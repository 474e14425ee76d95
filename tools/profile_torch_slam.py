#!/usr/bin/env python3
"""Where the GPU time of the PyTorch port's main path goes.

Runs the flagship config (configs/replica/hierslam_semantic_run.py as
shipped, ``raster.backend="stream"``, or the backend ``--backend`` names)
on frames of the procedural room at 1200x680 with 26 semantic channels,
as ``chip_smoke.py`` does, for frames
0..N-3 unprofiled, then profiles frame N-2 (tracking only) and frame N-1
(tracking, densify and a mapping phase when N is a multiple of
``map_every``) with torch.profiler.  Prints tracking_iter_ms and
mapping_iter_ms of the unprofiled frames, each profiled frame's
device-time table by kernel, the device busy share of its wall time and
its kernel launches (per tracking iteration for frame N-2), and writes the
tracking frame's Chrome trace into the checkout's output directory (the
path is printed).  The runner's own ``config["profile"]`` traces listed
frames the same way.

    python3 tools/profile_torch_slam.py [--frames 8] [--top 30] [--backend pallas]
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--backend", default=None, help="override raster.backend")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hierslam_torch.config import load_config
    from hierslam_torch.ops import kernels
    from hierslam_torch.slam.pipeline import SLAMRunner

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    kernels.build()
    n = args.frames
    ds = smoke.room_dataset(n, 1200, 680, 600.0)
    cfg = load_config(os.path.join(ROOT, "configs", "replica", "hierslam_semantic_run.py"))
    if args.backend:
        cfg["raster"]["backend"] = args.backend
    print(f"raster.backend {cfg['raster']['backend']}", flush=True)
    cfg["data"]["num_frames"] = n
    cfg["workdir"] = tempfile.mkdtemp()
    runner = SLAMRunner(cfg, dataset=ds, device="cuda")
    for t in range(n - 2):
        runner.step(t)
    torch.cuda.synchronize()
    summ = runner.runtime_summary()
    print(f"frames 0-{n - 3} unprofiled: tracking_iter_ms {summ['tracking_iter_ms']:.3f} "
          f"mapping_iter_ms {summ['mapping_iter_ms']:.3f}", flush=True)
    # frame n-2 tracks only; frame n-1 tracks, densifies and maps
    for t in (n - 2, n - 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            runner.step(t)
            torch.cuda.synchronize()
            wall = time.time() - t0
        # device time from the kernel events alone (one stream: no overlap)
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms, cnt = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, cnt + 1)
        busy = sum(ms for ms, _ in by_name.values())
        n_k = sum(c for _, c in by_name.values())
        print(f"profiled frame {t}: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
              f"({100 * busy / (wall * 1e3):.1f}% of wall), {n_k} kernel launches"
              + (f", {n_k / cfg['tracking']['num_iters']:.1f} per tracking iteration"
                 if t == n - 2 else ""), flush=True)
        for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]:
            print(f"  {ms:10.3f} ms {100 * ms / busy:5.1f}% {cnt:7d}x  {name[:100]}", flush=True)
        if t == n - 2:
            os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
            path = os.path.join(ROOT, "chiprun_out",
                                f"profile_{cfg['raster']['backend']}_frame{t}.json")
            prof.export_chrome_trace(path)
            print(f"trace: {os.path.relpath(path, ROOT)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
