#!/usr/bin/env python3
"""The camera-centre drift of ``chip_smoke.py``'s ``[tum]`` run, by variant.

    python3 tools/tum_drift_torch.py [--runs N] [--deterministic]
        [--no-distortion] [--flat-tracking]

Writes the ``[tum]`` phase's 8 procedural frames at 640x480 in the TUM
layout (``chip_smoke.write_tum``) and runs
``configs/replica/hierslam_nosemantic_run.py`` on them N times through the
CLI in this process, as ``[tum]`` does (``chip_smoke.replica_run``, with
all its checks and lines).  Variants:

- ``--deterministic``: every run under PyTorch's deterministic algorithms,
  as ``[tum]`` runs;
- ``--no-distortion``: the ideal colour frames and a copy of
  ``configs/data/tum.yaml`` without ``distortion`` (no undistortion, no
  black border);
- ``--flat-tracking``: the config's tracking ladder replaced by the
  semantic configs' flat 512 slots without saturation capping.

Each run prints one ``DRIFT`` line (its camera-centre error in cm at every
frame); the last line is a JSON object of them.  Needs one GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAT = ("config['raster'].update(track_bucket_spec=None, track_max_per_tile=512, "
        "track_sat_margin=0.0)\n")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--no-distortion", action="store_true")
    ap.add_argument("--flat-tracking", action="store_true")
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this tool needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from hierslam_torch.ops import kernels

    kernels.build()
    torch.use_deterministic_algorithms(args.deterministic)
    root = tempfile.mkdtemp()
    cs.write_tum(root, 8, distorted=not args.no_distortion)
    data_cfg = cs.TUM_YAML
    if args.no_distortion:
        data_cfg = os.path.join(root, "tum_undistorted.yaml")
        with open(os.path.join(ROOT, cs.TUM_YAML)) as f:
            lines = [line for line in f if not line.strip().startswith("distortion:")]
        with open(data_cfg, "w") as f:
            f.writelines(lines)
    data = dict(gradslam_data_cfg=data_cfg, basedir=root, sequence=cs.TUM_SEQ,
                desired_image_height=cs.TUM_FRAME["H"], desired_image_width=cs.TUM_FRAME["W"])
    variant = (f"deterministic={args.deterministic} distortion={not args.no_distortion} "
               f"flat_tracking={args.flat_tracking}")
    out = []
    for i in range(args.runs):
        cfg = os.path.join(root, f"hierslam_drift{i}_run.py")   # a workdir of its own
        with open(cfg, "w") as f:
            f.write("import importlib.util\n"
                    f"spec = importlib.util.spec_from_file_location('ns', "
                    f"{cs.REPLICA_CONFIGS[0]!r})\n"
                    "shipped = importlib.util.module_from_spec(spec)\n"
                    "spec.loader.exec_module(shipped)\n"
                    "config = shipped.config\n" + (FLAT if args.flat_tracking else ""))
        t0 = time.time()
        ok, _, errs = cs.replica_run(cfg, root, 8, data=data, frame=cs.TUM_FRAME,
                                     tag=f"[drift run {i}]")
        print(f"DRIFT {variant} run {i}: checks {'passed' if ok else 'failed'} in "
              f"{time.time() - t0:.1f} s; centre error (cm) "
              + " ".join(f"{e:.3f}" for e in errs), flush=True)
        out.append(dict(ok=bool(ok), centre_err_cm=errs))
    print(json.dumps({"variant": variant, "runs": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
