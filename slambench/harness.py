"""One run of one cell: set-up, warm-up, the measured window or the traced
period, the check, and the result line (``python3 slambench/run.py``).

Set-up (all of it in ``setup_s``): build or load the kernels, make the map
from the seed on the device, write it as a resume checkpoint under
``$TMPDIR``, construct ``SLAMRunner`` resumed from it (which re-reads the
frames before the resume frame), render the frames from the resume frame
on into host memory, then step ``warmup_periods`` whole
``map_every`` periods, recording the first tracking phase, densify and
mapping phase for the check (``Recorder``).  Frames reach ``step`` from a
loader thread two frames ahead, as ``SLAMRunner.run`` has them.

``--trace 0``: the window starts at a period's first frame and ends with
the first mapping frame that completes after ``--seconds``; the clock runs
without pause.  ``--trace 1``: ``torch.profiler`` covers one period, with a
``record_function`` span round each ``step``, and the per-layer metrics are
read from its trace (``slambench/metrics/<name>.py``).  Either way the
check runs after the program's state is freed.
"""
from __future__ import annotations

import gc
import importlib
import json
import os
import queue
import shutil
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from slambench import cells
from slambench.frozen import trace as trace_lib
from slambench.reference import check

OUT_DIR = os.path.join(cells.ROOT, "slambench_out")
FORBIDDEN = ("jax", "jaxlib", "flax", "hierslam_tpu")
K_CALLS = 2   # recorded K4 calls a traced period (see PERF.md)


class FramePump:
    """``load(t)`` for t in [start, end) on a thread ``depth`` frames ahead
    (``hierslam_torch.utils.prefetch.Prefetcher``'s loop), with a stop."""

    def __init__(self, load: Callable[[int], object], start: int, end: int, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.stopped = threading.Event()
        self.err: Optional[BaseException] = None

        def work():
            try:
                for t in range(start, end):
                    item = (t, load(t))
                    while not self.stopped.is_set():
                        try:
                            self.q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self.stopped.is_set():
                        return
            except BaseException as e:   # raised on the consumer side
                self.err = e
            self.q.put(None)

        self.thread = threading.Thread(target=work, daemon=True)
        self.thread.start()

    def next(self):
        item = self.q.get()
        if item is None:
            raise self.err or RuntimeError("the sequence ended before the run did: lengthen "
                                           "the traffic's sequence_frames")
        return item

    def stop(self):
        self.stopped.set()
        while self.thread.is_alive():
            try:
                self.q.get(timeout=0.1)
            except queue.Empty:
                pass
        self.thread.join()


def _cpu(x):
    return None if x is None else {k: v.detach().to("cpu", copy=True) for k, v in x.items()}


class Recorder:
    """Wraps the runner's tracker, densifier and mapper to record the first
    call of each (the densifier: its last call on its first frame, the one
    whose rows the runner keeps) for ``reference/check.py``."""

    def __init__(self, runner):
        self.runner = runner
        self.obs: Dict = {"track": None, "densify": None, "map": None}
        self.orig = (runner.tracker, runner.densifier, runner.mapper)
        tracker, densifier, mapper = self.orig
        obs = self.obs

        def track(p_b, active, maxrad, im, depth, t):
            res = tracker(p_b, active, maxrad, im, depth, t)
            if obs["track"] is None:
                p1, trace = res[0], res[3]
                obs["track"] = dict(t=int(t), rows=p_b["means3D"].shape[0],
                                    losses=trace[0].cpu().numpy(), best=float(res[1]),
                                    q1=p1["cam_unnorm_rots"][0, :, t].cpu().numpy(),
                                    t1=p1["cam_trans"][0, :, t].cpu().numpy())
            return res
        track.continue_round = tracker.continue_round

        def densify(p_b, v_b, im, depth, t, generator=None):
            first = obs["densify"] is None or obs["densify"]["t"] == t
            if first:
                rec = dict(t=int(t), rows=p_b["means3D"].shape[0], n_before=int(v_b["n_active"]),
                           q=p_b["cam_unnorm_rots"][0, :, t].cpu().numpy(),
                           tr=p_b["cam_trans"][0, :, t].cpu().numpy(),
                           gen_state=generator.get_state())
            res = densifier(p_b, v_b, im, depth, t, generator)
            if first:
                n0, n1 = rec["n_before"], int(res[1]["n_active"])
                rec.update(n_added=n1 - n0, added={k: res[0][k][n0:n1].cpu() for k in res[0]
                                                   if res[0][k].shape[0] == rec["rows"]})
                obs["densify"] = rec
            return res

        def map_phase(p_b, v_b, window, rand_idx, mlp, mlp_state, generator=None):
            if obs["map"] is not None:
                return mapper(p_b, v_b, window, rand_idx, mlp, mlp_state, generator)
            rows = p_b["means3D"].shape[0]
            rec = dict(p_in=_cpu(p_b), v_in=_cpu({k: v for k, v in v_b.items()}),
                       time_idx=window["time_idx"].cpu().tolist(), rand_idx=np.array(rand_idx),
                       mlp_in=_cpu(mlp),
                       mlp_state_in=None if mlp_state is None else
                       (_cpu(mlp_state.mu), _cpu(mlp_state.nu), mlp_state.count))
            res = mapper(p_b, v_b, window, rand_idx, mlp, mlp_state, generator)
            rec.update(p_out={k: x.cpu() for k, x in res[0].items()
                              if x.dim() and x.shape[0] == rows},
                       mlp_out=_cpu(res[2]), losses=res[4]["loss"].cpu().numpy(),
                       dropped=int(res[4]["n_map_bin_dropped"].max()))
            obs["map"] = rec
            return res

        runner.tracker, runner.densifier, runner.mapper = track, densify, map_phase

    def close(self):
        self.runner.tracker, self.runner.densifier, self.runner.mapper = self.orig


class KernelRecorder:
    """Keeps the inputs of the first ``n`` K4 launches while it is open, by
    wrapping ``hierslam_torch.ops.kernels.stream_bwd`` (the traced run only)."""

    def __init__(self, n: int = K_CALLS):
        from hierslam_torch.ops import kernels
        self.kernels = kernels
        self.k4 = []
        self.orig = kernels.stream_bwd

        def k4(stream, scalars, row_off, *rest):
            if len(self.k4) < n:
                grid_x, tile_shape, n_feat, img = rest[6], rest[7], rest[8], rest[9]
                self.k4.append(dict(stream=stream.clone(), sc=scalars.clone(),
                                    row_off=row_off.clone(), grid_x=grid_x,
                                    tile_shape=tuple(tile_shape), n_feat=n_feat,
                                    img_shape=tuple(img)))
            return self.orig(stream, scalars, row_off, *rest)

        kernels.stream_bwd = k4

    def close(self):
        self.kernels.stream_bwd = self.orig


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout else "unread"
    except (OSError, subprocess.SubprocessError):
        return "unread"


def frame_kind(cfg: Dict, t: int) -> str:
    if (t + 1) % cfg["map_every"] == 0:
        return "map"
    return "posed" if cfg["tracking"]["use_gt_poses"] else "track"


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(spec: Dict, seed: int, seconds: Optional[float], traced: bool, t_start: float,
             device="cuda", plant: Optional[Callable] = None, log=print) -> Dict:
    """One run; returns what the result line is made of.  ``seconds=None``
    skips the window (``calibrate.py``); ``plant(runner)`` (tests only)
    changes the runner after its construction."""
    from hierslam_torch.slam.pipeline import SLAMRunner

    dev = torch.device(device)
    traffic, conf = spec["traffic"], spec["config"]
    if dev.type == "cuda":
        from hierslam_torch.ops import kernels
        kernels.build()
    S = int(traffic["resume_frame"])
    ds = cells.RoomSequence(conf["frames"], traffic["arc_frames"], traffic["sequence_frames"],
                            dev)
    work = os.path.join(os.environ.get("TMPDIR") or OUT_DIR, f"slambench_{spec['name']}")
    cfg = cells.run_config(spec, seed, work)
    period = int(cfg["map_every"])
    if S % period:
        raise ValueError(f"resume_frame {S} is not the first frame of a map_every period")
    n_sem = int(sum(ds.num_semantic[:-1]))
    seeded = cells.make_map(ds, int(traffic["map_gaussians"]), S, seed, n_sem)
    use_mlp = cfg.get("model", {}).get("flag_use_embedding", 0) == 1
    cells.write_checkpoint(os.path.join(work, "run"), seeded, ds, S, cfg["keyframe_every"],
                           cells.decoder_weights(n_sem, ds.num_semantic_class, seed)
                           if use_mlp else None)
    seeded = {k: v.cpu() for k, v in seeded.items()}
    runner = SLAMRunner(cfg, dataset=ds, device=dev)
    ds.prerender(S)
    if plant is not None:
        plant(runner)
    rots, trans = cells.checkpoint_poses(ds, S)
    inputs = dict(ds=ds, map=seeded, cfg=cfg, S=S, rots=rots, trans=trans)
    tracks = not cfg["tracking"]["use_gt_poses"]
    pump = FramePump(runner._load_frame, S, len(ds))
    out: Dict = {}
    try:
        rec = Recorder(runner)
        t = S
        for _ in range(int(traffic["warmup_periods"]) * period):
            t, frame = pump.next()
            runner.step(t, frame)
            if rec.obs["map"] is not None:
                rec.close()
        rec.close()
        sync(dev)
        out["setup_s"] = time.time() - t_start
        log(f"[slambench] set-up {out['setup_s']:.3f} s: map of {seeded['means3D'].shape[0]} "
            f"gaussians resumed at frame {S}, warm-up frames {S}..{t}")
        if traced:
            out.update(_traced_period(runner, pump, cfg, period, dev))
        elif seconds is not None:
            out.update(_window(runner, pump, cfg, seconds, dev, log))
    finally:
        pump.stop()
        shutil.rmtree(work, ignore_errors=True)
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["n_active_end"] = int(runner.variables["active"].sum())
    del runner
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    ref = check.reference_observations(inputs, rec.obs, dev)
    nums = check.numbers(rec.obs, ref)
    expected = check.expected_numbers(spec["limits"], tracks)
    out["check"] = check.judge(nums, spec["limits"], expected)
    out["correct"] = check.correct(out["check"])
    out["check_s"] = time.time() - t0
    out["observations"] = (rec.obs, ref)
    out["inputs"] = inputs
    return out


def _counters():
    """The program's kernel launch counts and plain-version call counts."""
    from hierslam_torch.ops import gather_vjp, kernels, render_pallas, render_stream
    return (kernels.launch_counts, render_pallas.plain_counts, render_stream.plain_counts,
            gather_vjp.plain_counts)


def _window(runner, pump, cfg, seconds, dev, log) -> Dict:
    s0 = dict(runner.stats)
    for counts in _counters():
        counts.update({k: 0 for k in counts})
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    frames = periods = 0
    t_first = None
    t0 = time.time()
    while True:
        t, frame = pump.next()
        t_first = t if t_first is None else t_first
        runner.step(t, frame)
        frames += 1
        if frame_kind(cfg, t) == "map":
            periods += 1
            if time.time() - t0 >= seconds:
                break
    sync(dev)
    wall = time.time() - t0
    s1 = runner.stats

    def per_iter(kind):
        n = s1[f"{kind}_iter_time_count"] - s0[f"{kind}_iter_time_count"]
        return None if n == 0 else 1e3 * (s1[f"{kind}_iter_time_sum"]
                                          - s0[f"{kind}_iter_time_sum"]) / n
    log(f"[slambench] window: frames {t_first}..{t} ({frames} frames, {periods} periods) in "
        f"{wall:.3f} s; launches and plain calls "
        + ", ".join(f"{k} {v}" for counts in _counters() for k, v in counts.items()))
    out = dict(frames=frames, wall_s=wall, frames_per_s=frames / wall,
               tracking_iter_ms=per_iter("tracking"), mapping_iter_ms=per_iter("mapping"))
    if dev.type == "cuda":
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def _traced_period(runner, pump, cfg, period, dev) -> Dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "trace.json")
    krec = KernelRecorder()
    try:
        with profile(activities=acts) as prof:
            for _ in range(period):
                t, frame = pump.next()
                with record_function(f"{trace_lib.FRAME_SPAN}{t}.{frame_kind(cfg, t)}"):
                    runner.step(t, frame)
            sync(dev)
    finally:
        krec.close()
    prof.export_chrome_trace(path)
    return dict(frames=period, trace_path=path, k4_calls=krec.k4)


def per_layer(spec: Dict, res: Dict, cfg_iters: Dict) -> Dict:
    """The per-layer metrics of the cell from the traced period's record;
    a reader that finds nothing returns None and the metric is left out."""
    tr = trace_lib.load(res["trace_path"])
    record = dict(trace=tr, k4_calls=res["k4_calls"], **cfg_iters)
    out = {}
    for m in spec["per_layer"]:
        mod = importlib.import_module(f"slambench.metrics.{m['name']}")
        v = mod.read(record)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    t0, t1 = trace_lib.window(tr)
    device = dict(busy_s=trace_lib.busy_us(tr) / 1e6, window_s=(t1 - t0) / 1e6)
    breakdown = dict(device_ops=trace_lib.top_device_ops(tr), idle_gaps=trace_lib.idle_gaps(tr))
    return out, device, breakdown


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="one run of one slambench cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cells.cell_spec(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slambench: the cell needs {chips} CUDA device(s), {n} visible; no result",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    print(f"[slambench] device {kind}, {torch.cuda.device_count()} visible, "
          f"nvidia-smi: {power_limit()}; torch {torch.__version__}, cell {args.workload}, "
          f"seed {args.seed}", flush=True)
    res = run_cell(spec, args.seed, args.seconds, bool(args.trace), t_start, dev,
                   log=lambda s: print(s, flush=True))
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"slambench: modules loaded in the run's process: {found}; no result",
              file=sys.stderr)
        return 3
    device = dict(platform="gpu", kind=kind, count=chips,
                  memory_peak_bytes=int(res["memory_peak_bytes"]))
    line = dict(correct=bool(res["correct"]), attempted=int(res["frames"]), failed=0)
    if args.trace:
        cfg = cells.shipped_config(spec)
        iters = dict(track_iters=cfg["tracking"]["num_iters"],
                     map_iters=cfg["mapping"]["num_iters"])
        metrics, dev_times, breakdown = per_layer(spec, res, iters)
        device.update(dev_times)
        line.update(metrics=metrics, device=device, breakdown=breakdown)
    else:
        metrics = {}
        for m in spec["end_to_end"]:
            v = res.get(m["name"])
            if v is None:
                raise RuntimeError(f"the run gave no {m['name']}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        line.update(metrics=metrics, device=device)
    line["check"] = res["check"]
    print(f"[slambench] check took {res['check_s']:.1f} s; n_active at the end "
          f"{res['n_active_end']}", flush=True)
    for name, c in res["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
