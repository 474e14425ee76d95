#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``hierslam_torch``) on one card.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # build + kernel checks only

Phases, each of which must pass (the script exits non-zero otherwise):

1. environment: card name and power limit (nvidia-smi), kernel build with
   nvcc from ``hierslam_torch/csrc``;
2. kernels: K1 (blend forward) and K2 (blend backward) against their plain
   PyTorch versions at the tracking shape (T=3225, K=512, F=3) and one
   mapping class (T=128, K=4096, F=29), random tables from a seed; error,
   kernel and plain times (median of CUDA-event timings), roofline bound;
3. reference: a tiny SLAM run (3 frames, 96x64) on the GPU with the
   kernels against the same run on the CPU with the plain versions;
4. SLAM: frames 0-7 of the procedural room at 1200x680 with 26 semantic
   channels, the flagship config (configs/replica/hierslam_semantic_run.py)
   with ``raster.backend="pallas"``: tracking on frames 1-7, mapping at
   t=0 and t=7, densify at t=7; launch counts must equal what the config
   implies, losses must be finite, ``params.npz`` must carry the JAX
   runner's keys.

The last two lines of standard output are a JSON object with the kernels'
numbers and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TILE = (16, 16)
P = TILE[0] * TILE[1]
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, float32 outside the tensor cores
SEM_LEVELS = (2, 3, 5, 7, 9)   # Replica tree shape: 26 channels over 5 levels
NUM_LEAF = 102
# tolerances of the kernel checks, held at every pixel and every slot: the
# kernels take transmittance as a sequential product, the plain versions as
# a cumprod, and sum over pixels in another order (float32)
TOL = {"acc": 1e-3, "ft": 1e-4, "med": 1e-4, "dtab_rel": 2e-3}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def load_module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cuda_ms(fn, reps: int) -> float:
    """Median over ``reps`` CUDA-event timings of ``fn()`` after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def random_table(seed: int, T: int, K: int, F: int, grid_x: int, device):
    """Screen-space table [T, K, 7+F] with means scattered around each tile,
    positive-definite conics and depth-sorted slots; slot mask ~85% live."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    th, tw = TILE
    tid = np.arange(T)
    ox, oy = (tid % grid_x) * tw, (tid // grid_x) * th
    xy = np.stack([ox[:, None] + rng.uniform(-6, tw + 6, (T, K)),
                   oy[:, None] + rng.uniform(-6, th + 6, (T, K))], -1)
    a = rng.uniform(0.02, 0.4, (T, K))
    c = rng.uniform(0.02, 0.4, (T, K))
    b = rng.uniform(-0.5, 0.5, (T, K)) * np.sqrt(a * c)
    opa = rng.uniform(0.05, 0.6, (T, K))
    dep = np.sort(rng.uniform(0.5, 5.0, (T, K)), axis=1)
    feats = rng.uniform(0, 1, (T, K, F))
    table = np.concatenate([xy, np.stack([a, b, c], -1), opa[..., None], dep[..., None],
                            feats], -1).astype(np.float32)
    ok = rng.uniform(size=(T, K)) > 0.15
    return (torch.as_tensor(table, device=device), torch.as_tensor(ok, device=device))


def pair_stats(table, ok, grid_x: int):
    """What the blend needs on this data.  Pairs: per pixel, slots evaluated
    up to and including the one that ends it (forward), slots up to the
    last committed one (backward), and committed (blended) pairs.  Slots
    read: per tile, up to the largest of those over its pixels (a block
    retires once all its pixels have ended), for the forward and the
    backward."""
    import torch

    from hierslam_torch.ops.render_xla import blend_terms, pixel_grid, tile_chunks

    T, K, _ = table.shape
    n_fwd = n_bwd = n_comm = rows_fwd = rows_bwd = 0
    with torch.no_grad():
        for lo, hi in tile_chunks(T, P, K):
            px, py = pixel_grid(torch.arange(lo, hi, device=table.device), TILE, grid_x)
            (_, _, _, _, contrib, _, _, _, committed, _) = blend_terms(
                table[lo:hi], ok[lo:hi], px, py)
            comm = contrib & committed
            stop = contrib & ~committed
            ks = torch.arange(K, device=table.device)
            first_stop = torch.where(stop.any(-1), (stop * (K - ks)).argmax(-1) + 1,
                                     torch.full(stop.shape[:2], K, device=table.device))
            last = torch.where(comm.any(-1), K - 1 - comm.flip(-1).int().argmax(-1),
                               torch.full(comm.shape[:2], -1, device=table.device))
            n_fwd += int(first_stop.sum())
            n_bwd += int((last + 1).sum())
            n_comm += int(comm.sum())
            rows_fwd += int(first_stop.amax(-1).sum())
            rows_bwd += int((last + 1).amax(-1).sum())
    return n_fwd, n_bwd, n_comm, rows_fwd, rows_bwd


def n_beyond(err, tol) -> int:
    return int((err > tol).sum())


def check_kernels(name: str, seed: int, T: int, K: int, F: int, grid_x: int, reps: int):
    import torch

    from hierslam_torch.ops import kernels, render_pallas

    dev = torch.device("cuda")
    table, ok = random_table(seed, T, K, F, grid_x, dev)
    C = 7 + F
    acc, ft, med, last, mslot = kernels.blend_fwd(table, ok, grid_x, TILE)
    torch.cuda.synchronize()
    acc_p, ft_p, med_p = render_pallas.blend_fwd_plain(table, ok, grid_x, TILE)
    e_acc = (acc - acc_p).abs().amax(-1)
    e_ft = (ft - ft_p).abs()
    e_med = (med - med_p).abs()
    n_fl = n_beyond(e_acc, TOL["acc"]) + n_beyond(e_ft, TOL["ft"]) + n_beyond(e_med, TOL["med"])
    fwd_err = max(float(e_acc.max()), float(e_ft.max()), float(e_med.max()))
    fwd_ok = n_fl == 0
    print(f"[kernels] {name} K1: max abs err acc {float(e_acc.max()):.3e} ft "
          f"{float(e_ft.max()):.3e} med {float(e_med.max()):.3e}; pixels beyond "
          f"tolerance {n_fl} of {T * P} (allowed 0)", flush=True)

    g = torch.Generator(device=dev).manual_seed(seed + 1)
    gacc = torch.randn(acc.shape, generator=g, device=dev)
    gft = torch.randn(ft.shape, generator=g, device=dev)
    gmed = torch.randn(med.shape, generator=g, device=dev)
    dtab = kernels.blend_bwd(table, ok, ft, last, mslot, gacc, gft, gmed, grid_x, TILE)
    torch.cuda.synchronize()
    dtab_p = render_pallas.blend_bwd_plain(table, ok, gacc, gft, gmed, grid_x, TILE)
    e_d = (dtab - dtab_p).abs()
    rel = (e_d / (1.0 + dtab_p.abs())).amax(-1)
    n_fl_b = n_beyond(rel, TOL["dtab_rel"])
    bwd_err = float(e_d.max())
    bwd_ok = n_fl_b == 0
    print(f"[kernels] {name} K2: max abs err {bwd_err:.3e}, max err/(1+|ref|) "
          f"{float(rel.max()):.3e}; slots beyond tolerance {n_fl_b} of {T * K} "
          "(allowed 0)", flush=True)
    pad_ok = bool((dtab[~ok] == 0).all())
    if not pad_ok:
        print(f"[kernels] {name} K2: masked slots got a nonzero gradient", flush=True)

    ms_f = cuda_ms(lambda: kernels.blend_fwd(table, ok, grid_x, TILE), reps)
    ms_b = cuda_ms(lambda: kernels.blend_bwd(table, ok, ft, last, mslot, gacc, gft, gmed,
                                             grid_x, TILE), reps)
    plain_f = cuda_ms(lambda: render_pallas.blend_fwd_plain(table, ok, grid_x, TILE), 3)
    plain_b = cuda_ms(lambda: render_pallas.blend_bwd_plain(table, ok, gacc, gft, gmed,
                                                            grid_x, TILE), 3)
    n_fwd, n_bwd, n_comm, rows_fwd, rows_bwd = pair_stats(table, ok, grid_x)
    pix = T * P
    # table and mask rows up to each tile's last needed slot; per pixel K1
    # writes acc, ft, med, last, mslot and K2 reads them back with gft and
    # gmed; K2 writes all of dtab
    f_bytes = rows_fwd * (C * 4 + 1) + pix * ((F + 2) + 4) * 4
    f_ops = 12 * n_fwd + (2 * (F + 2) + 4) * n_comm
    b_bytes = rows_bwd * (C * 4 + 1) + pix * ((F + 2) + 5) * 4 + T * K * C * 4
    b_ops = 12 * n_bwd + (4 * (F + 2) + 30 + C) * n_comm

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    bf, bf_by = bound(f_bytes, f_ops)
    bb, bb_by = bound(b_bytes, b_ops)
    print(f"[kernels] {name}: K1 {ms_f:.4f} ms (plain {plain_f:.3f} ms, bound {bf:.4f} ms "
          f"by {bf_by}); K2 {ms_b:.4f} ms (plain {plain_b:.3f} ms, bound {bb:.4f} ms by "
          f"{bb_by}); pairs fwd {n_fwd} bwd {n_bwd} blended {n_comm}; table rows read fwd "
          f"{rows_fwd} bwd {rows_bwd} of {T * K}", flush=True)
    rows = [
        dict(name=f"blend_fwd_K1[{name}]", route="cuda", source="hierslam_torch/csrc/blend.cu",
             replaces="hierslam_tpu/ops/render_pallas.py:117", ms=ms_f, plain_ms=plain_f,
             bound_ms=bf, bound_by=bf_by, library_ms=None, max_abs_err=fwd_err),
        dict(name=f"blend_bwd_K2[{name}]", route="cuda", source="hierslam_torch/csrc/blend.cu",
             replaces="hierslam_tpu/ops/render_pallas.py:155", ms=ms_b, plain_ms=plain_b,
             bound_ms=bb, bound_by=bb_by, library_ms=None, max_abs_err=bwd_err),
    ]
    return rows, fwd_ok and bwd_ok and pad_ok


def room_dataset(n: int, W: int, H: int, f: float, n_frames_arc: int = 200):
    """Procedural room frames (tools/procedural_room.py) with labels mapped
    onto a (2, 3, 5, 7, 9)-level tree with 102 leaves; poses relative to
    frame 0."""
    import numpy as np

    room = load_module("procedural_room", os.path.join(ROOT, "tools", "procedural_room.py"))
    cx, cy = (W - 1) / 2, (H - 1) / 2
    frames = [room.render_frame(t, W, H, f, f, cx, cy, n_frames_arc) for t in range(n)]
    K4 = np.eye(4)
    K4[0, 0], K4[1, 1], K4[0, 2], K4[1, 2] = f, f, cx, cy
    inv0 = np.linalg.inv(frames[0][2])
    leaf_of_prim = np.array([(17 * p + 5) % NUM_LEAF for p in range(6)])

    class RoomDataset:
        num_semantic = list(SEM_LEVELS) + [NUM_LEAF]
        num_semantic_class = NUM_LEAF

        def __len__(self):
            return n

        def __getitem__(self, t):
            color, depth, c2w, prim = frames[t]
            leaf = leaf_of_prim[prim]
            levels = [(leaf * (i + 3)) % k for i, k in enumerate(SEM_LEVELS)]
            labels = np.stack(levels + [leaf]).astype(np.int64)
            return color, depth, K4, inv0 @ c2w, labels

    return RoomDataset()


def centre_err_cm(runner, ds, n):
    import numpy as np

    from hierslam_torch.slam.tracking import est_w2c

    errs = []
    for t in range(n):
        est_c = np.linalg.inv(est_w2c(runner.params, t).cpu().numpy().astype(np.float64))[:3, 3]
        errs.append(np.linalg.norm(est_c - np.asarray(ds[t][3])[:3, 3]) * 100)
    return errs


def reference_phase(cfg_path: str):
    """The same tiny run on the GPU (kernels) and the CPU (plain versions)."""
    import numpy as np

    from hierslam_torch.config import load_config
    from hierslam_torch.slam.pipeline import SLAMRunner

    ds = room_dataset(3, 96, 64, 48.0, n_frames_arc=40)
    traces = {}
    for dev in ("cuda", "cpu"):
        cfg = load_config(cfg_path)
        cfg["raster"].update(backend="pallas", bucket_spec=((4, 512), (-1, 256)),
                             track_max_per_tile=256)
        cfg["data"]["num_frames"] = 3
        cfg.update(map_every=3, map_capacity=65536, workdir=tempfile.mkdtemp())
        cfg["tracking"]["num_iters"] = 10
        cfg["mapping"]["num_iters"] = 10
        r = SLAMRunner(cfg, dataset=ds, device=dev)
        tr = []
        for t in range(3):
            r.step(t)
            if t > 0:
                tr.append(r.last_tracking_trace["loss"])
        traces[dev] = (np.stack(tr), r.last_mapping_trace["loss"],
                       r.params["cam_trans"][0].T.cpu().numpy())
    g, c = traces["cuda"], traces["cpu"]
    d_track = float(np.max(np.abs(g[0] - c[0]) / np.abs(c[0])))
    d_map = float(np.max(np.abs(g[1] - c[1]) / np.abs(c[1])))
    d_traj = float(np.max(np.abs(g[2] - c[2])))
    print(f"[reference] GPU kernels vs CPU plain, 3 frames 96x64: tracking loss rel "
          f"{d_track:.2e}, mapping loss rel {d_map:.2e}, trajectory abs {d_traj:.2e} m "
          "(tolerances 1e-2, 1e-2, 1e-3: float32 sums in another order, compounded "
          "over 10 Adam steps)", flush=True)
    return d_track <= 1e-2 and d_map <= 1e-2 and d_traj <= 1e-3


def slam_phase(cfg_path: str, n_frames: int = 8):
    import numpy as np
    import torch

    from hierslam_torch.config import load_config
    from hierslam_torch.ops import kernels, render_pallas
    from hierslam_torch.ops.binning import resolve_bucket_spec
    from hierslam_torch.slam.pipeline import SLAMRunner

    t0 = time.time()
    ds = room_dataset(n_frames, 1200, 680, 600.0)
    print(f"[slam] {n_frames} procedural frames at 1200x680 in {time.time() - t0:.1f} s",
          flush=True)
    cfg = load_config(cfg_path)
    cfg["raster"]["backend"] = "pallas"
    cfg["data"]["num_frames"] = n_frames
    workdir = tempfile.mkdtemp()
    cfg["workdir"] = workdir
    torch.cuda.reset_peak_memory_stats()
    runner = SLAMRunner(cfg, dataset=ds, device="cuda")

    kernels.reset_launch_counts()
    for k in render_pallas.plain_counts:
        render_pallas.plain_counts[k] = 0
    ok = True
    n_track = n_map = n_dens = 0
    t_run = time.time()
    for t in range(n_frames):
        runner.step(t)
        line = f"[slam] frame {t}:"
        if t > 0:
            tl = runner.last_tracking_trace["loss"]
            n_track += 1
            ok &= bool(np.isfinite(tl).all())
            line += f" tracking loss {tl[0]:.6g} -> {tl[-1]:.6g}"
        if t == 0 or (t + 1) % cfg["map_every"] == 0:
            ml = runner.last_mapping_trace["loss"]
            n_map += 1
            n_dens += int(t > 0)
            ok &= bool(np.isfinite(ml).all())
            line += f" mapping loss {ml[0]:.6g} -> {ml[-1]:.6g}"
        line += f" n_active {int(runner.variables['n_active'])}"
        print(line, flush=True)
    torch.cuda.synchronize()
    wall = time.time() - t_run
    launches = dict(kernels.launch_counts)
    plain = dict(render_pallas.plain_counts)
    pn = runner.finalize()
    summ = runner.runtime_summary()

    grid = runner.rc.grid(680, 1200)
    n_classes = sum(1 for nb, _ in resolve_bucket_spec(runner.rc.spec(), grid[0] * grid[1])
                    if nb > 0)
    it_t, it_m = cfg["tracking"]["num_iters"], cfg["mapping"]["num_iters"]
    want_fwd = n_track * it_t + n_dens + n_map * it_m * n_classes
    want_bwd = n_track * it_t + n_map * it_m * n_classes
    print(f"[slam] kernels: {json.dumps(launches)} plain: {json.dumps(plain)} "
          f"expected blend_fwd {want_fwd} blend_bwd {want_bwd}", flush=True)
    ok &= launches["blend_fwd"] == want_fwd and launches["blend_bwd"] == want_bwd
    ok &= all(v == 0 for v in plain.values())
    if not ok:
        print("[slam] non-finite loss or launch counts off", flush=True)
    print(f"[slam] drops: densify_overflow {summ['densify_overflow']} bin_overflow_max "
          f"{summ['bin_overflow_max']} map_bin_dropped "
          f"{float(np.max(runner.last_mapping_trace['n_map_bin_dropped']))} grad_dropped "
          f"{float(np.max(runner.last_mapping_trace['n_grad_dropped']))}", flush=True)
    errs = centre_err_cm(runner, ds, n_frames)
    print("[slam] camera-centre error vs GT (cm): " + " ".join(f"{e:.3f}" for e in errs),
          flush=True)
    print(f"[slam] tracking_iter_ms {summ['tracking_iter_ms']:.3f} mapping_iter_ms "
          f"{summ['mapping_iter_ms']:.3f} tracking_frame_s {summ['tracking_frame_s']:.3f} "
          f"mapping_frame_s {summ['mapping_frame_s']:.3f} wall_s {wall:.1f} n_active "
          f"{summ['n_active']} max_memory_allocated_GiB "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", flush=True)
    keys = ("means3D", "rgb_colors", "logit_opacities", "log_scales", "semantic",
            "unnorm_rotations", "cam_unnorm_rots", "cam_trans", "timestep", "intrinsics",
            "w2c", "gt_w2c_all_frames", "keyframe_time_indices", "org_width", "org_height")
    path = os.path.join(workdir, cfg["run_name"], "params.npz")
    with np.load(path) as data:
        missing = [k for k in keys if k not in data]
        finite = all(np.isfinite(data[k]).all() for k in keys if k not in missing)
    print(f"[slam] params.npz: missing keys {missing}, all finite {finite}", flush=True)
    ok &= not missing and finite and os.path.isfile(
        os.path.join(workdir, cfg["run_name"], "semantic_decoder.npz"))
    ok &= bool(np.all(np.isfinite(errs)))
    return ok, launches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", action="store_true", help="build and kernel checks only")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "hierslam_torch")):
        print("hierslam_torch not found beside chip_smoke.py: run from a checkout",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else
          f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    from hierslam_torch.ops import kernels

    t0 = time.time()
    kernels.build(verbose=True)
    print(f"[build] kernels built in {time.time() - t0:.1f} s", flush=True)

    rows = []
    ok = True
    for name, seed, T, K, F, gx, reps in (("tracking T=3225 K=512 F=3", 0, 3225, 512, 3, 75, 20),
                                          ("mapping T=128 K=4096 F=29", 1, 128, 4096, 29, 128, 20)):
        r, good = check_kernels(name, seed, T, K, F, gx, reps)
        rows += r
        ok &= good
    if not ok:
        fail("kernel check")
    launches = {"blend_fwd": None, "blend_bwd": None}
    if not args.kernels:
        cfg_path = os.path.join(ROOT, "configs", "replica", "hierslam_semantic_run.py")
        if not reference_phase(cfg_path):
            fail("GPU run disagrees with the CPU reference")
        good, launches = slam_phase(cfg_path)
        if not good:
            fail("SLAM phase")
    for row in rows:
        row["launches"] = launches["blend_fwd" if "fwd" in row["name"] else "blend_bwd"]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
