"""Full SLAM of the PyTorch port on the procedural 1200x680 sequence.

The port's counterpart of ``tools/real_shape_run.py``: it writes the
procedural room (``tools/procedural_room.py``) in the Replica semantic
layout with the port's own JPEG and PNG writers, runs the complete
pipeline of ``hierslam_torch`` over it at the JAX tool's configuration,
re-renders every 25th frame at K and 2K slots a tile to measure what the
per-tile caps cost in the image, and writes a report whose quality and
map-statistics rows compare with the JAX package's
(``REAL_SHAPE_r05_fixed.json``).

    python3 tools/real_shape_run_torch.py --frames 200 --data DIR --workdir DIR
    python3 tools/real_shape_run_torch.py --frames 200 --stop-at 16 ...   # a prefix
    python3 tools/real_shape_run_torch.py --frames 200 --gt-poses ...     # GT poses
    python3 tools/real_shape_run_torch.py --device cpu --scale 0.1 --frames 8 ...

Defaults are those of the JAX row it is compared with: flat 512-slot
tracking without saturation capping (``--track-buckets ''``,
``RS_TRACK_K=512``, ``RS_TRACK_SAT=0``), ``RS_SAT_MARGIN=2.0`` and
``RS_BUDGET=4100000`` (``tools/r5_sequence.sh``); the JAX tool's own
defaults for the rest.  Each ``RS_*`` variable set in the environment
wins over these, as in the JAX tool.

Imports ``hierslam_torch``, numpy and the numpy functions of
``tools/procedural_room.py``; no JAX.
"""
import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the environment of the JAX row (REAL_SHAPE_r05_fixed.json): the
# tools/r5_sequence.sh run with the tracking caps of the configs since the
# real-scale tracking fix (flat 512 slots, no saturation capping)
ROW_ENV = {"RS_SAT_MARGIN": "2.0", "RS_BUDGET": "4100000", "RS_TRACK_K": "512",
           "RS_TRACK_SAT": "0"}
SEQ = "proc_room"
# the stream table's features: 3 colours and the tree's 2 groups and 6 leaves
# (tools/procedural_room.py::tree_json; SLAMRunner.num_semantic = 8)
FEATURES = 11


def build_config(basedir, workdir, W, H, max_per_tile, map_every, capacity,
                 escalate_tiles=0, escalate_k=0, gt_poses=False,
                 bucket_spec=None, track_bucket_spec=None, env=None):
    """``tools/real_shape_run.py::build_config``: the same dict for the same
    arguments and environment (``env``, default ``os.environ``)."""
    env = os.environ if env is None else env
    return dict(
        workdir=workdir,
        run_name="proc_room",
        seed=0,
        map_every=map_every,
        keyframe_every=5,
        mapping_window_size=24,
        report_global_progress_every=100,
        eval_every=5,
        scene_radius_depth_ratio=3,
        mean_sq_dist_method="projective",
        gaussian_distribution="isotropic",
        report_iter_progress=False,
        load_checkpoint=False,
        checkpoint_time_idx=0,
        save_checkpoints=False,
        checkpoint_interval=500,
        use_wandb=False,
        nan_autopsy=env.get("RS_AUTOPSY", "0") == "1",
        map_capacity=capacity,
        raster=dict(
            max_per_tile=max_per_tile, gaussian_chunk=256, tile_batch=48,
            grad_pair_budget=int(env.get("RS_BUDGET", 2_000_000)),
            grad_bf16=env.get("RS_BF16", "1") == "1",
            track_max_per_tile=int(env.get("RS_TRACK_K", 512)),
            escalate_tiles=escalate_tiles, escalate_k=escalate_k,
            bucket_spec=bucket_spec, track_bucket_spec=track_bucket_spec,
            sat_margin=float(env.get("RS_SAT_MARGIN", "0")),
            sat_floor=int(env.get("RS_SAT_FLOOR", "128")),
            track_sat_margin=float(env.get("RS_TRACK_SAT", "-1")),
            visible_budget=int(env.get("RS_VIS", 1_500_000)),
            backend=env.get("RS_BACKEND", "stream"),
            stream_rows=int(env.get("RS_STREAM_ROWS", "78000")),
            stream_cap=int(env.get("RS_STREAM_CAP", "4096")),
        ),
        model=dict(flag_use_embedding=1, eval_gt_transfer=False),
        data=dict(
            basedir=basedir,
            basedir_sem=basedir,
            sequence="proc_room",
            dataset_name="replica_semantic",
            sem_mode="tree",
            num_tree_level=2,
            use_pyramid=False,
            pyramid_level=4,
            desired_image_height=H,
            desired_image_width=W,
            start=0, end=-1, stride=1, num_frames=-1,
            camera_params=dict(
                image_height=H, image_width=W,
                fx=600.0 * W / 1200, fy=600.0 * W / 1200,
                cx=(W - 1) / 2, cy=(H - 1) / 2,
                png_depth_scale=6553.5,
            ),
        ),
        tracking=dict(
            use_gt_poses=gt_poses, forward_prop=True, num_iters=40,
            use_sil_for_loss=True, sil_thres=0.99, use_l1=True,
            ignore_outlier_depth_loss=False,
            loss_weights=dict(im=0.5, depth=1.0),
            lrs=dict(
                means3D=0.0, rgb_colors=0.0, unnorm_rotations=0.0,
                logit_opacities=0.0, log_scales=0.0, semantic=0.0,
                cam_unnorm_rots=0.0004, cam_trans=0.002,
            ),
        ),
        mapping=dict(
            num_iters=60, add_new_gaussians=True, sil_thres=0.5,
            use_l1=True, use_sil_for_loss=False,
            ignore_outlier_depth_loss=False,
            loss_weights=dict(im=0.5, depth=1.0, sem=0.2),
            lrs=dict(
                means3D=0.0001, rgb_colors=0.0025, unnorm_rotations=0.001,
                logit_opacities=0.05, log_scales=0.001, semantic=0.05,
                cam_unnorm_rots=0.0, cam_trans=0.0,
            ),
            prune_gaussians=True,
            pruning_dict=dict(
                start_after=0, remove_big_after=0, stop_after=20,
                prune_every=20, removal_opacity_threshold=0.005,
                final_removal_opacity_threshold=0.005,
                reset_opacities=False, reset_opacities_every=500,
            ),
            use_gaussian_splatting_densification=False,
        ),
    )


def procedural_room():
    """``tools/procedural_room.py`` (numpy only at import)."""
    spec = importlib.util.spec_from_file_location(
        "procedural_room", os.path.join(ROOT, "tools", "procedural_room.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_frame(job):
    """Render frame ``i`` of an ``n_frames`` trajectory and write its three
    files; -> the frame's c2w as a ``traj.txt`` line."""
    from hierslam_torch.utils.image_io import write_jpeg, write_png

    seq, i, n_frames, W, H, fx, fy = job
    cx, cy = (W - 1) / 2, (H - 1) / 2
    color, depth, c2w, label = procedural_room().render_frame(i, W, H, fx, fy, cx, cy, n_frames)
    write_jpeg(os.path.join(seq, "results", f"frame{i:06d}.jpg"), color, 95)
    write_png(os.path.join(seq, "results", f"depth{i:06d}.png"),
              np.clip(depth * 6553.5, 0, 65535).astype(np.uint16))
    write_png(os.path.join(seq, "semantic_class", f"semantic_class_{i}.png"),
              label.astype(np.uint8))
    return " ".join(f"{v:.9f}" for v in c2w.reshape(-1))


def generate(root, n_frames=200, W=1200, H=680, fx=None, fy=None, stop_at=None, workers=1):
    """``procedural_room.generate`` with the port's writers: the same frames,
    PNGs that decode to the same arrays, the same ``traj.txt`` and tree,
    and a q95 4:2:0 JPEG from ``image_io.write_jpeg``.  ``stop_at`` writes
    only the first frames of the ``n_frames`` trajectory; ``workers``
    processes render and encode the frames."""
    fx = fx or 600.0 * W / 1200.0
    fy = fy or fx
    n_write = n_frames if stop_at is None else min(stop_at, n_frames)
    seq = os.path.join(root, SEQ)
    os.makedirs(os.path.join(seq, "results"), exist_ok=True)
    os.makedirs(os.path.join(seq, "semantic_class"), exist_ok=True)
    jobs = [(seq, i, n_frames, W, H, fx, fy) for i in range(n_write)]
    if workers > 1:
        import multiprocessing

        # spawned workers import this module by name from its directory; the
        # function is sent as that module's, whichever way this one was loaded
        here = os.path.dirname(os.path.abspath(__file__))
        if here not in sys.path:
            sys.path.insert(0, here)
        import real_shape_run_torch

        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            traj = pool.map(real_shape_run_torch._write_frame, jobs, chunksize=1)
    else:
        traj = [_write_frame(j) for j in jobs]
    with open(os.path.join(seq, "traj.txt"), "w") as fh:
        fh.write("\n".join(traj))
    with open(os.path.join(seq, "info_semantic_tree.json"), "w") as fh:
        json.dump(procedural_room().tree_json(), fh)
    return seq


def overflow_quality_check(params_np, config, dataset, k_lo, n_frames, every=25,
                           device="cuda"):
    """``tools/real_shape_run.py::overflow_quality_check`` on the port:
    render every ``every``-th frame at K and at 2K (the whole cap config
    doubled: ``max_per_tile``, every ``bucket_spec`` class, ``escalate_k``
    where set) and report the mean dropped pairs at each K and the PSNR
    between the two renders."""
    import torch

    from hierslam_torch import resolve_device
    from hierslam_torch.config import raster_config
    from hierslam_torch.core.camera import setup_camera
    from hierslam_torch.slam.losses import render_gaussians

    dev = resolve_device(device)
    first = dataset[0]
    H, W = first[1].shape
    camera = setup_camera(W, H, np.asarray(first[2])[:3, :3], params_np["w2c"])
    gauss = {k: torch.as_tensor(v, device=dev) for k, v in params_np.items()
             if k in ("means3D", "rgb_colors", "unnorm_rotations",
                      "logit_opacities", "log_scales")}
    q_all = torch.as_tensor(params_np["cam_unnorm_rots"], device=dev)
    t_all = torch.as_tensor(params_np["cam_trans"], device=dev)

    results = {}
    renders = {}
    for mult in (1, 2):
        k = k_lo * mult
        rr = dict(config["raster"], max_per_tile=k)
        if rr.get("escalate_tiles"):
            rr["escalate_k"] = (rr.get("escalate_k") or 4 * k_lo) * mult
        if rr.get("bucket_spec"):
            rr["bucket_spec"] = tuple((n, kk * mult) for n, kk in rr["bucket_spec"])
        rc = raster_config({**config, "raster": rr})
        ims, drops = [], []
        with torch.no_grad():
            for t in range(0, n_frames, every):
                out = render_gaussians(gauss, None, q_all[0, :, t], t_all[0, :, t], camera, rc,
                                       with_semantic=False, gaussians_grad=False,
                                       camera_grad=False)
                ims.append(out.im.clamp(0, 1).cpu().numpy())
                drops.append(int(out.n_dropped))
        renders[mult] = ims
        results[f"overflow_pairs_K{k}"] = float(np.mean(drops))
    mses = [np.mean((a - b) ** 2) for a, b in zip(renders[1], renders[2])]
    mse = float(np.mean(mses))
    results["overflow_psnr_K_vs_2K"] = float(10 * np.log10(1.0 / max(mse, 1e-12)))
    return results


def card():
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
    except OSError as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else out.stderr.strip()


@contextlib.contextmanager
def recording(rec):
    """While active, every mapping stream binning leaves (used rows, dropped
    pairs) in ``rec["binnings"]`` and every tracking pose cache its dropped
    pairs in ``rec["track_dropped"]`` (the package has no hook for either;
    the wrapped functions still do all the work)."""
    from hierslam_torch.ops import render_stream as rs
    from hierslam_torch.slam import tracking

    bin_stream, track_cache = rs.compute_stream_binning, tracking.build_track_cache

    def binning(*a, **kw):
        b = bin_stream(*a, **kw)
        rec["binnings"].append((int(b.lists.n_rows), int(b.lists.n_dropped)))
        return b

    def cache(*a, **kw):
        c = track_cache(*a, **kw)
        rec["track_dropped"].append(int(c.n_dropped))
        return c

    rs.compute_stream_binning, tracking.build_track_cache = binning, cache
    try:
        yield
    finally:
        rs.compute_stream_binning, tracking.build_track_cache = bin_stream, track_cache


def parse_buckets(text):
    return tuple(tuple(int(v) for v in e.split(":")) for e in text.split(",")) if text else None


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default=os.path.join(ROOT, "tree_check", "proc_room_data"))
    ap.add_argument("--workdir", default=os.path.join(ROOT, "tree_check", "proc_room_run"))
    ap.add_argument("--frames", type=int, default=200,
                    help="frames of the procedural trajectory")
    ap.add_argument("--stop-at", type=int, default=None,
                    help="write and run only the first N frames of the trajectory")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--max-per-tile", type=int, default=1024)
    ap.add_argument("--map-every", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=2_000_000)
    ap.add_argument("--escalate-tiles", type=int, default=0)
    ap.add_argument("--escalate-k", type=int, default=0)
    ap.add_argument("--buckets", default="128:4096,384:1024,768:512,-1:256",
                    help="capacity-class ladder n:k,... ('' = single class at --max-per-tile)")
    ap.add_argument("--track-buckets", default="",
                    help="tracking ladder n:k,... ('' = flat RS_TRACK_K slots, the default "
                         "of the configs since the real-scale tracking fix)")
    ap.add_argument("--gt-poses", action="store_true",
                    help="upper-bound calibration run: GT poses instead of tracking")
    ap.add_argument("--skip-gen", action="store_true")
    ap.add_argument("--workers", type=int, default=min(8, os.cpu_count() or 1),
                    help="processes that write the frames")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the report here")
    return ap


def resolve(args, env=None):
    """The run's config for parsed ``args``: ``build_config`` under the
    environment (``env``, default ``os.environ``) over :data:`ROW_ENV`."""
    W, H = int(1200 * args.scale), int(680 * args.scale)
    env = {**ROW_ENV, **(os.environ if env is None else env)}
    cfg = build_config(args.data, args.workdir, W, H, args.max_per_tile, args.map_every,
                       args.capacity, escalate_tiles=args.escalate_tiles,
                       escalate_k=args.escalate_k, gt_poses=args.gt_poses,
                       bucket_spec=parse_buckets(args.buckets),
                       track_bucket_spec=parse_buckets(args.track_buckets), env=env)
    if args.gt_poses:
        cfg["run_name"] = "proc_room_gtpose"
    if args.stop_at is not None:
        cfg["data"]["num_frames"] = min(args.stop_at, args.frames)
    return cfg


def raster_block(cfg):
    """The resolved raster settings a report is comparable by."""
    r = cfg["raster"]
    keys = ("max_per_tile", "bucket_spec", "track_max_per_tile", "track_bucket_spec",
            "sat_margin", "sat_floor", "track_sat_margin", "visible_budget", "backend",
            "stream_rows", "stream_cap", "grad_pair_budget", "grad_bf16")
    return {k: r[k] for k in keys} | {"map_capacity": cfg["map_capacity"]}


def run(argv=None, runner_hook=None):
    """Generate (unless present), run SLAM and the final eval, then the K
    against 2K check.  ``runner_hook(runner)`` is called on the
    ``SLAMRunner`` before it runs.  Returns (report, runner)."""
    args = parser().parse_args(argv)
    cfg = resolve(args)
    W, H = cfg["data"]["desired_image_width"], cfg["data"]["desired_image_height"]
    print("raster: " + json.dumps(raster_block(cfg)), flush=True)

    import torch

    from hierslam_torch import resolve_device
    from hierslam_torch.datasets import get_dataset
    from hierslam_torch.eval.runner import run_final_eval
    from hierslam_torch.ops import gather_vjp, kernels, render_pallas, render_stream
    from hierslam_torch.slam.pipeline import SLAMRunner

    dev = resolve_device(args.device)
    seq_dir = os.path.join(args.data, SEQ)
    gen_s = 0.0
    if not args.skip_gen and not os.path.isdir(seq_dir):
        t0 = time.time()
        generate(args.data, args.frames, W, H, stop_at=args.stop_at, workers=args.workers)
        gen_s = time.time() - t0
        print(f"wrote {cfg['data']['num_frames'] if args.stop_at else args.frames} frames "
              f"at {W}x{H} in {gen_s:.1f} s", flush=True)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    for counts in (render_pallas.plain_counts, render_stream.plain_counts,
                   gather_vjp.plain_counts):
        for k in counts:
            counts[k] = 0
    rec = {"binnings": [], "track_dropped": []}
    phases, decode_ms = [], []
    t0 = time.time()
    with recording(rec):
        runner = SLAMRunner(cfg, device=dev)
        load, mapper = runner._load_frame, runner.mapper

        def timed_load(t):
            s = time.time()
            out = load(t)
            decode_ms.append((time.time() - s) * 1e3)
            return out

        def phase(*a, **kw):
            rec["binnings"].clear()
            out = mapper(*a, **kw)
            rows = [r for r, _ in rec["binnings"]]
            losses = out[4]
            phases.append(dict(
                binnings=len(rows), max_stream_rows=max(rows, default=0),
                max_binning_dropped=max((d for _, d in rec["binnings"]), default=0),
                max_n_map_bin_dropped=int(losses["n_map_bin_dropped"].max()),
                max_n_grad_dropped=int(losses["n_grad_dropped"].max()),
                n_active=int(out[1]["active"].sum())))
            return out

        runner._load_frame, runner.mapper = timed_load, phase
        if runner_hook is not None:
            runner_hook(runner)
        params_np, summary = runner.run()
        results = run_final_eval(runner.dataset, params_np, runner.config, runner.eval_dir,
                                 mlp=runner._mlp_numpy(), num_frames=runner.num_frames,
                                 device=dev)
    wall = time.time() - t0
    launches = dict(kernels.launch_counts)
    plain = dict(render_pallas.plain_counts, **render_stream.plain_counts,
                 **gather_vjp.plain_counts)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None

    n_frames = params_np["cam_unnorm_rots"].shape[-1]
    dataset = get_dataset(config_dict=cfg["data"], basedir=args.data, sequence=SEQ, start=0,
                          end=-1, stride=1, desired_height=H, desired_width=W,
                          relative_pose=True)
    t1 = time.time()
    oq = overflow_quality_check(params_np, cfg, dataset, args.max_per_tile, n_frames,
                                device=dev)
    oq_s = time.time() - t1

    stream_rows = cfg["raster"]["stream_rows"]
    report = {
        "wall_s": round(wall, 1),
        "frames": n_frames,
        "image": [W, H],
        "mode": "gt_pose_upper_bound" if args.gt_poses else "full_slam",
        "summary": {k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in summary.items()},
        "metrics": {k: round(float(v), 4) for k, v in results.items()},
        "overflow_quality": {k: round(v, 2) for k, v in oq.items()},
        "device": card() if dev.type == "cuda" else "cpu",
        "raster": raster_block(cfg),
        "max_memory_allocated_GiB": None if peak is None else round(peak, 3),
        "stream_rows_budget": stream_rows,
        "max_stream_rows": max((p["max_stream_rows"] for p in phases), default=0),
        "mapping_phases": phases,
        "max_dropped": {
            "densify_binning": summary["bin_overflow_max"],
            "tracking_binning": max(rec["track_dropped"], default=0),
            "mapping_binning": max((p["max_binning_dropped"] for p in phases), default=0),
            "n_grad_dropped": max((p["max_n_grad_dropped"] for p in phases), default=0),
        },
        "launches": launches,
        "plain_calls": plain,
        "decode_ms_per_item": round(float(np.median(decode_ms)), 1) if decode_ms else None,
        "generate_s": round(gen_s, 1),
        "overflow_check_s": round(oq_s, 1),
    }
    return report, runner


def main(argv=None):
    report, runner = run(argv)
    text = json.dumps(report, indent=2)
    out_path = os.path.join(runner.output_dir, "real_shape_report.json")
    with open(out_path, "w") as f:
        f.write(text)
    args = parser().parse_args(argv)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    print(f"report -> {out_path}")


if __name__ == "__main__":
    main()
