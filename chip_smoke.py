#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``hierslam_torch``) on one card.

    python3 chip_smoke.py               # every phase
    python3 chip_smoke.py --kernels     # build + kernel checks only
    python3 chip_smoke.py --repeat 3    # the flagship SLAM run three times
    python3 chip_smoke.py --kernels --tracking-table FILE
                                        # time K1/K2 on the table in FILE
                                        # (recorded and written there if absent)

Phases, each of which must pass (the script exits non-zero otherwise):

1. environment: card name and power limit (nvidia-smi), kernel build with
   nvcc from ``hierslam_torch/csrc`` (one nvcc per source, in parallel),
   the ptxas report of K1-K5, ``bin_emit`` and the tracker's projection
   (``csrc/track.cu``) (registers, shared memory,
   spill bytes; a spill in any instantiation fails the run);
2. kernels: K1-K4 against their plain PyTorch versions at F = 1, 3, 29,
   32, 33, 64, 77 and 128 (every feature bucket's edges, the widest the
   kernels take; the padding cases of the backwards' warp reduce-scatter)
   on small inputs (up to 2 pixels of K1 may end on another slot than the
   plain version, each shown to be a rounding tie, as on the recorded
   tables below); then K1/K2 (ladder blend) at
   the tracking shape (T=3225, K=512, F=3) and one ladder mapping class
   (T=128, K=4096, F=29), random tables from a seed, the tracking shape's
   table again with its rows shuffled and each row blended at its tile id
   (what a ladder class launches), and on the run's own
   tracking table (what the first tracking iteration of frame 6 of the
   flagship run hands to K1, recorded by this script during phase 4, or,
   with ``--kernels``, during a run of frames 0-6 of its own); K3/K4 (stream
   blend) against theirs on the pair stream of a real map (frame 0 of the
   procedural room at 1200x680 back-projected, binned at the frame-0 pose
   with the flagship raster config) at F=29 and F=3, and at F = 77 K1/K2
   on a ladder class and K3/K4 on frame 0 at 640x480 binned with the
   ScanNet tree-large config; errors, the pixels
   whose last committed or median slot or pair differs from the plain
   version's (K1, K3), kernel and plain times (median of CUDA-event timings),
   roofline bounds; ``[kernels] cull thin``: K1 against its plain version
   on tables of thin gaussians (``tools/thin_gaussians.py``: lambda1 /
   lambda2 to 1e7 at 0-60 degrees, half with the tile at the ellipse's
   tip; F = 3 and 29), with the (warp, slot) a pixel takes that the plain
   cull drops (0 allowed) and would have dropped with the box K1 took
   before, and K3 on the thinnest conics its isotropic rows project to (at
   the frustum's clamps), each with the smallest (ac - b^2)/ac reached; K5
   against its plain version, to the bit, on three seeded inputs: shaped as
   the flagship's first mapping stream and as ``[tum]``'s first
   ladder-mapping backward, and an adversarial one (a run of 119,000
   references, longer than a stage of the kernel, cut by a pair budget;
   90% of the rows empty; C = nd = 135);
3. reference: a tiny SLAM run (3 frames, 96x64) on the GPU with the
   kernels against the same run on the CPU with the plain versions, once
   with the ladder mapper and once with the stream mapper; the per-frame
   tracking losses of both sides and the first frame and iteration that
   differ by more than 1e-4 are printed;
4. SLAM, the main path: frames 0-7 of the procedural room at 1200x680 with
   26 semantic channels, the flagship config
   (configs/replica/hierslam_semantic_run.py) as shipped
   (``raster.backend="stream"``): tracking on frames 1-7 (K1/K2), densify
   at t=7 (K1), stream mapping at t=0 and t=7 (K3/K4, and K5, the
   gather's backward, once an iteration); launch counts must
   equal what the config implies with no plain-version call, losses must
   be finite, ``params.npz`` must carry the JAX runner's keys; K5 on the
   first mapping iteration's backward (the pair stream's gather) against
   its plain version, to the bit, twice, timed beside ``index_add_``;
   ``bin_emit`` on frame 0's first stream binning's pair emission against
   its plain version (a boolean-mask compaction a cell row) on the same
   card tensors, to the bit, twice, timed; ``track_project_fwd`` and
   ``track_project_bwd`` on frame 6's first tracking iteration (its pose
   cache and the cotangent K2 handed back) against
   ``render_tracked.track_project_plain`` and its autograd on the same card
   tensors: the table and mask to the bit, each kernel twice to the bit,
   the pose gradient within 1e-3, timed (``check_track_project``);
5. ladder: the same config with ``raster.backend="pallas"`` on 3 frames
   (mapping at t=0 and, after a densify, at t=2), with its own count check;
6. cli, the disk-to-eval path: the 8 procedural frames written in the
   Replica semantic layout (the port's JPEG and PNG writers) and read back
   by the port's loader, which must match the frames; then ``python3 -m
   hierslam_torch.scripts.run_slam`` in-process on that sequence with the
   flagship config as shipped (checkpoints every 4 frames), its launch
   counts (tracking, densify, the t = 0 progress renders and the final
   eval's renders) and eval row; ``config["profile"]`` traces frame 6
   (tracked) and frame 7 (tracked, densified, mapped): each trace's span,
   device time, kernel launches and top kernels, and the launches per
   tracking and per mapping iteration; a second run that resumes at frame 4;
   K1 against its plain version on the table of the first eval render
   (F = 29); and ``run_final_eval`` on the GPU against the CPU on the final
   map of phase 3's stream run;
7. eval_novel_view, the standalone evaluation of a finished run: a random
   LPIPS file in the weights' schema (from a seed) added to the [cli] run's
   config, then ``python3 -m hierslam_torch.scripts.eval_novel_view``
   in-process on it (the final eval with ``save_frames``: per-frame PNGs,
   the per-level semantic figures, LPIPS); its row against [cli]'s at the
   printed precision, finite LPIPS, the PNG counts and sizes, its K1
   launches and K1 on its first eval table (F = 29); then
   ``run_final_eval`` with ``model.eval_gt_transfer`` on the GPU against
   the CPU on the 96x64 reference map, and LPIPS of one 1200x680 pair on
   the GPU against the CPU, timed;
8. scannet, the ScanNet path at F = 77: 6 procedural frames at 640x480
   with ScanNet's intrinsics written in the ScanNet semantic layout (JPEG
   colour, depth in mm, per-frame poses, 16-bit raw-id labels) with a
   raw -> NYU40 TSV, a (2, 3, 4, 7) NYU40 tree TSV and a tree-large TSV of
   (4, 8, 12, 20, 30) over 550 sparse raw ids, read back by the port's
   loader and checked; ``run_slam`` in-process on
   configs/scannet/hierslam_semantic_large_run.py as shipped (74 channels,
   F = 77, 550 leaves; ``basedir`` from ``SCANNET_DIR``, only ``workdir``
   and ``num_frames`` set), its launch counts, 0 plain calls, finite
   losses, 0 dropped pairs, camera-centre error, the sparse-id eval row and
   artifacts; K1 on its first F = 77 eval table and K3/K4 on its first
   mapping pair stream against their plain versions, with timings; then
   configs/scannet/hierslam_semantic_run.py (16 channels, F = 19) on 3 of
   the frames with the same checks;
9. replica, the two shipped Replica configs without semantics: the 8
   frames at 1200x680 in the plain Replica layout (no labels, no tree),
   ``python3 -m hierslam_torch.scripts.run_slam`` in-process on
   configs/replica/hierslam_nosemantic_run.py and hierslam_gtpose_run.py
   as shipped (``REPLICA_DIR`` set, only ``workdir`` and ``num_frames``
   changed): rank-ladder tracking with saturation capping, the ladder
   mapper with visible-rank compaction, F = 3; their launch counts, 0
   plain calls, finite losses, dropped pairs, the camera-centre error, the
   eval row, no semantic channels or decoder; with GT poses no tracking
   launch and the dataset's poses written; K1/K2 on the nosemantic run's
   first tracking (1,024-slot class) and ladder mapping (4,096) tables;
10. tum, the TUM path, the only one with lens distortion: 8 frames of the
   procedural room at 640x480 rendered with configs/data/tum.yaml's
   intrinsics, written in the TUM layout (timestamped PNGs, ``rgb.txt``,
   ``depth.txt``, ``groundtruth.txt`` at 30 Hz, depth x 5000) with the
   colour passed through tum.yaml's forward distortion, read back by the
   port's loader (association, undistortion) and checked; then
   configs/replica/hierslam_nosemantic_run.py through the CLI with only
   its ``data`` block pointed at tum.yaml and the sequence (480x640),
   ``workdir`` and ``num_frames`` changed, run twice with the float order
   free: both runs must read the same frame-7 camera-centre error to the
   bit (``tum_phase``); the checks of 9, K1/K2 on its first tracking table
   (the rank ladder's first class on the 40x30 tile grid, F = 3) and K5 on
   its ladder mapper's first backward, to the bit;
11. capacity: 3 frames at 96x64 with GT poses in a map of 8,192 slots on
   the GPU and on the CPU, each frame from the same state on both: the
   bucket grows, pruning holes are compacted and the least-opaque
   gaussians pruned; both sides' counts and compactions equal at every
   frame, their mapping losses within 1e-2;
12. real_shape: the first 16 frames of tools/real_shape_run_torch.py's
   200-frame run at 1200x680 with its configuration (F = 11), its map cut
   to 1,100,000 slots so that they reach compaction and the escalated
   prune, through the final eval and the K against 2K check; its launch
   counts, 0 plain calls, peak memory, stream rows against 78,000, dropped
   pairs; K3/K4 on its largest mapping stream and K1/K2 on the 2K check's
   densest class (8,192 slots a tile);
13. classic: configs/replica/hierslam_nosemantic_run.py (the ladder
   mapper, F = 3) on 8 procedural frames at 1200x680 with
   ``mapping.use_gaussian_splatting_densification=True``,
   ``raster.visible_budget=0`` and a densify schedule that fires at
   iterations 20 and 40 of each 60-iteration phase: the clones, splits
   and prunes of each event, the launch counts (every segment of a phase
   bins the window again and renders as before), 0 plain calls, finite
   losses and ``params.npz``; K1/K2 on the first mapping table after a
   densify event; then one classic phase of the 96x64 room on the GPU and
   the CPU from the same state, whose clone and split sets must be equal
   but for gaussians within 1e-3 of the gradient threshold (counted);
14. aniso: [classic]'s final map with per-axis log-scale offsets in
   [log 0.5, log 2] and random unit quaternions (a numpy seed), frames
   1-3 tracked again with the pose cache and without
   (``track_use_cache=False``): both tracking_iter_ms, the launch counts,
   K1/K2 on the cached tracker's first table; both trackers on the 96x64
   map made anisotropic, GPU against CPU (first loss and final pose
   within 1e-2);
15. visualize: ``python3 -m hierslam_torch.scripts.visualize`` on the
   [cli] run (``--frames-only --semantic --viz-scale 1.0 --every 4``):
   the PNGs, K1 launches, K1 on its first table; frame 0 through
   ``render_trajectory_frames`` on the GPU against the CPU at a quarter
   of the size;
16. parallel, keyframe data-parallel mapping and the tile-sharded render
   over ``torch.distributed`` (``gloo``), every rank on this one card: the
   flagship config as shipped with ``parallel.map_data_devices = 2`` on the
   8 frames at 1200x680 through ``SLAMRunner(cfg, mesh=...)``: finite
   losses, each rank's launch counts (the worker: K3/K4 of every mapping
   iteration, nothing else) and 0 plain calls, equal checksums of the ranks'
   maps at every phase's end, the camera-centre error, tracking_iter_ms,
   mapping_iter_ms and the phase-start broadcast's bytes and seconds; the
   tile-sharded render of its final map over 2 and 4 ranks against the
   single render (1e-5 image, 1e-4 depth at every pixel but those proven to
   part by a slot at a blend threshold, counted); at 96x64 the data-parallel
   mapper with equal columns against the single mapper with both backends
   with the float order free (JAX's test tolerances, equal rank
   checksums); K1 on the last strip's tables (rows past the image) and
   K3/K4 on rank 1's first mapping stream against their plain versions,
   with timings;
17. repro: the flagship's first 3 frames at 1200x680 with each mapper
   (``stream``, ``pallas``), twice in this process: every ``params.npz``
   array and every frame's pose equal to the bit.

The launch counts of phases 4-6 include the two t = 0 progress renders (K1
at each ``bucket_spec`` class) that ``SLAMRunner.step`` makes.  Every count
check holds ``bin_emit`` at one launch a binning on the card that emits a
pair (``count_binnings``), ``track_project_fwd`` and ``track_project_bwd``
at one launch each a cached tracking iteration (``track_launches``), and
the plain versions, the emission's (``binning.plain_counts``) and the
projection's (``render_tracked.plain_counts``) among them, at 0 calls.  Every ladder
render launches K1 (and K2) once a capacity class, each class at its true
tile ids into buffers the classes share; the K1/K2 checks on tables the
main path recorded take those tile ids.

The last two lines of standard output are a JSON object with the kernels'
numbers and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import glob
import importlib.util
import io
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import warnings
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
TILE = (16, 16)
P = TILE[0] * TILE[1]
RW = 128                       # pairs per stream row
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, float32 outside the tensor cores
SEM_LEVELS = (2, 3, 5, 7, 9)   # Replica tree shape: 26 channels over 5 levels
NUM_LEAF = 102
# tolerances of the kernel checks, held at every pixel and every slot: the
# kernels take transmittance as a sequential product, the plain versions as
# a cumprod, and sum over pixels in another order (float32)
TOL = {"acc": 1e-3, "ft": 1e-4, "med": 1e-4, "dtab_rel": 2e-3}
MAX_F = 128                    # the kernels' widest feature bucket (csrc/fwd.cuh)
# what params.npz holds (the JAX runner's keys)
PARAM_KEYS = ("means3D", "rgb_colors", "logit_opacities", "log_scales", "semantic",
              "unnorm_rotations", "cam_unnorm_rots", "cam_trans", "timestep", "intrinsics",
              "w2c", "gt_w2c_all_frames", "keyframe_time_indices", "org_width", "org_height")
# feature counts held on small inputs: each bucket's edges (F <= 3, 29, 32,
# and the wide bucket to 128) and the padding cases of the reduce-scatter
SMALL_F = (1, 3, 29, 32, 33, 64, 77, MAX_F)
SCANNET_LARGE = os.path.join(ROOT, "configs", "scannet", "hierslam_semantic_large_run.py")
SCANNET_F = 77                 # 3 colours + 74 tree-large channels
SCANNET_FRAME = dict(W=640, H=480, f=577.590698)   # configs/data/scannet_semantic.yaml
CAPACITY_SLOTS = 8192          # [capacity]: the 96x64 frame 0 inserts 6,144
REAL_SHAPE_FRAMES = 16         # [real_shape]: two densifies and three mapping phases
REAL_SHAPE_CAPACITY = 1_100_000   # [real_shape]: frame 0 inserts 816,000, frame 7 ~161,000


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


def walk_counts(terms, n_slots, live):
    """From ``render_xla.blend_terms`` of a chunk [B, P, K], per pixel: slot
    positions up to and including the one that ends it (``n_slots`` [B, 1]
    where none does); the plain version's two choices that K2 and K4 take
    from the forward kernels, [B, P, 2]: the index of the last committed slot
    and of the slot where T crosses 0.5, -1 where none; the committed
    pairs; and the (pixel, slot) tests the function needs, forward and
    backward: of those positions, and of the positions up to the last
    committed one, only the slots of ``live`` [B, K] (not masked; for the
    stream, valid pairs inside the tile's rows).  A slot that is not live
    costs its mask and no float operation."""
    import torch

    contrib, Ta, Tb, committed = terms[4], terms[6], terms[7], terms[8]
    K = contrib.shape[-1]
    comm = contrib & committed
    stop = contrib & ~committed
    ks = torch.arange(K, device=contrib.device)
    first_stop = torch.where(stop.any(-1), (stop * (K - ks)).argmax(-1) + 1,
                             n_slots.expand(stop.shape[:2]))
    none = torch.full_like(first_stop, -1)
    last = torch.where(comm.any(-1), K - 1 - comm.flip(-1).int().argmax(-1), none)
    crossing = comm & (Tb > 0.5) & (Ta < 0.5)
    med = torch.where(crossing.any(-1), crossing.int().argmax(-1), none)
    live = live[:, None, :]
    tests_fwd = int(((ks < first_stop[..., None]) & live).sum())
    tests_bwd = int(((ks <= last[..., None]) & live).sum())
    return first_stop, torch.stack([last, med], -1), int(comm.sum()), tests_fwd, tests_bwd


def pair_stats(table, ok, grid_x: int, tile_ids=None):
    """What the blend needs on this data (row b of the table tile
    ``tile_ids[b]``, b where None).  Tests: per pixel, the unmasked
    slots up to and including the one that ends it (forward) or up to the
    last committed one (backward); committed (blended) pairs.  Slots read:
    per tile, every position up to the largest of those over its pixels (a
    block retires once all its pixels have ended), for the forward and the
    backward, and the sum over pixels of the forward's positions.  Last: the
    plain version's choices [T, P, 2] (``walk_counts``)."""
    import torch

    from hierslam_torch.ops.render_xla import blend_terms, pixel_grid, tile_chunks

    T, K, _ = table.shape
    ids = torch.arange(T, device=table.device) if tile_ids is None else tile_ids.long()
    n_fwd = n_bwd = n_comm = n_pos = rows_fwd = rows_bwd = 0
    lasts = []
    with torch.no_grad():
        for lo, hi in tile_chunks(T, P, K):
            px, py = pixel_grid(ids[lo:hi], TILE, grid_x)
            terms = blend_terms(table[lo:hi], ok[lo:hi], px, py)
            first_stop, choice, comm, tests_fwd, tests_bwd = walk_counts(
                terms, torch.full((hi - lo, 1), K, device=table.device), ok[lo:hi])
            last = choice[..., 0]
            n_fwd += tests_fwd
            n_bwd += tests_bwd
            n_comm += comm
            n_pos += int(first_stop.sum())
            rows_fwd += int(first_stop.amax(-1).sum())
            rows_bwd += int((last + 1).amax(-1).sum())
            lasts.append(choice)
    return n_fwd, n_bwd, n_comm, n_pos, rows_fwd, rows_bwd, torch.cat(lasts)


def ptxas_summary(text: str):
    """Per kernel instantiation in ``nvcc -Xptxas -v`` output: registers,
    static shared memory and stack / spill bytes, as
    {"stream_bwd_kernel<29>": {"registers": 85, "smem": 8, "stack": 0,
    "spill_stores": 0, "spill_loads": 0}, ...}."""
    import re

    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
        if m:
            n = int(m.group(1))
            name, rest = m.group(2)[:n], m.group(2)[n:]
            t = re.match(r"IL[ib](\d+)E(?:L[ib](\d+)E)?", rest)
            args = ",".join(a for a in t.groups() if a is not None) if t else ""
            cur = out.setdefault(f"{name}<{args}>" if t else name, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


def n_beyond(err, tol) -> int:
    return int((err > tol).sum())


def bound(nbytes, ops):
    """Least time (ms) for ``nbytes`` of device memory traffic and ``ops``
    float32 operations, and which of the two sets it."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


FLIP_REL = 1e-5   # a tie: the plain T within this (relative) of the threshold


def flip_is_tie(table, ok, grid_x: int, t: int, p: int, out_k, choice_p, tile=None):
    """Whether pixel ``p`` of tile ``t``, where K1's last committed or median
    slot (``out_k`` = its acc, final T, median, last, mslot at that pixel)
    is not the plain version's (``choice_p``), differs only by rounding at a
    threshold.  Three things must hold.  Where the last slots differ, they
    are neighbours among the slots the pixel takes, and the plain
    transmittance after the later one is within ``FLIP_REL`` of 1e-4.  Where
    the median slots differ, the plain transmittance before or after each is
    within ``FLIP_REL`` of 0.5.  And K1's outputs are, within ``TOL``, what
    the plain terms give when they end at K1's slot and take K1's median
    slot.  ``tile`` (table [1, K, 7+F], slot mask [1, K]) gives tile ``t``
    alone, as ``stream_tile_table`` makes it for K3; slots then count from
    the tile's first pair.  Returns (ok, a line that says what was found)."""
    import torch

    from hierslam_torch.ops.render_xla import MEDIAN_DEFAULT, blend_terms, pixel_grid

    acc_k, ft_k, med_k, lk, mk = out_k
    lk, mk, lp, mp = int(lk), int(mk), int(choice_p[0]), int(choice_p[1])
    tab, ok_t = (table[t:t + 1], ok[t:t + 1]) if tile is None else tile
    px, py = pixel_grid(torch.tensor([t], device=tab.device), TILE, grid_x)
    terms = blend_terms(tab, ok_t, px[:, p:p + 1], py[:, p:p + 1])
    contrib, a, Ta, Tb = (terms[i][0, 0] for i in (4, 5, 6, 7))
    good, said = True, [f"tile {t} pixel {p}: last {lk} (plain {lp}) median slot {mk} (plain {mp})"]
    if lk != lp:
        lo, j = min(lk, lp), max(lk, lp)
        rel = abs(float(Ta[j]) / 1e-4 - 1.0)
        near = bool(contrib[j]) and not bool(contrib[lo + 1:j].any())
        good &= near and rel <= FLIP_REL
        said.append(f"plain T after slot {j} is {float(Ta[j]):.9g}, {rel:.2e} from 1e-4"
                    + ("" if near else "; the two slots are not neighbours"))
    if mk != mp:
        for m in (mk, mp):
            if m >= 0:
                rel = min(abs(float(Tb[m]) - 0.5), abs(float(Ta[m]) - 0.5)) / 0.5
                good &= rel <= FLIP_REL
                said.append(f"plain T around slot {m} is {float(Tb[m]):.9g} -> "
                            f"{float(Ta[m]):.9g}, {rel:.2e} from 0.5")
    ks = torch.arange(contrib.shape[0], device=tab.device)
    w = a * Tb * (contrib & (ks <= lk))
    feats = torch.cat([tab[0, :, 7:], tab[0, :, 6:7], torch.ones_like(tab[0, :, 6:7])], -1)
    e_acc = float((acc_k - w @ feats).abs().max())
    e_ft = abs(float(ft_k) - (float(Ta[lk]) if lk >= 0 else 1.0))
    e_med = abs(float(med_k) - (float(tab[0, mk, 6]) if mk >= 0 else MEDIAN_DEFAULT))
    good &= e_acc <= TOL["acc"] and e_ft <= TOL["ft"] and e_med <= TOL["med"]
    said.append(f"against the plain terms ended at slot {lk}: acc {e_acc:.3e} ft {e_ft:.3e} "
                f"med {e_med:.3e}")
    return good, "; ".join(said) + (" -- a tie" if good else " -- NOT a tie")


def check_kernels(name: str, table, ok, grid_x: int, reps: int, seed: int = 0,
                  flips_allowed: int = 0, tile_ids=None, n_tiles: Optional[int] = None,
                  bwd: bool = True):
    """K1/K2 against their plain versions on a table [T, K, 7+F] with slot
    mask ``ok``; with ``reps`` > 0 also their times and bounds; with ``bwd``
    False K1 alone, untimed (returns (None, ok)).  ``seed``
    makes K2's cotangents.  With ``tile_ids`` ([T] int32), row b of the table
    is tile ``tile_ids[b]`` of a grid of ``n_tiles`` (a ladder class as the
    main path launches it: its true pixels, its rows of the buffers the
    classes share); without, row b is tile b.  Returns (JSON rows or None,
    ok).

    ``flips_allowed`` is for a table no seed was picked for (the recorded
    tables; the small seeded ones at every F).  K1 takes transmittance as a
    sequential product, the plain version as a cumprod; where the two round
    apart at
    the 1e-4 cutoff, a pixel ends one slot earlier or later, and its outputs
    differ by that slot's weight, which no tolerance bounds; where they
    round apart at 0.5, the median depth is another slot's or none.  At
    most that many pixels may have a last committed slot or a median slot
    other than the plain version's, and each must be such a tie
    (``flip_is_tie``); any other difference fails.  K2 is then given zero
    cotangents at those pixels, so that every slot of every tile is held on
    the other pixels.  With 0, every pixel and slot is held as it is."""
    import torch

    from hierslam_torch.ops import kernels, render_pallas

    dev = table.device
    T, K, C = table.shape
    F = C - 7
    if tile_ids is not None:
        name += " at true tile ids"
    n_all = T if n_tiles is None else n_tiles
    rows = torch.arange(T, device=dev) if tile_ids is None else tile_ids.long()
    out = kernels.blend_fwd(table, ok, grid_x, TILE, tile_ids, n_tiles=n_all)
    torch.cuda.synchronize()
    acc, ft, med, last, mslot = (x[rows] for x in out)    # row b: table row b's tile
    acc_p, ft_p, med_p = render_pallas.blend_fwd_plain(table, ok, grid_x, TILE, tile_ids)
    e_acc = (acc - acc_p).abs().amax(-1)
    e_ft = (ft - ft_p).abs()
    e_med = (med - med_p).abs()
    n_fwd, n_bwd, n_comm, n_pos, rows_fwd, rows_bwd, choice_p = pair_stats(table, ok, grid_x,
                                                                         tile_ids)
    flipped = (torch.stack([last, mslot], -1) != choice_p).any(-1)
    n_flip = int(flipped.sum())
    held = ~flipped if flips_allowed else torch.ones_like(flipped)
    n_fl = (n_beyond(e_acc[held], TOL["acc"]) + n_beyond(e_ft[held], TOL["ft"])
            + n_beyond(e_med[held], TOL["med"]))
    fwd_err = max(float(e_acc.max()), float(e_ft.max()), float(e_med.max()))
    fwd_ok = n_fl == 0 and (not flips_allowed or n_flip <= flips_allowed)
    print(f"[kernels] {name} K1: max abs err acc {float(e_acc.max()):.3e} ft "
          f"{float(e_ft.max()):.3e} med {float(e_med.max()):.3e}; pixels beyond "
          f"tolerance {n_fl} of {int(held.sum())} (allowed 0); pixels whose last committed "
          f"or median slot differs from the plain version's {n_flip}"
          + (f" (allowed {flips_allowed}, each held to be a rounding tie)"
             if flips_allowed else ""), flush=True)
    if flips_allowed and fwd_ok:
        for b, p in flipped.nonzero().tolist():
            tie, said = flip_is_tie(table, ok, grid_x, int(rows[b]), p,
                                    (acc[b, p], ft[b, p], med[b, p], last[b, p], mslot[b, p]),
                                    choice_p[b, p], tile=(table[b:b + 1], ok[b:b + 1]))
            print(f"[kernels] {name} K1: {said}", flush=True)
            fwd_ok &= tie
    if not bwd:
        return None, fwd_ok

    g = torch.Generator(device=dev).manual_seed(seed + 1)
    gacc = torch.randn(out[0].shape, generator=g, device=dev)
    gft = torch.randn(out[1].shape, generator=g, device=dev)
    gmed = torch.randn(out[2].shape, generator=g, device=dev)
    if flips_allowed:   # a tie pixel adds nothing to either side's sums
        tie_px = torch.zeros(out[1].shape, dtype=torch.bool, device=dev)
        tie_px[rows] = flipped
        gacc[tie_px], gft[tie_px], gmed[tie_px] = 0.0, 0.0, 0.0
    res = (out[1], out[3], out[4])     # final T, last, median slot of every row
    dtab = kernels.blend_bwd(table, ok, *res, gacc, gft, gmed, grid_x, TILE, tile_ids)
    torch.cuda.synchronize()
    dtab_p = render_pallas.blend_bwd_plain(table, ok, gacc, gft, gmed, grid_x, TILE, tile_ids)
    e_d = (dtab - dtab_p).abs()
    rel = (e_d / (1.0 + dtab_p.abs())).amax(-1)
    n_fl_b = n_beyond(rel, TOL["dtab_rel"])
    bwd_err = float(e_d.max())
    bwd_ok = n_fl_b == 0
    print(f"[kernels] {name} K2: max abs err {bwd_err:.3e}, max err/(1+|ref|) "
          f"{float(rel.max()):.3e}; slots beyond tolerance {n_fl_b} of {T * K} "
          "(allowed 0)" + (f", cotangents 0 at the {n_flip} tie pixels" if n_flip else ""),
          flush=True)
    pad_ok = bool((dtab[~ok] == 0).all())
    if not pad_ok:
        print(f"[kernels] {name} K2: masked slots got a nonzero gradient", flush=True)
    if not reps:
        return None, fwd_ok and bwd_ok and pad_ok

    ms_f = cuda_ms(lambda: kernels.blend_fwd(table, ok, grid_x, TILE, tile_ids, out), reps)
    ms_b = cuda_ms(lambda: kernels.blend_bwd(table, ok, *res, gacc, gft, gmed, grid_x, TILE,
                                             tile_ids), reps)
    plain_f = cuda_ms(lambda: render_pallas.blend_fwd_plain(table, ok, grid_x, TILE, tile_ids),
                      3)
    plain_b = cuda_ms(lambda: render_pallas.blend_bwd_plain(table, ok, gacc, gft, gmed,
                                                            grid_x, TILE, tile_ids), 3)
    pix = T * P
    # table and mask rows up to each tile's last needed slot; per pixel K1
    # writes acc, ft, med, last, mslot and K2 reads them back with gft and
    # gmed; K2 writes all of dtab.  Operations: 12 per (pixel, unmasked slot)
    # test and the blend or suffix-sum terms per committed pair.
    f_bytes = rows_fwd * (C * 4 + 1) + pix * ((F + 2) + 4) * 4
    f_ops = 12 * n_fwd + (2 * (F + 2) + 4) * n_comm
    b_bytes = rows_bwd * (C * 4 + 1) + pix * ((F + 2) + 5) * 4 + T * K * C * 4
    b_ops = 12 * n_bwd + (4 * (F + 2) + 30 + C) * n_comm

    bf, bf_by = bound(f_bytes, f_ops)
    bb, bb_by = bound(b_bytes, b_ops)
    print(f"[kernels] {name}: K1 {ms_f:.4f} ms (plain {plain_f:.3f} ms, bound {bf:.4f} ms "
          f"by {bf_by}); K2 {ms_b:.4f} ms (plain {plain_b:.3f} ms, bound {bb:.4f} ms by "
          f"{bb_by}); (pixel, unmasked slot) tests fwd {n_fwd} bwd {n_bwd} blended {n_comm} "
          f"({100 * n_comm / max(n_fwd, 1):.2f}% of the tests, "
          f"{100 * n_comm / max(n_pos, 1):.2f}% of the {n_pos} slot positions walked); table "
          f"rows read fwd "
          f"{rows_fwd} bwd {rows_bwd} of {T * K}", flush=True)
    rows = [
        dict(kernel="blend_fwd", name=f"blend_fwd_K1[{name}]", route="cuda",
             source="hierslam_torch/csrc/blend.cu",
             replaces="hierslam_tpu/ops/render_pallas.py:117", ms=ms_f, plain_ms=plain_f,
             bound_ms=bf, bound_by=bf_by, library_ms=None, max_abs_err=fwd_err),
        dict(kernel="blend_bwd", name=f"blend_bwd_K2[{name}]", route="cuda",
             source="hierslam_torch/csrc/blend.cu",
             replaces="hierslam_tpu/ops/render_pallas.py:155", ms=ms_b, plain_ms=plain_b,
             bound_ms=bb, bound_by=bb_by, library_ms=None, max_abs_err=bwd_err),
    ]
    return rows, fwd_ok and bwd_ok and pad_ok


def stream_inputs(cfg_path: str, n_feat: int, W: int = 1200, H: int = 680, f: float = 600.0):
    """The pair stream the main path's first mapping iteration blends: frame
    0 of the procedural room back-projected (one gaussian per pixel, F - 3
    semantic channels drawn from a seeded generator: 26 for the flagship's
    F = 29; F < 3 keeps the first F colours) in a map of SLAMRunner's first
    bucket of slots (the
    emission budgets of the binning scale with the slot count), the
    inactive slots at the sentinel logit, binned at the frame-0 pose with
    the flagship raster config and the mapper's 4 px margin."""
    import numpy as np
    import torch

    from hierslam_torch.config import load_config, raster_config
    from hierslam_torch.core import gaussians as G
    from hierslam_torch.core import transforms
    from hierslam_torch.core.camera import setup_camera
    from hierslam_torch.ops import render_stream as rs

    dev = torch.device("cuda")
    ds = room_dataset(1, W, H, f)
    color, depth, K4, c2w, _ = ds[0]
    w2c = np.linalg.inv(c2w)
    camera = setup_camera(W, H, K4[:3, :3], w2c)
    im = torch.as_tensor(color.transpose(2, 0, 1) / 255.0, dtype=torch.float32, device=dev)
    d = torch.as_tensor(np.asarray(depth), dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(0)
    fl = G.pointcloud_fields(im, d, K4[:3, :3], w2c, n_feat - 3, gen)
    n = fl["means3D"].shape[0]
    step, headroom = 512 * 1024, 256 * 1024            # SLAMRunner's bucket defaults
    bucket = -(-(n + headroom) // step) * step
    active = torch.arange(bucket, device=dev) < n
    keys = ["means3D", "log_scales", "logit_opacities", "rgb_colors"]
    keys += ["semantic"] if n_feat > 3 else []
    fl = {k: torch.cat([v, torch.zeros((bucket - n,) + v.shape[1:], device=dev)])
          for k, v in fl.items()}
    table = torch.cat([fl[k] for k in keys], 1)[:, :5 + n_feat].contiguous()
    table[~active, rs.COL_LOGIT] = rs.SENTINEL_LOGIT
    rc = raster_config(load_config(cfg_path))
    w2c_t = torch.as_tensor(w2c, dtype=torch.float32, device=dev)
    q = transforms.matrix_to_quaternion(w2c_t[:3, :3])
    means_cam, _ = transforms.transform_to_frame(fl["means3D"], fl["unnorm_rotations"], q,
                                                 w2c_t[:3, 3], gaussians_grad=False,
                                                 camera_grad=False)
    b = rs.compute_stream_binning(means_cam, torch.exp(fl["log_scales"]),
                                  fl["unnorm_rotations"], camera, rc, active=active,
                                  margin_px=4.0, opacities=torch.sigmoid(fl["logit_opacities"]))
    table_s = torch.cat([table, rs.sentinel_row(table.shape[1], dev)], 0)
    stream = table_s[b.lists.idx].contiguous()
    sc = rs.make_scalars(transforms.build_w2c(transforms.normalize(q), w2c_t[:3, 3]), camera)
    return stream, sc, b.lists, b.lists.idx == bucket, rc.grid(H, W), (H, W)


def stream_pair_stats(stream, sc, row_off, grid, n_feat, img_shape):
    """What the stream blend needs on this data, as ``pair_stats`` counts it
    for the ladder: per pixel the valid pairs up to and including the one
    that ends it (forward) or up to its last committed pair (backward), the
    committed pairs, and per tile the rows read: up to the row where its
    last pixel ends (forward) or that holds its last committed pair
    (backward); and the plain version's choices [T, P, 2] (``walk_counts``)
    as stream positions."""
    import torch

    from hierslam_torch.ops import render_stream as rs
    from hierslam_torch.ops.render_xla import tile_chunks

    T = row_off.shape[0] - 1
    flat = stream.reshape(-1, stream.shape[-1])
    k_max = rs.max_tile_pairs(row_off)
    n_fwd = n_bwd = n_comm = n_pos = rows_fwd = rows_bwd = 0
    lasts = []
    with torch.no_grad():
        for lo, hi in tile_chunks(T, P, k_max):
            pos, inside = rs.tile_view(flat, row_off, lo, hi, k_max)
            tids = torch.arange(lo, hi, device=stream.device)
            _, terms, _ = rs.blend_view(flat[pos], inside, sc, tids, grid[1], TILE, n_feat,
                                        img_shape)
            valid = rs.project_pairs(flat[pos], sc, (tids % grid[1]).float()[:, None],
                                     (tids // grid[1]).float()[:, None], float(img_shape[1]),
                                     float(img_shape[0]), TILE)["valid"]
            first_stop, choice, comm, tests_fwd, tests_bwd = walk_counts(
                terms, inside.sum(-1, keepdim=True), valid & inside)
            last = choice[..., 0]
            n_fwd += tests_fwd
            n_bwd += tests_bwd
            n_comm += comm
            n_pos += int(first_stop.sum())
            rows_fwd += int(((first_stop.amax(-1) + RW - 1) // RW).sum())
            rows_bwd += int((last.amax(-1) // RW + 1).clamp_min(0).sum())
            lasts.append(torch.where(choice >= 0,
                                     choice + row_off[lo:hi, None, None].long() * RW, choice))
    return n_fwd, n_bwd, n_comm, n_pos, rows_fwd, rows_bwd, torch.cat(lasts)


def check_stream_kernels(cfg_path: str, n_feat: int, reps: int, **size):
    """K3/K4 against their plain versions on the pair stream of
    ``stream_inputs`` (``size``: W, H, f of another frame); with ``reps``
    > 0 also their times and bounds.  Returns (JSON rows or None, ok)."""
    stream, sc, lists, pad, grid, img = stream_inputs(cfg_path, n_feat, **size)
    ro = lists.row_off
    R = stream.shape[0]
    name = (f"flagship stream R={R} F={n_feat}" if not size else
            f"stream {size['W']}x{size['H']} R={R} F={n_feat}")
    print(f"[kernels] {name}: n_rows {int(lists.n_rows)} n_refs {int(lists.n_refs)} n_dropped "
          f"{int(lists.n_dropped)} n_sat_masked {int(lists.n_sat_masked)} max rows a tile "
          f"{int((ro[1:] - ro[:-1]).max())}", flush=True)
    return check_stream(name, stream, sc, ro, pad, grid, n_feat, img, reps)


def stream_tile_table(stream, sc, ro, grid, n_feat: int, img, t: int):
    """Tile ``t`` of a pair stream as a ladder table [1, K, 7+F] with its slot
    mask [1, K]: its pairs projected as K3 projects them, in stream order."""
    import torch

    from hierslam_torch.ops import render_stream as rs

    flat = stream.reshape(-1, stream.shape[-1])
    k = (int(ro[t + 1]) - int(ro[t])) * RW
    pos, inside = rs.tile_view(flat, ro, t, t + 1, k)
    tids = torch.tensor([t], device=stream.device)
    ladder, _, _ = rs.blend_view(flat[pos], inside, sc, tids, grid[1], TILE, n_feat, img)
    valid = rs.project_pairs(flat[pos], sc, (tids % grid[1]).float()[:, None],
                             (tids // grid[1]).float()[:, None], float(img[1]), float(img[0]),
                             TILE)["valid"]
    return ladder, valid & inside


def check_stream(name: str, stream, sc, ro, pad, grid, n_feat: int, img, reps: int,
                 flips_allowed: int = 0):
    """K3/K4 against their plain versions on a pair stream [R, 128, 5+F]
    (scalars ``sc``, row offsets ``ro``, ``pad`` the pairs that must get an
    exact 0 gradient) of a ``grid`` of tiles over an image of shape
    ``img``; with ``reps`` > 0 also their times and bounds.
    ``flips_allowed`` is ``check_kernels``'s tie rule for a recorded
    stream: at most that many pixels may end on another pair than the
    plain version's, each proven a rounding tie by ``flip_is_tie`` on its
    tile, and K4 gets zero cotangents there.  Returns (JSON rows or None,
    ok)."""
    import torch

    from hierslam_torch.ops import kernels, render_stream as rs

    R, _, C = stream.shape
    T = grid[0] * grid[1]
    F = n_feat
    acc, ft, med, last, mpos = kernels.stream_fwd(stream, sc, ro, grid[1], TILE, F, img)
    torch.cuda.synchronize()
    acc_p, ft_p, med_p = rs.blend_stream_fwd_plain(stream, sc, ro, grid, TILE, F, img)
    e_acc = (acc - acc_p).abs().amax(-1)
    e_ft = (ft - ft_p).abs()
    e_med = (med - med_p).abs()
    n_fwd, n_bwd, n_comm, n_pos, rows_fwd, rows_bwd, choice_p = stream_pair_stats(
        stream, sc, ro, grid, F, img)
    flipped = (torch.stack([last, mpos], -1) != choice_p).any(-1)
    n_flip = int(flipped.sum())
    held = ~flipped if flips_allowed else torch.ones_like(flipped)
    n_fl = (n_beyond(e_acc[held], TOL["acc"]) + n_beyond(e_ft[held], TOL["ft"])
            + n_beyond(e_med[held], TOL["med"]))
    fwd_err = max(float(e_acc.max()), float(e_ft.max()), float(e_med.max()))
    fwd_ok = n_fl == 0 and (not flips_allowed or n_flip <= flips_allowed)
    print(f"[kernels] {name} K3: max abs err acc {float(e_acc.max()):.3e} ft "
          f"{float(e_ft.max()):.3e} med {float(e_med.max()):.3e}; pixels beyond tolerance "
          f"{n_fl} of {int(held.sum())} (allowed 0); pixels whose last committed or median pair "
          f"differs from the plain version's {n_flip}"
          + (f" (allowed {flips_allowed}, each held to be a rounding tie)"
             if flips_allowed else ""), flush=True)
    if flips_allowed and fwd_ok:
        for t, p in flipped.nonzero().tolist():
            base = int(ro[t]) * RW          # stream position of the tile's first pair
            own = [v - base if v >= 0 else v for v in (int(last[t, p]), int(mpos[t, p]))]
            tie, said = flip_is_tie(None, None, grid[1], t, p,
                                    (acc[t, p], ft[t, p], med[t, p], *own),
                                    [v - base if v >= 0 else v for v in choice_p[t, p].tolist()],
                                    tile=stream_tile_table(stream, sc, ro, grid, F, img, t))
            print(f"[kernels] {name} K3: {said}", flush=True)
            fwd_ok &= tie

    g = torch.Generator(device="cuda").manual_seed(7)
    gacc = torch.randn(acc.shape, generator=g, device="cuda")
    gft = torch.randn(ft.shape, generator=g, device="cuda")
    gmed = torch.randn(med.shape, generator=g, device="cuda")
    if flips_allowed:   # a tie pixel adds nothing to either side's sums
        gacc[flipped], gft[flipped], gmed[flipped] = 0.0, 0.0, 0.0
    dtab = kernels.stream_bwd(stream, sc, ro, ft, last, mpos, gacc, gft, gmed, grid[1], TILE,
                              F, img)
    torch.cuda.synchronize()
    dtab_p = rs.blend_stream_bwd_plain(stream, sc, ro, gacc, gft, gmed, grid, TILE, F, img,
                                       mpos=mpos)
    e_d = (dtab - dtab_p).abs()
    rel = (e_d / (1.0 + dtab_p.abs())).amax(-1)
    n_fl_b = n_beyond(rel, TOL["dtab_rel"])
    bwd_err = float(e_d.max())
    pad_ok = bool((dtab[pad] == 0).all())
    print(f"[kernels] {name} K4: max abs err {bwd_err:.3e}, max err/(1+|ref|) "
          f"{float(rel.max()):.3e}; pairs beyond tolerance {n_fl_b} of {R * RW} (allowed 0); "
          f"{int(pad.sum())} pad pairs, all exactly 0: {pad_ok}"
          + (f"; cotangents 0 at the {n_flip} tie pixels" if flips_allowed and n_flip else ""),
          flush=True)
    if not reps:
        return None, fwd_ok and n_fl_b == 0 and pad_ok

    ms_f = cuda_ms(lambda: kernels.stream_fwd(stream, sc, ro, grid[1], TILE, F, img), reps)
    ms_b = cuda_ms(lambda: kernels.stream_bwd(stream, sc, ro, ft, last, mpos, gacc, gft, gmed,
                                              grid[1], TILE, F, img), reps)
    plain_f = cuda_ms(lambda: rs.blend_stream_fwd_plain(stream, sc, ro, grid, TILE, F, img), 3)
    plain_b = cuda_ms(lambda: rs.blend_stream_bwd_plain(stream, sc, ro, gacc, gft, gmed, grid,
                                                        TILE, F, img, mpos=mpos), 3)
    pix = T * P
    row_bytes = RW * C * 4
    # rows up to each tile's last needed pair; per pixel K3 writes acc, ft,
    # med, last, mpos and K4 reads them back with gft, gmed; K4 writes the
    # whole d stream.  Operations: ~100 (K3) / ~250 (K4) per projected pair,
    # 12 per (pixel, valid pair) test, and the blend or suffix-sum terms per
    # committed pair.
    f_bytes = rows_fwd * row_bytes + pix * ((F + 2) + 4) * 4
    f_ops = 100 * rows_fwd * RW + 12 * n_fwd + (2 * (F + 2) + 4) * n_comm
    b_bytes = rows_bwd * row_bytes + pix * ((F + 2) + 5) * 4 + R * row_bytes
    b_ops = 250 * rows_bwd * RW + 12 * n_bwd + (4 * (F + 2) + 30 + C) * n_comm
    bf, bf_by = bound(f_bytes, f_ops)
    bb, bb_by = bound(b_bytes, b_ops)
    print(f"[kernels] {name}: K3 {ms_f:.4f} ms (plain {plain_f:.3f} ms, bound {bf:.4f} ms by "
          f"{bf_by}); K4 {ms_b:.4f} ms (plain {plain_b:.3f} ms, bound {bb:.4f} ms by {bb_by}); "
          f"(pixel, valid pair) tests fwd {n_fwd} bwd {n_bwd} blended {n_comm} "
          f"({100 * n_comm / max(n_fwd, 1):.2f}% of the tests, "
          f"{100 * n_comm / max(n_pos, 1):.2f}% of the {n_pos} pair positions walked); stream "
          f"rows read fwd "
          f"{rows_fwd} bwd {rows_bwd} of {R}", flush=True)
    rows = [
        dict(kernel="stream_fwd", name=f"stream_fwd_K3[{name}]", route="cuda",
             source="hierslam_torch/csrc/stream.cu",
             replaces="hierslam_tpu/ops/render_stream.py:244", ms=ms_f, plain_ms=plain_f,
             bound_ms=bf, bound_by=bf_by, library_ms=None, max_abs_err=fwd_err),
        dict(kernel="stream_bwd", name=f"stream_bwd_K4[{name}]", route="cuda",
             source="hierslam_torch/csrc/stream.cu",
             replaces="hierslam_tpu/ops/render_stream.py:332", ms=ms_b, plain_ms=plain_b,
             bound_ms=bb, bound_by=bb_by, library_ms=None, max_abs_err=bwd_err),
    ]
    return rows, fwd_ok and n_fl_b == 0 and pad_ok


@functools.lru_cache(maxsize=2)
def room_dataset(n: int, W: int, H: int, f: float, n_frames_arc: int = 200):
    """Procedural room frames (tools/procedural_room.py) with labels mapped
    onto a (2, 3, 5, 7, 9)-level tree with 102 leaves and the loaders'
    palette (``colors_map_all``, which ``model.eval_gt_transfer`` reads);
    poses relative to frame 0."""
    import numpy as np

    from hierslam_torch.datasets.tree import label_colormap

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
        colors_map_all = label_colormap(256)
        raw_c2w = [fr[2] for fr in frames]           # as a trajectory file holds them

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


def reference_phase(cfg_path: str, backend: str):
    """The same tiny run on the GPU (kernels) and the CPU (plain versions)."""
    import numpy as np

    from hierslam_torch.config import load_config
    from hierslam_torch.slam.pipeline import SLAMRunner

    ds = room_dataset(3, 96, 64, 48.0, n_frames_arc=40)
    traces = {}
    final = None
    for dev in ("cuda", "cpu"):
        cfg = load_config(cfg_path)
        cfg["raster"].update(backend=backend, bucket_spec=((4, 512), (-1, 256)),
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
        if dev == "cuda":
            final = (ds, r.finalize(), r._mlp_numpy(), cfg)
    g, c = traces["cuda"], traces["cpu"]
    rel = np.abs(g[0] - c[0]) / np.abs(c[0])                  # [frames 1.., iterations]
    for i in range(rel.shape[0]):
        print(f"[reference] {backend} mapper frame {i + 1} tracking loss, first -> last "
              f"iteration: GPU {g[0][i, 0]:.9g} -> {g[0][i, -1]:.9g}, CPU {c[0][i, 0]:.9g} -> "
              f"{c[0][i, -1]:.9g}, max rel diff {rel[i].max():.3e} at iteration "
              f"{int(rel[i].argmax())}", flush=True)
    off = np.argwhere(rel > 1e-4)
    print(f"[reference] {backend} mapper: first tracking loss that differs by more than 1e-4: "
          + (f"frame {off[0][0] + 1} iteration {off[0][1]} ({rel[tuple(off[0])]:.3e})"
             if len(off) else "none") + f"; mapping loss (after frame 2) max rel diff "
          f"{np.max(np.abs(g[1] - c[1]) / np.abs(c[1])):.3e} at iteration "
          f"{int(np.argmax(np.abs(g[1] - c[1]) / np.abs(c[1])))}", flush=True)
    d_track = float(rel.max())
    d_map = float(np.max(np.abs(g[1] - c[1]) / np.abs(c[1])))
    d_traj = float(np.max(np.abs(g[2] - c[2])))
    print(f"[reference] {backend} mapper, GPU kernels vs CPU plain, 3 frames 96x64: "
          f"tracking loss rel "
          f"{d_track:.6e}, mapping loss rel {d_map:.6e}, trajectory abs {d_traj:.6e} m "
          "(tolerances 1e-2, 1e-2, 1e-3: float32 sums in another order, compounded "
          "over 10 Adam steps)", flush=True)
    return d_track <= 1e-2 and d_map <= 1e-2 and d_traj <= 1e-3, final


RECORD_FRAME = 6   # the frame whose first tracking table is kept


def k1_record(table, ok, grid_x, tile_shape=TILE, tile_ids=None, out=None, n_tiles=None):
    """A copy of what a K1 call blends: (table, slot mask, grid_x, tile ids or
    None, rows of its output buffers), the arguments ``check_kernels``
    takes."""
    rows = out[0].shape[0] if out is not None else n_tiles or table.shape[0]
    return (table.detach().clone(), ok.clone(), grid_x,
            None if tile_ids is None else tile_ids.clone(), rows)


def differentiable(table) -> bool:
    """Whether a K1 table is a differentiable render's: it, or the run of
    slots whose class it is (``render_pallas.blend_run``, the tracker's),
    requires a gradient."""
    return table.requires_grad or (table._base is not None and table._base.requires_grad)


@contextlib.contextmanager
def recording_blend_fwd(seen: list, n_feat: Optional[int] = None, pick=None,
                        outputs: Optional[list] = None):
    """While active, the first call of the wrapper ``kernels.blend_fwd`` (with
    ``n_feat`` features, when given, and a table for which ``pick(table)``
    holds, when given) leaves its ``k1_record`` in ``seen`` and, with
    ``outputs``, what it returned (acc, final T, median, last and median
    slot of every tile of the render) in ``outputs``.  The wrapper is
    wrapped from here, the package has no hook for it; every call still
    goes to the kernel."""
    from hierslam_torch.ops import kernels

    launch = kernels.blend_fwd

    def recording(table, ok, grid_x, tile_shape, *args, **kwargs):
        first = (not seen and (n_feat is None or table.shape[-1] - 7 == n_feat)
                 and (pick is None or pick(table)))
        if first:
            seen.append(k1_record(table, ok, grid_x, tile_shape, *args, **kwargs))
        out = launch(table, ok, grid_x, tile_shape, *args, **kwargs)
        if first and outputs is not None:
            outputs.append(out)
        return out

    kernels.blend_fwd = recording
    try:
        yield
    finally:
        kernels.blend_fwd = launch


@contextlib.contextmanager
def recording_gather_bwd(seen: list):
    """While active, the first call of the wrapper ``kernels.gather_bwd``
    leaves copies of its arguments (cotangent rows, spos, ends, summed
    columns, bf16 rounding) in ``seen``, in host memory, so that they add
    nothing to the run's peak device memory; every call still goes to the
    kernel."""
    from hierslam_torch.ops import kernels

    launch = kernels.gather_bwd

    def recording(cot, spos, ends, n_diff, grad_bf16):
        if not seen:
            seen.append((cot.cpu(), spos.cpu(), ends.cpu(), n_diff, grad_bf16))
        return launch(cot, spos, ends, n_diff, grad_bf16)

    kernels.gather_bwd = recording
    try:
        yield
    finally:
        kernels.gather_bwd = launch


def moved(x, device):
    """``x`` with every tensor in it (nested in tuples) on ``device``."""
    if isinstance(x, tuple):
        return tuple(moved(y, device) for y in x)
    return x.to(device) if hasattr(x, "to") else x


@contextlib.contextmanager
def recording_emit_pairs(seen: list):
    """While active, the first pair emission of a stream binning (the call
    of ``binning.emit_pairs`` inside ``binning.bin_stream``, the stream
    mapper's binning) leaves copies of its arguments in ``seen``, in host
    memory, so that they add nothing to the run's peak device memory.  Both
    are wrapped from here, the package has no hook for them; every call
    still goes to the kernel."""
    from hierslam_torch.ops import binning

    bin_stream, emit, inside = binning.bin_stream, binning.emit_pairs, [False]

    def stream_binning(*args, **kwargs):
        inside[0] = True
        try:
            return bin_stream(*args, **kwargs)
        finally:
            inside[0] = False

    def recording(*args):
        if inside[0] and not seen:
            seen.append(moved(args, "cpu"))
        return emit(*args)

    binning.bin_stream, binning.emit_pairs = stream_binning, recording
    try:
        yield
    finally:
        binning.bin_stream, binning.emit_pairs = bin_stream, emit


@contextlib.contextmanager
def recording_track_project(seen: list):
    """While active, the first tracking iteration's projection leaves in
    ``seen``, in host memory, the arguments of its ``kernels.track_project_fwd``
    call (the pose cache's rows, valid, tile, the 28 scalars, grid_x, image
    and tile shape), then the table's cotangent its ``track_project_bwd``
    got.  Both wrappers are wrapped from here, the package has no hook for
    them; every call still goes to the kernels."""
    from hierslam_torch.ops import kernels

    fwd, bwd = kernels.track_project_fwd, kernels.track_project_bwd

    def recording_fwd(*args):
        if not seen:
            seen.append(moved(tuple(args), "cpu"))
        return fwd(*args)

    def recording_bwd(rows, gtable, scalars, img_shape):
        if len(seen) == 1:
            seen.append(gtable.cpu())
        return bwd(rows, gtable, scalars, img_shape)

    kernels.track_project_fwd, kernels.track_project_bwd = recording_fwd, recording_bwd
    try:
        yield
    finally:
        kernels.track_project_fwd, kernels.track_project_bwd = fwd, bwd


def check_track_project(name: str, rec, reps: int = 20):
    """``track_project_fwd`` and ``track_project_bwd`` against the plain
    version (``render_tracked.track_project_plain`` and its autograd) on a
    recorded tracking iteration (``recording_track_project``), on the same
    card tensors: two launches of each, the forward's table and mask equal
    to the bit to the plain version's, the backward's twice to the bit and
    within 1e-3 (relative to the largest entry) of the plain gradient of the
    pose's 12 scalars.  CUDA-event medians of ``reps`` launches and of the
    plain version on the card.  Returns (JSON rows, ok)."""
    import torch

    from hierslam_torch.ops import kernels, render_tracked

    args, gtab = moved(rec[0], torch.device("cuda")), rec[1].cuda()
    rows, valid, tile, sc, grid_x, img_shape, tile_shape = args
    S, rc = rows.shape

    def bits(x):
        return x.view(torch.int32) if x.is_floating_point() else x

    ref = render_tracked.track_project_plain(*args)
    outs = [kernels.track_project_fwd(*args) for _ in range(2)]
    differ = sum(int((bits(x) != bits(y)).sum()) for out in outs for x, y in zip(out, ref))
    sc_ = sc.clone().requires_grad_(True)
    plain_tab = render_tracked.track_project_plain(rows, valid, tile, sc_, grid_x, img_shape,
                                                   tile_shape)[0]
    gref = torch.autograd.grad(plain_tab, sc_, gtab, retain_graph=True)[0]
    gs = [kernels.track_project_bwd(rows, gtab, sc, img_shape) for _ in range(2)]
    rel = float((gs[0][:12] - gref[:12]).abs().max() / gref[:12].abs().max())
    repeat = torch.equal(bits(gs[0]), bits(gs[1]))
    good = differ == 0 and repeat and rel <= 1e-3 and bool((gs[0][12:] == 0).all())
    fwd_ms = cuda_ms(lambda: kernels.track_project_fwd(*args), reps)
    bwd_ms = cuda_ms(lambda: kernels.track_project_bwd(rows, gtab, sc, img_shape), reps)
    plain_ms = cuda_ms(lambda: render_tracked.track_project_plain(*args), reps)
    plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(plain_tab, sc_, gtab, retain_graph=True),
                           reps)
    # forward: each slot's row, valid and tile read, its table row and ok
    # written; backward: its row and its cotangent row read.  Operations: ~110
    # a slot forward (~170 aniso), about twice that backward
    ops = 110 if rc == 8 else 170
    fb, fb_by = bound(S * (4 * rc + 5 + 41), S * ops)
    bb, bb_by = bound(S * (4 * rc + 40), 2 * S * ops)
    live = int(outs[0][1].sum())
    print(f"[kernels] {name} track_project: S={S} slots ({rc} columns a row, {live} ok) "
          f"grid_x={grid_x} image {img_shape[1]}x{img_shape[0]}: forward twice equal to the "
          f"bit to the plain version: {differ == 0} ({differ} elements differ); backward twice "
          f"equal to the bit: {repeat}, max |kernel - plain| / max |plain| over the pose's 12 "
          f"{rel:.3e}; track_project_fwd {fwd_ms:.4f} ms (bound {fb:.4f} ms by {fb_by}, "
          f"{100 * fb / fwd_ms:.1f}%), track_project_bwd {bwd_ms:.4f} ms (bound {bb:.4f} ms by "
          f"{bb_by}, {100 * bb / bwd_ms:.1f}%); plain forward {plain_ms:.3f} ms, plain backward "
          f"{plain_bwd_ms:.3f} ms", flush=True)
    rows_out = [dict(kernel=k, name=f"{k}[{name}]", route="cuda",
                     source="hierslam_torch/csrc/track.cu", replaces=None, ms=ms, plain_ms=p,
                     bound_ms=b, bound_by=by, library_ms=None, max_abs_err=err)
                for k, ms, p, b, by, err in (
                    ("track_project_fwd", fwd_ms, plain_ms, fb, fb_by, float(differ)),
                    ("track_project_bwd", bwd_ms, plain_bwd_ms, bb, bb_by, rel))]
    return rows_out, good


OPS_PER_SAT_PAIR = 9 * 9 + 4 * 9   # 9 corner exponents of 9 operations, 4 quads of ~9 (exp one)


def check_bin_emit(name: str, args, reps: int = 20):
    """``bin_emit`` against its plain version on a recorded pair emission
    (``binning.emit_pairs``'s arguments): the kernel path (the total read
    once, one launch) twice and the plain loop (``binning.emit_pairs_plain``,
    a boolean-mask compaction a cell row) on the same card tensors, every
    output equal to the bit.  Times the kernel alone (the total known) and
    the plain loop on the card.  Returns (JSON rows, ok)."""
    import torch

    from hierslam_torch.ops import binning, kernels

    args = moved(args, torch.device("cuda"))
    rect_min, w_rect, _, depth, o, budgets, grid_x, tile, vis, sat, offs = args
    ref = binning.emit_pairs_plain(*args[:-1])
    outs = [binning.emit_pairs(*args) for _ in range(2)]

    def bits(x):
        return x.view(torch.int32) if x.is_floating_point() else x

    differ = sum(int((bits(x) != bits(y)).sum()) if x.shape == y.shape else max(x.numel(), 1)
                 for out in outs for x, y in zip(out, ref) if y is not None)
    same = differ == 0
    m, k, n = int(offs[-1]), o.shape[0], rect_min.shape[0]
    k_emit = int(offs.diff().max())   # ranks that emit: the others read only offs
    sat32 = tuple(x.float().contiguous() for x in sat) if sat is not None else None
    rect_c, depth32 = rect_min.contiguous(), depth.float().contiguous()
    ms = cuda_ms(lambda: kernels.bin_emit(rect_c, w_rect, depth32, o, offs, m, grid_x, tile,
                                          vis, sat32), reps)
    plain_ms = cuda_ms(lambda: binning.emit_pairs_plain(*args[:-1]), 3)
    # each emitting rank's order entry, rect, width and depth (with sat its
    # screen terms) read once; each pair's tile, depth and id (with sat its
    # quads) written once
    with_sat = sat is not None
    bb, bb_by = bound(k_emit * (36 + 24 * with_sat) + m * (20 + 8 * with_sat),
                      m * OPS_PER_SAT_PAIR * with_sat)
    print(f"[kernels] {name} bin_emit: two launches equal to the bit to the plain version on "
          f"the same card tensors: {same} ({differ} elements differ); N={n} ranks={k} "
          f"emitting={k_emit} pairs={m} cell rows={len(budgets)} sat={with_sat} tile={tile} "
          f"grid_x={grid_x} visible ranks={vis}; bin_emit {ms:.4f} ms (bound {bb:.4f} ms by "
          f"{bb_by}, {100 * bb / ms:.1f}%); plain {plain_ms:.3f} ms", flush=True)
    row = dict(kernel="bin_emit", name=f"bin_emit[{name}]", route="cuda",
               source="hierslam_torch/csrc/binning.cu",
               replaces="hierslam_tpu/ops/binning.py:328", ms=ms, plain_ms=plain_ms,
               bound_ms=bb, bound_by=bb_by, library_ms=None, max_abs_err=float(differ))
    return [row], same


def check_gather(name: str, cot, spos, ends, n_diff: int, grad_bf16: bool, reps: int = 20):
    """K5 against its plain version on a gather backward (inputs on the
    host or the card): two launches, each equal to the bit to the plain
    version on a CPU copy of the inputs (both add each run from 0 in
    ascending position order).  Times K5, the plain version on the card,
    and the backward before the inverse map: one ``index_add_`` of every
    cotangent row, in gather order, into the row its position references
    (a pad's row, zeroed, into row 0), with the float order free and as
    ``index_add_`` runs under deterministic algorithms (``index_put_`` with
    ``accumulate=True``, sort-based).  Returns (JSON rows, ok)."""
    import torch

    from hierslam_torch.ops import gather_vjp, kernels

    want = gather_vjp.gather_bwd_plain(cot.cpu(), spos.cpu(), ends.cpu(), n_diff, grad_bf16)
    dev = torch.device("cuda")
    cot, spos, ends = cot.to(dev), spos.to(dev), ends.to(dev)
    M, C = cot.shape
    N, m = ends.shape[0], spos.shape[0]
    first = kernels.gather_bwd(cot, spos, ends, n_diff, grad_bf16).cpu()
    second = kernels.gather_bwd(cot, spos, ends, n_diff, grad_bf16).cpu()
    same = torch.equal(first, want) and torch.equal(second, want)
    err = float((first - want).abs().max())
    e = ends.long().clamp_max(m)
    n_ref = e - torch.cat([e.new_zeros(1), e[:-1]])
    refs = int(e[-1])
    ms = cuda_ms(lambda: kernels.gather_bwd(cot, spos, ends, n_diff, grad_bf16), reps)
    plain_ms = cuda_ms(lambda: gather_vjp.gather_bwd_plain(cot, spos, ends, n_diff, grad_bf16), 3)
    pos = spos[:refs].long()
    rows = torch.zeros((M,), dtype=torch.long, device=dev)
    rows[pos] = torch.repeat_interleave(torch.arange(N, device=dev), n_ref)
    valid = torch.zeros((M, 1), device=dev)
    valid[pos] = 1.0
    src = cot[:, :n_diff]
    if grad_bf16:
        src = src.to(torch.bfloat16).float()
    src = (src * valid).contiguous()
    out = torch.zeros((N, n_diff), device=dev)
    lib_ms = cuda_ms(lambda: out.index_add_(0, rows, src), reps)
    det_ms = cuda_ms(lambda: out.index_put_((rows,), src, accumulate=True), reps)
    # the random row reads alone: the referenced rows' summed columns
    # gathered in K5's order (and written out in that order)
    cols = cot[:, :n_diff].contiguous()
    sel_ms = cuda_ms(lambda: cols.index_select(0, pos), reps)
    # each referenced cotangent row's summed columns, its position and every
    # run end read once; every element of grad written once; one add a term
    bb, bb_by = bound(refs * (n_diff + 1) * 4 + N * 4 + N * C * 4, refs * n_diff)
    print(f"[kernels] {name} K5: two launches equal to the bit to the plain version on the "
          f"CPU: {same} (max abs err {err:.3e}); N={N} rows, M={M} positions, {refs} "
          f"references, longest run {int(n_ref.max())}, C={C}, summed columns {n_diff}, "
          f"bf16 {grad_bf16}; K5 {ms:.4f} ms (bound {bb:.4f} ms by {bb_by}, "
          f"{100 * bb / ms:.1f}%); plain {plain_ms:.3f} ms; index_add_ with the float order "
          f"free {lib_ms:.4f} ms, deterministic (index_put_ accumulate) {det_ms:.4f} ms; "
          f"index_select of the referenced rows' summed columns, in K5's order, {sel_ms:.4f} ms",
          flush=True)
    row = dict(kernel="gather_bwd", name=f"gather_bwd_K5[{name}]", route="cuda",
               source="hierslam_torch/csrc/gather.cu",
               replaces="hierslam_tpu/ops/gather_vjp.py:218", ms=ms, plain_ms=plain_ms,
               bound_ms=bb, bound_by=bb_by, library_ms=lib_ms,
               library_deterministic_ms=det_ms, index_select_ms=sel_ms, max_abs_err=err)
    return [row], same


# K5's seeded inputs: rows, positions, each row's references binomial(9, p),
# columns, summed columns, bf16 terms; the first two shaped as the run's
# recorded inputs ([slam stream], [tum]), the third the adversarial one
GATHER_SEEDED = (
    ("flagship-shaped", dict(n=1_572_865, n_pos=3_432_576, p=0.229, c=34, nd=34, bf16=True)),
    ("tum-shaped", dict(n=1_048_576, n_pos=1_269_760, p=0.0915, c=15, nd=10, bf16=True)),
    ("adversarial", dict(n=200_000, n_pos=240_000, p=0.5, c=135, nd=135, bf16=False,
                         empty=0.9, long_run=120_000, cut=1_000)),
)


def seeded_gather(seed: int, n: int, n_pos: int, p: float, c: int, nd: int, bf16: bool,
                  empty: float = 0.0, long_run: int = 0, cut: int = 0):
    """K5's inputs from a seed, as ``check_gather`` takes them: ``n`` rows,
    each with binomial(9, ``p``) references (a share ``empty`` of the rows
    with none; with ``long_run``, row n // 3 with that many) at random
    positions among ``n_pos`` (the rest pads), an inverse map built by the
    port, normal cotangent rows [n_pos, c]; with ``cut``, the positions end
    ``cut`` references before the long run does (a pair budget inside a
    run)."""
    import numpy as np
    import torch

    from hierslam_torch.ops import gather_vjp

    rng = np.random.default_rng(seed)
    counts = rng.binomial(9, p, n)
    counts[rng.uniform(size=n) < empty] = 0
    if long_run:
        counts[n // 3] = long_run
    refs = int(counts.sum())
    flat = np.full(max(n_pos, refs), -1, np.int64)
    flat[:refs] = np.repeat(np.arange(n), counts)
    rng.shuffle(flat)
    dev = torch.device("cuda")
    inv = gather_vjp.build_inverse_map(torch.as_tensor(flat, device=dev), n)
    m = int(inv.ends[n // 3]) - cut if long_run and cut else inv.spos.shape[0]
    cot = torch.randn((flat.shape[0], c), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(seed))
    return cot, inv.spos[:m], inv.ends, nd, bf16


THIN = dict(T=128, K=512, grid_x=16)   # [kernels] cull thin: 16 x 8 tiles of 512 slots


def thin_cull_counts(table, ok, grid_x: int):
    """On a ladder table: the (warp, slot) in which a pixel takes the slot
    (``render_xla.blend_terms``), how many of them the plain cull drops with
    its box from ``render_xla.conic_cov_diag`` and with the box K1 took
    before (the conic's float32 determinant, no allowance for the blend's
    rounding of q), and the slots some pixel takes [T, K]."""
    import torch

    from hierslam_torch.ops import render_xla as rx

    T, K, _ = table.shape
    dev = table.device
    tp = rx.thread_pixels(TILE).to(dev)
    n_taken, missed, taken_slot = 0, {"now": 0, "before": 0}, []
    with torch.no_grad():
        for lo, hi in rx.tile_chunks(T, P, K):
            tab, okc = table[lo:hi], ok[lo:hi]
            tids = torch.arange(lo, hi, device=dev)
            px, py = rx.pixel_grid(tids, TILE, grid_x)
            contrib = rx.blend_terms(tab, okc, px, py)[4]
            taken = contrib[:, tp].reshape(hi - lo, P // 32, 32, K).any(2)
            x0 = ((tids % grid_x) * TILE[1]).float()[:, None]
            y0 = ((tids // grid_x) * TILE[0]).float()[:, None]
            a, b, c = tab[..., 2], tab[..., 3], tab[..., 4]
            det = a * c - b * b
            inf = torch.full_like(det, float("inf"))
            before = (torch.where(det > 0, c / det, inf), torch.where(det > 0, a / det, inf))
            for key, box in (("now", rx.conic_cov_diag(a, b, c)), ("before", before)):
                live = rx.cull_mask(tab[..., 0], tab[..., 1], *box, tab[..., 5], x0, y0, TILE)
                missed[key] += int((taken & ~(live & okc[..., None]).permute(0, 2, 1)).sum())
            n_taken += int(taken.sum())
            taken_slot.append(taken.any(1))
    return n_taken, missed["now"], missed["before"], torch.cat(taken_slot)


def thin_stream_inputs(cfg_path: str, n: int = 150_000, seed: int = 0, W: int = 1200,
                       H: int = 680, f: float = 600.0):
    """A pair stream of raw rows as thin as K3's rows project: a stream row
    is isotropic in 3-D (one log-scale column), so its 2-D covariance
    s^2 J J^T + 0.3 I is thinnest where the projection is most oblique, at
    the clamps of the view frustum (|x / z| <= ``limx``, |y / z| <=
    ``limy``), and there no thinner than eigenvalues 1 : 1 + limx^2 +
    limy^2 (for fx = fy).  Means from a seed over 1.6 times the image on
    each axis (past its edges, where the clamp holds), 0.3-3 m deep,
    footprints of 0.5-16 px, binned at the identity pose with ``cfg_path``'s
    raster config.  Returns ``stream_inputs``'s tuple and the smallest
    (ac - b^2)/ac of a row in front of the camera, measured and the
    frustum's floor."""
    import numpy as np
    import torch

    from hierslam_torch.config import load_config, raster_config
    from hierslam_torch.core.camera import setup_camera
    from hierslam_torch.ops import render_stream as rs

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    cx, cy = (W - 1) / 2, (H - 1) / 2
    u = rng.uniform(-0.3 * W, 1.3 * W, n)
    v = rng.uniform(-0.3 * H, 1.3 * H, n)
    z = rng.uniform(0.3, 3.0, n)
    r_px = np.exp(rng.uniform(np.log(0.5), np.log(16.0), n))
    table = np.concatenate([np.stack([(u - cx) * z / f, (v - cy) * z / f, z,
                                      np.log(r_px * z / f), rng.uniform(-4, 6, n)], 1),
                            rng.uniform(0, 1, (n, 3))], 1)
    t = torch.as_tensor(table, dtype=torch.float32, device=dev)
    camera = setup_camera(W, H, np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]]), np.eye(4))
    rc = raster_config(load_config(cfg_path))
    rot = torch.zeros((n, 4), device=dev)
    rot[:, 0] = 1.0
    b = rs.compute_stream_binning(t[:, :3], torch.exp(t[:, 3:4]), rot, camera, rc,
                                  margin_px=4.0, opacities=torch.sigmoid(t[:, 4]))
    stream = torch.cat([t, rs.sentinel_row(t.shape[1], dev)], 0)[b.lists.idx].contiguous()
    sc = rs.make_scalars(torch.eye(4, device=dev), camera)
    with torch.no_grad():
        q = rs.project_pairs(t, sc, 0.0, 0.0, float(W), float(H), TILE)
    a, bb, c = (q[k].double() for k in ("ca", "cb", "cc"))
    front = q["dep"] > 0.2
    ratio = float(((a * c - bb * bb) / (a * c))[front].min())
    lam = 1.0 + float(sc[26]) ** 2 + float(sc[27]) ** 2
    return (stream, sc, b.lists, b.lists.idx == n, rc.grid(H, W), (H, W)), ratio, \
        4 * lam / (1 + lam) ** 2


def cull_thin_phase(cfg_path: str) -> bool:
    """``[kernels] cull thin``: the footprint cull on near-singular conics.
    K1 against its plain version (``check_kernels``'s tolerances and tie
    rule, forward only) on a table of thin gaussians from
    ``tools/thin_gaussians.py`` at F = 3 and 29, half of them with the tile
    at a tip of the ellipse, with the plain cull's dropped (warp, slot) now
    and with the box K1 took before; K3 against its plain version on the
    thinnest stream rows (``thin_stream_inputs``).  Prints the smallest
    (ac - b^2)/ac reached and the pixels beyond tolerance."""
    import torch

    thin = load_module("thin_gaussians", os.path.join(ROOT, "tools", "thin_gaussians.py"))
    dev = torch.device("cuda")
    T, K, gx = THIN["T"], THIN["K"], THIN["grid_x"]
    ok = True
    for F in (3, 29):
        tab_np, ok_np = thin.thin_table(40 + F, T, K, F, gx, TILE)
        ratio = thin.det_ratio(tab_np)
        table, slot_ok = torch.as_tensor(tab_np, device=dev), torch.as_tensor(ok_np, device=dev)
        n_taken, n_now, n_before, taken_slot = thin_cull_counts(table, slot_ok, gx)
        name = f"cull thin T={T} K={K} F={F}"
        print(f"[kernels] {name}: lambda1/lambda2 to 1e7 at 0-60 degrees, half the slots with "
              f"the tile at a tip; smallest (ac - b^2)/ac {ratio.min():.3e}, of a slot a pixel "
              f"takes {ratio[taken_slot.cpu().numpy()].min():.3e}; (warp, slot) taken "
              f"{n_taken}, dropped by the plain cull {n_now} (allowed 0), by the box K1 took "
              f"before {n_before}", flush=True)
        ok &= n_now == 0
        ok &= check_kernels(name, table, slot_ok, gx, 0, flips_allowed=2, bwd=False)[1]
    (stream, sc, lists, pad, grid, img), ratio, floor = thin_stream_inputs(cfg_path)
    name = f"cull thin stream R={stream.shape[0]} F=3"
    print(f"[kernels] {name}: isotropic rows over the frustum's clamps; smallest (ac - b^2)/ac "
          f"of a row in front {ratio:.4f} (the frustum's floor {floor:.4f}); n_refs "
          f"{int(lists.n_refs)} n_dropped {int(lists.n_dropped)}", flush=True)
    ok &= check_stream(name, stream, sc, lists.row_off, pad, grid, 3, img, 0, flips_allowed=2)[1]
    return ok


def tracking_table(cfg_path: str):
    """The ``k1_record`` of what the first tracking iteration of frame
    ``RECORD_FRAME`` hands to K1 in the flagship run, from a run of
    frames 0 .. ``RECORD_FRAME`` stepped as ``slam_phase`` steps them."""
    from hierslam_torch.config import load_config
    from hierslam_torch.slam.pipeline import SLAMRunner

    cfg = load_config(cfg_path)
    cfg["data"]["num_frames"] = 8
    cfg["workdir"] = tempfile.mkdtemp()
    runner = SLAMRunner(cfg, dataset=room_dataset(8, 1200, 680, 600.0), device="cuda")
    for t in range(RECORD_FRAME):
        runner.step(t)
    seen = []
    with recording_blend_fwd(seen):
        runner.step(RECORD_FRAME)
    return seen[0]


BINNINGS = [0]   # binnings on the card that emitted a pair, since the counts were zeroed


def count_binnings() -> None:
    """Count in ``BINNINGS`` the binnings on the card that emit a pair (each
    launches ``bin_emit`` once, one with none launches nothing).  Every
    binning goes through ``binning._emit_sort_sat``, wrapped from here once
    a process (the package has no hook for it); the wrapped function still
    does all the work."""
    from hierslam_torch.ops import binning

    emit = binning._emit_sort_sat
    if getattr(emit, "counting", False):
        return

    def counting(*args, **kwargs):
        sp = emit(*args, **kwargs)
        BINNINGS[0] += int(sp.s_gauss.is_cuda and sp.s_gauss.shape[0] > 0)
        return sp

    counting.counting = True
    binning._emit_sort_sat = counting


def reset_counts() -> None:
    """Zero the kernels' launch counts, the plain versions' call counts and
    ``BINNINGS``."""
    from hierslam_torch.ops import (binning, gather_vjp, kernels, render_pallas, render_stream,
                                    render_tracked)

    count_binnings()
    kernels.reset_launch_counts()
    BINNINGS[0] = 0
    for counts in (render_pallas.plain_counts, render_stream.plain_counts,
                   gather_vjp.plain_counts, binning.plain_counts, render_tracked.plain_counts):
        for k in counts:
            counts[k] = 0


def read_counts():
    """-> (kernel launches, plain-version calls, binnings on the card that
    emitted a pair) since ``reset_counts``."""
    from hierslam_torch.ops import (binning, gather_vjp, kernels, render_pallas, render_stream,
                                    render_tracked)

    return (dict(kernels.launch_counts),
            dict(render_pallas.plain_counts, **render_stream.plain_counts,
                 **gather_vjp.plain_counts, **binning.plain_counts,
                 **render_tracked.plain_counts),
            BINNINGS[0])


def track_launches(summ, rc, H: int, W: int, it_t: int):
    """The projection kernels' launches of a run: one ``track_project_fwd``
    and one ``track_project_bwd`` a cached tracking iteration, ``it_t`` a
    pose cache; each cache adds the grid's tiles to ``track_tiles`` (0 with
    GT poses or the uncached tracker).  ``summ`` None: none."""
    gy, gx = rc.grid(H, W)
    n = 0 if summ is None else it_t * summ["track_tiles"] // (gy * gx)
    return {"track_project_fwd": n, "track_project_bwd": n}


def ladder_classes(rc, H: int, W: int) -> int:
    """The non-empty ``bucket_spec`` classes of a ladder render of raster
    config ``rc`` at H x W: K1 launches per render."""
    from hierslam_torch.ops.binning import resolve_bucket_spec

    grid = rc.grid(H, W)
    return sum(1 for nb, _ in resolve_bucket_spec(rc.spec(), grid[0] * grid[1]) if nb > 0)


def slam_phase(cfg_path: str, backend: Optional[str] = None, n_frames: int = 8,
               map_every: Optional[int] = None, record: Optional[list] = None,
               gather_record: Optional[list] = None, emit_record: Optional[list] = None,
               track_record: Optional[list] = None):
    """Drive ``SLAMRunner.step`` over ``n_frames`` procedural frames at
    1200x680 with the flagship config (``backend``/``map_every`` override
    it when given).  Launch counts are zeroed just before the run and read
    just after.  With ``record`` (a list), frame ``RECORD_FRAME``'s first
    tracking table is left in it; with ``gather_record``, the inputs of the
    first K5 launch (frame 0's first mapping backward); with
    ``emit_record``, those of frame 0's first stream binning's pair
    emission; with ``track_record``, frame ``RECORD_FRAME``'s first
    tracking projection (``recording_track_project``).  Returns (ok,
    launches, summary)."""
    import numpy as np
    import torch

    from hierslam_torch.config import load_config
    from hierslam_torch.slam.pipeline import SLAMRunner

    t0 = time.time()
    ds = room_dataset(n_frames, 1200, 680, 600.0)
    cfg = load_config(cfg_path)
    if backend is not None:
        cfg["raster"]["backend"] = backend
    if map_every is not None:
        cfg["map_every"] = map_every
    backend = cfg["raster"]["backend"]
    tag = f"[slam {backend}]"
    print(f"{tag} {n_frames} procedural frames at 1200x680 in {time.time() - t0:.1f} s",
          flush=True)
    cfg["data"]["num_frames"] = n_frames
    workdir = tempfile.mkdtemp()
    cfg["workdir"] = workdir
    torch.cuda.reset_peak_memory_stats()
    runner = SLAMRunner(cfg, dataset=ds, device="cuda")

    reset_counts()
    ok = True
    n_track = n_map = n_dens = 0
    t_run = time.time()
    for t in range(n_frames):
        with contextlib.ExitStack() as stack:
            if record is not None and t == RECORD_FRAME:
                stack.enter_context(recording_blend_fwd(record))
            if gather_record is not None and t == 0:
                stack.enter_context(recording_gather_bwd(gather_record))
            if emit_record is not None and t == 0:
                stack.enter_context(recording_emit_pairs(emit_record))
            if track_record is not None and t == RECORD_FRAME:
                stack.enter_context(recording_track_project(track_record))
            runner.step(t)
        line = f"{tag} frame {t}:"
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
            line += (f" mapping loss {ml[0]:.6g} -> {ml[-1]:.6g} n_map_bin_dropped "
                     f"{float(np.max(runner.last_mapping_trace['n_map_bin_dropped'])):.0f}")
        line += f" n_active {int(runner.variables['n_active'])}"
        print(line, flush=True)
    torch.cuda.synchronize()
    wall = time.time() - t_run
    launches, plain, n_bin = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    pn = runner.finalize()
    summ = runner.runtime_summary()

    it_t, it_m = cfg["tracking"]["num_iters"], cfg["mapping"]["num_iters"]
    n_classes = ladder_classes(runner.rc, runner.H, runner.W)
    n_prog = 2 * n_classes        # the t = 0 progress renders, after tracking and mapping
    # one K1 and one K2 launch a tracking class an iteration: the classes of
    # one configured class are sized from each frame's counts (track_classes)
    n_tk = it_t * summ["track_classes"]
    if backend == "stream":
        want = {"blend_fwd": n_tk + n_dens + n_prog, "blend_bwd": n_tk,
                "stream_fwd": n_map * it_m, "stream_bwd": n_map * it_m,
                "gather_bwd": n_map * it_m, "bin_emit": n_bin}
    else:
        want = {"blend_fwd": n_tk + n_dens + n_prog + n_map * it_m * n_classes,
                "blend_bwd": n_tk + n_map * it_m * n_classes,
                "stream_fwd": 0, "stream_bwd": 0, "gather_bwd": n_map * it_m,
                "bin_emit": n_bin}
    want.update(track_launches(summ, runner.rc, runner.H, runner.W, it_t))
    print(f"{tag} launches: {json.dumps(launches)} expected: {json.dumps(want)} plain calls: "
          f"{json.dumps(plain)}", flush=True)
    ok &= launches == want
    ok &= all(v == 0 for v in plain.values())
    # one configured tracking class is the least of classes sized from the counts
    ok &= runner.rc.track_bucket_spec is not None or summ["track_pairs_dropped"] == 0
    if not ok:
        print(f"{tag} non-finite loss, plain calls, launch counts or tracking drops off",
              flush=True)
    print(f"{tag} drops: densify_overflow {summ['densify_overflow']} bin_overflow_max "
          f"{summ['bin_overflow_max']} n_map_bin_dropped "
          f"{float(np.max(runner.last_mapping_trace['n_map_bin_dropped']))} n_grad_dropped "
          f"{float(np.max(runner.last_mapping_trace['n_grad_dropped']))} track_pairs_dropped "
          f"{summ['track_pairs_dropped']}; tracking classes {summ['track_classes']} over "
          f"{n_track} frames, slots {summ['track_slots']} for {summ['track_pairs']} pairs",
          flush=True)
    errs = centre_err_cm(runner, ds, n_frames)
    print(f"{tag} camera-centre error vs GT (cm): " + " ".join(f"{e:.3f}" for e in errs),
          flush=True)
    summ["max_memory_allocated_GiB"] = peak_gib
    print(f"{tag} tracking_iter_ms {summ['tracking_iter_ms']:.3f} mapping_iter_ms "
          f"{summ['mapping_iter_ms']:.3f} tracking_frame_s {summ['tracking_frame_s']:.3f} "
          f"mapping_frame_s {summ['mapping_frame_s']:.3f} wall_s {wall:.1f} n_active "
          f"{summ['n_active']} max_memory_allocated_GiB {peak_gib:.2f}", flush=True)
    path = os.path.join(workdir, cfg["run_name"], "params.npz")
    with np.load(path) as data:
        missing = [k for k in PARAM_KEYS if k not in data]
        finite = all(np.isfinite(data[k]).all() for k in PARAM_KEYS if k not in missing)
    print(f"{tag} params.npz: missing keys {missing}, all finite {finite}", flush=True)
    ok &= not missing and finite and os.path.isfile(
        os.path.join(workdir, cfg["run_name"], "semantic_decoder.npz"))
    ok &= bool(np.all(np.isfinite(errs)))
    return ok, launches, summ


SEQ = "room0"        # the flagship's sequence name (configs/replica/hierslam_semantic_run.py)
FRAME = dict(W=1200, H=680, f=600.0)     # the flagship's frames (configs/data/replica_semantic.yaml)


def write_sequence(root: str, n: int, semantic: bool = True):
    """Frames 0..n-1 of ``room_dataset`` at 1200x680 in the Replica semantic
    layout under ``root/room0``: q95 4:2:0 JPEG colour, 16-bit PNG depth
    (x 6553.5), 8-bit label PNGs of the leaf ids, the raw c2w in
    ``traj.txt`` and a tree that maps leaf l to the level ids (l mod 2,
    l mod 3, l mod 5, l mod 7, l mod 9), 26 channels over 102 leaves.
    ``semantic=False`` writes the plain Replica layout: no labels, no tree.
    Returns (room dataset, seconds to write)."""
    import numpy as np

    from hierslam_torch.utils.image_io import write_jpeg, write_png

    ds = room_dataset(n, FRAME["W"], FRAME["H"], FRAME["f"])
    t0 = time.time()
    seq = os.path.join(root, SEQ)
    os.makedirs(os.path.join(seq, "results"))
    if semantic:
        os.makedirs(os.path.join(seq, "semantic_class"))
    for t in range(n):
        color, depth, _, _, labels = ds[t]
        write_jpeg(os.path.join(seq, "results", f"frame{t:06d}.jpg"), color, 95)
        d16 = np.clip(np.round(depth * 6553.5), 0, 65535).astype(np.uint16)
        write_png(os.path.join(seq, "results", f"depth{t:06d}.png"), d16)
        if semantic:
            write_png(os.path.join(seq, "semantic_class", f"semantic_class_{t}.png"),
                      labels[-1].astype(np.uint8))
    with open(os.path.join(seq, "traj.txt"), "w") as f:
        f.write("\n".join(" ".join(repr(float(v)) for v in c2w.reshape(-1))
                          for c2w in ds.raw_c2w[:n]))
    if not semantic:
        return ds, time.time() - t0
    tree = {f"{leaf}_leaf{leaf}": [{str(leaf % k): f"level{i}_{leaf % k}"}
                                    for i, k in enumerate(SEM_LEVELS)]
            for leaf in range(NUM_LEAF)}
    with open(os.path.join(seq, "info_semantic_tree.json"), "w") as f:
        json.dump(tree, f)
    return ds, time.time() - t0


def check_loader(root: str, ds, n: int) -> bool:
    """The port's Replica loader on the written sequence against the frames
    that were written: depth within one PNG step (1/6553.5 m), the leaf row
    of the labels and K equal, poses within 1e-5 (float32), colour PSNR >=
    30 dB (a lossy q95 4:2:0 file).  Prints the read time of each item."""
    import numpy as np

    from hierslam_torch.datasets import get_dataset
    from hierslam_torch.datasets.base import load_dataset_config

    cfg = load_dataset_config(os.path.join(ROOT, "configs", "data", "replica_semantic.yaml"))
    cfg.update(sem_mode="tree", num_tree_level=len(SEM_LEVELS))
    loader = get_dataset(cfg, root, SEQ, start=0, end=-1, stride=1, desired_height=FRAME["H"],
                         desired_width=FRAME["W"], relative_pose=True)
    ok = len(loader) == n and loader.num_semantic == list(SEM_LEVELS) + [NUM_LEAF]
    ms, worst = [], dict(depth=0.0, pose=0.0, psnr=1e9)
    for t in range(n):
        t0 = time.time()
        color, depth, K4, pose, labels = loader[t]
        ms.append((time.time() - t0) * 1e3)
        c_ref, d_ref, K_ref, p_ref, l_ref = ds[t]
        mse = np.mean((color.astype(np.float64) - c_ref.astype(np.float64)) ** 2)
        worst["psnr"] = min(worst["psnr"], 10 * np.log10(255.0**2 / mse))
        worst["depth"] = max(worst["depth"], float(np.abs(depth - d_ref).max()))
        worst["pose"] = max(worst["pose"], float(np.abs(pose - p_ref).max()))
        ok &= bool(np.array_equal(labels[-1], l_ref[-1])) and bool(np.array_equal(K4, K_ref))
    ok &= worst["depth"] <= 1 / 6553.5 and worst["pose"] <= 1e-5 and worst["psnr"] >= 30
    print(f"[cli] loader: {n} items, labels and K equal: {ok}; max depth error "
          f"{worst['depth']:.3e} m (allowed {1 / 6553.5:.3e}), max pose error "
          f"{worst['pose']:.3e} (allowed 1e-5), min colour PSNR {worst['psnr']:.2f} dB "
          f"(allowed >= 30); ms per item (JPEG + 2 PNG decodes): "
          + " ".join(f"{x:.0f}" for x in ms) + f", median {statistics.median(ms):.0f}",
          flush=True)
    return ok


def run_cli(args, record=None, n_feat: int = 3 + sum(SEM_LEVELS)):
    """``python3 -m hierslam_torch.scripts.run_slam ARGS`` in this process:
    -> (return value, printed text, seconds in ``run_final_eval``).  The
    eval's per-class lines stay in the text; the rest is printed.  With
    ``record`` (a list), the first K1 call of ``run_final_eval`` with
    ``n_feat`` features (the flagship's 29) leaves its table there.  The
    eval ends on host values (its row), so its time needs no
    synchronize."""
    from hierslam_torch.scripts import run_slam as cli
    from hierslam_torch.slam import pipeline

    final_eval = pipeline.run_final_eval
    eval_s = []

    def timed_eval(*a, **kw):
        t0 = time.time()
        with (recording_blend_fwd(record, n_feat=n_feat) if record is not None
              else contextlib.nullcontext()):
            out = final_eval(*a, **kw)
        eval_s.append(time.time() - t0)
        return out

    buf = io.StringIO()
    pipeline.run_final_eval = timed_eval
    try:
        with contextlib.redirect_stdout(buf):
            out = cli.main(args)
    finally:
        pipeline.run_final_eval = final_eval
    text = buf.getvalue()
    for line in text.splitlines():
        if not line.startswith((" semantic label", "current frame", "mean_iou")):
            print(f"[cli]   {line}", flush=True)
    return out, text, eval_s[0]


def eval_row(text: str):
    """The numbers of the eval row printed under its header, or None."""
    lines = text.splitlines()
    head = [i for i, ln in enumerate(lines) if ln.startswith("[ATE RMSE cm] [PSNR]")]
    if not head or head[-1] + 1 >= len(lines):
        return None
    return [float(x) for x in lines[head[-1] + 1].split()]


def cli_phase(cfg_path: str):
    """Phase 6 (the module docstring).  Returns (ok, launches, recorded eval
    table or None, the finished run: its config file, results directory,
    eval row and eval seconds)."""
    import numpy as np

    from hierslam_torch.config import load_config, raster_config

    n = 8
    root = tempfile.mkdtemp()
    trace_dir = os.path.join(root, "traces")
    ds, dt = write_sequence(root, n)
    print(f"[cli] wrote {n} frames at {FRAME['W']}x{FRAME['H']} to the Replica semantic layout "
          f"in {dt:.1f} s", flush=True)
    ok = check_loader(root, ds, n)
    workdir = os.path.join(root, "experiments")
    wrapper = os.path.join(root, "run.py")
    with open(wrapper, "w") as f:
        f.write(
            "import importlib.util\n"
            f"spec = importlib.util.spec_from_file_location('flagship', {cfg_path!r})\n"
            "flagship = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(flagship)\n"
            "config = flagship.config\n"
            f"config['workdir'] = {workdir!r}\n"
            f"config['data'].update(basedir={root!r}, basedir_sem={root!r}, gradslam_data_cfg="
            f"{os.path.join(ROOT, 'configs', 'data', 'replica_semantic.yaml')!r})\n"
            "config.update(save_checkpoints=True, checkpoint_interval=4)\n"
            f"config['profile'] = dict(trace_dir={trace_dir!r}, frames={list(PROFILED)!r})\n")
    cfg = load_config(wrapper)
    run_dir = os.path.join(workdir, cfg["run_name"])
    record = []
    reset_counts()
    t0 = time.time()
    (pn, summ, res), text, eval_s = run_cli([wrapper], record)
    launches, plain, n_bin = read_counts()
    wall = time.time() - t0
    row = eval_row(text)
    good_row = row is not None and len(row) == 8 and np.isfinite(row[:3] + row[4:]).all() \
        and row[0] < 5.0
    # tracking on frames 1-7, a densify at t=7, mapping at t=0 and t=7; K1
    # renders the four classes twice at t=0 (progress) and at eval frames 0, 4
    it_t, it_m = cfg["tracking"]["num_iters"], cfg["mapping"]["num_iters"]
    n_eval = sum(1 for t in range(n) if t == 0 or (t + 1) % cfg["eval_every"] == 0)
    n_map = sum(1 for t in range(n) if t == 0 or (t + 1) % cfg["map_every"] == 0)
    n_classes = ladder_classes(raster_config(cfg), FRAME["H"], FRAME["W"])
    n_tk = it_t * summ["track_classes"]   # classes sized from each tracked frame's counts
    want = {"blend_fwd": n_tk + (n_map - 1) + (2 + n_eval) * n_classes,
            "blend_bwd": n_tk, "stream_fwd": n_map * it_m, "stream_bwd": n_map * it_m,
            "gather_bwd": n_map * it_m, "bin_emit": n_bin,
            **track_launches(summ, raster_config(cfg), FRAME["H"], FRAME["W"], it_t)}
    files = ("params.npz", "semantic_decoder.npz", "config.py", "params4.npz",
             "keyframe_time_indices4.npy", "semantic_decoder_4.npz")
    missing = [f for f in files if not os.path.isfile(os.path.join(run_dir, f))]
    with np.load(os.path.join(run_dir, "params.npz")) as data:
        missing += [k for k in PARAM_KEYS if k not in data]
    print(f"[cli] run: eval row {row} (ATE < 5 cm: {good_row}); launches "
          f"{json.dumps(launches)} expected {json.dumps(want)}; plain calls {json.dumps(plain)}; "
          f"progress_failed {summ['progress_failed']}; missing files or keys {missing}; "
          f"tracking_iter_ms {summ['tracking_iter_ms']:.3f} mapping_iter_ms "
          f"{summ['mapping_iter_ms']:.3f} eval_s {eval_s:.2f} wall_s {wall:.1f} (SLAM + eval)",
          flush=True)
    ok &= good_row and launches == want and not any(plain.values()) \
        and summ["progress_failed"] == 0 and not missing and res is not None
    ok &= profile_summary(trace_dir, it_t, it_m)
    # resume at frame 4 from the checkpoint the run left (not traced)
    with open(wrapper, "a") as f:
        f.write("config.update(load_checkpoint=True, checkpoint_time_idx=4)\n"
                "config.pop('profile')\n")
    t0 = time.time()
    (_, summ2, _), text, _ = run_cli([wrapper])
    row2 = eval_row(text)
    good2 = row2 is not None and np.isfinite(row2[:3] + row2[4:]).all() and row2[0] < 5.0
    print(f"[cli] resumed at frame 4: eval row {row2} (ATE < 5 cm: {good2}), progress_failed "
          f"{summ2['progress_failed']}, wall_s {time.time() - t0:.1f}", flush=True)
    ok &= good2 and summ2["progress_failed"] == 0
    finished = dict(wrapper=wrapper, run_dir=run_dir, row=row2, eval_s=eval_s)
    return ok, launches, (record[0] if record else None), finished


PROFILED = (6, 7)   # [cli]: config["profile"] traces frame 6 (tracked) and 7 (tracked, mapped)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")   # device events of a Chrome trace


def trace_summary(path: str):
    """From a ``torch.profiler`` Chrome trace: the span of its events (ms),
    the device time (kernels, copies and sets, ms), the kernel launches and
    every kernel by device time as (name, ms, count), longest first."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    by_name = {}
    for e in dev:
        if e["cat"] == "kernel":
            ms, cnt = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (ms + e["dur"] / 1e3, cnt + 1)
    span = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
    ranked = sorted(((n, ms, c) for n, (ms, c) in by_name.items()), key=lambda r: -r[1])
    return span, sum(e["dur"] for e in dev) / 1e3, sum(c for _, c in by_name.values()), ranked


def profile_summary(trace_dir: str, it_t: int, it_m: int) -> bool:
    """[cli]: the traces ``config["profile"]`` wrote, one a frame of
    ``PROFILED``: each frame's span, device time and kernel launches, its
    top kernels, and the launches per tracking iteration (frame 6, tracking
    only, over ``it_t``) and per mapping iteration (frame 7 less frame 6,
    over ``it_m``).  Fails unless exactly those traces are there, each with
    device time."""
    names = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
    want = sorted(f"frame{t}.json" for t in PROFILED)
    ok = names == want
    launches = {}
    for t in PROFILED if ok else ():
        span, busy, n_k, ranked = trace_summary(os.path.join(trace_dir, f"frame{t}.json"))
        launches[t] = n_k
        ok &= busy > 0
        size = os.path.getsize(os.path.join(trace_dir, f"frame{t}.json")) / 2**20
        print(f"[cli] profile frame {t}: span {span:.1f} ms, device {busy:.1f} ms "
              f"({100 * busy / span:.1f}% of the span), {n_k} kernel launches; trace "
              f"{size:.1f} MiB", flush=True)
        for name, ms, cnt in ranked[:8]:
            print(f"[cli]   {ms:9.3f} ms {cnt:6d}x {name[:90]}", flush=True)
        # the gather's backward (K5) and any scatter left on the path
        for part in ("gather_bwd_kernel", "indexFunc", "index_put", "scatter"):
            hits = [(name, ms, cnt) for name, ms, cnt in ranked if part in name]
            print(f"[cli]   kernels named *{part}*: {sum(h[1] for h in hits):.3f} ms, "
                  f"{sum(h[2] for h in hits)} launches"
                  + "".join(f"; {ms:.3f} ms {cnt}x {name[:100]}" for name, ms, cnt in hits[:3]),
                  flush=True)
    if ok:
        a, b = PROFILED
        print(f"[cli] profile: launches per tracking iteration {launches[a] / it_t:.1f} (frame "
              f"{a}), per mapping iteration {(launches[b] - launches[a]) / it_m:.1f} (frame {b} "
              f"less frame {a})", flush=True)
    else:
        print(f"[cli] profile: traces {names}, expected {want}", flush=True)
    return ok


def eval_agreement(final, gt_transfer: bool = False) -> bool:
    """``run_final_eval`` on the GPU (kernels) and on the CPU (plain
    versions) on the same final map of phase 3's stream run, every frame;
    with ``gt_transfer``, under ``model.eval_gt_transfer``."""
    ds, pn, mlp, cfg = final
    cfg = dict(cfg, eval_every=1)
    tag = "[eval]"
    if gt_transfer:
        tag = "[eval_novel_view] eval_gt_transfer,"
        cfg["model"] = dict(cfg.get("model", {}), eval_gt_transfer=True)
    from hierslam_torch.eval.runner import run_final_eval

    rows = []
    for dev in ("cuda", "cpu"):
        with contextlib.redirect_stdout(io.StringIO()):
            rows.append(run_final_eval(ds, pn, cfg, tempfile.mkdtemp(), mlp=mlp, device=dev))
    tol = dict(psnr=1e-3, ms_ssim=1e-5, depth_l1_cm=1e-4, depth_rmse_cm=1e-4, ate_rmse_cm=1e-6,
               miou_pct=0.1, mbiou_pct=0.1)
    diff = {k: abs(rows[0][k] - rows[1][k]) for k in tol}
    ok = all(diff[k] <= tol[k] for k in tol)
    print(f"{tag} 96x64 reference map, GPU vs CPU: "
          + " ".join(f"{k} {rows[0][k]:.6f}/{rows[1][k]:.6f} (|d| {diff[k]:.2e}, "
                     f"allowed {tol[k]:g})" for k in tol), flush=True)
    return ok


LPIPS_SHAPES = ((64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3), (256, 384, 3, 3),
                (256, 256, 3, 3))     # AlexNet's five convolutions (OIHW)


def lpips_random_weights(path: str, seed: int = 0) -> None:
    """Random LPIPS weights in the schema of weights/lpips_alex.npz
    (``conv{1..5}_{w,b}``, ``lin{1..5}_w``) from ``seed``: the real file is
    not in the repo."""
    import numpy as np

    rng = np.random.default_rng(seed)
    params = {}
    for i, shape in enumerate(LPIPS_SHAPES, start=1):
        params[f"conv{i}_w"] = rng.normal(0, 0.05, shape).astype(np.float32)
        params[f"conv{i}_b"] = rng.normal(0, 0.05, shape[0]).astype(np.float32)
        params[f"lin{i}_w"] = np.abs(rng.normal(0, 1, shape[0])).astype(np.float32)
    np.savez(path, **params)


def png_size(path: str):
    """(width, height) from a PNG's IHDR."""
    with open(path, "rb") as f:
        head = f.read(24)
    return struct.unpack(">II", head[16:24])


def eval_novel_view_phase(finished, final):
    """Phase 7 (the module docstring).  Returns (ok, JSON rows, launches)."""
    import numpy as np
    import torch

    from hierslam_torch.config import load_config, raster_config
    from hierslam_torch.eval import runner
    from hierslam_torch.eval.lpips import lpips_fn
    from hierslam_torch.scripts import eval_novel_view as cli
    from hierslam_torch.utils.image_io import read_png

    tag = "[eval_novel_view]"
    wrapper, run_dir = finished["wrapper"], finished["run_dir"]
    weights = os.path.join(os.path.dirname(wrapper), "lpips_random.npz")
    lpips_random_weights(weights)
    with open(wrapper, "a") as f:
        f.write(f"config['lpips_weights'] = {weights!r}\n")
    cfg = load_config(wrapper)
    real_eval = runner.run_final_eval
    calls = []

    def timed_eval(*a, **kw):
        t0 = time.time()
        out = real_eval(*a, **kw)
        calls.append((time.time() - t0, a, kw))
        return out

    record = []
    buf = io.StringIO()
    runner.run_final_eval = timed_eval
    reset_counts()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf), contextlib.chdir(ROOT), \
                recording_blend_fwd(record, n_feat=3 + sum(SEM_LEVELS)):
            res = cli.main([wrapper])
    finally:
        runner.run_final_eval = real_eval
    wall = time.time() - t0
    launches, plain, n_bin = read_counts()
    text = buf.getvalue()
    for line in text.splitlines():
        if not line.startswith((" semantic label", "current frame", "mean_iou")):
            print(f"{tag}   {line}", flush=True)
    # the same eval without save_frames, on the same inputs (after the counts)
    eval_s, a, kw = calls[0]
    n = len(a[0])                          # the frames of the run (the dataset's)
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        real_eval(*a[:3], tempfile.mkdtemp(), **dict(kw, save_frames=False))
    plain_eval_s = time.time() - t0

    row, cli_row = eval_row(text), finished["row"]
    units = (1e-4, 1e-3, 1e-4, None, 1e-4, 1e-4, 1e-2, 1e-2)   # the row's printed precision
    diffs = [abs(x - y) for x, y, u in zip(row, cli_row, units) if u is not None]
    same = all(abs(x - y) <= 1.01 * u for x, y, u in zip(row, cli_row, units) if u is not None)
    identical = all(x == y for x, y, u in zip(row, cli_row, units) if u is not None)
    good_lpips = bool(np.isfinite(res["lpips"])) and np.isfinite(row[3])
    n_eval = sum(1 for t in range(n) if t == 0 or (t + 1) % cfg["eval_every"] == 0)
    n_show = sum(1 for t in (0, n // 2) if t < n)
    n_cls = ladder_classes(raster_config(cfg), FRAME["H"], FRAME["W"])
    want = {"blend_fwd": (n_eval + n_show) * n_cls, "blend_bwd": 0, "stream_fwd": 0,
            "stream_bwd": 0, "gather_bwd": 0, "bin_emit": n_bin,
            **track_launches(None, raster_config(cfg), FRAME["H"], FRAME["W"], 0)}
    eval_dir = os.path.join(run_dir, "eval")
    n_levels = len(SEM_LEVELS)
    expect = {"renders": n_eval, "renders_depth": n_eval, "rgb": n_eval, "depth": n_eval,
              "rendered_semantic": 2 * n_eval,
              "rendered_semantic_multilevel_mlp": 2 * n_show * n_levels}
    counts, sizes = {}, set()
    for d in expect:
        files = sorted(glob.glob(os.path.join(eval_dir, d, "*.png")))
        counts[d] = len(files)
        sizes |= {png_size(p) for p in files}
    good_png = counts == expect and sizes == {(FRAME["W"], FRAME["H"])}
    print(f"{tag} eval row {row} against [cli]'s {cli_row}: LPIPS {res['lpips']:.6f} (random "
          f"weights from a seed), the other columns within the printed precision: {same} "
          f"(identical: {identical}; max |diff| {max(diffs):.2e}); launches "
          f"{json.dumps(launches)} expected {json.dumps(want)} ({n_eval} eval and {n_show} "
          f"figure renders of {n_cls} ladder classes); plain calls {json.dumps(plain)}",
          flush=True)
    print(f"{tag} PNGs per directory {json.dumps(counts)} expected {json.dumps(expect)}, sizes "
          f"{sorted(sizes)} (expected {FRAME['W']}x{FRAME['H']}); wall_s {wall:.2f} (reload, "
          f"loader, eval); run_final_eval s with save_frames {eval_s:.2f}, without "
          f"{plain_eval_s:.2f} (with LPIPS both; [cli]'s eval without LPIPS "
          f"{finished['eval_s']:.2f})", flush=True)
    ok = same and good_lpips and good_png and launches == want and not any(plain.values())

    rows = []
    if not record:
        print(f"{tag} no eval table was recorded", flush=True)
        ok = False
    else:
        table, slot_ok, gx, ids, n_t = record[0]
        T, K, C = table.shape
        print(f"{tag} first eval render's K1 table: T={T} K={K} F={C - 7} grid_x={gx}, "
              f"{100 * float(slot_ok.float().mean()):.1f}% of the slots live", flush=True)
        r, good = check_kernels(f"eval_novel_view table T={T} K={K} F={C - 7}", table, slot_ok,
                                gx, 20, seed=8, flips_allowed=2, tile_ids=ids, n_tiles=n_t)
        r[0]["path"] = "eval_novel_view"
        rows.append(r[0])
        ok &= good
    ok &= eval_agreement(final, gt_transfer=True)

    # LPIPS on one 1200x680 pair, the GPU against the CPU
    img = read_png(os.path.join(eval_dir, "renders", "gs_0000.png"))
    gt = read_png(os.path.join(eval_dir, "rgb", "gt_0000.png"))
    pair = [torch.as_tensor(x.transpose(2, 0, 1) / 255.0, dtype=torch.float32) for x in (img, gt)]
    gpu, cpu = lpips_fn(weights, "cuda"), lpips_fn(weights, "cpu")
    on_card = [x.cuda() for x in pair]
    d_gpu, d_cpu = gpu(*on_card), cpu(*pair)
    ms = cuda_ms(lambda: gpu(*on_card), 20)
    rel = abs(d_gpu - d_cpu) / abs(d_cpu)
    print(f"{tag} LPIPS of frame 0's render against its GT at {FRAME['W']}x{FRAME['H']}: GPU "
          f"{d_gpu:.9g} CPU {d_cpu:.9g} (rel {rel:.2e}, allowed 1e-4); {ms:.3f} ms a frame "
          "on the GPU (conv2d, TF32 off)", flush=True)
    ok &= rel <= 1e-4 and np.isfinite(d_gpu)
    return ok, rows, launches


SCANNET_SEQ = "scene0000_00"     # scenes[0] of the ScanNet configs (SCENE_NUM unset)
SCANNET_CAM = dict(fx=577.590698, fy=578.729797, cx=318.905426, cy=242.683609)  # the YAML's
SCANNET_LARGE_WIDTHS = (4, 8, 12, 20, 30)   # tree-large levels: 74 channels (bench.py:272)
SCANNET_LEAVES = 550
SCANNET_TREE_WIDTHS = (2, 3, 4, 7)          # the NYU40 tree: 16 channels, F = 19
SCANNET_SMALL = os.path.join(ROOT, "configs", "scannet", "hierslam_semantic_run.py")


def scannet_ids():
    """550 sparse raw ids (1, 4, 7, ..., 1648: ScanNet's raw ids are sparse
    below about 1,400) and the raw id of each of the room's six
    primitives."""
    ids = [1 + 3 * k for k in range(SCANNET_LEAVES)]
    return ids, [ids[(91 * p + 13) % SCANNET_LEAVES] for p in range(6)]


def write_scannet(root: str, n: int):
    """Frames 0..n-1 of the procedural room at 640x480 with ScanNet's
    intrinsics in the ScanNet semantic layout under ``root/scene0000_00``:
    q95 JPEG colour, 16-bit PNG depth in mm, the raw c2w per frame in
    ``pose/*.txt``, 16-bit ``label-filt`` PNGs of the primitives' raw ids;
    and, in ``root``, the raw -> NYU40 TSV (NYU40 id 1 + raw mod 40), a
    4-level NYU40 tree TSV of widths (2, 3, 4, 7) (level ids nyu mod
    width) and a tree-large TSV of widths (4, 8, 12, 20, 30) over the 550
    raw ids (level ids the leaf index mod width).  Returns (the frames as
    (colour, depth, c2w, raw label), seconds to write)."""
    import numpy as np

    from hierslam_torch.utils.image_io import write_jpeg, write_png

    room = load_module("procedural_room", os.path.join(ROOT, "tools", "procedural_room.py"))
    ids, prim_raw = scannet_ids()
    W, H = SCANNET_FRAME["W"], SCANNET_FRAME["H"]
    t0 = time.time()
    seq = os.path.join(root, SCANNET_SEQ)
    for d in ("color", "depth", "pose", "label-filt"):
        os.makedirs(os.path.join(seq, d))
    frames = []
    for t in range(n):
        color, depth, c2w, prim = room.render_frame(t, W, H, SCANNET_CAM["fx"], SCANNET_CAM["fy"],
                                                    SCANNET_CAM["cx"], SCANNET_CAM["cy"], 200)
        raw = np.asarray(prim_raw)[prim].astype(np.uint16)
        write_jpeg(os.path.join(seq, "color", f"{t}.jpg"), color, 95)
        write_png(os.path.join(seq, "depth", f"{t}.png"),
                  np.clip(np.round(depth * 1000.0), 0, 65535).astype(np.uint16))
        np.savetxt(os.path.join(seq, "pose", f"{t}.txt"), c2w)
        write_png(os.path.join(seq, "label-filt", f"{t}.png"), raw)
        frames.append((color, depth, c2w, raw))

    def tsv(name, levels):
        lines = ["\t".join(f"c{i}" for i in range(17 + 2 * max(len(SCANNET_LARGE_WIDTHS),
                                                                  len(SCANNET_TREE_WIDTHS))))]
        for i, r in enumerate(ids):
            nyu = 1 + r % 40
            row = [str(r), f"raw{r}", "", "", str(nyu), "", "", f"nyu{nyu}"] + [""] * 9
            for lv, level in enumerate(levels(i, nyu)):
                row += [str(level), f"l{lv + 1}_{level}"]
            lines.append("\t".join(row))
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines))

    tsv("scannetv2-labels.combined.tsv", lambda i, nyu: ())
    tsv("scannetv2-labels.combined.tree.tsv",
        lambda i, nyu: [nyu % w for w in SCANNET_TREE_WIDTHS])
    tsv("scannetv2-labels.combined.tree-large.tsv",
        lambda i, nyu: [i % w for w in SCANNET_LARGE_WIDTHS])
    return frames, time.time() - t0


def check_scannet_loader(root: str, frames) -> bool:
    """The port's tree-large ScanNet loader on the written sequence against
    what was written: K the YAML's; depth within half a millimetre (the
    PNG's step); poses within 1e-5 of the frames' relative to frame 0;
    each label level the written raw id's tree ids, the leaf row its index
    among the TSV's ids; colour PSNR >= 30 dB (a lossy q95 4:2:0 file)."""
    import numpy as np

    from hierslam_torch.datasets import get_dataset
    from hierslam_torch.datasets.base import load_dataset_config

    cfg = load_dataset_config(os.path.join(ROOT, "configs", "data", "scannet_semantic.yaml"))
    cfg.update(sem_mode="tree_large")
    loader = get_dataset(cfg, root, SCANNET_SEQ, start=0, end=-1, stride=1,
                         desired_height=SCANNET_FRAME["H"], desired_width=SCANNET_FRAME["W"],
                         relative_pose=True)
    ids, _ = scannet_ids()
    dense = {r: i for i, r in enumerate(ids)}
    same = (len(loader) == len(frames) and loader.semantic_id == ids
            and loader.num_semantic == list(SCANNET_LARGE_WIDTHS) + [SCANNET_LEAVES])
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = (SCANNET_CAM[k] for k in ("fx", "fy", "cx", "cy"))
    inv0 = np.linalg.inv(frames[0][2])
    ms, worst = [], dict(depth=0.0, pose=0.0, psnr=1e9)
    for t, (c_ref, d_ref, c2w, raw) in enumerate(frames):
        t0 = time.time()
        color, depth, K4, pose, labels = loader[t]
        ms.append((time.time() - t0) * 1e3)
        leaf = np.vectorize(dense.get)(raw)
        want = np.stack([leaf % w for w in SCANNET_LARGE_WIDTHS] + [leaf])
        same &= bool(np.array_equal(labels, want)) and bool(np.allclose(K4, K, rtol=0, atol=1e-4))
        mse = np.mean((color.astype(np.float64) - c_ref.astype(np.float64)) ** 2)
        worst["psnr"] = min(worst["psnr"], 10 * np.log10(255.0**2 / mse))
        worst["depth"] = max(worst["depth"], float(np.abs(depth - d_ref).max()))
        worst["pose"] = max(worst["pose"], float(np.abs(pose - inv0 @ c2w).max()))
    ok = same and worst["depth"] <= 0.5e-3 + 1e-6 and worst["pose"] <= 1e-5 \
        and worst["psnr"] >= 30
    print(f"[scannet] loader (tree_large): {len(frames)} items, labels, ids and K as written: "
          f"{same}; max depth error {worst['depth']:.3e} m (allowed 5e-4), max pose error "
          f"{worst['pose']:.3e} (allowed 1e-5), min colour PSNR {worst['psnr']:.2f} dB (allowed "
          f">= 30); ms per item: " + " ".join(f"{x:.0f}" for x in ms), flush=True)
    return ok


@contextlib.contextmanager
def recording_stream_fwd(seen: list, rows: list, n_feat: int, largest: bool = False):
    """While active, the first call of the wrapper ``kernels.stream_fwd``
    with ``n_feat`` features (with ``largest``, the call with the most
    rows) leaves a copy of its (stream, scalars, row offsets, grid_x,
    image shape) in ``seen``, and ``rows`` holds the most stream rows any
    call took.  Every call still goes to the kernel."""
    from hierslam_torch.ops import kernels

    launch = kernels.stream_fwd

    def recording(stream, scalars, row_off, grid_x, tile_shape, nf, img_shape):
        if nf == n_feat and (not seen or (largest and stream.shape[0] > rows[0])):
            seen[:] = [(stream.detach().clone(), scalars.clone(), row_off.clone(), grid_x,
                        img_shape)]
        rows[0] = max(rows[0], stream.shape[0])
        return launch(stream, scalars, row_off, grid_x, tile_shape, nf, img_shape)

    kernels.stream_fwd = recording
    try:
        yield
    finally:
        kernels.stream_fwd = launch


def scannet_run(cfg_path: str, root: str, n: int, n_feat: int):
    """``run_slam`` (the CLI, in this process) on the written sequence with
    the ScanNet config ``cfg_path`` as shipped, but for ``workdir`` and
    ``num_frames``: the data's ``basedir`` comes from ``SCANNET_DIR``.
    Checks its launch counts, 0 plain calls, finite losses, 0 dropped pairs,
    the camera-centre error (< 5 cm), the eval row and the artifacts.
    Returns (ok, launches, recorded (eval table, first mapping stream))."""
    import numpy as np
    import torch

    from hierslam_torch.config import load_config, raster_config
    from hierslam_torch.eval import ate as ate_lib

    tag = f"[scannet {os.path.basename(cfg_path)}]"
    workdir = os.path.join(root, "experiments")
    wrapper = os.path.join(root, f"run_{n_feat}.py")
    with open(wrapper, "w") as f:
        f.write("import importlib.util\n"
                f"spec = importlib.util.spec_from_file_location('scannet', {cfg_path!r})\n"
                "shipped = importlib.util.module_from_spec(spec)\n"
                "spec.loader.exec_module(shipped)\n"
                "config = shipped.config\n"
                f"config['workdir'] = {workdir!r}\n"
                f"config['data']['num_frames'] = {n}\n")
    os.environ["SCANNET_DIR"] = root
    cfg = load_config(wrapper)
    run_dir = os.path.join(workdir, cfg["run_name"])
    tables, streams, rows = [], [], [0]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    with recording_stream_fwd(streams, rows, n_feat), contextlib.chdir(ROOT):
        (pn, summ, res), text, eval_s = run_cli([wrapper], tables, n_feat)
    launches, plain, n_bin = read_counts()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    row = eval_row(text)
    good_row = row is not None and len(row) == 8 and np.isfinite(row[:3] + row[4:]).all()
    it_t, it_m = cfg["tracking"]["num_iters"], cfg["mapping"]["num_iters"]
    n_eval = sum(1 for t in range(n) if t == 0 or (t + 1) % cfg["eval_every"] == 0)
    n_map = sum(1 for t in range(n) if t == 0 or (t + 1) % cfg["map_every"] == 0)
    n_classes = ladder_classes(raster_config(cfg), SCANNET_FRAME["H"], SCANNET_FRAME["W"])
    n_tk = it_t * summ["track_classes"]   # classes sized from each tracked frame's counts
    want = {"blend_fwd": n_tk + (n_map - 1) + (2 + n_eval) * n_classes,
            "blend_bwd": n_tk, "stream_fwd": n_map * it_m, "stream_bwd": n_map * it_m,
            "gather_bwd": n_map * it_m, "bin_emit": n_bin,
            **track_launches(summ, raster_config(cfg), SCANNET_FRAME["H"], SCANNET_FRAME["W"],
                             it_t)}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r[k] for r in recs for k in ("tracking_loss", "mapping_loss") if k in r]
    dropped = max(r.get("mapping_n_map_bin_dropped", 0) + r.get("mapping_n_grad_dropped", 0)
                  for r in recs)
    est = ate_lib.trajectory_from_params(pn["cam_unnorm_rots"], pn["cam_trans"])
    gt = pn["gt_w2c_all_frames"]
    errs = [float(np.linalg.norm(np.linalg.inv(est[t])[:3, 3] - np.linalg.inv(gt[t])[:3, 3]))
            * 100 for t in range(n)]
    with np.load(os.path.join(run_dir, "params.npz")) as data:
        missing = [k for k in PARAM_KEYS if k not in data]
        sem_w = data["semantic"].shape[1] if "semantic" in data else -1
    with np.load(os.path.join(run_dir, "semantic_decoder.npz")) as dec:
        dec_shape = tuple(dec["w"].shape)
    print(f"{tag} {n} frames from disk: eval row {row}; launches {json.dumps(launches)} "
          f"expected {json.dumps(want)}; plain calls {json.dumps(plain)}; semantic width "
          f"{sem_w}, decoder {dec_shape}; missing keys {missing}", flush=True)
    print(f"{tag} losses finite {bool(np.isfinite(losses).all())} ({len(losses)} records); "
          f"dropped pairs {dropped}; camera-centre error vs GT (cm): "
          + " ".join(f"{e:.3f}" for e in errs) + " (allowed < 5)", flush=True)
    print(f"{tag} tracking_iter_ms {summ['tracking_iter_ms']:.3f} mapping_iter_ms "
          f"{summ['mapping_iter_ms']:.3f} tracking_frame_s {summ['tracking_frame_s']:.3f} "
          f"mapping_frame_s {summ['mapping_frame_s']:.3f} eval_s {eval_s:.2f} wall_s {wall:.1f} "
          f"n_active {summ['n_active']} max_memory_allocated_GiB {peak:.2f} stream rows "
          f"{rows[0]} of {cfg['raster']['stream_rows']}", flush=True)
    ok = (good_row and launches == want and not any(plain.values()) and not missing
          and sem_w == n_feat - 3 and dec_shape[1] == n_feat - 3 and res is not None
          and bool(np.isfinite(losses).all()) and dropped == 0 and max(errs) < 5.0
          and summ["progress_failed"] == 0 and rows[0] <= cfg["raster"]["stream_rows"])
    return ok, launches, (tables[0] if tables else None, streams[0] if streams else None)


def scannet_phase():
    """Phase 8 (the module docstring).  Returns (ok, JSON rows, launches of
    the tree-large run)."""
    root = tempfile.mkdtemp()
    n = 6
    frames, dt = write_scannet(root, n)
    print(f"[scannet] wrote {n} frames at {SCANNET_FRAME['W']}x{SCANNET_FRAME['H']} to the "
          f"ScanNet semantic layout in {dt:.1f} s", flush=True)
    ok = check_scannet_loader(root, frames)
    good, launches, (table_rec, stream_rec) = scannet_run(SCANNET_LARGE, root, n, SCANNET_F)
    ok &= good and table_rec is not None and stream_rec is not None
    rows = []
    if table_rec is not None:
        table, slot_ok, gx, ids, n_t = table_rec
        T, K, C = table.shape
        print(f"[scannet] first eval render's table: T={T} K={K} F={C - 7} grid_x={gx}, "
              f"{100 * float(slot_ok.float().mean()):.1f}% of the slots live", flush=True)
        r, good = check_kernels(f"scannet eval table T={T} K={K} F={C - 7}", table, slot_ok, gx,
                                20, seed=4, flips_allowed=2, tile_ids=ids, n_tiles=n_t)
        rows.append(r[0])
        ok &= good
    if stream_rec is not None:
        from hierslam_torch.config import load_config, raster_config
        from hierslam_torch.ops import render_stream as rs

        stream, sc, ro, gx, img = stream_rec
        grid = raster_config(load_config(SCANNET_LARGE)).grid(*img)
        pad = stream[..., rs.COL_LOGIT] == rs.SENTINEL_LOGIT
        r, good = check_stream(f"scannet first mapping stream R={stream.shape[0]} F={SCANNET_F}",
                               stream, sc, ro, pad, grid, SCANNET_F, img, 20)
        rows += r
        ok &= good
    good, _, _ = scannet_run(SCANNET_SMALL, root, 3, 3 + sum(SCANNET_TREE_WIDTHS))
    ok &= good
    for row in rows:
        row["path"] = "scannet"
    return ok, rows, launches


REPLICA_CONFIGS = tuple(os.path.join(ROOT, "configs", "replica", f"hierslam_{name}_run.py")
                        for name in ("nosemantic", "gtpose"))
CENTRE_BOUND_CM = 5.0      # the camera-centre error the flagship phases allow


def track_classes(rc, H: int, W: int) -> int:
    """K1 launches per tracking iteration: the non-empty classes of
    ``track_bucket_spec``, or one flat class."""
    from hierslam_torch.ops.binning import resolve_bucket_spec

    if rc.track_bucket_spec is None:
        return 1
    grid = rc.grid(H, W)
    return sum(1 for nb, _ in resolve_bucket_spec(rc.track_bucket_spec, grid[0] * grid[1])
               if nb > 0)


def replica_run(cfg_path: str, root: str, n: int, tables=None, data=None, frame=FRAME,
                tag=None):
    """``python3 -m hierslam_torch.scripts.run_slam`` (in this process) on the
    plain Replica sequence under ``root`` with the shipped config
    ``cfg_path``: only ``workdir``, ``basedir`` (through ``REPLICA_DIR``)
    and ``num_frames`` change, and the keys of ``data`` in its ``data``
    block (another dataset of ``frame``'s size).  With ``tables`` (a dict of lists), the
    first K1 table of a tracking iteration (the rank ladder's first class,
    128 tiles of 1,024 slots) and of a ladder mapping iteration (128 tiles
    of 4,096) are left there.
    Checks the launch counts the config implies, 0 plain calls, finite
    losses, the camera-centre error, the eval row and the artifacts (no
    semantic channels, no decoder); with GT poses, that no tracking
    launch ran and that the written poses are the dataset's.  Returns (ok,
    launches, the camera-centre error in cm at every frame)."""
    import numpy as np
    import torch

    from hierslam_torch.config import load_config, raster_config
    from hierslam_torch.eval import ate as ate_lib

    name = os.path.basename(cfg_path)[len("hierslam_"):-len("_run.py")]
    tag = tag or f"[replica {name}]"
    workdir = os.path.join(root, "experiments", name)   # both configs' run_name is room0_0
    wrapper = os.path.join(root, f"run_{name}.py")
    with open(wrapper, "w") as f:
        f.write("import importlib.util\n"
                f"spec = importlib.util.spec_from_file_location('replica', {cfg_path!r})\n"
                "shipped = importlib.util.module_from_spec(spec)\n"
                "spec.loader.exec_module(shipped)\n"
                "config = shipped.config\n"
                f"config['workdir'] = {workdir!r}\n"
                f"config['data']['num_frames'] = {n}\n"
                + (f"config['data'].update({data!r})\n" if data else ""))
    os.environ["REPLICA_DIR"] = root
    cfg = load_config(wrapper)
    rc = raster_config(cfg)
    run_dir = os.path.join(workdir, cfg["run_name"])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        stack.enter_context(contextlib.chdir(ROOT))
        if tables is not None:
            # the differentiable renders: tracking's first class is 128 tiles
            # of 1,024 slots, the ladder mapper's 128 of 4,096 (its second is
            # 384 of 1,024)
            for key, k in (("tracking", 1024), ("mapping", 4096)):
                stack.enter_context(recording_blend_fwd(
                    tables.setdefault(key, []),
                    pick=lambda tab, k=k: (differentiable(tab)
                                           and tuple(tab.shape[:2]) == (128, k))))
        (pn, summ, res), text, eval_s = run_cli([wrapper])
    launches, plain, n_bin = read_counts()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    row = eval_row(text)
    good_row = row is not None and len(row) == 8 and np.isfinite(row[:3] + row[4:6]).all()
    gt = cfg["tracking"]["use_gt_poses"]
    it_t, it_m = cfg["tracking"]["num_iters"], cfg["mapping"]["num_iters"]
    n_eval = sum(1 for t in range(n) if t == 0 or (t + 1) % cfg["eval_every"] == 0)
    n_map = sum(1 for t in range(n) if t == 0 or (t + 1) % cfg["map_every"] == 0)
    n_cls = ladder_classes(rc, frame["H"], frame["W"])
    n_tcls = track_classes(rc, frame["H"], frame["W"])
    n_track = it_t * summ["track_classes"]   # 0 with GT poses
    want = {"blend_fwd": n_track + (n_map - 1) + (2 + n_eval) * n_cls + n_map * it_m * n_cls,
            "blend_bwd": n_track + n_map * it_m * n_cls, "stream_fwd": 0, "stream_bwd": 0,
            "gather_bwd": n_map * it_m, "bin_emit": n_bin,
            **track_launches(summ, rc, frame["H"], frame["W"], it_t)}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r[k] for r in recs for k in ("tracking_loss", "mapping_loss") if k in r]
    n_tracked = sum(1 for r in recs if r.get("phase") == "tracking")
    dropped = max(r.get("mapping_n_map_bin_dropped", 0) for r in recs)
    grad_dropped = max(r.get("mapping_n_grad_dropped", 0) for r in recs)
    past_budget = max(0, max(r.get("n_active", 0) for r in recs) - rc.visible_budget)
    est = ate_lib.trajectory_from_params(pn["cam_unnorm_rots"], pn["cam_trans"])
    gtw = pn["gt_w2c_all_frames"]
    errs = [float(np.linalg.norm(np.linalg.inv(est[t])[:3, 3] - np.linalg.inv(gtw[t])[:3, 3]))
            * 100 for t in range(n)]
    pose_err = float(np.abs(est - gtw).max())
    missing = [f for f in ("params.npz", "config.py") if not os.path.isfile(
        os.path.join(run_dir, f))]
    with np.load(os.path.join(run_dir, "params.npz")) as saved:
        missing += [k for k in PARAM_KEYS if k != "semantic" and k not in saved]
        semantic = "semantic" in saved
    decoder = os.path.isfile(os.path.join(run_dir, "semantic_decoder.npz"))
    print(f"{tag} {n} frames from disk ({os.path.basename(cfg_path)}"
          + (f", data {json.dumps(data)}" if data else " as shipped") + "): eval row "
          f"{row}; launches {json.dumps(launches)} expected {json.dumps(want)} ({n_tcls} "
          f"tracking classes, {n_cls} ladder classes); plain calls {json.dumps(plain)}",
          flush=True)
    print(f"{tag} losses finite {bool(np.isfinite(losses).all())} ({len(losses)} records, "
          f"{n_tracked} tracking iteration records); mapping binning dropped at most {dropped} "
          f"pairs (ladder caps, emission budgets, visible budget), gaussians past "
          f"visible_budget={rc.visible_budget}: {past_budget}; n_grad_dropped {grad_dropped}; "
          f"camera-centre error vs GT (cm): " + " ".join(f"{e:.3f}" for e in errs)
          + f" (allowed < {CENTRE_BOUND_CM}); written poses vs the dataset's, max abs "
          f"{pose_err:.3e}" + (" (allowed 1e-5)" if gt else ""), flush=True)
    print(f"{tag} tracking_iter_ms {summ['tracking_iter_ms']:.3f} mapping_iter_ms "
          f"{summ['mapping_iter_ms']:.3f} eval_s {eval_s:.2f} wall_s {wall:.1f} n_active "
          f"{summ['n_active']} max_memory_allocated_GiB {peak:.2f}; semantic channels "
          f"{semantic}, decoder {decoder}, missing {missing}", flush=True)
    ok = (good_row and launches == want and not any(plain.values()) and not missing
          and not semantic and not decoder and res is not None
          and bool(np.isfinite(losses).all()) and max(errs) < CENTRE_BOUND_CM
          and summ["progress_failed"] == 0)
    if gt:
        ok &= n_tracked == 0 and pose_err <= 1e-5
    return ok, launches, errs


def replica_phase():
    """Phase 9 (the module docstring).  Returns (ok, JSON rows, launches of
    the nosemantic run)."""
    root = tempfile.mkdtemp()
    n = 8
    _, dt = write_sequence(root, n, semantic=False)
    print(f"[replica] wrote {n} frames at {FRAME['W']}x{FRAME['H']} to the plain Replica layout "
          f"in {dt:.1f} s", flush=True)
    tables = {}
    ok, launches, _ = replica_run(REPLICA_CONFIGS[0], root, n, tables)
    good, _, _ = replica_run(REPLICA_CONFIGS[1], root, n)
    ok &= good
    rows = []
    for key, seed in (("tracking", 5), ("mapping", 6)):
        if not tables.get(key):
            print(f"[replica nosemantic] no {key} table was recorded", flush=True)
            ok = False
            continue
        table, slot_ok, gx, ids, n_t = tables[key][0]
        T, K, C = table.shape
        print(f"[replica nosemantic] first {key} iteration's K1 table: T={T} K={K} F={C - 7} "
              f"grid_x={gx}, {100 * float(slot_ok.float().mean()):.1f}% of the slots live",
              flush=True)
        r, good = check_kernels(f"nosemantic {key} table T={T} K={K} F={C - 7}", table,
                                slot_ok, gx, 20, seed=seed, flips_allowed=2, tile_ids=ids,
                                n_tiles=n_t)
        rows += r
        ok &= good
    for row in rows:
        row["path"] = "replica"
    return ok, rows, launches


TUM_SEQ = "rgbd_dataset_freiburg1_desk"     # a TUM RGB-D sequence's name
TUM_YAML = "./configs/data/tum.yaml"        # the data config, as a run config names it
TUM_FRAME = dict(W=640, H=480)              # TUM's frames (configs/data/tum.yaml)
TUM_T0 = 1305031452.791720                  # TUM's stamps: seconds since 1970


def tum_camera():
    """(camera_params, K, distortion) of configs/data/tum.yaml."""
    import numpy as np

    from hierslam_torch.datasets.base import load_dataset_config

    cam = load_dataset_config(os.path.join(ROOT, TUM_YAML))["camera_params"]
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1.0]])
    return cam, K, np.asarray(cam["distortion"], np.float64)


def distort(img, K, dist, iters: int = 20):
    """What a lens with ``dist`` (k1, k2, p1, p2, k3) sees of the ideal
    image ``img``: every pixel samples ``img`` (bilinear, edges clamped) at
    its undistorted position, found by the fixed-point iteration of
    ``cv2.undistortPoints``."""
    import numpy as np

    H, W = img.shape[:2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    k1, k2, p1, p2, k3 = dist
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    x0, y0 = (u - cx) / fx, (v - cy) / fy
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (x0 - dx) * icdist, (y0 - dy) * icdist
    su, sv = np.clip(fx * x + cx, 0, W - 1), np.clip(fy * y + cy, 0, H - 1)
    i0 = np.minimum(np.floor(sv).astype(np.int64), H - 2)
    j0 = np.minimum(np.floor(su).astype(np.int64), W - 2)
    b, a = (sv - i0)[..., None], (su - j0)[..., None]
    f = img.astype(np.float64)
    out = (f[i0, j0] * (1 - a) * (1 - b) + f[i0, j0 + 1] * a * (1 - b)
           + f[i0 + 1, j0] * (1 - a) * b + f[i0 + 1, j0 + 1] * a * b)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def write_tum(root: str, n: int, distorted: bool = True):
    """Frames 0..n-1 of the procedural room at 640x480, rendered with the
    intrinsics of configs/data/tum.yaml, in the TUM layout under
    ``root/TUM_SEQ``: colour PNGs through the lens's forward distortion
    (so that the loader's undistortion lines them up with the depth; the
    ideal frames with ``distorted=False``),
    16-bit depth PNGs (x 5000), and ``rgb.txt``, ``depth.txt`` and
    ``groundtruth.txt`` (tx ty tz qx qy qz qw) at 30 Hz, the depth 10 ms
    after each colour frame.  Returns (the ideal frames (colour, depth,
    c2w), seconds to write)."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    from hierslam_torch.utils.image_io import write_png

    cam, K, dist = tum_camera()
    room = load_module("procedural_room", os.path.join(ROOT, "tools", "procedural_room.py"))
    t0 = time.time()
    seq = os.path.join(root, TUM_SEQ)
    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(seq, d))
    frames, lists = [], {"rgb.txt": [], "depth.txt": [], "groundtruth.txt": []}
    for t in range(n):
        color, depth, c2w, _ = room.render_frame(t, TUM_FRAME["W"], TUM_FRAME["H"], cam["fx"],
                                                 cam["fy"], cam["cx"], cam["cy"], 200)
        frames.append((color, depth, c2w))
        tc, td = f"{TUM_T0 + t / 30:.6f}", f"{TUM_T0 + t / 30 + 0.01:.6f}"
        write_png(os.path.join(seq, "rgb", f"{tc}.png"),
                  distort(color, K, dist) if distorted else color)
        write_png(os.path.join(seq, "depth", f"{td}.png"), np.clip(
            np.round(depth * cam["png_depth_scale"]), 0, 65535).astype(np.uint16))
        quat = Rotation.from_matrix(c2w[:3, :3]).as_quat()
        lists["rgb.txt"].append(f"{tc} rgb/{tc}.png")
        lists["depth.txt"].append(f"{td} depth/{td}.png")
        lists["groundtruth.txt"].append(" ".join([tc] + [repr(float(v)) for v in c2w[:3, 3]]
                                                 + [repr(float(v)) for v in quat]))
    for name, lines in lists.items():
        with open(os.path.join(seq, name), "w") as f:
            f.write(f"# {name}\n# file: '{TUM_SEQ}.bag'\n# timestamp data\n"
                    + "\n".join(lines) + "\n")
    return frames, time.time() - t0


def check_tum_loader(root: str, frames, n: int) -> bool:
    """The port's TUM loader on the written sequence against the frames that
    were written: all n frames associated, depth within half a PNG step
    (0.5/5000 m), K equal to the YAML's, poses within 1e-5 of the written
    ones relative to frame 0, and the undistorted colour within 30 dB PSNR
    of the ideal frame where its source lies inside the image (the
    distorted file itself is printed for comparison).  Prints the read time
    of each item (two PNG decodes and the undistortion)."""
    import numpy as np

    from hierslam_torch.datasets import get_dataset
    from hierslam_torch.datasets.base import load_dataset_config, undistort_map
    from hierslam_torch.utils.image_io import read_image

    cfg = load_dataset_config(os.path.join(ROOT, TUM_YAML))
    loader = get_dataset(cfg, root, TUM_SEQ, start=0, end=-1, stride=1,
                         desired_height=TUM_FRAME["H"], desired_width=TUM_FRAME["W"],
                         relative_pose=True)
    cam, K, dist = tum_camera()
    iu, iv = undistort_map(K.astype(np.float32), dist, TUM_FRAME["H"], TUM_FRAME["W"])
    inside = ((iu >= 32) & (iu < 32 * (TUM_FRAME["W"] - 2)) & (iv >= 32)
              & (iv < 32 * (TUM_FRAME["H"] - 2)))
    inv0 = np.linalg.inv(frames[0][2])
    ok = len(loader) == n and loader.distortion is not None
    ms, worst = [], dict(depth=0.0, pose=0.0, psnr=1e9, raw=0.0)

    def psnr(a, b):
        return 10 * np.log10(255.0**2 / np.mean((a.astype(np.float64) - b) ** 2))

    for t in range(min(n, len(loader))):
        t0 = time.time()
        color, depth, K4, pose = loader[t]
        ms.append((time.time() - t0) * 1e3)
        c_ref, d_ref, c2w = frames[t]
        raw = read_image(loader.color_paths[t])
        worst["psnr"] = min(worst["psnr"], psnr(color[inside], c_ref[inside]))
        worst["raw"] = max(worst["raw"], psnr(raw[inside], c_ref[inside]))
        worst["depth"] = max(worst["depth"], float(np.abs(depth - d_ref).max()))
        worst["pose"] = max(worst["pose"], float(np.abs(pose - inv0 @ c2w).max()))
        ok &= bool(np.array_equal(K4[:3, :3], K.astype(np.float32)))
    step = 1 / cam["png_depth_scale"]
    ok &= worst["depth"] <= 0.5 * step + 1e-6 and worst["pose"] <= 1e-5 and worst["psnr"] >= 30
    print(f"[tum] loader: {len(loader)} of {n} frames associated, K equal and distortion on: "
          f"{ok}; max depth error {worst['depth']:.3e} m (allowed {0.5 * step:.3e}), max pose "
          f"error {worst['pose']:.3e} (allowed 1e-5), min colour PSNR against the ideal frame "
          f"{worst['psnr']:.2f} dB over the {100 * float(inside.mean()):.1f}% of pixels whose "
          f"source lies inside the image (allowed >= 30; the distorted file itself: at most "
          f"{worst['raw']:.2f} dB); ms per item (2 PNG decodes + undistortion): "
          + " ".join(f"{x:.0f}" for x in ms) + f", median {statistics.median(ms):.0f}",
          flush=True)
    return ok


TUM_RUNS = 2   # [tum] runs the CLI twice: the same centre error, to the bit


def tum_phase():
    """Phase 10 (the module docstring).  Returns (ok, JSON rows, launches).

    The run is made twice in this process with the float order free, and
    both must read the same frame-7 camera-centre error to the bit, inside
    its bound.  Before the gather's backward summed each row's references
    in a fixed order (K5), the same inputs gave 2.9 to 7.3 cm over five
    runs on an H100 and passed the bound in two of six: the nosemantic
    config tracks seven frames against frame 0's map, and where its
    tracking ends moved with the order of the GPU's atomic adds
    (``tools/tum_drift_torch.py`` runs the variants)."""
    root = tempfile.mkdtemp()
    n = 8
    frames, dt = write_tum(root, n)
    print(f"[tum] wrote {n} frames at {TUM_FRAME['W']}x{TUM_FRAME['H']} to the TUM layout "
          f"(colour through tum.yaml's distortion) in {dt:.1f} s", flush=True)
    ok = check_tum_loader(root, frames, n)
    tables, gather_seen = {}, []
    data = dict(gradslam_data_cfg=TUM_YAML, basedir=root, sequence=TUM_SEQ,
                desired_image_height=TUM_FRAME["H"], desired_image_width=TUM_FRAME["W"])
    errs = []
    for i in range(TUM_RUNS):
        with recording_gather_bwd(gather_seen) if i == 0 else contextlib.nullcontext():
            good, run_launches, e = replica_run(REPLICA_CONFIGS[0], root, n,
                                                tables if i == 0 else None, data=data,
                                                frame=TUM_FRAME, tag=f"[tum run {i + 1}]")
        ok &= good
        errs.append(e[-1])
        launches = launches if i else run_launches
    same = len(set(errs)) == 1
    print(f"[tum] frame {n - 1} camera-centre error of the {TUM_RUNS} runs (cm): "
          + " ".join(repr(e) for e in errs) + f"; equal to the bit: {same}", flush=True)
    ok &= same
    rows = []
    if not tables.get("tracking") or not gather_seen:
        print("[tum] no tracking table or gather backward was recorded", flush=True)
        return False, rows, launches
    table, slot_ok, gx, ids, n_t = tables["tracking"][0]
    T, K, C = table.shape
    print(f"[tum] first tracking iteration's K1 table: T={T} K={K} F={C - 7} grid_x={gx}, "
          f"{100 * float(slot_ok.float().mean()):.1f}% of the slots live", flush=True)
    r, good = check_kernels(f"tum tracking table T={T} K={K} F={C - 7}", table, slot_ok, gx, 20,
                            seed=7, flips_allowed=2, tile_ids=ids, n_tiles=n_t)
    r2, good2 = check_gather("tum ladder mapper first backward", *gather_seen[0])
    for row in r + r2:
        row["path"] = "tum"
    return ok and good and good2, r + r2, launches


def runner_state(r, dev):
    """What ``SLAMRunner.step`` reads and changes besides its frames: the map,
    the bucket, the decoder with its Adam state and both random streams,
    copied onto ``dev``."""
    import copy

    from hierslam_torch.slam import optim

    def to(d):
        return {k: v.detach().to(dev, copy=True) for k, v in d.items()}

    ms = r.mlp_state
    return dict(params=to(r.params), variables=to(r.variables), bucket=r.bucket,
                mlp=None if r.mlp is None else to(r.mlp),
                mlp_state=None if ms is None else optim.AdamState(to(ms.mu), to(ms.nu), ms.count),
                generator=r.generator.get_state(), rng=copy.deepcopy(r.rng.bit_generator.state))


def set_runner_state(r, state) -> None:
    r.params, r.variables, r.bucket = state["params"], state["variables"], state["bucket"]
    r.mlp, r.mlp_state = state["mlp"], state["mlp_state"]
    r.generator.set_state(state["generator"])
    r.rng.bit_generator.state = state["rng"]


def capacity_phase(devices=("cuda", "cpu")):
    """Phase 11 (the module docstring): the same tiny run on each device, in
    a map too small for it.  Each frame starts on the second device from
    the first device's state before that frame (the map, the bucket, the
    decoder, the random streams), so that both take the same inputs: the
    densify masks threshold silhouettes and depth errors, where two maps
    that parted by float rounding would flip single pixels.  Returns ok."""
    import numpy as np

    from hierslam_torch.config import load_config
    from hierslam_torch.slam.pipeline import SLAMRunner

    ds = room_dataset(3, 96, 64, 48.0, n_frames_arc=6)
    cfg_path = os.path.join(ROOT, "configs", "replica", "hierslam_semantic_run.py")
    runners, reasons = [], []
    for dev in devices:
        cfg = load_config(cfg_path)
        cfg["raster"].update(bucket_spec=((4, 512), (-1, 256)), track_max_per_tile=256)
        cfg["data"]["num_frames"] = 3
        # 6,144 slots for frame 0 and 2,048 more; the mapping prunes what lies
        # beyond 4.8 / 4.82 of frame 0's farthest depth, so each densify meets
        # holes and new surface in a full bucket
        cfg.update(map_every=1, map_capacity=CAPACITY_SLOTS, bucket_step=1024,
                   bucket_headroom=0, hole_compact_threshold=10**9,
                   scene_radius_depth_ratio=4.82, workdir=tempfile.mkdtemp())
        cfg["tracking"].update(num_iters=10, use_gt_poses=True)
        cfg["mapping"].update(num_iters=10, on_capacity_saturated="warn")
        r = SLAMRunner(cfg, dataset=ds, device=dev)
        reasons.append([])
        compact = r._compact

        def recording(reason, compact=compact, seen=reasons[-1]):
            seen.append(reason)
            compact(reason)

        r._compact = recording
        runners.append(r)
    first, second = devices
    bucket0 = runners[0].bucket
    keys = ("densify_added", "densify_overflow", "compactions", "slots_reclaimed",
            "emergency_pruned")
    ok, worst = True, 0.0
    for t in range(3):
        state = runner_state(runners[0], runners[1].device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            runners[0].step(t)
            set_runner_state(runners[1], state)
            runners[1].step(t)
        got = [(dict({k: r.stats[k] for k in keys}, n_active=int(r.variables["n_active"]),
                     bucket=r.bucket), list(seen), r.last_mapping_trace["loss"])
               for r, seen in zip(runners, reasons)]
        (sa, ra, la), (sb, rb, lb) = got
        rel = float(np.max(np.abs(la - lb) / np.abs(lb)))
        worst = max(worst, rel)
        ok &= sa == sb and ra == rb
        print(f"[capacity] frame {t}: {first} {json.dumps(sa)}, {second} {json.dumps(sb)}; "
              f"mapping loss max rel diff {rel:.3e}; compactions so far: " + "; ".join(ra),
              flush=True)
    s = sa
    reached = (bucket0 < CAPACITY_SLOTS and s["emergency_pruned"] > 0
               and any(x.startswith("densify overflow") for x in ra)
               and any(x.startswith("escalated prune") for x in ra))
    print(f"[capacity] {first} vs {second}, capacity {CAPACITY_SLOTS}: stats (compactions "
          f"{s['compactions']}, slots_reclaimed {s['slots_reclaimed']}, emergency_pruned "
          f"{s['emergency_pruned']}) and compactions equal at every frame: {ok}; mapping loss "
          f"max rel diff {worst:.3e} (allowed 1e-2, as the reference phase); bucket growth "
          f"from {bucket0} to the capacity (an escalated prune runs only in a full bucket), a "
          f"compaction of pruning holes and an escalated prune: {reached}", flush=True)
    return ok and worst <= 1e-2 and reached


def real_shape_phase():
    """Phase 12 (the module docstring).  Returns (ok, JSON rows, launches)."""
    import numpy as np
    import torch

    from hierslam_torch.ops import render_stream as rs

    tool = load_module("real_shape_run_torch", os.path.join(ROOT, "tools",
                                                             "real_shape_run_torch.py"))
    root = tempfile.mkdtemp()
    argv = ["--frames", "200", "--stop-at", str(REAL_SHAPE_FRAMES), "--capacity",
            str(REAL_SHAPE_CAPACITY), "--data", os.path.join(root, "data"), "--workdir",
            os.path.join(root, "run")]
    streams, rows, tables, densifies = [], [0], [], [0]

    def count_densifies(runner):
        """Each remedy redoes the densify, and each densify renders once."""
        densify = runner.densifier

        def counting(*a, **kw):
            densifies[0] += 1
            return densify(*a, **kw)

        runner.densifier = counting

    # the tool zeroes its counts after writing the frames (no binning) and
    # reads them just before its K against 2K check, which bins again
    oq_check, bins_read = tool.overflow_quality_check, []

    def counted_then_check(*a, **kw):
        bins_read.append(BINNINGS[0])
        return oq_check(*a, **kw)

    tool.overflow_quality_check = counted_then_check
    count_binnings()
    BINNINGS[0] = 0
    with recording_stream_fwd(streams, rows, tool.FEATURES, largest=True), \
            recording_blend_fwd(tables, pick=lambda tab: tab.shape[1] == 2 * 4096):
        report, runner = tool.run(argv, runner_hook=count_densifies)
    s, m = report["summary"], report["metrics"]
    width = 3 + runner.num_semantic
    launches, plain, n_bin = report["launches"], report["plain_calls"], bins_read[0]
    n = report["frames"]
    cfg = runner.config
    it_t, it_m = cfg["tracking"]["num_iters"], cfg["mapping"]["num_iters"]
    n_eval = sum(1 for t in range(n) if t == 0 or (t + 1) % cfg["eval_every"] == 0)
    n_map = sum(1 for t in range(n) if t == 0 or (t + 1) % cfg["map_every"] == 0)
    n_cls = ladder_classes(runner.rc, runner.H, runner.W)
    n_tk = it_t * s["track_classes"]   # classes sized from each tracked frame's counts
    want = {"blend_fwd": n_tk + densifies[0] + (2 + n_eval) * n_cls,
            "blend_bwd": n_tk, "stream_fwd": n_map * it_m, "stream_bwd": n_map * it_m,
            "gather_bwd": n_map * it_m, "bin_emit": n_bin,
            **track_launches(s, runner.rc, runner.H, runner.W, it_t)}
    print(f"[real_shape] F = {width} (3 + num_semantic); {n} frames of the 200-frame "
          f"procedural room at "
          f"{report['image'][0]}x{report['image'][1]}, tools/real_shape_run_torch.py's "
          f"configuration (raster {json.dumps(report['raster'])}); reduced: map_capacity "
          f"{REAL_SHAPE_CAPACITY} (2,000,000 in the tool) so that {n} frames reach compaction "
          f"and the escalated prune; writing the frames took {report['generate_s']} s",
          flush=True)
    print(f"[real_shape] launches {json.dumps(launches)} expected {json.dumps(want)} "
          f"({densifies[0]} densify renders for {n_map - 1} densifies: each remedy redoes one); "
          f"plain calls {json.dumps(plain)}; summary {json.dumps(s)}", flush=True)
    print(f"[real_shape] eval {json.dumps(m)}; K vs 2K {json.dumps(report['overflow_quality'])}; "
          f"peak memory {report['max_memory_allocated_GiB']} GiB; stream rows at most "
          f"{report['max_stream_rows']} of {report['stream_rows_budget']} (per phase "
          + " ".join(str(p["max_stream_rows"]) for p in report["mapping_phases"])
          + f"); most pairs dropped {json.dumps(report['max_dropped'])}; decode "
          f"{report['decode_ms_per_item']} ms an item; SLAM + eval {report['wall_s']} s",
          flush=True)
    finite = all(np.isfinite(v) for k, v in m.items() if k != "lpips")
    ok = (launches == want and not any(plain.values()) and finite and s["compactions"] >= 1
          and width == tool.FEATURES
          and s["emergency_pruned"] > 0 and s["progress_failed"] == 0
          and report["max_stream_rows"] <= report["stream_rows_budget"])
    out = []
    if streams:
        stream, sc, ro, gx, img = streams[0]
        grid = (ro.shape[0] - 1) // gx, gx
        pad = stream[..., rs.COL_LOGIT] == rs.SENTINEL_LOGIT
        r, good = check_stream(f"real_shape largest mapping stream R={stream.shape[0]} "
                               f"F={tool.FEATURES}", stream, sc, ro, pad, grid, tool.FEATURES,
                               img, 20, flips_allowed=2)
        out += r
        ok &= good
    if tables:
        table, slot_ok, gx, ids, n_t = tables[0]
        T, K, C = table.shape
        print(f"[real_shape] the 2K check's densest class: T={T} K={K} F={C - 7} grid_x={gx}, "
              f"{100 * float(slot_ok.float().mean()):.1f}% of the slots live", flush=True)
        r, good = check_kernels(f"real_shape 2K table T={T} K={K} F={C - 7}", table, slot_ok,
                                gx, 20, seed=8, flips_allowed=2, tile_ids=ids, n_tiles=n_t)
        out += r
        ok &= good
    ok &= bool(streams) and bool(tables)
    del runner
    torch.cuda.empty_cache()
    for row in out:
        row["path"] = "real_shape"
    return ok, out, launches


CLASSIC_DENSIFY = dict(start_after=10, densify_every=20, stop_after=50, remove_big_after=30)
# the shipped grad_thresh (2e-4) at 96x64, scaled by the pixel count above
# it: the mapping loss is a mean over the image, so a gaussian's mean
# |dL/d means2D| falls as 1/pixels (at 1200x680 nothing reaches 2e-4)
CLASSIC_THRESH_PIXELS = 2e-4 * 96 * 64
CLASSIC_FRAMES = 8      # mapping at t = 0 and t = 7 under the shipped map_every = 8
NEAR_THRESH_REL = 1e-3  # accumulated gradients this close to grad_thresh may decide either way
# the 96x64 GPU-vs-CPU runs: every tile list whole (frame 0 inserts 6,144 gaussians)
SMALL_RUN = dict(map_capacity=65536)
SMALL_RASTER = dict(bucket_spec=((-1, 1024),), track_bucket_spec=((-1, 1024),))


def plain_frames(ds):
    """``ds`` without its labels: a dataset of the non-semantic configs."""
    class Plain:
        def __len__(self):
            return len(ds)

        def __getitem__(self, t):
            return ds[t][:4]

    return Plain()


def classic_config(workdir: str, n: int, pixels: int, **extra):
    """configs/replica/hierslam_nosemantic_run.py (the ladder mapper, F = 3)
    with classic densification on: ``visible_budget=0``, which it needs, a
    densify schedule that fires inside a 60-iteration phase (the shipped
    ``start_after=500`` never does) and ``grad_thresh`` for frames of
    ``pixels`` (``CLASSIC_THRESH_PIXELS``)."""
    from hierslam_torch.config import load_config

    cfg = load_config(REPLICA_CONFIGS[0])
    cfg["mapping"]["use_gaussian_splatting_densification"] = True
    cfg["mapping"]["densify_dict"] = dict(cfg["mapping"]["densify_dict"], **CLASSIC_DENSIFY,
                                          grad_thresh=CLASSIC_THRESH_PIXELS / pixels)
    cfg["raster"] = dict(cfg["raster"], visible_budget=0)
    cfg["data"]["num_frames"] = n
    cfg.update(workdir=workdir, **extra)
    return cfg


@contextlib.contextmanager
def recording_densify(events: list, after=None):
    """While active, every ``densify_step`` of a classic mapping phase leaves
    (iteration, clone mask, split mask, mean gradient, pruned count, rows
    before) in ``events``, and calls ``after()`` once it is done.  The
    masks are the function's own rule, computed here from its inputs."""
    import torch

    from hierslam_torch.slam import mapping

    step = mapping.densify_step

    def recording(params, variables, opt, it, cfg, *a, **kw):
        active = variables["active"]
        grads = variables["means2D_gradient_accum"] / variables["denom"].clamp_min(1e-12)
        grads = torch.where(torch.isnan(grads) | ~active, torch.zeros_like(grads), grads)
        small = params["log_scales"].exp().amax(1) <= 0.01 * variables["scene_radius"]
        dense = grads >= cfg.grad_thresh
        clone, split = dense & small & active, dense & ~small & active
        out = step(params, variables, opt, it, cfg, *a, **kw)
        pruned = int((active & ~out[1]["active"]).sum()) - int(split.sum())
        seen = grads[variables["denom"] > 0]
        pct = (torch.quantile(seen[:2**24].float(), torch.tensor([0.5, 0.9, 0.99],
                                                              device=seen.device)).tolist()
               + [float(seen.max())] if seen.numel() else [])
        events.append(dict(it=it, clone=clone.cpu(), split=split.cpu(), grads=grads.cpu(),
                           pruned=pruned, rows=int(variables["n_active"]),
                           overflow=int(out[3]), seen=int(seen.numel()), pct=pct))
        if after is not None:
            after()
        return out

    mapping.densify_step = recording
    try:
        yield
    finally:
        mapping.densify_step = step


def classic_phase():
    """Phase 13 (the module docstring).  Returns (ok, JSON rows, launches,
    the run's final state, the 96x64 GPU-vs-CPU run's state after its
    phase)."""
    import numpy as np
    import torch

    from hierslam_torch.config import raster_config
    from hierslam_torch.slam.densify_classic import DensifyConfig
    from hierslam_torch.slam.pipeline import SLAMRunner

    tag = "[classic]"
    n = CLASSIC_FRAMES
    cfg = classic_config(tempfile.mkdtemp(), n, FRAME["W"] * FRAME["H"])
    print(f"{tag} {os.path.basename(REPLICA_CONFIGS[0])} on {n} procedural frames at "
          f"{FRAME['W']}x{FRAME['H']}; overrides: "
          "mapping.use_gaussian_splatting_densification=True, raster.visible_budget=0, "
          f"densify_dict {json.dumps(CLASSIC_DENSIFY)} and grad_thresh "
          f"{cfg['mapping']['densify_dict']['grad_thresh']:.6g} (2e-4 at 96x64, scaled by "
          "the pixel count)", flush=True)
    ds = plain_frames(room_dataset(n, FRAME["W"], FRAME["H"], FRAME["f"]))
    runner = SLAMRunner(cfg, dataset=ds, device="cuda")
    rc = raster_config(cfg)
    dcfg = DensifyConfig(**cfg["mapping"]["densify_dict"])
    events, tables, armed = [], [], [False]
    reset_counts()
    t0 = time.time()
    with recording_densify(events, after=lambda: armed.__setitem__(0, True)), \
            recording_blend_fwd(tables, pick=lambda tab: armed[0] and differentiable(tab)):
        for t in range(n):
            runner.step(t)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, plain, n_bin = read_counts()
    summ = runner.runtime_summary()
    it_t, it_m = cfg["tracking"]["num_iters"], cfg["mapping"]["num_iters"]
    n_map = sum(1 for t in range(n) if t == 0 or (t + 1) % cfg["map_every"] == 0)
    n_cls = ladder_classes(rc, runner.H, runner.W)
    n_tk = it_t * summ["track_classes"]   # the tracked frames' classes, an iteration each
    ev = dcfg.events(it_m)
    want = {"blend_fwd": n_tk + (n_map - 1) + 2 * n_cls + n_map * it_m * n_cls,
            "blend_bwd": n_tk + n_map * it_m * n_cls,
            "stream_fwd": 0, "stream_bwd": 0, "gather_bwd": n_map * it_m, "bin_emit": n_bin,
            **track_launches(summ, rc, runner.H, runner.W, it_t)}
    for e in events:
        print(f"{tag} densify at iteration {e['it']}: clones {int(e['clone'].sum())} splits "
              f"{int(e['split'].sum())} pruned {e['pruned']} of {e['rows']} rows, overflow "
              f"{e['overflow']}; mean |dL/d means2D| of the {e['seen']} seen gaussians, "
              "median / 90% / 99% / max: " + " ".join(f"{v:.3e}" for v in e["pct"]),
              flush=True)
    trace = runner.last_mapping_trace
    print(f"{tag} launches {json.dumps(launches)} expected {json.dumps(want)} ({n_map} mapping "
          f"phases of {len(ev) + 1} segments, events at {list(ev)}, each segment binning the "
          f"window again; {summ['track_classes']} tracking classes over the frames and "
          f"{n_cls} ladder classes); plain calls "
          f"{json.dumps(plain)}; classic_densify_overflow "
          f"{float(trace['classic_densify_overflow'][0]):.0f}", flush=True)
    pn = runner.finalize()
    path = os.path.join(cfg["workdir"], cfg["run_name"], "params.npz")
    with np.load(path) as data:
        missing = [k for k in PARAM_KEYS if k != "semantic" and k not in data]
        finite = all(np.isfinite(data[k]).all() for k in data.files)
    errs = centre_err_cm(runner, room_dataset(n, FRAME["W"], FRAME["H"], FRAME["f"]), n)
    print(f"{tag} tracking_iter_ms {summ['tracking_iter_ms']:.3f} mapping_iter_ms "
          f"{summ['mapping_iter_ms']:.3f} wall_s {wall:.1f} n_active {summ['n_active']}; "
          f"params.npz missing keys {missing}, all finite {finite}; camera-centre error vs GT "
          "(cm): " + " ".join(f"{e:.3f}" for e in errs), flush=True)
    born = [int(e["clone"].sum() + e["split"].sum()) for e in events]
    ok = (launches == want and not any(plain.values()) and len(events) == n_map * len(ev)
          and all(b > 0 for b in born) and not missing and finite
          and float(trace["classic_densify_overflow"][0]) == 0
          and bool(np.isfinite(trace["loss"]).all()) and bool(np.isfinite(errs).all()))
    rows = []
    if not tables:
        print(f"{tag} no table after a densify event was recorded", flush=True)
        ok = False
    else:
        table, slot_ok, gx, ids, n_t = tables[0]
        T, K, C = table.shape
        print(f"{tag} first mapping table after the first densify event: T={T} K={K} "
              f"F={C - 7} grid_x={gx}, {100 * float(slot_ok.float().mean()):.1f}% of the slots "
              "live", flush=True)
        rows, good = check_kernels(f"classic mapping table after a densify T={T} K={K} "
                                   f"F={C - 7}", table, slot_ok, gx, 20, seed=9,
                                   flips_allowed=2, tile_ids=ids, n_tiles=n_t)
        ok &= good
    good, small_state = classic_agreement()
    for row in rows:
        row["path"] = "classic"
    return ok and good, rows, launches, runner_state(runner, "cuda"), small_state


def classic_agreement() -> bool:
    """One classic mapping phase (frame 0 of the 96x64 room) on the GPU and
    on the CPU from the same state: the clone and split sets of each event
    must be equal but for gaussians whose mean gradient lies within
    ``NEAR_THRESH_REL`` of ``grad_thresh`` (K2's atomics sum in the order
    they land, so such a sum may round to either side).  Once an event
    differs, later events are compared on the rows both maps share.
    Returns (ok, the GPU runner's state after the phase)."""
    import numpy as np

    from hierslam_torch.slam.pipeline import SLAMRunner

    tag = "[classic]"
    ds = plain_frames(room_dataset(3, 96, 64, 48.0, n_frames_arc=40))
    runners, events = [], {}
    for dev in ("cuda", "cpu"):
        cfg = classic_config(tempfile.mkdtemp(), 3, 96 * 64, **SMALL_RUN)
        cfg["raster"].update(SMALL_RASTER)
        runners.append(SLAMRunner(cfg, dataset=ds, device=dev))
    set_runner_state(runners[1], runner_state(runners[0], "cpu"))
    thresh = float(runners[0].config["mapping"]["densify_dict"]["grad_thresh"])
    for r, dev in zip(runners, ("cuda", "cpu")):
        events[dev] = []
        with recording_densify(events[dev]):
            r.step(0)
    g, c = events["cuda"], events["cpu"]
    ok = len(g) == len(c) > 0
    shared, near_all, off_all = None, 0, 0
    for eg, ec in zip(g, c):
        rows = shared or min(len(eg["clone"]), len(ec["clone"]))
        near = ((eg["grads"][:rows] - thresh).abs() <= NEAR_THRESH_REL * thresh) | (
            (ec["grads"][:rows] - thresh).abs() <= NEAR_THRESH_REL * thresh)
        differ = (eg["clone"][:rows] != ec["clone"][:rows]) | (
            eg["split"][:rows] != ec["split"][:rows])
        off = int((differ & ~near).sum())
        near_all += int(near.sum())
        off_all += off
        print(f"{tag} 96x64 GPU vs CPU, densify at iteration {eg['it']}: clones "
              f"{int(eg['clone'].sum())}/{int(ec['clone'].sum())} splits "
              f"{int(eg['split'].sum())}/{int(ec['split'].sum())}; rows compared {rows}, "
              f"within {NEAR_THRESH_REL:g} of grad_thresh {int(near.sum())}, deciding apart "
              f"{int(differ.sum())} ({off} of them not near the threshold; allowed 0)",
              flush=True)
        if differ.any() and shared is None:
            shared = eg["rows"]
    la, lb = (r.last_mapping_trace["loss"] for r in runners)
    rel = np.abs(la - lb) / np.abs(lb)
    print(f"{tag} 96x64 GPU vs CPU: {near_all} gaussians near the threshold over "
          f"{len(g)} events, {off_all} decided apart elsewhere; mapping loss max rel diff "
          f"{rel.max():.3e} (first iteration {rel[0]:.3e})", flush=True)
    return ok and off_all == 0, runner_state(runners[0], "cuda")


ANISO_FRAMES = (1, 2, 3)   # re-tracked with the anisotropic map


def make_anisotropic(state, seed: int = 0):
    """``state`` (``runner_state``) with an anisotropic map: per-axis
    log-scale offsets in [log 0.5, log 2] (as tests/test_render_cached.py
    makes them) and random unit quaternions, from a numpy seed."""
    import numpy as np
    import torch

    p = dict(state["params"])
    n, dev = p["log_scales"].shape[0], p["log_scales"].device
    rng = np.random.default_rng(seed)
    off = rng.uniform(np.log(0.5), np.log(2.0), (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p["log_scales"] = p["log_scales"] + torch.as_tensor(off, device=dev)
    p["unnorm_rotations"] = torch.as_tensor(q, device=dev)
    return dict(state, params=p)


def aniso_tracking(state, cfg_of, ds, dev: str, frames, record=None):
    """``frames`` tracked from ``state`` on ``dev``, with the pose cache
    and without: {use_cache: runner}.  ``cfg_of(use_cache)`` makes the
    config; with ``record`` (a list), the cached tracker's first K1 table
    is left there."""
    from hierslam_torch.slam.pipeline import SLAMRunner

    out = {}
    for use_cache in (True, False):
        r = SLAMRunner(cfg_of(use_cache), dataset=ds, device=dev)
        set_runner_state(r, state_to(state, dev))
        with (recording_blend_fwd(record, pick=differentiable)
              if record is not None and use_cache else contextlib.nullcontext()):
            for t in frames:
                r.step(t)
        out[use_cache] = r
    return out


def state_to(state, dev):
    """A copy of ``state`` (``runner_state``) with its tensors on ``dev``."""
    import copy

    from hierslam_torch.slam import optim

    def to(d):
        return {k: v.to(dev, copy=True) for k, v in d.items()}

    ms = state["mlp_state"]
    return dict(state, params=to(state["params"]), variables=to(state["variables"]),
                mlp=None if state["mlp"] is None else to(state["mlp"]),
                mlp_state=None if ms is None else optim.AdamState(to(ms.mu), to(ms.nu),
                                                                  ms.count),
                rng=copy.deepcopy(state["rng"]))


def aniso_phase(final_state, small_state):
    """Phase 14 (the module docstring).  Returns (ok, JSON rows, launches)."""
    import numpy as np
    import torch

    from hierslam_torch.config import raster_config
    from hierslam_torch.slam.tracking import est_w2c

    tag = "[aniso]"
    n = CLASSIC_FRAMES
    room = room_dataset(n, FRAME["W"], FRAME["H"], FRAME["f"])
    state = make_anisotropic(final_state)
    workdir = tempfile.mkdtemp()

    def cfg_of(use_cache):
        return classic_config(workdir, n, FRAME["W"] * FRAME["H"], track_use_cache=use_cache)

    rc = raster_config(cfg_of(True))
    live = state["variables"]["active"]
    ls = state["params"]["log_scales"][live]
    print(f"{tag} [classic]'s final map made anisotropic: {int(live.sum())} live gaussians, "
          f"log-scale spread per gaussian (max - min axis) up to "
          f"{float((ls.amax(1) - ls.amin(1)).max()):.3f}, random unit quaternions; frames "
          f"{list(ANISO_FRAMES)} tracked again with the pose cache and without", flush=True)
    tables = []
    reset_counts()
    runs = aniso_tracking(state, cfg_of, plain_frames(room), "cuda", ANISO_FRAMES, tables)
    torch.cuda.synchronize()
    launches, plain, n_bin = read_counts()
    it_t = cfg_of(True)["tracking"]["num_iters"]
    n_tcls = track_classes(rc, FRAME["H"], FRAME["W"])
    per = len(ANISO_FRAMES) * it_t * n_tcls
    # the uncached tracker's renders gather the map: one K5 an iteration
    want = {"blend_fwd": 2 * per, "blend_bwd": 2 * per, "stream_fwd": 0, "stream_bwd": 0,
            "gather_bwd": len(ANISO_FRAMES) * it_t, "bin_emit": n_bin,
            **track_launches(runs[True].runtime_summary(), rc, FRAME["H"], FRAME["W"], it_t)}
    ok = launches == want and not any(plain.values())
    for use_cache, r in runs.items():
        summ = r.runtime_summary()
        errs = centre_err_cm(r, room, n)
        losses = r.last_tracking_trace["loss"]
        print(f"{tag} {'cached' if use_cache else 'uncached'} tracker: tracking_iter_ms "
              f"{summ['tracking_iter_ms']:.3f}; frame {ANISO_FRAMES[-1]} loss {losses[0]:.6g} "
              f"-> {losses[-1]:.6g}; camera-centre error vs GT (cm) at frames "
              f"{list(ANISO_FRAMES)}: " + " ".join(f"{errs[t]:.3f}" for t in ANISO_FRAMES),
              flush=True)
        ok &= bool(np.isfinite(losses).all()) and bool(np.isfinite(errs).all())
    print(f"{tag} launches {json.dumps(launches)} expected {json.dumps(want)} ({n_tcls} "
          f"tracking classes, both trackers); plain calls {json.dumps(plain)}", flush=True)
    del runs
    torch.cuda.empty_cache()

    # the 96x64 map of [classic]'s GPU-vs-CPU run, made anisotropic, frame 1
    small = make_anisotropic(small_state, seed=1)
    ds = plain_frames(room_dataset(3, 96, 64, 48.0, n_frames_arc=40))

    def small_cfg(use_cache):
        cfg = classic_config(tempfile.mkdtemp(), 3, 96 * 64, track_use_cache=use_cache,
                             **SMALL_RUN)
        cfg["raster"].update(SMALL_RASTER)
        return cfg

    by_dev = {dev: aniso_tracking(small, small_cfg, ds, dev, (1,)) for dev in ("cuda", "cpu")}
    for use_cache in (True, False):
        g, c = by_dev["cuda"][use_cache], by_dev["cpu"][use_cache]
        lg, lc = g.last_tracking_trace["loss"][0], c.last_tracking_trace["loss"][0]
        rel = abs(lg - lc) / abs(lc)
        pose = float((est_w2c(g.params, 1).cpu() - est_w2c(c.params, 1)).abs().max())
        print(f"{tag} 96x64 GPU vs CPU, {'cached' if use_cache else 'uncached'} tracker on "
              f"frame 1: first loss {lg:.9g} / {lc:.9g} (rel {rel:.3e}), final pose max abs "
              f"diff {pose:.3e} (both allowed 1e-2, as [reference])", flush=True)
        ok &= rel <= 1e-2 and pose <= 1e-2
    rows = []
    if not tables:
        print(f"{tag} no cached tracking table was recorded", flush=True)
        ok = False
    else:
        table, slot_ok, gx, ids, n_t = tables[0]
        T, K, C = table.shape
        a, b, c = (table[..., i][slot_ok] for i in (2, 3, 4))
        print(f"{tag} first cached tracking table: T={T} K={K} F={C - 7} grid_x={gx}, "
              f"{100 * float(slot_ok.float().mean()):.1f}% of the slots live; smallest "
              f"(ac - b^2) / ac over live slots {float(((a * c - b * b) / (a * c)).min()):.3e}",
              flush=True)
        rows, good = check_kernels(f"anisotropic cached tracking table T={T} K={K} F={C - 7}",
                                   table, slot_ok, gx, 20, seed=10, flips_allowed=2,
                                   tile_ids=ids, n_tiles=n_t)
        ok &= good
    for row in rows:
        row["path"] = "aniso"
    return ok, rows, launches


VIZ_EVERY = 4
VIZ_CHECK_SCALE = 0.25   # the GPU-vs-CPU frame: the plain blend on the CPU at full size is slow


def visualize_phase(finished):
    """Phase 15 (the module docstring).  Returns (ok, JSON rows, launches)."""
    import numpy as np
    import torch

    from hierslam_torch.config import load_config, raster_config
    from hierslam_torch.datasets.tree import label_colormap
    from hierslam_torch.scripts import visualize
    from hierslam_torch.utils.image_io import read_png
    from hierslam_torch.viz.recon import render_trajectory_frames

    tag = "[visualize]"
    wrapper, run_dir = finished["wrapper"], finished["run_dir"]
    viz_dir = os.path.join(run_dir, "viz")
    cfg = load_config(wrapper)
    params = dict(np.load(os.path.join(run_dir, "params.npz")))
    n = params["cam_unnorm_rots"].shape[-1]
    argv = [wrapper, "--frames-only", "--semantic", "--viz-scale", "1.0", "--every",
            str(VIZ_EVERY)]
    record = []
    reset_counts()
    t0 = time.time()
    with contextlib.chdir(ROOT), recording_blend_fwd(record, n_feat=3 + sum(SEM_LEVELS)):
        out = visualize.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, plain, n_bin = read_counts()
    shown = list(range(0, n, VIZ_EVERY))
    expect = sorted([f"recon_{t:04d}.png" for t in shown] + [f"sem_{t:04d}.png" for t in shown])
    got = sorted(f for f in os.listdir(viz_dir) if f.endswith(".png"))
    sizes = {png_size(os.path.join(viz_dir, f)) for f in got}
    n_cls = ladder_classes(raster_config(cfg), FRAME["H"], FRAME["W"])
    want = {"blend_fwd": len(shown) * n_cls, "blend_bwd": 0, "stream_fwd": 0, "stream_bwd": 0,
            "gather_bwd": 0, "bin_emit": n_bin,
            **track_launches(None, raster_config(cfg), FRAME["H"], FRAME["W"], 0)}
    print(f"{tag} python3 -m hierslam_torch.scripts.visualize {' '.join(argv[1:])} on the "
          f"[cli] run ({n} frames, F = {3 + sum(SEM_LEVELS)}, its semantic_decoder.npz): wrote "
          f"{len(got)} PNGs to {out}: {got} (expected {expect}), sizes "
          f"{sorted(sizes)}; launches {json.dumps(launches)} expected {json.dumps(want)} "
          f"({len(shown)} renders of {n_cls} ladder classes); plain calls {json.dumps(plain)}; "
          f"wall_s {wall:.2f}", flush=True)
    ok = (out == viz_dir and got == expect and sizes == {(FRAME["W"], FRAME["H"])}
          and launches == want and not any(plain.values()))

    # frame 0 through render_trajectory_frames on the GPU and on the CPU
    mlp = dict(np.load(os.path.join(run_dir, "semantic_decoder.npz")))
    cmap = label_colormap(max(int(mlp["w"].shape[0]), 2))
    dirs = [tempfile.mkdtemp() for _ in range(2)]
    for dev, d in zip(("cuda", "cpu"), dirs):
        render_trajectory_frames(params, d, cfg, every=n, viz_scale=VIZ_CHECK_SCALE,
                                 semantic=True, mlp=mlp, colormap=cmap, device=dev)
    diffs = {}
    for name in ("recon_0000.png", "sem_0000.png"):
        a, b = (read_png(os.path.join(d, name)).astype(np.int16) for d in dirs)
        d = np.abs(a - b).max(-1)
        diffs[name] = (int((d > 1).sum()), int((d > 0).sum()), int(d.max()), d.size)
    beyond, _, _, pix = diffs["recon_0000.png"]
    sem_apart = diffs["sem_0000.png"][1]
    print(f"{tag} frame 0 at viz scale {VIZ_CHECK_SCALE}, GPU vs CPU: recon pixels beyond 1 "
          f"grey level {beyond} of {pix} (allowed {2 * n_cls}: 2 rounding ties a class), "
          f"differing at all {diffs['recon_0000.png'][1]}, max {diffs['recon_0000.png'][2]}; "
          f"semantic pixels with another leaf {sem_apart} (allowed {pix // 200}: argmax "
          "between logits within K1's tolerance)", flush=True)
    ok &= beyond <= 2 * n_cls and sem_apart <= pix // 200
    rows = []
    if not record:
        print(f"{tag} no K1 table was recorded", flush=True)
        ok = False
    else:
        table, slot_ok, gx, ids, n_t = record[0]
        T, K, C = table.shape
        print(f"{tag} first render's K1 table: T={T} K={K} F={C - 7} grid_x={gx}, "
              f"{100 * float(slot_ok.float().mean()):.1f}% of the slots live", flush=True)
        r, good = check_kernels(f"visualize table T={T} K={K} F={C - 7}", table, slot_ok, gx,
                                20, seed=11, flips_allowed=2, tile_ids=ids, n_tiles=n_t)
        rows = [r[0]]
        ok &= good
    for row in rows:
        row["path"] = "visualize"
    return ok, rows, launches


PARALLEL_MAP_D = 2             # [parallel]: ranks of the flagship's data-parallel mapping
PARALLEL_RENDER_D = 4          # [parallel]: ranks of the second tile-sharded render
WORKER_RECORD = {}             # in a mesh worker: the inputs of a wrapper's first calls


def worker_record(kind: str, limit: int) -> None:
    """In a mesh worker: keep copies of the arguments of the next ``limit``
    calls of the wrapper ``kernels.<kind>`` ("blend_fwd": K1, "stream_fwd":
    K3), for ``worker_recorded``.  The wrapper is wrapped from here, the
    package has no hook for it; every call still goes to the kernel."""
    from hierslam_torch.ops import kernels

    launch = getattr(kernels, kind)
    WORKER_RECORD[kind] = seen = []

    def recording(*args, **kwargs):
        if len(seen) < limit:
            seen.append(k1_record(*args, **kwargs) if kind == "blend_fwd" else
                        tuple(a.detach().clone() if hasattr(a, "detach") else a for a in args))
        return launch(*args, **kwargs)

    setattr(kernels, kind, recording)


def worker_recorded(kind: str):
    """In a mesh worker: the recorded calls of ``kind``, on the CPU."""
    return [tuple(a.cpu() if hasattr(a, "cpu") else a for a in c)
            for c in WORKER_RECORD.pop(kind, [])]


def mesh_counts(mesh):
    """-> [(launches, plain calls, binnings)] of every rank since its counts
    were zeroed."""
    return [read_counts()] + mesh.run_workers(read_counts)


def zero_counts(mesh) -> None:
    reset_counts()
    mesh.run_workers(reset_counts)


def parallel_map_run(cfg_path: str, record: dict):
    """[parallel] (a): the flagship config as shipped with
    ``parallel.map_data_devices = 2`` on the 8 procedural frames at
    1200x680, both ranks on this card.  Rank 1's first K3 call is left in
    ``record["stream"]``.  Returns (ok, runner, mesh, worker launches)."""
    import numpy as np
    import torch

    from hierslam_torch.config import load_config
    from hierslam_torch.parallel import make_mesh
    from hierslam_torch.slam.pipeline import SLAMRunner

    tag = "[parallel map]"
    n, D = 8, PARALLEL_MAP_D
    ds = room_dataset(n, 1200, 680, 600.0)
    cfg = load_config(cfg_path)
    cfg["data"]["num_frames"] = n
    cfg["workdir"] = tempfile.mkdtemp()
    cfg["parallel"] = dict(map_data_devices=D)
    t0 = time.time()
    mesh = make_mesh(D, devices=["cuda:0"] * D)
    print(f"{tag} mesh of {D} ranks on one card up in {time.time() - t0:.1f} s", flush=True)
    mesh.run_workers(worker_record, "stream_fwd", 1)
    runner = SLAMRunner(cfg, dataset=ds, device="cuda", mesh=mesh)
    zero_counts(mesh)
    ok = True
    n_map = n_dens = 0
    checks, casts = [], []
    t_run = time.time()
    for t in range(n):
        runner.step(t)
        line = f"{tag} frame {t}:"
        if t > 0:
            tl = runner.last_tracking_trace["loss"]
            ok &= bool(np.isfinite(tl).all())
            line += f" tracking loss {tl[0]:.6g} -> {tl[-1]:.6g}"
        if t == 0 or (t + 1) % cfg["map_every"] == 0:
            ml = runner.last_mapping_trace["loss"]
            n_map += 1
            n_dens += int(t > 0)
            ok &= bool(np.isfinite(ml).all())
            cs = mesh.stats["checksums"]
            checks.append(len(cs) == D and len(set(cs)) == 1)
            casts.append((mesh.stats["broadcast_bytes"], mesh.stats["broadcast_s"]))
            line += (f" mapping loss {ml[0]:.6g} -> {ml[-1]:.6g}; rank checksums {cs}; "
                     f"phase-start broadcast {casts[-1][0]} bytes in {casts[-1][1]:.4f} s")
        print(line + f" n_active {int(runner.variables['n_active'])}", flush=True)
    torch.cuda.synchronize()
    wall = time.time() - t_run
    counts = mesh_counts(mesh)
    recorded = mesh.run_workers(worker_recorded, "stream_fwd")[0]
    record["stream"] = recorded[0] if recorded else None
    summ = runner.runtime_summary()
    it_t, it_m = cfg["tracking"]["num_iters"], cfg["mapping"]["num_iters"]
    n_prog = 2 * ladder_classes(runner.rc, runner.H, runner.W)
    n_tk = it_t * summ["track_classes"]   # classes sized from each tracked frame's counts
    want0 = {"blend_fwd": n_tk + n_dens + n_prog, "blend_bwd": n_tk,
             "stream_fwd": n_map * it_m, "stream_bwd": n_map * it_m, "gather_bwd": n_map * it_m,
             **track_launches(summ, runner.rc, runner.H, runner.W, it_t)}
    want_w = {"blend_fwd": 0, "blend_bwd": 0, "stream_fwd": n_map * it_m,
              "stream_bwd": n_map * it_m, "gather_bwd": n_map * it_m,
              **track_launches(None, runner.rc, runner.H, runner.W, it_t)}
    for r, (launches, plain, n_bin) in enumerate(counts):
        want = dict(want0 if r == 0 else want_w, bin_emit=n_bin)
        print(f"{tag} rank {r} launches {json.dumps(launches)} expected {json.dumps(want)} "
              f"plain calls {json.dumps(plain)}", flush=True)
        ok &= launches == want and not any(plain.values())
    errs = centre_err_cm(runner, ds, n)
    print(f"{tag} camera-centre error vs GT (cm): " + " ".join(f"{e:.3f}" for e in errs)
          + f" (allowed < {CENTRE_BOUND_CM})", flush=True)
    print(f"{tag} tracking_iter_ms {summ['tracking_iter_ms']:.3f} mapping_iter_ms "
          f"{summ['mapping_iter_ms']:.3f} mapping_frame_s {summ['mapping_frame_s']:.3f} "
          f"map_broadcast_bytes {summ['map_broadcast_bytes']} map_broadcast_s "
          f"{summ['map_broadcast_s']:.4f} map_collective_s {summ['map_collective_s']:.4f} "
          f"(both inside mapping_frame_s) wall_s {wall:.1f} n_active "
          f"{summ['n_active']}; equal checksums at every phase's end: {all(checks)}", flush=True)
    ok &= all(checks) and len(checks) == n_map and max(errs) < CENTRE_BOUND_CM
    worker_launches = {k: sum(c[0][k] for c in counts[1:]) for k in counts[0][0]}
    return ok, runner, mesh, worker_launches


def parallel_equal_check(cfg_path: str, backend: str, mesh) -> bool:
    """[parallel] (b): at 96x64 the data-parallel mapper on ``mesh`` (2
    ranks on this card) with equal columns against the single mapper, both
    built by ``SLAMRunner`` from the flagship config, on one state after 3
    frames, with the float order free on every rank; JAX's test tolerances (loss 5e-4 relative, means and colours 3e-4)."""
    import numpy as np
    import torch

    from hierslam_torch.config import load_config
    from hierslam_torch.parallel.mesh import tensors_of
    from hierslam_torch.slam.keyframes import Keyframe
    from hierslam_torch.slam.pipeline import SLAMRunner

    ds = room_dataset(3, 96, 64, 48.0, n_frames_arc=40)
    cfg = load_config(cfg_path)
    cfg["raster"].update(backend=backend, bucket_spec=((4, 512), (-1, 256)),
                         track_max_per_tile=256)
    cfg["data"]["num_frames"] = 3
    cfg.update(map_every=3, map_capacity=65536, workdir=tempfile.mkdtemp())
    cfg["tracking"]["num_iters"] = 10
    cfg["mapping"]["num_iters"] = 10
    single = SLAMRunner(cfg, dataset=ds, device="cuda")
    for t in range(3):
        single.step(t)
    frames = []
    for t in range(3):
        im, depth, labels, _ = single._load_frame(t)
        frames.append(Keyframe(id=t, w2c=single._est_w2c(t), color=im, depth=depth,
                               labels=labels))
    window = single._window_arrays(frames)
    p_b, v_b = single._sliced_state()
    idx = np.random.default_rng(0).integers(0, 3, cfg["mapping"]["num_iters"])
    a = single.mapper(p_b, v_b, window, idx, single.mlp, single.mlp_state)
    dp = SLAMRunner(dict(cfg, parallel=dict(map_data_devices=mesh.size)), dataset=ds,
                    device="cuda", mesh=mesh)
    b = dp.mapper(p_b, v_b, window, np.repeat(idx[:, None], mesh.size, 1), single.mlp,
                  single.mlp_state)
    cs = mesh.stats["checksums"]
    la, lb = a[4]["loss"].cpu().numpy(), b[4]["loss"].cpu().numpy()
    d_loss = float(np.max(np.abs(la - lb) / np.abs(la)))
    d_par = {k: float((a[0][k] - b[0][k]).abs().max()) for k in ("means3D", "rgb_colors")}
    bits = all(torch.equal(x, y) for x, y in zip(tensors_of(a), tensors_of(b)))
    print(f"[parallel equal] {backend} mapper at 96x64, {mesh.size} ranks with equal columns "
          f"vs the single mapper: loss rel {d_loss:.3e} (allowed 5e-4), means3D abs "
          f"{d_par['means3D']:.3e}, rgb_colors abs {d_par['rgb_colors']:.3e} (allowed 3e-4); "
          f"equal to the bit: {bits}; rank checksums {cs}", flush=True)
    return d_loss <= 5e-4 and max(d_par.values()) <= 3e-4 and len(set(cs)) == 1


def strip_raster_config(rc):
    """``rc`` with one class of 8,192 slots and a 256-tile emission cap: a
    ladder that drops no pair of the final map, so that a strip's tiles
    get the lists the whole image's tiles get (the shipped ladder's
    capacities are per render: a strip's class caps would truncate other
    tiles than the whole image's)."""
    from dataclasses import replace

    return replace(rc, bucket_spec=((-1, 8192),), max_tiles_per_gaussian=256, max_refs=256)


# [parallel] (c): the whole-image render against the tile-sharded one, 1e-5
# on the image and 1e-4 on depth at every pixel (the tolerances of the
# port's tile-sharded render test).  Every class blends at its tiles' true
# screen coordinates, and a strip's y is the image's less a whole number of
# tiles, so the two renders see the same slots at the same places up to the
# rounding of that subtraction.  The exceptions: pixels where that rounding
# takes a slot across a threshold of the blend (alpha 1/255, power 0, T 1e-4
# or 0.5), which moves the pixel by that slot's weight.  Each must be proven
# such a tie (``whole_image_tie``), and they are counted.
WHOLE_IMAGE_TOL = {"im": 1e-5, "depth": 1e-4}
TIES_CHECKED = 200     # more pixels beyond the tolerances than this fail outright


def whole_image_tie(whole, strip, x: int, y: int, strip_y0: int):
    """Whether pixel (x, y) of the image, where the whole-image render
    (``whole``: K1's ``k1_record`` and outputs) and the strip render that
    holds it (``strip``, starting at image row ``strip_y0``) part beyond
    ``WHOLE_IMAGE_TOL``, parts only by a tie.  Four things must hold.  The
    two tiles' tables hold the same slots: the same mask, every column but
    y equal, y less the strip's offset within 1e-3 px.  The slots the plain
    terms take at one render's pixel and not at the other's have an alpha
    within ``FLIP_REL`` of 1/255 or a power within 1e-6 of 0.  Where the
    two K1 runs end on other slots or take other median slots, the plain
    transmittance there is within ``FLIP_REL`` of 1e-4 or 0.5, as
    ``flip_is_tie`` holds K1 against the plain version.  And each render's
    K1 output at the pixel is what its plain terms give when they end at
    its K1's slot (``flip_is_tie``).  Returns (ok, a line that says what
    was found)."""
    import torch

    from hierslam_torch.ops.render_xla import ALPHA_MIN, blend_terms, pixel_grid

    th, tw = TILE
    sides = []
    for (rec, out), yy in ((whole, y), (strip, y - strip_y0)):
        table, ok, gx, ids = rec[:4]
        t = (yy // th) * gx + x // tw
        b = int((ids == t).nonzero()[0, 0])
        p = (yy % th) * tw + x % tw
        px, py = pixel_grid(torch.tensor([t], device=table.device), TILE, gx)
        terms = blend_terms(table[b:b + 1], ok[b:b + 1], px[:, p:p + 1], py[:, p:p + 1])
        sides.append((table[b:b + 1], ok[b:b + 1], gx, t, p, terms,
                      tuple(o[t, p] for o in out)))
    (tab_w, ok_w, gx, t_w, p, terms_w, out_w), (tab_s, ok_s, _, t_s, _, terms_s, out_s) = sides
    said = [f"pixel ({x}, {y}): whole-image tile {t_w}, strip tile {t_s}"]
    cols = [c for c in range(tab_w.shape[-1]) if c != 1]
    same = (torch.equal(ok_w, ok_s) and torch.equal(tab_w[..., cols], tab_s[..., cols])
            and float((tab_w[..., 1] - strip_y0 - tab_s[..., 1]).abs().max()) <= 1e-3)
    good = same
    if not same:
        said.append("the two tables do not hold the same slots")
    power_w, alpha_w, contrib_w = (terms_w[i][0, 0] for i in (2, 3, 4))
    power_s, alpha_s, contrib_s = (terms_s[i][0, 0] for i in (2, 3, 4))
    raw = [torch.exp(pw) * tab_w[0, :, 5] for pw in (power_w, power_s)]
    near = ((torch.minimum(*[(r / ALPHA_MIN - 1).abs() for r in raw]) <= FLIP_REL)
            | (torch.minimum(power_w.abs(), power_s.abs()) <= 1e-6))
    flipped = (contrib_w != contrib_s).nonzero()[:, 0].tolist()
    good &= all(bool(near[j]) for j in flipped)
    said.append(f"slots taken at one pixel and not the other {flipped}, each at a threshold: "
                f"{all(bool(near[j]) for j in flipped)}")
    # the two K1 runs' choices, held as flip_is_tie holds K1 against the plain version
    for (tab, ok_t, t, out_k), other in (((tab_w, ok_w, t_w, out_w), out_s),
                                         ((tab_s, ok_s, t_s, out_s), out_w)):
        tie, line = flip_is_tie(tab, ok_t, gx, t, p, out_k, (other[3], other[4]),
                                tile=(tab, ok_t))
        good &= tie
        said.append(line.rsplit(" -- ", 1)[0])
    return good, "; ".join(said) + (" -- a tie" if good else " -- NOT a tie")


def parallel_render_check(runner, mesh, record: Optional[dict] = None):
    """[parallel] (c): the tile-sharded render of ``runner``'s map (its
    live gaussians at frame 0's camera, ``strip_raster_config`` of its
    raster config) over ``mesh`` against the single render.  With
    ``record``, the last rank's K1 calls (the last strip's tables) are left
    in ``record["strip"]``.  Returns (ok, launches of all ranks)."""
    import torch

    from hierslam_torch.core.camera import strip_camera
    from hierslam_torch.parallel import make_tile_sharded_render
    from hierslam_torch.slam.losses import render_gaussians

    D = mesh.size
    tag = f"[parallel render D={D}]"
    act = runner.variables["active"]
    params = {k: v[act] for k, v in runner.params.items() if v.shape[0] == act.shape[0]}
    rc = strip_raster_config(runner.rc)
    q = torch.tensor([1.0, 0, 0, 0], device=runner.device)
    t = torch.zeros(3, device=runner.device)
    kw = dict(with_semantic=False, gaussians_grad=False, camera_grad=False)
    seen, outs = [], []
    with recording_blend_fwd(seen, outputs=outs):
        ref = render_gaussians(params, None, q, t, runner.camera, rc, **kw)
    whole = (seen[0], outs[0])
    render = make_tile_sharded_render(mesh, runner.camera, rc)
    if record is not None:
        mesh.run_workers(worker_record, "blend_fwd", 4)
    zero_counts(mesh)
    t0 = time.time()
    im, depth = render(params)
    if im.is_cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    counts = mesh_counts(mesh)
    if record is not None:
        record["strip"] = mesh.run_workers(worker_recorded, "blend_fwd")[-1]
    # the strips as one device renders them, stacked and cropped
    strips, strip_k1 = [], []
    th = rc.tile_shape[0]
    tiles_y = -(-runner.H // th)
    strip_h = -(-tiles_y // D) * th
    cam_s = strip_camera(runner.camera, strip_h)
    for r in range(D):
        seen, outs = [], []
        with recording_blend_fwd(seen, outputs=outs):
            out = render_gaussians(params, None, q, t, cam_s, rc,
                                   pixel_offset_y=float(r * strip_h), **kw)
        strip_k1.append((seen[0], outs[0]))
        strips.append(torch.cat([out.im, out.depth[None]], 0))
    stacked = torch.cat(strips, 1)[:, :runner.H]
    exact = torch.equal(stacked[:3], im) and torch.equal(stacked[3], depth)
    d_im = (im - ref.im).abs().amax(0)
    d_d = (depth - ref.depth).abs()
    beyond = ((d_im > WHOLE_IMAGE_TOL["im"]) | (d_d > WHOLE_IMAGE_TOL["depth"])).nonzero()
    launches = {k: sum(c[0][k] for c in counts) for k in counts[0][0]}
    plain = sum(sum(c[1].values()) for c in counts)
    n_ties = 0
    if len(beyond) <= TIES_CHECKED:
        for y, x in beyond.tolist():
            tie, said = whole_image_tie(whole, strip_k1[y // strip_h], x, y,
                                        y // strip_h * strip_h)
            print(f"{tag} {said}", flush=True)
            n_ties += int(tie)
    print(f"{tag} {runner.W}x{runner.H} in strips of {strip_h} rows ({D * strip_h - runner.H} "
          f"rows past the image): equal to the bit to the strips rendered on one device: "
          f"{exact}; against the whole-image render max abs err image {float(d_im.max()):.3e} "
          f"depth {float(d_d.max()):.3e}, mean image {float(d_im.mean()):.3e}; pixels beyond "
          f"{WHOLE_IMAGE_TOL['im']} on the image or {WHOLE_IMAGE_TOL['depth']} on depth "
          f"{len(beyond)} of {runner.H * runner.W}, proven alpha- or transmittance-threshold "
          f"ties {n_ties} (all must be; at most {TIES_CHECKED} are checked); single render "
          f"n_dropped {int(ref.n_dropped)} (must be 0); K1 launches on all ranks "
          f"{launches['blend_fwd']} (one a rank), plain calls {plain}; wall_s {wall:.3f} "
          f"(broadcast {mesh.stats['broadcast_bytes']} bytes in "
          f"{mesh.stats['broadcast_s']:.4f} s)", flush=True)
    ok = (exact and n_ties == len(beyond) and plain == 0
          and launches["blend_fwd"] == D and int(ref.n_dropped) == 0)
    return ok, launches


def parallel_phase(cfg_path: str):
    """Phase 16 (the module docstring).  Returns (ok, JSON rows, launches
    of the workers' mapping, launches of the strip renders)."""
    import torch

    from hierslam_torch.config import load_config, raster_config
    from hierslam_torch.ops import render_stream as rs

    from hierslam_torch.parallel import make_mesh

    record = {}
    ok, runner, mesh, map_launches = parallel_map_run(cfg_path, record)
    with mesh:
        good, strip_launches = parallel_render_check(runner, mesh)
        ok &= good
        for backend in ("stream", "pallas"):
            ok &= parallel_equal_check(cfg_path, backend, mesh)
    D = PARALLEL_RENDER_D
    with make_mesh(D, devices=["cuda:0"] * D) as mesh:
        good, strip_launches = parallel_render_check(runner, mesh, record=record)
    ok &= good
    del runner
    torch.cuda.empty_cache()
    rows = []
    strips = record.get("strip") or []
    if not strips:
        print("[parallel] no K1 table of the last strip was recorded", flush=True)
        ok = False
    for i, (table, slot_ok, gx, ids, n_t) in enumerate(strips):
        table, slot_ok, ids = table.cuda(), slot_ok.cuda(), ids.cuda()
        T, K, C = table.shape
        print(f"[parallel] last strip's K1 table {i + 1} of {len(strips)}: T={T} K={K} "
              f"F={C - 7} grid_x={gx}, {100 * float(slot_ok.float().mean()):.1f}% of the slots "
              "live", flush=True)
        r, good = check_kernels(f"strip table T={T} K={K} F={C - 7}", table, slot_ok, gx,
                                20 if i == 0 else 0, seed=12 + i, flips_allowed=2,
                                tile_ids=ids, n_tiles=n_t)
        if r:
            rows.append(dict(r[0], path="parallel_strip"))
        ok &= good
    if record.get("stream") is None:
        print("[parallel] no stream of rank 1 was recorded", flush=True)
        ok = False
    else:
        stream, sc, ro, gx, _, n_feat, img = (a.cuda() if hasattr(a, "cuda") else a
                                              for a in record["stream"])
        grid = raster_config(load_config(cfg_path)).grid(*img)
        pad = stream[..., rs.COL_LOGIT] == rs.SENTINEL_LOGIT
        r, good = check_stream(f"rank 1 first mapping stream R={stream.shape[0]} F={n_feat}",
                               stream, sc, ro, pad, grid, n_feat, img, 20, flips_allowed=2)
        rows += [dict(x, path="parallel_map") for x in r]
        ok &= good
    return ok, rows, map_launches, strip_launches


REPRO_FRAMES = 3   # [repro]: mapping at t = 0 and, after a densify, at t = 2


def repro_run(cfg_path: str, backend: str, ds):
    """The flagship config with ``raster.backend`` set on the
    ``REPRO_FRAMES`` frames of ``ds`` -> (every array of its params.npz,
    the estimated w2c of every frame)."""
    import numpy as np

    from hierslam_torch.config import load_config
    from hierslam_torch.slam.pipeline import SLAMRunner
    from hierslam_torch.slam.tracking import est_w2c

    cfg = load_config(cfg_path)
    cfg["raster"]["backend"] = backend
    cfg["data"]["num_frames"] = REPRO_FRAMES
    cfg.update(map_every=REPRO_FRAMES, workdir=tempfile.mkdtemp())
    runner = SLAMRunner(cfg, dataset=ds, device="cuda")
    for t in range(REPRO_FRAMES):
        runner.step(t)
    runner.finalize()
    with np.load(os.path.join(cfg["workdir"], cfg["run_name"], "params.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    return arrays, [est_w2c(runner.params, t).cpu().numpy() for t in range(REPRO_FRAMES)]


def bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def repro_phase(cfg_path: str) -> bool:
    """Phase 17 (the module docstring): the flagship's 3-frame run with each
    mapper twice in this process, equal to the bit."""
    ds = room_dataset(REPRO_FRAMES, 1200, 680, 600.0)
    ok = True
    for backend in ("stream", "pallas"):
        t0 = time.time()
        (pa, wa), (pb, wb) = (repro_run(cfg_path, backend, ds) for _ in range(2))
        differ = sorted(k for k in pa.keys() | pb.keys()
                        if k not in pa or k not in pb or not bits_equal(pa[k], pb[k]))
        poses = all(bits_equal(x, y) for x, y in zip(wa, wb))
        print(f"[repro] {backend} mapper, the flagship's {REPRO_FRAMES} frames at 1200x680 twice: "
              f"params.npz arrays {len(pa)}, those that differ {differ}; every pose equal to "
              f"the bit: {poses}; wall_s {time.time() - t0:.1f}", flush=True)
        ok &= not differ and poses
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", action="store_true", help="build and kernel checks only")
    ap.add_argument("--repeat", type=int, default=1,
                    help="runs of the flagship SLAM phase (each is checked)")
    ap.add_argument("--tracking-table", metavar="FILE",
                    help="read the recorded tracking table from FILE if it exists, else "
                         "record it and write it there (so that several checkouts are "
                         "timed on one table)")
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
    ptx = {}   # read from the report kept beside each library, built now or before
    for src in kernels.SOURCES:
        ptx.update(ptxas_summary(kernels.ptxas_report(src)))
    dyn = {f"{src} C={C}": kernels.bwd_batch(src, C, P)
           for src, C in (("blend.cu", 10), ("blend.cu", 36), ("blend.cu", 84),
                          ("blend.cu", 7 + MAX_F), ("stream.cu", 8), ("stream.cu", 34),
                          ("stream.cu", 82), ("stream.cu", 5 + MAX_F))}
    dyn.update({f"K1 C={C}": kernels._load("blend.cu").blend_fwd_smem(C, P)
                for C in (10, 36, 84, 7 + MAX_F)})
    dyn.update({f"K3 C={C}": kernels._load("stream.cu").stream_fwd_smem(C)
                for C in (8, 34, 82, 5 + MAX_F)})
    print(f"[build] ptxas: {json.dumps(ptx, sort_keys=True)}; K2/K4 (batch, dynamic smem "
          f"bytes) at P={P}: {json.dumps(dyn)}", flush=True)
    reported = all(any(k.startswith(name) for k in ptx)
                   for name in ("blend_fwd", "blend_bwd", "stream_fwd", "stream_bwd",
                                "gather_bwd", "bin_emit", "track_fwd_kernel", "track_bwd_kernel",
                                "track_bwd_finish"))
    if not reported or any(v.get("spill_stores", 1) + v.get("spill_loads", 1)
                           for v in ptx.values()):
        fail("a kernel spills registers to local memory (or its ptxas report is missing)")

    rows = []
    ok = True
    cfg_path = os.path.join(ROOT, "configs", "replica", "hierslam_semantic_run.py")
    # every feature bucket and padding case of the backwards' reduce-scatter
    # on small inputs, then the main path's shapes with timings
    dev = torch.device("cuda")
    for F in SMALL_F:
        ok &= check_kernels(f"small T=48 K=256 F={F}", *random_table(10 + F, 48, 256, F, 8, dev),
                            8, 0, seed=10 + F, flips_allowed=2)[1]
        ok &= check_stream_kernels(cfg_path, F, 0, W=160, H=96, f=80.0)[1]
    # tiles whose rows start off a 16-byte boundary and a last batch cut short
    # (K1 then copies in 4-byte pieces)
    ok &= check_kernels("small T=48 K=99 F=3", *random_table(5, 48, 99, 3, 8, dev), 8, 0,
                        seed=5)[1]
    if not ok:
        fail("kernel check at small shapes")
    for name, seed, T, K, F, gx in (("tracking T=3225 K=512 F=3", 0, 3225, 512, 3, 75),
                                    ("mapping T=128 K=4096 F=29", 1, 128, 4096, 29, 128)):
        r, good = check_kernels(name, *random_table(seed, T, K, F, gx, dev), gx, 20, seed=seed)
        rows += r
        ok &= good
    # the tracking shape's table with its rows in a shuffled order, each
    # row blended at its own tile id (what a ladder class launches)
    table, slot_ok = random_table(0, 3225, 512, 3, 75, dev)
    perm = torch.randperm(3225, generator=torch.Generator().manual_seed(0)).to(dev)
    r, good = check_kernels("tracking T=3225 K=512 F=3, rows shuffled", table[perm],
                            slot_ok[perm], 75, 20, seed=0, tile_ids=perm.int(), n_tiles=3225)
    rows += r
    ok &= good
    for n_feat in (29, 3):
        r, good = check_stream_kernels(cfg_path, n_feat, 20)
        rows += r
        ok &= good
    # the wide bucket at ScanNet tree-large's F = 77: a seeded ladder class,
    # and frame 0 of the room at 640x480 binned with that config
    r, good = check_kernels(f"mapping T=128 K=4096 F={SCANNET_F}",
                            *random_table(1, 128, 4096, SCANNET_F, 128, dev), 128, 20, seed=1)
    r2, good2 = check_stream_kernels(SCANNET_LARGE, SCANNET_F, 20, **SCANNET_FRAME)
    for row in r + r2:
        row["path"] = "scannet"
    rows += r + r2
    ok &= good and good2
    ok &= cull_thin_phase(cfg_path)
    # K5 on seeded inputs: the recorded inputs' shapes, and the adversarial
    # one (a run longer than the staging, most rows empty, odd C, nd = 135)
    for i, (name, shape) in enumerate(GATHER_SEEDED):
        r, good = check_gather(name, *seeded_gather(20 + i, **shape))
        rows += r
        ok &= good
    print(f"[kernels] checks on seeded inputs done at {time.time() - t0:.1f} s", flush=True)

    def check_recorded(recorded):
        """K1/K2 on the flagship run's own tracking table, a third shape."""
        table, slot_ok, gx, ids, n_t = recorded
        T, K, C = table.shape
        print(f"[kernels] tracking table of frame {RECORD_FRAME}, first iteration: T={T} K={K} "
              f"F={C - 7} grid_x={gx}, {100 * float(slot_ok.float().mean()):.1f}% of the "
              f"slots live (at {time.time() - t0:.1f} s)", flush=True)
        return check_kernels(f"captured tracking table T={T} K={K} F={C - 7}", table, slot_ok,
                             gx, 20, seed=2, flips_allowed=2, tile_ids=ids, n_tiles=n_t)

    # the table comes from FILE, else from the flagship run below or, with
    # --kernels, from a run of its first frames
    recorded = None
    if args.tracking_table and os.path.isfile(args.tracking_table):
        recorded = torch.load(args.tracking_table, map_location=dev)
    elif args.kernels:
        recorded = tracking_table(cfg_path)
    if recorded is not None:
        r, good = check_recorded(recorded)
        rows += r
        ok &= good
    if not ok:   # after every kernel's line is out
        fail("kernel check at the main path's shapes")
    launches = {k: None for k in kernels.launch_counts}
    eval_launches = scannet_launches = replica_launches = real_shape_launches = launches
    nvs_launches = tum_launches = classic_launches = aniso_launches = viz_launches = launches
    par_map_launches = par_strip_launches = launches
    if not args.kernels:
        final = {}
        for backend in ("pallas", "stream"):
            good, final[backend] = reference_phase(cfg_path, backend)
            if not good:
                fail(f"GPU run with the {backend} mapper disagrees with the CPU reference")
        print(f"[reference] done at {time.time() - t0:.1f} s", flush=True)
        runs = []
        seen, gather_seen, emit_seen, track_seen = [], [], [], []
        for i in range(args.repeat):
            good, launches, summ = slam_phase(cfg_path,
                                              record=seen if recorded is None else None,
                                              gather_record=gather_seen if i == 0 else None,
                                              emit_record=emit_seen if i == 0 else None,
                                              track_record=track_seen if i == 0 else None)
            if not good:
                fail("SLAM phase (flagship as shipped)")
            runs.append(summ)
            if recorded is None:
                recorded = seen[0]
                r, good = check_recorded(recorded)
                rows += r
                if not good:
                    fail("kernel check on the recorded tracking table")
            if i == 0:
                r, good = check_gather("flagship first mapping stream", *gather_seen[0])
                rows += r
                del gather_seen[:]
                if not good:
                    fail("K5 check on the flagship's first mapping backward")
                if not emit_seen:
                    fail("no pair emission of a stream binning was recorded")
                r, good = check_bin_emit("flagship first mapping binning", emit_seen[0])
                rows += r
                del emit_seen[:]
                if not good:
                    fail("bin_emit check on the flagship's first mapping binning")
                if len(track_seen) != 2:
                    fail(f"no tracking projection of frame {RECORD_FRAME} was recorded")
                r, good = check_track_project(f"frame {RECORD_FRAME} first tracking iteration",
                                              track_seen)
                rows += r
                del track_seen[:]
                if not good:
                    fail("track_project check on the flagship's tracking cache")
        if args.repeat > 1:
            for key in ("tracking_iter_ms", "mapping_iter_ms"):
                vals = [r[key] for r in runs]
                print(f"[slam stream] {key} over {len(vals)} runs: "
                      + " ".join(f"{v:.3f}" for v in vals)
                      + f" median {statistics.median(vals):.3f}", flush=True)
        print(f"[slam stream] done at {time.time() - t0:.1f} s", flush=True)
        good, _, _ = slam_phase(cfg_path, backend="pallas", n_frames=3, map_every=3)
        if not good:
            fail("SLAM phase (ladder mapper)")
        print(f"[slam pallas] done at {time.time() - t0:.1f} s", flush=True)
        good, eval_launches, eval_table, finished = cli_phase(cfg_path)
        if not good or eval_table is None:
            fail("cli phase (disk loaders, run_slam, resume, final eval)")
        print(f"[cli] done at {time.time() - t0:.1f} s", flush=True)
        table, slot_ok, gx, ids, n_t = eval_table
        T, K, C = table.shape
        print(f"[kernels] first eval render's table: T={T} K={K} F={C - 7} grid_x={gx}, "
              f"{100 * float(slot_ok.float().mean()):.1f}% of the slots live", flush=True)
        r, good = check_kernels(f"eval table T={T} K={K} F={C - 7}", table, slot_ok, gx, 20,
                                seed=3, flips_allowed=2, tile_ids=ids, n_tiles=n_t)
        r[0]["path"] = "cli"
        rows.append(r[0])
        print(f"[kernels] eval table K1: {r[0]['ms']:.4f} ms, {100 * r[0]['bound_ms'] / r[0]['ms']:.1f}% "
              f"of its bound", flush=True)
        if not good:
            fail("kernel check on the recorded eval table")
        if not eval_agreement(final["stream"]):
            fail("final eval on the GPU disagrees with the CPU")
        print(f"[eval] done at {time.time() - t0:.1f} s", flush=True)
        good, r, nvs_launches = eval_novel_view_phase(finished, final["stream"])
        rows += r
        if not good:
            fail("eval_novel_view phase (the CLI on the [cli] run with save_frames, figures and "
                 "LPIPS, K1 on its eval table, gt-transfer and LPIPS GPU vs CPU)")
        print(f"[eval_novel_view] done at {time.time() - t0:.1f} s", flush=True)
        good, r, scannet_launches = scannet_phase()
        rows += r
        if not good:
            fail("scannet phase (loader, the tree-large and tree configs through the CLI, K1 "
                 "and K3/K4 at F = 77 on the run's own inputs)")
        print(f"[scannet] done at {time.time() - t0:.1f} s", flush=True)
        good, r, replica_launches = replica_phase()
        rows += r
        if not good:
            fail("replica phase (the nosemantic and gtpose configs through the CLI, K1/K2 on "
                 "their rank-ladder tracking and ladder mapping tables)")
        print(f"[replica] done at {time.time() - t0:.1f} s", flush=True)
        good, r, tum_launches = tum_phase()
        rows += r
        if not good:
            fail("tum phase (the TUM layout with tum.yaml's distortion, the nosemantic config "
                 "through the CLI, K1/K2 on its tracking table)")
        print(f"[tum] done at {time.time() - t0:.1f} s", flush=True)
        if not capacity_phase():
            fail("capacity phase (bucket growth, compaction and escalated prune, GPU vs CPU)")
        print(f"[capacity] done at {time.time() - t0:.1f} s", flush=True)
        good, r, real_shape_launches = real_shape_phase()
        rows += r
        if not good:
            fail("real_shape phase (the real-shape tool's prefix at 1200x680, K3/K4 on its "
                 "largest stream, K1/K2 on the 2K check's densest class)")
        print(f"[real_shape] done at {time.time() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
        good, r, classic_launches, final_state, small_state = classic_phase()
        rows += r
        if not good:
            fail("classic phase (clone/split densification in the ladder mapper at 1200x680, "
                 "K1/K2 on its table after a densify event, the 96x64 clone and split sets GPU "
                 "vs CPU)")
        print(f"[classic] done at {time.time() - t0:.1f} s", flush=True)
        good, r, aniso_launches = aniso_phase(final_state, small_state)
        del final_state, small_state
        rows += r
        if not good:
            fail("aniso phase (an anisotropic map tracked with and without the pose cache, "
                 "K1/K2 on its cached tracking table, both trackers GPU vs CPU)")
        print(f"[aniso] done at {time.time() - t0:.1f} s", flush=True)
        good, r, viz_launches = visualize_phase(finished)
        rows += r
        if not good:
            fail("visualize phase (the viewer CLI on the [cli] run, K1 on its table, a frame "
                 "GPU vs CPU)")
        print(f"[visualize] done at {time.time() - t0:.1f} s", flush=True)
        good, r, par_map_launches, par_strip_launches = parallel_phase(cfg_path)
        rows += r
        if not good:
            fail("parallel phase (data-parallel mapping of the flagship on 2 ranks, the "
                 "tile-sharded render on 2 and 4, equal columns vs the single mapper, K1 on the "
                 "last strip's table and K3/K4 on rank 1's stream)")
        print(f"[parallel] done at {time.time() - t0:.1f} s", flush=True)
        if not repro_phase(cfg_path):
            fail("repro phase (the flagship's 3-frame run with each mapper twice, equal to the "
                 "bit)")
        print(f"[repro] done at {time.time() - t0:.1f} s", flush=True)
    if args.tracking_table and not os.path.isfile(args.tracking_table):
        torch.save(recorded, args.tracking_table)
    by_path = {"cli": eval_launches, "scannet": scannet_launches,
               "replica": replica_launches, "real_shape": real_shape_launches,
               "eval_novel_view": nvs_launches, "tum": tum_launches,
               "classic": classic_launches, "aniso": aniso_launches, "visualize": viz_launches,
               "parallel_map": par_map_launches, "parallel_strip": par_strip_launches}
    for row in rows:
        row["launches"] = by_path.get(row.pop("path", None), launches)[row.pop("kernel")]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
