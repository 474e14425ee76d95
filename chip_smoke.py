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
   the ptxas report of K1-K4 (registers, shared memory, spill bytes; a
   spill in any instantiation fails the run);
2. kernels: K1-K4 against their plain PyTorch versions at F = 1, 3, 29
   and 32 on small inputs (the padding cases of the backwards' warp
   reduce-scatter); then K1/K2 (ladder blend) at
   the tracking shape (T=3225, K=512, F=3) and one ladder mapping class
   (T=128, K=4096, F=29), random tables from a seed, and on the run's own
   tracking table (what the first tracking iteration of frame 6 of the
   flagship run hands to K1, recorded by this script during phase 4, or,
   with ``--kernels``, during a run of frames 0-6 of its own); K3/K4 (stream
   blend) against theirs on the pair stream of a real map (frame 0 of the
   procedural room at 1200x680 back-projected, binned at the frame-0 pose
   with the flagship raster config) at F=29 and F=3; errors, the pixels
   whose last committed or median slot or pair differs from the plain
   version's (K1, K3), kernel and plain times (median of CUDA-event timings),
   roofline bounds;
3. reference: a tiny SLAM run (3 frames, 96x64) on the GPU with the
   kernels against the same run on the CPU with the plain versions, once
   with the ladder mapper and once with the stream mapper; the per-frame
   tracking losses of both sides and the first frame and iteration that
   differ by more than 1e-4 are printed;
4. SLAM, the main path: frames 0-7 of the procedural room at 1200x680 with
   26 semantic channels, the flagship config
   (configs/replica/hierslam_semantic_run.py) as shipped
   (``raster.backend="stream"``): tracking on frames 1-7 (K1/K2), densify
   at t=7 (K1), stream mapping at t=0 and t=7 (K3/K4); launch counts must
   equal what the config implies with no plain-version call, losses must
   be finite, ``params.npz`` must carry the JAX runner's keys;
5. ladder: the same config with ``raster.backend="pallas"`` on 3 frames
   (mapping at t=0 and, after a densify, at t=2), with its own count check.

The last two lines of standard output are a JSON object with the kernels'
numbers and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
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


def pair_stats(table, ok, grid_x: int):
    """What the blend needs on this data.  Tests: per pixel, the unmasked
    slots up to and including the one that ends it (forward) or up to the
    last committed one (backward); committed (blended) pairs.  Slots read:
    per tile, every position up to the largest of those over its pixels (a
    block retires once all its pixels have ended), for the forward and the
    backward, and the sum over pixels of the forward's positions.  Last: the
    plain version's choices [T, P, 2] (``walk_counts``)."""
    import torch

    from hierslam_torch.ops.render_xla import blend_terms, pixel_grid, tile_chunks

    T, K, _ = table.shape
    n_fwd = n_bwd = n_comm = n_pos = rows_fwd = rows_bwd = 0
    lasts = []
    with torch.no_grad():
        for lo, hi in tile_chunks(T, P, K):
            px, py = pixel_grid(torch.arange(lo, hi, device=table.device), TILE, grid_x)
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
            t = re.match(r"ILi(\d+)E", rest)
            cur = out.setdefault(f"{name}<{t.group(1)}>" if t else name, {})
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


def flip_is_tie(table, ok, grid_x: int, t: int, p: int, out_k, choice_p):
    """Whether pixel ``p`` of tile ``t``, where K1's last committed or median
    slot (``out_k`` = its acc, final T, median, last, mslot at that pixel)
    is not the plain version's (``choice_p``), differs only by rounding at a
    threshold.  Three things must hold.  Where the last slots differ, they
    are neighbours among the slots the pixel takes, and the plain
    transmittance after the later one is within ``FLIP_REL`` of 1e-4.  Where
    the median slots differ, the plain transmittance before or after each is
    within ``FLIP_REL`` of 0.5.  And K1's outputs are, within ``TOL``, what
    the plain terms give when they end at K1's slot and take K1's median
    slot.  Returns (ok, a line that says what was found)."""
    import torch

    from hierslam_torch.ops.render_xla import MEDIAN_DEFAULT, blend_terms, pixel_grid

    acc_k, ft_k, med_k, lk, mk = out_k
    lk, mk, lp, mp = int(lk), int(mk), int(choice_p[0]), int(choice_p[1])
    tab = table[t:t + 1]
    px, py = pixel_grid(torch.tensor([t], device=table.device), TILE, grid_x)
    terms = blend_terms(tab, ok[t:t + 1], px[:, p:p + 1], py[:, p:p + 1])
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
    ks = torch.arange(contrib.shape[0], device=table.device)
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
                  flips_allowed: int = 0):
    """K1/K2 against their plain versions on a table [T, K, 7+F] with slot
    mask ``ok``; with ``reps`` > 0 also their times and bounds.  ``seed``
    makes K2's cotangents.  Returns (JSON rows or None, ok).

    ``flips_allowed`` is for a table that differs from run to run (the
    recorded tracking table).  K1 takes transmittance as a sequential
    product, the plain version as a cumprod; where the two round apart at
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
    acc, ft, med, last, mslot = kernels.blend_fwd(table, ok, grid_x, TILE)
    torch.cuda.synchronize()
    acc_p, ft_p, med_p = render_pallas.blend_fwd_plain(table, ok, grid_x, TILE)
    e_acc = (acc - acc_p).abs().amax(-1)
    e_ft = (ft - ft_p).abs()
    e_med = (med - med_p).abs()
    n_fwd, n_bwd, n_comm, n_pos, rows_fwd, rows_bwd, choice_p = pair_stats(table, ok, grid_x)
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
        for t, p in flipped.nonzero().tolist():
            tie, said = flip_is_tie(table, ok, grid_x, t, p, (acc[t, p], ft[t, p], med[t, p],
                                                              last[t, p], mslot[t, p]),
                                    choice_p[t, p])
            print(f"[kernels] {name} K1: {said}", flush=True)
            fwd_ok &= tie

    g = torch.Generator(device=dev).manual_seed(seed + 1)
    gacc = torch.randn(acc.shape, generator=g, device=dev)
    gft = torch.randn(ft.shape, generator=g, device=dev)
    gmed = torch.randn(med.shape, generator=g, device=dev)
    if flips_allowed:   # a tie pixel adds nothing to either side's sums
        gacc[flipped], gft[flipped], gmed[flipped] = 0.0, 0.0, 0.0
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
          "(allowed 0)" + (f", cotangents 0 at the {n_flip} tie pixels" if n_flip else ""),
          flush=True)
    pad_ok = bool((dtab[~ok] == 0).all())
    if not pad_ok:
        print(f"[kernels] {name} K2: masked slots got a nonzero gradient", flush=True)
    if not reps:
        return None, fwd_ok and bwd_ok and pad_ok

    ms_f = cuda_ms(lambda: kernels.blend_fwd(table, ok, grid_x, TILE), reps)
    ms_b = cuda_ms(lambda: kernels.blend_bwd(table, ok, ft, last, mslot, gacc, gft, gmed,
                                             grid_x, TILE), reps)
    plain_f = cuda_ms(lambda: render_pallas.blend_fwd_plain(table, ok, grid_x, TILE), 3)
    plain_b = cuda_ms(lambda: render_pallas.blend_bwd_plain(table, ok, gacc, gft, gmed,
                                                            grid_x, TILE), 3)
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
    ``stream_inputs`` (``size``: W, H, f of a smaller frame); with ``reps``
    > 0 also their times and bounds.  Returns (JSON rows or None, ok)."""
    import torch

    from hierslam_torch.ops import kernels, render_stream as rs

    stream, sc, lists, pad, grid, img = stream_inputs(cfg_path, n_feat, **size)
    ro = lists.row_off
    R, _, C = stream.shape
    T = grid[0] * grid[1]
    F = n_feat
    name = (f"flagship stream R={R} F={F}" if not size else
            f"stream {size['W']}x{size['H']} R={R} F={F}")
    print(f"[kernels] {name}: n_rows {int(lists.n_rows)} n_refs {int(lists.n_refs)} n_dropped "
          f"{int(lists.n_dropped)} n_sat_masked {int(lists.n_sat_masked)} max rows a tile "
          f"{int((ro[1:] - ro[:-1]).max())}", flush=True)
    acc, ft, med, last, mpos = kernels.stream_fwd(stream, sc, ro, grid[1], TILE, F, img)
    torch.cuda.synchronize()
    acc_p, ft_p, med_p = rs.blend_stream_fwd_plain(stream, sc, ro, grid, TILE, F, img)
    e_acc = (acc - acc_p).abs().amax(-1)
    e_ft = (ft - ft_p).abs()
    e_med = (med - med_p).abs()
    n_fl = n_beyond(e_acc, TOL["acc"]) + n_beyond(e_ft, TOL["ft"]) + n_beyond(e_med, TOL["med"])
    fwd_err = max(float(e_acc.max()), float(e_ft.max()), float(e_med.max()))
    n_fwd, n_bwd, n_comm, n_pos, rows_fwd, rows_bwd, choice_p = stream_pair_stats(
        stream, sc, ro, grid, F, img)
    n_flip = int((torch.stack([last, mpos], -1) != choice_p).any(-1).sum())
    print(f"[kernels] {name} K3: max abs err acc {float(e_acc.max()):.3e} ft "
          f"{float(e_ft.max()):.3e} med {float(e_med.max()):.3e}; pixels beyond tolerance "
          f"{n_fl} of {T * P} (allowed 0); pixels whose last committed or median pair differs "
          f"from the plain version's {n_flip}", flush=True)

    g = torch.Generator(device="cuda").manual_seed(7)
    gacc = torch.randn(acc.shape, generator=g, device="cuda")
    gft = torch.randn(ft.shape, generator=g, device="cuda")
    gmed = torch.randn(med.shape, generator=g, device="cuda")
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
          f"{int(pad.sum())} pad pairs, all exactly 0: {pad_ok}", flush=True)
    if not reps:
        return None, n_fl == 0 and n_fl_b == 0 and pad_ok

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
    return rows, n_fl == 0 and n_fl_b == 0 and pad_ok


@functools.lru_cache(maxsize=2)
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


def reference_phase(cfg_path: str, backend: str):
    """The same tiny run on the GPU (kernels) and the CPU (plain versions)."""
    import numpy as np

    from hierslam_torch.config import load_config
    from hierslam_torch.slam.pipeline import SLAMRunner

    ds = room_dataset(3, 96, 64, 48.0, n_frames_arc=40)
    traces = {}
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
    return d_track <= 1e-2 and d_map <= 1e-2 and d_traj <= 1e-3


RECORD_FRAME = 6   # the frame whose first tracking table is kept


@contextlib.contextmanager
def recording_blend_fwd(seen: list):
    """While active, the first call of the wrapper ``kernels.blend_fwd`` leaves
    a copy of its (table, slot mask, grid_x) in ``seen``.  The wrapper is
    wrapped from here, the package has no hook for it; every call still
    goes to the kernel."""
    from hierslam_torch.ops import kernels

    launch = kernels.blend_fwd

    def recording(table, ok, grid_x, tile_shape):
        if not seen:
            seen.append((table.detach().clone(), ok.clone(), grid_x))
        return launch(table, ok, grid_x, tile_shape)

    kernels.blend_fwd = recording
    try:
        yield
    finally:
        kernels.blend_fwd = launch


def tracking_table(cfg_path: str):
    """The (table, slot mask, grid_x) that the first tracking iteration of
    frame ``RECORD_FRAME`` hands to K1 in the flagship run, from a run of
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


def slam_phase(cfg_path: str, backend: Optional[str] = None, n_frames: int = 8,
               map_every: Optional[int] = None, record: Optional[list] = None):
    """Drive ``SLAMRunner.step`` over ``n_frames`` procedural frames at
    1200x680 with the flagship config (``backend``/``map_every`` override
    it when given).  Launch counts are zeroed just before the run and read
    just after.  With ``record`` (a list), frame ``RECORD_FRAME``'s first
    tracking table is left in it.  Returns (ok, launches, summary)."""
    import numpy as np
    import torch

    from hierslam_torch.config import load_config
    from hierslam_torch.ops import kernels, render_pallas, render_stream
    from hierslam_torch.ops.binning import resolve_bucket_spec
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

    kernels.reset_launch_counts()
    for counts in (render_pallas.plain_counts, render_stream.plain_counts):
        for k in counts:
            counts[k] = 0
    ok = True
    n_track = n_map = n_dens = 0
    t_run = time.time()
    for t in range(n_frames):
        with (recording_blend_fwd(record) if record is not None and t == RECORD_FRAME
              else contextlib.nullcontext()):
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
    launches = dict(kernels.launch_counts)
    plain = dict(render_pallas.plain_counts, **render_stream.plain_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    pn = runner.finalize()
    summ = runner.runtime_summary()

    it_t, it_m = cfg["tracking"]["num_iters"], cfg["mapping"]["num_iters"]
    if backend == "stream":
        want = {"blend_fwd": n_track * it_t + n_dens, "blend_bwd": n_track * it_t,
                "stream_fwd": n_map * it_m, "stream_bwd": n_map * it_m}
    else:
        grid = runner.rc.grid(680, 1200)
        n_classes = sum(1 for nb, _ in resolve_bucket_spec(runner.rc.spec(), grid[0] * grid[1])
                        if nb > 0)
        want = {"blend_fwd": n_track * it_t + n_dens + n_map * it_m * n_classes,
                "blend_bwd": n_track * it_t + n_map * it_m * n_classes,
                "stream_fwd": 0, "stream_bwd": 0}
    print(f"{tag} launches: {json.dumps(launches)} expected: {json.dumps(want)} plain calls: "
          f"{json.dumps(plain)}", flush=True)
    ok &= launches == want
    ok &= all(v == 0 for v in plain.values())
    if not ok:
        print(f"{tag} non-finite loss, plain calls or launch counts off", flush=True)
    print(f"{tag} drops: densify_overflow {summ['densify_overflow']} bin_overflow_max "
          f"{summ['bin_overflow_max']} n_map_bin_dropped "
          f"{float(np.max(runner.last_mapping_trace['n_map_bin_dropped']))} n_grad_dropped "
          f"{float(np.max(runner.last_mapping_trace['n_grad_dropped']))}", flush=True)
    errs = centre_err_cm(runner, ds, n_frames)
    print(f"{tag} camera-centre error vs GT (cm): " + " ".join(f"{e:.3f}" for e in errs),
          flush=True)
    summ["max_memory_allocated_GiB"] = peak_gib
    print(f"{tag} tracking_iter_ms {summ['tracking_iter_ms']:.3f} mapping_iter_ms "
          f"{summ['mapping_iter_ms']:.3f} tracking_frame_s {summ['tracking_frame_s']:.3f} "
          f"mapping_frame_s {summ['mapping_frame_s']:.3f} wall_s {wall:.1f} n_active "
          f"{summ['n_active']} max_memory_allocated_GiB {peak_gib:.2f}", flush=True)
    keys = ("means3D", "rgb_colors", "logit_opacities", "log_scales", "semantic",
            "unnorm_rotations", "cam_unnorm_rots", "cam_trans", "timestep", "intrinsics",
            "w2c", "gt_w2c_all_frames", "keyframe_time_indices", "org_width", "org_height")
    path = os.path.join(workdir, cfg["run_name"], "params.npz")
    with np.load(path) as data:
        missing = [k for k in keys if k not in data]
        finite = all(np.isfinite(data[k]).all() for k in keys if k not in missing)
    print(f"{tag} params.npz: missing keys {missing}, all finite {finite}", flush=True)
    ok &= not missing and finite and os.path.isfile(
        os.path.join(workdir, cfg["run_name"], "semantic_decoder.npz"))
    ok &= bool(np.all(np.isfinite(errs)))
    return ok, launches, summ


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
           for src, C in (("blend.cu", 10), ("blend.cu", 36), ("stream.cu", 8),
                          ("stream.cu", 34))}
    print(f"[build] ptxas: {json.dumps(ptx, sort_keys=True)}; K2/K4 (batch, dynamic smem "
          f"bytes) at P={P}: {json.dumps(dyn)}", flush=True)
    reported = all(any(k.startswith(name) for k in ptx)
                   for name in ("blend_fwd", "blend_bwd", "stream_fwd", "stream_bwd"))
    if not reported or any(v.get("spill_stores", 1) + v.get("spill_loads", 1)
                           for v in ptx.values()):
        fail("a kernel spills registers to local memory (or its ptxas report is missing)")

    rows = []
    ok = True
    cfg_path = os.path.join(ROOT, "configs", "replica", "hierslam_semantic_run.py")
    # every feature bucket and padding case of the backwards' reduce-scatter
    # on small inputs, then the main path's shapes with timings
    dev = torch.device("cuda")
    for F in (1, 3, 29, 32):
        ok &= check_kernels(f"small T=48 K=256 F={F}", *random_table(10 + F, 48, 256, F, 8, dev),
                            8, 0, seed=10 + F)[1]
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
    for n_feat in (29, 3):
        r, good = check_stream_kernels(cfg_path, n_feat, 20)
        rows += r
        ok &= good
    print(f"[kernels] checks on seeded inputs done at {time.time() - t0:.1f} s", flush=True)

    def check_recorded(recorded):
        """K1/K2 on the flagship run's own tracking table, a third shape."""
        table, slot_ok, gx = recorded
        T, K, C = table.shape
        print(f"[kernels] tracking table of frame {RECORD_FRAME}, first iteration: T={T} K={K} "
              f"F={C - 7} grid_x={gx}, {100 * float(slot_ok.float().mean()):.1f}% of the "
              f"slots live (at {time.time() - t0:.1f} s)", flush=True)
        return check_kernels(f"captured tracking table T={T} K={K} F={C - 7}", table, slot_ok,
                             gx, 20, seed=2, flips_allowed=2)

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
    if not args.kernels:
        for backend in ("pallas", "stream"):
            if not reference_phase(cfg_path, backend):
                fail(f"GPU run with the {backend} mapper disagrees with the CPU reference")
        print(f"[reference] done at {time.time() - t0:.1f} s", flush=True)
        runs = []
        seen = []
        for i in range(args.repeat):
            good, launches, summ = slam_phase(cfg_path,
                                              record=seen if recorded is None else None)
            if not good:
                fail("SLAM phase (flagship as shipped)")
            runs.append(summ)
            if recorded is None:
                recorded = seen[0]
                r, good = check_recorded(recorded)
                rows += r
                if not good:
                    fail("kernel check on the recorded tracking table")
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
    if args.tracking_table and not os.path.isfile(args.tracking_table):
        torch.save(recorded, args.tracking_table)
    for row in rows:
        row["launches"] = launches[row.pop("kernel")]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
