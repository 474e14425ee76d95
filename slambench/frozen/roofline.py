"""The work a K4 call's inputs need, and its least time on the card.

Frozen copy of ``chip_smoke.py``'s ``bound``, ``walk_counts`` and
``stream_pair_stats`` (commit 2c704bc) and of the byte and operation
counts its ``check_stream`` gives K4.  The helpers they call are frozen in
``layout.py``.
"""
from __future__ import annotations

import torch

from slambench.frozen import layout as rs
from slambench.frozen.layout import tile_chunks

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, float32 outside the tensor cores
RW = 128                       # pairs per stream row


def bound(nbytes, ops):
    """Least time (ms) for ``nbytes`` of device memory traffic and ``ops``
    float32 operations, and which of the two sets it."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def walk_counts(terms, n_slots, live):
    """From ``blend_terms`` of a chunk [B, P, K], per pixel: slot positions
    up to and including the one that ends it, the index of the last
    committed slot and of the slot where T crosses 0.5, the committed pairs,
    and the (pixel, live slot) tests forward and backward."""
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


def stream_pair_stats(stream, sc, row_off, grid, tile_shape, n_feat, img_shape):
    """What the stream blend needs on this pair stream, with rows of ``RW``
    pairs: (tests fwd, tests bwd, committed pairs, slot positions walked,
    stream rows read fwd, bwd)."""
    T = row_off.shape[0] - 1
    P = tile_shape[0] * tile_shape[1]
    flat = stream.reshape(-1, stream.shape[-1])
    k_max = rs.max_tile_pairs(row_off)
    n_fwd = n_bwd = n_comm = n_pos = rows_fwd = rows_bwd = 0
    with torch.no_grad():
        for lo, hi in tile_chunks(T, P, k_max):
            pos, inside = rs.tile_view(flat, row_off, lo, hi, k_max)
            tids = torch.arange(lo, hi, device=stream.device)
            _, terms, _ = rs.blend_view(flat[pos], inside, sc, tids, grid[1], tile_shape, n_feat,
                                        img_shape)
            valid = rs.project_pairs(flat[pos], sc, (tids % grid[1]).float()[:, None],
                                     (tids // grid[1]).float()[:, None], float(img_shape[1]),
                                     float(img_shape[0]), tile_shape)["valid"]
            first_stop, choice, comm, tests_fwd, tests_bwd = walk_counts(
                terms, inside.sum(-1, keepdim=True), valid & inside)
            last = choice[..., 0]
            n_fwd += tests_fwd
            n_bwd += tests_bwd
            n_comm += comm
            n_pos += int(first_stop.sum())
            rows_fwd += int(((first_stop.amax(-1) + RW - 1) // RW).sum())
            rows_bwd += int((last.amax(-1) // RW + 1).clamp_min(0).sum())
    return n_fwd, n_bwd, n_comm, n_pos, rows_fwd, rows_bwd


def k4_bound_ms(stream, sc, row_off, grid, tile_shape, n_feat, img_shape) -> float:
    """K4's least time on this pair stream [R, 128, 5+F]: the rows up to
    each tile's last committed pair, the per-pixel reads, the whole d stream
    written; ~250 operations a projected pair, 12 a (pixel, valid pair)
    test, the suffix-sum terms a committed pair."""
    R, _, C = stream.shape
    T = row_off.shape[0] - 1
    pix = T * tile_shape[0] * tile_shape[1]
    row_bytes = RW * C * 4
    _, n_bwd, n_comm, _, _, rows_bwd = stream_pair_stats(stream, sc, row_off, grid, tile_shape,
                                                         n_feat, img_shape)
    F = n_feat
    b_bytes = rows_bwd * row_bytes + pix * ((F + 2) + 5) * 4 + R * row_bytes
    b_ops = 250 * rows_bwd * RW + 12 * n_bwd + (4 * (F + 2) + 30 + C) * n_comm
    return bound(b_bytes, b_ops)[0]
