"""Tile binning (port of ``hierslam_tpu/ops/binning.py``: ``bin_gaussians``, ``bin_bucketed``,
``bin_stream``).

Every Gaussian emits one (tile, depth) pair per tile its screen rect
covers, with the JAX package's budgeted prefix emission (Gaussians sorted
by ``tiles_touched`` descending, cell-row ``r`` covering the first ``B_r``
of them).  On CUDA tensors kernel ``bin_emit`` (``csrc/binning.cu``, via
``ops/kernels.py``) writes every cell row's pairs at offsets the device
works out, after one host read of their total; on CPU tensors the plain
version (:func:`emit_pairs_plain`) compacts each row with a boolean mask.
A CUDA tensor never takes the plain path.  The pairs are put in the
total order tile, then depth, then gaussian id: two stable sorts, the
first by id and the second by one packed int64 key ``tile << 32 | depth
bits`` (depth > 0.2 for every live pair, so its float32 bits order like
the value).  Unlike the static-shape JAX version, emitted-but-empty cells
are filtered out before the sort.

With ``sat_margin > 0`` each pair carries quantized per-quadrant lower
bounds of its alpha over the tile; four global cumsums of ``log1p(-alpha)``
then give each tile's provable saturation rank ``k_need`` and the
per-tile need ``k_eff = min(count, max(sat_floor, ceil(margin * k_need)))``.
Tiles are ranked by need into the capacity classes of ``bucket_spec``
(``bin_bucketed``) or granted rows of one ragged pair stream by a
waterfill under a global row budget (``bin_stream``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from hierslam_torch.ops import kernels

SAT_SCALE = 255
T_DONE_LOG = -9.210340371976182  # ln(1e-4)


class TileLists(NamedTuple):
    """Fixed-K depth-ordered per-tile lists (:func:`bin_gaussians`)."""

    idx: torch.Tensor        # [T, K] int64 gaussian indices in depth order, -1 pad
    count: torch.Tensor      # [T] overlap counts (may exceed K)
    n_dropped: torch.Tensor  # [] pairs lost to the K cap and the emission caps


class EscalatedLists(NamedTuple):
    """Longer lists for the tiles of the highest overlap counts."""

    tile_ids: torch.Tensor   # [OB] tile ids (top counts, lowest id first among ties)
    idx: torch.Tensor        # [OB, K_big] indices in depth order, -1 pad
    count: torch.Tensor      # [OB] overlap counts of those tiles


class BucketedLists(NamedTuple):
    """Depth-ordered per-tile lists in rank-assigned capacity classes."""

    tile_ids: Tuple[torch.Tensor, ...]  # per class: [n_b] int64 tile ids
    idx: Tuple[torch.Tensor, ...]       # per class: [n_b, k_b] int64, -1 pad
    count: torch.Tensor                 # [T] true per-tile overlap counts
    k_eff: torch.Tensor                 # [T] per-tile need used for ranking
    n_refs: torch.Tensor                # [] total non-pad (tile, slot) refs
    n_dropped: torch.Tensor             # [] pairs lost to budgets/class caps
    n_sat_masked: torch.Tensor          # [] provably-invisible masked pairs
    # visible-rank compaction (None unless visible_budget > 0): idx entries
    # are RANKS into the touched-descending order, vis_ids[r] is the
    # gaussian at rank r and rank_of the inverse permutation.
    vis_ids: Optional[torch.Tensor] = None   # [V] int64
    rank_of: Optional[torch.Tensor] = None   # [N] int64


def default_emission_budgets(n: int, r_cap: int) -> Tuple[int, ...]:
    """Per-cell-row emission budgets (row 0 covers every gaussian)."""
    out = []
    for r in range(r_cap):
        if r < 2:
            b = n
        elif r < 4:
            b = -(-n // 2)
        elif r < 8:
            b = -(-n // 4)
        else:
            b = -(-n // 16)
        out.append(min(n, max(b, 4096)))
    return tuple(out)


def resolve_bucket_spec(spec, num_tiles: int):
    """Resolve ((n, k), ..., (-1, k_min)) against a tile count: ks strictly
    descending multiples of k_min, the last class takes the remainder."""
    spec = tuple((int(n), int(k)) for n, k in spec)
    if not spec or spec[-1][0] != -1:
        raise ValueError("bucket_spec's last entry must be (-1, k_min)")
    ks = [k for _, k in spec]
    k_min = ks[-1]
    if any(k <= 0 or k % k_min for k in ks):
        raise ValueError(f"bucket ks must be positive multiples of the "
                         f"last class's k ({k_min}): {ks}")
    if any(a <= b for a, b in zip(ks, ks[1:])):
        raise ValueError(f"bucket ks must be strictly descending: {ks}")
    if any(n < 0 for n, _ in spec[:-1]):
        raise ValueError("only the last bucket may have n = -1")
    out, left = [], num_tiles
    for n, k in spec[:-1]:
        n = min(n, left)
        out.append((n, k))
        left -= n
    out.append((left, k_min))
    return tuple(out)


# calls of the plain emission (a main-path run on the card keeps it at 0)
plain_counts = {"emit_pairs_plain": 0}


class SortedPairs(NamedTuple):
    s_gauss: torch.Tensor       # [M] gaussian ids (or visible ranks) in (tile, depth, id) order
    starts: torch.Tensor        # [T] per-tile run starts
    counts: torch.Tensor        # [T] true overlap counts
    k_eff: torch.Tensor         # [T] saturation-bounded per-tile need
    n_sat_masked: torch.Tensor  # []
    n_dropped_pre: torch.Tensor  # [] emission-cap + row-budget drops
    order: torch.Tensor         # [N] touched-descending gaussian order
    v_budget: int


def _emit_sort_sat(rect_min, rect_max, valid, depth, grid, tile_shape, r_cap,
                   emission_budgets, sat_margin, sat_floor, xy, conic,
                   opacity, visible_budget) -> SortedPairs:
    grid_y, grid_x = grid
    n = depth.shape[0]
    dev = depth.device
    num_tiles = grid_y * grid_x
    v_budget = min(visible_budget, n) if visible_budget > 0 else 0
    base_n = v_budget if v_budget else n
    budgets = (tuple(emission_budgets) if emission_budgets is not None
               else default_emission_budgets(base_n, r_cap))
    budgets = tuple(min(b, base_n) for b in budgets)
    if len(budgets) < r_cap:
        raise ValueError("need one emission budget per cell row")
    budgets = budgets[:r_cap]
    with_sat = sat_margin > 0.0
    if with_sat and (xy is None or conic is None or opacity is None):
        raise ValueError("sat_margin > 0 requires xy/conic/opacity")

    rect_min = rect_min.long()
    rect_max = rect_max.long()
    w_rect = rect_max[:, 0] - rect_min[:, 0]
    touched_all = torch.where(
        valid, w_rect * (rect_max[:, 1] - rect_min[:, 1]), torch.zeros_like(w_rect)
    )
    n_dropped_emit = (touched_all - r_cap).clamp_min(0).sum()
    touched = touched_all.clamp_max(r_cap)
    neg_sorted, order = torch.sort(-touched, stable=True)
    offs, n_dropped_budget = emission_offsets(neg_sorted, budgets)
    flat_tile, flat_depth, flat_gauss, flat_alpha = emit_pairs(
        rect_min, w_rect, touched, depth, order[:base_n], budgets, grid_x, tile_shape,
        bool(v_budget), (xy, conic, opacity.reshape(-1)) if with_sat else None, offs)

    # (tile, depth, gauss) order: stable sort by gauss, then stable sort by
    # the packed (tile, depth) key
    p1 = torch.sort(flat_gauss, stable=True).indices
    key = (flat_tile[p1] << 32) | flat_depth[p1].view(torch.int32).long()
    p2 = torch.sort(key, stable=True).indices
    perm = p1[p2]
    s_tile = flat_tile[perm]
    s_gauss = flat_gauss[perm]
    m = s_gauss.shape[0]

    tile_ids = torch.arange(num_tiles, device=dev)
    starts = torch.searchsorted(s_tile, tile_ids)
    ends = torch.searchsorted(s_tile, tile_ids, right=True)
    counts = ends - starts

    n_sat_masked = torch.zeros((), dtype=torch.int64, device=dev)
    if with_sat:
        k_need = torch.zeros((num_tiles,), dtype=torch.int64, device=dev)
        if m > 0:
            s_alpha = flat_alpha[perm]
            for qi in range(4):
                alpha_deq = s_alpha[:, qi].float() * (0.99 / SAT_SCALE)
                csh = torch.cat([
                    torch.zeros((1,), dtype=torch.float32, device=dev),
                    torch.cumsum(torch.log1p(-alpha_deq), 0)[:-1],
                ])
                csh_start = csh[starts.clamp_max(m - 1)]
                thresh = csh_start + T_DONE_LOG
                hits = torch.searchsorted(-csh, -thresh, right=True)
                k_need = torch.maximum(
                    k_need, torch.minimum((hits - starts).clamp_min(0), counts)
                )
        k_eff = torch.minimum(
            counts,
            torch.ceil(sat_margin * k_need.float()).long().clamp_min(int(sat_floor)),
        )
        n_sat_masked = (counts - k_eff).sum()
    else:
        k_eff = counts

    return SortedPairs(
        s_gauss=s_gauss, starts=starts, counts=counts, k_eff=k_eff,
        n_sat_masked=n_sat_masked,
        n_dropped_pre=n_dropped_emit + n_dropped_budget,
        order=order, v_budget=v_budget,
    )


def emission_offsets(neg_sorted: torch.Tensor, budgets: Sequence[int]):
    """Where each cell row's pairs go in the emission's concatenation.
    ``neg_sorted`` is ``-touched`` sorted ascending (tiles touched, clamped
    to the ``r_cap = len(budgets)`` cell rows), so the gaussians that reach
    cell row ``r`` (``touched > r``, ``cnt_gt[r]`` of them) are a prefix of
    the touched-descending order and row ``r`` emits the first
    ``min(budgets[r], cnt_gt[r])``.  Returns ``offs`` [r_cap + 1] int64, row
    ``r``'s part at ``offs[r]:offs[r+1]``, and the pairs the budgets drop
    ([]); reads nothing back to the host."""
    dev = neg_sorted.device
    cnt_gt = torch.searchsorted(neg_sorted, -torch.arange(len(budgets), device=dev))
    # a pageable source is staged before the copy returns: no wait for the device
    buds = torch.tensor(budgets, dtype=torch.int64).to(dev, non_blocking=True)
    lens = torch.minimum(buds, cnt_gt)
    offs = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    return offs, (cnt_gt - buds).clamp_min(0).sum()


def emit_pairs_plain(rect_min, w_rect, touched, depth, o, budgets, grid_x, tile_shape, vis,
                     sat):
    """Plain form of :func:`emit_pairs`: for each cell row ``r`` the cells
    of the first ``budgets[r]`` gaussians of the touched-descending order
    ``o``, kept where ``touched > r`` by one boolean-mask compaction a row,
    concatenated in row order."""
    plain_counts["emit_pairs_plain"] += 1
    th, tw = tile_shape
    rmx, rmy = rect_min[o, 0], rect_min[o, 1]
    wr = w_rect.clamp_min(1)[o]
    tch = touched[o]
    dep = depth[o].float()
    if sat is not None:
        xy, conic, opacity = sat
        sx, sy = xy[o, 0].float(), xy[o, 1].float()
        sca, scb, scc = conic[o, 0].float(), conic[o, 1].float(), conic[o, 2].float()
        sop = opacity[o].float()

    tiles_parts, depth_parts, gauss_parts, alpha_parts = [], [], [], []
    ids_b = torch.arange(o.shape[0], device=o.device) if vis else o
    for r, b in enumerate(budgets):
        ok = r < tch[:b]
        cell_x = rmx[:b] + r % wr[:b]
        cell_y = rmy[:b] + r // wr[:b]
        tiles_parts.append((cell_y * grid_x + cell_x)[ok])
        depth_parts.append(dep[:b][ok])
        gauss_parts.append(ids_b[:b][ok])
        if sat is not None:
            # per-quadrant conservative alpha lower bounds on the tile's
            # 3x3 corner grid, quantized floor-ward (never truncates a
            # contributor)
            x0 = (cell_x[ok] * tw).float()
            y0 = (cell_y[ok] * th).float()
            bx, by = sx[:b][ok], sy[:b][ok]
            ba, bb, bc, bo = sca[:b][ok], scb[:b][ok], scc[:b][ok], sop[:b][ok]
            hw, hh = (tw - 1) * 0.5, (th - 1) * 0.5
            pgrid = []
            for cy in (y0, y0 + hh, y0 + (th - 1)):
                row = []
                for cx in (x0, x0 + hw, x0 + (tw - 1)):
                    dx = bx - cx
                    dy = by - cy
                    row.append(-0.5 * (ba * dx * dx + bc * dy * dy) - bb * dx * dy)
                pgrid.append(row)
            quads = []
            for iy, ix in ((0, 0), (0, 1), (1, 0), (1, 1)):
                pmin = torch.minimum(
                    torch.minimum(pgrid[iy][ix], pgrid[iy][ix + 1]),
                    torch.minimum(pgrid[iy + 1][ix], pgrid[iy + 1][ix + 1]),
                )
                alpha_lb = torch.clamp_max(bo * torch.exp(pmin), 0.99)
                alpha_lb = torch.where(alpha_lb >= 1.0 / 255.0, alpha_lb,
                                       torch.zeros_like(alpha_lb))
                quads.append(torch.floor(alpha_lb / 0.99 * SAT_SCALE).to(torch.int16))
            alpha_parts.append(torch.stack(quads, -1))
    return (torch.cat(tiles_parts), torch.cat(depth_parts), torch.cat(gauss_parts),
            torch.cat(alpha_parts) if sat is not None else None)


def emit_pairs(rect_min, w_rect, touched, depth, o, budgets, grid_x, tile_shape, vis, sat,
               offs):
    """Every gaussian's (tile, depth, id) pairs, cell row by cell row: row
    ``r``'s part, at ``offs[r]`` (:func:`emission_offsets`), holds the cell
    ``r`` (row-major in its tile rect ``rect_min`` + ``w_rect`` wide) of the
    first ``min(budgets[r], cnt_gt[r])`` gaussians of the touched-descending
    order ``o``, ids ``o`` (ranks into it with ``vis``).  With ``sat`` =
    (xy, conic, opacity) each pair also carries its quantized per-quadrant
    alpha lower bounds over the tile.  -> (tile [M] int64, depth [M] f32,
    gauss [M] int64, quads [M, 4] int16 or None).  On CUDA tensors kernel
    ``bin_emit`` writes every part in place after one host read, of ``M``;
    on CPU tensors :func:`emit_pairs_plain` runs."""
    if o.device.type != "cuda":
        return emit_pairs_plain(rect_min, w_rect, touched, depth, o, budgets, grid_x,
                                tile_shape, vis, sat)
    if sat is not None:
        sat = tuple(x.float().contiguous() for x in sat)
    return kernels.bin_emit(rect_min.contiguous(), w_rect, depth.float().contiguous(), o, offs,
                            int(offs[-1]), grid_x, tile_shape, vis, sat)


def _vis_fields(sp: SortedPairs, n: int):
    if not sp.v_budget:
        return None, None
    rank_of = torch.empty_like(sp.order)
    rank_of[sp.order] = torch.arange(n, device=sp.order.device)
    return sp.order[: sp.v_budget], rank_of


def _tile_lists(s_gauss_pad, starts, lim, k: int):
    """[len(starts), k] lists: the first ``lim`` of each run, -1 after."""
    kk = torch.arange(k, device=starts.device)
    take = starts[:, None] + kk[None, :]
    ok = kk[None, :] < lim[:, None]
    m = s_gauss_pad.shape[0] - 1
    return torch.where(ok, s_gauss_pad[take.clamp_max(m)], torch.full_like(take, -1))


def bin_gaussians(
    rect_min: torch.Tensor,
    rect_max: torch.Tensor,
    valid: torch.Tensor,
    depth: torch.Tensor,
    grid: Tuple[int, int],
    max_per_tile: int,
    chunk: int = 16384,
    max_tiles_per_gaussian: int = 32,
    emission_budgets: Optional[Sequence[int]] = None,
    n_escalate: int = 0,
    escalate_k: int = 0,
):
    """Per-tile depth-ordered lists at one capacity K = ``max_per_tile``
    (``chunk`` shapes the JAX scan only and is ignored).  With
    ``n_escalate`` and ``escalate_k > K`` the ``n_escalate`` tiles of the
    highest counts also get lists at ``escalate_k`` slots, and the pairs
    those recover leave ``n_dropped``.  Returns ``(TileLists,
    EscalatedLists or None)``."""
    sp = _emit_sort_sat(rect_min, rect_max, valid, depth, grid, (1, 1),
                        max_tiles_per_gaussian, emission_budgets, 0.0, 0, None, None, None, 0)
    dev = depth.device
    counts = sp.counts
    s_gauss_pad = torch.cat([sp.s_gauss, torch.full((1,), -1, dtype=torch.int64, device=dev)])
    k = max_per_tile
    lists = _tile_lists(s_gauss_pad, sp.starts, counts, k)
    n_dropped = (counts - k).clamp_min(0).sum() + sp.n_dropped_pre
    esc = None
    if n_escalate > 0 and escalate_k > k:
        ob = min(n_escalate, counts.shape[0])
        big_ids = torch.sort(-counts, stable=True).indices[:ob]
        big_counts = counts[big_ids]
        esc = EscalatedLists(
            tile_ids=big_ids,
            idx=_tile_lists(s_gauss_pad, sp.starts[big_ids], big_counts, escalate_k),
            count=big_counts)
        n_dropped = n_dropped - (big_counts.clamp_max(escalate_k) - big_counts.clamp_max(k)).sum()
    return TileLists(idx=lists, count=counts, n_dropped=n_dropped), esc


def bin_bucketed(
    rect_min: torch.Tensor,
    rect_max: torch.Tensor,
    valid: torch.Tensor,
    depth: torch.Tensor,
    grid: Tuple[int, int],
    bucket_spec,
    tile_shape: Tuple[int, int],
    max_tiles_per_gaussian: int = 16,
    emission_budgets: Optional[Sequence[int]] = None,
    sat_margin: float = 0.0,
    sat_floor: int = 64,
    xy: Optional[torch.Tensor] = None,
    conic: Optional[torch.Tensor] = None,
    opacity: Optional[torch.Tensor] = None,
    visible_budget: int = 0,
) -> BucketedLists:
    """Rank-bucketed per-tile depth-ordered lists (see :class:`BucketedLists`)."""
    grid_y, grid_x = grid
    num_tiles = grid_y * grid_x
    n = depth.shape[0]
    spec = resolve_bucket_spec(bucket_spec, num_tiles)
    sp = _emit_sort_sat(
        rect_min, rect_max, valid, depth, grid, tile_shape,
        max_tiles_per_gaussian, emission_budgets, sat_margin, sat_floor,
        xy, conic, opacity, visible_budget,
    )
    s_gauss, starts, counts, k_eff = sp.s_gauss, sp.starts, sp.counts, sp.k_eff
    dev = depth.device
    rank_order = torch.sort(-k_eff, stable=True).indices
    s_gauss_pad = torch.cat([s_gauss, torch.full((1,), -1, dtype=torch.int64, device=dev)])
    ids_out, idx_out = [], []
    n_class_dropped = torch.zeros((), dtype=torch.int64, device=dev)
    n_refs = torch.zeros((), dtype=torch.int64, device=dev)
    off = 0
    for n_b, k_b in spec:
        ids_b = rank_order[off:off + n_b]
        off += n_b
        lim_b = k_eff[ids_b].clamp_max(k_b)
        idx_b = _tile_lists(s_gauss_pad, starts[ids_b], lim_b, k_b)
        ids_out.append(ids_b)
        idx_out.append(idx_b)
        n_refs = n_refs + lim_b.sum()
        n_class_dropped = n_class_dropped + (
            torch.minimum(k_eff[ids_b], counts[ids_b]) - k_b
        ).clamp_min(0).sum()

    vis_ids, rank_of = _vis_fields(sp, n)
    return BucketedLists(
        tile_ids=tuple(ids_out),
        idx=tuple(idx_out),
        count=counts,
        k_eff=k_eff,
        n_refs=n_refs,
        n_dropped=n_class_dropped + sp.n_dropped_pre,
        n_sat_masked=sp.n_sat_masked,
        vis_ids=vis_ids,
        rank_of=rank_of,
    )


class StreamLists(NamedTuple):
    """Ragged depth-ordered pair stream in ``rw``-pair rows.

    Tile ``t`` owns rows ``row_off[t]..row_off[t+1]``: ``ceil(k_alloc/rw)``
    of them, its saturation-bounded need ``k_eff`` (capped at ``k_cap``)
    granted under a global row budget by waterfilling.  ``idx`` holds the
    ``n_rows`` used rows only (the JAX package pads it to the budget for a
    static shape); pad slots hold the sentinel index (``n``, or the visible
    budget under compaction), the row the caller appends to its table."""

    idx: torch.Tensor          # [n_rows, rw] int64, sentinel-padded
    row_off: torch.Tensor      # [T+1] int32 row offsets per tile
    count: torch.Tensor        # [T] true overlap counts
    k_eff: torch.Tensor        # [T] saturation-bounded need
    k_alloc: torch.Tensor      # [T] granted slots
    n_refs: torch.Tensor       # [] kept (non-pad) pairs
    n_rows: torch.Tensor       # [] used rows (<= the budget)
    n_dropped: torch.Tensor    # [] real pairs lost (budget, caps, emission)
    n_sat_masked: torch.Tensor
    vis_ids: Optional[torch.Tensor] = None
    rank_of: Optional[torch.Tensor] = None


def bin_stream(
    rect_min: torch.Tensor,
    rect_max: torch.Tensor,
    valid: torch.Tensor,
    depth: torch.Tensor,
    grid: Tuple[int, int],
    tile_shape: Tuple[int, int],
    stream_rows: int,
    k_cap: int = 4096,
    rw: int = 128,
    max_tiles_per_gaussian: int = 16,
    emission_budgets: Optional[Sequence[int]] = None,
    sat_margin: float = 0.0,
    sat_floor: int = 64,
    xy: Optional[torch.Tensor] = None,
    conic: Optional[torch.Tensor] = None,
    opacity: Optional[torch.Tensor] = None,
    visible_budget: int = 0,
) -> StreamLists:
    """The ragged pair stream (see :class:`StreamLists`).  The waterfill
    takes the largest row ceiling ``j*`` in ``0..k_cap/rw`` whose total
    fits ``stream_rows``, then hands the leftover rows, one each, to the
    tiles with the largest unmet need (ties in tile order; the JAX
    package's unstable argsort may break them otherwise)."""
    num_tiles = grid[0] * grid[1]
    n = depth.shape[0]
    if k_cap % rw:
        raise ValueError(f"stream_cap {k_cap} must be a multiple of {rw}")
    sp = _emit_sort_sat(
        rect_min, rect_max, valid, depth, grid, tile_shape,
        max_tiles_per_gaussian, emission_budgets, sat_margin, sat_floor,
        xy, conic, opacity, visible_budget,
    )
    counts, k_eff, starts = sp.counts, sp.k_eff, sp.starts
    dev = depth.device
    m = sp.s_gauss.shape[0]

    rows_need = -(-k_eff.clamp_max(k_cap) // rw)                        # [T]
    ceil_j = torch.arange(k_cap // rw + 1, device=dev)
    fill = torch.minimum(rows_need[None, :], ceil_j[:, None]).sum(1)    # [mrt+1]
    j_star = (fill <= stream_rows).sum() - 1
    rows_alloc = torch.minimum(rows_need, j_star)
    leftover = stream_rows - rows_alloc.sum()
    unmet = rows_need - rows_alloc
    order = torch.sort(-unmet, stable=True).indices
    extra = (torch.arange(num_tiles, device=dev) < leftover) & (unmet[order] > 0)
    rows_alloc = rows_alloc.clone()
    rows_alloc[order] += extra.long()
    k_alloc = torch.minimum(rows_alloc * rw, k_eff.clamp_max(k_cap))
    row_off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(rows_alloc, 0)])
    n_rows = row_off[-1]

    nr = int(n_rows)
    r_ids = torch.arange(nr, device=dev)
    tile_of_row = torch.searchsorted(row_off[1:], r_ids, right=True)
    base = (r_ids - row_off[tile_of_row]) * rw                          # [R]
    kept = torch.minimum(k_alloc, counts)
    lane = torch.arange(rw, device=dev)
    take = starts[tile_of_row][:, None] + base[:, None] + lane[None, :]
    ok = base[:, None] + lane[None, :] < kept[tile_of_row][:, None]
    sentinel = sp.v_budget if sp.v_budget else n
    s_gauss_pad = torch.cat([sp.s_gauss, torch.full((1,), sentinel, dtype=torch.int64,
                                                    device=dev)])
    idx = torch.where(ok, s_gauss_pad[take.clamp_max(m)], torch.full_like(take, sentinel))

    vis_ids, rank_of = _vis_fields(sp, n)
    return StreamLists(
        idx=idx,
        row_off=row_off.to(torch.int32),
        count=counts,
        k_eff=k_eff,
        k_alloc=k_alloc,
        n_refs=kept.sum(),
        n_rows=n_rows,
        n_dropped=sp.n_dropped_pre + (torch.minimum(k_eff, counts) - kept).clamp_min(0).sum(),
        n_sat_masked=sp.n_sat_masked,
        vis_ids=vis_ids,
        rank_of=rank_of,
    )
