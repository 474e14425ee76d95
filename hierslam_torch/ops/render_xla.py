"""Plain PyTorch tile blend (port of ``hierslam_tpu/ops/render_xla.py``).

This is the plain version of kernel K1 (``csrc/blend.cu``): the same
per-pixel math over depth-ordered slots, written as dense ``[tiles, P, K]``
tensor code.  ``alpha = min(0.99, opa exp(power))`` with the ``power > 0``
and ``alpha < 1/255`` skips; front-to-back transmittance as a cumulative
product; a contribution is committed while the transmittance after it
stays >= 1e-4 (a prefix property, since T only falls); the median depth is
the depth of the slot where T crosses 0.5 (15.0 if none).  Its autograd is
the oracle for the closed-form backward in ``ops/render_pallas.py``.

Also here, and called by neither plain blend: the plain version of the
forwards' per-warp footprint cull and pixel layout (``csrc/cull.cuh``):
:func:`thread_pixels`, :func:`warp_rects`, :func:`cull_mask`; and
:func:`rect_recheck_mask`, the current pose's rect test on cached lists.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_DONE = 1e-4
MEDIAN_DEFAULT = 15.0
# bound on the [tiles, P, K] elements one chunk of the plain blend holds
CHUNK_ELEMS = 1 << 24


def pixel_grid(tile_ids: torch.Tensor, tile_shape, grid_x: int):
    """Pixel centres [B, P] of the tiles ``tile_ids`` on a grid ``grid_x`` wide."""
    th, tw = tile_shape
    lin = torch.arange(th * tw, device=tile_ids.device)
    px = ((tile_ids % grid_x) * tw)[:, None] + lin[None, :] % tw
    py = ((tile_ids // grid_x) * th)[:, None] + lin[None, :] // tw
    return px.float(), py.float()


# the cull's widening (csrc/cull.cuh): on tau, then on each half-width
CULL_TAU = 1e-3
CULL_REL = 1.01
CULL_PX = 0.5
CULL_WILD = 1e9
# q's float32 rounding, taken off the conic's diagonal: 8u, u = 2^-24
CULL_Q_ROUND = 8.0 * 2.0 ** -24


def _blocks_wide(tile_shape) -> int:
    """8 x 4 pixel blocks in a row of the tile; the kernels take no tile
    that is not a multiple of 8 x 4 pixels."""
    th, tw = tile_shape
    if tw % 8 or th % 4:
        raise ValueError(f"tile {th} x {tw}: need a multiple of 4 x 8 pixels")
    return tw // 8


def thread_pixels(tile_shape) -> torch.Tensor:
    """[P] int64: the row-major pixel index ``y * tw + x`` of each thread of
    a K1/K3 block; thread ``32 w + l`` is lane ``l`` of warp ``w``, the 8 x 4
    pixel block at x = 8 (w % (tw / 8)), y = 4 (w / (tw / 8))."""
    th, tw = tile_shape
    bw = _blocks_wide(tile_shape)
    p = torch.arange(th * tw)
    w, l = p // 32, p % 32
    return (4 * (w // bw) + l // 8) * tw + 8 * (w % bw) + l % 8


def warp_rects(tile_shape) -> torch.Tensor:
    """[P / 32, 4] int64: the inclusive pixel rectangle (x0, x1, y0, y1),
    inside the tile, of each warp's 8 x 4 block."""
    th, tw = tile_shape
    bw = _blocks_wide(tile_shape)
    w = torch.arange(th * tw // 32)
    x0, y0 = 8 * (w % bw), 4 * (w // bw)
    return torch.stack([x0, x0 + 7, y0, y0 + 3], -1)


def conic_cov_diag(ca: torch.Tensor, cb: torch.Tensor, cc: torch.Tensor):
    """Plain version of ``csrc/cull.cuh::conic_box_diag``: the diagonal
    (cxx, cyy) of the covariance whose box holds every pixel that the
    blend's float32 quadratic form of the conic can take.  The conic loses
    ``CULL_Q_ROUND (max(a, c) + |b|)`` on its diagonal, which bounds that
    form's rounding, and is inverted with its determinant in float64 (the
    kernel: Kahan's form).  Infinite (live for every warp) where what is
    left is not positive definite."""
    eta = CULL_Q_ROUND * (torch.maximum(ca, cc) + cb.abs())
    a2, c2 = ca - eta, cc - eta
    det = (a2.double() * c2.double() - cb.double() * cb.double()).to(ca.dtype)
    inf = torch.full_like(det, float("inf"))
    pd = (det > 0.0) & (a2 > 0.0)
    return torch.where(pd, c2 / det, inf), torch.where(pd, a2 / det, inf)


def cull_mask(x, y, cxx, cyy, opa, tile_x0, tile_y0, tile_shape) -> torch.Tensor:
    """Plain version of ``csrc/cull.cuh::warp_mask``: for pairs with screen
    mean ``x, y``, covariance diagonal ``cxx, cyy`` and opacity ``opa``
    (any shape ``S``) seen from tiles whose first pixel is ``tile_x0,
    tile_y0`` (broadcast against ``S``), the warps ``[S..., P / 32]`` bool
    whose pixels the pair can reach.  A pixel takes a pair only if
    ``opa * exp(power) >= 1/255`` with ``power <= 0``, that is inside the
    ellipse ``q <= 2 ln(255 opa)``; a warp is live when the ellipse's box,
    widened by 1e-3 on tau and 1% and half a pixel on each half-width,
    meets its rectangle.  Conservative: NaN or infinite boxes are live for
    every warp; an opacity under 1/255 for none."""
    rects = warp_rects(tile_shape).to(x.device).float()
    tau = torch.log(255.0 * opa)
    tau = torch.where(tau < 0.0, torch.zeros_like(tau), tau) + CULL_TAU
    hx = torch.sqrt(2.0 * tau * cxx) * CULL_REL + CULL_PX
    hy = torch.sqrt(2.0 * tau * cyy) * CULL_REL + CULL_PX
    lx, ux = (x - hx - tile_x0)[..., None], (x + hx - tile_x0)[..., None]
    ly, uy = (y - hy - tile_y0)[..., None], (y + hy - tile_y0)[..., None]
    miss = (lx > rects[:, 1]) | (ux < rects[:, 0]) | (ly > rects[:, 3]) | (uy < rects[:, 2])
    tame = ((lx.abs() < CULL_WILD) & (ux.abs() < CULL_WILD) & (ly.abs() < CULL_WILD)
            & (uy.abs() < CULL_WILD))
    return (~miss | ~tame) & ~(opa < ALPHA_MIN)[..., None]


def blend_terms(tab: torch.Tensor, ok: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Per (tile, pixel, slot) blend quantities of a table chunk
    ``[B, K, 7+F]`` at pixels ``px, py [B, P]``."""
    dx = tab[:, None, :, 0] - px[:, :, None]
    dy = tab[:, None, :, 1] - py[:, :, None]
    ca, cb, cc = tab[:, None, :, 2], tab[:, None, :, 3], tab[:, None, :, 4]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp_max(tab[:, None, :, 5] * torch.exp(power), ALPHA_MAX)
    contrib = (power <= 0.0) & (alpha >= ALPHA_MIN) & ok[:, None, :]
    a = torch.where(contrib, alpha, torch.zeros_like(alpha))
    Ta = torch.cumprod(1.0 - a, dim=-1)
    Tb = torch.cat([torch.ones_like(Ta[..., :1]), Ta[..., :-1]], dim=-1)
    committed = Ta >= T_DONE
    w = a * Tb * committed
    return dx, dy, power, alpha, contrib, a, Ta, Tb, committed, w


def _feats(tab: torch.Tensor) -> torch.Tensor:
    """[B, K, F+2]: features, depth, ones."""
    dep = tab[..., 6:7]
    return torch.cat([tab[..., 7:], dep, torch.ones_like(dep)], dim=-1)


def tile_chunks(T: int, P: int, K: int):
    step = max(1, CHUNK_ELEMS // max(1, P * K))
    return [(lo, min(T, lo + step)) for lo in range(0, T, step)]


def blend_table(table: torch.Tensor, ok: torch.Tensor, grid_x: int,
                tile_shape: Tuple[int, int], tile_ids: Optional[torch.Tensor] = None,
                out=None):
    """table [T, K, 7+F], ok [T, K] bool -> (acc [T, P, F+2], final_T [T, P],
    median [T, P]).  Row b of the table is tile ``tile_ids[b]`` ([T]; tile b
    where None) of a grid ``grid_x`` tiles wide; with ``out`` (acc, final_T,
    median buffers of ``T_all`` rows, shared by the capacity classes of one
    render) row b's results are written to row ``tile_ids[b]`` of each and
    ``out`` is returned.  Differentiable by autograd."""
    T, K, _ = table.shape
    P = tile_shape[0] * tile_shape[1]
    ids = (torch.arange(T, device=table.device) if tile_ids is None
           else tile_ids.to(device=table.device, dtype=torch.int64))
    accs, fts, meds = [], [], []
    for lo, hi in tile_chunks(T, P, K):
        tab, okc = table[lo:hi], ok[lo:hi]
        px, py = pixel_grid(ids[lo:hi], tile_shape, grid_x)
        (_, _, _, _, contrib, _, Ta, Tb, committed, w) = blend_terms(tab, okc, px, py)
        accs.append(torch.einsum("bpk,bkc->bpc", w, _feats(tab)))
        fts.append(torch.where(committed, Ta, torch.ones_like(Ta)).amin(-1).clamp_max(1.0))
        crossing = contrib & committed & (Tb > 0.5) & (Ta < 0.5)
        dep = tab[:, None, :, 6].expand_as(Ta)
        med = torch.where(crossing, dep, torch.zeros_like(dep)).sum(-1)
        meds.append(torch.where(crossing.any(-1), med, torch.full_like(med, MEDIAN_DEFAULT)))
    res = torch.cat(accs), torch.cat(fts), torch.cat(meds)
    if out is None:
        return res
    for buf, x in zip(out, res):
        buf.index_copy_(0, ids, x)
    return out


def tiles_to_image(x: torch.Tensor, grid: Tuple[int, int], tile_shape, H: int, W: int):
    """[T, P, C] per-tile pixels -> [C, H, W]; [T, P] -> [H, W]."""
    gy, gx = grid
    th, tw = tile_shape
    if x.dim() == 2:
        x = x.reshape(gy, gx, th, tw).permute(0, 2, 1, 3)
        return x.reshape(gy * th, gx * tw)[:H, :W]
    C = x.shape[-1]
    x = x.reshape(gy, gx, th, tw, C).permute(4, 0, 2, 1, 3)
    return x.reshape(C, gy * th, gx * tw)[:, :H, :W]


def blend_tiles(g_xy, g_conic, g_opacity, g_depth, g_features, g_valid, *,
                image_shape, tile_shape, grid):
    """Composite all tiles from per-tile arrays ``[T, K, ...]``.  Returns
    ``(channels [F+2, H, W], final_T [H, W], median [H, W])``: the F
    feature channels, blended depth, and the blend mass."""
    H, W = image_shape
    table = torch.cat(
        [g_xy, g_conic, g_opacity[..., None], g_depth[..., None], g_features], -1
    )
    acc, ft, med = blend_table(table, g_valid, grid[1], tile_shape)
    return (tiles_to_image(acc, grid, tile_shape, H, W),
            tiles_to_image(ft, grid, tile_shape, H, W),
            tiles_to_image(med, grid, tile_shape, H, W))


def rect_recheck_mask(tile_idx: torch.Tensor, rect_min: torch.Tensor, rect_max: torch.Tensor,
                      valid: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
    """``[T, K]`` mask of the slots of cached lists ``tile_idx`` (-1 pad)
    whose gaussian is valid and whose current tile rect (``[N, 2]``
    ``rect_min`` inclusive, ``rect_max`` exclusive) covers the slot's tile."""
    grid_x = grid[1]
    t_ids = torch.arange(tile_idx.shape[0], device=tile_idx.device)
    tx = (t_ids % grid_x)[:, None]
    ty = (t_ids // grid_x)[:, None]
    safe = tile_idx.clamp_min(0)
    rmin, rmax = rect_min[safe], rect_max[safe]
    return ((tile_idx >= 0) & valid[safe]
            & (tx >= rmin[..., 0]) & (tx < rmax[..., 0])
            & (ty >= rmin[..., 1]) & (ty < rmax[..., 1]))
