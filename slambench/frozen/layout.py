"""The layout of the K2 and K4 calls' inputs, decoded to count the work they
need (``roofline.py``): a frozen copy of the program's plain helpers at
commit 2c704bc (``ops/render_xla.py``: ``blend_terms``, ``pixel_grid``,
``tile_chunks``; ``ops/render_stream.py``: ``project_pairs``,
``tile_view``, ``blend_view``, ``max_tile_pairs``), so that a later change
to the program cannot change what a call is counted to need.  Nothing
here decides ``correct``.
"""
from __future__ import annotations

from typing import Tuple

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_DONE = 1e-4
COL_LOGS = 3
COL_LOGIT = 4
COL_FEAT = 5
RW = 128          # pairs per stream row
CHUNK_ELEMS = 1 << 24   # bound on the [tiles, P, K] elements one chunk holds


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


def tile_chunks(T: int, P: int, K: int):
    step = max(1, CHUNK_ELEMS // max(1, P * K))
    return [(lo, min(T, lo + step)) for lo in range(0, T, step)]


def project_pairs(tab: torch.Tensor, sc: torch.Tensor, tile_x, tile_y, img_w: float,
                  img_h: float, tile_shape: Tuple[int, int]):
    """Plain form of the kernels' per-pair projection (JAX ``_project_row``
    and ``_screen_quantities``): raw pairs ``[..., 5+F]`` seen from tile
    ``(tile_x, tile_y)`` (broadcast against ``tab[..., 0]``) -> screen x, y,
    conic a, b, c, opacity, camera depth, the valid mask (in front,
    det != 0, rect overlaps the tile) and the covariance diagonal cxx, cyy
    that K3's footprint cull reads.  Differentiable in ``tab``; written
    in the kernels' operation order."""
    th, tw = tile_shape
    mx, my, mz = tab[..., 0], tab[..., 1], tab[..., 2]
    logs, logit = tab[..., COL_LOGS], tab[..., COL_LOGIT]
    mcx = sc[0] * mx + sc[1] * my + sc[2] * mz + sc[9]
    mcy = sc[3] * mx + sc[4] * my + sc[5] * mz + sc[10]
    mcz = sc[6] * mx + sc[7] * my + sc[8] * mz + sc[11]
    ph_x = sc[12] * mcx + sc[13] * mcy + sc[14] * mcz + sc[15]
    ph_y = sc[16] * mcx + sc[17] * mcy + sc[18] * mcz + sc[19]
    ph_w = sc[20] * mcx + sc[21] * mcy + sc[22] * mcz + sc[23]
    p_w = 1.0 / (ph_w + 1e-7)
    px = ((ph_x * p_w + 1.0) * img_w - 1.0) * 0.5
    py = ((ph_y * p_w + 1.0) * img_h - 1.0) * 0.5

    fx, fy, limx, limy = sc[24], sc[25], sc[26], sc[27]
    safe_z = torch.where(mcz == 0.0, torch.ones_like(mcz), mcz)
    inv_z = 1.0 / safe_z
    txc = torch.clamp(mcx * inv_z, min=-limx, max=limx)
    tyc = torch.clamp(mcy * inv_z, min=-limy, max=limy)
    j00 = fx * inv_z
    j02 = -fx * txc * inv_z
    j11 = fy * inv_z
    j12 = -fy * tyc * inv_z
    s = torch.exp(logs)
    s2 = s * s
    c_xx = s2 * (j00 * j00 + j02 * j02) + 0.3
    c_xy = s2 * (j02 * j12)
    c_yy = s2 * (j11 * j11 + j12 * j12) + 0.3
    det = c_xx * c_yy - c_xy * c_xy
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    ca = c_yy * det_inv
    cb = -c_xy * det_inv
    cc = c_xx * det_inv

    with torch.no_grad():
        mid = 0.5 * (c_xx + c_yy)
        sq = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + sq, mid - sq)))
        pxd, pyd = px.detach(), py.detach()
        rminx = torch.floor((pxd - radius) / tw)
        rminy = torch.floor((pyd - radius) / th)
        rmaxx = torch.floor((pxd + radius + tw - 1) / tw)
        rmaxy = torch.floor((pyd + radius + th - 1) / th)
        rect_ok = (tile_x >= rminx) & (tile_x < rmaxx) & (tile_y >= rminy) & (tile_y < rmaxy)
        valid = (mcz > 0.2) & det_ok & rect_ok
    return dict(px=px, py=py, ca=ca, cb=cb, cc=cc, opa=torch.sigmoid(logit), dep=mcz,
                valid=valid, cxx=c_xx, cyy=c_yy)


def tile_view(flat: torch.Tensor, row_off: torch.Tensor, lo: int, hi: int, k_max: int):
    """Tiles lo..hi of the flat stream as a padded view: stream positions
    [B, k_max] and the mask of those inside each tile's rows."""
    ro = row_off.long()
    start = ro[lo:hi] * RW
    n = (ro[lo + 1:hi + 1] - ro[lo:hi]) * RW
    k = torch.arange(k_max, device=flat.device)
    pos = start[:, None] + k[None, :]
    inside = k[None, :] < n[:, None]
    return torch.where(inside, pos, torch.zeros_like(pos)), inside


def blend_view(tab, inside, sc, tids, grid_x, tile_shape, n_feat, img_shape):
    """Project and blend one padded chunk ``tab [B, K, 5+F]`` of tiles
    ``tids``: (ladder table [B, K, 7+F], ``render_xla.blend_terms``,
    blended features [B, K, F+2])."""
    img_h, img_w = img_shape
    tx = (tids % grid_x).float()[:, None]
    ty = (tids // grid_x).float()[:, None]
    q = project_pairs(tab, sc, tx, ty, float(img_w), float(img_h), tile_shape)
    ladder = torch.cat([torch.stack([q["px"], q["py"], q["ca"], q["cb"], q["cc"], q["opa"],
                                     q["dep"]], -1), tab[..., COL_FEAT:COL_FEAT + n_feat]], -1)
    px, py = pixel_grid(tids, tile_shape, grid_x)
    terms = blend_terms(ladder, q["valid"] & inside, px, py)
    feats = torch.cat([ladder[..., 7:], ladder[..., 6:7], torch.ones_like(ladder[..., 6:7])], -1)
    return ladder, terms, feats


def max_tile_pairs(row_off: torch.Tensor) -> int:
    """Pair slots of the longest tile (a host sync)."""
    ro = row_off.long()
    n = ro[1:] - ro[:-1]
    return int(n.max()) * RW if n.numel() else 0
