"""The ragged pair-stream blend (port of ``hierslam_tpu/ops/render_stream.py``).

The mapper renders straight from raw Gaussian attributes: one gather of
the packed parameter table per iteration gives the pair stream
``[R, 128, 5+F]`` (pair-major, the natural output of the gather), and the
projection -- world to camera, near cull, EWA covariance with the clamped
Jacobian, conic, radius, the exact rect test against the tile, sigmoid --
happens per pair inside the blend, with the pose as 28 scalars on the
device.  Tile ``t`` owns the stream rows ``row_off[t]..row_off[t+1]``
(``ops/binning.bin_stream``).

``blend_stream`` is a ``torch.autograd.Function``.  On CUDA tensors its
forward launches kernel K3 and its backward kernel K4 (``csrc/stream.cu``,
via ``ops/kernels.py``).  On CPU tensors the forward is
:func:`blend_stream_fwd_plain` (each tile's rows laid out as a padded
``[tiles, k_max, 5+F]`` view, projected by :func:`project_pairs`, then the
plain ladder blend of ``ops/render_xla.py``) and the backward
:func:`blend_stream_bwd_plain` (autograd through that forward, one chunk of
tiles at a time).  A CUDA tensor never takes the plain path.

Stream columns: 0:3 world mean, 3 isotropic log scale, 4 opacity logit,
5:5+F features (rgb, then the semantic embedding).  Pad pairs point at a
sentinel row appended to the table (zeros, logit -100): they blend to
nothing and route no gradient.  Left out of the TPU version, because they
guard nothing on a GPU: the columns-first ``[R, Cp, 128]`` layout and its
padding, the DMA double buffer, the VMEM row bound, the triangular-matmul
cumsum and the aliased zero buffer.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hierslam_torch.ops import binning, kernels, projection
from hierslam_torch.ops.gather_vjp import InverseMap, build_inverse_map, gather_rows
from hierslam_torch.ops.render_xla import blend_terms, pixel_grid, tile_chunks, tiles_to_image

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_DONE = 1e-4
MEDIAN_DEFAULT = 15.0

COL_MEAN = 0
COL_LOGS = 3
COL_LOGIT = 4
COL_FEAT = 5
SENTINEL_LOGIT = -100.0

RW = 128          # pairs per stream row
N_SCALARS = 28

# calls of the plain versions (a main-path run on the card keeps both at 0)
plain_counts = {"blend_stream_fwd_plain": 0, "blend_stream_bwd_plain": 0}

_camera_consts = {}


def _camera_constants(camera, device) -> torch.Tensor:
    """full_proj rows 0, 1, 3 and (fx, fy, 1.3 tan fovx, 1.3 tan fovy) on
    ``device``, made once per camera and device: a copy from host memory
    on every iteration would wait for the device."""
    full = np.asarray(camera.full_proj, np.float32)
    extra = np.asarray([camera.focal_x, camera.focal_y, 1.3 * camera.tan_fovx,
                        1.3 * camera.tan_fovy], np.float32)
    vals = np.concatenate([full[0], full[1], full[3], extra])
    key = (vals.tobytes(), str(device))
    if key not in _camera_consts:
        _camera_consts[key] = torch.as_tensor(vals, device=device)
    return _camera_consts[key]


def make_scalars(w2c: torch.Tensor, camera) -> torch.Tensor:
    """The kernels' 28 scalars, built on ``w2c``'s device: R (row-major, 9),
    t (3), full_proj rows 0, 1, 3 (12), fx, fy, 1.3 tan fovx, 1.3 tan fovy."""
    w2c = w2c.float()
    return torch.cat([w2c[:3, :3].reshape(-1), w2c[:3, 3],
                      _camera_constants(camera, w2c.device)]).contiguous()


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


def pack_table(params, sem_w: int) -> torch.Tensor:
    """The ``[N, 5+F]`` stream table of a parameter dict (mean, log scale,
    opacity logit, rgb, then ``sem_w`` semantic columns); keeps autograd."""
    cols = [params["means3D"], params["log_scales"][:, :1], params["logit_opacities"][:, :1],
            params["rgb_colors"]] + ([params["semantic"]] if sem_w else [])
    return torch.cat([c.float() for c in cols], 1)


def unpack_table(table: torch.Tensor, sem_w: int):
    """The parameter columns of a stream table."""
    out = {"means3D": table[:, COL_MEAN:COL_MEAN + 3],
           "log_scales": table[:, COL_LOGS:COL_LOGS + 1],
           "logit_opacities": table[:, COL_LOGIT:COL_LOGIT + 1],
           "rgb_colors": table[:, COL_FEAT:COL_FEAT + 3]}
    if sem_w:
        out["semantic"] = table[:, COL_FEAT + 3:COL_FEAT + 3 + sem_w]
    return out


def set_logit(table: torch.Tensor, rows: torch.Tensor, value: float) -> torch.Tensor:
    """``table`` with its opacity-logit column set to ``value`` on ``rows``
    (the sentinel marks a removed row)."""
    col = torch.arange(table.shape[1], device=table.device) == COL_LOGIT
    return torch.where(rows[:, None] & col[None, :], torch.full_like(table, value), table)


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


def blend_stream_fwd_plain(stream: torch.Tensor, scalars: torch.Tensor, row_off: torch.Tensor,
                           grid: Tuple[int, int], tile_shape: Tuple[int, int], n_feat: int,
                           img_shape: Tuple[int, int]):
    """Plain version of K3: (acc [T, P, F+2], final_T [T, P], median [T, P])."""
    plain_counts["blend_stream_fwd_plain"] += 1
    T = row_off.shape[0] - 1
    P = tile_shape[0] * tile_shape[1]
    dev = stream.device
    flat = stream.reshape(-1, stream.shape[-1])
    k_max = max_tile_pairs(row_off)
    if k_max == 0:
        return (torch.zeros((T, P, n_feat + 2), device=dev), torch.ones((T, P), device=dev),
                torch.full((T, P), MEDIAN_DEFAULT, device=dev))
    accs, fts, meds = [], [], []
    for lo, hi in tile_chunks(T, P, k_max):
        pos, inside = tile_view(flat, row_off, lo, hi, k_max)
        ladder, terms, feats = blend_view(flat[pos], inside, scalars,
                                            torch.arange(lo, hi, device=dev), grid[1],
                                            tile_shape, n_feat, img_shape)
        (_, _, _, _, contrib, _, Ta, Tb, committed, w) = terms
        accs.append(torch.einsum("bpk,bkc->bpc", w, feats))
        fts.append(torch.where(committed, Ta, torch.ones_like(Ta)).amin(-1).clamp_max(1.0))
        crossing = contrib & committed & (Tb > 0.5) & (Ta < 0.5)
        dep = ladder[:, None, :, 6].expand_as(Ta)
        med = torch.where(crossing, dep, torch.zeros_like(dep)).sum(-1)
        meds.append(torch.where(crossing.any(-1), med, torch.full_like(med, MEDIAN_DEFAULT)))
    return torch.cat(accs), torch.cat(fts), torch.cat(meds)


def blend_stream_bwd_plain(stream: torch.Tensor, scalars: torch.Tensor, row_off: torch.Tensor,
                           gacc: torch.Tensor, gft: torch.Tensor, gmed: torch.Tensor,
                           grid: Tuple[int, int], tile_shape: Tuple[int, int], n_feat: int,
                           img_shape: Tuple[int, int],
                           mpos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K4: the cotangent of the stream ``[R, 128, 5+F]``,
    by autograd through :func:`blend_stream_fwd_plain` one chunk of tiles
    at a time.  The median cotangent goes to the pair where the plain
    forward's T crosses 0.5, or, given ``mpos`` (K3's median positions,
    -1 for none), to that pair."""
    plain_counts["blend_stream_bwd_plain"] += 1
    T = row_off.shape[0] - 1
    P = tile_shape[0] * tile_shape[1]
    dev = stream.device
    flat = stream.reshape(-1, stream.shape[-1]).detach()
    dflat = torch.zeros_like(flat)
    k_max = max_tile_pairs(row_off)
    for lo, hi in (tile_chunks(T, P, k_max) if k_max else []):
        pos, inside = tile_view(flat, row_off, lo, hi, k_max)
        with torch.enable_grad():
            tab = flat[pos].requires_grad_(True)
            ladder, terms, feats = blend_view(tab, inside, scalars,
                                                torch.arange(lo, hi, device=dev), grid[1],
                                                tile_shape, n_feat, img_shape)
            (_, _, _, _, contrib, _, Ta, Tb, committed, w) = terms
            acc = torch.einsum("bpk,bkc->bpc", w, feats)
            ft = torch.where(committed, Ta, torch.ones_like(Ta)).amin(-1).clamp_max(1.0)
            dep = ladder[..., 6]                                  # [B, K]
            if mpos is None:
                crossing = contrib & committed & (Tb > 0.5) & (Ta < 0.5)
                med = (crossing * dep[:, None, :]).sum(-1)
            else:
                k_med = mpos[lo:hi].long() - row_off[lo:hi].long()[:, None] * RW
                has = k_med >= 0
                med = torch.gather(dep, 1, k_med.clamp_min(0)) * has
            loss = ((acc * gacc[lo:hi]).sum() + (ft * gft[lo:hi]).sum()
                    + (med * gmed[lo:hi]).sum())
            (g,) = torch.autograd.grad(loss, tab)
        dflat[pos[inside]] = g[inside]
    return dflat.reshape(stream.shape)


class _BlendStream(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stream, scalars, row_off, grid, tile_shape, n_feat, img_shape):
        ctx.meta = (grid, tile_shape, n_feat, img_shape)
        if stream.is_cuda:
            acc, ft, med, last, mpos = kernels.stream_fwd(stream, scalars, row_off, grid[1],
                                                          tile_shape, n_feat, img_shape)
            ctx.save_for_backward(stream, scalars, row_off, ft, last, mpos)
        else:
            acc, ft, med = blend_stream_fwd_plain(stream, scalars, row_off, grid, tile_shape,
                                                  n_feat, img_shape)
            ctx.save_for_backward(stream, scalars, row_off)
        return acc, ft, med

    @staticmethod
    def backward(ctx, gacc, gft, gmed):
        grid, tile_shape, n_feat, img_shape = ctx.meta
        gacc, gft, gmed = (g.contiguous() for g in (gacc, gft, gmed))
        if ctx.saved_tensors[0].is_cuda:
            stream, scalars, row_off, ft, last, mpos = ctx.saved_tensors
            dstream = kernels.stream_bwd(stream, scalars, row_off, ft, last, mpos, gacc, gft,
                                         gmed, grid[1], tile_shape, n_feat, img_shape)
        else:
            stream, scalars, row_off = ctx.saved_tensors
            dstream = blend_stream_bwd_plain(stream, scalars, row_off, gacc, gft, gmed, grid,
                                             tile_shape, n_feat, img_shape)
        return dstream, None, None, None, None, None, None


def blend_stream(stream: torch.Tensor, scalars: torch.Tensor, row_off: torch.Tensor,
                 grid: Tuple[int, int], tile_shape: Tuple[int, int], n_feat: int,
                 img_shape: Tuple[int, int]):
    """Streamed ragged blend: stream [R, 128, 5+F], scalars [28] from
    :func:`make_scalars`, row_off [T+1] int32, img_shape (projection height,
    width) -> (acc [T, P, F+2], final_T [T, P], median [T, P]).
    Differentiable in ``stream``; the pose gets no gradient."""
    return _BlendStream.apply(stream.contiguous(), scalars.detach().contiguous(),
                              row_off.to(torch.int32).contiguous(), tuple(grid),
                              tuple(tile_shape), int(n_feat), tuple(img_shape))


class StreamBinning(NamedTuple):
    """Amortized stream binning of one window frame: the ragged lists and
    the gather's inverse map over the table and its sentinel row (whose
    references sort with the pads and get no run)."""

    lists: binning.StreamLists
    inverse: InverseMap


@torch.no_grad()
def compute_stream_binning(means_cam, scales, rotations, camera, config, active=None,
                           margin_px: float = 0.0, opacities=None,
                           compact: bool = False) -> StreamBinning:
    """Ragged stream lists and their inverse map at the given camera-frame
    means (the stream analogue of ``ops/rasterize.compute_binning``)."""
    prep = projection.preprocess(means_cam, scales, rotations, camera, config.tile_shape,
                                 active=active, radius_margin_px=margin_px)
    grid = config.grid(camera.height, camera.width)
    if opacities is not None and opacities.dim() == 2:
        opacities = opacities[:, 0]
    sat = config.sat_margin > 0.0 and opacities is not None
    lists = binning.bin_stream(
        prep.rect_min, prep.rect_max, prep.valid, prep.depth, grid, config.tile_shape,
        stream_rows=config.stream_rows_for(grid), k_cap=config.stream_cap,
        max_tiles_per_gaussian=config.max_tiles_per_gaussian,
        sat_margin=config.sat_margin if sat else 0.0, sat_floor=config.sat_floor,
        xy=prep.xy if sat else None, conic=prep.conic if sat else None,
        opacity=opacities if sat else None,
        visible_budget=config.visible_budget if compact else 0,
    )
    n_rows = lists.vis_ids.shape[0] if lists.vis_ids is not None else means_cam.shape[0]
    return StreamBinning(lists, build_inverse_map(lists.idx, n_rows + 1, num_real=n_rows))


def sentinel_row(width: int, device=None) -> torch.Tensor:
    """The row pad pairs point at: zeros with the opacity logit at -100."""
    row = torch.zeros((1, width), dtype=torch.float32, device=device)
    row[0, COL_LOGIT] = SENTINEL_LOGIT
    return row


def render_from_table(table: torch.Tensor, b: StreamBinning, w2c: torch.Tensor, camera, config,
                      n_feat: int):
    """Render the ragged stream from a raw-attribute table ``[V, 5+F]``
    (no sentinel row: it is appended here; compacted to the binning's
    visible prefix if the binning was).  Differentiable in ``table``.
    Returns (channels [F+2, H, W], final_T [H, W], median [H, W])."""
    H, W = camera.height, camera.width
    grid = config.grid(H, W)
    c_used = COL_FEAT + n_feat
    table_s = torch.cat([table[:, :c_used], sentinel_row(c_used, table.device)], 0)
    stream = gather_rows(table_s, b.lists.idx, c_used, config.grad_pair_budget,
                         config.grad_bf16, b.inverse)
    scalars = make_scalars(w2c.detach(), camera)
    proj_h = camera.proj_height or H
    acc, ft, med = blend_stream(stream, scalars, b.lists.row_off, grid, config.tile_shape,
                                n_feat, (proj_h, W))
    return assemble_stream(acc, ft, med, grid, config.tile_shape, (H, W))


def assemble_stream(acc, ft, med, grid, tile_shape, image_shape):
    """[T, P, C] per-tile outputs -> ([C, H, W], [H, W], [H, W])."""
    H, W = image_shape
    return (tiles_to_image(acc, grid, tile_shape, H, W),
            tiles_to_image(ft, grid, tile_shape, H, W),
            tiles_to_image(med, grid, tile_shape, H, W))
