"""Pose-only rendering for camera tracking (port of ``hierslam_tpu/ops/render_tracked.py``).

While tracking, the map is frozen and only the 7-dof pose moves.  The
frame binning and the per-slot raw attributes (world mean, color, opacity
and shape) are gathered once per frame at the propagated pose, with a
pixel margin for the in-frame drift; each iteration then only transforms
the cached means, projects them per slot, re-applies the exact
current-pose rect and frustum test, and blends.  Gradients reduce straight
to the pose.  The shape of an isotropic map is one scale a slot
(``cov2d = s^2 J J^T + 0.3 I``); of an anisotropic one the frame-constant
world covariance ``R s s^T R^T`` as six upper-triangle entries, folded
with the current rotation ``W`` as ``(J W) S (J W)^T + 0.3 I``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from hierslam_torch.core import transforms
from hierslam_torch.ops import projection
from hierslam_torch.ops.rasterize import RasterConfig, _assemble_buckets, compute_binning
from hierslam_torch.ops.render_pallas import render_tiles_pallas


class TrackCache(NamedTuple):
    tile_ids: Tuple[torch.Tensor, ...]     # per class: [n_b] true tile ids
    means_world: Tuple[torch.Tensor, ...]  # [n_b, k_b, 3]
    colors: Tuple[torch.Tensor, ...]       # [n_b, k_b, 3]
    opacity: Tuple[torch.Tensor, ...]      # [n_b, k_b] post-sigmoid
    # isotropic: [n_b, k_b] post-exp scale; anisotropic: [n_b, k_b, 6] world
    # covariance (xx, xy, xz, yy, yz, zz)
    scale: Tuple[torch.Tensor, ...]
    slot_valid: Tuple[torch.Tensor, ...]   # [n_b, k_b]
    count: torch.Tensor                    # [T] true overlap counts
    radii0: torch.Tensor                   # [N] radii at the cache pose
    n_dropped: torch.Tensor


@torch.no_grad()
def build_track_cache(params, active, q0, t0, camera, config: RasterConfig,
                      margin_px: float = 12.0) -> TrackCache:
    """Bin + gather the frame-constant attributes at the initial pose."""
    aniso = params["log_scales"].shape[1] == 3
    means_cam0, rots_cam0 = transforms.transform_to_frame(
        params["means3D"], params["unnorm_rotations"], q0, t0,
        gaussians_grad=False, camera_grad=False, transform_rots=aniso,
    )
    scales = torch.exp(params["log_scales"])
    opac = torch.sigmoid(params["logit_opacities"])
    b = compute_binning(means_cam0, scales, rots_cam0, camera, config,
                        active=active, margin_px=margin_px, opacities=opac)
    if aniso:
        cov = projection.quat_scale_to_cov3d(params["unnorm_rotations"], scales,
                                             camera.scale_modifier)
        shape_cols = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    else:
        shape_cols = scales[:, :1]
    table = torch.cat([params["means3D"], params["rgb_colors"], opac, shape_cols], 1)
    mw, cols, opas, scs, valids = [], [], [], [], []
    for idx in b.lists.idx:
        safe = idx.clamp_min(0)
        valid = idx >= 0
        if active is not None:
            valid = valid & active[safe]
        g = table[safe]
        mw.append(g[..., 0:3])
        cols.append(g[..., 3:6])
        opas.append(torch.where(valid, g[..., 6], torch.zeros_like(g[..., 6])))
        scs.append(g[..., 7:13] if aniso else g[..., 7])
        valids.append(valid)
    prep0 = projection.preprocess(means_cam0, scales, rots_cam0, camera,
                                  config.tile_shape, active=active)
    return TrackCache(
        tile_ids=tuple(b.lists.tile_ids), means_world=tuple(mw),
        colors=tuple(cols), opacity=tuple(opas), scale=tuple(scs),
        slot_valid=tuple(valids), count=b.lists.count, radii0=prep0.radius,
        n_dropped=b.lists.n_dropped,
    )


def render_tracked(cache: TrackCache, q: torch.Tensor, t: torch.Tensor, camera,
                   config: RasterConfig):
    """Render at pose (q, t) from the cache: (im [3,H,W], depth, median,
    final_opacity, mask)."""
    H, W = camera.height, camera.width
    th, tw = config.tile_shape
    grid = config.grid(H, W)
    grid_x = grid[1]
    w2c = transforms.build_w2c(transforms.normalize(q), t)
    full = torch.as_tensor(np.asarray(camera.full_proj), dtype=torch.float32, device=q.device)
    fx, fy = camera.focal_x, camera.focal_y
    limx, limy = 1.3 * camera.tan_fovx, 1.3 * camera.tan_fovy

    strips_acc, ids_list = [], []
    for bi, ids_b in enumerate(cache.tile_ids):
        nb = ids_b.shape[0]
        if nb == 0:
            continue
        m = cache.means_world[bi] @ w2c[:3, :3].T + w2c[:3, 3]   # [n_b, K, 3]
        z = m[..., 2]
        in_front = z > 0.2
        p_hom = m @ full[:, :3].T + full[:, 3]
        p_w = 1.0 / (p_hom[..., 3] + 1e-7)
        x = ((p_hom[..., 0] * p_w + 1.0) * W - 1.0) * 0.5
        y = ((p_hom[..., 1] * p_w + 1.0) * H - 1.0) * 0.5

        safe_z = torch.where(z == 0, torch.ones_like(z), z)
        inv_z = 1.0 / safe_z
        txc = torch.clamp(m[..., 0] * inv_z, -limx, limx)
        tyc = torch.clamp(m[..., 1] * inv_z, -limy, limy)
        jxx = fx * inv_z
        jyy = fy * inv_z
        jxz = -fx * txc * inv_z
        jyz = -fy * tyc * inv_z
        sc = cache.scale[bi]
        if sc.dim() == 3:
            Wm = w2c[:3, :3]
            t0 = [jxx * Wm[0, c] + jxz * Wm[2, c] for c in range(3)]
            t1 = [jyy * Wm[1, c] + jyz * Wm[2, c] for c in range(3)]
            S = [[sc[..., 0], sc[..., 1], sc[..., 2]],
                 [sc[..., 1], sc[..., 3], sc[..., 4]],
                 [sc[..., 2], sc[..., 4], sc[..., 5]]]
            a0 = [t0[0] * S[0][c] + t0[1] * S[1][c] + t0[2] * S[2][c] for c in range(3)]
            b1 = [t1[0] * S[0][c] + t1[1] * S[1][c] + t1[2] * S[2][c] for c in range(3)]
            c_xx = a0[0] * t0[0] + a0[1] * t0[1] + a0[2] * t0[2] + 0.3
            c_xy = a0[0] * t1[0] + a0[1] * t1[1] + a0[2] * t1[2]
            c_yy = b1[0] * t1[0] + b1[1] * t1[1] + b1[2] * t1[2] + 0.3
        else:
            s2 = sc * sc
            c_xx = s2 * (jxx * jxx + jxz * jxz) + 0.3
            c_xy = s2 * (jxz * jyz)
            c_yy = s2 * (jyy * jyy + jyz * jyz) + 0.3
        det = c_xx * c_yy - c_xy * c_xy
        det_ok = det != 0.0
        det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
        conic = torch.stack([c_yy * det_inv, -c_xy * det_inv, c_xx * det_inv], -1)

        with torch.no_grad():
            mid = 0.5 * (c_xx + c_yy)
            sq = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
            radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + sq, mid - sq)))
            xn, yn = x.detach(), y.detach()
            btx = (ids_b % grid_x)[:, None].float()
            bty = (ids_b // grid_x)[:, None].float()
            rect_ok = (
                (btx >= torch.floor((xn - radius) / tw))
                & (btx < torch.floor((xn + radius + tw - 1) / tw))
                & (bty >= torch.floor((yn - radius) / th))
                & (bty < torch.floor((yn + radius + th - 1) / th))
            )
            valid = cache.slot_valid[bi] & in_front & det_ok & rect_ok
        opa = torch.where(valid, cache.opacity[bi], torch.zeros_like(cache.opacity[bi]))

        j = torch.arange(nb, dtype=torch.float32, device=q.device)[:, None]
        x = x + (j - btx) * tw
        y = y - bty * th
        table = torch.cat([x[..., None], y[..., None], conic, opa[..., None],
                           z[..., None], cache.colors[bi]], -1)
        acc_b, ft_b, med_b = render_tiles_pallas(
            table, valid, image_shape=(th, nb * tw), tile_shape=config.tile_shape,
            grid=(1, nb),
        )
        strips_acc.append(torch.cat([acc_b, ft_b[None], med_b[None]], 0))
        ids_list.append(ids_b)

    merged = _assemble_buckets(strips_acc, ids_list, grid, config.tile_shape, H, W)
    acc, ft, med = merged[:-2], merged[-2], merged[-1]
    return acc[:3], acc[-2], med, 1.0 - ft, acc[-1]
