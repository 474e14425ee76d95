"""Pose-only rendering for camera tracking (port of ``hierslam_tpu/ops/render_tracked.py``).

While tracking, the map is frozen and only the 7-dof pose moves.  The
frame binning and the per-slot raw attributes (world mean, color, opacity
and shape) are gathered once per frame at the propagated pose, with a
pixel margin for the in-frame drift; each iteration then only transforms
the cached means, projects them per slot (every class's slots in one
pass, ``TrackCache.run``), re-applies the exact current-pose rect and
frustum test, and blends every class at its true
tile ids and screen coordinates into buffers the classes share
(``render_pallas.blend_classes``).  Gradients reduce straight to the
pose.  The frame's lists drop no pair under one configured class
(``track_max_per_tile``): that class is the least, and tiles that hold
more pairs take classes of twice, four times ... its slots, sized from
the tiles' counts read once to the host (:func:`track_lists`).  The
shape of an isotropic map is one scale a slot
(``cov2d = s^2 J J^T + 0.3 I``); of an anisotropic one the frame-constant
world covariance ``R s s^T R^T`` as six upper-triangle entries, folded
with the current rotation ``W`` as ``(J W) S (J W)^T + 0.3 I``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from hierslam_torch.core import transforms
from hierslam_torch.ops import binning, projection
from hierslam_torch.ops.rasterize import RasterConfig
from hierslam_torch.ops.render_pallas import blend_classes
from hierslam_torch.ops.render_xla import tiles_to_image


class TrackSlots(NamedTuple):
    """Every class's slots in one run, class after class, each class's
    [n_b, k_b] row-major: S slots in all."""

    means_world: torch.Tensor              # [S, 3]
    colors: torch.Tensor                   # [S, 3]
    opacity: torch.Tensor                  # [S] post-sigmoid, 0 on an invalid slot
    # isotropic: [S] post-exp scale; anisotropic: [S, 6] world covariance
    # (xx, xy, xz, yy, yz, zz)
    scale: torch.Tensor
    valid: torch.Tensor                    # [S]
    tile_xy: torch.Tensor                  # [S, 2] float32: the slot's tile column, row


class TrackCache(NamedTuple):
    tile_ids: Tuple[torch.Tensor, ...]     # per class: [n_b] int32 true tile ids
    # per class, views of ``run``'s slots:
    means_world: Tuple[torch.Tensor, ...]  # [n_b, k_b, 3]
    colors: Tuple[torch.Tensor, ...]       # [n_b, k_b, 3]
    opacity: Tuple[torch.Tensor, ...]      # [n_b, k_b]
    scale: Tuple[torch.Tensor, ...]        # [n_b, k_b] or [n_b, k_b, 6]
    slot_valid: Tuple[torch.Tensor, ...]   # [n_b, k_b]
    run: TrackSlots                        # the same slots in one run
    count: torch.Tensor                    # [T] true overlap counts
    radii0: torch.Tensor                   # [N] radii at the cache pose
    n_dropped: torch.Tensor
    # host integers of the binning (binning.bin_to_need): pairs, slots,
    # classes, tiles, pairs_dropped
    counters: Dict[str, int]


def track_lists(prep: projection.Preprocessed, grid, config: RasterConfig, opacities):
    """The tracker's tile lists: the config's one class as the least of
    classes sized from the tiles' counts, so that no pair is dropped, or
    its ladder as given (``binning.bin_to_need``) -> (lists, counters)."""
    sat = config.sat_margin > 0.0
    return binning.bin_to_need(
        prep.rect_min, prep.rect_max, prep.valid, prep.depth, grid, config.spec(),
        config.tile_shape, max_tiles_per_gaussian=config.max_tiles_per_gaussian,
        sat_margin=config.sat_margin if sat else 0.0, sat_floor=config.sat_floor,
        xy=prep.xy if sat else None, conic=prep.conic if sat else None,
        opacity=opacities if sat else None,
    )


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
    prep = projection.preprocess(means_cam0, scales, rots_cam0, camera, config.tile_shape,
                                 active=active, radius_margin_px=margin_px)
    lists, counters = track_lists(prep, config.grid(camera.height, camera.width), config,
                                  opac[:, 0])
    if aniso:
        cov = projection.quat_scale_to_cov3d(params["unnorm_rotations"], scales,
                                             camera.scale_modifier)
        shape_cols = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    else:
        shape_cols = scales[:, :1]
    table = torch.cat([params["means3D"], params["rgb_colors"], opac, shape_cols], 1)
    idx = torch.cat([i.reshape(-1) for i in lists.idx])
    safe = idx.clamp_min(0)
    valid = idx >= 0
    if active is not None:
        valid = valid & active[safe]
    g = table[safe]
    shapes = [tuple(i.shape) for i in lists.idx]
    tile = torch.cat([ids.repeat_interleave(k) for ids, (_, k) in zip(lists.tile_ids, shapes)])
    grid_x = config.grid(camera.height, camera.width)[1]
    prep0 = projection.preprocess(means_cam0, scales, rots_cam0, camera,
                                  config.tile_shape, active=active)
    run = TrackSlots(means_world=g[:, 0:3], colors=g[:, 3:6],
                     opacity=torch.where(valid, g[:, 6], torch.zeros_like(g[:, 6])),
                     scale=g[:, 7:13] if aniso else g[:, 7], valid=valid,
                     tile_xy=torch.stack([tile % grid_x, tile // grid_x], 1).float())
    sizes = [n * k for n, k in shapes]

    def per_class(x):
        return tuple(v.view(*shape, *x.shape[1:]) for v, shape in zip(x.split(sizes), shapes))
    return TrackCache(
        tile_ids=tuple(i.to(torch.int32) for i in lists.tile_ids),
        means_world=per_class(run.means_world), colors=per_class(run.colors),
        opacity=per_class(run.opacity), scale=per_class(run.scale),
        slot_valid=per_class(run.valid), run=run, count=lists.count, radii0=prep0.radius,
        n_dropped=lists.n_dropped, counters=counters,
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

    # every slot of every class at once; the classes part only to be blended
    run = cache.run
    m = run.means_world @ w2c[:3, :3].T + w2c[:3, 3]   # [S, 3]
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
    sc = run.scale
    if sc.dim() == 2:
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
        btx, bty = run.tile_xy[:, 0], run.tile_xy[:, 1]
        rect_ok = (
            (btx >= torch.floor((xn - radius) / tw))
            & (btx < torch.floor((xn + radius + tw - 1) / tw))
            & (bty >= torch.floor((yn - radius) / th))
            & (bty < torch.floor((yn + radius + th - 1) / th))
        )
        valid = run.valid & in_front & det_ok & rect_ok
    opa = torch.where(valid, run.opacity, torch.zeros_like(run.opacity))
    table = torch.cat([x[..., None], y[..., None], conic, opa[..., None], z[..., None],
                       run.colors], -1)

    shapes = [tuple(v.shape) for v in cache.slot_valid]
    sizes = [n * k for n, k in shapes]
    tables, oks, ids = [], [], []
    for tab, ok, (n, k), ids_b in zip(table.split(sizes), valid.split(sizes), shapes,
                                      cache.tile_ids):
        if n:
            tables.append(tab.view(n, k, -1))
            oks.append(ok.view(n, k))
            ids.append(ids_b)
    acc, ft, med = (tiles_to_image(v, grid, config.tile_shape, H, W) for v in
                    blend_classes(tables, oks, ids, grid_x, config.tile_shape,
                                  grid[0] * grid[1]))
    return acc[:3], acc[-2], med, 1.0 - ft, acc[-1]
