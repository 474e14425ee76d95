"""Pose-only rendering for camera tracking (port of ``hierslam_tpu/ops/render_tracked.py``).

While tracking, the map is frozen and only the 7-dof pose moves.  The
frame binning and the per-slot raw attributes (world mean, color, opacity
and shape) are gathered once per frame at the propagated pose, with a
pixel margin for the in-frame drift; each iteration then only projects
every class's slots at the current pose in one pass
(:func:`track_project`: the camera transform, the EWA covariance, the
exact current-pose rect and frustum test) into one blend table, and
blends every class at its true tile ids and screen coordinates into
buffers the classes share (``render_pallas.blend_run``).  Gradients reduce
straight to the pose.  On CUDA tensors the projection is kernel
``track_project_fwd`` and its backward ``track_project_bwd``
(``csrc/track.cu``), with the pose as 28 scalars on the device
(``render_stream.make_scalars``); on CPU tensors it is
:func:`track_project_plain`, written in the kernels' operation order,
whose gradient autograd takes.  A CUDA tensor never takes the plain path.
The frame's lists drop no pair under one configured class
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

import torch

from hierslam_torch.core import transforms
from hierslam_torch.ops import binning, kernels, projection
from hierslam_torch.ops.rasterize import RasterConfig
from hierslam_torch.ops.render_pallas import blend_run
from hierslam_torch.ops.render_stream import make_scalars
from hierslam_torch.ops.render_xla import tiles_to_image

# calls of the plain version (a main-path run on the card keeps it at 0)
plain_counts = {"track_project_plain": 0}


class TrackSlots(NamedTuple):
    """Every class's slots in one run, class after class, each class's
    [n_b, k_b] row-major: S slots in all."""

    # the slot's gaussian: world mean (3), color (3), post-sigmoid opacity,
    # then its shape: the post-exp isotropic scale ([S, 8]) or the world
    # covariance's upper triangle xx, xy, xz, yy, yz, zz ([S, 13])
    rows: torch.Tensor
    valid: torch.Tensor                    # [S] bool
    tile: torch.Tensor                     # [S] int32: the slot's true tile id


class TrackCache(NamedTuple):
    tile_ids: Tuple[torch.Tensor, ...]     # per class: [n_b] int32 true tile ids
    slot_valid: Tuple[torch.Tensor, ...]   # per class: [n_b, k_b], a view of ``run.valid``
    run: TrackSlots                        # every class's slots in one run
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
    shapes = [tuple(i.shape) for i in lists.idx]
    tile = torch.cat([ids.repeat_interleave(k) for ids, (_, k) in zip(lists.tile_ids, shapes)])
    prep0 = projection.preprocess(means_cam0, scales, rots_cam0, camera,
                                  config.tile_shape, active=active)
    run = TrackSlots(rows=table[safe], valid=valid, tile=tile.to(torch.int32))
    sizes = [n * k for n, k in shapes]
    return TrackCache(
        tile_ids=tuple(i.to(torch.int32) for i in lists.tile_ids),
        slot_valid=tuple(v.view(shape) for v, shape in zip(valid.split(sizes), shapes)),
        run=run, count=lists.count, radii0=prep0.radius, n_dropped=lists.n_dropped,
        counters=counters,
    )


def track_project_plain(rows: torch.Tensor, valid: torch.Tensor, tile: torch.Tensor,
                        sc: torch.Tensor, grid_x: int, img_shape, tile_shape):
    """Plain version of ``track_project_fwd``: every slot (``TrackSlots``
    rows, valid, tile) projected at the pose and camera of the 28 scalars
    ``sc`` (``render_stream.make_scalars``) -> (blend table [S, 10]: screen
    x, y, conic a, b, c, opacity where ok else 0, camera z, color; ok [S]:
    valid, in front, det != 0 and the rect overlaps the slot's tile).
    Differentiable in ``sc``; written in the kernel's operation order, as
    explicit multiply-adds."""
    plain_counts["track_project_plain"] += 1
    img_h, img_w = img_shape
    th, tw = tile_shape
    s = sc.unbind()
    fx, fy, limx, limy = s[24:28]
    mx, my, mz = rows[:, 0], rows[:, 1], rows[:, 2]
    mcx = s[0] * mx + s[1] * my + s[2] * mz + s[9]
    mcy = s[3] * mx + s[4] * my + s[5] * mz + s[10]
    mcz = s[6] * mx + s[7] * my + s[8] * mz + s[11]
    ph_x = s[12] * mcx + s[13] * mcy + s[14] * mcz + s[15]
    ph_y = s[16] * mcx + s[17] * mcy + s[18] * mcz + s[19]
    ph_w = s[20] * mcx + s[21] * mcy + s[22] * mcz + s[23]
    p_w = 1.0 / (ph_w + 1e-7)
    x = ((ph_x * p_w + 1.0) * img_w - 1.0) * 0.5
    y = ((ph_y * p_w + 1.0) * img_h - 1.0) * 0.5

    safe_z = torch.where(mcz == 0.0, torch.ones_like(mcz), mcz)
    inv_z = 1.0 / safe_z
    txc = torch.clamp(mcx * inv_z, min=-limx, max=limx)
    tyc = torch.clamp(mcy * inv_z, min=-limy, max=limy)
    j00 = fx * inv_z
    j02 = -fx * txc * inv_z
    j11 = fy * inv_z
    j12 = -fy * tyc * inv_z
    if rows.shape[1] == 13:
        cov = rows[:, 7:13]
        S = [[cov[:, 0], cov[:, 1], cov[:, 2]],
             [cov[:, 1], cov[:, 3], cov[:, 4]],
             [cov[:, 2], cov[:, 4], cov[:, 5]]]
        t0 = [j00 * s[c] + j02 * s[6 + c] for c in range(3)]
        t1 = [j11 * s[3 + c] + j12 * s[6 + c] for c in range(3)]
        a0 = [t0[0] * S[0][c] + t0[1] * S[1][c] + t0[2] * S[2][c] for c in range(3)]
        b1 = [t1[0] * S[0][c] + t1[1] * S[1][c] + t1[2] * S[2][c] for c in range(3)]
        c_xx = a0[0] * t0[0] + a0[1] * t0[1] + a0[2] * t0[2] + 0.3
        c_xy = a0[0] * t1[0] + a0[1] * t1[1] + a0[2] * t1[2]
        c_yy = b1[0] * t1[0] + b1[1] * t1[1] + b1[2] * t1[2] + 0.3
    else:
        s2 = rows[:, 7] * rows[:, 7]
        c_xx = s2 * (j00 * j00 + j02 * j02) + 0.3
        c_xy = s2 * (j02 * j12)
        c_yy = s2 * (j11 * j11 + j12 * j12) + 0.3
    det = c_xx * c_yy - c_xy * c_xy
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))

    with torch.no_grad():
        mid = 0.5 * (c_xx + c_yy)
        sq = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + sq, mid - sq)))
        xn, yn = x.detach(), y.detach()
        tx, ty = (tile % grid_x).float(), (tile // grid_x).float()
        rect_ok = (
            (tx >= torch.floor((xn - radius) * (1.0 / tw)))
            & (tx < torch.floor((xn + radius + tw - 1) * (1.0 / tw)))
            & (ty >= torch.floor((yn - radius) * (1.0 / th)))
            & (ty < torch.floor((yn + radius + th - 1) * (1.0 / th)))
        )
        ok = valid & (mcz > 0.2) & det_ok & rect_ok
    opa = torch.where(ok, rows[:, 6], torch.zeros_like(rows[:, 6]))
    table = torch.stack([x, y, c_yy * det_inv, -c_xy * det_inv, c_xx * det_inv, opa, mcz,
                         rows[:, 3], rows[:, 4], rows[:, 5]], -1)
    return table, ok


class _TrackProject(torch.autograd.Function):
    """The projection on the card: ``track_project_fwd`` forward, and
    ``track_project_bwd`` from the table's cotangent to the 28 scalars."""

    @staticmethod
    def forward(ctx, sc, rows, valid, tile, grid_x, img_shape, tile_shape):
        table, ok = kernels.track_project_fwd(rows, valid, tile, sc, grid_x, img_shape,
                                              tile_shape)
        ctx.save_for_backward(sc, rows)
        ctx.img_shape = img_shape
        ctx.mark_non_differentiable(ok)
        return table, ok

    @staticmethod
    def backward(ctx, gtable, _gok):
        sc, rows = ctx.saved_tensors
        gsc = kernels.track_project_bwd(rows, gtable.contiguous(), sc, ctx.img_shape)
        return (gsc,) + (None,) * 6


def track_project(run: TrackSlots, sc: torch.Tensor, grid_x: int, img_shape, tile_shape):
    """Every slot of ``run`` projected at the pose and camera of ``sc``
    -> (table [S, 10], ok [S]): the kernels on CUDA tensors, else
    :func:`track_project_plain`."""
    if run.rows.is_cuda:
        return _TrackProject.apply(sc, run.rows, run.valid, run.tile, int(grid_x),
                                   tuple(img_shape), tuple(tile_shape))
    return track_project_plain(run.rows, run.valid, run.tile, sc, grid_x, img_shape, tile_shape)


def render_tracked(cache: TrackCache, q: torch.Tensor, t: torch.Tensor, camera,
                   config: RasterConfig):
    """Render at pose (q, t) from the cache: (im [3,H,W], depth, median,
    final_opacity, mask)."""
    H, W = camera.height, camera.width
    grid = config.grid(H, W)
    sc = make_scalars(transforms.build_w2c(transforms.normalize(q), t), camera)
    # every slot of every class at once; the classes part only to be blended
    table, ok = track_project(cache.run, sc, grid[1], (H, W), config.tile_shape)
    acc, ft, med = (tiles_to_image(v, grid, config.tile_shape, H, W) for v in
                    blend_run(table, ok, [tuple(v.shape) for v in cache.slot_valid],
                              cache.tile_ids, grid[1], config.tile_shape, grid[0] * grid[1]))
    return acc[:3], acc[-2], med, 1.0 - ft, acc[-1]
