"""Per-frame camera tracking (port of ``hierslam_tpu/slam/tracking.py``).

The JAX ``lax.scan`` over iterations is an eager loop here.  Per frame: a
fresh hand-written Adam on the pose (eps=1e-8, bias-corrected), the loss
taken at the pre-step pose, the post-step pose kept as candidate whenever
that loss improved, and the best candidate written back.  All bookkeeping
stays on the device (``torch.where``): no host sync inside the iterations;
the loss traces are stacked once per round.
"""
from __future__ import annotations

from dataclasses import replace as _dc_replace
from typing import Dict

import torch

from hierslam_torch import resolve_device
from hierslam_torch.core import transforms
from hierslam_torch.ops.rasterize import RasterConfig, RenderOutput
from hierslam_torch.ops.render_tracked import build_track_cache, render_tracked
from hierslam_torch.slam.losses import LossConfig, render_gaussians, tracking_loss
from hierslam_torch.utils.trace import span

Params = Dict[str, torch.Tensor]

# the pose caches' binning counters (render_tracked.TrackCache.counters), summed
TRACK_COUNTERS = ("track_pairs", "track_slots", "track_classes", "track_tiles",
                  "track_pairs_dropped")


def propagate_pose(params: Params, time_idx: int, forward_prop: bool = True) -> Params:
    """Pose init for frame ``time_idx``: constant velocity when enabled and
    t > 1, else a copy of the previous pose."""
    t = int(time_idx)
    q = params["cam_unnorm_rots"].clone()
    tr = params["cam_trans"].clone()
    q1, t1 = q[0, :, t - 1], tr[0, :, t - 1]
    if forward_prop and t > 1:
        p1 = transforms.normalize(q1)
        p2 = transforms.normalize(q[0, :, t - 2])
        new_q = transforms.normalize(p1 + (p1 - p2))
        new_t = t1 + (t1 - tr[0, :, t - 2])
    else:
        new_q, new_t = q1, t1
    q[0, :, t] = new_q
    tr[0, :, t] = new_t
    out = dict(params)
    out["cam_unnorm_rots"], out["cam_trans"] = q, tr
    return out


def apply_gt_pose(params: Params, gt_w2c: torch.Tensor, time_idx: int) -> Params:
    """Write the (relative) GT pose into the trajectory."""
    t = int(time_idx)
    q = params["cam_unnorm_rots"].clone()
    tr = params["cam_trans"].clone()
    q[0, :, t] = transforms.matrix_to_quaternion(gt_w2c[:3, :3])
    tr[0, :, t] = gt_w2c[:3, 3]
    out = dict(params)
    out["cam_unnorm_rots"], out["cam_trans"] = q, tr
    return out


def est_w2c(params: Params, time_idx: int) -> torch.Tensor:
    """Estimated 4x4 w2c of frame ``time_idx``."""
    t = int(time_idx)
    q = transforms.normalize(params["cam_unnorm_rots"][0, :, t])
    return transforms.build_w2c(q, params["cam_trans"][0, :, t])


def make_tracker(camera, loss_cfg: LossConfig, raster_cfg: RasterConfig,
                 lr_quat: float, lr_trans: float, num_iters: int,
                 use_cache: bool = True, margin_px: float = 16.0, device="cuda"):
    """Returns ``track(params, active, max_radius, im, depth, time_idx) ->
    (params, best_loss, max_radius, trace, carry)`` with the best pose
    written into the trajectory; ``track.continue_round(params, active, im,
    depth, time_idx, carry)`` runs ``num_iters`` more steps of the same Adam
    run (the depth-loss escape hatch).  With ``use_cache`` renders come from
    the per-frame pose cache (``ops/render_tracked.py``), built at the
    round's start pose with a ``margin_px`` rect margin; without, every
    iteration bins afresh and renders through ``render_gaussians`` with
    the pose gradient.  ``track.counters`` sums the caches' binning
    counters (:data:`TRACK_COUNTERS`, host integers) since construction.
    While a profiler records, each cache build is an ``hs.track.cache``
    span and each iteration (render to Adam step) an ``hs.track.iter``
    span."""
    dev = resolve_device(device)
    counters = dict.fromkeys(TRACK_COUNTERS, 0)
    if raster_cfg.track_sat_margin >= 0.0:
        raster_cfg = _dc_replace(raster_cfg, sat_margin=raster_cfg.track_sat_margin)
    if raster_cfg.track_bucket_spec is not None:
        raster_cfg = _dc_replace(raster_cfg, bucket_spec=raster_cfg.track_bucket_spec)
    elif raster_cfg.track_max_per_tile:
        raster_cfg = _dc_replace(
            raster_cfg, max_per_tile=raster_cfg.track_max_per_tile,
            bucket_spec=None if raster_cfg.bucket_spec is None else (
                (-1, raster_cfg.track_max_per_tile),),
        )

    def track_round(params, active, im_gt, depth_gt, time_idx, carry_in):
        t_idx = int(time_idx)
        q_cur, t_cur = carry_in[0], carry_in[1]
        if use_cache:
            with span("hs.track.cache"):
                cache = build_track_cache(params, active, q_cur, t_cur, camera, raster_cfg,
                                          margin_px=margin_px)
            for k, v in cache.counters.items():
                counters[f"track_{k}"] += v

        def loss_fn(q, t):
            if use_cache:
                im, dep, med, fo, mask = render_tracked(cache, q, t, camera, raster_cfg)
                out = RenderOutput(im=im, radii=cache.radii0, depth=dep, median_depth=med,
                                   final_opacity=fo, mask=mask, semantic=None,
                                   n_dropped=cache.n_dropped, tile_count=None)
            else:
                out = render_gaussians(params, active, q, t, camera, raster_cfg,
                                       with_semantic=False, gaussians_grad=False,
                                       camera_grad=True)
            loss, parts = tracking_loss(out, im_gt, depth_gt, loss_cfg)
            return loss, out.radii, parts

        (q, t, mq, vq, mt, vt, cnt, bq, bt, bloss, maxrad) = carry_in
        losses, d_ls, i_ls = [], [], []
        for _ in range(num_iters):
            with span("hs.track.iter"):
                q = q.detach().requires_grad_(True)
                t = t.detach().requires_grad_(True)
                loss, radii, parts = loss_fn(q, t)
                gq, gt = torch.autograd.grad(loss, (q, t))
                loss = loss.detach()
                q, t = q.detach(), t.detach()
                cnt = cnt + 1
                bc1, bc2 = 1 - 0.9**cnt, 1 - 0.999**cnt
                mq = 0.9 * mq + 0.1 * gq
                vq = 0.999 * vq + 0.001 * gq * gq
                mt = 0.9 * mt + 0.1 * gt
                vt = 0.999 * vt + 0.001 * gt * gt
                q = q - lr_quat * (mq / bc1) / (torch.sqrt(vq / bc2) + 1e-8)
                t = t - lr_trans * (mt / bc1) / (torch.sqrt(vt / bc2) + 1e-8)
                better = loss < bloss
                bq = torch.where(better, q, bq)
                bt = torch.where(better, t, bt)
                bloss = torch.minimum(loss, bloss)
                maxrad = torch.where(radii > 0, torch.maximum(maxrad, radii.float()), maxrad)
                losses.append(loss)
                d_ls.append(parts["depth"].detach())
                i_ls.append(parts["im"].detach())
        carry = (q, t, mq, vq, mt, vt, cnt, bq, bt, bloss, maxrad)
        out = dict(params)
        rots = params["cam_unnorm_rots"].clone()
        trans = params["cam_trans"].clone()
        rots[0, :, t_idx] = bq
        trans[0, :, t_idx] = bt
        out["cam_unnorm_rots"], out["cam_trans"] = rots, trans
        trace = (torch.stack(losses), torch.stack(d_ls), torch.stack(i_ls))
        return out, bloss, maxrad, trace, carry

    def fresh_carry(params, max_radius, time_idx):
        t_idx = int(time_idx)
        q0 = params["cam_unnorm_rots"][0, :, t_idx].clone()
        t0 = params["cam_trans"][0, :, t_idx].clone()
        zq, zt = torch.zeros_like(q0), torch.zeros_like(t0)
        inf = torch.full((), float("inf"), dtype=torch.float32, device=q0.device)
        return (q0, t0, zq, zq, zt, zt, 0, q0, t0, inf, max_radius)

    def track(params, active, max_radius, im_gt, depth_gt, time_idx):
        if params["means3D"].device != dev:
            raise ValueError(f"tracker built for {dev}, params on {params['means3D'].device}")
        init = fresh_carry(params, max_radius, time_idx)
        return track_round(params, active, im_gt, depth_gt, time_idx, init)

    track.continue_round = track_round
    track.counters = counters
    return track
