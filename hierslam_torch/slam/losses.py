"""Tracking / mapping losses (port of ``hierslam_tpu/slam/losses.py``).

* rendering: ``render_gaussians`` (ladder, or the pair stream for a
  stream binning) and ``render_packed_stream`` (the packed mapper's table);
* tracking: silhouette-gated **sum** losses, depth ``|d - d_hat|`` and RGB
  over the mask, no semantic term;
* mapping: depth masked **mean**, RGB ``0.8 L1 + 0.2 (1 - SSIM)``, semantic
  per-tree-level cross-entropy plus, from mapping iteration
  ``mlp_gate_iter`` on, the leaf cross-entropy through the 1x1-conv
  decoder (weight 5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hierslam_torch.core import transforms
from hierslam_torch.ops import render_stream as rs
from hierslam_torch.ops.gather_vjp import compact_rows
from hierslam_torch.ops.rasterize import RasterConfig, RenderOutput, rasterize
from hierslam_torch.ops.ssim import calc_ssim

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class LossConfig:
    use_sil_for_loss: bool = True
    sil_thres: float = 0.99
    use_l1: bool = True
    ignore_outlier_depth_loss: bool = False
    w_im: float = 0.5
    w_depth: float = 1.0
    w_sem: float = 0.0
    sem_levels: Tuple[int, ...] = ()
    num_leaf: int = 0
    use_mlp: bool = False
    mlp_gate_iter: int = 14
    weight_sem_level: float = 1.0
    weight_sem_leaf: float = 5.0


def lower_median(x: torch.Tensor) -> torch.Tensor:
    """torch.median semantics (the lower median) over all elements."""
    flat = x.reshape(-1)
    return torch.kthvalue(flat, (flat.shape[0] - 1) // 2 + 1).values


def cross_entropy_mean_cmajor(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of channel-major logits [C, H, W] against int
    labels [H, W]."""
    lse = torch.logsumexp(logits, dim=0)
    picked = torch.gather(logits, 0, labels.long()[None])[0]
    return (lse - picked).mean()


def mlp_apply(mlp: Params, sem_img: torch.Tensor) -> torch.Tensor:
    """1x1-conv decoder: [S, H, W] -> [L, H, W] (full float32)."""
    return torch.einsum("shw,ls->lhw", sem_img, mlp["w"]) + mlp["b"][:, None, None]


def mlp_init(num_semantic: int, num_leaf: int, generator: Optional[torch.Generator] = None,
             device="cpu") -> Params:
    """torch Conv2d default init U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn
    from ``generator`` on its own device."""
    bound = 1.0 / float(np.sqrt(num_semantic))

    def u(shape):
        gen_dev = generator.device if generator is not None else device
        r = torch.rand(shape, generator=generator, device=gen_dev).to(device)
        return r * (2 * bound) - bound

    return {"w": u((num_leaf, num_semantic)), "b": u((num_leaf,))}


def render_packed_stream(table: torch.Tensor, active, binning_cache: rs.StreamBinning,
                         cam_quat, cam_trans, camera, raster_cfg: RasterConfig,
                         n_feat: int) -> RenderOutput:
    """Streamed render straight from a packed ``[N, 5+F]`` table (stream
    columns, ``ops/render_stream.py``), the packed mapper's optimization
    variable.  ``active`` (or None when the sentinel logit already marks the
    removed rows) sets the sentinel logit on inactive rows.  Differentiable
    in ``table``; the pose gets no gradient.  ``radii`` are zeros: the
    stream computes none."""
    lists = binning_cache.lists
    act = active
    if lists.vis_ids is not None:
        table = compact_rows(table, lists.vis_ids)
        act = active[lists.vis_ids] if active is not None else None
    if act is not None:
        table = rs.set_logit(table, ~act, rs.SENTINEL_LOGIT)
    w2c = transforms.build_w2c(transforms.normalize(cam_quat.detach()), cam_trans.detach())
    ch, ft, med = rs.render_from_table(table, binning_cache, w2c, camera, raster_cfg, n_feat)
    sem_w = n_feat - 3
    dev = table.device
    return RenderOutput(
        im=ch[:3], radii=torch.zeros((table.shape[0],), dtype=torch.int32, device=dev),
        depth=ch[-2], median_depth=med, final_opacity=1.0 - ft, mask=ch[-1],
        semantic=ch[3:3 + sem_w] if sem_w else None, n_dropped=lists.n_dropped,
        tile_count=lists.count,
        n_grad_dropped=((lists.n_refs - raster_cfg.grad_pair_budget).clamp_min(0)
                        if raster_cfg.grad_pair_budget
                        else torch.zeros((), dtype=torch.int64, device=dev)),
    )


def render_gaussians(params: Params, active, cam_quat, cam_trans, camera,
                     raster_cfg: RasterConfig, *, with_semantic: bool,
                     gaussians_grad: bool, camera_grad: bool,
                     binning_cache=None, means2D_offset=None) -> RenderOutput:
    """transform_to_frame + activations (sigmoid opacity, exp scale, raw
    semantic logits) + rasterize.  A visible-rank binning cache first
    compacts the parameters to its ``[V]`` prefix, so per-gaussian work
    scales with V; ``radii`` are then in compact space.  A
    :class:`~hierslam_torch.ops.render_stream.StreamBinning` cache renders
    through the pair stream instead (isotropic maps, no pose gradient).

    ``means2D_offset`` ([N, 2] zeros) is the classic-densification hook:
    its gradient is dL/d(screen-space mean).  It needs full-N screen
    means, so neither the stream nor a visible-rank cache takes it."""
    if isinstance(binning_cache, rs.StreamBinning):
        if params["log_scales"].shape[1] != 1:
            raise NotImplementedError("stream backend supports isotropic maps only")
        if means2D_offset is not None:
            raise NotImplementedError(
                "classic densification is incompatible with the stream "
                "backend (needs full-N means2D bookkeeping)")
        if camera_grad:
            raise NotImplementedError(
                "stream backend does not provide camera gradients; "
                "tracking uses the render_tracked path")
        gp = params if gaussians_grad else {k: v.detach() for k, v in params.items()}
        sem_w = gp["semantic"].shape[1] if with_semantic and "semantic" in gp else 0
        return render_packed_stream(rs.pack_table(gp, sem_w), active, binning_cache, cam_quat,
                                    cam_trans, camera, raster_cfg, 3 + sem_w)
    vis = getattr(getattr(binning_cache, "lists", None), "vis_ids", None)
    if vis is not None:
        if means2D_offset is not None:
            raise NotImplementedError(
                "classic densification (means2D gradients) needs full-N "
                "radii bookkeeping — incompatible with visible_budget")
        keys = ["means3D", "unnorm_rotations", "rgb_colors", "logit_opacities", "log_scales"]
        if with_semantic and "semantic" in params:
            keys.append("semantic")
        params = {k: compact_rows(params[k], vis) for k in keys}
        if active is not None:
            active = active[vis]
    means_cam, rots = transforms.transform_to_frame(
        params["means3D"], params["unnorm_rotations"], cam_quat, cam_trans,
        gaussians_grad=gaussians_grad, camera_grad=camera_grad,
        transform_rots=params["log_scales"].shape[1] != 1,
    )
    gp = params if gaussians_grad else {k: v.detach() for k, v in params.items()}
    sem = gp.get("semantic") if with_semantic else None
    return rasterize(
        means_cam, gp["rgb_colors"], torch.sigmoid(gp["logit_opacities"][:, 0]),
        torch.exp(gp["log_scales"]), transforms.normalize(rots), camera,
        semantics=sem, active=active, config=raster_cfg, binning_cache=binning_cache,
        means2D_offset=means2D_offset, device=means_cam.device,
    )


def _valid_mask(out: RenderOutput, gt_depth, cfg: LossConfig, tracking: bool):
    with torch.no_grad():
        depth = out.depth
        nan_mask = ~torch.isnan(depth)
        if cfg.ignore_outlier_depth_loss:
            depth_error = torch.abs(gt_depth - depth) * (gt_depth > 0)
            mask = (depth_error < 10 * lower_median(depth_error)) & (gt_depth > 0)
        else:
            mask = gt_depth > 0
        mask = mask & nan_mask
        if tracking and cfg.use_sil_for_loss:
            mask = mask & (out.final_opacity > cfg.sil_thres)
    return mask


def tracking_loss(out: RenderOutput, im_gt, depth_gt, cfg: LossConfig):
    mask = _valid_mask(out, depth_gt, cfg, tracking=True)
    losses = {"depth": torch.sum(torch.abs(depth_gt - out.depth) * mask)}
    if cfg.use_sil_for_loss or cfg.ignore_outlier_depth_loss:
        losses["im"] = torch.sum(torch.abs(im_gt - out.im) * mask[None])
    else:
        losses["im"] = torch.sum(torch.abs(im_gt - out.im))
    loss = cfg.w_im * losses["im"] + cfg.w_depth * losses["depth"]
    losses["loss"] = loss
    return loss, losses


def mapping_loss(out: RenderOutput, im_gt, depth_gt, labels_gt, mlp: Optional[Params],
                 iter_idx: int, cfg: LossConfig, gt_ssim=None):
    """``labels_gt`` [L(+1), H, W] or None; the leaf term enters only from
    ``iter_idx >= cfg.mlp_gate_iter`` (before, its weight is exactly 0)."""
    mask = _valid_mask(out, depth_gt, cfg, tracking=False)
    cnt = mask.sum().clamp_min(1)
    losses = {"depth": torch.sum(torch.abs(depth_gt - out.depth) * mask) / cnt}
    losses["im"] = 0.8 * torch.mean(torch.abs(out.im - im_gt)) + 0.2 * (
        1.0 - calc_ssim(out.im, im_gt, ref_stats=gt_ssim)
    )
    loss = cfg.w_im * losses["im"] + cfg.w_depth * losses["depth"]
    if cfg.sem_levels and labels_gt is not None:
        sem_img = out.semantic
        level_loss = 0.0
        off = 0
        for i, n_cls in enumerate(cfg.sem_levels):
            level_loss = level_loss + cross_entropy_mean_cmajor(
                sem_img[off:off + n_cls], labels_gt[i])
            off += n_cls
        sem_loss = cfg.weight_sem_level * level_loss
        if cfg.use_mlp and mlp is not None and iter_idx >= cfg.mlp_gate_iter:
            leaf_ce = cross_entropy_mean_cmajor(mlp_apply(mlp, sem_img), labels_gt[-1])
            sem_loss = sem_loss + cfg.weight_sem_leaf * leaf_ce
        losses["sem"] = sem_loss
        loss = loss + cfg.w_sem * sem_loss
    losses["loss"] = loss
    return loss, losses
