"""Densification + keyframe-window mapping (port of ``hierslam_tpu/slam/mapping.py``).

* ``make_densifier``: the silhouette / depth-error non-presence render (one
  uniform class at the densify K) back-projected into free capacity slots;
* ``make_mapper``: the mapping phase — one amortized binning per window
  frame with a 4 px rect margin at the phase-start params, then per
  iteration: render a random window frame, mapping loss, prune (reference
  order: backward -> prune -> step), a fresh eps=1e-15 Adam on the
  Gaussians and the persistent eps=1e-8 Adam of the semantic decoder.
  With ``backend="pallas"``/``"xla"`` it renders through the ladder
  (``ops/rasterize.py``, K1/K2) with the parameter dict as the Adam
  variable.  With ``backend="stream"`` (the flagship's) the Adam variable
  is one packed ``[N, 5+F]`` stream table (means, log scale, opacity
  logit, rgb, semantic) with a per-column lr, rendered through the pair
  stream (``ops/render_stream.py``, K3/K4) from full-N binnings; removed
  and inactive rows carry the sentinel opacity logit, and rotations, which
  an isotropic stream render does not read, stay as they are.

With a ``densify_cfg`` (``use_gaussian_splatting_densification``, ladder
mapper only) the phase also runs classic clone/split densification
(``slam/densify_classic.py``): each iteration accumulates
``||dL/d means2D||`` over the gaussians it saw, and at each densify event
the clones and splits land and the window is binned again, so that they
render from the next iteration on.
"""
from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace
from typing import Dict, Optional

import numpy as np
import torch

from hierslam_torch import resolve_device
from hierslam_torch.core import gaussians as G
from hierslam_torch.core import transforms
from hierslam_torch.ops import render_stream as rs
from hierslam_torch.ops.rasterize import RasterConfig, compute_binning
from hierslam_torch.ops.ssim import ssim_ref_stats
from hierslam_torch.slam import optim
from hierslam_torch.slam.densify_classic import (DensifyConfig, accumulate_mean2d_gradient,
                                                 densify_step)
from hierslam_torch.slam.losses import (LossConfig, lower_median, mapping_loss, render_gaussians,
                                        render_packed_stream)
from hierslam_torch.utils import trace

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class PruneConfig:
    """pruning_dict schema of the configs."""

    start_after: int = 0
    remove_big_after: int = 0
    stop_after: int = 20
    prune_every: int = 20
    removal_opacity_threshold: float = 0.005
    final_removal_opacity_threshold: float = 0.005
    reset_opacities: bool = False
    reset_opacities_every: int = 500


def make_densifier(camera, raster_cfg: RasterConfig, sil_thres: float,
                   num_semantic: int, device="cuda"):
    """Add-new-gaussians step: ``densify(params, variables, im, depth,
    time_idx, generator=None) -> (params, variables, n_added, n_overflow,
    n_bin_dropped)``."""
    dev = resolve_device(device)
    k_dens = raster_cfg.densify_max_per_tile or min(2 * raster_cfg.max_per_tile, 4096)
    dens_cfg = _dc_replace(raster_cfg, max_per_tile=k_dens, bucket_spec=((-1, k_dens),),
                           escalate_tiles=0)

    @torch.no_grad()
    def densify(params, variables, im_gt, depth_gt, time_idx, generator=None):
        if im_gt.device != dev:
            raise ValueError(f"densifier built for {dev}, frame on {im_gt.device}")
        t = int(time_idx)
        q = params["cam_unnorm_rots"][0, :, t]
        tr = params["cam_trans"][0, :, t]
        out = render_gaussians(params, variables["active"], q, tr, camera, dens_cfg,
                               with_semantic=False, gaussians_grad=False, camera_grad=False)
        sil = out.final_opacity
        depth_error = torch.abs(depth_gt - out.depth) * (depth_gt > 0)
        non_presence = (sil < sil_thres) | (
            (out.depth > depth_gt) & (depth_error > 50 * lower_median(depth_error))
        )
        mask = non_presence.reshape(-1) & (depth_gt > 0).reshape(-1)
        w2c = transforms.build_w2c(transforms.normalize(q), tr)
        fields = G.pointcloud_fields(im_gt, depth_gt, camera.intrinsics, w2c,
                                     num_semantic, generator)
        params, variables, n_over = G.insert_gaussians(params, variables, fields, mask, float(t))
        variables = dict(variables)
        for k in ("means2D_gradient_accum", "denom", "max_2D_radius"):
            variables[k] = torch.zeros_like(variables[k])
        return params, variables, mask.sum(), n_over, out.n_dropped

    return densify


def make_mapper(camera, loss_cfg: LossConfig, raster_cfg: RasterConfig,
                lrs: Dict[str, float], num_iters: int, prune_cfg: PruneConfig,
                mlp_lr: float = 5e-4, bin_margin_px: float = 4.0,
                densify_cfg: Optional[DensifyConfig] = None, device="cuda", combine=None):
    """Returns ``map_phase(params, variables, window, rand_idx, mlp,
    mlp_state, generator=None, noise=None) -> (params, variables, mlp,
    mlp_state, losses)``.

    ``window``: im [W,3,H,W], depth [W,H,W], labels [W,L+1,H,W] (optional),
    time_idx [W]; ``rand_idx`` [num_iters] host ints into the window.
    ``losses`` holds one [num_iters] device tensor per loss term; the
    stream mapper adds the phase's ``stream_rows``, ``stream_row_budget``,
    ``pairs_kept`` and ``pairs_dropped`` (int64 totals over its binnings,
    each expanded to [num_iters]).  While a profiler records, the phase's
    parts are the spans ``hs.map.setup``, ``hs.map.bin`` (each window
    binning) and ``hs.map.iter`` (each iteration, render to Adam step).  With
    ``densify_cfg`` the split children's draws come from ``generator``, or
    from ``noise``: one sequence of ``num_to_split_into`` ``[N, 3]``
    tensors per densify event.

    ``combine(grads, mlp_grads, parts, radii) -> (grads, mlp_grads, parts,
    radii)`` is the data-parallel mapper's hook (``parallel/shard.py``):
    it runs after each backward, before prune and step, and averages the
    ranks' gradients and loss parts and takes the max of their ``radii``
    (None where no radius bookkeeping follows)."""
    dev = resolve_device(device)
    with_sem = bool(loss_cfg.sem_levels)
    packed = raster_cfg.backend == "stream"
    use_classic = densify_cfg is not None
    if use_classic and raster_cfg.visible_budget > 0:
        raise ValueError("use_gaussian_splatting_densification needs full-N means2D/"
                         "radii bookkeeping — set raster.visible_budget=0 with it")
    if use_classic and packed:
        raise ValueError("use_gaussian_splatting_densification needs full-N means2D "
                         "bookkeeping — use raster.backend 'pallas' or 'xla' with it")
    events = densify_cfg.events(num_iters) if use_classic else ()
    # the stream mapper bins full-N: its costs scale with the pair stream,
    # and a visible budget would only truncate rendering
    compacted = raster_cfg.visible_budget > 0 and not packed
    bin_fn = rs.compute_stream_binning if packed else compute_binning

    def bin_window(src, active, wq, wt):
        """One amortized binning per window frame at the params ``src``."""
        with trace.span("hs.map.bin"):
            scales0 = torch.exp(src["log_scales"])
            opac0 = torch.sigmoid(src["logit_opacities"])
            binnings = []
            for q, t in zip(wq, wt):
                means_cam, _ = transforms.transform_to_frame(
                    src["means3D"], src["unnorm_rotations"], q, t,
                    gaussians_grad=False, camera_grad=False)
                binnings.append(bin_fn(
                    means_cam, scales0, src["unnorm_rotations"], camera, raster_cfg,
                    active=active, margin_px=bin_margin_px, opacities=opac0, compact=compacted))
            return binnings

    def stream_counters(lists, n):
        """The phase's stream work, each count expanded to ``[n]`` as a loss
        trace: the binnings' used rows (known on the host: ``idx`` holds
        the used rows only) and their row budget, and their kept and
        dropped pairs (device sums, read with the losses at the phase's
        end)."""
        budget = raster_cfg.stream_rows_for(raster_cfg.grid(camera.height, camera.width))
        rows = sum(x.idx.shape[0] for x in lists)
        return {
            "stream_rows": torch.full((n,), rows, dtype=torch.int64, device=dev),
            "stream_row_budget": torch.full((n,), len(lists) * budget, dtype=torch.int64,
                                            device=dev),
            "pairs_kept": torch.stack([x.n_refs for x in lists]).sum().expand(n),
            "pairs_dropped": torch.stack([x.n_dropped for x in lists]).sum().expand(n),
        }

    def map_phase(params, variables, window, rand_idx, mlp, mlp_state, generator=None,
                  noise=None):
        if params["means3D"].device != dev:
            raise ValueError(f"mapper built for {dev}, params on {params['means3D'].device}")
        with trace.span("hs.map.setup"):
            variables = dict(variables)
            if packed:
                if params["log_scales"].shape[1] != 1:
                    raise NotImplementedError("stream backend supports isotropic maps only")
                sem_w = params["semantic"].shape[1] if with_sem and "semantic" in params else 0
                # inactive slots carry the sentinel logit: they blend to nothing
                # and route no gradient; a prune writes the same (rows are not
                # reused within a phase, so this is the reference's row removal)
                gp = {"table": rs.set_logit(rs.pack_table(params, sem_w).detach(),
                                            ~variables["active"], rs.SENTINEL_LOGIT)}
                lr_vec = np.zeros(gp["table"].shape[1], np.float32)
                lr_vec[rs.COL_MEAN:rs.COL_MEAN + 3] = lrs.get("means3D", 0.0)
                lr_vec[rs.COL_LOGS] = lrs.get("log_scales", 0.0)
                lr_vec[rs.COL_LOGIT] = lrs.get("logit_opacities", 0.0)
                lr_vec[rs.COL_FEAT:rs.COL_FEAT + 3] = lrs.get("rgb_colors", 0.0)
                lr_vec[rs.COL_FEAT + 3:] = lrs.get("semantic", 0.0)
                phase_lrs = {"table": torch.as_tensor(lr_vec, device=dev)}
            else:
                gp = {k: params[k] for k in G.GAUSSIAN_KEYS if k in params}
                phase_lrs = lrs
            opt = optim.adam_init(gp)
            tidx = window["time_idx"].long()
            wq = params["cam_unnorm_rots"][0].T[tidx]
            wt = params["cam_trans"][0].T[tidx]
            n_win = tidx.shape[0]
            w_ssim = [ssim_ref_stats(window["im"][i]) for i in range(n_win)]

        # amortized binning at the phase-start params (the packed table
        # holds the same values), again after each densify event
        with torch.no_grad():
            binnings = bin_window(params, variables["active"], wq, wt)
        if packed:
            counters = stream_counters([b.lists for b in binnings], num_iters)

        wants_mlp = with_sem and loss_cfg.use_mlp and mlp is not None
        traces: Dict[str, list] = {}
        n_slots = params["means3D"].shape[0]
        n_classic_over = torch.zeros((), dtype=torch.int64, device=dev)
        for it in range(num_iters):
            with trace.span("hs.map.iter"):
                k = int(rand_idx[it])
                labels = window["labels"][k].long() if "labels" in window else None
                leaves = {n: v.detach().requires_grad_(True) for n, v in gp.items()}
                mlp_l = ({n: v.detach().requires_grad_(True) for n, v in mlp.items()}
                         if wants_mlp else None)
                m2d = (torch.zeros((n_slots, 2), device=dev, requires_grad=True)
                       if use_classic else None)
                if packed:
                    out = render_packed_stream(leaves["table"], None, binnings[k], wq[k], wt[k],
                                               camera, raster_cfg, 3 + sem_w)
                else:
                    full = dict(params)
                    full.update(leaves)
                    out = render_gaussians(full, variables["active"], wq[k], wt[k], camera,
                                           raster_cfg, with_semantic=with_sem, gaussians_grad=True,
                                           camera_grad=False, binning_cache=binnings[k],
                                           means2D_offset=m2d)
                loss, parts = mapping_loss(out, window["im"][k], window["depth"][k], labels,
                                           mlp_l, it, loss_cfg, gt_ssim=w_ssim[k])
                inputs = (list(leaves.values()) + (list(mlp_l.values()) if wants_mlp else [])
                          + ([m2d] if use_classic else []))
                grads = torch.autograd.grad(loss, inputs, allow_unused=True)
                grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
                ggp = dict(zip(leaves.keys(), grads[:len(leaves)]))
                gmlp = (dict(zip(mlp_l.keys(), grads[len(leaves):len(leaves) + len(mlp_l)]))
                        if wants_mlp else None)
                if use_classic:   # after the backward, before prune and step
                    variables = accumulate_mean2d_gradient(variables, grads[-1], out.radii > 0)
                parts = {n: v.detach() for n, v in parts.items()}
                parts["n_grad_dropped"] = out.n_grad_dropped.float()
                parts["n_map_bin_dropped"] = out.n_dropped.float()
                radii = None if compacted or packed else out.radii
                if combine is not None:
                    ggp, gmlp, parts, radii = combine(ggp, gmlp, parts, radii)

                # prune (reference order: backward -> prune -> step)
                if (prune_cfg.start_after <= it <= prune_cfg.stop_after
                        and it % prune_cfg.prune_every == 0):
                    thresh = (prune_cfg.final_removal_opacity_threshold
                              if it == prune_cfg.stop_after
                              else prune_cfg.removal_opacity_threshold)
                    if packed:
                        logit, log_scale = gp["table"][:, rs.COL_LOGIT], gp["table"][:, rs.COL_LOGS]
                    else:
                        logit, log_scale = gp["logit_opacities"][:, 0], gp["log_scales"].amax(1)
                    active = variables["active"]
                    removed = active & (torch.sigmoid(logit) < thresh)
                    if it >= prune_cfg.remove_big_after:
                        big = torch.exp(log_scale) > 0.1 * variables["scene_radius"]
                        removed = removed | (active & big)
                    del logit, log_scale   # views: kept, they hold this table to the end
                    variables["active"] = active & ~removed
                    opt = optim.zero_moment_rows(opt, removed)
                    if packed:
                        gp = {"table": rs.set_logit(gp["table"], removed, rs.SENTINEL_LOGIT)}
                if (prune_cfg.reset_opacities and it > 0
                        and it % prune_cfg.reset_opacities_every == 0
                        and it <= prune_cfg.stop_after):
                    reset = float(np.log(0.01 / 0.99))
                    if packed:
                        # every row, as the JAX packed path does: rows a prune or
                        # the phase-start fold gave the sentinel logit come back
                        every = torch.ones_like(variables["active"])
                        gp = {"table": rs.set_logit(gp["table"], every, reset)}
                        opt = optim.AdamState(
                            mu={"table": rs.set_logit(opt.mu["table"], every, 0.0)},
                            nu={"table": rs.set_logit(opt.nu["table"], every, 0.0)},
                            count=opt.count)
                    else:
                        gp = dict(gp)
                        gp["logit_opacities"] = torch.full_like(gp["logit_opacities"], reset)
                        opt = optim.zero_moments_for_key(opt, "logit_opacities")

                gp, opt = optim.adam_step(gp, ggp, opt, phase_lrs, eps=1e-15)
                if wants_mlp:
                    mlp, mlp_state = optim.adam_step(mlp, gmlp, mlp_state,
                                                     {"w": mlp_lr, "b": mlp_lr}, eps=1e-8)
                if radii is not None:
                    variables["max_2D_radius"] = torch.where(
                        radii > 0, torch.maximum(variables["max_2D_radius"], radii.float()),
                        variables["max_2D_radius"])
                for n, v in parts.items():
                    traces.setdefault(n, []).append(v)
                # the iteration's graph and gradients go now: kept, the old
                # gradients would live through the next iteration's backward
                del out, loss, inputs, grads, ggp, gmlp, leaves, mlp_l

            if it in events:
                full = dict(params)
                full.update(gp)
                e = events.index(it)
                full, variables, opt, n_over = densify_step(
                    full, variables, opt, it, densify_cfg, generator,
                    None if noise is None else noise[e])
                n_classic_over = n_classic_over + n_over
                gp = {n: full[n] for n in gp}
                with torch.no_grad():
                    binnings = bin_window(full, variables["active"], wq, wt)

        out_params = dict(params)
        out_params.update(rs.unpack_table(gp["table"], sem_w) if packed
                          else {n: v.detach() for n, v in gp.items()})
        losses = {n: torch.stack(v) for n, v in traces.items()}
        if use_classic:
            losses["classic_densify_overflow"] = n_classic_over.float().expand(num_iters)
        if packed:
            losses.update(counters)
        return out_params, variables, mlp, mlp_state, losses

    return map_phase
