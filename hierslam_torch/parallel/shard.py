"""Keyframe data-parallel mapping and the tile-sharded render (port of
``hierslam_tpu/parallel/shard.py``).

* :func:`make_dp_mapper`: the mapping phase of ``slam.mapping.make_mapper``
  with a batch of D window frames an iteration, D the mesh's size.  Rank d
  renders frame ``rand_idx[it, d]`` against the replicated map (the
  flagship's stream backend through K3/K4, the ladder through K1/K2), and
  one ``all_reduce`` a iteration averages the gradients and the loss parts
  (``Rank.mean``); ``radii`` take the max over the ranks.  Prune, opacity
  reset and Adam then run on every rank on equal inputs, so the ranks'
  maps stay equal to the bit: a checksum of each rank's result is compared
  at the phase's end (``check``).  With all D columns of ``rand_idx``
  equal, the phase is the single-device mapper's: the ranks' gradients
  are equal, and their float32 mean at D = 2 or 4 is the gradient exactly.
* :func:`make_dp_mapping_step`: one such step on a batch, without binning
  cache.
* :func:`make_tile_sharded_render`: each rank renders the full map into
  its strip of ``strip_h`` rows (a strip camera with ``pixel_offset_y``,
  K1); the strips, zero outside their rows, are summed by one
  ``all_reduce`` (exact: ``x + 0 == x``) and cropped to the image.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from hierslam_torch.core import gaussians as G
from hierslam_torch.core.camera import strip_camera
from hierslam_torch.ops.rasterize import RasterConfig
from hierslam_torch.parallel.mesh import Mesh, MeshError, Rank, tensors_of
from hierslam_torch.slam import optim
from hierslam_torch.slam.losses import LossConfig, mapping_loss, render_gaussians
from hierslam_torch.slam.mapping import make_mapper

RENDER_KEYS = ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales")


def _grads(loss, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    xs = list(leaves.values())
    gs = torch.autograd.grad(loss, xs, allow_unused=True)
    return {k: torch.zeros_like(x) if g is None else g for (k, x), g in zip(leaves.items(), gs)}


def _step_rank(rk: Rank, static, inputs):
    camera, loss_cfg, raster_cfg, lrs, it = static
    params, variables, batch, opt_state, mlp, mlp_state = inputs
    frame = {k: v[rk.rank] for k, v in batch.items()}
    with_sem = bool(loss_cfg.sem_levels)
    wants_mlp = with_sem and loss_cfg.use_mlp and mlp is not None
    gp = {k: params[k].detach().requires_grad_(True) for k in G.GAUSSIAN_KEYS if k in params}
    mlp_l = {k: v.detach().requires_grad_(True) for k, v in mlp.items()} if wants_mlp else mlp
    out = render_gaussians(gp, variables["active"], frame["quat"], frame["trans"], camera,
                           raster_cfg, with_semantic=with_sem, gaussians_grad=True,
                           camera_grad=False)
    labels = frame["labels"].long() if "labels" in frame else None
    loss, _ = mapping_loss(out, frame["im"], frame["depth"], labels, mlp_l, it, loss_cfg)
    ggp = _grads(loss, {**gp, **(mlp_l if wants_mlp else {})})
    names = list(ggp)
    means = rk.mean([ggp[k] for k in names] + [loss.detach()[None]])
    ggp, loss = dict(zip(names, means[:-1])), means[-1][0]
    gmlp = {k: ggp.pop(k) for k in (mlp_l if wants_mlp else {})}
    gp, opt_state = optim.adam_step({k: v.detach() for k, v in gp.items()}, ggp, opt_state, lrs,
                                    eps=1e-15)
    if wants_mlp:
        mlp, mlp_state = optim.adam_step(mlp, gmlp, mlp_state, {"w": 5e-4, "b": 5e-4}, eps=1e-8)
    out_params = dict(params)
    out_params.update(gp)
    return out_params, opt_state, mlp, mlp_state, loss


def make_dp_mapping_step(mesh: Mesh, camera, loss_cfg: LossConfig, raster_cfg: RasterConfig,
                         lrs: Dict[str, float], axis: str = "data"):
    """One data-parallel mapping step: ``step(params, variables, batch,
    opt_state, mlp, mlp_state, it) -> (params, opt_state, mlp, mlp_state,
    loss)``.  ``batch`` holds per-rank frames with a leading axis of the
    mesh's size: im [D,3,H,W], depth [D,H,W], labels [D,L,H,W] (optional),
    quat [D,4], trans [D,3].  Rank d renders frame d with no binning cache;
    the gradients and the loss are averaged over the ranks, then Adam
    steps the gaussians (eps 1e-15) and the decoder (lr 5e-4, eps 1e-8)."""
    n = mesh.shape[axis]

    def step(params, variables, batch, opt_state, mlp, mlp_state, it):
        for k, v in batch.items():
            if v.shape[0] != n:
                raise ValueError(f"batch[{k!r}] has {v.shape[0]} frames for {n} ranks")
        return mesh.run(_step_rank, (camera, loss_cfg, raster_cfg, lrs, int(it)),
                        (params, variables, batch, opt_state, mlp, mlp_state))

    return step


def _checksum(tree) -> torch.Tensor:
    """An int64 checksum of the bits of every tensor in ``tree``, each
    element weighted by its position and each tensor by its place (integer
    sums: the same on every device and in every order)."""
    total = None
    for i, x in enumerate(tensors_of(tree)):
        flat = x.detach().reshape(-1)
        if flat.dtype.is_floating_point:
            flat = flat.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[flat.element_size()])
        pos = torch.arange(flat.numel(), device=flat.device) % 1_000_003 + 1
        term = (flat.long() * pos).sum() * (i + 1)
        total = term if total is None else total + term
    return total


def _check_replicas(rk: Rank, tree) -> None:
    sums = torch.zeros(rk.size, dtype=torch.int64, device=rk.device)
    sums[rk.rank] = _checksum(tree)
    rk.all_reduce(sums, "sum")
    rk.stats["checksums"] = sums.tolist()
    if bool((sums != sums[0]).any()):
        raise MeshError(f"the ranks' maps differ after the mapping phase: checksums "
                        f"{rk.stats['checksums']}")


def _phase_rank(rk: Rank, static, inputs):
    (camera, loss_cfg, raster_cfg, lrs, num_iters, prune_cfg, mlp_lr, bin_margin_px, rand_idx,
     check) = static
    params, variables, window, mlp, mlp_state = inputs

    def combine(ggp, gmlp, parts, radii):
        names, mnames, pnames = list(ggp), list(gmlp or {}), list(parts)
        means = rk.mean([ggp[k] for k in names] + [gmlp[k] for k in mnames]
                        + [torch.stack([parts[k] for k in pnames])])
        ggp = dict(zip(names, means[:len(names)]))
        if gmlp is not None:
            gmlp = dict(zip(mnames, means[len(names):-1]))
        parts = dict(zip(pnames, means[-1].unbind()))
        if radii is not None:
            radii = rk.all_reduce(radii.clone(), "max")
        return ggp, gmlp, parts, radii

    phase = make_mapper(camera, loss_cfg, raster_cfg, lrs, num_iters, prune_cfg, mlp_lr,
                        bin_margin_px, device=rk.device, combine=combine)
    out = phase(params, variables, window, rand_idx[:, rk.rank], mlp, mlp_state)
    if check:
        _check_replicas(rk, out)
    return out


def make_dp_mapper(mesh: Mesh, camera, loss_cfg: LossConfig, raster_cfg: RasterConfig,
                   lrs: Dict[str, float], num_iters: int, prune_cfg, mlp_lr: float = 5e-4,
                   bin_margin_px: float = 4.0, axis: str = "data"):
    """The data-parallel mapping phase (the module docstring), with the
    signature and results of ``slam.mapping.make_mapper`` but for classic
    densification: ``map_phase(params, variables, window, rand_idx, mlp,
    mlp_state, generator=None, *, check=True)``, ``rand_idx`` ``[num_iters,
    D]`` host ints into the window, one column a rank.  The returned loss
    parts are the ranks' means.  The phase-start broadcast's bytes and
    seconds are printed and left in ``mesh.stats``; with ``check`` the ranks'
    results are held equal by a checksum (``mesh.stats["checksums"]``)."""
    n = mesh.shape[axis]

    def map_phase(params, variables, window, rand_idx, mlp, mlp_state, generator=None, *,
                  check: bool = True):
        rand_idx = np.asarray(rand_idx)
        if rand_idx.shape != (num_iters, n):
            raise ValueError(f"rand_idx has shape {rand_idx.shape}, want ({num_iters}, {n})")
        static = (camera, loss_cfg, raster_cfg, lrs, num_iters, prune_cfg, mlp_lr, bin_margin_px,
                  rand_idx, check)
        out = mesh.run(_phase_rank, static, (params, variables, window, mlp, mlp_state))
        st = mesh.stats
        print(f"[parallel] mapping phase: broadcast {st['broadcast_bytes']} bytes to {n - 1} "
              f"ranks in {st['broadcast_s']:.4f} s at its start; {st['collective_s']:.4f} s in "
              "collectives in all", flush=True)
        return out

    return map_phase


@torch.no_grad()
def _strip_rank(rk: Rank, static, params):
    cam, raster_cfg, height = static
    q, t = torch.tensor([1.0, 0.0, 0.0, 0.0], device=rk.device), torch.zeros(3, device=rk.device)
    strip_h = cam.height
    out = render_gaussians(params, None, q, t, cam, raster_cfg, with_semantic=False,
                           gaussians_grad=False, camera_grad=False,
                           pixel_offset_y=float(rk.rank * strip_h))
    full = torch.zeros((4, rk.size * strip_h, cam.width), device=rk.device)
    rows = slice(rk.rank * strip_h, (rk.rank + 1) * strip_h)
    full[:3, rows] = out.im
    full[3, rows] = out.depth
    rk.all_reduce(full, "sum")
    return full[:3, :height], full[3, :height]


def make_tile_sharded_render(mesh: Mesh, camera, raster_cfg: RasterConfig, axis: str = "data"):
    """``render(params) -> (im [3, H, W], depth [H, W])`` of the whole map at
    the camera's pose (identity ``cam_quat``/``cam_trans``), with the tile
    rows sharded over the mesh: ``strip_h = ceil(tiles_y / D) * tile_h``
    rows a rank, the last strip running past ``H``.  No semantics, no
    gradient."""
    n = mesh.shape[axis]
    th = raster_cfg.tile_shape[0]
    tiles_y = -(-camera.height // th)
    strip_h = -(-tiles_y // n) * th
    static = (strip_camera(camera, strip_h), raster_cfg, camera.height)

    def render(params):
        return mesh.run(_strip_rank, static, {k: params[k] for k in RENDER_KEYS})

    return render
