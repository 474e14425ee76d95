"""Classic 3DGS gradient-driven clone/split densification over capacity
slots (port of ``hierslam_tpu/slam/densify_classic.py``).

Off in every shipped config (``use_gaussian_splatting_densification``);
``slam/mapping.py`` runs it inside a mapping phase when it is on.

* ``accumulate_mean2d_gradient``: ``||dL/d means2D||`` into
  ``means2D_gradient_accum`` and one into ``denom`` for the gaussians seen
  this iteration;
* ``densify_step``: CLONE (grad >= thresh, max scale <= 0.01 scene radius:
  an exact copy appended), then SPLIT (grad >= thresh, larger: ``n`` copies
  drawn from the gaussian itself, ``eps * scales`` through ``R(q)``, with
  scales shrunk by ``0.8 n``; the original removed), then the opacity/size
  prune, then the statistics reset.  Appended rows start with zero Adam
  moments (their slots were never live this phase); removed rows' moments
  are zeroed.

The split draws come from a ``torch.Generator``, which cannot reproduce
JAX's threefry stream: ``densify_step`` takes the ``n`` noise tensors as an
argument, and draws them from the generator only when none are given.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from hierslam_torch.core import gaussians as G
from hierslam_torch.core.transforms import quat_to_rotmat
from hierslam_torch.slam import optim


@dataclass(frozen=True)
class DensifyConfig:
    """densify_dict schema of the configs."""

    start_after: int = 500
    remove_big_after: int = 3000
    stop_after: int = 5000
    densify_every: int = 100
    grad_thresh: float = 0.0002
    num_to_split_into: int = 2
    removal_opacity_threshold: float = 0.005
    final_removal_opacity_threshold: float = 0.005
    reset_opacities_every: int = 3000

    def events(self, num_iters: int) -> Tuple[int, ...]:
        """Iterations of a ``num_iters`` phase after which a densify step
        runs: ``start_after < i <= stop_after`` and ``i % densify_every == 0``."""
        return tuple(i for i in range(num_iters)
                     if self.start_after < i <= self.stop_after
                     and i % self.densify_every == 0)


def accumulate_mean2d_gradient(variables: Dict, means2d_grad: torch.Tensor,
                               seen: torch.Tensor) -> Dict:
    """``means2D_gradient_accum[seen] += ||grad[:, :2]||``; ``denom[seen] += 1``."""
    norm = torch.linalg.vector_norm(means2d_grad[:, :2], dim=-1)
    variables = dict(variables)
    variables["means2D_gradient_accum"] = variables["means2D_gradient_accum"] + torch.where(
        seen, norm, torch.zeros_like(norm))
    variables["denom"] = variables["denom"] + seen.float()
    return variables


@torch.no_grad()
def densify_step(params: Dict, variables: Dict, opt: optim.AdamState, iter_idx: int,
                 cfg: DensifyConfig, generator: Optional[torch.Generator] = None,
                 noise: Optional[Sequence[torch.Tensor]] = None):
    """One clone/split/prune pass.  ``noise``: the ``num_to_split_into``
    ``[N, 3]`` standard-normal draws of the split children, drawn from
    ``generator`` on its own device when not given (a CPU generator gives
    the same draws whatever device the map lives on).  Returns (params,
    variables, opt, n_overflowed)."""
    active = variables["active"]
    grads = variables["means2D_gradient_accum"] / variables["denom"].clamp_min(1e-12)
    grads = torch.where(torch.isnan(grads) | ~active, torch.zeros_like(grads), grads)
    scales = torch.exp(params["log_scales"])
    small = scales.amax(1) <= 0.01 * variables["scene_radius"]
    dense = grads >= cfg.grad_thresh
    to_clone = dense & small & active
    to_split = dense & ~small & active
    gkeys = [k for k in G.GAUSSIAN_KEYS if k in params]

    # clones: exact copies appended into free slots
    params, variables, over = G.insert_gaussians(
        params, variables, {k: params[k] for k in gkeys}, to_clone, variables["timestep"])

    # splits: n resampled, shrunken copies; the original is removed
    n = cfg.num_to_split_into
    shape = params["means3D"].shape
    if noise is None:
        dev = params["means3D"].device
        gen_dev = generator.device if generator is not None else dev
        noise = [torch.randn(shape, generator=generator, device=gen_dev).to(dev)
                 for _ in range(n)]
    if len(noise) != n:
        raise ValueError(f"{len(noise)} noise tensors for {n} split copies")
    R = quat_to_rotmat(params["unnorm_rotations"])
    for eps in noise:
        offset = torch.einsum("nij,nj->ni", R, eps * scales.expand(shape))
        fields = {k: params[k] for k in gkeys}
        fields["means3D"] = params["means3D"] + offset
        fields["log_scales"] = params["log_scales"] - math.log(0.8 * n)
        params, variables, ov = G.insert_gaussians(params, variables, fields, to_split,
                                                   variables["timestep"])
        over = over + ov
    variables = dict(variables)
    variables["active"] = variables["active"] & ~to_split
    opt = optim.zero_moment_rows(opt, to_split)

    # prune on the densify schedule
    thresh = (cfg.final_removal_opacity_threshold if iter_idx == cfg.stop_after
              else cfg.removal_opacity_threshold)
    removed = torch.sigmoid(params["logit_opacities"][:, 0]) < thresh
    if iter_idx >= cfg.remove_big_after:
        removed = removed | (torch.exp(params["log_scales"].amax(1))
                             > 0.1 * variables["scene_radius"])
    removed = removed & variables["active"]
    variables["active"] = variables["active"] & ~removed
    opt = optim.zero_moment_rows(opt, removed)

    for k in ("means2D_gradient_accum", "denom", "max_2D_radius"):
        variables[k] = torch.zeros_like(variables[k])
    return params, variables, opt, over
