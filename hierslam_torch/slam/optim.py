"""Functional Adam over param dicts with capacity-slot moment surgery
(port of ``hierslam_tpu/slam/optim.py``).

Fresh per phase like the reference's ``torch.optim.Adam`` uses (mapping
with eps=1e-15, the semantic decoder with eps=1e-8); moments of removed
rows are zeroed.  Kept functional so the moment buffers are plain
``[capacity, ...]`` tensors the mapper can row-mask.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    mu: Params
    nu: Params
    count: int  # steps taken


def adam_init(params: Params) -> AdamState:
    return AdamState(
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        count=0,
    )


def adam_step(params: Params, grads: Params, state: AdamState, lrs: Dict,
              eps: float = 1e-8, betas: Tuple[float, float] = (0.9, 0.999)
              ) -> Tuple[Params, AdamState]:
    b1, b2 = betas
    count = state.count + 1
    bc1 = 1.0 - b1**count
    bc2 = 1.0 - b2**count
    new_p, new_mu, new_nu = dict(params), dict(state.mu), dict(state.nu)
    for k, g in grads.items():
        lr = lrs.get(k, 0.0)
        mu = b1 * state.mu[k] + (1 - b1) * g
        nu = b2 * state.nu[k] + (1 - b2) * (g * g)
        new_mu[k], new_nu[k] = mu, nu
        # lr may be a per-column tensor (the packed stream table's [5+F]
        # row, broadcast over its [N, 5+F] rows)
        if not isinstance(lr, torch.Tensor) and lr == 0.0:
            continue
        new_p[k] = params[k] - lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    return new_p, AdamState(mu=new_mu, nu=new_nu, count=count)


def zero_moment_rows(state: AdamState, removed: torch.Tensor) -> AdamState:
    """Zero the first-axis rows of every moment buffer where ``removed``."""
    keep = (~removed).float()

    def mask_rows(x):
        if x.dim() == 0 or x.shape[0] != removed.shape[0]:
            return x
        return x * keep.reshape((-1,) + (1,) * (x.dim() - 1))

    return AdamState(
        mu={k: mask_rows(v) for k, v in state.mu.items()},
        nu={k: mask_rows(v) for k, v in state.nu.items()},
        count=state.count,
    )


def zero_moments_for_key(state: AdamState, key: str) -> AdamState:
    """Reset one param group's moments (opacity reset)."""
    mu, nu = dict(state.mu), dict(state.nu)
    mu[key] = torch.zeros_like(mu[key])
    nu[key] = torch.zeros_like(nu[key])
    return AdamState(mu=mu, nu=nu, count=state.count)
