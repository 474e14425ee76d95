"""Carry the JAX runner's state into the port.

``from_jax_numpy`` takes numpy copies of the JAX package's params,
variables and semantic-decoder state (same keys: ``cam_unnorm_rots
[1,4,F]``, ``cam_trans [1,3,F]``, ``mlp {"w": [L,S], "b": [L]}``, an Adam
state ``(mu, nu, count)``) and returns the port's tensors on ``device``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hierslam_torch.slam.optim import AdamState


def _t(x, device):
    x = np.asarray(x)
    if x.dtype == np.bool_:
        return torch.as_tensor(x, device=device)
    if np.issubdtype(x.dtype, np.integer):
        return torch.as_tensor(x.astype(np.int64), device=device)
    return torch.as_tensor(x.astype(np.float32), device=device)


def from_jax_numpy(params: Dict, variables: Dict, mlp: Optional[Dict] = None,
                   mlp_state=None, device="cpu"):
    """-> (params, variables, mlp, mlp_state) as the port's tensors.
    ``mlp_state`` is a JAX ``AdamState`` or a ``(mu, nu, count)`` tuple."""
    p = {k: _t(v, device) for k, v in params.items()}
    v = {k: _t(x, device) for k, x in variables.items()}
    m = {k: _t(x, device) for k, x in mlp.items()} if mlp is not None else None
    ms = None
    if mlp_state is not None:
        mu, nu, count = mlp_state
        ms = AdamState(mu={k: _t(x, device) for k, x in mu.items()},
                       nu={k: _t(x, device) for k, x in nu.items()},
                       count=int(np.asarray(count)))
    return p, v, m, ms
