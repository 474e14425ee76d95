"""Fixed-capacity Gaussian map state (port of ``hierslam_tpu/core/gaussians.py``).

The map is a capacity-N structure of arrays with an ``active`` mask:
densify appends into free slots, prune clears mask bits.  Param keys
mirror the reference so ``params.npz`` artifacts interoperate.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
Variables = Dict[str, torch.Tensor]

GAUSSIAN_KEYS = (
    "means3D",
    "rgb_colors",
    "unnorm_rotations",
    "logit_opacities",
    "log_scales",
    "semantic",
)
PER_GAUSSIAN_VARS = (
    "active", "max_2D_radius", "means2D_gradient_accum", "denom", "timestep"
)


def pixel_rays(width: int, height: int, intrinsics, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized ray directions ((x-cx)/fx, (y-cy)/fy), flattened row-major."""
    k = torch.as_tensor(np.asarray(intrinsics), dtype=torch.float32, device=device)
    cx, cy, fx, fy = k[0, 2], k[1, 2], k[0, 0], k[1, 1]
    xs = (torch.arange(width, dtype=torch.float32, device=device) - cx) / fx
    ys = (torch.arange(height, dtype=torch.float32, device=device) - cy) / fy
    xx = xs[None, :].expand(height, width).reshape(-1)
    yy = ys[:, None].expand(height, width).reshape(-1)
    return xx, yy


def backproject(depth: torch.Tensor, intrinsics, w2c) -> torch.Tensor:
    """Depth image -> world-frame points [H*W, 3]."""
    h, w = depth.shape
    xx, yy = pixel_rays(w, h, intrinsics, depth.device)
    z = depth.reshape(-1)
    pts_cam = torch.stack([xx * z, yy * z, z], -1)
    w2c = torch.as_tensor(w2c, dtype=torch.float32, device=depth.device)
    c2w = torch.linalg.inv(w2c)
    return pts_cam @ c2w[:3, :3].T + c2w[:3, 3]


def mean_sq_dist_projective(depth: torch.Tensor, intrinsics) -> torch.Tensor:
    """Projective scale prior: (z / mean focal)^2."""
    k = np.asarray(intrinsics)
    s = depth.reshape(-1) / float((k[0, 0] + k[1, 1]) / 2)
    return s * s


def empty_params(capacity: int, num_frames: int, num_semantic: int = 0,
                 device="cpu") -> Params:
    """Capacity-shaped zero params; trajectory ``cam_unnorm_rots [1,4,F]``
    (identity) and ``cam_trans [1,3,F]``."""
    f32 = dict(dtype=torch.float32, device=device)
    rots = torch.zeros((capacity, 4), **f32)
    rots[:, 0] = 1.0
    cam_rots = torch.zeros((1, 4, num_frames), **f32)
    cam_rots[:, 0, :] = 1.0
    p: Params = {
        "means3D": torch.zeros((capacity, 3), **f32),
        "rgb_colors": torch.zeros((capacity, 3), **f32),
        "unnorm_rotations": rots,
        "logit_opacities": torch.zeros((capacity, 1), **f32),
        "log_scales": torch.zeros((capacity, 1), **f32),
        "cam_unnorm_rots": cam_rots,
        "cam_trans": torch.zeros((1, 3, num_frames), **f32),
    }
    if num_semantic > 0:
        p["semantic"] = torch.zeros((capacity, num_semantic), **f32)
    return p


def empty_variables(capacity: int, device="cpu") -> Variables:
    """Aux per-Gaussian bookkeeping plus the active mask and live count."""
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "active": torch.zeros((capacity,), dtype=torch.bool, device=device),
        "n_active": torch.zeros((), dtype=torch.int64, device=device),
        "max_2D_radius": torch.zeros((capacity,), **f32),
        "means2D_gradient_accum": torch.zeros((capacity,), **f32),
        "denom": torch.zeros((capacity,), **f32),
        "timestep": torch.zeros((capacity,), **f32),
        "scene_radius": torch.ones((), **f32),
    }


def insert_gaussians(
    params: Params,
    variables: Variables,
    new_fields: Params,
    mask: torch.Tensor,
    time_idx,
) -> Tuple[Params, Variables, torch.Tensor]:
    """Append the masked candidate rows into free capacity slots, in order.
    ``time_idx`` is one timestep for every row or a per-candidate ``[M]``
    tensor.  Returns (params, variables, n_overflowed); rows past capacity
    are counted, not lost silently."""
    capacity = params["means3D"].shape[0]
    n_active = variables["n_active"]
    slot = n_active + torch.cumsum(mask.to(torch.int64), 0) - 1
    ok = mask & (slot < capacity)
    tgt = slot[ok]
    out = dict(params)
    for k in GAUSSIAN_KEYS:
        if k not in params:
            continue
        dst = params[k].clone()
        dst[tgt] = new_fields[k][ok].to(dst.dtype)
        out[k] = dst
    n_insert = ok.sum()
    n_requested = mask.sum()
    variables = dict(variables)
    act = variables["active"].clone()
    act[tgt] = True
    variables["active"] = act
    ts = variables["timestep"].clone()
    ts[tgt] = time_idx[ok] if isinstance(time_idx, torch.Tensor) else float(time_idx)
    variables["timestep"] = ts
    variables["n_active"] = n_active + n_insert
    return out, variables, n_requested - n_insert


def pointcloud_fields(
    color: torch.Tensor,        # [3, H, W] in [0, 1]
    depth: torch.Tensor,        # [H, W]
    intrinsics,
    w2c,
    num_semantic: int,
    generator: Optional[torch.Generator] = None,
    semantic_init: Optional[torch.Tensor] = None,
) -> Params:
    """Candidate Gaussian rows from one RGB-D view (all H*W pixels; the
    caller masks).  Scale log sqrt((z/f)^2), opacity logit 0, identity
    rotations, semantic ~ U[0, 1) drawn from ``generator`` on its own
    device (a CPU generator gives the same draws whatever device the map
    lives on) — or taken from ``semantic_init`` [H*W, S] when given (tests
    feed both frameworks the same draws)."""
    pts = backproject(depth, intrinsics, w2c)
    m3sd = mean_sq_dist_projective(depth, intrinsics)
    n = pts.shape[0]
    dev = depth.device
    rots = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    rots[:, 0] = 1.0
    fields: Params = {
        "means3D": pts,
        "rgb_colors": color.reshape(3, -1).T,
        "unnorm_rotations": rots,
        "logit_opacities": torch.zeros((n, 1), dtype=torch.float32, device=dev),
        "log_scales": 0.5 * torch.log(m3sd.clamp_min(1e-12))[:, None],
    }
    if num_semantic > 0:
        if semantic_init is not None:
            fields["semantic"] = semantic_init.to(device=dev, dtype=torch.float32)
        else:
            gen_dev = generator.device if generator is not None else dev
            fields["semantic"] = torch.rand(
                (n, num_semantic), generator=generator, device=gen_dev
            ).to(dev)
    return fields


def compact_slots(params: Params, variables: Variables) -> Tuple[Params, Variables]:
    """Stable-partition live rows to the front of every capacity array,
    reclaiming prune holes as append slots (relative order kept)."""
    active = variables["active"]
    order = torch.sort((~active).to(torch.int8), stable=True).indices
    out = dict(params)
    for k in GAUSSIAN_KEYS:
        if k in params:
            out[k] = params[k][order]
    v = dict(variables)
    for k in PER_GAUSSIAN_VARS:
        v[k] = variables[k][order]
    v["n_active"] = active.sum()
    return out, v


def emergency_prune(
    params: Params, variables: Variables, need_free: int, max_fraction: float = 0.2
) -> Tuple[Variables, torch.Tensor]:
    """Deactivate the ``need_free`` least-opaque live gaussians, capped at
    ``max_fraction`` of the live map.  Returns (variables, n_freed)."""
    active = variables["active"]
    n_live = int(active.sum())
    k = min(int(need_free), int(max_fraction * n_live))
    opa = torch.where(
        active, params["logit_opacities"][:, 0],
        torch.full_like(params["logit_opacities"][:, 0], float("inf")),
    )
    if k > 0:
        thresh = torch.sort(opa).values[k - 1]
        drop = active & (opa <= thresh)
    else:
        drop = torch.zeros_like(active)
    v = dict(variables)
    v["active"] = active & ~drop
    return v, drop.sum()


def active_params_to_numpy(params: Params, variables: Variables) -> Dict[str, np.ndarray]:
    """Host-side compaction to live rows, for ``params.npz`` artifacts."""
    act = variables["active"].cpu().numpy()
    out = {}
    for k, v in params.items():
        v = v.detach().cpu().numpy()
        out[k] = v[act] if k in GAUSSIAN_KEYS else v
    out["timestep"] = variables["timestep"].cpu().numpy()[act]
    return out
