"""The procedural room of ``tools/procedural_room.py::render_frame`` in PyTorch.

A copy of the numpy ray-caster (commit 2c704bc) that runs on the card:
the same room (four walls, floor, ceiling, three boxes, two spheres), the
same textures, the same camera arc, the same float64 arithmetic.  The arc
is one turn every ``arc_frames`` frames; frame ``t`` of a longer sequence
goes round again.  Everything is computed on ``device``.
"""
from __future__ import annotations

import math

import torch

_PLANES = (
    # (p0, n, prim_id, uv axes)
    ((0.0, 0.0, 3.0), (0.0, 0.0, -1.0), 0, (0, 1)),    # back wall
    ((0.0, 0.0, -3.0), (0.0, 0.0, 1.0), 0, (0, 1)),    # front wall
    ((-3.0, 0.0, 0.0), (1.0, 0.0, 0.0), 0, (2, 1)),    # left
    ((3.0, 0.0, 0.0), (-1.0, 0.0, 0.0), 0, (2, 1)),    # right
    ((0.0, 1.4, 0.0), (0.0, -1.0, 0.0), 1, (0, 2)),    # floor
    ((0.0, -1.6, 0.0), (0.0, 1.0, 0.0), 2, (0, 2)),    # ceiling
)
_BOXES = (
    ((-1.8, 0.6, 1.0), (-0.8, 1.4, 2.0), 3),
    ((0.8, 0.9, -0.5), (1.8, 1.4, 0.6), 3),
    ((2.0, -0.8, 1.2), (2.6, 1.4, 1.9), 5),
)
_SPHERES = (
    ((-0.3, 0.9, 0.6), 0.5, 4),
    ((1.2, 0.35, 1.8), 0.35, 4),
)
NUM_PRIMS = 6


def camera_c2w(t_idx: int, arc_frames: int) -> torch.Tensor:
    """The arc's camera-to-world pose of frame ``t_idx`` (float64, CPU)."""
    n = max(arc_frames, 1)
    s, c = math.sin(2 * math.pi * t_idx / n), math.cos(2 * math.pi * t_idx / n)
    ang = 0.6 * s
    cy_, sy_ = math.cos(ang), math.sin(ang)
    c2w = torch.eye(4, dtype=torch.float64)
    c2w[:3, :3] = torch.tensor([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]], dtype=torch.float64)
    c2w[:3, 3] = torch.tensor([1.2 * s, -0.2, -1.0 + 0.8 * c], dtype=torch.float64)
    return c2w


def _texture(u, v, seed):
    t1 = 0.5 + 0.5 * torch.sin(2 * math.pi * (u * 1.5 + seed))
    t2 = (torch.floor(u * 6) + torch.floor(v * 6)) % 2
    t3 = 0.5 + 0.5 * torch.sin(2 * math.pi * (v * 11.0 + 2 * seed) + 3 * u)
    r = 0.25 + 0.5 * (0.5 * t1 + 0.5 * t2)
    g = 0.25 + 0.5 * (0.6 * t2 + 0.4 * t3)
    b = 0.25 + 0.5 * (0.7 * t3 + 0.3 * t1)
    return torch.stack([r, g, b], -1)


def _intersect_plane(o, d, p0, n):
    denom = d @ n
    par = torch.abs(denom) > 1e-8
    t = torch.where(par, ((p0 - o) @ n) / torch.where(par, denom, torch.ones_like(denom)),
                    torch.full_like(denom, math.inf))
    return torch.where(t > 0.05, t, torch.full_like(t, math.inf))


def _intersect_sphere(o, d, c, r):
    oc = o - c
    b = d @ oc
    disc = b * b - (oc @ oc - r * r)
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t = -b - sq
    return torch.where((disc > 0) & (t > 0.05), t, torch.full_like(t, math.inf))


def _intersect_box(o, d, lo, hi):
    inv = 1.0 / torch.where(torch.abs(d) > 1e-9, d, torch.full_like(d, 1e-9))
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = torch.minimum(t0, t1).amax(-1)
    tmax = torch.maximum(t0, t1).amin(-1)
    hit = tmax > torch.clamp_min(tmin, 0.05)
    return torch.where(hit, torch.where(tmin > 0.05, tmin, tmax),
                       torch.full_like(tmin, math.inf))


def render_frame(t_idx: int, W: int, H: int, fx: float, fy: float, cx: float, cy: float,
                 arc_frames: int, device="cpu"):
    """-> (colour [H, W, 3] uint8, depth [H, W] float32, c2w [4, 4] float64
    on the CPU, primitive id [H, W] int64), all but c2w on ``device``."""
    f64 = dict(dtype=torch.float64, device=device)
    c2w = camera_c2w(t_idx, arc_frames)
    R = c2w[:3, :3].to(device)
    o = c2w[:3, 3].to(device)
    ys, xs = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64), indexing="ij")
    dirs_cam = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)], -1)
    d = (dirs_cam @ R.T).reshape(H * W, 3)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    P = H * W
    best_t = torch.full((P,), math.inf, **f64)
    best_id = torch.zeros(P, dtype=torch.int64, device=device)
    best_uv = torch.zeros((P, 2), **f64)

    def take(t, pid, uv_of):
        nonlocal best_t, best_id, best_uv
        hit = t < best_t
        pts = o + t[:, None] * d
        best_uv = torch.where(hit[:, None], uv_of(pts), best_uv)
        best_id = torch.where(hit, torch.full_like(best_id, pid), best_id)
        best_t = torch.where(hit, t, best_t)

    for p0, n, pid, (ua, va) in _PLANES:
        t = _intersect_plane(o, d, torch.tensor(p0, **f64), torch.tensor(n, **f64))
        take(t, pid, lambda pts, ua=ua, va=va: pts[:, [ua, va]] * 0.5)
    for lo, hi, pid in _BOXES:
        t = _intersect_box(o, d, torch.tensor(lo, **f64), torch.tensor(hi, **f64))
        take(t, pid, lambda pts: pts[:, [0, 1]] * 1.3)
    for c, r, pid in _SPHERES:
        t = _intersect_sphere(o, d, torch.tensor(c, **f64), r)
        take(t, pid, lambda pts: pts[:, [0, 1]] * 2.0)

    color = _texture(best_uv[:, 0], best_uv[:, 1], best_id.to(torch.float64) * 0.37)
    z_cam = (d @ R)[:, 2] * best_t
    depth = torch.where(torch.isfinite(best_t), z_cam, torch.zeros_like(z_cam)).reshape(H, W)
    rgb = torch.clamp(color.reshape(H, W, 3) * 255, 0, 255).to(torch.uint8)
    return rgb, depth.to(torch.float32), c2w, best_id.reshape(H, W)
