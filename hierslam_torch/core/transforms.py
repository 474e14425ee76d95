"""Quaternion / rigid-transform math (port of ``hierslam_tpu/core/transforms.py``).

Quaternions are ``(w, x, y, z)`` real-first; ``matrix_to_quaternion`` is the
branch-free pytorch3d construction.
"""
from __future__ import annotations

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along ``dim``, dividing by max(norm, eps)."""
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return v / n.clamp_min(eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) ``[..., 4]`` (normalized here) -> rotation ``[..., 3, 3]``."""
    q = normalize(q)
    r, x, y, z = q.unbind(-1)
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


def quat_mult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of ``[..., 4]`` quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    return torch.stack([w, x, y, z], -1)


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, torch.sqrt(x.clamp_min(0.0)), torch.zeros_like(x))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation ``[..., 3, 3]`` -> quaternion ``[..., 4]`` (w, x, y, z)."""
    batch = matrix.shape[:-2]
    m = matrix.reshape(batch + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.unbind(-1)
    q_abs = _sqrt_positive_part(
        torch.stack(
            [
                1.0 + m00 + m11 + m22,
                1.0 + m00 - m11 - m22,
                1.0 - m00 + m11 - m22,
                1.0 - m00 - m11 + m22,
            ],
            -1,
        )
    )
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
        ],
        -2,
    )
    quat_candidates = quat_by_rijk / (2.0 * q_abs[..., None].clamp_min(0.1))
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(batch + (1, 4))
    return torch.gather(quat_candidates, -2, idx).squeeze(-2)


def build_w2c(cam_quat: torch.Tensor, cam_trans: torch.Tensor) -> torch.Tensor:
    """Pose parameters -> 4x4 world-to-camera: ``[R(normalize(q)) | t]``."""
    R = quat_to_rotmat(cam_quat)
    top = torch.cat([R, cam_trans[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    bottom = bottom.expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 homogeneous transform to ``[N, 3]`` points (full f32)."""
    return pts @ T[:3, :3].T + T[:3, 3]


def transform_to_frame(
    means3D: torch.Tensor,
    unnorm_rotations: torch.Tensor,
    cam_quat: torch.Tensor,
    cam_trans: torch.Tensor,
    *,
    gaussians_grad: bool,
    camera_grad: bool,
    transform_rots: bool = False,
):
    """World-frame Gaussians -> camera frame, with gradient routing: during
    tracking only the pose gets gradient, during mapping only the Gaussians.
    Isotropic maps skip the rotation transform."""
    if not camera_grad:
        cam_quat = cam_quat.detach()
        cam_trans = cam_trans.detach()
    if not gaussians_grad:
        means3D = means3D.detach()
        unnorm_rotations = unnorm_rotations.detach()
    cam_quat_n = normalize(cam_quat)
    w2c = build_w2c(cam_quat_n, cam_trans)
    pts = transform_points(w2c, means3D)
    if transform_rots:
        rots = quat_mult(cam_quat_n, normalize(unnorm_rotations))
    else:
        rots = unnorm_rotations
    return pts, rots


def relative_transformation(trans_01: torch.Tensor, trans_02: torch.Tensor) -> torch.Tensor:
    """Pose of frame 2 relative to frame 1: ``inv(T_01) @ T_02``."""
    return torch.linalg.inv(trans_01) @ trans_02
