"""Per-Gaussian screen-space preprocessing (port of ``hierslam_tpu/ops/projection.py``).

Near cull, EWA projection to a 2D covariance with the +0.3 low-pass, conic,
3-sigma radius and the screen-space tile rectangle (getRect).  Isotropic
maps (scales ``[N, 1]``) use ``cov2d = s^2 T T^T + 0.3 I`` directly; the
rotation-invariant form needs no quaternion.  Anisotropic maps (scales
``[N, 3]``) go through ``R S S R^T``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hierslam_torch.core.transforms import quat_to_rotmat


class Preprocessed(NamedTuple):
    xy: torch.Tensor          # [N, 2] pixel-space mean
    depth: torch.Tensor       # [N] camera-space z
    conic: torch.Tensor       # [N, 3] (a, b, c) of the inverse 2D covariance
    radius: torch.Tensor      # [N] int32 screen radius (0 => culled)
    rect_min: torch.Tensor    # [N, 2] int32 (tx, ty) inclusive
    rect_max: torch.Tensor    # [N, 2] int32 (tx, ty) exclusive
    valid: torch.Tensor       # [N] bool
    tiles_touched: torch.Tensor  # [N] int32


class PrepCols(NamedTuple):
    """:class:`Preprocessed` as 1-D columns."""

    x: torch.Tensor
    y: torch.Tensor
    depth: torch.Tensor
    conic_a: torch.Tensor
    conic_b: torch.Tensor
    conic_c: torch.Tensor
    radius: torch.Tensor
    rect_min_x: torch.Tensor
    rect_min_y: torch.Tensor
    rect_max_x: torch.Tensor
    rect_max_y: torch.Tensor
    valid: torch.Tensor
    tiles_touched: torch.Tensor

    def stacked(self) -> Preprocessed:
        return Preprocessed(
            xy=torch.stack([self.x, self.y], -1),
            depth=self.depth,
            conic=torch.stack([self.conic_a, self.conic_b, self.conic_c], -1),
            radius=self.radius,
            rect_min=torch.stack([self.rect_min_x, self.rect_min_y], -1),
            rect_max=torch.stack([self.rect_max_x, self.rect_max_y], -1),
            valid=self.valid,
            tiles_touched=self.tiles_touched,
        )


def quat_scale_to_cov3d(rotations: torch.Tensor, scales: torch.Tensor,
                        mod: float = 1.0) -> torch.Tensor:
    """``R S S^T R^T`` world covariance [N, 3, 3] (``rotations`` are
    normalized here)."""
    R = quat_to_rotmat(rotations)
    M = R * (mod * scales)[:, None, :]
    return M @ M.transpose(-1, -2)


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def preprocess(means3D, scales, rotations, camera, tile_shape, active=None,
               radius_margin_px: float = 0.0, pixel_offset_y: float = 0.0) -> Preprocessed:
    """Project Gaussians to screen space (stacked ``[N, c]`` form)."""
    return preprocess_cols(
        means3D, scales, rotations, camera, tile_shape, active=active,
        radius_margin_px=radius_margin_px, pixel_offset_y=pixel_offset_y,
    ).stacked()


def preprocess_cols(
    means3D: torch.Tensor,
    scales: torch.Tensor,
    rotations: Optional[torch.Tensor],
    camera,
    tile_shape: Tuple[int, int],
    active: Optional[torch.Tensor] = None,
    radius_margin_px: float = 0.0,
    pixel_offset_y: float = 0.0,
) -> PrepCols:
    """Project Gaussians to screen space.

    ``scales`` are post-exp: ``[N, 1]`` isotropic (``rotations`` unused) or
    ``[N, 3]`` anisotropic with unit ``rotations [N, 4]``.  A strip camera
    (``core.camera.strip_camera``) with ``pixel_offset_y`` renders image
    rows ``[pixel_offset_y, pixel_offset_y + camera.height)`` as its rows
    ``[0, camera.height)``.
    """
    th, tw = tile_shape
    dev = means3D.device
    w2c = torch.as_tensor(np.asarray(camera.w2c), dtype=torch.float32, device=dev)
    full = torch.as_tensor(np.asarray(camera.full_proj), dtype=torch.float32, device=dev)
    mx, my, mz = means3D[:, 0], means3D[:, 1], means3D[:, 2]

    def apply_row(M, r):
        return M[r, 0] * mx + M[r, 1] * my + M[r, 2] * mz + M[r, 3]

    pv_x = apply_row(w2c, 0)
    pv_y = apply_row(w2c, 1)
    depth = apply_row(w2c, 2)
    in_frustum = depth > 0.2

    ph_x = apply_row(full, 0)
    ph_y = apply_row(full, 1)
    ph_w = apply_row(full, 3)
    p_w = 1.0 / (ph_w + 1e-7)

    limx = 1.3 * camera.tan_fovx
    limy = 1.3 * camera.tan_fovy
    tz = depth
    safe_tz = torch.where(tz == 0, torch.ones_like(tz), tz)
    inv_z = 1.0 / safe_tz
    inv_z2 = inv_z * inv_z
    tx = torch.clamp(pv_x * inv_z, -limx, limx) * tz
    ty = torch.clamp(pv_y * inv_z, -limy, limy) * tz
    fx, fy = camera.focal_x, camera.focal_y
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2
    Wr = w2c[:3, :3]
    t0 = [j00 * Wr[0, c] + j02 * Wr[2, c] for c in range(3)]
    t1 = [j11 * Wr[1, c] + j12 * Wr[2, c] for c in range(3)]

    if scales.shape[1] == 1:
        s2 = (camera.scale_modifier * scales[:, 0]) ** 2
        c_xx = s2 * (t0[0] * t0[0] + t0[1] * t0[1] + t0[2] * t0[2]) + 0.3
        c_xy = s2 * (t0[0] * t1[0] + t0[1] * t1[1] + t0[2] * t1[2])
        c_yy = s2 * (t1[0] * t1[0] + t1[1] * t1[1] + t1[2] * t1[2]) + 0.3
    else:
        cov3d = quat_scale_to_cov3d(rotations, scales, camera.scale_modifier)
        a0 = [t0[0] * cov3d[:, 0, c] + t0[1] * cov3d[:, 1, c] + t0[2] * cov3d[:, 2, c]
              for c in range(3)]
        b1 = [t1[0] * cov3d[:, 0, c] + t1[1] * cov3d[:, 1, c] + t1[2] * cov3d[:, 2, c]
              for c in range(3)]
        c_xx = a0[0] * t0[0] + a0[1] * t0[1] + a0[2] * t0[2] + 0.3
        c_xy = a0[0] * t1[0] + a0[1] * t1[1] + a0[2] * t1[2]
        c_yy = b1[0] * t1[0] + b1[1] * t1[1] + b1[2] * t1[2] + 0.3

    det = c_xx * c_yy - c_xy * c_xy
    det_valid = det != 0.0
    det_inv = 1.0 / torch.where(det_valid, det, torch.ones_like(det))
    conic_a = c_yy * det_inv
    conic_b = -c_xy * det_inv
    conic_c = c_xx * det_inv

    with torch.no_grad():
        mid = 0.5 * (c_xx + c_yy)
        sq = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        radius_f = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + sq, mid - sq)))

    orig_h = camera.proj_height or camera.height
    px = ndc2pix(ph_x * p_w, camera.width)
    py = ndc2pix(ph_y * p_w, orig_h)
    if pixel_offset_y:
        py = py - pixel_offset_y

    grid_x = (camera.width + tw - 1) // tw
    grid_y = (camera.height + th - 1) // th
    with torch.no_grad():
        px_ng, py_ng = px.detach(), py.detach()
        rad_rect = radius_f + radius_margin_px
        def tile_edge(v, size, grid_n):
            return torch.clamp(torch.floor(v / size), 0, grid_n).to(torch.int32)

        rect_min_x = tile_edge(px_ng - rad_rect, tw, grid_x)
        rect_min_y = tile_edge(py_ng - rad_rect, th, grid_y)
        rect_max_x = tile_edge(px_ng + rad_rect + tw - 1, tw, grid_x)
        rect_max_y = tile_edge(py_ng + rad_rect + th - 1, th, grid_y)
        tiles_touched = (rect_max_x - rect_min_x) * (rect_max_y - rect_min_y)
        valid = in_frustum & det_valid & (tiles_touched > 0)
        if active is not None:
            valid = valid & active
        radius = torch.where(valid, radius_f, torch.zeros_like(radius_f)).to(torch.int32)
        tiles_touched = torch.where(valid, tiles_touched, torch.zeros_like(tiles_touched))

    return PrepCols(
        x=px, y=py, depth=depth, conic_a=conic_a, conic_b=conic_b,
        conic_c=conic_c, radius=radius, rect_min_x=rect_min_x,
        rect_min_y=rect_min_y, rect_max_x=rect_max_x, rect_max_y=rect_max_y,
        valid=valid, tiles_touched=tiles_touched,
    )
