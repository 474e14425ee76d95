"""Camera model for the rasterizer (port of ``hierslam_tpu/core/camera.py``).

An OpenGL-style projection with near=0.01 / far=100, ``tanfov = w/(2 fx)``
and a full projection ``proj @ w2c``, as setup_camera of the reference.
All fields are host values (numpy arrays / python floats); the ops turn
them into tensors on the device they run on.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Camera(NamedTuple):
    """Rasterization camera (static, host-side)."""

    width: int
    height: int
    w2c: np.ndarray          # [4, 4] world->camera
    full_proj: np.ndarray    # [4, 4] proj @ w2c
    cam_pos: np.ndarray      # [3] camera center in world frame
    tan_fovx: float
    tan_fovy: float
    focal_x: float
    focal_y: float
    bg: np.ndarray           # [3] background color (always black)
    intrinsics: np.ndarray   # [3, 3] pinhole K
    near: float = 0.01
    far: float = 100.0
    scale_modifier: float = 1.0
    # a strip camera (tile-sharded rendering) rasterizes ``height`` rows of
    # an image whose projection was built for ``proj_height`` rows
    proj_height: int = 0


def strip_camera(camera: Camera, strip_height: int) -> Camera:
    """A camera that rasterizes only ``strip_height`` rows of the full
    image; combine with ``pixel_offset_y`` to select which rows."""
    return camera._replace(height=strip_height, proj_height=camera.height)


def opengl_projection(w: int, h: int, fx, fy, cx, cy, near=0.01, far=100.0) -> np.ndarray:
    """OpenGL-style projection matrix."""
    return np.array(
        [
            [2 * fx / w, 0.0, -(w - 2 * cx) / w, 0.0],
            [0.0, 2 * fy / h, -(h - 2 * cy) / h, 0.0],
            [0.0, 0.0, far / (far - near), -(far * near) / (far - near)],
            [0.0, 0.0, 1.0, 0.0],
        ],
        dtype=np.float32,
    )


def setup_camera(w: int, h: int, k, w2c, near: float = 0.01, far: float = 100.0) -> Camera:
    """Build a :class:`Camera` from intrinsics ``k`` (3x3) and a 4x4 ``w2c``."""
    k = np.asarray(k, dtype=np.float32)
    w2c = np.asarray(w2c, dtype=np.float32)
    fx, fy, cx, cy = float(k[0, 0]), float(k[1, 1]), float(k[0, 2]), float(k[1, 2])
    proj = opengl_projection(w, h, fx, fy, cx, cy, near, far)
    cam_pos = np.linalg.inv(w2c)[:3, 3]
    return Camera(
        width=int(w),
        height=int(h),
        w2c=w2c,
        full_proj=(proj @ w2c).astype(np.float32),
        cam_pos=cam_pos.astype(np.float32),
        tan_fovx=w / (2 * fx),
        tan_fovy=h / (2 * fy),
        focal_x=fx,
        focal_y=fy,
        bg=np.zeros(3, dtype=np.float32),
        intrinsics=k,
        near=near,
        far=far,
    )


def intrinsics_matrix(fx, fy, cx, cy) -> np.ndarray:
    K = np.eye(3, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K
