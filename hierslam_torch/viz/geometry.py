"""Display-independent geometry for reconstruction replay (port of
``hierslam_tpu/viz/geometry.py``).

The Open3D replay (``viz/recon.interactive_replay``) only wraps these
arrays in Open3D objects: the point cloud of the map rendered at the
estimated pose, the camera frustum wireframe and the trajectory polyline.
Rendering runs on ``device`` (the GPU unless ``device="cpu"``); the rest
is numpy.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hierslam_torch import resolve_device

_GAUSS_KEYS = ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales",
               "semantic")


def rgbd_to_pointcloud(
    im: np.ndarray,       # [3, H, W] in [0, 1]
    depth: np.ndarray,    # [H, W] meters
    intrinsics: np.ndarray,  # [3, 3]
    w2c: np.ndarray,      # [4, 4]
    stride: int = 1,
    max_depth: float = 1e6,
) -> Tuple[np.ndarray, np.ndarray]:
    """Back-project a rendered RGB-D frame to a world-frame coloured point
    cloud: (points [M, 3] float64, colours [M, 3] in [0, 1])."""
    H, W = depth.shape
    ys, xs = np.meshgrid(np.arange(0, H, stride), np.arange(0, W, stride), indexing="ij")
    d = depth[ys, xs]
    valid = (d > 0) & (d < max_depth)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x_cam = (xs - cx) / fx * d
    y_cam = (ys - cy) / fy * d
    pts_cam = np.stack([x_cam, y_cam, d, np.ones_like(d)], -1)[valid]
    c2w = np.linalg.inv(w2c)
    pts = (pts_cam @ c2w.T)[:, :3]
    cols = im[:, ys, xs].transpose(1, 2, 0)[valid]
    return pts, np.clip(cols, 0, 1)


def camera_frustum_geometry(width: int, height: int, intrinsics: np.ndarray, w2c: np.ndarray,
                            size: float = 0.045) -> Tuple[np.ndarray, np.ndarray]:
    """Camera-frustum wireframe: the apex at the camera centre and the 4
    image corners back-projected to depth ``size``.  Returns (vertices
    [5, 3], lines [8, 2] int)."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    corners_px = np.array([[0.0, 0.0], [width, 0.0], [width, height], [0.0, height]])
    x = (corners_px[:, 0] - cx) / fx * size
    y = (corners_px[:, 1] - cy) / fy * size
    cam_pts = np.concatenate([np.zeros((1, 3)), np.stack([x, y, np.full(4, size)], -1)], axis=0)
    c2w = np.linalg.inv(w2c)
    verts = cam_pts @ c2w[:3, :3].T + c2w[:3, 3]
    lines = np.array([[0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [2, 3], [3, 4], [4, 1]], np.int64)
    return verts, lines


def trajectory_geometry(w2cs: List[np.ndarray], upto: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The polyline through the camera centres: (vertices [T, 3], lines
    [T-1, 2], colours [T-1, 3] on matplotlib's 'cool' ramp)."""
    n = len(w2cs) if upto is None else min(upto + 1, len(w2cs))
    centers = np.stack([np.linalg.inv(w2cs[i])[:3, 3] for i in range(n)])
    if n < 2:
        return centers, np.zeros((0, 2), np.int64), np.zeros((0, 3))
    lines = np.stack([np.arange(n - 1), np.arange(1, n)], -1)
    t = np.arange(n - 1) / max(n - 1, 1)
    colors = np.stack([t, 1.0 - t, np.ones_like(t)], -1)
    return centers, lines, colors


def subset_upto_timestep(params: Dict[str, np.ndarray], t: Optional[int]):
    """The gaussians added up to timestep ``t`` (the saved ``timestep``
    field); all of them when ``t`` is None."""
    if t is None or "timestep" not in params:
        return params
    keep = params["timestep"] <= t
    out = dict(params)
    for k in _GAUSS_KEYS + ("timestep",):
        if k in out and out[k].ndim >= 1 and out[k].shape[0] == keep.shape[0]:
            out[k] = out[k][keep]
    return out


def _tensor(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def semantic_point_colors(sem_img: np.ndarray, colormap: np.ndarray,
                          mlp: Optional[Dict] = None, num_semantic=None) -> np.ndarray:
    """Rendered semantic channels [S, H, W] -> palette colours [H, W, 3] in
    [0, 1]: the decoder's argmax leaf when ``mlp`` is given, else the last
    level of the per-level tree decode, else the flat argmax."""
    from hierslam_torch.eval.metrics import decode_tree_labels
    from hierslam_torch.slam.losses import mlp_apply

    if mlp is not None:
        with torch.no_grad():
            labels = mlp_apply({k: _tensor(v, "cpu") for k, v in mlp.items()},
                               _tensor(sem_img, "cpu")).argmax(0).numpy()
    elif isinstance(num_semantic, (list, tuple)):
        labels = decode_tree_labels(sem_img, list(num_semantic))[-1]
    else:
        labels = np.argmax(sem_img, 0)
    cmap = np.asarray(colormap, np.float64)[:, :3]
    if cmap.max() > 1.0:
        cmap = cmap / 255.0
    return cmap[np.clip(labels, 0, len(cmap) - 1)]


def viz_camera(params: Dict[str, np.ndarray], viz_scale: float):
    """(camera, K) of the run's frames scaled by ``viz_scale``."""
    from hierslam_torch.core.camera import setup_camera

    H, W = int(params["org_height"]), int(params["org_width"])
    vh, vw = int(H * viz_scale), int(W * viz_scale)
    K = params["intrinsics"][:3, :3].copy()
    K[0] *= vw / W
    K[1] *= vh / H
    return setup_camera(vw, vh, K, params["w2c"]), K


def render_at(params: Dict[str, np.ndarray], t: int, camera, rc, with_semantic: bool,
              device="cuda"):
    """The map of ``params`` (numpy, a ``params.npz``) rendered at frame
    ``t``'s estimated pose on ``device``: (RenderOutput, q, t)."""
    from hierslam_torch.slam.losses import render_gaussians

    dev = resolve_device(device)
    gauss = {k: _tensor(v, dev) for k, v in params.items() if k in _GAUSS_KEYS}
    q = _tensor(params["cam_unnorm_rots"][0, :, t], dev)
    tr = _tensor(params["cam_trans"][0, :, t], dev)
    with torch.no_grad():
        out = render_gaussians(gauss, None, q, tr, camera, rc, with_semantic=with_semantic,
                               gaussians_grad=False, camera_grad=False)
    return out, q, tr


def replay_step_geometry(
    params: Dict[str, np.ndarray],
    config: Dict,
    t: int,
    online: bool = True,
    viz_scale: float = 0.5,
    pcd_stride: int = 1,
    frustum_size: float = 0.045,
    semantic: bool = False,
    mlp: Optional[Dict] = None,
    colormap: Optional[np.ndarray] = None,
    num_semantic=None,
    device="cuda",
):
    """All display-independent geometry of replay step ``t``: the map
    rendered at the estimated pose as a point cloud (with ``semantic`` and
    a palette also ``sem_colors``, aligned with ``points``), the camera
    frustum and the trajectory so far.  Returns a dict of numpy arrays."""
    from hierslam_torch.config import raster_config
    from hierslam_torch.core.transforms import build_w2c, normalize

    camera, K = viz_camera(params, viz_scale)
    vw, vh = camera.width, camera.height
    with_sem = semantic and "semantic" in params
    p = subset_upto_timestep(params, t if online else None)
    out, q, tr = render_at(p, t, camera, raster_config(config), with_sem, device)
    est_w2c = build_w2c(normalize(q), tr).cpu().numpy()
    im, depth = out.im.cpu().numpy(), out.depth.cpu().numpy()
    # the render is already in the estimated camera's frame
    pts, cols = rgbd_to_pointcloud(im, depth, K, np.eye(4), pcd_stride)
    sem_cols = None
    if with_sem and out.semantic is not None and colormap is not None:
        sem_rgb = semantic_point_colors(out.semantic.cpu().numpy(), colormap, mlp=mlp,
                                        num_semantic=num_semantic)
        ys, xs = np.meshgrid(np.arange(0, depth.shape[0], pcd_stride),
                             np.arange(0, depth.shape[1], pcd_stride), indexing="ij")
        sem_cols = sem_rgb[ys, xs][depth[ys, xs] > 0]
    c2w = np.linalg.inv(est_w2c)
    pts = pts @ c2w[:3, :3].T + c2w[:3, 3]

    all_w2cs = [build_w2c(normalize(_tensor(params["cam_unnorm_rots"][0, :, i], "cpu")),
                          _tensor(params["cam_trans"][0, :, i], "cpu")).numpy()
                for i in range(t + 1)]
    fr_verts, fr_lines = camera_frustum_geometry(vw, vh, K, est_w2c, frustum_size)
    tr_verts, tr_lines, tr_cols = trajectory_geometry(all_w2cs)
    return {
        "points": pts, "colors": cols, "sem_colors": sem_cols,
        "frustum_verts": fr_verts, "frustum_lines": fr_lines,
        "traj_verts": tr_verts, "traj_lines": tr_lines, "traj_colors": tr_cols,
    }
