"""Reconstruction replay from ``params.npz`` (port of ``hierslam_tpu/viz/recon.py``).

* ``render_trajectory_frames``: the map rendered along the saved
  trajectory into PNG frames (``recon_XXXX.png``, and ``sem_XXXX.png``
  with the semantic decode), headless, written by the port's own PNG
  encoder;
* ``interactive_replay``: the Open3D window replay of
  ``viz/geometry.replay_step_geometry``'s arrays, gated on open3d being
  installed.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from hierslam_torch.viz.geometry import (render_at, replay_step_geometry, subset_upto_timestep,
                                         viz_camera)


def render_trajectory_frames(
    params: Dict[str, np.ndarray],
    out_dir: str,
    config: Dict,
    every: int = 30,
    viz_scale: float = 0.5,
    online: bool = False,
    semantic: bool = False,
    mlp: Optional[Dict] = None,
    colormap: Optional[np.ndarray] = None,
    num_semantic=None,
    device="cuda",
):
    """Render RGB (and semantic) frames of the map along the saved
    trajectory, every ``every``-th frame, on ``device``.  Returns
    ``out_dir``."""
    from hierslam_torch.config import raster_config
    from hierslam_torch.eval.metrics import decode_tree_labels
    from hierslam_torch.slam.losses import mlp_apply
    from hierslam_torch.utils.image_io import write_png

    os.makedirs(out_dir, exist_ok=True)
    camera, _ = viz_camera(params, viz_scale)
    rc = raster_config(config)
    n_frames = params["cam_unnorm_rots"].shape[-1]
    for t in range(0, n_frames, every):
        p = subset_upto_timestep(params, t if online else None)
        out, _, _ = render_at(p, t, camera, rc, semantic and "semantic" in p, device)
        rgb = (out.im.permute(1, 2, 0).clamp(0, 1).cpu().numpy() * 255).astype(np.uint8)
        write_png(os.path.join(out_dir, f"recon_{t:04d}.png"), rgb)
        if semantic and out.semantic is not None and colormap is not None:
            if mlp is not None:
                w = {k: torch.as_tensor(np.asarray(v, np.float32), device=out.semantic.device)
                     for k, v in mlp.items()}
                with torch.no_grad():
                    labels = mlp_apply(w, out.semantic).argmax(0).cpu().numpy()
            elif isinstance(num_semantic, (list, tuple)):
                labels = decode_tree_labels(out.semantic.cpu().numpy(), list(num_semantic))[-1]
            else:
                labels = out.semantic.argmax(0).cpu().numpy()
            vis = colormap[np.clip(labels, 0, len(colormap) - 1)][..., :3].astype(np.uint8)
            write_png(os.path.join(out_dir, f"sem_{t:04d}.png"), vis)
    return out_dir


def interactive_replay(
    params: Dict[str, np.ndarray],
    config: Dict,
    every: int = 1,
    online: bool = True,
    viz_scale: float = 0.5,
    pcd_stride: int = 2,
    fps: float = 10.0,
    semantic: bool = False,
    mlp: Optional[Dict] = None,
    colormap: Optional[np.ndarray] = None,
    num_semantic=None,
    device="cuda",
):
    """Open3D interactive replay: per step the map's point cloud (semantic
    palette colours with ``semantic``), the camera frustum and the
    trajectory, then the window stays open.  Raises ImportError without
    open3d."""
    try:
        import open3d as o3d
    except ImportError as e:
        raise ImportError(
            "open3d is required for interactive replay; use "
            "render_trajectory_frames for headless rendering"
        ) from e

    n_frames = params["cam_unnorm_rots"].shape[-1]
    vis = o3d.visualization.Visualizer()
    H = int(params["org_height"] * viz_scale)
    W = int(params["org_width"] * viz_scale)
    vis.create_window(width=W, height=H, visible=True)

    pcd = o3d.geometry.PointCloud()
    frustum = o3d.geometry.LineSet()
    traj = o3d.geometry.LineSet()
    added = False
    for t in range(0, n_frames, every):
        g = replay_step_geometry(
            params, config, t, online=online, viz_scale=viz_scale, pcd_stride=pcd_stride,
            semantic=semantic, mlp=mlp, colormap=colormap, num_semantic=num_semantic,
            device=device,
        )
        pcd.points = o3d.utility.Vector3dVector(g["points"])
        pcd.colors = o3d.utility.Vector3dVector(
            g["sem_colors"] if g.get("sem_colors") is not None else g["colors"])
        frustum.points = o3d.utility.Vector3dVector(g["frustum_verts"])
        frustum.lines = o3d.utility.Vector2iVector(g["frustum_lines"])
        frustum.paint_uniform_color([0.0, 0.8, 0.8])
        traj.points = o3d.utility.Vector3dVector(g["traj_verts"])
        traj.lines = o3d.utility.Vector2iVector(g["traj_lines"])
        if len(g["traj_colors"]):
            traj.colors = o3d.utility.Vector3dVector(g["traj_colors"])
        for geom in (pcd, frustum, traj):
            (vis.update_geometry if added else vis.add_geometry)(geom)
        added = True
        if not vis.poll_events():
            break
        vis.update_renderer()
        time.sleep(1.0 / fps)
    vis.run()  # the window stays interactive after the replay
    vis.destroy_window()
