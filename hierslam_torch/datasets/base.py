"""RGB-D dataset base (port of ``hierslam_tpu/datasets/base.py``): the
gradslam directory and preprocessing contract on numpy, with the port's
own image and YAML readers (``utils/image_io.py``) in place of ``cv2``,
``imageio`` and PyYAML.

* subclass hooks ``get_filepaths`` / ``load_poses``;
* start/end/stride subsampling;
* colour resized as ``cv2.resize(INTER_LINEAR)``, depth and labels as
  ``cv2.resize(INTER_NEAREST)`` (``resize``), depth then divided by
  ``png_depth_scale``;
* intrinsics rescaled by the resize ratios;
* poses normalized relative to frame 0;
* ``__getitem__`` -> (color HWC float32 in [0,255], depth HW float32
  meters, intrinsics 4x4, c2w pose 4x4) as numpy arrays.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from hierslam_torch.utils.image_io import load_yaml, read_image


def natsorted(paths: List[str]) -> List[str]:
    """Natural sort (numeric-aware)."""

    def key(s):
        return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", s)]

    return sorted(paths, key=key)


def load_dataset_config(path: str, default_path: Optional[str] = None) -> Dict:
    """YAML camera-config loader with recursive ``inherit_from`` merging."""
    cfg_special = load_yaml(path)
    inherit = cfg_special.get("inherit_from")
    if inherit is not None:
        cfg = load_dataset_config(inherit, default_path)
    elif default_path is not None:
        cfg = load_yaml(default_path)
    else:
        cfg = {}
    _update_recursive(cfg, cfg_special)
    return cfg


def _update_recursive(dict1: Dict, dict2: Dict):
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = {} if isinstance(v, dict) else None
        if isinstance(v, dict):
            _update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def as_intrinsics_matrix(fx, fy, cx, cy) -> np.ndarray:
    K = np.eye(3, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K


def relative_poses(poses: np.ndarray) -> np.ndarray:
    """Normalize a pose sequence to frame 0."""
    inv0 = np.linalg.inv(poses[0])
    return np.einsum("ij,njk->nik", inv0, poses)


def _linear_taps(src: int, dst: int):
    """cv2's INTER_LINEAR source indices and weights along one axis (for
    float64 images): half-pixel centres, clamped at the edges."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst) + 0.5) * scale - 0.5
    i0 = np.floor(f).astype(np.int64)
    a1 = f - i0
    a1[(i0 < 0) | (i0 >= src - 1)] = 0
    i0 = np.clip(i0, 0, src - 1)
    i1 = np.minimum(i0 + 1, src - 1)
    return i0, i1, 1 - a1, a1


def resize(img: np.ndarray, width: int, height: int, nearest: bool) -> np.ndarray:
    """``cv2.resize(img, (width, height), INTER_NEAREST or INTER_LINEAR)``
    on a [H, W] or [H, W, C] array.

    The same size returns a copy.  INTER_NEAREST takes source index
    ``floor(dst * src/dst)``.  INTER_LINEAR interpolates horizontally, then
    vertically, in float64 at half-pixel centres, clamped at the edges.
    cv2's INTER_AREA special case at an exact 2x reduction gives the same
    values: there the taps are 0.5/0.5 and no edge clamp applies."""
    h0, w0 = img.shape[:2]
    if (h0, w0) == (height, width):
        return img.copy()
    if nearest:
        ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h0))).astype(np.int64),
                        h0 - 1)
        xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w0))).astype(np.int64),
                        w0 - 1)
        return img[ys][:, xs]
    src = img.astype(np.float64)
    x0, x1, a0, a1 = _linear_taps(w0, width)
    y0, y1, b0, b1 = _linear_taps(h0, height)
    ex = (slice(None),) + (None,) * (img.ndim - 2)
    rows = src[:, x0] * a0[ex] + src[:, x1] * a1[ex]
    out = rows[y0] * b0[(slice(None), None) + ex[1:]] + rows[y1] * b1[(slice(None), None) + ex[1:]]
    return out.astype(img.dtype) if img.dtype.kind == "f" else out


class RGBDDataset:
    """Base class.  Subclasses set ``self.input_folder`` (and optionally
    ``self.pose_path``) before calling ``super().__init__``."""

    def __init__(
        self,
        config_dict: Dict,
        stride: Optional[int] = 1,
        start: int = 0,
        end: int = -1,
        desired_height: int = 480,
        desired_width: int = 640,
        relative_pose: bool = True,
        **kwargs,
    ):
        stride = stride or 1
        self.name = config_dict["dataset_name"]
        cam = config_dict["camera_params"]
        self.png_depth_scale = cam["png_depth_scale"]
        self.orig_height = cam["image_height"]
        self.orig_width = cam["image_width"]
        self.fx, self.fy = cam["fx"], cam["fy"]
        self.cx, self.cy = cam["cx"], cam["cy"]
        if cam.get("distortion"):
            raise NotImplementedError(
                "undistorting colour frames (camera_params.distortion, TUM) is not ported "
                "yet (ROADMAP.md, queue 1 path 5)")
        self.distortion = None
        self.crop_edge = cam.get("crop_edge")

        self.desired_height = desired_height
        self.desired_width = desired_width
        self.height_ratio = desired_height / self.orig_height
        self.width_ratio = desired_width / self.orig_width

        if start < 0:
            raise ValueError("start must be positive")
        if not (end == -1 or end > start):
            raise ValueError("end must be -1 or > start")
        self.start, self.end, self.stride = start, end, stride

        self.color_paths, self.depth_paths = self.get_filepaths()
        if len(self.color_paths) != len(self.depth_paths):
            raise ValueError("color/depth count mismatch")
        self.num_imgs = len(self.color_paths)
        poses = self.load_poses()

        if self.end == -1:
            self.end = self.num_imgs
        sl = slice(self.start, self.end, stride)
        self.color_paths = self.color_paths[sl]
        self.depth_paths = self.depth_paths[sl]
        poses = poses[sl]
        self.retained_inds = np.arange(self.num_imgs)[sl]
        self.num_imgs = len(self.color_paths)

        self.poses = np.stack(poses).astype(np.float32)
        self.transformed_poses = (
            relative_poses(self.poses) if relative_pose else self.poses
        )

    # -- subclass hooks -----------------------------------------------------
    def get_filepaths(self) -> Tuple[List[str], List[str]]:
        raise NotImplementedError

    def load_poses(self) -> List[np.ndarray]:
        raise NotImplementedError

    # -- preprocessing ------------------------------------------------------
    def _preprocess_color(self, color: np.ndarray) -> np.ndarray:
        return resize(color, self.desired_width, self.desired_height, nearest=False)

    def _preprocess_depth(self, depth: np.ndarray) -> np.ndarray:
        depth = resize(depth.astype(float), self.desired_width, self.desired_height,
                       nearest=True)
        return depth / self.png_depth_scale

    def _preprocess_label(self, label: np.ndarray) -> np.ndarray:
        return resize(label, self.desired_width, self.desired_height, nearest=True)

    def scaled_intrinsics(self) -> np.ndarray:
        K = as_intrinsics_matrix(self.fx, self.fy, self.cx, self.cy)
        K[0] *= self.width_ratio
        K[1] *= self.height_ratio
        return K

    def _read_depth(self, path: str) -> np.ndarray:
        return np.asarray(read_image(path), dtype=np.int64)

    def __len__(self):
        return self.num_imgs

    def load_rgbd(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        color = np.asarray(read_image(self.color_paths[index]), dtype=float)
        color = self._preprocess_color(color)
        depth = self._preprocess_depth(self._read_depth(self.depth_paths[index]))
        return color.astype(np.float32), depth.astype(np.float32)

    def __getitem__(self, index: int):
        color, depth = self.load_rgbd(index)
        K4 = np.eye(4, dtype=np.float32)
        K4[:3, :3] = self.scaled_intrinsics()
        return color, depth, K4, self.transformed_poses[index]
