"""Keyframe store + overlap-based window selection (host-side numpy; a
port-owned copy of ``hierslam_tpu/slam/keyframes.py``).

Reproduces utils/keyframe_selection.py:40-96: sample 1600 valid-depth
pixels of the current frame, back-project with the current estimated pose,
reproject into every stored keyframe, rank by fraction landing inside a
20-px margin with positive depth, then take a random permutation of the
positive-overlap keyframes (the reference permutes *after* sorting, so the
sort only filters — replicated faithfully).

Runs once per mapping phase on the host (numpy): keyframe images live in
host RAM and are uploaded once per mapping phase.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class Keyframe:
    id: int
    w2c: np.ndarray                    # [4,4] estimated
    color: np.ndarray                  # [3,H,W] float32 in [0,1]
    depth: np.ndarray                  # [H,W] float32
    labels: Optional[np.ndarray] = None  # [L+1,H,W] int32


class KeyframeStore:
    def __init__(self):
        self.frames: List[Keyframe] = []

    def add(self, kf: Keyframe):
        self.frames.append(kf)

    @property
    def time_indices(self) -> List[int]:
        return [f.id for f in self.frames]

    def __len__(self):
        return len(self.frames)


def backproject_sample(depth, intrinsics, w2c, sampled_yx):
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    xx = (sampled_yx[:, 1] - cx) / fx
    yy = (sampled_yx[:, 0] - cy) / fy
    z = depth[sampled_yx[:, 0], sampled_yx[:, 1]]
    pts_cam = np.stack([xx * z, yy * z, z], -1)
    c2w = np.linalg.inv(w2c)
    pts = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    # Drop points collapsing to duplicated positions at the camera origin
    # (utils/keyframe_selection.py:27-37).
    A = np.abs(np.round(pts, 4))
    _, inv, counts = np.unique(
        np.concatenate([A, np.zeros((1, 3))], 0), axis=0, return_inverse=True, return_counts=True
    )
    dup = np.isin(inv[: len(A)], np.where(counts > 1)[0])
    return pts[~dup]


def keyframe_selection_overlap(
    depth: np.ndarray,
    w2c: np.ndarray,
    intrinsics: np.ndarray,
    keyframes: List[Keyframe],
    k: int,
    pixels: int = 1600,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    """Return indices (into ``keyframes``) of the selected window."""
    if not keyframes:
        return []
    rng = rng or np.random.default_rng()
    H, W = depth.shape
    valid = np.argwhere(depth > 0)
    if len(valid) == 0:
        return []
    sampled = valid[rng.integers(0, len(valid), size=pixels)]
    pts = backproject_sample(depth, intrinsics, w2c, sampled)

    scored = []
    for i, kf in enumerate(keyframes):
        cam_pts = pts @ kf.w2c[:3, :3].T + kf.w2c[:3, 3]
        z = cam_pts[:, 2:] + 1e-5
        uv = (cam_pts @ intrinsics.T)[:, :2] / z
        edge = 20
        inside = (
            (uv[:, 0] > edge) & (uv[:, 0] < W - edge)
            & (uv[:, 1] > edge) & (uv[:, 1] < H - edge)
            & (z[:, 0] > 0)
        )
        scored.append((i, inside.mean() if len(pts) else 0.0))

    scored.sort(key=lambda s: s[1], reverse=True)
    positives = [i for i, p in scored if p > 0.0]
    return list(rng.permutation(np.array(positives, dtype=int))[:k]) if positives else []
