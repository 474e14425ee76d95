"""Trajectory alignment + ATE (port of ``hierslam_tpu/eval/ate.py``).

Horn closed-form alignment of the estimated trajectory onto GT (no scale),
average translational error over frames (printed as "ATE RMSE", the
reference's definition).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from hierslam_torch.core import transforms


def align(model: np.ndarray, data: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Align two [3, N] trajectories; returns (rot, trans, per-point error)."""
    mu_m = model.mean(1, keepdims=True)
    mu_d = data.mean(1, keepdims=True)
    mz = model - mu_m
    dz = data - mu_d
    W = mz @ dz.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = mu_d - rot @ mu_m
    aligned = rot @ model + trans
    err = np.sqrt(np.sum((aligned - data) ** 2, axis=0))
    return rot, trans, err


def evaluate_ate(gt_traj: List[np.ndarray], est_traj: List[np.ndarray]) -> float:
    """Mean translational error between two lists of 4x4 pose matrices."""
    gt = np.stack([p[:3, 3] for p in gt_traj]).T
    est = np.stack([p[:3, 3] for p in est_traj]).T
    _, _, err = align(gt, est)
    return float(err.mean())


def trajectory_from_params(cam_unnorm_rots, cam_trans) -> List[np.ndarray]:
    """Per-frame estimated w2c matrices (float32) from the trajectory
    parameters ``[1, 4, F]`` / ``[1, 3, F]``, numpy arrays or tensors."""
    def cpu_f32(x):
        return (x.detach().cpu() if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))).float()

    q, t = cpu_f32(cam_unnorm_rots)[0].T, cpu_f32(cam_trans)[0].T
    return list(transforms.build_w2c(transforms.normalize(q), t).numpy())
