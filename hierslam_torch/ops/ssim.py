"""SSIM with an 11x11 sigma=1.5 Gaussian window (port of ``hierslam_tpu/ops/ssim.py``).

The window is the outer product of a 1-D Gaussian, so the depthwise filter
runs separably (two 1-D depthwise convs, zero padding), in full float32:
TF32 is off for cuDNN convolutions (``hierslam_torch/__init__.py``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as Fn


@functools.lru_cache(maxsize=8)
def _window(window_size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter(img: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """Depthwise 2D Gaussian filter of ``img [C, H, W]``, applied separably."""
    c = img.shape[0]
    k = win.shape[0]
    g1 = torch.as_tensor(win.sum(axis=1), device=img.device)
    rv = g1.view(1, 1, k, 1).expand(c, 1, k, 1)
    rh = g1.view(1, 1, 1, k).expand(c, 1, 1, k)
    out = Fn.conv2d(img[None], rv, padding=(k // 2, 0), groups=c)
    out = Fn.conv2d(out, rh, padding=(0, k // 2), groups=c)
    return out[0]


def ssim_ref_stats(img2: torch.Tensor, window_size: int = 11):
    """(mu2, sigma2_sq) of a reference image, constant over a mapping phase."""
    win = _window(window_size, 1.5)
    mu2 = _filter(img2, win)
    sigma2_sq = _filter(img2 * img2, win) - mu2 * mu2
    return mu2, sigma2_sq


def calc_ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
              ref_stats=None) -> torch.Tensor:
    """Mean SSIM between two [C, H, W] images (``ref_stats``: optional
    :func:`ssim_ref_stats` of ``img2``)."""
    win = _window(window_size, 1.5)
    mu1 = _filter(img1, win)
    if ref_stats is None:
        mu2, sigma2_sq = ssim_ref_stats(img2, window_size)
    else:
        mu2, sigma2_sq = ref_stats
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter(img1 * img1, win) - mu1_sq
    sigma12 = _filter(img1 * img2, win) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return ssim_map.mean()


def calc_psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """PSNR of two images in [0, 1], a scalar for ``[C, H, W]``."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20 * torch.log10(1.0 / torch.sqrt(mse))
