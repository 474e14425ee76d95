"""LPIPS (AlexNet) from a local weights file (port of
``hierslam_tpu/eval/lpips.py``).

* AlexNet feature stack (torchvision layout): conv1 11x11/4 p2 -> relu ->
  maxpool 3/2 -> conv2 5x5 p2 -> relu -> maxpool 3/2 -> conv3 3x3 p1 ->
  relu -> conv4 3x3 p1 -> relu -> conv5 3x3 p1 -> relu; LPIPS taps the
  five relu outputs (before the pools);
* the LPIPS input scaling layer (shift/scale per RGB channel applied to
  [-1, 1] inputs) and channel-unit-normalized squared feature differences
  weighted by the five learned 1x1 "lin" layers, spatially averaged and
  summed over layers.

The convolutions are ``torch.nn.functional.conv2d`` (the JAX package's are
``lax.conv_general_dilated``, outside any Pallas kernel), in float32: the
package turns TF32 off for cuDNN.

Expected ``.npz`` keys (``tools/export_lpips_weights.py`` writes them):

    conv{i}_w [out,in,kh,kw], conv{i}_b [out]   for i in 1..5
    lin{i}_w  [C_i]                             for i in 1..5

Pass the file via config key ``lpips_weights`` or the ``LPIPS_WEIGHTS``
environment variable; ``weights/lpips_alex.npz`` is looked for last.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as Fn

from hierslam_torch import resolve_device

# (kernel, stride, pad, pool_after) per conv layer: torchvision AlexNet.
ALEX_LAYERS = (
    (11, 4, 2, True),
    (5, 1, 2, True),
    (3, 1, 1, False),
    (3, 1, 1, False),
    (3, 1, 1, False),
)
# LPIPS ScalingLayer constants (lpips/lpips.py).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """lpips.normalize_tensor: x / (||x||_channel + eps)."""
    return f / (torch.sqrt((f * f).sum(0, keepdim=True)) + eps)


def alexnet_features(params: Dict[str, torch.Tensor], x: torch.Tensor) -> List[torch.Tensor]:
    """Relu-tap features of AlexNet for x [3,H,W] already scaled to the
    LPIPS input distribution."""
    feats = []
    h = x[None]
    for i, (_, stride, pad, pool) in enumerate(ALEX_LAYERS, start=1):
        h = Fn.relu(Fn.conv2d(h, params[f"conv{i}_w"], params[f"conv{i}_b"], stride=stride,
                              padding=pad))
        feats.append(h[0])
        if pool:
            h = Fn.max_pool2d(h, 3, 2)
    return feats


def lpips_distance(params: Dict[str, torch.Tensor], img: torch.Tensor,
                   gt: torch.Tensor) -> torch.Tensor:
    """LPIPS-alex distance of two [3,H,W] images in [0, 1]."""
    shift = torch.as_tensor(_SHIFT, device=img.device)[:, None, None]
    scale = torch.as_tensor(_SCALE, device=img.device)[:, None, None]

    def prep(x):
        return (2.0 * x.clamp(0.0, 1.0) - 1.0 - shift) / scale

    with torch.no_grad():
        fa = alexnet_features(params, prep(img))
        fb = alexnet_features(params, prep(gt))
        total = torch.zeros((), device=img.device)
        for i, (a, b) in enumerate(zip(fa, fb), start=1):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2          # [C, H, W]
            w = params[f"lin{i}_w"].reshape(-1, 1, 1)
            total = total + (d * w).sum(0).mean()
    return total


def load_lpips_params(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    with np.load(path) as data:
        params = {}
        for i in range(1, 6):
            for k in (f"conv{i}_w", f"conv{i}_b", f"lin{i}_w"):
                params[k] = torch.as_tensor(np.asarray(data[k], np.float32), device=device)
            params[f"lin{i}_w"] = params[f"lin{i}_w"].reshape(-1)
    return params


def default_weights_path() -> str:
    return os.environ.get(
        "LPIPS_WEIGHTS",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "weights", "lpips_alex.npz"),
    )


def lpips_fn(weights_path: Optional[str] = None, device="cuda"):
    """Build an ``f(img, gt) -> float`` LPIPS callable on ``device`` (the
    GPU unless ``device="cpu"``; its images may be numpy arrays or
    tensors), or None.

    Resolution order: explicit ``weights_path`` -> $LPIPS_WEIGHTS ->
    <repo>/weights/lpips_alex.npz -> None, with the expected path printed.
    """
    path = weights_path or default_weights_path()
    if not (path and os.path.isfile(path)):
        print(
            f"LPIPS disabled: no weights at {path!r}. Export lpips_alex.npz with "
            "tools/export_lpips_weights.py and set LPIPS_WEIGHTS or config['lpips_weights']."
        )
        return None
    device = resolve_device(device)
    params = load_lpips_params(path, device)

    def compute(img, gt):
        img = torch.as_tensor(img, dtype=torch.float32, device=device)
        gt = torch.as_tensor(gt, dtype=torch.float32, device=device)
        return float(lpips_distance(params, img, gt))

    return compute
