"""Image / depth / semantic metrics (port of ``hierslam_tpu/eval/metrics.py``).

* masked and reference PSNR, MS-SSIM (5 scales, Wang et al. weights, float32
  with TF32 off) on tensors on the eval's device;
* depth RMSE & L1 on the host (numpy), as the JAX package computes them;
* per-class IoU and boundary IoU with per-frame accumulation; the boundary
  band is an erosion by a (2d+1)^2 square, a separable max pool of the
  mask's complement on the masks' device;
* LPIPS is not ported: ``lpips_fn`` returns None without weights.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as Fn

from hierslam_torch.ops.ssim import _filter, _window

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def masked_psnr(img: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """PSNR over mask-selected pixels of [C,H,W] images in [0,1]."""
    m = mask.to(img.dtype)
    cnt = torch.clamp(m.sum() * img.shape[0], min=1.0)
    mse = (((img - gt) * m[None]) ** 2).sum() / cnt
    return 20 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def reference_psnr(img: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The reference's eval PSNR: per-channel MSE over ALL pixels of the
    mask-weighted images, PSNR averaged over channels."""
    m = mask.to(img.dtype)[None]
    mse = ((img * m - gt * m) ** 2).mean(dim=(1, 2))
    return (20 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))).mean()


def reference_depth_metrics(depth: np.ndarray, gt: np.ndarray, mask: np.ndarray):
    """(rmse, l1) with the reference's formulas: both are the masked mean
    of ``|depth * mask - gt| * mask`` (its "RMSE" is sqrt of a square)."""
    diff = np.abs(depth * mask - gt) * mask
    denom = max(mask.sum(), 1)
    v = float(diff.sum() / denom)
    return v, v


def _avgpool2(img: torch.Tensor) -> torch.Tensor:
    c, h, w = img.shape
    h2, w2 = h // 2, w // 2
    return img[:, : h2 * 2, : w2 * 2].reshape(c, h2, 2, w2, 2).mean((2, 4))


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor, levels: int = 5) -> torch.Tensor:
    """Multi-scale SSIM of [C,H,W] images (standard Wang et al. weights)."""
    win = _window(11, 1.5)
    weights = MSSSIM_WEIGHTS[:levels]
    mcs = []
    val = None
    for i in range(levels):
        mu1, mu2 = _filter(img1, win), _filter(img2, win)
        s1 = _filter(img1 * img1, win) - mu1 * mu1
        s2 = _filter(img2 * img2, win) - mu2 * mu2
        s12 = _filter(img1 * img2, win) - mu1 * mu2
        c1, c2 = 0.01**2, 0.03**2
        cs = ((2 * s12 + c2) / (s1 + s2 + c2)).mean()
        ssim = (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
                / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()
        if i == levels - 1:
            val = ssim
        else:
            mcs.append(torch.clamp(cs, min=0.0))
            img1, img2 = _avgpool2(img1), _avgpool2(img2)
    out = torch.clamp(val, min=0.0) ** weights[-1]
    for w, cs in zip(weights[:-1], mcs):
        out = out * cs**w
    return out


def depth_metrics(depth: np.ndarray, gt: np.ndarray, mask: np.ndarray):
    """(rmse, l1) over valid mask, in the input units."""
    d = (depth - gt)[mask]
    if d.size == 0:
        return 0.0, 0.0
    return float(np.sqrt(np.mean(d**2))), float(np.mean(np.abs(d)))


def _dilation(h: int, w: int, dilation_ratio: float) -> int:
    return max(1, int(round(dilation_ratio * np.sqrt(h**2 + w**2))))


def _boundaries(masks: torch.Tensor, dilation_ratio: float) -> torch.Tensor:
    """[N, H, W] binary masks -> their boundary bands.

    The JAX package pads each mask with one row and column of zeros and
    erodes it ``d`` times by a 3x3 square with cv2's default border, which
    counts as inside.  That is one erosion by a (2d+1)^2 square of the
    padded mask; the erosion of the mask is the complement of the dilation
    (a max pool, whose padding never wins) of the complement."""
    n, h, w = masks.shape
    d = _dilation(h, w, dilation_ratio)
    comp = 1.0 - Fn.pad(masks.float(), (1, 1, 1, 1))[:, None]
    comp = Fn.max_pool2d(comp, (1, 2 * d + 1), stride=1, padding=(0, d))
    comp = Fn.max_pool2d(comp, (2 * d + 1, 1), stride=1, padding=(d, 0))
    eroded = 1.0 - comp[:, 0, 1:h + 1, 1:w + 1]
    return masks.float() - eroded


def mask_to_boundary(mask, dilation_ratio: float = 0.02):
    """Binary mask [H, W] (numpy or tensor) -> its boundary band (same type)."""
    t = torch.as_tensor(mask) if not torch.is_tensor(mask) else mask
    out = _boundaries(t[None], dilation_ratio)[0]
    return out.cpu().numpy().astype(np.asarray(mask).dtype) if not torch.is_tensor(mask) else out


def boundary_iou(gt, dt, dilation_ratio: float = 0.02) -> float:
    return boundary_ious(torch.as_tensor(gt)[None] > 0, torch.as_tensor(dt)[None] > 0,
                         dilation_ratio)[0]


def boundary_ious(gt: torch.Tensor, dt: torch.Tensor, dilation_ratio: float = 0.02,
                  chunk: int = 16) -> List[float]:
    """Boundary IoU of each of N mask pairs [N, H, W] (bool)."""
    out = []
    for lo in range(0, gt.shape[0], chunk):
        gb = _boundaries(gt[lo:lo + chunk], dilation_ratio) > 0
        db = _boundaries(dt[lo:lo + chunk], dilation_ratio) > 0
        inter = (gb & db).sum((1, 2)).tolist()
        union = (gb | db).sum((1, 2)).tolist()
        out += [i / u if u else 0.0 for i, u in zip(inter, union)]
    return out


def calculate_iou(mask1, mask2) -> float:
    a, b = torch.as_tensor(mask1) > 0, torch.as_tensor(mask2) > 0
    union = int((a | b).sum())
    if union == 0:
        return 0.0
    return int((a & b).sum()) / union


class IoUAccumulator:
    """Per-class IoU/boundary-IoU accumulation across frames, skipping
    classes absent in both prediction and GT.  Labels are integer tensors
    (or numpy arrays) [H, W]; the masks are built on their device."""

    def __init__(self):
        self.iou: Dict[int, List[float]] = {}
        self.biou: Dict[int, List[float]] = {}

    def add_frame(self, pred_label, gt_label, class_ids: Sequence[int], class_names=None,
                  verbose: bool = False):
        """Accumulate one frame; returns (frame_miou, frame_mbiou,
        per_class_iou, per_class_biou).  ``verbose`` prints the per-class
        lines of the reference, with pixel counts for iou == 0 classes."""
        pred = torch.as_tensor(pred_label)
        gt = torch.as_tensor(gt_label).to(pred.device)
        ids = torch.as_tensor(list(class_ids), device=pred.device)
        pm = pred[None] == ids[:, None, None]
        gm = gt[None] == ids[:, None, None]
        n_p, n_g = pm.sum((1, 2)), gm.sum((1, 2))
        present = ((n_p > 0) | (n_g > 0)).nonzero()[:, 0]
        pm, gm = pm[present], gm[present]
        inter = (pm & gm).sum((1, 2)).tolist()
        union = (pm | gm).sum((1, 2)).tolist()
        bious = boundary_ious(gm, pm)
        n_p, n_g = n_p[present].tolist(), n_g[present].tolist()
        f_iou: Dict[int, float] = {}
        f_biou: Dict[int, float] = {}
        for j, idx in enumerate(present.tolist()):
            c = class_ids[idx]
            iou = inter[j] / union[j] if union[j] else 0.0
            biou = bious[j]
            self.iou.setdefault(c, []).append(iou)
            self.biou.setdefault(c, []).append(biou)
            f_iou[c], f_biou[c] = iou, biou
            if verbose:
                name = class_names[idx] if class_names is not None else c
                line = (f" semantic label {c} ({name}): iou: {iou:.3f}, biou: {biou:.3f}, "
                        f"class_counts: {len(self.iou[c])}")
                if iou == 0:
                    line += f", pixel num gt vs est: {n_g[j]} vs {n_p[j]}"
                print(line)
        f_miou = float(np.mean(list(f_iou.values()))) if f_iou else 0.0
        f_mbiou = float(np.mean(list(f_biou.values()))) if f_biou else 0.0
        return f_miou, f_mbiou, f_iou, f_biou

    def summary(self):
        miou_c = {c: float(np.mean(v)) for c, v in self.iou.items()}
        mbiou_c = {c: float(np.mean(v)) for c, v in self.biou.items()}
        miou = float(np.mean(list(miou_c.values()))) if miou_c else 0.0
        mbiou = float(np.mean(list(mbiou_c.values()))) if mbiou_c else 0.0
        return miou, mbiou, miou_c, mbiou_c


def eval_semantic_single(pred_label, gt_label, class_ids, class_names=None,
                         verbose: bool = True):
    """Single-frame per-class IoU/bIoU report with the reference's stdout
    lines."""
    acc = IoUAccumulator()
    miou, mbiou, per_iou, per_biou = acc.add_frame(
        pred_label, gt_label, class_ids, class_names, verbose)
    if verbose:
        pred = np.asarray(torch.as_tensor(pred_label).cpu())
        num_wrong = sum((pred == c).sum() for c, v in per_iou.items() if v == 0)
        print(f"mean_iou: {miou:.4f}, mean_biou: {mbiou:.4f}")
        print("num 0 worng is: ", num_wrong)  # sic — reference string
    return miou, mbiou, per_iou, per_biou


def lpips_fn(weights_path: Optional[str] = None):
    """LPIPS is not ported: None without weights (the row prints nan)."""
    if weights_path:
        raise NotImplementedError("LPIPS is not ported yet (ROADMAP.md, queue 1 path 5)")
    return None


def decode_tree_labels(sem_img, num_semantic: List[int]):
    """Per-level argmax over the concatenated tree embedding: [S,H,W] ->
    [L,H,W] (numpy or tensor in, the same out)."""
    out = []
    off = 0
    for n_cls in num_semantic[:-1]:
        out.append(sem_img[off: off + n_cls].argmax(0))
        off += n_cls
    return torch.stack(out) if torch.is_tensor(sem_img) else np.stack(out)


def tree_tuple_to_leaf(level_labels: np.ndarray, mapping: Dict[str, tuple]) -> np.ndarray:
    """Per-pixel level-id tuple -> leaf base id; unmatched tuples map to -1."""
    lut: Dict[tuple, int] = {tuple(v): int(k) for k, v in mapping.items()}
    L, H, W = level_labels.shape
    flat = np.asarray(level_labels).reshape(L, -1).T
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    lu = np.array([lut.get(tuple(row), -1) for row in uniq])
    return lu[inv.reshape(-1)].reshape(H, W)
