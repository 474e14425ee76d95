"""Semantic figures and the gt-transfer protocol (port of
``hierslam_tpu/eval/semantic_viz.py``):

* ``visualize_label``: palette colouring of a label image;
* ``plot_semantic_legend``: the class legend figure, drawn where
  matplotlib imports (one line says it was skipped elsewhere);
* ``gt_transfer_labels``: SGS-SLAM's colour-transfer protocol, every
  predicted pixel snapped to the nearest palette colour among the classes
  present in the frame's ground truth (``model.eval_gt_transfer``);
* ``show_semantic``: per-tree-level prediction and ground-truth label
  images, blended 0.35/0.65 over the RGB frame, saved as
  ``sem_{t:04d}_level{i}[_gt].png``.

The figures are numpy on the host, as in the JAX package; the renders and
the decoder run on the eval's device.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hierslam_torch.datasets import tree as tree_lib
from hierslam_torch.eval import metrics as M
from hierslam_torch.eval.progress import plotting_available
from hierslam_torch.slam.losses import mlp_apply
from hierslam_torch.utils.image_io import write_png


def visualize_label(label: np.ndarray, colors_map: np.ndarray) -> np.ndarray:
    """[H, W] int label image -> [H, W, 3] uint8 palette colors."""
    idx = np.clip(np.asarray(label).astype(np.int64), 0, len(colors_map) - 1)
    return colors_map[idx].astype(np.uint8)


def blend_over_rgb(label_vis: np.ndarray, rgb: np.ndarray, w_color: float = 0.35,
                   w_sem: float = 0.65) -> np.ndarray:
    """``cv2.addWeighted`` of the RGB frame and the coloured labels, in
    float32, clipped to uint8."""
    out = rgb.astype(np.float32) * w_color + label_vis.astype(np.float32) * w_sem
    return np.clip(out, 0, 255).astype(np.uint8)


def plot_semantic_legend(class_ids: Sequence[int], class_names: Sequence[str],
                         colormap: np.ndarray, save_path: str,
                         save_name: str = "semantic_class_Legend",
                         ncol: Optional[int] = None) -> Optional[str]:
    """Legend figure of class colour patches -> its path, or None (with a
    printed line) where matplotlib is not installed."""
    if not plotting_available():
        print(f"matplotlib is not installed: the legend {save_name}.png is skipped",
              flush=True)
        return None
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt

    os.makedirs(save_path, exist_ok=True)
    patches = [mpatches.Patch(color=np.asarray(colormap[int(c)], np.float32) / 255.0,
                              label=f"{c}: {n}") for c, n in zip(class_ids, class_names)]
    n = max(len(patches), 1)
    ncol = ncol or max(1, int(np.ceil(n / 25)))
    fig = plt.figure(figsize=(3 * ncol, min(25, n) * 0.25 + 1))
    plt.legend(handles=patches, loc="center", ncol=ncol, fontsize=7)
    plt.axis("off")
    out = os.path.join(save_path, f"{save_name}.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def gt_transfer_labels(pred_label: np.ndarray, gt_label: np.ndarray,
                       colors_map: np.ndarray) -> np.ndarray:
    """Re-assign every predicted pixel to the class whose palette colour is
    nearest among the classes present in this frame's GT (the palette's
    rows are unique, so this is the reference's colour-space argmin)."""
    gt_classes = np.unique(np.asarray(gt_label).astype(np.int64))
    refer = colors_map[np.clip(gt_classes, 0, len(colors_map) - 1)].astype(np.float32)
    pred_colors = colors_map[
        np.clip(np.asarray(pred_label).astype(np.int64), 0, len(colors_map) - 1)
    ].astype(np.float32)
    d = np.linalg.norm(pred_colors[..., None, :] - refer[None, None], axis=-1)   # [H, W, G]
    return gt_classes[np.argmin(d, axis=-1)]


def _combined_prefix_ids(levels_a: np.ndarray, levels_b: np.ndarray):
    """Shared dense ids of the tuples of per-level labels, computed over
    prediction and GT together so that both images take the same colours:
    the tuples' ranks in lexicographic order (``np.unique(axis=0)``'s).

    Each tuple is read as one mixed-radix integer, the first level most
    significant, so that a 1-D ``np.unique`` gives the same ranks; row-wise
    ``np.unique`` takes seconds a level at 1200x680."""
    L = levels_a.shape[0]
    both = np.concatenate([levels_a.reshape(L, -1), levels_b.reshape(L, -1)],
                          axis=1).astype(np.int64)
    lo = both.min(1, keepdims=True)
    radix = both.max(1) - lo[:, 0] + 1
    if np.sum(np.log2(radix)) < 62:                 # the key fits an int64
        key = np.zeros(both.shape[1], np.int64)
        for level, r in zip(both - lo, radix):
            key = key * r + level
        uniq, inv = np.unique(key, return_inverse=True)
    else:
        uniq, inv = np.unique(both.T, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    P = levels_a.shape[1] * levels_a.shape[2]
    return (inv[:P].reshape(levels_a.shape[1:]), inv[P:].reshape(levels_b.shape[1:]),
            len(uniq))


def show_semantic(render_sem_fn, dataset, num_frames: int, eval_dir: str,
                  mlp: Optional[Dict[str, torch.Tensor]] = None,
                  frames: Optional[Sequence[int]] = None, blend_rgb: bool = True,
                  w_color: float = 0.35, w_sem: float = 0.65) -> List[str]:
    """Multi-level semantic imagery for selected frames (default: 0 and
    ``num_frames // 2``).

    ``render_sem_fn(t) -> [S, H, W]`` tensor renders the semantic channels
    at the estimated pose of frame ``t``; ``mlp`` (tensors on its device)
    decodes the leaf level.  Saves, per frame and tree level,
    ``sem_{t:04d}_level{i}.png`` (prediction) and ``..._gt.png`` under
    ``eval_dir/rendered_semantic_multilevel[_mlp]``; returns the paths."""
    sub = "rendered_semantic_multilevel_mlp" if mlp is not None else \
        "rendered_semantic_multilevel"
    out_dir = os.path.join(eval_dir, sub)
    os.makedirs(out_dir, exist_ok=True)
    num_semantic = dataset.num_semantic
    n_levels = len(num_semantic) - 1
    written: List[str] = []
    frames = list(frames) if frames is not None else [0, num_frames // 2]

    for t in frames:
        if t >= num_frames:
            continue
        item = dataset[t]
        color = np.asarray(item[0])                 # [H, W, 3] 0-255
        label_gt = np.asarray(item[4])              # [L+1, H, W]
        sem = render_sem_fn(t)                      # [S, H, W]
        pred_levels = M.decode_tree_labels(sem.cpu().numpy(), num_semantic)   # [L, H, W]
        if mlp is not None:
            with torch.no_grad():
                leaf = mlp_apply(mlp, sem).argmax(0).cpu().numpy()
        else:
            leaf = pred_levels[-1]

        base = f"sem_{t:04d}"
        for i_level in range(n_levels):
            if i_level == n_levels - 1:             # leaf level: the dataset's palette
                cmap = np.asarray(dataset.colors_map_all)
                vis_pred = visualize_label(leaf, cmap)
                vis_gt = visualize_label(label_gt[-1], cmap)
            else:
                ia, ib, n_ids = _combined_prefix_ids(pred_levels[: i_level + 1],
                                                     label_gt[: i_level + 1])
                cmap = tree_lib.label_colormap(max(n_ids, 2))
                vis_pred = visualize_label(ia, cmap)
                vis_gt = visualize_label(ib, cmap)
            if blend_rgb:
                vis_pred = blend_over_rgb(vis_pred, color, w_color, w_sem)
                vis_gt = blend_over_rgb(vis_gt, color, w_color, w_sem)
            p1 = os.path.join(out_dir, f"{base}_level{i_level}.png")
            p2 = os.path.join(out_dir, f"{base}_level{i_level}_gt.png")
            write_png(p1, vis_pred)
            write_png(p2, vis_gt)
            written += [p1, p2]
    return written
