"""Online (during-SLAM) progress reporting (port of
``hierslam_tpu/eval/progress.py``), called every
``report_global_progress_every`` frames and at frame 0, after tracking and
after mapping:

* render the current frame at the current estimated pose;
* masked PSNR + depth L1 of the render vs GT;
* trajectory ATE RMSE over all frames so far (finite GT poses only);
* where matplotlib is installed, a 2x3 qualitative panel (GT RGB / GT depth
  / silhouette, rendered RGB / rendered depth / depth-diff L1) as PNG.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from hierslam_torch.eval import ate as ate_lib
from hierslam_torch.eval import metrics as M


def plotting_available() -> bool:
    """Whether matplotlib imports (the panels and metrics.png need it)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def plot_rgbd_silhouette(
    color: np.ndarray,            # [3, H, W] GT rgb in [0,1]
    depth: np.ndarray,            # [H, W] GT depth
    rastered_color: np.ndarray,   # [3, H, W]
    rastered_depth: np.ndarray,   # [H, W]
    presence_sil_mask: np.ndarray,  # [H, W] bool
    diff_depth_l1: np.ndarray,    # [H, W]
    psnr: float,
    depth_l1: float,
    fig_title: str,
    plot_dir: Optional[str] = None,
    plot_name: Optional[str] = None,
    save_plot: bool = False,
):
    """2x3 qualitative panel; needs matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    aspect_ratio = color.shape[2] / color.shape[1]
    fig, axs = plt.subplots(2, 3, figsize=(14 / 1.55 * aspect_ratio, 8))
    axs[0, 0].imshow(np.clip(color, 0, 1).transpose(1, 2, 0))
    axs[0, 0].set_title("Ground Truth RGB")
    axs[0, 1].imshow(depth, cmap="jet", vmin=0, vmax=6)
    axs[0, 1].set_title("Ground Truth Depth")
    axs[1, 0].imshow(np.clip(rastered_color, 0, 1).transpose(1, 2, 0))
    axs[1, 0].set_title("Rasterized RGB, PSNR: {:.2f}".format(psnr))
    axs[1, 1].imshow(rastered_depth, cmap="jet", vmin=0, vmax=6)
    axs[1, 1].set_title("Rasterized Depth, L1: {:.2f}".format(depth_l1))
    axs[0, 2].imshow(presence_sil_mask, cmap="gray")
    axs[0, 2].set_title("Rasterized Silhouette")
    axs[1, 2].imshow(diff_depth_l1, cmap="jet", vmin=0, vmax=6)
    axs[1, 2].set_title("Diff Depth L1")
    for ax in axs.flatten():
        ax.axis("off")
    fig.suptitle(fig_title, y=0.95, fontsize=16)
    fig.tight_layout()
    out_path = None
    if save_plot and plot_dir is not None:
        os.makedirs(plot_dir, exist_ok=True)
        out_path = os.path.join(plot_dir, f"{plot_name}.png")
        fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def ate_so_far(gt_w2c_all: List[np.ndarray], cam_unnorm_rots, cam_trans) -> float:
    """ATE RMSE (m) over the frames processed so far, skipping nonfinite GT
    poses; 100.0 on failure."""
    try:
        n = len(gt_w2c_all)
        est = ate_lib.trajectory_from_params(cam_unnorm_rots, cam_trans)[:n]
        valid = [i for i in range(n) if np.isfinite(gt_w2c_all[i]).all()]
        if len(valid) < 2:
            return 0.0
        return float(ate_lib.evaluate_ate(
            [gt_w2c_all[i] for i in valid], [est[i] for i in valid]
        ))
    except (ValueError, IndexError, np.linalg.LinAlgError):
        return 100.0


def report_progress(
    render_fn,
    params: Dict,
    im_gt: torch.Tensor,      # [3, H, W]
    depth_gt: torch.Tensor,   # [H, W]
    time_idx: int,
    gt_w2c_all: List[np.ndarray],
    sil_thres: float,
    plot_dir: str,
    phase: str = "tracking",
    save_plot: bool = True,
    logger=None,
) -> Dict[str, float]:
    """Render the current frame, score it, log the scalars and, with
    ``save_plot``, write the panel."""
    out = render_fn(params, time_idx)
    sil = out.final_opacity
    presence = sil > sil_thres
    valid = depth_gt > 0
    mask = valid & presence
    psnr = float(M.masked_psnr(out.im, im_gt, mask))
    rd = out.depth.cpu().numpy()
    gd = depth_gt.cpu().numpy()
    mask_np, valid_np = mask.cpu().numpy(), valid.cpu().numpy()
    diff_depth = np.abs(rd - gd) * valid_np
    depth_l1 = float(diff_depth[mask_np].mean()) if mask_np.any() else 0.0
    ate_rmse_m = ate_so_far(gt_w2c_all, params["cam_unnorm_rots"], params["cam_trans"])
    title = (
        f"{phase.capitalize()} Time Step: {time_idx} | Frame {time_idx} | "
        f"PSNR: {psnr:.2f}, Depth L1: {depth_l1:.4f}, "
        f"ATE RMSE: {ate_rmse_m * 100:.2f} cm"
    )
    if save_plot:
        plot_rgbd_silhouette(
            im_gt.cpu().numpy(), gd, out.im.cpu().numpy(), rd, presence.cpu().numpy(),
            diff_depth, psnr, depth_l1, title, plot_dir=plot_dir,
            plot_name=f"{phase}_{time_idx:04d}", save_plot=True,
        )
    results = {
        f"{phase}_progress_psnr": psnr,
        f"{phase}_progress_depth_l1": depth_l1,
        f"{phase}_progress_ate_rmse_cm": ate_rmse_m * 100,
    }
    if logger is not None:
        logger.log(time_idx, **results)
    return results
