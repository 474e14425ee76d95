"""Final evaluation drivers (port of ``hierslam_tpu/eval/runner.py``).

Protocol:
* evaluate frame 0 plus every ``eval_every``-th frame;
* render with the FINAL map at the per-frame estimated poses (the ladder
  rasterizer, K1, at the config's ``bucket_spec`` classes);
* PSNR / MS-SSIM on valid-depth-masked RGB; depth RMSE & L1 on the valid
  mask, reported in cm;
* semantic mIoU / boundary-mIoU per-class accumulation, with leaf decoding
  through the 1x1-conv decoder or by per-level argmax + tuple->leaf lookup;
* trajectory ATE from the estimated trajectory vs GT w2c, in cm; 100.0 on
  failure;
* summary row: [ATE RMSE] [PSNR] [MS-SSIM] [LPIPS] [Depth L1] [Depth RMSE]
  [miou] [mbiou].

Not ported (ROADMAP.md, queue 1 path 5): ``save_frames`` (per-frame image
dumps and the semantic figures), ``model.eval_gt_transfer``, the ScanNet
sparse-id protocol and LPIPS.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from hierslam_torch import resolve_device
from hierslam_torch.config import raster_config
from hierslam_torch.core import transforms
from hierslam_torch.core.camera import setup_camera
from hierslam_torch.eval import ate as ate_lib
from hierslam_torch.eval import metrics as M
from hierslam_torch.slam.losses import mlp_apply, render_gaussians

_GAUSS_KEYS = ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales")


def _build_renderer(camera, rc, with_semantic):
    """``render(params, time_idx)``: the map at frame ``time_idx``'s
    estimated pose, no gradients."""

    def render(params, time_idx):
        q = params["cam_unnorm_rots"][0, :, time_idx]
        tr = params["cam_trans"][0, :, time_idx]
        with torch.no_grad():
            return render_gaussians(params, None, q, tr, camera, rc,
                                    with_semantic=with_semantic, gaussians_grad=False,
                                    camera_grad=False)

    return render


def _image(color: np.ndarray, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(color).transpose(2, 0, 1) / 255.0, dtype=torch.float32,
                           device=dev)


def run_nvs_eval(dataset, params_np: Dict[str, np.ndarray], config: Dict, eval_dir: str,
                 sil_thres: float = 0.5, device="cuda") -> Dict[str, float]:
    """Novel-view synthesis evaluation: render held-out views at their GT
    poses and score only pixels the map covers (rendered presence >
    ``sil_thres`` and valid GT depth)."""
    dev = resolve_device(device)
    os.makedirs(eval_dir, exist_ok=True)
    _, depth0, K4, _ = dataset[0][:4]
    H, W = depth0.shape
    camera = setup_camera(W, H, np.asarray(K4)[:3, :3], params_np["w2c"])
    rc = raster_config(config)
    gauss = {k: torch.as_tensor(params_np[k], device=dev) for k in _GAUSS_KEYS}
    psnrs, msssims, d_l1 = [], [], []
    for t in range(len(dataset)):
        color, depth_gt, _, pose = dataset[t][:4]
        gt_w2c = torch.as_tensor(np.linalg.inv(np.asarray(pose)), dtype=torch.float32,
                                 device=dev)
        q = transforms.matrix_to_quaternion(gt_w2c[:3, :3])
        with torch.no_grad():
            out = render_gaussians(gauss, None, q, gt_w2c[:3, 3], camera, rc,
                                   with_semantic=False, gaussians_grad=False,
                                   camera_grad=False)
            valid = ((torch.as_tensor(np.asarray(depth_gt), device=dev) > 0)
                     & (out.final_opacity > sil_thres))
            im_gt = _image(color, dev)
            psnrs.append(float(M.masked_psnr(out.im, im_gt, valid)))
            msssims.append(float(M.ms_ssim(out.im.clamp(0, 1), im_gt)))
        _, l1 = M.depth_metrics(out.depth.cpu().numpy(), np.asarray(depth_gt),
                                valid.cpu().numpy())
        d_l1.append(l1)
    results = {
        "nvs_psnr": float(np.mean(psnrs)) if psnrs else 0.0,
        "nvs_ms_ssim": float(np.mean(msssims)) if msssims else 0.0,
        "nvs_depth_l1_cm": float(np.mean(d_l1)) * 100 if d_l1 else 0.0,
    }
    print("[NVS] PSNR {nvs_psnr:.3f} MS-SSIM {nvs_ms_ssim:.4f} "
          "Depth L1 {nvs_depth_l1_cm:.3f} cm".format(**results))
    return results


def run_final_eval(
    dataset,
    params_np: Dict[str, np.ndarray],
    config: Dict,
    eval_dir: str,
    mlp: Optional[Dict] = None,
    num_frames: Optional[int] = None,
    save_frames: bool = False,
    verbose_iou: bool = True,
    device="cuda",
) -> Dict[str, float]:
    dev = resolve_device(device)
    if save_frames:
        raise NotImplementedError(
            "save_frames (per-frame image dumps, semantic figures) is not ported yet "
            "(ROADMAP.md, queue 1 path 5)")
    if config.get("model", {}).get("eval_gt_transfer", False):
        raise NotImplementedError(
            "model.eval_gt_transfer is not ported yet (ROADMAP.md, queue 1 path 5)")
    os.makedirs(eval_dir, exist_ok=True)
    eval_every = config.get("eval_every", 5)
    num_frames = num_frames or len(dataset)
    semantic = hasattr(dataset, "num_semantic")
    tree_mode = semantic and isinstance(dataset.num_semantic, list)
    class_names = getattr(dataset, "semantic_class", None)

    _, depth0, K4, _ = dataset[0][:4]
    H, W = depth0.shape
    camera = setup_camera(W, H, np.asarray(K4)[:3, :3], params_np["w2c"])
    rc = raster_config(config)

    gauss = {k: torch.as_tensor(params_np[k], device=dev)
             for k in _GAUSS_KEYS + ("semantic",) if k in params_np and params_np[k].ndim >= 2}
    gauss["cam_unnorm_rots"] = torch.as_tensor(params_np["cam_unnorm_rots"], device=dev)
    gauss["cam_trans"] = torch.as_tensor(params_np["cam_trans"], device=dev)
    render = _build_renderer(camera, rc, with_semantic=semantic and "semantic" in gauss)
    mlp_t = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in mlp.items()} \
        if mlp else None

    psnrs, msssims, d_rmse, d_l1 = [], [], [], []
    iou_acc = M.IoUAccumulator()
    M.lpips_fn(config.get("lpips_weights"))     # raises when weights are given
    iou_txt = os.path.join(eval_dir, "sem_iou_2flat.txt")

    for t in range(num_frames):
        if t != 0 and (t + 1) % eval_every != 0:
            continue
        item = dataset[t]
        color, depth_gt, _, _ = item[:4]
        label_gt = item[4] if semantic else None
        im_gt = _image(color, dev)
        out = render(gauss, t)
        valid = np.asarray(depth_gt) > 0
        valid_t = torch.as_tensor(valid, device=dev)
        with torch.no_grad():
            psnrs.append(float(M.reference_psnr(out.im, im_gt, valid_t)))
            m = valid_t.float()[None]
            msssims.append(float(M.ms_ssim(out.im.clamp(0, 1) * m, im_gt * m)))
        rmse, l1 = M.reference_depth_metrics(out.depth.cpu().numpy(), np.asarray(depth_gt),
                                             valid)
        d_rmse.append(rmse)
        d_l1.append(l1)

        if semantic and out.semantic is not None:
            if tree_mode:
                if mlp_t is not None:
                    with torch.no_grad():
                        pred = mlp_apply(mlp_t, out.semantic).argmax(0)
                else:
                    levels = M.decode_tree_labels(out.semantic.cpu().numpy(),
                                                  dataset.num_semantic)
                    pred = M.tree_tuple_to_leaf(levels, dataset.label_mapping_tree) \
                        if getattr(dataset, "label_mapping_tree", None) else levels[-1]
                gt_leaf = np.asarray(label_gt[-1])
            else:
                pred = out.semantic.argmax(0)
                gt_leaf = np.asarray(label_gt[0])
            n_cls = dataset.num_semantic_class if hasattr(dataset, "num_semantic_class") else (
                dataset.num_semantic if not tree_mode else dataset.num_semantic[-1])
            pred = torch.as_tensor(pred, device=dev)
            if verbose_iou:
                print(f"current frame is: {t}")
            f_miou, f_mbiou, f_iou, f_biou = iou_acc.add_frame(
                pred, torch.as_tensor(gt_leaf, device=dev), list(range(int(n_cls))),
                class_names, verbose=verbose_iou)
            if verbose_iou:
                print(f"mean_iou: {f_miou:.4f}, mean_biou: {f_mbiou:.4f}")
            with open(iou_txt, "a") as f:
                f.write(f"frame: {t}\n")
                f.write(f"mean_iou: {f_miou:.4f}, mean_biou: {f_mbiou:.4f}\n")
                f.write(f"mean_iou_per_class: {f_iou}\n")
                f.write(f"mean_biou_per_class: {f_biou}\n\n")

    try:
        gt_all = params_np["gt_w2c_all_frames"]
        valid_t = [i for i in range(gt_all.shape[0]) if np.isfinite(gt_all[i]).all()]
        est_traj = ate_lib.trajectory_from_params(params_np["cam_unnorm_rots"],
                                                  params_np["cam_trans"])
        ate_cm = ate_lib.evaluate_ate([gt_all[i] for i in valid_t],
                                      [est_traj[i] for i in valid_t]) * 100
    except (KeyError, ValueError, IndexError, np.linalg.LinAlgError) as e:
        print(f"ATE evaluation failed: {e}")   # the reference's fallback
        ate_cm = 100.0

    miou, mbiou, _, _ = iou_acc.summary()
    results = {
        "ate_rmse_cm": ate_cm,
        "psnr": float(np.mean(psnrs)) if psnrs else 0.0,
        "ms_ssim": float(np.mean(msssims)) if msssims else 0.0,
        "lpips": float("nan"),
        "depth_l1_cm": float(np.mean(d_l1)) * 100 if d_l1 else 0.0,
        "depth_rmse_cm": float(np.mean(d_rmse)) * 100 if d_rmse else 0.0,
        "miou_pct": miou * 100,
        "mbiou_pct": mbiou * 100,
    }
    for name, arr in (("psnr", psnrs), ("ms_ssim", msssims), ("depth_l1", d_l1),
                      ("depth_rmse", d_rmse)):
        np.savetxt(os.path.join(eval_dir, f"{name}.txt"), np.asarray(arr))
    print("[ATE RMSE cm] [PSNR] [MS-SSIM] [LPIPS] [Depth L1 cm] [Depth RMSE cm] [mIoU%] "
          "[mbIoU%]")
    print("{ate_rmse_cm:.4f} {psnr:.3f} {ms_ssim:.4f} {lpips:.4f} "
          "{depth_l1_cm:.4f} {depth_rmse_cm:.4f} {miou_pct:.2f} {mbiou_pct:.2f}".format(**results))
    return results
