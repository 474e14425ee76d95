"""Final evaluation drivers (port of ``hierslam_tpu/eval/runner.py``).

Protocol:
* evaluate frame 0 plus every ``eval_every``-th frame;
* render with the FINAL map at the per-frame estimated poses (the ladder
  rasterizer, K1, at the config's ``bucket_spec`` classes);
* PSNR / MS-SSIM on valid-depth-masked RGB; depth RMSE & L1 on the valid
  mask, reported in cm;
* semantic mIoU / boundary-mIoU per-class accumulation, with leaf decoding
  through the 1x1-conv decoder or by per-level argmax + tuple->leaf lookup;
  where the dataset has ``semantic_id`` (ScanNet tree_large), prediction
  and ground truth are mapped from dense leaf indices to those sparse raw
  ids and the classes are the ids, in their order, named by
  ``semantic_class``;
* LPIPS-alex on the masked images where weights are found (``lpips.py``),
  else NaN;
* ``model.eval_gt_transfer``: SGS-SLAM's colour-transfer protocol on the
  leaf labels before scoring (``semantic_viz.gt_transfer_labels``);
* ``save_frames``: per-frame PNGs of the render, its JET-coloured depth,
  the GT colour and depth and the leaf labels, and in tree mode the class
  legend (where matplotlib imports) and the per-level figures of
  ``semantic_viz.show_semantic``;
* trajectory ATE from the estimated trajectory vs GT w2c, in cm; 100.0 on
  failure;
* summary row: [ATE RMSE] [PSNR] [MS-SSIM] [LPIPS] [Depth L1] [Depth RMSE]
  [miou] [mbiou].
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
from hierslam_torch.eval.semantic_viz import (gt_transfer_labels, plot_semantic_legend,
                                              show_semantic, visualize_label)
from hierslam_torch.slam.losses import mlp_apply, render_gaussians
from hierslam_torch.utils.image_io import write_png

_GAUSS_KEYS = ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales")

# cv2.applyColorMap's COLORMAP_JET as RGB rows 0..255 (cv2 builds it by
# interpolating its anchors; no closed formula rounds to the same bytes)
JET_RGB = np.frombuffer(bytes.fromhex(
    "00008000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000b00000b40000b8"
    "0000bc0000c00000c40000c80000cc0000d00000d40000d80000dc0000e00000e40000e80000ec0000f00000f4"
    "0000f80000fc0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff"
    "0034ff0038ff003cff0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff"
    "0070ff0074ff0078ff007cff0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8ff"
    "00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff00d0ff00d4ff00d8ff00dcff00e0ff00e4ff"
    "00e8ff00ecff00f0ff00f4ff00f8ff00fcff02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde"
    "26ffda2affd62effd232ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56ffaa5affa65effa2"
    "62ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff8282ff7e86ff7a8aff768eff7292ff6e96ff6a9aff66"
    "9eff62a2ff5ea6ff5aaaff56aeff52b2ff4eb6ff4abaff46beff42c2ff3ec6ff3acaff36ceff32d2ff2ed6ff2a"
    "daff26deff22e2ff1ee6ff1aeaff16eeff12f2ff0ef6ff0afaff06feff01fffc00fff800fff400fff000ffec00"
    "ffe800ffe400ffe000ffdc00ffd800ffd400ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000"
    "ffac00ffa800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000ff7c00ff7800ff7400"
    "ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff5400ff5000ff4c00ff4800ff4400ff4000ff3c00ff3800"
    "ff3400ff3000ff2c00ff2800ff2400ff2000ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000fc0000"
    "f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c00000"
    "bc0000b80000b40000b00000ac0000a80000a40000a000009c00009800009400009000008c0000880000840000"
    "800000"
), np.uint8).reshape(256, 3)


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


def _depth_colormap(depth: np.ndarray, vmin: float = 0.0, vmax: float = 6.0) -> np.ndarray:
    """JET-coloured depth image, RGB uint8."""
    normalized = np.clip((depth - vmin) / (vmax - vmin), 0, 1)
    return JET_RGB[(normalized * 255).astype(np.uint8)]


def _save_frame_artifacts(eval_dir: str, t: int, out, color_hwc: np.ndarray,
                          depth_gt: np.ndarray, pred_label=None, gt_label=None,
                          colors_map=None) -> None:
    """Per-frame rendered and GT RGB, depth and leaf-label PNGs."""
    dirs = {n: os.path.join(eval_dir, n) for n in
            ("renders", "renders_depth", "rgb", "depth", "rendered_semantic")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    im = out.im.permute(1, 2, 0).clamp(0, 1).cpu().numpy()
    write_png(os.path.join(dirs["renders"], f"gs_{t:04d}.png"), (im * 255).astype(np.uint8))
    write_png(os.path.join(dirs["renders_depth"], f"gs_{t:04d}.png"),
              _depth_colormap(out.depth.cpu().numpy()))
    write_png(os.path.join(dirs["rgb"], f"gt_{t:04d}.png"),
              np.clip(color_hwc, 0, 255).astype(np.uint8))
    write_png(os.path.join(dirs["depth"], f"gt_{t:04d}.png"), _depth_colormap(depth_gt))
    if pred_label is not None and colors_map is not None:
        write_png(os.path.join(dirs["rendered_semantic"], f"sem_{t:04d}.png"),
                  visualize_label(pred_label, colors_map))
        if gt_label is not None:
            write_png(os.path.join(dirs["rendered_semantic"], f"sem_{t:04d}_gt.png"),
                      visualize_label(gt_label, colors_map))


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
    os.makedirs(eval_dir, exist_ok=True)
    eval_every = config.get("eval_every", 5)
    num_frames = num_frames or len(dataset)
    semantic = hasattr(dataset, "num_semantic")
    tree_mode = semantic and isinstance(dataset.num_semantic, list)
    gt_transfer = bool(config.get("model", {}).get("eval_gt_transfer", False))
    class_names = getattr(dataset, "semantic_class", None)
    sparse_ids = getattr(dataset, "semantic_id", None)

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

    psnrs, msssims, lpips_vals, d_rmse, d_l1 = [], [], [], [], []
    iou_acc = M.IoUAccumulator()
    lpips = M.lpips_fn(config.get("lpips_weights"), dev)
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
            if lpips is not None:
                lpips_vals.append(lpips((out.im * m).clamp(0, 1), im_gt * m))
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
            gt_leaf = torch.as_tensor(gt_leaf, device=dev)
            if sparse_ids is not None:
                # dense leaf index -> sparse raw id, for prediction and GT
                sid = torch.as_tensor(sparse_ids, device=dev)
                pred = sid[pred.long().clamp(0, len(sid) - 1)]
                gt_leaf = sid[gt_leaf.long().clamp(0, len(sid) - 1)]
                class_ids = list(sparse_ids)
            else:
                class_ids = list(range(int(n_cls)))
            if gt_transfer:
                cmap = np.asarray(dataset.colors_map_all)
                p, g = pred.cpu().numpy(), gt_leaf.cpu().numpy()
                if sparse_ids is not None:
                    # the palette is indexed densely: transfer in dense space
                    sid = np.asarray(sparse_ids)
                    p = gt_transfer_labels(np.searchsorted(sid, p), np.searchsorted(sid, g), cmap)
                    p = sid[np.clip(p, 0, len(sid) - 1)]
                else:
                    p = gt_transfer_labels(p, g, cmap)
                pred = torch.as_tensor(p, device=dev)
            if verbose_iou:
                print(f"current frame is: {t}")
            f_miou, f_mbiou, f_iou, f_biou = iou_acc.add_frame(
                pred, gt_leaf, class_ids, class_names, verbose=verbose_iou)
            if verbose_iou:
                print(f"mean_iou: {f_miou:.4f}, mean_biou: {f_mbiou:.4f}")
            with open(iou_txt, "a") as f:
                f.write(f"frame: {t}\n")
                f.write(f"mean_iou: {f_miou:.4f}, mean_biou: {f_mbiou:.4f}\n")
                f.write(f"mean_iou_per_class: {f_iou}\n")
                f.write(f"mean_biou_per_class: {f_biou}\n\n")

        if save_frames:
            labelled = semantic and out.semantic is not None
            _save_frame_artifacts(
                eval_dir, t, out, np.asarray(color), np.asarray(depth_gt),
                pred_label=pred.cpu().numpy() if labelled else None,
                gt_label=gt_leaf.cpu().numpy() if labelled else None,
                colors_map=(np.asarray(dataset.colors_map_all)
                            if semantic and hasattr(dataset, "colors_map_all") else None))

    if semantic and tree_mode and save_frames:
        if hasattr(dataset, "colors_map_all"):
            n_leaf = int(dataset.num_semantic[-1])
            names = class_names or [str(i) for i in range(n_leaf)]
            plot_semantic_legend(range(min(n_leaf, len(names))), names,
                                 np.asarray(dataset.colors_map_all), eval_dir,
                                 "semantic_class_Legend_leaf")
        if "semantic" in gauss:
            show_semantic(lambda t: render(gauss, t).semantic, dataset, num_frames, eval_dir,
                          mlp=mlp_t, frames=config.get("show_semantic_frames"))
        else:
            print("show_semantic skipped: the map has no semantic channels")

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
        "lpips": float(np.mean(lpips_vals)) if lpips_vals else float("nan"),
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
