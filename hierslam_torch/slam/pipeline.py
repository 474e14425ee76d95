"""End-to-end SLAM driver (port of ``hierslam_tpu/slam/pipeline.py``).

Tracking every frame (skip frame 0); densify + mapping when ``t == 0`` or
``(t + 1) % map_every == 0``; keyframe admission every ``keyframe_every``
(plus frame 0 and ``num_frames - 2``) gated on a finite GT pose; progress
reports (a render of the current frame, scored) at ``t == 0`` and every
``report_global_progress_every`` frames, after tracking and after mapping;
checkpoints every ``checkpoint_interval``.  The map is a fixed-capacity
slot buffer; per-gaussian work runs on the live prefix rounded up to a
bucket, grown on densify overflow, with compaction and escalated pruning
as the next remedies.

Frames come from the dataset that ``config["data"]`` names (the Replica
loaders of ``hierslam_torch.datasets``), or from a ``dataset=`` object:
``len()``, and ``ds[t]`` -> ``(color uint8 HWC, depth [H,W], K 4x4, c2w
4x4, labels [L+1,H,W])``, plus ``num_semantic`` / ``num_semantic_class``.
``run()`` steps every frame from ``start_idx`` (after a resume from a
checkpoint) with a loader thread ahead of it; ``run_slam`` adds the final
eval.
"""
from __future__ import annotations

import os
import time
import traceback
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from hierslam_torch import resolve_device
from hierslam_torch.config import apply_defaults, raster_config
from hierslam_torch.core import gaussians as G
from hierslam_torch.core.camera import setup_camera
from hierslam_torch.datasets import get_dataset
from hierslam_torch.datasets.base import load_dataset_config
from hierslam_torch.eval.progress import plotting_available, report_progress
from hierslam_torch.eval.runner import _build_renderer, run_final_eval
from hierslam_torch.slam import optim
from hierslam_torch.slam.densify_classic import DensifyConfig
from hierslam_torch.slam.keyframes import Keyframe, KeyframeStore, keyframe_selection_overlap
from hierslam_torch.slam.losses import LossConfig, mlp_init
from hierslam_torch.slam.mapping import PruneConfig, make_densifier, make_mapper
from hierslam_torch.slam.tracking import apply_gt_pose, est_w2c, make_tracker, propagate_pose
from hierslam_torch.utils import io as uio
from hierslam_torch.utils.convert import from_jax_numpy
from hierslam_torch.utils.logging import RunLogger, plot_metrics
from hierslam_torch.utils.prefetch import Prefetcher


class SLAMRunner:
    def __init__(self, config: Dict, dataset=None, device="cuda"):
        self.device = dev = resolve_device(device)
        self.config = config = apply_defaults(config)
        if config.get("use_wandb", False):
            raise NotImplementedError("wandb logging is not ported (ROADMAP.md)")
        if config.get("profile"):
            raise NotImplementedError(
                "config['profile'] (device traces of listed frames) is not ported; "
                "tools/profile_torch_slam.py traces a tracked and a mapped frame")
        uio.seed_everything(config["seed"])
        self.rng = np.random.default_rng(config["seed"])
        # random draws come from a CPU generator, so a run draws the same
        # numbers on every device
        self.generator = torch.Generator()
        self.generator.manual_seed(int(config["seed"]))

        self.output_dir = os.path.join(config["workdir"], config["run_name"])
        self.eval_dir = os.path.join(self.output_dir, "eval")
        self.plot_dir = os.path.join(self.eval_dir, "plots")
        os.makedirs(self.eval_dir, exist_ok=True)

        dc = config["data"]
        if dataset is None:
            dataset, self.semantic = self._dataset_from_config(dc)
        else:   # an in-memory dataset is semantic when it has label maps
            self.semantic = bool(getattr(dataset, "num_semantic", 0))
        self.dataset = dataset
        self.num_frames = dc.get("num_frames", -1)
        if self.num_frames == -1:
            self.num_frames = len(dataset)

        # ---- semantics ----------------------------------------------------
        ns = dataset.num_semantic if self.semantic else 0
        self.num_semantic, self.sem_levels, self.num_leaf = 0, (), 0
        self.use_mlp = False
        if self.semantic:
            if isinstance(ns, (list, tuple)):
                self.sem_levels = tuple(int(x) for x in ns[:-1])
                self.num_semantic = int(sum(ns[:-1]))
                self.num_leaf = int(dataset.num_semantic_class)
                self.use_mlp = config.get("model", {}).get("flag_use_embedding", 0) == 1
            else:
                self.num_semantic = int(ns)
                self.sem_levels = (self.num_semantic,)
                self.num_leaf = int(ns)

        # ---- first frame / camera / map init -----------------------------
        color0, depth0, K4, pose0 = dataset[0][:4]
        self.intrinsics = np.asarray(K4)[:3, :3]
        w2c0 = np.linalg.inv(np.asarray(pose0))
        H, W = depth0.shape
        self.H, self.W = H, W
        self.camera = setup_camera(W, H, self.intrinsics, w2c0)
        self.first_frame_w2c = w2c0

        capacity = int(config["map_capacity"])
        self.capacity = capacity
        self.params = G.empty_params(capacity, self.num_frames, self.num_semantic, dev)
        self.variables = G.empty_variables(capacity, dev)
        im0 = torch.as_tensor(color0.transpose(2, 0, 1) / 255.0, dtype=torch.float32, device=dev)
        d0 = torch.as_tensor(np.asarray(depth0), dtype=torch.float32, device=dev)
        fields = G.pointcloud_fields(im0, d0, self.intrinsics, w2c0, self.num_semantic,
                                     self.generator)
        self.params, self.variables, over = G.insert_gaussians(
            self.params, self.variables, fields, (d0 > 0).reshape(-1), 0.0)
        if int(over) > 0:
            raise ValueError(f"map_capacity {capacity} too small for first frame")
        self.variables["scene_radius"] = torch.tensor(
            float(np.max(depth0)) / config["scene_radius_depth_ratio"], device=dev)

        # ---- step functions ---------------------------------------------
        rc = raster_config(config)
        if rc.sat_margin > 0 and config.get("mapping", {}).get(
                "pruning_dict", {}).get("reset_opacities", False):
            warnings.warn("reset_opacities invalidates amortized saturation capping; "
                          "disabling raster.sat_margin for this run")
            from dataclasses import replace as _dcr

            rc = _dcr(rc, sat_margin=0.0)
        self.rc = rc
        tcfg = config["tracking"]
        track_loss = LossConfig(
            use_sil_for_loss=tcfg["use_sil_for_loss"], sil_thres=tcfg["sil_thres"],
            use_l1=tcfg["use_l1"], ignore_outlier_depth_loss=tcfg["ignore_outlier_depth_loss"],
            w_im=tcfg["loss_weights"]["im"], w_depth=tcfg["loss_weights"]["depth"],
        )
        self.tracker = make_tracker(
            self.camera, track_loss, rc, lr_quat=tcfg["lrs"]["cam_unnorm_rots"],
            lr_trans=tcfg["lrs"]["cam_trans"], num_iters=tcfg["num_iters"],
            use_cache=bool(config.get("track_use_cache", True)), device=dev,
        )
        mcfg = config["mapping"]
        map_loss = LossConfig(
            use_sil_for_loss=mcfg["use_sil_for_loss"], sil_thres=mcfg["sil_thres"],
            use_l1=mcfg["use_l1"], ignore_outlier_depth_loss=mcfg["ignore_outlier_depth_loss"],
            w_im=mcfg["loss_weights"]["im"], w_depth=mcfg["loss_weights"]["depth"],
            w_sem=mcfg["loss_weights"].get("sem", 0.0),
            sem_levels=self.sem_levels if self.semantic else (),
            num_leaf=self.num_leaf, use_mlp=self.use_mlp,
        )
        prune = PruneConfig(**{
            k: mcfg["pruning_dict"][k] for k in PruneConfig.__dataclass_fields__
            if k in mcfg.get("pruning_dict", {})
        }) if mcfg.get("prune_gaussians", False) else None
        map_lrs = {k: v for k, v in mcfg["lrs"].items() if k in G.GAUSSIAN_KEYS}
        densify_cfg = None
        if mcfg.get("use_gaussian_splatting_densification", False):
            dd = mcfg.get("densify_dict", {})
            densify_cfg = DensifyConfig(**{k: dd[k] for k in DensifyConfig.__dataclass_fields__
                                           if k in dd})
        if int(config.get("parallel", {}).get("map_data_devices", 0)) > 1:
            raise NotImplementedError("multi-device mapping is not ported yet (ROADMAP.md)")
        self.mapper = make_mapper(
            self.camera, map_loss, rc, map_lrs, num_iters=mcfg["num_iters"],
            prune_cfg=prune or PruneConfig(start_after=10**9), densify_cfg=densify_cfg,
            device=dev,
        )
        self.densifier = make_densifier(self.camera, rc, mcfg["sil_thres"],
                                        self.num_semantic, device=dev)

        # ---- semantic decoder -------------------------------------------
        self.mlp, self.mlp_state = None, None
        if self.use_mlp:
            self.mlp = mlp_init(self.num_semantic, self.num_leaf, self.generator, dev)
            self.mlp_state = optim.adam_init(self.mlp)

        self.keyframes = KeyframeStore()
        self.gt_w2c_all: List[np.ndarray] = []
        self.logger = RunLogger(self.output_dir)
        self._progress_render = _build_renderer(self.camera, rc, with_semantic=False)
        self.plots = plotting_available()
        if not self.plots:
            print("matplotlib is not installed: progress panels and metrics.png are skipped "
                  "(the progress scalars are logged)", flush=True)

        self.start_idx = 0
        if config.get("load_checkpoint", False):
            self.start_idx = int(config["checkpoint_time_idx"])
            self._resume(self.start_idx)
        self.stats = dict(
            tracking_iter_time_sum=0.0, tracking_iter_time_count=0,
            tracking_frame_time_sum=0.0, tracking_frame_time_count=0,
            mapping_iter_time_sum=0.0, mapping_iter_time_count=0,
            mapping_frame_time_sum=0.0, mapping_frame_time_count=0,
            densify_added=0, densify_overflow=0,
            bin_overflow_last=0, bin_overflow_max=0,
            compactions=0, slots_reclaimed=0, emergency_pruned=0, progress_failed=0,
        )
        self.overflow_warn_threshold = int(
            config.get("raster", {}).get("overflow_warn_threshold", 100_000))
        self.bucket_step = int(config.get("bucket_step", 512 * 1024))
        self.bucket_headroom = int(config.get("bucket_headroom", 256 * 1024))
        self.bucket = self._choose_bucket()
        self.hole_compact_threshold = int(config.get("hole_compact_threshold", self.bucket_step))

    def _dataset_from_config(self, dc: Dict):
        """The dataset ``config["data"]`` names, as the JAX runner builds
        it: the YAML camera config merged under the data keys."""
        if "gradslam_data_cfg" in dc:
            data_cfg = {**load_dataset_config(dc["gradslam_data_cfg"]), **dc}
        else:
            data_cfg = dict(dc)
        data_cfg["results_dir"] = self.output_dir
        ds = get_dataset(
            config_dict=data_cfg, basedir=dc["basedir"],
            sequence=os.path.basename(dc["sequence"]), start=dc["start"], end=dc["end"],
            stride=dc["stride"], desired_height=dc["desired_image_height"],
            desired_width=dc["desired_image_width"], relative_pose=True,
        )
        return ds, "semantic" in data_cfg["dataset_name"]

    # ------------------------------------------------------------------
    def load_state(self, params: Dict, variables: Dict, mlp: Optional[Dict] = None,
                   mlp_state=None) -> None:
        """Install a JAX runner's numpy state (see ``utils/convert.py``)."""
        p, v, m, ms = from_jax_numpy(params, variables, mlp, mlp_state, self.device)
        self.params, self.variables = p, v
        if m is not None:
            self.mlp, self.mlp_state = m, ms
        self.capacity = p["means3D"].shape[0]
        self.bucket = self._choose_bucket()

    def _choose_bucket(self) -> int:
        need = int(self.variables["n_active"]) + self.bucket_headroom
        b = -(-need // self.bucket_step) * self.bucket_step
        return min(self.capacity, b)

    def _sliced_state(self):
        b = self.bucket
        p = {k: (v[:b] if k in G.GAUSSIAN_KEYS else v) for k, v in self.params.items()}
        v = {k: (x[:b] if x.dim() >= 1 and x.shape[0] == self.capacity else x)
             for k, x in self.variables.items()}
        return p, v

    def _merge_params(self, p_b) -> None:
        b = self.bucket
        for k, v in p_b.items():
            if k in G.GAUSSIAN_KEYS:
                self.params[k][:b] = v
            else:
                self.params[k] = v

    def _merge_variables(self, v_b) -> None:
        b = self.bucket
        for k, v in v_b.items():
            if v.dim() >= 1 and self.variables[k].shape[0] == self.capacity:
                self.variables[k][:b] = v
            else:
                self.variables[k] = v

    def _holes(self) -> int:
        return int(self.variables["n_active"]) - int(self.variables["active"].sum())

    def _compact(self, reason: str) -> None:
        holes = self._holes()
        self.params, self.variables = G.compact_slots(self.params, self.variables)
        self.stats["compactions"] += 1
        self.stats["slots_reclaimed"] += holes
        self.bucket = self._choose_bucket()
        self.logger.log(-1, compaction_reason=reason, slots_reclaimed=holes,
                        n_active=int(self.variables["n_active"]))

    def _escalated_prune(self, need_free: int, t: int) -> bool:
        headroom = max(need_free, self.bucket_headroom // 4)
        self.variables, n_freed = G.emergency_prune(self.params, self.variables, headroom)
        n_freed = int(n_freed)
        if n_freed == 0:
            return False
        warnings.warn(f"frame {t}: capacity saturated — escalated prune dropped the "
                      f"{n_freed} least-opaque gaussians to make room")
        self.stats["emergency_pruned"] += n_freed
        self.logger.log(t, emergency_pruned=n_freed)
        self._compact(f"escalated prune at frame {t}")
        return True

    def _resume(self, ckpt_t: int):
        """Reload ``params{t}.npz``, the keyframe indices and the decoder,
        then re-read frames 0..t-1 to rebuild ``gt_w2c_all`` and the
        keyframe store.  As in the JAX runner, optimizer moments and the aux
        variables start from zero (an approximate resume)."""
        dev = self.device
        ckpt = uio.load_params(os.path.join(self.output_dir, f"params{ckpt_t}.npz"))
        n = ckpt["means3D"].shape[0]
        if n > self.capacity:
            raise ValueError(f"checkpoint has {n} gaussians > capacity {self.capacity}")
        params = G.empty_params(self.capacity, self.num_frames, self.num_semantic, dev)
        for k in G.GAUSSIAN_KEYS:
            if k in ckpt and k in params:
                params[k][:n] = torch.as_tensor(ckpt[k], device=dev)
        params["cam_unnorm_rots"] = torch.as_tensor(ckpt["cam_unnorm_rots"], device=dev)
        params["cam_trans"] = torch.as_tensor(ckpt["cam_trans"], device=dev)
        self.params = params
        variables = G.empty_variables(self.capacity, dev)
        variables["active"][:n] = True
        variables["n_active"] = torch.tensor(n, dtype=torch.int64, device=dev)
        variables["scene_radius"] = self.variables["scene_radius"]
        if "timestep" in ckpt and ckpt["timestep"].shape[0] == n:
            variables["timestep"][:n] = torch.as_tensor(ckpt["timestep"], device=dev)
        self.variables = variables

        kf_idx = np.load(os.path.join(self.output_dir,
                                      f"keyframe_time_indices{ckpt_t}.npy")).tolist()
        dec = os.path.join(self.output_dir, f"semantic_decoder_{ckpt_t}.npz")
        if self.use_mlp and os.path.isfile(dec):
            self.mlp = {k: torch.as_tensor(v, device=dev)
                        for k, v in uio.load_semantic_decoder(dec).items()}
            self.mlp_state = optim.adam_init(self.mlp)
        for t in range(ckpt_t):
            im_np, depth_np, label_np, gt_w2c = self._load_frame(t)
            self.gt_w2c_all.append(gt_w2c)
            if t in kf_idx:
                self.keyframes.add(Keyframe(id=t, w2c=self._est_w2c(t), color=im_np,
                                            depth=depth_np, labels=label_np))

    def _load_frame(self, t: int):
        item = self.dataset[t]
        color, depth, _, pose = item[:4]
        label = item[4] if self.semantic else None
        gt_w2c = np.linalg.inv(np.asarray(pose))
        im = np.ascontiguousarray(color.transpose(2, 0, 1) / 255.0, dtype=np.float32)
        return im, np.asarray(depth, np.float32), label, gt_w2c

    def _window_arrays(self, frames: List[Keyframe]):
        dev = self.device
        window = {
            "im": torch.as_tensor(np.stack([f.color for f in frames]), device=dev),
            "depth": torch.as_tensor(np.stack([f.depth for f in frames]), device=dev),
            "time_idx": torch.as_tensor(np.array([f.id for f in frames], np.int64), device=dev),
        }
        if self.semantic:
            window["labels"] = torch.as_tensor(
                np.stack([f.labels for f in frames]).astype(np.int16), device=dev)
        return window

    def _est_w2c(self, t: int) -> np.ndarray:
        return est_w2c(self.params, t).cpu().numpy()

    # ------------------------------------------------------------------
    def step(self, time_idx: int, frame=None):
        """Process one frame (tracking + optional densify/map/keyframe);
        ``frame`` is what ``_load_frame(time_idx)`` returns, loaded here
        when not given."""
        cfg = self.config
        dev = self.device
        t = time_idx
        im_np, depth_np, label_np, gt_w2c = frame if frame is not None else self._load_frame(t)
        self.gt_w2c_all.append(gt_w2c)
        im = torch.as_tensor(im_np, device=dev)
        depth = torch.as_tensor(depth_np, device=dev)
        if t > 0:
            self.params = propagate_pose(self.params, t, cfg["tracking"]["forward_prop"])

        # (A) tracking
        t0 = time.time()
        if t > 0 and not cfg["tracking"]["use_gt_poses"]:
            p_b, v_b = self._sliced_state()
            p_b, bloss, maxrad, trace, carry = self.tracker(
                p_b, v_b["active"], v_b["max_2D_radius"], im, depth, t)
            if cfg["tracking"]["use_depth_loss_thres"]:
                if float(trace[1][-1]) >= cfg["tracking"]["depth_loss_thres"]:
                    p_b, bloss, maxrad, trace, carry = self.tracker.continue_round(
                        p_b, v_b["active"], im, depth, t, carry)
            bloss_f = float(bloss)
            self._merge_params(p_b)
            self.variables["max_2D_radius"][: self.bucket] = maxrad
            self.logger.log(t, tracking_loss=bloss_f)
            self.last_tracking_trace = {
                "loss": trace[0].cpu().numpy(), "depth": trace[1].cpu().numpy(),
                "im": trace[2].cpu().numpy()}
            self.logger.log_iters(t, "tracking", self.last_tracking_trace)
            self.stats["tracking_iter_time_sum"] += time.time() - t0
            self.stats["tracking_iter_time_count"] += cfg["tracking"]["num_iters"]
        elif t > 0:
            self.params = apply_gt_pose(
                self.params, torch.as_tensor(gt_w2c, dtype=torch.float32, device=dev), t)
        self.stats["tracking_frame_time_sum"] += time.time() - t0
        self.stats["tracking_frame_time_count"] += 1

        report = t == 0 or (t + 1) % cfg["report_global_progress_every"] == 0
        if report:
            self._report_progress(t, im, depth, "tracking", cfg["tracking"]["sil_thres"])

        # (B) densify + mapping
        if t == 0 or (t + 1) % cfg["map_every"] == 0:
            m0 = time.time()
            if cfg["mapping"].get("add_new_gaussians", True) and t > 0:
                gen_state = self.generator.get_state()
                p_b, v_b = self._sliced_state()
                p_b, v_b, n_added, n_over, n_bin_drop = self.densifier(
                    p_b, v_b, im, depth, t, self.generator)
                prune_attempts = 0
                while int(n_over) > 0:
                    if self.bucket < self.capacity:
                        self.bucket = min(self.capacity, self.bucket + self.bucket_step)
                    elif self._holes() > 0:
                        self._compact(f"densify overflow at frame {t}")
                    elif prune_attempts < 3 and self._escalated_prune(int(n_over), t):
                        prune_attempts += 1
                    else:
                        break
                    # each remedy redoes the densify with the same draws
                    self.generator.set_state(gen_state)
                    p_b, v_b = self._sliced_state()
                    p_b, v_b, n_added, n_over, n_bin_drop = self.densifier(
                        p_b, v_b, im, depth, t, self.generator)
                if int(n_over) > 0:
                    msg = (f"frame {t}: map capacity {self.capacity} saturated — "
                           f"{int(n_over)} new gaussians dropped even after "
                           "compaction and escalated pruning; raise map_capacity")
                    if cfg["mapping"].get("on_capacity_saturated", "error") == "error":
                        raise RuntimeError(msg)
                    warnings.warn(msg)
                self._merge_params(p_b)
                self._merge_variables(v_b)
                self.stats["densify_added"] += int(n_added)
                self.stats["densify_overflow"] += int(n_over)
                n_bin_drop = int(n_bin_drop)
                self.stats["bin_overflow_last"] = n_bin_drop
                self.stats["bin_overflow_max"] = max(self.stats["bin_overflow_max"], n_bin_drop)
                if n_bin_drop > self.overflow_warn_threshold:
                    warnings.warn(f"frame {t}: {n_bin_drop} (gaussian, tile) pairs dropped "
                                  "by binning caps — consider raising raster.max_per_tile")
                self.logger.log(t, bin_overflow=n_bin_drop)

            est = self._est_w2c(t)
            num_kf = cfg["mapping_window_size"] - 2
            selected = keyframe_selection_overlap(
                depth_np, est, self.intrinsics, self.keyframes.frames[:-1], num_kf,
                rng=self.rng)
            window_frames = [self.keyframes.frames[i] for i in selected]
            if len(self.keyframes) > 0:
                window_frames.append(self.keyframes.frames[-1])
            window_frames.append(Keyframe(id=t, w2c=est, color=im_np, depth=depth_np,
                                          labels=label_np))
            # the JAX mapper pads the window to a static size; rand_idx never
            # reads the padding, so the port binds only the real frames
            window = self._window_arrays(window_frames)
            rand_idx = self.rng.integers(0, len(window_frames), cfg["mapping"]["num_iters"])
            p_b, v_b = self._sliced_state()
            p_b, v_b, self.mlp, self.mlp_state, losses = self.mapper(
                p_b, v_b, window, rand_idx, self.mlp, self.mlp_state, self.generator)
            losses = {k: v.cpu().numpy() for k, v in losses.items()}
            self._merge_params(p_b)
            self._merge_variables(v_b)
            if self._holes() >= self.hole_compact_threshold:
                self._compact(f"hole threshold after mapping at frame {t}")
            else:
                self.bucket = max(self.bucket, self._choose_bucket())
            self.last_mapping_trace = losses
            self.logger.log_iters(t, "mapping", losses)
            n_mb = int(np.max(losses.get("n_map_bin_dropped", 0.0)))
            if n_mb > self.overflow_warn_threshold:
                vb = self.rc.visible_budget
                if self.rc.backend == "stream":
                    causes = "row budget / per-tile cap / emission budgets"
                    knob = "raster.stream_rows / stream_cap"
                else:
                    causes = ("capacity-class ladder / emission budgets"
                              + (f" / visible_budget={vb}" if vb else ""))
                    knob = "raster.bucket_spec"
                warnings.warn(f"frame {t}: mapping binning dropped {n_mb} (gaussian, tile) "
                              f"pairs ({causes}) — consider widening {knob}")
                self.logger.log(t, n_map_bin_dropped=n_mb)
            n_gd = int(np.max(losses.get("n_grad_dropped", 0.0)))
            if n_gd > 0:
                warnings.warn(f"frame {t}: {n_gd} gradient routes truncated by "
                              f"grad_pair_budget={self.rc.grad_pair_budget}")
                self.logger.log(t, n_grad_dropped=n_gd)
            final_loss = float(losses["loss"][-1])
            self.logger.log(t, mapping_loss=final_loss, n_active=int(self.variables["n_active"]))
            dm = time.time() - m0
            self.stats["mapping_iter_time_sum"] += dm
            self.stats["mapping_iter_time_count"] += cfg["mapping"]["num_iters"]
            self.stats["mapping_frame_time_sum"] += dm
            self.stats["mapping_frame_time_count"] += 1
            if report:
                self._report_progress(t, im, depth, "mapping", cfg["mapping"]["sil_thres"])

        # (C) keyframe admission
        if ((t == 0 or (t + 1) % cfg["keyframe_every"] == 0 or t == self.num_frames - 2)
                and np.isfinite(gt_w2c).all()):
            self.keyframes.add(Keyframe(id=t, w2c=self._est_w2c(t), color=im_np,
                                        depth=depth_np, labels=label_np))

        # (D) checkpoint
        if cfg["save_checkpoints"] and t % cfg["checkpoint_interval"] == 0:
            pn = G.active_params_to_numpy(self.params, self.variables)
            uio.save_params_ckpt(pn, self.output_dir, t)
            np.save(os.path.join(self.output_dir, f"keyframe_time_indices{t}.npy"),
                    np.array(self.keyframes.time_indices))
            uio.save_semantic_decoder(self._mlp_numpy(), self.output_dir, suffix=f"_{t}")

    # ------------------------------------------------------------------
    def _report_progress(self, t, im, depth, phase: str, sil_thres: float):
        """A progress report; a failure is counted, saves an emergency
        checkpoint and the run goes on, as in the JAX runner."""
        try:
            report_progress(self._progress_render, self.params, im, depth, t, self.gt_w2c_all,
                            sil_thres, self.plot_dir, phase=phase, save_plot=self.plots,
                            logger=self.logger)
        except Exception:   # a report must not end the run
            traceback.print_exc()
            self.stats["progress_failed"] += 1
            self.emergency_checkpoint(t)
            print("Failed to evaluate trajectory.")

    def emergency_checkpoint(self, t: int):
        """Save a recoverable snapshot (what ``_resume`` reads) on failure."""
        pn = G.active_params_to_numpy(self.params, self.variables)
        uio.save_params_ckpt(pn, self.output_dir, t)
        np.save(os.path.join(self.output_dir, f"keyframe_time_indices{t}.npy"),
                np.array(self.keyframes.time_indices))
        uio.save_semantic_decoder(self._mlp_numpy(), self.output_dir, suffix=f"_{t}")

    def run(self, progress: bool = True):
        """Step frames ``start_idx .. num_frames - 1`` (loaded by a thread
        two frames ahead), save ``params.npz``, plot metrics.png where
        matplotlib is installed and print the runtime summary.  A frame
        that raises leaves an emergency checkpoint."""
        frames = Prefetcher(self._load_frame, self.start_idx, self.num_frames, depth=2)
        t_run = time.time()
        for t, frame in frames:
            try:
                self.step(t, frame)
            except Exception:
                self.emergency_checkpoint(t)
                raise
            if progress:
                print(f"hierslam-torch: frame {t + 1}/{self.num_frames} "
                      f"({time.time() - t_run:.1f} s)", flush=True)
        pn = self.finalize()          # closes the metrics log
        if self.plots:
            try:
                plot_metrics(self.logger.path, os.path.join(self.eval_dir, "metrics.png"),
                             keys=("tracking_loss", "mapping_loss", "n_active"))
            except Exception as e:
                print(f"metrics plot failed: {e}")
        summ = self.runtime_summary()
        print(
            "Average Tracking/Iteration Time: {:.2f} ms\n"
            "Average Tracking/Frame Time: {:.3f} s\n"
            "Average Mapping/Iteration Time: {:.2f} ms\n"
            "Average Mapping/Frame Time: {:.3f} s".format(
                summ["tracking_iter_ms"], summ["tracking_frame_s"],
                summ["mapping_iter_ms"], summ["mapping_frame_s"],
            )
        )
        return pn, summ

    def _mlp_numpy(self):
        if self.mlp is None:
            return None
        return {k: v.detach().cpu().numpy() for k, v in self.mlp.items()}

    def finalize(self) -> Dict[str, np.ndarray]:
        """Save the final ``params.npz`` (the JAX runner's keys) and
        ``semantic_decoder.npz``."""
        pn = G.active_params_to_numpy(self.params, self.variables)
        pn["intrinsics"] = self.intrinsics
        pn["w2c"] = self.first_frame_w2c
        pn["org_width"] = np.asarray(self.W)
        pn["org_height"] = np.asarray(self.H)
        pn["gt_w2c_all_frames"] = np.stack(self.gt_w2c_all)
        pn["keyframe_time_indices"] = np.array(self.keyframes.time_indices)
        uio.save_params(pn, self.output_dir)
        uio.save_semantic_decoder(self._mlp_numpy(), self.output_dir)
        self.logger.close()
        return pn

    def runtime_summary(self) -> Dict[str, float]:
        s = self.stats

        def avg(a, b):
            return s[a] / max(s[b], 1)

        return {
            "tracking_iter_ms": avg("tracking_iter_time_sum", "tracking_iter_time_count") * 1e3,
            "tracking_frame_s": avg("tracking_frame_time_sum", "tracking_frame_time_count"),
            "mapping_iter_ms": avg("mapping_iter_time_sum", "mapping_iter_time_count") * 1e3,
            "mapping_frame_s": avg("mapping_frame_time_sum", "mapping_frame_time_count"),
            "densify_added": s["densify_added"],
            "densify_overflow": s["densify_overflow"],
            "bin_overflow_last": s["bin_overflow_last"],
            "bin_overflow_max": s["bin_overflow_max"],
            "compactions": s["compactions"],
            "slots_reclaimed": s["slots_reclaimed"],
            "emergency_pruned": s["emergency_pruned"],
            "progress_failed": s["progress_failed"],
            "n_active": int(self.variables["active"].sum()),
        }


def run_slam(config: Dict, do_eval: bool = True, device="cuda"):
    """SLAM over the config's dataset, then (``do_eval``) the final eval.
    -> (params_np, runtime summary, eval results or None)."""
    runner = SLAMRunner(config, device=device)
    params_np, summary = runner.run()
    results = None
    if do_eval:
        results = run_final_eval(runner.dataset, params_np, runner.config, runner.eval_dir,
                                 mlp=runner._mlp_numpy(), num_frames=runner.num_frames,
                                 device=device)
    return params_np, summary, results
