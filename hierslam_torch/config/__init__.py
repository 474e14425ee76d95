"""Config system (port of ``hierslam_tpu/config/__init__.py``).

Executable Python config modules defining ``config = dict(...)`` — the
files under ``configs/`` load unchanged.  ``raster_config`` maps the
``raster`` dict onto :class:`~hierslam_torch.ops.rasterize.RasterConfig`.
"""
from __future__ import annotations

import importlib.util
import os
from typing import Dict

from hierslam_torch.ops.rasterize import RasterConfig


def load_config(path: str) -> Dict:
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(f"hierslam_config_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.config


def apply_defaults(config: Dict) -> Dict:
    """The reference driver's start-up default patching."""
    config = dict(config)
    tr = dict(config.get("tracking", {}))
    tr.setdefault("use_depth_loss_thres", False)
    tr.setdefault("depth_loss_thres", 100000)
    tr.setdefault("visualize_tracking_loss", False)
    config["tracking"] = tr
    config.setdefault("gaussian_distribution", "isotropic")
    data = dict(config.get("data", {}))
    data.setdefault("ignore_bad", False)
    data.setdefault("use_train_split", True)
    config["data"] = data
    config.setdefault("map_capacity", 2_000_000)
    config.setdefault("seed", 0)
    config.setdefault("report_global_progress_every", 500)
    config.setdefault("checkpoint_interval", 500)
    config.setdefault("save_checkpoints", False)
    config.setdefault("load_checkpoint", False)
    config.setdefault("checkpoint_time_idx", 0)
    config.setdefault("use_wandb", False)
    config.setdefault("eval_every", 5)
    return config


def raster_config(config: Dict) -> RasterConfig:
    r = config.get("raster", {})
    mtg = r.get("max_tiles_per_gaussian", 16)
    return RasterConfig(
        tile_shape=tuple(r.get("tile_shape", (16, 16))),
        max_per_tile=r.get("max_per_tile", 1024),
        gaussian_chunk=r.get("gaussian_chunk", 256),
        tile_batch=r.get("tile_batch", 64),
        bin_chunk=r.get("bin_chunk", 16384),
        max_tiles_per_gaussian=mtg,
        max_refs=r.get("max_refs", mtg),
        backend=r.get("backend", "pallas"),
        pallas_interpret=r.get("pallas_interpret", False),
        grad_pair_budget=r.get("grad_pair_budget", 0),
        grad_bf16=r.get("grad_bf16", False),
        track_max_per_tile=r.get("track_max_per_tile", 0),
        escalate_tiles=r.get("escalate_tiles", 0),
        escalate_k=r.get("escalate_k", 0),
        densify_max_per_tile=r.get("densify_max_per_tile", 0),
        bucket_spec=(tuple(tuple(e) for e in r["bucket_spec"])
                     if r.get("bucket_spec") else None),
        track_bucket_spec=(tuple(tuple(e) for e in r["track_bucket_spec"])
                           if r.get("track_bucket_spec") else None),
        sat_margin=r.get("sat_margin", 0.0),
        sat_floor=r.get("sat_floor", 64),
        track_sat_margin=r.get("track_sat_margin", -1.0),
        visible_budget=r.get("visible_budget", 0),
        stream_rows=r.get("stream_rows", 0),
        stream_cap=r.get("stream_cap", 4096),
    )
