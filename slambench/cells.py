"""Finding a cell's files by name, and the inputs the benchmark makes.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix;
``slambench/configs/<config>.json``, ``slambench/traffic/<traffic>.json``
and ``slambench/limits/<cell>.json`` hold them, and each per-layer metric
is read by ``slambench/metrics/<metric>.py``.  This module also holds the
benchmark's dataset (the procedural room rendered on the device), the map
it makes from the seed and the resume checkpoint it writes.
"""
from __future__ import annotations

import json
import math
import os
import runpy
from typing import Dict, List

import numpy as np
import torch

from slambench.frozen import room

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "slambench")


def _json(*parts) -> Dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_benchmark() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(name: str, bench: Dict = None) -> Dict:
    """The cell ``name`` with its configuration, traffic, limits, and the
    end-to-end and per-layer metrics it reports."""
    bench = bench or load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    cell = cells[name]

    def reports(m, e2e_names):
        if "workloads" in m:
            return name in m["workloads"]
        return m.get("moves", m["name"]) in e2e_names

    e2e = [m for m in bench["end_to_end"] if reports(m, {m["name"]})]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, e2e_names)]
    return dict(name=name, cell=cell, config=_json("configs", cell["config"] + ".json"),
                traffic=_json("traffic", cell["traffic"] + ".json"),
                limits=_json("limits", name + ".json"), end_to_end=e2e, per_layer=per_layer)


def shipped_config(spec: Dict) -> Dict:
    """The shipped config the configuration names, with the keys that the
    configuration and the traffic set (dotted paths into its dicts)."""
    cfg = runpy.run_path(os.path.join(ROOT, spec["config"]["config_file"]))["config"]
    for key, value in {**spec["config"].get("set", {}), **spec["traffic"].get("set", {})}.items():
        d = cfg
        *path, last = key.split(".")
        for p in path:
            d = d[p]
        d[last] = value
    return cfg


def run_config(spec: Dict, seed: int, workdir: str) -> Dict:
    """The config a run hands ``SLAMRunner``: shipped, then resumed from the
    benchmark's checkpoint at the traffic's resume frame, seeded from
    ``seed``, writing under ``workdir``."""
    cfg = shipped_config(spec)
    cfg.update(workdir=workdir, run_name="run", seed=int(seed) % 2**31, load_checkpoint=True,
               checkpoint_time_idx=int(spec["traffic"]["resume_frame"]), save_checkpoints=False)
    cfg["data"] = dict(cfg["data"], num_frames=-1)
    return cfg


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one use of the run's ``seed`` (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % 2**64, sum(ord(c) << (8 * i) for i, c in
                                                        enumerate(what[:8]))])
    return int(ss.generate_state(2, np.uint32).astype(np.uint64) @ np.array([1, 2**32],
                                                                            np.uint64)) >> 1


class RoomSequence:
    """The procedural room as a dataset of ``SLAMRunner``: ``len()`` frames,
    ``ds[t]`` -> (colour uint8 [H, W, 3], depth float32 [H, W], K 4x4, c2w
    4x4 relative to frame 0, labels int32 [L+1, H, W]) as numpy arrays,
    rendered on ``device``; :meth:`prerender` renders the frames a run's
    loader will hand on into host memory during set-up, so that the loader
    thread only hands over numpy arrays, as a loader from disk would, and
    puts no work of the benchmark's on the card inside the window.  The
    labels map the
    room's six primitives onto the configuration's tree: leaf
    ``leaf_of_prim[p]``, level i ``(leaf * level_multipliers[i]) %
    sem_widths[i]``."""

    def __init__(self, frames: Dict, arc_frames: int, n_frames: int, device="cuda"):
        self.f = frames
        self.arc_frames = int(arc_frames)
        self.n = int(n_frames)
        self.device = torch.device(device)
        self.num_semantic = list(frames["sem_widths"]) + [int(frames["num_leaf"])]
        self.num_semantic_class = int(frames["num_leaf"])
        K4 = np.eye(4)
        K4[0, 0], K4[1, 1], K4[0, 2], K4[1, 2] = (frames["fx"], frames["fy"], frames["cx"],
                                                  frames["cy"])
        self.K4 = K4
        self.inv0 = np.linalg.inv(room.camera_c2w(0, self.arc_frames).numpy())
        leaf = torch.as_tensor(frames["leaf_of_prim"], dtype=torch.int64)
        levels = [(leaf * m) % w for m, w in zip(frames["level_multipliers"],
                                                  frames["sem_widths"])]
        self.label_of_prim = torch.stack(levels + [leaf]).to(torch.int32).to(self.device)
        self.host: Dict[int, tuple] = {}

    def __len__(self):
        return self.n

    def pose(self, t: int) -> np.ndarray:
        """c2w of frame ``t`` relative to frame 0 (float64); frame ``t`` is
        frame ``t % arc_frames``: the arc goes round again."""
        return self.inv0 @ room.camera_c2w(t % self.arc_frames, self.arc_frames).numpy()

    def render(self, t: int):
        """Frame ``t`` on the device: (colour uint8 [H, W, 3], depth [H, W],
        labels int32 [L+1, H, W])."""
        f = self.f
        rgb, depth, _, prim = room.render_frame(t % self.arc_frames, f["W"], f["H"], f["fx"],
                                                f["fy"], f["cx"], f["cy"], self.arc_frames,
                                                self.device)
        return rgb, depth, self.label_of_prim[:, prim]

    def prerender(self, start: int) -> None:
        """Frames ``start``..``len - 1`` into host memory (labels as int16),
        each distinct frame of the arc once."""
        for t in range(start, self.n):
            key = t % self.arc_frames
            if key not in self.host:
                rgb, depth, labels = self.render(key)
                self.host[key] = (rgb.cpu().numpy(), depth.cpu().numpy(),
                                  labels.to(torch.int16).cpu().numpy())

    def __getitem__(self, t: int):
        if not 0 <= t < self.n:
            raise IndexError(t)
        if t % self.arc_frames in self.host:
            rgb, depth, labels = self.host[t % self.arc_frames]
            labels = labels.astype(np.int32)
        else:
            rgb, depth, labels = (x.cpu().numpy() for x in self.render(t))
        return rgb, depth, self.K4.copy(), self.pose(t), labels


def _quaternion(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation whose angle is well below pi (w > 0)."""
    w = 0.5 * math.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12))
    return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w)])


def make_map(ds: RoomSequence, n: int, frames: int, seed: int, num_semantic: int) -> Dict:
    """``n`` gaussians on the room's surfaces as frames 0..frames-1 see them,
    made on the dataset's device from ``seed``: each frame gives an equal
    share (the first ``n % frames`` one more) of its valid depth pixels,
    drawn without replacement, back-projected at the frame's pose; colour
    the pixel's; isotropic log scale log(z / mean focal), as the program's
    densify sets it; identity rotation; opacity logit ~ N(1.5, 1); semantic
    features the pixel's leaf's embedding, a U[0, 1) vector a leaf drawn from
    the seed; timestep the frame.  -> {key: tensor} (the checkpoint's keys)."""
    dev = ds.device
    g = torch.Generator(device=dev)
    g.manual_seed(sub_seed(seed, "map"))
    f = ds.f
    fmean = 0.5 * (f["fx"] + f["fy"])
    xs = (torch.arange(f["W"], dtype=torch.float32, device=dev) - f["cx"]) / f["fx"]
    ys = (torch.arange(f["H"], dtype=torch.float32, device=dev) - f["cy"]) / f["fy"]
    xx = xs[None, :].expand(f["H"], f["W"]).reshape(-1)
    yy = ys[:, None].expand(f["H"], f["W"]).reshape(-1)
    share = [n // frames + (1 if t < n % frames else 0) for t in range(frames)]
    parts = {k: [] for k in ("means3D", "rgb_colors", "log_scales", "leaf", "timestep")}
    for t in range(frames):
        rgb, depth, labels = ds.render(t)
        z = depth.reshape(-1)
        valid = torch.nonzero(z > 0)[:, 0]
        pick = valid[torch.randperm(valid.shape[0], generator=g, device=dev)[:share[t]]]
        zp = z[pick]
        cam = torch.stack([xx[pick] * zp, yy[pick] * zp, zp], -1)
        c2w = torch.as_tensor(ds.pose(t), dtype=torch.float32, device=dev)
        parts["means3D"].append(cam @ c2w[:3, :3].T + c2w[:3, 3])
        parts["rgb_colors"].append(rgb.reshape(-1, 3)[pick].float() / 255.0)
        parts["log_scales"].append(torch.log(zp / fmean)[:, None])
        parts["leaf"].append(labels[-1].reshape(-1)[pick].long())
        parts["timestep"].append(torch.full((pick.shape[0],), float(t), device=dev))
    m = {k: torch.cat(v) for k, v in parts.items()}
    leaf = m.pop("leaf")
    rots = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    rots[:, 0] = 1.0
    m["unnorm_rotations"] = rots
    m["logit_opacities"] = 1.5 + torch.randn((n, 1), generator=g, device=dev)
    if num_semantic > 0:
        emb = torch.rand((ds.num_semantic_class, num_semantic), generator=g, device=dev)
        m["semantic"] = emb[leaf]
    return m


def decoder_weights(num_semantic: int, num_leaf: int, seed: int) -> Dict[str, np.ndarray]:
    """The semantic decoder of the checkpoint: U(-1/sqrt(S), 1/sqrt(S)), as
    the program initialises it, drawn from ``seed``."""
    rng = np.random.default_rng(sub_seed(seed, "decoder"))
    b = 1.0 / math.sqrt(num_semantic)
    return {"w": rng.uniform(-b, b, (num_leaf, num_semantic)).astype(np.float32),
            "b": rng.uniform(-b, b, (num_leaf,)).astype(np.float32)}


def keyframe_indices(S: int, keyframe_every: int) -> List[int]:
    """The frames before ``S`` that the runner's keyframe rule admits."""
    return [t for t in range(S) if t == 0 or (t + 1) % keyframe_every == 0]


def write_checkpoint(out_dir: str, m: Dict, ds: RoomSequence, S: int, keyframe_every: int,
                     decoder=None) -> None:
    """The resume checkpoint ``SLAMRunner._resume`` reads, at frame ``S``:
    ``params{S}.npz`` (the map and the arc's w2c poses of frames 0..S-1 as
    quaternion and translation), ``keyframe_time_indices{S}.npy`` and, with
    a decoder, ``semantic_decoder_{S}.npz``."""
    os.makedirs(out_dir, exist_ok=True)
    rots, trans = checkpoint_poses(ds, S)
    arrays = {k: v.detach().cpu().numpy() for k, v in m.items()}
    np.savez(os.path.join(out_dir, f"params{S}.npz"), cam_unnorm_rots=rots.numpy(),
             cam_trans=trans.numpy(), **arrays)
    np.save(os.path.join(out_dir, f"keyframe_time_indices{S}.npy"),
            np.array(keyframe_indices(S, keyframe_every)))
    if decoder is not None:
        np.savez(os.path.join(out_dir, f"semantic_decoder_{S}.npz"), **decoder)


def checkpoint_poses(ds: RoomSequence, S: int):
    """The checkpoint's trajectory as tensors [1, 4, n], [1, 3, n]."""
    rots = torch.zeros((1, 4, len(ds)), dtype=torch.float32)
    rots[0, 0] = 1.0
    trans = torch.zeros((1, 3, len(ds)), dtype=torch.float32)
    for t in range(S):
        w2c = np.linalg.inv(ds.pose(t))
        rots[0, :, t] = torch.as_tensor(_quaternion(w2c[:3, :3]), dtype=torch.float32)
        trans[0, :, t] = torch.as_tensor(w2c[:3, 3], dtype=torch.float32)
    return rots, trans
