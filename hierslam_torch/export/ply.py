"""PLY exporters for `params.npz` maps (a port-owned copy of
``hierslam_tpu/export/ply.py``, numpy only).

Equivalents of scripts/export_ply.py, export_ply_semantic.py and
export_ply_semantic_tree.py: standard 3DGS PLY attribute layout (x,y,z,
normals, f_dc from RGB2SH, opacity logit, per-axis log scales, quaternion)
plus semantic variants that color each Gaussian by its decoded tree label.
Binary little-endian PLY written directly (no plyfile dependency).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

SH_C0 = 0.28209479177387814


def rgb_to_sh(rgb: np.ndarray) -> np.ndarray:
    """RGB in [0,1] -> 0th-order SH coefficient (utils/graphics_utils.py:109)."""
    return (rgb - 0.5) / SH_C0


def sh_to_rgb(sh: np.ndarray) -> np.ndarray:
    return sh * SH_C0 + 0.5


def _write_ply(path: str, fields: List[tuple]) -> None:
    """fields: list of (name, float32 column [N])."""
    n = len(fields[0][1])
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name, _ in fields]
    header.append("end_header")
    data = np.stack([np.asarray(col, np.float32) for _, col in fields], axis=1)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.astype("<f4").tobytes())


def _gaussian_columns(params: Dict[str, np.ndarray], rgb: np.ndarray) -> List[tuple]:
    means = np.asarray(params["means3D"])
    n = means.shape[0]
    log_scales = np.asarray(params["log_scales"])
    if log_scales.shape[1] == 1:
        log_scales = np.tile(log_scales, (1, 3))
    rots = np.asarray(params["unnorm_rotations"])
    f_dc = rgb_to_sh(np.asarray(rgb))
    cols = [
        ("x", means[:, 0]), ("y", means[:, 1]), ("z", means[:, 2]),
        ("nx", np.zeros(n)), ("ny", np.zeros(n)), ("nz", np.zeros(n)),
        ("f_dc_0", f_dc[:, 0]), ("f_dc_1", f_dc[:, 1]), ("f_dc_2", f_dc[:, 2]),
        ("opacity", np.asarray(params["logit_opacities"])[:, 0]),
        ("scale_0", log_scales[:, 0]), ("scale_1", log_scales[:, 1]),
        ("scale_2", log_scales[:, 2]),
        ("rot_0", rots[:, 0]), ("rot_1", rots[:, 1]),
        ("rot_2", rots[:, 2]), ("rot_3", rots[:, 3]),
    ]
    return cols


def export_ply(params: Dict[str, np.ndarray], path: str) -> str:
    """Standard 3DGS PLY with the map's RGB colors (export_ply.py:20-46)."""
    _write_ply(path, _gaussian_columns(params, params["rgb_colors"]))
    return path


def decode_gaussian_tree_labels(
    semantic: np.ndarray, num_semantic: List[int]
) -> np.ndarray:
    """Per-Gaussian per-level argmax over the tree embedding
    (export_ply_semantic_tree.py:208-228): [N, S] -> [N, L]."""
    out = []
    off = 0
    for n_cls in num_semantic[:-1]:
        out.append(np.argmax(semantic[:, off : off + n_cls], axis=1))
        off += n_cls
    return np.stack(out, 1)


def export_ply_semantic(
    params: Dict[str, np.ndarray],
    path: str,
    colormap: np.ndarray,
    num_semantic=None,
    mlp: Optional[Dict] = None,
    level: Optional[int] = None,
) -> str:
    """Color each Gaussian by its decoded semantic label
    (export_ply_semantic[_tree].py).

    * flat embedding: argmax over channels;
    * tree embedding + ``mlp``: leaf decode through the 1x1-conv decoder;
    * tree embedding + ``level``: color by that level's argmax
      (per-level export, export_ply_semantic_tree.py:329-382).
    """
    sem = np.asarray(params["semantic"])
    if isinstance(num_semantic, (list, tuple)):
        levels = decode_gaussian_tree_labels(sem, list(num_semantic))
        if level is not None:
            labels = levels[:, level]
        elif mlp is not None:
            labels = np.argmax(sem @ np.asarray(mlp["w"]).T + np.asarray(mlp["b"]), axis=1)
        else:
            labels = levels[:, -1]
    else:
        labels = np.argmax(sem, axis=1)
    rgb = colormap[np.clip(labels, 0, len(colormap) - 1)][:, :3].astype(np.float32) / 255.0
    _write_ply(path, _gaussian_columns(params, rgb))
    return path
