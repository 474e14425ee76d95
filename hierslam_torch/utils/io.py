"""Checkpoint / artifact IO (a port-owned copy of ``hierslam_tpu/utils/io.py``).

``params.npz`` carries the same keys as the reference final artifact
(scripts/hierslam.py:2163-2176) so its eval / PLY-export / viz tooling can
read ours.  The 1x1-conv semantic decoder is saved as
``semantic_decoder.npz`` ({'w': [L,S], 'b': [L]}) — the functional
equivalent of ``Semantic.pth``.
"""
from __future__ import annotations

import os
import random
from typing import Dict, Optional

import numpy as np


def seed_everything(seed: int = 42) -> None:
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def save_params(params_np: Dict[str, np.ndarray], output_dir: str, suffix: str = "") -> str:
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"params{suffix}.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in params_np.items()})
    return path


def save_params_ckpt(params_np: Dict[str, np.ndarray], output_dir: str, time_idx: int) -> str:
    return save_params(params_np, output_dir, suffix=str(time_idx))


def load_params(path: str) -> Dict[str, np.ndarray]:
    return dict(np.load(path, allow_pickle=True))


def save_semantic_decoder(mlp: Optional[Dict], output_dir: str, suffix: str = "") -> Optional[str]:
    if mlp is None:
        return None
    path = os.path.join(output_dir, f"semantic_decoder{suffix}.npz")
    np.savez(path, w=np.asarray(mlp["w"]), b=np.asarray(mlp["b"]))
    return path


def load_semantic_decoder(path: str) -> Dict:
    data = np.load(path)
    return {"w": data["w"], "b": data["b"]}
