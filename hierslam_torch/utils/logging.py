"""Run metrics logger (port-owned copy of ``hierslam_tpu/utils/logging.py``):
JSONL records per frame and per optimizer iteration, sent to wandb as
well when ``use_wandb`` is set and wandb imports and starts (else it says
so and logs locally, as the JAX package does), and ``plot_metrics``
(needs matplotlib)."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class RunLogger:
    def __init__(self, out_dir: str, use_wandb: bool = False, wandb_cfg: Optional[Dict] = None):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.t0 = time.time()
        self._iter_counts: Dict[str, int] = {}
        self.last: Dict = {}   # the latest value of each metric
        self.wandb = None      # the wandb run, when one started
        if use_wandb:
            try:
                import wandb

                self.wandb = wandb.init(**(wandb_cfg or {}))
            except Exception as e:   # wandb is optional, as in the JAX package
                print(f"wandb unavailable ({e}); logging locally only")

    def log(self, step: int, **metrics):
        rec = {"step": step, "t": round(time.time() - self.t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()})
        self.last.update({k: v for k, v in rec.items() if k not in ("step", "t")})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def log_iters(self, frame: int, phase: str, traces: Dict):
        """One record per optimizer iteration of a phase; ``traces`` maps a
        loss term to its [num_iters] values (numpy).  wandb gets them as
        ``<Phase>/<term>`` with the phase's running iteration count."""
        names = list(traces.keys())
        cols = {k: np.asarray(traces[k], dtype=np.float64) for k in names}
        n = len(cols[names[0]])
        base = self._iter_counts.get(phase, 0)
        for i in range(n):
            rec = {"step": frame, "phase": phase, "iter": base + i}
            rec.update({f"{phase}_{k}": float(cols[k][i]) for k in names})
            self._f.write(json.dumps(rec) + "\n")
            if self.wandb is not None:
                self.wandb.log({f"{phase.capitalize()}/{k}": float(cols[k][i]) for k in names}
                               | {f"{phase.capitalize()}/step": base + i})
        self._iter_counts[phase] = base + n
        self._f.flush()

    def close(self):
        self._f.close()
        if self.wandb is not None:
            self.wandb.finish()


def plot_metrics(jsonl_path: str, out_png: str, keys=("tracking_loss", "mapping_loss")):
    """metrics.png: each key's per-frame values from the JSONL log."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(jsonl_path) as f:
        rows = [json.loads(line) for line in f]
    fig, axes = plt.subplots(1, len(keys), figsize=(5 * len(keys), 3.5))
    if len(keys) == 1:
        axes = [axes]
    for ax, k in zip(axes, keys):
        ax.plot([r["step"] for r in rows if k in r], [r[k] for r in rows if k in r])
        ax.set_title(k)
        ax.set_xlabel("frame")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return out_png
