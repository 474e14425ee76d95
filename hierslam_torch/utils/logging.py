"""Run metrics logger (port-owned copy of ``hierslam_tpu/utils/logging.py``,
without the optional wandb hook): JSONL records per frame and per
optimizer iteration."""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class RunLogger:
    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.t0 = time.time()
        self._iter_counts: Dict[str, int] = {}

    def log(self, step: int, **metrics):
        rec = {"step": step, "t": round(time.time() - self.t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log_iters(self, frame: int, phase: str, traces: Dict):
        """One record per optimizer iteration of a phase; ``traces`` maps a
        loss term to its [num_iters] values (numpy)."""
        names = list(traces.keys())
        cols = {k: np.asarray(traces[k], dtype=np.float64) for k in names}
        n = len(cols[names[0]])
        base = self._iter_counts.get(phase, 0)
        for i in range(n):
            rec = {"step": frame, "phase": phase, "iter": base + i}
            rec.update({f"{phase}_{k}": float(cols[k][i]) for k in names})
            self._f.write(json.dumps(rec) + "\n")
        self._iter_counts[phase] = base + n
        self._f.flush()

    def close(self):
        self._f.close()
