#!/usr/bin/env python3
"""Which ops of the port's GPU path PyTorch holds to be nondeterministic.

    python3 tools/determinism_census.py

Runs ``chip_smoke.py``'s ``[reference]`` phase (3 frames at 96x64 with each
mapper, GPU against CPU) and its ``[tum]`` phase (the TUM layout through
the CLI, twice) under ``torch.use_deterministic_algorithms(True,
warn_only=True)``, and prints every distinct warning each raised, with its
count: an op without a deterministic CUDA implementation warns on every
call.  Warnings of other origins are printed too and are told apart by
their text.  The last line is a JSON object of the phases' warnings.
Needs one GPU.
"""
from __future__ import annotations

import json
import os
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this tool needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from hierslam_torch.ops import kernels

    kernels.build()
    cfg_path = os.path.join(ROOT, "configs", "replica", "hierslam_semantic_run.py")
    torch.use_deterministic_algorithms(True, warn_only=True)
    phases = {"reference stream": lambda: cs.reference_phase(cfg_path, "stream"),
              "reference pallas": lambda: cs.reference_phase(cfg_path, "pallas"),
              "tum": cs.tum_phase}
    out, ok = {}, True
    for name, run in phases.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ok &= bool(run()[0])
        seen = {}
        for w in caught:
            text = str(w.message).splitlines()[0][:300]
            seen[text] = seen.get(text, 0) + 1
        out[name] = seen
        print(f"[census] {name}: {len(seen)} distinct warnings", flush=True)
        for text, n in sorted(seen.items(), key=lambda kv: -kv[1]):
            print(f"[census] {name}: {n}x {text}", flush=True)
    print(json.dumps({"ok": ok, "warnings": out}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
