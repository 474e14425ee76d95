"""Run one cell of the benchmark once and print its result line.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (see slambench/README.md)."""
import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# caches inside the checkout, at fixed paths (the kernels' own nvcc build
# directory is hierslam_torch/csrc/build)
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "slambench_out", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "slambench_out", "extensions"))
sys.path.insert(0, ROOT)

from slambench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
