"""hierslam_torch — the PyTorch + CUDA port of ``hierslam_tpu``.

The JAX package beside this one is the reference: every module here mirrors
the JAX module of the same name, and the tests hold each function against
its JAX counterpart on the same numpy inputs.  The ladder blend
(``csrc/blend.cu``) and the stream blend with its in-kernel projection
(``csrc/stream.cu``), forward and backward, and the gathers' backward
(``csrc/gather.cu``) run as hand-written CUDA kernels for Hopper;
everything else is plain PyTorch.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
without CUDA they raise rather than fall back.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"

# The JAX package forces Precision.HIGHEST on the SSIM convolutions, the
# tracking pose transform and the semantic decoder; TF32 would bring back
# the variance cancellation ops/ssim.py records for reduced precision.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless ``device="cpu"``.

    Raises when CUDA is asked for and missing: the port never falls back
    to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
