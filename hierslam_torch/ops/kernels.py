"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled at first use with ``nvcc`` into a shared library
with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``) and
loaded with ``ctypes``.  The library name carries a hash of the sources,
so an edited kernel is rebuilt.  Nothing here runs at import time.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream, raises
on a launch error, and adds one to its entry of :data:`launch_counts`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("blend.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SMEM_BUDGET = 46 * 1024   # dynamic shared memory per block, under the 48 KB default

# kernel launches since the last reset (one per launch, nowhere else)
launch_counts = {"blend_fwd": 0, "blend_bwd": 0}

_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libhierslam_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library for these sources is missing.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills) and
    prints the compiler's output.  Returns the library path."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *[os.path.join(CSRC, s) for s in SOURCES]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if verbose or res.returncode != 0:
        print(res.stdout + res.stderr, flush=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}")
    os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.blend_fwd.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]
        lib.blend_fwd.restype = _I
        lib.blend_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _P, _P]
        lib.blend_bwd.restype = _I
        lib.blend_max_features.argtypes = []
        lib.blend_max_features.restype = _I
        _lib = lib
    return _lib


def _check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _tile_args(table: torch.Tensor, tile_shape):
    if table.device.type != "cuda":
        raise ValueError("the CUDA blend kernels take CUDA tensors only")
    th, tw = tile_shape
    P = th * tw
    if P % 32 or P > 1024:
        raise ValueError(f"tile of {P} pixels: need a multiple of 32, at most 1024")
    T, K, C = table.shape
    if C < 7 or C - 7 > _load().blend_max_features():
        raise ValueError(f"table width {C}: need 7 + F columns, F <= "
                         f"{_load().blend_max_features()}")
    return T, K, C, th, tw, P


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def blend_fwd(table: torch.Tensor, ok: torch.Tensor, grid_x: int, tile_shape):
    """K1.  table [T, K, 7+F] f32, ok [T, K] bool -> (acc [T, P, F+2],
    final_T [T, P], median [T, P], last committed slot [T, P] int32,
    median slot [T, P] int32, -1 where T never crosses 0.5)."""
    T, K, C, th, tw, P = _tile_args(table, tile_shape)
    dev = table.device
    _check("table", table, torch.float32, (T, K, C), dev)
    _check("ok", ok, torch.bool, (T, K), dev)
    F = C - 7
    acc = torch.empty((T, P, F + 2), dtype=torch.float32, device=dev)
    ft = torch.empty((T, P), dtype=torch.float32, device=dev)
    med = torch.empty((T, P), dtype=torch.float32, device=dev)
    last = torch.empty((T, P), dtype=torch.int32, device=dev)
    mslot = torch.empty((T, P), dtype=torch.int32, device=dev)
    if T == 0:
        return acc, ft, med, last, mslot
    nb = min(256, SMEM_BUDGET // (C * 4 + 1))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _load().blend_fwd(
        table.data_ptr(), ok.data_ptr(), T, K, C, grid_x, th, tw, nb,
        acc.data_ptr(), ft.data_ptr(), med.data_ptr(), last.data_ptr(), mslot.data_ptr(),
        stream,
    )
    _raise_on(err, "blend_fwd")
    launch_counts["blend_fwd"] += 1
    return acc, ft, med, last, mslot


def blend_bwd(table, ok, ft, last, mslot, gacc, gft, gmed, grid_x: int, tile_shape):
    """K2.  Residuals (final_T, last, mslot) from :func:`blend_fwd`, cotangents
    gacc [T, P, F+2], gft / gmed [T, P] -> d table [T, K, 7+F]."""
    T, K, C, th, tw, P = _tile_args(table, tile_shape)
    dev = table.device
    F = C - 7
    _check("table", table, torch.float32, (T, K, C), dev)
    _check("ok", ok, torch.bool, (T, K), dev)
    _check("ft", ft, torch.float32, (T, P), dev)
    _check("last", last, torch.int32, (T, P), dev)
    _check("mslot", mslot, torch.int32, (T, P), dev)
    _check("gacc", gacc, torch.float32, (T, P, F + 2), dev)
    _check("gft", gft, torch.float32, (T, P), dev)
    _check("gmed", gmed, torch.float32, (T, P), dev)
    dtab = torch.empty((T, K, C), dtype=torch.float32, device=dev)
    if T == 0:
        return dtab
    sb = min(32, (SMEM_BUDGET - 64) // ((P // 32 + 1) * C * 4 + 1))
    if sb < 1:
        raise ValueError(f"table width {C} leaves no room for the reduction")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _load().blend_bwd(
        table.data_ptr(), ok.data_ptr(), ft.data_ptr(), last.data_ptr(), mslot.data_ptr(),
        gacc.data_ptr(), gft.data_ptr(), gmed.data_ptr(), T, K, C, grid_x, th,
        tw, sb, dtab.data_ptr(), stream,
    )
    _raise_on(err, "blend_bwd")
    launch_counts["blend_bwd"] += 1
    return dtab
