"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each source is compiled at first use with ``nvcc`` into a shared library
of its own with a plain C interface (``-gencode arch=compute_90a,code=
sm_90a``), all sources at once in parallel, and loaded with ``ctypes``.
A library's name carries a hash of its source, of every header in
``csrc/`` and of its flags, so an edited kernel or header is rebuilt.
ptxas's report (registers, shared memory, spill bytes of every kernel) is
kept beside each library (:func:`ptxas_report`).  Nothing here runs at
import time.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs (K1 also writes into buffers its caller passes), launches on
PyTorch's current stream, raises on a launch error, and adds one to its
entry of :data:`launch_counts`.  The kernels take 0 to 128 features
(``csrc/fwd.cuh`` MAX_FEATURES); a wrapper raises above that, and a launch
whose block would need more shared memory than its budget or the card's
grant returns an error before it starts, on which the wrapper raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# source -> extra flags.  stream.cu keeps multiplies and adds apart so that
# its discrete decisions round as the plain PyTorch version does (see there).
SOURCES = {"blend.cu": (), "stream.cu": ("-fmad=false",), "gather.cu": ()}
SMEM_BUDGET = 46 * 1024   # K2's dynamic shared memory per block, under the 48 KB default
# K4's budget is above 48 KB (the launch asks for it): its shared copies of
# the projection terms and the float4 features take 52 KB at F = 29 before
# any batch, and 3 blocks of 64 KB still fit an SM's 228 KB.  Past that (the
# wide bucket, which runs one block an SM) the batch takes no more than the
# block needs at a batch of 1: its buffer then lies in the dead raw row.
# K1 and K3 size their own buffers (csrc/blend.cu, csrc/stream.cu).
K4_SMEM_BUDGET = 64 * 1024
RW = 128                  # pairs per stream row
TILE_THREADS = 256        # most pixels a tile the kernels take (their launch bounds)

# kernel launches since the last reset (one per launch, nowhere else)
launch_counts = {"blend_fwd": 0, "blend_bwd": 0, "stream_fwd": 0, "stream_bwd": 0,
                 "gather_bwd": 0}

_libs: Dict[str, ctypes.CDLL] = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


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


def library_path(source: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    h.update(" ".join(NVCC_FLAGS + SOURCES[source]).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"libhierslam_{stem}_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> Dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together, and keep each build's compiler output (ptxas's
    report) beside its library.  ``verbose`` prints that output.  Returns
    the library path of each source."""
    paths = {src: library_path(src) for src in SOURCES}
    todo = {src: p for src, p in paths.items() if not os.path.isfile(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src, path in todo.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *SOURCES[src], "-o", tmp, os.path.join(CSRC, src)]
        procs[src] = (cmd, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (cmd, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if verbose or proc.returncode != 0:
            print(f"[nvcc {src}]\n{out}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode}): {' '.join(cmd)}")
        else:
            # the report first: a library on disk always has one
            with open(f"{tmp}.log", "w") as f:
                f.write(out)
            os.replace(f"{tmp}.log", f"{todo[src]}.log")
            os.replace(tmp, todo[src])
    if failed:
        raise RuntimeError("nvcc failed: " + "; ".join(failed))
    return paths


def ptxas_report(source: str) -> str:
    """nvcc's output (``-Xptxas -v``) of the build of ``source``'s current
    library; "" where that library is not built."""
    path = f"{library_path(source)}.log"
    if not os.path.isfile(path):
        return ""
    with open(path) as f:
        return f.read()


def _load(source: str) -> ctypes.CDLL:
    if source not in _libs:
        lib = ctypes.CDLL(build()[source])
        if source == "blend.cu":
            lib.blend_fwd.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                                      _P, _P]
            lib.blend_bwd.argtypes = [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _I, _P, _P]
            lib.blend_max_features.argtypes = []
            lib.blend_fwd_smem.argtypes = [_I, _I]
            lib.blend_bwd_smem.argtypes = [_I, _I, _I]
            for fn in (lib.blend_fwd, lib.blend_bwd, lib.blend_max_features,
                       lib.blend_fwd_smem, lib.blend_bwd_smem):
                fn.restype = _I
        elif source == "gather.cu":
            lib.gather_bwd.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
            lib.gather_max_cols.argtypes = []
            for fn in (lib.gather_bwd, lib.gather_max_cols):
                fn.restype = _I
        else:
            lib.stream_fwd.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P, _P,
                                       _P, _P, _P]
            lib.stream_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _I, _F, _F, _I, _P, _P]
            lib.stream_max_features.argtypes = []
            lib.stream_fwd_smem.argtypes = [_I]
            lib.stream_bwd_smem.argtypes = [_I, _I, _I]
            for fn in (lib.stream_fwd, lib.stream_bwd, lib.stream_max_features,
                       lib.stream_fwd_smem, lib.stream_bwd_smem):
                fn.restype = _I
        _libs[source] = lib
    return _libs[source]


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
    if tw % 8 or th % 4 or P > TILE_THREADS:
        raise ValueError(f"tile {th} x {tw}: need a multiple of 4 x 8 pixels (the forwards' "
                         f"warps are 8 x 4 pixel blocks), at most {TILE_THREADS} pixels")
    T, K, C = table.shape
    max_f = _load("blend.cu").blend_max_features()
    if C < 7 or C - 7 > max_f:
        raise ValueError(f"table width {C}: need 7 + F columns, F <= {max_f} (the kernels' "
                         "widest feature bucket)")
    return T, K, C, th, tw, P


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _tile_ids_arg(tile_ids: Optional[torch.Tensor], T: int, dev) -> int:
    """The pointer the kernels take for ``tile_ids`` (0: row b is tile b)."""
    if tile_ids is None:
        return 0
    _check("tile_ids", tile_ids, torch.int32, (T,), dev)
    return tile_ids.data_ptr()


def blend_fwd(table: torch.Tensor, ok: torch.Tensor, grid_x: int, tile_shape,
              tile_ids: Optional[torch.Tensor] = None, out=None, n_tiles: Optional[int] = None):
    """K1.  table [T, K, 7+F] f32, ok [T, K] bool -> (acc [T_all, P, F+2],
    final_T [T_all, P], median [T_all, P], last committed slot [T_all, P]
    int32, median slot [T_all, P] int32, -1 where T never crosses 0.5).

    Row b of the table is tile ``tile_ids[b]`` ([T] int32; tile b where
    None) of a grid ``grid_x`` tiles wide, blended at its true pixels, and
    its outputs are row ``tile_ids[b]`` of ``out`` (the five buffers above,
    shared by the capacity classes of one render), or of new buffers of
    ``n_tiles`` rows (default T).  Rows no tile id names are left as they
    were; a tile id outside the rows writes nothing (the kernel checks)."""
    T, K, C, th, tw, P = _tile_args(table, tile_shape)
    dev = table.device
    _check("table", table, torch.float32, (T, K, C), dev)
    _check("ok", ok, torch.bool, (T, K), dev)
    ids = _tile_ids_arg(tile_ids, T, dev)
    F = C - 7
    if out is None:
        rows = T if n_tiles is None else n_tiles
        out = (torch.empty((rows, P, F + 2), dtype=torch.float32, device=dev),
               *(torch.empty((rows, P), dtype=dt, device=dev)
                 for dt in (torch.float32, torch.float32, torch.int32, torch.int32)))
    acc, ft, med, last, mslot = out
    rows = acc.shape[0]
    if tile_ids is None and rows < T:
        raise ValueError(f"{T} tiles into buffers of {rows} rows")
    _check("acc", acc, torch.float32, (rows, P, F + 2), dev)
    for name, x, dt in (("ft", ft, torch.float32), ("med", med, torch.float32),
                        ("last", last, torch.int32), ("mslot", mslot, torch.int32)):
        _check(name, x, dt, (rows, P), dev)
    if T == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _load("blend.cu").blend_fwd(
        table.data_ptr(), ok.data_ptr(), ids, rows, T, K, C, grid_x, th, tw,
        acc.data_ptr(), ft.data_ptr(), med.data_ptr(), last.data_ptr(), mslot.data_ptr(),
        stream,
    )
    _raise_on(err, "blend_fwd")
    launch_counts["blend_fwd"] += 1
    return out


def blend_bwd(table, ok, ft, last, mslot, gacc, gft, gmed, grid_x: int, tile_shape,
              tile_ids: Optional[torch.Tensor] = None):
    """K2.  Residuals (final_T, last, mslot) from :func:`blend_fwd` and
    cotangents gacc [T_all, P, F+2], gft / gmed [T_all, P], read at row
    ``tile_ids[b]`` (b where None) for row b of the table -> d table
    [T, K, 7+F], 0 on a row whose tile id lies outside those rows."""
    T, K, C, th, tw, P = _tile_args(table, tile_shape)
    dev = table.device
    F = C - 7
    _check("table", table, torch.float32, (T, K, C), dev)
    _check("ok", ok, torch.bool, (T, K), dev)
    ids = _tile_ids_arg(tile_ids, T, dev)
    rows = ft.shape[0] if tile_ids is not None else T
    _check("ft", ft, torch.float32, (rows, P), dev)
    _check("last", last, torch.int32, (rows, P), dev)
    _check("mslot", mslot, torch.int32, (rows, P), dev)
    _check("gacc", gacc, torch.float32, (rows, P, F + 2), dev)
    _check("gft", gft, torch.float32, (rows, P), dev)
    _check("gmed", gmed, torch.float32, (rows, P), dev)
    dtab = torch.empty((T, K, C), dtype=torch.float32, device=dev)
    if T == 0:
        return dtab
    sb, _ = bwd_batch("blend.cu", C, P)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _load("blend.cu").blend_bwd(
        table.data_ptr(), ok.data_ptr(), ids, rows, ft.data_ptr(), last.data_ptr(),
        mslot.data_ptr(), gacc.data_ptr(), gft.data_ptr(), gmed.data_ptr(), T, K, C, grid_x, th,
        tw, sb, dtab.data_ptr(), stream,
    )
    _raise_on(err, "blend_bwd")
    launch_counts["blend_bwd"] += 1
    return dtab


def bwd_batch(source: str, C: int, P: int):
    """The batch of K2's slots (``blend.cu``) or K4's pairs (``stream.cu``)
    summed between two passes over the warps, at most 32 and as many as
    :data:`SMEM_BUDGET` (K2) or K4's budget allow at table width C and P
    pixels a tile, and the block's dynamic shared memory in bytes.  K4's
    budget is the larger of :data:`K4_SMEM_BUDGET` and what the block
    needs at a batch of 1."""
    lib = _load(source)
    if source == "blend.cu":
        budget, smem_of = SMEM_BUDGET, lib.blend_bwd_smem
    else:
        smem_of = lib.stream_bwd_smem
        budget = max(K4_SMEM_BUDGET, smem_of(C, P, 1))
    sb = 32
    while sb > 1 and smem_of(C, P, sb) > budget:
        sb -= 1
    smem = smem_of(C, P, sb)
    if smem > budget:
        raise ValueError(f"table width {C} leaves no room for the reduction")
    return sb, smem


def _stream_args(stream: torch.Tensor, scalars: torch.Tensor, row_off: torch.Tensor,
                 n_feat: int, tile_shape):
    if stream.device.type != "cuda":
        raise ValueError("the CUDA stream kernels take CUDA tensors only")
    th, tw = tile_shape
    P = th * tw
    if tw % 8 or th % 4 or P < RW or P > TILE_THREADS:
        raise ValueError(f"tile {th} x {tw}: need a multiple of 4 x 8 pixels (the forwards' "
                         f"warps are 8 x 4 pixel blocks), {RW} to {TILE_THREADS} pixels")
    max_f = _load("stream.cu").stream_max_features()
    if not 0 <= n_feat <= max_f:
        raise ValueError(f"{n_feat} features: the stream kernels take at most {max_f} (their "
                         "widest feature bucket)")
    C = 5 + n_feat
    R = stream.shape[0]
    T = row_off.shape[0] - 1
    dev = stream.device
    _check("stream", stream, torch.float32, (R, RW, C), dev)
    _check("scalars", scalars, torch.float32, (28,), dev)
    _check("row_off", row_off, torch.int32, (T + 1,), dev)
    return T, R, C, th, tw, P


def stream_fwd(stream: torch.Tensor, scalars: torch.Tensor, row_off: torch.Tensor,
               grid_x: int, tile_shape, n_feat: int, img_shape):
    """K3.  stream [R, 128, 5+F] f32 (tile t owns rows row_off[t]..
    row_off[t+1]), scalars [28] f32 (``render_stream.make_scalars``),
    row_off [T+1] int32, img_shape (projection height, width) ->
    (acc [T, P, F+2], final_T [T, P], median [T, P], stream position of
    each pixel's last committed pair [T, P] int32, and of its median
    crossing, -1 where none)."""
    T, R, C, th, tw, P = _stream_args(stream, scalars, row_off, n_feat, tile_shape)
    dev = stream.device
    F = n_feat
    acc = torch.empty((T, P, F + 2), dtype=torch.float32, device=dev)
    ft = torch.empty((T, P), dtype=torch.float32, device=dev)
    med = torch.empty((T, P), dtype=torch.float32, device=dev)
    last = torch.empty((T, P), dtype=torch.int32, device=dev)
    mpos = torch.empty((T, P), dtype=torch.int32, device=dev)
    if T == 0:
        return acc, ft, med, last, mpos
    img_h, img_w = img_shape
    err = _load("stream.cu").stream_fwd(
        stream.data_ptr(), scalars.data_ptr(), row_off.data_ptr(), T, R, C, grid_x, th, tw,
        float(img_w), float(img_h), acc.data_ptr(), ft.data_ptr(), med.data_ptr(),
        last.data_ptr(), mpos.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "stream_fwd")
    launch_counts["stream_fwd"] += 1
    return acc, ft, med, last, mpos


def stream_bwd(stream, scalars, row_off, ft, last, mpos, gacc, gft, gmed, grid_x: int,
               tile_shape, n_feat: int, img_shape):
    """K4.  Residuals (final_T, last, mpos) from :func:`stream_fwd`,
    cotangents gacc [T, P, F+2], gft / gmed [T, P] -> d stream
    [R, 128, 5+F], exactly 0 on pad pairs and on rows no tile reads."""
    T, R, C, th, tw, P = _stream_args(stream, scalars, row_off, n_feat, tile_shape)
    dev = stream.device
    F = n_feat
    _check("ft", ft, torch.float32, (T, P), dev)
    _check("last", last, torch.int32, (T, P), dev)
    _check("mpos", mpos, torch.int32, (T, P), dev)
    _check("gacc", gacc, torch.float32, (T, P, F + 2), dev)
    _check("gft", gft, torch.float32, (T, P), dev)
    _check("gmed", gmed, torch.float32, (T, P), dev)
    dtab = torch.zeros((R, RW, C), dtype=torch.float32, device=dev)
    if T == 0 or R == 0:
        return dtab
    sb, _ = bwd_batch("stream.cu", C, P)
    img_h, img_w = img_shape
    err = _load("stream.cu").stream_bwd(
        stream.data_ptr(), scalars.data_ptr(), row_off.data_ptr(), ft.data_ptr(),
        last.data_ptr(), mpos.data_ptr(), gacc.data_ptr(), gft.data_ptr(), gmed.data_ptr(),
        T, R, C, grid_x, th, tw, float(img_w), float(img_h), sb, dtab.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "stream_bwd")
    launch_counts["stream_bwd"] += 1
    return dtab


def gather_bwd(cot: torch.Tensor, spos: torch.Tensor, ends: torch.Tensor, n_diff: int,
               grad_bf16: bool) -> torch.Tensor:
    """K5, the gather's backward as a segmented sum.  Cotangent rows
    cot [M, C] f32, the inverse map's positions spos [m] int32 (a prefix
    under a pair budget) and run ends ends [N] int32 -> grad [N, C], row g
    the sum from 0, in ascending position order, of rows
    ``spos[starts[g]:min(ends[g], m)]`` of ``cot`` in their first
    ``n_diff`` columns (each rounded to bfloat16 first with ``grad_bf16``),
    0 in the other columns."""
    if cot.device.type != "cuda":
        raise ValueError("the CUDA gather kernel takes CUDA tensors only")
    dev = cot.device
    M, C = cot.shape
    N, m = ends.shape[0], spos.shape[0]
    _check("cot", cot, torch.float32, (M, C), dev)
    _check("spos", spos, torch.int32, (m,), dev)
    _check("ends", ends, torch.int32, (N,), dev)
    lib = _load("gather.cu")
    if C > lib.gather_max_cols() or not 0 <= n_diff <= C:
        raise ValueError(f"{n_diff} summed columns of {C}: the kernel takes rows of at most "
                         f"{lib.gather_max_cols()} columns")
    if m > M:
        raise ValueError(f"{m} positions into {M} cotangent rows")
    grad = torch.empty((N, C), dtype=torch.float32, device=dev)
    if N == 0:
        return grad
    err = lib.gather_bwd(cot.data_ptr(), spos.data_ptr(), ends.data_ptr(), N, m, C, n_diff,
                         int(bool(grad_bf16)), grad.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "gather_bwd")
    launch_counts["gather_bwd"] += 1
    return grad
