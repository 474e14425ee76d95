"""Rank meshes over ``torch.distributed`` (port of ``hierslam_tpu/parallel/mesh.py``).

The JAX package runs its multi-device steps as one program over a 1-D
device mesh.  Here one controller process, the caller, holds rank 0, and
``n - 1`` worker processes, started with the ``spawn`` context, hold
ranks 1..n-1.  :meth:`Mesh.run` sends a function (by import path) and its
small static arguments to every worker over a pipe, broadcasts its tensor
arguments from rank 0 in one buffer, and runs the function on every rank;
the controller returns its own rank's result.  Only the steps that the
JAX package runs over a mesh run here: a SLAM run keeps tracking on the
controller, so that the ranks never hold maps that rounded apart.

Every wait is bounded by the mesh's ``timeout``: the process group's
set-up, each collective (polled, so that a worker that raises or dies
makes the controller raise at once), each worker's reply and each join at
:meth:`Mesh.close`.  Collectives are ``broadcast`` and ``all_reduce``
only, the two that ``gloo`` offers on CUDA tensors.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import shutil
import tempfile
import time
import traceback
from typing import Dict, List, NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist

from hierslam_torch import resolve_device

DEFAULT_TIMEOUT_S = 300.0
POLL_S = 5e-4            # between polls of a pending collective or reply
ALIGN = 16               # byte alignment of each tensor in a broadcast buffer
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class MeshError(RuntimeError):
    """A rank raised, died or did not answer within the mesh's timeout."""


class _Leaf(NamedTuple):
    """A tensor's place in a broadcast buffer."""

    dtype: torch.dtype
    shape: tuple
    offset: int
    nbytes: int


class _Slot(NamedTuple):
    """A tensor's place in a flattened tree."""

    index: int


def _flatten(tree, leaves: list):
    """``tree`` with each tensor replaced by its :class:`_Slot` in
    ``leaves`` (dicts, lists, tuples and named tuples are walked; anything
    else is kept as it is, to be pickled)."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _Slot(len(leaves) - 1)
    if isinstance(tree, dict):
        return {k: _flatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_flatten(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    return tree


def _unflatten(skel, leaf_fn):
    if isinstance(skel, _Slot):
        return leaf_fn(skel.index)
    if isinstance(skel, dict):
        return {k: _unflatten(v, leaf_fn) for k, v in skel.items()}
    if isinstance(skel, tuple) and hasattr(skel, "_fields"):
        return type(skel)(*(_unflatten(v, leaf_fn) for v in skel))
    if isinstance(skel, (list, tuple)):
        return type(skel)(_unflatten(v, leaf_fn) for v in skel)
    return skel


def tensors_of(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in walk order."""
    leaves: list = []
    _flatten(tree, leaves)
    return leaves


class Rank:
    """What a function run on a mesh sees: its ``rank``, the mesh ``size``,
    its ``device`` and the collectives, each bounded by ``timeout``.
    ``stats`` is a dict the function may leave numbers in (the
    controller's is :attr:`Mesh.stats`); ``stats["collective_s"]`` adds up
    the seconds this rank waits in collectives, the other ranks' work
    included."""

    def __init__(self, rank: int, size: int, device: torch.device, timeout: float, watch):
        self.rank, self.size, self.device, self.timeout = rank, size, device, timeout
        self._watch = watch
        self.stats: Dict = {"collective_s": 0.0}

    def _wait(self, work, what: str) -> None:
        t0 = time.monotonic()
        while not work.is_completed():
            self._watch()
            if time.monotonic() - t0 > self.timeout:
                raise MeshError(f"rank {self.rank}: {what} timed out after {self.timeout} s")
            time.sleep(POLL_S)
        work.wait()
        self.stats["collective_s"] += time.monotonic() - t0

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place ``all_reduce`` of ``x`` (``op`` "sum" or "max")."""
        self._wait(dist.all_reduce(x, op=_OPS[op], async_op=True), f"all_reduce({op})")
        return x

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """In-place ``broadcast`` of ``x`` from rank 0."""
        self._wait(dist.broadcast(x, src=0, async_op=True), "broadcast")
        return x

    def mean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the ranks of each float32 tensor, in one
        ``all_reduce``: the sum divided by ``size``."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce(flat, "sum")
        flat = flat / self.size
        out, off = [], 0
        for t in tensors:
            out.append(flat[off:off + t.numel()].reshape(t.shape))
            off += t.numel()
        return out


def _layout(tensors: List[torch.Tensor]):
    """Each tensor's leaf with its offset and size in the buffer, and the
    buffer's size."""
    out, total = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        out.append(_Leaf(t.dtype, tuple(t.shape), total, nbytes))
        total += -(-nbytes // ALIGN) * ALIGN
    return out, total


def _receive(rk: Rank, skel, layout: List[_Leaf], total: int):
    buf = rk.broadcast(torch.empty(total, dtype=torch.uint8, device=rk.device))

    def leaf(i: int):
        lf = layout[i]
        raw = buf[lf.offset:lf.offset + lf.nbytes]
        return raw.view(lf.dtype).reshape(lf.shape).clone()

    return _unflatten(skel, leaf)


def _parent_watch() -> None:
    parent = multiprocessing.parent_process()
    if parent is not None and not parent.is_alive():
        raise MeshError("the controller process is gone")


def _worker_main(rank: int, size: int, init_method: str, device: str, backend: str,
                 timeout: float, n_threads: int, conn) -> None:
    """A worker rank: set up, then run what the controller sends until it
    says close (or is gone).  The first failure is sent back and ends the
    worker."""
    try:
        torch.set_num_threads(n_threads)
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        conn.send(("ready", None))
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=size,
                                timeout=datetime.timedelta(seconds=timeout))
        rk = Rank(rank, size, dev, timeout, _parent_watch)
        while True:
            while not conn.poll(1.0):
                _parent_watch()
            msg = conn.recv()
            if msg[0] == "close":
                break
            if msg[0] == "run":
                _, fn, static, skel, layout, total = msg
                fn(rk, static, _receive(rk, skel, layout, total))
                conn.send(("ok", None))
            else:
                _, fn, args = msg
                conn.send(("ok", fn(*args)))
    except Exception:
        try:
            conn.send(("error", f"rank {rank} ({device}):\n{traceback.format_exc()}"))
        except OSError:
            pass
        return
    dist.destroy_process_group()


class Mesh:
    """``n`` ranks over ``torch.distributed``: rank 0 is this process,
    ranks 1..n-1 worker processes (see the module docstring).  ``shape``
    is ``{axis: n}`` as a JAX mesh's.  Close it with :meth:`close` or use
    it as a context manager: no worker outlives it."""

    def __init__(self, devices: List[torch.device], axis: str, backend: str, timeout: float):
        if dist.is_initialized():
            raise RuntimeError("a process group is already set up in this process: close "
                               "its mesh first")
        n = len(devices)
        self.devices, self.backend, self.timeout = devices, backend, timeout
        self.shape = {axis: n}
        self.device = devices[0]
        self.stats: Dict = {}
        self._closed = False
        self._procs, self._conns = [], []
        self._replies: List[list] = [[] for _ in range(n)]
        self._dir = tempfile.mkdtemp(prefix="hierslam_mesh_")
        init = "file://" + os.path.join(self._dir, "rendezvous")
        print(f"[mesh] {n} ranks on {[str(d) for d in devices]}: backend {backend}", flush=True)
        ctx = multiprocessing.get_context("spawn")
        try:
            for r in range(1, n):
                here, there = ctx.Pipe()
                p = ctx.Process(target=_worker_main, name=f"hierslam-mesh-rank{r}", daemon=True,
                                args=(r, n, init, str(devices[r]), backend, timeout,
                                      torch.get_num_threads(), there))
                p.start()
                there.close()
                self._procs.append(p)
                self._conns.append(here)
            for r in range(1, n):
                self._reply(r, "start")
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            dist.init_process_group(backend, init_method=init, rank=0, world_size=n,
                                    timeout=datetime.timedelta(seconds=timeout))
        except BaseException:
            self.close(kill=True)
            raise
        self._rank = Rank(0, n, self.device, timeout, self._watch)
        self.stats = self._rank.stats

    @property
    def size(self) -> int:
        return len(self.devices)

    def _watch(self) -> None:
        """Raise if a worker has reported a failure or is gone; keep its
        other replies."""
        for r, (conn, p) in enumerate(zip(self._conns, self._procs), 1):
            try:
                while conn.poll():
                    kind, value = conn.recv()
                    if kind == "error":
                        raise MeshError(value)
                    self._replies[r].append(value)
            except (EOFError, OSError):
                p.join(1.0)
                raise MeshError(f"rank {r} is gone (exit code {p.exitcode})") from None
            if p.exitcode is not None:
                raise MeshError(f"rank {r} exited with code {p.exitcode}")

    def _reply(self, r: int, what: str):
        deadline = time.monotonic() + self.timeout
        while not self._replies[r]:
            self._watch()
            if time.monotonic() > deadline:
                raise MeshError(f"rank {r}: no reply to {what} within {self.timeout} s")
            self._conns[r - 1].poll(POLL_S)
        return self._replies[r].pop(0)

    def _send(self, msg) -> None:
        if self._closed:
            raise MeshError("the mesh is closed")
        for r, conn in enumerate(self._conns, 1):
            try:
                conn.send(msg)
            except OSError:
                self._watch()
                raise MeshError(f"rank {r} is gone") from None

    def run(self, fn, static, tensors):
        """Run ``fn(rank, static, tensors)`` on every rank and return rank
        0's result.  ``fn`` is a module-level function, ``static`` small
        picklable values, ``tensors`` a tree of dicts, lists and tuples of
        tensors: broadcast from this process in one buffer (its size and
        time are left in ``stats["broadcast_bytes"]`` and
        ``stats["broadcast_s"]``; ``stats["collective_s"]`` counts the
        broadcast and ``fn``'s collectives).  Any rank's failure closes the mesh and
        raises :class:`MeshError` here."""
        leaves: list = []
        skel = _flatten(tensors, leaves)
        leaves = [t.detach().to(self.device) for t in leaves]
        layout, total = _layout(leaves)
        try:
            self._send(("run", fn, static, skel, layout, total))
            self.stats["collective_s"] = 0.0
            t0 = time.perf_counter()
            buf = torch.empty(total, dtype=torch.uint8, device=self.device)
            for t, lf in zip(leaves, layout):
                if lf.nbytes:
                    buf[lf.offset:lf.offset + lf.nbytes] = t.reshape(-1).view(torch.uint8)
            self._rank.broadcast(buf)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stats.update(broadcast_bytes=total, broadcast_s=time.perf_counter() - t0)
            del buf
            out = fn(self._rank, static, _unflatten(skel, leaves.__getitem__))
            for r in range(1, self.size):
                self._reply(r, fn.__name__)
        except BaseException:
            self.close(kill=True)
            raise
        return out

    def run_workers(self, fn, *args) -> list:
        """``fn(*args)`` on each worker (no collectives), for inspection:
        their results, ranks 1..n-1 in order."""
        try:
            self._send(("call", fn, args))
            return [self._reply(r, fn.__name__) for r in range(1, self.size)]
        except BaseException:
            self.close(kill=True)
            raise

    def close(self, kill: bool = False) -> None:
        """Stop the workers (``kill``: at once) and tear the group down."""
        if self._closed:
            return
        self._closed = True
        if not kill:
            for conn in self._conns:
                try:
                    conn.send(("close",))
                except OSError:
                    pass
        for p in self._procs:
            p.join(0 if kill else self.timeout)
            if p.is_alive():
                p.kill()
                p.join(self.timeout)
        for conn in self._conns:
            conn.close()
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self._dir, ignore_errors=True)

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(kill=exc[0] is not None)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", *,
              devices: Union[None, str, torch.device, Sequence] = None,
              backend: Optional[str] = None, timeout: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """A mesh of ``n_devices`` ranks (default: one per visible GPU).

    Rank r runs on ``cuda:r``; fewer visible GPUs than ``n_devices`` raise
    ``ValueError``, as the JAX package's ``make_mesh`` does.  ``devices``
    places the ranks instead: one device for all (``"cpu"``, or
    ``"cuda:0"`` to run several ranks on one card) or one per rank.
    ``backend`` defaults to ``nccl`` when every rank has a GPU of its own,
    else ``gloo``."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = n_devices or have
        if n > have or n < 1:
            raise ValueError(f"requested {n} devices, have {have}")
        devs = [torch.device("cuda", r) for r in range(n)]
    elif isinstance(devices, (str, torch.device)):
        n = n_devices or 1
        devs = [torch.device(devices)] * n
    else:
        devs = [torch.device(d) for d in devices]
        n = n_devices or len(devs)
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices given for {n} ranks")
    devs = [resolve_device(d) for d in devs]
    if backend is None:
        own_gpus = all(d.type == "cuda" for d in devs) and len(set(devs)) == n
        backend = "nccl" if own_gpus else "gloo"
    return Mesh(devs, axis, backend, timeout)
