"""Per-tile row gathers (port of ``hierslam_tpu/ops/gather_vjp.py``).

The gather's backward is a segmented sum over the binning's *inverse
map*: the flat (tile, slot) positions stably sorted by the row they
reference, and the end of each row's run in that order.  Each row's
gradient is its run's cotangent rows summed from 0 in ascending position
order, with no atomics, so a run on the GPU repeats itself to the bit and
equals the CPU's.  On a CUDA tensor the sum is kernel K5
(``csrc/gather.cu``, via ``ops/kernels.py``), on a CPU tensor its plain
version :func:`gather_bwd_plain` (``index_add_`` over the sorted run
positions, which adds in index order).  The map is built once per
binning, with integer ops only.

Only the first ``n_diff`` columns carry gradient, a ``pair_budget`` routes
only the first ``budget`` references in row order (pads sort last; the
overflow is counted by the caller as ``n_grad_dropped``), and
``grad_bf16`` rounds the cotangent to bfloat16 before the float32 sum.
Left out of the TPU version: the sort-merge in place of ``searchsorted``
(``rank_probes``), the bit-plane run masks of the doubling passes, and the
128-lane padding of the gather tables.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hierslam_torch.ops import kernels

# calls of the plain version (a main-path run on the card keeps it at 0)
plain_counts = {"gather_bwd_plain": 0}


class InverseMap(NamedTuple):
    spos: torch.Tensor   # [M] int32 flat (tile, slot) positions, stably sorted by row
    ends: torch.Tensor   # [N] int32 end of each row's run (row g's starts at ends[g - 1])


@torch.no_grad()
def build_inverse_map(tile_idx: torch.Tensor, num_rows: int,
                      num_real: Optional[int] = None) -> InverseMap:
    """Invert the per-tile row lists ``tile_idx`` (any shape, -1 padded)
    into ``num_rows`` runs.  Ids ``>= num_real`` (default ``num_rows``: the
    stream's sentinel row) are keyed with the pads, past every row: they
    sort last and get no run."""
    flat = tile_idx.reshape(-1).long()
    real = num_rows if num_real is None else num_real
    key = torch.where((flat >= 0) & (flat < real), flat, torch.full_like(flat, num_rows))
    skey, spos = torch.sort(key, stable=True)
    rows = torch.arange(num_rows, dtype=skey.dtype, device=skey.device)
    ends = torch.searchsorted(skey, rows, right=True)
    return InverseMap(spos=spos.to(torch.int32), ends=ends.to(torch.int32))


def gather_bwd_plain(cot: torch.Tensor, spos: torch.Tensor, ends: torch.Tensor, n_diff: int,
                     grad_bf16: bool) -> torch.Tensor:
    """Plain version of K5: ``grad [N, C]`` with row g the sum over its run
    (``spos[starts[g]:min(ends[g], len(spos))]``) of the cotangent rows
    ``cot [M, C]`` in their first ``n_diff`` columns, each rounded to
    bfloat16 first with ``grad_bf16``; 0 elsewhere."""
    plain_counts["gather_bwd_plain"] += 1
    n, c = ends.shape[0], cot.shape[1]
    e = ends.long().clamp_max(spos.shape[0])
    n_ref = e - torch.cat([e.new_zeros(1), e[:-1]])
    rows = torch.repeat_interleave(torch.arange(n, device=cot.device), n_ref)
    g = cot[spos[:rows.shape[0]].long(), :n_diff]
    if grad_bf16:
        g = g.to(torch.bfloat16).float()
    grad = torch.zeros((n, c), dtype=cot.dtype, device=cot.device)
    grad[:, :n_diff].index_add_(0, rows, g)
    return grad


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, arr, tile_idx, inverse, n_diff, pair_budget, grad_bf16):
        ctx.tile_idx, ctx.inverse = tile_idx, inverse
        ctx.meta = (arr.shape[0], arr.shape[1], n_diff, pair_budget, grad_bf16)
        flat = tile_idx.reshape(-1)
        return arr[flat.clamp_min(0)].reshape(tuple(tile_idx.shape) + (arr.shape[1],))

    @staticmethod
    def backward(ctx, g):
        n, c, n_diff, pair_budget, grad_bf16 = ctx.meta
        inv = ctx.inverse
        if inv is None:   # built on the first backward: a render without one needs none
            inv = build_inverse_map(ctx.tile_idx, n)
        spos = inv.spos
        nd = c if n_diff == 0 else min(n_diff, c)
        if pair_budget and pair_budget < spos.shape[0]:
            # references occupy a prefix of the row-sorted order
            spos = spos[:pair_budget]
        cot = g.reshape(-1, c).contiguous()
        if cot.is_cuda:
            grad = kernels.gather_bwd(cot, spos, inv.ends, nd, grad_bf16)
        else:
            grad = gather_bwd_plain(cot, spos, inv.ends, nd, grad_bf16)
        return grad, None, None, None, None, None


def gather_rows(arr: torch.Tensor, tile_idx: torch.Tensor, n_diff: int = 0,
                pair_budget: int = 0, grad_bf16: bool = False,
                inverse: Optional[InverseMap] = None) -> torch.Tensor:
    """``arr[max(tile_idx, 0)]`` -> ``tile_idx.shape + [C]``; padded slots
    (-1) gather row 0 and route no gradient.  ``inverse`` is the map of
    ``tile_idx`` over ``arr``'s rows (:func:`build_inverse_map`); when None,
    the backward builds it."""
    if inverse is not None and (inverse.ends.shape[0] != arr.shape[0]
                                or inverse.spos.shape[0] != tile_idx.numel()):
        raise ValueError(f"inverse map of {inverse.ends.shape[0]} rows and "
                         f"{inverse.spos.shape[0]} positions for a gather of "
                         f"{tile_idx.numel()} positions from {arr.shape[0]} rows")
    return _GatherRows.apply(arr, tile_idx, inverse, n_diff, pair_budget, grad_bf16)


class _CompactRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, arr, vis, rank_of):
        ctx.save_for_backward(rank_of)
        return arr.index_select(0, vis)

    @staticmethod
    def backward(ctx, g):
        (rank_of,) = ctx.saved_tensors
        v = g.shape[0]
        g_pad = torch.cat([g, g.new_zeros((1,) + tuple(g.shape[1:]))])
        return g_pad[rank_of.clamp_max(v)], None, None


def compact_rows(arr: torch.Tensor, vis: torch.Tensor, rank_of: torch.Tensor) -> torch.Tensor:
    """``arr[vis]`` -- compact rows to the visible-rank prefix.  ``rank_of``
    ([N], ``rank_of[vis[r]] == r``, ``>= V`` outside the prefix) makes the
    backward one gather of the zero-padded cotangent."""
    return _CompactRows.apply(arr, vis, rank_of)
