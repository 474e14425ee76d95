"""Per-tile row gathers (port of the semantics of ``hierslam_tpu/ops/gather_vjp.py``).

The JAX package routes the gather's cotangent through a scatter-free
inverse map, because scatters are slow on a TPU.  On the GPU the backward
is one ``index_add_``.  What stays is what the inverse map guarded: only
the first ``n_diff`` columns carry gradient, a ``pair_budget`` routes only
the first ``budget`` references in gaussian-id order (the overflow is
counted by the caller as ``n_grad_dropped``), and ``grad_bf16`` rounds
the cotangent to bfloat16 before the float32 sum.
"""
from __future__ import annotations

import torch


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, arr, tile_idx, n_diff, pair_budget, grad_bf16):
        flat = tile_idx.reshape(-1)
        ctx.save_for_backward(flat)
        ctx.meta = (arr.shape, n_diff, pair_budget, grad_bf16)
        return arr[flat.clamp_min(0)].reshape(tuple(tile_idx.shape) + (arr.shape[1],))

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        shape, n_diff, pair_budget, grad_bf16 = ctx.meta
        n, c = shape
        nd = c if n_diff == 0 else min(n_diff, c)
        g = g.reshape(-1, c)[:, :nd]
        if grad_bf16:
            g = g.to(torch.bfloat16).float()
        valid = flat >= 0
        if pair_budget and pair_budget < flat.shape[0]:
            # the first `pair_budget` references in gaussian-id order (pad
            # slots sort last, as in the JAX inverse map)
            key = torch.where(valid, flat, torch.full_like(flat, n))
            pos = torch.sort(key, stable=True).indices[:pair_budget]
            flat, valid, g = flat[pos], valid[pos], g[pos]
        grad = torch.zeros((n, c), dtype=g.dtype, device=g.device)
        grad[:, :nd].index_add_(0, flat.clamp_min(0), g * valid[:, None])
        return grad, None, None, None, None


def gather_rows(arr: torch.Tensor, tile_idx: torch.Tensor, n_diff: int = 0,
                pair_budget: int = 0, grad_bf16: bool = False) -> torch.Tensor:
    """``arr[max(tile_idx, 0)]`` -> ``tile_idx.shape + [C]``; padded slots
    (-1) gather row 0 and route no gradient."""
    return _GatherRows.apply(arr, tile_idx, n_diff, pair_budget, grad_bf16)


def compact_rows(arr: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """``arr[vis]`` — compact rows to the visible-rank prefix (the backward
    is the index_select VJP)."""
    return arr.index_select(0, vis)

