"""The ladder blend with its closed-form backward (port of ``hierslam_tpu/ops/render_pallas.py``).

``blend_tiles_pallas`` is a ``torch.autograd.Function``.  On CUDA tensors
its forward launches kernel K1 and its backward kernel K2
(``csrc/blend.cu``, via ``ops/kernels.py``).  On CPU tensors the forward is
the plain blend (``ops/render_xla.blend_table``) and the backward
:func:`blend_bwd_plain`, a dense torch form of the same closed-form
suffix sums as the TPU kernel ``_bwd_kernel``:

    dL/da_i = c_i [ s_i Tb_i - (S_i + gT T_final) / (1 - a_i) ]

with ``s_i = gacc . f_i`` and ``S_i`` the sum of ``s_j w_j`` over j > i,
then the chain rule to opacity (0 where alpha clamps at 0.99), conic,
screen mean, depth (blend term plus the median-crossing term) and
features.  A CUDA tensor never takes the plain path.
"""
from __future__ import annotations

from typing import Tuple

import torch

from hierslam_torch.ops import kernels, render_xla
from hierslam_torch.ops.render_xla import ALPHA_MAX, blend_terms, pixel_grid, tile_chunks

# calls of the plain versions (a main-path run on the card keeps both at 0)
plain_counts = {"blend_fwd_plain": 0, "blend_bwd_plain": 0}


def blend_fwd_plain(table, ok, grid_x, tile_shape):
    plain_counts["blend_fwd_plain"] += 1
    return render_xla.blend_table(table, ok, grid_x, tile_shape)


def blend_bwd_plain(table: torch.Tensor, ok: torch.Tensor, gacc: torch.Tensor,
                    gft: torch.Tensor, gmed: torch.Tensor, grid_x: int,
                    tile_shape: Tuple[int, int]) -> torch.Tensor:
    """Closed-form cotangent of the table [T, K, 7+F] (plain version of K2)."""
    plain_counts["blend_bwd_plain"] += 1
    T, K, C = table.shape
    n_feat = C - 7
    P = tile_shape[0] * tile_shape[1]
    out = []
    for lo, hi in tile_chunks(T, P, K):
        tab, okc = table[lo:hi], ok[lo:hi]
        px, py = pixel_grid(torch.arange(lo, hi, device=table.device), tile_shape, grid_x)
        (dx, dy, power, alpha, contrib, a, Ta, Tb, committed, w) = blend_terms(
            tab, okc, px, py)
        T_final = torch.where(committed, Ta, torch.ones_like(Ta)).amin(-1, keepdim=True)
        feats = torch.cat([tab[..., 7:], tab[..., 6:7], torch.ones_like(tab[..., 6:7])], -1)
        ga = gacc[lo:hi]
        s = torch.einsum("bpc,bkc->bpk", ga, feats)
        sw = s * w
        S = sw.sum(-1, keepdim=True) - torch.cumsum(sw, -1)
        u = 1.0 - a
        da = (committed & contrib) * (s * Tb - (S + gft[lo:hi, :, None] * T_final) / u)
        live = (alpha < ALPHA_MAX) & contrib
        zero = torch.zeros_like(da)
        dopa = torch.where(live, torch.exp(power) * da, zero)
        dpow = torch.where(live, alpha * da, zero)
        ca, cb, cc = tab[:, None, :, 2], tab[:, None, :, 3], tab[:, None, :, 4]
        d_x = (dpow * (-(ca * dx + cb * dy))).sum(1)
        d_y = (dpow * (-(cc * dy + cb * dx))).sum(1)
        d_ca = (-0.5 * dx * dx * dpow).sum(1)
        d_cb = (-dx * dy * dpow).sum(1)
        d_cc = (-0.5 * dy * dy * dpow).sum(1)
        d_opa = dopa.sum(1)
        dfeats = torch.einsum("bpc,bpk->bkc", ga, w)
        crossing = contrib & committed & (Tb > 0.5) & (Ta < 0.5)
        d_dep = dfeats[..., n_feat] + (crossing * gmed[lo:hi, :, None]).sum(1)
        out.append(torch.cat(
            [torch.stack([d_x, d_y, d_ca, d_cb, d_cc, d_opa, d_dep], -1),
             dfeats[..., :n_feat]], -1))
    return torch.cat(out) if out else torch.zeros_like(table)


class _Blend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ok, grid_x, tile_shape):
        ctx.grid_x, ctx.tile_shape = grid_x, tile_shape
        if table.is_cuda:
            acc, ft, med, last, mslot = kernels.blend_fwd(table, ok, grid_x, tile_shape)
            ctx.save_for_backward(table, ok, ft, last, mslot)
        else:
            acc, ft, med = blend_fwd_plain(table, ok, grid_x, tile_shape)
            ctx.save_for_backward(table, ok)
        return acc, ft, med

    @staticmethod
    def backward(ctx, gacc, gft, gmed):
        gacc, gft, gmed = (g.contiguous() for g in (gacc, gft, gmed))
        if ctx.saved_tensors[0].is_cuda:
            table, ok, ft, last, mslot = ctx.saved_tensors
            dtab = kernels.blend_bwd(table, ok, ft, last, mslot, gacc, gft, gmed,
                                     ctx.grid_x, ctx.tile_shape)
        else:
            table, ok = ctx.saved_tensors
            dtab = blend_bwd_plain(table, ok, gacc, gft, gmed, ctx.grid_x, ctx.tile_shape)
        return dtab, None, None, None


def blend_tiles_pallas(table: torch.Tensor, ok: torch.Tensor, grid_x: int,
                       tile_shape: Tuple[int, int]):
    """Fused tile blend: table [T, K, 7+F], ok [T, K] bool ->
    (acc [T, P, F+2], final_T [T, P], median [T, P])."""
    return _Blend.apply(table.contiguous(), ok.contiguous(), int(grid_x), tuple(tile_shape))


def render_tiles_pallas(table: torch.Tensor, slot_ok: torch.Tensor, *,
                        image_shape: Tuple[int, int], tile_shape: Tuple[int, int],
                        grid: Tuple[int, int]):
    """Image-form wrapper: (channels [F+2, H, W], final_T [H, W], median [H, W])."""
    H, W = image_shape
    acc, ft, med = blend_tiles_pallas(table, slot_ok, grid[1], tile_shape)
    return (render_xla.tiles_to_image(acc, grid, tile_shape, H, W),
            render_xla.tiles_to_image(ft, grid, tile_shape, H, W),
            render_xla.tiles_to_image(med, grid, tile_shape, H, W))
