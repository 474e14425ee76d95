"""The ladder blend with its closed-form backward (port of ``hierslam_tpu/ops/render_pallas.py``).

:func:`blend_classes` blends the capacity classes of one render, each at
its true tile ids, into buffers they share, through one
``torch.autograd.Function``; :func:`blend_tiles_pallas` is its one-class
case with row b tile b.  On CUDA tensors its forward launches kernel K1
and its backward kernel K2 once a class (``csrc/blend.cu``, via
``ops/kernels.py``).  On CPU tensors the forward is
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

from typing import Optional, Sequence, Tuple

import torch

from hierslam_torch.ops import kernels, render_xla
from hierslam_torch.ops.render_xla import ALPHA_MAX, blend_terms, pixel_grid, tile_chunks

# calls of the plain versions (a main-path run on the card keeps both at 0)
plain_counts = {"blend_fwd_plain": 0, "blend_bwd_plain": 0}


def blend_fwd_plain(table, ok, grid_x, tile_shape, tile_ids=None, out=None):
    """Plain version of K1 (``render_xla.blend_table``; tile ids and shared
    buffers as there)."""
    plain_counts["blend_fwd_plain"] += 1
    return render_xla.blend_table(table, ok, grid_x, tile_shape, tile_ids, out)


def blend_bwd_plain(table: torch.Tensor, ok: torch.Tensor, gacc: torch.Tensor,
                    gft: torch.Tensor, gmed: torch.Tensor, grid_x: int,
                    tile_shape: Tuple[int, int],
                    tile_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Closed-form cotangent of the table [T, K, 7+F] (plain version of K2).
    Row b of the table is tile ``tile_ids[b]`` (b where None), whose
    cotangents are row ``tile_ids[b]`` of ``gacc``, ``gft`` and ``gmed``."""
    plain_counts["blend_bwd_plain"] += 1
    T, K, C = table.shape
    n_feat = C - 7
    P = tile_shape[0] * tile_shape[1]
    ids = (torch.arange(T, device=table.device) if tile_ids is None
           else tile_ids.to(device=table.device, dtype=torch.int64))
    out = []
    for lo, hi in tile_chunks(T, P, K):
        tab, okc, ids_c = table[lo:hi], ok[lo:hi], ids[lo:hi]
        px, py = pixel_grid(ids_c, tile_shape, grid_x)
        (dx, dy, power, alpha, contrib, a, Ta, Tb, committed, w) = blend_terms(
            tab, okc, px, py)
        T_final = torch.where(committed, Ta, torch.ones_like(Ta)).amin(-1, keepdim=True)
        feats = torch.cat([tab[..., 7:], tab[..., 6:7], torch.ones_like(tab[..., 6:7])], -1)
        ga = gacc[ids_c]
        s = torch.einsum("bpc,bkc->bpk", ga, feats)
        sw = s * w
        S = sw.sum(-1, keepdim=True) - torch.cumsum(sw, -1)
        u = 1.0 - a
        da = (committed & contrib) * (s * Tb - (S + gft[ids_c][:, :, None] * T_final) / u)
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
        d_dep = dfeats[..., n_feat] + (crossing * gmed[ids_c][:, :, None]).sum(1)
        out.append(torch.cat(
            [torch.stack([d_x, d_y, d_ca, d_cb, d_cc, d_opa, d_dep], -1),
             dfeats[..., :n_feat]], -1))
    return torch.cat(out) if out else torch.zeros_like(table)


class _BlendClasses(torch.autograd.Function):
    """The classes of one render: ``n`` tables, then their ``n`` slot masks
    and ``n`` tile-id vectors (None: row b is tile b), blended into shared
    buffers of ``n_tiles`` rows."""

    @staticmethod
    def forward(ctx, grid_x, tile_shape, n_tiles, n, *classes):
        tables = classes[:n]
        dev = tables[0].device
        P = tile_shape[0] * tile_shape[1]
        acc = torch.empty((n_tiles, P, tables[0].shape[-1] - 5), dtype=torch.float32,
                          device=dev)
        ft, med = (torch.empty((n_tiles, P), dtype=torch.float32, device=dev) for _ in range(2))
        ctx.meta = (grid_x, tile_shape, n, tables[0].is_cuda)
        if tables[0].is_cuda:
            last, mslot = (torch.empty((n_tiles, P), dtype=torch.int32, device=dev)
                           for _ in range(2))
            for tab, ok, ids in zip(tables, classes[n:2 * n], classes[2 * n:]):
                kernels.blend_fwd(tab, ok, grid_x, tile_shape, ids, (acc, ft, med, last, mslot))
            ctx.save_for_backward(ft, last, mslot, *classes)
        else:
            for tab, ok, ids in zip(tables, classes[n:2 * n], classes[2 * n:]):
                blend_fwd_plain(tab, ok, grid_x, tile_shape, ids, (acc, ft, med))
            ctx.save_for_backward(*classes)
        return acc, ft, med

    @staticmethod
    def backward(ctx, gacc, gft, gmed):
        grid_x, tile_shape, n, cuda = ctx.meta
        gacc, gft, gmed = (g.contiguous() for g in (gacc, gft, gmed))
        saved = ctx.saved_tensors
        classes = saved[3:] if cuda else saved
        dtabs = []
        for tab, ok, ids in zip(classes[:n], classes[n:2 * n], classes[2 * n:]):
            if cuda:   # saved[:3]: final T, last and median slot of every tile
                dtabs.append(kernels.blend_bwd(tab, ok, *saved[:3], gacc, gft, gmed, grid_x,
                                               tile_shape, ids))
            else:
                dtabs.append(blend_bwd_plain(tab, ok, gacc, gft, gmed, grid_x, tile_shape, ids))
        return (None, None, None, None, *dtabs) + (None,) * (2 * n)


def blend_classes(tables: Sequence[torch.Tensor], oks: Sequence[torch.Tensor],
                  tile_ids: Sequence[torch.Tensor], grid_x: int, tile_shape: Tuple[int, int],
                  n_tiles: int):
    """The capacity classes of one render, blended at their true tiles:
    class c's table [n_c, k_c, 7+F] and slot mask [n_c, k_c] hold the tiles
    ``tile_ids[c]`` [n_c] of a grid ``grid_x`` wide and ``n_tiles`` tiles in
    all, which the classes partition.  -> (acc [n_tiles, P, F+2], final_T
    [n_tiles, P], median [n_tiles, P]) in tile order.  One K1 launch a class
    forward and one K2 launch a class backward."""
    if sum(int(t.shape[0]) for t in tables) != n_tiles:
        raise ValueError(f"classes of {[int(t.shape[0]) for t in tables]} tiles do not "
                         f"partition {n_tiles}")
    ids = [i.to(torch.int32).contiguous() for i in tile_ids]
    return _BlendClasses.apply(int(grid_x), tuple(tile_shape), int(n_tiles), len(tables),
                               *(t.contiguous() for t in tables),
                               *(o.contiguous() for o in oks), *ids)


def blend_tiles_pallas(table: torch.Tensor, ok: torch.Tensor, grid_x: int,
                       tile_shape: Tuple[int, int]):
    """Fused tile blend, row b of the table tile b: table [T, K, 7+F], ok
    [T, K] bool -> (acc [T, P, F+2], final_T [T, P], median [T, P])."""
    return _BlendClasses.apply(int(grid_x), tuple(tile_shape), int(table.shape[0]), 1,
                               table.contiguous(), ok.contiguous(), None)


def render_tiles_pallas(table: torch.Tensor, slot_ok: torch.Tensor, *,
                        image_shape: Tuple[int, int], tile_shape: Tuple[int, int],
                        grid: Tuple[int, int]):
    """Image-form wrapper: (channels [F+2, H, W], final_T [H, W], median [H, W])."""
    H, W = image_shape
    acc, ft, med = blend_tiles_pallas(table, slot_ok, grid[1], tile_shape)
    return (render_xla.tiles_to_image(acc, grid, tile_shape, H, W),
            render_xla.tiles_to_image(ft, grid, tile_shape, H, W),
            render_xla.tiles_to_image(med, grid, tile_shape, H, W))
