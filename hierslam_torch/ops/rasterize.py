"""Public differentiable rasterizer (port of ``hierslam_tpu/ops/rasterize.py``).

``preprocess`` -> ``bin_bucketed`` (rank-assigned capacity classes) -> one
gather of every per-gaussian blend quantity into per-slot rows ->
each class blended once on its own ``(1, n_b)`` virtual tile grid (screen
x shifted so class tile j lands at columns ``[j*tw, (j+1)*tw)``) -> one
permutation of tile blocks back into the image.

Binning may be amortized: pass ``binning_cache=`` (from
:func:`compute_binning` with a pixel margin) to reuse tile lists across
optimizer iterations; each slot re-applies the current rect test.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from hierslam_torch import resolve_device
from hierslam_torch.ops import binning, projection
from hierslam_torch.ops.gather_vjp import gather_rows, pack_cols_table
from hierslam_torch.ops.render_pallas import render_tiles_pallas


@dataclass(frozen=True)
class RasterConfig:
    """Rasterizer knobs, with the JAX package's names and defaults.

    ``gaussian_chunk``, ``tile_batch``, ``bin_chunk``, ``max_refs`` and
    ``pallas_interpret`` shape the TPU kernels and scans only: they are
    accepted and ignored.  ``backend`` "pallas" and "xla" both name the
    ladder blend (kernels K1/K2 on CUDA tensors, their plain versions on
    CPU tensors); "stream" makes the mapper render through the ragged pair
    stream (``ops/render_stream.py``, kernels K3/K4), with ``stream_rows``
    128-pair rows in all and at most ``stream_cap`` pairs a tile, while
    tracking and densify keep the ladder blend."""

    tile_shape: Tuple[int, int] = (16, 16)
    max_per_tile: int = 1024
    gaussian_chunk: int = 256
    tile_batch: int = 64
    bin_chunk: int = 16384
    max_refs: int = 16
    max_tiles_per_gaussian: int = 16
    backend: str = "pallas"
    pallas_interpret: bool = False
    grad_pair_budget: int = 0
    grad_bf16: bool = False
    track_max_per_tile: int = 0
    escalate_tiles: int = 0
    escalate_k: int = 0
    track_bucket_spec: Optional[Tuple[Tuple[int, int], ...]] = None
    bucket_spec: Optional[Tuple[Tuple[int, int], ...]] = None
    sat_margin: float = 0.0
    sat_floor: int = 64
    track_sat_margin: float = -1.0
    visible_budget: int = 0
    densify_max_per_tile: int = 0
    stream_rows: int = 0
    stream_cap: int = 4096

    def __post_init__(self):
        if self.backend not in ("pallas", "xla", "stream"):
            raise ValueError(f"unknown blend backend {self.backend!r}")

    def stream_rows_for(self, grid: Tuple[int, int]) -> int:
        """The stream's row budget: ``stream_rows``, or every tile at
        ``stream_cap`` when it is 0 (exact, for tests and small scenes)."""
        if self.stream_rows:
            return self.stream_rows
        return grid[0] * grid[1] * (self.stream_cap // 128)

    @property
    def esc_k(self) -> int:
        return self.escalate_k or 4 * self.max_per_tile

    def spec(self) -> Tuple[Tuple[int, int], ...]:
        """The unresolved capacity-class ladder for this config."""
        if self.bucket_spec is not None:
            return tuple(tuple(e) for e in self.bucket_spec)
        if self.escalate_tiles > 0:
            return ((self.escalate_tiles, self.esc_k), (-1, self.max_per_tile))
        return ((-1, self.max_per_tile),)

    def grid(self, height: int, width: int) -> Tuple[int, int]:
        th, tw = self.tile_shape
        return ((height + th - 1) // th, (width + tw - 1) // tw)


class Binning(NamedTuple):
    lists: binning.BucketedLists


class RenderOutput(NamedTuple):
    im: torch.Tensor                 # [3, H, W]
    radii: torch.Tensor              # [N] int32
    depth: torch.Tensor              # [H, W] alpha-blended depth
    median_depth: torch.Tensor       # [H, W]
    final_opacity: torch.Tensor      # [H, W] 1 - final transmittance
    mask: torch.Tensor               # [H, W] accumulated blend mass
    semantic: Optional[torch.Tensor]  # [S, H, W] or None
    n_dropped: torch.Tensor          # [] binning overflow count
    tile_count: Optional[torch.Tensor]  # [T] per-tile gaussian counts
    n_grad_dropped: Optional[torch.Tensor] = None


def _slot_ok(idx, g_rect, tx, ty):
    """Live-slot mask: real index + current-pose rect/frustum re-check."""
    return (
        (idx >= 0)
        & (g_rect[..., 4] > 0.5)
        & (tx >= g_rect[..., 0]) & (tx < g_rect[..., 2])
        & (ty >= g_rect[..., 1]) & (ty < g_rect[..., 3])
    )


def _assemble_buckets(strips, ids_list, grid, tile_shape, H, W):
    """[C, H, W] image from per-class strips ``[C, th, n_b*tw]`` (class tile
    j at columns ``[j*tw, (j+1)*tw)``) and their true tile ids."""
    gy, gx = grid
    th, tw = tile_shape
    pieces = []
    for s, ids in zip(strips, ids_list):
        nb = ids.shape[0]
        C = s.shape[0]
        pieces.append(s.reshape(C, th, nb, tw).permute(2, 0, 1, 3))
    tiles_all = torch.cat(pieces, 0)                  # [T, C, th, tw]
    ids_all = torch.cat(list(ids_list))
    pos = torch.empty_like(ids_all)
    pos[ids_all] = torch.arange(ids_all.shape[0], device=ids_all.device)
    merged = tiles_all[pos]
    C = merged.shape[1]
    out = merged.reshape(gy, gx, C, th, tw).permute(2, 0, 3, 1, 4)
    return out.reshape(C, gy * th, gx * tw)[:, :H, :W]


def _normalize_inputs(opacities, scales):
    if opacities.dim() == 2:
        opacities = opacities[:, 0]
    return opacities, scales


def _bin_from_prep(prep: projection.Preprocessed, grid, config: RasterConfig,
                   opacities=None, visible_budget: int = 0):
    sat = config.sat_margin > 0.0 and opacities is not None
    return binning.bin_bucketed(
        prep.rect_min, prep.rect_max, prep.valid, prep.depth.detach(), grid,
        config.spec(), config.tile_shape,
        max_tiles_per_gaussian=config.max_tiles_per_gaussian,
        sat_margin=config.sat_margin if sat else 0.0,
        sat_floor=config.sat_floor,
        xy=prep.xy.detach() if sat else None,
        conic=prep.conic.detach() if sat else None,
        opacity=opacities.detach() if sat else None,
        visible_budget=visible_budget,
    )


@torch.no_grad()
def compute_binning(means3D, scales, rotations, camera, config: RasterConfig,
                    active=None, margin_px: float = 0.0, opacities=None,
                    compact: bool = False) -> Binning:
    """Tile lists for the given camera-frame means.  ``margin_px`` inflates
    the rects (amortized binning); ``opacities`` enables the saturation
    bound; ``compact=True`` applies ``config.visible_budget`` and returns
    visible-rank lists."""
    prep = projection.preprocess(
        means3D, scales, rotations, camera, config.tile_shape, active=active,
        radius_margin_px=margin_px,
    )
    if opacities is not None and opacities.dim() == 2:
        opacities = opacities[:, 0]
    lists = _bin_from_prep(
        prep, config.grid(camera.height, camera.width), config, opacities,
        visible_budget=config.visible_budget if compact else 0,
    )
    return Binning(lists=lists)


def _combined_idx(lists: binning.BucketedLists):
    """All classes' lists reshaped to k_min-wide rows (one gather)."""
    k_min = lists.idx[-1].shape[1]
    return torch.cat([x.reshape(-1, k_min) for x in lists.idx if x.shape[0] > 0], 0)


def rasterize(
    means3D: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    scales: torch.Tensor,
    rotations: Optional[torch.Tensor],
    camera,
    semantics: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
    config: RasterConfig = RasterConfig(),
    binning_cache: Optional[Binning] = None,
    means2D_offset: Optional[torch.Tensor] = None,
    device="cuda",
) -> RenderOutput:
    """Rasterize N Gaussians (camera-frame means, post-activation opacity
    ``[N]``/``[N, 1]`` and scales ``[N, 1]``/``[N, 3]``, optional semantic
    logits ``[N, S]`` blended like colors) on ``device``, where the inputs
    must lie.  ``means2D_offset`` ([N, 2] zeros) is added to the screen
    means: its gradient is dL/d(screen-space mean) in pixels, what classic
    densification accumulates."""
    dev = resolve_device(device)
    if means3D.device != dev:
        raise ValueError(f"rasterize on {dev}, inputs on {means3D.device}")
    H, W = camera.height, camera.width
    grid = config.grid(H, W)
    opacities, scales = _normalize_inputs(opacities, scales)
    pc = projection.preprocess_cols(
        means3D, scales, rotations, camera, config.tile_shape, active=active,
    )
    if binning_cache is None:
        lists = _bin_from_prep(pc.stacked(), grid, config, opacities.detach())
    else:
        lists = binning_cache.lists

    feat_cols = [colors[:, i] for i in range(colors.shape[1])]
    if semantics is not None:
        feat_cols += [semantics[:, i] for i in range(semantics.shape[1])]
    rect_cols = [c.detach().float() for c in (
        pc.rect_min_x, pc.rect_min_y, pc.rect_max_x, pc.rect_max_y, pc.valid)]
    c_main = 7 + len(feat_cols)
    px, py = pc.x, pc.y
    if means2D_offset is not None:
        px = px + means2D_offset[:, 0]
        py = py + means2D_offset[:, 1]
    table = pack_cols_table(
        [px, py, pc.conic_a, pc.conic_b, pc.conic_c, opacities, pc.depth]
        + feat_cols + rect_cols
    )
    g_comb = gather_rows(table, _combined_idx(lists), c_main,
                         config.grad_pair_budget, config.grad_bf16)
    k_min = lists.idx[-1].shape[1]
    grid_x = grid[1]
    th_, tw_ = config.tile_shape

    strips_acc, ids_list = [], []
    row_off = 0
    for ids_b, idx_b in zip(lists.tile_ids, lists.idx):
        nb, kb = idx_b.shape
        if nb == 0:
            continue
        rows = nb * kb // k_min
        gb_all = g_comb[row_off:row_off + rows].reshape(nb, kb, -1)
        row_off += rows
        gb = gb_all[..., :c_main]
        btx = (ids_b % grid_x).float()[:, None]
        bty = (ids_b // grid_x).float()[:, None]
        slot_ok_b = _slot_ok(idx_b, gb_all[..., c_main:c_main + 5], btx, bty)
        j = torch.arange(nb, dtype=torch.float32, device=gb.device)[:, None]
        shift = torch.stack([(j - btx) * tw_, (-bty * th_).expand_as(j)], -1)
        gb = torch.cat([gb[..., :2] + shift, gb[..., 2:]], -1)
        acc_b, ft_b, med_b = render_tiles_pallas(
            gb, slot_ok_b, image_shape=(th_, nb * tw_), tile_shape=config.tile_shape,
            grid=(1, nb),
        )
        strips_acc.append(torch.cat([acc_b, ft_b[None], med_b[None]], 0))
        ids_list.append(ids_b)

    merged = _assemble_buckets(strips_acc, ids_list, grid, config.tile_shape, H, W)
    acc, final_T, med = merged[:-2], merged[-2], merged[-1]
    sem = acc[3:3 + semantics.shape[1]] if semantics is not None else None
    n_grad_dropped = (
        (lists.n_refs - config.grad_pair_budget).clamp_min(0)
        if config.grad_pair_budget else torch.zeros((), dtype=torch.int64, device=acc.device)
    )
    return RenderOutput(
        im=acc[:3], radii=pc.radius, depth=acc[-2], median_depth=med,
        final_opacity=1.0 - final_T, mask=acc[-1], semantic=sem,
        n_dropped=lists.n_dropped, tile_count=lists.count,
        n_grad_dropped=n_grad_dropped,
    )
