"""The forwards' per-warp footprint cull and pixel layout, plain versions.

K1 and K3 (``hierslam_torch/csrc/blend.cu``, ``stream.cu``) let a warp
visit only the pairs whose footprint can reach its pixels
(``csrc/cull.cuh``).  The kernels run only on the card; here the plain
version of the cull (``render_xla.cull_mask``) is held against the plain
blend's own terms: every (warp, pair) in which ``render_xla.blend_terms``
shows a pixel with ``power <= 0`` and ``alpha >= 1/255`` must be live.  The
cull may keep more (it is a box around an ellipse, widened); it must never
keep less.  No tolerance: the comparison is of booleans.  The JAX package
has no cull, so there is nothing of it to compare with here.

``csrc/cull.cuh`` itself (``warp_mask``, ``thread_pixel``) is not reached
from the CPU.  Its constants and rules are written a second time in
``render_xla``; what holds the two together is ``chip_smoke.py``, which
holds K1 and K3 against the plain blends on the card (a cull that dropped a
taken pair would change ``acc`` and the last committed slot there), and
the card-only test at the end of this file.

The tables mix the splats the maps are made of (about a pixel of sigma)
with the cases the cull must survive: means on and beyond tile edges,
opacities one float on either side of 1/255, alphas that clamp at 0.99,
conics that are not positive definite, a NaN and an infinity.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from golden import make_scene
from hierslam_torch.core import camera as tcam
from hierslam_torch.core import transforms as ttf
from hierslam_torch.ops import render_stream as trs
from hierslam_torch.ops import render_xla as rx
from hierslam_torch.ops.rasterize import RasterConfig

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "thin_gaussians", os.path.join(os.path.dirname(__file__), "..", "tools", "thin_gaussians.py"))
thin = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(thin)

ALPHA_MIN = np.float32(1.0) / np.float32(255.0)


def edge_table(seed, T, K, F, grid_x, tile_shape, sigma):
    """[T, K, 7+F] float32 table and [T, K] slot mask: splats of about
    ``sigma`` pixels scattered over and around each tile, then the edge
    cases written over the first slots of every tile.  Returns also the
    slots that must be live for every warp (degenerate conic, NaN, inf)."""
    rng = np.random.default_rng(seed)
    th, tw = tile_shape
    tid = np.arange(T)
    ox, oy = (tid % grid_x) * tw, (tid // grid_x) * th
    x = ox[:, None] + rng.uniform(-8, tw + 8, (T, K))
    y = oy[:, None] + rng.uniform(-8, th + 8, (T, K))
    var = (sigma * rng.uniform(0.6, 1.6, (T, K, 2))) ** 2 + 0.3
    rho = rng.uniform(-0.8, 0.8, (T, K))
    cxy = rho * np.sqrt(var[..., 0] * var[..., 1])
    det = var[..., 0] * var[..., 1] - cxy ** 2
    a, b, c = var[..., 1] / det, -cxy / det, var[..., 0] / det
    opa = rng.uniform(0.003, 1.0, (T, K))
    dep = np.sort(rng.uniform(0.5, 5.0, (T, K)), axis=1)
    tab = np.concatenate([np.stack([x, y, a, b, c, opa, dep], -1),
                          rng.uniform(0, 1, (T, K, F))], -1).astype(np.float32)
    ok = rng.uniform(size=(T, K)) > 0.1
    # means on pixel centres of the tile's border and just outside it
    tab[:, 0, 0], tab[:, 0, 1] = ox, oy
    tab[:, 1, 0], tab[:, 1, 1] = ox + tw - 1, oy + th - 1
    tab[:, 2, 0], tab[:, 2, 1] = ox - 0.5, oy + th / 2
    tab[:, 3, 0], tab[:, 3, 1] = ox + tw / 2, oy + th - 0.5
    tab[:, 4, 0], tab[:, 4, 1] = ox + 7.5, oy + 3.5          # between four pixel blocks
    # opacities one float above, at and below 1/255, on a pixel centre
    for k, o in ((5, np.nextafter(ALPHA_MIN, np.float32(1))), (6, ALPHA_MIN),
                 (7, np.nextafter(ALPHA_MIN, np.float32(0)))):
        tab[:, k, 0], tab[:, k, 1], tab[:, k, 5] = ox + 3, oy + 2, o
    for k, o in ((8, 1.0), (9, 0.999)):                      # alpha clamps at 0.99
        tab[:, k, 0], tab[:, k, 1], tab[:, k, 5] = ox + 5, oy + 1, o
    tab[:, 10, 2:5] = (0.5, 0.5, 0.5)                        # det = 0
    tab[:, 11, 2:5] = (0.1, 0.4, 0.1)                        # det < 0
    tab[:, 12, 2:5] = (0.0, 0.0, 0.0)                        # flat: power 0 everywhere
    tab[:, 10:16, 5] = 0.5
    tab[:, 13, 0] = np.nan
    tab[:, 14, 2] = np.nan
    tab[:, 15, 1] = np.inf
    tab[:, 16, 5] = np.nan
    ok[:, :17] = True
    return torch.as_tensor(tab), torch.as_tensor(ok), [10, 11, 12, 13, 14, 15, 16]


def taken_by_warp(contrib, tile_shape):
    """[B, P, K] per-pixel takes (row-major pixels) -> [B, P / 32, K]: a
    pixel of the warp takes the pair."""
    B, P, K = contrib.shape
    return contrib[:, rx.thread_pixels(tile_shape)].reshape(B, P // 32, 32, K).any(2)


@pytest.mark.parametrize("tile_shape", [(16, 16), (8, 16), (4, 32)])
@pytest.mark.parametrize("F", [1, 3, 29])
def test_cull_keeps_every_taken_slot(F, tile_shape):
    grid_x, T, K = 5, 15, 96
    dropped = []
    for sigma in (1.0, 4.0):
        tab, ok, wild = edge_table(100 + F, T, K, F, grid_x, tile_shape, sigma)
        tids = torch.arange(T)
        px, py = rx.pixel_grid(tids, tile_shape, grid_x)
        terms = rx.blend_terms(tab, ok, px, py)
        alpha, contrib = terms[3], terms[4]
        taken = taken_by_warp(contrib, tile_shape)                    # [T, nw, K]
        cxx, cyy = rx.conic_cov_diag(tab[..., 2], tab[..., 3], tab[..., 4])
        th, tw = tile_shape
        x0 = ((tids % grid_x) * tw).float()[:, None]
        y0 = ((tids // grid_x) * th).float()[:, None]
        live = rx.cull_mask(tab[..., 0], tab[..., 1], cxx, cyy, tab[..., 5], x0, y0, tile_shape)
        live = (live & ok[..., None]).permute(0, 2, 1)                # [T, nw, K]
        missed = taken & ~live
        assert not missed.any(), f"cull dropped {int(missed.sum())} taken (warp, slot)"
        # the edge cases do what they were built for
        assert taken[:, :, 5].any() and taken[:, :, 6].any() and not taken[:, :, 7].any()
        assert not live[:, :, 7].any()
        assert float(alpha[:, :, 8].max()) == pytest.approx(0.99)
        assert live[:, :, wild].all()
        assert taken[:, :, 12].all()
        n = int(ok.sum()) * live.shape[1]
        dropped.append(1.0 - float(live.sum()) / n)
        print(f"F={F} tile {tile_shape} sigma {sigma}: cull drops {100 * dropped[-1]:.1f}% of "
              f"{n} (warp, slot); {100 * float(taken.sum()) / n:.1f}% are taken")
    # it is a cull: small splats miss most warps, and more than large ones do
    assert dropped[0] > 0.4 and dropped[0] > dropped[1]


def thin_live_and_taken(tab, ok, grid_x, tile_shape):
    """[T, nw, K] (live, taken) of a table: the plain cull of each slot
    from its conic, and the warps in which a pixel takes it."""
    T = tab.shape[0]
    th, tw = tile_shape
    tids = torch.arange(T)
    px, py = rx.pixel_grid(tids, tile_shape, grid_x)
    taken = taken_by_warp(rx.blend_terms(tab, ok, px, py)[4], tile_shape)
    cxx, cyy = rx.conic_cov_diag(tab[..., 2], tab[..., 3], tab[..., 4])
    x0 = ((tids % grid_x) * tw).float()[:, None]
    y0 = ((tids // grid_x) * th).float()[:, None]
    live = rx.cull_mask(tab[..., 0], tab[..., 1], cxx, cyy, tab[..., 5], x0, y0, tile_shape)
    return (live & ok[..., None]).permute(0, 2, 1), taken


@pytest.mark.parametrize("tile_shape", [(16, 16), (4, 32)])
@pytest.mark.parametrize("seed", [0, 1])
def test_cull_keeps_every_taken_slot_of_thin_gaussians(seed, tile_shape):
    """Thin gaussians (lambda1 / lambda2 to 1e7, at 0-60 degrees), half of
    them with a tile at the tip of the ellipse (``tools/thin_gaussians.py``):
    there the float32 quadratic form of the blend rounds far more than the
    box's 1% widening covers, and a cull from the conic as it stands drops
    hundreds of taken (warp, slot) in such a table."""
    grid_x, T, K = 8, 32, 256
    tab, ok = (torch.as_tensor(x) for x in thin.thin_table(200 + seed, T, K, 3, grid_x,
                                                             tile_shape))
    live, taken = thin_live_and_taken(tab, ok, grid_x, tile_shape)
    missed = taken & ~live
    assert not missed.any(), f"cull dropped {int(missed.sum())} taken (warp, slot)"
    ratio = thin.det_ratio(tab.numpy())
    taken_slot = taken.any(1).numpy()
    n = int(ok.sum()) * live.shape[1]
    # the box from the conic as it stands, its determinant in float32 (the
    # cull before the allowance) and in float64: what each would drop
    drops = []
    for dt in (torch.float32, torch.float64):
        a, b, c = (tab[..., i].to(dt) for i in (2, 3, 4))
        d = a * c - b * b
        box = [torch.where(d > 0, x / d, torch.full_like(d, float("inf"))).float() for x in (c, a)]
        th, tw = tile_shape
        tids = torch.arange(T)
        x0, y0 = ((tids % grid_x) * tw).float()[:, None], ((tids // grid_x) * th).float()[:, None]
        old = rx.cull_mask(tab[..., 0], tab[..., 1], *box, tab[..., 5], x0, y0, tile_shape)
        drops.append(int((taken & ~(old & ok[..., None]).permute(0, 2, 1)).sum()))
    print(f"thin tile {tile_shape} seed {seed}: smallest (ac - b^2)/ac {ratio.min():.3e}, of a "
          f"taken slot {ratio[taken_slot].min():.3e}; cull drops {100 * (1 - float(live.sum()) / n):.1f}% "
          f"of {n} (warp, slot); {100 * float(taken.sum()) / n:.1f}% are taken; a box with no "
          f"allowance for q's rounding would drop {drops[0]} taken (determinant in float32), "
          f"{drops[1]} (in float64)")
    # the table reaches the conics whose tips dropped pixels, and the tips are taken
    assert ratio[taken_slot].min() < 1e-6
    assert int(taken.sum()) > 1000 and float(live.sum()) < live.numel()


def small_stream(F, seed=3, n=400, W=64, H=48):
    sc, cam = make_scene(n=n, seed=seed, W=W, H=H, sem=max(F - 3, 0))
    K = tcam.intrinsics_matrix(cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    camera = tcam.setup_camera(W, H, K, np.eye(4))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    cols = [sc["means3D"], np.log(sc["scales"][:, :1]),
            np.log(sc["opacities"] / (1 - sc["opacities"]))[:, None], sc["colors"]]
    if F > 3:
        cols.append(sc["semantics"])
    table = t(np.concatenate(cols, 1)[:, :5 + F])
    w2c = t(cam["w2c"])
    q = ttf.matrix_to_quaternion(w2c[:3, :3])
    means_cam, _ = ttf.transform_to_frame(table[:, :3], t(sc["rotations"]), q, w2c[:3, 3],
                                          gaussians_grad=False, camera_grad=False)
    rc = RasterConfig(backend="stream", stream_cap=512)
    b = trs.compute_stream_binning(means_cam, torch.exp(table[:, 3:4]), t(sc["rotations"]),
                                   camera, rc, opacities=torch.sigmoid(table[:, 4]))
    table_s = torch.cat([table, trs.sentinel_row(table.shape[1])], 0)
    stream = table_s[b.lists.idx]
    scal = trs.make_scalars(ttf.build_w2c(ttf.normalize(q), w2c[:3, 3]), camera)
    return stream, scal, b.lists.row_off, rc.grid(H, W), rc.tile_shape, (H, W)


@pytest.mark.parametrize("F", [1, 3, 29])
def test_cull_keeps_every_taken_pair_of_a_stream(F):
    stream, scal, row_off, grid, tile_shape, img = small_stream(F)
    T = grid[0] * grid[1]
    flat = stream.reshape(-1, stream.shape[-1])
    k_max = trs.max_tile_pairs(row_off)
    assert k_max > 0
    pos, inside = trs.tile_view(flat, row_off, 0, T, k_max)
    tids = torch.arange(T)
    _, terms, _ = trs.blend_view(flat[pos], inside, scal, tids, grid[1], tile_shape, F, img)
    taken = taken_by_warp(terms[4], tile_shape)                       # [T, nw, k_max]
    assert taken.any()
    th, tw = tile_shape
    tx, ty = (tids % grid[1]).float()[:, None], (tids // grid[1]).float()[:, None]
    q = trs.project_pairs(flat[pos], scal, tx, ty, float(img[1]), float(img[0]), tile_shape)
    live = rx.cull_mask(q["px"], q["py"], q["cxx"], q["cyy"], q["opa"], tx * tw, ty * th,
                        tile_shape)
    live = (live & (q["valid"] & inside)[..., None]).permute(0, 2, 1)
    missed = taken & ~live
    assert not missed.any(), f"cull dropped {int(missed.sum())} taken (warp, pair)"
    n = int((q["valid"] & inside).sum()) * live.shape[1]
    share = 1.0 - float(live.sum()) / n
    print(f"stream F={F}: cull drops {100 * share:.1f}% of {n} (warp, valid pair); "
          f"{100 * float(taken.sum()) / n:.1f}% are taken")
    assert 0.0 < share < 1.0


@pytest.mark.parametrize("tile_shape", [(16, 16), (8, 16), (4, 32), (12, 16), (32, 8)])
def test_thread_pixels_is_a_bijection_that_agrees_with_pixel_grid(tile_shape):
    th, tw = tile_shape
    P = th * tw
    tp = rx.thread_pixels(tile_shape)
    assert sorted(tp.tolist()) == list(range(P))
    grid_x, tile = 7, 10
    px, py = rx.pixel_grid(torch.tensor([tile]), tile_shape, grid_x)
    rects = rx.warp_rects(tile_shape)
    assert rects.shape == (P // 32, 4)
    for p in range(P):
        w, l = divmod(p, 32)   # warp w is an 8 x 4 block, lane l its pixel (l % 8, l / 8)
        x, y = 8 * (w % (tw // 8)) + l % 8, 4 * (w // (tw // 8)) + l // 8
        assert int(tp[p]) == y * tw + x
        assert float(px[0, tp[p]]) == (tile % grid_x) * tw + x
        assert float(py[0, tp[p]]) == (tile // grid_x) * th + y
        x0, x1, y0, y1 = rects[w].tolist()
        assert x0 <= x <= x1 and y0 <= y <= y1
    for w in range(P // 32):   # each rectangle is the tight box of its warp's pixels
        xs, ys = tp[32 * w:32 * w + 32] % tw, tp[32 * w:32 * w + 32] // tw
        assert rects[w].tolist() == [int(xs.min()), int(xs.max()), int(ys.min()), int(ys.max())]
    if tile_shape == (16, 16):
        assert rects[3].tolist() == [8, 15, 4, 7]


@pytest.mark.parametrize("tile_shape", [(6, 16), (2, 48), (16, 12)])
def test_layout_raises_on_a_tile_that_is_not_8x4_blocks(tile_shape):
    with pytest.raises(ValueError, match="multiple of 4 x 8"):
        rx.thread_pixels(tile_shape)
    with pytest.raises(ValueError, match="multiple of 4 x 8"):
        rx.warp_rects(tile_shape)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [3, 29])
def test_k1_on_the_edge_table_agrees_with_the_plain_blend(F):
    """csrc/cull.cuh through K1: on the table of edge cases, the kernel's
    outputs are the plain blend's (acc 1e-3, final T and median 1e-4 as in
    chip_smoke.py), which a dropped (warp, slot) would break."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from hierslam_torch.ops import kernels, render_pallas

    tile_shape, grid_x, T, K = (16, 16), 5, 15, 96
    for sigma in (1.0, 4.0):
        tab, ok, _ = edge_table(100 + F, T, K, F, grid_x, tile_shape, sigma)
        # the plain blend's cumprod spreads a NaN over a pixel's later slots,
        # the kernel's walk does not: keep the finite cases
        finite = torch.isfinite(tab).all(-1)
        tab = torch.where(finite[..., None], tab, torch.zeros_like(tab))
        tab, ok = tab.cuda().contiguous(), (ok & finite).cuda()
        acc, ft, med, _, _ = kernels.blend_fwd(tab, ok, grid_x, tile_shape)
        acc_p, ft_p, med_p = render_pallas.blend_fwd_plain(tab, ok, grid_x, tile_shape)
        assert float((acc - acc_p).abs().max()) <= 1e-3
        assert float((ft - ft_p).abs().max()) <= 1e-4
        assert float((med - med_p).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("F", [3, 29])
def test_k1_on_thin_gaussians_agrees_with_the_plain_blend(F):
    """csrc/cull.cuh's ``conic_box_diag`` through K1: on a table of thin
    gaussians with tiles at their tips, the kernel's outputs are the plain
    blend's (the tolerances of the edge-table test), which a dropped (warp,
    slot) would break."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from hierslam_torch.ops import kernels, render_pallas

    tile_shape, grid_x, T, K = (16, 16), 8, 64, 512
    tab, ok = (torch.as_tensor(x).cuda() for x in thin.thin_table(300 + F, T, K, F, grid_x))
    acc, ft, med, _, _ = kernels.blend_fwd(tab, ok, grid_x, tile_shape)
    acc_p, ft_p, med_p = render_pallas.blend_fwd_plain(tab, ok, grid_x, tile_shape)
    assert float((acc - acc_p).abs().max()) <= 1e-3
    assert float((ft - ft_p).abs().max()) <= 1e-4
    assert float((med - med_p).abs().max()) <= 1e-4
