"""The binning's pair emission: kernel ``bin_emit`` (``csrc/binning.cu``)
against its plain version (``ops/binning.emit_pairs_plain``).

On the CPU: the offsets that place each cell row's part of the emission
(``binning.emission_offsets``, PyTorch ops that run on both devices) against
the parts the plain version's boolean masks keep, on seeded inputs with
binding budgets and a visible budget.

On the card (marker ``cuda``, skipped here): the kernel path against the
plain version on the same CUDA tensors, equal to the bit in the emission's
outputs, in every ``SortedPairs`` field and in every field of
``bin_stream``, ``bin_bucketed`` and ``bin_gaussians`` (the plain path
forced by replacing ``binning.emit_pairs`` for the one call); a seeded map
at the flagship's shapes; and one stream binning's host syncs and counters.
On the card's machine: ``python3 -m pytest tests/test_torch_bin_emit.py -m
cuda --noconftest -p no:cacheprovider``.
"""
import warnings

import numpy as np
import pytest
import torch

from hierslam_torch.ops import binning

# name -> (seed, n, grid (gy, gx), tile (th, tw), r_cap, largest rect side,
#          sat, visible budget, emission budgets (None: the defaults))
CASES = {
    "sat": (1, 3000, (12, 20), (16, 16), 16, 6, True, 0, None),
    "no_sat": (2, 3000, (12, 20), (16, 16), 16, 6, False, 0, None),
    "visible": (3, 3000, (12, 20), (16, 16), 16, 6, True, 1700, None),
    "tight": (4, 3000, (12, 20), (16, 16), 16, 6, True, 0,
              (3000, 1400, 700, 500, 300, 200, 120, 90, 60, 40, 30, 20, 12, 8, 4, 1)),
    "tight_visible": (5, 3000, (12, 20), (16, 16), 16, 6, False, 2000,
                      (2500, 900, 400, 400, 250, 100, 80, 60, 40, 30, 20, 10, 5, 3, 2, 1)),
    "r_cap32": (6, 3000, (16, 24), (16, 16), 32, 9, True, 0, None),
    "tile1": (7, 3000, (40, 60), (1, 1), 32, 9, False, 0, None),
    "none_valid": (8, 500, (12, 20), (16, 16), 16, 6, True, 0, None),
    "singular": (9, 3000, (12, 20), (16, 16), 16, 6, True, 0, None),
}


def make_inputs(case, device="cpu"):
    """Seeded screen-space inputs of a binning: rects on the tile grid (some
    wider than ``r_cap`` cells, some empty), ~10% invalid, depths with ties
    (the stable sorts decide them), and with the screen terms gaussians of
    1 to 200 px.  ``singular``: near-singular conics, and conic entries up to
    1e37 whose exponents overflow to inf and NaN."""
    seed, n, (gy, gx), (th, tw), _, side, _, _, _ = CASES[case]
    rng = np.random.default_rng(seed)
    x0, y0 = rng.integers(0, gx, n), rng.integers(0, gy, n)
    x1 = np.minimum(x0 + rng.integers(0, side + 1, n), gx)
    y1 = np.minimum(y0 + rng.integers(0, side + 1, n), gy)
    valid = rng.random(n) < 0.9
    if case == "none_valid":
        valid[:] = False
    depth = np.round(rng.uniform(0.3, 8.0, n), 2)
    xy = np.stack([(x0 + rng.random(n) * (x1 - x0 + 1)) * tw,
                   (y0 + rng.random(n) * (y1 - y0 + 1)) * th], 1)
    sig = np.exp(rng.uniform(0.0, np.log(200.0), (n, 2)))
    rho = rng.uniform(-0.9, 0.9, n)
    a, c = 1.0 / sig[:, 0] ** 2, 1.0 / sig[:, 1] ** 2
    b = rho * np.sqrt(a * c)
    if case == "singular":
        k = rng.random(n) < 0.3
        b[k] = np.sign(b[k] + 1e-9) * np.sqrt(a[k] * c[k]) * (1.0 - 1e-7)
        big = rng.random(n) < 0.2
        scale = 10.0 ** rng.uniform(10, 37, n)
        a[big], b[big], c[big] = a[big] * scale[big], -b[big] * scale[big], c[big] * scale[big]
    conic = np.stack([a, b, c], 1)
    opacity = rng.uniform(0.005, 1.0, n)

    def dev(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dt).to(device)

    return dict(rect_min=dev(np.stack([x0, y0], 1), torch.int32),
                rect_max=dev(np.stack([x1, y1], 1), torch.int32),
                valid=dev(valid, torch.bool), depth=dev(depth, torch.float32),
                xy=dev(xy, torch.float32), conic=dev(conic, torch.float32),
                opacity=dev(opacity, torch.float32))


def emission(case, device="cpu"):
    """The arguments ``_emit_sort_sat`` hands to ``emit_pairs``, worked out
    as it does, and the touched counts, order and budgets behind them."""
    _, n, (_, gx), tile, r_cap, _, sat, vis, budgets = CASES[case]
    x = make_inputs(case, device)
    base_n = min(vis, n) if vis else n
    budgets = tuple(min(b, base_n) for b in (
        budgets or binning.default_emission_budgets(base_n, r_cap)))[:r_cap]
    rect_min, rect_max = x["rect_min"].long(), x["rect_max"].long()
    w_rect = rect_max[:, 0] - rect_min[:, 0]
    touched = torch.where(x["valid"], w_rect * (rect_max[:, 1] - rect_min[:, 1]),
                          torch.zeros_like(w_rect)).clamp_max(r_cap)
    neg_sorted, order = torch.sort(-touched, stable=True)
    offs, n_dropped = binning.emission_offsets(neg_sorted, budgets)
    args = (rect_min, w_rect, touched, x["depth"], order[:base_n], budgets, gx, tile,
            bool(vis), (x["xy"], x["conic"], x["opacity"]) if sat else None)
    return args, offs, n_dropped


@pytest.mark.parametrize("case", list(CASES))
def test_emission_offsets_place_the_masked_parts(case):
    """Part r of the plain version's concatenation lies at offs[r]:offs[r+1]
    and holds cell r of the first min(budgets[r], #touched > r) ranks, in
    rank order; the budgets' drops are what the counts exceed them by."""
    args, offs, n_dropped = emission(case)
    rect_min, w_rect, touched, depth, o, budgets, gx, _, vis, _ = args
    tile, dep, gauss, quads = binning.emit_pairs_plain(*args)
    t = touched.numpy()
    cnt_gt = np.array([(t > r).sum() for r in range(len(budgets))])
    lens = np.minimum(np.array(budgets), cnt_gt)
    np.testing.assert_array_equal(offs.numpy(), np.concatenate([[0], np.cumsum(lens)]))
    assert int(n_dropped) == int(np.maximum(cnt_gt - np.array(budgets), 0).sum())
    assert tile.shape[0] == int(offs[-1]) == gauss.shape[0] == dep.shape[0]
    assert (quads is None) == (CASES[case][6] is False)
    wr = w_rect.clamp_min(1)
    for r in range(len(budgets)):
        s, e = int(offs[r]), int(offs[r + 1])
        g = o[:e - s]
        cell = (rect_min[g, 1] + r // wr[g]) * gx + rect_min[g, 0] + r % wr[g]
        assert torch.equal(tile[s:e], cell), r
        assert torch.equal(dep[s:e], depth[g]), r
        ids = torch.arange(e - s) if vis else g
        assert torch.equal(gauss[s:e], ids), r
    if case == "none_valid":
        assert int(offs[-1]) == 0
    if case.startswith("tight"):
        assert int(n_dropped) > 0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from hierslam_torch.ops import kernels
    kernels.reset_launch_counts()
    binning.plain_counts["emit_pairs_plain"] = 0
    return kernels


def _same(a, b, what):
    """Equal to the bit: floats compared by their bits, tuples entry by entry."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        if a.is_floating_point():
            a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
        assert torch.equal(a, b), what
    else:
        assert a == b, what


def _both(fn, monkeypatch):
    """``fn()`` on the kernel path, then with the plain emission in its place."""
    kernel = fn()
    with monkeypatch.context() as m:
        m.setattr(binning, "emit_pairs", lambda *a: binning.emit_pairs_plain(*a[:-1]))
        plain = fn()
    return kernel, plain


def _fields(nt, what, other):
    for f in nt._fields:
        _same(getattr(nt, f), getattr(other, f), f"{what}.{f}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_bin_emit_equals_plain_on_card(case, monkeypatch):
    """The kernel path and the plain version on the same CUDA tensors: the
    emission, ``SortedPairs`` and the three binnings equal to the bit."""
    kernels = _card()
    args, offs, _ = emission(case, "cuda")
    out = binning.emit_pairs(*args, offs)
    _same(out, binning.emit_pairs_plain(*args), "emission")
    m = int(offs[-1])
    assert kernels.launch_counts["bin_emit"] == (1 if m else 0)
    if case == "sat":
        assert m > 0 and int(out[3].max()) > 0   # the quads are not all 0

    _, _, grid, tile, r_cap, _, sat, vis, budgets = CASES[case]
    x = make_inputs(case, "cuda")
    common = (x["rect_min"], x["rect_max"], x["valid"], x["depth"], grid)
    s_kw = dict(max_tiles_per_gaussian=r_cap, emission_budgets=budgets,
                sat_margin=2.0 if sat else 0.0, sat_floor=8, xy=x["xy"], conic=x["conic"],
                opacity=x["opacity"], visible_budget=vis)
    if case == "tile1":
        for esc in ((0, 0), (5, 64)):
            k, p = _both(lambda: binning.bin_gaussians(
                *common, 16, max_tiles_per_gaussian=r_cap, emission_budgets=budgets,
                n_escalate=esc[0], escalate_k=esc[1]), monkeypatch)
            _fields(k[0], "bin_gaussians", p[0])
            assert (k[1] is None) == (p[1] is None)
            if k[1] is not None:
                _fields(k[1], "escalated", p[1])
        return
    k, p = _both(lambda: binning._emit_sort_sat(
        *common, tile, r_cap, budgets, s_kw["sat_margin"], 8, x["xy"], x["conic"],
        x["opacity"], vis), monkeypatch)
    _fields(k, "SortedPairs", p)
    k, p = _both(lambda: binning.bin_stream(*common, tile, stream_rows=400, k_cap=512,
                                            **s_kw), monkeypatch)
    _fields(k, "bin_stream", p)
    spec = ((16, 256), (64, 128), (-1, 64))
    k, p = _both(lambda: binning.bin_bucketed(*common, spec, tile, **s_kw), monkeypatch)
    _fields(k, "bin_bucketed", p)


def _flagship_map(n, seed, dev):
    """``n`` gaussians in front of the flagship's 1200x680 camera (f = 600),
    2 to 8 m deep, 1 to 10 cm, opacity logits N(1.5, 1)."""
    from hierslam_torch.core import camera as tcam

    rng = np.random.default_rng(seed)
    W, H, f = 1200, 680, 600.0
    z = rng.uniform(2.0, 8.0, n)
    x = (rng.uniform(0, W, n) - W / 2) / f * z * 1.1
    y = (rng.uniform(0, H, n) - H / 2) / f * z * 1.1
    means = torch.as_tensor(np.stack([x, y, z], 1), dtype=torch.float32, device=dev)
    scales = torch.as_tensor(np.exp(rng.uniform(np.log(0.01), np.log(0.1), (n, 1))),
                             dtype=torch.float32, device=dev)
    rots = torch.as_tensor(rng.normal(size=(n, 4)), dtype=torch.float32, device=dev)
    opac = torch.sigmoid(torch.as_tensor(rng.normal(1.5, 1.0, n), dtype=torch.float32,
                                         device=dev))
    K = np.array([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1]], np.float32)
    return means, scales, rots, opac, tcam.setup_camera(W, H, K, np.eye(4))


def _flagship_raster():
    import os

    from hierslam_torch.config import apply_defaults, load_config, raster_config
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return raster_config(apply_defaults(load_config(
        os.path.join(root, "configs", "replica", "hierslam_semantic_run.py"))))


@pytest.mark.cuda
def test_bin_emit_flagship_shape_on_card(monkeypatch):
    """A seeded 300k-gaussian map at the flagship's 1200x680 and raster
    config: the stream binning (lists and inverse map) and the densify
    render's ladder binning, kernel path against plain, equal to the bit."""
    from hierslam_torch.ops import projection, render_stream

    kernels = _card()
    rc = _flagship_raster()
    means, scales, rots, opac, cam = _flagship_map(300_000, 2147484417, "cuda")
    k, p = _both(lambda: render_stream.compute_stream_binning(
        means, scales, rots, cam, rc, margin_px=4.0, opacities=opac), monkeypatch)
    _fields(k.lists, "bin_stream", p.lists)
    _fields(k.inverse, "inverse", p.inverse)
    assert kernels.launch_counts["bin_emit"] == 1 and int(k.lists.n_refs) > 1_000_000
    prep = projection.preprocess(means, scales, rots, cam, rc.tile_shape)
    k, p = _both(lambda: binning.bin_bucketed(
        prep.rect_min, prep.rect_max, prep.valid, prep.depth, rc.grid(680, 1200), rc.spec(),
        rc.tile_shape, rc.max_tiles_per_gaussian, sat_margin=rc.sat_margin,
        sat_floor=rc.sat_floor, xy=prep.xy, conic=prep.conic, opacity=opac,
        visible_budget=rc.visible_budget), monkeypatch)
    _fields(k, "bin_bucketed", p)


@pytest.mark.cuda
def test_bin_emit_syncs_and_counters_on_card():
    """The emission waits for the device once, to read its total: the
    offsets and the launch run under sync debug mode "error", as does the
    move of the map into a window frame's camera.  A whole stream binning
    waits twice (that total and the used rows), launches the kernel once and
    never calls the plain version."""
    from hierslam_torch.core import transforms
    from hierslam_torch.ops import render_stream

    kernels = _card()
    args, _, _ = emission("sat", "cuda")
    rect_min, w_rect, touched, depth, o, budgets, gx, tile, vis, sat = args
    neg_sorted = torch.sort(-touched, stable=True).values
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        offs, _ = binning.emission_offsets(neg_sorted, budgets)
        torch.cuda.set_sync_debug_mode(0)
        m = int(offs[-1])
        torch.cuda.set_sync_debug_mode("error")
        kernels.bin_emit(rect_min, w_rect, depth, o, offs, m, gx, tile, vis, sat)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert m > 0

    kernels.reset_launch_counts()
    rc = _flagship_raster()
    means, scales, rots, opac, cam = _flagship_map(50_000, 5, "cuda")
    q, t = torch.tensor([1.0, 0.0, 0.0, 0.0], device="cuda"), torch.zeros(3, device="cuda")
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        means, _ = transforms.transform_to_frame(means, rots, q, t, gaussians_grad=False,
                                                 camera_grad=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            torch.cuda.set_sync_debug_mode("warn")
            render_stream.compute_stream_binning(means, scales, rots, cam, rc, margin_px=4.0,
                                                 opacities=opac)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    assert len(syncs) == 2, [str(w.message) for w in syncs]
    assert kernels.launch_counts["bin_emit"] == 1
    assert binning.plain_counts["emit_pairs_plain"] == 0
