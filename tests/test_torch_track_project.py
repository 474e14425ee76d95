"""The tracker's per-slot projection: kernels ``track_project_fwd`` and
``track_project_bwd`` (``csrc/track.cu``) against their plain version
(``ops/render_tracked.track_project_plain``).

On the CPU: the plain version against the composed PyTorch code it replaced
(:func:`composed_projection`: the projection of ``render_tracked`` with
``@`` products and ``full_proj`` as a tensor), isotropic and anisotropic,
on slots at z == 0, 0 < z < 0.2, det == 0, clamped txc/tyc, invalid ones,
and on a pose cache's slots with its empty slots; the render and its pose
gradient through the run blend (``render_pallas.blend_run``), empty
classes included, against the composed projection through the per-class
blend; the plain version's pose gradient through ``build_w2c`` against
central finite differences in float64.

On the card (marker ``cuda``, skipped here): the kernels against the plain
version on the same CUDA tensors -- a seeded three-class cache, and the
cache of a seeded 300k-gaussian map at the flagship's 1200x680 and tracking
raster config (the size of the ``slam_300k`` cell's caches) -- ``ok`` and
every table column equal to the bit, the pose gradient within a relative
tolerance, two launches of each kernel equal to the bit, and one launch of
each a ``render_tracked`` call and its backward with no plain call.  On the
card's machine: ``python3 -m pytest tests/test_torch_track_project.py -m
cuda --noconftest -p no:cacheprovider``.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from hierslam_torch.core import camera as tcam
from hierslam_torch.core import transforms
from hierslam_torch.ops import render_tracked
from hierslam_torch.ops.rasterize import RasterConfig
from hierslam_torch.ops.render_pallas import blend_classes
from hierslam_torch.ops.render_stream import make_scalars
from hierslam_torch.ops.render_xla import tiles_to_image

TILE = (16, 16)
# the pose the special slots are placed for: identity rotation, t = (0.25, -0.5, 0.5)
Q_ID = (1.0, 0.0, 0.0, 0.0)
T_ID = (0.25, -0.5, 0.5)


def composed_projection(run, q, t, camera, tile_shape, grid_x):
    """The per-slot projection as ``render_tracked`` composed it before the
    kernels: (table [S, 10], ok [S])."""
    H, W = camera.height, camera.width
    th, tw = tile_shape
    w2c = transforms.build_w2c(transforms.normalize(q), t)
    full = torch.as_tensor(np.asarray(camera.full_proj), dtype=torch.float32, device=q.device)
    fx, fy = camera.focal_x, camera.focal_y
    limx, limy = 1.3 * camera.tan_fovx, 1.3 * camera.tan_fovy
    rows = run.rows
    m = rows[:, 0:3] @ w2c[:3, :3].T + w2c[:3, 3]
    z = m[..., 2]
    in_front = z > 0.2
    p_hom = m @ full[:, :3].T + full[:, 3]
    p_w = 1.0 / (p_hom[..., 3] + 1e-7)
    x = ((p_hom[..., 0] * p_w + 1.0) * W - 1.0) * 0.5
    y = ((p_hom[..., 1] * p_w + 1.0) * H - 1.0) * 0.5
    safe_z = torch.where(z == 0, torch.ones_like(z), z)
    inv_z = 1.0 / safe_z
    txc = torch.clamp(m[..., 0] * inv_z, -limx, limx)
    tyc = torch.clamp(m[..., 1] * inv_z, -limy, limy)
    jxx, jyy = fx * inv_z, fy * inv_z
    jxz, jyz = -fx * txc * inv_z, -fy * tyc * inv_z
    if rows.shape[1] == 13:
        sc = rows[:, 7:13]
        Wm = w2c[:3, :3]
        t0 = [jxx * Wm[0, c] + jxz * Wm[2, c] for c in range(3)]
        t1 = [jyy * Wm[1, c] + jyz * Wm[2, c] for c in range(3)]
        S = [[sc[..., 0], sc[..., 1], sc[..., 2]],
             [sc[..., 1], sc[..., 3], sc[..., 4]],
             [sc[..., 2], sc[..., 4], sc[..., 5]]]
        a0 = [t0[0] * S[0][c] + t0[1] * S[1][c] + t0[2] * S[2][c] for c in range(3)]
        b1 = [t1[0] * S[0][c] + t1[1] * S[1][c] + t1[2] * S[2][c] for c in range(3)]
        c_xx = a0[0] * t0[0] + a0[1] * t0[1] + a0[2] * t0[2] + 0.3
        c_xy = a0[0] * t1[0] + a0[1] * t1[1] + a0[2] * t1[2]
        c_yy = b1[0] * t1[0] + b1[1] * t1[1] + b1[2] * t1[2] + 0.3
    else:
        s2 = rows[:, 7] * rows[:, 7]
        c_xx = s2 * (jxx * jxx + jxz * jxz) + 0.3
        c_xy = s2 * (jxz * jyz)
        c_yy = s2 * (jyy * jyy + jyz * jyz) + 0.3
    det = c_xx * c_yy - c_xy * c_xy
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c_yy * det_inv, -c_xy * det_inv, c_xx * det_inv], -1)
    with torch.no_grad():
        mid = 0.5 * (c_xx + c_yy)
        sq = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + sq, mid - sq)))
        xn, yn = x.detach(), y.detach()
        btx, bty = (run.tile % grid_x).float(), (run.tile // grid_x).float()
        rect_ok = ((btx >= torch.floor((xn - radius) / tw))
                   & (btx < torch.floor((xn + radius + tw - 1) / tw))
                   & (bty >= torch.floor((yn - radius) / th))
                   & (bty < torch.floor((yn + radius + th - 1) / th)))
        ok = run.valid & in_front & det_ok & rect_ok
    opa = torch.where(ok, rows[:, 6], torch.zeros_like(rows[:, 6]))
    return torch.cat([x[:, None], y[:, None], conic, opa[:, None], z[:, None], rows[:, 3:6]],
                     -1), ok


def small_camera(W=96, H=64, f=64.0):
    K = np.array([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1]], np.float32)
    return tcam.setup_camera(W, H, K, np.eye(4))


def special_slots(aniso, seed=0, n=600, camera=None, device="cpu"):
    """Seeded slots seen from pose (Q_ID, T_ID) by ``small_camera``:
    random gaussians in front, and among them slots at z == 0, at
    0 < z < 0.2, far outside the fov (clamped txc/tyc), invalid ones, and on
    the anisotropic path ones whose covariance makes det == 0 exactly."""
    camera = camera or small_camera()
    rng = np.random.default_rng(seed)
    W, H, f = camera.width, camera.height, camera.focal_x
    grid = RasterConfig(tile_shape=TILE).grid(H, W)
    z = rng.uniform(0.5, 4.0, n)
    u, v = rng.uniform(-8, W + 8, n), rng.uniform(-8, H + 8, n)
    cam = np.stack([(u - (W - 1) / 2) / f * z, (v - (H - 1) / 2) / f * z, z], 1)
    kinds = rng.integers(0, 8, n)
    cam[kinds == 1, 2] = 0.0                                         # z == 0
    cam[kinds == 2, 2] = rng.uniform(0.01, 0.19, int((kinds == 2).sum()))   # 0 < z < 0.2
    far = kinds == 3                                                 # clamped txc, tyc
    cam[far, 0] = cam[far, 2] * rng.choice([-3.0, 3.0], int(far.sum()))
    cam[far, 1] = cam[far, 2] * rng.choice([-4.0, 4.0], int(far.sum()))
    means = (cam - np.asarray(T_ID)).astype(np.float32)   # R = I: camera = world + t
    colors = rng.random((n, 3)).astype(np.float32)
    opac = rng.uniform(0.05, 1.0, (n, 1)).astype(np.float32)
    if aniso:
        A = rng.normal(0, 0.05, (n, 3, 3))
        cov = A @ A.transpose(0, 2, 1)
        shape = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].astype(np.float32)
        # det == 0: on the optical axis at z = 2 (J = diag(32, 32) at f = 64),
        # cov2d = [[0, 0], [0, c]] once 0.3 is added to -0.3
        sing = kinds == 4
        means[sing] = np.asarray([0.0, 0.0, 2.0], np.float32) - np.asarray(T_ID, np.float32)
        shape[sing] = np.asarray([np.float32(-0.3) / np.float32(1024.0), 0, 0, 0.01, 0, 0.01],
                                 np.float32)
    else:
        shape = np.exp(rng.uniform(np.log(0.005), np.log(0.2), (n, 1))).astype(np.float32)
    rows = np.concatenate([means, colors, opac, shape], 1)
    tile = rng.integers(0, grid[0] * grid[1], n)
    inside = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    own = (np.clip(v, 0, H - 1) // TILE[0]) * grid[1] + np.clip(u, 0, W - 1) // TILE[1]
    tile = np.where(inside & (rng.random(n) < 0.7), own, tile)   # most slots on their own tile
    valid = (kinds != 5)
    run = render_tracked.TrackSlots(
        rows=torch.as_tensor(rows, device=device), valid=torch.as_tensor(valid, device=device),
        tile=torch.as_tensor(tile.astype(np.int32), device=device))
    return run, camera, grid, kinds


def _pose(q, t, device="cpu", dtype=torch.float32):
    return (torch.tensor(q, dtype=dtype, device=device),
            torch.tensor(t, dtype=dtype, device=device))


def _scalars(q, t, camera):
    return make_scalars(transforms.build_w2c(transforms.normalize(q), t), camera)


@pytest.mark.parametrize("aniso", [False, True])
def test_plain_equals_composed_on_special_slots(aniso):
    run, camera, grid, kinds = special_slots(aniso, seed=1 + aniso)
    q, t = _pose(Q_ID, T_ID)
    ref, ref_ok = composed_projection(run, q, t, camera, TILE, grid[1])
    got, ok = render_tracked.track_project_plain(run.rows, run.valid, run.tile,
                                                 _scalars(q, t, camera), grid[1],
                                                 (camera.height, camera.width), TILE)
    assert torch.equal(ok, ref_ok)
    torch.testing.assert_close(got, ref, rtol=2e-6, atol=1e-6)
    # every kind of slot is there and the masks read what they should
    for k in range(6):
        assert (kinds == k).any(), k
    kinds = torch.as_tensor(kinds)
    assert not ok[kinds == 1].any() and not ok[kinds == 2].any() and not ok[kinds == 5].any()
    assert (got[kinds == 1, 6] == 0).all() and ok[kinds == 0].any()
    if aniso:   # det == 0 exactly: conic from det_inv = 1, not ok
        assert not ok[kinds == 4].any()
        torch.testing.assert_close(got[kinds == 4, 2:5], ref[kinds == 4, 2:5])
        assert (got[kinds == 4, 4] == 0).all()
    far = kinds == 3
    lim = 1.3 * camera.tan_fovx
    assert (run.rows[far, 0] + T_ID[0]).abs().gt(lim * (run.rows[far, 2] + T_ID[2])).all()


@pytest.mark.parametrize("aniso", [False, True])
def test_plain_equals_composed_at_a_rotated_pose(aniso):
    """Away from the axis-aligned pose (a rotation with every entry of R
    nonzero), the plain version's multiply-adds against the composed ``@``
    products: the same masks, the table to float rounding."""
    run, camera, grid, _ = special_slots(aniso, seed=11 + aniso, n=2000)
    q, t = _pose((0.98, 0.08, -0.12, 0.1), (0.3, -0.45, 0.6))
    ref, ref_ok = composed_projection(run, q, t, camera, TILE, grid[1])
    got, ok = render_tracked.track_project_plain(run.rows, run.valid, run.tile,
                                                 _scalars(q, t, camera), grid[1],
                                                 (camera.height, camera.width), TILE)
    assert int((ok != ref_ok).sum()) == 0 and int(ok.sum()) > 100
    live = ref_ok
    torch.testing.assert_close(got[live], ref[live], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("aniso", [False, True])
def test_plain_pose_gradient_against_finite_differences(aniso):
    """float64: the gradient of a fixed weighting of the table's
    pose-dependent columns (x, y, conic, z) through ``build_w2c`` against
    central differences in each of the 7 pose parameters."""
    run, camera, grid, kinds = special_slots(aniso, seed=21 + aniso)
    keep = torch.as_tensor((kinds == 0) | (kinds == 3))   # smooth: no z == 0, no det == 0
    rows = run.rows[keep].double()
    valid, tile = run.valid[keep], run.tile[keep]
    w = np.random.default_rng(3).normal(size=(rows.shape[0], 10))
    w[:, 5] = w[:, 7:] = 0.0                     # opacity and colour: no pose in them
    w = torch.as_tensor(w)
    consts = torch.as_tensor(np.concatenate([
        np.asarray(camera.full_proj, np.float64)[[0, 1, 3]].reshape(-1),
        [camera.focal_x, camera.focal_y, 1.3 * camera.tan_fovx, 1.3 * camera.tan_fovy]]))

    def loss(q, t):
        w2c = transforms.build_w2c(transforms.normalize(q), t)
        sc = torch.cat([w2c[:3, :3].reshape(-1), w2c[:3, 3], consts])
        table, _ = render_tracked.track_project_plain(rows, valid, tile, sc, grid[1],
                                                      (camera.height, camera.width), TILE)
        return (table * w).sum()

    q0, t0 = _pose((0.999, 0.02, -0.03, 0.025), (0.27, -0.52, 0.53), dtype=torch.float64)
    q, t = q0.clone().requires_grad_(True), t0.clone().requires_grad_(True)
    gq, gt = torch.autograd.grad(loss(q, t), (q, t))
    eps = 1e-5
    for g, base, other, first in ((gq, q0, t0, True), (gt, t0, q0, False)):
        for i in range(base.shape[0]):
            d = torch.zeros_like(base)
            d[i] = eps
            lo = loss(base - d, other) if first else loss(other, base - d)
            hi = loss(base + d, other) if first else loss(other, base + d)
            fd = float((hi - lo) / (2 * eps))
            assert abs(float(g[i]) - fd) <= 1e-5 * max(1.0, abs(fd)), (first, i, float(g[i]), fd)


def _seeded_params(n, seed, aniso, W=96, H=64, f=64.0):
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 4.0, n)
    x = (rng.uniform(0, W, n) - W / 2) / f * z * 1.1
    y = (rng.uniform(0, H, n) - H / 2) / f * z * 1.1
    # a dense clump in one corner, so that some tiles need larger classes
    m = rng.random(n) < 0.35
    x[m] = (rng.uniform(0, 20, int(m.sum())) - W / 2) / f * z[m]
    y[m] = (rng.uniform(0, 14, int(m.sum())) - H / 2) / f * z[m]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))   # noqa: E731
    return dict(
        means3D=t(np.stack([x, y, z], 1)),
        rgb_colors=t(rng.random((n, 3))),
        unnorm_rotations=t(rng.normal(size=(n, 4))),
        logit_opacities=t(rng.normal(1.0, 1.0, (n, 1))),
        log_scales=t(rng.uniform(np.log(0.01), np.log(0.08), (n, 3 if aniso else 1))),
    )


def _track_config(k=16):
    return RasterConfig(tile_shape=TILE, max_per_tile=k, bucket_spec=((-1, k),))


def _cache(aniso, seed, device="cpu", n=4000, k=16):
    params = {kk: v.to(device) for kk, v in _seeded_params(n, seed, aniso).items()}
    camera = small_camera()
    q0, t0 = _pose((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0), device)
    active = torch.rand(n, generator=torch.Generator().manual_seed(seed)).to(device) < 0.9
    cache = render_tracked.build_track_cache(params, active, q0, t0, camera, _track_config(k),
                                             margin_px=8.0)
    return cache, camera


def _render_composed(cache, q, t, camera, config):
    """``render_tracked`` as it was composed: the composed projection, then
    the per-class blend (one table a class, each a copy)."""
    H, W = camera.height, camera.width
    grid = config.grid(H, W)
    table, ok = composed_projection(cache.run, q, t, camera, config.tile_shape, grid[1])
    shapes = [tuple(v.shape) for v in cache.slot_valid]
    sizes = [n * k for n, k in shapes]
    tabs, oks, ids = [], [], []
    for tab, o, (n, k), i in zip(table.split(sizes), ok.split(sizes), shapes, cache.tile_ids):
        if n:
            tabs.append(tab.view(n, k, -1))
            oks.append(o.view(n, k))
            ids.append(i)
    acc, ft, med = (tiles_to_image(v, grid, config.tile_shape, H, W) for v in
                    blend_classes(tabs, oks, ids, grid[1], config.tile_shape, grid[0] * grid[1]))
    return acc[:3], acc[-2], med, 1.0 - ft, acc[-1]


@pytest.mark.parametrize("aniso", [False, True])
def test_render_tracked_against_the_composed_render(aniso):
    """A cache of several classes (one of them empty) with empty slots: the
    render and its pose gradient through the plain projection and the run
    blend against the composed projection and the per-class blend."""
    cache, camera = _cache(aniso, 31 + aniso)
    shapes = [tuple(v.shape) for v in cache.slot_valid]
    assert sum(1 for n, _ in shapes if n) >= 3, shapes
    assert any(n == 0 for n, _ in shapes), shapes
    assert not bool(cache.run.valid.all())                      # empty slots
    config = _track_config()
    wts = torch.as_tensor(np.random.default_rng(5).random((5, camera.height, camera.width)),
                          dtype=torch.float32)

    def go(fn):
        q, t = _pose((0.995, 0.03, -0.05, 0.02), (0.02, -0.01, 0.03))
        q.requires_grad_(True)
        t.requires_grad_(True)
        out = fn(cache, q, t, camera, config)
        loss = sum((o.reshape(-1, camera.height, camera.width) * w).sum()
                   for o, w in zip(out, wts))
        return out, torch.autograd.grad(loss, (q, t))

    n0 = render_tracked.plain_counts["track_project_plain"]
    out, (gq, gt) = go(render_tracked.render_tracked)
    assert render_tracked.plain_counts["track_project_plain"] == n0 + 1
    ref, (rq, rt) = go(_render_composed)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gq, rq, rtol=2e-3, atol=1e-3)
    torch.testing.assert_close(gt, rt, rtol=2e-3, atol=1e-3)
    assert float(out[4].detach().sum()) > 0


# ---------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from hierslam_torch.ops import kernels
    kernels.build()
    kernels.reset_launch_counts()
    render_tracked.plain_counts["track_project_plain"] = 0
    return kernels


def _bits(x):
    return x.contiguous().view(torch.int32) if x.is_floating_point() else x


def _flagship_cache(n=300_000, seed=2147484421):
    """The pose cache of a seeded ``n``-gaussian map in front of the
    flagship's 1200x680 camera (2 to 8 m, 1 to 10 cm), with the flagship's
    raster config as the tracker takes it (its one class of
    ``track_max_per_tile`` as the least of classes sized from the counts)."""
    import os

    from hierslam_torch.config import apply_defaults, load_config, raster_config
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rc = raster_config(apply_defaults(load_config(
        os.path.join(root, "configs", "replica", "hierslam_semantic_run.py"))))
    rc = replace(rc, sat_margin=max(rc.track_sat_margin, 0.0), max_per_tile=rc.track_max_per_tile,
                 bucket_spec=((-1, rc.track_max_per_tile),))
    rng = np.random.default_rng(seed)
    W, H, f = 1200, 680, 600.0
    z = rng.uniform(2.0, 8.0, n)
    x = (rng.uniform(0, W, n) - W / 2) / f * z * 1.1
    y = (rng.uniform(0, H, n) - H / 2) / f * z * 1.1
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")   # noqa: E731
    params = dict(means3D=t(np.stack([x, y, z], 1)), rgb_colors=t(rng.random((n, 3))),
                  unnorm_rotations=t(rng.normal(size=(n, 4))),
                  logit_opacities=t(rng.normal(1.5, 1.0, (n, 1))),
                  log_scales=t(rng.uniform(np.log(0.01), np.log(0.1), (n, 1))))
    K = np.array([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1]], np.float32)
    camera = tcam.setup_camera(W, H, K, np.eye(4))
    q0, t0 = _pose((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0), "cuda")
    cache = render_tracked.build_track_cache(params, None, q0, t0, camera, rc, margin_px=16.0)
    return cache, camera, rc


def _card_cases():
    return ["iso3", "aniso3", "flagship300k"]


def _card_case(name):
    if name == "flagship300k":
        return _flagship_cache()
    cache, camera = _cache(name.startswith("aniso"), 41, "cuda", n=20000, k=256)
    return cache, camera, _track_config(256)


# relative tolerance of the pose gradient, kernel against the plain
# version's autograd (both f32; the sums run in other orders)
GRAD_RTOL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", _card_cases())
def test_track_project_on_card(case):
    kernels = _card()
    cache, camera, config = _card_case(case)
    run = cache.run
    H, W = camera.height, camera.width
    grid = config.grid(H, W)
    if case != "flagship300k":
        assert sum(1 for v in cache.slot_valid if v.shape[0]) >= 3
    q, t = _pose((0.9995, 0.012, -0.02, 0.008), (0.01, -0.02, 0.015), "cuda")
    sc = _scalars(q, t, camera)
    args = (run.rows, run.valid, run.tile, sc, grid[1], (H, W), config.tile_shape)
    table, ok = kernels.track_project_fwd(*args)
    table2, ok2 = kernels.track_project_fwd(*args)
    plain, plain_ok = render_tracked.track_project_plain(*args)
    assert torch.equal(ok, plain_ok) and torch.equal(ok, ok2)
    for c in range(10):
        assert torch.equal(_bits(table[:, c]), _bits(plain[:, c])), c
    assert torch.equal(_bits(table), _bits(table2))
    assert int(ok.sum()) > 0

    # the backward on the render's own cotangent (K2's) and on a dense one
    gen = torch.Generator(device="cuda").manual_seed(7)
    dense = torch.randn(table.shape, generator=gen, device="cuda")
    q_, t_ = q.clone().requires_grad_(True), t.clone().requires_grad_(True)
    wts = [torch.rand(o.shape, generator=gen, device="cuda") for o in
           render_tracked.render_tracked(cache, q_, t_, camera, config)]
    kernels.reset_launch_counts()
    render_tracked.plain_counts["track_project_plain"] = 0
    out = render_tracked.render_tracked(cache, q_, t_, camera, config)
    loss = sum((o * w).sum() for o, w in zip(out, wts))
    gq, gt = torch.autograd.grad(loss, (q_, t_))
    n_cls = sum(1 for v in cache.slot_valid if v.shape[0])
    assert kernels.launch_counts == dict(
        kernels.launch_counts, track_project_fwd=1, track_project_bwd=1, blend_fwd=n_cls,
        blend_bwd=n_cls)
    assert render_tracked.plain_counts["track_project_plain"] == 0
    for cot in ("render", "dense"):
        if cot == "render":
            gtab = _k2_cotangent(cache, q, t, camera, config, wts)
        else:
            gtab = dense
        g1 = kernels.track_project_bwd(run.rows, gtab, sc, (H, W))
        g2 = kernels.track_project_bwd(run.rows, gtab, sc, (H, W))
        assert torch.equal(_bits(g1), _bits(g2)), cot
        assert (g1[12:] == 0).all()
        sc_ = sc.detach().clone().requires_grad_(True)
        ref = torch.autograd.grad(render_tracked.track_project_plain(
            run.rows, run.valid, run.tile, sc_, grid[1], (H, W), config.tile_shape)[0],
            sc_, gtab)[0]
        err = float((g1[:12] - ref[:12]).abs().max() / ref[:12].abs().max())
        print(f"[track_project {case}] {cot} cotangent: max |kernel - plain| / max |plain| "
              f"over the pose's 12 = {err:.3e}")
        assert err <= GRAD_RTOL, (cot, err)
    # the pose gradient of the render, kernel path against the plain projection
    with_plain = _plain_render_grad(cache, q, t, camera, config, wts)
    for a, b in zip((gq, gt), with_plain):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= GRAD_RTOL, err


def _k2_cotangent(cache, q, t, camera, config, wts):
    """The table's cotangent that K2 hands the projection in a render."""
    from hierslam_torch.ops.render_pallas import blend_run

    H, W = camera.height, camera.width
    grid = config.grid(H, W)
    table, ok = render_tracked.track_project(cache.run, _scalars(q, t, camera), grid[1], (H, W),
                                             config.tile_shape)
    table = table.detach().requires_grad_(True)
    acc, ft, med = (tiles_to_image(v, grid, config.tile_shape, H, W) for v in blend_run(
        table, ok, [tuple(v.shape) for v in cache.slot_valid], cache.tile_ids, grid[1],
        config.tile_shape, grid[0] * grid[1]))
    out = acc[:3], acc[-2], med, 1.0 - ft, acc[-1]
    return torch.autograd.grad(sum((o * w).sum() for o, w in zip(out, wts)), (table,))[0]


def _plain_render_grad(cache, q, t, camera, config, wts):
    """(gq, gt) of the render with the plain projection on the same CUDA
    tensors (the blend still K1/K2)."""
    kernel_path = render_tracked.track_project

    def plain(run, sc, grid_x, img_shape, tile_shape):
        return render_tracked.track_project_plain(run.rows, run.valid, run.tile, sc, grid_x,
                                                  img_shape, tile_shape)
    render_tracked.track_project = plain
    try:
        q_, t_ = q.clone().requires_grad_(True), t.clone().requires_grad_(True)
        out = render_tracked.render_tracked(cache, q_, t_, camera, config)
        loss = sum((o * w).sum() for o, w in zip(out, wts))
        return torch.autograd.grad(loss, (q_, t_))
    finally:
        render_tracked.track_project = kernel_path


@pytest.mark.cuda
def test_blend_run_backward_is_one_buffer_on_card():
    """K2 writes every class's cotangent into its part of one buffer: the
    run blend's table gradient equals the per-class blend's, concatenated,
    to the bit."""
    _card()
    cache, camera = _cache(False, 43, "cuda", n=20000, k=256)
    config = _track_config(256)
    H, W = camera.height, camera.width
    grid = config.grid(H, W)
    q, t = _pose((0.9995, 0.012, -0.02, 0.008), (0.01, -0.02, 0.015), "cuda")
    table, ok = render_tracked.track_project(cache.run, _scalars(q, t, camera), grid[1], (H, W),
                                             config.tile_shape)
    shapes = [tuple(v.shape) for v in cache.slot_valid]
    from hierslam_torch.ops.render_pallas import blend_run
    gen = torch.Generator(device="cuda").manual_seed(9)
    a = table.detach().requires_grad_(True)
    outs = blend_run(a, ok, shapes, cache.tile_ids, grid[1], TILE, grid[0] * grid[1])
    wts = [torch.rand(o.shape, generator=gen, device="cuda") for o in outs]
    (ga,) = torch.autograd.grad(sum((o * w).sum() for o, w in zip(outs, wts)), (a,))
    sizes = [n * k for n, k in shapes]
    parts = [p.detach().view(n, k, -1).requires_grad_(True)
             for p, (n, k) in zip(table.split(sizes), shapes) if n]
    oks = [o.view(n, k) for o, (n, k) in zip(ok.split(sizes), shapes) if n]
    ids = [i for i, (n, _) in zip(cache.tile_ids, shapes) if n]
    ref = blend_classes(parts, oks, ids, grid[1], TILE, grid[0] * grid[1])
    for x, y in zip(outs, ref):
        assert torch.equal(_bits(x), _bits(y))
    gref = torch.autograd.grad(sum((o * w).sum() for o, w in zip(ref, wts)), parts)
    assert torch.equal(_bits(ga), _bits(torch.cat([g.reshape(-1, 10) for g in gref])))
