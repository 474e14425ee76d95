"""The ladder blend at true tile ids, on the CPU.

Every capacity class of a render is blended at its own tiles' true pixels
(``render_pallas.blend_classes``: row b of a class's table is tile
``tile_ids[b]``) into buffers the classes share, which then hold the image
in tile order.  Here:

* a tall, narrow image rendered whole and as stitched strip cameras, one
  class over all its tiles, no pair dropped: the image to 1e-5 and depth
  to 1e-4, the tolerances ``tests/test_torch_parallel.py`` holds the
  tile-sharded render to.  A strip's screen y differs from the whole
  image's by a whole number of tiles, which float32 subtracts exactly, so
  with true tile coordinates the two agree to the bit.  (Blending a class
  on a grid one tile high, tile j at x = 16 j, put screen x at up to 16
  times the class's tile count, where float32 keeps fewer bits: the two
  renders then parted by up to 3.8e-3 at 64x1024);
* the plain K1/K2 (``render_xla.blend_table``, ``blend_bwd_plain``) with
  shuffled tile ids equal the identity order after the permutation, to the
  bit, and ``blend_classes`` over a partition equals the one-class blend;
* ``rasterize`` and ``render_tracked`` with a three-class ladder against
  the JAX package's (its plain blend, backend "xla"), at the tolerances of
  ``tests/test_torch_raster.py``: 2e-4 on the forward, 2e-3 relative +
  absolute on gradients;
* on the card only (marker ``cuda``): K1/K2 with tile ids against their
  plain versions, and a tile id past the buffers' rows, which the kernels
  skip.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import make_scene
from hierslam_torch.core import camera as tcam
from hierslam_torch.ops import rasterize as trast
from hierslam_torch.ops import render_pallas as tpal
from hierslam_torch.ops import render_tracked as ttrk
from hierslam_torch.ops import render_xla as txla
from hierslam_torch.slam.losses import render_gaussians
from hierslam_tpu.core import camera as jcam
from hierslam_tpu.ops import render_tracked as jtrk

jrast = sys.modules["hierslam_tpu.ops.rasterize"]

torch.set_num_threads(1)
TILE = (16, 16)
LADDER = ((3, 384), (5, 256), (-1, 128))   # three classes, tile ids out of order


def t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _wall(n, W, H, f, seed=0):
    """n isotropic gaussians spread over the view of an identity camera
    (focal f, W x H), 2-4 m away, screen sigmas of 0.3-1.2 px."""
    rng = np.random.default_rng(seed)
    u, v = rng.uniform(-8, W + 8, n), rng.uniform(-8, H + 8, n)
    z = rng.uniform(2.0, 4.0, n)
    params = {
        "means3D": np.stack([(u - W / 2) * z / f, (v - H / 2) * z / f, z], 1),
        "rgb_colors": rng.uniform(0, 1, (n, 3)),
        "unnorm_rotations": np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)),
        "logit_opacities": rng.uniform(-1, 2, (n, 1)),
        "log_scales": np.log(rng.uniform(0.3, 1.2, (n, 1)) * z[:, None] / f),
    }
    return {k: t(v) for k, v in params.items()}


@pytest.mark.parametrize("W,H,D", [(64, 1024, 4), (32, 2048, 8)])
def test_strips_match_whole_image(W, H, D):
    f = 40.0
    cam = tcam.setup_camera(W, H, np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]),
                            np.eye(4))
    # one class over all tiles; no gaussian's tiles are capped
    rc = trast.RasterConfig(max_per_tile=256, max_tiles_per_gaussian=256)
    params = _wall(2000, W, H, f)
    q, tr = torch.tensor([1.0, 0, 0, 0]), torch.zeros(3)
    kw = dict(with_semantic=False, gaussians_grad=False, camera_grad=False)
    whole = render_gaussians(params, None, q, tr, cam, rc, **kw)
    strip_h = H // D
    cam_s = tcam.strip_camera(cam, strip_h)
    strips = [render_gaussians(params, None, q, tr, cam_s, rc, pixel_offset_y=float(r * strip_h),
                               **kw) for r in range(D)]
    assert int(whole.n_dropped) == 0 and all(int(s.n_dropped) == 0 for s in strips)
    im = torch.cat([s.im for s in strips], 1)
    depth = torch.cat([s.depth for s in strips], 0)
    assert im.shape == whole.im.shape and float(whole.im.max()) > 0.1
    np.testing.assert_allclose(im.numpy(), whole.im.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(depth.numpy(), whole.depth.numpy(), atol=1e-4, rtol=0)


def _tables(seed, T, K, F, grid_x):
    """Per-tile screen tables [T, K, 7+F] (means around each tile,
    positive-definite conics, depth-sorted slots), ~85% of the slots live."""
    rng = np.random.default_rng(seed)
    tid = np.arange(T)
    xy = np.stack([(tid % grid_x * 16)[:, None] + rng.uniform(-6, 22, (T, K)),
                   (tid // grid_x * 16)[:, None] + rng.uniform(-6, 22, (T, K))], -1)
    a, c = rng.uniform(0.02, 0.4, (T, K)), rng.uniform(0.02, 0.4, (T, K))
    b = rng.uniform(-0.5, 0.5, (T, K)) * np.sqrt(a * c)
    table = np.concatenate([xy, np.stack([a, b, c], -1), rng.uniform(0.1, 0.95, (T, K, 1)),
                            np.sort(rng.uniform(0.5, 5.0, (T, K, 1)), 1),
                            rng.uniform(0, 1, (T, K, F))], -1)
    return t(table), torch.as_tensor(rng.uniform(size=(T, K)) > 0.15)


@pytest.mark.parametrize("F", [3, 29])
def test_plain_versions_take_tile_ids(F):
    T, gx = 20, 5
    table, ok = _tables(F, T, 48, F, gx)
    perm = torch.as_tensor(np.random.default_rng(F).permutation(T))
    ref = txla.blend_table(table, ok, gx, TILE)
    # the rows of a shuffled table, returned in its row order
    rows = txla.blend_table(table[perm], ok[perm], gx, TILE, tile_ids=perm)
    for a, b in zip(rows, ref):
        assert torch.equal(a, b[perm])
    # written to the shared buffers at the tile ids: the identity order again
    out = tuple(torch.full_like(x, float("nan")) for x in ref)
    assert txla.blend_table(table[perm], ok[perm], gx, TILE, tile_ids=perm, out=out) is out
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    g = torch.Generator().manual_seed(F)
    gacc, gft, gmed = (torch.randn(x.shape, generator=g) for x in ref)
    d_ref = tpal.blend_bwd_plain(table, ok, gacc, gft, gmed, gx, TILE)
    d_perm = tpal.blend_bwd_plain(table[perm], ok[perm], gacc, gft, gmed, gx, TILE, perm)
    assert torch.equal(d_perm, d_ref[perm])


def test_blend_classes_equal_one_class():
    T, gx, F = 24, 6, 4
    table, ok = _tables(7, T, 40, F, gx)
    ids = [torch.as_tensor(i) for i in np.split(np.random.default_rng(7).permutation(T), [3, 11])]
    leaf = table.clone().requires_grad_(True)
    acc, ft, med = tpal.blend_classes([leaf[i] for i in ids], [ok[i] for i in ids], ids, gx,
                                      TILE, T)
    g = torch.Generator().manual_seed(1)
    w = [torch.randn(x.shape, generator=g) for x in (acc, ft, med)]
    sum(((x * wx).sum() for x, wx in zip((acc, ft, med), w))).backward()
    one = table.clone().requires_grad_(True)
    ref = tpal.blend_tiles_pallas(one, ok, gx, TILE)
    sum(((x * wx).sum() for x, wx in zip(ref, w))).backward()
    for a, b in zip((acc, ft, med), ref):
        assert torch.equal(a, b)
    assert torch.equal(leaf.grad, one.grad)
    with pytest.raises(ValueError, match="partition"):
        tpal.blend_classes([table[:5]], [ok[:5]], [torch.arange(5)], gx, TILE, T)


def _cams(cam):
    K = jcam.intrinsics_matrix(cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    return (jcam.setup_camera(cam["W"], cam["H"], K, cam["w2c"]),
            tcam.setup_camera(cam["W"], cam["H"], K, cam["w2c"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_rasterize_ladder_matches_jax(seed):
    scene, cam = make_scene(n=120, seed=10 + seed, W=48, H=64, sem=3)
    jc, tc = _cams(cam)
    cfg_kw = dict(max_per_tile=128, bucket_spec=LADDER)
    jcfg = jrast.RasterConfig(**cfg_kw, backend="xla", gaussian_chunk=64, tile_batch=4)
    rots = scene["rotations"]
    arrs = [scene["means3D"], scene["colors"], scene["opacities"], scene["scales"][:, :1],
            scene["semantics"]]
    rng = np.random.default_rng(seed)
    w_im, w_d, w_s = (rng.normal(size=s).astype(np.float32)
                      for s in ((3, 64, 48), (64, 48), (3, 64, 48)))

    def loss_j(m, c, o, s, se):
        out = jrast.rasterize(m, c, o, jnp.tile(s, (1, 3)), jnp.asarray(rots, jnp.float32), jc,
                              semantics=se, config=jcfg)
        return (jnp.sum(out.im * w_im) + jnp.sum(out.depth * w_d) + jnp.sum(out.semantic * w_s)
                + jnp.sum(out.final_opacity * w_d) + jnp.sum(out.median_depth * w_d)), out

    (vj, oj), gj = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        *[jnp.asarray(a, jnp.float32) for a in arrs])
    leaves = [t(a).requires_grad_(True) for a in arrs]
    out = trast.rasterize(*leaves[:4], t(rots), tc, semantics=leaves[4],
                          config=trast.RasterConfig(**cfg_kw), device="cpu")
    vt = ((out.im * t(w_im)).sum() + (out.depth * t(w_d)).sum() + (out.semantic * t(w_s)).sum()
          + (out.final_opacity * t(w_d)).sum() + (out.median_depth * t(w_d)).sum())
    vt.backward()
    assert int(out.n_dropped) == int(oj.n_dropped)
    for f in ("im", "depth", "median_depth", "final_opacity", "mask", "semantic"):
        np.testing.assert_allclose(getattr(out, f).detach().numpy(), np.asarray(getattr(oj, f)),
                                   atol=2e-4, err_msg=f)
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
    for leaf, g in zip(leaves, gj):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), rtol=2e-3, atol=2e-3)


def test_render_tracked_ladder_matches_jax():
    scene, cam = make_scene(n=120, seed=12, W=48, H=64)
    jc, tc = _cams(cam)
    logit = np.log(scene["opacities"] / (1 - scene["opacities"]))[:, None]
    pn = {"means3D": scene["means3D"], "rgb_colors": scene["colors"],
          "unnorm_rotations": scene["rotations"], "logit_opacities": logit,
          "log_scales": np.log(scene["scales"][:, :1])}
    q0, t0 = np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32)
    q1 = np.array([0.999, 0.01, -0.008, 0.005], np.float32)
    t1 = np.array([0.01, -0.01, 0.02], np.float32)
    jcfg = jrast.RasterConfig(max_per_tile=128, bucket_spec=LADDER, backend="xla",
                              gaussian_chunk=64, tile_batch=4)
    tcfg = trast.RasterConfig(max_per_tile=128, bucket_spec=LADDER)
    cj = jtrk.build_track_cache({k: jnp.asarray(v, jnp.float32) for k, v in pn.items()}, None,
                                jnp.asarray(q0), jnp.asarray(t0), jc, jcfg, margin_px=12.0)
    ct = ttrk.build_track_cache({k: t(v) for k, v in pn.items()}, None, t(q0), t(t0), tc, tcfg,
                                margin_px=12.0)
    assert sum(int(i.shape[0]) for i in ct.tile_ids) == 12 and len(ct.tile_ids) == 3
    rng = np.random.default_rng(5)
    w_im, w_d = rng.normal(size=(3, 64, 48)).astype(np.float32), rng.normal(
        size=(64, 48)).astype(np.float32)

    def loss_j(q, tr):
        im, dep, med, fo, mask = jtrk.render_tracked(cj, q, tr, jc, jcfg)
        return jnp.sum(im * w_im) + jnp.sum(dep * w_d) + jnp.sum(fo * w_d) + jnp.sum(med * w_d)

    vj, (gqj, gtj) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1)))(
        jnp.asarray(q1), jnp.asarray(t1))
    q, tr = t(q1).requires_grad_(True), t(t1).requires_grad_(True)
    im, dep, med, fo, mask = ttrk.render_tracked(ct, q, tr, tc, tcfg)
    vt = (im * t(w_im)).sum() + (dep * t(w_d)).sum() + (fo * t(w_d)).sum() + (med * t(w_d)).sum()
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-4)
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(gqj), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(gtj), rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_kernels_take_tile_ids_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from hierslam_torch.ops import kernels

    T, gx = 24, 6
    table, ok = _tables(3, T, 256, 29, gx)
    perm = torch.as_tensor(np.random.default_rng(3).permutation(T))
    rows = perm[:10]                       # a class of 10 of the grid's 24 tiles
    tab, okc = table[rows].cuda(), ok[rows].cuda()
    ids = rows.to(torch.int32).cuda()
    acc, ft, med, last, mslot = kernels.blend_fwd(tab, okc, gx, TILE, ids, n_tiles=T)
    acc_p, ft_p, med_p = tpal.blend_fwd_plain(tab, okc, gx, TILE, ids)
    r = rows.cuda()
    torch.testing.assert_close(acc[r], acc_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(ft[r], ft_p, atol=1e-5, rtol=0)
    g = [torch.randn_like(x) for x in (acc, ft, med)]
    dt = kernels.blend_bwd(tab, okc, ft, last, mslot, *g, gx, TILE, ids)
    dp = tpal.blend_bwd_plain(tab, okc, *g, gx, TILE, ids)
    torch.testing.assert_close(dt, dp, atol=2e-3, rtol=2e-3)
    # a tile id past the buffers' rows writes nothing and gets no gradient
    bad = ids.clone()
    bad[0] = T
    out = tuple(torch.full_like(x, -7) for x in (acc, ft, med, last, mslot))
    kernels.blend_fwd(tab, okc, gx, TILE, bad, out)
    assert all(bool((x[r[0]] == -7).all()) for x in out)
    torch.testing.assert_close(out[0][r[1:]], acc[r[1:]], atol=0, rtol=0)
    dt = kernels.blend_bwd(tab, okc, ft, last, mslot, *g, gx, TILE, bad)
    assert bool((dt[0] == 0).all())
    torch.testing.assert_close(dt[1:], dp[1:], atol=2e-3, rtol=2e-3)
