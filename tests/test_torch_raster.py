"""Parity of the port's rasterizer with the JAX package on the CPU.

The JAX side runs its Pallas blend in interpret mode (its default on the
CPU), the port its plain versions (``render_xla.blend_table`` for K1, the
closed-form ``blend_bwd_plain`` for K2).  Tolerances:

* screen-space projection and the blend forward: 2e-4 absolute, the
  golden-model bound of the JAX package (README), for float32
  transmittance taken as a product here and in log space there;
* gradients: 2e-3 relative + absolute, the bound the JAX package holds
  its own Pallas VJP to against autodiff (tests/test_render_pallas.py),
  for sums over 256 pixels in another order;
* binning: exact (integer lists compared as sets per tile, counts equal).

The CUDA kernels themselves run only on the card: ``test_kernels_on_card``
compares them with the plain versions there and skips here.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import golden_render, make_scene
from hierslam_torch.core import camera as tcam
from hierslam_torch.ops import binning as tbin
from hierslam_torch.ops import projection as tproj
from hierslam_torch.ops import rasterize as trast
from hierslam_torch.ops import render_pallas as tpal
from hierslam_torch.ops import render_tracked as ttrk
from hierslam_torch.ops import render_xla as txla
from hierslam_torch.ops.gather_vjp import gather_rows as t_gather_rows
from hierslam_tpu.core import camera as jcam
from hierslam_tpu.ops import binning as jbin
from hierslam_tpu.ops import projection as jproj
from hierslam_tpu.ops import render_tracked as jtrk
from hierslam_tpu.ops.gather_vjp import build_inverse_map, gather_rows as j_gather_rows
from hierslam_tpu.ops.render_pallas import render_tiles_pallas as j_render_tiles_pallas

jrast = sys.modules["hierslam_tpu.ops.rasterize"]

torch.set_num_threads(1)
TILE = (16, 16)


def t(x):
    return torch.as_tensor(np.array(x, np.float32))


def cams(cam):
    K = jcam.intrinsics_matrix(cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    return (jcam.setup_camera(cam["W"], cam["H"], K, cam["w2c"]),
            tcam.setup_camera(cam["W"], cam["H"], K, cam["w2c"]))


def make_tables(seed=0, T=6, K=64, F=5, grid_x=3):
    """Per-tile screen tables: means around each tile, positive-definite
    conics, random opacity/depth/features, ~85% live slots."""
    rng = np.random.default_rng(seed)
    tid = np.arange(T)
    ox, oy = (tid % grid_x) * 16, (tid // grid_x) * 16
    xy = np.stack([ox[:, None] + rng.uniform(-6, 22, (T, K)),
                   oy[:, None] + rng.uniform(-6, 22, (T, K))], -1)
    a = rng.uniform(0.02, 0.4, (T, K))
    c = rng.uniform(0.02, 0.4, (T, K))
    b = rng.uniform(-0.5, 0.5, (T, K)) * np.sqrt(a * c)
    table = np.concatenate([xy, np.stack([a, b, c], -1), rng.uniform(0.1, 0.95, (T, K, 1)),
                            rng.uniform(0.5, 5.0, (T, K, 1)), rng.uniform(0, 1, (T, K, F))],
                           -1).astype(np.float32)
    return table, rng.uniform(size=(T, K)) > 0.15


@pytest.mark.parametrize("aniso", [False, True])
def test_projection_matches(aniso):
    scene, cam = make_scene(n=120, seed=4, W=40, H=24)
    jc, tc = cams(cam)
    scales = scene["scales"] if aniso else scene["scales"][:, :1]
    rots = scene["rotations"]
    pj = jproj.preprocess(jnp.asarray(scene["means3D"], jnp.float32),
                          jnp.asarray(np.broadcast_to(scales, (120, 3)), jnp.float32),
                          jnp.asarray(rots, jnp.float32), jc, TILE, radius_margin_px=3.0)
    pt = tproj.preprocess(t(scene["means3D"]), t(scales), t(rots), tc, TILE,
                          radius_margin_px=3.0)
    for f in ("xy", "depth", "conic"):
        np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)),
                                   rtol=2e-4, atol=2e-4, err_msg=f)
    for f in ("radius", "rect_min", "rect_max", "valid", "tiles_touched"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)),
                                      err_msg=f)


def _per_tile_sets(lists, vis_ids):
    out = {}
    for ids, idx in zip(lists.tile_ids, lists.idx):
        ids, idx = np.asarray(ids), np.asarray(idx)
        vis = None if vis_ids is None else np.asarray(vis_ids)
        for tid, row in zip(ids, idx):
            row = row[row >= 0]
            out[int(tid)] = tuple(sorted((vis[row] if vis is not None else row).tolist()))
    return out


WIDE = ((4, 1024), (-1, 512))   # wide enough that no class truncates
NARROW = ((3, 16), (-1, 8))     # caps below the need: classes truncate


# visible_budget 400 >= n: the visible-rank permutation without truncation
# (which gaussians a budget below n keeps depends on the unstable JAX
# argsort's tie order, so only the untruncated case can agree exactly).
# With truncating classes the counts still agree exactly: the drops depend
# on each tile's need, not on which of two tied tiles a class takes; the
# lists agree as sets wherever both put a tile in a class of the same cap.
@pytest.mark.parametrize("sat,vis,spec", [
    pytest.param(0.0, 0, WIDE, id="0.0-0"),
    pytest.param(2.0, 0, WIDE, id="2.0-0"),
    pytest.param(2.0, 400, WIDE, id="2.0-400"),
    pytest.param(2.0, 0, NARROW, id="2.0-0-truncating"),
])
def test_binning_matches(sat, vis, spec):
    scene, cam = make_scene(n=300, seed=5, W=64, H=48)
    jc, tc = cams(cam)
    s = scene["scales"][:, :1] * 2.0
    pj = jproj.preprocess(jnp.asarray(scene["means3D"], jnp.float32),
                          jnp.asarray(np.broadcast_to(s, (300, 3)), jnp.float32),
                          jnp.asarray(scene["rotations"], jnp.float32), jc, TILE)
    pt = tproj.preprocess(t(scene["means3D"]), t(s), None, tc, TILE)
    kw = dict(sat_margin=sat, sat_floor=8, visible_budget=vis)
    opa = np.full(300, 0.98, np.float32)  # opaque enough for tiles to saturate
    lj = jbin.bin_bucketed(pj.rect_min, pj.rect_max, pj.valid, pj.depth, (3, 4), spec, TILE,
                           xy=pj.xy, conic=pj.conic, opacity=jnp.asarray(opa), **kw)
    lt = tbin.bin_bucketed(pt.rect_min, pt.rect_max, pt.valid, pt.depth, (3, 4), spec, TILE,
                           xy=pt.xy, conic=pt.conic, opacity=t(opa), **kw)
    for f in ("count", "k_eff", "n_refs", "n_dropped", "n_sat_masked"):
        np.testing.assert_array_equal(getattr(lt, f).numpy(), np.asarray(getattr(lj, f)),
                                      err_msg=f)
    assert (int(lt.n_dropped) > 0) == (spec is NARROW)
    assert sat == 0.0 or int(lt.n_sat_masked) > 0
    st, sj = _per_tile_sets(lt, lt.vis_ids), _per_tile_sets(lj, lj.vis_ids)
    assert sorted(map(len, st.values())) == sorted(map(len, sj.values()))
    same = [k for k in st if len(st[k]) == len(sj[k])]
    assert len(same) >= len(st) // 2
    assert {k: st[k] for k in same} == {k: sj[k] for k in same}
    assert spec is NARROW or st == sj
    if vis:
        assert sorted(lt.vis_ids.tolist()) == sorted(np.asarray(lj.vis_ids).tolist())


def test_blend_forward_matches_pallas_interpret():
    table, ok = make_tables()
    shape = (32, 48)
    aj, fj, mj = j_render_tiles_pallas(jnp.asarray(table), jnp.asarray(ok), image_shape=shape,
                                       tile_shape=TILE, grid=(2, 3), interpret=True)
    at, ft, mt = tpal.render_tiles_pallas(t(table), torch.as_tensor(ok), image_shape=shape,
                                          tile_shape=TILE, grid=(2, 3))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=2e-4)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=2e-4)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=2e-4)


@pytest.mark.parametrize("seed,opaque", [(3, False), (5, True)])
def test_blend_backward_matches_pallas_vjp_and_autograd(seed, opaque):
    table, ok = make_tables(seed=seed, K=96)
    if opaque:  # drive the T < 1e-4 termination and the 0.99 clamp
        table[..., 5] = 0.995
    rng = np.random.default_rng(seed + 10)
    shape = (32, 48)
    ga = rng.normal(size=(7, 32, 48)).astype(np.float32)
    gf = rng.normal(size=shape).astype(np.float32)
    gm = rng.normal(size=shape).astype(np.float32)

    def loss_j(tb):
        a, f, m = j_render_tiles_pallas(tb, jnp.asarray(ok), image_shape=shape, tile_shape=TILE,
                                        grid=(2, 3), interpret=True)
        return jnp.sum(a * ga) + jnp.sum(f * gf) + jnp.sum(m * gm)

    gj = np.asarray(jax.grad(loss_j)(jnp.asarray(table)))
    tt = t(table).requires_grad_(True)
    a, f, m = tpal.render_tiles_pallas(tt, torch.as_tensor(ok), image_shape=shape,
                                       tile_shape=TILE, grid=(2, 3))
    ((a * t(ga)).sum() + (f * t(gf)).sum() + (m * t(gm)).sum()).backward()
    np.testing.assert_allclose(tt.grad.numpy(), gj, rtol=2e-3, atol=2e-3)
    # the closed form against autograd through the plain forward (float64)
    t64 = torch.as_tensor(table, dtype=torch.float64).requires_grad_(True)
    a, f, m = txla.blend_tiles(t64[..., :2], t64[..., 2:5], t64[..., 5], t64[..., 6],
                               t64[..., 7:], torch.as_tensor(ok), image_shape=shape,
                               tile_shape=TILE, grid=(2, 3))
    ((a * t(ga).double()).sum() + (f * t(gf).double()).sum()
     + (m * t(gm).double()).sum()).backward()
    np.testing.assert_allclose(tt.grad.numpy(), t64.grad.numpy(), rtol=2e-3, atol=2e-3)


def _scene_inputs(scene):
    return [t(scene["means3D"]), t(scene["colors"]), t(scene["opacities"]),
            t(scene["scales"][:, :1]), t(scene["rotations"])]


@pytest.mark.parametrize("sem,seed", [(0, 0), (0, 1), (6, 0), (6, 1)])
def test_rasterize_matches_golden(sem, seed):
    scene, cam = make_scene(n=80, seed=seed, W=40, H=24, sem=sem)
    ref = golden_render(scene["means3D"], scene["colors"], scene["opacities"],
                        scene["scales"], scene["rotations"], cam["w2c"], cam["full_proj"],
                        cam["fx"], cam["fy"], cam["tan_fovx"], cam["tan_fovy"], cam["W"],
                        cam["H"], semantics=scene["semantics"])
    _, tc = cams(cam)
    out = trast.rasterize(*_scene_inputs(scene), tc,
                          semantics=None if sem == 0 else t(scene["semantics"]),
                          config=trast.RasterConfig(max_per_tile=128), device="cpu")
    assert int(out.n_dropped) == 0
    np.testing.assert_allclose(out.im.numpy(), ref["im"], atol=2e-4)
    np.testing.assert_allclose(out.final_opacity.numpy(), ref["final_opacity"], atol=2e-4)
    np.testing.assert_allclose(out.mask.numpy(), ref["mask"], atol=2e-4)
    np.testing.assert_allclose(out.depth.numpy(), ref["depth"], atol=2e-4)
    np.testing.assert_allclose(out.median_depth.numpy(), ref["median_depth"], atol=2e-4)
    np.testing.assert_array_equal(out.radii.numpy(), ref["radii"])
    if sem:
        np.testing.assert_allclose(out.semantic.numpy(), ref["semantic"], atol=2e-4)


# The whole-rasterizer comparisons run the JAX side on its plain blend
# (backend "xla", the same math as its Pallas kernels, which the blend tests
# above hold in interpret mode): interpret-mode compiles would dominate.
def test_rasterize_forward_and_gradients_match_jax():
    scene, cam = make_scene(n=90, seed=2, W=48, H=32, sem=4)
    jc, tc = cams(cam)
    cfg_kw = dict(max_per_tile=128, bucket_spec=((2, 256), (-1, 128)), sat_margin=2.0,
                  sat_floor=16, grad_pair_budget=0)
    jcfg_kw = dict(cfg_kw, backend="xla", gaussian_chunk=64, tile_batch=4)
    names = ("means", "colors", "opac", "scales", "sem")
    arrs = [scene["means3D"], scene["colors"], scene["opacities"], scene["scales"][:, :1],
            scene["semantics"]]
    rng = np.random.default_rng(7)
    w_im = rng.normal(size=(3, 32, 48)).astype(np.float32)
    w_d = rng.normal(size=(32, 48)).astype(np.float32)
    w_s = rng.normal(size=(4, 32, 48)).astype(np.float32)
    rots = scene["rotations"]

    def loss_j(m, c, o, s, se):
        out = jrast.rasterize(m, c, o, jnp.tile(s, (1, 3)), jnp.asarray(rots, jnp.float32), jc,
                              semantics=se, config=jrast.RasterConfig(**jcfg_kw))
        val = (jnp.sum(out.im * w_im) + jnp.sum(out.depth * w_d) + jnp.sum(out.semantic * w_s)
               + jnp.sum(out.final_opacity * w_d) + jnp.sum(out.median_depth * w_d))
        return val, out

    (vj, oj), gj = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        *[jnp.asarray(a, jnp.float32) for a in arrs])
    leaves = [t(a).requires_grad_(True) for a in arrs]
    out = trast.rasterize(leaves[0], leaves[1], leaves[2], leaves[3], t(rots), tc,
                          semantics=leaves[4], config=trast.RasterConfig(**cfg_kw), device="cpu")
    vt = ((out.im * t(w_im)).sum() + (out.depth * t(w_d)).sum()
          + (out.semantic * t(w_s)).sum() + (out.final_opacity * t(w_d)).sum()
          + (out.median_depth * t(w_d)).sum())
    vt.backward()
    for f in ("im", "depth", "median_depth", "final_opacity", "mask", "semantic"):
        np.testing.assert_allclose(getattr(out, f).detach().numpy(), np.asarray(getattr(oj, f)),
                                   atol=2e-4, err_msg=f)
    assert int(out.n_dropped) == int(oj.n_dropped)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)
    for name, leaf, g in zip(names, leaves, gj):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), rtol=2e-3, atol=2e-3,
                                   err_msg=name)


def test_render_tracked_with_pose_gradients_matches_jax():
    scene, cam = make_scene(n=80, seed=3, W=40, H=24)
    jc, tc = cams(cam)
    logit = np.log(scene["opacities"] / (1 - scene["opacities"]))[:, None]
    pn = {"means3D": scene["means3D"], "rgb_colors": scene["colors"],
          "unnorm_rotations": scene["rotations"], "logit_opacities": logit,
          "log_scales": np.log(scene["scales"][:, :1])}
    pj = {k: jnp.asarray(v, jnp.float32) for k, v in pn.items()}
    pt = {k: t(v) for k, v in pn.items()}
    q0 = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    t0 = np.zeros(3, np.float32)
    q1 = np.array([0.999, 0.01, -0.008, 0.005], np.float32)
    t1 = np.array([0.01, -0.01, 0.02], np.float32)
    cfg = dict(max_per_tile=128)
    jcfg = jrast.RasterConfig(max_per_tile=128, backend="xla", gaussian_chunk=64, tile_batch=4)
    cj = jtrk.build_track_cache(pj, None, jnp.asarray(q0), jnp.asarray(t0), jc, jcfg,
                                margin_px=12.0)
    ct = ttrk.build_track_cache(pt, None, t(q0), t(t0), tc, trast.RasterConfig(**cfg),
                                margin_px=12.0)
    rng = np.random.default_rng(4)
    w_im = rng.normal(size=(3, 24, 40)).astype(np.float32)
    w_d = rng.normal(size=(24, 40)).astype(np.float32)

    def loss_j(q, tr):
        im, dep, med, fo, mask = jtrk.render_tracked(cj, q, tr, jc, jcfg)
        return jnp.sum(im * w_im) + jnp.sum(dep * w_d) + jnp.sum(fo * w_d)

    vj, (gqj, gtj) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1)))(
        jnp.asarray(q1), jnp.asarray(t1))
    q = t(q1).requires_grad_(True)
    tr = t(t1).requires_grad_(True)
    im, dep, med, fo, mask = ttrk.render_tracked(ct, q, tr, tc, trast.RasterConfig(**cfg))
    vt = (im * t(w_im)).sum() + (dep * t(w_d)).sum() + (fo * t(w_d)).sum()
    vt.backward()
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-4)
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(gqj), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(gtj), rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(ct.radii0.numpy(), np.asarray(cj.radii0))


@pytest.mark.parametrize("budget,bf16", [(0, False), (20, False), (20, True)])
def test_gather_rows_budget_matches_jax(budget, bf16):
    rng = np.random.default_rng(3)
    n, tt, k, c = 40, 12, 8, 5
    idx = rng.integers(-1, 12, size=(tt, k)).astype(np.int32)
    arr = rng.normal(size=(n, c)).astype(np.float32)
    cot = rng.normal(size=(tt, k, c)).astype(np.float32) * (idx >= 0)[:, :, None]
    inv = build_inverse_map(jnp.asarray(idx), n, 16)

    def fj(a):
        out = j_gather_rows(a, jnp.asarray(idx), inv.spos, inv.ends, inv.run_masks, 16, 4,
                            budget, bf16)
        return jnp.sum(out * cot)

    gj = np.asarray(jax.grad(fj)(jnp.asarray(arr)))
    a = t(arr).requires_grad_(True)
    (t_gather_rows(a, torch.as_tensor(idx).long(), 4, budget, bf16) * t(cot)).sum().backward()
    # bf16 rounds each cotangent to 8 bits: 1e-2 relative; float32 sums: 1e-5
    tol = 2e-2 if bf16 else 1e-5
    np.testing.assert_allclose(a.grad.numpy(), gj, rtol=tol, atol=tol)
    if budget:
        assert (a.grad.numpy()[:, :4] == 0).any()  # the budget truncated routes
    assert (a.grad.numpy()[:, 4:] == 0).all()


def test_rasterize_needs_cuda_unless_cpu():
    scene, cam = make_scene(n=10, seed=0, W=40, H=24)
    _, tc = cams(cam)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trast.rasterize(*_scene_inputs(scene), tc)


def test_kernel_library_name_follows_source_headers_and_flags(tmp_path, monkeypatch):
    """A kernel library is named by a hash of its source, of every header in
    csrc/ (blend.cu and stream.cu include reduce.cuh) and of its flags, so
    an edit to any of them builds a new library instead of loading a stale
    one.  Pure file hashing: runs without nvcc."""
    from hierslam_torch.ops import kernels

    for name in (*kernels.SOURCES, "reduce.cuh"):
        (tmp_path / name).write_bytes(open(os.path.join(kernels.CSRC, name), "rb").read())
    monkeypatch.setattr(kernels, "CSRC", str(tmp_path))
    before = {src: kernels.library_path(src) for src in kernels.SOURCES}
    assert before == {src: kernels.library_path(src) for src in kernels.SOURCES}
    (tmp_path / "reduce.cuh").write_text((tmp_path / "reduce.cuh").read_text() + "\n// edit\n")
    after = {src: kernels.library_path(src) for src in kernels.SOURCES}
    assert all(after[src] != before[src] for src in kernels.SOURCES)
    monkeypatch.setitem(kernels.SOURCES, "stream.cu", ())   # without -fmad=false
    assert kernels.library_path("stream.cu") != after["stream.cu"]


@pytest.mark.cuda
def test_kernels_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from hierslam_torch.ops import kernels

    table, ok = make_tables(seed=1, T=12, K=256, F=29, grid_x=4)
    tab = torch.as_tensor(table, device="cuda")
    okc = torch.as_tensor(ok, device="cuda")
    acc, ft, med, last, mslot = kernels.blend_fwd(tab, okc, 4, TILE)
    acc_p, ft_p, med_p = tpal.blend_fwd_plain(tab, okc, 4, TILE)
    torch.testing.assert_close(acc, acc_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(ft, ft_p, atol=1e-5, rtol=0)
    g = torch.randn_like(acc), torch.randn_like(ft), torch.randn_like(med)
    dt = kernels.blend_bwd(tab, okc, ft, last, mslot, *g, 4, TILE)
    dp = tpal.blend_bwd_plain(tab, okc, *g, 4, TILE)
    torch.testing.assert_close(dt, dp, atol=2e-3, rtol=2e-3)
