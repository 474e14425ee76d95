"""Parity of the port's SLAM layer with the JAX package on the CPU: SSIM,
Adam, the losses (with the MLP gate), the tracker, the densifier and the
ladder mapper, on the same numpy inputs.

Tolerances, with their reasons:

* SSIM, Adam, losses: 1e-5 relative — float32 convolutions and sums in
  another order;
* tracker: the 5-step loss trace to 1e-4 relative and the best pose to
  1e-5 — gradients differ in the last bits (product vs log-space
  transmittance), and Adam's normalized steps pass that on;
* mapper: loss traces to 1e-5 relative, Gaussian parameters to 1e-4
  after 5 steps.  With eps=1e-15 Adam steps by about ``lr * sign(g)``, so
  a gradient of pure rounding noise would move its parameter by a full
  step on either side: the start map is kept off the GT geometry so that
  no depth residual is exactly 0.  Rotations are not compared: on
  isotropic maps their gradient is rounding noise in JAX and exactly 0 in
  the port (ROADMAP.md, faults).

The JAX tracker and mapper run their Pallas blend in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierslam_torch.core import camera as tcam
from hierslam_torch.ops import rasterize as trast
from hierslam_torch.ops import ssim as tssim
from hierslam_torch.slam import losses as tloss
from hierslam_torch.slam import mapping as tmap
from hierslam_torch.slam import optim as topt
from hierslam_torch.slam import tracking as ttrk
from hierslam_tpu.core import camera as jcam
from hierslam_tpu.core import gaussians as JG
from hierslam_tpu.ops import ssim as jssim
from hierslam_tpu.ops.rasterize import RasterConfig as JRasterConfig
from hierslam_tpu.ops.rasterize import RenderOutput as JRenderOutput
from hierslam_tpu.slam import losses as jloss
from hierslam_tpu.slam import mapping as jmap
from hierslam_tpu.slam import optim as jopt
from hierslam_tpu.slam import tracking as jtrk

torch.set_num_threads(1)
H, W = 48, 64
RC = dict(max_per_tile=256, gaussian_chunk=64, tile_batch=4)


def t(x):
    return torch.as_tensor(np.array(x, np.float32))


def cameras():
    K = jcam.intrinsics_matrix(40.0, 40.0, W / 2, H / 2)
    return jcam.setup_camera(W, H, K, np.eye(4)), tcam.setup_camera(W, H, K, np.eye(4))


def synthetic_map(seed=0, n=400, num_semantic=0):
    """A wall + floor gaussian cloud in front of the camera (numpy)."""
    rng = np.random.default_rng(seed)
    h = n // 2
    wall = np.stack([rng.uniform(-1.5, 1.5, h), rng.uniform(-1.0, 1.0, h),
                     2.5 + 0.05 * rng.normal(size=h)], -1)
    floor = np.stack([rng.uniform(-1.5, 1.5, n - h), 1.0 + 0.02 * rng.normal(size=n - h),
                      rng.uniform(0.8, 2.5, n - h)], -1)
    p = {
        "means3D": np.concatenate([wall, floor]),
        "rgb_colors": rng.uniform(0, 1, (n, 3)),
        "unnorm_rotations": np.tile([1.0, 0, 0, 0], (n, 1)),
        "logit_opacities": np.full((n, 1), 4.0),
        "log_scales": np.full((n, 1), np.log(0.06)),
        "cam_unnorm_rots": np.tile(np.array([1.0, 0, 0, 0])[None, :, None], (1, 1, 4)),
        "cam_trans": np.zeros((1, 3, 4)),
    }
    if num_semantic:
        p["semantic"] = rng.uniform(0, 1, (n, num_semantic))
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def render_gt(pn, q, tr, jc):
    """GT frame from the JAX renderer, as numpy."""
    pj = {k: jnp.asarray(v) for k, v in pn.items()}
    out = jloss.render_gaussians(pj, jnp.ones(pn["means3D"].shape[0], bool), jnp.asarray(q),
                                 jnp.asarray(tr), jc, JRasterConfig(**RC),
                                 with_semantic=False, gaussians_grad=False, camera_grad=False)
    return np.asarray(out.im), np.asarray(out.depth)


def test_ssim_matches():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (3, 40, 52)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    sj = float(jssim.calc_ssim(jnp.asarray(a), jnp.asarray(b)))
    st = float(tssim.calc_ssim(t(a), t(b)))
    sr = float(tssim.calc_ssim(t(a), t(b), ref_stats=tssim.ssim_ref_stats(t(b))))
    np.testing.assert_allclose([st, sr], [sj, sj], rtol=1e-5)


@pytest.mark.parametrize("eps", [1e-8, 1e-15])
def test_adam_with_row_surgery_matches(eps):
    rng = np.random.default_rng(1)
    p0 = {"x": rng.normal(size=(7, 3)).astype(np.float32),
          "y": rng.normal(size=(7, 1)).astype(np.float32)}
    lrs = {"x": 1e-2, "y": 0.0}
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    pt = {k: t(v) for k, v in p0.items()}
    sj, st = jopt.adam_init(pj), topt.adam_init(pt)
    for i in range(5):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
        pj, sj = jopt.adam_step(pj, {k: jnp.asarray(v) for k, v in g.items()}, sj, lrs, eps=eps)
        pt, st = topt.adam_step(pt, {k: t(v) for k, v in g.items()}, st, lrs, eps=eps)
        if i == 2:
            rm = np.array([1, 0, 0, 1, 0, 0, 0], bool)
            sj = jopt.zero_moment_rows(sj, jnp.asarray(rm))
            st = topt.zero_moment_rows(st, torch.as_tensor(rm))
    for k in p0:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(st.nu[k].numpy(), np.asarray(sj.nu[k]), rtol=1e-5, atol=1e-9)
    assert st.count == int(sj.count)


@pytest.mark.parametrize("iter_idx", [13, 14])
def test_losses_and_mlp_gate_match(iter_idx):
    rng = np.random.default_rng(2)
    levels, leaf = (2, 3), 5
    S = sum(levels)
    im = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    dep = rng.uniform(0.5, 3, (H, W)).astype(np.float32)
    fo = rng.uniform(0.9, 1.0, (H, W)).astype(np.float32)
    sem = rng.normal(size=(S, H, W)).astype(np.float32)
    im_gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    d_gt = rng.uniform(0.5, 3, (H, W)).astype(np.float32)
    d_gt[:4] = 0.0
    labels = np.stack([rng.integers(0, 2, (H, W)), rng.integers(0, 3, (H, W)),
                       rng.integers(0, leaf, (H, W))]).astype(np.int32)
    mlp = {"w": rng.normal(size=(leaf, S)).astype(np.float32),
           "b": rng.normal(size=leaf).astype(np.float32)}
    cfg_kw = dict(use_sil_for_loss=False, sil_thres=0.5, w_im=0.5, w_depth=1.0, w_sem=0.2,
                  sem_levels=levels, num_leaf=leaf, use_mlp=True)

    def out_j(im_, sem_):
        return JRenderOutput(im=im_, radii=None, depth=jnp.asarray(dep), median_depth=None,
                             final_opacity=jnp.asarray(fo), mask=None, semantic=sem_,
                             n_dropped=None, tile_count=None)

    def f_j(im_, sem_, w_):
        loss, parts = jloss.mapping_loss(out_j(im_, sem_), jnp.asarray(im_gt), jnp.asarray(d_gt),
                                         jnp.asarray(labels), {"w": w_, "b": jnp.asarray(mlp["b"])},
                                         iter_idx, jloss.LossConfig(**cfg_kw))
        return loss, parts

    (lj, pj), gj = jax.value_and_grad(f_j, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(im), jnp.asarray(sem), jnp.asarray(mlp["w"]))
    im_t, sem_t, w_t = (t(x).requires_grad_(True) for x in (im, sem, mlp["w"]))
    out_t = trast.RenderOutput(im=im_t, radii=None, depth=t(dep), median_depth=None,
                               final_opacity=t(fo), mask=None, semantic=sem_t, n_dropped=None,
                               tile_count=None)
    lt, pt = tloss.mapping_loss(out_t, t(im_gt), t(d_gt), torch.as_tensor(labels),
                                {"w": w_t, "b": t(mlp["b"])}, iter_idx,
                                tloss.LossConfig(**cfg_kw))
    gt = torch.autograd.grad(lt, (im_t, sem_t, w_t), allow_unused=True)
    for k in ("loss", "depth", "im", "sem"):
        np.testing.assert_allclose(float(pt[k]), float(pj[k]), rtol=1e-5, err_msg=k)
    for a, b in zip(gt, gj):
        a = np.zeros(b.shape, np.float32) if a is None else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-7)
    # tracking loss on the same render (silhouette-gated sums)
    tcfg = dict(use_sil_for_loss=True, sil_thres=0.95)
    lj2, _ = jloss.tracking_loss(out_j(jnp.asarray(im), None), jnp.asarray(im_gt),
                                 jnp.asarray(d_gt), jloss.LossConfig(**tcfg))
    lt2, _ = tloss.tracking_loss(out_t, t(im_gt), t(d_gt), tloss.LossConfig(**tcfg))
    np.testing.assert_allclose(float(lt2), float(lj2), rtol=1e-5)
    x = rng.normal(size=(37, 11)).astype(np.float32)
    assert float(tloss.lower_median(t(x))) == float(jloss.lower_median(jnp.asarray(x)))


def test_tracker_matches():
    jc, tc = cameras()
    pn = synthetic_map(seed=0)
    q_gt = np.array([0.9999, 0.01, -0.02, 0.005], np.float32)
    t_gt = np.array([0.03, -0.02, 0.01], np.float32)
    im, dep = render_gt(pn, q_gt, t_gt, jc)
    cfg = dict(use_sil_for_loss=True, sil_thres=0.99, w_im=0.5, w_depth=1.0)
    n = pn["means3D"].shape[0]
    # up to 302 pairs a tile: the port's 256 slots are its least class, not a
    # cap, so the JAX tracker takes one class that holds every tile's pairs
    trk_j = jtrk.make_tracker(jc, jloss.LossConfig(**cfg),
                              JRasterConfig(**dict(RC, max_per_tile=512)), 4e-4, 2e-3, 5)
    pj, blj, mrj, trj, cj = trk_j({k: jnp.asarray(v) for k, v in pn.items()},
                                  jnp.ones(n, bool), jnp.zeros(n), jnp.asarray(im),
                                  jnp.asarray(dep), 1)
    trk_t = ttrk.make_tracker(tc, tloss.LossConfig(**cfg), trast.RasterConfig(**RC), 4e-4, 2e-3,
                              5, device="cpu")
    pt, blt, mrt, trt, ct = trk_t({k: t(v) for k, v in pn.items()}, torch.ones(n, dtype=bool),
                                  torch.zeros(n), t(im), t(dep), 1)
    for a, b in zip(trt, trj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)
    np.testing.assert_allclose(float(blt), float(blj), rtol=1e-4)
    np.testing.assert_allclose(pt["cam_trans"].numpy(), np.asarray(pj["cam_trans"]), atol=1e-5)
    np.testing.assert_allclose(pt["cam_unnorm_rots"].numpy(), np.asarray(pj["cam_unnorm_rots"]),
                               atol=1e-5)
    np.testing.assert_array_equal(mrt.numpy(), np.asarray(mrj))
    assert float(trt[0][-1]) < float(trt[0][0])
    # the depth-loss escape hatch: 5 more steps of the same Adam run
    pj2, blj2, _, trj2, _ = trk_j.continue_round(pj, jnp.ones(n, bool), jnp.asarray(im),
                                                 jnp.asarray(dep), 1, cj)
    pt2, blt2, _, trt2, ct2 = trk_t.continue_round(pt, torch.ones(n, dtype=bool), t(im),
                                                   t(dep), 1, ct)
    assert ct2[6] == 10
    np.testing.assert_allclose(trt2[0].numpy(), np.asarray(trj2[0]), rtol=1e-4)
    np.testing.assert_allclose(float(blt2), float(blj2), rtol=1e-4)
    np.testing.assert_allclose(pt2["cam_trans"].numpy(), np.asarray(pj2["cam_trans"]), atol=1e-5)


def test_densifier_matches():
    jc, tc = cameras()
    pn = synthetic_map(seed=1, n=300)
    keep = np.arange(300) % 3 != 0  # holes the densifier must fill
    cap = 4096
    pj = JG.empty_params(cap, 4)
    vj = JG.empty_variables(cap)
    fields = {k: jnp.asarray(pn[k][keep]) for k in JG.GAUSSIAN_KEYS if k in pn}
    pj, vj, _ = JG.insert_gaussians(pj, vj, fields, jnp.ones(int(keep.sum()), bool), 0.0)
    im, dep = render_gt(pn, np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32), jc)
    pj_np = {k: np.asarray(v) for k, v in pj.items()}
    vj_np = {k: np.asarray(v) for k, v in vj.items()}
    dens_j = jmap.make_densifier(jc, JRasterConfig(**RC), 0.5, 0)
    pj2, vj2, nj, oj, _ = dens_j(pj, vj, jnp.asarray(im), jnp.asarray(dep), jnp.asarray(0),
                                 jax.random.PRNGKey(0))
    from hierslam_torch.utils.convert import from_jax_numpy

    pt, vt, _, _ = from_jax_numpy(pj_np, vj_np)
    dens_t = tmap.make_densifier(tc, trast.RasterConfig(**RC), 0.5, 0, device="cpu")
    pt2, vt2, nt, ot, _ = dens_t(pt, vt, t(im), t(dep), 0)
    assert int(nt) == int(nj) > 0 and int(ot) == int(oj) == 0
    np.testing.assert_array_equal(vt2["active"].numpy(), np.asarray(vj2["active"]))
    for k in ("means3D", "rgb_colors", "logit_opacities", "log_scales", "unnorm_rotations"):
        np.testing.assert_allclose(pt2[k].numpy(), np.asarray(pj2[k]), atol=1e-5, err_msg=k)


def test_ladder_mapper_matches():
    jc, tc = cameras()
    levels, leaf = (2, 3), 4
    S = sum(levels)
    pn = synthetic_map(seed=2, n=400, num_semantic=S)
    rng = np.random.default_rng(3)
    ims, deps = [], []
    for q, tr in (([1.0, 0, 0, 0], [0, 0, 0]), ([0.9999, 0.0, 0.01, 0.0], [0.05, 0.0, 0.0])):
        im, dep = render_gt(pn, np.asarray(q, np.float32), np.asarray(tr, np.float32), jc)
        ims.append(im)
        deps.append(dep)
    labels = np.stack([np.stack([rng.integers(0, 2, (H, W)), rng.integers(0, 3, (H, W)),
                                 rng.integers(0, leaf, (H, W))]) for _ in range(2)])
    start = dict(pn)
    # off the GT geometry: a depth residual of exactly 0 would give |d - d_hat|
    # a gradient of pure rounding noise on both sides
    start["means3D"] = pn["means3D"] + 0.02 * rng.normal(size=(400, 3))
    start["rgb_colors"] = np.clip(pn["rgb_colors"] + 0.3 * rng.normal(size=(400, 3)), 0, 1)
    start["logit_opacities"] = pn["logit_opacities"].copy()
    start["logit_opacities"][:40] = -8.0  # pruned at iteration 0
    start["cam_trans"][0, :, 1] = [0.05, 0.0, 0.0]
    start["cam_unnorm_rots"][0, :, 1] = [0.9999, 0.0, 0.01, 0.0]
    start = {k: np.asarray(v, np.float32) for k, v in start.items()}
    variables = {k: np.array(v) for k, v in JG.empty_variables(400).items()}
    variables["active"][:] = True
    variables["n_active"] = np.asarray(400, np.int32)
    variables["scene_radius"] = np.asarray(3.0, np.float32)
    mlp = {"w": rng.uniform(-0.4, 0.4, (leaf, S)).astype(np.float32),
           "b": rng.uniform(-0.4, 0.4, leaf).astype(np.float32)}
    window = {"im": np.stack(ims), "depth": np.stack(deps), "labels": labels.astype(np.int16),
              "time_idx": np.array([0, 1], np.int32)}
    rand_idx = np.array([0, 1, 1, 0, 1], np.int32)
    lcfg = dict(use_sil_for_loss=False, sil_thres=0.5, w_im=0.5, w_depth=1.0, w_sem=0.2,
                sem_levels=levels, num_leaf=leaf, use_mlp=True, mlp_gate_iter=2)
    lrs = {"means3D": 1e-4, "rgb_colors": 2.5e-3, "unnorm_rotations": 1e-3,
           "logit_opacities": 0.05, "log_scales": 1e-3, "semantic": 0.05}
    rc = dict(RC, bucket_spec=((4, 512), (-1, 256)), sat_margin=2.0, sat_floor=32,
              visible_budget=1000)
    prune = dict(start_after=0, stop_after=20, prune_every=20)
    mapper_j = jmap.make_mapper(jc, jloss.LossConfig(**lcfg), JRasterConfig(**rc), lrs, 5,
                                jmap.PruneConfig(**prune))
    mlp_j = {k: jnp.asarray(v) for k, v in mlp.items()}
    pj, vj, mj, _, lj = mapper_j({k: jnp.asarray(v) for k, v in start.items()},
                                 {k: jnp.asarray(v) for k, v in variables.items()},
                                 {k: jnp.asarray(v) for k, v in window.items()},
                                 jnp.asarray(rand_idx), mlp_j, jopt.adam_init(mlp_j))
    from hierslam_torch.utils.convert import from_jax_numpy

    pt0, vt0, mt0, _ = from_jax_numpy(start, variables, mlp)
    mapper_t = tmap.make_mapper(tc, tloss.LossConfig(**lcfg), trast.RasterConfig(**rc), lrs, 5,
                                tmap.PruneConfig(**prune), device="cpu")
    win_t = {k: torch.as_tensor(v) for k, v in window.items()}
    pt, vt, mt, _, lt = mapper_t(pt0, vt0, win_t, rand_idx, mt0, topt.adam_init(mt0))
    for k in ("loss", "im", "depth", "sem"):
        np.testing.assert_allclose(lt[k].numpy(), np.asarray(lj[k]), rtol=1e-5, err_msg=k)
    assert float(lt["n_map_bin_dropped"].max()) == float(np.max(lj["n_map_bin_dropped"])) == 0
    np.testing.assert_array_equal(vt["active"].numpy(), np.asarray(vj["active"]))
    assert int((~vt["active"]).sum()) == 40
    for k in ("means3D", "rgb_colors", "logit_opacities", "log_scales", "semantic"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), atol=1e-4, err_msg=k)
    for k in mlp:
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]), atol=1e-4, err_msg=k)
    # the decoder moved: its gate (iteration 2 here) opened
    assert not np.allclose(mt["w"].numpy(), mlp["w"])
