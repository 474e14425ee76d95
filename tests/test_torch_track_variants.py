"""Parity of the port's other tracking variants with the JAX package on the
CPU: the pose cache of an anisotropic map (its render and pose gradient)
and the tracker without the cache (``track_use_cache=False``), and both
options with classic densification through ``SLAMRunner``.

The anisotropic map is a wall + floor cloud with per-axis log-scale
offsets in ``[log 0.5, log 2]`` (as ``tests/test_render_cached.py`` makes
them) and random unit quaternions, from a numpy seed.  Tolerances, with
their reasons:

* the cache's world covariances: 1e-5 of the largest entry — float32
  products in another order;
* the cached render: 1e-5 per pixel, 1e-4 on depth — the same float32
  math, sums in another order;
* its pose gradient: 1e-4 of its largest component — the blend backward
  sums over pixels and slots in another order;
* the trackers: the 5-step loss trace to 1e-4 relative and the best pose
  to 1e-5, as ``tests/test_torch_slam.py`` holds the cached tracker.

The JAX side runs its Pallas blend in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabricate import fabricate_replica
from test_e2e import small_config

from hierslam_torch.core import camera as tcam
from hierslam_torch.ops import rasterize as trast
from hierslam_torch.ops import render_tracked as trt
from hierslam_torch.slam import losses as tloss
from hierslam_torch.slam import tracking as ttrk
from hierslam_tpu.core import camera as jcam
from hierslam_tpu.ops import render_tracked as jrt
from hierslam_tpu.ops.rasterize import RasterConfig as JRasterConfig
from hierslam_tpu.slam import losses as jloss
from hierslam_tpu.slam import tracking as jtrk

torch.set_num_threads(1)
H, W = 32, 48
RC = dict(max_per_tile=256, gaussian_chunk=64, tile_batch=4)


def t(x):
    return torch.as_tensor(np.array(x, np.float32))


def cameras():
    K = jcam.intrinsics_matrix(30.0, 30.0, W / 2, H / 2)
    return jcam.setup_camera(W, H, K, np.eye(4)), tcam.setup_camera(W, H, K, np.eye(4))


def scene(seed=0, n=240, aniso=True):
    """A wall + floor gaussian cloud in front of the camera (numpy)."""
    rng = np.random.default_rng(seed)
    h = n // 2
    wall = np.stack([rng.uniform(-1.5, 1.5, h), rng.uniform(-1.0, 1.0, h),
                     2.5 + 0.05 * rng.normal(size=h)], -1)
    floor = np.stack([rng.uniform(-1.5, 1.5, n - h), 1.0 + 0.02 * rng.normal(size=n - h),
                      rng.uniform(0.8, 2.5, n - h)], -1)
    log_s = np.full((n, 1), np.log(0.07))
    q = np.tile([1.0, 0, 0, 0], (n, 1))
    if aniso:
        log_s = log_s + rng.uniform(np.log(0.5), np.log(2.0), (n, 3))
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    p = {
        "means3D": np.concatenate([wall, floor]),
        "rgb_colors": rng.uniform(0, 1, (n, 3)),
        "unnorm_rotations": q,
        "logit_opacities": np.full((n, 1), 3.0),
        "log_scales": log_s,
        "cam_unnorm_rots": np.tile(np.array([1.0, 0, 0, 0])[None, :, None], (1, 1, 3)),
        "cam_trans": np.zeros((1, 3, 3)),
    }
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def gt_frame(pn, q, tr, jc):
    """The frame the JAX renderer makes of ``pn`` at (q, tr), as numpy."""
    pj = {k: jnp.asarray(v) for k, v in pn.items()}
    out = jloss.render_gaussians(pj, jnp.ones(pn["means3D"].shape[0], bool), jnp.asarray(q),
                                 jnp.asarray(tr), jc, JRasterConfig(**RC),
                                 with_semantic=False, gaussians_grad=False, camera_grad=False)
    return np.asarray(out.im), np.asarray(out.depth)


def test_anisotropic_track_cache_matches_jax():
    """The cache's world covariances and radii, its render at a moved pose
    and the pose gradient of a loss on that render."""
    jc, tc = cameras()
    pn = scene(seed=1)
    q0 = np.array([1.0, 0.01, -0.02, 0.005], np.float32)
    t0 = np.array([0.02, -0.01, 0.03], np.float32)
    q1 = q0 + np.array([0.0, 0.004, 0.003, -0.002], np.float32)
    t1 = t0 + np.array([0.01, 0.008, -0.012], np.float32)
    target = np.random.default_rng(1).uniform(0, 1, (3, H, W)).astype(np.float32)
    pj = {k: jnp.asarray(v) for k, v in pn.items()}
    cj = jrt.build_track_cache(pj, None, jnp.asarray(q0), jnp.asarray(t0), jc,
                               JRasterConfig(**RC), margin_px=12.0)
    ct = trt.build_track_cache({k: t(v) for k, v in pn.items()}, None, t(q0), t(t0), tc,
                               trast.RasterConfig(**RC), margin_px=12.0)
    # each class's world covariances: its part of the run's shape columns
    shapes = [tuple(v.shape) for v in ct.slot_valid]
    assert ct.run.rows.shape[1] == 13
    scale = [c.reshape(n, k, 6) for c, (n, k) in
             zip(ct.run.rows[:, 7:].split([n * k for n, k in shapes]), shapes)]
    for a, b in zip(scale, cj.scale):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())
    np.testing.assert_array_equal(ct.radii0.numpy(), np.asarray(cj.radii0))

    def loss_j(q, tr):
        im, dep, _, fo, _ = jrt.render_tracked(cj, q, tr, jc, JRasterConfig(**RC))
        return jnp.sum((im - target) ** 2) + jnp.sum(jnp.sin(dep)), (im, dep, fo)

    (_, (imj, depj, foj)), gj = jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True)(
        jnp.asarray(q1), jnp.asarray(t1))
    q, tr = t(q1).requires_grad_(True), t(t1).requires_grad_(True)
    im, dep, _, fo, _ = trt.render_tracked(ct, q, tr, tc, trast.RasterConfig(**RC))
    loss = torch.sum((im - t(target)) ** 2) + torch.sum(torch.sin(dep))
    gt = torch.autograd.grad(loss, (q, tr))
    assert float(fo.detach().max()) > 0.9   # the moved pose still sees the map
    np.testing.assert_allclose(im.detach().numpy(), np.asarray(imj), atol=1e-5)
    np.testing.assert_allclose(fo.detach().numpy(), np.asarray(foj), atol=1e-5)
    np.testing.assert_allclose(dep.detach().numpy(), np.asarray(depj), atol=1e-4)
    for a, b in zip(gt, gj):
        b = np.asarray(b)
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("use_cache,aniso", [(True, True), (False, True), (False, False)])
def test_tracker_variant_matches_jax(use_cache, aniso):
    jc, tc = cameras()
    pn = scene(seed=2, aniso=aniso)
    q_gt = np.array([0.9999, 0.01, -0.02, 0.005], np.float32)
    t_gt = np.array([0.03, -0.02, 0.01], np.float32)
    im, dep = gt_frame(pn, q_gt, t_gt, jc)
    cfg = dict(use_sil_for_loss=True, sil_thres=0.99, w_im=0.5, w_depth=1.0)
    n = pn["means3D"].shape[0]
    trk_j = jtrk.make_tracker(jc, jloss.LossConfig(**cfg), JRasterConfig(**RC), 4e-4, 2e-3, 5,
                              use_cache=use_cache)
    pj, blj, mrj, trj, _ = trk_j({k: jnp.asarray(v) for k, v in pn.items()}, jnp.ones(n, bool),
                                 jnp.zeros(n), jnp.asarray(im), jnp.asarray(dep), 1)
    trk_t = ttrk.make_tracker(tc, tloss.LossConfig(**cfg), trast.RasterConfig(**RC), 4e-4, 2e-3,
                              5, use_cache=use_cache, device="cpu")
    pt, blt, mrt, trt_, _ = trk_t({k: t(v) for k, v in pn.items()}, torch.ones(n, dtype=bool),
                                  torch.zeros(n), t(im), t(dep), 1)
    for a, b in zip(trt_, trj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)
    np.testing.assert_allclose(float(blt), float(blj), rtol=1e-4)
    np.testing.assert_allclose(pt["cam_trans"].numpy(), np.asarray(pj["cam_trans"]), atol=1e-5)
    np.testing.assert_allclose(pt["cam_unnorm_rots"].numpy(), np.asarray(pj["cam_unnorm_rots"]),
                               atol=1e-5)
    np.testing.assert_array_equal(mrt.numpy(), np.asarray(mrj))
    assert float(trt_[0][-1]) < float(trt_[0][0])


def test_runner_with_classic_densify_and_uncached_tracking(tmp_path):
    """``use_gaussian_splatting_densification`` and ``track_use_cache``
    reach the mapper and the tracker: 3 frames of a fabricated sequence,
    the mapping phases clone and split on their densify schedule."""
    from hierslam_torch.slam import mapping as tmap
    from hierslam_torch.slam.pipeline import SLAMRunner

    basedir, seq, _ = fabricate_replica(str(tmp_path / "data"), n_frames=3, W=32, H=24,
                                        semantic=False)
    cfg = small_config(basedir, seq, semantic=False, workdir=str(tmp_path / "w"))
    cfg["data"].update(desired_image_height=24, desired_image_width=32)
    cfg["data"]["camera_params"].update(image_height=24, image_width=32, cx=16.0, cy=12.0)
    cfg["tracking"].update(num_iters=4)
    cfg["mapping"].update(num_iters=8, use_gaussian_splatting_densification=True,
                          densify_dict=dict(start_after=1, densify_every=3, stop_after=7,
                                            grad_thresh=1e-6, remove_big_after=10**9))
    cfg["track_use_cache"] = False
    r = SLAMRunner(cfg, device="cpu")
    seen = []
    real = tmap.densify_step

    def recording(p, v, opt, it, *a, **kw):
        out = real(p, v, opt, it, *a, **kw)
        seen.append((it, int(out[1]["n_active"] - v["n_active"])))
        return out

    tmap.densify_step = recording
    try:
        for step in range(3):
            r.step(step)
    finally:
        tmap.densify_step = real
    # mapping at t=0 and t=1 (map_every=2), events at iterations 3 and 6
    assert [it for it, _ in seen] == [3, 6, 3, 6]
    assert all(born > 0 for _, born in seen)
    trace = r.last_mapping_trace
    assert np.isfinite(trace["loss"]).all() and trace["classic_densify_overflow"][0] == 0
    assert np.isfinite(r.last_tracking_trace["loss"]).all()

