"""Parity of the port's classic clone/split densification with the JAX
package on the CPU: ``accumulate_mean2d_gradient``, ``densify_step``, the
rasterizer's means2D gradient hook and a classic mapping phase.

Split children are drawn from a ``torch.Generator`` in the port and from
threefry in JAX, so each test hands the port JAX's draws (``noise=``),
made with the keys JAX's own functions split.  Tolerances, with their
reasons:

* ``densify_step``: every parameter, variable and Adam row to 1e-6 — the
  same float32 operations, an einsum in another order;
* the means2D gradient: 1e-5 of its largest component — the blend
  backward sums over pixels in another order;
* the mapping phase: equal clone and split sets (the active masks and
  ``n_active``), loss traces to 1e-5 relative and parameters to 1e-4,
  as ``tests/test_torch_slam.py`` holds the ladder mapper.

The JAX side runs its Pallas blend in interpret mode.  The mapping
fixture is ``tests/test_densify_classic.py``'s: a flat wall whose
gaussians tie in depth, so JAX's unstable argsort is handed the stable
order the port takes (``stable_argsort``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierslam_torch.core import camera as tcam
from hierslam_torch.ops import rasterize as trast
from hierslam_torch.slam import densify_classic as tdc
from hierslam_torch.slam import losses as tloss
from hierslam_torch.slam import mapping as tmap
from hierslam_torch.slam import optim as topt
from hierslam_torch.utils.convert import from_jax_numpy
from hierslam_tpu.core import camera as jcam
from hierslam_tpu.core import gaussians as JG
from hierslam_tpu.ops.rasterize import RasterConfig as JRasterConfig
from hierslam_tpu.ops.rasterize import rasterize as jrasterize
from hierslam_tpu.slam import densify_classic as jdc
from hierslam_tpu.slam import losses as jloss
from hierslam_tpu.slam import mapping as jmap
from hierslam_tpu.slam import optim as jopt

torch.set_num_threads(1)
RC = dict(max_per_tile=256, gaussian_chunk=64, tile_batch=4)


def t(x):
    return torch.as_tensor(np.array(x, np.float32))


def jax_split_draws(key, n, shape):
    """The ``n`` normal draws ``densify_step`` makes from ``key``."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape)))
    return out


@pytest.fixture
def stable_argsort(monkeypatch):
    """JAX's ``jnp.argsort(..., stable=False)`` returns the stable order."""
    real = jnp.argsort

    def argsort(a, axis=-1, *, kind=None, order=None, stable=True, descending=False):
        return real(a, axis=axis, stable=True, descending=descending)

    monkeypatch.setattr(jnp, "argsort", argsort)


def densify_state(seed, cap=192, n=48, aniso=False):
    """A map of ``n`` live gaussians in ``cap`` slots with accumulated
    means2D statistics (some above the threshold, small and large, some
    unseen), low-opacity and oversized rows, and Adam moments."""
    rng = np.random.default_rng(seed)
    s = 3 if aniso else 1
    params = {k: np.array(v) for k, v in JG.empty_params(cap, 2).items()}
    params["log_scales"] = np.zeros((cap, s), np.float32)
    q = rng.normal(size=(n, 4))
    params["means3D"][:n] = rng.normal(size=(n, 3))
    params["rgb_colors"][:n] = rng.uniform(0, 1, (n, 3))
    params["unnorm_rotations"][:n] = q
    params["logit_opacities"][:n] = rng.normal(1.0, 3.0, (n, 1))
    params["log_scales"][:n] = rng.uniform(np.log(0.001), np.log(0.5), (n, 1)) + rng.uniform(
        -0.3, 0.3, (n, s))
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    variables = {k: np.array(v) for k, v in JG.empty_variables(cap).items()}
    variables["active"][:n] = True
    variables["active"][rng.choice(n, 4, replace=False)] = False   # pruned earlier
    variables["n_active"] = np.asarray(n, np.int32)
    variables["timestep"][:n] = rng.integers(0, 5, n)
    variables["scene_radius"] = np.asarray(2.0, np.float32)
    variables["denom"][:n] = rng.integers(0, 4, n)
    variables["means2D_gradient_accum"][:n] = (
        rng.uniform(0, 6e-4, n) * variables["denom"][:n])
    variables["max_2D_radius"][:n] = rng.uniform(0, 9, n)
    gk = [k for k in JG.GAUSSIAN_KEYS if k in params]
    mu = {k: rng.normal(size=params[k].shape).astype(np.float32) for k in gk}
    nu = {k: rng.uniform(0, 1, params[k].shape).astype(np.float32) for k in gk}
    return params, variables, mu, nu


@pytest.mark.parametrize("iter_idx,n_split,aniso", [
    (20, 2, False),    # before remove_big_after
    (50, 2, False),    # the final threshold and the big-gaussian prune
    (30, 3, True),     # three children of anisotropic gaussians
])
def test_densify_step_matches_jax(iter_idx, n_split, aniso):
    params, variables, mu, nu = densify_state(iter_idx + n_split, aniso=aniso)
    cfg = dict(grad_thresh=2e-4, num_to_split_into=n_split, remove_big_after=30,
               stop_after=50, removal_opacity_threshold=0.05,
               final_removal_opacity_threshold=0.2)
    key = jax.random.PRNGKey(iter_idx)
    jstate = jopt.AdamState(mu={k: jnp.asarray(v) for k, v in mu.items()},
                            nu={k: jnp.asarray(v) for k, v in nu.items()},
                            count=jnp.asarray(3, jnp.int32))
    pj, vj, oj, over_j = jdc.densify_step(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in variables.items()}, jstate, iter_idx,
        jdc.DensifyConfig(**cfg), key)
    pt0, vt0, _, _ = from_jax_numpy(params, variables)
    tstate = topt.AdamState(mu={k: t(v) for k, v in mu.items()},
                            nu={k: t(v) for k, v in nu.items()}, count=3)
    noise = [t(x) for x in jax_split_draws(key, n_split, params["means3D"].shape)]
    pt, vt, ot, over_t = tdc.densify_step(pt0, vt0, tstate, iter_idx, tdc.DensifyConfig(**cfg),
                                          noise=noise)
    assert int(over_t) == int(over_j) == 0
    # the case does what it is for: clones, splits and prunes all happen
    grads = variables["means2D_gradient_accum"] / np.maximum(variables["denom"], 1e-12)
    dense = variables["active"] & (grads >= cfg["grad_thresh"])
    small = np.exp(params["log_scales"]).max(1) <= 0.01 * variables["scene_radius"]
    n_clone, n_split_rows = int((dense & small).sum()), int((dense & ~small).sum())
    assert n_clone > 0 and n_split_rows > 0
    assert int(vt["n_active"]) == 48 + n_clone + n_split * n_split_rows
    assert int((vt0["active"] & ~vt["active"]).sum()) > n_split_rows   # splits and prunes
    for k in pt:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    for k in vt:
        np.testing.assert_allclose(vt[k].numpy(), np.asarray(vj[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    for k in mu:
        np.testing.assert_allclose(ot.mu[k].numpy(), np.asarray(oj.mu[k]), atol=1e-6)
        np.testing.assert_allclose(ot.nu[k].numpy(), np.asarray(oj.nu[k]), atol=1e-6)
    assert ot.count == 3


def test_densify_step_draws_from_the_generator():
    """Without ``noise`` the children come from the generator: the same
    seed gives the same map, another seed other children."""
    params, variables, mu, nu = densify_state(7)
    pt0, vt0, _, _ = from_jax_numpy(params, variables)
    state = topt.AdamState(mu={k: t(v) for k, v in mu.items()},
                           nu={k: t(v) for k, v in nu.items()}, count=1)
    cfg = tdc.DensifyConfig(grad_thresh=2e-4)
    runs = [tdc.densify_step(pt0, vt0, state, 10, cfg, torch.Generator().manual_seed(s))[0]
            for s in (0, 0, 1)]
    np.testing.assert_array_equal(runs[0]["means3D"].numpy(), runs[1]["means3D"].numpy())
    assert not np.array_equal(runs[0]["means3D"].numpy(), runs[2]["means3D"].numpy())
    with pytest.raises(ValueError, match="noise tensors"):
        tdc.densify_step(pt0, vt0, state, 10, cfg, noise=[torch.zeros(192, 3)])


def test_accumulate_mean2d_gradient_matches_jax():
    rng = np.random.default_rng(3)
    n = 50
    variables = {k: np.array(v) for k, v in JG.empty_variables(n).items()}
    variables["means2D_gradient_accum"][:] = rng.uniform(0, 1e-3, n)
    variables["denom"][:] = rng.integers(0, 3, n)
    g = rng.normal(0, 1e-3, (n, 2)).astype(np.float32)
    seen = rng.uniform(size=n) > 0.3
    vj = jdc.accumulate_mean2d_gradient({k: jnp.asarray(v) for k, v in variables.items()},
                                        jnp.asarray(g), jnp.asarray(seen))
    _, vt0, _, _ = from_jax_numpy({}, variables)
    vt = tdc.accumulate_mean2d_gradient(vt0, t(g), torch.as_tensor(seen))
    for k in ("means2D_gradient_accum", "denom"):
        np.testing.assert_allclose(vt[k].numpy(), np.asarray(vj[k]), rtol=1e-6, err_msg=k)


def _hook_scene(seed, n=40, W=48, H=32):
    rng = np.random.default_rng(seed)
    return dict(
        means=np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.8, 0.8, n),
                        rng.uniform(2.0, 3.5, n)], -1).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        opac=rng.uniform(0.3, 0.95, n).astype(np.float32),
        scales=rng.uniform(0.03, 0.12, (n, 1)).astype(np.float32),
        rots=np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
        target=rng.uniform(0, 1, (3, H, W)).astype(np.float32),
    ), W, H


def test_means2d_hook_gradient_matches_jax():
    """dL/d means2D out of the blend backward's x/y columns, through the
    table assembly of a two-class ladder (each class shifted onto its own
    strip, the strips permuted back): nonzero and JAX's, in pixels."""
    sc, W, H = _hook_scene(4)
    K = jcam.intrinsics_matrix(36.0, 36.0, W / 2, H / 2)
    jc, tc = jcam.setup_camera(W, H, K, np.eye(4)), tcam.setup_camera(W, H, K, np.eye(4))
    rc = dict(RC, bucket_spec=((2, 128), (-1, 64)))
    n = sc["means"].shape[0]

    def loss_j(off):
        out = jrasterize(jnp.asarray(sc["means"]), jnp.asarray(sc["colors"]),
                         jnp.asarray(sc["opac"]), jnp.asarray(np.tile(sc["scales"], (1, 3))),
                         jnp.asarray(sc["rots"]), jc, config=JRasterConfig(**rc),
                         means2D_offset=off)
        return jnp.sum((out.im - sc["target"]) ** 2) + jnp.sum(out.depth)

    gj = np.asarray(jax.grad(loss_j)(jnp.zeros((n, 2))))
    off = torch.zeros((n, 2), requires_grad=True)
    out = trast.rasterize(t(sc["means"]), t(sc["colors"]), t(sc["opac"]), t(sc["scales"]),
                          t(sc["rots"]), tc, config=trast.RasterConfig(**rc),
                          means2D_offset=off, device="cpu")
    loss = torch.sum((out.im - t(sc["target"])) ** 2) + torch.sum(out.depth)
    (gt,) = torch.autograd.grad(loss, off)
    gt = gt.numpy()
    seen = out.radii.numpy() > 0
    assert seen.sum() > n // 2 and (np.abs(gt[seen]).sum(1) > 0).all()
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-5 * np.abs(gj).max())


def classic_fixture():
    """``tests/test_densify_classic.py``'s mapping fixture, as numpy, with
    every other gaussian small enough to be cloned and the start map moved
    off the GT wall."""
    key = jax.random.PRNGKey(5)
    n = 200
    k1, k2 = jax.random.split(key)
    gt = {
        "means3D": jnp.stack([jax.random.uniform(k1, (n,), minval=-1.2, maxval=1.2),
                              jax.random.uniform(k2, (n,), minval=-0.9, maxval=0.9),
                              2.5 + jnp.zeros((n,))], -1),
        "rgb_colors": jax.random.uniform(k2, (n, 3)),
        "unnorm_rotations": jnp.zeros((n, 4)).at[:, 0].set(1.0),
        "logit_opacities": jnp.full((n, 1), 4.0),
        # half at 0.025, under 0.01 of the scene radius: clones beside splits
        "log_scales": jnp.log(jnp.where(jnp.arange(n)[:, None] % 2 == 0, 0.08, 0.025)),
        "cam_unnorm_rots": jnp.zeros((1, 4, 2)).at[:, 0, :].set(1.0),
        "cam_trans": jnp.zeros((1, 3, 2)),
    }
    camera = jcam.setup_camera(64, 48, jcam.intrinsics_matrix(40.0, 40.0, 32.0, 24.0),
                               np.eye(4))
    out = jloss.render_gaussians(gt, jnp.ones((n,), bool), jnp.array([1.0, 0, 0, 0]),
                                 jnp.zeros(3), camera, JRasterConfig(**RC),
                                 with_semantic=False, gaussians_grad=False, camera_grad=False)
    cap = 4096
    params = JG.empty_params(cap, 2)
    variables = JG.empty_variables(cap)
    fields = {k: gt[k] for k in JG.GAUSSIAN_KEYS if k in gt}
    fields["rgb_colors"] = jnp.clip(fields["rgb_colors"] + 0.4 * jax.random.normal(k1, (n, 3)),
                                    0, 1)
    # off the GT geometry: a depth residual of exactly 0 would give |d - d_hat|
    # a gradient of pure rounding noise, which Adam at eps=1e-15 turns into a
    # full step either way (tests/test_torch_slam.py); this also unties the
    # wall's depths
    rng = np.random.default_rng(5)
    fields["means3D"] = fields["means3D"] + 0.02 * rng.normal(size=(n, 3)).astype(np.float32)
    params, variables, _ = JG.insert_gaussians(params, variables, fields, jnp.ones((n,), bool),
                                               0.0)
    variables["scene_radius"] = jnp.asarray(3.0)
    window = {"im": np.asarray(out.im)[None], "depth": np.asarray(out.depth)[None],
              "time_idx": np.zeros((1,), np.int32)}
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in variables.items()}, window)


def test_classic_mapping_phase_matches_jax(monkeypatch):
    params, variables, window = classic_fixture()
    K = jcam.intrinsics_matrix(40.0, 40.0, 32.0, 24.0)
    jc, tc = jcam.setup_camera(64, 48, K, np.eye(4)), tcam.setup_camera(64, 48, K, np.eye(4))
    lcfg = dict(use_sil_for_loss=False, sil_thres=0.5, w_im=0.5, w_depth=1.0)
    # rotations frozen: on an isotropic map their gradient is rounding noise
    # in JAX and 0 in the port (ROADMAP.md, faults), and the split children
    # are placed through R(q)
    lrs = {"means3D": 1e-4, "rgb_colors": 2.5e-3, "unnorm_rotations": 0.0,
           "logit_opacities": 0.05, "log_scales": 1e-3}
    # events at iterations 5 and 10; the threshold between the seen
    # gaussians' accumulated gradients, so each event clones and splits some
    dcfg = dict(start_after=2, stop_after=12, densify_every=5, grad_thresh=2e-4,
                num_to_split_into=2, remove_big_after=10**9)
    rc = dict(RC)
    n_it = 14
    key = jax.random.PRNGKey(7)
    mapper_j = jmap.make_mapper(jc, jloss.LossConfig(**lcfg), JRasterConfig(**rc), lrs, n_it,
                                jmap.PruneConfig(start_after=10**9),
                                densify_cfg=jdc.DensifyConfig(**dcfg))
    pj, vj, _, _, lj = mapper_j({k: jnp.asarray(v) for k, v in params.items()},
                                {k: jnp.asarray(v) for k, v in variables.items()},
                                {k: jnp.asarray(v) for k, v in window.items()},
                                jnp.zeros((n_it,), jnp.int32), None, None, key)
    # JAX's draws: one key per event, split from the phase's key
    noise, dkey = [], key
    for _ in tdc.DensifyConfig(**dcfg).events(n_it):
        dkey, sub = jax.random.split(dkey)
        noise.append([t(x) for x in jax_split_draws(sub, 2, params["means3D"].shape)])

    counts = []
    real_step = tmap.densify_step

    def counting(p, v, opt, it, cfg, generator=None, noise=None):
        out = real_step(p, v, opt, it, cfg, generator, noise)
        born = int(out[1]["n_active"] - v["n_active"])
        lost = int((v["active"] & ~out[1]["active"]).sum())
        counts.append((it, born, lost))
        return out

    monkeypatch.setattr(tmap, "densify_step", counting)
    pt0, vt0, _, _ = from_jax_numpy(params, variables)
    mapper_t = tmap.make_mapper(tc, tloss.LossConfig(**lcfg), trast.RasterConfig(**rc), lrs,
                                n_it, tmap.PruneConfig(start_after=10**9),
                                densify_cfg=tdc.DensifyConfig(**dcfg), device="cpu")
    pt, vt, _, _, lt = mapper_t(pt0, vt0, {k: torch.as_tensor(v) for k, v in window.items()},
                                np.zeros(n_it, np.int64), None, None, noise=noise)
    # both events cloned and split gaussians (born = clones + 2 splits,
    # lost = splits: nothing is pruned at opacity 0.98)
    assert [c[0] for c in counts] == [5, 10]
    assert all(born > 2 * lost > 0 for _, born, lost in counts), counts
    print("(iteration, clones + 2 splits, splits):", counts)
    assert int(vt["n_active"]) == int(vj["n_active"]) == 200 + sum(c[1] for c in counts)
    np.testing.assert_array_equal(vt["active"].numpy(), np.asarray(vj["active"]))
    np.testing.assert_array_equal(vt["timestep"].numpy(), np.asarray(vj["timestep"]))
    assert float(lt["classic_densify_overflow"][0]) == float(lj["classic_densify_overflow"][0])
    for k in ("loss", "im", "depth"):
        np.testing.assert_allclose(lt[k].numpy(), np.asarray(lj[k]), rtol=1e-5, err_msg=k)
    # the split children's means (JAX's draws) and everything else
    for k in ("means3D", "rgb_colors", "logit_opacities", "log_scales"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), atol=1e-4, err_msg=k)
    for k in ("means2D_gradient_accum", "denom", "max_2D_radius"):
        np.testing.assert_allclose(vt[k].numpy(), np.asarray(vj[k]), rtol=1e-4, atol=1e-9,
                                   err_msg=k)


def test_classic_mapper_rejects_what_jax_rejects():
    K = tcam.intrinsics_matrix(20.0, 20.0, 16.0, 12.0)
    tc = tcam.setup_camera(32, 24, K, np.eye(4))
    dcfg = tdc.DensifyConfig()
    for rc, msg in ((trast.RasterConfig(visible_budget=100), "visible_budget=0"),
                    (trast.RasterConfig(backend="stream"), "'pallas' or 'xla'")):
        with pytest.raises(ValueError, match=msg):
            tmap.make_mapper(tc, tloss.LossConfig(), rc, {}, 2, tmap.PruneConfig(),
                             densify_cfg=dcfg, device="cpu")
