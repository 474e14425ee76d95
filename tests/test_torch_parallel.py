"""The port's ``parallel/`` against the JAX package's on the CPU: the strip
camera and ``pixel_offset_y``, the tile-sharded render, the data-parallel
mapping step and the data-parallel mapper, at D = 4.

The port runs 4 ``gloo`` ranks on the CPU (one mesh for the module), the
JAX package its ``shard_map`` over 4 of the 8 virtual CPU devices that
``tests/conftest.py`` sets up, with ``backend="xla"`` (its Pallas blend's
math, without the interpreter's cost).

Tolerances, with their reasons:

* projection rows at a strip's offset: 1e-5 (float32, another order);
  the binned lists exactly;
* the tile-sharded render: 1e-5 on the image, 1e-4 on depth, as
  ``tests/test_parallel.py`` holds JAX's against its single render (a
  strip moves the screen y by a whole number of tiles, which rounds the
  Gaussian's exponent apart in the last bits);
* the step and the mapper: loss parts to 5e-4 relative, ``means3D`` and
  ``rgb_colors`` to 3e-4, as ``tests/test_parallel.py`` holds JAX's DP
  mapper against its single one (the D-way mean sums in another order on
  each side, and Adam carries that on); rotations are not compared: on an
  isotropic map their gradient is rounding noise in JAX and exactly 0 in
  the port (ROADMAP.md section 3);
* ``max_2D_radius``, the ranks' max of integer radii: exactly.
"""
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierslam_torch.core.camera import setup_camera as t_setup_camera
from hierslam_torch.core.camera import strip_camera as t_strip_camera
from hierslam_torch.ops import projection as tproj
from hierslam_torch.ops.rasterize import RasterConfig
from hierslam_torch.ops.rasterize import compute_binning as t_compute_binning
from hierslam_torch.parallel import (make_dp_mapper, make_dp_mapping_step, make_mesh,
                                     make_tile_sharded_render)
from hierslam_torch.parallel.mesh import tensors_of
from hierslam_torch.slam import optim as topt
from hierslam_torch.slam.losses import LossConfig, render_gaussians
from hierslam_torch.slam.mapping import PruneConfig, make_mapper
from hierslam_torch.utils.convert import from_jax_numpy
from hierslam_tpu import parallel as jpar
from hierslam_tpu.core.camera import intrinsics_matrix
from hierslam_tpu.core.camera import setup_camera as j_setup_camera
from hierslam_tpu.core.camera import strip_camera as j_strip_camera
from hierslam_tpu.ops import projection as jproj
from hierslam_tpu.ops.rasterize import RasterConfig as JRasterConfig
from hierslam_tpu.ops.rasterize import compute_binning as j_compute_binning
from hierslam_tpu.slam import losses as jloss
from hierslam_tpu.slam import optim as jopt
from hierslam_tpu.slam.mapping import PruneConfig as JPruneConfig

from test_parallel import _mapper_fixture
from test_slam_steps import _synthetic_map

torch.set_num_threads(1)
D = 4
RC = dict(max_per_tile=256, gaussian_chunk=64, tile_batch=4)
LOSS = dict(use_sil_for_loss=False, sil_thres=0.5, w_im=0.5, w_depth=1.0)
LRS = dict(means3D=1e-4, rgb_colors=2.5e-3, unnorm_rotations=1e-3, logit_opacities=0.05,
           log_scales=1e-3)
COMPARED = ("means3D", "rgb_colors")


@pytest.fixture(scope="module")
def mesh():
    m = make_mesh(D, devices="cpu", timeout=120)
    yield m
    m.close()
    assert not multiprocessing.active_children()


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_mesh(D)


def cameras(W=64, H=48):
    K = intrinsics_matrix(40.0, 40.0, W / 2, H / 2)
    return j_setup_camera(W, H, K, np.eye(4)), t_setup_camera(W, H, K, np.eye(4))


def scene_np(seed=0):
    return {k: np.array(v) for k, v in _synthetic_map(jax.random.PRNGKey(seed)).items()}


def test_strip_projection_and_binning_match_jax():
    jc, tc = cameras()
    pn = scene_np(1)
    js, ts = j_strip_camera(jc, 16), t_strip_camera(tc, 16)
    assert (ts.height, ts.proj_height, ts.width) == (js.height, js.proj_height, js.width) == (
        16, 48, 64)
    scales = np.exp(pn["log_scales"])
    args_j = (jnp.asarray(pn["means3D"]), jnp.asarray(scales), jnp.asarray(pn["unnorm_rotations"]))
    args_t = tuple(torch.tensor(a) for a in (pn["means3D"], scales, pn["unnorm_rotations"]))
    pj = jproj.preprocess_cols(*args_j, js, (16, 16), pixel_offset_y=16.0)
    pt = tproj.preprocess_cols(*args_t, ts, (16, 16), pixel_offset_y=16.0)
    for name in pt._fields:
        a, b = getattr(pt, name).numpy(), np.asarray(getattr(pj, name))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    # the strip sees the middle tile row only: some gaussians fall outside
    assert 0 < int(pt.valid.sum()) < pn["means3D"].shape[0]
    bj = j_compute_binning(*args_j, js, JRasterConfig(**RC), pixel_offset_y=16.0).lists
    bt = t_compute_binning(*args_t, ts, RasterConfig(**RC), pixel_offset_y=16.0).lists

    def per_tile(lists):
        return {int(t): [int(i) for i in row if i >= 0]
                for ids, idx in zip(lists.tile_ids, lists.idx)
                for t, row in zip(np.asarray(ids), np.asarray(idx))}

    assert per_tile(bt) == per_tile(bj)
    assert sum(map(len, per_tile(bt).values())) > 0


def _render_params(pn):
    return {k: torch.as_tensor(pn[k]) for k in ("means3D", "rgb_colors", "unnorm_rotations",
                                                 "logit_opacities", "log_scales")}


def _single(params, tc):
    out = render_gaussians(params, None, torch.tensor([1.0, 0, 0, 0]), torch.zeros(3), tc,
                           RasterConfig(**RC), with_semantic=False, gaussians_grad=False,
                           camera_grad=False)
    return out.im, out.depth


def test_tile_sharded_render_matches_jax_and_single(mesh, jmesh):
    jc, tc = cameras()
    pn = scene_np(0)
    jr = jpar.make_tile_sharded_render(jmesh, jc, JRasterConfig(**RC, backend="xla"))
    im_j, d_j = jr({k: jnp.asarray(v) for k, v in pn.items()})
    im, d = make_tile_sharded_render(mesh, tc, RasterConfig(**RC))(_render_params(pn))
    assert im.shape == (3, 48, 64) and d.shape == (48, 64)
    np.testing.assert_allclose(im.numpy(), np.asarray(im_j), atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), atol=1e-4)
    im_s, d_s = _single(_render_params(pn), tc)
    np.testing.assert_allclose(im.numpy(), im_s.numpy(), atol=1e-5)
    np.testing.assert_allclose(d.numpy(), d_s.numpy(), atol=1e-4)
    assert float(im.max()) > 0.1


def test_tile_sharded_render_crops_the_last_strip(mesh):
    """H = 56: 4 tile rows, strips of 16 rows, the last one running 8 rows
    past the image."""
    _, tc = cameras(H=56)
    params = _render_params(scene_np(0))
    im, d = make_tile_sharded_render(mesh, tc, RasterConfig(**RC))(params)
    im_s, d_s = _single(params, tc)
    assert im.shape == (3, 56, 64) and d.shape == (56, 64)
    np.testing.assert_allclose(im.numpy(), im_s.numpy(), atol=1e-5)
    np.testing.assert_allclose(d.numpy(), d_s.numpy(), atol=1e-4)
    assert float(im[:, 48:].max()) > 0.1          # the last strip's rows inside the image


def test_dp_mapping_step_matches_jax(mesh, jmesh):
    """3 steps on one batch of D frames at distinct poses."""
    jc, tc = cameras()
    gt = scene_np(1)
    rng = np.random.default_rng(2)
    n = gt["means3D"].shape[0]
    ims, deps = render_frames(gt, jc)
    batch = {"im": ims, "depth": deps, "quat": POSES[0], "trans": POSES[1]}
    start = dict(gt)
    # off the GT geometry: a residual of exactly 0 has a gradient of rounding noise
    start["means3D"] = gt["means3D"] + np.float32(0.02) * rng.normal(size=(n, 3)).astype(
        np.float32)
    start["rgb_colors"] = np.clip(gt["rgb_colors"] + 0.3 * rng.normal(size=(n, 3)), 0,
                                  1).astype(np.float32)
    gkeys = ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales")
    loss_j = jloss.LossConfig(**LOSS)
    step_j = jpar.make_dp_mapping_step(jmesh, jc, loss_j, JRasterConfig(**RC, backend="xla"),
                                       LRS)
    pj = {k: jnp.asarray(v) for k, v in start.items()}
    oj = jopt.adam_init({k: pj[k] for k in gkeys})
    vj = {"active": jnp.ones((n,), bool)}
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    step_t = make_dp_mapping_step(mesh, tc, LossConfig(**LOSS), RasterConfig(**RC), LRS)
    pt = {k: torch.as_tensor(v) for k, v in start.items()}
    ot = topt.adam_init({k: pt[k] for k in gkeys})
    vt = {"active": torch.ones(n, dtype=torch.bool)}
    bt = {k: torch.as_tensor(v) for k, v in batch.items()}
    lj, lt = [], []
    for it in range(3):
        pj, oj, _, _, loss = step_j(pj, vj, bj, oj, None, None, it)
        lj.append(float(loss))
        pt, ot, _, _, loss = step_t(pt, vt, bt, ot, None, None, it)
        lt.append(float(loss))
    np.testing.assert_allclose(lt, lj, rtol=5e-4)
    assert lt[-1] < lt[0]
    for k in COMPARED + ("logit_opacities", "log_scales"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), atol=3e-4, err_msg=k)
    assert ot.count == 3


POSES = (np.array([[1.0, 0, 0, 0], [0.9999, 0.0, 0.01, 0.0], [0.9999, 0.01, 0.0, 0.0],
                   [0.9998, 0.0, -0.015, 0.01]], np.float32),
         np.array([[0, 0, 0], [0.05, 0, 0], [0, 0.04, 0], [-0.03, 0.02, 0.05]], np.float32))


def render_frames(gt, jc):
    """The map ``gt`` (numpy) rendered by JAX at each of ``POSES``."""
    ims, deps = [], []
    for q, tr in zip(*POSES):
        out = jloss.render_gaussians({k: jnp.asarray(v) for k, v in gt.items()}, None,
                                     jnp.asarray(q), jnp.asarray(tr), jc,
                                     JRasterConfig(**RC, backend="xla"), with_semantic=False,
                                     gaussians_grad=False, camera_grad=False)
        ims.append(np.clip(np.asarray(out.im), 0, 1))
        deps.append(np.asarray(out.depth))
    return np.stack(ims), np.stack(deps)


@pytest.fixture(scope="module")
def dp_runs(mesh, jmesh):
    """JAX's and the port's DP mapper at D = 4 with distinct columns on
    ``tests/test_parallel.py``'s mapper state (its map in a 1,024-slot
    capacity, its perturbed colours), with two changes: its four window
    frames, all one image there, are rendered at the four distinct
    ``POSES``, so that the columns differ; and the means are moved 2 cm
    off the geometry, since a residual of exactly 0 has a gradient of
    rounding noise, whose sign Adam (eps 1e-15) turns into a full step on
    either side.  Measured on that state as it stands, the two frameworks'
    single mappers part by 3e-3 in the loss at the third iteration."""
    jc, params, variables, window = _mapper_fixture()
    tc = cameras()[1]
    gt = scene_np(3)                                  # the fixture's map
    n = gt["means3D"].shape[0]
    ims, deps = render_frames(gt, jc)
    window = dict(window, im=jnp.asarray(ims), depth=jnp.asarray(deps))
    params = dict(params)
    params["cam_unnorm_rots"] = jnp.asarray(POSES[0].T[None])
    params["cam_trans"] = jnp.asarray(POSES[1].T[None])
    noise = 0.02 * np.random.default_rng(5).normal(size=(n, 3))
    params["means3D"] = params["means3D"].at[:n].add(jnp.asarray(noise, jnp.float32))
    iters = 6
    idx = np.random.default_rng(1).integers(0, 4, (iters, D)).astype(np.int32)
    assert not (idx == idx[:, :1]).all()
    prune = dict(start_after=10**9)
    dp_j = jpar.make_dp_mapper(jmesh, jc, jloss.LossConfig(**LOSS),
                               JRasterConfig(**RC, backend="xla"), LRS, iters,
                               JPruneConfig(**prune))
    pj, vj, _, _, lj = dp_j(params, variables, window, jnp.asarray(idx), None, None)
    pn = {k: np.asarray(v) for k, v in params.items()}
    vn = {k: np.asarray(v) for k, v in variables.items()}
    pt0, vt0, _, _ = from_jax_numpy(pn, vn)
    win_t = {k: torch.as_tensor(np.asarray(v)) for k, v in window.items()}
    dp_t = make_dp_mapper(mesh, tc, LossConfig(**LOSS), RasterConfig(**RC), LRS, iters,
                          PruneConfig(**prune))
    pt, vt, _, _, lt = dp_t(pt0, vt0, win_t, idx, None, None)
    return (pj, vj, lj), (pt, vt, lt), mesh.stats["checksums"]


def test_dp_mapper_matches_jax(dp_runs):
    (pj, _, lj), (pt, _, lt), checksums = dp_runs
    for k in ("loss", "im", "depth"):
        np.testing.assert_allclose(lt[k].numpy(), np.asarray(lj[k]), rtol=5e-4, err_msg=k)
    for k in COMPARED:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), atol=3e-4, err_msg=k)
    assert len(set(checksums)) == 1 and len(checksums) == D


def test_dp_mapper_radii_max_matches_jax(dp_runs):
    (_, vj, _), (_, vt, _), _ = dp_runs
    r_t, r_j = vt["max_2D_radius"].numpy(), np.asarray(vj["max_2D_radius"])
    np.testing.assert_array_equal(r_t, r_j)
    assert (r_t > 0).sum() > 100


def test_dp_mapper_visible_budget_skips_radii(mesh):
    """Under ``visible_budget`` the radii live in per-frame rank spaces and
    are not reduced: ``max_2D_radius`` stays as it was, and with equal
    columns the phase is the single mapper's to the bit ((4g)/4 == g)."""
    jc, params, variables, window = _mapper_fixture()
    tc = cameras()[1]
    pt0, vt0, _, _ = from_jax_numpy({k: np.asarray(v) for k, v in params.items()},
                                    {k: np.asarray(v) for k, v in variables.items()})
    vt0["max_2D_radius"] = torch.full_like(vt0["max_2D_radius"], 2.0)
    win_t = {k: torch.as_tensor(np.asarray(v)) for k, v in window.items()}
    rc = RasterConfig(**RC, visible_budget=300)
    prune = PruneConfig(start_after=10**9)
    idx = np.random.default_rng(3).integers(0, 4, 4)
    a = make_mapper(tc, LossConfig(**LOSS), rc, LRS, 4, prune, device="cpu")(
        pt0, vt0, win_t, idx, None, None)
    b = make_dp_mapper(mesh, tc, LossConfig(**LOSS), rc, LRS, 4, prune)(
        pt0, vt0, win_t, np.repeat(idx[:, None], D, 1), None, None)
    for x, y in zip(tensors_of(a), tensors_of(b)):
        assert torch.equal(x, y)
    assert torch.equal(b[1]["max_2D_radius"], vt0["max_2D_radius"])
    assert float(b[4]["n_map_bin_dropped"].max()) > 0      # the budget truncated the map
