"""The port's data-parallel mapper with equal columns is its single mapper,
on 2 ``gloo`` ranks on the CPU (one mesh for the module).

With every column of ``rand_idx`` equal, both ranks compute the same
gradients and loss parts from the same inputs in the same order, so their
float32 mean at D = 2, ``(g + g) / 2``, is ``g`` exactly: the phase's
results must equal the single mapper's to the bit, with both backends, a
prune at iteration 0, an opacity reset, the semantic decoder past its gate
and, on the ladder without a visible budget, the ``max_2D_radius``
bookkeeping through the ranks' max.  The ranks run with the controller's
thread count, so that their CPU sums split alike.
"""
import multiprocessing

import numpy as np
import pytest
import torch

from hierslam_torch.core.camera import intrinsics_matrix, setup_camera
from hierslam_torch.core.gaussians import empty_variables
from hierslam_torch.ops.rasterize import RasterConfig
from hierslam_torch.parallel import make_dp_mapper, make_mesh
from hierslam_torch.parallel.mesh import tensors_of
from hierslam_torch.slam import optim
from hierslam_torch.slam.losses import LossConfig, render_gaussians
from hierslam_torch.slam.mapping import PruneConfig, make_mapper

torch.set_num_threads(1)
H, W = 48, 64
ITERS = 6


@pytest.fixture(scope="module")
def mesh():
    m = make_mesh(2, devices="cpu", timeout=120)
    yield m
    m.close()
    assert not multiprocessing.active_children()


def scene(seed=0, n=400, levels=(2, 3), leaf=4):
    """A wall + floor map with semantics, a 2-frame window rendered from it
    (the map then moved off it), a decoder and its Adam state."""
    rng = np.random.default_rng(seed)
    h = n // 2
    wall = np.stack([rng.uniform(-1.5, 1.5, h), rng.uniform(-1.0, 1.0, h),
                     2.5 + 0.05 * rng.normal(size=h)], -1)
    floor = np.stack([rng.uniform(-1.5, 1.5, n - h), 1.0 + 0.02 * rng.normal(size=n - h),
                      rng.uniform(0.8, 2.5, n - h)], -1)
    S = sum(levels)
    p = {"means3D": np.concatenate([wall, floor]), "rgb_colors": rng.uniform(0, 1, (n, 3)),
         "unnorm_rotations": np.tile([1.0, 0, 0, 0], (n, 1)),
         "logit_opacities": np.full((n, 1), 4.0), "log_scales": np.full((n, 1), np.log(0.06)),
         "semantic": rng.uniform(0, 1, (n, S)),
         "cam_unnorm_rots": np.tile(np.array([1.0, 0, 0, 0])[None, :, None], (1, 1, 2)),
         "cam_trans": np.zeros((1, 3, 2))}
    p["cam_trans"][0, :, 1] = [0.05, 0.0, 0.0]
    p = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in p.items()}
    cam = setup_camera(W, H, intrinsics_matrix(40.0, 40.0, W / 2, H / 2), np.eye(4))
    ims, deps = [], []
    for f in range(2):
        out = render_gaussians(p, None, p["cam_unnorm_rots"][0, :, f], p["cam_trans"][0, :, f],
                               cam, RasterConfig(max_per_tile=256), with_semantic=False,
                               gaussians_grad=False, camera_grad=False)
        ims.append(out.im.clamp(0, 1))
        deps.append(out.depth)
    labels = np.stack([np.stack([rng.integers(0, 2, (H, W)), rng.integers(0, 3, (H, W)),
                                 rng.integers(0, leaf, (H, W))]) for _ in range(2)])
    window = {"im": torch.stack(ims), "depth": torch.stack(deps),
              "labels": torch.as_tensor(labels.astype(np.int16)),
              "time_idx": torch.tensor([0, 1])}
    p["means3D"] = p["means3D"] + 0.02 * torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    p["rgb_colors"] = (p["rgb_colors"] + 0.3 * torch.as_tensor(
        rng.normal(size=(n, 3)), dtype=torch.float32)).clamp(0, 1)
    p["logit_opacities"][:40] = -8.0          # pruned at iteration 0
    v = empty_variables(n)
    v["active"][:] = True
    v["n_active"] = torch.tensor(n)
    v["scene_radius"] = torch.tensor(3.0)
    mlp = {"w": torch.as_tensor(rng.uniform(-0.4, 0.4, (leaf, S)), dtype=torch.float32),
           "b": torch.as_tensor(rng.uniform(-0.4, 0.4, leaf), dtype=torch.float32)}
    loss = LossConfig(use_sil_for_loss=False, sil_thres=0.5, w_im=0.5, w_depth=1.0, w_sem=0.2,
                      sem_levels=levels, num_leaf=leaf, use_mlp=True, mlp_gate_iter=2)
    return cam, p, v, window, mlp, loss


LRS = {"means3D": 1e-4, "rgb_colors": 2.5e-3, "unnorm_rotations": 1e-3, "logit_opacities": 0.05,
       "log_scales": 1e-3, "semantic": 0.05}
PRUNE = PruneConfig(start_after=0, stop_after=4, prune_every=4, reset_opacities=True,
                    reset_opacities_every=3)


@pytest.mark.parametrize("backend", ["pallas", "stream"])
def test_dp_mapper_equal_columns_is_single_mapper(mesh, backend):
    cam, p, v, window, mlp, loss = scene()
    rc = RasterConfig(max_per_tile=256, backend=backend)
    single = make_mapper(cam, loss, rc, LRS, ITERS, PRUNE, device="cpu")
    dp = make_dp_mapper(mesh, cam, loss, rc, LRS, ITERS, PRUNE)
    idx = np.random.default_rng(1).integers(0, 2, ITERS)
    a = single(p, v, window, idx, mlp, optim.adam_init(mlp))
    b = dp(p, v, window, np.repeat(idx[:, None], 2, 1), mlp, optim.adam_init(mlp))
    ta, tb = tensors_of(a), tensors_of(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)
    pa, va, ma = a[0], a[1], a[2]
    assert int((~va["active"]).sum()) == 40                       # the prune ran
    assert not torch.equal(ma["w"], mlp["w"])                     # the decoder stepped
    if backend == "pallas":
        assert float(va["max_2D_radius"].max()) > 0               # radii went through the max
    cs = mesh.stats["checksums"]
    assert len(cs) == 2 and cs[0] == cs[1]
    assert mesh.stats["broadcast_bytes"] > sum(x.numel() * x.element_size()
                                               for x in tensors_of((p, v, window)))
