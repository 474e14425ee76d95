"""The port's packed stream mapper and a stream-mapped SLAMRunner against
the JAX package on the CPU (``raster.backend="stream"``, the flagship's).

The JAX side runs its stream kernels in interpret mode, the port the plain
versions of K3/K4.  Tolerances, with their reasons:

* mapper, modelled on ``tests/test_stream.py``'s stream-vs-ladder test:
  iteration 0 sees the same parameters, so its loss agrees to 1e-5
  relative; later losses to 1e-2 and the Gaussian parameters by their 99th
  percentile (5e-3) and maximum (0.05): with eps=1e-15 Adam steps by about
  ``lr * sign(g)``, and pairs at the T >= 1e-4 cutoff and the median
  crossing take float32-level differences (product vs log-space
  transmittance) to discrete jumps.  Rotations come out bit-equal to the
  input on both sides: the packed table carries no rotation column.
* runner: 3 frames at 32x24, mapping at t=0 (identical inputs: 1e-4
  relative per loss term), tracking at t=1, t=2 (each loss term to 2e-3 of
  the total loss, poses to 0.5 mm and 2e-4, as ``test_torch_pipeline.py``
  states for the silhouette-mask flips; the same 5 iterations as there:
  at 4 both the ladder and the stream runner reach 3.7e-3 at t=2, where
  tracking runs the same ladder path on either backend), and the t=2
  mapping's first rgb
  and depth terms to 1e-2 (it starts from those poses and a densify whose
  semantic draw differs).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from fabricate import fabricate_replica
from test_e2e import small_config
from test_torch_slam import H, RC, W, cameras, render_gt, synthetic_map
from hierslam_torch.ops import rasterize as trast
from hierslam_torch.slam import losses as tloss
from hierslam_torch.slam import mapping as tmap
from hierslam_torch.slam import optim as topt
from hierslam_torch.utils.convert import from_jax_numpy
from hierslam_tpu.core import gaussians as JG
from hierslam_tpu.ops.rasterize import RasterConfig as JRasterConfig
from hierslam_tpu.slam import losses as jloss
from hierslam_tpu.slam import mapping as jmap
from hierslam_tpu.slam import optim as jopt

torch.set_num_threads(1)


def test_stream_mapper_matches():
    jc, tc = cameras()
    levels, leaf = (2, 3), 4
    S = sum(levels)
    pn = synthetic_map(seed=4, n=400, num_semantic=S)
    rng = np.random.default_rng(6)
    ims, deps = [], []
    for q, tr in (([1.0, 0, 0, 0], [0, 0, 0]), ([0.9999, 0.0, 0.01, 0.0], [0.05, 0.0, 0.0])):
        im, dep = render_gt(pn, np.asarray(q, np.float32), np.asarray(tr, np.float32), jc)
        ims.append(im)
        deps.append(dep)
    labels = np.stack([np.stack([rng.integers(0, 2, (H, W)), rng.integers(0, 3, (H, W)),
                                 rng.integers(0, leaf, (H, W))]) for _ in range(2)])
    n_cap = 448                       # 48 inactive capacity slots
    start = {k: np.array(v) for k, v in JG.empty_params(n_cap, 4, S).items()}
    for k, v in pn.items():
        if k in JG.GAUSSIAN_KEYS or k == "semantic":
            start[k][:400] = v
    start["means3D"][:400] += 0.02 * rng.normal(size=(400, 3))
    start["rgb_colors"][:400] = np.clip(pn["rgb_colors"] + 0.3 * rng.normal(size=(400, 3)),
                                        0, 1)
    start["logit_opacities"][:40] = -8.0  # pruned at iteration 0
    start["unnorm_rotations"][:] = rng.normal(size=(n_cap, 4))
    start["cam_trans"][0, :, 1] = [0.05, 0.0, 0.0]
    start["cam_unnorm_rots"][0, :, 1] = [0.9999, 0.0, 0.01, 0.0]
    start = {k: np.asarray(v, np.float32) for k, v in start.items()}
    variables = {k: np.array(v) for k, v in JG.empty_variables(n_cap).items()}
    variables["active"][:400] = True
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
    rc = dict(RC, backend="stream", stream_cap=512, sat_margin=2.0, sat_floor=32,
              visible_budget=100)    # ignored by the stream mapper (full-N binning)
    prune = dict(start_after=0, stop_after=20, prune_every=20)
    mapper_j = jmap.make_mapper(jc, jloss.LossConfig(**lcfg), JRasterConfig(**rc), lrs, 5,
                                jmap.PruneConfig(**prune))
    mlp_j = {k: jnp.asarray(v) for k, v in mlp.items()}
    pj, vj, mj, _, lj = mapper_j({k: jnp.asarray(v) for k, v in start.items()},
                                 {k: jnp.asarray(v) for k, v in variables.items()},
                                 {k: jnp.asarray(v) for k, v in window.items()},
                                 jnp.asarray(rand_idx), mlp_j, jopt.adam_init(mlp_j))
    pt0, vt0, mt0, _ = from_jax_numpy(start, variables, mlp)
    mapper_t = tmap.make_mapper(tc, tloss.LossConfig(**lcfg), trast.RasterConfig(**rc), lrs, 5,
                                tmap.PruneConfig(**prune), device="cpu")
    win_t = {k: torch.as_tensor(v) for k, v in window.items()}
    pt, vt, mt, _, lt = mapper_t(pt0, vt0, win_t, rand_idx, mt0, topt.adam_init(mt0))

    np.testing.assert_allclose(float(lt["loss"][0]), float(lj["loss"][0]), rtol=1e-5)
    for k in ("loss", "im", "depth", "sem"):
        np.testing.assert_allclose(lt[k].numpy(), np.asarray(lj[k]), rtol=1e-2, err_msg=k)
    assert float(lt["im"][-1]) < float(lt["im"][0])   # the map learns (the decoder
    # gate opening at iteration 2 adds the leaf term to the total loss)
    assert float(lt["n_map_bin_dropped"].max()) == float(np.max(lj["n_map_bin_dropped"])) == 0
    assert float(lt["n_grad_dropped"].max()) == float(np.max(lj["n_grad_dropped"])) == 0
    np.testing.assert_array_equal(vt["active"].numpy(), np.asarray(vj["active"]))
    assert int((~vt["active"][:400]).sum()) == 40
    for k in ("means3D", "rgb_colors", "log_scales", "semantic"):
        diff = np.abs(pt[k].numpy() - np.asarray(pj[k]))
        assert np.quantile(diff, 0.99) < 5e-3 and diff.max() < 0.05, (k, diff.max())
    # removed and inactive rows carry the sentinel logit on both sides
    lo_t, lo_j = pt["logit_opacities"].numpy(), np.asarray(pj["logit_opacities"])
    off = ~vt["active"].numpy()
    assert (lo_t[off] == -100.0).all() and (lo_j[off] == -100.0).all()
    diff = np.abs(lo_t[~off] - lo_j[~off])
    assert np.quantile(diff, 0.99) < 5e-3 and diff.max() < 0.05
    for p in (pt["unnorm_rotations"].numpy(), np.asarray(pj["unnorm_rotations"])):
        np.testing.assert_array_equal(p, start["unnorm_rotations"])
    for k in mlp:
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]), atol=1e-3, err_msg=k)


def test_stream_mapper_opacity_reset_matches():
    """An opacity reset in the packed mapper writes the reset logit into
    every row of the table and zeroes the logit column's moments, as the
    JAX packed path does: rows a prune removed at iteration 0 come back at
    log(0.01/0.99) in both packages (and stay inactive in ``variables``).
    Tolerances as in ``test_stream_mapper_matches``."""
    jc, tc = cameras()
    pn = synthetic_map(seed=5, n=200)
    im, dep = render_gt(pn, np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32), jc)
    # the start is perturbed off the ground truth as in the test above: at
    # the ground truth the L1 residuals are float32 noise between the two
    # renderers, and Adam with eps=1e-15 steps a full lr on their sign
    rng = np.random.default_rng(7)
    start = dict(pn)
    start["means3D"] = pn["means3D"] + 0.02 * rng.normal(size=(200, 3)).astype(np.float32)
    start["rgb_colors"] = np.clip(pn["rgb_colors"] + 0.3 * rng.normal(size=(200, 3)),
                                  0, 1).astype(np.float32)
    start["logit_opacities"] = pn["logit_opacities"].copy()
    start["logit_opacities"][:20] = -8.0            # pruned at iteration 0
    variables = {k: np.array(v) for k, v in JG.empty_variables(200).items()}
    variables["active"][:] = True
    variables["n_active"] = np.asarray(200, np.int32)
    variables["scene_radius"] = np.asarray(3.0, np.float32)
    window = {"im": im[None], "depth": dep[None], "time_idx": np.zeros(1, np.int32)}
    rand_idx = np.zeros(3, np.int32)
    lcfg = dict(use_sil_for_loss=False, sil_thres=0.5)
    lrs = {"means3D": 1e-4, "rgb_colors": 2.5e-3, "logit_opacities": 0.05, "log_scales": 1e-3}
    rc = dict(RC, backend="stream", stream_cap=512)
    prune = dict(start_after=0, stop_after=2, prune_every=2, reset_opacities=True,
                 reset_opacities_every=2)
    mapper_j = jmap.make_mapper(jc, jloss.LossConfig(**lcfg), JRasterConfig(**rc), lrs, 3,
                                jmap.PruneConfig(**prune))
    pj, vj, _, _, lj = mapper_j({k: jnp.asarray(v) for k, v in start.items()},
                                {k: jnp.asarray(v) for k, v in variables.items()},
                                {k: jnp.asarray(v) for k, v in window.items()},
                                jnp.asarray(rand_idx), None, None)
    pt0, vt0, _, _ = from_jax_numpy(start, variables)
    mapper_t = tmap.make_mapper(tc, tloss.LossConfig(**lcfg), trast.RasterConfig(**rc), lrs, 3,
                                tmap.PruneConfig(**prune), device="cpu")
    win_t = {k: torch.as_tensor(np.array(v)) for k, v in window.items()}
    pt, vt, _, _, lt = mapper_t(pt0, vt0, win_t, rand_idx, None, None)

    np.testing.assert_allclose(float(lt["loss"][0]), float(lj["loss"][0]), rtol=1e-5)
    for k in ("loss", "im", "depth"):
        np.testing.assert_allclose(lt[k].numpy(), np.asarray(lj[k]), rtol=1e-2, err_msg=k)
    np.testing.assert_array_equal(vt["active"].numpy(), np.asarray(vj["active"]))
    assert (~vt["active"][:20]).all() and vt["active"][20:].all()
    # the pruned rows: revived by the reset at iteration 2, then one Adam
    # step from zeroed moments on a zero gradient (they were sentinel rows
    # when the gradient was taken), so exactly the reset logit on both sides
    lo_t, lo_j = pt["logit_opacities"].numpy()[:, 0], np.asarray(pj["logit_opacities"])[:, 0]
    reset = np.float32(np.log(0.01 / 0.99))
    np.testing.assert_array_equal(lo_t[:20], lo_j[:20])
    np.testing.assert_array_equal(lo_j[:20], np.full(20, reset))
    for k in ("means3D", "rgb_colors", "log_scales", "logit_opacities"):
        diff = np.abs(pt[k].numpy() - np.asarray(pj[k]))
        assert np.quantile(diff, 0.99) < 5e-3 and diff.max() < 0.05, (k, diff.max())


def _iter_records(path, phase):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if r.get("phase") == phase]


def test_stream_slam_runners_match(tmp_path):
    from hierslam_torch.slam.pipeline import SLAMRunner as TorchRunner
    from hierslam_tpu.slam.pipeline import SLAMRunner as JaxRunner

    basedir, seq, _ = fabricate_replica(str(tmp_path / "data"), n_frames=3, W=32, H=24,
                                        semantic=True)
    cfg = small_config(basedir, seq, workdir=str(tmp_path / "jax"))
    cfg["data"].update(desired_image_height=24, desired_image_width=32)
    cfg["data"]["camera_params"].update(image_height=24, image_width=32, cx=16.0, cy=12.0)
    cfg["map_every"] = 3
    cfg["tracking"]["num_iters"] = 5
    cfg["mapping"]["num_iters"] = 5
    cfg["raster"].update(backend="stream", stream_cap=1024, max_per_tile=1024)

    jr = JaxRunner(cfg)
    jr._report_progress = lambda *a, **k: None   # eval is not part of this slice
    frames = [jr.dataset[t] for t in range(3)]

    class Frames:
        num_semantic = jr.dataset.num_semantic
        num_semantic_class = jr.dataset.num_semantic_class

        def __len__(self):
            return len(frames)

        def __getitem__(self, t):
            return tuple(np.asarray(x) for x in frames[t])

    tcfg = dict(cfg, workdir=str(tmp_path / "torch"))
    tr = TorchRunner(tcfg, dataset=Frames(), device="cpu")
    tr.load_state(
        {k: np.asarray(v) for k, v in jr.params.items()},
        {k: np.asarray(v) for k, v in jr.variables.items()},
        {k: np.asarray(v) for k, v in jr.mlp.items()},
        tuple(jr.mlp_state),
    )
    for t in range(3):
        jr.step(t)
        tr.step(t)

    np.testing.assert_allclose(tr.params["cam_trans"].numpy(),
                               np.asarray(jr.params["cam_trans"]), atol=5e-4)
    np.testing.assert_allclose(tr.params["cam_unnorm_rots"].numpy(),
                               np.asarray(jr.params["cam_unnorm_rots"]), atol=2e-4)
    jm = os.path.join(cfg["workdir"], cfg["run_name"], "metrics.jsonl")
    tm = os.path.join(tcfg["workdir"], cfg["run_name"], "metrics.jsonl")
    jt, tt = _iter_records(jm, "tracking"), _iter_records(tm, "tracking")
    assert len(jt) == len(tt) == 10
    for a, b in zip(tt, jt):
        for k in ("tracking_loss", "tracking_depth", "tracking_im"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=2e-3 * b["tracking_loss"],
                                       err_msg=k)
    jmp, tmp = _iter_records(jm, "mapping"), _iter_records(tm, "mapping")
    assert len(jmp) == len(tmp) == 10
    assert max(r["mapping_n_map_bin_dropped"] for r in tmp + jmp) == 0
    for a, b in zip(tmp[:5], jmp[:5]):      # t=0: identical inputs
        for k in ("mapping_loss", "mapping_im", "mapping_depth", "mapping_sem"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    for k in ("mapping_im", "mapping_depth"):  # t=2, before the first update
        np.testing.assert_allclose(tmp[5][k], jmp[5][k], rtol=1e-2, err_msg=k)
    assert tr.stats["densify_added"] == jr.stats["densify_added"] > 0
    assert int(tr.variables["n_active"]) == int(jr.variables["n_active"])
    pt, pj = tr.finalize(), jr.finalize()
    assert sorted(pt) == sorted(pj)
