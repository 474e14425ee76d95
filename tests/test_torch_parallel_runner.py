"""``SLAMRunner`` with ``parallel.map_data_devices = 4`` against the JAX
package's runner on the CPU, and the mesh's failures.

The port's runner maps on 4 ``gloo`` ranks on the CPU (``mesh=``), JAX's
over 4 of the 8 virtual CPU devices of ``tests/conftest.py``, on the
fabricated sequence and configuration of ``tests/test_torch_cli.py``, with
the same draws (its ``same_draws``) and the same ``(num_iters, 4)``
``rand_idx`` drawn from the run's generator.  The bounds are that test's,
for the reasons it gives: tracking losses per term to 5e-3 of the total on
the first tracked frame and 2e-2 later (silhouette-mask flips, ROADMAP.md
section 3), poses to 2 mm and 1e-3, each gaussian parameter to ``2 lr``
times the mapping steps at most and a twentieth of that on average.

The failures: D above the visible GPUs and classic densification raise
before any process starts; a worker that raises during a phase, or dies,
makes the controller raise at once (well inside the mesh's timeout) and
leaves no process behind.
"""
import json
import multiprocessing
import os
import time

import numpy as np
import pytest
import torch

from hierslam_torch.ops.rasterize import RasterConfig
from hierslam_torch.parallel import MeshError, make_dp_mapper, make_mesh
from hierslam_torch.slam.losses import LossConfig
from hierslam_torch.slam.mapping import PruneConfig
from hierslam_torch.slam.pipeline import SLAMRunner

from test_torch_cli import _config, same_draws  # noqa: F401  (a fixture)
from test_torch_parallel_equal import LRS, scene

torch.set_num_threads(1)


def test_runner_dp_mapping_matches_jax(tmp_path, same_draws):  # noqa: F811
    from hierslam_tpu.slam.pipeline import SLAMRunner as JSLAMRunner

    cfg = _config(tmp_path, tmp_path / "jax")
    cfg["parallel"] = dict(map_data_devices=4)
    jcfg = dict(cfg, raster=dict(cfg["raster"], backend="xla"))
    tcfg = dict(cfg, workdir=str(tmp_path / "torch"), raster=dict(cfg["raster"], backend="pallas"))
    mesh = make_mesh(4, devices="cpu", timeout=120)
    runner = SLAMRunner(tcfg, device="cpu", mesh=mesh)
    pt, st = runner.run(progress=False)
    assert mesh.closed and not multiprocessing.active_children()
    jr = JSLAMRunner(jcfg)
    pj, sj = jr.run(progress=False)

    def records(workdir):
        with open(os.path.join(workdir, cfg["run_name"], "metrics.jsonl")) as f:
            return [r for r in map(json.loads, f) if r.get("phase") == "tracking"]

    a, b = records(tcfg["workdir"]), records(jcfg["workdir"])
    assert len(a) == len(b) == 15
    for x, y in zip(a, b):
        for k in ("tracking_loss", "tracking_depth", "tracking_im"):
            rel = 5e-3 if x["step"] == 1 else 2e-2
            np.testing.assert_allclose(x[k], y[k], rtol=0, atol=rel * y["tracking_loss"],
                                       err_msg=f"{k} frame {x['step']}")
    assert st["densify_added"] == sj["densify_added"]
    assert st["map_broadcast_bytes"] > 0
    tol = dict(cam_trans=2e-3, cam_unnorm_rots=1e-3, gt_w2c_all_frames=0.0,
               keyframe_time_indices=0.0, intrinsics=0.0, w2c=1e-7, org_width=0.0,
               org_height=0.0, timestep=0.0)
    steps = 3 * cfg["mapping"]["num_iters"]              # mappings at t = 0, 1, 3
    assert sorted(pt) == sorted(pj)
    for k in pt:
        assert pt[k].shape == pj[k].shape, k
        d = np.abs(pt[k].astype(np.float64) - pj[k])
        if k in tol:
            assert d.max() <= tol[k], (k, d.max())
            continue
        bound = 2 * cfg["mapping"]["lrs"][k] * steps
        assert d.max() <= bound, (k, d.max(), bound)
        if k != "unnorm_rotations":
            assert d.mean() <= bound / 20, (k, d.mean(), bound / 20)


def test_map_data_devices_above_visible_gpus_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = _config(tmp_path, tmp_path / "w", n_frames=2)
    cfg["parallel"] = dict(map_data_devices=2)
    with pytest.raises(ValueError, match="map_data_devices=2 but only 0 devices"):
        SLAMRunner(cfg, device="cpu")
    with pytest.raises(ValueError, match="requested 2 devices, have 0"):
        make_mesh(2)
    assert not multiprocessing.active_children()


def test_classic_densification_with_dp_raises(tmp_path):
    cfg = _config(tmp_path, tmp_path / "w", n_frames=2)
    cfg["parallel"] = dict(map_data_devices=2)
    cfg["mapping"]["use_gaussian_splatting_densification"] = True
    with pytest.raises(ValueError, match="use_gaussian_splatting_densification"):
        SLAMRunner(cfg, device="cpu")
    assert not multiprocessing.active_children()


def test_failed_or_dead_worker_raises_at_once():
    cam, p, v, window, mlp, loss = scene()
    loss = LossConfig(use_sil_for_loss=False, sil_thres=0.5, w_im=0.5, w_depth=1.0)
    timeout = 60
    prune = PruneConfig(start_after=10**9)
    # rank 1 reads window frame 99 of 2: an IndexError there while rank 0
    # waits in the phase's first all_reduce
    mesh = make_mesh(2, devices="cpu", timeout=timeout)
    dp = make_dp_mapper(mesh, cam, loss, RasterConfig(max_per_tile=256), LRS, 2, prune)
    idx = np.array([[0, 99], [1, 99]])
    t0 = time.monotonic()
    with pytest.raises(MeshError, match="(?s)rank 1.*IndexError"):
        dp(p, v, window, idx, None, None)
    assert time.monotonic() - t0 < timeout / 2
    assert mesh.closed and not multiprocessing.active_children()
    # a worker that dies between calls
    mesh = make_mesh(2, devices="cpu", timeout=timeout)
    dp = make_dp_mapper(mesh, cam, loss, RasterConfig(max_per_tile=256), LRS, 2, prune)
    mesh._procs[0].kill()
    mesh._procs[0].join(timeout)
    t0 = time.monotonic()
    with pytest.raises(MeshError, match="rank 1"):
        dp(p, v, window, np.zeros((2, 2), int), None, None)
    assert time.monotonic() - t0 < timeout / 2
    assert mesh.closed and not multiprocessing.active_children()

