"""Parity of the port's reconstruction viewer with the JAX package on the
CPU: the replay geometry (``viz/geometry.py``), the PNG frames along the
trajectory (``viz/recon.py``) and ``python3 -m
hierslam_torch.scripts.visualize`` against ``scripts/visualize.py``.

The map is a ``params.npz``-style dict from a numpy seed: 400 gaussians
added over 3 timesteps, 5 semantic channels of a (2, 3)-level tree, and a
3-frame trajectory, rendered at 64x48 scaled by 0.5.  Tolerances, with
their reasons:

* the numpy geometry (point clouds of given images, frustums,
  trajectories, subsets): equal to 1e-12 — the same float64 numpy;
* replay points: 1e-4 m (the rendered depth, float32 sums in another
  order), colours to 1 grey level (1/255);
* PNG frames: pixel for pixel within 1 grey level (a float32 difference
  can cross a rounding boundary of ``* 255``), the semantic decode equal.

The JAX side renders with its Pallas blend in interpret mode.
"""
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from hierslam_torch.datasets.tree import label_colormap
from hierslam_torch.utils.image_io import read_png
from hierslam_torch.viz import geometry as TG
from hierslam_torch.viz import recon as TR
from hierslam_tpu.viz import geometry as JG
from hierslam_tpu.viz import recon as JR

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = [2, 3, 4]   # num_semantic: two levels of 2 and 3 channels, 4 leaves
CFG = {"raster": dict(max_per_tile=128, gaussian_chunk=32, tile_batch=2)}


def viz_params(seed=0, n=400):
    rng = np.random.default_rng(seed)
    q = np.tile(np.array([1.0, 0, 0, 0])[None, :, None], (1, 1, 3))
    q[0, 1:, 1:] = rng.normal(0, 0.01, (3, 2))
    tr = np.zeros((1, 3, 3))
    tr[0, :, 1:] = rng.normal(0, 0.03, (3, 2))
    p = {
        "means3D": np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.7, 0.7, n),
                             rng.uniform(1, 3, n)], -1),
        "rgb_colors": rng.uniform(0, 1, (n, 3)),
        "unnorm_rotations": np.tile([1.0, 0, 0, 0], (n, 1)),
        "logit_opacities": rng.normal(2.0, 0.5, (n, 1)),
        "log_scales": np.log(rng.uniform(0.05, 0.12, (n, 1))),
        "semantic": rng.normal(0, 1, (n, sum(LEVELS[:-1]))),
        "timestep": rng.integers(0, 3, n).astype(np.float64),
        "cam_unnorm_rots": q,
        "cam_trans": tr,
        "intrinsics": np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]]),
        "w2c": np.eye(4),
        "org_width": np.asarray(64),
        "org_height": np.asarray(48),
    }
    return {k: (np.asarray(v, np.float32) if k not in ("org_width", "org_height") else v)
            for k, v in p.items()}


def decoder(seed=1):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 1, (LEVELS[-1], sum(LEVELS[:-1]))).astype(np.float32),
            "b": rng.normal(0, 0.1, LEVELS[-1]).astype(np.float32)}


def test_numpy_geometry_matches_jax():
    rng = np.random.default_rng(2)
    im = rng.uniform(0, 1.2, (3, 24, 32))
    depth = rng.uniform(0, 3, (24, 32))
    depth[::5] = 0.0
    K = np.array([[20.0, 0, 16], [0, 20.0, 12], [0, 0, 1]])
    w2c = np.eye(4)
    w2c[:3, 3] = [0.1, -0.2, 0.3]
    for stride in (1, 3):
        for a, b in zip(TG.rgbd_to_pointcloud(im, depth, K, w2c, stride, max_depth=2.5),
                        JG.rgbd_to_pointcloud(im, depth, K, w2c, stride, max_depth=2.5)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for a, b in zip(TG.camera_frustum_geometry(32, 24, K, w2c, 0.1),
                    JG.camera_frustum_geometry(32, 24, K, w2c, 0.1)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    w2cs = [np.eye(4) + np.pad(rng.normal(0, 0.1, (3, 1)), ((0, 1), (3, 0))) for _ in range(5)]
    for upto in (None, 0, 2):
        for a, b in zip(TG.trajectory_geometry(w2cs, upto), JG.trajectory_geometry(w2cs, upto)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    p = viz_params()
    for t in (None, 1):
        a, b = TG.subset_upto_timestep(p, t), JG.subset_upto_timestep(p, t)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("mode", ["mlp", "tree", "flat"])
def test_semantic_point_colors_matches_jax(mode):
    sem = np.random.default_rng(3).normal(0, 1, (5, 12, 16)).astype(np.float32)
    kw = dict(mlp=decoder() if mode == "mlp" else None,
              num_semantic=LEVELS if mode == "tree" else None)
    a = TG.semantic_point_colors(sem, label_colormap(8), **kw)
    b = JG.semantic_point_colors(sem, label_colormap(8), **kw)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("online,semantic", [(True, False), (False, True)])
def test_replay_step_geometry_matches_jax(online, semantic):
    p = viz_params()
    kw = dict(online=online, viz_scale=0.5, pcd_stride=2, semantic=semantic,
              mlp=decoder() if semantic else None,
              colormap=label_colormap(8) if semantic else None)
    a = TG.replay_step_geometry(p, CFG, 2, device="cpu", **kw)
    b = JG.replay_step_geometry(p, CFG, 2, **kw)
    assert a["points"].shape == b["points"].shape and a["points"].shape[0] > 50
    np.testing.assert_allclose(a["points"], b["points"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(a["colors"], b["colors"], rtol=0, atol=1 / 255)
    if semantic:
        np.testing.assert_array_equal(a["sem_colors"], b["sem_colors"])
    else:
        assert a["sem_colors"] is b["sem_colors"] is None
    for k in ("frustum_verts", "frustum_lines", "traj_verts", "traj_lines", "traj_colors"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)


def _same_pngs(dir_a, dir_b, expect):
    names = sorted(f for f in os.listdir(dir_a) if f.endswith(".png"))
    assert names == sorted(f for f in os.listdir(dir_b) if f.endswith(".png")) == expect
    for f in names:
        a = read_png(os.path.join(dir_a, f)).astype(np.int16)
        b = read_png(os.path.join(dir_b, f)).astype(np.int16)
        assert a.shape == b.shape == (24, 32, 3)
        tol = 0 if f.startswith("sem_") else 1
        assert np.abs(a - b).max() <= tol, f


@pytest.mark.parametrize("decode", ["mlp", "tree"])
def test_render_trajectory_frames_matches_jax(tmp_path, decode):
    p = viz_params()
    kw = dict(every=2, viz_scale=0.5, online=decode == "tree", semantic=True,
              mlp=decoder() if decode == "mlp" else None, colormap=label_colormap(8),
              num_semantic=LEVELS)
    TR.render_trajectory_frames(p, str(tmp_path / "t"), CFG, device="cpu", **kw)
    JR.render_trajectory_frames(p, str(tmp_path / "j"), CFG, **kw)
    _same_pngs(tmp_path / "t", tmp_path / "j",
               ["recon_0000.png", "recon_0002.png", "sem_0000.png", "sem_0002.png"])


def _finished_run(tmp_path, name, with_decoder):
    workdir = tmp_path / name
    run_dir = workdir / "viz_run"
    os.makedirs(run_dir)
    np.savez(run_dir / "params.npz", **viz_params())
    if with_decoder:
        np.savez(run_dir / "semantic_decoder.npz", **decoder())
    cfg = dict(CFG, workdir=str(workdir), run_name="viz_run",
               data=dict(num_semantic=LEVELS))
    path = tmp_path / f"{name}.py"
    path.write_text(f"config = {cfg!r}\n")
    return str(path), run_dir


@pytest.mark.parametrize("with_decoder", [True, False])
def test_visualize_cli_matches_jax(tmp_path, monkeypatch, with_decoder):
    cfg_t, run_t = _finished_run(tmp_path, "t", with_decoder)
    cfg_j, run_j = _finished_run(tmp_path, "j", with_decoder)
    from hierslam_torch.scripts import visualize

    args = ["--frames-only", "--semantic", "--every", "2"]
    assert visualize.main([cfg_t] + args + ["--device", "cpu"]) == str(run_t / "viz")
    monkeypatch.setattr(sys, "argv", ["visualize.py", cfg_j] + args)
    runpy.run_path(os.path.join(ROOT, "scripts", "visualize.py"), run_name="__main__")
    _same_pngs(run_t / "viz", run_j / "viz",
               ["recon_0000.png", "recon_0002.png", "sem_0000.png", "sem_0002.png"])


def test_interactive_replay_needs_open3d_and_visualize_needs_cuda(tmp_path):
    """Without open3d both replays raise the same ImportError; the CLI
    refuses to run without CUDA unless told ``--device cpu``."""
    p = viz_params()
    for replay in (TR.interactive_replay, JR.interactive_replay):
        with pytest.raises(ImportError, match="open3d is required"):
            replay(p, CFG)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from hierslam_torch.scripts import visualize

    cfg, _ = _finished_run(tmp_path, "c", False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        visualize.main([cfg, "--frames-only"])
