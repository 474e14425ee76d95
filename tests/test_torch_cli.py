"""The whole slice on the CPU: the port's ``run_slam`` from disk to the eval
row against the JAX package's on a fabricated Replica sequence, resume
from a checkpoint, the emergency checkpoint, and the two CLIs run as
subprocesses with cv2, imageio, yaml, PIL, matplotlib and tqdm blocked.

The two runs draw their random numbers from different generators (the
semantic init of each new gaussian and the decoder's init), so the test
hands both the same draws: ``jax.random.uniform`` and ``torch.rand`` give
numbers made from the requested shape with numpy.  The JAX runner renders
with ``raster.backend="xla"`` (its Pallas kernels' math); the port with its
ladder path (plain K1/K2 on CPU tensors).

Tolerances, with their reasons.  Tracking sums its losses over the pixels
whose rendered opacity passes 0.99, so rounding-level parameter
differences flip single pixels of that mask (ROADMAP.md, section 3): the
first tracked frame, whose map comes from the same inputs, to 5e-3 of the
total loss per term (2.5e-3 measured; the pipeline test's 2e-3 holds for
its draws, not for these), later frames, after mappings that start from
those poses, to 2e-2; poses to 2 mm and 1e-3 in the quaternion.  Adam with
eps=1e-15 moves a parameter by about ``lr`` a step whatever the size of
its gradient, so where the two gradients are rounding noise of opposite
sign the two maps part by up to ``2 lr`` a step.  So the per-parameter
maximum of ``2 lr`` times the mapping steps only guards against a
blow-up: about any gradient stays inside it.  What holds the mapping
gradient is the mean of each gaussian parameter's difference, to a tenth
of that (rotations excepted: their gradient on an isotropic map is
rounding noise in JAX and 0 in the port, ROADMAP.md section 3), the
tracking losses of the later frames, which start from the mapped map,
and the eval row: PSNR to 0.05 dB, MS-SSIM to 1e-3, depth and ATE to
0.05 cm, mIoU to 2 points.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabricate import fabricate_replica
from test_e2e import small_config

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("cv2", "imageio", "yaml", "PIL", "matplotlib", "tqdm", "jax")


def _draws(shape):
    shape = tuple(int(s) for s in shape)
    return np.random.default_rng(sum(shape) * 7919 + len(shape)).uniform(size=shape)


@pytest.fixture
def same_draws(monkeypatch):
    """``jax.random.uniform`` and ``torch.rand`` give the same numbers for a
    shape on both sides."""

    def j_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(_draws(shape), dtype) * (maxval - minval) + minval

    real_rand = torch.rand

    def t_rand(*size, generator=None, device=None, dtype=None, **kw):
        shape = size[0] if len(size) == 1 and isinstance(size[0], (tuple, list)) else size
        if generator is not None:
            real_rand(shape, generator=generator)      # keep the generator's stream
        return torch.as_tensor(_draws(shape), dtype=dtype or torch.float32, device=device)

    monkeypatch.setattr(jax.random, "uniform", j_uniform)
    monkeypatch.setattr(torch, "rand", t_rand)


def _config(tmp_path, workdir, n_frames=4):
    basedir, seq, _ = fabricate_replica(str(tmp_path / "data"), n_frames=n_frames, W=32, H=24,
                                        semantic=True)
    cfg = small_config(basedir, seq, workdir=str(workdir))
    cfg["data"].update(desired_image_height=24, desired_image_width=32, num_frames=n_frames)
    cfg["data"]["camera_params"].update(image_height=24, image_width=32, cx=16.0, cy=12.0)
    cfg["tracking"]["num_iters"] = 5
    cfg["mapping"]["num_iters"] = 5
    cfg["raster"]["max_per_tile"] = 1024
    return cfg


def _records(path, phase):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r.get("phase") == phase]


def test_run_slam_matches_jax(tmp_path, same_draws):
    from hierslam_torch.slam.pipeline import run_slam as t_run_slam
    from hierslam_tpu.slam.pipeline import run_slam as j_run_slam

    cfg = _config(tmp_path, tmp_path / "jax")
    tcfg = dict(cfg, workdir=str(tmp_path / "torch"), raster=dict(cfg["raster"], backend="pallas"))
    jcfg = dict(cfg, raster=dict(cfg["raster"], backend="xla"))
    pt, st, rt = t_run_slam(tcfg, device="cpu")
    pj, sj, rj = j_run_slam(jcfg)

    jm = os.path.join(cfg["workdir"], cfg["run_name"], "metrics.jsonl")
    tm = os.path.join(tcfg["workdir"], cfg["run_name"], "metrics.jsonl")
    jt, tt = _records(jm, "tracking"), _records(tm, "tracking")
    assert len(jt) == len(tt) == 15
    for a, b in zip(tt, jt):
        for k in ("tracking_loss", "tracking_depth", "tracking_im"):
            rel = 5e-3 if a["step"] == 1 else 2e-2
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=rel * b["tracking_loss"],
                                       err_msg=f"{k} frame {a['step']}")
    assert st["densify_added"] == sj["densify_added"]
    assert sorted(pt) == sorted(pj)
    tol = dict(cam_trans=2e-3, cam_unnorm_rots=1e-3, gt_w2c_all_frames=0.0,
               keyframe_time_indices=0.0, intrinsics=0.0, w2c=1e-7, org_width=0.0,
               org_height=0.0, timestep=0.0)
    steps = 3 * cfg["mapping"]["num_iters"]              # mappings at t = 0, 1, 3
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
    with np.load(os.path.join(tcfg["workdir"], cfg["run_name"], "params.npz")) as saved:
        assert sorted(saved) == sorted(pt)
    for k, v in dict(psnr=0.05, ms_ssim=1e-3, depth_l1_cm=0.05, depth_rmse_cm=0.05,
                     ate_rmse_cm=0.05, miou_pct=2.0, mbiou_pct=2.0).items():
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=v, err_msg=k)
    assert np.isnan(rt["lpips"])
    # both ran the t = 0 progress reports and logged the same scalars (PSNR
    # over the pixels whose opacity passes the 0.5 or 0.99 presence
    # threshold: a mask flip moves it as it moves the eval row's)
    def progress(path):
        with open(path) as f:
            return [r for r in map(json.loads, f) if "tracking_progress_psnr" in r
                    or "mapping_progress_psnr" in r]

    a, b = progress(tm), progress(jm)
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        for k in x:
            if k != "t":
                np.testing.assert_allclose(x[k], y[k], rtol=0,
                                           atol=0.05 if "psnr" in k else 1e-3, err_msg=k)


def _checkpoint(out_dir, t, n=300, num_frames=4, seed=0):
    """The files a run leaves at frame ``t`` (params{t}.npz, the keyframe
    indices, the decoder), for a map of ``n`` gaussians."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    p = {
        "means3D": rng.uniform(-1, 1, (n, 3)) + [0, 0, 2.5],
        "rgb_colors": rng.uniform(0, 1, (n, 3)),
        "unnorm_rotations": np.tile([1.0, 0, 0, 0], (n, 1)),
        "logit_opacities": rng.normal(size=(n, 1)),
        "log_scales": np.full((n, 1), np.log(0.05)),
        "semantic": rng.uniform(0, 1, (n, 6)),
        "cam_unnorm_rots": np.tile(np.array([1.0, 0, 0, 0])[None, :, None], (1, 1, num_frames)),
        "cam_trans": rng.normal(0, 0.01, (1, 3, num_frames)),
        "timestep": rng.integers(0, t + 1, n).astype(np.float32),
    }
    np.savez(os.path.join(out_dir, f"params{t}.npz"),
             **{k: np.asarray(v, np.float32) for k, v in p.items()})
    np.save(os.path.join(out_dir, f"keyframe_time_indices{t}.npy"), np.array([0, 1]))
    np.savez(os.path.join(out_dir, f"semantic_decoder_{t}.npz"),
             w=rng.normal(size=(4, 6)).astype(np.float32),
             b=rng.normal(size=(4,)).astype(np.float32))


def test_resume_matches_jax(tmp_path):
    from hierslam_torch.slam.pipeline import SLAMRunner as TorchRunner
    from hierslam_tpu.slam.pipeline import SLAMRunner as JaxRunner

    cfg = _config(tmp_path, tmp_path / "jax")
    cfg.update(load_checkpoint=True, checkpoint_time_idx=2)
    cfg["data"]["num_tree_level"] = 2
    tcfg = dict(cfg, workdir=str(tmp_path / "torch"), raster=dict(cfg["raster"], backend="pallas"))
    for d in (cfg["workdir"], tcfg["workdir"]):
        _checkpoint(os.path.join(d, cfg["run_name"]), 2)
    tr = TorchRunner(tcfg, device="cpu")
    jr = JaxRunner(dict(cfg, raster=dict(cfg["raster"], backend="xla")))
    assert tr.start_idx == jr.start_idx == 2
    n = 300
    for k in ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales",
              "semantic"):
        np.testing.assert_array_equal(tr.params[k][:n].numpy(), np.asarray(jr.params[k][:n]))
        assert not tr.params[k][n:].any() or k == "unnorm_rotations"
    for k in ("cam_unnorm_rots", "cam_trans"):
        np.testing.assert_array_equal(tr.params[k].numpy(), np.asarray(jr.params[k]))
    assert np.array_equal(tr.variables["active"].numpy(), np.asarray(jr.variables["active"]))
    assert int(tr.variables["n_active"]) == int(jr.variables["n_active"]) == n
    np.testing.assert_array_equal(tr.variables["timestep"].numpy(),
                                  np.asarray(jr.variables["timestep"]))
    assert tr.keyframes.time_indices == jr.keyframes.time_indices == [0, 1]
    for a, b in zip(tr.keyframes.frames, jr.keyframes.frames):
        for k in ("color", "depth", "labels"):
            assert np.array_equal(getattr(a, k), np.asarray(getattr(b, k))), k
        np.testing.assert_allclose(a.w2c, b.w2c, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.stack(tr.gt_w2c_all), np.stack(jr.gt_w2c_all))
    for k in ("w", "b"):
        np.testing.assert_array_equal(tr.mlp[k].numpy(), np.asarray(jr.mlp[k]))
    assert not any(tr.mlp_state.mu[k].any() for k in ("w", "b"))
    # the resumed run steps on to the end and saves its artifact
    pn, _ = tr.run(progress=False)
    assert pn["cam_trans"].shape == (1, 3, 4) and len(tr.gt_w2c_all) == 4


def test_emergency_checkpoint_on_failure(tmp_path):
    from hierslam_torch.slam.pipeline import SLAMRunner

    cfg = _config(tmp_path, tmp_path / "torch", n_frames=3)
    cfg["raster"]["backend"] = "pallas"
    runner = SLAMRunner(cfg, device="cpu")
    track = runner.tracker

    def failing(params, active, max_radius, im, depth, t):
        if t == 2:
            raise RuntimeError("tracking failed")
        return track(params, active, max_radius, im, depth, t)

    runner.tracker = failing
    with pytest.raises(RuntimeError, match="tracking failed"):
        runner.run(progress=False)
    out = runner.output_dir
    for name in ("params2.npz", "keyframe_time_indices2.npy", "semantic_decoder_2.npz"):
        assert os.path.isfile(os.path.join(out, name)), name
    assert np.load(os.path.join(out, "keyframe_time_indices2.npy")).tolist() == [0, 1]
    assert runner.stats["progress_failed"] == 0


def test_progress_failure_is_counted(tmp_path):
    from hierslam_torch.slam.pipeline import SLAMRunner

    cfg = _config(tmp_path, tmp_path / "torch", n_frames=2)
    cfg["raster"]["backend"] = "pallas"
    runner = SLAMRunner(cfg, device="cpu")

    def broken(params, t):
        raise RuntimeError("render failed")

    runner._progress_render = broken
    runner.step(0)
    assert runner.stats["progress_failed"] == 2       # after tracking and after mapping
    assert os.path.isfile(os.path.join(runner.output_dir, "params0.npz"))


def test_metrics_plot_failure_is_caught(tmp_path, monkeypatch, capsys):
    from hierslam_torch.slam import pipeline

    def broken(*args, **kw):
        raise RuntimeError("no backend")

    monkeypatch.setattr(pipeline, "plot_metrics", broken)
    monkeypatch.setattr(pipeline, "report_progress", lambda *a, **kw: None)
    cfg = _config(tmp_path, tmp_path / "torch", n_frames=1)
    cfg["raster"]["backend"] = "pallas"
    runner = pipeline.SLAMRunner(cfg, device="cpu")
    runner.plots = True
    pn, _ = runner.run(progress=False)
    assert "metrics plot failed: no backend" in capsys.readouterr().out
    assert runner.logger._f.closed
    assert os.path.isfile(os.path.join(runner.output_dir, "params.npz"))
    assert pn["cam_trans"].shape == (1, 3, 1)


def _run_blocked(module, args, cwd):
    prelude = (
        "import sys, runpy\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        f"sys.argv = ['{module}'] + {list(args)!r}\n"
        f"runpy.run_module('{module}', run_name='__main__')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", prelude], capture_output=True, text=True,
                          timeout=300, cwd=cwd, env=env)


def test_cli_runs_without_image_yaml_or_plot_packages(tmp_path):
    cfg = _config(tmp_path, tmp_path / "exp", n_frames=3)
    cfg["raster"]["backend"] = "pallas"
    cfg_path = tmp_path / "cfg.py"
    cfg_path.write_text(f"config = {cfg!r}\n")
    out = _run_blocked("hierslam_torch.scripts.run_slam", [str(cfg_path), "--device", "cpu"],
                       str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    head = ("[ATE RMSE cm] [PSNR] [MS-SSIM] [LPIPS] [Depth L1 cm] [Depth RMSE cm] [mIoU%] "
            "[mbIoU%]")
    i = lines.index(head)
    row = [float(x) for x in lines[i + 1].split()]
    assert len(row) == 8 and np.isfinite(row[:3] + row[4:]).all()
    assert "matplotlib is not installed" in out.stdout
    assert lines[-1].startswith("total SLAM time:")
    run_dir = tmp_path / "exp" / cfg["run_name"]
    for name in ("params.npz", "config.py", "semantic_decoder.npz", "eval/psnr.txt"):
        assert (run_dir / name).is_file(), name
    out = _run_blocked("hierslam_torch.scripts.export_ply",
                       [str(run_dir), "--semantic", "--num-semantic", "2", "4", "4"],
                       str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert (run_dir / "splat_semantic.ply").is_file()
    shutil.rmtree(run_dir)
