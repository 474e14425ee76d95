"""The two shipped Replica configs without semantics on the CPU: the port's
``run_slam`` against the JAX package's on ``fabricate_replica(semantic=
False)`` for ``configs/replica/hierslam_nosemantic_run.py`` (the ladder
mapper with visible-rank compaction, rank-ladder tracking with saturation
capping, the plain ``ReplicaDataset``) and ``hierslam_gtpose_run.py``
(the same with GT poses, no tracking after frame 0); then the ladder
mapper with a visible budget below the map size and the rank-ladder
tracker with ``sat_margin`` 2.0, each against its JAX counterpart.

Both runs load the shipped file (``REPLICA_DIR`` set to the fabricated
sequence) and cut it for a CPU test: the fabricated 64x48 camera, 3
frames, ``map_every`` 2 (so that a densify and a second ladder mapping
run), a map of 32,768 slots, 3 tracking and 3 mapping iterations, and the
ladders' tile counts scaled to the 12 tiles of 64x48 with the top ks cut
(mapping ((2, 1024), (3, 512), (3, 256), (-1, 128)), tracking ((3, 1024),
(4, 512), (-1, 128)): the JAX side's XLA blend costs what its largest k
does).  ``sat_margin`` 2.0, ``sat_floor`` 128, ``visible_budget`` (above
the map: every gaussian is ranked and compacted) and the rest are as
shipped.  The JAX runner renders with ``backend="xla"`` (its Pallas
kernels' math, ``tests/test_torch_cli.py``), the port with its ladder
(plain K1/K2 on CPU tensors).

JAX ranks gaussians and tiles with ``argsort(stable=False)``, the port
with a stable sort (``ROADMAP.md`` queue 3, cause (b)).  The fabricated
wall is one plane at constant depth, so visible ranks decide the blend
order of every wall gaussian in a tile; the ``stable_argsort`` fixture
hands the JAX side the stable order, one of the orders its unstable sort
may return, as ``same_draws`` hands both sides the same random draws.

Tolerances, with their reasons (``ROADMAP.md`` queue 3):
* mapping at t = 0 sees the same inputs: each term to 1e-4 (2e-6
  measured); the second mapping to 1e-2 (3e-5 measured, 2.8e-3 with GT
  poses); the pairs the mapping binning drops (the ladder's caps) equal;
* tracking.  Frame 1 starts every wall gaussian at one camera depth, and
  the tracking classes cut its tiles' lists inside those exact ties, where
  each side's last-bit rounding of the camera transform picks which
  gaussians stay (cause (b)): each term to 3e-2 of the total loss (1.3e-2
  measured).  Frame 2, at another pose: to 2e-2 (1.3e-4 measured);
* poses to 2 mm and 1e-3, parameters to ``2 lr`` a mapping step at most
  and a twentieth of that on average (rotations excepted, as in
  ``tests/test_torch_cli.py``);
* the eval row: PSNR to 0.05 dB, MS-SSIM to 3e-3, ATE to 0.05 cm, depth
  L1 to 0.5 cm (1e-3 dB, 9e-4, 2e-3 cm and 0.17 cm measured: opacity
  logits whose gradients are rounding noise step by ``lr`` = 0.05 on one
  side only, silhouette flips at the 0.99 threshold);
* the mapper and tracker at the unit level (the JAX side with its
  Pallas kernels' math, ``backend="xla"``): loss traces to 1e-5 and
  parameters to 1e-4 (the mapper), 1e-4 and poses to 1e-5 (the tracker),
  as ``tests/test_torch_slam.py`` holds them.
"""
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabricate import fabricate_replica
from test_torch_cli import _records
from test_torch_slam import RC, cameras, render_gt, synthetic_map, t
from hierslam_tpu.core import gaussians as JG
from hierslam_tpu.ops.rasterize import RasterConfig as JRasterConfig
from hierslam_tpu.slam import losses as jloss
from hierslam_tpu.slam import mapping as jmap
from hierslam_tpu.slam import tracking as jtrk

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP_LADDER = ((2, 1024), (3, 512), (3, 256), (-1, 128))
TRACK_LADDER = ((3, 1024), (4, 512), (-1, 128))


@pytest.fixture
def stable_argsort(monkeypatch):
    """The JAX package's ``jnp.argsort(..., stable=False)`` returns the
    stable order (see the module docstring)."""
    real = jnp.argsort

    def argsort(a, axis=-1, *, kind=None, order=None, stable=True, descending=False):
        return real(a, axis=axis, stable=True, descending=descending)

    monkeypatch.setattr(jnp, "argsort", argsort)


def _config(tmp_path, monkeypatch, name):
    from hierslam_torch.config import load_config

    basedir, seq, cam = fabricate_replica(str(tmp_path / "data"), n_frames=3, W=64, H=48,
                                          semantic=False)
    monkeypatch.setenv("REPLICA_DIR", basedir)
    cfg = load_config(os.path.join(REPO, "configs", "replica", f"hierslam_{name}_run.py"))
    assert cfg["data"]["basedir"] == basedir and cfg["model"]["flag_use_embedding"] == 0
    cfg["data"].pop("gradslam_data_cfg")
    cfg["data"].update(sequence=seq, num_frames=3, desired_image_height=48,
                       desired_image_width=64, dataset_name=cam["dataset_name"],
                       camera_params=cam["camera_params"])
    cfg.update(workdir=str(tmp_path / "jax"), run_name="r", map_capacity=32768, map_every=2,
               mapping_window_size=3)
    cfg["raster"].update(bucket_spec=MAP_LADDER, track_bucket_spec=TRACK_LADDER,
                         gaussian_chunk=128, tile_batch=12, overflow_warn_threshold=1000)
    cfg["tracking"]["num_iters"] = 3
    cfg["mapping"]["num_iters"] = 3
    return cfg


def _run_both(tmp_path, monkeypatch, name):
    from hierslam_torch.slam.pipeline import run_slam as t_run_slam
    from hierslam_tpu.slam.pipeline import run_slam as j_run_slam

    cfg = _config(tmp_path, monkeypatch, name)
    tcfg = dict(cfg, workdir=str(tmp_path / "torch"))
    jcfg = dict(cfg, raster=dict(cfg["raster"], backend="xla"))
    out = {}
    for side, fn, c in (("torch", lambda c: t_run_slam(c, device="cpu"), tcfg),
                        ("jax", j_run_slam, jcfg)):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            res = fn(c)
        path = os.path.join(c["workdir"], "r", "metrics.jsonl")
        out[side] = res + (path, [str(w.message) for w in seen])
    return cfg, out


def _compare(cfg, out, tracked):
    (pt, st, rt, tm, tw), (pj, sj, rj, jm, jw) = out["torch"], out["jax"]
    # the mapping binning's drops are counted and warned on, naming the budget
    for said in (tw, jw):
        assert any("mapping binning dropped" in w and "visible_budget=1500000" in w
                   for w in said), said
    assert not os.path.exists(os.path.join(os.path.dirname(tm), "semantic_decoder.npz"))
    jt, tt = _records(jm, "tracking"), _records(tm, "tracking")
    assert len(jt) == len(tt) == (6 if tracked else 0)
    for a, b in zip(tt, jt):
        rel = 3e-2 if a["step"] == 1 else 2e-2
        for k in ("tracking_loss", "tracking_depth", "tracking_im"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=rel * b["tracking_loss"],
                                       err_msg=f"{k} frame {a['step']}")
    jmp, tmp = _records(jm, "mapping"), _records(tm, "mapping")
    assert len(jmp) == len(tmp) == 6
    assert "mapping_sem" not in tmp[0]
    for i, (a, b) in enumerate(zip(tmp, jmp)):      # t = 0 (i < 3): the same inputs
        for k in ("mapping_loss", "mapping_im", "mapping_depth"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4 if i < 3 else 1e-2,
                                       err_msg=f"{k} record {i}")
        assert a["mapping_n_map_bin_dropped"] == b["mapping_n_map_bin_dropped"] > 0
    for k in ("densify_added", "densify_overflow", "compactions", "n_active"):
        assert st[k] == sj[k], k
    assert sorted(pt) == sorted(pj) and "semantic" not in pt
    tol = dict(cam_trans=2e-3, cam_unnorm_rots=1e-3, gt_w2c_all_frames=0.0,
               keyframe_time_indices=0.0, intrinsics=0.0, w2c=1e-7, org_width=0.0,
               org_height=0.0, timestep=0.0)
    steps = 2 * cfg["mapping"]["num_iters"]           # mappings at t = 0 and 1
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
    for k, v in dict(psnr=0.05, ms_ssim=3e-3, depth_l1_cm=0.5, depth_rmse_cm=0.5,
                     ate_rmse_cm=0.05, miou_pct=0.0, mbiou_pct=0.0).items():
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=v, err_msg=k)
    return pt


def test_nosemantic_config_matches_jax(tmp_path, monkeypatch, stable_argsort):
    cfg, out = _run_both(tmp_path, monkeypatch, "nosemantic")
    assert "backend" not in cfg["raster"] and not cfg["tracking"]["use_gt_poses"]
    _compare(cfg, out, tracked=True)


def test_gtpose_config_matches_jax(tmp_path, monkeypatch, stable_argsort):
    from hierslam_torch.eval.ate import trajectory_from_params

    cfg, out = _run_both(tmp_path, monkeypatch, "gtpose")
    assert cfg["tracking"]["use_gt_poses"]
    pt = _compare(cfg, out, tracked=False)
    # the written poses are the dataset's (relative to frame 0), to float32
    est = trajectory_from_params(pt["cam_unnorm_rots"], pt["cam_trans"])
    np.testing.assert_allclose(est, pt["gt_w2c_all_frames"], rtol=0, atol=1e-6)


def _touched(pn, tc):
    """Per gaussian, the tiles its screen rect covers (capped at 16), at the
    identity pose: what visible-rank binning orders by."""
    from hierslam_torch.ops import projection

    prep = projection.preprocess(t(pn["means3D"]), torch.exp(t(pn["log_scales"])),
                                 t(pn["unnorm_rotations"]), tc, (16, 16),
                                 active=torch.ones(pn["means3D"].shape[0], dtype=bool),
                                 radius_margin_px=4.0)
    w = prep.rect_max[:, 0] - prep.rect_min[:, 0]
    h = prep.rect_max[:, 1] - prep.rect_min[:, 1]
    return torch.where(prep.valid, w * h, torch.zeros_like(w)).clamp_max(16).numpy()


def test_ladder_mapper_visible_budget_below_map_matches_jax():
    """The nosemantic config's mapper (ladder, ``visible_budget``, ``sat_margin``
    2.0) with a budget that keeps about half of the map: the gaussians
    past it are dropped, counted in ``n_map_bin_dropped`` and get no
    gradient.  The budget is the count of gaussians touching at least v
    tiles, so the kept set is the same whatever order an unstable sort
    gives tied touch counts."""
    from hierslam_torch.ops import rasterize as trast
    from hierslam_torch.slam import losses as tloss
    from hierslam_torch.slam import mapping as tmap
    from hierslam_torch.utils.convert import from_jax_numpy

    jc, tc = cameras()
    n = 600
    pn = synthetic_map(seed=7, n=n)
    im, dep = render_gt(pn, np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32), jc)
    rng = np.random.default_rng(8)
    start = dict(pn)
    start["means3D"] = pn["means3D"] + 0.02 * rng.normal(size=(n, 3))
    start["rgb_colors"] = np.clip(pn["rgb_colors"] + 0.3 * rng.normal(size=(n, 3)), 0, 1)
    start = {k: np.asarray(v, np.float32) for k, v in start.items()}
    touched = _touched(start, tc)
    counts = {v: int((touched >= v).sum()) for v in range(1, 17)}
    budget = min((c for c in counts.values() if n // 3 <= c <= 2 * n // 3),
                 key=lambda c: abs(c - n // 2))
    variables = {k: np.array(v) for k, v in JG.empty_variables(n).items()}
    variables["active"][:] = True
    variables["n_active"] = np.asarray(n, np.int32)
    variables["scene_radius"] = np.asarray(3.0, np.float32)
    window = {"im": im[None].copy(), "depth": dep[None].copy(),
              "time_idx": np.array([0], np.int32)}
    rand_idx = np.zeros(5, np.int32)
    lcfg = dict(use_sil_for_loss=False, sil_thres=0.5, w_im=0.5, w_depth=1.0)
    lrs = {"means3D": 1e-4, "rgb_colors": 2.5e-3, "unnorm_rotations": 1e-3,
           "logit_opacities": 0.05, "log_scales": 1e-3}
    rc = dict(RC, bucket_spec=((4, 512), (-1, 256)), sat_margin=2.0, sat_floor=128,
              visible_budget=budget)
    prune = dict(start_after=0, stop_after=20, prune_every=20)
    mapper_j = jmap.make_mapper(jc, jloss.LossConfig(**lcfg), JRasterConfig(**rc, backend="xla"),
                                lrs, 5,
                                jmap.PruneConfig(**prune))
    pj, vj, _, _, lj = mapper_j({k: jnp.asarray(v) for k, v in start.items()},
                                {k: jnp.asarray(v) for k, v in variables.items()},
                                {k: jnp.asarray(v) for k, v in window.items()},
                                jnp.asarray(rand_idx), None, None)
    pt0, vt0, _, _ = from_jax_numpy(start, variables)
    mapper_t = tmap.make_mapper(tc, tloss.LossConfig(**lcfg), trast.RasterConfig(**rc), lrs, 5,
                                tmap.PruneConfig(**prune), device="cpu")
    pt, vt, _, _, lt = mapper_t(pt0, vt0, {k: torch.as_tensor(v) for k, v in window.items()},
                                rand_idx, None, None)
    for k in ("loss", "im", "depth"):
        np.testing.assert_allclose(lt[k].numpy(), np.asarray(lj[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(lt["n_map_bin_dropped"].numpy(),
                                  np.asarray(lj["n_map_bin_dropped"]))
    assert float(lt["n_map_bin_dropped"][0]) > 0
    np.testing.assert_array_equal(vt["active"].numpy(), np.asarray(vj["active"]))
    for k in ("means3D", "rgb_colors", "logit_opacities", "log_scales"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), atol=1e-4, err_msg=k)
    # the gaussians past the budget got no gradient: they did not move
    past = touched < min(v for v, c in counts.items() if c == budget)
    assert past.sum() == n - budget
    np.testing.assert_array_equal(pt["rgb_colors"].numpy()[past], start["rgb_colors"][past])


def test_rank_ladder_tracker_with_saturation_matches_jax():
    """Rank-ladder tracking (the nosemantic config's three classes, scaled
    to 12 tiles) with saturation capping at ``sat_margin`` 2.0: tiles
    ranked by their saturation-bounded need, lists cut to their class,
    pairs past each cut counted."""
    from dataclasses import replace

    from hierslam_torch.ops import rasterize as trast
    from hierslam_torch.ops.render_tracked import build_track_cache
    from hierslam_torch.slam import losses as tloss
    from hierslam_torch.slam import tracking as ttrk

    jc, tc = cameras()
    pn = synthetic_map(seed=0, n=1200)
    im, dep = render_gt(pn, np.array([0.9999, 0.01, -0.02, 0.005], np.float32),
                        np.array([0.03, -0.02, 0.01], np.float32), jc)
    cfg = dict(use_sil_for_loss=True, sil_thres=0.99, w_im=0.5, w_depth=1.0)
    n = pn["means3D"].shape[0]
    rc = dict(RC, track_bucket_spec=((3, 256), (4, 128), (-1, 64)), sat_margin=2.0,
              sat_floor=32, bucket_spec=((2, 512), (-1, 256)))
    trk_j = jtrk.make_tracker(jc, jloss.LossConfig(**cfg), JRasterConfig(**rc, backend="xla"),
                              4e-4, 2e-3, 5)
    pj, blj, mrj, trj, _ = trk_j({k: jnp.asarray(v) for k, v in pn.items()},
                                 jnp.ones(n, bool), jnp.zeros(n), jnp.asarray(im),
                                 jnp.asarray(dep), 1)
    trk_t = ttrk.make_tracker(tc, tloss.LossConfig(**cfg), trast.RasterConfig(**rc), 4e-4,
                              2e-3, 5, device="cpu")
    pt, blt, mrt, trt, _ = trk_t({k: t(v) for k, v in pn.items()}, torch.ones(n, dtype=bool),
                                 torch.zeros(n), t(im), t(dep), 1)
    for a, b in zip(trt, trj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)
    np.testing.assert_allclose(float(blt), float(blj), rtol=1e-4)
    for k in ("cam_trans", "cam_unnorm_rots"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(mrt.numpy(), np.asarray(mrj))
    # the ladder cut lists: pairs were dropped, and the classes are the spec's
    track_rc = replace(trast.RasterConfig(**rc), bucket_spec=rc["track_bucket_spec"])
    cache = build_track_cache({k: t(v) for k, v in pn.items()}, torch.ones(n, dtype=bool),
                              t(pn["cam_unnorm_rots"][0, :, 1]), t(pn["cam_trans"][0, :, 1]), tc,
                              track_rc, margin_px=16.0)
    assert int(cache.n_dropped) > 0
    assert [tuple(v.shape) for v in cache.slot_valid] == [(3, 256), (4, 128), (5, 64)]

