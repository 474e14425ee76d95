"""Parity of the port's core modules with the JAX package: camera,
transforms, the capacity map and the config loader.  Same numpy inputs
through both; float32 on both sides, so tolerances are a few ulps of the
values compared (1e-6 absolute on unit-scale quantities).

``test_capacity_remedies_match_jax`` runs both SLAM runners through the
remedy loop of a full map (bucket growth, compaction of pruning holes,
escalated prunes): its counts and the order of its events are equal, the
mapping losses within 1e-2 (float32 sums in another order, compounded
over the remedies' redone densifies)."""
import dataclasses
import glob
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierslam_torch import config as tcfg
from hierslam_torch.core import camera as tcam
from hierslam_torch.core import gaussians as TG
from hierslam_torch.core import transforms as TT
from hierslam_tpu import config as jcfg
from hierslam_tpu.core import camera as jcam
from hierslam_tpu.core import gaussians as JG
from hierslam_tpu.core import transforms as JT

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def rand_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q


def test_camera_matches():
    k = jcam.intrinsics_matrix(600.0, 590.0, 599.5, 339.5)
    np.testing.assert_array_equal(tcam.intrinsics_matrix(600.0, 590.0, 599.5, 339.5), k)
    rng = np.random.default_rng(0)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = np.asarray(JT.quat_to_rotmat(jnp.asarray(rand_quats(rng, 1)[0])))
    w2c[:3, 3] = rng.normal(size=3)
    a = jcam.setup_camera(1200, 680, k, w2c)
    b = tcam.setup_camera(1200, 680, k, w2c)
    for f in a._fields:
        np.testing.assert_allclose(np.asarray(getattr(b, f)), np.asarray(getattr(a, f)),
                                   rtol=1e-6, err_msg=f)


@pytest.mark.parametrize("fn", ["normalize", "quat_to_rotmat", "quat_mult",
                                "matrix_to_quaternion", "build_w2c"])
def test_transforms_match(fn):
    rng = np.random.default_rng(1)
    q1, q2 = rand_quats(rng, 16), rand_quats(rng, 16)
    if fn == "normalize":
        a, b = JT.normalize(jnp.asarray(q1)), TT.normalize(t(q1))
    elif fn == "quat_to_rotmat":
        a, b = JT.quat_to_rotmat(jnp.asarray(q1)), TT.quat_to_rotmat(t(q1))
    elif fn == "quat_mult":
        a = JT.quat_mult(jnp.asarray(q1), jnp.asarray(q2))
        b = TT.quat_mult(t(q1), t(q2))
    elif fn == "matrix_to_quaternion":
        R = np.asarray(JT.quat_to_rotmat(jnp.asarray(q1)))
        a, b = JT.matrix_to_quaternion(jnp.asarray(R)), TT.matrix_to_quaternion(t(R))
    else:
        tr = rng.normal(size=(16, 3)).astype(np.float32)
        a = JT.build_w2c(JT.normalize(jnp.asarray(q1)), jnp.asarray(tr))
        b = TT.build_w2c(TT.normalize(t(q1)), t(tr))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


@pytest.mark.parametrize("transform_rots", [False, True])
def test_transform_to_frame_matches(transform_rots):
    rng = np.random.default_rng(2)
    means = rng.normal(size=(50, 3)).astype(np.float32)
    rots = rand_quats(rng, 50)
    q = rand_quats(rng, 1)[0]
    tr = rng.normal(size=3).astype(np.float32)
    pa, ra = JT.transform_to_frame(jnp.asarray(means), jnp.asarray(rots), jnp.asarray(q),
                                   jnp.asarray(tr), gaussians_grad=True, camera_grad=True,
                                   transform_rots=transform_rots)
    pb, rb = TT.transform_to_frame(t(means), t(rots), t(q), t(tr), gaussians_grad=True,
                                   camera_grad=True, transform_rots=transform_rots)
    np.testing.assert_allclose(pb.numpy(), np.asarray(pa), atol=1e-5)
    np.testing.assert_allclose(rb.numpy(), np.asarray(ra), atol=1e-6)


def _frame(rng, h=12, w=16):
    color = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, (h, w)).astype(np.float32)
    depth[0, :3] = 0.0
    return color, depth


def test_pointcloud_insert_and_slots_match():
    rng = np.random.default_rng(3)
    color, depth = _frame(rng)
    k = jcam.intrinsics_matrix(20.0, 21.0, 8.0, 6.0)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.1, -0.2, 0.3]
    import jax

    fj = JG.pointcloud_fields(jnp.asarray(color), jnp.asarray(depth), k, w2c, 4,
                              jax.random.PRNGKey(0))
    sem = np.asarray(fj["semantic"])  # the same draws go to the port
    ft = TG.pointcloud_fields(t(color), t(depth), k, w2c, 4, semantic_init=t(sem))
    for key in fj:
        np.testing.assert_allclose(ft[key].numpy(), np.asarray(fj[key]), atol=1e-5, err_msg=key)

    mask = depth.reshape(-1) > 1.0
    pj, vj, oj = JG.insert_gaussians(JG.empty_params(120, 3, 4), JG.empty_variables(120),
                                     fj, jnp.asarray(mask), 2.0)
    pt, vt, ot = TG.insert_gaussians(TG.empty_params(120, 3, 4), TG.empty_variables(120),
                                     ft, torch.as_tensor(mask), 2.0)
    assert int(ot) == int(oj) > 0
    for key in pj:
        np.testing.assert_allclose(pt[key].numpy(), np.asarray(pj[key]), atol=1e-5, err_msg=key)
    for key in ("active", "n_active", "timestep"):
        np.testing.assert_array_equal(vt[key].numpy(), np.asarray(vj[key]), err_msg=key)

    # prune holes, then compaction and escalated prune behave alike
    holes = np.zeros(120, bool)
    holes[[1, 4, 5, 30]] = True
    vj = dict(vj, active=vj["active"] & ~jnp.asarray(holes))
    vt = dict(vt, active=vt["active"] & ~torch.as_tensor(holes))
    pj2, vj2 = JG.compact_slots(pj, vj)
    pt2, vt2 = TG.compact_slots(pt, vt)
    for key in pj2:
        np.testing.assert_allclose(pt2[key].numpy(), np.asarray(pj2[key]), atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(vt2["active"].numpy(), np.asarray(vj2["active"]))
    assert int(vt2["n_active"]) == int(vj2["n_active"])
    pj2 = dict(pj2, logit_opacities=jnp.asarray(rng.normal(size=(120, 1)).astype(np.float32)))
    pt2 = dict(pt2, logit_opacities=t(np.asarray(pj2["logit_opacities"])))
    vje, nj = JG.emergency_prune(pj2, vj2, 7)
    vte, nt = TG.emergency_prune(pt2, vt2, 7)
    assert int(nt) == int(nj) == 7
    np.testing.assert_array_equal(vte["active"].numpy(), np.asarray(vje["active"]))
    aj = JG.active_params_to_numpy(pj2, vje)
    at = TG.active_params_to_numpy(pt2, vte)
    assert sorted(aj) == sorted(at)
    for key in aj:
        np.testing.assert_allclose(at[key], np.asarray(aj[key]), atol=1e-6, err_msg=key)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "configs", "*", "*.py"))))
def test_config_loads_like_jax(path):
    cj = jcfg.apply_defaults(jcfg.load_config(path))
    ct = tcfg.apply_defaults(tcfg.load_config(path))
    assert ct == cj
    rj = dataclasses.asdict(jcfg.raster_config(cj))
    rt = dataclasses.asdict(tcfg.raster_config(ct))
    assert rt == rj


def test_capacity_remedies_match_jax(tmp_path):
    """Three frames of the procedural room at 64x48 in a map of 3,584 slots
    (the first frame inserts 3,072), GT poses, a densify every frame and
    ``SLAMRunner``'s bucket knobs cut (step 1,024, no headroom, no
    compaction by hole count alone).  The mapping prunes the gaussians
    beyond 3.2 / 3.21 of frame 0's farthest depth (``scene_radius_depth_ratio``
    3.21), the camera's arc (6 frames to the loop) shows new surface, and so
    each densify overflows: the bucket grows to the capacity, the pruning
    holes are compacted, and the least-opaque gaussians are pruned (three
    times at most) while the densify, redone with the same draws, does not
    fit; what still does not fit is dropped with a warning
    (``on_capacity_saturated="warn"``) and counted.  The counts of both
    runners and the sequence of their compactions and prunes are equal."""
    from test_e2e import small_config

    from hierslam_torch.slam.pipeline import SLAMRunner as TorchRunner
    from hierslam_tpu.slam.pipeline import SLAMRunner as JaxRunner

    spec = importlib.util.spec_from_file_location(
        "procedural_room", os.path.join(ROOT, "tools", "procedural_room.py"))
    room = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(room)
    room.generate(str(tmp_path / "data"), n_frames=6, W=64, H=48)
    cfg = small_config(str(tmp_path / "data"), "proc_room", semantic=False,
                       workdir=str(tmp_path / "jax"))
    cfg["data"]["num_frames"] = 3
    cfg["data"]["camera_params"].update(fx=32.0, fy=32.0, cx=31.5, cy=23.5)
    cfg["tracking"].update(use_gt_poses=True, num_iters=3)
    cfg["mapping"].update(num_iters=3, on_capacity_saturated="warn")
    cfg["raster"]["max_per_tile"] = 1024
    cfg.update(map_capacity=3584, map_every=1, scene_radius_depth_ratio=3.21,
               bucket_step=1024, bucket_headroom=0, hole_compact_threshold=10**6)
    runners = {"torch": TorchRunner(dict(cfg, workdir=str(tmp_path / "torch"),
                                         raster=dict(cfg["raster"], backend="pallas")),
                                    device="cpu"),
               "jax": JaxRunner(dict(cfg, raster=dict(cfg["raster"], backend="xla")))}
    stats, events, losses = {}, {}, {}
    for side, r in runners.items():
        assert r.bucket == 3072 < r.capacity == 3584
        with pytest.warns(UserWarning, match="escalated prune"):
            _, stats[side] = r.run()
        with open(os.path.join(r.output_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        events[side] = [(rec["step"], rec.get("compaction_reason"), rec.get("slots_reclaimed"),
                         rec.get("emergency_pruned"), rec.get("n_active")) for rec in recs
                        if "compaction_reason" in rec or "emergency_pruned" in rec]
        losses[side] = np.array([rec["mapping_loss"] for rec in recs
                                 if rec.get("phase") == "mapping"])
    keys = ("densify_added", "densify_overflow", "compactions", "slots_reclaimed",
            "emergency_pruned", "n_active")
    assert {k: stats["torch"][k] for k in keys} == {k: stats["jax"][k] for k in keys}
    assert events["torch"] == events["jax"]
    reasons = [e[1] for e in events["torch"] if e[1]]
    assert any(r.startswith("densify overflow") for r in reasons)
    assert any(r.startswith("escalated prune") for r in reasons)
    assert stats["torch"]["emergency_pruned"] > 0
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-2)
