"""The benchmark's inputs: the PyTorch room against tools/procedural_room.py,
the map and frames deterministic in the seed, and the resume checkpoint
read back by SLAMRunner._resume."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from slambench import cells
from slambench.frozen import room
from slambench.tests.tiny import tiny_spec


def _numpy_room():
    path = os.path.join(cells.ROOT, "tools", "procedural_room.py")
    spec = importlib.util.spec_from_file_location("procedural_room", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("t", [0, 37, 130, 333])
def test_room_equals_the_numpy_room(t):
    a = _numpy_room().render_frame(t, 96, 64, 48.0, 48.0, 47.5, 31.5, 200)
    b = room.render_frame(t, 96, 64, 48.0, 48.0, 47.5, 31.5, 200)
    assert np.array_equal(a[0], b[0].numpy())
    assert np.array_equal(a[1], b[1].numpy())
    assert np.array_equal(a[2], b[2].numpy())
    assert np.array_equal(a[3], b[3].numpy())


@pytest.mark.parametrize("cell", ["replica_semantic.posed_300k"])
def test_map_is_deterministic_in_the_seed(cell):
    spec = tiny_spec(cell)
    ds = cells.RoomSequence(spec["config"]["frames"], 40, 20, "cpu")
    n_sem = sum(ds.num_semantic[:-1])
    big = 2**31 + 12345
    a = cells.make_map(ds, 3001, 6, big, n_sem)
    b = cells.make_map(ds, 3001, 6, big, n_sem)
    c = cells.make_map(ds, 3001, 6, big + 1, n_sem)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["means3D"], c["means3D"])
    assert a["means3D"].shape == (3001, 3) and a["semantic"].shape == (3001, n_sem)
    assert int((a["timestep"] == 0).sum()) == 501
    f0, f1 = ds[5], ds[5]
    assert all(np.array_equal(x, y) for x, y in zip(f0, f1))
    assert f0[4].shape == (6, 64, 96) and f0[4].dtype == np.int32


def test_checkpoint_is_what_resume_reads(tmp_path):
    from hierslam_torch.slam.pipeline import SLAMRunner

    spec = tiny_spec("replica_semantic.posed_300k")
    S = spec["traffic"]["resume_frame"]
    ds = cells.RoomSequence(spec["config"]["frames"], 40, S + 4, "cpu")
    cfg = cells.run_config(spec, 99, str(tmp_path))
    n_sem = sum(ds.num_semantic[:-1])
    m = cells.make_map(ds, 5000, S, 99, n_sem)
    dec = cells.decoder_weights(n_sem, ds.num_semantic_class, 99)
    cells.write_checkpoint(os.path.join(str(tmp_path), "run"), m, ds, S, cfg["keyframe_every"],
                           dec)
    r = SLAMRunner(cfg, dataset=ds, device="cpu")
    assert r.start_idx == S and int(r.variables["n_active"]) == 5000
    for k, v in m.items():
        if k != "timestep":
            assert torch.equal(r.params[k][:5000], v)
    assert torch.equal(r.variables["timestep"][:5000], m["timestep"])
    assert torch.equal(r.mlp["w"], torch.as_tensor(dec["w"]))
    assert r.keyframes.time_indices == cells.keyframe_indices(S, cfg["keyframe_every"])
    for t in range(S):
        from hierslam_torch.slam.tracking import est_w2c
        w2c = est_w2c(r.params, t).numpy()
        assert np.allclose(w2c, np.linalg.inv(ds.pose(t)), atol=1e-5)
