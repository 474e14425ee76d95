"""The port runner's ``config["profile"]`` and ``use_wandb``, on the CPU.

``profile`` = {"trace_dir": .., "frames": [..]} traces each listed frame's
step with ``torch.profiler`` (``hierslam_tpu/slam/pipeline.py`` wraps the
same frames in ``jax.profiler.trace``); ``use_wandb`` logs through wandb
where it imports and starts, else prints the JAX package's message and
logs locally.  Neither machine has wandb: a fake module in ``sys.modules``
stands in for it, recording every call.  Each run is 2 frames of a
fabricated Replica-layout sequence at 32x24 (mapping at t=0 and t=1,
tracking at t=1); a traced or logged run must save the same parameters,
to the bit, as the run without the option.
"""
import glob
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from fabricate import fabricate_replica
from hierslam_torch.utils.logging import RunLogger as TorchLogger
from hierslam_tpu.utils.logging import RunLogger as JaxLogger
from test_e2e import small_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return fabricate_replica(str(root), n_frames=2, W=32, H=24, semantic=True)[:2]


def _config(sequence, workdir, **extra):
    cfg = small_config(*sequence, workdir=str(workdir))
    cfg["data"].update(desired_image_height=24, desired_image_width=32, num_frames=2)
    cfg["data"]["camera_params"].update(image_height=24, image_width=32, cx=16.0, cy=12.0)
    cfg["tracking"]["num_iters"] = 5
    cfg["mapping"]["num_iters"] = 5
    cfg["raster"].update(max_per_tile=1024, backend="pallas")
    cfg.update(extra)
    return cfg


def _run(cfg):
    from hierslam_torch.slam.pipeline import SLAMRunner

    runner = SLAMRunner(cfg, device="cpu")
    runner.run(progress=False)
    with np.load(os.path.join(runner.output_dir, "params.npz")) as f:
        return runner, {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def baseline(sequence, tmp_path_factory):
    return _run(_config(sequence, tmp_path_factory.mktemp("plain")))[1]


def _same_params(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class FakeWandb(types.ModuleType):
    """A stand-in for the wandb package: ``init`` returns a run; every
    call on either lands in ``calls``."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", kw))
        return self

    def log(self, data, step=None):
        self.calls.append(("log", {k: (v if isinstance(v, (int, float, str)) else type(v).__name__)
                                   for k, v in data.items()}, step))

    def finish(self):
        self.calls.append(("finish",))


def test_profile_traces_the_listed_frame(sequence, baseline, tmp_path):
    trace_dir = tmp_path / "traces"
    cfg = _config(sequence, tmp_path / "run", profile={"trace_dir": str(trace_dir),
                                                       "frames": [1]})
    _, params = _run(cfg)
    traces = glob.glob(str(trace_dir / "*"))
    assert [os.path.basename(p) for p in traces] == ["frame1.json"]
    with open(traces[0]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)        # the frame's operations were traced
    assert {"hs.frame", "hs.track", "hs.map", "hs.map.iter"} <= names   # and named by phase
    assert "hierslam.step1" in trace
    _same_params(params, baseline)


def _log_records(logger):
    logger.log(0, tracking_loss=np.float32(0.25), n_active=120)
    logger.log(1, mapping_loss=torch.tensor(0.5), compaction_reason="holes")
    logger.log_iters(1, "tracking", {"loss": np.array([3.0, 2.0]), "im": np.array([1.0, 0.5])})
    logger.log_iters(2, "tracking", {"loss": np.array([1.5]), "im": np.array([0.25])})
    logger.log_iters(2, "mapping", {"loss": np.array([4.0])})
    logger.close()


def test_run_logger_calls_wandb_as_jax(tmp_path, monkeypatch):
    calls = {}
    for name, cls in (("torch", TorchLogger), ("jax", JaxLogger)):
        fake = FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        logger = cls(str(tmp_path / name), use_wandb=True, wandb_cfg={"project": "p"})
        assert logger.wandb is fake
        _log_records(logger)
        calls[name] = fake.calls
        assert logger.last == {"tracking_loss": 0.25, "n_active": 120, "mapping_loss": 0.5,
                               "compaction_reason": "holes"}
    assert calls["torch"] == calls["jax"]
    assert calls["torch"][0] == ("init", {"project": "p"})
    assert calls["torch"][-1] == ("finish",)
    # the local records are the same too, but for the clock
    recs = {}
    for name in ("torch", "jax"):
        with open(tmp_path / name / "metrics.jsonl") as f:
            recs[name] = [{k: v for k, v in json.loads(line).items() if k != "t"} for line in f]
    assert recs["torch"] == recs["jax"]


def test_run_logger_without_wandb_says_what_jax_says(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)     # import wandb raises
    said = []
    for name, cls in (("torch", TorchLogger), ("jax", JaxLogger)):
        logger = cls(str(tmp_path / name), use_wandb=True)
        assert logger.wandb is None
        _log_records(logger)
        said.append(capsys.readouterr().out)
    assert said[0] == said[1]
    assert said[0].startswith("wandb unavailable (") and "logging locally only" in said[0]


def test_use_wandb_run_without_wandb(sequence, baseline, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)
    runner, params = _run(_config(sequence, tmp_path / "run", use_wandb=True))
    assert "wandb unavailable (" in capsys.readouterr().out
    assert runner.logger.wandb is None
    _same_params(params, baseline)


def test_use_wandb_run_logs_metrics_and_panels(sequence, baseline, tmp_path, monkeypatch):
    fake = FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    runner, params = _run(_config(sequence, tmp_path / "run", use_wandb=True,
                                  wandb=dict(project="hierslam", name="run")))
    assert fake.calls[0] == ("init", {"project": "hierslam", "name": "run"})
    assert fake.calls[-1] == ("finish",)
    logged = {k for c in fake.calls if c[0] == "log" for k in c[1]}
    assert {"tracking_loss", "mapping_loss", "Tracking/loss", "Mapping/loss"} <= logged
    if runner.plots:    # the progress panels go where JAX's go
        assert {"Tracking/Qual Viz", "Mapping/Qual Viz"} <= logged
    _same_params(params, baseline)
