"""A tiny rehearsal of the run loop on the CPU: it runs, writes no device
metric, loads no JAX, and a run with a fault planted under the timed path
comes out not correct.  ``run.py`` itself refuses a machine without a card."""
import json
import os
import subprocess
import sys

import pytest

from slambench import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "hierslam_tpu"}


def rehearse(cell, fault=None):
    env = dict(os.environ, PYTHONPATH=cells.ROOT)
    args = [sys.executable, "-m", "slambench.tests.rehearse", cell] + ([fault] if fault else [])
    r = subprocess.run(args, cwd=cells.ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["replica_semantic.posed_300k"])
def test_rehearsal_runs_correct_without_device_metrics(cell):
    out = rehearse(cell)
    assert out["correct"] is True
    assert out["frames"] == 8 and out["frames_per_s"] > 0
    assert out["peak_mem_gib"] is None and out["memory_peak_bytes"] is None
    assert not out["cuda_initialized"]
    assert out["tracking_iter_ms"] is None   # frames arrive with their poses
    # the import check compares whole top-level names: hierslam_torch is not hierslam_tpu
    assert "hierslam_torch" in out["modules"]
    assert not FORBIDDEN & set(out["modules"])


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_planted_fault_is_not_correct(fault):
    out = rehearse("replica_semantic.posed_300k", fault)
    assert out["correct"] is False, out["check"]


def test_run_refuses_without_a_card():
    r = subprocess.run([sys.executable, "slambench/run.py", "--workload",
                        "replica_semantic.posed_300k", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=cells.ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert not any(line.startswith("{") for line in r.stdout.splitlines())
    assert "no result" in r.stderr
