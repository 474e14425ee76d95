"""Every configuration, traffic mix, limit and metric file loads, and every
cell of BENCHMARK.json resolves to its files by name."""
import importlib
import os
import re

import pytest

from slambench import cells
from slambench.reference import check

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    spec = cells.cell_spec(cell, BENCH)
    cfg = cells.shipped_config(spec)
    assert cfg["tracking"]["use_gt_poses"] == spec["traffic"]["set"]["tracking.use_gt_poses"]
    tracks = not cfg["tracking"]["use_gt_poses"]
    nums = check.expected_numbers(spec["limits"], tracks)
    assert set(spec["limits"]) <= set(check.NUMBERS)
    phases = ("track", "dens", "map") if tracks else ("dens", "map")
    assert all(any(n.startswith(p) for n in nums) for p in phases)
    assert spec["traffic"]["resume_frame"] % cfg["map_every"] == 0
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s", "frames_per_s"}
    assert spec["per_layer"], "every cell reports a per-layer metric"
    for m in spec["per_layer"]:
        assert callable(importlib.import_module(f"slambench.metrics.{m['name']}").read)


def test_files_are_named_from_the_benchmark():
    for c in BENCH["configs"]:
        assert NAME.match(c["name"])
        assert os.path.isfile(os.path.join(cells.ROOT, c["file"]))
        assert cells._json("configs", c["name"] + ".json")["source"] == c["source"]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["name"] == f"{w['config']}.{w['traffic']}"
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_each_file_belongs_to_a_cell():
    used_cfg = {w["config"] for w in BENCH["workloads"]}
    used_tr = {w["traffic"] for w in BENCH["workloads"]}
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert {f[:-5] for f in os.listdir(os.path.join(here, "configs"))} == used_cfg
    assert {f[:-5] for f in os.listdir(os.path.join(here, "traffic"))} == used_tr
    assert {f[:-5] for f in os.listdir(os.path.join(here, "limits"))} == \
        {w["name"] for w in BENCH["workloads"]}
