"""The port's phase spans and stream counters, on the CPU.

While ``torch.profiler`` records, ``SLAMRunner.step`` marks each of its
phases with a ``hs.*`` span (``hierslam_torch/utils/trace.py``), the stream
mapper marks its set-up, binnings and iterations, and the step's changes
of ``SLAMRunner.stats`` land at the root of the trace as
``hierslam.step<t>``.  With no profiler, no span is entered.  Each run is 3
frames of a fabricated Replica-layout sequence at 32x24 on the stream
backend: mapping at t=0 and t=2 (densify at t=2), progress reports and
checkpoints at t=0 and t=2, keyframes at t=0 and t=1.  Each step is traced
on its own, inside a span of its own, as the benchmark traces it.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from fabricate import fabricate_replica
from test_e2e import small_config

torch.set_num_threads(1)

N_FRAMES, MAP_ITERS = 3, 4
MAP_FRAMES = (0, 2)
TOP = ("hs.frame", "hs.track", "hs.report", "hs.densify", "hs.keyframes", "hs.window", "hs.map",
       "hs.keyframe_add", "hs.checkpoint")
INNER = ("hs.map.setup", "hs.map.bin", "hs.map.iter", "hs.track.cache", "hs.track.iter")


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return fabricate_replica(str(root), n_frames=N_FRAMES, W=32, H=24, semantic=True)[:2]


def _config(sequence, workdir):
    cfg = small_config(*sequence, workdir=str(workdir))
    cfg["data"].update(desired_image_height=24, desired_image_width=32)
    cfg["data"]["camera_params"].update(image_height=24, image_width=32, cx=16.0, cy=12.0)
    cfg.update(map_every=3, report_global_progress_every=3, save_checkpoints=True,
               checkpoint_interval=2)
    cfg["tracking"]["num_iters"] = 3
    cfg["mapping"]["num_iters"] = MAP_ITERS
    cfg["raster"].update(backend="stream", stream_cap=1024, max_per_tile=1024)
    return cfg


class BinningRecorder:
    """Keeps every stream binning the mapper makes (``compute_stream_binning``
    is bound when the runner builds its mapper)."""

    def __init__(self, mp):
        from hierslam_torch.ops import render_stream as rs

        self.made, orig = [], rs.compute_stream_binning

        def record(*a, **k):
            b = orig(*a, **k)
            self.made.append(b)
            return b
        mp.setattr(rs, "compute_stream_binning", record)


def _drive(cfg, trace_dir=None):
    """Step every frame; with ``trace_dir``, each step under its own profiler
    inside a ``step<t>`` span, its trace parsed.  -> (runner, final params,
    traces, binnings a mapping frame)."""
    from hierslam_torch.slam.pipeline import SLAMRunner

    with pytest.MonkeyPatch.context() as mp:
        rec = BinningRecorder(mp)
        runner = SLAMRunner(cfg, device="cpu")
        runner.plots = False
        traces, by_frame = {}, {}
        for t in range(N_FRAMES):
            frame = runner._load_frame(t)
            n0 = len(rec.made)
            if trace_dir is None:
                runner.step(t, frame)
            else:
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    with record_function(f"step{t}"):
                        runner.step(t, frame)
                path = os.path.join(trace_dir, f"step{t}.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    traces[t] = json.load(f)
            by_frame[t] = rec.made[n0:]
    return runner, runner.finalize(), traces, by_frame


@pytest.fixture(scope="module")
def untraced(sequence, tmp_path_factory):
    """A run with no profiler, ``record_function`` and the trace metadata
    call made to raise."""
    def refuse(*a, **k):
        raise AssertionError("entered with no profiler running")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", refuse)
        mp.setattr(torch.autograd.profiler, "record_function", refuse)
        mp.setattr(torch.autograd, "_add_metadata_json", refuse)
        return _drive(_config(sequence, tmp_path_factory.mktemp("plain")))


@pytest.fixture(scope="module")
def traced(sequence, tmp_path_factory):
    return _drive(_config(sequence, tmp_path_factory.mktemp("traced")),
                  str(tmp_path_factory.mktemp("traces")))


def _spans(trace):
    return [dict(name=e["name"], ts0=e["ts"], ts1=e["ts"] + e["dur"], tid=e["tid"])
            for e in trace["traceEvents"]
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _one(spans, name):
    found = [s for s in spans if s["name"] == name]
    assert len(found) == 1, (name, len(found))
    return found[0]


def test_every_span_appears(traced):
    names = {s["name"] for tr in traced[2].values() for s in _spans(tr)}
    assert set(TOP + INNER) <= names, sorted(set(TOP + INNER) - names)
    assert {n for n in names if n.startswith("hs.")} == set(TOP + INNER)


def test_map_iters_nest_in_map_once_an_iteration(traced):
    for t, tr in traced[2].items():
        spans = _spans(tr)
        iters = [s for s in spans if s["name"] == "hs.map.iter"]
        if t not in MAP_FRAMES:
            assert not iters and not any(s["name"] == "hs.map" for s in spans)
            continue
        step, phase = _one(spans, f"step{t}"), _one(spans, "hs.map")
        assert len(iters) == MAP_ITERS
        for s in iters + [s for s in spans if s["name"] in ("hs.map.setup", "hs.map.bin")]:
            assert s["tid"] == phase["tid"] == step["tid"]
            assert phase["ts0"] <= s["ts0"] <= s["ts1"] <= phase["ts1"]
        assert sorted(s["ts0"] for s in iters) == [s["ts0"] for s in iters]


def _union(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def test_top_level_spans_tile_each_step(traced):
    for t, tr in traced[2].items():
        spans = _spans(tr)
        step = _one(spans, f"step{t}")
        top = [s for s in spans if s["name"] in TOP]
        for s in top:
            assert s["tid"] == step["tid"] and step["ts0"] <= s["ts0"] <= s["ts1"] <= step["ts1"]
        covered = _union([(s["ts0"], s["ts1"]) for s in top])
        assert covered >= 0.95 * (step["ts1"] - step["ts0"]), (t, covered, step)
        # top-level spans do not overlap: each names one phase
        assert covered == pytest.approx(sum(s["ts1"] - s["ts0"] for s in top))


def test_no_span_without_a_profiler(untraced):
    runner = untraced[0]
    assert runner.stats["mapping_frame_time_count"] == len(MAP_FRAMES)
    assert runner.stats["map_stream_rows"] > 0


def test_traced_run_saves_the_untraced_params(traced, untraced):
    a, b = traced[1], untraced[1]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _binning_sums(binnings, cfg):
    from hierslam_torch.config import raster_config

    rc = raster_config(cfg)
    budget = rc.stream_rows_for(rc.grid(24, 32))
    return dict(map_stream_rows=sum(int(b.lists.n_rows) for b in binnings),
                map_stream_row_budget=budget * len(binnings),
                map_pairs_kept=sum(int(b.lists.n_refs) for b in binnings),
                map_pairs_dropped=sum(int(b.lists.n_dropped) for b in binnings))


@pytest.mark.parametrize("run", ["traced", "untraced"])
def test_stream_stats_are_the_binnings_sums(run, request):
    runner, _, _, by_frame = request.getfixturevalue(run)
    binnings = [b for t in MAP_FRAMES for b in by_frame[t]]
    assert len(binnings) == sum(len(by_frame[t]) for t in range(N_FRAMES)) > 0
    want = _binning_sums(binnings, runner.config)
    assert want["map_pairs_kept"] > 0
    for k, v in want.items():
        assert runner.stats[k] == v, k
        assert runner.runtime_summary()[k] == v, k
    assert runner.last_mapping_trace["pairs_kept"].dtype == np.int64


def test_step_counters_in_the_trace(traced):
    runner, _, traces, by_frame = traced
    for t, tr in traces.items():
        counters = tr[f"hierslam.step{t}"]
        assert set(counters) == set(runner.stats)
        want = (_binning_sums(by_frame[t], runner.config) if t in MAP_FRAMES
                else dict.fromkeys(("map_stream_rows", "map_stream_row_budget",
                                    "map_pairs_kept", "map_pairs_dropped"), 0))
        for k, v in want.items():
            assert counters[k] == v, (t, k)
        assert counters["mapping_iter_time_count"] == (MAP_ITERS if t in MAP_FRAMES else 0)


def test_to_host_keeps_values_and_dtypes():
    from hierslam_torch.slam.pipeline import _to_host

    g = torch.Generator().manual_seed(3)
    traces = {"loss": torch.randn(5, generator=g), "n": torch.full((5,), 2**40 + 3),
              "half": torch.randn(5, generator=g).to(torch.float64) * 1e-30}
    got = _to_host(traces)
    for k, v in traces.items():
        assert got[k].dtype == v.numpy().dtype
        np.testing.assert_array_equal(got[k], v.numpy())
