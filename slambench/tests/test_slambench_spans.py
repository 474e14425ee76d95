"""The readers of the program's spans and counters (``slambench/spans.py``
and the seven metrics that read it), on hand-built trace files; and, on the
card, that a span and the kernels launched inside it share one clock."""
import json

import pytest
import torch

from slambench import harness, spans
from slambench.frozen import trace as tl
from slambench.metrics import (densify_ms, host_syncs_per_map_iter, keyframe_select_ms,
                               map_bin_ms, map_iter_idle_pct, map_slot_use_pct,
                               window_upload_ms)

READERS = (densify_ms, keyframe_select_ms, window_upload_ms, map_bin_ms, map_iter_idle_pct,
           host_syncs_per_map_iter, map_slot_use_pct)


def _x(name, ts0, ts1, tid=1, cat="user_annotation", **args):
    return dict(ph="X", cat=cat, name=name, ts=ts0, dur=ts1 - ts0, tid=tid, args=args)


def _period(with_spans=True):
    """One posed frame and one mapping frame, microseconds.  The mapping
    frame's spans on the step's thread (1): densify 500, keyframes 200,
    window 200, two bins of 300 and 100, two iterations of 1000; a
    densify span on another thread (9), and one in the posed frame, which
    no mapping-frame reader may count."""
    ev = [_x("slambench.frame128.posed", 0, 1000), _x("slambench.frame135.map", 2000, 12000)]
    if with_spans:
        ev += [_x("hs.track", 10, 990), _x("hs.densify", 100, 900),
               _x("hs.densify", 2100, 2600), _x("hs.densify", 2200, 2300, tid=9),
               _x("hs.keyframes", 2600, 2800), _x("hs.window", 2800, 3000),
               _x("hs.map", 3000, 11900), _x("hs.map.setup", 3000, 3100),
               _x("hs.map.bin", 3100, 3400), _x("hs.map.bin", 3400, 3500),
               _x("hs.map.iter", 4000, 5000), _x("hs.map.iter", 5000, 6000)]
    # kernels: [4100, 4500] and [4900, 5200] meet the iterations for 500 + 200 us
    # of their 2000; [7000, 7100] lies outside them
    for i, (a, b) in enumerate([(4100, 4300), (4200, 4500), (4900, 5200), (7000, 7100)]):
        ev += [_x("cudaLaunchKernel", a - 50, a - 40, cat="cuda_runtime", correlation=i),
               _x(f"k{i}", a, b, tid=7, cat="kernel", correlation=i)]
    # syncs inside the iterations from three threads (3), one outside, and
    # runtime calls that do not wait
    ev += [_x("cudaStreamSynchronize", 4600, 4610, cat="cuda_runtime"),
           _x("cudaMemcpy", 5500, 5510, tid=2, cat="cuda_runtime"),
           _x("cudaEventSynchronize", 5990, 6010, tid=3, cat="cuda_runtime"),
           _x("cudaStreamSynchronize", 3450, 3460, cat="cuda_runtime"),
           _x("cudaMemcpyAsync", 5600, 5610, cat="cuda_runtime")]
    doc = {"traceEvents": ev}
    if with_spans:
        doc["hierslam.step128"] = {"map_stream_rows": 0, "map_pairs_kept": 0}
        doc["hierslam.step135"] = {"map_stream_rows": 10, "map_pairs_kept": 1000,
                                   "map_pairs_dropped": 4, "map_stream_row_budget": 20}
    return doc


WANT = {densify_ms: 0.5, keyframe_select_ms: 0.2, window_upload_ms: 0.2, map_bin_ms: 0.4,
        map_iter_idle_pct: 65.0, host_syncs_per_map_iter: 1.5,
        map_slot_use_pct: 100.0 * 1000 / (10 * 128)}


def _record(tmp_path, monkeypatch, doc):
    monkeypatch.setattr(harness, "OUT_DIR", str(tmp_path))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(doc))
    return dict(trace=tl.load(str(path)), k4_calls=[], track_iters=40, map_iters=2)


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.__name__.split(".")[-1])
def test_reader_on_a_hand_built_trace(reader, tmp_path, monkeypatch):
    record = _record(tmp_path, monkeypatch, _period())
    assert reader.read(record) == pytest.approx(WANT[reader], rel=1e-12)


def test_the_spans_of_the_record(tmp_path, monkeypatch):
    record = _record(tmp_path, monkeypatch, _period())
    tr = spans.read(record)
    assert [len(s) for s in spans.in_frames(tr, "hs.map.iter")] == [2]
    assert [len(s) for s in spans.in_frames(tr, "hs.track", "posed")] == [1]
    assert set(tr["counters"]) == {128, 135}


def test_none_where_the_file_is_another_period(tmp_path, monkeypatch):
    record = _record(tmp_path, monkeypatch, _period())
    record["trace"]["frames"][1] = dict(record["trace"]["frames"][1],
                                        ts1=record["trace"]["frames"][1]["ts1"] + 1)
    assert spans.read(record) is None
    assert all(r.read(record) is None for r in READERS)


def test_none_where_the_program_records_no_span(tmp_path, monkeypatch):
    record = _record(tmp_path, monkeypatch, _period(with_spans=False))
    assert spans.read(record) is None
    assert all(r.read(record) is None for r in READERS)


def test_device_readers_none_without_device_events(tmp_path, monkeypatch):
    doc = _period()
    doc["traceEvents"] = [e for e in doc["traceEvents"]
                          if e["cat"] not in ("kernel", "cuda_runtime")]
    record = _record(tmp_path, monkeypatch, doc)
    assert map_iter_idle_pct.read(record) is None
    assert host_syncs_per_map_iter.read(record) is None
    assert densify_ms.read(record) == pytest.approx(0.5)


def test_none_without_the_file(tmp_path, monkeypatch):
    record = _record(tmp_path, monkeypatch, _period())
    monkeypatch.setattr(harness, "OUT_DIR", str(tmp_path / "elsewhere"))
    assert all(r.read(record) is None for r in READERS)


def test_intervals():
    assert spans.union([(5, 6), (1, 3), (2, 4), (7, 7)]) == [(1, 4), (5, 6)]
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10


@pytest.mark.cuda
def test_a_span_and_its_kernels_share_the_clock(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels' device events exist on the card only")
    from torch.profiler import ProfilerActivity, profile

    from hierslam_torch.utils import trace

    x = torch.ones(1 << 22, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with trace.span("hs.clock"):
            y = x * 2.0
        torch.cuda.synchronize()
    assert float(y[0]) == 2.0
    path = tmp_path / "clock.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    (span,) = [e for e in ev if e.get("cat") == "user_annotation" and e.get("name") == "hs.clock"]
    launch = {e["args"]["correlation"]: e for e in ev
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    kernels = [e for e in ev if e.get("cat") == "kernel"]
    assert kernels
    for k in kernels:
        lk = launch[k["args"]["correlation"]]
        assert span["ts"] <= lk["ts"] <= span["ts"] + span["dur"], (span, lk)
        assert k["ts"] >= span["ts"], (span, k)
