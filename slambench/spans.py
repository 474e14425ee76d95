"""The program's own spans and counters in the traced period's trace.

The harness hands a metric only ``record["trace"]`` (the frames' spans and
the device events, ``frozen/trace.load``).  The ``hs.*`` spans that
``hierslam_torch`` records inside ``SLAMRunner.step`` while a profiler runs
(``hierslam_torch/utils/trace.py``), the CUDA runtime events of every
thread and the ``hierslam.step<t>`` counters at the root of the trace are
read here from the same file, ``trace.json`` in ``harness.OUT_DIR``,
parsed once for all metrics (cached by path and modification time).

``read(record)`` returns None where that file's ``slambench.frame*`` spans
are not the record's, or where it holds no ``hs.*`` span (a program that
records none): each metric that reads it is then left out of the line.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Tuple

from slambench import harness
from slambench.frozen import trace as tl

SPAN_PREFIX = "hs."
COUNTERS = "hierslam.step"   # + "<t>": the step's changes of SLAMRunner.stats
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")


@functools.lru_cache(maxsize=2)
def _parse(path: str, mtime_ns: int) -> Dict:
    with open(path) as f:
        doc = json.load(f)
    frames, spans, runtime = [], [], []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        name, cat, ts0, ts1 = e.get("name", ""), e.get("cat"), e["ts"], e["ts"] + e["dur"]
        if cat == "user_annotation":
            m = tl._FRAME_RE.match(name)
            if m:
                frames.append((int(m.group(1)), m.group(2), ts0, ts1, e.get("tid")))
            elif name.startswith(SPAN_PREFIX):
                spans.append(dict(name=name, ts0=ts0, ts1=ts1, tid=e.get("tid")))
        elif cat in tl.LAUNCH_CATS:
            runtime.append(dict(name=name, ts0=ts0, ts1=ts1, tid=e.get("tid"),
                                correlation=e.get("args", {}).get("correlation")))
    counters = {int(k[len(COUNTERS):]): v for k, v in doc.items()
                if k.startswith(COUNTERS) and k[len(COUNTERS):].isdigit() and isinstance(v, dict)}
    frames.sort(key=lambda f: f[2])
    spans.sort(key=lambda s: s["ts0"])
    return dict(frames=frames, spans=spans, runtime=runtime, counters=counters)


def read(record) -> Optional[Dict]:
    """The program's spans, the runtime events and the step counters of
    the record's traced period, with its frames and device events; None
    where the trace file is not the record's or holds no ``hs.*`` span."""
    p = os.path.join(harness.OUT_DIR, "trace.json")
    try:
        mtime = os.stat(p).st_mtime_ns
    except OSError:
        return None
    doc = _parse(p, mtime)
    frames = record["trace"]["frames"]
    if doc["frames"] != [(f["t"], f["kind"], f["ts0"], f["ts1"], f["tid"]) for f in frames]:
        return None
    if not doc["spans"]:
        return None
    return dict(doc, frames=frames, device=record["trace"]["device"])


def in_frames(tr: Dict, name: str, kind: str = "map") -> List[List[Dict]]:
    """For each frame of ``kind``, the spans named ``name`` on its thread
    inside its interval."""
    return [[s for s in tr["spans"] if s["name"] == name and s["tid"] == f["tid"]
             and f["ts0"] <= s["ts0"] and s["ts1"] <= f["ts1"]]
            for f in tr["frames"] if f["kind"] == kind]


def ms_per_frame(record, name: str, kind: str = "map") -> Optional[float]:
    """The summed duration (ms) of the spans named ``name`` a frame of
    ``kind``, averaged over those frames; None where there is none."""
    tr = read(record)
    if tr is None:
        return None
    per = in_frames(tr, name, kind)
    if not per or not any(per):
        return None
    return sum(s["ts1"] - s["ts0"] for spans in per for s in spans) / 1e3 / len(per)


def union(intervals) -> List[Tuple[float, float]]:
    """Sorted disjoint intervals covering the same points."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(xs: List[Tuple[float, float]], ys: List[Tuple[float, float]]) -> float:
    """The length common to two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def map_iters(tr: Dict) -> List[Dict]:
    """The ``hs.map.iter`` spans of the period's mapping frames."""
    return [s for spans in in_frames(tr, "hs.map.iter") for s in spans]
