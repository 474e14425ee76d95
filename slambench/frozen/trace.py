"""Reading a ``torch.profiler`` Chrome trace of a traced period.

The arithmetic of ``chip_smoke.py``'s ``trace_summary`` and
``profile_summary`` (commit 2c704bc: kernel events, launches a tracking
iteration from tracking-only frames, a mapping iteration as the mapping
frame less the other frames), generalised from two traced frames to the
frames of one period.  Frames are told apart by the ``record_function``
span the harness puts round each ``step`` (``FRAME_SPAN``); a kernel
belongs to the frame whose span holds the host call that launched it, on
the thread that runs ``step``: a launch from another thread (the loader's
copies) belongs to no frame.
"""
from __future__ import annotations

import bisect
import json
import re
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")   # device events of a Chrome trace
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
FRAME_SPAN = "slambench.frame"   # + "<t>.<track|map|posed>"
_FRAME_RE = re.compile(r"^slambench\.frame(\d+)\.(\w+)$")


def load(path: str) -> Dict:
    """The parts of the trace the metrics read: device events, kernel
    events with the frame that launched them, and the frames' spans."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    frames = []
    for e in events:
        m = _FRAME_RE.match(e.get("name", ""))
        if m and e.get("cat") == "user_annotation":
            frames.append(dict(t=int(m.group(1)), kind=m.group(2), ts0=e["ts"],
                               ts1=e["ts"] + e["dur"], tid=e.get("tid")))
    frames.sort(key=lambda f: f["ts0"])
    launch = {e["args"]["correlation"]: (e["ts"], e.get("tid")) for e in events
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    device = sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    starts = [f["ts0"] for f in frames]
    for e in device:
        e["frame"] = None
        ts, tid = launch.get(e.get("args", {}).get("correlation"), (None, None))
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= frames[i]["ts1"] and tid == frames[i]["tid"]:
            e["frame"] = frames[i]["t"]
    return dict(frames=frames, device=device)


def window(tr: Dict) -> Tuple[float, float]:
    """The traced window (us): from the first frame's start to the end of
    the last frame's span or of the last device event, whichever is later."""
    t0 = tr["frames"][0]["ts0"]
    t1 = max([tr["frames"][-1]["ts1"]] + [e["ts"] + e["dur"] for e in tr["device"]])
    return t0, t1


def busy_us(tr: Dict, cats=DEVICE_CATS) -> float:
    """The union of the device events' intervals inside the window (us)."""
    t0, t1 = window(tr)
    total, cur0, cur1 = 0.0, None, None
    for e in tr["device"]:
        if e["cat"] not in cats:
            continue
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b <= a:
            continue
        if cur1 is None or a > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        total += cur1 - cur0
    return total


def launches_by_frame(tr: Dict) -> Dict[int, int]:
    out = {f["t"]: 0 for f in tr["frames"]}
    for e in tr["device"]:
        if e["cat"] == "kernel" and e["frame"] is not None:
            out[e["frame"]] += 1
    return out


def kernel_times_ms(tr: Dict, part: str) -> List[float]:
    """Device times (ms) of the kernels whose name holds ``part``, in order."""
    return [e["dur"] / 1e3 for e in tr["device"] if e["cat"] == "kernel" and part in e["name"]]


def top_device_ops(tr: Dict, n: int = 10) -> List[List]:
    """The ``n`` device operations that took most time: [name, seconds]."""
    by_name: Dict[str, float] = {}
    for e in tr["device"]:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: Dict, n: int = 10) -> List[List]:
    """The ``n`` longest gaps between device events in the window, each
    named by the frame whose span holds the gap's middle on the host
    ("frame128.track", "frame135.map", "between frames"): [name, seconds]."""
    t0, t1 = window(tr)
    gaps, end = [], t0
    for e in tr["device"]:
        if e["ts"] > end:
            gaps.append((end, e["ts"]))
        end = max(end, e["ts"] + e["dur"])
    if t1 > end:
        gaps.append((end, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:n]:
        mid = 0.5 * (a + b)
        name = "between frames"
        for f in tr["frames"]:
            if f["ts0"] <= mid <= f["ts1"]:
                name = f"frame{f['t']}.{f['kind']}"
                break
        out.append([name, (b - a) / 1e6])
    return out


def frames_of(tr: Dict, kind: Optional[str] = None) -> List[Dict]:
    return [f for f in tr["frames"] if kind is None or f["kind"] == kind]
