"""Kernel launches a tracking iteration: the kernels whose launch call
starts inside one of the program's ``hs.track.iter`` spans, by time and
from every thread (the autograd engine launches the backward's kernels
from a thread of its own), over the number of those spans."""
import bisect

from slambench import spans, track_spans


def read(record):
    tr = spans.read(record)
    iters = [] if tr is None else track_spans.iters(tr)
    if not iters or not tr["runtime"]:   # no CUDA runtime traced: no device
        return None
    its = spans.union((s["ts0"], s["ts1"]) for s in iters)
    starts = [a for a, _ in its]

    def inside(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= its[i][1]
    launched = {e["correlation"] for e in tr["runtime"]
                if e["correlation"] is not None and inside(e["ts0"])}
    n = sum(1 for e in tr["device"] if e["cat"] == "kernel"
            and e.get("args", {}).get("correlation") in launched)
    return n / len(iters)
