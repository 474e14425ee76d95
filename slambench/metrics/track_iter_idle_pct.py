"""The share of the tracking iterations' host time in which no kernel runs:
100 less the union of the kernels' device intervals, clipped to the
program's ``hs.track.iter`` spans, over those spans' total."""
from slambench import spans, track_spans


def read(record):
    tr = spans.read(record)
    iters = [] if tr is None else track_spans.iters(tr)
    if not iters or not any(e["cat"] == "kernel" for e in tr["device"]):
        return None
    its = spans.union((s["ts0"], s["ts1"]) for s in iters)
    total = sum(b - a for a, b in its)
    kernels = spans.union((e["ts"], e["ts"] + e["dur"]) for e in tr["device"]
                          if e["cat"] == "kernel")
    return 100.0 * (1.0 - spans.overlap(its, kernels) / total)
