"""Host syncs a mapping iteration: the CUDA runtime calls that wait for the
device (``spans.SYNCS``) that start inside the program's ``hs.map.iter``
spans, from every thread (the autograd engine runs the backward on a
thread of its own), over the number of those spans."""
from slambench import spans


def read(record):
    tr = spans.read(record)
    iters = [] if tr is None else spans.map_iters(tr)
    if not iters or not tr["runtime"]:   # no CUDA runtime traced: no device
        return None
    its = spans.union((s["ts0"], s["ts1"]) for s in iters)
    n = sum(1 for e in tr["runtime"] if e["name"] in spans.SYNCS
            and any(a <= e["ts0"] <= b for a, b in its))
    return n / len(iters)
