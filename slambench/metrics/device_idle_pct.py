"""The share of the traced period's wall time that no kernel covers: 100
less the union of the kernels' intervals over the window."""
from slambench.frozen import trace as tl


def read(record):
    tr = record["trace"]
    if not any(e["cat"] == "kernel" for e in tr["device"]):
        return None
    t0, t1 = tl.window(tr)
    return 100.0 * (1.0 - tl.busy_us(tr, ("kernel",)) / (t1 - t0))
