"""Kernel launches a mapping iteration: the mapping frame's launches less
the mean of the period's other frames, over its mapping iterations
(``chip_smoke.py``'s ``profile_summary`` arithmetic)."""
from slambench.frozen import trace as tl


def read(record):
    tr = record["trace"]
    maps = tl.frames_of(tr, "map")
    others = [f for f in tr["frames"] if f["kind"] != "map"]
    if not maps or not others or not tr["device"]:
        return None
    by = tl.launches_by_frame(tr)
    rest = sum(by[f["t"]] for f in others) / len(others)
    return (sum(by[f["t"]] for f in maps) / len(maps) - rest) / record["map_iters"]
