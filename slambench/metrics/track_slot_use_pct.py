"""The share of the tracker's slots that hold a pair: 100 times the pairs
in the pose caches' lists over the slots of their classes (n_b k_b summed),
from the program's ``hierslam.step<t>`` counters ``track_pairs`` and
``track_slots`` of the traced period's frames."""
from slambench import spans


def read(record):
    tr = spans.read(record)
    if tr is None:
        return None
    steps = [tr["counters"].get(f["t"]) for f in tr["frames"]]
    steps = [c for c in steps if c and c.get("track_slots")]
    if not steps:
        return None
    return 100.0 * sum(c["track_pairs"] for c in steps) / sum(c["track_slots"] for c in steps)
