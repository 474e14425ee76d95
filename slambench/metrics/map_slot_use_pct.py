"""The share of the mapping stream's slots that hold a pair: 100 times the
pairs the mapping binnings kept over their rows times 128 pairs a row,
from the program's ``hierslam.step<t>`` counters of the traced period's
mapping frames (``map_pairs_kept``, ``map_stream_rows``)."""
from slambench import spans

RW = 128   # pairs a stream row (hierslam_torch/ops/render_stream.py RW)


def read(record):
    tr = spans.read(record)
    if tr is None:
        return None
    steps = [tr["counters"].get(f["t"]) for f in tr["frames"] if f["kind"] == "map"]
    steps = [c for c in steps if c and c.get("map_stream_rows")]
    if not steps:
        return None
    kept = sum(c["map_pairs_kept"] for c in steps)
    return 100.0 * kept / (RW * sum(c["map_stream_rows"] for c in steps))
