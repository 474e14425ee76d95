"""The tracker's pose-cache build: the ``hs.track.cache`` spans summed a
frame (``ops/render_tracked.py::build_track_cache``: the binning, the one
read of the tiles' counts, the gathers), averaged over the traced period's
frames that built one."""
from slambench import spans, track_spans


def read(record):
    tr = spans.read(record)
    per = [] if tr is None else [f for f in track_spans.per_frame(tr, "hs.track.cache") if f]
    if not per:
        return None
    return sum(s["ts1"] - s["ts0"] for f in per for s in f) / 1e3 / len(per)
