"""K2 (``csrc/blend.cu`` ``blend_bwd_kernel``) as a share of its roofline in
the traced period: the least time of the work the tracker's pose caches
need (``frozen/k2_work.k2_work`` of each frame's ``hierslam.step<t>``
counters ``track_slots``, ``track_pairs``, ``track_tiles``, once for each
of the frame's ``hs.track.iter`` spans, through ``frozen/roofline.bound``)
over the device time of every K2 launch in the period.  In a full-SLAM
period every K2 launch is the tracker's: densify and the progress renders
run K1 only, the mapper the stream kernels.  A frame that builds a second
cache (the depth-loss escape hatch) would count each cache's work for all
of its iterations."""
from slambench import spans, track_spans
from slambench.frozen import k2_work, roofline, trace as tl

KERNEL = "blend_bwd_kernel"


def read(record):
    tr = spans.read(record)
    if tr is None:
        return None
    iters = {f["t"]: 0 for f in tr["frames"]}
    for s in track_spans.iters(tr):
        f = next(f for f in tr["frames"] if f["ts0"] <= s["ts0"] <= f["ts1"])
        iters[f["t"]] += 1
    bound = 0.0
    for t, n in iters.items():
        c = tr["counters"].get(t) or {}
        if n and c.get("track_slots"):
            work = k2_work.k2_work(c["track_slots"], c["track_pairs"], c["track_tiles"])
            bound += n * roofline.bound(*work)[0]
    times = tl.kernel_times_ms(record["trace"], KERNEL)
    if not bound or not times:
        return None
    return 100.0 * bound / sum(times)
