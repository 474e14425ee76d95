"""K4 (``csrc/stream.cu`` ``stream_bwd_kernel``) as a share of its roofline:
the least time of the work the recorded calls' pair streams need
(``frozen/roofline.k4_bound_ms``) over those calls' device time in the
trace (the first launches of that kernel, one a recorded call)."""
from slambench.frozen import roofline, trace as tl

KERNEL = "stream_bwd_kernel"


def read(record):
    calls = record["k4_calls"]
    times = tl.kernel_times_ms(record["trace"], KERNEL)[:len(calls)]
    if not calls or len(times) < len(calls):
        return None
    bound = sum(roofline.k4_bound_ms(c["stream"], c["sc"], c["row_off"],
                                     (None, c["grid_x"]), c["tile_shape"], c["n_feat"],
                                     c["img_shape"]) for c in calls)
    return 100.0 * bound / sum(times)
