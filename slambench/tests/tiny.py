"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds (tests only)."""
import copy

from slambench import cells

TINY_FRAMES = dict(W=96, H=64, fx=48.0, fy=48.0, cx=47.5, cy=31.5)
TINY_SET = {"map_capacity": 65536, "tracking.num_iters": 4, "mapping.num_iters": 4,
            "raster.bucket_spec": [[-1, 4096]], "raster.track_max_per_tile": 4096,
            "raster.stream_rows": 20000}   # budgets that drop no pair at this size


def tiny_spec(cell: str, n: int = 4000, resume: int = None) -> dict:
    spec = copy.deepcopy(cells.cell_spec(cell))
    period = cells.shipped_config(spec)["map_every"]
    spec["config"]["frames"].update(TINY_FRAMES)
    spec["config"]["set"] = dict(TINY_SET)
    S = resume if resume is not None else max(8, period)
    spec["traffic"].update(map_gaussians=n, resume_frame=S, arc_frames=40,
                           sequence_frames=S + 8 * period + 16)
    return spec
