"""A tiny run of a cell on the CPU with the plain versions (tests only):

    python3 -m slambench.tests.rehearse CELL [FAULT]

prints one JSON line: what the run gave, the check, and the top-level
names of the modules the process loaded.  FAULT plants one fault under
the timed path: ``unchanged`` (tracking and mapping return the state they
were given), ``half_batch`` (the losses over half of the image rows),
``altered`` (the tracked pose and the mapped means moved by 1 cm)."""
import contextlib
import json
import sys
import time

import torch

from slambench import harness
from slambench.tests.tiny import tiny_spec


def half_batch_losses(out, *args, fn, **kw):
    """A loss over the top half of the image rows only (a planted fault:
    half of the batch left out, the mean taken over the rest)."""
    H = out.depth.shape[-2]
    h = H // 2

    def cut(x):
        return x[..., :h, :] if isinstance(x, torch.Tensor) and x.dim() >= 2 and \
            x.shape[-2] == H else x
    out = out._replace(**{f: cut(getattr(out, f)) for f in out._fields})
    args = [cut(a) for a in args]
    kw = {k: (None if k == "gt_ssim" else cut(x)) for k, x in kw.items()}
    return fn(out, *args, **kw)


@contextlib.contextmanager
def planted_half_batch(tracking_module, mapping_module):
    """Plant ``half_batch_losses`` under a tracking and a mapping module."""
    t_orig, m_orig = tracking_module.tracking_loss, mapping_module.mapping_loss
    tracking_module.tracking_loss = lambda out, *a, **k: half_batch_losses(out, *a, fn=t_orig,
                                                                           **k)
    mapping_module.mapping_loss = lambda out, *a, **k: half_batch_losses(out, *a, fn=m_orig,
                                                                         **k)
    try:
        yield
    finally:
        tracking_module.tracking_loss, mapping_module.mapping_loss = t_orig, m_orig


def plant(fault):
    def unchanged(runner):
        tracker, mapper = runner.tracker, runner.mapper

        def track(p_b, active, maxrad, im, depth, t):
            res = tracker(p_b, active, maxrad, im, depth, t)
            return (p_b,) + tuple(res[1:])
        track.continue_round = tracker.continue_round

        def map_phase(p_b, v_b, *rest):
            res = mapper(p_b, v_b, *rest)
            return (p_b, v_b, rest[2], rest[3], res[4])
        runner.tracker, runner.mapper = track, map_phase

    def altered(runner):
        tracker, mapper = runner.tracker, runner.mapper

        def track(p_b, active, maxrad, im, depth, t):
            res = tracker(p_b, active, maxrad, im, depth, t)
            p = dict(res[0])
            p["cam_trans"] = p["cam_trans"].clone()
            p["cam_trans"][0, 0, t] += 0.01
            return (p,) + tuple(res[1:])
        track.continue_round = tracker.continue_round

        def map_phase(*args):
            res = mapper(*args)
            p = dict(res[0])
            p["means3D"] = p["means3D"] + 0.01
            return (p,) + tuple(res[1:])
        runner.tracker, runner.mapper = track, map_phase

    return {"unchanged": unchanged, "altered": altered}.get(fault)


def main(cell, fault=None):
    spec = tiny_spec(cell)
    t0 = time.time()
    if fault == "half_batch":
        from hierslam_torch.slam import mapping, tracking
        with planted_half_batch(tracking, mapping):
            res = harness.run_cell(spec, 2**31 + 5, 0.0, False, t0, "cpu", log=lambda s: None)
    else:
        res = harness.run_cell(spec, 2**31 + 5, 0.0, False, t0, "cpu", plant=plant(fault),
                               log=lambda s: None)
    out = {k: res.get(k) for k in ("frames", "frames_per_s", "tracking_iter_ms",
                                   "mapping_iter_ms", "peak_mem_gib", "memory_peak_bytes",
                                   "correct", "check")}
    out["modules"] = sorted({m.split(".")[0] for m in sys.modules})
    out["cuda_initialized"] = torch.cuda.is_initialized()
    print(json.dumps(out))


if __name__ == "__main__":
    main(*sys.argv[1:])
