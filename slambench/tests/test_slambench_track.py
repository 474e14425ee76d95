"""The cell ``replica_semantic_rgbd.slam_300k``: its files resolve, a tiny run of it
on the CPU comes out correct, the tracker forced back to one class of
slots that cuts every longer list comes out not correct at the witness
size, and the readers of its five tracking metrics read a hand-built
trace."""
import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import pytest
import torch

from slambench import cells, harness
from slambench.frozen import roofline, trace as tl
from slambench.metrics import (k2_track_roofline_pct, launches_per_track_iter, track_cache_ms,
                               track_iter_idle_pct, track_slot_use_pct)
from slambench.tests.test_slambench_rehearsal import FORBIDDEN, rehearse
from slambench.tests.tiny import tiny_spec

CELL = "replica_semantic_rgbd.slam_300k"
TRACK_METRICS = ("track_cache_ms", "track_iter_idle_pct", "launches_per_track_iter",
                 "track_slot_use_pct", "k2_track_roofline_pct")
READERS = (track_cache_ms, track_iter_idle_pct, launches_per_track_iter, track_slot_use_pct,
           k2_track_roofline_pct)


def one_class(prep, grid, config, opacities):
    """The tracker's lists as they were before the classes were sized from
    the counts: one class at the config's slots, every longer list cut
    there, the emission under its budgets."""
    from hierslam_torch.ops import binning

    return binning.bin_bucketed(
        prep.rect_min, prep.rect_max, prep.valid, prep.depth, grid, config.spec(),
        config.tile_shape, max_tiles_per_gaussian=config.max_tiles_per_gaussian), {}


def test_the_cell_resolves_to_its_files():
    spec = cells.cell_spec(CELL)
    cfg = cells.shipped_config(spec)
    assert not cfg["tracking"]["use_gt_poses"] and cfg["tracking"]["num_iters"] == 40
    posed = cells.cell_spec("replica_semantic.posed_300k")
    for k in ("map_gaussians", "resume_frame", "arc_frames", "sequence_frames",
              "warmup_periods"):
        assert spec["traffic"][k] == posed["traffic"][k], k
    assert {k: v for k, v in spec["limits"].items() if not k.startswith("track")} == \
        posed["limits"]
    assert {"track_loss_gap", "track_best_gap", "track_change_gap"} <= set(spec["limits"])
    assert {m["name"] for m in spec["per_layer"]} == set(TRACK_METRICS)
    assert not set(TRACK_METRICS) & {m["name"] for m in posed["per_layer"]}
    assert {m["name"] for m in spec["end_to_end"]} == \
        {"frames_per_s", "mapping_iter_ms", "peak_mem_gib", "setup_s"}


def test_rehearsal_tracks_and_runs_correct():
    out = rehearse(CELL)
    assert out["correct"] is True, out["check"]
    assert set(out["check"]) >= {"track_loss_gap", "track_best_gap", "track_change_gap"}
    assert out["frames"] == 8 and out["tracking_iter_ms"] > 0
    assert out["peak_mem_gib"] is None and not out["cuda_initialized"]
    assert not FORBIDDEN & set(out["modules"])


def test_one_cut_class_at_the_witness_size_is_not_correct(monkeypatch):
    """At 96x64 with 256 tracking slots the cap binds; the tracker's lists
    cut at one class of 256 slots, as before the classes were sized from
    the counts, read the first tracking loss far off the dense reference."""
    from hierslam_torch.ops import render_tracked

    spec = tiny_spec(CELL)
    spec["config"]["set"]["raster.track_max_per_tile"] = 256
    monkeypatch.setattr(render_tracked, "track_lists", one_class)
    res = harness.run_cell(spec, 2**31 + 5, 0.0, False, time.time(), "cpu", log=lambda s: None)
    assert res["correct"] is False
    gap = res["check"]["track_loss_gap"]
    assert gap["value"] > gap["limit"], res["check"]


@pytest.mark.cuda
def test_within_the_class_the_card_takes_the_one_class_lists_to_the_bit(tmp_path, monkeypatch):
    """On the card, at the witness size with 4,096 slots, where no tile holds
    more pairs than the class and no emission budget binds: the pose cache
    and the tracking phase (K1/K2) are the one-class path's to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1/K2 and bin_emit run on the card only")
    from hierslam_torch.ops import kernels, render_tracked
    from hierslam_torch.slam.pipeline import SLAMRunner
    from hierslam_torch.slam.tracking import propagate_pose

    kernels.build()
    dev = torch.device("cuda", 0)
    spec = tiny_spec(CELL)
    spec["config"]["set"]["raster.track_max_per_tile"] = 4096
    traffic, conf = spec["traffic"], spec["config"]
    S, seed = int(traffic["resume_frame"]), 2**31 + 21
    ds = cells.RoomSequence(conf["frames"], traffic["arc_frames"], traffic["sequence_frames"],
                            dev)
    cfg = cells.run_config(spec, seed, str(tmp_path))
    n_sem = int(sum(ds.num_semantic[:-1]))
    seeded = cells.make_map(ds, int(traffic["map_gaussians"]), S, seed, n_sem)
    cells.write_checkpoint(os.path.join(str(tmp_path), "run"), seeded, ds, S,
                           cfg["keyframe_every"],
                           cells.decoder_weights(n_sem, ds.num_semantic_class, seed))
    runner = SLAMRunner(cfg, dataset=ds, device=dev)
    im_np, depth_np, _, _ = runner._load_frame(S)
    runner.params = propagate_pose(runner.params, S, True)
    p_b, v_b = runner._sliced_state()
    im, depth = torch.as_tensor(im_np, device=dev), torch.as_tensor(depth_np, device=dev)
    q0, t0 = p_b["cam_unnorm_rots"][0, :, S], p_b["cam_trans"][0, :, S]
    rc = replace(runner.rc, max_per_tile=4096, bucket_spec=((-1, 4096),), sat_margin=0.0)

    def run():
        cache = render_tracked.build_track_cache(p_b, v_b["active"], q0, t0, runner.camera, rc,
                                                 margin_px=16.0)
        return cache, runner.tracker(p_b, v_b["active"], v_b["max_2D_radius"], im, depth, S)
    sized, out = run()
    monkeypatch.setattr(render_tracked, "track_lists", one_class)
    flat, ref = run()
    assert int(flat.n_dropped) == 0 and int(flat.count.max()) <= 4096
    assert sized.counters["classes"] == 1 and sized.counters["pairs_dropped"] == 0
    for f in render_tracked.TrackCache._fields[:-1]:
        a, b = getattr(sized, f), getattr(flat, f)
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert torch.equal(x, y), f
    assert all(torch.equal(a, b) for a, b in zip(out[3], ref[3]))
    assert torch.equal(out[1], ref[1])
    for k in ("cam_unnorm_rots", "cam_trans"):
        assert torch.equal(out[0][k], ref[0][k]), k


def _x(name, ts0, ts1, tid=1, cat="user_annotation", **args):
    return dict(ph="X", cat=cat, name=name, ts=ts0, dur=ts1 - ts0, tid=tid, args=args)


def _period(tracked=True):
    """A tracking frame and a mapping frame (us), both tracked on thread 1:
    caches of 1000 and 500, three iterations of 1000; kernels launched
    inside them from thread 1 and from the autograd engine's thread (5),
    and one outside them."""
    ev = [_x("slambench.frame129.track", 0, 10000), _x("slambench.frame135.map", 20000, 40000)]
    if tracked:
        ev += [_x("hs.track", 10, 9990), _x("hs.track.cache", 100, 1100),
               _x("hs.track.iter", 2000, 3000), _x("hs.track.iter", 3000, 4000),
               _x("hs.track", 20010, 22500), _x("hs.track.cache", 20100, 20600),
               _x("hs.track.iter", 21000, 22000), _x("hs.map", 23000, 39000)]
    kernels = [(2100, 1, 2200, 2600, "void blend_fwd_kernel<3>"),
               (2700, 5, 2800, 2900, "void blend_bwd_kernel<3>"),
               (3100, 1, 3200, 3500, "void blend_bwd_kernel<3>"),
               (21100, 5, 21200, 21300, "void blend_bwd_kernel<3>"),
               (5000, 1, 5100, 5200, "other")]
    for i, (launch, tid, a, b, name) in enumerate(kernels):
        ev += [_x("cudaLaunchKernel", launch, launch + 10, tid=tid, cat="cuda_runtime",
                  correlation=i),
               _x(name, a, b, tid=7, cat="kernel", correlation=i)]
    doc = {"traceEvents": ev}
    if tracked:
        doc["hierslam.step129"] = dict(track_pairs=600, track_slots=1000, track_tiles=2,
                                       track_classes=1, track_pairs_dropped=0)
        doc["hierslam.step135"] = dict(track_pairs=300, track_slots=1000, track_tiles=2,
                                       track_classes=1, track_pairs_dropped=0)
    return doc


def _record(tmp_path, monkeypatch, doc):
    monkeypatch.setattr(harness, "OUT_DIR", str(tmp_path))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(doc))
    return dict(trace=tl.load(str(path)), k4_calls=[], track_iters=40, map_iters=60)


# K2's bytes: slots x 10 columns x 4 written, pairs x 41 read, 256 pixels x 10 x 4
# a tile read; two iterations of frame 129's cache and one of frame 135's, over the
# three K2 launches' 0.5 ms
K2_BYTES = 2 * (40000 + 600 * 41 + 2 * 10240) + (40000 + 300 * 41 + 2 * 10240)
WANT = {track_cache_ms: 0.75, track_iter_idle_pct: 70.0, launches_per_track_iter: 4 / 3,
        track_slot_use_pct: 45.0,
        k2_track_roofline_pct: 100.0 * K2_BYTES / roofline.HBM_BYTES_PER_S * 1e3 / 0.5}


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.__name__.split(".")[-1])
def test_reader_on_a_hand_built_trace(reader, tmp_path, monkeypatch):
    record = _record(tmp_path, monkeypatch, _period())
    assert reader.read(record) == pytest.approx(WANT[reader], rel=1e-12)


def test_readers_none_where_no_frame_tracks(tmp_path, monkeypatch):
    record = _record(tmp_path, monkeypatch, _period(tracked=False))
    assert all(r.read(record) is None for r in READERS)


def test_the_metrics_import_nothing_of_jax():
    code = ("import sys; import slambench.metrics.k2_track_roofline_pct, "
            "slambench.metrics.launches_per_track_iter; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert not FORBIDDEN & set(eval(r.stdout))
