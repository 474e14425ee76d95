"""The tracker's tile lists sized from the tiles' own counts, on the CPU.

``ops/render_tracked.build_track_cache`` bins a frame once with a 16 px
margin; under one configured class (``raster.track_max_per_tile``) that
class is the least, and a tile that holds more pairs takes a class of
twice, four times ... its slots (``ops/binning.bin_to_need``), so that no
pair is dropped.  The scene is the benchmark's cell
``replica_semantic_rgbd.slam_300k`` cut to 96x64 with a map of 4,000 gaussians
(``slambench/tests/tiny.py``), resumed at frame 8 as the benchmark resumes
it; the tracking phase of frame 8 is held to the dense reference
(``slambench/reference/dense.py``, which imports nothing of the program)
within the cell's own limits.  At 256 slots the cap binds there: the
tracker before its classes were sized (one class, every list cut at 256)
reads the first tracking loss about 0.9 off.
"""
import json
import os
from dataclasses import replace

import torch

from hierslam_torch.ops import binning, render_tracked
from hierslam_torch.slam.pipeline import SLAMRunner
from hierslam_torch.slam.tracking import TRACK_COUNTERS, propagate_pose
from slambench import cells, harness
from slambench.reference import check
from slambench.tests.tiny import tiny_spec

torch.set_num_threads(2)

CELL = "replica_semantic_rgbd.slam_300k"
SEED = 2**31 + 5
TRACK_NUMBERS = ("track_loss_gap", "track_best_gap", "track_change_gap")


def one_class_lists(prep, grid, config, opacities):
    """The lists the tracker took before its classes were sized: one class
    at the config's slots, every longer list cut there, the emission under
    its budgets (``binning.bin_bucketed``)."""
    lists = binning.bin_bucketed(prep.rect_min, prep.rect_max, prep.valid, prep.depth, grid,
                                 config.spec(), config.tile_shape,
                                 max_tiles_per_gaussian=config.max_tiles_per_gaussian)
    return lists, {}


def resumed(tmp_path, k_min: int, iters: int = None):
    """The cell at the witness size with ``k_min`` tracking slots, resumed
    at its resume frame as ``slambench/harness.py`` resumes it -> (runner,
    the benchmark's inputs for the check, the resume frame, the limits)."""
    spec = tiny_spec(CELL)
    spec["config"]["set"]["raster.track_max_per_tile"] = k_min
    if iters is not None:
        spec["config"]["set"]["tracking.num_iters"] = iters
    traffic, conf = spec["traffic"], spec["config"]
    S = int(traffic["resume_frame"])
    ds = cells.RoomSequence(conf["frames"], traffic["arc_frames"], traffic["sequence_frames"],
                            "cpu")
    cfg = cells.run_config(spec, SEED, str(tmp_path))
    n_sem = int(sum(ds.num_semantic[:-1]))
    seeded = cells.make_map(ds, int(traffic["map_gaussians"]), S, SEED, n_sem)
    cells.write_checkpoint(os.path.join(str(tmp_path), "run"), seeded, ds, S,
                           cfg["keyframe_every"],
                           cells.decoder_weights(n_sem, ds.num_semantic_class, SEED))
    runner = SLAMRunner(cfg, dataset=ds, device="cpu")
    rots, trans = cells.checkpoint_poses(ds, S)
    inputs = dict(ds=ds, map=seeded, cfg=cfg, S=S, rots=rots, trans=trans)
    return runner, inputs, S, spec["limits"]


def first_track_numbers(runner, inputs, S):
    """Step frame ``S`` (tracking only) with the harness's recorder, then
    the tracking numbers against the dense reference."""
    rec = harness.Recorder(runner)
    runner.step(S)
    rec.close()
    ref = check.reference_observations(inputs, rec.obs, "cpu")
    return check.numbers(rec.obs, ref)


def tracker_inputs(runner, t):
    im_np, depth_np, _, _ = runner._load_frame(t)
    params = propagate_pose(runner.params, t, runner.config["tracking"]["forward_prop"])
    runner.params = params
    p_b, v_b = runner._sliced_state()
    return p_b, v_b, torch.as_tensor(im_np), torch.as_tensor(depth_np)


def test_witness_with_a_binding_cap_agrees_with_the_dense_reference(tmp_path, monkeypatch):
    runner, inputs, S, limits = resumed(tmp_path, 256)
    nums = first_track_numbers(runner, inputs, S)
    s = runner.stats
    assert s["track_classes"] > 1 and s["track_slots"] > 256 * s["track_tiles"]   # it binds
    assert s["track_pairs_dropped"] == 0
    for k in TRACK_NUMBERS:
        assert nums[k] <= limits[k], (k, nums)
    # the lists cut at 256 slots read the first tracking loss far off
    runner, inputs, S, _ = resumed(tmp_path / "cut", 256)
    monkeypatch.setattr(render_tracked, "track_lists", one_class_lists)
    cut = first_track_numbers(runner, inputs, S)
    assert cut["track_loss_gap"] > 0.5, cut


def test_lists_within_the_class_are_the_one_class_lists_to_the_bit(tmp_path, monkeypatch):
    """Where no tile holds more pairs than the class and no emission budget
    binds, the cache, the losses and the best pose are the one-class
    path's to the bit."""
    runner, _, S, _ = resumed(tmp_path, 4096)
    p_b, v_b, im, depth = tracker_inputs(runner, S)
    q0, t0 = p_b["cam_unnorm_rots"][0, :, S], p_b["cam_trans"][0, :, S]
    rc = replace(runner.rc, max_per_tile=4096, bucket_spec=((-1, 4096),), sat_margin=0.0)

    sized = render_tracked.build_track_cache(p_b, v_b["active"], q0, t0, runner.camera, rc,
                                             margin_px=16.0)
    out = runner.tracker(p_b, v_b["active"], v_b["max_2D_radius"], im, depth, S)
    with monkeypatch.context() as mp:
        mp.setattr(render_tracked, "track_lists", one_class_lists)
        flat = render_tracked.build_track_cache(p_b, v_b["active"], q0, t0, runner.camera, rc,
                                                margin_px=16.0)
        ref = runner.tracker(p_b, v_b["active"], v_b["max_2D_radius"], im, depth, S)
    assert int(flat.n_dropped) == 0 and int(flat.count.max()) <= 4096
    assert sized.counters["classes"] == 1 and sized.counters["pairs_dropped"] == 0
    for f in render_tracked.TrackCache._fields:
        a, b = getattr(sized, f), getattr(flat, f)
        if f == "counters":
            continue
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert torch.equal(x, y), f
    assert all(torch.equal(a, b) for a, b in zip(out[3], ref[3]))       # the loss traces
    assert torch.equal(out[1], ref[1])                                  # the best loss
    for k in ("cam_unnorm_rots", "cam_trans"):
        assert torch.equal(out[0][k], ref[0][k]), k


def test_counters_of_a_seeded_scene(tmp_path):
    runner, _, S, _ = resumed(tmp_path, 256)
    p_b, v_b, _, _ = tracker_inputs(runner, S)
    rc = replace(runner.rc, max_per_tile=256, bucket_spec=((-1, 256),), sat_margin=0.0)
    cache = render_tracked.build_track_cache(
        p_b, v_b["active"], p_b["cam_unnorm_rots"][0, :, S], p_b["cam_trans"][0, :, S],
        runner.camera, rc, margin_px=16.0)
    c = cache.counters
    shapes = [tuple(v.shape) for v in cache.slot_valid if v.shape[0] > 0]
    counts = cache.count.numpy()
    assert c["tiles"] == counts.shape[0] == 24 == sum(n for n, _ in shapes)
    assert c["classes"] == len(shapes) > 1
    assert c["slots"] == sum(n * k for n, k in shapes)
    assert c["pairs"] == int(counts.sum()) == sum(int(v.sum()) for v in cache.slot_valid)
    assert c["pairs_dropped"] == 0 and int(cache.n_dropped) == 0
    for ids, v in zip(cache.tile_ids, cache.slot_valid):
        k = v.shape[1]
        assert k in (256, 512, 1024, 2048, 4096)
        need = counts[ids.long().numpy()]
        assert (need <= k).all() and (k == 256 or (need > k // 2).all())
    # the runner's stats mirror the tracker's totals
    runner.step(S)
    assert {k: runner.stats[k] for k in TRACK_COUNTERS} == dict(runner.tracker.counters)
    assert runner.stats["track_pairs"] > 0
    assert {k: runner.runtime_summary()[k] for k in TRACK_COUNTERS} == \
        dict(runner.tracker.counters)


def test_tracking_spans_and_counters_under_the_profiler(tmp_path):
    runner, _, S, _ = resumed(tmp_path, 256, iters=40)
    path = runner._profiled_step(S, None, str(tmp_path / "traces"))
    with open(path) as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "user_annotation"
             and e.get("ph") == "X"]
    track = [e for e in spans if e["name"] == "hs.track"]
    cache = [e for e in spans if e["name"] == "hs.track.cache"]
    iters = [e for e in spans if e["name"] == "hs.track.iter"]
    assert len(track) == 1 and len(cache) == 1 and len(iters) == 40
    t0, t1 = track[0]["ts"], track[0]["ts"] + track[0]["dur"]
    for e in cache + iters:
        assert e["tid"] == track[0]["tid"] and t0 <= e["ts"] <= e["ts"] + e["dur"] <= t1
    assert cache[0]["ts"] + cache[0]["dur"] <= min(e["ts"] for e in iters)
    step = doc[f"hierslam.step{S}"]
    assert {k: step[k] for k in TRACK_COUNTERS} == dict(runner.tracker.counters)
    assert step["track_pairs_dropped"] == 0 and step["track_classes"] > 1
