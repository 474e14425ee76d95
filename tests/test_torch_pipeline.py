"""Both SLAMRunners on 3 frames of a fabricated Replica-layout sequence.

The port starts from the JAX runner's post-init state (``load_state``) and
is fed the frames the JAX dataset read.  With ``map_every=3`` the schedule
is: mapping at t=0 (no densify), tracking at t=1 and t=2, then densify +
mapping at t=2.  Until the densify at t=2 both runs consume the same
inputs, so the trajectory, the tracking loss traces and the t=0 mapping
trace must agree.  The densify draws its semantic init from each
framework's own generator, so from then on only what the draw cannot
touch is compared: the number of inserted Gaussians and the rgb/depth
terms of the first t=2 mapping iteration.

The JAX runner renders with ``raster.backend="xla"``: the same blend math
as its Pallas kernels (``ops/rasterize.py``), which tests/test_torch_raster.py
holds in interpret mode against the port's plain K1/K2; interpret-mode
compiles of the three jitted phases would dominate the quick test tier.
The port runs its own ``backend="pallas"`` path (plain K1 and the
closed-form K2 on CPU tensors).

Tolerances, with their reasons.  The t=0 mapping trace agrees to 1e-4
relative (float32 sums in another order).  Tracking sums its losses over
the pixels whose rendered opacity passes 0.99, so a parameter difference
of 1e-5 (Adam's eps=1e-15 steps on rounding-level gradients in the t=0
mapping) flips single pixels of that mask: each tracking loss term to
2e-3 of the total loss, poses to 0.5 mm and 2e-4 in the quaternion.  The
t=2 mapping starts from those poses: its first rgb/depth terms to 1e-2
relative.
"""
import json
import os

import numpy as np
import torch

from fabricate import fabricate_replica
from test_e2e import small_config

torch.set_num_threads(1)


def _iter_records(path, phase):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if r.get("phase") == phase]


def test_slam_runners_match(tmp_path):
    from hierslam_torch.slam.pipeline import SLAMRunner as TorchRunner
    from hierslam_tpu.slam.pipeline import SLAMRunner as JaxRunner

    basedir, seq, _ = fabricate_replica(str(tmp_path / "data"), n_frames=3, W=32, H=24,
                                        semantic=True)
    cfg = small_config(basedir, seq, workdir=str(tmp_path / "jax"))
    cfg["data"].update(desired_image_height=24, desired_image_width=32)
    cfg["data"]["camera_params"].update(image_height=24, image_width=32, cx=16.0, cy=12.0)
    cfg["map_every"] = 3
    cfg["tracking"]["num_iters"] = 5
    cfg["mapping"]["num_iters"] = 5
    cfg["raster"]["backend"] = "xla"
    # every list holds its whole tile (n_dropped == 0): truncation at a
    # near-tie in depth would keep different gaussians on either side
    cfg["raster"]["max_per_tile"] = 1024

    jr = JaxRunner(cfg)
    jr._report_progress = lambda *a, **k: None   # eval is not part of this slice
    frames = [jr.dataset[t] for t in range(3)]

    class Frames:
        num_semantic = jr.dataset.num_semantic
        num_semantic_class = jr.dataset.num_semantic_class

        def __len__(self):
            return len(frames)

        def __getitem__(self, t):
            return tuple(np.asarray(x) for x in frames[t])

    tcfg = dict(cfg, workdir=str(tmp_path / "torch"),
                raster=dict(cfg["raster"], backend="pallas"))
    tr = TorchRunner(tcfg, dataset=Frames(), device="cpu")
    tr.load_state(
        {k: np.asarray(v) for k, v in jr.params.items()},
        {k: np.asarray(v) for k, v in jr.variables.items()},
        {k: np.asarray(v) for k, v in jr.mlp.items()},
        tuple(jr.mlp_state),
    )
    for t in range(3):
        jr.step(t)
        tr.step(t)

    np.testing.assert_allclose(tr.params["cam_trans"].numpy(),
                               np.asarray(jr.params["cam_trans"]), atol=5e-4)
    np.testing.assert_allclose(tr.params["cam_unnorm_rots"].numpy(),
                               np.asarray(jr.params["cam_unnorm_rots"]), atol=2e-4)
    jm = os.path.join(cfg["workdir"], cfg["run_name"], "metrics.jsonl")
    tm = os.path.join(tcfg["workdir"], cfg["run_name"], "metrics.jsonl")
    jt, tt = _iter_records(jm, "tracking"), _iter_records(tm, "tracking")
    assert len(jt) == len(tt) == 10
    for a, b in zip(tt, jt):
        for k in ("tracking_loss", "tracking_depth", "tracking_im"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=2e-3 * b["tracking_loss"],
                                       err_msg=k)
    jmap, tmap = _iter_records(jm, "mapping"), _iter_records(tm, "mapping")
    assert len(jmap) == len(tmap) == 10
    assert max(r["mapping_n_map_bin_dropped"] for r in tmap + jmap) == 0
    for a, b in zip(tmap[:5], jmap[:5]):      # t=0: identical inputs
        for k in ("mapping_loss", "mapping_im", "mapping_depth", "mapping_sem"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    for k in ("mapping_im", "mapping_depth"):  # t=2, before the first update
        np.testing.assert_allclose(tmap[5][k], jmap[5][k], rtol=1e-2, err_msg=k)
    assert tr.stats["densify_added"] == jr.stats["densify_added"] > 0
    assert int(tr.variables["n_active"]) == int(jr.variables["n_active"])
    assert tr.keyframes.time_indices == jr.keyframes.time_indices

    pt, pj = tr.finalize(), jr.finalize()
    assert sorted(pt) == sorted(pj)
    np.testing.assert_allclose(pt["gt_w2c_all_frames"], pj["gt_w2c_all_frames"], atol=1e-6)
