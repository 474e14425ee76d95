"""The port's eval layer against the JAX package's on the same numpy
inputs: metrics, boundary IoU, the IoU accumulator, tree decoding, ATE,
the progress scalars, PLY export and the final / NVS eval drivers.

The JAX eval renders with ``raster.backend="xla"`` (the blend math of its
Pallas kernels, which tests/test_torch_raster.py holds in interpret mode
against the port's plain K1); the port renders through its own ladder
path, plain K1 on CPU tensors.

Tolerances, with their reasons: PSNR to 1e-4 dB and MS-SSIM to 1e-6 on
the same images (float32 filters and sums in another order), MS-SSIM to
1e-5 on renders (the two renders differ in the last bits); depth metrics
to 1e-6 m on the same arrays, 1e-4 cm on renders;
ATE to 1e-6 m (float32 pose math, float64 alignment); boundary masks,
IoU counts, tree decoding and PLY bytes exact; the eval's semantic rows
exact except where a rendered logit pair ties within float32 rounding,
which the test shows does not happen on its map (every per-class IoU
equal).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabricate import fabricate_replica
from hierslam_torch.core import camera as tcam
from hierslam_torch.datasets.tree import label_colormap
from hierslam_torch.eval import ate as tate
from hierslam_torch.eval import metrics as TM
from hierslam_torch.eval import progress as tprog
from hierslam_torch.eval import runner as trun
from hierslam_torch.export import ply as tply
from hierslam_tpu.core import camera as jcam
from hierslam_tpu.datasets import get_dataset as j_get_dataset
from hierslam_tpu.eval import ate as jate
from hierslam_tpu.eval import metrics as JM
from hierslam_tpu.eval import progress as jprog
from hierslam_tpu.eval import runner as jrun
from hierslam_tpu.export import ply as jply

torch.set_num_threads(1)
H, W = 48, 64
RC = dict(max_per_tile=1024, gaussian_chunk=64, tile_batch=4)


def _images(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    m = rng.uniform(size=(H, W)) > 0.3
    return a, b, m


def test_image_metrics_match():
    a, b, m = _images(0)
    ta, tb, tm = torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(m)
    ja, jb, jm = jnp.asarray(a), jnp.asarray(b), jnp.asarray(m)
    np.testing.assert_allclose(float(TM.masked_psnr(ta, tb, tm)),
                               float(JM.masked_psnr(ja, jb, jm)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(TM.reference_psnr(ta, tb, tm)),
                               float(JM.reference_psnr(ja, jb, jm)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(TM.ms_ssim(ta, tb)), float(JM.ms_ssim(ja, jb)),
                               rtol=0, atol=1e-6)
    d, g = a[0] * 5, b[0] * 5
    for f in ("reference_depth_metrics", "depth_metrics"):
        np.testing.assert_allclose(getattr(TM, f)(d, g, m), getattr(JM, f)(d, g, m),
                                   rtol=0, atol=1e-6)


def _edge_masks():
    rng = np.random.default_rng(1)
    masks = [np.ones((H, W), np.uint8), np.zeros((H, W), np.uint8)]
    m = np.zeros((H, W), np.uint8)
    m[:, :20] = 1                                   # touches three edges
    masks.append(m)
    m = np.zeros((H, W), np.uint8)
    m[10:30, 5:50] = 1
    m[0, :] = 1                                     # a one-pixel row on the top edge
    masks.append(m)
    masks.append((rng.uniform(size=(H, W)) > 0.5).astype(np.uint8))
    masks.append((rng.uniform(size=(300, 17)) > 0.8).astype(np.uint8))   # d = 6
    return masks


@pytest.mark.parametrize("i", range(6))
def test_mask_to_boundary_matches(i):
    m = _edge_masks()[i]
    got = TM.mask_to_boundary(m)
    assert got.dtype == m.dtype and np.array_equal(got, JM.mask_to_boundary(m))
    other = _edge_masks()[(i + 1) % 4]
    if other.shape == m.shape:
        assert TM.boundary_iou(m, other) == JM.boundary_iou(m, other)


def test_iou_accumulator_and_tree_decode_match(capsys):
    rng = np.random.default_rng(2)
    tacc, jacc = TM.IoUAccumulator(), JM.IoUAccumulator()
    names = [f"c{i}" for i in range(7)]
    for f in range(3):
        pred = rng.integers(0, 6, (H, W))
        gt = np.where(rng.uniform(size=(H, W)) > 0.3, pred, rng.integers(0, 5, (H, W)))
        capsys.readouterr()
        a = tacc.add_frame(torch.as_tensor(pred), torch.as_tensor(gt), list(range(7)), names,
                           verbose=True)
        out_t = capsys.readouterr().out
        b = jacc.add_frame(pred, gt, list(range(7)), names, verbose=True)
        out_j = capsys.readouterr().out
        assert a == b and out_t == out_j
    assert tacc.summary() == jacc.summary()
    sem = rng.normal(size=(6, H, W)).astype(np.float32)
    mapping = {"0": (0, 0), "1": (0, 1), "2": (1, 2), "3": (1, 3)}
    lv = TM.decode_tree_labels(sem, [2, 4, 4])
    assert np.array_equal(lv, JM.decode_tree_labels(sem, [2, 4, 4]))
    assert np.array_equal(TM.decode_tree_labels(torch.as_tensor(sem), [2, 4, 4]).numpy(), lv)
    assert np.array_equal(TM.tree_tuple_to_leaf(lv, mapping), JM.tree_tuple_to_leaf(lv, mapping))
    a = TM.eval_semantic_single(pred, gt, list(range(6)), verbose=True)
    assert a == JM.eval_semantic_single(pred, gt, list(range(6)), verbose=True)


def test_ate_matches():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 4, 9)).astype(np.float32)
    t = rng.normal(size=(1, 3, 9)).astype(np.float32)
    a, b = tate.trajectory_from_params(q, t), jate.trajectory_from_params(q, t)
    np.testing.assert_allclose(np.stack(a), np.stack(b), rtol=0, atol=1e-6)
    gt = [np.linalg.inv(x) for x in b]
    est = [x @ np.diag([1, 1, 1, 1.0]) + 0.01 * rng.normal(size=(4, 4)) for x in b]
    assert tate.evaluate_ate(gt, est) == jate.evaluate_ate(gt, est)
    gt[2] = np.full((4, 4), np.nan)
    np.testing.assert_allclose(tprog.ate_so_far(gt, torch.as_tensor(q), torch.as_tensor(t)),
                               jprog.ate_so_far(gt, q, t), rtol=0, atol=1e-6)


def _scene(tmp_path):
    """The fabricated sequence's JAX loader (one object both evals read) and
    a map: frame 0 back-projected (opaque), random semantics and decoder,
    and a trajectory of the GT poses with small errors."""
    basedir, seq, cam = fabricate_replica(str(tmp_path / "d"), n_frames=4, semantic=True)
    ds = j_get_dataset(dict(cam, sem_mode="tree", num_tree_level=2), basedir, seq, start=0,
                       end=-1, stride=1, desired_height=H, desired_width=W, relative_pose=True)
    rng = np.random.default_rng(4)
    color, depth, K4, _ = ds[0][:4]
    K = np.asarray(K4)[:3, :3]
    ys, xs = np.nonzero(depth > 0)
    z = depth[ys, xs]
    pts = np.stack([(xs - K[0, 2]) * z / K[0, 0], (ys - K[1, 2]) * z / K[1, 1], z], -1)
    n = len(z)
    gt_w2c = np.stack([np.linalg.inv(ds[t][3]) for t in range(4)]).astype(np.float32)
    trans = gt_w2c[:, :3, 3] + rng.normal(0, 0.003, (4, 3))
    params = {
        "means3D": pts, "rgb_colors": color[ys, xs] / 255.0,
        "unnorm_rotations": np.tile([1.0, 0, 0, 0], (n, 1)),
        "logit_opacities": np.full((n, 1), 4.0),
        "log_scales": np.log(z / K[0, 0])[:, None] + np.log(1.2),
        "semantic": rng.uniform(0, 1, (n, 6)),
        "cam_unnorm_rots": np.tile(np.array([1.0, 0, 0, 0])[None, :, None], (1, 1, 4)),
        "cam_trans": trans.T[None],
        "w2c": np.eye(4), "gt_w2c_all_frames": gt_w2c,
    }
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    mlp = {"w": rng.normal(size=(4, 6)).astype(np.float32),
           "b": rng.normal(size=(4,)).astype(np.float32)}
    return ds, params, mlp


@pytest.mark.parametrize("with_mlp", [True, False])
def test_final_eval_matches(tmp_path, with_mlp, capsys):
    ds, params, mlp = _scene(tmp_path)
    mlp = mlp if with_mlp else None
    cfg = dict(eval_every=2, model=dict())
    rt = trun.run_final_eval(ds, params, dict(cfg, raster=dict(RC, backend="pallas")),
                             str(tmp_path / "t"), mlp=mlp, device="cpu")
    out_t = capsys.readouterr().out
    rj = jrun.run_final_eval(ds, params, dict(cfg, raster=dict(RC, backend="xla")),
                             str(tmp_path / "j"), mlp=mlp)
    out_j = capsys.readouterr().out
    assert sorted(rt) == sorted(rj)
    tol = dict(psnr=1e-4, ms_ssim=1e-5, depth_l1_cm=1e-4, depth_rmse_cm=1e-4,
               ate_rmse_cm=1e-4, miou_pct=0.0, mbiou_pct=0.0)
    for k, v in tol.items():
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=v, err_msg=k)
    assert np.isnan(rt["lpips"]) and np.isnan(rj["lpips"])
    assert rt["miou_pct"] > 0
    for name in ("psnr", "ms_ssim", "depth_l1", "depth_rmse"):
        np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / f"{name}.txt"),
                                   np.loadtxt(tmp_path / "j" / f"{name}.txt"), rtol=0,
                                   atol=1e-4, err_msg=name)
    iou = [open(tmp_path / d / "sem_iou_2flat.txt").read() for d in ("t", "j")]
    assert iou[0] == iou[1]
    # the printed header, the per-frame IoU lines and the row's layout
    head = "[ATE RMSE cm] [PSNR] [MS-SSIM] [LPIPS] [Depth L1 cm] [Depth RMSE cm] [mIoU%] [mbIoU%]"
    assert head in out_t and head in out_j
    lines_t = [ln for ln in out_t.splitlines() if ln.startswith((" semantic", "current", "mean"))]
    lines_j = [ln for ln in out_j.splitlines() if ln.startswith((" semantic", "current", "mean"))]
    assert lines_t == lines_j


def test_nvs_eval_matches(tmp_path):
    ds, params, _ = _scene(tmp_path)
    rt = trun.run_nvs_eval(ds, params, dict(raster=dict(RC, backend="pallas")),
                           str(tmp_path / "t"), device="cpu")
    rj = jrun.run_nvs_eval(ds, params, dict(raster=dict(RC, backend="xla")),
                           str(tmp_path / "j"))
    for k, tol in (("nvs_psnr", 1e-4), ("nvs_ms_ssim", 1e-5), ("nvs_depth_l1_cm", 1e-4)):
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=tol, err_msg=k)


def test_report_progress_scalars_match(tmp_path):
    ds, params, _ = _scene(tmp_path)
    camera_t = tcam.setup_camera(W, H, np.asarray(ds[0][2])[:3, :3], np.eye(4))
    camera_j = jcam.setup_camera(W, H, np.asarray(ds[0][2])[:3, :3], np.eye(4))
    from hierslam_torch.config import raster_config as t_rc
    from hierslam_tpu.config import raster_config as j_rc

    rt = t_rc(dict(raster=dict(RC, backend="pallas")))
    rj = j_rc(dict(raster=dict(RC, backend="xla")))
    keys = ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales",
            "cam_unnorm_rots", "cam_trans")
    gt_all = list(params["gt_w2c_all_frames"][:3])
    for t in (0, 2):
        color, depth = ds[t][:2]
        im = (color.transpose(2, 0, 1) / 255.0).astype(np.float32)
        a = tprog.report_progress(trun._build_renderer(camera_t, rt, False),
                                  {k: torch.as_tensor(params[k]) for k in keys},
                                  torch.as_tensor(im), torch.as_tensor(depth), t, gt_all, 0.99,
                                  str(tmp_path), save_plot=False)
        b = jprog.report_progress(jrun._build_renderer(camera_j, rj, False),
                                  {k: jnp.asarray(params[k]) for k in keys}, jnp.asarray(im),
                                  jnp.asarray(depth), t, gt_all, 0.99, str(tmp_path),
                                  save_plot=False)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4, err_msg=k)


def test_export_ply_bytes_match(tmp_path):
    _, params, mlp = _scene(tmp_path)
    cmap = label_colormap(512)
    for name, kw in (("plain", None), ("flat", dict(num_semantic=None)),
                     ("tree", dict(num_semantic=[2, 4, 4])),
                     ("mlp", dict(num_semantic=[2, 4, 4], mlp=mlp)),
                     ("level", dict(num_semantic=[2, 4, 4], level=0))):
        a, b = str(tmp_path / f"t_{name}.ply"), str(tmp_path / f"j_{name}.ply")
        if kw is None:
            tply.export_ply(params, a)
            jply.export_ply(params, b)
        else:
            tply.export_ply_semantic(params, a, cmap, **kw)
            jply.export_ply_semantic(params, b, cmap, **kw)
        assert open(a, "rb").read() == open(b, "rb").read(), name
