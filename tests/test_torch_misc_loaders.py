"""The port's other loaders (TUM, ICL, Azure Kinect, Ai2Thor, Record3D,
RealSense, ScanNet++, NeRFCapture) against the JAX package's on fabricated
layouts, the colour undistortion against ``cv2.undistort``, and a 3-frame
``run_slam`` on a TUM layout against JAX's.

Tolerances: the undistortion is exact (the port builds cv2's fixed-point
map, 1/32 of a pixel, and sums cv2's float32 weights in float64).  Colour
holds to 1e-4 on 0-255 values (the resize sums the same float64 terms as
cv2 in another order, then rounds to float32), depth, poses and K exactly.
The TUM run is held to the bounds of ``tests/test_torch_cli.py``, for the
reasons given there.  Its scene is a slanted plane: on the frontal wall of
``fabricate.make_scene_images`` the gaussians tie in depth, and each
side's last-bit rounding then picks their blend order (``ROADMAP.md``
queue 3, cause (b)), which moves frame 1's first tracking loss past its
bound at 64x48.
"""
import json
import os

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from fabricate import make_scene_images
from hierslam_torch.datasets import base as tbase
from hierslam_torch.datasets import get_dataset as t_get_dataset
from hierslam_tpu.datasets import get_dataset as j_get_dataset
from test_e2e import small_config
from test_torch_cli import _records, same_draws  # noqa: F401  (a fixture)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUM_DIST = [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]      # configs/data/tum.yaml
TUM_K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]])


def _cam(name, H, W, f=40.0, scale=6553.5, **extra):
    return {"dataset_name": name,
            "camera_params": dict(image_height=H, image_width=W, fx=f, fy=f, cx=W / 2,
                                  cy=H / 2, png_depth_scale=scale, **extra)}


def _distorted(color, K, dist):
    """The image a lens with ``dist`` sees of the ideal ``color``: each
    distorted pixel samples the ideal image at its undistorted position."""
    H, W = color.shape[:2]
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    pts = np.stack([u.ravel(), v.ravel()], -1)[:, None]
    und = cv2.undistortPoints(pts, K, np.asarray(dist), P=K).reshape(H, W, 2)
    return cv2.remap(color, und[..., 0].astype(np.float32), und[..., 1].astype(np.float32),
                     cv2.INTER_LINEAR, borderMode=cv2.BORDER_REPLICATE)


def _write_depth(path, depth, scale):
    imageio.imwrite(path, np.clip(depth * scale, 0, 65535).astype(np.uint16))


def _quat(c2w):
    from scipy.spatial.transform import Rotation

    return list(c2w[:3, 3]) + list(Rotation.from_matrix(c2w[:3, :3]).as_quat())


def slanted_scene(n_frames, W, H, K):
    """Frames of a textured plane seen at a slant, the camera stepping 2 cm
    in x a frame: (colour uint8, depth m, c2w).  Every pixel has its own
    depth, so no two gaussians of the map tie in depth (the fabricated
    wall's frontal plane makes them tie)."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    d = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u)], -1)
    normal = np.array([0.35, 0.25, -1.0])
    frames = []
    for t in range(n_frames):
        c2w = np.eye(4)
        c2w[0, 3] = 0.02 * t
        depth = (normal @ (np.array([0.0, 0.0, 2.5]) - c2w[:3, 3])) / (d @ normal)
        wx, wy = d[..., 0] * depth + c2w[0, 3], d[..., 1] * depth
        checker = (np.floor(wx * 5) + np.floor(wy * 5)) % 2
        color = np.stack([0.2 + 0.6 * checker, 0.3 + 0.4 * (wx % 1), 0.5 + 0.3 * (wy % 1)], -1)
        frames.append((np.clip(color * 255, 0, 255).astype(np.uint8), depth.astype(np.float32),
                       c2w))
    return frames


def fabricate_tum(root, n_frames=5, W=64, H=48, K=None, dist=TUM_DIST, extra=True):
    """TUM layout: ``rgb/`` and ``depth/`` PNGs named by timestamp, depth x
    5000, colour through the lens's distortion.  The lists are written out
    of order; with ``extra`` an rgb frame 0.02 s after another (dropped by
    the 32 fps cap) and one with no depth within 0.08 s (dropped by the
    match) are added.  Returns (basedir, sequence, camera config, the kept
    frames' c2w)."""
    K = TUM_K * [[W / 640], [H / 480], [1]] if K is None else K
    seq = os.path.join(root, "tum_seq")
    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(seq, d), exist_ok=True)
    frames = slanted_scene(n_frames + 1, W, H, K)
    t0 = 1305031102.175304
    rgb, dep, gt, kept = [], [], [], []
    for i, (color, depth, c2w) in enumerate(frames[:n_frames]):
        tr, td, tg = t0 + i / 30, t0 + i / 30 + 0.011 * (i % 3), t0 + i / 30 - 0.004
        rgb.append(f"{tr:.6f} rgb/{tr:.6f}.png")
        dep.append(f"{td:.6f} depth/{td:.6f}.png")
        gt.append(f"{tg:.4f} " + " ".join(f"{v:.7f}" for v in _quat(c2w)))
        imageio.imwrite(os.path.join(seq, "rgb", f"{tr:.6f}.png"), _distorted(color, K, dist))
        _write_depth(os.path.join(seq, "depth", f"{td:.6f}.png"), depth, 5000.0)
        kept.append(c2w)
    if extra:
        color = frames[n_frames][0]
        for tr in (t0 + 1 / 30 + 0.02, t0 + n_frames / 30 + 0.5):
            rgb.append(f"{tr:.6f} rgb/{tr:.6f}.png")
            imageio.imwrite(os.path.join(seq, "rgb", f"{tr:.6f}.png"), color)
    order = np.random.default_rng(0).permutation
    for name, lines in (("rgb.txt", rgb), ("depth.txt", dep), ("groundtruth.txt", gt)):
        lines = [lines[i] for i in order(len(lines))] if name != "rgb.txt" else \
            sorted(lines)
        with open(os.path.join(seq, name), "w") as f:
            f.write(f"# {name}\n# file: 'fabricated'\n# timestamp data\n" + "\n".join(lines)
                    + "\n")
    cam = {"dataset_name": "tum", "camera_params": dict(
        image_height=H, image_width=W, fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), png_depth_scale=5000.0, distortion=list(dist))}
    return root, "tum_seq", cam, kept


def _frames(n, W=64, H=48):
    return make_scene_images(n, W, H)


def fab_icl(root, n):
    seq = os.path.join(root, "icl")
    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(seq, d))
    rows = []
    for i, (color, depth, c2w, _) in enumerate(_frames(n)):
        imageio.imwrite(os.path.join(seq, "rgb", f"{i}.png"), color)
        _write_depth(os.path.join(seq, "depth", f"{i}.png"), depth, 5000.0)
        rows += [" ".join(f"{v:.9f}" for v in r) for r in c2w[:3]] + [""]
    with open(os.path.join(seq, "traj0.gt.sim"), "w") as f:
        f.write("\n".join(rows))
    return seq, _cam("icl", 48, 64, scale=5000.0), {}


def fab_azure(root, n, odom):
    seq = os.path.join(root, "azure")
    for d in ("color", "depth"):
        os.makedirs(os.path.join(seq, d))
    lines = []
    for i, (color, depth, c2w, _) in enumerate(_frames(n)):
        imageio.imwrite(os.path.join(seq, "color", f"{i:05d}.jpg"), color, quality=95)
        _write_depth(os.path.join(seq, "depth", f"{i:05d}.png"), depth, 1000.0)
        if odom == "odometry.log":
            lines += [f"{i} {i} {i + 1}"] + [" ".join(map(repr, r.tolist())) for r in c2w]
        else:
            lines.append(" ".join(map(repr, c2w.reshape(-1).tolist())))
    kw = {}
    if odom:
        with open(os.path.join(seq, odom), "w") as f:
            f.write("\n".join(lines) + "\n")
        kw = {"odomfile": odom}
    return seq, _cam("azure", 48, 64, scale=1000.0), kw


def fab_ai2thor(root, n):
    seq = os.path.join(root, "ai2thor")
    for d in ("color", "depth", "pose"):
        os.makedirs(os.path.join(seq, d))
    for i, (color, depth, c2w, _) in enumerate(_frames(n)):
        imageio.imwrite(os.path.join(seq, "color", f"{i}.png"), color)
        _write_depth(os.path.join(seq, "depth", f"{i}.png"), depth, 1000.0)
        np.savetxt(os.path.join(seq, "pose", f"{i}.txt"), c2w)
    return seq, _cam("ai2thor", 48, 64, scale=1000.0), {}


def fab_record3d(root, n, ext="png", name="record3d"):
    seq = os.path.join(root, name)
    for d in ("rgb", "depth", "poses"):
        os.makedirs(os.path.join(seq, d))
    for i, (color, depth, c2w, _) in enumerate(_frames(n)):
        imageio.imwrite(os.path.join(seq, "rgb", f"{i}.{ext}"), color,
                        **({"quality": 95} if ext == "jpg" else {}))
        _write_depth(os.path.join(seq, "depth", f"{i}.png"), depth, 1000.0)
        np.save(os.path.join(seq, "poses", f"{i}.npy"), c2w)
    return seq, _cam(name, 48, 64, scale=1000.0), {}


def _gl(c2w):
    return (c2w @ np.diag([1.0, -1.0, -1.0, 1.0])).tolist()


def fab_scannetpp(root, n, train):
    seq = os.path.join(root, "scannetpp")
    base = os.path.join(seq, "dslr")
    for d in ("nerfstudio", "undistorted_images", "undistorted_depths"):
        os.makedirs(os.path.join(base, d))
    names = [f"DSC{i:05d}.JPG" for i in range(n)]
    recs = []
    for name, (color, depth, c2w, _) in zip(names, _frames(n)):
        imageio.imwrite(os.path.join(base, "undistorted_images", name), color, format="JPEG",
                        quality=95)
        _write_depth(os.path.join(base, "undistorted_depths", name.replace(".JPG", ".png")),
                     depth, 1000.0)
        recs.append({"file_path": name, "transform_matrix": _gl(c2w)})
    meta = {"h": 48, "w": 64, "fl_x": 41.5, "fl_y": 40.5, "cx": 31.5, "cy": 23.5,
            "frames": recs[:-2], "test_frames": recs[-2:]}
    with open(os.path.join(base, "nerfstudio", "transforms_undistorted.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(base, "train_test_lists.json"), "w") as f:
        json.dump({"train": names[:-2][::-1], "test": names[-2:] + ["DSC99999.JPG"]}, f)
    cam = {"dataset_name": "scannetpp", "camera_params": dict(image_height=584,
                                                              image_width=876)}
    return seq, cam, {"use_train_split": train}


def fab_nerfcapture(root, n):
    seq = os.path.join(root, "nerfcapture")
    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(seq, d))
    recs = []
    for i, (color, depth, c2w, _) in enumerate(_frames(n)):
        imageio.imwrite(os.path.join(seq, "rgb", f"{i}.jpg"), color, quality=95)
        _write_depth(os.path.join(seq, "depth", f"{i}.png"), depth, 6553.5)
        recs.append({"transform_matrix": _gl(c2w)})
    with open(os.path.join(seq, "transforms.json"), "w") as f:
        json.dump({"h": 48, "w": 64, "fl_x": 40.0, "fl_y": 41.0, "cx": 32.0, "cy": 24.0,
                   "frames": recs}, f)
    return seq, {"dataset_name": "nerfcapture"}, {}


LAYOUTS = {
    "icl": lambda r: fab_icl(r, 3),
    "azure_log": lambda r: fab_azure(r, 3, "odometry.log"),
    "azure_flat": lambda r: fab_azure(r, 4, "odometry.txt"),
    "azure_none": lambda r: fab_azure(r, 3, None),
    "ai2thor": lambda r: fab_ai2thor(r, 3),
    "record3d": lambda r: fab_record3d(r, 4),
    "realsense": lambda r: fab_record3d(r, 3, "jpg", "realsense"),
    "scannetpp_train": lambda r: fab_scannetpp(r, 5, True),
    "scannetpp_test": lambda r: fab_scannetpp(r, 5, False),
    "nerfcapture": lambda r: fab_nerfcapture(r, 3),
}


def _same_items(t, j, size):
    assert len(t) == len(j) > 0
    for i in range(len(t)):
        a, b = t[i], j[i]
        assert len(a) == len(b) == 4
        assert a[0].shape == (size[1], size[0], 3)
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-4)
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("size", [(64, 48), (32, 24)])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_misc_loader_matches_jax(tmp_path, layout, size):
    seq, cam, kw = LAYOUTS[layout](str(tmp_path))
    args = dict(config_dict=cam, basedir=str(tmp_path), sequence=os.path.basename(seq),
                start=0, end=-1, stride=1, desired_height=size[1], desired_width=size[0],
                relative_pose=True, **kw)
    t, j = t_get_dataset(**args), j_get_dataset(**args)
    assert type(t).__name__ == type(j).__name__
    _same_items(t, j, size)
    n = {"scannetpp_train": 3, "scannetpp_test": 2}.get(layout)
    if n is not None:
        assert len(t) == n


@pytest.mark.parametrize("size", [(640, 480), (320, 240)])
def test_tum_loader_matches_jax(tmp_path, size):
    basedir, seq, cam, kept = fabricate_tum(str(tmp_path), n_frames=4, W=640, H=480)
    args = dict(config_dict=cam, basedir=basedir, sequence=seq, start=0, end=-1, stride=1,
                desired_height=size[1], desired_width=size[0], relative_pose=True)
    t, j = t_get_dataset(**args), j_get_dataset(**args)
    assert len(t) == len(j) == 4           # the 32 fps cap and the 0.08 s match drop two
    _same_items(t, j, size)
    rel = np.linalg.inv(kept[0]) @ np.stack(kept)
    np.testing.assert_allclose(np.stack([t[i][3] for i in range(4)]), rel, rtol=0, atol=1e-6)
    # the undistorted colour lines up with the ideal frame away from the border
    ideal = slanted_scene(1, 640, 480, TUM_K)[0][0]
    if size == (640, 480):
        inner = (slice(60, 420), slice(80, 560))
        err = np.abs(t[0][0][inner] - ideal[inner].astype(np.float32))
        assert np.median(err) < 2.0, np.median(err)


def test_tum_pose_file_fallback(tmp_path):
    basedir, seq, cam, _ = fabricate_tum(str(tmp_path), n_frames=3, extra=False)
    os.rename(os.path.join(basedir, seq, "groundtruth.txt"),
              os.path.join(basedir, seq, "pose.txt"))
    args = dict(config_dict=cam, basedir=basedir, sequence=seq, desired_height=48,
                desired_width=64)
    _same_items(t_get_dataset(**args), j_get_dataset(**args), (64, 48))


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("shape", [(480, 640), (37, 53)])
def test_undistort_matches_cv2(shape, channels):
    H, W = shape
    K = TUM_K if shape == (480, 640) else TUM_K * [[W / 640], [H / 480], [1]]
    rng = np.random.default_rng(H)
    v, u = np.mgrid[0:H, 0:W]
    smooth = np.sin(u / 17.0) * 100 + np.cos(v / 23.0) * 80 + 120
    for img in (rng.integers(0, 256, (H, W, channels)).astype(np.float64),
                np.repeat(smooth[..., None], channels, -1)):
        img = img[..., 0] if channels == 1 else img
        got = tbase.undistort(img, K, np.asarray(TUM_DIST))
        ref = cv2.undistort(img, K, np.asarray(TUM_DIST))
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert np.abs(got - ref).max() == 0.0


def test_undistort_float32_camera_and_eight_coefficients():
    """The loaders pass a float32 K (``as_intrinsics_matrix``); a rational
    model has eight coefficients."""
    K = tbase.as_intrinsics_matrix(517.3, 516.5, 318.6, 255.3)
    img = np.random.default_rng(1).integers(0, 256, (480, 640, 3)).astype(np.float64)
    for dist in (np.asarray(TUM_DIST), np.array([0.1, -0.05, 0.001, -0.002, 0.01, 0.02, -0.01,
                                                  0.005])):
        assert np.abs(tbase.undistort(img, K, dist) - cv2.undistort(img, K, dist)).max() == 0.0


def test_tum_run_slam_matches_jax(tmp_path, same_draws):  # noqa: F811
    from hierslam_torch.slam.pipeline import run_slam as t_run_slam
    from hierslam_tpu.slam.pipeline import run_slam as j_run_slam

    basedir, seq, cam, _ = fabricate_tum(str(tmp_path / "data"), n_frames=3, extra=False)
    cfg = small_config(basedir, seq, semantic=False, workdir=str(tmp_path / "jax"))
    cfg["data"].update(dataset_name="tum", camera_params=cam["camera_params"], num_frames=3)
    cfg["tracking"]["num_iters"] = 5
    cfg["mapping"]["num_iters"] = 5
    cfg["raster"]["max_per_tile"] = 1024
    tcfg = dict(cfg, workdir=str(tmp_path / "torch"), raster=dict(cfg["raster"], backend="pallas"))
    # up to ~2,600 pairs a tile: the port's tracker sizes its classes from the
    # counts (1024 slots the least), so the JAX tracker takes one class that
    # holds every tile's pairs
    jcfg = dict(cfg, raster=dict(cfg["raster"], backend="xla", track_max_per_tile=4096))
    pt, st, rt = t_run_slam(tcfg, device="cpu")
    pj, sj, rj = j_run_slam(jcfg)

    jt = _records(os.path.join(cfg["workdir"], "smoke", "metrics.jsonl"), "tracking")
    tt = _records(os.path.join(tcfg["workdir"], "smoke", "metrics.jsonl"), "tracking")
    assert len(jt) == len(tt) == 10
    for a, b in zip(tt, jt):
        for k in ("tracking_loss", "tracking_depth", "tracking_im"):
            rel = 5e-3 if a["step"] == 1 else 2e-2
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=rel * b["tracking_loss"],
                                       err_msg=f"{k} frame {a['step']}")
    assert st["densify_added"] == sj["densify_added"]
    assert sorted(pt) == sorted(pj) and "semantic" not in pt
    tol = dict(cam_trans=2e-3, cam_unnorm_rots=1e-3, gt_w2c_all_frames=0.0,
               keyframe_time_indices=0.0, intrinsics=0.0, w2c=1e-7, org_width=0.0,
               org_height=0.0, timestep=0.0)
    steps = 2 * cfg["mapping"]["num_iters"]              # mappings at t = 0, 1
    for k in pt:
        assert pt[k].shape == pj[k].shape, k
        d = np.abs(pt[k].astype(np.float64) - pj[k])
        if k in tol:
            assert d.max() <= tol[k], (k, d.max())
            continue
        bound = 2 * cfg["mapping"]["lrs"][k] * steps
        assert d.max() <= bound, (k, d.max(), bound)
        if k != "unnorm_rotations":
            assert d.mean() <= bound / 20, (k, d.mean(), bound / 20)
    for k, v in dict(psnr=0.05, ms_ssim=1e-3, depth_l1_cm=0.05, depth_rmse_cm=0.05,
                     ate_rmse_cm=0.05).items():
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=v, err_msg=k)
