"""The rest of the port's eval against the JAX package's: LPIPS-alex, the
JET depth colouring, the gt-transfer protocol and the semantic figures,
``run_final_eval(save_frames=True)`` with every PNG it writes, and the
``eval_novel_view`` CLI against ``scripts/eval_novel_view.py`` on both of
its branches.

Tolerances, with their reasons: AlexNet features to 2e-4 (float32
convolutions summed in another order, as ``tests/test_lpips.py`` holds the
JAX stack against torch) and the LPIPS distance to a relative 1e-5; the
JET table, the GT colour and depth images, label images, the per-level
figures and the legend exact; the renders' PNGs to 1 grey level and the
rendered depth's JET index to 1 step (the two renders differ in the last
bits, which can cross a rounding edge of the 8-bit code); eval rows as
``tests/test_torch_eval.py`` holds them.
"""
import glob
import os
import sys

import cv2
import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierslam_torch.datasets.tree import label_colormap
from hierslam_torch.eval import lpips as TL
from hierslam_torch.eval import runner as trun
from hierslam_torch.eval import semantic_viz as TSV
from hierslam_tpu.eval import lpips as JL
from hierslam_tpu.eval import runner as jrun
from hierslam_tpu.eval import semantic_viz as JSV
from test_e2e import small_config
from test_lpips import _random_params
from test_torch_cli import _run_blocked
from test_torch_eval import RC, _scene

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_TOL = dict(psnr=1e-4, ms_ssim=1e-5, depth_l1_cm=1e-4, depth_rmse_cm=1e-4,
               ate_rmse_cm=1e-4, miou_pct=0.0, mbiou_pct=0.0)


def test_alexnet_features_and_distance_match_jax():
    rng = np.random.default_rng(0)
    params = _random_params(rng)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    x = rng.normal(0, 1, (3, 67, 93)).astype(np.float32)
    for a, b in zip(TL.alexnet_features(tp, torch.as_tensor(x)),
                    JL.alexnet_features(jp, jnp.asarray(x))):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-4)
    for shape in ((3, 64, 96), (3, 48, 64)):
        img = rng.uniform(0, 1, shape).astype(np.float32)
        gt = np.clip(img + rng.normal(0, 0.2, shape), -0.1, 1.1).astype(np.float32)
        d_t = float(TL.lpips_distance(tp, torch.as_tensor(img), torch.as_tensor(gt)))
        d_j = float(JL.lpips_distance(jp, jnp.asarray(img), jnp.asarray(gt)))
        assert d_t > 0
        np.testing.assert_allclose(d_t, d_j, rtol=1e-5)
        assert float(TL.lpips_distance(tp, torch.as_tensor(img), torch.as_tensor(img))) == 0.0


def test_lpips_fn_from_file_and_environment(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **_random_params(rng))
    img = rng.uniform(0, 1, (3, 48, 64)).astype(np.float32)
    gt = rng.uniform(0, 1, (3, 48, 64)).astype(np.float32)
    want = JL.lpips_fn(str(path))(img, gt)
    np.testing.assert_allclose(TL.lpips_fn(str(path), "cpu")(img, gt), want, rtol=1e-5)
    monkeypatch.setenv("LPIPS_WEIGHTS", str(path))
    assert TL.default_weights_path() == str(path)
    np.testing.assert_allclose(TL.lpips_fn(device="cpu")(torch.as_tensor(img), gt), want,
                               rtol=1e-5)
    if not torch.cuda.is_available():           # the GPU unless asked for the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TL.lpips_fn(str(path))


def test_lpips_missing_weights_prints_path(capsys, monkeypatch):
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    assert TL.lpips_fn("/nonexistent/lpips_alex.npz") is None
    out = capsys.readouterr().out
    assert "/nonexistent/lpips_alex.npz" in out and "LPIPS_WEIGHTS" in out
    assert TL.default_weights_path() == os.path.join(REPO, "weights", "lpips_alex.npz")
    assert TL.lpips_fn() is None                     # no weights in the repo
    assert "weights/lpips_alex.npz" in capsys.readouterr().out


def test_jet_table_and_depth_colormap_match_cv2():
    bgr = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_JET)[:, 0]
    assert trun.JET_RGB.shape == (256, 3)
    assert np.array_equal(trun.JET_RGB, bgr[:, ::-1])
    depth = np.random.default_rng(2).uniform(-1, 8, (37, 53)).astype(np.float32)
    depth[0, :4] = [0.0, 6.0, 3.0, np.float32(6.0 * 128 / 255)]
    assert np.array_equal(trun._depth_colormap(depth), jrun._depth_colormap(depth))


@pytest.mark.parametrize("sparse", [False, True])
def test_gt_transfer_and_prefix_ids_match(sparse):
    rng = np.random.default_rng(3)
    cmap = label_colormap(512)
    ids = np.array([0, 7, 19, 42, 300, 301]) if sparse else np.arange(6)
    gt = ids[rng.integers(0, 4, (48, 64))]                  # 4 of the 6 classes present
    pred = ids[rng.integers(0, 6, (48, 64))]
    if sparse:
        gt, pred = np.searchsorted(ids, gt), np.searchsorted(ids, pred)
    a, b = TSV.gt_transfer_labels(pred, gt, cmap), JSV.gt_transfer_labels(pred, gt, cmap)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert set(np.unique(a)) <= set(np.unique(gt))
    # small ids, ids from -1 (a mixed-radix key), ids past 2**21 a level (row-wise)
    for lo, hi in ((0, 3), (-1, 40), (0, 2**22)):
        la = rng.integers(lo, hi, (3, 48, 64))
        lb = rng.integers(lo, hi, (3, 48, 64))
        lb[:, :8] = la[:, :8]                           # tuples both images share
        for n in (1, 2, 3):
            x = TSV._combined_prefix_ids(la[:n], lb[:n])
            y = JSV._combined_prefix_ids(la[:n], lb[:n])
            assert x[2] == y[2] and np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
    vis = TSV.visualize_label(pred, cmap)
    assert np.array_equal(vis, JSV.visualize_label(pred, cmap))
    rgb = rng.integers(0, 256, (48, 64, 3)).astype(np.float32)
    assert np.array_equal(TSV.blend_over_rgb(vis, rgb), JSV.blend_over_rgb(vis, rgb))


def _jet_index(img):
    lut = {tuple(c): i for i, c in enumerate(trun.JET_RGB.tolist())}
    return np.vectorize(lambda *c: lut[c])(img[..., 0], img[..., 1], img[..., 2])


def compare_eval_dirs(a: str, b: str, n_expected: int):
    """Every PNG under ``a`` and ``b``: the same files, decoded and compared
    (renders to 1 grey level, rendered depth to 1 JET step, the rest
    exactly).  Returns the number of PNGs."""
    files = sorted(os.path.relpath(p, a) for p in glob.glob(os.path.join(a, "**", "*.png"),
                                                            recursive=True))
    other = sorted(os.path.relpath(p, b) for p in glob.glob(os.path.join(b, "**", "*.png"),
                                                            recursive=True))
    assert files == other and len(files) == n_expected, (files, other)
    for rel in files:
        x = imageio.imread(os.path.join(a, rel)).astype(np.int64)
        y = imageio.imread(os.path.join(b, rel)).astype(np.int64)
        assert x.shape == y.shape, rel
        if rel.startswith("renders_depth"):
            d = np.abs(_jet_index(x) - _jet_index(y)).max()
        else:
            d = np.abs(x - y).max()
        assert d <= (1 if rel.startswith("renders") else 0), (rel, d)
    return len(files)


class SparseIds:
    """The fabricated sequence with sparse raw leaf ids, as ScanNet
    tree-large's loader exposes them (``semantic_id``)."""

    semantic_id = [0, 7, 19, 42]

    def __init__(self, ds):
        self.ds = ds

    def __getattr__(self, name):
        return getattr(self.ds, name)

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]


@pytest.mark.parametrize("case", ["mlp", "tree", "gt_transfer", "gt_transfer_sparse"])
def test_final_eval_save_frames_matches(tmp_path, case, capsys):
    ds, params, mlp = _scene(tmp_path)
    mlp = mlp if case in ("mlp", "gt_transfer_sparse") else None
    if case == "gt_transfer_sparse":
        ds = SparseIds(ds)
    weights = tmp_path / "lpips.npz"
    np.savez(weights, **_random_params(np.random.default_rng(4)))
    cfg = dict(eval_every=2, model=dict(eval_gt_transfer=case.startswith("gt_transfer")),
               lpips_weights=str(weights), show_semantic_frames=[0, 3])
    rt = trun.run_final_eval(ds, params, dict(cfg, raster=dict(RC, backend="pallas")),
                             str(tmp_path / "t"), mlp=mlp, save_frames=True, device="cpu")
    rj = jrun.run_final_eval(ds, params, dict(cfg, raster=dict(RC, backend="xla")),
                             str(tmp_path / "j"), mlp=mlp, save_frames=True)
    assert "show_semantic failed" not in capsys.readouterr().out
    for k, v in ROW_TOL.items():
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=v, err_msg=k)
    assert np.isfinite(rt["lpips"])
    np.testing.assert_allclose(rt["lpips"], rj["lpips"], rtol=1e-4)
    # eval frames 0 and 1 (eval_every 2 over 4 frames: t = 0, 1, 3): 4 dumps
    # and 2 label images each; 2 frames x 2 levels x (pred, GT) figures; the legend
    n = compare_eval_dirs(str(tmp_path / "t"), str(tmp_path / "j"), 3 * 6 + 8 + 1)
    assert n == 27
    sub = "rendered_semantic_multilevel" + ("_mlp" if mlp is not None else "")
    assert len(os.listdir(tmp_path / "t" / sub)) == 8
    if case.startswith("gt_transfer"):       # every predicted colour is one the GT has
        for t in (0, 1, 3):
            sem = [imageio.imread(str(tmp_path / "t" / "rendered_semantic" / f"sem_{t:04d}{s}"
                                      ".png")).reshape(-1, 3) for s in ("", "_gt")]
            assert {tuple(c) for c in sem[0]} <= {tuple(c) for c in sem[1]}, t


def test_legend_is_skipped_without_matplotlib(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = TSV.plot_semantic_legend(range(2), ["a", "b"], label_colormap(4), str(tmp_path),
                                   "legend")
    assert out is None and not os.listdir(tmp_path)
    assert "matplotlib is not installed: the legend legend.png is skipped" in \
        capsys.readouterr().out


def _finished_run(tmp_path, ds, params, mlp, name, data, backend):
    """A config file whose ``workdir/run_name`` holds ``params.npz`` (and
    the decoder) of a finished run."""
    cfg = small_config(data["basedir"], data["sequence"], workdir=str(tmp_path / name))
    cfg["data"].update(data)
    cfg.update(eval_every=2, raster=dict(RC, backend=backend))
    run_dir = tmp_path / name / cfg["run_name"]
    os.makedirs(run_dir)
    np.savez(run_dir / "params.npz", **params)
    if mlp is not None:
        np.savez(run_dir / "semantic_decoder.npz", **mlp)
    path = tmp_path / f"config_{name}.py"
    path.write_text(f"config = {cfg!r}\n")
    return str(path), str(run_dir)


def _jax_cli(cfg_path, monkeypatch):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_eval_novel_view", os.path.join(REPO, "scripts", "eval_novel_view.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["eval_novel_view.py", cfg_path])
    mod.main()


def _row(text):
    lines = text.splitlines()
    i = lines.index("[ATE RMSE cm] [PSNR] [MS-SSIM] [LPIPS] [Depth L1 cm] [Depth RMSE cm] "
                    "[mIoU%] [mbIoU%]")
    return [float(x) for x in lines[i + 1].split()]


def test_eval_novel_view_cli_train_split_matches_jax(tmp_path, monkeypatch, capsys):
    ds, params, mlp = _scene(tmp_path)
    data = dict(basedir=os.path.dirname(ds.input_folder),
                sequence=os.path.basename(ds.input_folder), num_frames=4)
    t_cfg, t_dir = _finished_run(tmp_path, ds, params, mlp, "torch", data, "pallas")
    j_cfg, j_dir = _finished_run(tmp_path, ds, params, mlp, "jax", data, "xla")
    out = _run_blocked("hierslam_torch.scripts.eval_novel_view", [t_cfg, "--device", "cpu"],
                       str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    capsys.readouterr()
    _jax_cli(j_cfg, monkeypatch)
    row_t, row_j = _row(out.stdout), _row(capsys.readouterr().out)
    # the printed precision of each column (4, 3, 4, 4, 4, 4, 2, 2 decimals)
    for x, y, unit in zip(row_t, row_j, (1e-4, 1e-3, 1e-4, 1e-4, 1e-4, 1e-4, 1e-2, 1e-2)):
        assert (np.isnan(x) and np.isnan(y)) or abs(x - y) <= unit * 1.01, (row_t, row_j)
    assert "matplotlib is not installed: the legend semantic_class_Legend_leaf.png is " \
           "skipped" in out.stdout
    # the legend needs matplotlib, which the port's subprocess has not got
    os.remove(os.path.join(j_dir, "eval", "semantic_class_Legend_leaf.png"))
    assert compare_eval_dirs(os.path.join(t_dir, "eval"), os.path.join(j_dir, "eval"),
                             3 * 6 + 8) == 26


def _replicav2(root, n=3, W=64, H=48):
    """The eval split of ReplicaV2 (``imap/01``): ``rgb_*.png``,
    ``depth_*.png`` (x 6553.5), c2w rows in ``traj_w_c.txt``."""
    from fabricate import make_scene_images

    split = os.path.join(root, "room_v2", "imap", "01")
    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(split, d))
    rows = []
    for i, (color, depth, c2w, _) in enumerate(make_scene_images(n, W, H)):
        imageio.imwrite(os.path.join(split, "rgb", f"rgb_{i}.png"), color)
        imageio.imwrite(os.path.join(split, "depth", f"depth_{i}.png"),
                        np.clip(depth * 6553.5, 0, 65535).astype(np.uint16))
        rows.append(" ".join(map(repr, c2w.reshape(-1).tolist())))
    with open(os.path.join(split, "traj_w_c.txt"), "w") as f:
        f.write("\n".join(rows))
    return root, "room_v2"


def test_eval_novel_view_cli_nvs_matches_jax(tmp_path, monkeypatch, capsys):
    _, params, _ = _scene(tmp_path)
    basedir, seq = _replicav2(str(tmp_path / "v2"))
    data = dict(basedir=basedir, sequence=seq, dataset_name="replicav2", use_train_split=False)
    t_cfg, t_dir = _finished_run(tmp_path, None, params, None, "torch", data, "pallas")
    j_cfg, j_dir = _finished_run(tmp_path, None, params, None, "jax", data, "xla")
    out = _run_blocked("hierslam_torch.scripts.eval_novel_view", [t_cfg, "--device", "cpu"],
                       str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    capsys.readouterr()
    _jax_cli(j_cfg, monkeypatch)
    text_j = capsys.readouterr().out

    def nvs(text):
        line = [ln for ln in text.splitlines() if ln.startswith("[NVS] PSNR")][-1].split()
        return float(line[2]), float(line[4]), float(line[7])

    a, b = nvs(out.stdout), nvs(text_j)
    for x, y, unit in zip(a, b, (1e-3, 1e-4, 1e-3)):
        assert abs(x - y) <= unit * 1.01, (a, b)
    assert a[0] > 0
    assert not glob.glob(os.path.join(t_dir, "eval", "**", "*.png"), recursive=True)
