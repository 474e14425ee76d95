"""The ScanNet slice on the CPU: the port's ScanNet loaders, the sparse-id
eval protocol, the whole ``run_slam`` at F = 77 (the tree-large config)
against the JAX package, and the plain versions of K1-K4 at F = 77 against
the JAX kernels in interpret mode.

The fabricated sequence is ``tests/fabricate.py::fabricate_scannet``'s;
the wide tree-large TSV is written here: 550 sparse raw ids over levels of
(4, 8, 12, 20, 30) classes, 74 channels, the widths of the shipped
tree-large config, with the fabricated label ids (0, 100, 200, 300) among
the leaves.

Tolerances, with their reasons:
* loaders: labels, depth, K, poses and the class lists exact; colour
  exact where it is not resized (Pillow's decode to the bit) and to 1e-4
  where it is (``tests/test_torch_datasets.py``: the float32 of cv2's
  INTER_LINEAR sum, taken in another order);
* sparse-id eval: the mIoU and boundary-mIoU rows and the per-class lines
  equal, the rest as ``tests/test_torch_eval.py`` holds them;
* the whole slice, modelled on ``tests/test_torch_cli.py::
  test_run_slam_matches_jax`` (the same draws on both sides, the reasons
  given there).  The mapping at t = 0 sees the same inputs: each loss term
  of its iterations to 1e-4.  The first tracking iteration follows it: 5e-3
  of the total loss (5e-5 measured).  After that this config parts the two
  runs further than the Replica test's: Adam (eps 1e-15) moves each pose
  dof by about ``lr`` a step whatever its gradient, and one rotation
  gradient here is 1e-3 of the largest, rounding-level, so its sign can
  differ and the poses step apart; at 3 iterations a step moves the loss by
  3-5%, and frame 2 starts from a pose propagated from frame 1 with twice
  that difference.  So later tracking records to 1e-1 of the total loss
  (7.6% measured, at frame 2), the later mapping terms to 5e-2 (1.2%
  measured).  Final poses to 2 mm and 1e-3 (0.03 mm, 2.7e-4 measured),
  parameters to ``2 lr`` a mapping step at most and a twentieth of that
  on average; the eval row (frame 0): PSNR to 0.5 dB and MS-SSIM to 2e-2
  (0.16 dB and 4.6e-3 measured: map parameters whose gradients are
  rounding noise move by ``lr`` a step on one side only), depth and ATE to
  0.05 cm, mIoU to 2 points;
* plain K1-K4 at F = 77: the bounds of ``tests/test_torch_raster.py``
  (K1 2e-4, K2 2e-3) and ``tests/test_torch_stream.py`` (K3 3e-4 on
  colour, mass and T, 3e-3 on depth, median and semantics; K4 2e-3 of the
  largest reference entry).

The CUDA kernels run only on the card: ``test_wide_kernels_on_card`` holds
each against its plain version at F = 33 and 77 there and skips here.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fabricate import fabricate_scannet
from test_torch_cli import _records, same_draws  # noqa: F401 (a fixture)
from test_torch_raster import TILE, make_tables, t
from test_torch_stream import bin_both, render_jax, render_torch, scene
from hierslam_torch.datasets import get_dataset as t_get_dataset
from hierslam_torch.eval import runner as trun
from hierslam_torch.ops import render_pallas as tpal
from hierslam_tpu.datasets import get_dataset as j_get_dataset
from hierslam_tpu.eval import runner as jrun
from hierslam_tpu.ops.render_pallas import render_tiles_pallas as j_render_tiles_pallas

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = (4, 8, 12, 20, 30)       # tree-large level widths: 74 channels
N_LEAF = 550
LABEL_IDS = (0, 100, 200, 300)    # the raw ids of fabricate_scannet's label images


def write_tree_large(root: str) -> list:
    """A tree-large TSV of ``N_LEAF`` sparse raw ids (the label ids among
    them) whose level ids are the leaf's index modulo each width; returns
    the raw ids in order."""
    ids = set(LABEL_IDS)
    k = 0
    while len(ids) < N_LEAF:
        ids.add(7 + 3 * k)
        k += 1
    ids = sorted(ids)
    lines = ["\t".join(f"c{i}" for i in range(27))]
    for i, raw in enumerate(ids):
        row = ["0"] * 27
        row[0], row[1], row[4], row[7] = str(raw), f"raw{raw}", "1", "class1"
        for lv, w in enumerate(WIDTHS):
            row[17 + 2 * lv], row[18 + 2 * lv] = str(i % w), f"l{lv + 1}_{i % w}"
        lines.append("\t".join(row))
    with open(os.path.join(root, "scannetv2-labels.combined.tree-large.tsv"), "w") as f:
        f.write("\n".join(lines))
    return ids


def _sequence(tmp_path, n_frames=4, wide=False, big_colour=False):
    basedir, seq, cam = fabricate_scannet(str(tmp_path / "d"), n_frames=n_frames)
    if wide:
        write_tree_large(basedir)
    if big_colour:   # ScanNet's colour is 1296x968 against 640x480 depth: ~2.03x
        for p in glob.glob(os.path.join(basedir, seq, "color", "*.jpg")):
            img = np.asarray(Image.open(p))
            big = Image.fromarray(img).resize((130, 98), Image.BILINEAR)
            big.save(p, quality=95)
    return basedir, seq, cam


def _kwargs(basedir, seq, cam, sem_mode, H=48, W=64):
    cfg = dict(cam)
    if sem_mode is None:
        cfg["dataset_name"] = "scannet"
    else:
        cfg["sem_mode"] = sem_mode
    return dict(config_dict=cfg, basedir=basedir, sequence=seq, start=0, end=-1, stride=1,
                desired_height=H, desired_width=W, relative_pose=True)


@pytest.mark.parametrize("sem_mode,wide,big_colour", [
    (None, False, False), ("nyu40", False, False), ("tree", False, False),
    ("tree_large", False, False), ("tree_large", True, False), ("tree_large", True, True)])
def test_scannet_loader_matches(tmp_path, sem_mode, wide, big_colour):
    basedir, seq, cam = _sequence(tmp_path, wide=wide, big_colour=big_colour)
    H, W = (24, 32) if big_colour else (48, 64)
    kw = _kwargs(basedir, seq, cam, sem_mode, H, W)
    td, jd = t_get_dataset(**kw), j_get_dataset(**kw)
    assert type(td).__name__ == type(jd).__name__
    assert len(td) == len(jd) == 4
    if sem_mode is not None:
        assert td.num_semantic == jd.num_semantic
        assert td.num_semantic_class == jd.num_semantic_class
        assert np.array_equal(td.colour_map_np, jd.colour_map_np)
    if sem_mode == "tree_large":
        assert td.semantic_id == jd.semantic_id == sorted(td.semantic_id)
        assert td.semantic_class == jd.semantic_class
        if wide:
            assert td.num_semantic == list(WIDTHS) + [N_LEAF]
    for i in range(len(td)):
        a, b = td[i], jd[i]
        assert len(a) == len(b) == (4 if sem_mode is None else 5)
        assert a[0].shape == (H, W, 3)
        if big_colour:   # the float32 of cv2's INTER_LINEAR sum
            np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-4)
        else:
            assert a[0].dtype == b[0].dtype and np.array_equal(a[0], b[0])
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    if big_colour:   # the intrinsics follow the depth's 48x64 -> 24x32
        np.testing.assert_allclose(td[0][2][:2, :3], [[20, 0, 16], [0, 20, 12]])
    if sem_mode == "tree_large":   # dense leaf indices of the label ids
        dense = {td.semantic_id.index(r) for r in LABEL_IDS}
        assert set(np.unique(td[0][4][-1]).tolist()) <= dense


def _tree_large_scene(tmp_path):
    """A wide tree-large dataset (the JAX loader, read by both evals) and a
    map: frame 0 back-projected, random 74-channel semantics and a decoder
    whose bias favours the leaves the labels hold, GT poses with small
    errors."""
    basedir, seq, cam = _sequence(tmp_path, wide=True)
    ds = j_get_dataset(**_kwargs(basedir, seq, cam, "tree_large"))
    rng = np.random.default_rng(4)
    color, depth, K4, _ = ds[0][:4]
    K = np.asarray(K4)[:3, :3]
    ys, xs = np.nonzero(depth > 0)
    z = depth[ys, xs]
    pts = np.stack([(xs - K[0, 2]) * z / K[0, 0], (ys - K[1, 2]) * z / K[1, 1], z], -1)
    n, S = len(z), sum(WIDTHS)
    gt_w2c = np.stack([np.linalg.inv(ds[t][3]) for t in range(4)]).astype(np.float32)
    trans = gt_w2c[:, :3, 3] + rng.normal(0, 0.003, (4, 3))
    params = {
        "means3D": pts, "rgb_colors": color[ys, xs] / 255.0,
        "unnorm_rotations": np.tile([1.0, 0, 0, 0], (n, 1)),
        "logit_opacities": np.full((n, 1), 4.0),
        "log_scales": np.log(z / K[0, 0])[:, None] + np.log(1.2),
        "semantic": rng.uniform(0, 1, (n, S)),
        "cam_unnorm_rots": np.tile(np.array([1.0, 0, 0, 0])[None, :, None], (1, 1, 4)),
        "cam_trans": trans.T[None],
        "w2c": np.eye(4), "gt_w2c_all_frames": gt_w2c,
    }
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    b = rng.normal(size=(N_LEAF,))
    b[[ds.semantic_id.index(r) for r in LABEL_IDS]] += 6.0
    mlp = {"w": (0.3 * rng.normal(size=(N_LEAF, S))).astype(np.float32),
           "b": b.astype(np.float32)}
    return ds, params, mlp


def test_sparse_id_eval_matches(tmp_path, capsys):
    ds, params, mlp = _tree_large_scene(tmp_path)
    rc = dict(max_per_tile=1024, gaussian_chunk=64, tile_batch=4)
    cfg = dict(eval_every=2, model=dict())
    rt = trun.run_final_eval(ds, params, dict(cfg, raster=dict(rc, backend="pallas")),
                             str(tmp_path / "t"), mlp=mlp, device="cpu")
    out_t = capsys.readouterr().out
    rj = jrun.run_final_eval(ds, params, dict(cfg, raster=dict(rc, backend="xla")),
                             str(tmp_path / "j"), mlp=mlp)
    out_j = capsys.readouterr().out
    for k in ("miou_pct", "mbiou_pct"):
        assert rt[k] == rj[k], k
    tol = dict(psnr=1e-4, ms_ssim=1e-5, depth_l1_cm=1e-4, depth_rmse_cm=1e-4, ate_rmse_cm=1e-4)
    for k, v in tol.items():
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=v, err_msg=k)
    assert rt["miou_pct"] > 0
    iou = [open(tmp_path / d / "sem_iou_2flat.txt").read() for d in ("t", "j")]
    assert iou[0] == iou[1]
    lines_t = [ln for ln in out_t.splitlines() if ln.startswith((" semantic", "current", "mean"))]
    lines_j = [ln for ln in out_j.splitlines() if ln.startswith((" semantic", "current", "mean"))]
    assert lines_t == lines_j
    # classes are raw ids, in raw-id order, named by the TSV
    for frame in out_t.split("current frame is:")[1:]:
        ids = [int(ln.split()[2]) for ln in frame.splitlines() if ln.startswith(" semantic")]
        assert ids == sorted(ids) and set(ids) <= set(ds.semantic_id) and ids
        assert all(f"(raw{i})" in frame for i in ids)
    assert set(ids) & set(LABEL_IDS)


def _slam_config(tmp_path, basedir, seq, cam, workdir):
    """The shipped tree-large config with the fabricated sequence's 64x48
    camera and, cut for a CPU test's time and memory: a map of 32,768 slots
    (3M shipped), 512 stream rows and 65,536 gradient pairs (the JAX
    package sizes its buffers by these budgets; 12 tiles need about 50
    rows, and the test holds every mapping iteration to 0 dropped pairs)
    and 3 tracking / 3 mapping iterations."""
    from hierslam_torch.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "scannet", "hierslam_semantic_large_run.py"))
    cfg["data"].pop("gradslam_data_cfg")
    cfg["data"].update(basedir=basedir, basedir_sem=basedir, sequence=seq, num_frames=3,
                       desired_image_height=48, desired_image_width=64,
                       dataset_name=cam["dataset_name"], camera_params=cam["camera_params"])
    cfg.update(workdir=str(workdir), run_name="scannet", map_capacity=32768)
    cfg["raster"].update(stream_rows=512, grad_pair_budget=65536)
    cfg["tracking"]["num_iters"] = 3
    cfg["mapping"]["num_iters"] = 3
    return cfg


def test_run_slam_tree_large_matches_jax(tmp_path, same_draws):
    from hierslam_torch.slam.pipeline import run_slam as t_run_slam
    from hierslam_tpu.slam.pipeline import run_slam as j_run_slam

    basedir, seq, cam = _sequence(tmp_path, n_frames=3, wide=True)
    cfg = _slam_config(tmp_path, basedir, seq, cam, tmp_path / "jax")
    # up to ~2,600 pairs a tile: under the shipped one class of 512 slots the
    # port's tracker sizes classes from the counts and drops none, where the
    # JAX package cuts every list at 512.  Both trackers take a rank ladder
    # that puts all 12 tiles in 512 slots, which each package cuts alike: the
    # lists both took before, so that the runs compare on the same lists
    cfg["raster"]["track_bucket_spec"] = ((12, 512), (-1, 256))
    tcfg = dict(cfg, workdir=str(tmp_path / "torch"))
    assert cfg["raster"]["backend"] == "stream" and cfg["map_every"] == 1
    pt, st, rt = t_run_slam(tcfg, device="cpu")
    pj, sj, rj = j_run_slam(cfg)
    assert pt["semantic"].shape[1] == sum(WIDTHS) == 74

    jm = os.path.join(cfg["workdir"], "scannet", "metrics.jsonl")
    tm = os.path.join(tcfg["workdir"], "scannet", "metrics.jsonl")
    jt, tt = _records(jm, "tracking"), _records(tm, "tracking")
    assert len(jt) == len(tt) == 6
    for i, (a, b) in enumerate(zip(tt, jt)):
        for k in ("tracking_loss", "tracking_depth", "tracking_im"):
            rel = 5e-3 if i == 0 else 1e-1
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=rel * b["tracking_loss"],
                                       err_msg=f"{k} frame {a['step']} record {i}")
    jmp, tmp = _records(jm, "mapping"), _records(tm, "mapping")
    assert len(jmp) == len(tmp) == 9
    assert max(r["mapping_n_map_bin_dropped"] + r["mapping_n_grad_dropped"]
               for r in tmp + jmp) == 0
    for i, (a, b) in enumerate(zip(tmp, jmp)):   # t = 0 (i < 3): the same inputs
        for k in ("mapping_loss", "mapping_im", "mapping_depth", "mapping_sem"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4 if i < 3 else 5e-2,
                                       err_msg=f"{k} record {i}")
    assert st["densify_added"] == sj["densify_added"]
    assert sorted(pt) == sorted(pj)
    tol = dict(cam_trans=2e-3, cam_unnorm_rots=1e-3, gt_w2c_all_frames=0.0,
               keyframe_time_indices=0.0, intrinsics=0.0, w2c=1e-7, org_width=0.0,
               org_height=0.0, timestep=0.0)
    steps = 3 * cfg["mapping"]["num_iters"]              # mappings at t = 0, 1, 2
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
    run_dir = os.path.join(tcfg["workdir"], "scannet")
    with np.load(os.path.join(run_dir, "params.npz")) as saved:
        assert sorted(saved) == sorted(pt)
    with np.load(os.path.join(run_dir, "semantic_decoder.npz")) as dec:
        assert dec["w"].shape == (N_LEAF, 74) and dec["b"].shape == (N_LEAF,)
    for k, v in dict(psnr=0.5, ms_ssim=2e-2, depth_l1_cm=0.05, depth_rmse_cm=0.05,
                     ate_rmse_cm=0.05, miou_pct=2.0, mbiou_pct=2.0).items():
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=v, err_msg=k)
    assert np.isnan(rt["lpips"])


def test_plain_ladder_blend_at_77_matches_pallas_interpret():
    """K1 and K2's plain versions at F = 77 against the JAX Pallas kernel in
    interpret mode: forward and VJP."""
    table, ok = make_tables(seed=2, K=96, F=77)
    shape, grid = (32, 48), (2, 3)
    rng = np.random.default_rng(12)
    ga = rng.normal(size=(79, 32, 48)).astype(np.float32)
    gf = rng.normal(size=shape).astype(np.float32)
    gm = rng.normal(size=shape).astype(np.float32)

    def run_j(tb):
        return j_render_tiles_pallas(tb, jnp.asarray(ok), image_shape=shape, tile_shape=TILE,
                                     grid=grid, interpret=True)

    aj, fj, mj = (np.asarray(x) for x in run_j(jnp.asarray(table)))
    gj = np.asarray(jax.grad(lambda tb: sum(
        jnp.sum(x * g) for x, g in zip(run_j(tb), (ga, gf, gm))))(jnp.asarray(table)))
    tt = t(table).requires_grad_(True)
    a, f, m = tpal.render_tiles_pallas(tt, torch.as_tensor(ok), image_shape=shape,
                                       tile_shape=TILE, grid=grid)
    np.testing.assert_allclose(a.detach().numpy(), aj, atol=2e-4)
    np.testing.assert_allclose(f.detach().numpy(), fj, atol=2e-4)
    np.testing.assert_allclose(m.detach().numpy(), mj, atol=2e-4)
    ((a * t(ga)).sum() + (f * t(gf)).sum() + (m * t(gm)).sum()).backward()
    assert np.abs(gj[..., 7:]).max() > 0
    np.testing.assert_allclose(tt.grad.numpy(), gj, rtol=2e-3, atol=2e-3)


def test_plain_stream_blend_at_77_matches_interpret():
    """K3 and K4's plain versions at F = 77 against the JAX stream kernels
    in interpret mode: forward and VJP."""
    sem = 74
    s = scene(sem=sem)
    cfg = dict(stream_cap=256)
    bj, bt = bin_both(s, **cfg)
    assert int(bt.lists.n_dropped) == 0
    chj, ftj, mdj = (np.asarray(x) for x in render_jax(s, bj, jnp.asarray(s["table"]), cfg,
                                                         3 + sem))
    cht, ftt, mdt = (x.numpy() for x in render_torch(s, bt, t(s["table"]), cfg, 3 + sem))
    np.testing.assert_allclose(cht[:3], chj[:3], atol=3e-4)
    np.testing.assert_allclose(cht[-1], chj[-1], atol=3e-4)
    np.testing.assert_allclose(cht[3:-1], chj[3:-1], atol=3e-3)
    np.testing.assert_allclose(ftt, ftj, atol=3e-4)
    np.testing.assert_allclose(mdt, mdj, atol=3e-3)

    H, W = s["tc"].height, s["tc"].width
    rng = np.random.default_rng(3)
    gw = (rng.normal(size=(3 + sem + 2, H, W)) * 0.1).astype(np.float32)
    gw_ft = (rng.normal(size=(H, W)) * 0.1).astype(np.float32)
    gw_med = (rng.normal(size=(H, W)) * 0.01).astype(np.float32)

    def loss_j(tab):
        ch, ft, med = render_jax(s, bj, tab, cfg, 3 + sem)
        return (jnp.sum(ch * gw) + jnp.sum(ft * gw_ft)
                + jnp.sum(med * jnp.where(med < 14.0, gw_med, 0.0)))

    gj = np.asarray(jax.grad(loss_j)(jnp.asarray(s["table"])))
    tab = t(s["table"]).requires_grad_(True)
    ch, ft, med = render_torch(s, bt, tab, cfg, 3 + sem)
    med_w = torch.where(med < 14.0, t(gw_med), torch.zeros_like(med))
    ((ch * t(gw)).sum() + (ft * t(gw_ft)).sum() + (med * med_w).sum()).backward()
    assert np.abs(gj[:, 5:]).max() > 0
    np.testing.assert_allclose(tab.grad.numpy(), gj, rtol=0, atol=2e-3 * np.abs(gj).max())


@pytest.mark.cuda
@pytest.mark.parametrize("F", [33, 77])
def test_wide_kernels_on_card(F):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from hierslam_torch.core import transforms as ttf
    from hierslam_torch.ops import kernels
    from hierslam_torch.ops import render_stream as trs
    from hierslam_torch.ops.rasterize import RasterConfig

    table, ok = make_tables(seed=F, T=12, K=256, F=F, grid_x=4)
    tab, okc = torch.as_tensor(table, device="cuda"), torch.as_tensor(ok, device="cuda")
    acc, ft, med, last, mslot = kernels.blend_fwd(tab, okc, 4, TILE)
    acc_p, ft_p, med_p = tpal.blend_fwd_plain(tab, okc, 4, TILE)
    torch.testing.assert_close(acc, acc_p, atol=1e-3, rtol=0)
    torch.testing.assert_close(ft, ft_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(med, med_p, atol=1e-4, rtol=0)
    g = torch.randn_like(acc), torch.randn_like(ft), torch.randn_like(med)
    dt = kernels.blend_bwd(tab, okc, ft, last, mslot, *g, 4, TILE)
    dp = tpal.blend_bwd_plain(tab, okc, *g, 4, TILE)
    assert ((dt - dp).abs() / (1 + dp.abs())).max() <= 2e-3

    s = scene(sem=F - 3, n=300)
    bt = bin_both(s, stream_cap=256)[1]
    n, C = s["table"].shape
    H, W = s["tc"].height, s["tc"].width
    dev = torch.device("cuda")
    stream = torch.cat([t(s["table"]), trs.sentinel_row(C)], 0).to(dev)[
        bt.lists.idx.to(dev)].contiguous()
    sc = trs.make_scalars(ttf.build_w2c(ttf.normalize(t(s["q"])), t(s["tr"])).to(dev), s["tc"])
    ro = bt.lists.row_off.to(dev)
    grid = RasterConfig().grid(H, W)
    acc, ft, med, last, mpos = kernels.stream_fwd(stream, sc, ro, grid[1], TILE, F, (H, W))
    acc_p, ft_p, med_p = trs.blend_stream_fwd_plain(stream, sc, ro, grid, TILE, F, (H, W))
    torch.testing.assert_close(acc, acc_p, atol=1e-3, rtol=0)
    torch.testing.assert_close(ft, ft_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(med, med_p, atol=1e-4, rtol=0)
    g = torch.randn_like(acc), torch.randn_like(ft), torch.randn_like(med)
    d = kernels.stream_bwd(stream, sc, ro, ft, last, mpos, *g, grid[1], TILE, F, (H, W))
    dp = trs.blend_stream_bwd_plain(stream, sc, ro, *g, grid, TILE, F, (H, W), mpos=mpos)
    assert ((d - dp).abs() / (1 + dp.abs())).max() <= 2e-3
    assert (d[bt.lists.idx.to(dev) == n] == 0).all()
    with pytest.raises(ValueError, match="at most 128"):
        kernels.stream_fwd(stream, sc, ro, grid[1], TILE, 129, (H, W))
