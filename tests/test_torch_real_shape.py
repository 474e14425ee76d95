"""``tools/real_shape_run_torch.py`` against ``tools/real_shape_run.py`` and
``tools/procedural_room.py`` on the CPU.

* ``build_config`` gives the JAX tool's dict for the same arguments and
  environment, and the port tool's defaults resolve to the settings of
  the JAX row it is compared with (``REAL_SHAPE_r05_fixed.json``);
* ``generate`` writes what ``procedural_room.generate`` writes: the same
  ``traj.txt`` and tree to the byte, PNGs that decode to the same arrays
  (the two zlib streams differ in bytes), and JPEGs that differ in bytes:
  both encode q95 4:2:0 with libjpeg's quantization tables, but the port
  takes a float64 DCT and averages the chroma, where libjpeg takes its
  ISLOW integer DCT and a biased chroma average, so a coefficient rounds
  to another quantization step here and there.  So the decoded pixels
  are held to the frame that was encoded: the port's within 0.05 dB of
  PSNR of imageio's (0.005-0.016 dB measured at 120x68 and 1200x680),
  and the two decodes within 16 levels at any pixel and 1.5 on the mean
  (13 and 1.13 measured at 120x68; 13 and 0.52 at 1200x680);
* ``overflow_quality_check`` gives the JAX tool's keys and values (the
  JAX side's Pallas kernels in interpret mode): the mean dropped pairs at
  K and 2K equal, the PSNR between the two renders within 0.01 dB (float32
  blends summed in another order);
* on the card (marker ``cuda``), K1 at 8,192 slots a tile, the densest
  class of the 2K check, against its plain version.
"""
import importlib.util
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RS_VARS = ("RS_AUTOPSY", "RS_BUDGET", "RS_BF16", "RS_TRACK_K", "RS_SAT_MARGIN", "RS_SAT_FLOOR",
           "RS_TRACK_SAT", "RS_VIS", "RS_BACKEND", "RS_STREAM_ROWS", "RS_STREAM_CAP")


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


port = _load("real_shape_run_torch")
jax_tool = _load("real_shape_run")
room = _load("procedural_room")
LADDER = ((128, 4096), (384, 1024), (768, 512), (-1, 256))


@pytest.fixture
def env(monkeypatch):
    """A clean ``RS_*`` environment; returns a setter."""
    for k in RS_VARS:
        monkeypatch.delenv(k, raising=False)

    def set_env(values):
        for k, v in values.items():
            monkeypatch.setenv(k, v)

    return set_env


CASES = {
    "defaults": ({}, dict()),
    "row": (port.ROW_ENV, dict(bucket_spec=LADDER)),
    "gt_poses_ladder_tracking": ({"RS_BACKEND": "pallas", "RS_VIS": "100", "RS_BF16": "0"},
                                 dict(gt_poses=True, bucket_spec=LADDER,
                                      track_bucket_spec=((128, 1024), (384, 512), (-1, 128)))),
    "escalated": ({"RS_STREAM_ROWS": "1000", "RS_STREAM_CAP": "512", "RS_AUTOPSY": "1",
                   "RS_SAT_FLOOR": "64"}, dict(escalate_tiles=8, escalate_k=2048)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_config_matches_jax(case, env):
    values, kw = CASES[case]
    env(values)
    args = ("/data", "/work", 600, 340, 512, 4, 123456)
    assert port.build_config(*args, **kw) == jax_tool.build_config(*args, **kw)


def test_defaults_resolve_to_the_jax_row(env):
    """No argument and no ``RS_*`` variable: the config of the JAX row's run
    (``RS_SAT_MARGIN=2.0 RS_BUDGET=4100000``, flat 512-slot tracking
    without saturation capping, the JAX tool's defaults otherwise); an
    ``RS_*`` variable set by the caller still wins."""
    args = port.parser().parse_args(["--data", "/d", "--workdir", "/w"])
    cfg = port.resolve(args)
    env(port.ROW_ENV)
    want = jax_tool.build_config("/d", "/w", 1200, 680, 1024, 8, 2_000_000,
                                 bucket_spec=LADDER, track_bucket_spec=None)
    assert cfg == want
    r = cfg["raster"]
    assert (r["track_bucket_spec"], r["track_max_per_tile"], r["track_sat_margin"]) == (None, 512,
                                                                                      0.0)
    assert (r["sat_margin"], r["grad_pair_budget"], r["stream_rows"]) == (2.0, 4_100_000, 78_000)
    assert (r["visible_budget"], r["stream_cap"], cfg["map_capacity"]) == (1_500_000, 4096,
                                                                          2_000_000)
    assert port.resolve(args, env={"RS_TRACK_K": "1024"})["raster"]["track_max_per_tile"] == 1024
    gt = port.resolve(port.parser().parse_args(["--gt-poses", "--stop-at", "16"]))
    assert gt["tracking"]["use_gt_poses"] and gt["run_name"] == "proc_room_gtpose"
    assert gt["data"]["num_frames"] == 16


def test_generate_matches_procedural_room(tmp_path):
    room.generate(str(tmp_path / "jax"), 2, 120, 68)
    port.generate(str(tmp_path / "torch"), 2, 120, 68, workers=1)
    a, b = tmp_path / "jax" / "proc_room", tmp_path / "torch" / "proc_room"
    files = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(b)) for p in b.rglob("*") if p.is_file())
    assert len(files) == 8
    for name in ("traj.txt", "info_semantic_tree.json"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    for name in files:
        if name.endswith(".png"):
            x, y = imageio.imread(a / name), imageio.imread(b / name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        elif name.endswith(".jpg"):
            x = imageio.imread(a / name).astype(np.float64)
            y = imageio.imread(b / name).astype(np.float64)
            assert x.shape == y.shape == (68, 120, 3)
            d = np.abs(x - y)
            assert d.max() <= 16 and d.mean() <= 1.5, (name, d.max(), d.mean())
            i = int(name[-10:-4])
            src = room.render_frame(i, 120, 68, 60.0, 60.0, 59.5, 33.5, 2)[0].astype(np.float64)
            psnr = [10 * np.log10(255.0**2 / np.mean((v - src) ** 2)) for v in (x, y)]
            assert psnr[1] >= psnr[0] - 0.05, (name, psnr)
    # and the depth PNG truncates as the JAX writer does (no rounding)
    _, depth, _, _ = room.render_frame(1, 120, 68, 60.0, 60.0, 59.5, 33.5, 2)
    np.testing.assert_array_equal(imageio.imread(b / "results" / "depth000001.png"),
                                  np.clip(depth * 6553.5, 0, 65535).astype(np.uint16))


def _small_map(n=600, frames=30, seed=4):
    """A wall + floor cloud in front of a camera that slides along x."""
    rng = np.random.default_rng(seed)
    h = n // 2
    wall = np.stack([rng.uniform(-1.5, 1.5, h), rng.uniform(-1.0, 1.0, h),
                     2.5 + 0.05 * rng.normal(size=h)], -1)
    floor = np.stack([rng.uniform(-1.5, 1.5, n - h), 1.0 + 0.02 * rng.normal(size=n - h),
                      rng.uniform(0.8, 2.5, n - h)], -1)
    cam_q = np.tile(np.array([1.0, 0, 0, 0])[None, :, None], (1, 1, frames))
    cam_t = np.zeros((1, 3, frames))
    cam_t[0, 0] = np.linspace(0, 0.3, frames)
    p = dict(means3D=np.concatenate([wall, floor]), rgb_colors=rng.uniform(0, 1, (n, 3)),
             unnorm_rotations=np.tile([1.0, 0, 0, 0], (n, 1)),
             logit_opacities=rng.uniform(-1, 3, (n, 1)),
             log_scales=np.log(rng.uniform(0.03, 0.12, (n, 1))),
             cam_unnorm_rots=cam_q, cam_trans=cam_t, w2c=np.eye(4))
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def test_overflow_quality_check_matches_jax(env):
    env(port.ROW_ENV)
    W, H = 64, 48
    cfg = jax_tool.build_config("/d", "/w", W, H, 32, 8, 4096,
                                bucket_spec=((2, 64), (4, 32), (-1, 16)))
    K4 = np.eye(4)
    K4[0, 0] = K4[1, 1] = 40.0
    K4[0, 2], K4[1, 2] = W / 2, H / 2
    dataset = [(np.zeros((H, W, 3), np.uint8), np.ones((H, W), np.float32), K4)]
    pn = _small_map()
    oj = jax_tool.overflow_quality_check(pn, cfg, dataset, 32, 30)
    ot = port.overflow_quality_check(pn, cfg, dataset, 32, 30, device="cpu")
    assert sorted(ot) == sorted(oj) == ["overflow_pairs_K32", "overflow_pairs_K64",
                                        "overflow_psnr_K_vs_2K"]
    assert ot["overflow_pairs_K32"] == oj["overflow_pairs_K32"] > 0
    assert ot["overflow_pairs_K64"] == oj["overflow_pairs_K64"]
    assert abs(ot["overflow_psnr_K_vs_2K"] - oj["overflow_psnr_K_vs_2K"]) <= 0.01, (ot, oj)


@pytest.mark.cuda
def test_k1_at_8192_slots_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from hierslam_torch.ops import kernels, render_pallas

    rng = np.random.default_rng(8192)
    T, K, F, gx = 8, 8192, 11, 4
    tid = np.arange(T)
    xy = np.stack([(tid % gx * 16)[:, None] + rng.uniform(-6, 22, (T, K)),
                   (tid // gx * 16)[:, None] + rng.uniform(-6, 22, (T, K))], -1)
    a, c = rng.uniform(0.02, 0.4, (T, K)), rng.uniform(0.02, 0.4, (T, K))
    b = rng.uniform(-0.5, 0.5, (T, K)) * np.sqrt(a * c)
    # faint gaussians so that most pixels walk deep into the 8,192 slots
    opa = rng.uniform(0.001, 0.01, (T, K))
    dep = np.sort(rng.uniform(0.5, 5.0, (T, K)), axis=1)
    table = np.concatenate([xy, np.stack([a, b, c], -1), opa[..., None], dep[..., None],
                            rng.uniform(0, 1, (T, K, F))], -1).astype(np.float32)
    tab = torch.as_tensor(table, device="cuda")
    ok = torch.as_tensor(rng.uniform(size=(T, K)) > 0.15, device="cuda")
    acc, ft, med, last, mslot = kernels.blend_fwd(tab, ok, gx, (16, 16))
    acc_p, ft_p, med_p = render_pallas.blend_fwd_plain(tab, ok, gx, (16, 16))
    assert int(last.max()) > 4096
    torch.testing.assert_close(acc, acc_p, atol=1e-3, rtol=0)
    torch.testing.assert_close(ft, ft_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(med, med_p, atol=1e-4, rtol=0)
    g = torch.randn_like(acc), torch.randn_like(ft), torch.randn_like(med)
    dt = kernels.blend_bwd(tab, ok, ft, last, mslot, *g, gx, (16, 16))
    dp = render_pallas.blend_bwd_plain(tab, ok, *g, gx, (16, 16))
    assert ((dt - dp).abs() / (1 + dp.abs())).max() <= 2e-3

