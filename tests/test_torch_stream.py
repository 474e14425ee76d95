"""Parity of the port's pair-stream renderer with the JAX package on the CPU.

The JAX side runs its stream kernels in interpret mode (its default on the
CPU), the port its plain versions (``blend_stream_fwd_plain`` for K3,
``blend_stream_bwd_plain`` for K4).  Tolerances:

* binning: exact (row offsets, allocations and counts equal; per-tile
  lists compared as sets).  With a binding row budget the leftover rows go
  to tied tiles in an order JAX's unstable argsort decides, so only the
  multiset of allocations and the accounting are compared there;
* forward: ``tests/test_stream.py``'s bounds (3e-4 on colour, mass and
  final T, 3e-3 on depth, median and semantics): float32 transmittance as
  a product here and in log space there;
* table gradients: 2e-3 of the largest reference entry, the bound JAX
  holds its own stream VJP to; the median cotangent is masked where the
  median is the 15.0 default (it routes nowhere) or near it (>= 14).

The CUDA kernels run only on the card: ``test_stream_kernels_on_card``
compares them with the plain versions there and skips here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import make_scene
from hierslam_torch.core import camera as tcam
from hierslam_torch.core import transforms as ttf
from hierslam_torch.ops import render_stream as trs
from hierslam_torch.ops.rasterize import RasterConfig as TConfig
from hierslam_tpu.core import camera as jcam
from hierslam_tpu.core import transforms as jtf
from hierslam_tpu.ops import render_stream as jrs
from hierslam_tpu.ops.gather_vjp import pack_cols_table
from hierslam_tpu.ops.rasterize import RasterConfig as JConfig

torch.set_num_threads(1)


def t(x):
    return torch.as_tensor(np.array(x, np.float32))


def scene(sem=0, seed=0, n=120, W=40, H=24):
    """``tests/test_stream.py``'s scene: an identity-w2c camera and an
    explicit pose, as the SLAM path renders."""
    sc, cam = make_scene(n=n, seed=seed, W=W, H=H, sem=sem)
    K = jcam.intrinsics_matrix(cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    q = np.asarray(jtf.matrix_to_quaternion(jnp.asarray(cam["w2c"][:3, :3])), np.float32)
    tr = np.asarray(cam["w2c"][:3, 3], np.float32)
    cols = [sc["means3D"], np.log(sc["scales"][:, :1]),
            np.log(sc["opacities"] / (1 - sc["opacities"]))[:, None], sc["colors"]]
    if sem:
        cols.append(sc["semantics"])
    table = np.concatenate(cols, 1).astype(np.float32)          # [N, 5+F]
    return dict(table=table, rots=np.asarray(sc["rotations"], np.float32), q=q, tr=tr,
                jc=jcam.setup_camera(W, H, K, np.eye(4)),
                tc=tcam.setup_camera(W, H, K, np.eye(4)))


def bin_both(s, **cfg):
    tb, rots = s["table"], s["rots"]
    qj, tj = jnp.asarray(s["q"]), jnp.asarray(s["tr"])
    mj, _ = jtf.transform_to_frame(jnp.asarray(tb[:, :3]), jnp.asarray(rots), qj, tj,
                                   gaussians_grad=False, camera_grad=False)
    opa = 1 / (1 + np.exp(-tb[:, 4]))
    bj = jrs.compute_stream_binning(mj, jnp.exp(jnp.asarray(tb[:, 3:4])), jnp.asarray(rots),
                                    s["jc"], JConfig(backend="stream", **cfg),
                                    opacities=jnp.asarray(opa))
    mt, _ = ttf.transform_to_frame(t(tb[:, :3]), t(rots), t(s["q"]), t(s["tr"]),
                                   gaussians_grad=False, camera_grad=False)
    bt = trs.compute_stream_binning(mt, torch.exp(t(tb[:, 3:4])), t(rots), s["tc"],
                                    TConfig(backend="stream", **cfg), opacities=t(opa))
    return bj, bt


def tile_sets(lists, n):
    ro, idx = np.asarray(lists.row_off), np.asarray(lists.idx)
    out = []
    for k in range(ro.shape[0] - 1):
        rows = idx[ro[k]:ro[k + 1]].reshape(-1)
        out.append(tuple(sorted(rows[rows < n].tolist())))
    return out


@pytest.mark.parametrize("sat", [0.0, 2.0])
def test_bin_stream_matches(sat):
    s = scene(n=300, W=64, H=48)
    s["table"][:, 3] += np.log(2.0)   # larger and opaque enough for tiles to saturate
    s["table"][:, 4] = 4.0
    n = s["table"].shape[0]
    bj, bt = bin_both(s, stream_cap=256, sat_margin=sat, sat_floor=8)
    lj, lt = bj.lists, bt.lists
    for f in ("row_off", "count", "k_eff", "k_alloc", "n_refs", "n_rows", "n_dropped",
              "n_sat_masked"):
        np.testing.assert_array_equal(getattr(lt, f).numpy(), np.asarray(getattr(lj, f)),
                                      err_msg=f)
    assert lt.row_off.dtype == torch.int32
    assert lt.idx.shape == (int(lt.n_rows), 128)
    assert tile_sets(lt, n) == tile_sets(lj, n)
    # pad slots hold the sentinel index n, which the renderer appends
    assert int(lt.idx.max()) == n and int(lt.idx.min()) >= 0
    assert sat == 0.0 or int(lt.n_sat_masked) > 0


def test_bin_stream_tight_budget_matches():
    s = scene(n=400)
    bj, bt = bin_both(s, stream_cap=256, stream_rows=4)
    lj, lt = bj.lists, bt.lists
    assert int(lt.n_rows) == int(lj.n_rows) <= 4
    rows_j = np.diff(np.asarray(lj.row_off))
    rows_t = np.diff(lt.row_off.numpy())
    np.testing.assert_array_equal(np.sort(rows_t), np.sort(rows_j))
    for f in ("count", "k_eff", "n_refs", "n_dropped", "n_sat_masked"):
        np.testing.assert_array_equal(getattr(lt, f).numpy(), np.asarray(getattr(lj, f)),
                                      err_msg=f)
    assert int(lt.n_dropped) > 0
    assert int(lt.n_refs) + int(lt.n_dropped) + int(lt.n_sat_masked) == int(lt.count.sum())


def render_jax(s, bj, table, cfg, n_feat):
    q, tr = jnp.asarray(s["q"]), jnp.asarray(s["tr"])
    w2c = jtf.build_w2c(jtf.normalize(q), tr)
    tab = pack_cols_table([table[:, i] for i in range(table.shape[1])])
    return jrs.render_from_table(tab, bj, w2c, s["jc"], JConfig(backend="stream", **cfg),
                                 n_feat)


def render_torch(s, bt, table, cfg, n_feat):
    w2c = ttf.build_w2c(ttf.normalize(t(s["q"])), t(s["tr"]))
    return trs.render_from_table(table, bt, w2c, s["tc"], TConfig(backend="stream", **cfg),
                                 n_feat)


CFG = dict(stream_cap=256)


@pytest.mark.parametrize("sem", [0, 5])
def test_render_from_table_forward_matches(sem):
    s = scene(sem=sem)
    bj, bt = bin_both(s, **CFG)
    assert int(bt.lists.n_dropped) == 0
    chj, ftj, mdj = (np.asarray(x) for x in render_jax(s, bj, jnp.asarray(s["table"]), CFG,
                                                         3 + sem))
    cht, ftt, mdt = render_torch(s, bt, t(s["table"]), CFG, 3 + sem)
    cht, ftt, mdt = cht.numpy(), ftt.numpy(), mdt.numpy()
    np.testing.assert_allclose(cht[:3], chj[:3], atol=3e-4)
    np.testing.assert_allclose(cht[-1], chj[-1], atol=3e-4)
    np.testing.assert_allclose(cht[-2], chj[-2], atol=3e-3)
    np.testing.assert_allclose(cht[3:-2], chj[3:-2], atol=3e-3)
    np.testing.assert_allclose(ftt, ftj, atol=3e-4)
    np.testing.assert_allclose(mdt, mdj, atol=3e-3)
    assert (mdt < 14).any() and (ftt < 0.5).any()   # the scene reaches both


@pytest.mark.parametrize("sem", [0, 5])
def test_render_from_table_gradients_match(sem):
    s = scene(sem=sem)
    bj, bt = bin_both(s, **CFG)
    n_ch = 3 + sem + 2
    H, W = s["tc"].height, s["tc"].width
    rng = np.random.default_rng(3)
    gw = (rng.normal(size=(n_ch, H, W)) * 0.1).astype(np.float32)
    gw_ft = (rng.normal(size=(H, W)) * 0.1).astype(np.float32)
    gw_med = (rng.normal(size=(H, W)) * 0.01).astype(np.float32)

    def loss_j(tab):
        ch, ft, med = render_jax(s, bj, tab, CFG, 3 + sem)
        med_w = jnp.where(med < 14.0, gw_med, 0.0)
        return jnp.sum(ch * gw) + jnp.sum(ft * gw_ft) + jnp.sum(med * med_w)

    gj = np.asarray(jax.grad(loss_j)(jnp.asarray(s["table"])))
    tab = t(s["table"]).requires_grad_(True)
    ch, ft, med = render_torch(s, bt, tab, CFG, 3 + sem)
    med_w = torch.where(med < 14.0, t(gw_med), torch.zeros_like(med))
    ((ch * t(gw)).sum() + (ft * t(gw_ft)).sum() + (med * med_w).sum()).backward()
    gt = tab.grad.numpy()
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(gt, gj, rtol=0, atol=2e-3 * np.abs(gj).max())


def test_sentinel_and_pad_pairs_get_no_gradient():
    s = scene(sem=0)
    bt = bin_both(s, **CFG)[1]
    n, C = s["table"].shape
    H, W = s["tc"].height, s["tc"].width
    w2c = ttf.build_w2c(ttf.normalize(t(s["q"])), t(s["tr"]))
    table_s = torch.cat([t(s["table"]), trs.sentinel_row(C)], 0)
    stream = table_s[bt.lists.idx].requires_grad_(True)           # [R, 128, C]
    grid = TConfig().grid(H, W)
    acc, ft, med = trs.blend_stream(stream, trs.make_scalars(w2c, s["tc"]), bt.lists.row_off,
                                    grid, (16, 16), 3, (H, W))
    rng = np.random.default_rng(5)
    (acc * t(rng.normal(size=acc.shape))).sum().add(
        (ft * t(rng.normal(size=ft.shape))).sum()).add(
        (med * t(rng.normal(size=med.shape))).sum()).backward()
    pad = bt.lists.idx == n
    assert pad.any() and (~pad).any()
    assert (stream.grad[pad] == 0).all()
    assert stream.grad[~pad].abs().max() > 0
    # a pruned row (sentinel logit) takes no part and gets nothing back
    table = t(s["table"])
    table[:40, trs.COL_LOGIT] = trs.SENTINEL_LOGIT
    table.requires_grad_(True)
    ch, ft2, _ = trs.render_from_table(table, bt, w2c, s["tc"], TConfig(**CFG), 3)
    (ch.sum() + ft2.sum()).backward()
    assert (table.grad[:40] == 0).all() and table.grad[40:].abs().max() > 0


def test_adam_per_column_lr_matches():
    """The packed mapper's Adam: one [5+F] lr row over an [N, 5+F] table."""
    from hierslam_torch.slam import optim as topt
    from hierslam_tpu.slam import optim as jopt

    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(9, 8)).astype(np.float32)
    lr = np.array([1e-4, 1e-4, 1e-4, 1e-3, 0.05, 2.5e-3, 2.5e-3, 0.0], np.float32)
    pj, pt = {"table": jnp.asarray(p0)}, {"table": t(p0)}
    sj, st = jopt.adam_init(pj), topt.adam_init(pt)
    for _ in range(4):
        g = rng.normal(size=p0.shape).astype(np.float32)
        pj, sj = jopt.adam_step(pj, {"table": jnp.asarray(g)}, sj, {"table": jnp.asarray(lr)},
                                eps=1e-15)
        pt, st = topt.adam_step(pt, {"table": t(g)}, st, {"table": t(lr)}, eps=1e-15)
    np.testing.assert_allclose(pt["table"].numpy(), np.asarray(pj["table"]), rtol=1e-5,
                               atol=1e-6)
    assert (pt["table"][:, -1] == t(p0)[:, -1]).all()   # lr 0: the column stays


@pytest.mark.cuda
def test_stream_kernels_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from hierslam_torch.ops import kernels

    s = scene(sem=5, n=300)
    bt = bin_both(s, **CFG)[1]
    n, C = s["table"].shape
    H, W = s["tc"].height, s["tc"].width
    dev = torch.device("cuda")
    table_s = torch.cat([t(s["table"]), trs.sentinel_row(C)], 0).to(dev)
    stream = table_s[bt.lists.idx.to(dev)].contiguous()
    w2c = ttf.build_w2c(ttf.normalize(t(s["q"])), t(s["tr"])).to(dev)
    sc = trs.make_scalars(w2c, s["tc"])
    ro = bt.lists.row_off.to(dev)
    grid = TConfig().grid(H, W)
    acc, ft, med, last, mpos = kernels.stream_fwd(stream, sc, ro, grid[1], (16, 16), 8, (H, W))
    acc_p, ft_p, med_p = trs.blend_stream_fwd_plain(stream, sc, ro, grid, (16, 16), 8, (H, W))
    torch.testing.assert_close(acc, acc_p, atol=1e-3, rtol=0)
    torch.testing.assert_close(ft, ft_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(med, med_p, atol=1e-4, rtol=0)
    g = torch.randn_like(acc), torch.randn_like(ft), torch.randn_like(med)
    d = kernels.stream_bwd(stream, sc, ro, ft, last, mpos, *g, grid[1], (16, 16), 8, (H, W))
    dp = trs.blend_stream_bwd_plain(stream, sc, ro, *g, grid, (16, 16), 8, (H, W), mpos=mpos)
    assert ((d - dp).abs() / (1 + dp.abs())).max() <= 2e-3
    assert (d[bt.lists.idx.to(dev) == n] == 0).all()
