"""The gather's inverse map and its segmented-sum backward against the JAX
package on the CPU (``ops/gather_vjp.py``; kernel K5 on the card).

Inputs are made from numpy seeds.  Tolerances:

* the inverse map: ``ends`` equal to the bit; within each run the same
  positions (``jax.lax.sort`` is not asked to be stable, the port's sort
  is, so the port's runs are also in ascending position order);
* the gather backward against JAX's ``custom_vjp``: float32 within 1e-6 x
  (1 + the row's sum of absolute terms), because JAX sums in the order of
  its doubling passes; with ``grad_bf16`` within ``BF16_TOL`` x (1 + that
  sum): JAX also adds in bfloat16 (the "~0.4%" of its docstring), and each
  of its log2(16) = 4 doubling passes rounds a partial sum to half an ulp,
  2^-9 of at most that sum (the first rounding, of each term, is the same
  on both sides);
* the same bounds on the harder layouts of :data:`HARD` (one run of
  100,000 references, 90% empty rows, a budget inside a run, nd = 1, odd
  nd = C, nd = C = 135), in float32 only for the long run: JAX's map packs
  its doubling passes' run masks in int8 (runs up to 256 references), so
  that run goes through JAX's ``_gather_bwd`` with the same bit-planes in
  int32 (16 or 17 passes), where ``BF16_TOL`` would no longer be the
  file's;
* against the earlier one-``index_add_`` backward (kept here as
  :func:`index_add_backward`) and between K5 and its plain version: equal
  to the bit, since both add each run in ascending position order;
* ``compact_rows``'s backward: equal to the bit (a gather on both sides);
  ``cross_entropy_mean``: 1e-6 relative.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import make_scene
from hierslam_torch.core import camera as tcam
from hierslam_torch.ops import gather_vjp as tg
from hierslam_torch.ops import rasterize as trast
from hierslam_torch.slam import losses as tloss
from hierslam_tpu.core import camera as jcam
from hierslam_tpu.ops import gather_vjp as jg
from hierslam_tpu.slam import losses as jloss
from test_torch_stream import bin_both
from test_torch_stream import scene as stream_scene

jrast = sys.modules["hierslam_tpu.ops.rasterize"]

torch.set_num_threads(1)
MAX_RUN = 16       # JAX's doubling passes cover runs up to this many references
BF16_TOL = np.log2(MAX_RUN) * 2.0**-9


def layout(kind: str, seed: int, n: int = 80, shape=(24, 32)):
    """Per-tile row lists over ``n`` rows: at most 8 references a row (under
    JAX's ``MAX_RUN``) at random positions, the rest pads: -1 on the ladder,
    the sentinel row ``n`` on the stream.  -> (idx, rows of the gathered
    table, rows with a run)."""
    rng = np.random.default_rng(seed)
    ids = np.repeat(np.arange(n), rng.integers(0, 9, size=n))
    flat = np.full(int(np.prod(shape)), -1 if kind == "ladder" else n, np.int64)
    flat[:ids.shape[0]] = ids
    rng.shuffle(flat)
    return flat.reshape(shape), n + (kind == "stream"), n


def port_map(idx, rows, real):
    return tg.build_inverse_map(torch.as_tensor(idx), rows, num_real=real)


def same_runs(inv_a, inv_b, n):
    """Equal ``ends`` over rows 0..n-1 and the same positions in each run."""
    ea, eb = np.asarray(inv_a.ends)[:n], np.asarray(inv_b.ends)[:n]
    np.testing.assert_array_equal(ea, eb)
    sa, sb = np.asarray(inv_a.spos), np.asarray(inv_b.spos)
    for g in range(n):
        s = ea[g - 1] if g else 0
        assert sorted(sa[s:ea[g]].tolist()) == sorted(sb[s:eb[g]].tolist())


def routed_abs(idx, cot, real, nd, budget):
    """[real, C] sums of |cot| over each row's references that the backward
    routes (the first ``budget`` in row order, pads last)."""
    flat = idx.reshape(-1)
    c = cot.shape[-1]
    cot = np.abs(cot.reshape(-1, c))
    key = np.where((flat >= 0) & (flat < real), flat, real)
    order = np.argsort(key, kind="stable")
    if budget:
        order = order[:budget]
    order = order[key[order] < real]
    s = np.zeros((real, c), np.float64)
    np.add.at(s, flat[order], cot[order])
    s[:, nd:] = 0
    return s


def index_add_backward(flat, g, n, c, n_diff, pair_budget, grad_bf16):
    """The gather backward before the inverse map (one ``index_add_`` over
    every position, a stable sort of every reference under a budget)."""
    nd = c if n_diff == 0 else min(n_diff, c)
    g = g.reshape(-1, c)[:, :nd]
    if grad_bf16:
        g = g.to(torch.bfloat16).float()
    valid = flat >= 0
    if pair_budget and pair_budget < flat.shape[0]:
        key = torch.where(valid, flat, torch.full_like(flat, n))
        pos = torch.sort(key, stable=True).indices[:pair_budget]
        flat, valid, g = flat[pos], valid[pos], g[pos]
    grad = torch.zeros((n, c), dtype=g.dtype, device=g.device)
    grad[:, :nd].index_add_(0, flat.clamp_min(0), g * valid[:, None])
    return grad


def port_backward(arr, idx, cot, n_diff, budget, bf16, inverse):
    a = torch.as_tensor(arr).requires_grad_(True)
    out = tg.gather_rows(a, torch.as_tensor(idx), n_diff, budget, bf16, inverse)
    out.backward(torch.as_tensor(cot))
    return a.grad


def budgets(idx, real):
    n_ref = int(((idx >= 0) & (idx < real)).sum())
    return {"none": 0, "below": n_ref // 2, "above": n_ref + 7}


@pytest.mark.parametrize("kind", ["ladder", "stream"])
@pytest.mark.parametrize("seed", [0, 1])
def test_inverse_map_matches_jax(kind, seed):
    idx, rows, real = layout(kind, seed)
    jinv = jg.build_inverse_map(jnp.asarray(idx, jnp.int32), rows, MAX_RUN)
    tinv = port_map(idx, rows, real)
    assert tinv.spos.dtype == tinv.ends.dtype == torch.int32
    assert tinv.ends.shape == (rows,)
    same_runs(tinv, jinv, real)
    flat, spos, ends = idx.reshape(-1), tinv.spos.numpy(), tinv.ends.numpy()
    for g in range(real):   # the port's runs: stably sorted, each row's own
        run = spos[(ends[g - 1] if g else 0):ends[g]]
        assert (flat[run] == g).all() and (np.diff(run) > 0).all()
    # the stream's sentinel references sort with the pads and get no run
    assert (ends[real:] == ends[real - 1]).all()
    assert (np.isin(flat[spos[ends[-1]:]], [-1, real])).all()


@pytest.mark.parametrize("kind", ["ladder", "stream"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("budget", ["none", "below", "above"])
@pytest.mark.parametrize("n_diff", [0, 4])
def test_gather_backward_matches_jax(kind, bf16, budget, n_diff):
    idx, rows, real = layout(kind, 3)
    pb = budgets(idx, real)[budget]
    rng = np.random.default_rng(4)
    c = 6
    arr = rng.normal(size=(rows, c)).astype(np.float32)
    cot = rng.normal(size=idx.shape + (c,)).astype(np.float32)
    jinv = jg.build_inverse_map(jnp.asarray(idx, jnp.int32), rows, MAX_RUN)
    _, vjp = jax.vjp(lambda a: jg.gather_rows(a, jnp.asarray(idx, jnp.int32), jinv.spos,
                                              jinv.ends, jinv.run_masks, MAX_RUN, n_diff, pb,
                                              bf16), jnp.asarray(arr))
    gj = np.asarray(vjp(jnp.asarray(cot))[0])[:real]
    gt = port_backward(arr, idx, cot, n_diff, pb, bf16, port_map(idx, rows, real)).numpy()
    nd = c if n_diff == 0 else n_diff
    routed = routed_abs(idx, cot, real, nd, pb)
    err = np.abs(gt[:real] - gj) / (1.0 + routed)
    assert err.max() <= (BF16_TOL if bf16 else 1e-6), err.max()
    assert (gt[:, nd:] == 0).all()
    assert (gt[real:] == 0).all()       # the sentinel row routes nothing
    assert (gt[:real][routed == 0] == 0).all()
    if budget == "below":   # rows with references past the budget get nothing
        assert ((routed_abs(idx, cot, real, nd, 0) > 0) & (routed == 0)).any()


@pytest.mark.parametrize("kind", ["ladder", "stream"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("budget", ["none", "below", "above"])
@pytest.mark.parametrize("n_diff", [0, 4])
def test_gather_backward_equals_index_add(kind, bf16, budget, n_diff):
    idx, rows, real = layout(kind, 5, n=300, shape=(40, 64))
    pb = budgets(idx, real)[budget]
    rng = np.random.default_rng(6)
    c = 6
    arr = rng.normal(size=(rows, c)).astype(np.float32)
    cot = rng.normal(size=idx.shape + (c,)).astype(np.float32)
    gt = port_backward(arr, idx, cot, n_diff, pb, bf16, port_map(idx, rows, real))
    flat = torch.as_tensor(idx).reshape(-1)
    # the stream's sentinel is a row of the earlier backward: its references
    # summed into it, and they sorted after every real one under a budget
    gp = index_add_backward(flat, torch.as_tensor(cot), rows, c, n_diff, pb, bf16)
    assert torch.equal(gt[:real], gp[:real])
    assert (gt[real:] == 0).all()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_gather_backward_equals_index_add_at_scale(bf16):
    """400,000 x 34 random references into 50,000 rows, the budget cutting
    the last run short."""
    rng = np.random.default_rng(7)
    n, c = 50_000, 34
    idx = rng.integers(-1, n, size=(3125, 128))
    n_ref = int((idx >= 0).sum())
    cot = torch.as_tensor(rng.normal(size=idx.shape + (c,)).astype(np.float32))
    arr = rng.normal(size=(n, c)).astype(np.float32)
    for pb in (0, n_ref - 1001):
        gt = port_backward(arr, idx, cot, 0, pb, bf16, port_map(idx, n, n))
        gp = index_add_backward(torch.as_tensor(idx).reshape(-1), cot, n, c, 0, pb, bf16)
        assert torch.equal(gt, gp)


# harder layouts: rows, references a row in 0..8 (a share ``empty`` none;
# with ``long``, row n // 3 that many), columns, summed columns (0: all), a
# pair budget that ends ``cut`` references inside the long run, bf16 cases
HARD = {
    "long_run": dict(n=64, long=100_000, c=3, n_diff=0),
    "long_run_cut": dict(n=64, long=100_000, c=3, n_diff=0, cut=50_000),
    "empty90": dict(n=3000, empty=0.9, c=6, n_diff=0),
    "nd1": dict(n=800, c=6, n_diff=1),
    "odd_nd_eq_c": dict(n=800, c=7, n_diff=7),
    "nd135": dict(n=300, c=135, n_diff=135),
}
HARD_CASES = [(k, bf16) for k, v in HARD.items() for bf16 in (False, True)
              if not (bf16 and v.get("long"))]


def hard_layout(n, c, n_diff, empty=0.0, long=0, cut=0, seed=0):
    """-> (idx [L / 128, 128] with -1 pads, cotangent rows [L, c], the pair
    budget: ``cut`` references into the long run, else 0)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, n)
    counts[rng.uniform(size=n) < empty] = 0
    if long:
        counts[n // 3] = long
    refs = int(counts.sum())
    flat = np.full(-(-(refs + refs // 10 + 7) // 128) * 128, -1, np.int64)
    flat[:refs] = np.repeat(np.arange(n), counts)
    rng.shuffle(flat)
    cot = rng.normal(size=(flat.size, c)).astype(np.float32)
    budget = int(counts[:n // 3].sum()) + cut if cut else 0
    return flat.reshape(-1, 128), cot, budget


def jax_backward_wide(idx, n, cot, n_diff, budget, max_run):
    """JAX's ``_gather_bwd`` on the map of ``jg.build_inverse_map`` with its
    run masks rebuilt in int32 (``build_inverse_map`` packs them in int8:
    8 passes)."""
    jinv = jg.build_inverse_map(jnp.asarray(idx, jnp.int32), n)
    flat = idx.reshape(-1)
    skey = np.where(flat < 0, n, flat)[np.asarray(jinv.spos)]
    masks = np.zeros(skey.shape, np.int32)
    s, p = 1, 0
    while s < max_run:
        masks[:-s] |= (skey[:-s] == skey[s:]).astype(np.int32) << p
        s, p = s * 2, p + 1
    g = jnp.asarray(cot.reshape(idx.shape + (cot.shape[1],)))
    res = (jinv.spos, jinv.ends, jnp.asarray(masks))
    return np.asarray(jg._gather_bwd(max_run, n_diff, budget, False, res, g)[0])


@pytest.mark.parametrize("case,bf16", HARD_CASES, ids=[f"{k}-{'bf16' if b else 'f32'}"
                                                        for k, b in HARD_CASES])
def test_gather_backward_matches_jax_on_hard_layouts(case, bf16):
    spec = HARD[case]
    n, c, n_diff = spec["n"], spec["c"], spec["n_diff"]
    idx, cot, pb = hard_layout(seed=13, **spec)
    arr = np.random.default_rng(14).normal(size=(n, c)).astype(np.float32)
    if spec.get("long"):   # passes enough for the longest run the budget keeps
        longest = spec.get("cut") or spec["long"]
        gj = jax_backward_wide(idx, n, cot, n_diff, pb, 1 << int(np.ceil(np.log2(longest + 1))))
    else:
        jinv = jg.build_inverse_map(jnp.asarray(idx, jnp.int32), n, MAX_RUN)
        _, vjp = jax.vjp(lambda a: jg.gather_rows(a, jnp.asarray(idx, jnp.int32), jinv.spos,
                                                  jinv.ends, jinv.run_masks, MAX_RUN, n_diff,
                                                  pb, bf16), jnp.asarray(arr))
        gj = np.asarray(vjp(jnp.asarray(cot.reshape(idx.shape + (c,))))[0])
    inv = port_map(idx, n, n)
    gt = port_backward(arr, idx, cot.reshape(idx.shape + (c,)), n_diff, pb, bf16, inv).numpy()
    nd = c if n_diff == 0 else n_diff
    routed = routed_abs(idx, cot, n, nd, pb)
    err = np.abs(gt - gj) / (1.0 + routed)
    assert err.max() <= (BF16_TOL if bf16 else 1e-6), err.max()
    assert (gt[:, nd:] == 0).all()
    assert (gt[routed == 0] == 0).all()
    ends = inv.ends.numpy()
    runs = np.diff(ends, prepend=0)
    if spec.get("long"):
        assert runs.max() >= 100_000
    if spec.get("cut"):   # the long row keeps only the references before the budget
        row = n // 3
        kept = min(pb, ends[row]) - ends[row - 1]
        assert 0 < kept < runs[row]
        assert (gt[row + 1:] == 0).all()
    if spec.get("empty"):
        assert (runs == 0).mean() > 0.85


def test_gather_rows_makes_its_own_map():
    idx, rows, real = layout("ladder", 8)
    rng = np.random.default_rng(8)
    arr = rng.normal(size=(rows, 5)).astype(np.float32)
    cot = rng.normal(size=idx.shape + (5,)).astype(np.float32)
    a = torch.as_tensor(arr).requires_grad_(True)
    out = tg.gather_rows(a, torch.as_tensor(idx), 3)
    np.testing.assert_array_equal(out.detach().numpy(), arr[np.maximum(idx, 0)])
    out.backward(torch.as_tensor(cot))
    assert torch.equal(a.grad, port_backward(arr, idx, cot, 3, 0, False,
                                             port_map(idx, rows, real)))
    with pytest.raises(ValueError, match="inverse map"):
        tg.gather_rows(a, torch.as_tensor(idx), 3, inverse=port_map(idx, rows + 1, real))


@pytest.mark.parametrize("width", [1, 7])
def test_compact_rows_backward_equals_jax(width):
    rng = np.random.default_rng(9)
    n, v = 50, 30
    order = rng.permutation(n)
    vis, rank_of = order[:v], np.empty(n, np.int64)
    rank_of[order] = np.arange(n)
    arr = rng.normal(size=(n, width)).astype(np.float32)
    cot = rng.normal(size=(v, width)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a: jg.compact_rows(a, jnp.asarray(vis, jnp.int32),
                                                   jnp.asarray(rank_of, jnp.int32)),
                         jnp.asarray(arr))
    a = torch.as_tensor(arr).requires_grad_(True)
    out = tg.compact_rows(a, torch.as_tensor(vis), torch.as_tensor(rank_of))
    out.backward(torch.as_tensor(cot))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(a.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]))


def test_cross_entropy_mean_matches_jax():
    rng = np.random.default_rng(10)
    logits = (3 * rng.normal(size=(500, 13))).astype(np.float32)
    labels = rng.integers(0, 13, size=500)
    vj, gj = jax.value_and_grad(jloss.cross_entropy_mean)(jnp.asarray(logits),
                                                          jnp.asarray(labels))
    lt = torch.as_tensor(logits).requires_grad_(True)
    vt = tloss.cross_entropy_mean(lt, torch.as_tensor(labels))
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gj), rtol=1e-6, atol=1e-8)
    # the channel-major form is the same function
    vc = tloss.cross_entropy_mean_cmajor(torch.as_tensor(logits).T.reshape(13, 20, 25),
                                         torch.as_tensor(labels).reshape(20, 25))
    np.testing.assert_allclose(float(vc), float(vj), rtol=1e-6)


def test_stream_binning_map_matches_jax():
    """The map ``compute_stream_binning`` builds on a real scene: JAX's runs
    over the gaussians, the sentinel row left out."""
    s = stream_scene(sem=2)
    bj, bt = bin_both(s, stream_cap=256)
    n = s["table"].shape[0]
    assert bt.inverse.ends.shape == (n + 1,)
    same_runs(bt.inverse, bj.inverse, n)
    assert int(bt.inverse.ends[n]) == int(bt.inverse.ends[n - 1]) == int(bt.lists.n_refs)


@pytest.mark.parametrize("vis", [0, 400])
def test_ladder_binning_map_matches_jax(vis):
    """The map ``compute_binning`` builds (over all classes' lists, in
    visible-rank space under a visible budget), against JAX's."""
    scene, cam = make_scene(n=300, seed=5, W=64, H=48)
    K = jcam.intrinsics_matrix(cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    jc = jcam.setup_camera(cam["W"], cam["H"], K, cam["w2c"])
    tc = tcam.setup_camera(cam["W"], cam["H"], K, cam["w2c"])
    kw = dict(bucket_spec=((4, 1024), (-1, 512)), visible_budget=vis)
    m, sc, rot = (np.asarray(scene[k], np.float32) for k in ("means3D", "scales", "rotations"))
    sc = sc[:, :1] * 2.0
    bj = jrast.compute_binning(jnp.asarray(m), jnp.asarray(sc), jnp.asarray(rot), jc,
                               jrast.RasterConfig(**kw), compact=bool(vis))
    bt = trast.compute_binning(torch.as_tensor(m), torch.as_tensor(sc), torch.as_tensor(rot),
                               tc, trast.RasterConfig(**kw), compact=bool(vis))
    n = 300
    assert bt.inverse.ends.shape == (n,)
    flat = trast._combined_idx(bt.lists).reshape(-1).numpy()
    spos, ends = bt.inverse.spos.numpy(), bt.inverse.ends.numpy()
    if vis:   # visible ranks: the same gaussians' run lengths
        rank_j = np.empty(n, np.int64)
        rank_j[np.asarray(bj.lists.vis_ids)] = np.arange(n)
        gid_t = bt.lists.vis_ids.numpy()
        nj = np.diff(np.asarray(bj.inverse.ends), prepend=0)
        np.testing.assert_array_equal(np.diff(ends, prepend=0), nj[rank_j[gid_t]])
    else:
        np.testing.assert_array_equal(ends, np.asarray(bj.inverse.ends))
    for g in range(n):
        run = spos[(ends[g - 1] if g else 0):ends[g]]
        assert (flat[run] == g).all() and (np.diff(run) > 0).all()
    assert int(ends[-1]) == int(bt.lists.n_refs) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_gather_kernel_on_card(bf16):
    """K5 twice on one input: both equal to the bit to the plain version on
    a CPU copy, with and without a budget that cuts a run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from hierslam_torch.ops import kernels

    idx, rows, real = layout("stream", 11, n=20_000, shape=(1000, 128))
    inv = port_map(idx, rows, real)
    cot = torch.as_tensor(np.random.default_rng(12).normal(size=(idx.size, 34))
                          .astype(np.float32))
    for m in (inv.spos.shape[0], int(inv.ends[real // 2]) - 3):
        want = tg.gather_bwd_plain(cot, inv.spos[:m], inv.ends, 29, bf16)
        args = (cot.cuda(), inv.spos[:m].cuda(), inv.ends.cuda(), 29, bf16)
        first = kernels.gather_bwd(*args).cpu()
        second = kernels.gather_bwd(*args).cpu()
        assert torch.equal(first, want) and torch.equal(second, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(HARD))
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_gather_kernel_on_card_hard_layouts(case, bf16):
    """K5 on the harder layouts (a run longer than its staging, most rows
    empty, a budget inside a run, nd = 1, odd nd = C, nd = C = 135): two
    launches, each equal to the bit to the plain version on a CPU copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from hierslam_torch.ops import kernels

    spec = HARD[case]
    idx, cot, pb = hard_layout(seed=15, **spec)
    n, c = spec["n"], spec["c"]
    nd = c if spec["n_diff"] == 0 else spec["n_diff"]
    inv = port_map(idx, n, n)
    m = pb or inv.spos.shape[0]
    cot = torch.as_tensor(cot)
    want = tg.gather_bwd_plain(cot, inv.spos[:m], inv.ends, nd, bf16)
    args = (cot.cuda(), inv.spos[:m].cuda(), inv.ends.cuda(), nd, bf16)
    assert torch.equal(kernels.gather_bwd(*args).cpu(), want)
    assert torch.equal(kernels.gather_bwd(*args).cpu(), want)
