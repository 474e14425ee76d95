"""The last public helpers of the JAX package in the port, against JAX on
the same numpy inputs: ``ops/binning.bin_gaussians`` (``TileLists``,
``EscalatedLists``), ``ops/render_xla.rect_recheck_mask``,
``core/transforms.relative_transformation`` and ``ops/ssim.calc_psnr``.

The lists are compared exactly.  Both sides order a tile's pairs by depth,
then gaussian id, and the K cap keeps the first K of that order; which
gaussians an emission budget drops depends on the order of equal
``tiles_touched`` (stable in the port, unstable in JAX: ROADMAP.md
section 3), so the budgets here drop nothing, and the drop count is held
on a case where the per-gaussian tile cap and the K cap drop pairs.  The
escalated tiles are the top counts with the lowest tile id first among
ties on both sides (``jax.lax.top_k``'s order).  Poses and PSNR: float32,
1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierslam_torch.core.transforms import relative_transformation as t_rel
from hierslam_torch.ops.binning import bin_gaussians as t_bin
from hierslam_torch.ops.render_xla import rect_recheck_mask as t_recheck
from hierslam_torch.ops.ssim import calc_psnr as t_psnr
from hierslam_tpu.core.transforms import relative_transformation as j_rel
from hierslam_tpu.ops.binning import bin_gaussians as j_bin
from hierslam_tpu.ops.render_xla import rect_recheck_mask as j_recheck
from hierslam_tpu.ops.ssim import calc_psnr as j_psnr

GRID = (6, 8)


def rects(seed, n=300, max_w=4):
    rng = np.random.default_rng(seed)
    lo = np.stack([rng.integers(0, GRID[1], n), rng.integers(0, GRID[0], n)], -1)
    hi = np.minimum(lo + rng.integers(1, max_w + 1, (n, 2)), [GRID[1], GRID[0]])
    valid = rng.uniform(size=n) < 0.9
    depth = rng.uniform(0.5, 5.0, n).astype(np.float32)
    depth[:20] = depth[20:40]                     # equal depths: the id breaks the tie
    return lo.astype(np.int32), hi.astype(np.int32), valid, depth


@pytest.mark.parametrize("case", ["exact", "capped", "escalated"])
def test_bin_gaussians_matches_jax(case):
    lo, hi, valid, depth = rects(0 if case == "exact" else 1)
    k, r_cap, esc = {"exact": (256, 32, {}), "capped": (16, 6, {}),
                     "escalated": (16, 32, dict(n_escalate=5, escalate_k=64))}[case]
    lj, ej = j_bin(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(valid), jnp.asarray(depth),
                   GRID, k, max_tiles_per_gaussian=r_cap, **esc)
    lt, et = t_bin(*(torch.as_tensor(a) for a in (lo, hi, valid, depth)), GRID, k,
                   max_tiles_per_gaussian=r_cap, **esc)
    np.testing.assert_array_equal(lt.idx.numpy(), np.asarray(lj.idx))
    np.testing.assert_array_equal(lt.count.numpy(), np.asarray(lj.count))
    assert int(lt.n_dropped) == int(lj.n_dropped)
    assert (int(lt.n_dropped) == 0) == (case == "exact")
    if case == "escalated":
        for name in ("tile_ids", "idx", "count"):
            np.testing.assert_array_equal(getattr(et, name).numpy(), np.asarray(getattr(ej, name)),
                                          err_msg=name)
        assert int(et.count.max()) > k
    else:
        assert et is None and ej is None


def test_rect_recheck_mask_matches_jax():
    lo, hi, valid, depth = rects(2)
    lists, _ = j_bin(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(valid), jnp.asarray(depth),
                     GRID, 64)
    idx = np.asarray(lists.idx)
    lo2, hi2 = lo + 1, hi                         # the rects a later pose gives
    valid2 = valid & (np.arange(lo.shape[0]) % 5 != 0)
    mj = j_recheck(jnp.asarray(idx), jnp.asarray(lo2), jnp.asarray(hi2), jnp.asarray(valid2),
                   GRID)
    mt = t_recheck(torch.as_tensor(idx.astype(np.int64)), torch.as_tensor(lo2),
                   torch.as_tensor(hi2), torch.as_tensor(valid2), GRID)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert 0 < int(mt.sum()) < int((idx >= 0).sum())


def test_relative_transformation_and_psnr_match_jax():
    rng = np.random.default_rng(3)

    def pose():
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = q * np.sign(np.linalg.det(q)), rng.normal(size=3)
        return T

    a, b = pose(), pose()
    np.testing.assert_allclose(t_rel(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                               np.asarray(j_rel(jnp.asarray(a), jnp.asarray(b))), atol=1e-5)
    x = rng.uniform(size=(3, 24, 32)).astype(np.float32)
    y = np.clip(x + 0.05 * rng.normal(size=x.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(t_psnr(torch.as_tensor(x), torch.as_tensor(y))),
                               float(j_psnr(jnp.asarray(x), jnp.asarray(y))), rtol=1e-5)
