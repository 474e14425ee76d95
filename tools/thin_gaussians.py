"""Seeded ladder tables of thin, nearly degenerate 2-D gaussians (numpy only).

The blend forwards cull a slot from the warps that its footprint's box
cannot reach (``hierslam_torch/csrc/cull.cuh``).  The box comes from the
conic, which the blend evaluates in float32; where ``(ac - b^2) / ac`` is
near 0 both the conic's determinant and the blend's own quadratic form lose
digits to cancellation.  These tables drive that case:
``tests/test_torch_cull.py`` holds the plain cull on them and
``chip_smoke.py`` (``[kernels] cull thin``) K1 against its plain version.

    from thin_gaussians import thin_table, det_ratio
"""
from __future__ import annotations

import numpy as np

ANGLES_DEG = (0.0, 30.0, 45.0, 60.0)
LAM2 = (0.3, 2.3)        # the short axis' variance: the projection adds 0.3 to both
LOG10_RATIO = (1.0, 7.0)  # lambda1 / lambda2 from 10 to 1e7
NEAR_PX = 300.0          # a mean within this of its tile's point on each axis


def thin_table(seed: int, T: int, K: int, F: int, grid_x: int, tile_shape=(16, 16),
               tip_share: float = 0.5):
    """-> table [T, K, 7 + F] float32 (x, y, conic a, b, c, opacity, depth,
    F features in [0, 1]) and slot mask [T, K] bool (every slot live).

    Row b is tile b of a grid ``grid_x`` tiles wide.  Each slot is a
    gaussian with covariance eigenvalues lambda2 in ``LAM2`` and lambda1 =
    r lambda2, log10 r uniform in ``LOG10_RATIO``, its long axis at one of
    ``ANGLES_DEG``, opacity log-uniform in [1/255, 0.99], and aimed at a
    random point of its tile: with probability ``1 - tip_share`` its mean
    lies within ``NEAR_PX`` of that point on each axis; otherwise the point
    lies at a tip of the ellipse that the blend takes (alpha >= 1/255),
    the mean 0.95-1.03 of its half-length L = sqrt(2 ln(255 opacity)
    lambda1) away along the long axis and up to its half-width across it,
    where the edge of the cull's box crosses the tile.  The conic is the
    covariance inverted in float64, then rounded to float32.  Depths are
    sorted along each row."""
    rng = np.random.default_rng(seed)
    th, tw = tile_shape
    tid = np.arange(T)
    ox, oy = (tid % grid_x) * tw, (tid // grid_x) * th
    lam2 = rng.uniform(*LAM2, (T, K))
    lam1 = lam2 * 10.0 ** rng.uniform(*LOG10_RATIO, (T, K))
    ang = np.deg2rad(rng.choice(ANGLES_DEG, (T, K)))
    cs, sn = np.cos(ang), np.sin(ang)
    cxx = lam1 * cs ** 2 + lam2 * sn ** 2
    cyy = lam1 * sn ** 2 + lam2 * cs ** 2
    cxy = (lam1 - lam2) * cs * sn
    det = cxx * cyy - cxy ** 2
    a, b, c = cyy / det, -cxy / det, cxx / det
    opa = np.exp(rng.uniform(np.log(1.0 / 255.0), np.log(0.99), (T, K)))
    tau = np.log(np.maximum(255.0 * opa, 1.0))
    px = ox[:, None] + rng.uniform(0, tw, (T, K))
    py = oy[:, None] + rng.uniform(0, th, (T, K))
    along = np.sqrt(2 * tau * lam1) * rng.uniform(0.95, 1.03, (T, K)) * rng.choice([-1, 1], (T, K))
    across = np.sqrt(2 * tau * lam2) * rng.uniform(-1, 1, (T, K))
    tip = rng.uniform(size=(T, K)) < tip_share
    x = np.where(tip, px - along * cs + across * sn, px + rng.uniform(-NEAR_PX, NEAR_PX, (T, K)))
    y = np.where(tip, py - along * sn - across * cs, py + rng.uniform(-NEAR_PX, NEAR_PX, (T, K)))
    dep = np.sort(rng.uniform(0.5, 5.0, (T, K)), axis=1)
    feats = rng.uniform(0, 1, (T, K, F))
    table = np.concatenate([np.stack([x, y, a, b, c, opa, dep], -1), feats], -1)
    return table.astype(np.float32), np.ones((T, K), bool)


def det_ratio(table) -> np.ndarray:
    """(ac - b^2) / ac of each slot's float32 conic, in float64 (exact
    products)."""
    a, b, c = (np.asarray(table[..., i], np.float64) for i in (2, 3, 4))
    return (a * c - b * b) / (a * c)
