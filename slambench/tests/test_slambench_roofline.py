"""The frozen roofline arithmetic gives chip_smoke.py's numbers."""
import importlib.util
import os

import torch

from slambench import cells
from slambench.frozen import roofline


def _chip_smoke():
    path = os.path.join(cells.ROOT, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bound_equals_chip_smoke():
    cs = _chip_smoke()
    assert roofline.bound(3.35e9, 1.0) == cs.bound(3.35e9, 1.0)
    assert roofline.bound(1.0, 67e9) == cs.bound(1.0, 67e9)


def test_stream_pair_stats_equal_chip_smoke():
    from hierslam_torch.ops import render_stream as rs

    cs = _chip_smoke()
    g = torch.Generator().manual_seed(3)
    grid, img, F = (2, 3), (32, 48), 4
    T = grid[0] * grid[1]
    counts = torch.tensor([130, 0, 40, 260, 5, 128])
    rows = (counts + 127) // 128
    row_off = torch.cat([torch.zeros(1, dtype=torch.long), rows.cumsum(0)]).to(torch.int32)
    R = int(row_off[-1])
    stream = torch.zeros((R, 128, 5 + F))
    for tile in range(T):
        n = int(counts[tile])
        flat = stream[int(row_off[tile]):int(row_off[tile + 1])].reshape(-1, 5 + F)
        tx, ty = tile % grid[1], tile // grid[1]
        flat[:n, 0] = (tx * 16 + torch.rand(n, generator=g) * 16 - 24) / 40.0
        flat[:n, 1] = (ty * 16 + torch.rand(n, generator=g) * 16 - 16) / 40.0
        flat[:n, 2] = 1.0 + torch.rand(n, generator=g)
        flat[:n, 3] = torch.log(torch.rand(n, generator=g) * 0.02 + 0.01)
        flat[:n, 4] = torch.randn(n, generator=g)
        flat[:n, 5:] = torch.rand((n, F), generator=g)
        flat[n:, 4] = rs.SENTINEL_LOGIT
    w2c = torch.eye(4)
    from hierslam_torch.core.camera import setup_camera
    import numpy as np
    cam = setup_camera(img[1], img[0], np.array([[40.0, 0, 24], [0, 40.0, 16], [0, 0, 1]]),
                       np.eye(4))
    sc = rs.make_scalars(w2c, cam)
    mine = roofline.stream_pair_stats(stream, sc, row_off, grid, (16, 16), F, img)
    theirs = cs.stream_pair_stats(stream, sc, row_off, grid, F, img)
    assert mine == theirs[:6]
    assert mine[2] > 0
