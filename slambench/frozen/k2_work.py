"""The work K2 (the ladder blend's backward) needs for the tracker's pose
caches, from their shapes alone, whatever kernel does it.

One K2 launch a capacity class an iteration reads each pixel's cotangents
(F + 2 accumulators, final transmittance, median depth) and the forward's
residuals (final transmittance, last and median slot), reads the row of
every pair in the class's lists (7 + F float32 columns and a mask byte),
and writes the whole cotangent table of the class, n_b k_b rows.  Summed
over a cache's classes: ``slots`` = the sum of n_b k_b, ``pairs`` the
pairs in the lists, ``tiles`` the sum of n_b.  The float32 operations
depend on where each pixel's transmittance ends, which the shapes do not
tell, so none are counted: the bound is the bytes'.  Tracking renders F =
3 colours on 16 x 16 tiles.
"""
from __future__ import annotations

from typing import Tuple

N_FEAT = 3          # tracking's features: the colours
TILE_PIXELS = 256   # 16 x 16


def k2_work(slots: int, pairs: int, tiles: int, n_feat: int = N_FEAT,
            tile_pixels: int = TILE_PIXELS) -> Tuple[float, float]:
    """(bytes, float32 operations) of one K2 pass over a cache's classes."""
    c = 7 + n_feat
    nbytes = (slots * c * 4                                   # the cotangent table written
              + pairs * (c * 4 + 1)                           # each pair's row and mask read
              + tiles * tile_pixels * ((n_feat + 2) + 5) * 4)  # each pixel's reads
    return float(nbytes), 0.0
