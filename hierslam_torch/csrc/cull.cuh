// Pixel layout of a tile's warps and the per-warp footprint cull of the
// blend forwards (K1 in blend.cu, K3 in stream.cu).
//
// A pixel takes a pair only if power <= 0 and opacity * exp(power) >= 1/255
// (the 0.99 clamp never decides that).  With power = -q / 2, q the
// quadratic form a dx^2 + 2 b dx dy + c dy^2, that needs q <= 2 tau,
// tau = ln(255 opacity); an opacity under 1/255 reaches no pixel.  The set
// q <= 2 tau is an ellipse whose axis-aligned box has the half-widths
// sqrt(2 tau cxx) and sqrt(2 tau cyy), cxx = c / (ac - b^2) and cyy = a /
// (ac - b^2) the diagonal of the 2-D covariance.  A warp is live for the
// pair when that box, widened, meets the rectangle of the warp's pixels.
// The widening keeps the test conservative against float rounding of tau
// and of the box: 1e-3 on tau, then 1% and half a pixel on each
// half-width.  The mask may keep a pair no pixel takes; it never drops one
// a pixel takes.  A NaN or an infinity anywhere gives "live for every warp".
//
// K1 reads a conic, not a covariance, and takes the box's diagonal from it
// (conic_box_diag).  The blend rounds q in float32 (fwd.cuh blend_power, dx
// and dy included): its error is at most 5u (a dx^2 + c dy^2 + 2|b dx dy|)
// <= 5u m |v|^2, u = 2^-24, m = max(a, c) + |b|.  Far from the mean of a
// thin gaussian that is more than the 1% widening covers: a tile at the tip
// of an ellipse with (ac - b^2)/ac below ~1e-5 lost pixels that took the
// pair.  So the box is that of the conic less eta = 8u m on its diagonal,
// which holds every v the rounded q can take, with its determinant in
// Kahan's form (one rounding where a c - b b cancels); a conic for which
// that is not positive definite, (ac - b^2)/ac below ~2e-6 at 45 degrees,
// is live for every warp.  K3 reads the covariance before its inversion, of
// rows that are isotropic in 3-D, and needs neither.
// ops/render_xla.py holds the plain version (warp_rects, cull_mask).
//
// Layout: a tile is a multiple of 8 x 4 pixels (the wrappers raise on any
// other).  Warp w is the 8 x 4 block at x = 8 (w % (tw / 8)), y = 4 (w /
// (tw / 8)) and lane l its pixel (l % 8, l / 8): a footprint of 7-9 pixels
// meets about three of a 16 x 16 tile's eight blocks where it met four or
// five 16 x 2 strips.  Outputs stay [tile, p] with p = y tw + x.

#pragma once

#include <cuda_runtime.h>

namespace hsl {

constexpr float ALPHA_MIN = 1.0f / 255.0f;  // the blend skips a smaller alpha
constexpr float CULL_TAU = 1e-3f;   // added to tau
constexpr float CULL_REL = 1.01f;   // factor on each half-width
constexpr float CULL_PX = 0.5f;     // added to each half-width, pixels
constexpr float CULL_WILD = 1e9f;   // a box edge beyond this (or NaN) is live everywhere
constexpr float CULL_Q_ROUND = 8.f * 5.9604645e-8f;  // 8u: q's rounding, on the conic's diagonal

// Whether a th x tw tile divides into 8 x 4 blocks.
__host__ __device__ __forceinline__ bool block_layout(int tw, int th) {
  return tw % 8 == 0 && th % 4 == 0;
}

// Pixel (x, y) inside the tile of thread p.
__device__ __forceinline__ void thread_pixel(int p, int tw, int& x, int& y) {
  const int w = p >> 5, l = p & 31, bw = tw >> 3;
  x = 8 * (w % bw) + (l & 7);
  y = 4 * (w / bw) + (l >> 3);
}

// Diagonal (cxx, cyy) of the covariance whose box holds every pixel the
// blend's float32 q of conic (a, b, c) can take (see the top of the file);
// infinite where there is no such box.
__device__ __forceinline__ void conic_box_diag(float a, float b, float c, float& cxx,
                                               float& cyy) {
  const float eta = CULL_Q_ROUND * (fmaxf(a, c) + fabsf(b));  // a NaN stays a NaN
  const float a2 = a - eta, c2 = c - eta;
  const float w = b * b;
  const float det = fmaf(a2, c2, -w) + fmaf(-b, b, w);  // Kahan: w's rounding put back
  const bool pd = det > 0.f && a2 > 0.f;
  const float inf = __int_as_float(0x7f800000);
  cxx = pd ? c2 / det : inf;
  cyy = pd ? a2 / det : inf;
}

// Warps of a tile (bits of an unsigned, 32 pixels each) that the footprint
// of a pair can reach: screen mean (x, y), covariance diagonal (cxx, cyy),
// opacity; (tile_x0, tile_y0) the tile's first pixel.
__device__ __forceinline__ unsigned warp_mask(float x, float y, float cxx, float cyy, float opa,
                                              float tile_x0, float tile_y0, int tw, int th) {
  if (opa < ALPHA_MIN) return 0u;  // alpha <= opacity wherever power <= 0
  const int nw = (tw * th) >> 5;
  const unsigned all = nw >= 32 ? 0xffffffffu : (1u << nw) - 1u;
  float tau = logf(255.0f * opa);       // a NaN stays a NaN
  tau = (tau < 0.f ? 0.f : tau) + CULL_TAU;
  const float hx = sqrtf(2.f * tau * cxx) * CULL_REL + CULL_PX;
  const float hy = sqrtf(2.f * tau * cyy) * CULL_REL + CULL_PX;
  const float lx = x - hx - tile_x0, ux = x + hx - tile_x0;
  const float ly = y - hy - tile_y0, uy = y + hy - tile_y0;
  if (!(fabsf(lx) < CULL_WILD && fabsf(ux) < CULL_WILD && fabsf(ly) < CULL_WILD &&
        fabsf(uy) < CULL_WILD))
    return all;
  // block column c spans x in [8c, 8c + 7], block row r spans y in [4r, 4r + 3]
  const int bw = tw >> 3, bh = th >> 2;
  const int c_lo = max(0, (int)ceilf((lx - 7.f) * 0.125f));
  const int c_hi = min(bw - 1, (int)floorf(ux * 0.125f));
  const int r_lo = max(0, (int)ceilf((ly - 3.f) * 0.25f));
  const int r_hi = min(bh - 1, (int)floorf(uy * 0.25f));
  if (c_lo > c_hi) return 0u;
  const unsigned cols = ((2u << c_hi) - 1u) & ~((1u << c_lo) - 1u);
  unsigned m = 0u;
  for (int r = r_lo; r <= r_hi; ++r) m |= cols << (r * bw);
  return m;
}

}  // namespace hsl
