// The binning's pair emission (bin_emit) for Hopper (sm_90a).
//
// Replaces no TPU kernel: hierslam_tpu/ops/binning.py::_emit_sort_sat emits
// its pairs with XLA ops over a static [r_cap, N] grid of cells.  The port's
// plain version (ops/binning.py::emit_pairs_plain) walks the r_cap cell
// rows with one boolean-mask compaction each: ~120 small elementwise ops and
// 11 masked indexings a row, each indexing a host sync (aten::nonzero), so
// a binning of 16 rows cost ~2,900 launches and ~180 syncs.  This kernel
// writes the same concatenation in one launch and no sync; its caller reads
// the total once to size the outputs.  Plain C interface, loaded with ctypes
// by hierslam_torch/ops/kernels.py; the wrapper there allocates the outputs,
// passes PyTorch's current stream and checks the launch error this returns.
//
// Layout.  order [k] int64 holds the gaussians in touched-descending order
// (tiles touched, clamped to r_cap).  The gaussians that reach cell row r
// are a prefix of that order, cut to the row's budget, so row r's part of
// the concatenation is ranks 0 .. len_r - 1 at offs[r] .. offs[r + 1]
// (len_r = offs[r + 1] - offs[r], ops/binning.py::emission_offsets).  Rank
// i's pair in row r, at j = offs[r] + i, for gaussian g = order[i]:
//   tile[j]  = (rect_min_y + r / wr) grid_x + rect_min_x + r % wr,
//              wr = max(w_rect, 1), all of g
//   depth[j] = depth[g]
//   gauss[j] = g, or i with vis (ids are ranks of the visible prefix)
//   quads[j] (sat only): for quadrant q of the tile's 3 x 3 corner grid
//              (x0, x0 + hw, x0 + tw - 1) x (y0, y0 + hh, y0 + th - 1),
//              x0 = cell_x tw, y0 = cell_y th, the least Gaussian exponent
//              p = -0.5 (a dx dx + c dy dy) - b dx dy over its four
//              corners, alpha = min(opacity exp(p), 0.99), 0 below 1/255,
//              quantised floor(alpha / 0.99 * 255) as int16.
//
// Rounding.  The quads are discrete, so they have to round exactly as the
// plain version's separate PyTorch ops do on the same CUDA tensors: built
// with -fmad=false (ops/kernels.py), each product and sum in the plain
// version's order; torch.minimum's and clamp_max's NaN rules (a NaN corner
// makes the quad 0, as the plain version's comparison does); expf, as ATen's
// exp; and ATen's division of a CUDA tensor by a host scalar, which is a
// product by the float reciprocal (div_true_kernel_cuda), so x / 0.99 is
// x * (1.0f / 0.99f).  The float constants are the plain version's Python
// floats cast to float32, as ATen casts a scalar.
//
// Bound on this card: bytes.  Per rank that emits (those below the longest
// part) its order entry and its gathered rect, width and depth (36 bytes),
// with sat also its screen terms (24), are read once; per pair 20 bytes are
// written, with sat 28: at the flagship's mapping binnings (~300k live
// gaussians, 0.75-1.35M pairs) 40-56 MB, 12-17 us at 3.35 TB/s, against
// ~120 float operations a pair with sat (1.4-2.4 us at 67 TFLOP/s).
//
// Design.  One thread a rank, looping over the cell rows: the gaussian's
// rect, depth and screen terms are gathered once into registers and serve
// all of its up to r_cap pairs, where a thread a (row, rank) would gather
// them once a row.  For one row the lanes of a warp hold neighbouring ranks
// and write neighbouring addresses; a rank past a row's part writes
// nothing, and one past every part (an invalid gaussian, or one of the
// capacity's empty slots: 700k of the flagship's 1M ranks) gathers
// nothing.  The part ends come from offs (r_cap + 1 int64, the same
// addresses for every thread, served by the cache).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// torch.minimum on CUDA: a NaN in either operand is the result
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// the plain version's per-corner exponent, in its operation order
__device__ __forceinline__ float corner_power(float a, float b, float c, float dx, float dy) {
  const float s = a * dx * dx + c * dy * dy;
  return -0.5f * s - b * dx * dy;
}

// quantised lower bound of alpha over a quadrant whose least exponent is p
__device__ __forceinline__ short quad_level(float opa, float p) {
  float alpha = opa * expf(p);
  alpha = alpha != alpha ? alpha : fminf(alpha, 0.99f);   // clamp_max keeps NaN
  alpha = alpha >= 1.0f / 255.0f ? alpha : 0.0f;          // and NaN fails the test
  return (short)floorf(alpha * (1.0f / 0.99f) * 255.0f);
}

}  // namespace

// At global scope, so that its symbol (and ptxas's report of it) carries
// its plain name.
__global__ void __launch_bounds__(THREADS) bin_emit_kernel(
    const int64_t* __restrict__ order, const int64_t* __restrict__ rect_min,
    const int64_t* __restrict__ w_rect, const float* __restrict__ depth,
    const float* __restrict__ xy, const float* __restrict__ conic,
    const float* __restrict__ opacity, const int64_t* __restrict__ offs, int r_cap, int k,
    int64_t grid_x, int tw, int th, float hw, float hh, int vis, int64_t* __restrict__ tile,
    float* __restrict__ dep_out, int64_t* __restrict__ gauss, short4* __restrict__ quads) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= k) return;
  bool emits = false;   // a rank past every row's part reads nothing more
  for (int r = 0; r < r_cap; ++r) emits |= i < offs[r + 1] - offs[r];
  if (!emits) return;
  const int64_t g = order[i];
  const int64_t rmx = rect_min[2 * g], rmy = rect_min[2 * g + 1];
  const int64_t wr = w_rect[g] > 1 ? w_rect[g] : 1;
  const float d = depth[g];
  const int64_t id = vis ? (int64_t)i : g;
  const bool sat = quads != nullptr;
  float sx = 0.f, sy = 0.f, ca = 0.f, cb = 0.f, cc = 0.f, opa = 0.f;
  if (sat) {
    sx = xy[2 * g];
    sy = xy[2 * g + 1];
    ca = conic[3 * g];
    cb = conic[3 * g + 1];
    cc = conic[3 * g + 2];
    opa = opacity[g];
  }
  int64_t lo = offs[0];
  for (int r = 0; r < r_cap; ++r) {
    const int64_t hi = offs[r + 1];
    const int64_t j = lo + i;
    const bool emit = j < hi;
    lo = hi;
    if (!emit) continue;
    const int64_t cell_x = rmx + r % wr;
    const int64_t cell_y = rmy + r / wr;
    tile[j] = cell_y * grid_x + cell_x;
    dep_out[j] = d;
    gauss[j] = id;
    if (!sat) continue;
    const float x0 = (float)(cell_x * tw), y0 = (float)(cell_y * th);
    const float cxs[3] = {x0, x0 + hw, x0 + (float)(tw - 1)};
    const float cys[3] = {y0, y0 + hh, y0 + (float)(th - 1)};
    float p[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) p[a][b] = corner_power(ca, cb, cc, sx - cxs[b], sy - cys[a]);
    short q[4];
#pragma unroll
    for (int iy = 0; iy < 2; ++iy)
#pragma unroll
      for (int ix = 0; ix < 2; ++ix)
        q[2 * iy + ix] = quad_level(opa, nan_min(nan_min(p[iy][ix], p[iy][ix + 1]),
                                                 nan_min(p[iy + 1][ix], p[iy + 1][ix + 1])));
    quads[j] = make_short4(q[0], q[1], q[2], q[3]);
  }
}

extern "C" {

// order [k] int64; rect_min [n, 2], w_rect [n] int64; depth [n] float32;
// with sat xy [n, 2], conic [n, 3], opacity [n] float32, else all three
// null; offs [r_cap + 1] int64 (offs[0] = 0, offs[r_cap] = the outputs'
// length m); tile [m], gauss [m] int64, dep_out [m] float32, quads [m, 4]
// int16 (null without sat).  hw, hh: (tw - 1) / 2, (th - 1) / 2.  See the
// top of the file.
int bin_emit(const int64_t* order, const int64_t* rect_min, const int64_t* w_rect,
             const float* depth, const float* xy, const float* conic, const float* opacity,
             const int64_t* offs, int r_cap, int k, int grid_x, int tw, int th, float hw, float hh,
             int vis, int64_t* tile, float* dep_out, int64_t* gauss, short* quads, void* stream) {
  const bool sat = quads != nullptr;
  if (k <= 0 || r_cap <= 0 || grid_x <= 0 || tw <= 0 || th <= 0 ||
      (sat && (xy == nullptr || conic == nullptr || opacity == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (k + THREADS - 1) / THREADS;
  bin_emit_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      order, rect_min, w_rect, depth, xy, conic, opacity, offs, r_cap, k, grid_x, tw, th, hw, hh,
      vis, tile, dep_out, gauss, reinterpret_cast<short4*>(quads));
  return (int)cudaGetLastError();
}

}  // extern "C"
