// The gather's backward as a segmented sum (K5), for Hopper (sm_90a).
//
// K5 replaces the XLA ops of hierslam_tpu/ops/gather_vjp.py::_gather_bwd
// (no Pallas kernel there: a row permute, doubling passes of a segmented
// suffix sum and a gather of each run's head).  Plain C interface, loaded
// with ctypes by hierslam_torch/ops/kernels.py; the wrapper there allocates
// the output, passes PyTorch's current stream and checks the launch error
// this returns.
//
// Inputs: the cotangent rows of a gather, cot [M, C] float32; the
// binning's inverse map, spos [m] int32 (flat gather positions stably
// sorted by the row they reference; m is cut to a pair budget) and
// ends [N] int32 (the end of each row's run in that order).  Output
// grad [N, C]: for row g < N and column c < nd,
//   grad[g, c] = sum_{i = starts[g]}^{min(ends[g], m) - 1} r(cot[spos[i], c])
// with starts[g] = min(ends[g - 1], m) (0 for g = 0) and r the round to
// bfloat16 (nearest, ties to even, as Tensor.to(torch.bfloat16) rounds)
// when bf16 is set, else the identity; columns c >= nd are 0.  Every
// element of grad is written.
//
// Summation order: each run is summed from 0.0f, one add at a time, in
// ascending position order, with no atomics, so that a run repeats to the
// bit and equals the plain version (index_add_ over the sorted positions
// on the CPU, which adds in index order).
//
// Design: one warp a row, lanes across the columns (NCH chunks of 32, up
// to MAX_COLS), 8 warps a block.  A warp reads 32 of its run's positions
// with one coalesced load and hands them out with shuffles; it loads UNROLL
// cotangent rows before it adds them, in order, so that the loads of a
// long run overlap.  Rows with an empty run write zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_CHUNKS = 5;
constexpr int MAX_COLS = MAX_CHUNKS * 32;
constexpr int UNROLL = 4;
constexpr unsigned FULL = 0xffffffffu;

template <bool BF16>
__device__ __forceinline__ float term(const float* p) {
  const float v = __ldg(p);
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

}  // namespace

// At global scope, so that its symbol (and ptxas's report of it) carries
// its plain name.
template <int NCH, bool BF16>
__global__ void __launch_bounds__(THREADS)
gather_bwd_kernel(const float* __restrict__ cot, const int* __restrict__ spos,
                  const int* __restrict__ ends, int n, int m, int c, int nd,
                  float* __restrict__ grad) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;   // the whole warp: row is the same on every lane
  const int e = min(ends[row], m);
  const int s = row == 0 ? 0 : min(ends[row - 1], m);
  float acc[NCH];
#pragma unroll
  for (int j = 0; j < NCH; ++j) acc[j] = 0.0f;
  for (int base = s; base < e; base += 32) {
    const int cnt = min(32, e - base);
    const int mine = lane < cnt ? spos[base + lane] : 0;
    int k = 0;
    for (; k + UNROLL <= cnt; k += UNROLL) {
      float v[UNROLL][NCH];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float* src = cot + (size_t)__shfl_sync(FULL, mine, k + u) * c;
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          const int col = lane + 32 * j;
          v[u][j] = col < nd ? term<BF16>(src + col) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int j = 0; j < NCH; ++j) acc[j] += v[u][j];
    }
    for (; k < cnt; ++k) {
      const float* src = cot + (size_t)__shfl_sync(FULL, mine, k) * c;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int col = lane + 32 * j;
        if (col < nd) acc[j] += term<BF16>(src + col);
      }
    }
  }
  float* dst = grad + (size_t)row * c;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int col = lane + 32 * j;
    if (col < nd) dst[col] = acc[j];
  }
  for (int col = nd + lane; col < c; col += 32) dst[col] = 0.0f;
}

namespace {

template <int NCH>
cudaError_t launch(bool bf16, const float* cot, const int* spos, const int* ends, int n, int m,
                   int c, int nd, float* grad, cudaStream_t stream) {
  const dim3 blocks((unsigned)((n + WARPS - 1) / WARPS));
  if (bf16)
    gather_bwd_kernel<NCH, true><<<blocks, THREADS, 0, stream>>>(cot, spos, ends, n, m, c, nd,
                                                                 grad);
  else
    gather_bwd_kernel<NCH, false><<<blocks, THREADS, 0, stream>>>(cot, spos, ends, n, m, c, nd,
                                                                  grad);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest nd the kernel sums (the ladder's 7 + F at F = 128 is 135).
int gather_max_cols() { return MAX_COLS; }

// cot [M, c] float32 (only rows spos[..] are read), spos [m] int32,
// ends [n] int32, grad [n, c] float32; bf16: 0 or 1.  See the top of the
// file.
int gather_bwd(const float* cot, const int* spos, const int* ends, int n, int m, int c, int nd,
               int bf16, float* grad, void* stream) {
  if (n <= 0 || nd < 0 || nd > c || nd > MAX_COLS || m < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool b = bf16 != 0;
  switch (nd <= 32 ? 1 : (nd + 31) / 32) {
    case 1: return (int)launch<1>(b, cot, spos, ends, n, m, c, nd, grad, s);
    case 2: return (int)launch<2>(b, cot, spos, ends, n, m, c, nd, grad, s);
    case 3: return (int)launch<3>(b, cot, spos, ends, n, m, c, nd, grad, s);
    case 4: return (int)launch<4>(b, cot, spos, ends, n, m, c, nd, grad, s);
    default: return (int)launch<MAX_CHUNKS>(b, cot, spos, ends, n, m, c, nd, grad, s);
  }
}

}  // extern "C"
