// The gather's backward as a segmented sum (K5), for Hopper (sm_90a).
//
// K5 replaces the XLA ops of hierslam_tpu/ops/gather_vjp.py:218-254,
// _gather_bwd (no Pallas kernel there: a row permute, doubling passes of a
// segmented suffix sum and a gather of each run's head).  Plain C
// interface, loaded with ctypes by hierslam_torch/ops/kernels.py; the
// wrapper there allocates the output, passes PyTorch's current stream and
// checks the launch error this returns.
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
// Bound on this card: bytes.  Per reference its nd summed columns and its
// position are read, per row its run end, and all of grad is written: at
// the flagship's first mapping stream (3.24M references, 34 columns, 1.57M
// rows) 0.20 ms at 3.35 TB/s against ~5e-5 ms of adds at 67 TFLOP/s.  The
// cotangent rows are read in the order of the rows they reference, which
// is random in cot: a 136-byte row at 8-byte alignment touches 5-6
// sectors of 32 bytes, which puts the practical ceiling near 75-85% of
// that bound.
//
// Design.  The work is one random row read a reference behind two
// dependent reads: the rows' run ends, then their runs' positions.  A row
// block is `rows` consecutive rows, whose runs form one contiguous span
// spos[s0:e0] (spos is sorted by row); rows = ENTRIES / G, G = C / VEC
// column groups a row, a group VEC = 2 columns (float2) where C and the
// pointers allow it, else 1.  A stage holds VALS floats (48 KB): 361
// references of 34 columns, 6 a row of the flagship's row blocks of 60
// rows, whose first mapping stream has 3.24M references over 816,000
// active rows, ~4 a row: a 24 KB stage (180) sent most active row blocks
// down the stage-by-stage path.  As many blocks as the card holds at once
// each walk every gridDim-th row block through a three-stage pipeline: the
// copies of row block k's summed cotangent groups (cp.async, 8 or 4 bytes a
// group, straight into shared memory: no register holds a load), of row
// block k + 1's positions and of row block k + 2's run ends are in flight
// together, and one wait and one barrier later the block sums row block
// k.  Threads take (row, column group) entries, entry e row e / G and
// group e % G, so neighbouring lanes take neighbouring columns of a row;
// each adds its run's staged terms in ascending order and writes grad at
// r0 C + VEC e: the row block's [rows, C] region of grad, zeros included,
// is one contiguous vectorised store.  A span longer than a stage (VALS
// floats, SPAN positions) is walked stage by stage in the same block, the
// partial sums kept in grad (each entry reads back what it wrote).
// Against the one warp a row of the design before: no lane idles past nd
// or past the last 32-column chunk, and a row with an empty run costs its
// store and its share of one load of ends; the chain ends -> positions ->
// rows costs one wait a row block, shared with two other row blocks'
// loads, not three a row; a row block's whole span is in flight at once
// whatever its run lengths, where a warp walked its run one reference at a
// time; and the stores are coalesced.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int EPT = 4;                    // entries a thread
constexpr int ENTRIES = THREADS * EPT;    // (row, column group) entries of a row block
constexpr int SPAN = 1024;                // positions a stage holds
constexpr int VALS = 12288;               // cotangent floats a stage holds (48 KB)
constexpr int MAX_COLS = ENTRIES;         // widest C (and nd): one group a row at least

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.0f; }
  __device__ static void add(T& a, T b) { a += b; }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ static T zero() { return make_float2(0.0f, 0.0f); }
  __device__ static void add(T& a, T b) {
    a.x += b.x;
    a.y += b.y;
  }
};

// A staged group as a summed term: each value rounded to bfloat16 with
// BF16, a value at column nd or past it (the second of a pair that
// straddles nd: `whole` false) 0.
template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}
template <bool BF16>
__device__ __forceinline__ float term(float v, bool) { return rnd<BF16>(v); }
template <bool BF16>
__device__ __forceinline__ float2 term(float2 v, bool whole) {
  return make_float2(rnd<BF16>(v.x), whole ? rnd<BF16>(v.y) : 0.0f);
}

// cp.async of one group (4 or 8 bytes, both ends aligned to it) into
// shared memory; cp_wait waits for every copy this thread started.
template <int VEC>
__device__ __forceinline__ void cp_group(void* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_int(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The block's view of row block b: rows r0 .. r0 + nr - 1, whose run ends
// (raw, as in `ends`) sit in e_raw[1 .. nr]; e_raw[0] is row r0 - 1's.
struct RowBlock {
  int r0, nr;
  const int* e_raw;
  int m;
  // start of row r0 + j's run (j = nr: the end of the last), cut at m
  __device__ int start(int j) const { return r0 + j == 0 ? 0 : min(e_raw[j], m); }
};

}  // namespace

// At global scope, so that its symbol (and ptxas's report of it) carries
// its plain name.  Dynamic shared memory: gather_smem(rows).
template <int VEC, bool BF16>
__global__ void __launch_bounds__(THREADS)
gather_bwd_kernel(const float* __restrict__ cot, const int* __restrict__ spos,
                  const int* __restrict__ ends, int n, int m, int c, int nd, int rows,
                  float* __restrict__ grad) {
  using V = typename Vec<VEC>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  V* s_val = reinterpret_cast<V*>(smem);                          // VALS floats
  int* s_pos = reinterpret_cast<int*>(smem + VALS * sizeof(float));   // [2][SPAN]
  int* s_ends = s_pos + 2 * SPAN;                                 // [3][rows + 1]
  const int nblk = (n + rows - 1) / rows;
  const int G = c / VEC;                  // groups a row of grad
  const int gv = (nd + VEC - 1) / VEC;    // groups a reference stages
  const int S = gv ? min(SPAN, VALS / (gv * VEC)) : SPAN;   // references a stage holds
  const int t = threadIdx.x;

  auto block = [&](int k) {   // the k-th row block of this CTA (b >= nblk: none)
    const int b = blockIdx.x + k * gridDim.x;
    RowBlock rb;
    rb.r0 = b * rows;
    rb.nr = b < nblk ? min(rows, n - rb.r0) : 0;
    rb.e_raw = s_ends + (k % 3) * (rows + 1);
    rb.m = m;
    return rb;
  };
  // start the copy of row block k's run ends
  auto ends_async = [&](int k) {
    const RowBlock rb = block(k);
    int* dst = s_ends + (k % 3) * (rows + 1);
    for (int j = t; j <= rb.nr && rb.nr; j += THREADS)
      if (rb.r0 + j > 0) cp_int(dst + j, ends + rb.r0 + j - 1);
  };
  // the span of row block k's references (its ends in place), and whether
  // one stage holds it
  auto span = [&](const RowBlock& rb, int& s0, int& len) {
    s0 = rb.start(0);
    len = gv && rb.nr ? rb.start(rb.nr) - s0 : 0;
  };
  // start the copy of `len` positions from s0 into stage p
  auto pos_async = [&](int p, int s0, int len) {
    for (int i = t; i < len; i += THREADS) cp_int(s_pos + p * SPAN + i, spos + s0 + i);
  };
  // start the copy of the summed groups of `len` staged references (their
  // positions in stage p) into s_val
  auto val_async = [&](int p, int len) {
    const int* pos = s_pos + p * SPAN;
    if (len == 0) return;
    // item idx is group g of staged reference i; a step of THREADS items
    // moves i by di and g by dg (no division in the loop)
    const int di = THREADS / gv, dg = THREADS - di * gv;
    int i = t / gv, g = t - i * gv;
    for (int idx = t; idx < len * gv; idx += THREADS) {
      cp_group<VEC>(s_val + idx, cot + (size_t)pos[i] * c + g * VEC);
      i += di;
      g += dg;
      if (g >= gv) {
        g -= gv;
        ++i;
      }
    }
  };
  // add each entry's staged references [cs, cs + len) to its sum; `first`:
  // the sums start from 0, else from what grad holds; an entry writes grad
  // when `first` or when its run meets the stage
  auto sum_stage = [&](const RowBlock& rb, int cs, int len, bool first) {
    V* dst = reinterpret_cast<V*>(grad + (size_t)rb.r0 * c);
#pragma unroll
    for (int kk = 0; kk < EPT; ++kk) {
      const int e = t + kk * THREADS;
      if (e >= rb.nr * G) continue;
      const int j = e / G;
      const int g = e - j * G;
      const int lo = g < gv ? max(rb.start(j), cs) - cs : 0;
      const int hi = g < gv ? min(rb.start(j + 1), cs + len) - cs : 0;
      if (!first && lo >= hi) continue;
      V acc = first ? Vec<VEC>::zero() : dst[e];
      const bool whole = (g + 1) * VEC <= nd;
#pragma unroll 4
      for (int i = lo; i < hi; ++i) Vec<VEC>::add(acc, term<BF16>(s_val[i * gv + g], whole));
      dst[e] = acc;
    }
  };

  // prologue: ends of row blocks 0 and 1, positions of 0
  ends_async(0);
  ends_async(1);
  cp_wait();
  __syncthreads();
  {
    int s0, len;
    span(block(0), s0, len);
    if (len <= S) pos_async(0, s0, len);
    cp_wait();
    __syncthreads();
  }
  for (int k = 0; block(k).nr; ++k) {
    const RowBlock rb = block(k), next = block(k + 1);
    int s0, len, s1, len1;
    span(rb, s0, len);
    span(next, s1, len1);
    // in flight together: this block's values, the next one's positions,
    // the one after's ends
    if (len <= S) val_async(k % 2, len);
    if (next.nr && len1 <= S) pos_async((k + 1) % 2, s1, len1);
    ends_async(k + 2);
    cp_wait();
    __syncthreads();
    if (len <= S) {
      sum_stage(rb, s0, len, true);
    } else {   // a span longer than a stage: stage by stage, the sums kept in grad
      for (int cs = s0; cs < s0 + len; cs += S) {
        const int l = min(S, s0 + len - cs);
        __syncthreads();   // the last stage's readers are done
        pos_async(k % 2, cs, l);
        cp_wait();
        __syncthreads();
        val_async(k % 2, l);
        cp_wait();
        __syncthreads();
        sum_stage(rb, cs, l, cs == s0);
      }
    }
    __syncthreads();   // every reader of s_val and of this block's stages is done
  }
}

namespace {

// Dynamic shared memory of a block of `rows` rows.
size_t gather_smem(int rows) {
  return VALS * sizeof(float) + (2 * SPAN + 3 * (size_t)(rows + 1)) * sizeof(int);
}

template <int VEC, bool BF16>
cudaError_t launch_one(const float* cot, const int* spos, const int* ends, int n, int m, int c,
                       int nd, float* grad, cudaStream_t stream) {
  const int rows = ENTRIES / (c / VEC);
  const int nblk = (n + rows - 1) / rows;
  const size_t smem = gather_smem(rows);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(gather_bwd_kernel<VEC, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_bwd_kernel<VEC, BF16>,
                                                        THREADS, smem);
  if (err != cudaSuccess) return err;
  const int grid = max(1, min(nblk, sms * per_sm));   // each block walks every grid-th row block
  gather_bwd_kernel<VEC, BF16><<<grid, THREADS, smem, stream>>>(cot, spos, ends, n, m, c, nd,
                                                                rows, grad);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch(bool bf16, const float* cot, const int* spos, const int* ends, int n, int m,
                   int c, int nd, float* grad, cudaStream_t stream) {
  return bf16 ? launch_one<VEC, true>(cot, spos, ends, n, m, c, nd, grad, stream)
              : launch_one<VEC, false>(cot, spos, ends, n, m, c, nd, grad, stream);
}

}  // namespace

extern "C" {

// Widest cotangent row (and so largest nd) the kernel takes.
int gather_max_cols() { return MAX_COLS; }

// cot [M, c] float32 (only rows spos[..] are read), spos [m] int32,
// ends [n] int32, grad [n, c] float32; bf16: 0 or 1.  See the top of the
// file.
int gather_bwd(const float* cot, const int* spos, const int* ends, int n, int m, int c, int nd,
               int bf16, float* grad, void* stream) {
  if (n <= 0 || c <= 0 || c > MAX_COLS || nd < 0 || nd > c || m < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool b = bf16 != 0;
  const bool pairs = c % 2 == 0 && ((uintptr_t)cot & 7) == 0 && ((uintptr_t)grad & 7) == 0;
  return (int)(pairs ? launch<2>(b, cot, spos, ends, n, m, c, nd, grad, s)
                     : launch<1>(b, cot, spos, ends, n, m, c, nd, grad, s));
}

}  // extern "C"
