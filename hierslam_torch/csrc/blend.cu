// Ladder blend forward (K1) and backward (K2) for Hopper (sm_90a).
//
// K1 replaces hierslam_tpu/ops/render_pallas.py::_fwd_kernel (launched by
// _run_fwd), K2 replaces ::_bwd_kernel (_run_bwd, the VJP of
// blend_tiles_pallas).  Plain C interface, loaded with ctypes by
// hierslam_torch/ops/kernels.py; the wrappers there allocate every output,
// pass PyTorch's current stream and check the launch error this returns.
//
// Table layout per tile: [K, C] float32 with C = 7 + F columns
// (x, y, conic a, b, c, opacity, depth, F features), slots in depth order,
// plus a [K] uint8 slot mask.  Pixel p of tile t sits at
// x = (t % grid_x) * tw + p % tw, y = (t / grid_x) * th + p / tw.
//
// K1 design: one block per tile, one thread per pixel.  Slots are staged
// through shared memory in batches (coalesced loads; every thread then
// reads the same slot, a broadcast).  Each pixel walks front to back with
// a running transmittance product and stops at the first slot that would
// take T below 1e-4 -- the CUDA original's early exit, which the TPU kernel
// could not take -- and the block stops once all its pixels have.  It saves
// per pixel for K2 the final T, the index of the last committed slot and the
// index of the slot where T crosses 0.5 (the median; -1 if none).
// What bounds it: exp and FMA issue per (pixel, slot) pair up to the
// termination point; the table is read once per block.
//
// K2 design: per pixel, walk back to front from the saved last committed
// slot and final T, recovering T before each slot as T_after / (1 - a)
// (one reciprocal for both quotients of a slot; no forward re-sweep).  The closed-form suffix sums are those of the TPU kernel:
// dL/da_i = s_i Tb_i - (S_i + gT T_final) / (1 - a_i), S_i the sum of s_j w_j
// over committed j > i.  The median cotangent goes to the depth of the slot
// K1 chose, not to one re-derived from the recovered T (which can fall on
// the other side of 0.5).  Slots are staged through shared memory in
// batches of sb, a masked slot with opacity 0 (which never passes 1/255).
// Each tile owns its [K, C] output rows, so the per-slot sum over the
// tile's pixels is a block reduction with no global atomics: a warp
// reduce-scatter (reduce.cuh: 14 shuffles for the C = 10 of tracking where
// a butterfly per value took 50, 38 for C = 36 against 180) leaves the
// warp's C sums spread over its lanes, which store them to shared memory,
// and one pass over the warps finishes them.  A warp with no active pixel
// on a slot stores zeros.  Rows past the block's last committed slot are
// written as 0.
// What bounds it: issue per (pixel, slot) walked -- exp, the suffix-sum and
// term arithmetic, the reduce-scatter's shuffles, selects and adds (~4 per
// value) and, before this design, ~20 instructions of shared-address
// arithmetic a slot, now pointers stepped down with the slot -- far above
// the bytes it moves.  The feature cotangents and terms are register arrays
// sized by the feature bucket (F <= 3, F <= 29, F <= 32); wide rows (F > 3)
// are staged at a float4 stride and their features read as float4; 3
// blocks of 256 an SM (80 registers, no spill).

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

#define ALPHA_MIN (1.0f / 255.0f)
#define ALPHA_MAX 0.99f
#define T_DONE 1e-4f
#define MEDIAN_DEFAULT 15.0f
#define BWD_THREADS 256  // most pixels a tile K2 takes
#define K2_MIN_BLOCKS 3  // K2 blocks an SM must hold: 80 registers, no spill

template <int MAXF>
__global__ void blend_fwd_kernel(
    const float* __restrict__ table, const uint8_t* __restrict__ ok,
    int K, int C, int F, int grid_x, int th, int tw, int nb,
    float* __restrict__ acc, float* __restrict__ ft, float* __restrict__ med,
    int* __restrict__ last, int* __restrict__ mslot) {
  extern __shared__ float smem[];
  float* s_tab = smem;                                   // [nb][C]
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(smem + nb * C);  // [nb]
  const int tile = blockIdx.x;
  const int P = blockDim.x;
  const int p = threadIdx.x;
  const float px = (float)((tile % grid_x) * tw + p % tw);
  const float py = (float)((tile / grid_x) * th + p / tw);
  const float* tab_t = table + (size_t)tile * K * C;
  const uint8_t* ok_t = ok + (size_t)tile * K;

  float a_f[MAXF];
#pragma unroll
  for (int c = 0; c < MAXF; ++c) a_f[c] = 0.f;
  float a_dep = 0.f, a_mass = 0.f;
  float T = 1.f, medv = MEDIAN_DEFAULT;
  int lastc = -1, medc = -1;
  bool done = false;

  for (int base = 0; base < K; base += nb) {
    const int n = min(nb, K - base);
    for (int i = p; i < n * C; i += P) s_tab[i] = tab_t[(size_t)base * C + i];
    for (int i = p; i < n; i += P) s_ok[i] = ok_t[base + i];
    __syncthreads();
    if (!done) {
      for (int j = 0; j < n; ++j) {
        if (!s_ok[j]) continue;
        const float* g = s_tab + j * C;
        const float dx = g[0] - px;
        const float dy = g[1] - py;
        const float power = -0.5f * (g[2] * dx * dx + g[4] * dy * dy) - g[3] * dx * dy;
        if (power > 0.f) continue;
        const float alpha = fminf(ALPHA_MAX, g[5] * expf(power));
        if (alpha < ALPHA_MIN) continue;
        const float test_T = T * (1.f - alpha);
        if (test_T < T_DONE) {
          done = true;
          break;
        }
        const float w = alpha * T;
#pragma unroll
        for (int c = 0; c < MAXF; ++c)
          if (c < F) a_f[c] += g[7 + c] * w;
        a_dep += g[6] * w;
        a_mass += w;
        if (T > 0.5f && test_T < 0.5f) {
          medv = g[6];
          medc = base + j;
        }
        T = test_T;
        lastc = base + j;
      }
    }
    // barrier before the next batch overwrites shared memory; the block
    // leaves once every pixel is done
    if (__syncthreads_count(!done) == 0) break;
  }

  const size_t pix = (size_t)tile * P + p;
  float* acc_p = acc + pix * (F + 2);
#pragma unroll
  for (int c = 0; c < MAXF; ++c)
    if (c < F) acc_p[c] = a_f[c];
  acc_p[F] = a_dep;
  acc_p[F + 1] = a_mass;
  ft[pix] = T;
  med[pix] = medv;
  last[pix] = lastc;
  mslot[pix] = medc;
}

template <int MAXF>
__global__ void __launch_bounds__(BWD_THREADS, K2_MIN_BLOCKS) blend_bwd_kernel(
    const float* __restrict__ table, const uint8_t* __restrict__ ok,
    const float* __restrict__ ft, const int* __restrict__ last,
    const int* __restrict__ mslot, const float* __restrict__ gacc, const float* __restrict__ gft,
    const float* __restrict__ gmed, int K, int C, int F, int grid_x, int th,
    int tw, int sb, float* __restrict__ dtab) {
  constexpr int V = 7 + MAXF;               // terms summed per slot (bucket)
  // wide rows read their features 1.. as float4 (a shared load each); at
  // F <= 3 the scalar loads are cheaper
  constexpr bool WIDE = MAXF > 3;
  extern __shared__ float4 smem4[];  // 16-byte aligned: s_tab is read as float4
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = blockDim.x;
  const int nwarps = P / 32;
  const int CP = WIDE ? (C + 3) & ~3 : C;   // slot stride, pads 0
  float* s_tab = smem;                      // [sb][CP]
  float* s_red = s_tab + sb * CP;           // [nwarps][sb][C]
  __shared__ int s_maxlast;

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float px = (float)((tile % grid_x) * tw + p % tw);
  const float py = (float)((tile / grid_x) * th + p / tw);
  const float* tab_t = table + (size_t)tile * K * C;
  const uint8_t* ok_t = ok + (size_t)tile * K;
  float* dtab_t = dtab + (size_t)tile * K * C;
  const size_t pix = (size_t)tile * P + p;

  float ga[MAXF];
#pragma unroll
  for (int c = 0; c < MAXF; ++c) ga[c] = (c < F) ? gacc[pix * (F + 2) + c] : 0.f;
  const float ga_dep = gacc[pix * (F + 2) + F];
  const float ga_mass = gacc[pix * (F + 2) + F + 1];
  const float T_final = ft[pix];
  const float gT = gft[pix];
  const float gm = gmed[pix];
  const int mylast = last[pix];
  const int mymed = mslot[pix];
  const float gTT = gT * T_final;

  if (p == 0) s_maxlast = -1;
  for (int i = p; i < sb * CP; i += P) s_tab[i] = 0.f;  // the pads stay 0
  __syncthreads();
  atomicMax(&s_maxlast, mylast);
  __syncthreads();
  const int maxl = s_maxlast;
  for (int i = (maxl + 1) * C + p; i < K * C; i += P) dtab_t[i] = 0.f;

  float T = T_final;
  float S = 0.f;
  for (int hi = maxl; hi >= 0; hi -= sb) {
    const int lo = max(0, hi - sb + 1);
    const int n = hi - lo + 1;
    __syncthreads();  // previous batch's reduction has read s_red / s_tab
    if (CP == C) {
      for (int i = p; i < n * C; i += P) s_tab[i] = tab_t[(size_t)lo * C + i];
    } else {
      for (int i = p; i < n * C; i += P) {
        const int jj = i / C;
        s_tab[jj * CP + i - jj * C] = tab_t[(size_t)lo * C + i];
      }
    }
    __syncthreads();
    // a masked slot is staged with opacity 0, which never passes 1/255
    for (int i = p; i < n; i += P)
      if (!ok_t[lo + i]) s_tab[i * CP + 5] = 0.f;
    __syncthreads();
    // the slot's row and this warp's sums for it, stepped down with jj
    const float* g = s_tab + (n - 1) * CP;
    float* red = s_red + ((size_t)warp * sb + n - 1) * C;
    for (int jj = n - 1; jj >= 0; --jj, g -= CP, red -= C) {
      // the slot's terms for this pixel, 0 where it does not commit
      float gs[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float w = 0.f;
      bool act = false;
      if (lo + jj <= mylast) {
        const float dx = g[0] - px;
        const float dy = g[1] - py;
        const float power = -0.5f * (g[2] * dx * dx + g[4] * dy * dy) - g[3] * dx * dy;
        if (power <= 0.f) {
          const float ep = expf(power);
          const float alpha = fminf(ALPHA_MAX, g[5] * ep);
          if (alpha >= ALPHA_MIN) {
            act = true;
            const float u = 1.f - alpha;
            // one reciprocal for both quotients (no discrete test reads T)
            const float inv_u = 1.f / u;
            const float Tb = T * inv_u;
            float s = ga_dep * g[6] + ga_mass;
            if constexpr (WIDE) {
              s += ga[0] * g[7];
              // feature c sits in column 7 + c: float4 q holds features 4q-7 .. 4q-4
              const float4* g4 = reinterpret_cast<const float4*>(g);
#pragma unroll
              for (int q = 2; 4 * q - 7 < MAXF; ++q) {
                if (4 * q < C) {  // pads past C are 0, as ga is past F
                  const float4 v = g4[q];
                  s += ga[4 * q - 7] * v.x;
                  if (4 * q - 6 < MAXF) s += ga[4 * q - 6] * v.y;
                  if (4 * q - 5 < MAXF) s += ga[4 * q - 5] * v.z;
                  if (4 * q - 4 < MAXF) s += ga[4 * q - 4] * v.w;
                }
              }
            } else {
#pragma unroll
              for (int c = 0; c < MAXF; ++c)
                if (c < F) s += ga[c] * g[7 + c];
            }
            w = alpha * Tb;
            const float da = s * Tb - (S + gTT) * inv_u;
            S += s * w;
            float dopa = 0.f, dpow = 0.f;
            if (alpha < ALPHA_MAX) {
              dopa = ep * da;
              dpow = alpha * da;
            }
            gs[0] = dpow * (-(g[2] * dx + g[3] * dy));
            gs[1] = dpow * (-(g[4] * dy + g[3] * dx));
            gs[2] = -0.5f * dx * dx * dpow;
            gs[3] = -dx * dy * dpow;
            gs[4] = -0.5f * dy * dy * dpow;
            gs[5] = dopa;
            gs[6] = ga_dep * w + (lo + jj == mymed ? gm : 0.f);
            T = Tb;
          }
        }
      }
      if (__any_sync(hsl::FULL_MASK, act))
        hsl::warp_sum_store<V>(
            [&](int c) { return c < 7 ? gs[c] : (c - 7 < MAXF ? ga[c - 7] * w : 0.f); }, red, C,
            lane);
      else
        hsl::warp_zero_store(red, C, lane);
    }
    __syncthreads();  // every warp's sums are in s_red
    for (int i = p; i < n * C; i += P) {
      float v = 0.f;
      for (int w = 0; w < nwarps; ++w) v += s_red[(size_t)w * sb * C + i];
      dtab_t[(size_t)lo * C + i] = v;
    }
  }
}

template <int MAXF>
static cudaError_t launch_fwd(const float* table, const uint8_t* ok, int T, int K,
                              int C, int grid_x, int th, int tw, int nb, float* acc,
                              float* ft, float* med, int* last, int* mslot,
                              cudaStream_t stream) {
  const size_t shmem = (size_t)nb * C * sizeof(float) + nb;
  blend_fwd_kernel<MAXF><<<T, th * tw, shmem, stream>>>(
      table, ok, K, C, C - 7, grid_x, th, tw, nb, acc, ft, med, last, mslot);
  return cudaGetLastError();
}

// Shared memory (bytes) of one K2 block for C columns, P pixels, batch sb.
static int bwd_smem(int C, int P, int sb) {
  const int CP = C - 7 > 3 ? (C + 3) & ~3 : C;  // the kernel's slot stride
  return sb * (CP + C * (P / 32)) * (int)sizeof(float);
}

template <int MAXF>
static cudaError_t launch_bwd(const float* table, const uint8_t* ok, const float* ft,
                              const int* last, const int* mslot, const float* gacc,
                              const float* gft, const float* gmed, int T, int K, int C,
                              int grid_x, int th, int tw, int sb, float* dtab,
                              cudaStream_t stream) {
  const int P = th * tw;
  blend_bwd_kernel<MAXF><<<T, P, bwd_smem(C, P, sb), stream>>>(
      table, ok, ft, last, mslot, gacc, gft, gmed, K, C, C - 7, grid_x, th, tw, sb, dtab);
  return cudaGetLastError();
}

extern "C" {

// Largest feature count the kernels take (F = C - 7): 3 (colour) and 29
// (colour and 26 semantic channels) are what the configs carry.
int blend_max_features() { return 32; }

// Shared memory (bytes) of one K2 block for C columns, P pixels, batch sb.
int blend_bwd_smem(int C, int P, int sb) { return bwd_smem(C, P, sb); }

int blend_fwd(const float* table, const uint8_t* ok, int T, int K, int C,
              int grid_x, int th, int tw, int nb, float* acc, float* ft,
              float* med, int* last, int* mslot, void* stream) {
  const int F = C - 7;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (F <= 4)
    return launch_fwd<4>(table, ok, T, K, C, grid_x, th, tw, nb, acc, ft, med, last, mslot, s);
  if (F <= 32)
    return launch_fwd<32>(table, ok, T, K, C, grid_x, th, tw, nb, acc, ft, med, last, mslot, s);
  return (int)cudaErrorInvalidValue;
}

int blend_bwd(const float* table, const uint8_t* ok, const float* ft, const int* last,
              const int* mslot, const float* gacc, const float* gft, const float* gmed,
              int T, int K, int C, int grid_x, int th, int tw, int sb, float* dtab,
              void* stream) {
  const int F = C - 7;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (th * tw > BWD_THREADS) return (int)cudaErrorInvalidValue;
  // feature buckets: the configs carry F = 3 and F = 29
  if (F <= 3)
    return launch_bwd<3>(table, ok, ft, last, mslot, gacc, gft, gmed, T, K, C, grid_x, th, tw,
                         sb, dtab, s);
  if (F <= 29)
    return launch_bwd<29>(table, ok, ft, last, mslot, gacc, gft, gmed, T, K, C, grid_x, th,
                          tw, sb, dtab, s);
  if (F <= 32)
    return launch_bwd<32>(table, ok, ft, last, mslot, gacc, gft, gmed, T, K, C, grid_x, th,
                          tw, sb, dtab, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
