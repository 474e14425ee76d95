// Ladder blend forward (K1) and backward (K2) for Hopper (sm_90a).
//
// K1 replaces hierslam_tpu/ops/render_pallas.py::_fwd_kernel (launched by
// _run_fwd), K2 replaces ::_bwd_kernel (_run_bwd, the VJP of
// blend_tiles_pallas).  Plain C interface, loaded with ctypes by
// hierslam_torch/ops/kernels.py; the wrappers there allocate the outputs or
// take the buffers a caller shares over the capacity classes of a render,
// pass PyTorch's current stream and check the launch error this returns.
//
// Table layout per tile: [K, C] float32 with C = 7 + F columns
// (x, y, conic a, b, c, opacity, depth, F features), slots in depth order,
// plus a [K] uint8 slot mask.  Block b blends row b of the table as tile
// t = tile_ids[b] of the image's grid (t = b where tile_ids is null): pixel p
// of tile t sits at x = (t % grid_x) * tw + p % tw, y = (t / grid_x) * th +
// p / tw, at true screen coordinates.  The per-pixel outputs and residuals
// are rows t of [T_all, P, .] buffers, so the capacity classes of one render,
// which partition the tiles, each launch into the same buffers and leave the
// whole image in tile order.  K2 reads the residuals and cotangents at row t
// and writes row b of d table.
//
// K1 design: one block per tile, one thread per pixel, a warp an 8 x 4
// block of pixels (cull.cuh).  What bounds it is the work per (warp, slot): a
// warp pays a slot's test (shared loads, the quadratic form, an exp, three
// branches) when one lane needs it -- far above the bytes (the table is
// read once per block) and the 12 operations a pair the roofline counts.
// So the design removes (warp, slot) visits and instructions per visit:
// - slots are staged in batches as packed records, two float4 a slot
//   (x y a b | c opacity depth mask), with the slot mask folded in and the
//   features in a float4-aligned array that only a commit reads.  The
//   lane that stages a slot computes the warps its footprint can reach
//   (cull.cuh), and a warp visits only the slots that
//   hold its bit, found with one ballot per 32 slots (fwd.cuh
//   walk_records): a masked slot or one that misses the warp costs no load
//   and no branch;
// - batches are pipelined with one barrier a batch: each warp brings its
//   own piece of batch b + 1 into shared memory with cp.async while the
//   block walks batch b, then packs it into the other of two record and
//   feature buffers.  A warp copies and packs only its own piece, so the
//   raw buffer needs no second copy and no barrier of its own.  A batch is
//   as many slots a warp (32, 16, 8 or 4) as 64 KB of shared memory hold:
//   256 slots at F = 3 (34 KB, 4 blocks an SM), 128 at F = 29 (58 KB, 3).
// Each pixel walks front to back with a running transmittance product and
// stops at the first slot that would take T below 1e-4 -- the CUDA
// original's early exit, which the TPU kernel could not take -- and the
// block leaves at the batch barrier once all its pixels have.  It saves per
// pixel for K2 the final T, the index of the last committed slot and the
// index of the slot where T crosses 0.5 (the median; -1 if none).
// A shape with fewer tiles than the card has SMs (a ladder class of 128
// tiles of 4,096 slots) runs one block an SM and is bound by the latency of
// that one block's chain of batches; splitting a tile's slots over blocks
// is not done here.
// Not taken: wgmma for the feature sum (see stream.cu).
//
// K2 design: per pixel, walk back to front from the saved last committed
// slot and final T, recovering T before each slot as T_after / (1 - a)
// (one reciprocal for both quotients of a slot; no forward re-sweep).  The closed-form suffix sums are those of the TPU kernel:
// dL/da_i = s_i Tb_i - (S_i + gT T_final) / (1 - a_i), S_i the sum of s_j w_j
// over committed j > i.  The median cotangent goes to the depth of the slot
// K1 chose, not to one re-derived from the recovered T (which can fall on
// the other side of 0.5).  Which slots a pixel takes (power <= 0, alpha >=
// 1/255) K2 decides again, with power rounded as K1 rounds it (fwd.cuh
// blend_power: the plain version's order, no FMA).  Slots are staged through
// shared memory in
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
//
// The wide bucket (33 <= F <= 128, fwd.cuh MAX_FEATURES) runs the same code
// with 128-float register arrays at one block an SM (up to 255 registers):
// K1's accumulator, K2's cotangents.  Loops over features stop at F, and
// K2's reduce-scatter skips the chunks past 7 + F (reduce.cuh).  With one
// block an SM, K1 takes batches of 64 slots under a budget of 112 KB
// (66 KB at F = 77, 104 KB at F = 128); K2's batch stays under 46 KB.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fwd.cuh"
#include "reduce.cuh"

#define K1_SMEM_BUDGET (64 * 1024)  // dynamic shared memory a K1 block may take
#define K1_WIDE_SMEM_BUDGET (112 * 1024)  // the same in the wide bucket (one block an SM)
#define BWD_THREADS 256  // most pixels a tile K2 takes
// K2 blocks an SM must hold: 3 (80 registers, no spill) up to F <= 32, 1 in
// the wide bucket
__host__ __device__ constexpr int k2_min_blocks(int maxf) { return maxf <= 32 ? 3 : 1; }

// K1 staging.  Warp w owns slots w spw .. (w + 1) spw of a batch; nv of them
// lie inside the table.  stage_copy starts the copy of their rows into the
// warp's piece of the raw buffer; stage_pack, once they have arrived, packs
// them into records rec4 [nb][2] and features feat4 [nb][fs4].  okv is the
// lane's byte of the slot mask.
__device__ __forceinline__ void stage_pack(const float* s_raw, float4* rec4, float4* feat4, int C,
                                           int F, int spw, int nv, bool okv, int warp, int lane,
                                           float tile_x0, float tile_y0, int tw, int th) {
  hsl::warp_copy_wait();
  const int fs4 = hsl::feat4_stride(F);
  if (lane < spw) {
    const int j = warp * spw + lane;
    float4 q0 = make_float4(0.f, 0.f, 0.f, 0.f), q1 = q0;  // mask 0: never visited
    if (lane < nv && okv) {
      const float* g = s_raw + j * C;
      const float a = g[2], b = g[3], c = g[4], opa = g[5];
      float cxx, cyy;  // infinite (live for every warp) without a box
      hsl::conic_box_diag(a, b, c, cxx, cyy);
      const unsigned mask = hsl::warp_mask(g[0], g[1], cxx, cyy, opa, tile_x0, tile_y0, tw, th);
      q0 = make_float4(g[0], g[1], a, b);
      q1 = make_float4(c, opa, g[6], __uint_as_float(mask));
    }
    rec4[2 * j] = q0;
    rec4[2 * j + 1] = q1;
  }
  for (int i = lane; i < nv * fs4; i += 32) {
    const int jj = warp * spw + i / fs4;
    const int q = i % fs4;
    feat4[jj * fs4 + q] = hsl::feat_quad(s_raw + jj * C + 7, 4 * q, F);
  }
}

// Shared memory (bytes) of one K1 block: raw rows of a batch of nb slots,
// two sets of records (rounded up to 32, what a ballot takes) and two
// float4-aligned feature copies.
static int fwd_smem(int C, int nb) {
  const int nbp = (nb + 31) & ~31;
  return (nb * C + 2 * nbp * 8 + 2 * nb * 4 * hsl::feat4_stride(C - 7)) * (int)sizeof(float);
}

template <int MAXF>
__global__ void __launch_bounds__(hsl::FWD_THREADS, hsl::fwd_min_blocks(MAXF))
blend_fwd_kernel(const float* __restrict__ table, const uint8_t* __restrict__ ok,
                 const int* __restrict__ tile_ids, int n_rows, int K, int C, int F, int grid_x,
                 int th, int tw, int spw, float* __restrict__ acc, float* __restrict__ ft,
                 float* __restrict__ med, int* __restrict__ last, int* __restrict__ mslot) {
  extern __shared__ float4 smem4[];
  const int row = blockIdx.x;                              // the table's row
  const int tile = tile_ids ? tile_ids[row] : row;         // the image's tile
  if (tile < 0 || tile >= n_rows) return;                  // no row of the outputs
  const int P = blockDim.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int nb = spw * (P >> 5);   // slots a batch
  const int nbp = (nb + 31) & ~31;
  const int fs4 = hsl::feat4_stride(F);
  float* s_raw = reinterpret_cast<float*>(smem4);  // [nb][C]
  float4* s_rec = smem4 + nb * C / 4;              // [2][nbp][2]
  float4* s_feat = s_rec + 2 * nbp * 2;            // [2][nb][fs4]
  int lx, ly;
  hsl::thread_pixel(p, tw, lx, ly);
  const float tile_x0 = (float)((tile % grid_x) * tw);
  const float tile_y0 = (float)((tile / grid_x) * th);
  const float px = tile_x0 + (float)lx;
  const float py = tile_y0 + (float)ly;
  const float* tab_t = table + (size_t)row * K * C;
  const uint8_t* ok_t = ok + (size_t)row * K;
  float* raw_w = s_raw + warp * spw * C;           // this warp's piece

  // records past nb, which only the ballot reads, hold mask 0
  for (int i = nb + p; i < nbp; i += P) {
    s_rec[2 * i + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
    s_rec[2 * (nbp + i) + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  hsl::Pixel<MAXF> s;
  // slots of this warp's piece of the batch at `base` that lie inside the table
  auto inside = [&](int base) { return max(0, min(spw, K - base - warp * spw)); };
  int nv = inside(0);
  bool okv = lane < nv && ok_t[warp * spw + lane];
  hsl::warp_copy_async(raw_w, tab_t + (size_t)warp * spw * C, nv * C, lane);
  stage_pack(s_raw, s_rec, s_feat, C, F, spw, nv, okv, warp, lane, tile_x0, tile_y0, tw, th);

  for (int base = 0, b = 0; base < K; base += nb, b ^= 1) {
    // batch b is packed and the walk of the batch before is over; the
    // block leaves once every pixel is done
    if (__syncthreads_count(!s.done) == 0) break;
    const bool next = base + nb < K;
    if (next) {
      nv = inside(base + nb);
      const size_t first = (size_t)base + nb + warp * spw;
      okv = lane < nv && ok_t[first + lane];
      hsl::warp_copy_async(raw_w, tab_t + first * C, nv * C, lane);
    }
    hsl::walk_records<MAXF>(s_rec + b * nbp * 2, s_feat + b * nb * fs4, fs4, nbp, base, F, warp,
                            lane, px, py, s);
    if (next)
      stage_pack(s_raw, s_rec + (b ^ 1) * nbp * 2, s_feat + (b ^ 1) * nb * fs4, C, F, spw, nv,
                 okv, warp, lane, tile_x0, tile_y0, tw, th);
  }

  hsl::store_pixel<MAXF>(s, (size_t)tile * P + ly * tw + lx, F, acc, ft, med, last, mslot);
}

template <int MAXF>
__global__ void __launch_bounds__(BWD_THREADS, k2_min_blocks(MAXF)) blend_bwd_kernel(
    const float* __restrict__ table, const uint8_t* __restrict__ ok,
    const int* __restrict__ tile_ids, int n_rows, const float* __restrict__ ft,
    const int* __restrict__ last, const int* __restrict__ mslot, const float* __restrict__ gacc,
    const float* __restrict__ gft, const float* __restrict__ gmed, int K, int C, int F, int grid_x, int th, int tw, int sb,
    float* __restrict__ dtab) {
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

  const int row = blockIdx.x;                              // the table's row
  const int tile = tile_ids ? tile_ids[row] : row;         // the image's tile
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  float* dtab_t = dtab + (size_t)row * K * C;
  if (tile < 0 || tile >= n_rows) {                        // no residuals: a zero gradient
    for (int i = p; i < K * C; i += P) dtab_t[i] = 0.f;
    return;
  }
  const float px = (float)((tile % grid_x) * tw + p % tw);
  const float py = (float)((tile / grid_x) * th + p / tw);
  const float* tab_t = table + (size_t)row * K * C;
  const uint8_t* ok_t = ok + (size_t)row * K;
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
        const float power = hsl::blend_power(g[2], g[3], g[4], dx, dy);  // as K1 rounds it
        if (power <= 0.f) {
          const float ep = expf(power);
          const float alpha = fminf(hsl::ALPHA_MAX, g[5] * ep);
          if (alpha >= hsl::ALPHA_MIN) {
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
            if (alpha < hsl::ALPHA_MAX) {
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
        hsl::warp_zero_store<V>(red, C, lane);
    }
    __syncthreads();  // every warp's sums are in s_red
    for (int i = p; i < n * C; i += P) {
      float v = 0.f;
      for (int w = 0; w < nwarps; ++w) v += s_red[(size_t)w * sb * C + i];
      dtab_t[(size_t)lo * C + i] = v;
    }
  }
}

// The most slots a warp (a multiple of 4: its rows stay 16-byte aligned)
// that the shared-memory budget of F = C - 7 features holds, and the
// block's shared memory then; -1 where even 4 do not fit.
static int fwd_batch(int C, int P, int* spw_out) {
  const int budget = C - 7 > 32 ? K1_WIDE_SMEM_BUDGET : K1_SMEM_BUDGET;
  int spw = 32;
  while (spw > 4 && fwd_smem(C, spw * (P / 32)) > budget) spw /= 2;
  *spw_out = spw;
  const int smem = fwd_smem(C, spw * (P / 32));
  return smem > budget ? -1 : smem;
}

// The arguments of a launch, as the C entry points take them.
struct Launch {
  const float* table;
  const uint8_t* ok;
  const int* tile_ids;
  int n_rows, T, K, C, grid_x, th, tw;
  cudaStream_t stream;
};

// Calls fn(std::integral_constant<int, MAXF>) for F's feature bucket
// (fwd.cuh); an error above the widest.
template <class Fn>
static int by_bucket(int F, Fn fn) {
  if (F <= 3) return (int)fn(std::integral_constant<int, 3>{});
  if (F <= 29) return (int)fn(std::integral_constant<int, 29>{});
  if (F <= 32) return (int)fn(std::integral_constant<int, 32>{});
  if (F <= hsl::MAX_FEATURES) return (int)fn(std::integral_constant<int, hsl::MAX_FEATURES>{});
  return (int)cudaErrorInvalidValue;
}

template <int MAXF>
static cudaError_t launch_fwd(const Launch& a, float* acc, float* ft, float* med, int* last,
                              int* mslot) {
  const int P = a.th * a.tw;
  int spw = 0;
  const int smem = fwd_batch(a.C, P, &spw);
  if (smem < 0) return cudaErrorInvalidValue;
  static int granted[hsl::MAX_DEVICES] = {};
  const cudaError_t e = hsl::grant_smem(blend_fwd_kernel<MAXF>, smem, granted);
  if (e != cudaSuccess) return e;
  blend_fwd_kernel<MAXF><<<a.T, P, smem, a.stream>>>(a.table, a.ok, a.tile_ids, a.n_rows, a.K,
                                                     a.C, a.C - 7, a.grid_x, a.th, a.tw, spw, acc,
                                                     ft, med, last, mslot);
  return cudaGetLastError();
}

// Shared memory (bytes) of one K2 block for C columns, P pixels, batch sb.
static int bwd_smem(int C, int P, int sb) {
  const int CP = C - 7 > 3 ? (C + 3) & ~3 : C;  // the kernel's slot stride
  return sb * (CP + C * (P / 32)) * (int)sizeof(float);
}

template <int MAXF>
static cudaError_t launch_bwd(const Launch& a, const float* ft, const int* last, const int* mslot,
                              const float* gacc, const float* gft, const float* gmed, int sb,
                              float* dtab) {
  const int P = a.th * a.tw;
  blend_bwd_kernel<MAXF><<<a.T, P, bwd_smem(a.C, P, sb), a.stream>>>(
      a.table, a.ok, a.tile_ids, a.n_rows, ft, last, mslot, gacc, gft, gmed, a.K, a.C, a.C - 7,
      a.grid_x, a.th, a.tw, sb, dtab);
  return cudaGetLastError();
}

extern "C" {

// Largest feature count the kernels take (F = C - 7): the configs carry 3
// (colour), 19, 29 and 77 (colour and 16, 26 or 74 semantic channels).
int blend_max_features() { return hsl::MAX_FEATURES; }

// Shared memory (bytes) of one K1 block for C columns and P pixels, -1
// where no batch fits its budget.
int blend_fwd_smem(int C, int P) {
  int spw = 0;
  return fwd_batch(C, P, &spw);
}

// Shared memory (bytes) of one K2 block for C columns, P pixels, batch sb.
int blend_bwd_smem(int C, int P, int sb) { return bwd_smem(C, P, sb); }

// tile_ids: null (row b is tile b), or T int32 tile ids of the grid (see
// the top of the file); n_rows: the rows of the outputs (K1) and of the
// residuals and cotangents (K2).  A tile id outside [0, n_rows) writes no
// output and gets a zero gradient.
int blend_fwd(const float* table, const uint8_t* ok, const int* tile_ids, int n_rows, int T,
              int K, int C, int grid_x, int th, int tw, float* acc, float* ft, float* med,
              int* last, int* mslot, void* stream) {
  if (th * tw > hsl::FWD_THREADS || !hsl::block_layout(tw, th))
    return (int)cudaErrorInvalidValue;
  const Launch a{table, ok, tile_ids, n_rows, T, K, C, grid_x, th, tw,
                 reinterpret_cast<cudaStream_t>(stream)};
  return by_bucket(C - 7, [&](auto b) {
    return launch_fwd<decltype(b)::value>(a, acc, ft, med, last, mslot);
  });
}

int blend_bwd(const float* table, const uint8_t* ok, const int* tile_ids, int n_rows,
              const float* ft, const int* last, const int* mslot, const float* gacc,
              const float* gft, const float* gmed, int T, int K, int C, int grid_x, int th, int tw,
              int sb, float* dtab, void* stream) {
  if (th * tw > BWD_THREADS) return (int)cudaErrorInvalidValue;
  const Launch a{table, ok, tile_ids, n_rows, T, K, C, grid_x, th, tw,
                 reinterpret_cast<cudaStream_t>(stream)};
  return by_bucket(C - 7, [&](auto b) {
    return launch_bwd<decltype(b)::value>(a, ft, last, mslot, gacc, gft, gmed, sb, dtab);
  });
}

}  // extern "C"
