// Stream blend forward (K3) and backward (K4) for Hopper (sm_90a).
//
// K3 replaces hierslam_tpu/ops/render_stream.py::_fwd_kernel (launched by
// _run_fwd), K4 replaces ::_bwd_kernel (_run_bwd, the VJP of blend_stream).
// Plain C interface, loaded with ctypes by hierslam_torch/ops/kernels.py;
// the wrappers there allocate every output (K4's d stream zero-filled), pass
// PyTorch's current stream and check the launch error this returns.
//
// Input: the ragged pair stream [R, 128, C] float32, C = 5 + F columns per
// pair (world mean x y z, isotropic log scale, opacity logit, F features),
// pairs in depth order within a tile; tile t owns rows row_off[t] ..
// row_off[t+1].  Pad pairs point at a sentinel row (logit -100), whose
// opacity 3.7e-44 never passes alpha >= 1/255.  The pose and projection
// constants come as 28 floats in device memory (ops/render_stream.py
// make_scalars: R row-major, t, full_proj rows 0, 1, 3, fx, fy,
// 1.3 tan fovx, 1.3 tan fovy), so the caller needs no host sync for them.
//
// Built with -fmad=false (ops/kernels.py): the projection and the alpha are
// written in the operation order of the plain PyTorch version
// (render_stream.project_pairs, render_xla.blend_terms), so the discrete
// decisions -- the rect test against the tile, alpha >= 1/255, the T >= 1e-4
// cutoff -- round as the plain version does instead of moving with FMA
// contraction.
//
// K3 design: one block per tile, one thread per pixel, a warp an 8 x 4
// block of pixels (cull.cuh).  What bounds it is the work per (warp, pair): a
// warp pays a pair's test (two shared loads, the quadratic form, an exp,
// three branches) when one lane needs it, and the commit's F + 2 sums when
// one lane commits -- far above the bytes (each row is read once per
// block) and the 12 operations a pair the roofline counts.  So the design
// removes (warp, pair) visits and instructions per visit:
// - the projection writes into each pair's screen record the warps its
//   footprint can reach (cull.cuh: the box of the alpha >= 1/255 ellipse
//   against each warp's pixel block), and a warp visits only the pairs
//   that hold its bit, found with one ballot per 32 pairs (fwd.cuh
//   walk_records): a pad, an invalid pair or one that misses the warp
//   costs no load and no branch;
// - a commit reads its features as float4 from a 16-byte-aligned copy
//   (8 loads at F = 29 where 29 were) and sums with explicit fused
//   multiply-adds; the tests (power, alpha, T) keep the plain version's
//   operation order under -fmad=false;
// - rows are pipelined with one barrier a row: each of warps 0-3 brings
//   its 32 pairs of row r + 1 into shared memory with cp.async while the
//   block walks row r, then projects them into the other of two record
//   and feature buffers.  A warp copies and projects only its own piece of
//   the raw row, so the raw buffer needs no second copy and no barrier of
//   its own (58 KB a block at F = 29, 3 blocks an SM).
// A pixel stops at the first pair that would take T below 1e-4 and the
// block retires at the row barrier once all its pixels have -- which the
// TPU kernel cannot do.  Saved per pixel for K4: final T, the stream
// position of the last committed pair and that of the median (T = 0.5)
// crossing, -1 if none.  A tile with no rows writes acc 0, T 1, median 15.
// Not taken: wgmma for the feature sum acc[pixel, f] += w[pixel, pair]
// feat[pair, f].  Float32 would need three TF32 products, and w is sparse:
// on the first mapping stream of the flagship run a pixel commits 4.4% of
// the pair positions it walks (chip_smoke.py prints blended / positions),
// so a dense 256 x 128 x F product a row would do about twenty times the
// multiply-adds the commits do, three times over.
//
// K4 design: one block per tile, one thread per pixel, rows back to front
// from the row holding the tile's largest last-committed position.  Each
// row is loaded (float4) and projected once: threads 0-127 write the screen
// record the pixels read (two float4 a pair), a float4-aligned copy of the
// features and the projection terms the chain step reads (18 floats a
// pair) to shared memory; the raw row is then dead and the reduction's
// buffer takes its place.  Each pixel recovers T before each pair as
// T_after / (1 - a) from K3's final T (one approximate reciprocal: no
// discrete test reads T) and takes every discrete choice from K3: which
// pairs commit (position <= its last) and where the median cotangent lands
// (K3's median position; it is not re-derived from the recovered T, which
// near 0.5 can fall on the other side).  Per pair, the 7 + F per-pixel
// terms (screen x, y, conic a b c, opacity, depth with the median term,
// features) are summed over the tile's pixels: a warp reduce-scatter
// (reduce.cuh: 38 shuffles at F = 29 where a butterfly per value took 180,
// 14 at F = 3 against 50) leaves the warp's sums spread over its lanes,
// which store them to shared memory, and one pass over the warps finishes
// them, in batches of sb pairs (no atomics: each tile owns its rows of the
// output).  A warp with no active pixel on a pair stores zeros; a batch no
// pixel of the tile is active in skips the pass over the warps (its gain is
// within the spread of timings, but without it ptxas spills 8 bytes at
// F <= 29 under the 80-register cap).  Threads
// 0-127 then chain each pair's screen-space gradient to the raw columns,
// following render_stream.py:422-479: conic -> cov2d -> J -> camera mean
// (zero outside the strict fov clamp) and the projective xy -> R^T to the
// world mean; 2 s^2 g_s2 to the log scale; sigmoid' to the logit.  No pose
// gradient.  Rows past the tile's last committed pair are not written: the
// wrapper's zero fill leaves them, the pad rows and everything past
// row_off[T] at 0.
// What bounds it: issue per (pixel, pair) walked, and the shared-memory
// pipe that shuffles and shared loads both use -- the reduce-scatter's
// shuffles, selects and adds (~4 per value), the feature loads and the
// suffix-sum and term arithmetic (~3 F + 40 operations, without FMA
// contraction) -- against a memory bound below 0.3 ms.  So the design cuts
// shuffles (reduce-scatter), shared loads (float4 records and features) and
// address arithmetic (pointers stepped down with the pair), and raises
// occupancy: the feature cotangents and terms are register arrays sized by
// the feature bucket (F <= 3, F <= 29, F <= 32), and the wide buckets keep
// the median position and cotangent in shared memory, which lets F <= 29
// fit 3 blocks of 256 (80 registers) an SM with no spill (k4_min_blocks).
//
// The wide bucket (33 <= F <= 128, fwd.cuh MAX_FEATURES) runs the same code
// with 128-float register arrays at one block an SM (up to 255 registers):
// K3's accumulator, K4's cotangents.  Loops over features stop at F, and
// K4's reduce-scatter skips the chunks past 7 + F (reduce.cuh).  Shared
// memory grows with C: K3 129 KB at F = 77 (207 KB at F = 128); K4 100 KB
// at F = 77, whose reduction buffer of up to 15 pairs fits in the dead raw
// row (ops/kernels.py bwd_batch).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fwd.cuh"
#include "reduce.cuh"

#define RW 128       // pairs per stream row
#define NSC 28       // pose + projection scalars
#define NSCR 8       // screen record: x y a b c opacity depth, warp mask (cull.cuh)
#define ND 7         // screen-space gradient terms per pair
#define BWD_THREADS 256  // most pixels a tile K4 takes
// K4 blocks an SM must hold, which sets the register cap (65,536 / (256 x
// blocks), rounded down to 8): 3 (80 registers) for the buckets that fit
// that with no spill, F <= 3 and F <= 29; 2 (up to 128) for F <= 32, which
// spills 8 bytes at 80; 1 (up to 255) for the wide bucket.
__host__ __device__ constexpr int k4_min_blocks(int maxf) {
  return maxf <= 29 ? 3 : maxf <= 32 ? 2 : 1;
}

// Projection terms the chain step reads, [NCH][RW] in shared memory.
enum {
  CH_A, CH_B, CH_C, CH_DET, CH_DETI, CH_J00, CH_J02, CH_J11, CH_J12, CH_S2, CH_INVZ, CH_TXC,
  CH_TYC, CH_MCX, CH_MCY, CH_PW, CH_PHX, CH_PHY, NCH
};

struct Proj {
  float px, py, ca, cb, cc, opa, dep;
  bool valid;
  unsigned mask;  // warps of the tile the pair can reach, 0 if not valid
  float mcx, mcy, ph_x, ph_y, p_w, inv_z, txc, tyc, j00, j02, j11, j12, s2;
  float cxx, cxy, cyy, det, det_inv;
};

// In-kernel projection of one raw pair (render_stream.py _project_row and
// _screen_quantities), shared by K3 and K4.  K3 asks for the footprint cull
// (CULL); K4, which tests only whether a pair is valid, gets mask 1 for one.
template <bool CULL>
__device__ __forceinline__ Proj project_pair(const float* g, const float* sc, float img_w,
                                             float img_h, float tile_x, float tile_y,
                                             float th, float tw) {
  Proj o;
  const float mx = g[0], my = g[1], mz = g[2], logs = g[3], logit = g[4];
  o.mcx = sc[0] * mx + sc[1] * my + sc[2] * mz + sc[9];
  o.mcy = sc[3] * mx + sc[4] * my + sc[5] * mz + sc[10];
  const float mcz = sc[6] * mx + sc[7] * my + sc[8] * mz + sc[11];
  const bool in_front = mcz > 0.2f;
  o.ph_x = sc[12] * o.mcx + sc[13] * o.mcy + sc[14] * mcz + sc[15];
  o.ph_y = sc[16] * o.mcx + sc[17] * o.mcy + sc[18] * mcz + sc[19];
  const float ph_w = sc[20] * o.mcx + sc[21] * o.mcy + sc[22] * mcz + sc[23];
  o.p_w = 1.0f / (ph_w + 1e-7f);
  o.px = ((o.ph_x * o.p_w + 1.0f) * img_w - 1.0f) * 0.5f;
  o.py = ((o.ph_y * o.p_w + 1.0f) * img_h - 1.0f) * 0.5f;

  const float fx = sc[24], fy = sc[25], limx = sc[26], limy = sc[27];
  const float safe_z = (mcz == 0.0f) ? 1.0f : mcz;
  o.inv_z = 1.0f / safe_z;
  o.txc = fminf(fmaxf(o.mcx * o.inv_z, -limx), limx);
  o.tyc = fminf(fmaxf(o.mcy * o.inv_z, -limy), limy);
  o.j00 = fx * o.inv_z;
  o.j02 = -fx * o.txc * o.inv_z;
  o.j11 = fy * o.inv_z;
  o.j12 = -fy * o.tyc * o.inv_z;
  const float s = expf(logs);
  o.s2 = s * s;
  o.cxx = o.s2 * (o.j00 * o.j00 + o.j02 * o.j02) + 0.3f;
  o.cxy = o.s2 * (o.j02 * o.j12);
  o.cyy = o.s2 * (o.j11 * o.j11 + o.j12 * o.j12) + 0.3f;
  o.det = o.cxx * o.cyy - o.cxy * o.cxy;
  const bool det_ok = o.det != 0.0f;
  o.det_inv = 1.0f / (det_ok ? o.det : 1.0f);
  o.ca = o.cyy * o.det_inv;
  o.cb = -o.cxy * o.det_inv;
  o.cc = o.cxx * o.det_inv;

  const float mid = 0.5f * (o.cxx + o.cyy);
  const float sq = sqrtf(fmaxf(0.1f, mid * mid - o.det));
  const float radius = ceilf(3.0f * sqrtf(fmaxf(mid + sq, mid - sq)));
  const float rminx = floorf((o.px - radius) / tw);
  const float rminy = floorf((o.py - radius) / th);
  const float rmaxx = floorf((o.px + radius + tw - 1.0f) / tw);
  const float rmaxy = floorf((o.py + radius + th - 1.0f) / th);
  const bool rect_ok = (tile_x >= rminx) && (tile_x < rmaxx) && (tile_y >= rminy) &&
                       (tile_y < rmaxy);
  o.opa = 1.0f / (1.0f + expf(-logit));
  o.dep = mcz;
  o.valid = in_front && det_ok && rect_ok;
  o.mask = !o.valid ? 0u
           : CULL   ? hsl::warp_mask(o.px, o.py, o.cxx, o.cyy, o.opa, tile_x * tw, tile_y * th,
                                     (int)tw, (int)th)
                    : 1u;
  return o;
}

// Copy one stream row (RW * C floats, 16-byte aligned) into shared memory.
__device__ __forceinline__ void load_row(const float* __restrict__ src, float* dst, int C,
                                         int p, int P) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = p; i < RW * C / 4; i += P) d4[i] = s4[i];
}

// Feature stride of K4's shared copy: F padded to a float4, plus one float4
// so that the 128-bit stores of 8 neighbouring pairs fall in distinct banks.
__host__ __device__ constexpr int feat_stride(int F) { return ((F + 3) & ~3) + 4; }

// The screen record of one projected pair, two float4.
__device__ __forceinline__ void store_record(float4* scr4, int j, const Proj& q) {
  scr4[2 * j] = make_float4(q.px, q.py, q.ca, q.cb);
  scr4[2 * j + 1] = make_float4(q.cc, q.opa, q.dep, __uint_as_float(q.mask));
}

// K4: threads 0..RW-1 project the row's pairs into the shared screen records
// ([RW][NSCR], read as two float4 a pair), the chain step's terms and a
// float4-aligned copy of the features (pads 0).
__device__ __forceinline__ void project_row(const float* s_row, const float* s_sc, float* s_scr,
                                            float* s_chn, float* s_feat, int C, int p,
                                            float img_w, float img_h, float tile_x,
                                            float tile_y, float th, float tw) {
  if (p < RW) {
    const float* g = s_row + p * C;
    const Proj q = project_pair<false>(g, s_sc, img_w, img_h, tile_x, tile_y, th, tw);
    store_record(reinterpret_cast<float4*>(s_scr), p, q);
    const int F = C - 5;
    float4* f4 = reinterpret_cast<float4*>(s_feat + p * feat_stride(F));
    for (int c = 0; c < F; c += 4) f4[c / 4] = hsl::feat_quad(g + 5, c, F);
    s_chn[CH_A * RW + p] = q.cxx;
    s_chn[CH_B * RW + p] = q.cxy;
    s_chn[CH_C * RW + p] = q.cyy;
    s_chn[CH_DET * RW + p] = q.det;
    s_chn[CH_DETI * RW + p] = q.det_inv;
    s_chn[CH_J00 * RW + p] = q.j00;
    s_chn[CH_J02 * RW + p] = q.j02;
    s_chn[CH_J11 * RW + p] = q.j11;
    s_chn[CH_J12 * RW + p] = q.j12;
    s_chn[CH_S2 * RW + p] = q.s2;
    s_chn[CH_INVZ * RW + p] = q.inv_z;
    s_chn[CH_TXC * RW + p] = q.txc;
    s_chn[CH_TYC * RW + p] = q.tyc;
    s_chn[CH_MCX * RW + p] = q.mcx;
    s_chn[CH_MCY * RW + p] = q.mcy;
    s_chn[CH_PW * RW + p] = q.p_w;
    s_chn[CH_PHX * RW + p] = q.ph_x;
    s_chn[CH_PHY * RW + p] = q.ph_y;
  }
}

// K3: warp w < RW / 32 starts the copy of its 32 pairs of stream row r into
// its piece of the raw buffer ...
__device__ __forceinline__ void stage_copy(const float* __restrict__ stream, float* s_raw, int r,
                                           int C, int warp, int lane) {
  hsl::warp_copy_async(s_raw + warp * 32 * C, stream + ((size_t)r * RW + warp * 32) * C, 32 * C,
                       lane);
}

// ... and, once they have arrived, projects them into screen records
// rec4 [RW][2] and copies their features to feat4 [RW][fs4].
__device__ __forceinline__ void stage_project(const float* s_raw, const float* s_sc, float4* rec4,
                                              float4* feat4, int C, int warp, int lane,
                                              float img_w, float img_h, float tile_x,
                                              float tile_y, float th, float tw) {
  hsl::warp_copy_wait();
  const int F = C - 5;
  const int fs4 = hsl::feat4_stride(F);
  const int j = warp * 32 + lane;
  store_record(rec4, j,
               project_pair<true>(s_raw + j * C, s_sc, img_w, img_h, tile_x, tile_y, th, tw));
  for (int i = lane; i < 32 * fs4; i += 32) {
    const int jj = warp * 32 + i / fs4;
    const int q = i % fs4;
    feat4[jj * fs4 + q] = hsl::feat_quad(s_raw + jj * C + 5, 4 * q, F);
  }
}

// Shared memory (bytes) of one K3 block for C columns: the raw row, two
// sets of records and two float4-aligned feature copies.
static int fwd_smem(int C) {
  return (RW * C + 2 * RW * NSCR + 2 * RW * 4 * hsl::feat4_stride(C - 5)) * (int)sizeof(float);
}

template <int MAXF>
__global__ void __launch_bounds__(hsl::FWD_THREADS, hsl::fwd_min_blocks(MAXF))
stream_fwd_kernel(const float* __restrict__ stream, const float* __restrict__ scal,
                  const int* __restrict__ row_off, int R, int C, int grid_x, int th, int tw,
                  float img_w, float img_h, float* __restrict__ acc, float* __restrict__ ft,
                  float* __restrict__ med, int* __restrict__ last, int* __restrict__ mpos) {
  extern __shared__ float4 smem4[];
  const int F = C - 5;
  const int fs4 = hsl::feat4_stride(F);
  float* s_raw = reinterpret_cast<float*>(smem4);  // [RW][C]
  float4* s_rec = smem4 + RW * C / 4;              // [2][RW][2]
  float4* s_feat = s_rec + 2 * RW * 2;             // [2][RW][fs4]
  __shared__ float s_sc[NSC];
  const int tile = blockIdx.x;
  const int P = blockDim.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  if (p < NSC) s_sc[p] = scal[p];
  const int r0 = row_off[tile];
  const int r1 = min(row_off[tile + 1], R);
  const float tile_x = (float)(tile % grid_x);
  const float tile_y = (float)(tile / grid_x);
  int lx, ly;
  hsl::thread_pixel(p, tw, lx, ly);
  const float px = (float)((tile % grid_x) * tw + lx);
  const float py = (float)((tile / grid_x) * th + ly);
  const bool stager = warp < RW / 32;  // warps 0-3 bring the rows in

  hsl::Pixel<MAXF> s;
  if (stager && r0 < r1) stage_copy(stream, s_raw, r0, C, warp, lane);
  __syncthreads();  // the scalars are in shared memory
  if (stager && r0 < r1)
    stage_project(s_raw, s_sc, s_rec, s_feat, C, warp, lane, img_w, img_h, tile_x, tile_y,
                  (float)th, (float)tw);

  for (int r = r0; r < r1; ++r) {
    const int b = (r - r0) & 1;
    // row r is projected and the walk of row r - 1 is over; the block
    // leaves once every pixel is done
    if (__syncthreads_count(!s.done) == 0) break;
    const bool next = stager && r + 1 < r1;
    if (next) stage_copy(stream, s_raw, r + 1, C, warp, lane);
    hsl::walk_records<MAXF>(s_rec + b * RW * 2, s_feat + b * RW * fs4, fs4, RW, r * RW, F, warp,
                            lane, px, py, s);
    if (next)
      stage_project(s_raw, s_sc, s_rec + (b ^ 1) * RW * 2, s_feat + (b ^ 1) * RW * fs4, C, warp,
                    lane, img_w, img_h, tile_x, tile_y, (float)th, (float)tw);
  }

  hsl::store_pixel<MAXF>(s, (size_t)tile * P + ly * tw + lx, F, acc, ft, med, last, mpos);
}

template <int MAXF>
__global__ void __launch_bounds__(BWD_THREADS, k4_min_blocks(MAXF))
stream_bwd_kernel(const float* __restrict__ stream, const float* __restrict__ scal,
                  const int* __restrict__ row_off, int R, int C, int grid_x, int th, int tw,
                  float img_w, float img_h, const float* __restrict__ ft,
                  const int* __restrict__ last, const int* __restrict__ mpos,
                  const float* __restrict__ gacc, const float* __restrict__ gft,
                  const float* __restrict__ gmed, int sb, float* __restrict__ dtab) {
  constexpr int V = ND + MAXF;                     // terms summed per pair (bucket)
  extern __shared__ float4 smem4[];
  const int F = C - 5;
  const int NR = ND + F;                           // terms stored per pair
  const int P = blockDim.x;
  const int nwarps = P / 32;
  const int FS = feat_stride(F);
  // the raw row is dead once projected: the reduction's buffer takes its place
  float* s_row = reinterpret_cast<float*>(smem4);  // [RW][C] until projected
  float* s_red = s_row;                            // [nwarps][sb][NR] after
  float* s_feat = s_row + max(RW * C, (nwarps * sb * NR + 3) & ~3);  // [RW][FS]
  float* s_scr = s_feat + RW * FS;                 // [RW][NSCR]
  float* s_chn = s_scr + NSCR * RW;                // [NCH][RW]
  float* s_d = s_chn + NCH * RW;                   // [RW][ND]
  const float4* scr4 = reinterpret_cast<const float4*>(s_scr);
  __shared__ float s_sc[NSC];
  __shared__ int s_maxlast;
  // the wide buckets keep each pixel's median position and cotangent out of
  // registers, which is what lets F <= 29 fit 80; at F <= 3 registers are
  // cheaper than the shared load per pair
  constexpr bool MED_SHARED = MAXF > 3;
  __shared__ int s_mpos[BWD_THREADS];
  __shared__ float s_gmed[BWD_THREADS];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  if (p < NSC) s_sc[p] = scal[p];
  const float px = (float)((tile % grid_x) * tw + p % tw);
  const float py = (float)((tile / grid_x) * th + p / tw);
  const size_t pix = (size_t)tile * P + p;

  float ga[MAXF];
#pragma unroll
  for (int c = 0; c < MAXF; ++c) ga[c] = (c < F) ? gacc[pix * (F + 2) + c] : 0.f;
  const float ga_dep = gacc[pix * (F + 2) + F];
  const float ga_mass = gacc[pix * (F + 2) + F + 1];
  const float T_final = ft[pix];
  const float gTT = gft[pix] * T_final;
  const int mylast = last[pix];
  const int mymed = MED_SHARED ? -1 : mpos[pix];
  const float gm = MED_SHARED ? 0.f : gmed[pix];
  if (MED_SHARED) {
    s_mpos[p] = mpos[pix];
    s_gmed[p] = gmed[pix];
  }

  if (p == 0) s_maxlast = -1;
  __syncthreads();
  atomicMax(&s_maxlast, mylast);
  __syncthreads();
  const int maxl = s_maxlast;
  if (maxl < 0) return;  // block-uniform: nothing committed in this tile
  const int r_top = min(maxl / RW, R - 1);

  float T = T_final;
  float S = 0.f;
  // the tile's first row and its grid coordinates are read again where used,
  // not held in registers across the walk
  for (int r = r_top; r >= row_off[tile]; --r) {
    __syncthreads();  // the previous row's chain step has read s_chn / s_d
    load_row(stream + (size_t)r * RW * C, s_row, C, p, P);
    __syncthreads();
    project_row(s_row, s_sc, s_scr, s_chn, s_feat, C, p, img_w, img_h,
                (float)(tile % grid_x), (float)(tile / grid_x), (float)th, (float)tw);
    __syncthreads();
    for (int hi = RW - 1; hi >= 0; hi -= sb) {
      const int lo = max(0, hi - sb + 1);
      const int n = hi - lo + 1;
      bool busy = false;  // a pixel of this warp is active in the batch
      // the pair's screen record and this warp's sums for it, stepped down
      // with jj
      const float4* q4 = scr4 + 2 * hi;
      float* red = s_red + ((size_t)warp * sb + n - 1) * NR;
      for (int jj = n - 1; jj >= 0; --jj, q4 -= 2, red -= NR) {
        const int j = lo + jj;
        const int pos = r * RW + j;
        // the pair's terms for this pixel, 0 where it does not commit
        float g[ND] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        float w = 0.f;
        bool act = false;
        const float4 q0 = q4[0];  // x y a b
        const float4 q1 = q4[1];  // c opacity depth mask
        if (pos <= mylast && __float_as_uint(q1.w) != 0u) {
          const float ca = q0.z, cb = q0.w, cc = q1.x;
          const float dx = q0.x - px;
          const float dy = q0.y - py;
          const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
          if (power <= 0.f) {
            const float ep = expf(power);
            const float alpha = fminf(hsl::ALPHA_MAX, q1.y * ep);
            if (alpha >= hsl::ALPHA_MIN) {
              act = true;
              const float4* f4 = reinterpret_cast<const float4*>(s_feat + j * FS);
              const float dep = q1.z;
              const float u = 1.f - alpha;
              // one reciprocal for both quotients, to 2 ulp: no discrete test reads T
              const float inv_u = __fdividef(1.f, u);
              const float Tb = T * inv_u;
              // continuous terms: FMA is taken explicitly here (the build
              // contracts nothing, for the discrete tests above)
              float s = __fmaf_rn(ga_dep, dep, ga_mass);
#pragma unroll
              for (int c = 0; c < MAXF; c += 4) {
                if (c < F) {  // pads past F are 0, as ga is
                  const float4 v = f4[c / 4];
                  s = __fmaf_rn(ga[c], v.x, s);
                  if (c + 1 < MAXF) s = __fmaf_rn(ga[c + 1], v.y, s);
                  if (c + 2 < MAXF) s = __fmaf_rn(ga[c + 2], v.z, s);
                  if (c + 3 < MAXF) s = __fmaf_rn(ga[c + 3], v.w, s);
                }
              }
              w = alpha * Tb;
              const float da = s * Tb - (S + gTT) * inv_u;
              S = __fmaf_rn(s, w, S);
              float dopa = 0.f, dpow = 0.f;
              if (alpha < hsl::ALPHA_MAX) {
                dopa = ep * da;
                dpow = alpha * da;
              }
              g[0] = dpow * (-(ca * dx + cb * dy));
              g[1] = dpow * (-(cc * dy + cb * dx));
              g[2] = -0.5f * dx * dx * dpow;
              g[3] = -dx * dy * dpow;
              g[4] = -0.5f * dy * dy * dpow;
              g[5] = dopa;
              if (MED_SHARED)
                g[6] = ga_dep * w + (pos == s_mpos[p] ? s_gmed[p] : 0.f);
              else
                g[6] = ga_dep * w + (pos == mymed ? gm : 0.f);
              T = Tb;
            }
          }
        }
        if (__any_sync(hsl::FULL_MASK, act)) {
          busy = true;
          hsl::warp_sum_store<V>(
              [&](int c) { return c < ND ? g[c] : (c - ND < MAXF ? ga[c - ND] * w : 0.f); },
              red, NR, lane);
        } else {
          hsl::warp_zero_store<V>(red, NR, lane);
        }
      }
      if (__syncthreads_or(busy)) {
        for (int i = p; i < n * NR; i += P) {
          float v = 0.f;
          for (int w = 0; w < nwarps; ++w) v += s_red[(size_t)w * sb * NR + i];
          const int j = lo + i / NR;
          const int c = i % NR;
          if (c < ND)
            s_d[j * ND + c] = v;
          else
            dtab[((size_t)r * RW + j) * C + 5 + (c - ND)] = v;
        }
      } else {
        // no pixel of the tile is active in the batch: its features stay at
        // the wrapper's zero fill
        for (int i = p; i < n * ND; i += P) s_d[lo * ND + i] = 0.f;
      }
      __syncthreads();  // s_red is free for the next batch, s_d is complete
    }

    // chain each pair's screen-space gradient to its raw columns
    if (p < RW) {
      const float* d = s_d + p * ND;
      const float d_px = d[0], d_py = d[1], d_ca = d[2], d_cb = d[3], d_cc = d[4];
      const float d_opa = d[5], d_dep = d[6];
#define CHN(k) s_chn[(k) * RW + p]
      const float A = CHN(CH_A), B = CHN(CH_B), Cc = CHN(CH_C), det = CHN(CH_DET);
      const float j00 = CHN(CH_J00), j02 = CHN(CH_J02), j11 = CHN(CH_J11), j12 = CHN(CH_J12);
      const float s2 = CHN(CH_S2), inv_z = CHN(CH_INVZ), txc = CHN(CH_TXC), tyc = CHN(CH_TYC);
      const float mcx = CHN(CH_MCX), mcy = CHN(CH_MCY), p_w = CHN(CH_PW);
      const float ph_x = CHN(CH_PHX), ph_y = CHN(CH_PHY);
      const float d2 = CHN(CH_DETI) * CHN(CH_DETI);
#undef CHN
      const float opa = s_scr[p * NSCR + 5];
      const float g_A = (-Cc * Cc * d_ca + B * Cc * d_cb - B * B * d_cc) * d2;
      const float g_B = (2.f * B * Cc * d_ca - (det + 2.f * B * B) * d_cb + 2.f * A * B * d_cc) * d2;
      const float g_C = (-B * B * d_ca + A * B * d_cb - A * A * d_cc) * d2;
      const float g_s2 = g_A * (j00 * j00 + j02 * j02) + g_B * (j02 * j12) +
                         g_C * (j11 * j11 + j12 * j12);
      const float g_j00 = g_A * s2 * 2.f * j00;
      const float g_j02 = g_A * s2 * 2.f * j02 + g_B * s2 * j12;
      const float g_j11 = g_C * s2 * 2.f * j11;
      const float g_j12 = g_C * s2 * 2.f * j12 + g_B * s2 * j02;
      const float fx = s_sc[24], fy = s_sc[25], limx = s_sc[26], limy = s_sc[27];
      const float g_txc = -fx * inv_z * g_j02;
      const float g_tyc = -fy * inv_z * g_j12;
      float g_inv_z = fx * g_j00 + fy * g_j11 - fx * txc * g_j02 - fy * tyc * g_j12;
      // txc = clip(mcx / z): no gradient outside the fov limits (strict)
      const bool in_x = fabsf(mcx * inv_z) < limx;
      const bool in_y = fabsf(mcy * inv_z) < limy;
      float g_mcx = in_x ? inv_z * g_txc : 0.f;
      float g_mcy = in_y ? inv_z * g_tyc : 0.f;
      g_inv_z = g_inv_z + ((in_x ? mcx * g_txc : 0.f) + (in_y ? mcy * g_tyc : 0.f));
      float g_mcz = -inv_z * inv_z * g_inv_z;
      const float W2 = img_w * 0.5f, H2 = img_h * 0.5f;
      const float g_phx = d_px * W2 * p_w;
      const float g_phy = d_py * H2 * p_w;
      const float g_pw = d_px * W2 * ph_x + d_py * H2 * ph_y;
      const float g_phw = -g_pw * p_w * p_w;
      g_mcx = g_mcx + s_sc[12] * g_phx + s_sc[16] * g_phy + s_sc[20] * g_phw;
      g_mcy = g_mcy + s_sc[13] * g_phx + s_sc[17] * g_phy + s_sc[21] * g_phw;
      g_mcz = g_mcz + s_sc[14] * g_phx + s_sc[18] * g_phy + s_sc[22] * g_phw;
      g_mcz = g_mcz + d_dep;
      float* out = dtab + ((size_t)r * RW + p) * C;
      out[0] = s_sc[0] * g_mcx + s_sc[3] * g_mcy + s_sc[6] * g_mcz;
      out[1] = s_sc[1] * g_mcx + s_sc[4] * g_mcy + s_sc[7] * g_mcz;
      out[2] = s_sc[2] * g_mcx + s_sc[5] * g_mcy + s_sc[8] * g_mcz;
      out[3] = 2.f * s2 * g_s2;
      out[4] = d_opa * opa * (1.f - opa);
    }
  }
}

template <int MAXF>
static cudaError_t launch_fwd(const float* stream, const float* sc, const int* row_off, int T,
                              int R, int C, int grid_x, int th, int tw, float img_w,
                              float img_h, float* acc, float* ft, float* med, int* last,
                              int* mpos, cudaStream_t s) {
  const int smem = fwd_smem(C);
  static int granted[hsl::MAX_DEVICES] = {};
  const cudaError_t e = hsl::grant_smem(stream_fwd_kernel<MAXF>, smem, granted);
  if (e != cudaSuccess) return e;
  stream_fwd_kernel<MAXF><<<T, th * tw, smem, s>>>(stream, sc, row_off, R, C, grid_x, th, tw,
                                                   img_w, img_h, acc, ft, med, last, mpos);
  return cudaGetLastError();
}

// Shared memory (bytes) of one K4 block for C columns, P pixels, batch sb.
static int bwd_smem(int C, int P, int sb) {
  const int red = ((P / 32) * sb * (ND + C - 5) + 3) & ~3;
  return ((RW * C > red ? RW * C : red) + RW * feat_stride(C - 5) + (NSCR + NCH + ND) * RW) *
         (int)sizeof(float);
}

template <int MAXF>
static cudaError_t launch_bwd(const float* stream, const float* sc, const int* row_off,
                              const float* ft, const int* last, const int* mpos,
                              const float* gacc, const float* gft, const float* gmed, int T,
                              int R, int C, int grid_x, int th, int tw, float img_w,
                              float img_h, int sb, float* dtab, cudaStream_t s) {
  const int P = th * tw;
  const int smem = bwd_smem(C, P, sb);
  static int granted[hsl::MAX_DEVICES] = {};
  const cudaError_t e = hsl::grant_smem(stream_bwd_kernel<MAXF>, smem, granted);
  if (e != cudaSuccess) return e;
  stream_bwd_kernel<MAXF><<<T, P, smem, s>>>(
      stream, sc, row_off, R, C, grid_x, th, tw, img_w, img_h, ft, last, mpos, gacc, gft, gmed,
      sb, dtab);
  return cudaGetLastError();
}

extern "C" {

// Largest feature count the kernels take (F = C - 5): the configs carry 3
// (colour), 19, 29 and 77 (colour and 16, 26 or 74 semantic channels).
int stream_max_features() { return hsl::MAX_FEATURES; }

// Shared memory (bytes) of one K3 block for C columns.
int stream_fwd_smem(int C) { return fwd_smem(C); }

// Shared memory (bytes) of one K4 block for C columns, P pixels, batch sb.
int stream_bwd_smem(int C, int P, int sb) { return bwd_smem(C, P, sb); }

int stream_fwd(const float* stream, const float* sc, const int* row_off, int T, int R, int C,
               int grid_x, int th, int tw, float img_w, float img_h, float* acc, float* ft,
               float* med, int* last, int* mpos, void* cu_stream) {
  const int F = C - 5;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(cu_stream);
  if (th * tw > hsl::FWD_THREADS || th * tw < RW || !hsl::block_layout(tw, th))
    return (int)cudaErrorInvalidValue;
  // feature buckets (fwd.cuh)
  if (F >= 0 && F <= 3)
    return launch_fwd<3>(stream, sc, row_off, T, R, C, grid_x, th, tw, img_w, img_h, acc, ft,
                         med, last, mpos, s);
  if (F >= 0 && F <= 29)
    return launch_fwd<29>(stream, sc, row_off, T, R, C, grid_x, th, tw, img_w, img_h, acc, ft,
                          med, last, mpos, s);
  if (F >= 0 && F <= 32)
    return launch_fwd<32>(stream, sc, row_off, T, R, C, grid_x, th, tw, img_w, img_h, acc, ft,
                          med, last, mpos, s);
  if (F >= 0 && F <= hsl::MAX_FEATURES)
    return launch_fwd<hsl::MAX_FEATURES>(stream, sc, row_off, T, R, C, grid_x, th, tw, img_w,
                                         img_h, acc, ft, med, last, mpos, s);
  return (int)cudaErrorInvalidValue;
}

int stream_bwd(const float* stream, const float* sc, const int* row_off, const float* ft,
               const int* last, const int* mpos, const float* gacc, const float* gft,
               const float* gmed, int T, int R, int C, int grid_x, int th, int tw, float img_w,
               float img_h, int sb, float* dtab, void* cu_stream) {
  const int F = C - 5;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(cu_stream);
  if (th * tw > BWD_THREADS) return (int)cudaErrorInvalidValue;
  // feature buckets (fwd.cuh)
  if (F >= 0 && F <= 3)
    return launch_bwd<3>(stream, sc, row_off, ft, last, mpos, gacc, gft, gmed, T, R, C, grid_x,
                         th, tw, img_w, img_h, sb, dtab, s);
  if (F >= 0 && F <= 29)
    return launch_bwd<29>(stream, sc, row_off, ft, last, mpos, gacc, gft, gmed, T, R, C, grid_x,
                          th, tw, img_w, img_h, sb, dtab, s);
  if (F >= 0 && F <= 32)
    return launch_bwd<32>(stream, sc, row_off, ft, last, mpos, gacc, gft, gmed, T, R, C, grid_x,
                          th, tw, img_w, img_h, sb, dtab, s);
  if (F >= 0 && F <= hsl::MAX_FEATURES)
    return launch_bwd<hsl::MAX_FEATURES>(stream, sc, row_off, ft, last, mpos, gacc, gft, gmed,
                                         T, R, C, grid_x, th, tw, img_w, img_h, sb, dtab, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
