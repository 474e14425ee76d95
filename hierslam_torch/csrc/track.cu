// The tracker's per-slot projection (track_project_fwd) and its backward to
// the pose (track_project_bwd) for Hopper (sm_90a).
//
// Replaces no TPU kernel: hierslam_tpu/ops/render_tracked.py::render_tracked
// projects the cached slots with XLA ops, which XLA fuses.  The port ran
// them as eager PyTorch ops (ops/render_tracked.py, before this file): ~60
// passes over the [S] slots forward and as many backward, ~30 saved [S]
// intermediates, a concatenation of the [S, 10] blend table and the pose's
// gradient through cuBLAS products; at the flagship's 300k map (S ~ 9M slots
// a frame) ~11 of a tracking iteration's 17.7 ms of device time.  Plain C
// interface, loaded with ctypes by hierslam_torch/ops/kernels.py; the
// wrappers there allocate the outputs and scratch, pass PyTorch's current
// stream and check the launch error these return.
//
// Input.  rows [S, RC] float32, the slot's gaussian as the pose cache
// gathers it (render_tracked.build_track_cache): world mean (3), colour (3),
// opacity (post-sigmoid), then its shape: the isotropic scale (RC = 8) or
// the world covariance's upper triangle xx xy xz yy yz zz (RC = 13); valid
// [S] uint8; tile [S] int32, the slot's true tile id; the pose and camera
// as the 28 scalars of ops/render_stream.py::make_scalars in device memory
// (R row-major, t, full_proj rows 0, 1, 3, fx, fy, 1.3 tan fovx,
// 1.3 tan fovy), so the caller needs no host copy for them.
//
// Forward (render_tracked.track_project_plain, in the same operation order):
// camera mean m = R mu + t, the projective screen mean, the EWA covariance
// with the Jacobian's clamped txc/tyc (iso: s^2 J J^T + 0.3 I; aniso:
// (J W) S (J W)^T + 0.3 I, W = R), its conic, the radius and the rect test
// against the slot's tile.  Writes the K1 table [S, 10] (x, y, conic a b c,
// opacity where ok else 0, camera z, colour) and ok = valid & z > 0.2 &
// det != 0 & rect overlaps the tile.  Built with -fmad=false
// (ops/kernels.py): every product and sum rounds as the plain version's
// separate PyTorch ops do, so the table and ok equal it to the bit;
// torch.clamp, clamp_min and maximum pass a NaN through, as nan_clamp,
// nan_clamp_min and nan_max below do;
// the divisions by the tile's sides are products by the float reciprocals
// the wrapper passes, as the plain version writes them.
//
// Backward.  From the table's cotangent (columns x, y, conic a b c and z, as
// K2 writes them; opacity and colour do not depend on the pose), each slot's
// projection is worked out again and the chain rule taken through the same
// formulas -- the inclusive clamp of txc/tyc (torch.clamp's gradient), the
// z == 0 and det == 0 guards, the 1e-7 in p_w, on the aniso path the fold
// with W -- down to the 12 entries of w2c[:3, :4] (R row-major, then t).  A
// slot whose six cotangents are all 0 adds nothing and is skipped.  The sum
// over slots is f32 and in a fixed order: each thread sums its slots in
// order, each block its threads by shuffles and then its warps in order into
// one partial row, and a second launch sums the partial rows in block order,
// so two launches on the same inputs are equal to the bit (no float atomics).
// It writes the gradient of all 28 scalars, 0 past the pose's 12.
//
// Bound on this card: bytes.  Forward, per slot, a row (32 or 52 bytes),
// valid and tile (5) read, the table row and ok (41) written: ~78 bytes, 0.2
// ms at 9M slots and 3.35 TB/s, against ~150 float operations and 8
// divisions and 2 square roots a slot.  Backward, per slot, the row and the
// cotangent row (40) read: ~72 bytes.  Design: one thread a slot; a block's
// 256 rows in and table rows out go through shared memory so that every
// global access is coalesced (odd strides, so that a thread's row lies in
// distinct banks from its neighbours'); the backward's blocks walk every
// gridDim-th chunk of 256 slots.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NSC = 28;         // pose and camera scalars
constexpr int NG = 12;          // pose entries: R row-major, t
constexpr int TAB = 10;         // blend table columns
constexpr int TABP = TAB + 1;   // its shared-memory stride
constexpr int THREADS = 256;
constexpr int BWD_GRID = 1024;  // most blocks of the backward: a fixed order of its sum

__host__ __device__ constexpr int row_cols(bool aniso) { return aniso ? 13 : 8; }
__host__ __device__ constexpr int row_stride(bool aniso) { return row_cols(aniso) | 1; }

// torch.clamp, clamp_min and maximum on a CUDA tensor: a NaN passes through
__device__ __forceinline__ float nan_clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float nan_clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}

// Copy n rows of `cols` floats from global memory into shared rows of
// `stride` floats, coalesced.
template <int COLS, int STRIDE>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, float* dst, int n) {
  for (int i = threadIdx.x; i < n * COLS; i += THREADS)
    dst[(i / COLS) * STRIDE + i % COLS] = src[i];
}

// One slot's projection: what the table holds and what the backward reads.
struct Proj {
  float mcx, mcy, mcz, ph_x, ph_y, p_w, px, py;
  float inv_z, vx, vy, txc, tyc, j00, j02, j11, j12;
  float s2;                         // iso
  float t0[3], t1[3], a0[3], b1[3]; // aniso
  float cxx, cxy, cyy, det, det_inv;
  bool det_ok;
};

template <bool ANISO>
__device__ __forceinline__ Proj project(const float* g, const float* s, float img_w,
                                        float img_h) {
  Proj o;
  const float mx = g[0], my = g[1], mz = g[2];
  o.mcx = s[0] * mx + s[1] * my + s[2] * mz + s[9];
  o.mcy = s[3] * mx + s[4] * my + s[5] * mz + s[10];
  o.mcz = s[6] * mx + s[7] * my + s[8] * mz + s[11];
  o.ph_x = s[12] * o.mcx + s[13] * o.mcy + s[14] * o.mcz + s[15];
  o.ph_y = s[16] * o.mcx + s[17] * o.mcy + s[18] * o.mcz + s[19];
  const float ph_w = s[20] * o.mcx + s[21] * o.mcy + s[22] * o.mcz + s[23];
  o.p_w = 1.0f / (ph_w + 1e-7f);
  o.px = ((o.ph_x * o.p_w + 1.0f) * img_w - 1.0f) * 0.5f;
  o.py = ((o.ph_y * o.p_w + 1.0f) * img_h - 1.0f) * 0.5f;

  const float fx = s[24], fy = s[25], limx = s[26], limy = s[27];
  const float safe_z = (o.mcz == 0.0f) ? 1.0f : o.mcz;
  o.inv_z = 1.0f / safe_z;
  o.vx = o.mcx * o.inv_z;
  o.vy = o.mcy * o.inv_z;
  o.txc = nan_clamp(o.vx, -limx, limx);
  o.tyc = nan_clamp(o.vy, -limy, limy);
  o.j00 = fx * o.inv_z;
  o.j02 = -fx * o.txc * o.inv_z;
  o.j11 = fy * o.inv_z;
  o.j12 = -fy * o.tyc * o.inv_z;
  if (ANISO) {
    // (J W) S (J W)^T: t0, t1 the rows of J W; a0 = S t0, b1 = S t1
    const float S[3][3] = {{g[7], g[8], g[9]}, {g[8], g[10], g[11]}, {g[9], g[11], g[12]}};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o.t0[c] = o.j00 * s[c] + o.j02 * s[6 + c];
      o.t1[c] = o.j11 * s[3 + c] + o.j12 * s[6 + c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o.a0[c] = o.t0[0] * S[0][c] + o.t0[1] * S[1][c] + o.t0[2] * S[2][c];
      o.b1[c] = o.t1[0] * S[0][c] + o.t1[1] * S[1][c] + o.t1[2] * S[2][c];
    }
    o.cxx = o.a0[0] * o.t0[0] + o.a0[1] * o.t0[1] + o.a0[2] * o.t0[2] + 0.3f;
    o.cxy = o.a0[0] * o.t1[0] + o.a0[1] * o.t1[1] + o.a0[2] * o.t1[2];
    o.cyy = o.b1[0] * o.t1[0] + o.b1[1] * o.t1[1] + o.b1[2] * o.t1[2] + 0.3f;
  } else {
    const float sc = g[7];
    o.s2 = sc * sc;
    o.cxx = o.s2 * (o.j00 * o.j00 + o.j02 * o.j02) + 0.3f;
    o.cxy = o.s2 * (o.j02 * o.j12);
    o.cyy = o.s2 * (o.j11 * o.j11 + o.j12 * o.j12) + 0.3f;
  }
  o.det = o.cxx * o.cyy - o.cxy * o.cxy;
  o.det_ok = o.det != 0.0f;
  o.det_inv = 1.0f / (o.det_ok ? o.det : 1.0f);
  return o;
}

}  // namespace

template <bool ANISO>
__global__ void __launch_bounds__(THREADS) track_fwd_kernel(
    const float* __restrict__ rows, const uint8_t* __restrict__ valid,
    const int* __restrict__ tile, const float* __restrict__ scalars, int S, int grid_x,
    float img_w, float img_h, float tw, float th, float inv_tw, float inv_th,
    float* __restrict__ table, uint8_t* __restrict__ ok) {
  constexpr int RC = row_cols(ANISO), RS = row_stride(ANISO);
  constexpr int BUF = RS > TABP ? RS : TABP;
  __shared__ float s_sc[NSC];
  __shared__ float s_buf[THREADS * BUF];
  const int base = blockIdx.x * THREADS;
  const int n = min(THREADS, S - base);
  const int j = threadIdx.x;
  if (j < NSC) s_sc[j] = scalars[j];
  stage_rows<RC, RS>(rows + (size_t)base * RC, s_buf, n);
  __syncthreads();

  float out[TAB];
  bool okv = false;
  if (j < n) {
    const float* g = s_buf + j * RS;
    const Proj o = project<ANISO>(g, s_sc, img_w, img_h);
    const float mid = 0.5f * (o.cxx + o.cyy);
    const float sq = sqrtf(nan_clamp_min(mid * mid - o.det, 0.1f));
    const float radius = ceilf(3.0f * sqrtf(nan_max(mid + sq, mid - sq)));
    const int tid = tile[base + j];
    const float tx = (float)(tid % grid_x), ty = (float)(tid / grid_x);
    const bool rect_ok = (tx >= floorf((o.px - radius) * inv_tw)) &&
                         (tx < floorf((o.px + radius + tw - 1.0f) * inv_tw)) &&
                         (ty >= floorf((o.py - radius) * inv_th)) &&
                         (ty < floorf((o.py + radius + th - 1.0f) * inv_th));
    okv = valid[base + j] != 0 && o.mcz > 0.2f && o.det_ok && rect_ok;
    out[0] = o.px;
    out[1] = o.py;
    out[2] = o.cyy * o.det_inv;
    out[3] = -o.cxy * o.det_inv;
    out[4] = o.cxx * o.det_inv;
    out[5] = okv ? g[6] : 0.0f;
    out[6] = o.mcz;
    out[7] = g[3];
    out[8] = g[4];
    out[9] = g[5];
  }
  __syncthreads();  // every row is read: the buffer takes the table rows
  if (j < n) {
#pragma unroll
    for (int c = 0; c < TAB; ++c) s_buf[j * TABP + c] = out[c];
    ok[base + j] = okv;
  }
  __syncthreads();
  float* dst = table + (size_t)base * TAB;
  for (int i = j; i < n * TAB; i += THREADS) dst[i] = s_buf[(i / TAB) * TABP + i % TAB];
}

// One slot's gradient of the 12 pose entries, added to acc.
template <bool ANISO>
__device__ __forceinline__ void slot_grad(const float* g, const float* d, const float* s,
                                          float img_w, float img_h, float* acc) {
  const float d_px = d[0], d_py = d[1], d_ca = d[2], d_cb = d[3], d_cc = d[4], d_dep = d[6];
  if (d_px == 0.f && d_py == 0.f && d_ca == 0.f && d_cb == 0.f && d_cc == 0.f && d_dep == 0.f)
    return;
  const Proj o = project<ANISO>(g, s, img_w, img_h);
  // conic = (cyy, -cxy, cxx) det_inv, det_inv = 1 / det where det != 0
  const float g_dinv = d_ca * o.cyy - d_cb * o.cxy + d_cc * o.cxx;
  const float g_det = o.det_ok ? -g_dinv * o.det_inv * o.det_inv : 0.f;
  const float g_cxx = d_cc * o.det_inv + g_det * o.cyy;
  const float g_cyy = d_ca * o.det_inv + g_det * o.cxx;
  const float g_cxy = -d_cb * o.det_inv - 2.f * g_det * o.cxy;
  float g_j00, g_j02, g_j11, g_j12;
  if (ANISO) {
    float gt0[3], gt1[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gt0[c] = 2.f * g_cxx * o.a0[c] + g_cxy * o.b1[c];
      gt1[c] = 2.f * g_cyy * o.b1[c] + g_cxy * o.a0[c];
    }
    g_j00 = gt0[0] * s[0] + gt0[1] * s[1] + gt0[2] * s[2];
    g_j02 = gt0[0] * s[6] + gt0[1] * s[7] + gt0[2] * s[8];
    g_j11 = gt1[0] * s[3] + gt1[1] * s[4] + gt1[2] * s[5];
    g_j12 = gt1[0] * s[6] + gt1[1] * s[7] + gt1[2] * s[8];
#pragma unroll
    for (int c = 0; c < 3; ++c) {   // W = R enters the fold directly
      acc[c] += gt0[c] * o.j00;
      acc[3 + c] += gt1[c] * o.j11;
      acc[6 + c] += gt0[c] * o.j02 + gt1[c] * o.j12;
    }
  } else {
    g_j00 = g_cxx * o.s2 * 2.f * o.j00;
    g_j02 = g_cxx * o.s2 * 2.f * o.j02 + g_cxy * o.s2 * o.j12;
    g_j11 = g_cyy * o.s2 * 2.f * o.j11;
    g_j12 = g_cyy * o.s2 * 2.f * o.j12 + g_cxy * o.s2 * o.j02;
  }
  const float fx = s[24], fy = s[25], limx = s[26], limy = s[27];
  float g_invz = fx * g_j00 + (-fx * o.txc) * g_j02 + fy * g_j11 + (-fy * o.tyc) * g_j12;
  // txc = clamp(mcx / z): the gradient passes inside the limits, ends included
  const float g_vx = (o.vx >= -limx && o.vx <= limx) ? -fx * o.inv_z * g_j02 : 0.f;
  const float g_vy = (o.vy >= -limy && o.vy <= limy) ? -fy * o.inv_z * g_j12 : 0.f;
  float g_mcx = g_vx * o.inv_z;
  float g_mcy = g_vy * o.inv_z;
  g_invz = g_invz + g_vx * o.mcx + g_vy * o.mcy;
  float g_mcz = o.mcz != 0.f ? -g_invz * o.inv_z * o.inv_z : 0.f;
  // px = ((ph_x p_w + 1) W - 1) / 2, p_w = 1 / (ph_w + 1e-7)
  const float g_ux = d_px * (img_w * 0.5f), g_uy = d_py * (img_h * 0.5f);
  const float g_phx = g_ux * o.p_w, g_phy = g_uy * o.p_w;
  const float g_phw = -(g_ux * o.ph_x + g_uy * o.ph_y) * o.p_w * o.p_w;
  g_mcx = g_mcx + s[12] * g_phx + s[16] * g_phy + s[20] * g_phw;
  g_mcy = g_mcy + s[13] * g_phx + s[17] * g_phy + s[21] * g_phw;
  g_mcz = g_mcz + s[14] * g_phx + s[18] * g_phy + s[22] * g_phw + d_dep;
  // m = R mu + t
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    acc[c] += g_mcx * g[c];
    acc[3 + c] += g_mcy * g[c];
    acc[6 + c] += g_mcz * g[c];
  }
  acc[9] += g_mcx;
  acc[10] += g_mcy;
  acc[11] += g_mcz;
}

template <bool ANISO>
__global__ void __launch_bounds__(THREADS) track_bwd_kernel(
    const float* __restrict__ rows, const float* __restrict__ gtab,
    const float* __restrict__ scalars, int S, float img_w, float img_h,
    float* __restrict__ partial) {
  constexpr int RC = row_cols(ANISO), RS = row_stride(ANISO);
  __shared__ float s_sc[NSC];
  __shared__ float s_row[THREADS * RS];
  __shared__ float s_cot[THREADS * TABP];
  __shared__ float s_red[THREADS / 32][NG];
  const int j = threadIdx.x;
  if (j < NSC) s_sc[j] = scalars[j];
  float acc[NG];
#pragma unroll
  for (int k = 0; k < NG; ++k) acc[k] = 0.f;
  const int chunks = (S + THREADS - 1) / THREADS;
  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const int base = ch * THREADS;
    const int n = min(THREADS, S - base);
    __syncthreads();  // the previous chunk's rows are read
    stage_rows<RC, RS>(rows + (size_t)base * RC, s_row, n);
    stage_rows<TAB, TABP>(gtab + (size_t)base * TAB, s_cot, n);
    __syncthreads();
    if (j < n) slot_grad<ANISO>(s_row + j * RS, s_cot + j * TABP, s_sc, img_w, img_h, acc);
  }
  // the block's sum: lanes by shuffles, then the warps in order
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if ((j & 31) == 0) s_red[j >> 5][k] = v;
  }
  __syncthreads();
  if (j < NG) {
    float v = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) v += s_red[w][j];
    partial[(size_t)blockIdx.x * NG + j] = v;
  }
}

// The partial rows summed in block order: warp k sums entry k, lane l the
// rows l, l + 32, ..., then the lanes by shuffles.  Entries past the pose's
// 12 (the camera's scalars) are 0.
__global__ void __launch_bounds__(NG * 32) track_bwd_finish(const float* __restrict__ partial,
                                                             int nblk, float* __restrict__ gsc) {
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float v = 0.f;
  for (int b = lane; b < nblk; b += 32) v += partial[(size_t)b * NG + k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) gsc[k] = v;
  if (threadIdx.x < NSC - NG) gsc[NG + threadIdx.x] = 0.f;
}

extern "C" {

// Blocks of the backward for S slots: the rows of its partial sums.
int track_bwd_blocks(int S) {
  const int chunks = (S + THREADS - 1) / THREADS;
  return chunks < BWD_GRID ? chunks : BWD_GRID;
}

// rows [S, rc] float32 (rc 8: isotropic, 13: anisotropic), valid [S] uint8,
// tile [S] int32, scalars [28] float32 -> table [S, 10] float32, ok [S]
// uint8.  See the top of the file.
int track_project_fwd(const float* rows, const uint8_t* valid, const int* tile,
                      const float* scalars, int S, int rc, int grid_x, float img_w, float img_h,
                      float tw, float th, float inv_tw, float inv_th, float* table, uint8_t* ok,
                      void* stream) {
  if (S <= 0 || grid_x <= 0 || (rc != row_cols(false) && rc != row_cols(true)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int grid = (S + THREADS - 1) / THREADS;
  if (rc == row_cols(true))
    track_fwd_kernel<true><<<grid, THREADS, 0, s>>>(rows, valid, tile, scalars, S, grid_x, img_w,
                                                    img_h, tw, th, inv_tw, inv_th, table, ok);
  else
    track_fwd_kernel<false><<<grid, THREADS, 0, s>>>(rows, valid, tile, scalars, S, grid_x,
                                                     img_w, img_h, tw, th, inv_tw, inv_th, table,
                                                     ok);
  return (int)cudaGetLastError();
}

// rows [S, rc] as above, gtab [S, 10] float32 the table's cotangent,
// scalars [28], partial [track_bwd_blocks(S), 12] float32 scratch -> gsc
// [28] float32, the gradient of the scalars (0 past the pose's 12).
int track_project_bwd(const float* rows, const float* gtab, const float* scalars, int S, int rc,
                      float img_w, float img_h, float* partial, float* gsc, void* stream) {
  if (S <= 0 || (rc != row_cols(false) && rc != row_cols(true)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int grid = track_bwd_blocks(S);
  if (rc == row_cols(true))
    track_bwd_kernel<true><<<grid, THREADS, 0, s>>>(rows, gtab, scalars, S, img_w, img_h,
                                                    partial);
  else
    track_bwd_kernel<false><<<grid, THREADS, 0, s>>>(rows, gtab, scalars, S, img_w, img_h,
                                                     partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  track_bwd_finish<<<1, NG * 32, 0, s>>>(partial, grid, gsc);
  return (int)cudaGetLastError();
}

}  // extern "C"
