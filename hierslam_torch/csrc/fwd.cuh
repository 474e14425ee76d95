// What the two blend forwards share (K1 in blend.cu, K3 in stream.cu): the
// packed records a tile's pixels walk, the walk itself, the per-pixel
// outputs, asynchronous copies into shared memory and the launch's shared
// memory grant.
//
// A record is two float4 (x y a b | c opacity depth mask): the screen mean,
// the conic, the opacity, the camera depth and, as integer bits, the warps
// the pair's footprint can reach (cull.cuh; 0 for a masked, invalid or pad
// entry).  Features sit in a float4-aligned array of their own, which only
// a commit reads, pads past F zero.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cull.cuh"

namespace hsl {

constexpr int FWD_THREADS = 256;  // most pixels a tile K1 and K3 take
constexpr int MAX_DEVICES = 64;   // devices a kernel's shared-memory grant is tracked for
constexpr unsigned WARP_ALL = 0xffffffffu;
constexpr float ALPHA_MAX = 0.99f;  // alpha is clamped here; ALPHA_MIN is in cull.cuh
constexpr float T_END = 1e-4f;
constexpr float MEDIAN_NONE = 15.0f;

// Feature buckets: every kernel is built for F <= 3, F <= 29, F <= 32 and
// F <= MAX_FEATURES, the wide bucket (33 to 128 features: the 77 of the
// ScanNet tree-large config, any F the JAX kernels take up to that).  Its
// accumulator, or cotangent, is a register array of 128 floats, which
// leaves room under the 255-register cap at one block of 256 an SM; the
// shared memory of K3's row pipeline at F = 128 (207 KB of the 227 KB a
// block may have) is the other limit.  The wrappers raise above it.
constexpr int MAX_FEATURES = 128;

// Blocks of 256 an SM must hold, which sets the register cap: 4 (64
// registers) at F <= 3, 3 (80) at F <= 29, 2 (up to 128) at F <= 32, which
// spills 16-28 bytes at 80; 1 (up to 255) in the wide bucket.
__host__ __device__ constexpr int fwd_min_blocks(int maxf) {
  return maxf <= 3 ? 4 : maxf <= 29 ? 3 : maxf <= 32 ? 2 : 1;
}

// float4 per entry of the feature array.
__host__ __device__ constexpr int feat4_stride(int F) { return (F + 3) >> 2; }

// power = -q / 2 of a pixel at offset (dx, dy) from a mean with conic
// (a, b, c), in the operation order of the plain version
// (render_xla.blend_terms) and with no fused multiply-add, whatever the
// build's -fmad: the tests power <= 0 and alpha >= 1/255 then round as the
// plain version's do, and as each other's in a forward and its backward.
__device__ __forceinline__ float blend_power(float a, float b, float c, float dx, float dy) {
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx), __fmul_rn(__fmul_rn(c, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(b, dx), dy));
}

// One pixel's running blend.
template <int MAXF>
struct Pixel {
  float a_f[MAXF];
  float a_dep = 0.f, a_mass = 0.f, T = 1.f, medv = MEDIAN_NONE;
  int lastc = -1, medc = -1;
  bool done = false;
  __device__ __forceinline__ Pixel() {
#pragma unroll
    for (int c = 0; c < MAXF; ++c) a_f[c] = 0.f;
  }
};

// Walk n records (n a multiple of 32, in depth order; entry j is position
// pos0 + j) for the pixel at (px, py).  Called by every lane of the warp: the
// warp gathers the records whose mask holds its bit with one ballot per 32
// and visits only those, so a pair that cannot reach the warp costs nothing
// beyond the ballot.  The tests are those of the plain version
// (render_xla.blend_terms) in its operation order (blend_power; alpha and
// T are single products); the sums, which feed no test, take a fused
// multiply-add.
template <int MAXF>
__device__ __forceinline__ void walk_records(const float4* rec4, const float4* feat4, int fs4,
                                             int n, int pos0, int F, int warp, int lane,
                                             float px, float py, Pixel<MAXF>& s) {
  const float* rec = reinterpret_cast<const float*>(rec4);
  for (int k0 = 0; k0 < n; k0 += 32) {
    const unsigned mine = __float_as_uint(rec[(k0 + lane) * 8 + 7]);
    unsigned live = __ballot_sync(WARP_ALL, (mine >> warp) & 1u);
    while (live) {
      const int j = k0 + __ffs(live) - 1;
      live &= live - 1u;
      if (!s.done) {
        const float4 q0 = rec4[2 * j];      // x y a b
        const float4 q1 = rec4[2 * j + 1];  // c opacity depth mask
        const float dx = q0.x - px;
        const float dy = q0.y - py;
        const float power = blend_power(q0.z, q0.w, q1.x, dx, dy);
        if (power <= 0.f) {
          const float alpha = fminf(ALPHA_MAX, q1.y * expf(power));
          if (alpha >= ALPHA_MIN) {
            const float test_T = s.T * (1.f - alpha);
            if (test_T < T_END) {
              s.done = true;
            } else {
              const float w = alpha * s.T;
              const float4* f4 = feat4 + (size_t)j * fs4;
#pragma unroll
              for (int c = 0; c < MAXF; c += 4) {
                if (c < F) {
                  const float4 v = f4[c / 4];
                  s.a_f[c] = __fmaf_rn(v.x, w, s.a_f[c]);
                  if (c + 1 < MAXF) s.a_f[c + 1] = __fmaf_rn(v.y, w, s.a_f[c + 1]);
                  if (c + 2 < MAXF) s.a_f[c + 2] = __fmaf_rn(v.z, w, s.a_f[c + 2]);
                  if (c + 3 < MAXF) s.a_f[c + 3] = __fmaf_rn(v.w, w, s.a_f[c + 3]);
                }
              }
              s.a_dep = __fmaf_rn(q1.z, w, s.a_dep);
              s.a_mass += w;
              if (s.T > 0.5f && test_T < 0.5f) {
                s.medv = q1.z;
                s.medc = pos0 + j;
              }
              s.T = test_T;
              s.lastc = pos0 + j;
            }
          }
        }
      }
    }
    if (__all_sync(WARP_ALL, s.done)) break;
  }
}

// Write one pixel's outputs: acc [F + 2], final T, median depth, the
// positions of its last committed entry and of its median crossing.
template <int MAXF>
__device__ __forceinline__ void store_pixel(const Pixel<MAXF>& s, size_t pix, int F,
                                            float* __restrict__ acc, float* __restrict__ ft,
                                            float* __restrict__ med, int* __restrict__ last,
                                            int* __restrict__ mpos) {
  float* acc_p = acc + pix * (F + 2);
#pragma unroll
  for (int c = 0; c < MAXF; ++c)
    if (c < F) acc_p[c] = s.a_f[c];
  acc_p[F] = s.a_dep;
  acc_p[F + 1] = s.a_mass;
  ft[pix] = s.T;
  med[pix] = s.medv;
  last[pix] = s.lastc;
  mpos[pix] = s.medc;
}

// Gather up to four features c .. c + 3 of a row into a float4, zeros past F.
__device__ __forceinline__ float4 feat_quad(const float* f, int c, int F) {
  return make_float4(f[c], c + 1 < F ? f[c + 1] : 0.f, c + 2 < F ? f[c + 2] : 0.f,
                     c + 3 < F ? f[c + 3] : 0.f);
}

// The warp copies n floats from device to shared memory without waiting
// (cp.async): 16-byte pieces where both ends are 16-byte aligned, 4-byte
// pieces otherwise and for the tail.  The copies of all lanes form one
// group; warp_copy_wait() waits for it.
__device__ __forceinline__ void warp_copy_async(float* dst, const float* src, int n, int lane) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const size_t g = __cvta_generic_to_global(src);
  const bool wide = ((g | (size_t)d) & 15) == 0;
  const int n16 = wide ? n >> 2 : 0;
  for (int i = lane; i < n16; i += 32)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16u * i),
                 "l"(g + 16 * (size_t)i)
                 : "memory");
  for (int i = 4 * n16 + lane; i < n; i += 32)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + 4u * i),
                 "l"(g + 4 * (size_t)i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for the warp's copies and make them visible to all its lanes.
__device__ __forceinline__ void warp_copy_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// Above 48 KB a block's dynamic shared memory must be asked for, once for
// each kernel instantiation and device; `granted` (one array of MAX_DEVICES
// per instantiation) holds the most granted so far.
template <typename Kernel>
static cudaError_t grant_smem(Kernel kernel, int smem, int* granted) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > granted[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    granted[dev] = smem;
  }
  return cudaSuccess;
}

}  // namespace hsl
