// Warp reduce-scatter for the blend backwards (K2 in blend.cu, K4 in
// stream.cu).
//
// Both kernels sum, for every slot or pair they walk, V = 7 + F per-pixel
// gradient terms over the 256 pixels of a tile.  A butterfly sum of each
// value on its own (five __shfl steps a value) costs 5 V shuffles per warp
// and pair and leaves every sum in every lane.  A reduce-scatter (recursive
// halving) needs only one copy of each sum: at offset o each lane keeps the
// half of its array that `lane & o` selects, sends the other half to lane
// `lane ^ o` and adds what that lane sends back, so the array halves at
// every step.  Over N values (N a power of two) that is N - 1 shuffles, plus
// one plain shuffle-add for each offset left above N when N < 32; lane l
// ends with the warp's sum of value l % N.
//
// V values go through a few such reduce-scatters ("chunks") one after the
// other.  Each halving step costs a shuffle, two selects and an add per
// kept value, each plain step a shuffle and an add; chunk_cost() counts
// them and the chunks are chosen to minimise that count, padding a rest
// with zeros where that is cheaper than splitting it.  A chunk holds at most
// MAX_CHUNK = 16 values: two chunks of 16 cost what one of 32 costs
// (16 + 16 against 31 shuffles, the same selects and adds) and keep 16
// fewer values live in registers.  Shuffles per warp and pair, against the
// 5 V of the butterfly per value:
//   V = 10 (F = 3, tracking-width tables): 8 + 2, (7 + 2) + (1 + 4) = 14
//          shuffles against 50;
//   V = 36 (F = 29): 16 + 16 + 4, 16 + 16 + (3 + 3) = 38 against 180;
//   V = 39 (the F <= 32 bucket): 16 + 16 + 8 (7 used), 16 + 16 + 9 = 41;
//   V = 135 (the wide bucket, F <= 128): eight chunks of 16 and one of 8,
//          of which a run at F features reduces only the chunks that start
//          below 7 + F: at F = 77 six of 16 (the last with 4 values used),
//          6 x (15 + 1) = 96 shuffles against 420.
//
// Array indices stay compile-time constants (every loop is unrolled over a
// template size and the half is chosen with `?:`, never by indexing with the
// lane), so the arrays live in registers and never spill to local memory.

#pragma once

#include <cuda_runtime.h>

namespace hsl {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_CHUNK = 16;  // most values one reduce-scatter takes (a power of two <= 32)

__host__ __device__ constexpr int ceil_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

__host__ __device__ constexpr int floor_pow2(int v) {
  int p = 1;
  while (2 * p <= v) p <<= 1;
  return p;
}

// Issue slots of one reduce-scatter over N values (a power of two).
__host__ __device__ constexpr int chunk_cost(int n) {
  int c = 4 * (n - 1);
  for (int o = n; o < 32; o <<= 1) c += 2;
  return c;
}

// Least issue slots to sum v values in chunks of at most MAX_CHUNK.
__host__ __device__ constexpr int sum_cost(int v) {
  if (v <= 0) return 0;
  if (v >= MAX_CHUNK) return chunk_cost(MAX_CHUNK) + sum_cost(v - MAX_CHUNK);
  const int pad = chunk_cost(ceil_pow2(v));
  const int split = chunk_cost(floor_pow2(v)) + sum_cost(v - floor_pow2(v));
  return pad < split ? pad : split;
}

// Size of the first chunk for v values: MAX_CHUNK, v padded to a power
// of two, or v's largest power of two with the rest summed after it.
__host__ __device__ constexpr int first_chunk(int v) {
  if (v >= MAX_CHUNK) return MAX_CHUNK;
  const int pad = chunk_cost(ceil_pow2(v));
  const int split = chunk_cost(floor_pow2(v)) + sum_cost(v - floor_pow2(v));
  return pad <= split ? ceil_pow2(v) : floor_pow2(v);
}

// One halving step at offset H on v[0, 2H), then the steps below it.
template <int H, int N>
__device__ __forceinline__ void halve(float (&v)[N], int lane) {
  if constexpr (H >= 1) {
    const bool up = (lane & H) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL_MASK, send, H);
    }
    halve<H / 2>(v, lane);
  }
}

// Reduce-scatter of N values (N a power of two, at most 32) over the warp:
// returns, in lane l, the warp's sum of v[l % N].  v is clobbered.
template <int N>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[N], int lane) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N: a power of two <= 32");
  halve<N / 2>(v, lane);
  float s = v[0];
#pragma unroll
  for (int o = N; o < 32; o <<= 1) s += __shfl_xor_sync(FULL_MASK, s, o);
  return s;
}

// Sum V values over the warp and store the sums at red[0, nr), the first
// nr <= V of them (nr may be below V at run time: the values past nr must
// then be 0 and are not stored).  value(c) gives value c of this lane; it is
// called once for each c < V.  Chunk by chunk (first_chunk), lane l of a
// chunk of N values starting at value B stores red[B + l] for l < N.
// Above 64 values (the wide bucket) a chunk that starts at or past nr, all
// of whose values are then 0 and none stored, is skipped (nr is the same in
// every lane).
template <int V, int B = 0, typename Value>
__device__ __forceinline__ void warp_sum_store(Value value, float* red, int nr, int lane) {
  static_assert(V >= 1 && B < V, "V: at least 1 value");
  constexpr int N = first_chunk(V - B);
  static_assert(N <= 32 && (N & (N - 1)) == 0, "MAX_CHUNK: a power of two <= 32");
  if constexpr (V > 64) {
    if (B >= nr) return;
  }
  float a[N];
#pragma unroll
  for (int c = 0; c < N; ++c) a[c] = (B + c < V) ? value(B + c) : 0.f;
  const float sa = warp_reduce_scatter<N>(a, lane);
  if (lane < N && B + lane < nr) red[B + lane] = sa;
  if constexpr (B + N < V) warp_sum_store<V, B + N>(value, red, nr, lane);
}

// What warp_sum_store<V> stores for a warp whose lanes are all idle.
template <int V>
__device__ __forceinline__ void warp_zero_store(float* red, int nr, int lane) {
  if constexpr (V <= 64) {
    if (lane < nr) red[lane] = 0.f;
    if (lane + 32 < nr) red[lane + 32] = 0.f;
  } else {
    for (int i = lane; i < nr; i += 32) red[i] = 0.f;
  }
}

}  // namespace hsl
