// The lane grid that csrc/p2cp.cu and csrc/min_dist.cu walk a row's point
// pairs with, and the helpers both share.
//
// A row is two channel-major point sets, u (N points) and v (M points). A
// group of LANES_U x LANES_V = 16 lanes takes a row, two rows a warp. Lane
// (a, b) of a group holds in registers the u points a + 4k (k < KU) of the
// current u tile and the v points b + 4l (l < KV) of the current v chunk, so
// one tile-and-chunk block is (4 KU) x (4 KV) points, and each pair (i, j) of
// the row falls in exactly one lane's block: the lane (i mod 4, j mod 4) of
// the block (i div 4KU, j div 4KV). A point past N or M in the grid reads the
// last real point (N - 1 or M - 1) instead: a copy changes no minimum, and
// the copy's own minimum is masked out of every sum and output. (A far
// sentinel would not do: with a NaN-propagating min, inf - inf is NaN.)
//
// The warp stages its rows in shared memory, issuing a lane's loads before
// its stores; the lanes read their points from there once a tile or chunk,
// and the inner loop over the block's pairs reads registers only. (KU, KV)
// are template arguments: each kernel compiles the tiles its Python launch
// rule may pick (ops/hopper_p2cp.py, ops/hopper_min_dist.py) and no others.
// A tile compiled with its shape (N, M) (the contours' 50 x 50, the tract
// variables' windows) has every count, clamp and offset folded to a
// constant; one tile compiled with N = M = 0 takes any other shape.

#pragma once

#include <cuda_runtime.h>

namespace point_pairs {

constexpr int LANES_U = 4, LANES_V = 4;
constexpr int GROUP = LANES_U * LANES_V;  // lanes a row
constexpr int ROWS_A_WARP = 32 / GROUP;
constexpr int MAX_WARPS = 4;              // warps a CTA the kernels are bounded for

// Entries of a per-lane array of K values once padded for reduce_scatter_min
// over `lanes` lanes: a power of two, at least `lanes`.
__host__ __device__ constexpr int padded(int k, int lanes) {
  int p = lanes;
  while (p < k) p *= 2;
  return p;
}

// The smaller of a and b, and NaN where either is NaN, as jnp.min and
// torch.amin take it (PTX min.NaN, sm_80 and later). fminf drops a NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// p ? a : b as one selp. Written out in PTX so that the compiler cannot turn
// a select between two entries of a register array into a select between
// their addresses, which would move the array to local memory.
__device__ __forceinline__ float pick(bool p, float a, float b) {
  float d;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\tselp.f32 %0, %1, %2, q;\n\t}"
      : "=f"(d)
      : "f"(a), "f"(b), "r"((int)p));
  return d;
}

// Min over the `lanes` lanes of a group whose lane indices differ by
// multiples of `stride` (this lane the `which`-th of them), scattered: K (a
// power of two, at least `lanes`) entries in, and afterwards entry s < K /
// lanes holds the group's min of entry (K / lanes) * which + s. Each stage
// halves the entries, the highest bit of `which` first; the order of the
// operands of each min is fixed, and min is exact, so every launch gives the
// same bits.
template <int K, int LANES, int STRIDE>
__device__ __forceinline__ void reduce_scatter_min(float (&x)[K], int which) {
  static_assert(K >= LANES && (K & (K - 1)) == 0, "K: a power of two, at least LANES");
  // One stage, then the next on the kept half: every index is a constant, so
  // x stays in registers.
  if constexpr (LANES > 1) {
    constexpr int H = K / 2;
    const bool upper = which & (LANES / 2);
#pragma unroll
    for (int s = 0; s < H; ++s) {
      const float send = pick(upper, x[s], x[s + H]);
      const float keep = pick(upper, x[s + H], x[s]);
      x[s] = min_nan(keep, __shfl_xor_sync(0xffffffffu, send, LANES / 2 * STRIDE));
    }
    reduce_scatter_min<H, LANES / 2, STRIDE>(reinterpret_cast<float(&)[H]>(x), which);
  }
}

// The warp copies its ROWS_A_WARP rows of u (each `lu` floats) to du and of
// v (each `lv` floats) to dv, row by row; a row past R repeats row R - 1.
// Each lane issues its loads before its stores, STAGE_BATCH floats of each
// row at a time, so a warp waits one memory round trip for rows of up to
// 128 floats (the contours' 2 x 50), not one for every 32 floats.
constexpr int STAGE_BATCH = 4;

__device__ __forceinline__ void warp_copy_rows(float* du, const float* __restrict__ u, int lu,
                                               float* dv, const float* __restrict__ v, int lv,
                                               int row0, int n_rows, int lane) {
  size_t r[ROWS_A_WARP];
#pragma unroll
  for (int q = 0; q < ROWS_A_WARP; ++q) r[q] = min(row0 + q, n_rows - 1);
  for (int e0 = lane; e0 < max(lu, lv); e0 += 32 * STAGE_BATCH) {
    float xu[ROWS_A_WARP][STAGE_BATCH], xv[ROWS_A_WARP][STAGE_BATCH];
#pragma unroll
    for (int q = 0; q < ROWS_A_WARP; ++q) {
#pragma unroll
      for (int t = 0; t < STAGE_BATCH; ++t) {
        const int e = e0 + 32 * t;
        xu[q][t] = e < lu ? u[r[q] * lu + e] : 0.0f;
        xv[q][t] = e < lv ? v[r[q] * lv + e] : 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < ROWS_A_WARP; ++q) {
#pragma unroll
      for (int t = 0; t < STAGE_BATCH; ++t) {
        const int e = e0 + 32 * t;
        if (e < lu) du[q * lu + e] = xu[q][t];
        if (e < lv) dv[q * lv + e] = xv[q][t];
      }
    }
  }
}

// Sum over the 16 lanes of a row's group, in a fixed order.
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = GROUP / 2; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace point_pairs
