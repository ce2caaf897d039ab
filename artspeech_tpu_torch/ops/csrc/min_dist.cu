// Minimum pairwise distance per row and its argmin pair, for a table of
// problems in one launch, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel artspeech_tpu/ops/pallas_kernels.py:_min_dist_kernel
// (pallas_call in _rows_call, reached from min_distance_pallas), which
// computes what the XLA formula ops/distances.py:min_distance computes. For
// each problem and row, of two point sets u (N points) and v (M points):
//
//   (i*, j*) = argmin over the flat index i*M + j of |u_i - v_j|^2
//   dist     = sqrt(|u_i* - v_j*|^2)
//
// Ties go to the smallest flat index i*M + j (jnp.argmin on the flat axis).
// A NaN distance counts as smaller than any number, as jnp.argmin and
// torch.argmin treat it, so a NaN point gives NaN at its first pair. Each
// squared distance is rounded as the plain version rounds it: the
// difference, both squares and their sum once each (__fsub_rn / __fmul_rn /
// __fadd_rn, so nvcc cannot contract them into FMAs). Both sides then pick
// the same pair, near-ties included.
//
// The table: up to MAX_SOURCES channel-major point sets (..., 2, N_s), read
// in place through their strides (a row stride for the flattened leading
// dims, a coordinate stride and a point stride), f32, bf16 or f16 (widened
// as it is staged; the same bits as a cast); and up to MAX_PROBLEMS problems, each a
// window (source, start, count) for u and one or two for v, read as one set
// (the tract variables' palate is two: hard palate, then soft palate). One
// launch takes a stack's four tract variables without copying a window,
// concatenating the palate or gathering the places of constriction.
// Outputs: out (P, R, 5) f32, the distance and the two winning points'
// (x, y) for each problem; idx (2, P, R) int64, the pair (optional).
//
// What bounds it: at the tract variables' shapes (R = 12*128 rows, N x M
// from 15 x 25 to 50 x 50) a row is at most 800 B read and 20 B written but
// up to 2,500 point pairs of about six operations each; the four problems
// are a few microseconds of work, less than a launch and its drain.
//
// Design: the lane grid of point_pairs.cuh, one group of 16 lanes a
// (problem, row), the (KU, KV) tile of each problem from the launch rule
// (ops/hopper_min_dist.py:min_dist_launch_geometry), which also orders the
// problems heaviest first so the light ones fill the tail. A CTA takes
// `warps` warps of one problem. A pair costs a rounded squared distance and
// one NaN-propagating min (walk); the first least pair is then found by
// keys (an integer that orders NaN first, then the squared distances), and
// the blocks and the group's lanes merge lexicographically on (key, flat
// index). Bounded to 85 registers (six CTAs of four warps an SM), so a
// stack's 768 CTAs at R = 1,536 run in one wave.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "point_pairs.cuh"

// The (tile id, KU, KV, N, M) tiles compiled, N = M = 0 for any shape: the
// tract variables' LA, TTCD, TBCD and VEL windows with their shapes, then
// one for any other; ops/hopper_min_dist.py:TILES lists the same in the same
// order. With N and M read at run time the walk spills and a stack's four
// TVs take about 6 % longer on the H100 (PERF.md).
#define MIN_DIST_TILES(X) \
  X(0, 13, 13, 50, 50) X(1, 4, 7, 15, 25) X(2, 5, 10, 20, 40) X(3, 4, 13, 15, 50) X(4, 8, 8, 0, 0)

namespace {

using namespace point_pairs;

constexpr int MAX_SOURCES = 8, MAX_PROBLEMS = 8;
constexpr int OUT_FIELDS = 5;  // dist, poc_1 (x, y), poc_2 (x, y)

struct Source {
  const void* base;
  long long row_stride, coord_stride, point_stride;  // in elements
};

struct Window {
  int source, start, count;
};

struct Problem {
  int tile, slot, first_block;  // first_block: blocks run the problems in table order
  Window u, v1, v2;             // v2.count == 0: v is v1 alone
};

struct Table {
  Source sources[MAX_SOURCES];
  Problem problems[MAX_PROBLEMS];
  int n_problems, dtype;  // the sources' storage type: 0 f32, 1 bf16, 2 f16
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

// The warp's rows row0, ... (rows of them) of the problem's windows into
// shared memory, ROWS_A_WARP rows of 2 (N + M) floats: u's x and y rows,
// then v's (v1's points, then v2's). The first 64 points of every window
// are loaded before any is stored, so a warp waits one memory round trip for
// the tract variables' windows; longer windows copy the rest point by point.
// Each window's row is one pointer, its points 32-bit offsets from it.
template <typename T>
__device__ __forceinline__ void stage(float* ws, const Table& t, const Problem& pr, int row0,
                                      int rows, int lane) {
  constexpr int BATCH = 2;  // points a lane a window in the first pass
  const int n = pr.u.count, m = pr.v1.count + pr.v2.count, row_floats = 2 * (n + m);
  const int windows = pr.v2.count ? 3 : 2;
  const Window win[3] = {pr.u, pr.v1, pr.v2};
  const int dst[3] = {0, 2 * n, 2 * n + pr.v1.count}, stride[3] = {n, m, m};
  const T* base[ROWS_A_WARP][3];
  int ps[3], cs[3];
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    const Source& s = t.sources[win[w].source];
    ps[w] = (int)s.point_stride;
    cs[w] = (int)s.coord_stride;
#pragma unroll
    for (int q = 0; q < ROWS_A_WARP; ++q)
      base[q][w] = static_cast<const T*>(s.base) + (row0 + q) * s.row_stride +
                   win[w].start * s.point_stride;
  }
  float x[ROWS_A_WARP][3][BATCH][2];
#pragma unroll
  for (int q = 0; q < ROWS_A_WARP; ++q) {
#pragma unroll
    for (int w = 0; w < 3; ++w) {
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int p = lane + 32 * k;
        const bool in = w < windows && q < rows && p < win[w].count;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          x[q][w][k][c] = in ? widen(base[q][w][p * ps[w] + c * cs[w]]) : 0.0f;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < ROWS_A_WARP; ++q) {
#pragma unroll
    for (int w = 0; w < 3; ++w) {
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int p = lane + 32 * k;
        if (w < windows && q < rows && p < win[w].count) {
          ws[q * row_floats + dst[w] + p] = x[q][w][k][0];
          ws[q * row_floats + dst[w] + stride[w] + p] = x[q][w][k][1];
        }
      }
    }
  }
  // Points past the first pass, window by window (its pointer recomputed, so
  // that no array above is indexed at run time and all stay in registers).
  auto rest = [&](const Window& w, int to, int count_c, int q) {
    const Source& s = t.sources[w.source];
    const T* row = static_cast<const T*>(s.base) + (row0 + q) * s.row_stride +
                   w.start * s.point_stride;
    for (int p = lane + 32 * BATCH; p < w.count; p += 32) {
      ws[q * row_floats + to + p] = widen(row[p * s.point_stride]);
      ws[q * row_floats + to + count_c + p] = widen(row[p * s.point_stride + s.coord_stride]);
    }
  };
  for (int q = 0; q < rows; ++q) {
    rest(pr.u, 0, n, q);
    rest(pr.v1, 2 * n, m, q);
    rest(pr.v2, 2 * n + pr.v1.count, m, q);
  }
}

// The squared distance as the plain version rounds it.
__device__ __forceinline__ float sq_dist(float ux, float uy, float vx, float vy) {
  const float dx = __fsub_rn(ux, vx), dy = __fsub_rn(uy, vy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// An unsigned key that orders a squared distance as argmin does: every NaN
// first (0), then the values (>= +0, whose bits order as their values).
__device__ __forceinline__ unsigned key_of(float sq) {
  return isnan(sq) ? 0u : __float_as_uint(sq) + 1u;
}

// (key, flat) before (best_key, best_flat): the smaller key, then the smaller
// flat index.
__device__ __forceinline__ void merge(unsigned key, int flat, unsigned& best_key, int& best_flat) {
  if (key < best_key || (key == best_key && flat < best_flat)) {
    best_key = key;
    best_flat = flat;
  }
}

// One row's walk over the (KU, KV) lane grid: this lane's first least
// (key, flat index). In each tile-and-chunk block the lane takes, for each of
// its u points k, the least squared distance over its v points with a
// NaN-propagating min (one FMNMX a pair); then the first k whose minimum has
// the least key, and the first v point l of that row whose squared distance
// has that key (the row computed again, rounded the same way). k ascending
// and l ascending are flat index ascending (copies of the last point come
// last and repeat a real pair), so this is the block's first least pair.
template <int KU, int KV, int NC, int MC>
__device__ __forceinline__ void walk(const float* su, int n_arg, const float* sv, int m_arg, int a,
                                     int b, unsigned& best_key, int& best_flat) {
  const int n = NC ? NC : n_arg, m = MC ? MC : m_arg;
  for (int i0 = 0; i0 < n; i0 += LANES_U * KU) {
    float ux[KU], uy[KU];
#pragma unroll
    for (int k = 0; k < KU; ++k) {
      const int i = min(i0 + a + LANES_U * k, n - 1);
      ux[k] = su[i];
      uy[k] = su[n + i];
    }
    for (int j0 = 0; j0 < m; j0 += LANES_V * KV) {
      float vx[KV], vy[KV];
#pragma unroll
      for (int l = 0; l < KV; ++l) {
        const int j = min(j0 + b + LANES_V * l, m - 1);
        vx[l] = sv[j];
        vy[l] = sv[m + j];
      }
      unsigned key = UINT_MAX;
      int k_best = 0;
      float bx = ux[0], by = uy[0];
#pragma unroll
      for (int k = 0; k < KU; ++k) {
        float row_min = INFINITY;
#pragma unroll
        for (int l = 0; l < KV; ++l) row_min = min_nan(row_min, sq_dist(ux[k], uy[k], vx[l], vy[l]));
        const unsigned row_key = key_of(row_min);
        if (row_key < key) {
          key = row_key;
          k_best = k;
          bx = ux[k];
          by = uy[k];
        }
      }
      int l_best = 0;
#pragma unroll
      for (int l = KV - 1; l >= 0; --l)
        if (key_of(sq_dist(bx, by, vx[l], vy[l])) == key) l_best = l;
      const int i = min(i0 + a + LANES_U * k_best, n - 1);
      const int j = min(j0 + b + LANES_V * l_best, m - 1);
      merge(key, i * m + j, best_key, best_flat);
    }
  }
}

__global__ void __launch_bounds__(MAX_WARPS * 32, 6)
    min_dist_kernel(const __grid_constant__ Table t, int n_rows, float* __restrict__ out,
                    int64_t* __restrict__ idx) {
  extern __shared__ __align__(16) float smem[];
  int p = 0;
  while (p + 1 < t.n_problems && (int)blockIdx.x >= t.problems[p + 1].first_block) ++p;
  const Problem& pr = t.problems[p];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = ((blockIdx.x - pr.first_block) * (blockDim.x / 32) + warp) * ROWS_A_WARP;
  if (row0 >= n_rows) return;  // the whole warp

  // Past R a row is not staged: its group works on whatever the buffer
  // holds and writes nothing.
  const int n = pr.u.count, m = pr.v1.count + pr.v2.count;
  const int row_floats = 2 * (n + m);
  float* ws = smem + warp * ROWS_A_WARP * row_floats;
  const int rows = min(ROWS_A_WARP, n_rows - row0);
  if (t.dtype == 1)
    stage<__nv_bfloat16>(ws, t, pr, row0, rows, lane);
  else if (t.dtype == 2)
    stage<__half>(ws, t, pr, row0, rows, lane);
  else
    stage<float>(ws, t, pr, row0, rows, lane);
  __syncwarp();

  const int q = lane / GROUP, a = lane % GROUP / LANES_V, b = lane % LANES_V;
  const float* su = ws + q * row_floats;
  const float* sv = su + 2 * n;
  unsigned best_key = UINT_MAX;
  int best_flat = INT_MAX;
  switch (pr.tile) {
#define MIN_DIST_WALK(ID, KU, KV, N, M)                             \
  case ID:                                                          \
    walk<KU, KV, N, M>(su, n, sv, m, a, b, best_key, best_flat);    \
    break;
    MIN_DIST_TILES(MIN_DIST_WALK)
#undef MIN_DIST_WALK
  }
#pragma unroll
  for (int off = GROUP / 2; off > 0; off /= 2) {
    const unsigned other_key = __shfl_xor_sync(0xffffffffu, best_key, off);
    const int other_flat = __shfl_xor_sync(0xffffffffu, best_flat, off);
    merge(other_key, other_flat, best_key, best_flat);
  }
  const int r = row0 + q;
  if (lane % GROUP == 0 && r < n_rows) {
    const int i = best_flat / m, j = best_flat % m;
    const float ux = su[i], uy = su[n + i], vx = sv[j], vy = sv[m + j];
    float* o = out + ((size_t)pr.slot * n_rows + r) * OUT_FIELDS;
    o[0] = sqrtf(sq_dist(ux, uy, vx, vy));  // NaN stays NaN
    o[1] = ux;
    o[2] = uy;
    o[3] = vx;
    o[4] = vy;
    if (idx) {
      const size_t problems = t.n_problems;
      idx[(size_t)pr.slot * n_rows + r] = i;
      idx[(problems + pr.slot) * n_rows + r] = j;
    }
  }
}

}  // namespace

extern "C" {

// sources: n_sources x (base address, row stride, coordinate stride, point
// stride), all of one storage type (dtype: 0 f32, 1 bf16, 2 f16); problems:
// n_problems x (tile, slot, first block, then u, v1, v2 as (source, start,
// count)), in the order the blocks run them; geometry as
// ops/hopper_min_dist.py:min_dist_launch_geometry gives it. Returns the
// first nonzero cudaError_t of the launch, else 0 (cudaErrorInvalidValue for
// a table the kernel does not take).
int min_dist(const long long* sources, int n_sources, const int* problems, int n_problems,
             int n_rows, int dtype, int warps, int blocks, int smem, void* out, void* idx,
             void* stream) {
  if (n_sources < 1 || n_sources > MAX_SOURCES || n_problems < 1 || n_problems > MAX_PROBLEMS ||
      dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  Table t = {};
  for (int s = 0; s < n_sources; ++s) {
    const long long* f = sources + 4 * s;
    t.sources[s] = {reinterpret_cast<const void*>(f[0]), f[1], f[2], f[3]};
  }
  for (int p = 0; p < n_problems; ++p) {
    const int* f = problems + 12 * p;
    t.problems[p] = {f[0], f[1], f[2], {f[3], f[4], f[5]}, {f[6], f[7], f[8]}, {f[9], f[10], f[11]}};
  }
  t.n_problems = n_problems;
  t.dtype = dtype;
  // Above the default 48 KiB a block must opt in; the tract variables need
  // 12.8 KB, so their launches skip the call.
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(min_dist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  min_dist_kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      t, n_rows, static_cast<float*>(out), static_cast<int64_t*>(idx));
  return (int)cudaGetLastError();
}

}  // extern "C"
