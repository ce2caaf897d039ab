// Mean bidirectional point-to-closest-point (P2CP) distance per row, for
// Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel artspeech_tpu/ops/pallas_kernels.py:_p2cp_kernel
// (pallas_call in _rows_call, reached from mean_p2cp_pallas). For each row of
// two point sets u (N points) and v (M points):
//
//   u2cp_i = min_j |u_i - v_j|,  v2cp_j = min_i |u_i - v_j|
//   out    = (mean_i u2cp_i + mean_j v2cp_j) / 2
//
// The minima run over squared distances and only the winners are
// square-rooted (sqrt is monotone), as the JAX formula
// ops/distances.py:mean_p2cp_channel_major does. A NaN coordinate makes its
// row NaN, as jnp.min and the plain version give it: the minima propagate
// NaN (point_pairs::min_nan).
//
// Layout: the model's channel-major contours: u (R, 2, N) and v (R, 2, M)
// f32, the x row then the y row of each point set, R = the product of the
// leading dims; out (R,) f32.
//
// What bounds it: at the metric's shape (R = 12*128*10 rows, N = M = 50) a
// row is 800 B read and 4 B written but 2,500 point pairs, each a squared
// distance (two subtractions, a multiply and an FMA) and two minima, so the
// f32 issue rate bounds it, not bytes. The plain formula writes and reads a
// (R, N, M) f32 tensor per direction instead.
//
// Design: the lane grid of point_pairs.cuh. Each squared
// distance is computed once, in registers, and updates both the lane's
// minimum for its u point (the row minimum) and for its v point (the column
// minimum). After a block the column minima are reduced over the group's
// LANES_U lanes and the row minima, after the last chunk of a tile, over its
// LANES_V lanes, both by reduce_scatter_min, which leaves each lane a few winners to
// square-root. The contours' 50 x 50 rows take a tile compiled with that
// shape (13 x 13 points a lane, 8 % of the grid padding). Where N needs more
// than one u tile, the column minima of a chunk are kept in shared memory
// from tile to tile. The sums go in a fixed order, so a second launch gives
// the same bits. The launch rule (tile, warps a CTA, shared memory) is
// ops/hopper_p2cp.py:p2cp_launch_geometry. On the H100 it runs at about a
// quarter of its bound (seven operations a pair at the f32 peak): the f32
// pipe and the instructions around the pair loop (staging, reductions,
// roots) hold it (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "point_pairs.cuh"

// The (KU, KV, N, M) tiles compiled, N = M = 0 for any shape;
// ops/hopper_p2cp.py:TILES lists the same.
#define P2CP_TILES(X) X(13, 13, 50, 50) X(8, 8, 0, 0)

namespace {

using namespace point_pairs;

template <int KU, int KV, int NC, int MC>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    p2cp_kernel(const float* __restrict__ u, const float* __restrict__ v, float* __restrict__ out,
                int n_rows, int n_arg, int m_arg) {
  constexpr int KUP = padded(KU, LANES_V), KVP = padded(KV, LANES_U);
  constexpr int SPAN_U = LANES_U * KU, SPAN_V = LANES_V * KV;
  const int n = NC ? NC : n_arg, m = MC ? MC : m_arg;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * (blockDim.x / 32) + warp) * ROWS_A_WARP;
  if (row0 >= n_rows) return;  // the whole warp

  // The warp's rows: (ROWS_A_WARP, 2, N), then (ROWS_A_WARP, 2, M), then
  // the column minima (ROWS_A_WARP, M) where N takes more than one u tile.
  const bool tiles = n > SPAN_U;
  float* wu = smem + warp * ROWS_A_WARP * (2 * (n + m) + (tiles ? m : 0));
  float* wv = wu + ROWS_A_WARP * 2 * n;
  warp_copy_rows(wu, u, 2 * n, wv, v, 2 * m, row0, n_rows, lane);
  __syncwarp();

  const int q = lane / GROUP, a = lane % GROUP / LANES_V, b = lane % LANES_V;
  const float* su = wu + q * 2 * n;
  const float* sv = wv + q * 2 * m;
  float* scol = wv + ROWS_A_WARP * 2 * m + q * m;
  float u_sum = 0.0f, v_sum = 0.0f;
  for (int i0 = 0; i0 < n; i0 += SPAN_U) {
    float ux[KU], uy[KU], rmin[KUP];
#pragma unroll
    for (int k = 0; k < KU; ++k) {
      const int i = min(i0 + a + LANES_U * k, n - 1);
      ux[k] = su[i];
      uy[k] = su[n + i];
    }
#pragma unroll
    for (int k = 0; k < KUP; ++k) rmin[k] = INFINITY;
    for (int j0 = 0; j0 < m; j0 += SPAN_V) {
      float vx[KV], vy[KV], cmin[KVP];
#pragma unroll
      for (int l = 0; l < KV; ++l) {
        const int j = min(j0 + b + LANES_V * l, m - 1);
        vx[l] = sv[j];
        vy[l] = sv[m + j];
      }
#pragma unroll
      for (int l = 0; l < KVP; ++l) cmin[l] = INFINITY;
#pragma unroll
      for (int k = 0; k < KU; ++k) {
#pragma unroll
        for (int l = 0; l < KV; ++l) {
          const float dx = ux[k] - vx[l], dy = uy[k] - vy[l];
          const float d = dx * dx + dy * dy;
          rmin[k] = min_nan(rmin[k], d);
          cmin[l] = min_nan(cmin[l], d);
        }
      }
      reduce_scatter_min<KVP, LANES_U, LANES_V>(cmin, a);
#pragma unroll
      for (int s = 0; s < KVP / LANES_U; ++s) {
        const int l = KVP / LANES_U * a + s, j = j0 + b + LANES_V * l;
        if (l < KV && j < m) {
          if (!tiles)
            v_sum += sqrtf(cmin[s]);
          else
            scol[j] = i0 == 0 ? cmin[s] : min_nan(scol[j], cmin[s]);
        }
      }
    }
    reduce_scatter_min<KUP, LANES_V, 1>(rmin, b);
#pragma unroll
    for (int s = 0; s < KUP / LANES_V; ++s) {
      const int k = KUP / LANES_V * b + s, i = i0 + a + LANES_U * k;
      if (k < KU && i < n) u_sum += sqrtf(rmin[s]);
    }
  }
  if (tiles) {
    // Each column's minimum was kept by one lane of the group; read them all.
    __syncwarp();
    for (int j = lane % GROUP; j < m; j += GROUP) v_sum += sqrtf(scol[j]);
  }
  u_sum = group_sum(u_sum);
  v_sum = group_sum(v_sum);
  const int r = row0 + q;
  if (lane % GROUP == 0 && r < n_rows) out[r] = (u_sum / n + v_sum / m) * 0.5f;
}

}  // namespace

extern "C" {

// Launches the (points_u, points_v) tile, compiled with the shape where
// `exact` is set, with `warps` warps a CTA and `smem` bytes of shared
// memory, as ops/hopper_p2cp.py:p2cp_launch_geometry gives them (above the
// default 48 KiB a block must opt in; the contours' rows need 6.4 KB).
// Returns the first nonzero cudaError_t of the launch, else 0
// (cudaErrorInvalidValue for a tile that is not compiled).
int p2cp(const void* u, const void* v, void* out, int n_rows, int n, int m, int points_u,
         int points_v, int exact, int warps, int smem, void* stream) {
  const int rows_a_cta = warps * ROWS_A_WARP;
  const int blocks = (n_rows + rows_a_cta - 1) / rows_a_cta;
#define P2CP_LAUNCH(KU, KV, N, M)                                                                 \
  if (points_u == KU && points_v == KV && exact == (N != 0) && (N == 0 || (n == N && m == M))) { \
    if (smem > 48 * 1024) {                                                                      \
      cudaError_t err = cudaFuncSetAttribute(                                                    \
          p2cp_kernel<KU, KV, N, M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);         \
      if (err != cudaSuccess) return (int)err;                                                   \
    }                                                                                            \
    p2cp_kernel<KU, KV, N, M><<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(  \
        static_cast<const float*>(u), static_cast<const float*>(v), static_cast<float*>(out),   \
        n_rows, n, m);                                                                           \
    return (int)cudaGetLastError();                                                              \
  }
  P2CP_TILES(P2CP_LAUNCH)
#undef P2CP_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
