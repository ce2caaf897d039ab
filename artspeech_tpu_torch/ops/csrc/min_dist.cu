// Minimum pairwise distance per row and its argmin pair, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel artspeech_tpu/ops/pallas_kernels.py:_min_dist_kernel
// (pallas_call in _rows_call, reached from min_distance_pallas), which
// computes what the XLA formula ops/distances.py:min_distance computes. For
// each row of two point sets u (N points) and v (M points):
//
//   (i*, j*) = argmin over the flat index i*M + j of |u_i - v_j|^2
//   dist     = sqrt(max(|u_i* - v_j*|^2, 0))
//
// Ties go to the smallest flat index i*M + j (jnp.argmin on the flat axis).
// A NaN distance counts as smaller than any number, as jnp.argmin and
// torch.argmin treat it. Each squared distance is rounded as the plain
// version rounds it: the difference, both squares and their sum once each
// (__fsub_rn/__fmul_rn/__fadd_rn, so nvcc cannot contract them into FMAs).
// Both sides then pick the same pair, near-ties included.
//
// Layout: the model's channel-major contours, read as they are: u (R, 2, N)
// and v (R, 2, M) f32, the x row then the y row of each point set; outputs
// dist (R,) f32 and the pair as int64 i (R,), j (R,), the index type that
// torch.gather takes.
//
// What bounds it: at the tract variables' shapes (R = 12*128 rows, N x M from
// 15 x 25 to 50 x 50) a row is at most 800 B read and 20 B written but up to
// 2,500 point pairs of about six operations each, so the f32 operation rate
// bounds it, not bytes; at these sizes the whole call is a few microseconds
// of work and the launch costs more. The kernel keeps every distance in
// registers; the plain formula writes and reads an (R, N, M) tensor.
//
// Design (as p2cp.cu): one warp per row, ROWS rows per block. The block
// stages its rows' u and v in shared memory with coalesced loads; lane l
// takes points l, l + 32, ... of u in increasing order and scans v (broadcast
// reads from shared memory) in increasing order, keeping (best, flat index)
// with a strict "better" test, so each lane holds the first minimum of its
// points. A shuffle reduction over the warp compares lexicographically:
// value first, then index. The last block masks the rows past R.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;  // rows (warps) per block

// (a, ia) before (b, ib): NaN first, then the smaller value, then the smaller
// flat index.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a < b || (a == b && ia < ib);
}

__global__ void min_dist_kernel(const float* __restrict__ u, const float* __restrict__ v,
                                float* __restrict__ dist, int64_t* __restrict__ idx_u,
                                int64_t* __restrict__ idx_v, int n_rows, int n, int m) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, n_rows - row0);
  float* su = smem;                 // (ROWS, 2, N)
  float* sv = smem + ROWS * 2 * n;  // (ROWS, 2, M)
  const float* gu = u + (size_t)row0 * 2 * n;
  const float* gv = v + (size_t)row0 * 2 * m;
  for (int i = threadIdx.x; i < rows * 2 * n; i += blockDim.x) su[i] = gu[i];
  for (int i = threadIdx.x; i < rows * 2 * m; i += blockDim.x) sv[i] = gv[i];
  __syncthreads();

  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= rows) return;
  const float* a = su + w * 2 * n;
  const float* b = sv + w * 2 * m;

  float best = INFINITY;
  int best_idx = INT_MAX;  // no point of this lane yet (n < 32 leaves lanes idle)
  for (int i = lane; i < n; i += 32) {
    const float ax = a[i], ay = a[n + i];
    for (int j = 0; j < m; ++j) {
      const float dx = __fsub_rn(ax, b[j]);
      const float dy = __fsub_rn(ay, b[m + j]);
      const float sq = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const int flat = i * m + j;
      if (better(sq, flat, best, best_idx)) {
        best = sq;
        best_idx = flat;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, best, off);
    const int other_idx = __shfl_xor_sync(0xffffffffu, best_idx, off);
    if (better(other, other_idx, best, best_idx)) {
      best = other;
      best_idx = other_idx;
    }
  }
  if (lane == 0) {
    const int r = row0 + w;
    dist[r] = isnan(best) ? best : sqrtf(fmaxf(best, 0.0f));  // fmaxf(NaN, 0) would be 0
    idx_u[r] = best_idx / m;
    idx_v[r] = best_idx % m;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (the wrapper refuses larger shapes).
size_t min_dist_smem_bytes(int n, int m) { return (size_t)ROWS * 2 * (n + m) * sizeof(float); }

// Returns the first nonzero cudaError_t of the launch, else 0.
int min_dist(const void* u, const void* v, void* dist, void* idx_u, void* idx_v, int n_rows,
             int n, int m, void* stream) {
  const size_t smem = min_dist_smem_bytes(n, m);
  // Above the default 48 KiB a block must opt in; the tract variables' shapes
  // need at most 6.4 KB, so their launches skip the call.
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        min_dist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_rows + ROWS - 1) / ROWS;
  min_dist_kernel<<<blocks, ROWS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(v), static_cast<float*>(dist),
      static_cast<int64_t*>(idx_u), static_cast<int64_t*>(idx_v), n_rows, n, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
