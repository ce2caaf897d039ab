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
// The minima run over squared distances and only the winner is square-rooted
// (sqrt is monotone), as the JAX formula ops/distances.py:mean_p2cp does.
//
// Layout: the model's channel-major contours, read as they are (no
// transpose): u (R, 2, N) and v (R, 2, M) f32, the x row then the y row of
// each point set, R = the product of the leading dims; out (R,) f32.
//
// What bounds it: at the metric's shape (R = 12*128*10 rows, N = M = 50) a
// row is 800 B read and 4 B written but 2 * 50 * 50 distance evaluations of
// six operations each, so the f32 operation rate bounds it, not bytes. The
// plain formula instead writes and reads a (R, N, M) f32 tensor per
// direction (154 MB at that shape); the kernel keeps every distance in
// registers.
//
// Design: one warp per row, ROWS rows per block. The block stages its rows'
// u and v in shared memory with coalesced loads; lane l of a row's warp
// takes points l, l + 32, ... of u, then of v, and scans the other set
// (broadcast reads from shared memory) for the least squared distance. The
// two sums of square roots are warp-reduced with shuffles. The last block
// masks the rows past R.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;  // rows (warps) per block

// Sum over lane l of sqrt(min_j |a_l - b_j|^2) for the points of set a that
// lane l owns; a and b are channel-major (x row, then y row).
__device__ __forceinline__ float directed_sum(const float* a, int na, const float* b, int nb,
                                              int lane) {
  float total = 0.0f;
  for (int i = lane; i < na; i += 32) {
    const float ax = a[i], ay = a[na + i];
    float best = INFINITY;
    for (int j = 0; j < nb; ++j) {
      const float dx = ax - b[j];
      const float dy = ay - b[nb + j];
      best = fminf(best, dx * dx + dy * dy);
    }
    total += sqrtf(fmaxf(best, 0.0f));
  }
  return total;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void p2cp_kernel(const float* __restrict__ u, const float* __restrict__ v,
                            float* __restrict__ out, int n_rows, int n, int m) {
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
  const float u_sum = warp_sum(directed_sum(a, n, b, m, lane));
  const float v_sum = warp_sum(directed_sum(b, m, a, n, lane));
  if (lane == 0) out[row0 + w] = (u_sum / n + v_sum / m) * 0.5f;
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (the wrapper refuses larger shapes).
size_t p2cp_smem_bytes(int n, int m) { return (size_t)ROWS * 2 * (n + m) * sizeof(float); }

// Returns the first nonzero cudaError_t of the launch, else 0.
int p2cp(const void* u, const void* v, void* out, int n_rows, int n, int m, void* stream) {
  const size_t smem = p2cp_smem_bytes(n, m);
  cudaError_t err = cudaFuncSetAttribute(p2cp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rows + ROWS - 1) / ROWS;
  p2cp_kernel<<<blocks, ROWS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(v), static_cast<float*>(out),
      n_rows, n, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
