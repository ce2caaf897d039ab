// Batch-major masked GRU recurrence, one direction, forward only, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel artspeech_tpu/ops/pallas_kernels.py:_gru_seq_kernel
// (pallas_call in gru_sequence_pallas). The JAX package keeps that kernel as
// a measured reference beside its production GRU (no model path calls it);
// the port keeps this one for the same reason. For every batch row b:
//
//   h_0 = 0
//   hg  = h @ W_h + b_h                      (f32)
//   r   = sigmoid(x_r + hg_r);  z = sigmoid(x_z + hg_z)
//   n   = tanh(x_n + r * hg_n)
//   h'  = m * ((1 - z) * n + z * h) + (1 - m) * h     (m = mask[b, t])
//   out[b, t] = h'
//
// with x = x_proj[b, t], gate order r, z, n, everything f32 (the TPU kernel
// takes f32 only).
//
// Layout: batch-major, as the TPU kernel's: x_proj (B, T, 3H), w_h (H, 3H),
// b_h (3H), mask (B, T) f32, out (B, T, H). The kernel reads x_proj and
// writes out in this layout; no transposed copy is made.
//
// What bounds it: T dependent steps, each a (rows, H) x (H, 3H) product and
// the elementwise gates. At the bench shape (B = 16, T = 128, H = 128) the
// products are 1.6 GFLOP in all against ~2.2 MB of x_proj and out: the
// bound is the f32 operation rate (~0.003 ms), but the time is the latency
// of T sequential steps.
//
// Design: the cluster step of rnn_fwd_step.cuh with its GRU cell, the one
// gru_fwd.cu runs, with batch-major addressing and the blend above as its
// mask formula. The TPU
// kernel's batch tile (16 rows a grid step) is a TPU shape: on the card one
// 16-row block left a step's 384 x 16 x 128 product on one SM. The launch
// geometry comes from hopper_gru.gru_launch_geometry, the same rule and the
// same geometry as gru_fwd with one direction (3 gates); the TPU's batch
// tile is not passed (it changes neither the launch nor the result).
//
// The wide instance. Where no cluster holds W_h in shared memory (the
// rule's `resident` is false), gru_seq_kernel runs one block of 512
// threads a tile of BT rows, reading W_h through the L2 every step (H = 1024:
// 12 MiB), the carry and the gates in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rnn_fwd_step.cuh"

namespace {

using rnn_fwd::sigmoid_f32;

constexpr int BT = 4;  // batch rows a block of the wide instance
constexpr int WIDE_THREADS = 512;

// Batch-major addressing for rnn_fwd::GruCell; the mask blends.
struct BatchMajor {
  const float* xp;
  const float* w;
  const float* b;
  const float* mask_;
  float* out;
  int n_steps, hidden;
  __device__ int time(int s, int) const { return s; }
  __device__ const float* x(int t, int bi) const {
    return xp + ((size_t)bi * n_steps + t) * 3 * hidden;
  }
  __device__ float* y(int t, int bi) const { return out + ((size_t)bi * n_steps + t) * hidden; }
  __device__ float mask(int t, int bi) const { return mask_[(size_t)bi * n_steps + t]; }
  __device__ static float combine(float m, float cand, float h) {
    return m * cand + (1.0f - m) * h;
  }
};

template <int R>
__global__ void __launch_bounds__(rnn_fwd::MAX_THREADS)
gru_seq_cluster_kernel(const float* __restrict__ xp, const float* __restrict__ wh,
                       const float* __restrict__ bh, const float* __restrict__ mask,
                       float* __restrict__ out, int batch, int n_steps, int hidden) {
  const rnn_fwd::GruCell<float, BatchMajor> cell{{xp, wh, bh, mask, out, n_steps, hidden}};
  rnn_fwd::cluster_steps<float, R>(cell, n_steps, batch, hidden);
}

__global__ void __launch_bounds__(WIDE_THREADS)
gru_seq_kernel(const float* __restrict__ xp, const float* __restrict__ wh,
               const float* __restrict__ bh, const float* __restrict__ mask,
               float* __restrict__ out, int batch, int n_steps, int hidden) {
  extern __shared__ __align__(16) float smem[];
  const int gates = 3 * hidden;
  float* h_s = smem;               // (BT, H)
  float* g_s = h_s + BT * hidden;  // (BT, 3H)
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BT;
  const int rows = min(BT, batch - b0);

  for (int i = tid; i < BT * hidden; i += blockDim.x) h_s[i] = 0.0f;
  __syncthreads();

  for (int t = 0; t < n_steps; ++t) {
    // 1. hg = h @ W_h + b_h for every row of the tile (rows past `rows`
    //    hold a zero carry and are never read back).
    for (int c = tid; c < gates; c += blockDim.x) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < hidden; ++k) {
        const float wk = wh[(size_t)k * gates + c];
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(h_s[r * hidden + k], wk, acc[r]);
      }
      const float bias = bh[c];
#pragma unroll
      for (int r = 0; r < BT; ++r) g_s[r * gates + c] = acc[r] + bias;
    }
    __syncthreads();

    // 2. The gates over the tile's (rows, H) elements.
    for (int e = tid; e < rows * hidden; e += blockDim.x) {
      const int r = e / hidden;
      const int j = e - r * hidden;
      const size_t bt = (size_t)(b0 + r) * n_steps + t;
      const float* x = xp + bt * gates;
      const float* g = g_s + r * gates;
      const float rg = sigmoid_f32(x[j] + g[j]);
      const float zg = sigmoid_f32(x[hidden + j] + g[hidden + j]);
      const float ng = tanhf(x[2 * hidden + j] + rg * g[2 * hidden + j]);
      const float h_prev = h_s[r * hidden + j];
      const float m = mask[bt];
      const float h_new = m * ((1.0f - zg) * ng + zg * h_prev) + (1.0f - m) * h_prev;
      h_s[r * hidden + j] = h_new;
      out[bt * hidden + j] = h_new;
    }
    __syncthreads();
  }
}

int launch_wide(const float* xp, const float* wh, const float* bh, const float* mask, float* out,
                int batch, int n_steps, int hidden, int smem, cudaStream_t stream) {
  if ((size_t)smem < (size_t)BT * 4 * hidden * sizeof(float) || (size_t)smem > rnn_fwd::MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(gru_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gru_seq_kernel<<<(batch + BT - 1) / BT, WIDE_THREADS, smem, stream>>>(xp, wh, bh, mask, out, batch,
                                                                   n_steps, hidden);
  return (int)cudaGetLastError();
}

void (*cluster_kernel(int rows))(const float*, const float*, const float*, const float*, float*,
                                 int, int, int) {
  switch (rows) {
    case 2: return gru_seq_cluster_kernel<2>;
    case 4: return gru_seq_cluster_kernel<4>;
    default: return gru_seq_cluster_kernel<8>;
  }
}

}  // namespace

extern "C" {

// x_proj (B, T, 3H), w_h (H, 3H), b_h (3H), mask (B, T), out (B, T, H), all
// f32 and contiguous; 1 <= H <= 1024. The launch geometry comes from
// hopper_gru.gru_launch_geometry (one direction, 3 gates, f32): cluster
// CTAs (0: the wide instance), rows a cluster walks (2, 4 or 8), and the
// dynamic shared memory in bytes. Returns the first nonzero cudaError_t
// of the launch (a geometry the kernel does not take, or a refused
// cluster), else 0.
int gru_seq(const void* xp, const void* wh, const void* bh, const void* mask, void* out,
            int batch, int n_steps, int hidden, int cluster, int rows, int smem, void* stream) {
  if (batch < 1 || n_steps < 1 || hidden < 1 || hidden > 1024)
    return (int)cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(xp);
  const float* w = static_cast<const float*>(wh);
  const float* b = static_cast<const float*>(bh);
  const float* m = static_cast<const float*>(mask);
  float* y = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 0) return launch_wide(x, w, b, m, y, batch, n_steps, hidden, smem, s);
  if (!rnn_fwd::valid_geometry(hidden, cluster, rows, smem, 3, sizeof(float)))
    return (int)cudaErrorInvalidValue;
  return rnn_fwd::launch_cluster(cluster_kernel(rows), cluster, (batch + rows - 1) / rows, 1,
                                 rnn_fwd::cluster_threads(hidden, cluster), smem, s, x, w, b, m,
                                 y, batch, n_steps, hidden);
}

}  // extern "C"
