// Masked GRU forward time loop for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel artspeech_tpu/ops/pallas_gru.py:_gru_fwd_kernel
// (pallas_call in _gru_forward), reached from ops/gru.py:GRULayer. It computes
// the same function without the h_bound side output: the backward kernel
// (gru_bwd.cu) reads the carry before every step from ys.
//
//   hg = h @ W_h + b_h                      (f32 accumulation)
//   r  = sigmoid(x_r + hg_r)
//   z  = sigmoid(x_z + hg_z)
//   n  = tanh(x_n + r * hg_n)
//   h' = mask ? (1 - z) * n + z * h : h     (carry frozen on padded steps)
//
// with x = x_proj[t] the hoisted input projection, gate order r, z, n, and
// all gate math in f32 for f32, bf16 and f16 storage. The carry is rounded to
// the storage type after every step, as the TPU kernel's carry is. A reverse
// direction walks time backward and stores outputs at their own time index.
//
// Layout: x_proj (T, B, D*3H), w_h (D, H, 3H), b_h (D, 3H), mask (T, B) f32,
// ys (T, B, D*H). D is 1 or 2: with D == 2 both directions of a bidirectional
// layer run in one launch and write their halves of the concatenated output.
// Direction d walks time backward iff bit d of rev_bits is set.
//
// What bounds it: T dependent steps, each a small (B_tile, H) x (H, 3H)
// product followed by elementwise gates. At the thesis batch (B = 8..16) the
// card is nearly idle: the time is the latency of T sequential steps, not
// bytes (x_proj is read once, ys written once) or operations.
//
// Design: the TPU kernel's sequential grid over time chunks has no Hopper
// counterpart, so the time loop runs inside the kernel. The step is the
// cluster step of rnn_fwd_step.cuh with its GRU cell (shared with gru_seq.cu,
// and with lstm_fwd.cu's LSTM cell): a thread-block cluster of C CTAs a
// (direction, tile of rows), each CTA holding the W_h columns of H/C hidden
// units in shared memory, the carry crossing the cluster through
// distributed shared memory once a step, and x_proj and the mask loaded a
// step ahead. The wrapper (hopper_gru.gru_launch_geometry with 3 gates)
// chooses C and the rows a cluster walks; this file lays the time-major,
// D-direction addressing over that step and launches it with
// cudaLaunchKernelEx.
//
// The wide instance. Where no cluster holds W_h in shared memory (the rule's
// `resident` is false: f32 above H = 384 or so, or H with no even split),
// gru_fwd_wide_kernel runs the same step with W_h read from global memory
// every step (the (H, 3H) f32 W_h at H = 1024 is 12 MiB, held by the 50 MB
// L2): one block of 512 threads a (direction, tile of BT rows), each thread
// looping over its gate columns, scalar reads of h. Only the carry and the
// gates stay in shared memory (BT * 4H f32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "rnn_fwd_step.cuh"

namespace {

using rnn_fwd::from_f32;
using rnn_fwd::sigmoid_f32;
using rnn_fwd::to_f32;

constexpr int BT = 4;  // batch rows a block of the wide instance

template <typename T, int R>
__global__ void __launch_bounds__(rnn_fwd::MAX_THREADS)
gru_fwd_cluster_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                       const T* __restrict__ bh, const float* __restrict__ mask,
                       T* __restrict__ ys, int n_steps, int batch, int hidden, int n_dir,
                       int rev_bits) {
  const int d = blockIdx.y;
  const rnn_fwd::GruCell<T, rnn_fwd::TimeMajor<T, 3>> cell{
      {xp, wh + (size_t)d * hidden * 3 * hidden, bh + (size_t)d * 3 * hidden, mask, ys, batch,
       hidden, n_dir, d, ((rev_bits >> d) & 1) != 0}};
  rnn_fwd::cluster_steps<T, R>(cell, n_steps, batch, hidden);
}

constexpr int WIDE_THREADS = 512;

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS)
gru_fwd_wide_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                    const T* __restrict__ bh, const float* __restrict__ mask,
                    T* __restrict__ ys, int n_steps, int batch, int hidden, int n_dir,
                    int rev_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int gates = 3 * hidden;
  float* h_s = reinterpret_cast<float*>(smem);  // (BT, H)
  float* g_s = h_s + BT * hidden;               // (BT, 3H)

  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const bool reverse = (rev_bits >> d) & 1;
  const T* w_d = wh + (size_t)d * hidden * gates;
  const T* b_d = bh + (size_t)d * gates;
  for (int i = tid; i < BT * hidden; i += blockDim.x) h_s[i] = 0.0f;
  __syncthreads();

  const size_t x_row = (size_t)n_dir * gates;
  const size_t y_row = (size_t)n_dir * hidden;

  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    for (int c = tid; c < gates; c += blockDim.x) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < hidden; ++k) {
        const float wk = to_f32(w_d[(size_t)k * gates + c]);
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(h_s[r * hidden + k], wk, acc[r]);
      }
      const float bias = to_f32(b_d[c]);
#pragma unroll
      for (int r = 0; r < BT; ++r) g_s[r * gates + c] = acc[r] + bias;
    }
    __syncthreads();

    for (int e = tid; e < BT * hidden; e += blockDim.x) {
      const int r = e / hidden;
      const int j = e - r * hidden;
      const int b = b0 + r;
      if (b >= batch) continue;
      const T* x = xp + ((size_t)t * batch + b) * x_row + (size_t)d * gates;
      const float* g = g_s + r * gates;
      const float rg = sigmoid_f32(to_f32(x[j]) + g[j]);
      const float zg = sigmoid_f32(to_f32(x[hidden + j]) + g[hidden + j]);
      const float ng = tanhf(to_f32(x[2 * hidden + j]) + rg * g[2 * hidden + j]);
      const float h_prev = h_s[e];
      const float cand = (1.0f - zg) * ng + zg * h_prev;
      const float m = mask[(size_t)t * batch + b];
      const T out = from_f32<T>(m != 0.0f ? cand : h_prev);
      h_s[e] = to_f32(out);
      ys[((size_t)t * batch + b) * y_row + (size_t)d * hidden + j] = out;
    }
    __syncthreads();
  }
}


template <typename T>
int launch_wide(const void* xp, const void* wh, const void* bh, const void* mask, void* ys,
                int n_steps, int batch, int hidden, int n_dir, int rev_bits, int smem,
                cudaStream_t stream) {
  if ((size_t)smem < (size_t)BT * 4 * hidden * sizeof(float) || (size_t)smem > rnn_fwd::MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gru_fwd_wide_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((batch + BT - 1) / BT, n_dir);
  gru_fwd_wide_kernel<T><<<grid, WIDE_THREADS, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(wh), static_cast<const T*>(bh),
      static_cast<const float*>(mask), static_cast<T*>(ys), n_steps, batch, hidden, n_dir,
      rev_bits);
  return (int)cudaGetLastError();
}

template <typename T>
void (*cluster_kernel(int rows))(const T*, const T*, const T*, const float*, T*, int, int, int,
                                 int, int) {
  switch (rows) {
    case 2: return gru_fwd_cluster_kernel<T, 2>;
    case 4: return gru_fwd_cluster_kernel<T, 4>;
    default: return gru_fwd_cluster_kernel<T, 8>;
  }
}

template <typename T>
int launch_cluster(const void* xp, const void* wh, const void* bh, const void* mask, void* ys,
                   int n_steps, int batch, int hidden, int n_dir, int rev_bits, int cluster,
                   int rows, int smem, cudaStream_t stream) {
  if (!rnn_fwd::valid_geometry(hidden, cluster, rows, smem, 3, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  return rnn_fwd::launch_cluster(
      cluster_kernel<T>(rows), cluster, (batch + rows - 1) / rows, n_dir,
      rnn_fwd::cluster_threads(hidden, cluster), smem, stream, static_cast<const T*>(xp),
      static_cast<const T*>(wh), static_cast<const T*>(bh), static_cast<const float*>(mask),
      static_cast<T*>(ys), n_steps, batch, hidden, n_dir, rev_bits);
}

template <typename T>
int launch(const void* xp, const void* wh, const void* bh, const void* mask, void* ys,
           int n_steps, int batch, int hidden, int n_dir, int rev_bits, int cluster, int rows,
           int smem, cudaStream_t stream) {
  if (cluster == 0)
    return launch_wide<T>(xp, wh, bh, mask, ys, n_steps, batch, hidden, n_dir, rev_bits, smem,
                          stream);
  return launch_cluster<T>(xp, wh, bh, mask, ys, n_steps, batch, hidden, n_dir, rev_bits,
                           cluster, rows, smem, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; 1 <= H <= 1024; n_dir 1 or 2. The launch
// geometry comes from hopper_gru.gru_launch_geometry with 3 gates: cluster
// CTAs (0: the wide instance), rows a cluster walks (2, 4 or 8), and the
// dynamic shared memory in bytes. Returns the first nonzero cudaError_t of the
// launch (a geometry the kernel does not take, or a refused cluster), else 0.
int gru_fwd(const void* xp, const void* wh, const void* bh, const void* mask, void* ys,
            int n_steps, int batch, int hidden, int n_dir, int rev_bits, int dtype, int cluster,
            int rows, int smem, void* stream) {
  if (hidden < 1 || hidden > 1024 || n_dir < 1 || n_dir > 2 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xp, wh, bh, mask, ys, n_steps, batch, hidden, n_dir, rev_bits, cluster,
                         rows, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xp, wh, bh, mask, ys, n_steps, batch, hidden, n_dir, rev_bits,
                                 cluster, rows, smem, s);
  return launch<__half>(xp, wh, bh, mask, ys, n_steps, batch, hidden, n_dir, rev_bits,
                        cluster, rows, smem, s);
}

}  // extern "C"
