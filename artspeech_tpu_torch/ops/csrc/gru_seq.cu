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
// What bounds it: T dependent steps, each a (tile, H) x (H, 3H) product and
// the elementwise gates. At the bench shape (B = 16, T = 128, H = 128) the
// products are 1.6 GFLOP in all against ~2.2 MB of x_proj and out: the
// bound is the f32 operation rate (~0.02 ms), but the time is the latency of
// T sequential steps on the few SMs that hold a batch tile.
//
// Design. One block owns one tile of `tile` batch rows (the TPU kernel's
// batch_tile, 16 by default) and loops over all T steps; the carry lives in
// shared memory in f32, one row a batch row. Each step:
//   1. thread c computes hg[r][c] for every row r of the tile (BT register
//      accumulators, BT the tile rounded up to 4, 8, 16 or 32), looping over
//      its gate columns c = tid, tid + blockDim, ...;
//   2. __syncthreads();
//   3. the block runs the gates over the (tile, H) elements, reading
//      x_proj[b, t] row by row (neighbouring threads on neighbouring
//      addresses) and updating the carry and out;
//   4. __syncthreads().
// Where W_h fits beside the carry and the gates in the 232,448 B of shared
// memory a block may use (H = 128, tile 16: 196,608 + 32,768 B), it is
// loaded once and stays resident, as in the TPU kernel; otherwise (wide H or
// a large tile) the product reads W_h from global memory every step, where
// the 50 MB L2 holds it (H = 1024: 12 MiB). Neighbouring threads read
// neighbouring columns either way. Splitting the columns of a tile over a
// cluster, tensor cores and prefetch of x_proj are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory one Hopper block may use
constexpr int MAX_THREADS = 512;

__device__ __forceinline__ float sigmoid_f32(float v) { return 1.0f / (1.0f + expf(-v)); }

__host__ __device__ inline int round_tile(int tile) {
  return tile <= 4 ? 4 : tile <= 8 ? 8 : tile <= 16 ? 16 : 32;
}

// Shared memory of a block: the carry (BT, H) and the gates (BT, 3H) in f32,
// plus W_h (H, 3H) when resident.
__host__ __device__ inline size_t smem_bytes(int hidden, int bt, bool resident) {
  const size_t gates = 3 * (size_t)hidden;
  return sizeof(float) * ((size_t)bt * (hidden + gates) + (resident ? hidden * gates : 0));
}

template <int BT, bool RESIDENT>
__global__ void __launch_bounds__(MAX_THREADS)
gru_seq_kernel(const float* __restrict__ xp, const float* __restrict__ wh,
               const float* __restrict__ bh, const float* __restrict__ mask,
               float* __restrict__ out, int batch, int n_steps, int hidden, int tile) {
  extern __shared__ __align__(16) float smem[];
  const int gates = 3 * hidden;
  float* h_s = smem;                // (BT, H)
  float* g_s = h_s + BT * hidden;   // (BT, 3H)
  float* w_s = g_s + BT * gates;    // (H, 3H), resident only
  const float* w = RESIDENT ? w_s : wh;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * tile;
  const int rows = min(tile, batch - b0);

  if (RESIDENT)
    for (int i = tid; i < hidden * gates; i += blockDim.x) w_s[i] = wh[i];
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
        const float wk = w[(size_t)k * gates + c];
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(h_s[r * hidden + k], wk, acc[r]);
      }
      const float bias = bh[c];
#pragma unroll
      for (int r = 0; r < BT; ++r) g_s[r * gates + c] = acc[r] + bias;
    }
    __syncthreads();

    // 3. The gates over the tile's (rows, H) elements.
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

template <int BT>
int launch(const float* xp, const float* wh, const float* bh, const float* mask, float* out,
           int batch, int n_steps, int hidden, int tile, cudaStream_t stream) {
  const bool resident = smem_bytes(hidden, BT, true) <= MAX_SMEM;
  const size_t smem = smem_bytes(hidden, BT, resident);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int gates = 3 * hidden;
  const int threads = gates >= MAX_THREADS ? MAX_THREADS : (gates + 31) / 32 * 32;
  const int blocks = (batch + tile - 1) / tile;
  cudaError_t err;
  if (resident) {
    err = cudaFuncSetAttribute(gru_seq_kernel<BT, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gru_seq_kernel<BT, true><<<blocks, threads, smem, stream>>>(xp, wh, bh, mask, out, batch,
                                                                n_steps, hidden, tile);
  } else {
    err = cudaFuncSetAttribute(gru_seq_kernel<BT, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gru_seq_kernel<BT, false><<<blocks, threads, smem, stream>>>(xp, wh, bh, mask, out, batch,
                                                                 n_steps, hidden, tile);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when W_h stays resident in shared memory at this width and tile, else 0.
int gru_seq_resident(int hidden, int tile) {
  return smem_bytes(hidden, round_tile(tile), true) <= MAX_SMEM;
}

// x_proj (B, T, 3H), w_h (H, 3H), b_h (3H), mask (B, T), out (B, T, H), all
// f32 and contiguous; 1 <= H <= 1024, 1 <= tile <= 32. Returns the first
// nonzero cudaError_t of the launch, else 0.
int gru_seq(const void* xp, const void* wh, const void* bh, const void* mask, void* out,
            int batch, int n_steps, int hidden, int tile, void* stream) {
  if (batch < 1 || n_steps < 1 || hidden < 1 || hidden > 1024 || tile < 1 || tile > 32)
    return (int)cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(xp);
  const float* w = static_cast<const float*>(wh);
  const float* b = static_cast<const float*>(bh);
  const float* m = static_cast<const float*>(mask);
  float* y = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (round_tile(tile)) {
    case 4: return launch<4>(x, w, b, m, y, batch, n_steps, hidden, tile, s);
    case 8: return launch<8>(x, w, b, m, y, batch, n_steps, hidden, tile, s);
    case 16: return launch<16>(x, w, b, m, y, batch, n_steps, hidden, tile, s);
    default: return launch<32>(x, w, b, m, y, batch, n_steps, hidden, tile, s);
  }
}

}  // extern "C"
