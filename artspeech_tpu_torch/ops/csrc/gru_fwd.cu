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
// all gate math in f32 for both f32 and bf16 storage. The carry is rounded to
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
// counterpart, so one thread block owns one (direction, batch tile of
// BT rows) and loops over all T steps inside. W_h is loaded once into dynamic
// shared memory and stays resident (H = 128: 196,608 B in f32, 98,304 B in
// bf16); the carry h lives in shared memory in f32. Each step:
//   1. thread c computes column c of hg for the BT rows of the tile, reading
//      W_h[k][c] (consecutive threads, consecutive banks) and h[r][k] as
//      float4 broadcasts;
//   2. __syncthreads();
//   3. threads run the elementwise gates over the (BT, H) tile, read x_proj
//      and the mask, update h in shared memory and write ys;
//   4. __syncthreads().
// Small batch tiles (BT = 4) spread the batch over more SMs, which shortens
// each step; tensor cores (wgmma), TMA prefetch of x_proj and keeping W_h in
// registers across a cluster are left for later work.
//
// The wide instance. The resident kernel needs H % 4 == 0 (float4 reads of
// h), 3H <= 1024 (a thread a column) and W_h in shared memory (f32 up to
// H = 136, bf16 up to H = 188). Every other H up to 1024 takes
// gru_fwd_wide_kernel: the same step with W_h read from global memory every
// step (the (H, 3H) f32 W_h at H = 1024 is 12 MiB, held by the 50 MB L2),
// each of 512 threads looping over its gate columns, and scalar reads of h.
// Only the carry and the gates stay in shared memory (BT * 4H f32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BT = 4;  // batch rows per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as jnp astype
}

__device__ __forceinline__ float sigmoid_f32(float v) { return 1.0f / (1.0f + expf(-v)); }

template <typename T>
__global__ void gru_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                               const T* __restrict__ bh, const float* __restrict__ mask,
                               T* __restrict__ ys, int n_steps, int batch, int hidden,
                               int n_dir, int rev_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int gates = 3 * hidden;
  const size_t w_bytes = ((size_t)hidden * gates * sizeof(T) + 15) & ~(size_t)15;
  T* w_s = reinterpret_cast<T*>(smem);
  float* h_s = reinterpret_cast<float*>(smem + w_bytes);  // (BT, H)
  float* g_s = h_s + BT * hidden;                          // (BT, 3H)

  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const bool reverse = (rev_bits >> d) & 1;

  const T* w_d = wh + (size_t)d * hidden * gates;
  for (int i = tid; i < hidden * gates; i += blockDim.x) w_s[i] = w_d[i];
  for (int i = tid; i < BT * hidden; i += blockDim.x) h_s[i] = 0.0f;
  const float bias = tid < gates ? to_f32(bh[(size_t)d * gates + tid]) : 0.0f;
  __syncthreads();

  const size_t x_row = (size_t)n_dir * gates;   // x_proj stride per (t, b)
  const size_t y_row = (size_t)n_dir * hidden;  // ys stride per (t, b)
  const float4* h4 = reinterpret_cast<const float4*>(h_s);
  const int h_quads = hidden / 4;

  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;

    // 1. hg[r][c] = sum_k h[r][k] * W[k][c] + b[c], one column per thread.
    if (tid < gates) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
      for (int q = 0; q < h_quads; ++q) {
        const int k = 4 * q;
        const float w0 = to_f32(w_s[(k + 0) * gates + tid]);
        const float w1 = to_f32(w_s[(k + 1) * gates + tid]);
        const float w2 = to_f32(w_s[(k + 2) * gates + tid]);
        const float w3 = to_f32(w_s[(k + 3) * gates + tid]);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float4 hv = h4[r * h_quads + q];
          acc[r] = fmaf(hv.x, w0, acc[r]);
          acc[r] = fmaf(hv.y, w1, acc[r]);
          acc[r] = fmaf(hv.z, w2, acc[r]);
          acc[r] = fmaf(hv.w, w3, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) g_s[r * gates + tid] = acc[r] + bias;
    }
    __syncthreads();

    // 3. Elementwise gates over the (BT, H) tile.
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

constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory one Hopper block may use

size_t resident_smem_bytes(int hidden, int elem_bytes) {
  const size_t gates = 3 * (size_t)hidden;
  return ((hidden * gates * elem_bytes + 15) & ~(size_t)15) + BT * (hidden + gates) * 4;
}

// The resident kernel takes H % 4 == 0, 3H <= 1024 and W_h in shared memory.
bool resident(int hidden, int elem_bytes) {
  return hidden % 4 == 0 && 3 * hidden <= 1024 &&
         resident_smem_bytes(hidden, elem_bytes) <= MAX_SMEM;
}

template <typename T>
int launch_wide(const void* xp, const void* wh, const void* bh, const void* mask, void* ys,
                int n_steps, int batch, int hidden, int n_dir, int rev_bits, void* stream) {
  const size_t smem = (size_t)BT * 4 * hidden * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gru_fwd_wide_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((batch + BT - 1) / BT, n_dir);
  gru_fwd_wide_kernel<T><<<grid, WIDE_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(wh), static_cast<const T*>(bh),
      static_cast<const float*>(mask), static_cast<T*>(ys), n_steps, batch, hidden, n_dir,
      rev_bits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xp, const void* wh, const void* bh, const void* mask, void* ys,
           int n_steps, int batch, int hidden, int n_dir, int rev_bits, void* stream) {
  const int gates = 3 * hidden;
  const size_t smem = resident_smem_bytes(hidden, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(gru_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((gates + 31) / 32) * 32;
  dim3 grid((batch + BT - 1) / BT, n_dir);
  gru_fwd_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(wh), static_cast<const T*>(bh),
      static_cast<const float*>(mask), static_cast<T*>(ys), n_steps, batch, hidden, n_dir,
      rev_bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when H in this storage type takes the resident kernel, 0 when the wide one.
int gru_fwd_resident(int hidden, int elem_bytes) { return resident(hidden, elem_bytes); }

// dtype: 0 = float32, 1 = bfloat16; 1 <= H <= 1024. Returns
// cudaGetLastError() of the launch.
int gru_fwd(const void* xp, const void* wh, const void* bh, const void* mask, void* ys,
            int n_steps, int batch, int hidden, int n_dir, int rev_bits, int dtype,
            void* stream) {
  if (hidden < 1 || hidden > 1024 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const bool res = resident(hidden, dtype == 0 ? 4 : 2);
  if (dtype == 0)
    return res ? launch<float>(xp, wh, bh, mask, ys, n_steps, batch, hidden, n_dir, rev_bits,
                               stream)
               : launch_wide<float>(xp, wh, bh, mask, ys, n_steps, batch, hidden, n_dir,
                                    rev_bits, stream);
  return res ? launch<__nv_bfloat16>(xp, wh, bh, mask, ys, n_steps, batch, hidden, n_dir,
                                     rev_bits, stream)
             : launch_wide<__nv_bfloat16>(xp, wh, bh, mask, ys, n_steps, batch, hidden, n_dir,
                                          rev_bits, stream);
}

}  // extern "C"
