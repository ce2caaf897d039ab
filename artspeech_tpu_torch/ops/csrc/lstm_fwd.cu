// Masked LSTM forward time loop for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel artspeech_tpu/ops/pallas_gru.py:_lstm_fwd_kernel
// (pallas_call in _lstm_forward), reached from ops/gru.py:LSTMLayer. It
// computes the same function without the h_bound / c_bound side outputs:
//
//   gates = h @ W_h + b_h + x                   (f32 accumulation)
//   i = sigmoid(gates_i), f = sigmoid(gates_f), g = tanh(gates_g),
//   o = sigmoid(gates_o)                        (gate order i, f, g, o)
//   c' = f * c + i * g;  h' = o * tanh(c')
//   h, c <- mask ? (h', c') : (h, c)            (carries frozen on padded steps)
//
// with x = x_proj[t] the hoisted input projection and all gate math in f32
// for both f32 and bf16 storage. h and c are rounded to the storage type
// after every step, as the TPU kernel's carries are. A reverse direction
// walks time backward and stores outputs at their own time index.
//
// Layout: x_proj (T, B, D*4H), w_h (D, H, 4H), b_h (D, 4H), mask (T, B) f32,
// ys (T, B, D*H). D is 1 or 2: with D == 2 both directions of a
// bidirectional layer run in one launch and write their halves of the
// concatenated output. Direction d walks time backward iff bit d of
// rev_bits is set. cs (T, B, D*H), when not null, receives the cell state
// after every step (the backward, lstm_bwd.cu, reads the cell state before
// a step from it); the wrapper passes it only when autograd will need it,
// so inference writes ys alone. Storing c costs one more (T, B, H) write;
// rebuilding it in the backward would cost a second pass over T with a
// (B, H) x (H, 4H) product a step.
//
// What bounds it: T dependent steps, each a small (B_tile, H) x (H, 4H)
// product followed by elementwise gates. At the latent RNN's batch (B = 8 or
// 12) the card is nearly idle: the time is the latency of T sequential
// steps, not bytes (x_proj is read once, ys written once) or operations.
//
// Where W_h lives. gru_fwd.cu keeps W_h resident in one block's shared
// memory. The LSTM's (H, 4H) W_h at the latent RNN's H = 128 in f32 is
// 262,144 B, more than the 232,448 B one block may use. So a thread-block
// cluster of two CTAs owns one (direction, batch tile of BT rows): CTA r
// owns hidden units [r*H/2, (r+1)*H/2) and their four gate columns, the
// (H, 2H) half of W_h that those units need (131,072 B in f32, 65,536 B in
// bf16), resident in its shared memory for all T steps. Each step:
//   1. thread c computes gate column c of the CTA's half for the BT rows,
//      reading W_h[k][c] (consecutive threads, consecutive banks) and the
//      full h[r][k] of the step as float4 broadcasts;
//   2. __syncthreads();
//   3. threads run the elementwise cell over the CTA's (BT, H/2) units (the
//      four gates of a unit are all local), update c in shared memory, write
//      ys (and cs), and store the new h of their units into the next h
//      buffer of both CTAs (the peer's through distributed shared memory);
//   4. cluster.sync(): the peer's half of h is in place for the next step.
// h is double-buffered, so a CTA writing step s's h into the peer cannot
// overwrite the h the peer is still reading in step s; one cluster barrier a
// step is enough. Streaming half of W_h from L2 every step was the other
// way: 128 KB a step and CTA through L2 against 8 KB of h through the
// cluster; the cluster keeps every weight read in shared memory. Tensor
// cores (wgmma) and TMA prefetch of x_proj are left for later work.
//
// The wide instance. The cluster kernel needs H % 4 == 0, 2H <= 1024 (a
// thread a column of its half) and half of W_h in a CTA's shared memory
// (f32 up to H = 164, bf16 up to H = 232). Every other H up to 1024 takes
// lstm_fwd_wide_kernel: one block of 512 threads a (direction, batch tile),
// no cluster, W_h read from global memory every step (the L2 holds it:
// 16 MiB at H = 1024 in f32), each thread looping over its gate columns,
// scalar reads of h. The carries h and c and the gates stay in shared
// memory (BT * 6H f32); h is updated in place, since the step's product has
// read all of it before the first update.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BT = 4;       // batch rows per cluster
constexpr int CLUSTER = 2;  // CTAs per cluster, each owning half of the hidden units

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as jnp astype
}

__device__ __forceinline__ float sigmoid_f32(float v) { return 1.0f / (1.0f + expf(-v)); }

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Global gate column of local column c: a CTA's columns are its units' i, f,
// g and o columns, one block of `units` each.
__device__ __forceinline__ int global_col(int c, int units, int hidden, int u0) {
  const int p = c / units;
  return p * hidden + u0 + (c - p * units);
}

// Bytes of shared memory one CTA uses: its (H, 2H) half of W_h, two (BT, H)
// f32 h buffers, the (BT, 2H) f32 gates and the (BT, H/2) f32 cell state.
size_t smem_bytes(int hidden, int elem_bytes) {
  const size_t cols = 2 * (size_t)hidden;
  return align16((size_t)hidden * cols * elem_bytes) +
         (size_t)BT * (2 * hidden + cols + hidden / 2) * sizeof(float);
}

template <typename T>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
    lstm_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                    const T* __restrict__ bh, const float* __restrict__ mask,
                    T* __restrict__ ys, T* __restrict__ cs, int n_steps, int batch, int hidden,
                    int n_dir, int rev_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int units = hidden / 2;  // hidden units this CTA owns
  const int cols = 4 * units;    // their gate columns
  const int gates = 4 * hidden;
  T* w_s = reinterpret_cast<T*>(smem);                                                // (H, cols)
  // (2, BT, H)
  float* h_s = reinterpret_cast<float*>(smem + align16((size_t)hidden * cols * sizeof(T)));
  float* g_s = h_s + 2 * BT * hidden;  // (BT, cols)
  float* c_s = g_s + BT * cols;        // (BT, units)
  float* h_peer = cluster.map_shared_rank(h_s, (unsigned)(rank ^ 1));

  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / CLUSTER) * BT;
  const int tid = threadIdx.x;
  const bool reverse = (rev_bits >> d) & 1;
  const int u0 = rank * units;  // first hidden unit of this CTA

  const T* w_d = wh + (size_t)d * hidden * gates;
  for (int i = tid; i < hidden * cols; i += blockDim.x) {
    const int k = i / cols;
    w_s[i] = w_d[(size_t)k * gates + global_col(i - k * cols, units, hidden, u0)];
  }
  for (int i = tid; i < 2 * BT * hidden; i += blockDim.x) h_s[i] = 0.0f;
  for (int i = tid; i < BT * units; i += blockDim.x) c_s[i] = 0.0f;
  const float bias =
      tid < cols ? to_f32(bh[(size_t)d * gates + global_col(tid, units, hidden, u0)]) : 0.0f;
  // Both CTAs are initialised before either writes into the other.
  cluster.sync();

  const size_t x_row = (size_t)n_dir * gates;   // x_proj stride per (t, b)
  const size_t y_row = (size_t)n_dir * hidden;  // ys and cs stride per (t, b)
  const int h_quads = hidden / 4;

  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    const float* h_cur = h_s + (s & 1) * BT * hidden;
    const int nxt = ((s + 1) & 1) * BT * hidden;

    // 1. gates[r][c] = sum_k h[r][k] * W[k][c] + b[c], one column per thread.
    if (tid < cols) {
      const float4* h4 = reinterpret_cast<const float4*>(h_cur);
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
      for (int q = 0; q < h_quads; ++q) {
        const int k = 4 * q;
        const float w0 = to_f32(w_s[(k + 0) * cols + tid]);
        const float w1 = to_f32(w_s[(k + 1) * cols + tid]);
        const float w2 = to_f32(w_s[(k + 2) * cols + tid]);
        const float w3 = to_f32(w_s[(k + 3) * cols + tid]);
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
      for (int r = 0; r < BT; ++r) g_s[r * cols + tid] = acc[r] + bias;
    }
    __syncthreads();

    // 3. The cell over the CTA's (BT, units) tile.
    for (int e = tid; e < BT * units; e += blockDim.x) {
      const int r = e / units;
      const int j = e - r * units;
      const int b = b0 + r;
      if (b >= batch) continue;
      const size_t row = (size_t)t * batch + b;
      const T* x = xp + row * x_row + (size_t)d * gates + u0 + j;
      const float* g = g_s + r * cols + j;
      const float ig = sigmoid_f32(g[0] + to_f32(x[0]));
      const float fg = sigmoid_f32(g[units] + to_f32(x[hidden]));
      const float gg = tanhf(g[2 * units] + to_f32(x[2 * hidden]));
      const float og = sigmoid_f32(g[3 * units] + to_f32(x[3 * hidden]));
      const float c_prev = c_s[e];
      const float c_new = fg * c_prev + ig * gg;
      const float h_cand = og * tanhf(c_new);
      const bool valid = mask[row] != 0.0f;
      const float h_prev = h_cur[r * hidden + u0 + j];
      const T h_out = from_f32<T>(valid ? h_cand : h_prev);
      const T c_out = from_f32<T>(valid ? c_new : c_prev);
      const float h_f = to_f32(h_out);
      c_s[e] = to_f32(c_out);
      h_s[nxt + r * hidden + u0 + j] = h_f;
      h_peer[nxt + r * hidden + u0 + j] = h_f;
      const size_t out = row * y_row + (size_t)d * hidden + u0 + j;
      ys[out] = h_out;
      if (cs != nullptr) cs[out] = c_out;
    }
    // 4. The whole new h is in both CTAs' next buffer.
    cluster.sync();
  }
}

constexpr int WIDE_THREADS = 512;
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory one Hopper block may use

bool resident(int hidden, int elem_bytes) {
  return hidden % 4 == 0 && 2 * hidden <= 1024 && smem_bytes(hidden, elem_bytes) <= MAX_SMEM;
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS)
lstm_fwd_wide_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                     const T* __restrict__ bh, const float* __restrict__ mask,
                     T* __restrict__ ys, T* __restrict__ cs, int n_steps, int batch, int hidden,
                     int n_dir, int rev_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int gates = 4 * hidden;
  float* h_s = reinterpret_cast<float*>(smem);  // (BT, H)
  float* c_s = h_s + BT * hidden;               // (BT, H)
  float* g_s = c_s + BT * hidden;               // (BT, 4H)

  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const bool reverse = (rev_bits >> d) & 1;
  const T* w_d = wh + (size_t)d * hidden * gates;
  const T* b_d = bh + (size_t)d * gates;
  for (int i = tid; i < 2 * BT * hidden; i += blockDim.x) h_s[i] = 0.0f;  // h and c
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
      const size_t row = (size_t)t * batch + b;
      const T* x = xp + row * x_row + (size_t)d * gates + j;
      const float* g = g_s + r * gates + j;
      const float ig = sigmoid_f32(g[0] + to_f32(x[0]));
      const float fg = sigmoid_f32(g[hidden] + to_f32(x[hidden]));
      const float gg = tanhf(g[2 * hidden] + to_f32(x[2 * hidden]));
      const float og = sigmoid_f32(g[3 * hidden] + to_f32(x[3 * hidden]));
      const float c_prev = c_s[e];
      const float c_new = fg * c_prev + ig * gg;
      const float h_cand = og * tanhf(c_new);
      const bool valid = mask[row] != 0.0f;
      const T h_out = from_f32<T>(valid ? h_cand : h_s[e]);
      const T c_out = from_f32<T>(valid ? c_new : c_prev);
      h_s[e] = to_f32(h_out);
      c_s[e] = to_f32(c_out);
      const size_t out = row * y_row + (size_t)d * hidden + j;
      ys[out] = h_out;
      if (cs != nullptr) cs[out] = c_out;
    }
    __syncthreads();
  }
}

template <typename T>
int launch_wide(const void* xp, const void* wh, const void* bh, const void* mask, void* ys,
                void* cs, int n_steps, int batch, int hidden, int n_dir, int rev_bits,
                void* stream) {
  const size_t smem = (size_t)BT * 6 * hidden * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lstm_fwd_wide_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((batch + BT - 1) / BT, n_dir);
  lstm_fwd_wide_kernel<T><<<grid, WIDE_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(wh), static_cast<const T*>(bh),
      static_cast<const float*>(mask), static_cast<T*>(ys), static_cast<T*>(cs), n_steps, batch,
      hidden, n_dir, rev_bits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xp, const void* wh, const void* bh, const void* mask, void* ys, void* cs,
           int n_steps, int batch, int hidden, int n_dir, int rev_bits, void* stream) {
  const size_t smem = smem_bytes(hidden, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(lstm_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((2 * hidden + 31) / 32) * 32;
  dim3 grid(CLUSTER * ((batch + BT - 1) / BT), n_dir);
  lstm_fwd_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(wh), static_cast<const T*>(bh),
      static_cast<const float*>(mask), static_cast<T*>(ys), static_cast<T*>(cs), n_steps, batch,
      hidden, n_dir, rev_bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when H in this storage type takes the cluster kernel, 0 when the wide one.
int lstm_fwd_resident(int hidden, int elem_bytes) { return resident(hidden, elem_bytes); }

// dtype: 0 = float32, 1 = bfloat16; 1 <= H <= 1024. cs may be null. Returns
// cudaGetLastError() of the launch.
int lstm_fwd(const void* xp, const void* wh, const void* bh, const void* mask, void* ys, void* cs,
             int n_steps, int batch, int hidden, int n_dir, int rev_bits, int dtype,
             void* stream) {
  if (hidden < 1 || hidden > 1024 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const bool res = resident(hidden, dtype == 0 ? 4 : 2);
  if (dtype == 0)
    return res ? launch<float>(xp, wh, bh, mask, ys, cs, n_steps, batch, hidden, n_dir,
                               rev_bits, stream)
               : launch_wide<float>(xp, wh, bh, mask, ys, cs, n_steps, batch, hidden, n_dir,
                                    rev_bits, stream);
  return res ? launch<__nv_bfloat16>(xp, wh, bh, mask, ys, cs, n_steps, batch, hidden, n_dir,
                                     rev_bits, stream)
             : launch_wide<__nv_bfloat16>(xp, wh, bh, mask, ys, cs, n_steps, batch, hidden,
                                          n_dir, rev_bits, stream);
}

}  // extern "C"
