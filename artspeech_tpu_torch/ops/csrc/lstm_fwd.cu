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
// for f32, bf16 and f16 storage. h and c are rounded to the storage type
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
// product followed by elementwise gates. At the latent RNN's batches (12 to
// train, 16 to synthesise) the card is nearly idle: the time is the latency
// of T sequential steps, not bytes (x_proj is read once, ys written once)
// or operations.
//
// Design: the forward cluster step of rnn_fwd_step.cuh, the one the GRU
// forwards (gru_fwd.cu, gru_seq.cu) run, with a four-gate cell. A
// thread-block cluster of C <= 8 CTAs owns a (direction, tile of R = 2, 4 or
// 8 rows); CTA r holds the (H, 4H/C) W_h slice of its H/C units in shared
// memory (at H = 128 in f32 and C = 8, 32 KiB); 8 lanes a unit split k and a
// fixed-order shuffle reduce-scatter leaves each row's four sums in the lane
// that applies its gates, with no block barrier; that lane keeps the
// (row, unit)'s cell state c in a register for all T steps (c never crosses
// the cluster) and writes ys and, when asked, cs; the new h goes to every
// CTA of the cluster by st.async on transaction mbarriers; x_proj and the
// mask are loaded a step ahead. The geometry comes from
// hopper_gru.gru_launch_geometry with 4 gates, the GRU forwards' rule.
//
// The wide instance. Where no cluster holds W_h (the rule's `resident` is
// false: U = H/C above 64, or a slice above a CTA's shared memory; H = 512
// and 1,024 in every storage type), lstm_fwd_wide_kernel runs: one block of 512
// threads a (direction, batch tile of BT rows), no cluster, W_h read from
// global memory every step (the L2 holds it: 16 MiB at H = 1024 in f32),
// each thread looping over its gate columns, scalar reads of h. The carries
// h and c and the gates stay in shared memory (BT * 6H f32); h is updated in
// place, since the step's product has read all of it before the first
// update.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rnn_fwd_step.cuh"

namespace {

using rnn_fwd::from_f32;
using rnn_fwd::sigmoid_f32;
using rnn_fwd::to_f32;

constexpr int BT = 4;  // batch rows a block of the wide instance
constexpr int WIDE_THREADS = 512;

// The LSTM's cell for rnn_fwd::cluster_steps: c is the carry beyond h.
template <typename T>
struct LstmCell : rnn_fwd::TimeMajor<T, 4> {
  static constexpr int G = 4;
  T* cs;  // cell states at ys' offsets, or null

  __device__ T apply(const float* s, const float* bh, const float* x, float m, float h,
                     float& c) const {
    const float ig = sigmoid_f32((s[0] + bh[0]) + x[0]);
    const float fg = sigmoid_f32((s[1] + bh[1]) + x[1]);
    const float gg = tanhf((s[2] + bh[2]) + x[2]);
    const float og = sigmoid_f32((s[3] + bh[3]) + x[3]);
    const float c_new = fmaf(fg, c, ig * gg);  // the fused product fixed, as the GRU's
    const bool valid = m != 0.0f;
    const T h_out = from_f32<T>(valid ? og * tanhf(c_new) : h);
    c = to_f32(from_f32<T>(valid ? c_new : c));
    return h_out;
  }

  __device__ void store(int t, int bi, int u, T h, float c) const {
    T* y = this->y(t, bi);
    y[u] = h;
    if (cs != nullptr) cs[y - this->ys + u] = from_f32<T>(c);
  }
};

template <typename T, int R>
__global__ void __launch_bounds__(rnn_fwd::MAX_THREADS)
lstm_fwd_cluster_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                        const T* __restrict__ bh, const float* __restrict__ mask,
                        T* __restrict__ ys, T* __restrict__ cs, int n_steps, int batch,
                        int hidden, int n_dir, int rev_bits) {
  const int d = blockIdx.y;
  const LstmCell<T> cell{{xp, wh + (size_t)d * hidden * 4 * hidden, bh + (size_t)d * 4 * hidden,
                          mask, ys, batch, hidden, n_dir, d, ((rev_bits >> d) & 1) != 0},
                         cs};
  rnn_fwd::cluster_steps<T, R>(cell, n_steps, batch, hidden);
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
                void* cs, int n_steps, int batch, int hidden, int n_dir, int rev_bits, int smem,
                cudaStream_t stream) {
  if ((size_t)smem < (size_t)BT * 6 * hidden * sizeof(float) || (size_t)smem > rnn_fwd::MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lstm_fwd_wide_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((batch + BT - 1) / BT, n_dir);
  lstm_fwd_wide_kernel<T><<<grid, WIDE_THREADS, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(wh), static_cast<const T*>(bh),
      static_cast<const float*>(mask), static_cast<T*>(ys), static_cast<T*>(cs), n_steps, batch,
      hidden, n_dir, rev_bits);
  return (int)cudaGetLastError();
}

template <typename T>
void (*cluster_kernel(int rows))(const T*, const T*, const T*, const float*, T*, T*, int, int,
                                 int, int, int) {
  switch (rows) {
    case 2: return lstm_fwd_cluster_kernel<T, 2>;
    case 4: return lstm_fwd_cluster_kernel<T, 4>;
    default: return lstm_fwd_cluster_kernel<T, 8>;
  }
}

template <typename T>
int launch(const void* xp, const void* wh, const void* bh, const void* mask, void* ys, void* cs,
           int n_steps, int batch, int hidden, int n_dir, int rev_bits, int cluster, int rows,
           int smem, cudaStream_t stream) {
  if (cluster == 0)
    return launch_wide<T>(xp, wh, bh, mask, ys, cs, n_steps, batch, hidden, n_dir, rev_bits,
                          smem, stream);
  if (!rnn_fwd::valid_geometry(hidden, cluster, rows, smem, 4, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  return rnn_fwd::launch_cluster(
      cluster_kernel<T>(rows), cluster, (batch + rows - 1) / rows, n_dir,
      rnn_fwd::cluster_threads(hidden, cluster), smem, stream, static_cast<const T*>(xp),
      static_cast<const T*>(wh), static_cast<const T*>(bh), static_cast<const float*>(mask),
      static_cast<T*>(ys), static_cast<T*>(cs), n_steps, batch, hidden, n_dir, rev_bits);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; 1 <= H <= 1024; n_dir 1 or 2; cs may be
// null. The launch geometry comes from hopper_gru.gru_launch_geometry with 4
// gates: cluster CTAs (0: the wide instance), rows a cluster walks (2, 4 or
// 8), and the dynamic shared memory in bytes. Returns the first nonzero
// cudaError_t of the launch (a geometry the kernel does not take, or a
// refused cluster), else 0.
int lstm_fwd(const void* xp, const void* wh, const void* bh, const void* mask, void* ys, void* cs,
             int n_steps, int batch, int hidden, int n_dir, int rev_bits, int dtype, int cluster,
             int rows, int smem, void* stream) {
  if (hidden < 1 || hidden > 1024 || n_dir < 1 || n_dir > 2 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xp, wh, bh, mask, ys, cs, n_steps, batch, hidden, n_dir, rev_bits,
                         cluster, rows, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xp, wh, bh, mask, ys, cs, n_steps, batch, hidden, n_dir, rev_bits,
                                 cluster, rows, smem, s);
  return launch<__half>(xp, wh, bh, mask, ys, cs, n_steps, batch, hidden, n_dir, rev_bits,
                        cluster, rows, smem, s);
}

}  // extern "C"
