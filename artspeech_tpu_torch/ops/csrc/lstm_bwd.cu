// Masked LSTM backward time loop for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel artspeech_tpu/ops/pallas_gru.py:_lstm_bwd_kernel
// (pallas_call in _lstm_bwd_rule), the backward half of the custom VJP
// around _lstm_fwd_kernel. Given the forward's inputs, its outputs ys, its
// cell states cs and the gradient g = dL/dys, it walks the recurrence in
// reverse traversal order:
//
//   h_prev, c_prev = carries before the step
//   gates = h_prev @ W_h + b_h + x             (recomputed, f32)
//   i, f, g, o as in the forward (lstm_fwd.cu); c' = f c_prev + i g; th = tanh(c')
//   dh_tot = g[t] + dh;  m = mask
//   dh_c = m dh_tot;  dc_c = m dc
//   do = dh_c th;  dc_c += dh_c o (1 - th^2)
//   df = dc_c c_prev;  di = dc_c g;  dg = dc_c i
//   dc = (1 - m) dc + dc_c f
//   dgates = [di i(1-i), df f(1-f), dg (1-g^2), do o(1-o)]   (f32)
//   dgates_c = dgates rounded to the storage type
//   dh = (1 - m) dh_tot + dgates_c @ W_h^T
//   dx_proj[t] = dgates_c
//   dW_h += h_prev^T @ dgates_c;  db_h += sum_rows(dgates)   (f32)
//
// The mask gets no gradient.
//
// No h_bound / c_bound. The TPU kernel rebuilds each chunk's entry cell
// states in a first pass from c_bound, because one grid step sees one chunk
// only. Here a cluster walks all T steps and reads any row: the carries
// before traversal step s are ys and cs at traversal step s - 1 (on a padded
// step both repeat the frozen carries, so this holds there too) and zero at
// s = 0. cs is the forward's cell state after every step, which the forward
// writes only when autograd needs it; the gates are recomputed from ys (one
// product a step, in a prologue) instead of storing the (T, B, 4H) gate
// tensor.
//
// Layout as lstm_fwd.cu: x_proj and dx_proj (T, B, D*4H); w_h (D, H, 4H);
// b_h (D, 4H); mask (T, B) f32; ys, cs, g (T, B, D*H). D is 1 or 2;
// direction d walks time backward iff bit d of rev_bits is set, and both
// directions of a bidirectional layer run in one launch.
//
// What bounds it: like the forward, T dependent steps of small products at
// the latent RNN's batch, so the time is per-step latency, not bytes or
// operations.
//
// Design: the cluster backward step of rnn_bwd_step.cuh (shared with
// gru_bwd.cu), launched with the geometry of
// hopper_gru.rnn_bwd_launch_geometry. The prologue recomputes the gates
// from ys and reads c_prev from cs, off the serial chain, into an f32
// scratch of six values a (step, row, unit): i, f, g, o, c_prev and
// tanh(c'). The loop then runs only the product dgates_c @ W_h^T,
// reduce-scattered over the cluster, and the cell's FMAs; dc stays in the
// register of the unit's cell thread. The scratch slots of a step take its
// dgates_c for the dW_h epilogue. The (H, 4H) f32 W_h (262,144 B at
// H = 128) does not fit one block; the step splits it over up to 8 CTAs.
//
// The wide instance. Where the cluster step does not run (the rule's
// `resident` is false: H above 256, a thread a k of its dh product),
// lstm_bwd_wide_kernel runs the same steps with W_h read from global memory
// (the L2 holds it: 16 MiB at H = 1024 in f32): one block of 512 threads a
// (direction, tile of BT rows), no cluster, the recompute a thread per gate
// column in turn, the dh product a warp per row k of W_h with a fixed
// butterfly of shuffles (deterministic), db_h in shared memory, dgates_c
// into the f32 scratch (T, B, D*4H) and the dW_h epilogue after the loop.
// Shared memory: h_prev, dh, dc and the product (BT, H), the gates and their
// rounded gradients (BT, 4H), db_h (4H), in f32: 208 H bytes, 212,992 B at
// H = 1024.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rnn_bwd_step.cuh"

namespace {

using dsmem::from_f32;
using dsmem::sigmoid_f32;
using dsmem::to_f32;

constexpr int BT = 4;    // batch rows a block of the wide instance
constexpr int KT = 32;   // rows of dW_h per pass of the wide epilogue
constexpr int RC = 256;  // (step, row) pairs staged per chunk of the wide epilogue

// The LSTM's cell for rnn_bwd::cluster_backward.
template <typename T>
struct LstmCell {
  static constexpr int G = 4;
  static constexpr int V = 6;  // i, f, g, o, c_prev, tanh(c')
  const T* xp;
  const T* cs;
  size_t x_row, y_row;
  int hidden, batch, d;

  static constexpr int NI = 5;  // x_i, x_f, x_g, x_o, c_prev

  __device__ void load(int t, int t_prev, int b, int u, T* in) const {
    const T* x = xp + ((size_t)t * batch + b) * x_row + (size_t)d * 4 * hidden + u;
    in[0] = x[0];
    in[1] = x[hidden];
    in[2] = x[2 * hidden];
    in[3] = x[3 * hidden];
    in[4] = cs[((size_t)t_prev * batch + b) * y_row + (size_t)d * hidden + u];
  }

  __device__ void values(const float* pre, float, const T* in, bool first, float* v) const {
    const float i = sigmoid_f32(pre[0] + to_f32(in[0]));
    const float f = sigmoid_f32(pre[1] + to_f32(in[1]));
    const float g = tanhf(pre[2] + to_f32(in[2]));
    const float o = sigmoid_f32(pre[3] + to_f32(in[3]));
    const float c_prev = first ? 0.0f : to_f32(in[4]);
    v[0] = i;
    v[1] = f;
    v[2] = g;
    v[3] = o;
    v[4] = c_prev;
    v[5] = tanhf(f * c_prev + i * g);
  }

  __device__ float step(const float* v, float m, float dh_tot, float& dc, float* dx,
                        float* dhg) const {
    const float i = v[0], f = v[1], g = v[2], o = v[3], c_prev = v[4], th = v[5];
    const float dh_c = m * dh_tot;
    float dc_c = m * dc;
    const float d_o = dh_c * th;
    dc_c = dc_c + dh_c * o * (1.0f - th * th);
    const float d_f = dc_c * c_prev;
    const float d_i = dc_c * g;
    const float d_g = dc_c * i;
    dc = (1.0f - m) * dc + dc_c * f;
    dx[0] = dhg[0] = d_i * i * (1.0f - i);
    dx[1] = dhg[1] = d_f * f * (1.0f - f);
    dx[2] = dhg[2] = d_g * (1.0f - g * g);
    dx[3] = dhg[3] = d_o * o * (1.0f - o);
    return (1.0f - m) * dh_tot;
  }
};

template <typename T, int R>
__global__ void __launch_bounds__(rnn_bwd::THREADS, 2)
lstm_bwd_cluster_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                        const T* __restrict__ bh, const float* __restrict__ mask,
                        const T* __restrict__ ys, const T* __restrict__ cs,
                        const T* __restrict__ gy, T* __restrict__ dxp, float* scratch,
                        float* __restrict__ dw_part, float* __restrict__ db_part, int n_steps,
                        int batch, int hidden, int n_dir, int rev_bits) {
  const rnn_bwd::Problem<T> pb{xp, wh, bh, mask, ys, gy, dxp, scratch, dw_part, db_part,
                               n_steps, batch, hidden, n_dir, rev_bits};
  const LstmCell<T> cell{xp, cs, (size_t)n_dir * 4 * hidden, (size_t)n_dir * hidden, hidden,
                         batch, (int)blockIdx.y};
  rnn_bwd::cluster_backward<T, R>(pb, cell);
}

// Carry before traversal step s (the output of step s - 1; zero at s = 0),
// all H units for the BT rows of the tile, into hp (BT, H) f32.
template <typename T>
__device__ void load_h_prev(float* hp, const T* ys, int s, int n_steps, int batch, int hidden,
                            int b0, int d, size_t y_row, bool reverse) {
  const int t_prev = reverse ? n_steps - s : s - 1;
  for (int e = threadIdx.x; e < BT * hidden; e += blockDim.x) {
    const int r = e / hidden;
    const int j = e - r * hidden;
    const int b = b0 + r;
    hp[e] = (s > 0 && b < batch)
                ? to_f32(ys[((size_t)t_prev * batch + b) * y_row + (size_t)d * hidden + j])
                : 0.0f;
  }
}

constexpr int WIDE_THREADS = 512;

size_t wide_smem_bytes(int hidden) {
  const size_t loop = sizeof(float) * ((size_t)BT * (4 * hidden + 8 * hidden) + 4 * hidden);
  const size_t epilogue = (size_t)RC * KT * sizeof(float);
  return loop > epilogue ? loop : epilogue;
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS)
lstm_bwd_wide_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                     const T* __restrict__ bh, const float* __restrict__ mask,
                     const T* __restrict__ ys, const T* __restrict__ cs,
                     const T* __restrict__ gy, T* __restrict__ dxp, float* dhg,
                     float* __restrict__ dw_part, float* __restrict__ db_part, int n_steps,
                     int batch, int hidden, int n_dir, int rev_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int gates = 4 * hidden;
  const int bh_size = BT * hidden;
  float* hp_s = reinterpret_cast<float*>(smem);  // (BT, H)
  float* g_s = hp_s + bh_size;                   // (BT, 4H): gates, then their f32 gradients
  float* gc_s = g_s + BT * gates;                // (BT, 4H): the gradients rounded, as f32
  float* dh_s = gc_s + BT * gates;               // (BT, H): dh without the W_h^T product
  float* dc_s = dh_s + bh_size;                  // (BT, H): dc
  float* part_s = dc_s + bh_size;                // (BT, H): the W_h^T product
  float* db_s = part_s + bh_size;                // (4H): db_h

  const int d = blockIdx.y;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int b0 = tile * BT;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const bool reverse = (rev_bits >> d) & 1;
  const size_t x_row = (size_t)n_dir * gates;
  const size_t y_row = (size_t)n_dir * hidden;
  const T* w_d = wh + (size_t)d * hidden * gates;
  const T* b_d = bh + (size_t)d * gates;

  for (int i = tid; i < bh_size; i += blockDim.x) dh_s[i] = dc_s[i] = part_s[i] = 0.0f;
  for (int c = tid; c < gates; c += blockDim.x) db_s[c] = 0.0f;
  load_h_prev(hp_s, ys, n_steps - 1, n_steps, batch, hidden, b0, d, y_row, reverse);
  __syncthreads();

  for (int s = n_steps - 1; s >= 0; --s) {
    const int t = reverse ? n_steps - 1 - s : s;
    const int t_prev = reverse ? n_steps - s : s - 1;

    // 1. Recompute h_prev @ W_h + b_h, a thread per gate column in turn.
    for (int c = tid; c < gates; c += blockDim.x) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < hidden; ++k) {
        const float wk = to_f32(w_d[(size_t)k * gates + c]);
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(hp_s[r * hidden + k], wk, acc[r]);
      }
      const float bias = to_f32(b_d[c]);
#pragma unroll
      for (int r = 0; r < BT; ++r) g_s[r * gates + c] = acc[r] + bias;
    }
    __syncthreads();

    // 2. The cell backward over the (BT, H) tile, as the cluster kernel.
    for (int e = tid; e < bh_size; e += blockDim.x) {
      const int r = e / hidden;
      const int j = e - r * hidden;
      const int b = b0 + r;
      float* g = g_s + r * gates + j;
      float* gc = gc_s + r * gates + j;
      if (b >= batch) {
        g[0] = g[hidden] = g[2 * hidden] = g[3 * hidden] = 0.0f;
        gc[0] = gc[hidden] = gc[2 * hidden] = gc[3 * hidden] = 0.0f;
        continue;
      }
      const float carry = dh_s[e] + part_s[e];
      const size_t row = (size_t)t * batch + b;
      const size_t unit = (size_t)d * hidden + j;
      const T* x = xp + row * x_row + (size_t)d * gates + j;
      const float ig = sigmoid_f32(g[0] + to_f32(x[0]));
      const float fg = sigmoid_f32(g[hidden] + to_f32(x[hidden]));
      const float gg = tanhf(g[2 * hidden] + to_f32(x[2 * hidden]));
      const float og = sigmoid_f32(g[3 * hidden] + to_f32(x[3 * hidden]));
      const float c_prev = s > 0 ? to_f32(cs[((size_t)t_prev * batch + b) * y_row + unit]) : 0.0f;
      const float c_new = fg * c_prev + ig * gg;
      const float th = tanhf(c_new);
      const float m = mask[row];
      const float dh_tot = to_f32(gy[row * y_row + unit]) + carry;
      const float dh_c = m * dh_tot;
      const float dc = dc_s[e];
      float dc_c = m * dc;
      const float d_o = dh_c * th;
      dc_c = dc_c + dh_c * og * (1.0f - th * th);
      const float d_f = dc_c * c_prev;
      const float d_i = dc_c * gg;
      const float d_g = dc_c * ig;
      dc_s[e] = (1.0f - m) * dc + dc_c * fg;
      dh_s[e] = (1.0f - m) * dh_tot;

      const float gi = d_i * ig * (1.0f - ig);
      const float gf = d_f * fg * (1.0f - fg);
      const float gg_ = d_g * (1.0f - gg * gg);
      const float go = d_o * og * (1.0f - og);
      const T ci = from_f32<T>(gi), cf = from_f32<T>(gf), cg_ = from_f32<T>(gg_),
              co = from_f32<T>(go);
      T* dx = dxp + row * x_row + (size_t)d * gates + j;
      float* dg = dhg + row * x_row + (size_t)d * gates + j;
      dx[0] = ci;
      dx[hidden] = cf;
      dx[2 * hidden] = cg_;
      dx[3 * hidden] = co;
      dg[0] = to_f32(ci);
      dg[hidden] = to_f32(cf);
      dg[2 * hidden] = to_f32(cg_);
      dg[3 * hidden] = to_f32(co);
      g[0] = gi;
      g[hidden] = gf;
      g[2 * hidden] = gg_;
      g[3 * hidden] = go;
      gc[0] = to_f32(ci);
      gc[hidden] = to_f32(cf);
      gc[2 * hidden] = to_f32(cg_);
      gc[3 * hidden] = to_f32(co);
    }
    __syncthreads();

    // 3. db_h; the product dgates_c @ W_h^T, a warp a row k of W_h; the next
    //    h_prev.
    for (int c = tid; c < gates; c += blockDim.x) {
      float acc = db_s[c];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc += g_s[r * gates + c];
      db_s[c] = acc;
    }
    for (int k = warp; k < hidden; k += n_warps) {
      const T* wk = w_d + (size_t)k * gates;
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
      for (int c = lane; c < gates; c += 32) {
        const float w = to_f32(wk[c]);
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(gc_s[r * gates + c], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < BT; ++r) part_s[r * hidden + k] = acc[r];
      }
    }
    if (s > 0) load_h_prev(hp_s, ys, s - 1, n_steps, batch, hidden, b0, d, y_row, reverse);
    __syncthreads();
  }

  // Epilogue: this block's partial dW_h[k][c] = sum over its (step, row)
  // pairs of h_prev[k] * dgates_c[c], KT rows of dW_h at a time, thread c
  // owning column c, once per chunk of blockDim.x columns; h_prev is staged
  // in shared memory, dgates_c read back from the scratch this block wrote.
  for (int c = tid; c < gates; c += blockDim.x)
    db_part[((size_t)d * n_tiles + tile) * gates + c] = db_s[c];
  float* h_stage = reinterpret_cast<float*>(smem);  // (RC, KT)
  const int n_pairs = n_steps * BT;
  for (int c0 = 0; c0 < gates; c0 += blockDim.x) {
    const int c = c0 + tid;
    for (int k0 = 0; k0 < hidden; k0 += KT) {
      float acc[KT];
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) acc[kk] = 0.0f;
      for (int j0 = 0; j0 < n_pairs; j0 += RC) {
        const int rows = min(RC, n_pairs - j0);
        __syncthreads();
        for (int i = tid; i < rows * KT; i += blockDim.x) {
          const int jj = i / KT;
          const int k = k0 + (i - jj * KT);
          const int st = (j0 + jj) / BT;
          const int b = b0 + (j0 + jj) - st * BT;
          float v = 0.0f;
          if (st > 0 && b < batch && k < hidden) {
            const int tp = reverse ? n_steps - st : st - 1;
            v = to_f32(ys[((size_t)tp * batch + b) * y_row + (size_t)d * hidden + k]);
          }
          h_stage[i] = v;
        }
        __syncthreads();
        if (c < gates) {
          for (int jj = 0; jj < rows; ++jj) {
            const int st = (j0 + jj) / BT;
            const int b = b0 + (j0 + jj) - st * BT;
            if (b >= batch) continue;
            const int t = reverse ? n_steps - 1 - st : st;
            const float gv = dhg[((size_t)t * batch + b) * x_row + (size_t)d * gates + c];
            const float4* h4 = reinterpret_cast<const float4*>(h_stage + jj * KT);
#pragma unroll
            for (int q = 0; q < KT / 4; ++q) {
              const float4 hv = h4[q];
              acc[4 * q + 0] = fmaf(hv.x, gv, acc[4 * q + 0]);
              acc[4 * q + 1] = fmaf(hv.y, gv, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(hv.z, gv, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(hv.w, gv, acc[4 * q + 3]);
            }
          }
        }
      }
      if (c < gates) {
        float* out = dw_part + ((size_t)d * n_tiles + tile) * hidden * gates;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          if (k0 + kk < hidden) out[(size_t)(k0 + kk) * gates + c] = acc[kk];
      }
    }
  }
}

template <typename T>
void (*cluster_kernel(int rows))(const T*, const T*, const T*, const float*, const T*, const T*,
                                 const T*, T*, float*, float*, float*, int, int, int, int, int) {
  switch (rows) {
    case 2: return lstm_bwd_cluster_kernel<T, 2>;
    case 4: return lstm_bwd_cluster_kernel<T, 4>;
    default: return lstm_bwd_cluster_kernel<T, 8>;
  }
}

template <typename T>
int launch(const void* xp, const void* wh, const void* bh, const void* mask, const void* ys,
           const void* cs, const void* gy, void* dxp, float* scratch, float* dw_part,
           float* db_part, float* dw, float* db, int n_steps, int batch, int hidden, int n_dir,
           int rev_bits, int cluster, int rows, int smem, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wh);
  const T* b = static_cast<const T*>(bh);
  const float* m = static_cast<const float*>(mask);
  const T* y = static_cast<const T*>(ys);
  const T* c = static_cast<const T*>(cs);
  const T* g = static_cast<const T*>(gy);
  T* dx = static_cast<T*>(dxp);
  const int tiles = (batch + rows - 1) / rows;
  int code;
  if (cluster == 0) {
    if (rows != BT || (size_t)smem < wide_smem_bytes(hidden) || (size_t)smem > dsmem::MAX_SMEM)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(lstm_bwd_wide_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    lstm_bwd_wide_kernel<T><<<dim3(tiles, n_dir), WIDE_THREADS, smem, stream>>>(
        x, w, b, m, y, c, g, dx, scratch, dw_part, db_part, n_steps, batch, hidden, n_dir,
        rev_bits);
    code = (int)cudaGetLastError();
  } else {
    if (!rnn_bwd::valid_geometry(hidden, cluster, rows, smem, 4, sizeof(T)))
      return (int)cudaErrorInvalidValue;
    code = dsmem::launch_cluster(cluster_kernel<T>(rows), cluster, tiles, n_dir,
                                 rnn_bwd::THREADS, smem, stream, x, w,
                                 b, m, y, c, g, dx, scratch, dw_part, db_part, n_steps, batch,
                                 hidden, n_dir, rev_bits);
  }
  if (code != 0) return code;
  return rnn_bwd::launch_sums(dw_part, db_part, dw, db, tiles, hidden, 4, n_dir, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; 1 <= H <= 1024; n_dir 1 or 2. The launch
// geometry comes from hopper_gru.rnn_bwd_launch_geometry: cluster CTAs (0:
// the wide instance), rows a cluster (or a wide block) walks, and the
// dynamic shared memory in bytes; the f32 scratch holds that rule's
// scratch_per_step values a time step. dw_part (D, tiles, H, 4H) and
// db_part (D, tiles, 4H), tiles = ceil(B / rows), are f32 scratch; dw
// (D, H, 4H) and db (D, 4H) are f32 outputs. Returns the first nonzero
// cudaError_t of the launches (a geometry the kernel does not take, or a
// refused cluster), else 0.
int lstm_bwd(const void* xp, const void* wh, const void* bh, const void* mask, const void* ys,
             const void* cs, const void* gy, void* dxp, void* scratch, void* dw_part,
             void* db_part, void* dw, void* db, int n_steps, int batch, int hidden, int n_dir,
             int rev_bits, int dtype, int cluster, int rows, int smem, void* stream) {
  if (hidden < 1 || hidden > 1024 || n_dir < 1 || n_dir > 2 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  float* f_scratch = static_cast<float*>(scratch);
  float* f_dw_part = static_cast<float*>(dw_part);
  float* f_db_part = static_cast<float*>(db_part);
  float* f_dw = static_cast<float*>(dw);
  float* f_db = static_cast<float*>(db);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xp, wh, bh, mask, ys, cs, gy, dxp, f_scratch, f_dw_part, f_db_part,
                         f_dw, f_db, n_steps, batch, hidden, n_dir, rev_bits, cluster, rows, smem,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xp, wh, bh, mask, ys, cs, gy, dxp, f_scratch, f_dw_part,
                                 f_db_part, f_dw, f_db, n_steps, batch, hidden, n_dir, rev_bits,
                                 cluster, rows, smem, s);
  return launch<__half>(xp, wh, bh, mask, ys, cs, gy, dxp, f_scratch, f_dw_part,
                        f_db_part, f_dw, f_db, n_steps, batch, hidden, n_dir, rev_bits,
                        cluster, rows, smem, s);
}

}  // extern "C"
