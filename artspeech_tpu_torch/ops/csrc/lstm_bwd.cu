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
// only. Here one cluster walks all T steps and reads any row: the carries
// before traversal step s are ys and cs at traversal step s - 1 (on a padded
// step both repeat the frozen carries, so this holds there too) and zero at
// s = 0. cs is the forward's cell state after every step, which the forward
// writes only when autograd needs it; the gates are recomputed from ys (one
// product a step) instead of storing the (T, B, 4H) gate tensor.
//
// Layout as lstm_fwd.cu: x_proj, dx_proj and the dhg scratch (T, B, D*4H);
// w_h (D, H, 4H); b_h (D, 4H); mask (T, B) f32; ys, cs, g (T, B, D*H). D is
// 1 or 2; direction d walks time backward iff bit d of rev_bits is set, and
// both directions of a bidirectional layer run in one launch.
//
// What bounds it: like the forward, T dependent steps of small products at
// the latent RNN's batch; each step here does two (BT, H) x (H, 4H)-sized
// products (the gate recompute and dh) plus the elementwise backward, so the
// time is per-step latency, not bytes or operations.
//
// Design. W_h at H = 128 in f32 (262,144 B) does not fit one block's shared
// memory, so, as in the forward, a cluster of two CTAs owns one (direction,
// tile of BT batch rows); CTA r owns hidden units [r*H/2, (r+1)*H/2), their
// four gate columns of W_h (one (H, 2H) half, row stride padded to an odd
// number of 32-bit words, 131,584 B in f32) and the carries dh and dc of
// those units, in f32 in shared memory.
// - The recompute reads the full h_prev of the step from ys, so it needs
//   nothing of the peer: thread c computes the CTA's gate column c, reading
//   W_h by rows (neighbouring threads on neighbouring words).
// - The cell backward of a unit needs only that unit's four gates: local.
// - dh = dgates_c @ W_h^T sums over all 4H columns, half of them in each
//   CTA. Each CTA computes its columns' partial sum for every k of h, with
//   thread (half p, k) summing H of its columns (reading W_h by columns:
//   neighbours one odd stride apart, so on different banks), and writes it
//   into the buffer of the CTA that owns unit k (the peer's through
//   distributed shared memory), indexed by source CTA and half. The next
//   step adds the four partials in a fixed order, (CTA 0: half 0 + half 1)
//   + (CTA 1: half 0 + half 1), the same on both CTAs and on every run. The
//   partials are double-buffered and one cluster.sync() a step orders the
//   writes before the reads.
// - dW_h is not accumulated step by step: each step writes dgates_c to a
//   scratch tensor, and after the loop each CTA computes its columns of its
//   tile's partial dW_h = sum over its T*BT rows of h_prev^T dgates_c as a
//   tiled product in the shared memory that W_h held (as gru_bwd.cu does).
//   db_h is summed in a register of thread c during the loop.
// - A second small kernel sums the per-tile f32 partials of dW_h and db_h
//   in tile order: no atomicAdd into the output, the same result every run.
// Tensor cores (wgmma) and prefetch of the next step's inputs are left for
// later work.
//
// The wide instance. The cluster kernel needs H % 4 == 0, 2H <= 1024 and
// half of W_h in a CTA's shared memory (f32 up to H = 160, bf16 up to
// H = 220). Every other H up to 1024 takes lstm_bwd_wide_kernel: one block
// of 512 threads a (direction, batch tile), no cluster, W_h read from
// global memory (the L2 holds it: 16 MiB at H = 1024 in f32), as
// gru_bwd.cu's wide kernel does it: the recompute a thread per gate column
// in turn, the dh product a warp per row k of W_h with a fixed butterfly of
// shuffles (deterministic), db_h in shared memory, and the resident dW_h
// epilogue once per chunk of 512 columns. Shared memory: h_prev, dh, dc and
// the product (BT, H), the gates and their rounded gradients (BT, 4H), db_h
// (4H), in f32: 208 H bytes, 212,992 B at H = 1024.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BT = 4;       // batch rows per cluster
constexpr int CLUSTER = 2;  // CTAs per cluster, each owning half of the hidden units
constexpr int KT = 32;      // rows of dW_h per pass of the epilogue
constexpr int RC = 256;     // (step, row) pairs staged per chunk of the epilogue

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as jnp astype
}

__device__ __forceinline__ float sigmoid_f32(float v) { return 1.0f / (1.0f + expf(-v)); }

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

__device__ __forceinline__ int global_col(int c, int units, int hidden, int u0) {
  const int p = c / units;
  return p * hidden + u0 + (c - p * units);
}

// Row stride of the resident half of W_h, in elements: its 2H columns plus
// one 32-bit word. H is a multiple of 4, so a row is an even number of words
// in f32 and bf16 alike, and the padded stride an odd one.
__host__ __device__ __forceinline__ int w_stride(int cols, int elem_bytes) {
  return cols + 4 / elem_bytes;
}

// Bytes of shared memory one CTA uses: its half of W_h, then in f32 h_prev
// (BT, H), the gates and their rounded gradients (BT, 2H) each, dh and dc
// (BT, H/2) each and the partials (2 buffers, 2 CTAs, 2 halves, BT, H/2);
// or the epilogue's (RC, KT) staging, whichever is larger.
size_t smem_bytes(int hidden, int elem_bytes) {
  const int units = hidden / 2;
  const int cols = 2 * hidden;
  const size_t loop = align16((size_t)hidden * w_stride(cols, elem_bytes) * elem_bytes) +
                      (size_t)BT * (hidden + 2 * cols + 2 * units + 8 * units) * sizeof(float);
  const size_t epilogue = (size_t)RC * KT * sizeof(float);
  return loop > epilogue ? loop : epilogue;
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

template <typename T>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
    lstm_bwd_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                    const T* __restrict__ bh, const float* __restrict__ mask,
                    const T* __restrict__ ys, const T* __restrict__ cs,
                    const T* __restrict__ gy, T* __restrict__ dxp, T* dhg,
                    float* __restrict__ dw_part, float* __restrict__ db_part, int n_steps,
                    int batch, int hidden, int n_dir, int rev_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int units = hidden / 2;
  const int cols = 4 * units;
  const int gates = 4 * hidden;
  const int ws = w_stride(cols, sizeof(T));
  const int bu = BT * units;
  T* w_s = reinterpret_cast<T*>(smem);
  float* hp_s = reinterpret_cast<float*>(smem + align16((size_t)hidden * ws * sizeof(T)));
  float* g_s = hp_s + BT * hidden;  // (BT, cols): gates, then their f32 gradients
  float* gc_s = g_s + BT * cols;    // (BT, cols): the gradients rounded, as f32
  float* dh_s = gc_s + BT * cols;   // (BT, units): dh without the W_h^T product
  float* dc_s = dh_s + bu;          // (BT, units): dc
  float* part_s = dc_s + bu;        // (2 buffers, 2 source CTAs, 2 halves, BT, units)
  float* part_peer = cluster.map_shared_rank(part_s, (unsigned)(rank ^ 1));

  const int d = blockIdx.y;
  const int tile = blockIdx.x / CLUSTER;
  const int n_tiles = gridDim.x / CLUSTER;
  const int b0 = tile * BT;
  const int tid = threadIdx.x;
  const bool reverse = (rev_bits >> d) & 1;
  const int u0 = rank * units;
  const size_t x_row = (size_t)n_dir * gates;
  const size_t y_row = (size_t)n_dir * hidden;

  const T* w_d = wh + (size_t)d * hidden * gates;
  for (int i = tid; i < hidden * cols; i += blockDim.x) {
    const int k = i / cols;
    const int c = i - k * cols;
    w_s[k * ws + c] = w_d[(size_t)k * gates + global_col(c, units, hidden, u0)];
  }
  for (int i = tid; i < 2 * bu; i += blockDim.x) dh_s[i] = 0.0f;  // dh_s and dc_s
  for (int i = tid; i < 8 * bu; i += blockDim.x) part_s[i] = 0.0f;
  const int my_col = tid < cols ? global_col(tid, units, hidden, u0) : 0;
  const float bias = tid < cols ? to_f32(bh[(size_t)d * gates + my_col]) : 0.0f;
  float db_acc = 0.0f;
  load_h_prev(hp_s, ys, n_steps - 1, n_steps, batch, hidden, b0, d, y_row, reverse);
  // Both CTAs are initialised before either writes into the other.
  cluster.sync();

  const float4* hp4 = reinterpret_cast<const float4*>(hp_s);
  const int h_quads = hidden / 4;

  for (int s = n_steps - 1; s >= 0; --s) {
    const int t = reverse ? n_steps - 1 - s : s;
    const int t_prev = reverse ? n_steps - s : s - 1;

    // 1. Recompute the CTA's gate columns of h_prev @ W_h + b_h, one column
    //    per thread, in the forward kernel's order of summation.
    if (tid < cols) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
      for (int q = 0; q < h_quads; ++q) {
        const int k = 4 * q;
        const float w0 = to_f32(w_s[(k + 0) * ws + tid]);
        const float w1 = to_f32(w_s[(k + 1) * ws + tid]);
        const float w2 = to_f32(w_s[(k + 2) * ws + tid]);
        const float w3 = to_f32(w_s[(k + 3) * ws + tid]);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float4 hv = hp4[r * h_quads + q];
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

    // 2. The cell backward over the CTA's (BT, units) tile. Each element
    //    reads and overwrites only its own unit's four gate columns.
    const float* pr = part_s + (s & 1) * 4 * bu;
    for (int e = tid; e < bu; e += blockDim.x) {
      const int r = e / units;
      const int j = e - r * units;
      const int b = b0 + r;
      float* g = g_s + r * cols + j;
      float* gc = gc_s + r * cols + j;
      if (b >= batch) {
        g[0] = g[units] = g[2 * units] = g[3 * units] = 0.0f;
        gc[0] = gc[units] = gc[2 * units] = gc[3 * units] = 0.0f;
        continue;
      }
      const float carry = dh_s[e] + ((pr[e] + pr[bu + e]) + (pr[2 * bu + e] + pr[3 * bu + e]));
      const size_t row = (size_t)t * batch + b;
      const size_t unit = (size_t)d * hidden + u0 + j;
      const T* x = xp + row * x_row + (size_t)d * gates + u0 + j;
      const float ig = sigmoid_f32(g[0] + to_f32(x[0]));
      const float fg = sigmoid_f32(g[units] + to_f32(x[hidden]));
      const float gg = tanhf(g[2 * units] + to_f32(x[2 * hidden]));
      const float og = sigmoid_f32(g[3 * units] + to_f32(x[3 * hidden]));
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
      T* dx = dxp + row * x_row + (size_t)d * gates + u0 + j;
      T* dg = dhg + row * x_row + (size_t)d * gates + u0 + j;
      dx[0] = dg[0] = ci;
      dx[hidden] = dg[hidden] = cf;
      dx[2 * hidden] = dg[2 * hidden] = cg_;
      dx[3 * hidden] = dg[3 * hidden] = co;
      g[0] = gi;
      g[units] = gf;
      g[2 * units] = gg_;
      g[3 * units] = go;
      gc[0] = to_f32(ci);
      gc[units] = to_f32(cf);
      gc[2 * units] = to_f32(cg_);
      gc[3 * units] = to_f32(co);
    }
    __syncthreads();

    // 3. db_h, the partial products dgates_c @ W_h^T for the next step's
    //    carry (into the owning CTA's buffer), and the next h_prev.
    if (tid < cols) {
#pragma unroll
      for (int r = 0; r < BT; ++r) db_acc += g_s[r * cols + tid];
      if (s > 0) {
        const int half = tid / hidden;  // local columns [half*H, (half+1)*H)
        const int k = tid - half * hidden;
        const T* wk = w_s + k * ws + half * hidden;
        const float4* gc4 = reinterpret_cast<const float4*>(gc_s + half * hidden);
        const int row_quads = cols / 4;
        float acc[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
        for (int q = 0; q < h_quads; ++q) {
          const float w0 = to_f32(wk[4 * q + 0]);
          const float w1 = to_f32(wk[4 * q + 1]);
          const float w2 = to_f32(wk[4 * q + 2]);
          const float w3 = to_f32(wk[4 * q + 3]);
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            const float4 gv = gc4[r * row_quads + q];
            acc[r] = fmaf(gv.x, w0, acc[r]);
            acc[r] = fmaf(gv.y, w1, acc[r]);
            acc[r] = fmaf(gv.z, w2, acc[r]);
            acc[r] = fmaf(gv.w, w3, acc[r]);
          }
        }
        const int owner = k / units;
        float* dst = (owner == rank ? part_s : part_peer) + ((s + 1) & 1) * 4 * bu +
                     (rank * 2 + half) * bu + (k - owner * units);
#pragma unroll
        for (int r = 0; r < BT; ++r) dst[r * units] = acc[r];
      }
    }
    if (s > 0) load_h_prev(hp_s, ys, s - 1, n_steps, batch, hidden, b0, d, y_row, reverse);
    cluster.sync();
  }

  // Epilogue: this CTA's columns of the tile's partial dW_h[k][c] = sum over
  // its (step, row) pairs of h_prev[k] * dgates_c[c], KT rows of dW_h at a
  // time, thread c owning column c. h_prev is staged through the shared
  // memory W_h held; dgates_c is read back from the scratch this CTA wrote.
  if (tid < cols) db_part[((size_t)d * n_tiles + tile) * gates + my_col] = db_acc;
  float* h_stage = reinterpret_cast<float*>(smem);  // (RC, KT)
  const int n_pairs = n_steps * BT;
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
        const int s = (j0 + jj) / BT;
        const int b = b0 + (j0 + jj) - s * BT;
        float v = 0.0f;
        if (s > 0 && b < batch && k < hidden) {
          const int t_prev = reverse ? n_steps - s : s - 1;
          v = to_f32(ys[((size_t)t_prev * batch + b) * y_row + (size_t)d * hidden + k]);
        }
        h_stage[i] = v;
      }
      __syncthreads();
      if (tid < cols) {
        for (int jj = 0; jj < rows; ++jj) {
          const int s = (j0 + jj) / BT;
          const int b = b0 + (j0 + jj) - s * BT;
          if (b >= batch) continue;
          const int t = reverse ? n_steps - 1 - s : s;
          const float gv =
              to_f32(dhg[((size_t)t * batch + b) * x_row + (size_t)d * gates + my_col]);
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
    if (tid < cols) {
      float* out = dw_part + ((size_t)d * n_tiles + tile) * hidden * gates;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        if (k0 + kk < hidden) out[(size_t)(k0 + kk) * gates + my_col] = acc[kk];
    }
  }
}

constexpr int WIDE_THREADS = 512;
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory one Hopper block may use

size_t wide_smem_bytes(int hidden) {
  const size_t loop = sizeof(float) * ((size_t)BT * (4 * hidden + 8 * hidden) + 4 * hidden);
  const size_t epilogue = (size_t)RC * KT * sizeof(float);
  return loop > epilogue ? loop : epilogue;
}

bool resident(int hidden, int elem_bytes) {
  return hidden % 4 == 0 && 2 * hidden <= 1024 && smem_bytes(hidden, elem_bytes) <= MAX_SMEM;
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS)
lstm_bwd_wide_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                     const T* __restrict__ bh, const float* __restrict__ mask,
                     const T* __restrict__ ys, const T* __restrict__ cs,
                     const T* __restrict__ gy, T* __restrict__ dxp, T* dhg,
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
      T* dg = dhg + row * x_row + (size_t)d * gates + j;
      dx[0] = dg[0] = ci;
      dx[hidden] = dg[hidden] = cf;
      dx[2 * hidden] = dg[2 * hidden] = cg_;
      dx[3 * hidden] = dg[3 * hidden] = co;
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

  // Epilogue: the cluster kernel's, once per chunk of blockDim.x columns.
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
            const float gv = to_f32(dhg[((size_t)t * batch + b) * x_row + (size_t)d * gates + c]);
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

// out[d][i] = sum over tiles, in tile order, of part[d][tile][i].
__global__ void sum_partials(const float* __restrict__ part, float* __restrict__ out,
                             int n_tiles, int width, int n_dir) {
  const size_t total = (size_t)n_dir * width;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t d = i / width;
    const float* p = part + d * n_tiles * width + (i - d * width);
    float acc = 0.0f;
    for (int tl = 0; tl < n_tiles; ++tl) acc += p[(size_t)tl * width];
    out[i] = acc;
  }
}

int launch_sum(const float* part, float* out, int n_tiles, int width, int n_dir,
               cudaStream_t stream) {
  const int threads = 256;
  long blocks = ((long)n_dir * width + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  sum_partials<<<(int)blocks, threads, 0, stream>>>(part, out, n_tiles, width, n_dir);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xp, const void* wh, const void* bh, const void* mask, const void* ys,
           const void* cs, const void* gy, void* dxp, void* dhg, float* dw_part, float* db_part,
           float* dw, float* db, int n_steps, int batch, int hidden, int n_dir, int rev_bits,
           cudaStream_t stream) {
  const bool res = resident(hidden, sizeof(T));
  const size_t smem = res ? smem_bytes(hidden, sizeof(T)) : wide_smem_bytes(hidden);
  const int n_tiles = (batch + BT - 1) / BT;
  if (res) {
    cudaError_t err = cudaFuncSetAttribute(lstm_bwd_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int threads = ((2 * hidden + 31) / 32) * 32;
    dim3 grid(CLUSTER * n_tiles, n_dir);
    lstm_bwd_kernel<T><<<grid, threads, smem, stream>>>(
        static_cast<const T*>(xp), static_cast<const T*>(wh), static_cast<const T*>(bh),
        static_cast<const float*>(mask), static_cast<const T*>(ys), static_cast<const T*>(cs),
        static_cast<const T*>(gy), static_cast<T*>(dxp), static_cast<T*>(dhg), dw_part,
        db_part, n_steps, batch, hidden, n_dir, rev_bits);
  } else {
    cudaError_t err = cudaFuncSetAttribute(lstm_bwd_wide_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(n_tiles, n_dir);
    lstm_bwd_wide_kernel<T><<<grid, WIDE_THREADS, smem, stream>>>(
        static_cast<const T*>(xp), static_cast<const T*>(wh), static_cast<const T*>(bh),
        static_cast<const float*>(mask), static_cast<const T*>(ys), static_cast<const T*>(cs),
        static_cast<const T*>(gy), static_cast<T*>(dxp), static_cast<T*>(dhg), dw_part,
        db_part, n_steps, batch, hidden, n_dir, rev_bits);
  }
  int code = (int)cudaGetLastError();
  if (code != 0) return code;
  const int gates = 4 * hidden;
  code = launch_sum(dw_part, dw, n_tiles, hidden * gates, n_dir, stream);
  if (code != 0) return code;
  return launch_sum(db_part, db, n_tiles, gates, n_dir, stream);
}

}  // namespace

extern "C" {

// 1 when H in this storage type takes the cluster kernel, 0 when the wide one.
int lstm_bwd_resident(int hidden, int elem_bytes) { return resident(hidden, elem_bytes); }

// Batch rows per cluster: the wrapper sizes the partials (D, ceil(B / BT), ...).
int lstm_bwd_batch_tile(void) { return BT; }

// dtype: 0 = float32, 1 = bfloat16; 1 <= H <= 1024. dhg is scratch (T, B, D*4H) in the
// storage type; dw_part (D, tiles, H, 4H) and db_part (D, tiles, 4H) are f32
// scratch; dw (D, H, 4H) and db (D, 4H) are f32 outputs. Returns the first
// nonzero cudaError_t of the launches, else 0.
int lstm_bwd(const void* xp, const void* wh, const void* bh, const void* mask, const void* ys,
             const void* cs, const void* gy, void* dxp, void* dhg, void* dw_part, void* db_part,
             void* dw, void* db, int n_steps, int batch, int hidden, int n_dir, int rev_bits,
             int dtype, void* stream) {
  float* f_dw_part = static_cast<float*>(dw_part);
  float* f_db_part = static_cast<float*>(db_part);
  float* f_dw = static_cast<float*>(dw);
  float* f_db = static_cast<float*>(db);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hidden < 1 || hidden > 1024) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(xp, wh, bh, mask, ys, cs, gy, dxp, dhg, f_dw_part, f_db_part, f_dw,
                         f_db, n_steps, batch, hidden, n_dir, rev_bits, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xp, wh, bh, mask, ys, cs, gy, dxp, dhg, f_dw_part, f_db_part,
                                 f_dw, f_db, n_steps, batch, hidden, n_dir, rev_bits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
