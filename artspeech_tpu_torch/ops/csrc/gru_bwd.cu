// Masked GRU backward time loop for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel artspeech_tpu/ops/pallas_gru.py:_gru_bwd_kernel
// (pallas_call in _gru_bwd_rule), the backward half of the custom VJP around
// _gru_fwd_kernel. Given the forward's inputs, its outputs ys and the
// gradient g = dL/dys, it walks the recurrence in reverse traversal order:
//
//   h_prev = carry before the step;  hg = h_prev @ W_h + b_h  (recomputed, f32)
//   r, z, n as in the forward (gru_fwd.cu), all in f32
//   dh_tot = g[t] + dh                          (dh: f32 carry across steps)
//   dcand  = m * dh_tot
//   dz = dcand * (h_prev - n);  dn = dcand * (1 - z)
//   dn_pre = dn * (1 - n^2);    dr = dn_pre * hg_n
//   dz_pre = dz * z * (1 - z);  dr_pre = dr * r * (1 - r)
//   dhg    = [dr_pre, dz_pre, dn_pre * r]       (gradient of hg, f32)
//   dhg_c  = dhg rounded to the storage type
//   dh     = (1 - m) * dh_tot + dcand * z + dhg_c @ W_h^T
//   dx_proj[t] = [dr_pre, dz_pre, dn_pre]       (storage type)
//   dW_h  += h_prev^T @ dhg_c;  db_h += sum_rows(dhg)   (f32)
//
// The mask gets no gradient.
//
// No h_bound. The TPU kernel reads the carry before each 4-step chunk from
// an h_bound side output of the forward, because one grid step sees one
// chunk of ys only. Here one block walks all T steps and may read any row of
// ys: the carry before traversal step s is ys at traversal step s - 1 (on a
// padded step ys repeats the frozen carry, so this holds there too) and zero
// at s = 0. So the forward kernel emits no h_bound.
//
// Layout as gru_fwd.cu: x_proj, dx_proj and the dhg scratch (T, B, D*3H);
// w_h (D, H, 3H); b_h (D, 3H); mask (T, B) f32; ys, g (T, B, D*H). D is 1
// or 2; direction d walks time backward iff bit d of rev_bits is set, and
// both directions of a bidirectional layer run in one launch.
//
// What bounds it: like the forward, T dependent steps of small products at
// the thesis batch; each step here does two (BT, H) x (H, 3H)-sized
// products (the gate recompute and dh) plus the elementwise backward, so
// the time is per-step latency, not bytes or operations.
//
// Design. One block owns one (direction, tile of BT batch rows) and loops
// over all T steps, the carry dh in shared memory in f32.
// - W_h stays resident in shared memory as ONE copy in the storage type,
//   row-major (k, c), with its row stride padded to an odd number of 32-bit
//   words. The recompute reads it by rows (thread c reads W[k][c]: neighbours
//   on neighbouring words) and the dh product by columns (thread k reads
//   W[k][c]: neighbours one odd stride apart, so on 32 different banks).
//   A transposed second copy would not fit: at H = 128 f32 one copy is
//   197,120 B of the 232,448 B a block may use. Neither product reads W_h
//   from L2.
// - The dh product gives each of 3H threads one (gate block, k) pair and a
//   partial sum over that gate block's H columns; the next step adds the
//   three partials when it reads the carry.
// - dW_h is not accumulated step by step: its (H, 3H) f32 sum has no room in
//   shared memory and would need 128 registers a thread. Each step writes
//   dhg_c to a scratch tensor instead, and after the loop the same block
//   computes its partial dW_h = sum over its T*BT rows of h_prev^T dhg_c as
//   a tiled product in the shared memory that W_h held. db_h is summed in a
//   register of thread c during the loop.
// - A second small kernel sums the per-block f32 partials of dW_h and db_h
//   in block order. Partials rather than atomicAdd into a zeroed output: the
//   sum order is fixed, so the result is the same on every run.
// Tensor cores (wgmma), prefetch of the next step's inputs and a
// cluster-split W_h are left for later work.
//
// The wide instance. The resident kernel needs H % 4 == 0, 3H <= 1024 (a
// thread a column) and W_h in shared memory (f32 up to H = 128, bf16 up to
// H = 180). Every other H up to 1024 takes gru_bwd_wide_kernel, the same
// steps with W_h read from global memory (the L2 holds it: 12 MiB at
// H = 1024 in f32) by 512 threads:
// - the recompute loops each thread over its gate columns, reading W_h by
//   rows (neighbouring threads on neighbouring columns);
// - the dh product gives a warp one k at a time: its lanes walk the 3H
//   columns of row k of W_h (coalesced) and a fixed butterfly of shuffles
//   sums their partials, the same order on every run, so one partial plane
//   replaces the resident kernel's three;
// - db_h accumulates in shared memory (3H f32), a column per thread;
// - the dW_h epilogue is the resident one, run once per chunk of 512
//   columns.
// Shared memory: 11 (BT, H)-sized f32 arrays less the two unused partial
// planes, plus db_h: 156 H bytes, 159,744 B at H = 1024.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BT = 4;    // batch rows per block
constexpr int KT = 32;   // rows of dW_h per pass of the epilogue
constexpr int RC = 256;  // (step, row) pairs staged per chunk of the epilogue

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as jnp astype
}

__device__ __forceinline__ float sigmoid_f32(float v) { return 1.0f / (1.0f + expf(-v)); }

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Row stride of the resident W_h, in elements: a row plus one 32-bit word.
// 3H is a multiple of 12, so a row is an even number of words in f32 and
// bf16 alike, and the padded stride an odd one.
__host__ __device__ __forceinline__ int w_stride(int gates, int elem_bytes) {
  return gates + 4 / elem_bytes;
}

// Bytes of shared memory one block uses: W_h plus 11 (BT, H) f32 arrays in
// the loop, the epilogue's (RC, KT) staging after it, whichever is larger.
size_t smem_bytes(int hidden, int elem_bytes) {
  const size_t loop = align16((size_t)hidden * w_stride(3 * hidden, elem_bytes) * elem_bytes) +
                      (size_t)11 * BT * hidden * sizeof(float);
  const size_t epilogue = (size_t)RC * KT * sizeof(float);
  return loop > epilogue ? loop : epilogue;
}

// Carry before traversal step s (the output of step s - 1; zero at s = 0),
// for the BT rows of the tile, into hp (BT, H) f32.
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
__global__ void gru_bwd_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                               const T* __restrict__ bh, const float* __restrict__ mask,
                               const T* __restrict__ ys, const T* __restrict__ gy,
                               T* __restrict__ dxp, T* dhg, float* __restrict__ dw_part,
                               float* __restrict__ db_part, int n_steps, int batch, int hidden,
                               int n_dir, int rev_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int gates = 3 * hidden;
  const int ws = w_stride(gates, sizeof(T));
  const int bh_size = BT * hidden;
  T* w_s = reinterpret_cast<T*>(smem);
  float* hp_s = reinterpret_cast<float*>(smem + align16((size_t)hidden * ws * sizeof(T)));
  float* g_s = hp_s + bh_size;      // (BT, 3H): hg, then dhg in f32
  float* gc_s = g_s + BT * gates;   // (BT, 3H): dhg_c as f32
  float* dh_s = gc_s + BT * gates;  // (BT, H): dh without the W_h^T product
  float* part_s = dh_s + bh_size;   // (3, BT, H): the product, one partial per gate block

  const int d = blockIdx.y;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int b0 = tile * BT;
  const int tid = threadIdx.x;
  const bool reverse = (rev_bits >> d) & 1;
  const size_t x_row = (size_t)n_dir * gates;
  const size_t y_row = (size_t)n_dir * hidden;

  const T* w_d = wh + (size_t)d * hidden * gates;
  for (int i = tid; i < hidden * gates; i += blockDim.x) {
    const int k = i / gates;
    w_s[k * ws + (i - k * gates)] = w_d[i];
  }
  for (int i = tid; i < bh_size; i += blockDim.x) dh_s[i] = 0.0f;
  for (int i = tid; i < 3 * bh_size; i += blockDim.x) part_s[i] = 0.0f;
  const float bias = tid < gates ? to_f32(bh[(size_t)d * gates + tid]) : 0.0f;
  float db_acc = 0.0f;
  load_h_prev(hp_s, ys, n_steps - 1, n_steps, batch, hidden, b0, d, y_row, reverse);
  __syncthreads();

  const float4* hp4 = reinterpret_cast<const float4*>(hp_s);
  const int h_quads = hidden / 4;

  for (int s = n_steps - 1; s >= 0; --s) {
    const int t = reverse ? n_steps - 1 - s : s;

    // 1. Recompute hg = h_prev @ W_h + b_h, one column per thread, in the
    //    forward kernel's order of summation.
    if (tid < gates) {
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
      for (int r = 0; r < BT; ++r) g_s[r * gates + tid] = acc[r] + bias;
    }
    __syncthreads();

    // 2. Elementwise backward over the (BT, H) tile. Each element reads and
    //    overwrites only its own three gate columns of g_s.
    for (int e = tid; e < bh_size; e += blockDim.x) {
      const int r = e / hidden;
      const int j = e - r * hidden;
      const int b = b0 + r;
      float* gr = g_s + r * gates;
      float* gcr = gc_s + r * gates;
      if (b >= batch) {
        gr[j] = gr[hidden + j] = gr[2 * hidden + j] = 0.0f;
        gcr[j] = gcr[hidden + j] = gcr[2 * hidden + j] = 0.0f;
        dh_s[e] = 0.0f;
        continue;
      }
      const float carry = dh_s[e] + (part_s[e] + part_s[bh_size + e] + part_s[2 * bh_size + e]);
      const size_t row = (size_t)t * batch + b;
      const T* x = xp + row * x_row + (size_t)d * gates;
      const float hn = gr[2 * hidden + j];
      const float rg = sigmoid_f32(to_f32(x[j]) + gr[j]);
      const float zg = sigmoid_f32(to_f32(x[hidden + j]) + gr[hidden + j]);
      const float ng = tanhf(to_f32(x[2 * hidden + j]) + rg * hn);
      const float m = mask[row];
      const float dh_tot = to_f32(gy[row * y_row + (size_t)d * hidden + j]) + carry;
      const float dcand = m * dh_tot;
      const float dz = dcand * (hp_s[e] - ng);
      const float dn = dcand * (1.0f - zg);
      const float dn_pre = dn * (1.0f - ng * ng);
      const float dr = dn_pre * hn;
      const float dhg_n = dn_pre * rg;
      const float dz_pre = dz * zg * (1.0f - zg);
      const float dr_pre = dr * rg * (1.0f - rg);
      dh_s[e] = (1.0f - m) * dh_tot + dcand * zg;

      T* dx = dxp + row * x_row + (size_t)d * gates;
      dx[j] = from_f32<T>(dr_pre);
      dx[hidden + j] = from_f32<T>(dz_pre);
      dx[2 * hidden + j] = from_f32<T>(dn_pre);
      gr[j] = dr_pre;
      gr[hidden + j] = dz_pre;
      gr[2 * hidden + j] = dhg_n;
      const T cr = from_f32<T>(dr_pre), cz = from_f32<T>(dz_pre), cn = from_f32<T>(dhg_n);
      gcr[j] = to_f32(cr);
      gcr[hidden + j] = to_f32(cz);
      gcr[2 * hidden + j] = to_f32(cn);
      T* dg = dhg + row * x_row + (size_t)d * gates;
      dg[j] = cr;
      dg[hidden + j] = cz;
      dg[2 * hidden + j] = cn;
    }
    __syncthreads();

    // 3. db_h, the partial products dhg_c @ W_h^T, and the next carry.
    if (tid < gates) {
#pragma unroll
      for (int r = 0; r < BT; ++r) db_acc += g_s[r * gates + tid];
      const int p = tid / hidden;  // gate block r, z or n
      const int k = tid - p * hidden;
      const T* wk = w_s + k * ws + p * hidden;
      const float4* gc4 = reinterpret_cast<const float4*>(gc_s + p * hidden);
      const int row_quads = gates / 4;
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
#pragma unroll
      for (int r = 0; r < BT; ++r) part_s[p * bh_size + r * hidden + k] = acc[r];
    }
    if (s > 0) load_h_prev(hp_s, ys, s - 1, n_steps, batch, hidden, b0, d, y_row, reverse);
    __syncthreads();
  }

  // Epilogue: this block's partial dW_h[k][c] = sum over its (step, row)
  // pairs of h_prev[k] * dhg_c[c], KT rows of dW_h at a time, thread c
  // owning column c. h_prev is staged through the shared memory W_h held;
  // dhg_c is read back from the scratch this block wrote.
  if (tid < gates) db_part[((size_t)d * n_tiles + tile) * gates + tid] = db_acc;
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
      if (tid < gates) {
        for (int jj = 0; jj < rows; ++jj) {
          const int s = (j0 + jj) / BT;
          const int b = b0 + (j0 + jj) - s * BT;
          if (b >= batch) continue;
          const int t = reverse ? n_steps - 1 - s : s;
          const float gv = to_f32(dhg[((size_t)t * batch + b) * x_row + (size_t)d * gates + tid]);
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
    if (tid < gates) {
      float* out = dw_part + ((size_t)d * n_tiles + tile) * hidden * gates;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        if (k0 + kk < hidden) out[(size_t)(k0 + kk) * gates + tid] = acc[kk];
    }
  }
}

constexpr int WIDE_THREADS = 512;
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory one Hopper block may use

// The wide kernel's shared memory: hp, dh and the dh product (BT, H) each,
// the gates and their rounded gradients (BT, 3H) each, db_h (3H), all f32;
// or the epilogue's staging, whichever is larger.
size_t wide_smem_bytes(int hidden) {
  const size_t loop = sizeof(float) * ((size_t)BT * (3 * hidden + 6 * hidden) + 3 * hidden);
  const size_t epilogue = (size_t)RC * KT * sizeof(float);
  return loop > epilogue ? loop : epilogue;
}

bool resident(int hidden, int elem_bytes) {
  return hidden % 4 == 0 && 3 * hidden <= 1024 && smem_bytes(hidden, elem_bytes) <= MAX_SMEM;
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS)
gru_bwd_wide_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                    const T* __restrict__ bh, const float* __restrict__ mask,
                    const T* __restrict__ ys, const T* __restrict__ gy,
                    T* __restrict__ dxp, T* dhg, float* __restrict__ dw_part,
                    float* __restrict__ db_part, int n_steps, int batch, int hidden,
                    int n_dir, int rev_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int gates = 3 * hidden;
  const int bh_size = BT * hidden;
  float* hp_s = reinterpret_cast<float*>(smem);  // (BT, H)
  float* g_s = hp_s + bh_size;                   // (BT, 3H): hg, then dhg in f32
  float* gc_s = g_s + BT * gates;                // (BT, 3H): dhg_c as f32
  float* dh_s = gc_s + BT * gates;               // (BT, H): dh without the W_h^T product
  float* part_s = dh_s + bh_size;                // (BT, H): the W_h^T product
  float* db_s = part_s + bh_size;                // (3H): db_h

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

  for (int i = tid; i < bh_size; i += blockDim.x) dh_s[i] = part_s[i] = 0.0f;
  for (int c = tid; c < gates; c += blockDim.x) db_s[c] = 0.0f;
  load_h_prev(hp_s, ys, n_steps - 1, n_steps, batch, hidden, b0, d, y_row, reverse);
  __syncthreads();

  for (int s = n_steps - 1; s >= 0; --s) {
    const int t = reverse ? n_steps - 1 - s : s;

    // 1. Recompute hg = h_prev @ W_h + b_h, a thread per column in turn.
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

    // 2. Elementwise backward over the (BT, H) tile, as the resident kernel.
    for (int e = tid; e < bh_size; e += blockDim.x) {
      const int r = e / hidden;
      const int j = e - r * hidden;
      const int b = b0 + r;
      float* gr = g_s + r * gates;
      float* gcr = gc_s + r * gates;
      if (b >= batch) {
        gr[j] = gr[hidden + j] = gr[2 * hidden + j] = 0.0f;
        gcr[j] = gcr[hidden + j] = gcr[2 * hidden + j] = 0.0f;
        dh_s[e] = 0.0f;
        continue;
      }
      const float carry = dh_s[e] + part_s[e];
      const size_t row = (size_t)t * batch + b;
      const T* x = xp + row * x_row + (size_t)d * gates;
      const float hn = gr[2 * hidden + j];
      const float rg = sigmoid_f32(to_f32(x[j]) + gr[j]);
      const float zg = sigmoid_f32(to_f32(x[hidden + j]) + gr[hidden + j]);
      const float ng = tanhf(to_f32(x[2 * hidden + j]) + rg * hn);
      const float m = mask[row];
      const float dh_tot = to_f32(gy[row * y_row + (size_t)d * hidden + j]) + carry;
      const float dcand = m * dh_tot;
      const float dz = dcand * (hp_s[e] - ng);
      const float dn = dcand * (1.0f - zg);
      const float dn_pre = dn * (1.0f - ng * ng);
      const float dr = dn_pre * hn;
      const float dhg_n = dn_pre * rg;
      const float dz_pre = dz * zg * (1.0f - zg);
      const float dr_pre = dr * rg * (1.0f - rg);
      dh_s[e] = (1.0f - m) * dh_tot + dcand * zg;

      T* dx = dxp + row * x_row + (size_t)d * gates;
      dx[j] = from_f32<T>(dr_pre);
      dx[hidden + j] = from_f32<T>(dz_pre);
      dx[2 * hidden + j] = from_f32<T>(dn_pre);
      gr[j] = dr_pre;
      gr[hidden + j] = dz_pre;
      gr[2 * hidden + j] = dhg_n;
      const T cr = from_f32<T>(dr_pre), cz = from_f32<T>(dz_pre), cn = from_f32<T>(dhg_n);
      gcr[j] = to_f32(cr);
      gcr[hidden + j] = to_f32(cz);
      gcr[2 * hidden + j] = to_f32(cn);
      T* dg = dhg + row * x_row + (size_t)d * gates;
      dg[j] = cr;
      dg[hidden + j] = cz;
      dg[2 * hidden + j] = cn;
    }
    __syncthreads();

    // 3. db_h; the product dhg_c @ W_h^T, a warp a row k of W_h; the next
    //    carry.
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

  // Epilogue: the resident kernel's, once per chunk of blockDim.x columns.
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
            const int t_prev = reverse ? n_steps - st : st - 1;
            v = to_f32(ys[((size_t)t_prev * batch + b) * y_row + (size_t)d * hidden + k]);
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
           const void* gy, void* dxp, void* dhg, float* dw_part, float* db_part, float* dw,
           float* db, int n_steps, int batch, int hidden, int n_dir, int rev_bits,
           cudaStream_t stream) {
  const int gates = 3 * hidden;
  const bool res = resident(hidden, sizeof(T));
  const size_t smem = res ? smem_bytes(hidden, sizeof(T)) : wide_smem_bytes(hidden);
  auto kernel = res ? gru_bwd_kernel<T> : gru_bwd_wide_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = res ? ((gates + 31) / 32) * 32 : WIDE_THREADS;
  const int n_tiles = (batch + BT - 1) / BT;
  dim3 grid(n_tiles, n_dir);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(wh), static_cast<const T*>(bh),
      static_cast<const float*>(mask), static_cast<const T*>(ys), static_cast<const T*>(gy),
      static_cast<T*>(dxp), static_cast<T*>(dhg), dw_part, db_part, n_steps, batch, hidden,
      n_dir, rev_bits);
  int code = (int)cudaGetLastError();
  if (code != 0) return code;
  code = launch_sum(dw_part, dw, n_tiles, hidden * gates, n_dir, stream);
  if (code != 0) return code;
  return launch_sum(db_part, db, n_tiles, gates, n_dir, stream);
}

}  // namespace

extern "C" {

// 1 when H in this storage type takes the resident kernel, 0 when the wide one.
int gru_bwd_resident(int hidden, int elem_bytes) { return resident(hidden, elem_bytes); }

// Batch rows per block: the wrapper sizes the partials (D, ceil(B / BT), ...).
int gru_bwd_batch_tile(void) { return BT; }

// dtype: 0 = float32, 1 = bfloat16; 1 <= H <= 1024. dhg is scratch
// (T, B, D*3H) in the storage type; dw_part (D, tiles, H, 3H) and db_part
// (D, tiles, 3H) are f32 scratch; dw (D, H, 3H) and db (D, 3H) are f32
// outputs. Returns the first
// nonzero cudaError_t of the launches, else 0.
int gru_bwd(const void* xp, const void* wh, const void* bh, const void* mask, const void* ys,
            const void* gy, void* dxp, void* dhg, void* dw_part, void* db_part, void* dw,
            void* db, int n_steps, int batch, int hidden, int n_dir, int rev_bits, int dtype,
            void* stream) {
  float* f_dw_part = static_cast<float*>(dw_part);
  float* f_db_part = static_cast<float*>(db_part);
  float* f_dw = static_cast<float*>(dw);
  float* f_db = static_cast<float*>(db);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hidden < 1 || hidden > 1024) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(xp, wh, bh, mask, ys, gy, dxp, dhg, f_dw_part, f_db_part, f_dw, f_db,
                         n_steps, batch, hidden, n_dir, rev_bits, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xp, wh, bh, mask, ys, gy, dxp, dhg, f_dw_part, f_db_part, f_dw,
                                 f_db, n_steps, batch, hidden, n_dir, rev_bits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
