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
// chunk of ys only. Here a cluster walks all T steps and may read any row of
// ys: the carry before traversal step s is ys at traversal step s - 1 (on a
// padded step ys repeats the frozen carry, so this holds there too) and zero
// at s = 0. So the forward kernel emits no h_bound.
//
// Layout as gru_fwd.cu: x_proj and dx_proj (T, B, D*3H); w_h (D, H, 3H);
// b_h (D, 3H); mask (T, B) f32; ys, g (T, B, D*H). D is 1 or 2; direction d
// walks time backward iff bit d of rev_bits is set, and both directions of
// a bidirectional layer run in one launch.
//
// What bounds it: like the forward, T dependent steps of small products at
// the thesis batch, so the time is per-step latency, not bytes or
// operations.
//
// Design: the cluster backward step of rnn_bwd_step.cuh (shared with
// lstm_bwd.cu), launched with the geometry of hopper_gru.rnn_bwd_launch_geometry.
// The gates are recomputed from ys in a prologue, off the serial chain,
// into an f32 scratch of five values a (step, row, unit): r, z, h_prev - n,
// 1 - n^2 and hg_n, every factor of the step's backward that does not
// depend on the carry. The loop then runs only the product dhg_c @ W_h^T,
// reduce-scattered over the cluster, and the few FMAs below. The scratch
// slots of a step take its dhg_c for the dW_h epilogue.
//
// The wide instance. Where the cluster step does not run (the rule's
// `resident` is false: H above 256, a thread a k of its dh product),
// gru_bwd_wide_kernel runs the same steps with W_h read from global memory
// (the L2 holds it: 12 MiB at H = 1024 in f32) by 512 threads, one block a
// (direction, tile of BT rows):
// - the recompute loops each thread over its gate columns, reading W_h by
//   rows (neighbouring threads on neighbouring columns);
// - the dh product gives a warp one k at a time: its lanes walk the 3H
//   columns of row k of W_h (coalesced) and a fixed butterfly of shuffles
//   sums their partials, the same order on every run;
// - db_h accumulates in shared memory (3H f32), a column per thread;
// - each step writes dhg_c to the f32 scratch (T, B, D*3H), and after the
//   loop the block computes its partial dW_h = sum over its T*BT rows of
//   h_prev^T dhg_c, KT rows of dW_h at a time with h_prev staged in shared
//   memory, once per chunk of 512 columns.
// Shared memory: 9 (BT, H)-sized f32 arrays plus db_h: 156 H bytes, 159,744 B
// at H = 1024.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "rnn_bwd_step.cuh"

namespace {

using dsmem::from_f32;
using dsmem::sigmoid_f32;
using dsmem::to_f32;

constexpr int BT = 4;    // batch rows a block of the wide instance
constexpr int KT = 32;   // rows of dW_h per pass of the wide epilogue
constexpr int RC = 256;  // (step, row) pairs staged per chunk of the wide epilogue

// The GRU's cell for rnn_bwd::cluster_backward.
template <typename T>
struct GruCell {
  static constexpr int G = 3;
  static constexpr int V = 5;  // r, z, h_prev - n, 1 - n^2, hg_n
  const T* xp;
  size_t x_row;
  int hidden, batch, d;

  static constexpr int NI = 3;  // x_r, x_z, x_n

  __device__ void load(int t, int, int b, int u, T* in) const {
    const T* x = xp + ((size_t)t * batch + b) * x_row + (size_t)d * 3 * hidden + u;
    in[0] = x[0];
    in[1] = x[hidden];
    in[2] = x[2 * hidden];
  }

  __device__ void values(const float* pre, float h, const T* in, bool, float* v) const {
    const float r = sigmoid_f32(to_f32(in[0]) + pre[0]);
    const float z = sigmoid_f32(to_f32(in[1]) + pre[1]);
    const float n = tanhf(to_f32(in[2]) + r * pre[2]);
    v[0] = r;
    v[1] = z;
    v[2] = h - n;
    v[3] = 1.0f - n * n;
    v[4] = pre[2];
  }

  __device__ float step(const float* v, float m, float dh_tot, float&, float* dx,
                        float* dhg) const {
    const float r = v[0], z = v[1];
    const float dcand = m * dh_tot;
    const float dz = dcand * v[2];
    const float dn = dcand * (1.0f - z);
    const float dn_pre = dn * v[3];
    const float dr = dn_pre * v[4];
    const float dz_pre = dz * z * (1.0f - z);
    const float dr_pre = dr * r * (1.0f - r);
    dx[0] = dhg[0] = dr_pre;
    dx[1] = dhg[1] = dz_pre;
    dx[2] = dn_pre;
    dhg[2] = dn_pre * r;
    return (1.0f - m) * dh_tot + dcand * z;
  }
};

template <typename T, int R>
__global__ void __launch_bounds__(rnn_bwd::THREADS, 2)
gru_bwd_cluster_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                       const T* __restrict__ bh, const float* __restrict__ mask,
                       const T* __restrict__ ys, const T* __restrict__ gy, T* __restrict__ dxp,
                       float* scratch, float* __restrict__ dw_part, float* __restrict__ db_part,
                       int n_steps, int batch, int hidden, int n_dir, int rev_bits) {
  const rnn_bwd::Problem<T> pb{xp, wh, bh, mask, ys, gy, dxp, scratch, dw_part, db_part,
                               n_steps, batch, hidden, n_dir, rev_bits};
  const GruCell<T> cell{xp, (size_t)n_dir * 3 * hidden, hidden, batch, (int)blockIdx.y};
  rnn_bwd::cluster_backward<T, R>(pb, cell);
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

constexpr int WIDE_THREADS = 512;

// The wide kernel's shared memory: hp, dh and the dh product (BT, H) each,
// the gates and their rounded gradients (BT, 3H) each, db_h (3H), all f32;
// or the epilogue's staging, whichever is larger.
size_t wide_smem_bytes(int hidden) {
  const size_t loop = sizeof(float) * ((size_t)BT * (3 * hidden + 6 * hidden) + 3 * hidden);
  const size_t epilogue = (size_t)RC * KT * sizeof(float);
  return loop > epilogue ? loop : epilogue;
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS)
gru_bwd_wide_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                    const T* __restrict__ bh, const float* __restrict__ mask,
                    const T* __restrict__ ys, const T* __restrict__ gy,
                    T* __restrict__ dxp, float* dhg, float* __restrict__ dw_part,
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
      float* dg = dhg + row * x_row + (size_t)d * gates;
      dg[j] = gcr[j];
      dg[hidden + j] = gcr[hidden + j];
      dg[2 * hidden + j] = gcr[2 * hidden + j];
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
                                 T*, float*, float*, float*, int, int, int, int, int) {
  switch (rows) {
    case 2: return gru_bwd_cluster_kernel<T, 2>;
    case 4: return gru_bwd_cluster_kernel<T, 4>;
    default: return gru_bwd_cluster_kernel<T, 8>;
  }
}

template <typename T>
int launch(const void* xp, const void* wh, const void* bh, const void* mask, const void* ys,
           const void* gy, void* dxp, float* scratch, float* dw_part, float* db_part, float* dw,
           float* db, int n_steps, int batch, int hidden, int n_dir, int rev_bits, int cluster,
           int rows, int smem, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wh);
  const T* b = static_cast<const T*>(bh);
  const float* m = static_cast<const float*>(mask);
  const T* y = static_cast<const T*>(ys);
  const T* g = static_cast<const T*>(gy);
  T* dx = static_cast<T*>(dxp);
  const int tiles = (batch + rows - 1) / rows;
  int code;
  if (cluster == 0) {
    if (rows != BT || (size_t)smem < wide_smem_bytes(hidden) || (size_t)smem > dsmem::MAX_SMEM)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(gru_bwd_wide_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    gru_bwd_wide_kernel<T><<<dim3(tiles, n_dir), WIDE_THREADS, smem, stream>>>(
        x, w, b, m, y, g, dx, scratch, dw_part, db_part, n_steps, batch, hidden, n_dir,
        rev_bits);
    code = (int)cudaGetLastError();
  } else {
    if (!rnn_bwd::valid_geometry(hidden, cluster, rows, smem, 3, sizeof(T)))
      return (int)cudaErrorInvalidValue;
    code = dsmem::launch_cluster(cluster_kernel<T>(rows), cluster, tiles, n_dir,
                                 rnn_bwd::THREADS, smem, stream, x, w,
                                 b, m, y, g, dx, scratch, dw_part, db_part, n_steps, batch,
                                 hidden, n_dir, rev_bits);
  }
  if (code != 0) return code;
  return rnn_bwd::launch_sums(dw_part, db_part, dw, db, tiles, hidden, 3, n_dir, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; 1 <= H <= 1024; n_dir 1 or 2. The launch
// geometry comes from hopper_gru.rnn_bwd_launch_geometry: cluster CTAs (0:
// the wide instance), rows a cluster (or a wide block) walks, and the
// dynamic shared memory in bytes; the f32 scratch holds that rule's
// scratch_per_step values a time step. dw_part (D, tiles, H, 3H) and
// db_part (D, tiles, 3H), tiles = ceil(B / rows), are f32 scratch; dw
// (D, H, 3H) and db (D, 3H) are f32 outputs. Returns the first nonzero
// cudaError_t of the launches (a geometry the kernel does not take, or a
// refused cluster), else 0.
int gru_bwd(const void* xp, const void* wh, const void* bh, const void* mask, const void* ys,
            const void* gy, void* dxp, void* scratch, void* dw_part, void* db_part, void* dw,
            void* db, int n_steps, int batch, int hidden, int n_dir, int rev_bits, int dtype,
            int cluster, int rows, int smem, void* stream) {
  if (hidden < 1 || hidden > 1024 || n_dir < 1 || n_dir > 2 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  float* f_scratch = static_cast<float*>(scratch);
  float* f_dw_part = static_cast<float*>(dw_part);
  float* f_db_part = static_cast<float*>(db_part);
  float* f_dw = static_cast<float*>(dw);
  float* f_db = static_cast<float*>(db);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xp, wh, bh, mask, ys, gy, dxp, f_scratch, f_dw_part, f_db_part, f_dw,
                         f_db, n_steps, batch, hidden, n_dir, rev_bits, cluster, rows, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xp, wh, bh, mask, ys, gy, dxp, f_scratch, f_dw_part, f_db_part,
                                 f_dw, f_db, n_steps, batch, hidden, n_dir, rev_bits, cluster, rows,
                                 smem, s);
  return launch<__half>(xp, wh, bh, mask, ys, gy, dxp, f_scratch, f_dw_part, f_db_part,
                        f_dw, f_db, n_steps, batch, hidden, n_dir, rev_bits, cluster, rows,
                        smem, s);
}

}  // extern "C"
