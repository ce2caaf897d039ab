// Fused causal attention for training, forward and backward, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernels artspeech_tpu/ops/pallas_train_attention.py:
// _fwd_kernel (pallas_call in _fused_fwd_impl) and _bwd_kernel (pallas_call in
// _fused_bwd), which serve the multi-channel transformer's cross-channel pair
// attention in training (artspeech_tpu/models/transformer.py,
// FusedChannelInteractions). For each group g < G of q, k, v (G, L, hd), q
// pre-scaled by 1/sqrt(hd), and the keep mask of its pair,
// keep[g / (G / n_pairs)] (L, L), pre-scaled by 1/keep_prob:
//
//   s_qk  = q_q . k_k                      for k <= q (causal)
//   P_qk  = exp(s_qk - max_k s) / z_q      (softmax over k <= q)
//   out_q = sum_k P_qk keep_qk v_k
//
// and its backward, given dO:
//
//   dV_k = sum_q P_qk keep_qk dO_q,   dP_qk = (dO_q . v_k) keep_qk,
//   dS_qk = P_qk (dP_qk - D_q),       D_q = sum_k dP_qk P_qk = dO_q . out_q,
//   dQ_q = sum_k dS_qk k_k,           dK_k = sum_q dS_qk q_q.
//
// The (L, L) scores never reach device memory, in either direction. The
// forward also writes lse_q = max + log z_q (G, L), so the backward rebuilds
// P_qk = exp(s_qk - lse_q) without a statistics pass, and takes D_q from the
// forward's output. All arithmetic is f32 with expf/logf; every row has its
// own key k = q, so no -inf reaches an exponent.
//
// What bounds it: per causal (q, k) pair the forward does 4 hd operations
// (score and PV) against 4 hd bytes of q/k/v/out per row, so at L = 128 and
// hd = 16 about 2.3 GFLOP against 147 MB at the thesis batch (G = 4,320):
// bytes and operations take about the same time at the card's peaks (0.044
// and 0.034 ms). The backward does 10 hd operations per pair (the score, dP,
// dV, dQ, dK products), so it leans to operations. Neither uses the tensor
// cores: hd = 16 and f32.
//
// Design: a block of 128 threads takes one group (L > 64) or 128 / span
// groups (span = L rounded up to 32: two groups at L <= 64, four at L <= 32),
// and loads the groups' K and V (forward), or Q, K, V and dO (backward), into
// shared memory, each row padded with zeros to HD = 16 or 32 floats so the
// inner loops read it as float4. A thread owns rows (its own q or k row and the running sums
// in registers) and loops over the other side's rows in shared memory; all
// active threads of a warp read the same shared row at the same time (a
// broadcast, no bank conflicts):
// - forward: one thread a query row, keys 0..q in order, online softmax
//   rescaled only when the running max rises;
// - backward: first dQ, one thread a query row over keys 0..q; then dK and
//   dV, one thread a key row over queries L-1 down to k.
// The TPU kernels' G_BLOCK and 128-multiple L have no counterpart: any L up
// to 512 and any G (blocks past G idle) are taken. wgmma and TMA are later
// work.
//
// The wide instances. The kernels above hold a row of hd floats per thread
// in registers and all L rows of a group in shared memory, so they take
// hd <= 32 and L <= 512, and the backward's block fits only while
// 4 (4 L HD + 2 L) bytes a group stay within 232,448 (not at L = 512 with
// hd > 16). Every other shape, hd up to 128, takes the wide kernels,
// which give a row to a warp instead of a thread: lane l holds elements
// l, l + 32, ... of the warp's row (NPL = ceil(hd / 32) of them, rounded up
// to 1, 2 or 4), each dot product is a butterfly of shuffles (every lane
// ends with the same sum, so all lanes take the same softmax steps), and the
// other side's rows are read from global memory by the warp in coalesced
// 128-byte spans (they stay in L1 and L2: a group's K and V at L = 512,
// hd = 128 are 512 KiB). No shared memory; L stays within MAX_L, the
// longest default bucket.
// - forward: a warp a query row, keys 0..q in order, the same online
//   softmax as above; four warps a block;
// - backward, two launches: dQ a warp a query row (it also writes
//   D_q = dO_q . out_q into a (G, L) scratch), then dK and dV a warp a key
//   row over queries L-1 down to k, reading D from the scratch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_L = 512;
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory one Hopper block may use

__host__ __device__ inline int row_span(int l) { return (l + 31) / 32 * 32; }
__host__ __device__ inline int groups_per_block(int l) {
  const int span = row_span(l);
  return span >= THREADS ? 1 : THREADS / span;
}

// Shared-memory rows are HD floats (hd rounded up to the template's width,
// zero-filled), so the inner loops read them as float4 with no bounds.
size_t fwd_smem_bytes(int l, int hd_max) {
  return sizeof(float) * 2 * (size_t)groups_per_block(l) * l * hd_max;
}
size_t bwd_smem_bytes(int l, int hd_max) {
  return sizeof(float) * (size_t)groups_per_block(l) * (4 * (size_t)l * hd_max + 2 * (size_t)l);
}

// Which group of the block a thread serves, its first row and its row
// stride: a warp never spans two groups (spans are multiples of 32).
struct Rows {
  int group, first, stride;
};
__device__ inline Rows thread_rows(int l) {
  if (groups_per_block(l) == 1) return {0, (int)threadIdx.x, THREADS};
  const int span = row_span(l);
  return {(int)threadIdx.x / span, (int)threadIdx.x % span, span};
}

// n rows of hd floats from src into HD-float rows of dst, zero-padded.
template <int HD>
__device__ inline void stage(float* dst, const float* __restrict__ src, int n, int hd) {
  for (int i = threadIdx.x; i < n * HD; i += THREADS) {
    const int row = i / HD, d = i % HD;
    dst[i] = d < hd ? src[(size_t)row * hd + d] : 0.0f;
  }
}

// a . b over HD floats, b a 16-byte aligned shared-memory row; four
// partial sums, so the chain of dependent multiply-adds is HD / 4 long.
template <int HD>
__device__ inline float dot(const float* a, const float* b) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(b + d);
    s0 = fmaf(a[d], x.x, s0);
    s1 = fmaf(a[d + 1], x.y, s1);
    s2 = fmaf(a[d + 2], x.z, s2);
    s3 = fmaf(a[d + 3], x.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// acc += w * b over HD floats, b a 16-byte aligned shared-memory row.
template <int HD>
__device__ inline void axpy(float* acc, float w, const float* b) {
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(b + d);
    acc[d] = fmaf(w, x.x, acc[d]);
    acc[d + 1] = fmaf(w, x.y, acc[d + 1]);
    acc[d + 2] = fmaf(w, x.z, acc[d + 2]);
    acc[d + 3] = fmaf(w, x.w, acc[d + 3]);
  }
}

template <int HD>
__device__ inline void load_row(float* dst, const float* src, int hd) {
#pragma unroll
  for (int d = 0; d < HD; ++d) dst[d] = d < hd ? src[d] : 0.0f;
}

template <int HD>
__device__ inline void store_row(float* dst, const float* src, int hd) {
#pragma unroll
  for (int d = 0; d < HD; ++d)
    if (d < hd) dst[d] = src[d];
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
train_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ keep,
                           float* __restrict__ out, float* __restrict__ lse, int g_total, int l,
                           int hd, int groups_per_pair) {
  extern __shared__ __align__(16) float smem[];
  const int gpb = groups_per_block(l);
  const int g0 = blockIdx.x * gpb;
  const int ng = min(gpb, g_total - g0);
  const size_t rows_hd = (size_t)l * HD;  // one group's rows in shared memory
  float* ks = smem;
  float* vs = smem + gpb * rows_hd;
  stage<HD>(ks, k + (size_t)g0 * l * hd, ng * l, hd);
  stage<HD>(vs, v + (size_t)g0 * l * hd, ng * l, hd);
  __syncthreads();
  const Rows rows = thread_rows(l);
  if (rows.group >= ng) return;
  const size_t g = (size_t)(g0 + rows.group);
  const float* kg = ks + rows.group * rows_hd;
  const float* vg = vs + rows.group * rows_hd;
  const float* keep_g = keep + (g / groups_per_pair) * l * l;

  for (int r = rows.first; r < l; r += rows.stride) {
    float qr[HD], acc[HD];
    load_row<HD>(qr, q + (g * l + r) * hd, hd);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
    const float* keep_r = keep_g + (size_t)r * l;
    // Online softmax, rescaled only when the running max rises (it rises
    // rarely after the first keys); key 0 sets it.
    float m = dot<HD>(qr, kg), z = 0.0f;
    for (int j = 0; j <= r; ++j) {
      const float s = dot<HD>(qr, kg + j * HD);
      if (s > m) {
        const float alpha = expf(m - s);
        z *= alpha;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] *= alpha;
        m = s;
      }
      const float p = expf(s - m);
      z += p;
      axpy<HD>(acc, p * keep_r[j], vg + j * HD);
    }
    const float inv_z = 1.0f / z;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= inv_z;
    store_row<HD>(out + (g * l + r) * hd, acc, hd);
    lse[g * l + r] = m + logf(z);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
train_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ keep,
                           const float* __restrict__ out, const float* __restrict__ lse,
                           const float* __restrict__ dout, float* __restrict__ dq,
                           float* __restrict__ dk, float* __restrict__ dv, int g_total, int l,
                           int hd, int groups_per_pair) {
  extern __shared__ __align__(16) float smem[];
  const int gpb = groups_per_block(l);
  const int g0 = blockIdx.x * gpb;
  const int ng = min(gpb, g_total - g0);
  const size_t rows_hd = (size_t)l * HD;
  float* qs = smem;
  float* ks = qs + gpb * rows_hd;
  float* vs = ks + gpb * rows_hd;
  float* dos = vs + gpb * rows_hd;
  float* lse_s = dos + gpb * rows_hd;
  float* dsum = lse_s + gpb * l;
  const size_t base = (size_t)g0 * l * hd;
  stage<HD>(qs, q + base, ng * l, hd);
  stage<HD>(ks, k + base, ng * l, hd);
  stage<HD>(vs, v + base, ng * l, hd);
  stage<HD>(dos, dout + base, ng * l, hd);
  // D_q = dO_q . out_q (equal to rowsum(dP * P) through the keep fold).
  const size_t row0 = (size_t)g0 * l;
  for (int i = threadIdx.x; i < ng * l; i += THREADS) {
    const float* a = dout + (row0 + i) * hd;
    const float* b = out + (row0 + i) * hd;
    float s = 0.0f;
    for (int d = 0; d < hd; ++d) s = fmaf(a[d], b[d], s);
    lse_s[i] = lse[row0 + i];
    dsum[i] = s;
  }
  __syncthreads();
  const Rows rows = thread_rows(l);
  if (rows.group >= ng) return;
  const int lg = rows.group;
  const size_t g = (size_t)(g0 + lg);
  const float* qg = qs + lg * rows_hd;
  const float* kg = ks + lg * rows_hd;
  const float* vg = vs + lg * rows_hd;
  const float* dog = dos + lg * rows_hd;
  const float* lse_g = lse_s + lg * l;
  const float* dsum_g = dsum + lg * l;
  const float* keep_g = keep + (g / groups_per_pair) * l * l;

  // dQ: one thread a query row, keys 0..r.
  for (int r = rows.first; r < l; r += rows.stride) {
    float qr[HD], dor[HD], acc[HD];
    load_row<HD>(qr, q + (g * l + r) * hd, hd);
    load_row<HD>(dor, dout + (g * l + r) * hd, hd);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
    const float lse_r = lse_g[r], d_r = dsum_g[r];
    const float* keep_r = keep_g + (size_t)r * l;
    for (int j = 0; j <= r; ++j) {
      const float* kj = kg + j * HD;
      const float p = expf(dot<HD>(qr, kj) - lse_r);
      const float dp = dot<HD>(dor, vg + j * HD) * keep_r[j];
      axpy<HD>(acc, p * (dp - d_r), kj);
    }
    store_row<HD>(dq + (g * l + r) * hd, acc, hd);
  }

  // dK and dV: one thread a key row c, queries L-1 down to c (so the active
  // threads of a warp read the same query row at each step).
  for (int c = rows.first; c < l; c += rows.stride) {
    float kc[HD], vc[HD], dka[HD], dva[HD];
    load_row<HD>(kc, k + (g * l + c) * hd, hd);
    load_row<HD>(vc, v + (g * l + c) * hd, hd);
#pragma unroll
    for (int d = 0; d < HD; ++d) dka[d] = dva[d] = 0.0f;
    for (int i = l - 1; i >= c; --i) {
      const float* qi = qg + i * HD;
      const float* doi = dog + i * HD;
      const float kp = keep_g[(size_t)i * l + c];
      const float p = expf(dot<HD>(kc, qi) - lse_g[i]);
      axpy<HD>(dva, p * kp, doi);
      axpy<HD>(dka, p * (dot<HD>(vc, doi) * kp - dsum_g[i]), qi);
    }
    store_row<HD>(dk + (g * l + c) * hd, dka, hd);
    store_row<HD>(dv + (g * l + c) * hd, dva, hd);
  }
}

// ---- wide instances: a warp a row ------------------------------------------

constexpr int WIDE_WARPS = 4;  // rows a block

// Elements l, l + 32, ... (NPL of them) of an hd-float row, zero past hd.
template <int NPL>
__device__ inline void load_lanes(float* dst, const float* __restrict__ row, int hd, int lane) {
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    dst[i] = d < hd ? row[d] : 0.0f;
  }
}

template <int NPL>
__device__ inline void store_lanes(float* row, const float* src, int hd, int lane) {
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) row[d] = src[i];
  }
}

// Sum over the warp by a fixed xor butterfly: every lane gets the same value.
__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int NPL>
__device__ inline float lane_dot(const float* a, const float* __restrict__ row, int hd, int lane) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) s = fmaf(a[i], row[d], s);
  }
  return warp_sum(s);
}

template <int NPL>
__device__ inline void lane_axpy(float* acc, float w, const float* __restrict__ row, int hd,
                                 int lane) {
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) acc[i] = fmaf(w, row[d], acc[i]);
  }
}

template <int NPL>
__global__ void __launch_bounds__(32 * WIDE_WARPS)
train_attention_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ keep,
                                float* __restrict__ out, float* __restrict__ lse, int g_total,
                                int l, int hd, int groups_per_pair) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * WIDE_WARPS + (threadIdx.x >> 5);  // g * L + r
  if (row >= (size_t)g_total * l) return;
  const size_t g = row / l;
  const int r = (int)(row - g * l);
  const float* kg = k + g * l * hd;
  const float* vg = v + g * l * hd;
  const float* keep_r = keep + ((g / groups_per_pair) * l + r) * l;
  float qr[NPL], acc[NPL];
  load_lanes<NPL>(qr, q + row * hd, hd, lane);
#pragma unroll
  for (int i = 0; i < NPL; ++i) acc[i] = 0.0f;
  float m = -INFINITY, z = 0.0f;
  for (int j = 0; j <= r; ++j) {
    const float s = lane_dot<NPL>(qr, kg + (size_t)j * hd, hd, lane);
    if (s > m) {
      const float alpha = expf(m - s);  // 0 at the first key
      z *= alpha;
#pragma unroll
      for (int i = 0; i < NPL; ++i) acc[i] *= alpha;
      m = s;
    }
    const float p = expf(s - m);
    z += p;
    lane_axpy<NPL>(acc, p * keep_r[j], vg + (size_t)j * hd, hd, lane);
  }
  const float inv_z = 1.0f / z;
#pragma unroll
  for (int i = 0; i < NPL; ++i) acc[i] *= inv_z;
  store_lanes<NPL>(out + row * hd, acc, hd, lane);
  if (lane == 0) lse[row] = m + logf(z);
}

template <int NPL>
__global__ void __launch_bounds__(32 * WIDE_WARPS)
train_attention_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ keep,
                               const float* __restrict__ out, const float* __restrict__ lse,
                               const float* __restrict__ dout, float* __restrict__ dq,
                               float* __restrict__ dsum, int g_total, int l, int hd,
                               int groups_per_pair) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * WIDE_WARPS + (threadIdx.x >> 5);
  if (row >= (size_t)g_total * l) return;
  const size_t g = row / l;
  const int r = (int)(row - g * l);
  const float* kg = k + g * l * hd;
  const float* vg = v + g * l * hd;
  const float* keep_r = keep + ((g / groups_per_pair) * l + r) * l;
  float qr[NPL], dor[NPL], acc[NPL];
  load_lanes<NPL>(qr, q + row * hd, hd, lane);
  load_lanes<NPL>(dor, dout + row * hd, hd, lane);
  const float d_r = lane_dot<NPL>(dor, out + row * hd, hd, lane);
  if (lane == 0) dsum[row] = d_r;
#pragma unroll
  for (int i = 0; i < NPL; ++i) acc[i] = 0.0f;
  const float lse_r = lse[row];
  for (int j = 0; j <= r; ++j) {
    const float* kj = kg + (size_t)j * hd;
    const float p = expf(lane_dot<NPL>(qr, kj, hd, lane) - lse_r);
    const float dp = lane_dot<NPL>(dor, vg + (size_t)j * hd, hd, lane) * keep_r[j];
    lane_axpy<NPL>(acc, p * (dp - d_r), kj, hd, lane);
  }
  store_lanes<NPL>(dq + row * hd, acc, hd, lane);
}

template <int NPL>
__global__ void __launch_bounds__(32 * WIDE_WARPS)
train_attention_dkv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ keep,
                                const float* __restrict__ lse, const float* __restrict__ dout,
                                const float* __restrict__ dsum, float* __restrict__ dk,
                                float* __restrict__ dv, int g_total, int l, int hd,
                                int groups_per_pair) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * WIDE_WARPS + (threadIdx.x >> 5);  // g * L + c
  if (row >= (size_t)g_total * l) return;
  const size_t g = row / l;
  const int c = (int)(row - g * l);
  const float* qg = q + g * l * hd;
  const float* dog = dout + g * l * hd;
  const float* lse_g = lse + g * l;
  const float* dsum_g = dsum + g * l;
  const float* keep_g = keep + (g / groups_per_pair) * l * l;
  float kc[NPL], vc[NPL], dka[NPL], dva[NPL];
  load_lanes<NPL>(kc, k + row * hd, hd, lane);
  load_lanes<NPL>(vc, v + row * hd, hd, lane);
#pragma unroll
  for (int i = 0; i < NPL; ++i) dka[i] = dva[i] = 0.0f;
  for (int i = l - 1; i >= c; --i) {
    const float* qi = qg + (size_t)i * hd;
    const float* doi = dog + (size_t)i * hd;
    const float kp = keep_g[(size_t)i * l + c];
    const float p = expf(lane_dot<NPL>(kc, qi, hd, lane) - lse_g[i]);
    const float dp = lane_dot<NPL>(vc, doi, hd, lane) * kp;
    lane_axpy<NPL>(dva, p * kp, doi, hd, lane);
    lane_axpy<NPL>(dka, p * (dp - dsum_g[i]), qi, hd, lane);
  }
  store_lanes<NPL>(dk + row * hd, dka, hd, lane);
  store_lanes<NPL>(dv + row * hd, dva, hd, lane);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

bool valid_shape(int g, int l, int hd, int n_pairs) {
  return g >= 1 && l >= 1 && l <= MAX_L && hd >= 1 && hd <= 128 && n_pairs >= 1 &&
         g % n_pairs == 0;
}

// The kernels that hold rows in registers and shared memory take the shape.
bool resident_fwd(int l, int hd) { return hd <= 32 && l <= MAX_L; }
bool resident_bwd(int l, int hd) {
  return hd <= 32 && l <= MAX_L && bwd_smem_bytes(l, hd <= 16 ? 16 : 32) <= MAX_SMEM;
}

int wide_blocks(int g, int l) {
  return (int)(((size_t)g * l + WIDE_WARPS - 1) / WIDE_WARPS);
}

template <int NPL>
int launch_fwd_wide(const void* q, const void* k, const void* v, const void* keep, void* out,
                    void* lse, int g, int l, int hd, int n_pairs, cudaStream_t stream) {
  train_attention_fwd_wide_kernel<NPL><<<wide_blocks(g, l), 32 * WIDE_WARPS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(keep), static_cast<float*>(out), static_cast<float*>(lse), g, l,
      hd, g / n_pairs);
  return (int)cudaGetLastError();
}

template <int NPL>
int launch_bwd_wide(const void* q, const void* k, const void* v, const void* keep,
                    const void* out, const void* lse, const void* dout, void* dq, void* dk,
                    void* dv, void* dsum, int g, int l, int hd, int n_pairs,
                    cudaStream_t stream) {
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fkeep = static_cast<const float*>(keep);
  const float* flse = static_cast<const float*>(lse);
  const float* fdout = static_cast<const float*>(dout);
  float* fdsum = static_cast<float*>(dsum);
  train_attention_dq_wide_kernel<NPL><<<wide_blocks(g, l), 32 * WIDE_WARPS, 0, stream>>>(
      fq, fk, fv, fkeep, static_cast<const float*>(out), flse, fdout, static_cast<float*>(dq),
      fdsum, g, l, hd, g / n_pairs);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  train_attention_dkv_wide_kernel<NPL><<<wide_blocks(g, l), 32 * WIDE_WARPS, 0, stream>>>(
      fq, fk, fv, fkeep, flse, fdout, fdsum, static_cast<float*>(dk), static_cast<float*>(dv), g,
      l, hd, g / n_pairs);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, const void* keep, void* out,
               void* lse, int g, int l, int hd, int n_pairs, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(l, HD);
  const int err = prepare(train_attention_fwd_kernel<HD>, smem);
  if (err) return err;
  const int gpb = groups_per_block(l);
  train_attention_fwd_kernel<HD><<<(g + gpb - 1) / gpb, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(keep), static_cast<float*>(out), static_cast<float*>(lse), g, l,
      hd, g / n_pairs);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* keep, const void* out,
               const void* lse, const void* dout, void* dq, void* dk, void* dv, int g, int l,
               int hd, int n_pairs, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(l, HD);
  const int err = prepare(train_attention_bwd_kernel<HD>, smem);
  if (err) return err;
  const int gpb = groups_per_block(l);
  train_attention_bwd_kernel<HD><<<(g + gpb - 1) / gpb, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(keep), static_cast<const float*>(out),
      static_cast<const float*>(lse), static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), g, l, hd, g / n_pairs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: (G, L, hd) f32; keep: (n_pairs, L, L) f32; out: (G, L, hd) f32;
// lse: (G, L) f32. 1 <= L <= 512, 1 <= hd <= 128, n_pairs divides G. Returns the
// first nonzero cudaError_t of the launch, else 0.
int train_attention_fwd(const void* q, const void* k, const void* v, const void* keep, void* out,
                        void* lse, int g, int l, int hd, int n_pairs, void* stream) {
  if (!valid_shape(g, l, hd, n_pairs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (resident_fwd(l, hd))
    return hd <= 16 ? launch_fwd<16>(q, k, v, keep, out, lse, g, l, hd, n_pairs, s)
                    : launch_fwd<32>(q, k, v, keep, out, lse, g, l, hd, n_pairs, s);
  // Within MAX_L every hd <= 32 is resident, so the wide forward sees hd > 32.
  return hd <= 64 ? launch_fwd_wide<2>(q, k, v, keep, out, lse, g, l, hd, n_pairs, s)
                  : launch_fwd_wide<4>(q, k, v, keep, out, lse, g, l, hd, n_pairs, s);
}

// As train_attention_fwd, plus its out and lse, dout (G, L, hd) f32, the
// gradients dq, dk, dv (G, L, hd) f32, and dsum, (G, L) f32 scratch that
// the wide kernels fill with D_q = dO_q . out_q.
int train_attention_bwd(const void* q, const void* k, const void* v, const void* keep,
                        const void* out, const void* lse, const void* dout, void* dq, void* dk,
                        void* dv, void* dsum, int g, int l, int hd, int n_pairs, void* stream) {
  if (!valid_shape(g, l, hd, n_pairs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (resident_bwd(l, hd))
    return hd <= 16
               ? launch_bwd<16>(q, k, v, keep, out, lse, dout, dq, dk, dv, g, l, hd, n_pairs, s)
               : launch_bwd<32>(q, k, v, keep, out, lse, dout, dq, dk, dv, g, l, hd, n_pairs, s);
  if (hd <= 32)
    return launch_bwd_wide<1>(q, k, v, keep, out, lse, dout, dq, dk, dv, dsum, g, l, hd, n_pairs,
                              s);
  if (hd <= 64)
    return launch_bwd_wide<2>(q, k, v, keep, out, lse, dout, dq, dk, dv, dsum, g, l, hd, n_pairs,
                              s);
  return launch_bwd_wide<4>(q, k, v, keep, out, lse, dout, dq, dk, dv, dsum, g, l, hd, n_pairs,
                            s);
}

// 1 when the forward (backward = 0) or backward (backward = 1) at (L, hd)
// takes the kernels that hold rows in registers, 0 when the wide ones.
int train_attention_resident(int l, int hd, int backward) {
  return backward ? resident_bwd(l, hd) : resident_fwd(l, hd);
}

}  // extern "C"
