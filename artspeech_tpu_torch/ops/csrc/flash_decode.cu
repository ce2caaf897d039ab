// One decode step of causal attention over merged-lane KV caches, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel artspeech_tpu/ops/pallas_attention.py:_flash_kernel
// (pallas_call in flash_decode_attend), which serves the KV-cached transformer
// decode (artspeech_tpu/models/transformer.py:make_fast_generate). For each
// lane g < G of caches K, V (S, hd, G) and a pre-scaled query q (hd, G):
//
//   s_r    = sum_d K[r, d, g] * q[d, g]              for r < n_rows
//   out[:, g] = sum_r softmax_r(s)[r] * V[r, :, g]   (over r < n_rows)
//
// with a running max and denominator in f32 (online softmax). Caches are f32
// or bf16; bf16 is widened to f32 on load, so all arithmetic is f32, as on
// the TPU. expf (not __expf) keeps the result within 1e-5 of the plain
// version.
//
// Layout: the decode's caches as they are, (S, hd, G) contiguous, G being
// every batch and head dimension merged. Rows past n_rows are never read:
// the caller passes n_rows = t + 1 at step t.
//
// What bounds it: each cache row is read once and used for hd
// multiply-adds twice (score and PV), so about 1 operation per byte in f32
// and 2 in bf16: memory bandwidth, far below the card's 20 f32 operations
// per byte. At the decode's shapes (hd = 16, G = 40 to 23,040) one call reads
// from a few kB to 377 MB (the B = 64 cross-channel caches in f32 at
// n_rows = 128: 0.11 ms at 3.35 TB/s), so at small G the launch and the
// number of blocks in flight matter as much as the bytes.
//
// Design: a block holds 32 lanes (one warp's width, so a warp's loads of
// K[r, d, g..g+31] are one contiguous span) and SPLITS warps; warp y takes
// rows y, y + SPLITS, ... of its lanes with q, the running max, the
// denominator and the accumulator in registers (one thread per (lane, warp)).
// The warps' partial (m, l, acc) then meet in shared memory and every thread
// of the block writes a share of the output rows. SPLITS shrinks as hd grows
// (registers and shared memory) and never exceeds n_rows. The TPU kernel's
// sequential grid over row chunks has no counterpart: rows are split across
// the warps of one block instead. Splitting rows across blocks too
// (flash-decoding's split-K with a combine pass) is the next step for small G.
//
// The wide instance. The kernel above holds q and the accumulator in
// registers (2 * HD_MAX floats a thread), so it stops at hd = 64. For
// 64 < hd <= 256, flash_decode_wide_kernel keeps them in dynamic shared
// memory instead: q as (hd, 32 lanes), shared by the block's warps, and
// each warp's accumulator as (hd, 32 lanes), which is also the partial the
// warps combine at the end (lane-major, so a warp's accesses fall on 32
// banks). It takes at most WIDE_SPLITS warps: (WIDE_SPLITS (hd + 2) + hd)
// 128 bytes, 164,864 B at hd = 256. Each row costs a shared-memory
// read-modify-write per element of the accumulator beside the two cache
// reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;

// Most warps a block takes for a head dim of at most HD_MAX: the partials
// (SPLITS x (HD_MAX + 2) x 32 floats) stay within 48 KiB of static-size
// shared memory and the registers (2 * HD_MAX a thread) within the SM's.
template <int HD_MAX>
struct MaxSplits {
  static constexpr int value = HD_MAX <= 16 ? 16 : (HD_MAX <= 32 ? 8 : 4);
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int HD_MAX>
__global__ void __launch_bounds__(LANES * MaxSplits<HD_MAX>::value)
flash_decode_kernel(const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ q, float* __restrict__ out, int hd, int g_total,
                    int n_rows) {
  constexpr int SPLITS_MAX = MaxSplits<HD_MAX>::value;
  __shared__ float part[SPLITS_MAX][HD_MAX + 2][LANES];  // acc rows, then m, then l
  const int lane = threadIdx.x;
  const int split = threadIdx.y;
  const int splits = blockDim.y;
  const int g = blockIdx.x * LANES + lane;
  const bool active = g < g_total;
  const size_t gs = (size_t)g_total;
  const size_t row_stride = (size_t)hd * gs;

  float qr[HD_MAX], acc[HD_MAX];
#pragma unroll
  for (int d = 0; d < HD_MAX; ++d) {
    qr[d] = (active && d < hd) ? q[d * gs + g] : 0.0f;
    acc[d] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;
  if (active) {
    for (int r = split; r < n_rows; r += splits) {
      const T* kr = k + r * row_stride + g;
      const T* vr = v + r * row_stride + g;
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < HD_MAX; ++d)
        if (d < hd) s = fmaf(widen(kr[d * gs]), qr[d], s);
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);  // 0 at the first row (m = -inf)
      const float p = expf(s - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int d = 0; d < HD_MAX; ++d)
        if (d < hd) acc[d] = fmaf(p, widen(vr[d * gs]), acc[d] * alpha);
      m = m_new;
    }
  }
#pragma unroll
  for (int d = 0; d < HD_MAX; ++d)
    if (d < hd) part[split][d][lane] = acc[d];
  part[split][HD_MAX][lane] = m;
  part[split][HD_MAX + 1][lane] = l;
  __syncthreads();
  if (!active) return;

  // Every thread rebuilds the block's max and denominator for its lane (at
  // most SPLITS_MAX terms), then writes output rows d = split, split +
  // splits, ...: a warp writes one contiguous span of 32 lanes per row.
  float m_all = -INFINITY;
  for (int y = 0; y < splits; ++y) m_all = fmaxf(m_all, part[y][HD_MAX][lane]);
  float l_all = 0.0f;
  for (int y = 0; y < splits; ++y) {
    const float my = part[y][HD_MAX][lane];
    l_all += my == -INFINITY ? 0.0f : part[y][HD_MAX + 1][lane] * expf(my - m_all);
  }
  for (int d = split; d < hd; d += splits) {
    float a = 0.0f;
    for (int y = 0; y < splits; ++y) {
      const float my = part[y][HD_MAX][lane];
      if (my != -INFINITY) a = fmaf(part[y][d][lane], expf(my - m_all), a);
    }
    out[d * gs + g] = a / l_all;
  }
}

constexpr int WIDE_SPLITS = 4;

size_t wide_smem_bytes(int hd, int splits) {
  return sizeof(float) * LANES * ((size_t)splits * (hd + 2) + hd);
}

template <typename T>
__global__ void __launch_bounds__(LANES * WIDE_SPLITS)
flash_decode_wide_kernel(const T* __restrict__ k, const T* __restrict__ v,
                         const float* __restrict__ q, float* __restrict__ out, int hd,
                         int g_total, int n_rows) {
  extern __shared__ float wide_smem[];
  const int lane = threadIdx.x;
  const int split = threadIdx.y;
  const int splits = blockDim.y;
  const int g = blockIdx.x * LANES + lane;
  const bool active = g < g_total;
  const size_t gs = (size_t)g_total;
  const size_t row_stride = (size_t)hd * gs;
  float* q_s = wide_smem;                                 // (hd, LANES)
  float* part = q_s + (size_t)hd * LANES;                 // (splits, hd + 2, LANES)
  float* acc = part + (size_t)split * (hd + 2) * LANES;   // this warp's (hd + 2, LANES)

  for (int d = split; d < hd; d += splits) q_s[d * LANES + lane] = active ? q[d * gs + g] : 0.0f;
  for (int d = 0; d < hd; ++d) acc[d * LANES + lane] = 0.0f;
  __syncthreads();
  float m = -INFINITY, l = 0.0f;
  if (active) {
    for (int r = split; r < n_rows; r += splits) {
      const T* kr = k + r * row_stride + g;
      const T* vr = v + r * row_stride + g;
      float s = 0.0f;
      for (int d = 0; d < hd; ++d) s = fmaf(widen(kr[d * gs]), q_s[d * LANES + lane], s);
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);  // 0 at the first row (m = -inf)
      const float p = expf(s - m_new);
      l = l * alpha + p;
      for (int d = 0; d < hd; ++d) {
        float* a = acc + d * LANES + lane;
        *a = fmaf(p, widen(vr[d * gs]), *a * alpha);
      }
      m = m_new;
    }
  }
  acc[hd * LANES + lane] = m;
  acc[(hd + 1) * LANES + lane] = l;
  __syncthreads();
  if (!active) return;

  const size_t part_stride = (size_t)(hd + 2) * LANES;
  float m_all = -INFINITY;
  for (int y = 0; y < splits; ++y) m_all = fmaxf(m_all, part[y * part_stride + hd * LANES + lane]);
  float l_all = 0.0f;
  for (int y = 0; y < splits; ++y) {
    const float my = part[y * part_stride + hd * LANES + lane];
    l_all += my == -INFINITY ? 0.0f
                             : part[y * part_stride + (hd + 1) * LANES + lane] * expf(my - m_all);
  }
  for (int d = split; d < hd; d += splits) {
    float a = 0.0f;
    for (int y = 0; y < splits; ++y) {
      const float my = part[y * part_stride + hd * LANES + lane];
      if (my != -INFINITY) a = fmaf(part[y * part_stride + d * LANES + lane], expf(my - m_all), a);
    }
    out[d * gs + g] = a / l_all;
  }
}

template <typename T>
int launch_wide(const void* k, const void* v, const void* q, void* out, int hd, int g,
                int n_rows, cudaStream_t stream) {
  const int splits = n_rows < WIDE_SPLITS ? n_rows : WIDE_SPLITS;
  const size_t smem = wide_smem_bytes(hd, splits);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_decode_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(LANES, splits);
  const dim3 grid((g + LANES - 1) / LANES);
  flash_decode_wide_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(q),
      static_cast<float*>(out), hd, g, n_rows);
  return (int)cudaGetLastError();
}

template <typename T, int HD_MAX>
int launch(const void* k, const void* v, const void* q, void* out, int hd, int g, int n_rows,
           cudaStream_t stream) {
  const int splits = n_rows < MaxSplits<HD_MAX>::value ? n_rows : MaxSplits<HD_MAX>::value;
  const dim3 block(LANES, splits);
  const dim3 grid((g + LANES - 1) / LANES);
  flash_decode_kernel<T, HD_MAX><<<grid, block, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(q),
      static_cast<float*>(out), hd, g, n_rows);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* k, const void* v, const void* q, void* out, int hd, int g,
                int n_rows, cudaStream_t stream) {
  if (hd <= 16) return launch<T, 16>(k, v, q, out, hd, g, n_rows, stream);
  if (hd <= 32) return launch<T, 32>(k, v, q, out, hd, g, n_rows, stream);
  if (hd <= 64) return launch<T, 64>(k, v, q, out, hd, g, n_rows, stream);
  return launch_wide<T>(k, v, q, out, hd, g, n_rows, stream);
}

}  // namespace

extern "C" {

// Largest head dim the kernels take (the wrapper refuses more).
int flash_decode_max_hd() { return 256; }

// k, v: (S, hd, G) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); q: (hd, G) f32;
// out: (hd, G) f32. Reads rows [0, n_rows), 1 <= n_rows <= S. Returns the
// first nonzero cudaError_t of the launch, else 0.
int flash_decode(const void* k, const void* v, const void* q, void* out, int hd, int g,
                 int n_rows, int is_bf16, void* stream) {
  if (hd < 1 || hd > 256 || g < 1 || n_rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_hd<__nv_bfloat16>(k, v, q, out, hd, g, n_rows, s)
                 : dispatch_hd<float>(k, v, q, out, hd, g, n_rows, s);
}

}  // extern "C"
