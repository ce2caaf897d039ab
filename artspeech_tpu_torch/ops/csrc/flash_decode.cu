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
// with a running max and denominator in f32 (online softmax). Caches are f32,
// bf16 or f16; a 16-bit cache is widened to f32 on load, so all arithmetic is
// f32, as on the TPU. expf (not __expf) keeps the result within 1e-5 of the plain
// version.
//
// Layout: the decode's caches as they are, (S, hd, G) contiguous, G being
// every batch and head dimension merged. Rows past n_rows are never read:
// the caller passes n_rows = t + 1 at step t.
//
// What bounds it: each cache row is read once and used for hd
// multiply-adds twice (score and PV), so about 1 operation per byte in f32
// and 2 in bf16 or f16: memory bandwidth, far below the card's 20 f32 operations
// per byte. At the decode's shapes (hd = 16; G = 480 / 2,560 for the self
// caches and 4,320 / 23,040 for the cross-channel caches at B = 12 / 64;
// n_rows = 1 ... 128) one call reads from 15 kB to 377 MB, so most calls are
// too small to fill the card unless their rows are split across CTAs, and
// the large ones need many bytes in flight on every SM.
//
// Design (the register instance, hd <= 64). The TPU kernel walks row chunks
// in a sequential grid; here the rows of a lane block are split twice, across
// the CTAs of a thread-block cluster and across the warps of each CTA
// (flash-decoding's split-K), and combined in one launch:
//
// - A cluster of C <= 8 CTAs owns a block of 32 * LPT lanes (LPT = lanes a
//   thread: 1, or 2 loaded as one 8-byte (f32) or 4-byte (bf16, f16) word, so
//   that a warp's 16-bit load spans 128 B). Its C * W warps are the row splits:
//   split s = rank * W + warp takes rows [s * n_rows / (C W), (s + 1) *
//   n_rows / (C W)), each warp the lane block's whole width.
// - A warp issues the K and V loads of a group of U rows (2 or 1, by
//   registers) before it uses any of them, and, where registers allow (hd <=
//   32), the next group's before it folds the current one into its running
//   (m, l, acc) with one rescale: two groups in flight.
// - The W warps' partials meet in shared memory and each CTA reduces them to
//   one (m, l, acc) per lane. After a cluster barrier, CTA r writes the output
//   rows d = r, r + C, ...: it reads the C CTAs' partials through distributed
//   shared memory (cluster.map_shared_rank) in CTA order, so two launches
//   give the same bits. A partial with no rows (m = -inf) adds nothing. A
//   second cluster barrier keeps every CTA's shared memory alive until its
//   peers have read it. A cluster of one CTA writes the output from its own
//   partial, with no cluster barrier. No workspace, no atomics, no second
//   kernel.
//
// The launch (LPT, C, W, the shared memory) comes from
// hopper_attention.flash_decode_launch_geometry, passed as arguments; the
// kernel derives nothing else and refuses what it cannot run. The rule aims
// at about two CTAs and four warps an SM: small G takes the largest
// clusters, large G lane pairs, clusters of 1 and long row splits.
//
// The wide instance. The kernel above holds q and the accumulator in
// registers (2 * HD_MAX floats a lane), so it stops at hd = 64. For
// 64 < hd <= 256, flash_decode_wide_kernel keeps them in dynamic shared
// memory instead: q as (hd, 32 lanes), shared by the block's warps, and
// each warp's accumulator as (hd, 32 lanes), which is also the partial the
// warps combine at the end (lane-major, so a warp's accesses fall on 32
// banks). It takes at most WIDE_SPLITS warps: (WIDE_SPLITS (hd + 2) + hd)
// 128 bytes, 164,864 B at hd = 256. Each row costs a shared-memory
// read-modify-write per element of the accumulator beside the two cache
// reads. Its warps, like the register instance's geometry, come from the
// launch rule.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dsmem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int LANES = 32;
constexpr int MAX_WARPS = 8;  // warps a CTA of the register instance

// What one thread loads for one (row, d): LPT lanes of the storage type, as
// raw words. A bf16 is the high half of an f32, so widening is a shift or a
// mask (__nv_bfloat162 loads widened with the intrinsics ran slower on the
// card, PERF.md). An f16 has its own exponent width, so it is widened by the
// intrinsics (__half2float, __half22float2).
template <typename T, int LPT> struct Pack;
template <> struct Pack<float, 1> { using type = uint32_t; };
template <> struct Pack<float, 2> { using type = uint2; };
template <> struct Pack<__nv_bfloat16, 1> { using type = uint16_t; };
template <> struct Pack<__nv_bfloat16, 2> { using type = uint32_t; };
template <> struct Pack<__half, 1> { using type = uint16_t; };
template <> struct Pack<__half, 2> { using type = uint32_t; };

template <typename T, int LPT> struct Unpack;
template <> struct Unpack<float, 1> {
  static __device__ __forceinline__ void to(uint32_t x, float (&o)[1]) { o[0] = __uint_as_float(x); }
};
template <> struct Unpack<float, 2> {
  static __device__ __forceinline__ void to(uint2 x, float (&o)[2]) {
    o[0] = __uint_as_float(x.x);
    o[1] = __uint_as_float(x.y);
  }
};
template <> struct Unpack<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void to(uint16_t x, float (&o)[1]) {
    o[0] = __uint_as_float((uint32_t)x << 16);
  }
};
template <> struct Unpack<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void to(uint32_t x, float (&o)[2]) {
    o[0] = __uint_as_float(x << 16);
    o[1] = __uint_as_float(x & 0xffff0000u);
  }
};
template <> struct Unpack<__half, 1> {
  static __device__ __forceinline__ void to(uint16_t x, float (&o)[1]) {
    o[0] = __half2float(__ushort_as_half(x));
  }
};
template <> struct Unpack<__half, 2> {
  static __device__ __forceinline__ void to(uint32_t x, float (&o)[2]) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&x));
    o[0] = f.x;
    o[1] = f.y;
  }
};

// The loop's shape: a group of U rows loaded before any is used, and two
// groups in flight (the next loaded while the current is folded) where both
// fit in about 128 registers a thread.
template <typename T, int HD_MAX, int LPT>
struct Loop {
  static constexpr int words = 2 * HD_MAX * (LPT * (int)sizeof(T) >= 4 ? LPT * (int)sizeof(T) / 4 : 1);
  static constexpr int rows = words >= 64 ? 1 : 64 / words;  // U
  static constexpr bool pipe = 2 * rows * words <= 128;
};

// Shared memory of the register instance: the W warps' partials and the
// CTA's, each (hd + 2, 32 * LPT) floats (acc rows, then m, then l).
__host__ __device__ inline size_t smem_bytes(int hd, int warps, int lpt) {
  return sizeof(float) * (size_t)(warps + 1) * (hd + 2) * LANES * lpt;
}

// EXACT: hd == HD_MAX, known when compiled: the loops then carry no bound
// checks and the row addresses fold (faster on the card, PERF.md).
template <typename T, int HD_MAX, int LPT, bool EXACT>
__global__ void __launch_bounds__(LANES * MAX_WARPS, 1)
flash_decode_kernel(const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ q, float* __restrict__ out, int hd_arg, int g_total,
                    int n_rows) {
  const int hd = EXACT ? HD_MAX : hd_arg;
  using P = typename Pack<T, LPT>::type;
  using L = Loop<T, HD_MAX, LPT>;
  constexpr int LB = LANES * LPT;  // lanes a cluster owns
  constexpr int U = L::rows;
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int warps = blockDim.x / LANES;
  const int warp = threadIdx.x / LANES;
  const int t = threadIdx.x % LANES;
  const int g_block = (blockIdx.x / csize) * LB;
  const int g0 = g_block + t * LPT;  // LPT = 2: G is even, so g0 + 1 < G too
  const bool active = g0 < g_total;
  const size_t gs = (size_t)g_total;
  const int splits = csize * warps;
  const int split = rank * warps + warp;
  const int r_begin = (int)((long long)split * n_rows / splits);
  const int r_end = (int)((long long)(split + 1) * n_rows / splits);

  float qr[HD_MAX][LPT], acc[HD_MAX][LPT], m[LPT], l[LPT];
#pragma unroll
  for (int d = 0; d < HD_MAX; ++d) {
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      qr[d][j] = active && d < hd ? q[d * gs + g0 + j] : 0.0f;
      acc[d][j] = 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.0f;
  }

  // Issues the K and V loads of rows [r, r + U) (those below r_end).
  auto load = [&](P (&kb)[U][HD_MAX], P (&vb)[U][HD_MAX], int r) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u < r_end) {
        const size_t base = (size_t)(r + u) * hd * gs + g0;
#pragma unroll
        for (int d = 0; d < HD_MAX; ++d) {
          if (d < hd) {
            kb[u][d] = *reinterpret_cast<const P*>(k + base + d * gs);
            vb[u][d] = *reinterpret_cast<const P*>(v + base + d * gs);
          }
        }
      }
    }
  };
  // Folds rows [r, r + U) into (m, l, acc) with one rescale: the group's
  // max, then its rows in order.
  auto fold = [&](const P (&kb)[U][HD_MAX], const P (&vb)[U][HD_MAX], int r) {
    float s[U][LPT], p[U][LPT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < LPT; ++j) s[u][j] = 0.0f;
#pragma unroll
      for (int d = 0; d < HD_MAX; ++d) {
        if (d < hd) {
          float kf[LPT];
          Unpack<T, LPT>::to(kb[u][d], kf);
#pragma unroll
          for (int j = 0; j < LPT; ++j) s[u][j] = fmaf(kf[j], qr[d][j], s[u][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      float m_new = m[j];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r + u < r_end) m_new = fmaxf(m_new, s[u][j]);
      const float alpha = expf(m[j] - m_new);  // 0 at the first row (m = -inf)
      l[j] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u][j] = r + u < r_end ? expf(s[u][j] - m_new) : 0.0f;
        l[j] += p[u][j];
      }
#pragma unroll
      for (int d = 0; d < HD_MAX; ++d) acc[d][j] *= alpha;
      m[j] = m_new;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u < r_end) {
#pragma unroll
        for (int d = 0; d < HD_MAX; ++d) {
          if (d < hd) {
            float vf[LPT];
            Unpack<T, LPT>::to(vb[u][d], vf);
#pragma unroll
            for (int j = 0; j < LPT; ++j) acc[d][j] = fmaf(p[u][j], vf[j], acc[d][j]);
          }
        }
      }
    }
  };

  if (active) {
    if constexpr (L::pipe) {
      // Two groups in flight: group i + 1's loads are issued before group i
      // is folded.
      P ka[U][HD_MAX], va[U][HD_MAX], kc[U][HD_MAX], vc[U][HD_MAX];
      load(ka, va, r_begin);
      for (int r = r_begin; r < r_end; r += 2 * U) {
        load(kc, vc, r + U);
        fold(ka, va, r);
        if (r + U >= r_end) break;
        load(ka, va, r + 2 * U);
        fold(kc, vc, r + U);
      }
    } else {
      for (int r = r_begin; r < r_end; r += U) {
        P kb[U][HD_MAX], vb[U][HD_MAX];
        load(kb, vb, r);
        fold(kb, vb, r);
      }
    }
  }

  // 1. The warps' partials, (warps, hd + 2, LB); a warp with no rows (or no
  //    lanes) writes m = -inf, l = 0, acc = 0.
  const size_t rows = (size_t)(hd + 2);
  float* mine = smem + (size_t)warp * rows * LB + t * LPT;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
#pragma unroll
    for (int d = 0; d < HD_MAX; ++d)
      if (d < hd) mine[d * LB + j] = acc[d][j];
    mine[hd * LB + j] = m[j];
    mine[(hd + 1) * LB + j] = l[j];
  }
  __syncthreads();

  // 2. The CTA's partial (hd + 2, LB) after the warps': a thread a (lane,
  //    group of rows); each rescales the warps' terms to the CTA's max.
  float* cta = smem + (size_t)warps * rows * LB;
  const int nthreads = blockDim.x;
  const int groups = nthreads >= LB ? nthreads / LB : 1;
  for (int idx = threadIdx.x; idx < LB * groups; idx += nthreads) {
    const int lane = idx % LB, grp = idx / LB;
    float mc = -INFINITY;
    for (int w = 0; w < warps; ++w) mc = fmaxf(mc, smem[(w * rows + hd) * LB + lane]);
    float scale[MAX_WARPS];
#pragma unroll
    for (int w = 0; w < MAX_WARPS; ++w) {
      const float mw = w < warps ? smem[(w * rows + hd) * LB + lane] : -INFINITY;
      scale[w] = mw == -INFINITY ? 0.0f : expf(mw - mc);
    }
    for (int row = grp; row < hd + 2; row += groups) {
      float a = mc;
      if (row != hd) {
        a = 0.0f;
#pragma unroll
        for (int w = 0; w < MAX_WARPS; ++w)
          if (w < warps) a = fmaf(smem[(w * rows + row) * LB + lane], scale[w], a);
      }
      cta[row * LB + lane] = a;
    }
  }
  if (csize == 1) {  // no peers: the CTA's partial is the lane block's
    __syncthreads();
    for (int idx = threadIdx.x; idx < LB * groups; idx += nthreads) {
      const int lane = idx % LB, grp = idx / LB;
      const int g = g_block + lane;
      const float l_all = cta[(hd + 1) * LB + lane];
      if (g < g_total)
        for (int d = grp; d < hd; d += groups) out[d * gs + g] = cta[d * LB + lane] / l_all;
    }
    return;
  }
  cluster.sync();

  // 3. CTA `rank` writes output rows d = rank, rank + C, ... from the C CTAs'
  //    partials, read in CTA order through distributed shared memory.
  for (int idx = threadIdx.x; idx < LB * groups; idx += nthreads) {
    const int lane = idx % LB, grp = idx / LB;
    const int g = g_block + lane;
    float mr[dsmem::MAX_CLUSTER];
    float m_all = -INFINITY;
#pragma unroll
    for (int c = 0; c < dsmem::MAX_CLUSTER; ++c) {
      mr[c] = c < csize ? *cluster.map_shared_rank(cta + hd * LB + lane, c) : -INFINITY;
      m_all = fmaxf(m_all, mr[c]);
    }
    float scale[dsmem::MAX_CLUSTER];
    float l_all = 0.0f;
#pragma unroll
    for (int c = 0; c < dsmem::MAX_CLUSTER; ++c) {
      scale[c] = mr[c] == -INFINITY ? 0.0f : expf(mr[c] - m_all);
      if (c < csize) l_all = fmaf(*cluster.map_shared_rank(cta + (hd + 1) * LB + lane, c), scale[c],
                                  l_all);
    }
    if (g < g_total) {
      for (int d = rank + grp * csize; d < hd; d += groups * csize) {
        float a = 0.0f;
#pragma unroll
        for (int c = 0; c < dsmem::MAX_CLUSTER; ++c)
          if (c < csize) a = fmaf(*cluster.map_shared_rank(cta + d * LB + lane, c), scale[c], a);
        out[d * gs + g] = a / l_all;
      }
    }
  }
  cluster.sync();  // every peer has read this CTA's partial
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
      for (int d = 0; d < hd; ++d) s = fmaf(dsmem::to_f32(kr[d * gs]), q_s[d * LANES + lane], s);
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);  // 0 at the first row (m = -inf)
      const float p = expf(s - m_new);
      l = l * alpha + p;
      for (int d = 0; d < hd; ++d) {
        float* a = acc + d * LANES + lane;
        *a = fmaf(p, dsmem::to_f32(vr[d * gs]), *a * alpha);
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
                int n_rows, int warps, int smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_decode_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(LANES, warps);
  const dim3 grid((g + LANES - 1) / LANES);
  flash_decode_wide_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(q),
      static_cast<float*>(out), hd, g, n_rows);
  return (int)cudaGetLastError();
}

// Launches the register instance on clusters of `cluster` CTAs, one cluster a
// lane block. dsmem::launch_cluster would set the shared-memory attribute on
// every call; the decode calls this 1,024 times a batch from a host-bound
// loop, so the attribute is set only where the launch needs more than the
// default 48 KiB (never at hd <= 16).
template <typename T, int HD_MAX, int LPT>
int launch(const void* k, const void* v, const void* q, void* out, int hd, int g, int n_rows,
           int cluster, int warps, int smem, cudaStream_t stream) {
  auto kernel = hd == HD_MAX ? flash_decode_kernel<T, HD_MAX, LPT, true>
                             : flash_decode_kernel<T, HD_MAX, LPT, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (g + LANES * LPT - 1) / (LANES * LPT);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks * cluster, 1, 1);
  config.blockDim = dim3(LANES * warps, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(k),
                                             static_cast<const T*>(v), static_cast<const float*>(q),
                                             static_cast<float*>(out), hd, g, n_rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename T>
int dispatch(const void* k, const void* v, const void* q, void* out, int hd, int g, int n_rows,
             int lanes, int cluster, int warps, int smem, cudaStream_t stream) {
  if (hd > 64) {
    if (lanes != 1 || cluster != 1 || warps < 1 || warps > WIDE_SPLITS || warps > n_rows ||
        (size_t)smem != wide_smem_bytes(hd, warps) || (size_t)smem > dsmem::MAX_SMEM)
      return (int)cudaErrorInvalidValue;
    return launch_wide<T>(k, v, q, out, hd, g, n_rows, warps, smem, stream);
  }
  if ((lanes != 1 && lanes != 2) || cluster < 1 || cluster > dsmem::MAX_CLUSTER ||
      cluster > n_rows || warps < 1 || warps > MAX_WARPS ||
      (size_t)smem < smem_bytes(hd, warps, lanes) || (size_t)smem > dsmem::MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (lanes == 2) {
    if (hd > 16 || g % 2 || !aligned(k, 2 * sizeof(T)) || !aligned(v, 2 * sizeof(T)) ||
        !aligned(q, 2 * sizeof(float)))
      return (int)cudaErrorInvalidValue;
    return launch<T, 16, 2>(k, v, q, out, hd, g, n_rows, cluster, warps, smem, stream);
  }
  if (hd <= 16) return launch<T, 16, 1>(k, v, q, out, hd, g, n_rows, cluster, warps, smem, stream);
  if (hd <= 32) return launch<T, 32, 1>(k, v, q, out, hd, g, n_rows, cluster, warps, smem, stream);
  return launch<T, 64, 1>(k, v, q, out, hd, g, n_rows, cluster, warps, smem, stream);
}

}  // namespace

extern "C" {

// Largest head dim the kernels take (the wrapper refuses more).
int flash_decode_max_hd() { return 256; }

// k, v: (S, hd, G) f32 (dtype 0), bf16 (dtype 1) or f16 (dtype 2); q: (hd, G) f32;
// out: (hd, G) f32. Reads rows [0, n_rows), 1 <= n_rows <= S. The launch
// comes from hopper_attention.flash_decode_launch_geometry: lanes a thread
// (1, or 2 where hd <= 16, G is even and the pointers are aligned to a
// pair), CTAs a cluster (1 to 8, at most n_rows), warps a CTA (1 to 8; the
// wide instance, hd > 64: 1 to 4, at most n_rows, clusters of 1) and the
// dynamic shared memory in bytes. Returns cudaErrorInvalidValue for a
// geometry the kernels do not take, else the first nonzero cudaError_t of
// the launch (a refused cluster included), else 0.
int flash_decode(const void* k, const void* v, const void* q, void* out, int hd, int g,
                 int n_rows, int dtype, int lanes, int cluster, int warps, int smem,
                 void* stream) {
  if (hd < 1 || hd > 256 || g < 1 || n_rows < 1 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(k, v, q, out, hd, g, n_rows, lanes, cluster, warps, smem, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(k, v, q, out, hd, g, n_rows, lanes, cluster, warps, smem, s);
  return dispatch<__half>(k, v, q, out, hd, g, n_rows, lanes, cluster, warps, smem, s);
}

}  // extern "C"
