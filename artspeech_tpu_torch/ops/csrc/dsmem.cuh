// Helpers shared by the recurrences' thread-block-cluster steps: the GRU
// forward step (gru_step.cuh) and the GRU and LSTM backward step
// (rnn_bwd_step.cuh). Storage-type conversions (f32, bf16 and f16), 16-byte
// loads, the distributed-shared-memory stores that complete on the
// receiver's transaction mbarrier, the waits on those mbarriers, and the
// launch of a kernel on clusters of a size chosen at run time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dsmem {

constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory one Hopper block may use

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as jnp astype
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);  // round to nearest even, as jnp astype
}

__device__ __forceinline__ float sigmoid_f32(float v) { return 1.0f / (1.0f + expf(-v)); }

// Four consecutive values as f32 (16 bytes of f32, 8 of bf16 or f16; aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared::cluster address of `local` (a shared::cta address) in CTA `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// Stores v at `addr` of a CTA of the cluster; the 4 bytes complete on that
// CTA's mbarrier `bar` (both shared::cluster addresses).
__device__ __forceinline__ void store_arrive(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// Initialises the mbarriers bars[0..n) with one arrival each (one thread).
__device__ __forceinline__ void init_bars(uint64_t* bars, int n) {
  for (int i = 0; i < n; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(shared_addr(&bars[i])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The arrival of a phase that completes when `bytes` more bytes have landed.
__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` of mbarrier `bar` has completed.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Launches kernel on clusters of `cluster` CTAs: grid (cluster * tiles,
// n_dir), `threads` a CTA, `smem` bytes of dynamic shared memory. Returns the
// first nonzero cudaError_t (a refused cluster included), else 0.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int cluster, int tiles, int n_dir, int threads,
                   int smem, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster * tiles, n_dir, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace dsmem
