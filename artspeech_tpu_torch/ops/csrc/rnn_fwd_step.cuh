// The masked GRU and LSTM forward time loop on a thread-block cluster, the
// forward's counterpart of rnn_bwd_step.cuh. Shared by gru_fwd.cu
// (time-major GRU, one or two directions, f32, bf16 or f16), gru_seq.cu
// (batch-major GRU, one direction, f32) and lstm_fwd.cu (time-major LSTM,
// one or two directions, f32, bf16 or f16). Each file supplies a cell: its gate
// count G, where x_proj, the mask and the outputs of (t, b) live, which time
// step walk step s visits, and the elementwise step from the G sums of a
// (row, unit) to its new h. The step itself is here.
//
//   pre = h @ W_h + b_h                      (f32 accumulation, G*H columns)
//   GRU, G = 3, gates r, z, n:
//     r = sigmoid(x_r + pre_r),  z = sigmoid(x_z + pre_z)
//     n = tanh(x_n + r * pre_n)
//     h' = combine(m, (1 - z) * n + z * h, h)
//   LSTM, G = 4, gates i, f, g, o (lstm_fwd.cu):
//     i, f, o = sigmoid(pre + x),  g = tanh(pre_g + x_g)
//     c' = f * c + i * g,  h' = o * tanh(c');  h, c frozen where m == 0
//
// What bounds it: T dependent steps, each a small (rows, H) x (H, G*H)
// product and the gates. At the thesis and latent-RNN batches the card is
// nearly idle: the time is the latency of a step times T, not bytes or
// operations. So the design spreads one step over as many SMs as the batch
// allows and keeps every global-memory latency off the step's critical path.
//
// Geometry (chosen on the host by hopper_gru.gru_launch_geometry and passed
// in): a cluster of C CTAs (C <= 8) owns one direction and a tile of R = 2,
// 4 or 8 batch rows. CTA r of the cluster owns hidden units
// [r*U, (r+1)*U), U = H/C, and their G gate columns, so every gate of a
// unit is local. Its (H, G*U) slice of W_h stays in shared memory for all T
// steps.
//
// Threads. LANES = 8 consecutive threads own one unit for the R rows of the
// tile (8U threads a CTA): lane l sums k in the quads
// {l, l + 8, l + 16, ...} of h, for the unit's G columns and the R rows,
// reading h as float4 broadcasts and its W_h quads as 16-byte (8-byte in
// bf16 and f16) loads laid out so that a warp reads consecutive addresses. Three
// levels of __shfl_xor_sync over the 8 lanes sum them in a fixed order,
// halving the rows a lane holds while it holds more than one
// (reduce-scatter), so that each row's G sums end in the lane that applies
// its gates. No block barrier separates the product from the gates. A
// carry beyond h (the LSTM's cell state) lives in that lane's register:
// only h crosses the cluster.
//
// The carry. h lives in f32 in every CTA's shared memory, two (R, HP)
// buffers (HP = H rounded up to 32, the padding kept zero): step s reads
// buffer s & 1 and each CTA writes its units' new h into buffer (s + 1) & 1
// of every CTA of the cluster, through distributed shared memory. One split
// barrier a step, and it is the data's own: each buffer has an mbarrier in
// every CTA, the stores are st.async with complete_tx, so they arrive on the
// receiving CTA's mbarrier as they land, and a CTA waits (acquire, cluster
// scope) on its own mbarrier for the step's rows * H * 4 bytes before the
// next product; the output stores and the rotation of the prefetched inputs
// run between the arrive and the wait. A CTA posts each phase's byte count
// (arrive.expect_tx) after the phase before it completed. With two
// buffers no CTA overwrites h that a peer still reads: a CTA writes buffer
// s & 1 again only in step s + 1, after it received step s's h from every
// CTA, and every CTA stores its step-s h only after the reads of its step-s
// product and gates (its 8 lanes meet in the shuffles first). Rows past the
// batch are never written and never waited for.
//
// Inputs a step ahead. During step s a gate lane loads the G values of
// x_proj and the mask of step s + 1 for its (row, unit) into registers,
// before the product; the step never waits on a global load.
//
// Tensor cores are not used: at a few rows a cluster an m16 tile is mostly
// padding and the step is latency bound, and TF32 would break the f32 limit
// against the plain version over T steps.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dsmem.cuh"

namespace rnn_fwd {

namespace cg = cooperative_groups;

using dsmem::align16;
using dsmem::expect_bytes;
using dsmem::from_f32;
using dsmem::launch_cluster;
using dsmem::load4;
using dsmem::map_rank;
using dsmem::MAX_CLUSTER;
using dsmem::MAX_SMEM;
using dsmem::shared_addr;
using dsmem::sigmoid_f32;
using dsmem::store_arrive;
using dsmem::to_f32;
using dsmem::wait_phase;

constexpr int LANES = 8;          // threads that split k for one unit
constexpr int MAX_THREADS = 512;  // threads a CTA

// H rounded up to a whole number of quads for every lane.
__host__ __device__ inline int padded_hidden(int hidden) {
  return (hidden + 4 * LANES - 1) / (4 * LANES) * (4 * LANES);
}

// Shared memory of one CTA: its (HP, G*U) slice of W_h in the storage type,
// then two (rows, HP) f32 h buffers (HP = H rounded up to 32).
__host__ __device__ inline size_t smem_bytes(int hidden, int cluster, int rows, int gates,
                                             int elem_bytes) {
  const size_t hp = padded_hidden(hidden);
  return align16(hp * gates * (hidden / cluster) * elem_bytes) +
         2 * (size_t)rows * hp * sizeof(float);
}

// Whether a geometry is one the kernel takes; the launch refuses others.
inline bool valid_geometry(int hidden, int cluster, int rows, int smem, int gates,
                           int elem_bytes) {
  if (cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) || hidden % cluster)
    return false;
  if (rows != 2 && rows != 4 && rows != 8) return false;
  const size_t need = smem_bytes(hidden, cluster, rows, gates, elem_bytes);
  return LANES * (hidden / cluster) <= MAX_THREADS && smem >= 0 && (size_t)smem >= need &&
         (size_t)smem <= MAX_SMEM;
}

// Threads a CTA of the cluster step.
inline int cluster_threads(int hidden, int cluster) { return LANES * (hidden / cluster); }

// Time-major addressing of direction d: x_proj (T, B, D*G*H), W_h
// (H, G*H) and b_h (G*H) of the direction, mask (T, B) f32, ys (T, B, D*H).
// A reverse direction walks time backward and stores outputs at their own
// time index. The mask selects.
template <typename T, int G>
struct TimeMajor {
  const T* xp;
  const T* w;
  const T* b;
  const float* mask_;
  T* ys;
  int batch, hidden, n_dir, d;
  bool reverse;
  __device__ int time(int s, int n_steps) const { return reverse ? n_steps - 1 - s : s; }
  __device__ const T* x(int t, int bi) const {
    return xp + ((size_t)t * batch + bi) * n_dir * G * hidden + (size_t)d * G * hidden;
  }
  __device__ T* y(int t, int bi) const {
    return ys + ((size_t)t * batch + bi) * n_dir * hidden + (size_t)d * hidden;
  }
  __device__ float mask(int t, int bi) const { return mask_[(size_t)t * batch + bi]; }
  __device__ static float combine(float m, float cand, float h) { return m != 0.0f ? cand : h; }
};

// The GRU's cell on a layout (TimeMajor<T, 3>, or gru_seq.cu's batch-major
// one) whose combine(m, cand, h) is the mask formula.
template <typename T, typename Layout>
struct GruCell : Layout {
  static constexpr int G = 3;
  // The new h from the G sums s of h @ W_h, the biases bh, the values x of
  // x_proj, the mask m and the carry h before the step (the GRU has no
  // other carry). The candidate's fused product is written out: left to the
  // compiler, which of (1 - z) * n and z * h it fuses follows the code
  // around the step, and the carry's bits with it.
  __device__ T apply(const float* s, const float* bh, const float* x, float m, float h,
                     float&) const {
    const float r = sigmoid_f32(x[0] + (s[0] + bh[0]));
    const float z = sigmoid_f32(x[1] + (s[1] + bh[1]));
    const float n = tanhf(x[2] + r * (s[2] + bh[2]));
    return from_f32<T>(this->combine(m, fmaf(1.0f - z, n, z * h), h));
  }
  __device__ void store(int t, int bi, int u, T h, float) const { this->y(t, bi)[u] = h; }
};

// The time loop of one CTA. The cell supplies (for this CTA's direction):
//   G                          its gate count;
//   w, b                       its (H, G*H) W_h and (G*H) b_h;
//   time(s, n)                 the time index of walk step s;
//   x(t, b)                    a pointer to the G*H gates of x_proj;
//   mask(t, b)                 the mask value;
//   apply(s, bh, x, m, h, c)   the new h in the storage type from the G sums
//                              s (f32, in the order above), the G biases, the
//                              G values of x_proj, the mask and the carries
//                              before the step; it updates c, the carry
//                              beyond h (0 at the start), in place;
//   store(t, b, u, h, c)       the step's outputs of unit u of row b.
template <typename T, int R, typename Cell>
__device__ __forceinline__ void cluster_steps(const Cell& cell, int n_steps, int batch,
                                              int hidden) {
  constexpr int G = Cell::G;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int units = hidden / csize;
  const int hp = padded_hidden(hidden);
  const int quads = hp / (4 * LANES);  // quads of k a lane sums
  T* w_s = reinterpret_cast<T*>(smem);
  float* h_s = reinterpret_cast<float*>(smem + align16((size_t)hp * G * units * sizeof(T)));

  const int tid = threadIdx.x;
  const int lane = tid % LANES;
  const int j = tid / LANES;
  const int u = rank * units + j;  // the hidden unit this thread owns
  const int b0 = (blockIdx.x / csize) * R;

  // W_h slice: value (k, gate p, local unit jj) at
  // (((q * G + p) * units + jj) * LANES + l) * 4 + i, k = 4 * (l + LANES * q) + i,
  // zero for k >= H.
  for (int idx = tid; idx < hp * G * units; idx += blockDim.x) {
    const int i = idx & 3;
    int rest = idx >> 2;
    const int l = rest % LANES;
    rest /= LANES;
    const int jj = rest % units;
    rest /= units;
    const int p = rest % G;
    const int k = 4 * (l + LANES * (rest / G)) + i;
    w_s[idx] = k < hidden ? cell.w[(size_t)k * G * hidden + p * hidden + rank * units + jj]
                          : from_f32<T>(0.0f);
  }
  for (int idx = tid; idx < 2 * R * hp; idx += blockDim.x) h_s[idx] = 0.0f;
  float bias[G];
#pragma unroll
  for (int p = 0; p < G; ++p) bias[p] = to_f32(cell.b[p * hidden + u]);

  // The tile row whose gates this lane applies (see the reduction below):
  // lane l holds row l / (LANES / R), and the first lane of each LANES / R
  // applies its gates.
  const int spread = LANES / R;
  const int row = lane / spread;
  const int b = b0 + row;
  const bool live = lane % spread == 0 && b < batch;
  float x[G], m = 0.0f, c = 0.0f;
#pragma unroll
  for (int p = 0; p < G; ++p) x[p] = 0.0f;
  if (live && n_steps > 0) {
    const T* xt = cell.x(cell.time(0, n_steps), b);
#pragma unroll
    for (int p = 0; p < G; ++p) x[p] = to_f32(xt[p * hidden + u]);
    m = cell.mask(cell.time(0, n_steps), b);
  }
  // One mbarrier a buffer; phase k of buffer i's completes when step
  // 2k + 1 - i's h has landed: rows_live * H * 4 bytes from the cluster.
  __shared__ __align__(8) uint64_t bars[2];
  const uint32_t step_bytes = (uint32_t)(min(R, batch - b0) * hidden * sizeof(float));
  if (tid == 0) {
    dsmem::init_bars(bars, 2);
    for (int i = 0; i < 2; ++i) expect_bytes(shared_addr(&bars[i]), step_bytes);
  }
  // Every CTA's buffers and mbarriers are in place before any peer writes
  // into them.
  cluster.sync();

  const unsigned seg = 0xffu << ((tid & 31) & ~(LANES - 1));  // this thread's 8 lanes
  const size_t gate_stride = (size_t)units * LANES * 4;       // between gates p in w_s
  const T* w_lane = w_s + (size_t)(j * LANES + lane) * 4;

  for (int s = 0; s < n_steps; ++s) {
    const int t = cell.time(s, n_steps);
    // Inputs of the next step, loaded now and used one step later.
    float x1[G], m1 = 0.0f;
#pragma unroll
    for (int p = 0; p < G; ++p) x1[p] = 0.0f;
    if (live && s + 1 < n_steps) {
      const int t1 = cell.time(s + 1, n_steps);
      const T* xt = cell.x(t1, b);
#pragma unroll
      for (int p = 0; p < G; ++p) x1[p] = to_f32(xt[p * hidden + u]);
      m1 = cell.mask(t1, b);
    }
    const float* h_cur = h_s + (s & 1) * R * hp;
    float* h_nxt = h_s + ((s + 1) & 1) * R * hp;

    // This lane's share of h @ W_h for the unit's G columns and the R rows.
    float acc[G][R];
#pragma unroll
    for (int p = 0; p < G; ++p)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[p][r] = 0.0f;
    const float* h_lane = h_cur + 4 * lane;
#pragma unroll 2
    for (int q = 0; q < quads; ++q) {
      const T* wq = w_lane + (size_t)G * q * gate_stride;
      float4 wv[G];
#pragma unroll
      for (int p = 0; p < G; ++p) wv[p] = load4(wq + p * gate_stride);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(h_lane + r * hp + 4 * LANES * q);
#pragma unroll
        for (int p = 0; p < G; ++p) {
          acc[p][r] = fmaf(hv.x, wv[p].x, acc[p][r]);
          acc[p][r] = fmaf(hv.y, wv[p].y, acc[p][r]);
          acc[p][r] = fmaf(hv.z, wv[p].z, acc[p][r]);
          acc[p][r] = fmaf(hv.w, wv[p].w, acc[p][r]);
        }
      }
    }
    // Sum over the 8 lanes. While a lane holds more than one row, a level
    // halves them (reduce-scatter): the lane with bit `off` set keeps the
    // upper half, its partner the lower, each adding what the other sends.
    // The levels left sum the one row in both partners (a + b and b + a
    // round alike). Lane l ends with row l / (LANES / R).
    int held = R;
#pragma unroll
    for (int off = LANES / 2; off > 0; off /= 2) {
      if (held > 1) {
        const int half = held / 2;
        const bool upper = (lane & off) != 0;
#pragma unroll
        for (int i = 0; i < R / 2; ++i) {
          if (i < half) {
#pragma unroll
            for (int p = 0; p < G; ++p) {
              const float give = upper ? acc[p][i] : acc[p][i + half];
              const float keep = upper ? acc[p][i + half] : acc[p][i];
              acc[p][i] = keep + __shfl_xor_sync(seg, give, off);
            }
          }
        }
        held = half;
      } else {
#pragma unroll
        for (int p = 0; p < G; ++p) acc[p][0] += __shfl_xor_sync(seg, acc[p][0], off);
      }
    }

    T out = from_f32<T>(0.0f);
    if (live) {
      float sums[G];
#pragma unroll
      for (int p = 0; p < G; ++p) sums[p] = acc[p][0];
      out = cell.apply(sums, bias, x, m, h_cur[row * hp + u], c);
      const float h_new = to_f32(out);
      const uint32_t dst = shared_addr(h_nxt + row * hp + u);
      const uint32_t bar = shared_addr(&bars[(s + 1) & 1]);
      for (int k = 0; k < csize; ++k) store_arrive(map_rank(dst, k), h_new, map_rank(bar, k));
    }
    if (live) cell.store(t, b, u, out, c);
#pragma unroll
    for (int p = 0; p < G; ++p) x[p] = x1[p];
    m = m1;
    // Step s's h has landed in buffer (s + 1) & 1 (phase s / 2 of its
    // mbarrier); then post that mbarrier's next phase, step s + 2.
    const uint32_t bar = shared_addr(&bars[(s + 1) & 1]);
    wait_phase(bar, (s >> 1) & 1);
    if (tid == 0) expect_bytes(bar, step_bytes);
  }
  // No CTA exits while a peer may still store into it.
  cluster.sync();
}

}  // namespace rnn_fwd
