// The masked GRU and LSTM backward time loop on a thread-block cluster,
// shared by gru_bwd.cu (G = 3 gates) and lstm_bwd.cu (G = 4). Each file
// supplies its cell: the values of a step that do not depend on the carry
// (`values`, from the recomputed gate pre-activations) and the step's
// elementwise backward given the carry (`step`). The step itself is here.
//
// What bounds it: T dependent steps, each a small (rows, G*H) x (G*H, H)
// product (dh = dgates_c @ W_h^T) behind an elementwise cell backward. At
// the thesis batches the card is nearly idle: the time is the latency of a
// step times T, so the design keeps the serial chain as short as it can
// and spreads it over as many SMs as the batch allows.
//
// Geometry (chosen on the host by hopper_gru.rnn_bwd_launch_geometry and
// passed in): a cluster of C CTAs (C <= 8) owns one direction and a tile of
// R = 2, 4 or 8 batch rows. CTA r of the cluster owns hidden units
// [r*U, (r+1)*U), U = H/C, and their G gate columns, unit-major (local
// column j*G + p is global column p*H + r*U + j), so every gate of a unit
// is local; its (H, G*U) slice of W_h stays in shared memory. A CTA has
// 256 threads of at most 128 registers, so two CTAs share an SM where
// their shared memory fits (at B = 16, 16 clusters of 8 then all fit).
//
// The recompute, off the serial chain. The gate pre-activations
// h_prev @ W_h + b_h of every step come from ys alone (h_prev is ys one
// walk step earlier), never from the carry. So a prologue computes them
// for all T steps of the CTA's rows and columns as a register-tiled
// product (PRO_ROWS (step, row) pairs staged as h_prev^T at a time; 4 pairs
// x 4 units x G gates a tile, k split over PRO_SPLIT threads and summed by
// a shuffle butterfly) and hands each unit's sums to the cell, which writes
// the V values of each (step, row, unit) that the loop needs (the gate
// activations and what the backward takes of them without the carry; for
// the LSTM c_prev and tanh(c')) into an f32 scratch the wrapper allocates.
// The loop reads them a step ahead.
//
// The loop, one walk step s at a time in reverse traversal order:
//   1. the cell threads (one a (row, unit)) wait for the step's partial dh
//      products, add the C partials in CTA order to their local carry, run
//      the cell backward, write dx_proj, keep db_h in registers, write the
//      rounded dgates_c into shared memory and into the scratch (over the
//      step's consumed values) for the epilogue;
//   2. one block barrier;
//   3. the dh product, reduce-scattered over the cluster: thread k sums
//      this CTA's G*U columns of dgates_c[r] * W_h[k] for the R rows,
//      reading W_h's quads (laid out so that a warp reads consecutive
//      addresses) and dgates_c's as broadcasts, and sends row r's sum to the
//      CTA that owns unit k, into that CTA's slot for this source CTA, by
//      st.async completing on the receiver's mbarrier. A CTA receives
//      rows * H * 4 bytes a step (its U units from each of the C CTAs) and
//      adds them in CTA order: deterministic. This moves G times fewer
//      bytes than gathering dgates and keeps one W_h slice a CTA.
// Nothing on the chain reads device memory: the cell's inputs (its V
// values, g and the mask) are loaded a step ahead. Two carry buffers and
// two dgates_c buffers, as the forward's two h buffers: a CTA writes buffer
// (i + 1) & 1 of a peer in loop step i only after it received every CTA's
// step i - 1 sends, which each CTA makes after its own reads of that buffer
// in step i - 1 (the block barrier orders them); and a dgates_c buffer is
// written again two steps later, after every thread passed the barrier of
// the step between. The LSTM's dc stays in its cell thread's register.
//
// dW_h and db_h. After the loop each CTA computes its columns' partial
// dW_h = sum over its tile's T*R (step, row) pairs of h_prev^T dgates_c in
// f32 FMAs (8 x 8 outputs a thread, EPI_ROWS pairs staged at a time); db_h
// sums the f32 dgates over the steps in each cell thread and then over the
// rows in order. A second kernel sums the per-tile partials in tile order,
// so the result is the same on every run.
//
// Stages fill a row at a time, a thread a column, with IN_FLIGHT loads of
// a thread issued before any is used: one conditional load at a time, or
// an index division an element, cost more than the products they feed.
//
// Tensor cores are not used: at a few rows a cluster an m16 tile is mostly
// padding, the step is latency bound, and TF32 would break the f32 limits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dsmem.cuh"

namespace rnn_bwd {

namespace cg = cooperative_groups;

using dsmem::align16;
using dsmem::expect_bytes;
using dsmem::from_f32;
using dsmem::load4;
using dsmem::map_rank;
using dsmem::shared_addr;
using dsmem::store_arrive;
using dsmem::to_f32;
using dsmem::wait_phase;

constexpr int THREADS = 256;  // threads a CTA (two CTAs an SM where their shared memory fits)
constexpr int PRO_ROWS = 64;      // (step, row) pairs a prologue chunk stages
constexpr int PRO_SPLIT = 4;      // threads that split k for one prologue tile
constexpr int EPI_ROWS = 32;      // (step, row) pairs an epilogue chunk stages
constexpr int IN_FLIGHT = 8;      // global loads a thread keeps in flight while staging

// A CTA's U units rounded up to groups of 4 (a prologue thread's units).
__host__ __device__ inline int unit_groups(int units) { return (units + 3) / 4; }

// A CTA's columns, unit-major (local column j * G + p is gate p of unit j),
// over whole groups of 4 units and rounded up to 8 (the epilogue's
// 8-column tiles).
__host__ __device__ inline int padded_cols(int gates, int units) {
  return (4 * unit_groups(units) * gates + 7) / 8 * 8;
}

// H rounded up to 8 (rows of the W_h slice, the staged h and the
// epilogue's 8-row tiles).
__host__ __device__ inline int padded_k(int hidden) { return (hidden + 7) / 8 * 8; }

// f32 values of the stage: the prologue's (HK, PRO_ROWS + 4) h_prev^T or
// the epilogue's (EPI_ROWS, HK + 4) h_prev and (EPI_ROWS, cols) dgates_c.
__host__ __device__ inline size_t stage_floats(int hidden, int cols) {
  const size_t hk = padded_k(hidden);
  const size_t pro = hk * (PRO_ROWS + 4);
  const size_t epi = (size_t)EPI_ROWS * (hk + 4 + cols);
  return pro > epi ? pro : epi;
}

// Shared memory of one CTA: its (HK, cols) W_h slice in the storage type,
// then in f32 two (C, rows, U) carry buffers, two (rows, cols) dgates_c
// buffers and the stage.
__host__ __device__ inline size_t smem_bytes(int hidden, int cluster, int rows, int gates,
                                             int elem_bytes) {
  const int cols = padded_cols(gates, hidden / cluster);
  return align16((size_t)padded_k(hidden) * cols * elem_bytes) +
         sizeof(float) * (2 * (size_t)rows * hidden + 2 * (size_t)rows * cols +
                          stage_floats(hidden, cols));
}

// Whether a geometry is one the kernel takes; the launch refuses others.
inline bool valid_geometry(int hidden, int cluster, int rows, int smem, int gates,
                           int elem_bytes) {
  if (cluster < 1 || cluster > dsmem::MAX_CLUSTER || (cluster & (cluster - 1)) ||
      hidden % cluster)
    return false;
  if (rows != 2 && rows != 4 && rows != 8) return false;
  if (hidden > THREADS || rows * (hidden / cluster) > THREADS) return false;
  const size_t need = smem_bytes(hidden, cluster, rows, gates, elem_bytes);
  return smem >= 0 && (size_t)smem >= need && (size_t)smem <= dsmem::MAX_SMEM;
}

// store(mm, c, *src(mm, c) as f32, or 0 where src is null) for every row
// mm < rows and column c < width: a thread keeps its columns and walks the
// rows, issuing IN_FLIGHT loads (from `fallback` where src is null) before
// it uses any, so a stage costs neither a device-memory latency nor an
// index division an element.
template <typename E, typename Src, typename Store>
__device__ __forceinline__ void stage_rows(int rows, int width, int tid, int nt,
                                           const E* fallback, Src src, Store store) {
  const int lanes = min(width, nt);  // threads a row
  const int row_lanes = nt / lanes;  // rows at once
  const int r_first = tid / lanes;
  if (r_first >= row_lanes) return;
  for (int c = tid - r_first * lanes; c < width; c += lanes) {
    for (int mm0 = r_first; mm0 < rows; mm0 += IN_FLIGHT * row_lanes) {
      E raw[IN_FLIGHT];
      bool ok[IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int mm = mm0 + u * row_lanes;
        const E* ptr = mm < rows ? src(mm, c) : nullptr;
        ok[u] = ptr != nullptr;
        raw[u] = *(ok[u] ? ptr : fallback);
      }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int mm = mm0 + u * row_lanes;
        if (mm < rows) store(mm, c, ok[u] ? to_f32(raw[u]) : 0.0f);
      }
    }
  }
}

// What both cells see: (T, B, D*G*H) x_proj and dx_proj, (D, H, G*H) W_h,
// (D, G*H) b_h, (T, B) f32 mask, (T, B, D*H) ys and g; the f32 scratch, a
// (T, rows, V, U) slice per CTA; the per-tile partials dw_part
// (D, tiles, H, G*H) and db_part (D, tiles, G*H).
template <typename T>
struct Problem {
  const T* xp;
  const T* wh;
  const T* bh;
  const float* mask;
  const T* ys;
  const T* gy;
  T* dxp;
  float* scratch;
  float* dw_part;
  float* db_part;
  int n_steps, batch, hidden, n_dir, rev_bits;
};

// The backward of one CTA. Cell supplies G, V, NI and
//   load(t, t_prev, b, u, in)           the NI inputs of unit u of row b at
//       time t that values() reads from device memory, as stored (t_prev:
//       the time of the walk step before; any valid time at the first);
//   values(pre, h, in, first, v)        the V values from the G
//       pre-activations pre (h_prev @ W_h + b_h), the unit's h_prev h and
//       those inputs (first: the first walk step, whose carries are zero);
//   step(v, m, dh_tot, dc, dx, dhg)     the cell backward: dx_proj's G
//       values and the f32 gradient dhg of h_prev @ W_h + b_h; returns the
//       carry without the product, and updates the LSTM's dc.
template <typename T, int R, typename Cell>
__device__ __forceinline__ void cluster_backward(const Problem<T>& pb, const Cell& cell) {
  constexpr int G = Cell::G;
  constexpr int V = Cell::V;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int hidden = pb.hidden;
  const int units = hidden / csize;
  const int groups = unit_groups(units);
  const int cols = padded_cols(G, units);
  const int hk = padded_k(hidden);
  const int n = pb.n_steps;
  const int batch = pb.batch;
  const int d = blockIdx.y;
  const int tile = blockIdx.x / csize;
  const int tiles = gridDim.x / csize;
  const int b0 = tile * R;
  const bool reverse = ((pb.rev_bits >> d) & 1) != 0;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t gh = (size_t)G * hidden;
  const size_t x_row = (size_t)pb.n_dir * gh;
  const size_t y_row = (size_t)pb.n_dir * hidden;
  const int vu = V * units;  // scratch values a (step, row)

  T* w_s = reinterpret_cast<T*>(smem);
  float* part_s = reinterpret_cast<float*>(smem + align16((size_t)hk * cols * sizeof(T)));
  float* dg_s = part_s + 2 * R * hidden;  // (2, R, cols)
  float* stage = dg_s + 2 * R * cols;
  float* scr = pb.scratch + ((size_t)(d * tiles + tile) * csize + rank) * n * R * vu;

  auto time_of = [&](int s) { return reverse ? n - 1 - s : s; };
  // Local column jl = j * G + p (unit j, gate p) -> global column p * H + rank * U + j.
  auto global_col = [&](int jl) {
    const int j = jl / G;
    return (jl - j * G) * hidden + rank * units + j;
  };
  // Where h_prev of (step, row) pair m at unit k is in ys; null where it
  // is zero (walk step 0, past the batch, past H).
  auto h_prev = [&](int m, int k) -> const T* {
    const int s = m / R;
    const int b = b0 + m - s * R;
    if (s == 0 || b >= batch || k >= hidden) return nullptr;
    return pb.ys + ((size_t)time_of(s - 1) * batch + b) * y_row + (size_t)d * hidden + k;
  };

  // W_h slice: value (k, local column jl = 4 * q + i) at (q * HK + k) * 4 + i,
  // zero for k >= H and past the units: a quad of a row is 16 bytes (8 in
  // bf16 and f16), and the quads q of consecutive k are consecutive.
  const T* w_d = pb.wh + (size_t)d * hidden * gh;
  for (int idx = tid; idx < hk * cols; idx += nt) {
    const int i = idx & 3;
    const int k = (idx >> 2) % hk;
    const int jl = 4 * ((idx >> 2) / hk) + i;
    w_s[idx] = k < hidden && jl < G * units ? w_d[(size_t)k * gh + global_col(jl)]
                                            : from_f32<T>(0.0f);
  }
  for (int idx = tid; idx < 2 * R * cols; idx += nt) dg_s[idx] = 0.0f;

  // Prologue: PRO_ROWS (step, row) pairs at a time, h_prev^T staged. A
  // tile of 4 pairs x 4 units x G gates of pre-activations is a register
  // tile of PRO_SPLIT threads, each summing every PRO_SPLIT-th k (4 h
  // values and G W quads a k for 16 G FMAs); a shuffle butterfly gives all
  // of them the sums, and each runs the cell's values() for one unit of
  // the tile into the scratch.
  const int n_rows = n * R;
  const int ps = PRO_ROWS + 4;  // row stride of h_prev^T
  const int split = tid % PRO_SPLIT;
  const unsigned split_mask = 0xfu << ((tid & 31) & ~(PRO_SPLIT - 1));
  for (int m0 = 0; m0 < n_rows; m0 += PRO_ROWS) {
    __syncthreads();  // W_h is in place; the last chunk's stage is read
    stage_rows(
        PRO_ROWS, hk, tid, nt, pb.ys,
        [&](int mm, int k) { return m0 + mm < n_rows ? h_prev(m0 + mm, k) : nullptr; },
        [&](int mm, int k, float v) { stage[k * ps + mm] = v; });
    __syncthreads();
    for (int item = tid; item < (PRO_ROWS / 4) * groups * PRO_SPLIT; item += nt) {
      const int mq = item / PRO_SPLIT / groups;
      const int ug = item / PRO_SPLIT - mq * groups;
      if (m0 + 4 * mq >= n_rows) continue;  // the tile's PRO_SPLIT threads alike
      float acc[4][4 * G];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4 * G; ++c) acc[a][c] = 0.0f;
      const float* hcol = stage + 4 * mq;
      for (int k = split; k < hk; k += PRO_SPLIT) {
        const float4 h4 = *reinterpret_cast<const float4*>(hcol + k * ps);
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int c = 0; c < G; ++c) {
          const float4 w = load4(w_s + ((size_t)(ug * G + c) * hk + k) * 4);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc[a][4 * c + 0] = fmaf(hv[a], w.x, acc[a][4 * c + 0]);
            acc[a][4 * c + 1] = fmaf(hv[a], w.y, acc[a][4 * c + 1]);
            acc[a][4 * c + 2] = fmaf(hv[a], w.z, acc[a][4 * c + 2]);
            acc[a][4 * c + 3] = fmaf(hv[a], w.w, acc[a][4 * c + 3]);
          }
        }
      }
      // (a + b) + (c + d) in every thread of the tile: the same bits.
#pragma unroll
      for (int off = 1; off < PRO_SPLIT; off *= 2)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4 * G; ++c)
            acc[a][c] += __shfl_xor_sync(split_mask, acc[a][c], off);
      // This thread's unit of the tile (its sums picked by selects, not
      // branches): its inputs of the 4 pairs (at a valid place where a
      // pair is past the rows or the batch) and its biases, all loaded
      // before any is used or any scratch is written.
      const int j = 4 * ug + split;
      const int u = rank * units + min(j, units - 1);
      T in[4][Cell::NI], bias[G];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int m = min(m0 + 4 * mq + a, n_rows - 1);
        const int s = m / R;
        const int b = min(b0 + m - s * R, batch - 1);
        cell.load(time_of(s), time_of(s > 0 ? s - 1 : s), b, u, in[a]);
      }
#pragma unroll
      for (int p = 0; p < G; ++p) bias[p] = pb.bh[(size_t)d * gh + p * hidden + u];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int m = m0 + 4 * mq + a;
        const int s = m / R;
        if (j >= units || m >= n_rows || b0 + m - s * R >= batch) continue;
        float pre[G];
#pragma unroll
        for (int p = 0; p < G; ++p) {
          const float* t = acc[a];
          const float sum = split == 0 ? t[p] : split == 1 ? t[G + p]
                          : split == 2 ? t[2 * G + p] : t[3 * G + p];
          pre[p] = sum + to_f32(bias[p]);
        }
        float v[V];
        cell.values(pre, hcol[u * ps + a], in[a], s == 0, v);
        float* dst = scr + (size_t)m * vu + j;
#pragma unroll
        for (int q = 0; q < V; ++q) dst[q * units] = v[q];
      }
    }
  }

  // One mbarrier a carry buffer; phase k of buffer i's completes when the
  // partials of loop step 2k + 1 - i have landed: rows_live * H * 4 bytes.
  __shared__ __align__(8) uint64_t bars[2];
  const uint32_t step_bytes = (uint32_t)(min(R, batch - b0) * hidden * sizeof(float));
  if (tid == 0) {
    dsmem::init_bars(bars, 2);
    for (int i = 0; i < 2; ++i) expect_bytes(shared_addr(&bars[i]), step_bytes);
  }
  __syncthreads();  // the prologue's scratch is written
  // Every CTA's buffers and mbarriers are in place before any peer writes
  // into them.
  cluster.sync();

  // The cell thread of (row re, unit je), if any, and its addresses at loop
  // step 0 (walk step n - 1); each loop step moves them by one time step.
  const bool cell_thread = tid < R * units;
  const int re = tid / units;
  const int je = tid - re * units;
  const int be = b0 + re;
  const int ue = rank * units + je;
  const bool live = cell_thread && be < batch;
  const int t_last = time_of(n - 1);
  const long t_dir = reverse ? 1 : -1;  // time step between consecutive loop steps
  const size_t row0 = (size_t)t_last * batch + be;
  const T* g_p = pb.gy + row0 * y_row + (size_t)d * hidden + ue;
  const float* m_p = pb.mask + row0;
  T* dx_p = pb.dxp + row0 * x_row + (size_t)d * gh + ue;
  float* sc_p = scr + ((size_t)(n - 1) * R + re) * vu + je;
  const long g_step = t_dir * batch * (long)y_row;
  const long x_step = t_dir * batch * (long)x_row;
  const long m_step = t_dir * batch;
  const long sc_step = -(long)R * vu;
  float dh = 0.0f, dc = 0.0f;
  float db[G];
#pragma unroll
  for (int p = 0; p < G; ++p) db[p] = 0.0f;
  // Its inputs of the current loop step as loaded (converted where used, a
  // loop step after their loads): the V values, g and the mask.
  float v[V], m_in = 0.0f;
  T g_in = from_f32<T>(0.0f);
  if (live) {
#pragma unroll
    for (int q = 0; q < V; ++q) v[q] = sc_p[q * units];
    g_in = *g_p;
    m_in = *m_p;
  }

  // The product's thread of k = tid, if any, and the addresses it sends
  // its R sums to: unit k's owner, in that CTA's slot for this one.
  const bool k_thread = tid < hidden;
  const int k_own = min(tid, hidden - 1);
  const int owner = k_own / units;
  uint32_t dst_addr[2], dst_bar[2];  // by carry buffer
#pragma unroll
  for (int buf = 0; buf < 2; ++buf) {
    const float* dst = part_s + (buf * csize + rank) * R * units + k_own - owner * units;
    dst_addr[buf] = map_rank(shared_addr(dst), owner);
    dst_bar[buf] = map_rank(shared_addr(&bars[buf]), owner);
  }
  const int quads = cols / 4;

  for (int i = 0; i < n; ++i) {
    float vn[V], m_nxt = 0.0f;
    T g_nxt = from_f32<T>(0.0f);
    if (live && i + 1 < n) {
#pragma unroll
      for (int q = 0; q < V; ++q) vn[q] = sc_p[sc_step + q * units];
      g_nxt = g_p[g_step];
      m_nxt = m_p[m_step];
    }
    float* dgb = dg_s + (i & 1) * R * cols;
    if (live) {
      float carry = dh;
      if (i > 0) {
        // Loop step i - 1's partials have landed in buffer i & 1 (phase
        // (i - 1) / 2 of its mbarrier); then post that mbarrier's next phase.
        const uint32_t bar = shared_addr(&bars[i & 1]);
        wait_phase(bar, ((i - 1) >> 1) & 1);
        if (tid == 0) expect_bytes(bar, step_bytes);
        const float* pr = part_s + (i & 1) * R * hidden + re * units + je;
        float sum = pr[0];
        for (int c = 1; c < csize; ++c) sum += pr[c * R * units];
        carry = dh + sum;
      }
      float dx[G], dhg[G];
      dh = cell.step(v, m_in != 0.0f ? 1.0f : 0.0f, to_f32(g_in) + carry, dc, dx, dhg);
#pragma unroll
      for (int p = 0; p < G; ++p) {
        const float rounded = to_f32(from_f32<T>(dhg[p]));
        dgb[re * cols + je * G + p] = rounded;
        dx_p[p * hidden] = from_f32<T>(dx[p]);
        sc_p[p * units] = rounded;
        db[p] += dhg[p];
      }
    }
    __syncthreads();
    if (i + 1 < n && k_thread) {
      // Row r's sum over this CTA's columns of dgates_c[r] * W_h[k] (the
      // dgates quads are broadcasts: every thread reads the same one).
      const int buf = (i + 1) & 1;
      const T* wk = w_s + (size_t)tid * 4;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int q = 0; q < quads; ++q) {
        const float4 w = load4(wk + (size_t)q * hk * 4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 g = *reinterpret_cast<const float4*>(dgb + r * cols + 4 * q);
          acc[r] = fmaf(g.x, w.x, acc[r]);
          acc[r] = fmaf(g.y, w.y, acc[r]);
          acc[r] = fmaf(g.z, w.z, acc[r]);
          acc[r] = fmaf(g.w, w.w, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (b0 + r < batch)
          store_arrive(dst_addr[buf] + r * units * sizeof(float), acc[r], dst_bar[buf]);
    }
    if (live && i + 1 < n) {
#pragma unroll
      for (int q = 0; q < V; ++q) v[q] = vn[q];
      g_in = g_nxt;
      m_in = m_nxt;
      g_p += g_step;
      m_p += m_step;
      dx_p += x_step;
      sc_p += sc_step;
    }
  }

  // db_h: each cell thread's sums over the steps, then over the rows in
  // order, into this tile's partial.
  float* db_st = stage;  // (R, cols)
  __syncthreads();
  if (cell_thread) {
#pragma unroll
    for (int p = 0; p < G; ++p) db_st[re * cols + je * G + p] = live ? db[p] : 0.0f;
  }
  __syncthreads();
  float* db_out = pb.db_part + ((size_t)d * tiles + tile) * gh;
  for (int jl = tid; jl < G * units; jl += nt) {
    float acc = 0.0f;
    for (int r = 0; r < R; ++r) acc += db_st[r * cols + jl];
    db_out[global_col(jl)] = acc;
  }

  // dW_h: this CTA's columns of the tile's partial as 8 x 8 register tiles
  // (8 k, 8 columns), EPI_ROWS (step, row) pairs staged at once: h_prev
  // (EPI_ROWS, HK + 4) and dgates_c (EPI_ROWS, cols) from the scratch.
  const int es = hk + 4;
  float* h_st = stage;
  float* g_st = stage + EPI_ROWS * es;
  const int col_tiles = cols / 8;
  const int n_tiles = (hk / 8) * col_tiles;
  float* dw_out = pb.dw_part + ((size_t)d * tiles + tile) * hidden * gh;
  for (int base = 0; base < n_tiles; base += nt) {
    const int item = base + tid;
    const int kq = item / col_tiles;
    const int cq = item - kq * col_tiles;
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] = 0.0f;
    for (int m0 = 0; m0 < n_rows; m0 += EPI_ROWS) {
      const int rows = min(EPI_ROWS, n_rows - m0);
      __syncthreads();  // db_st and the last chunk's stage are read
      stage_rows(
          rows, hk, tid, nt, pb.ys, [&](int mm, int k) { return h_prev(m0 + mm, k); },
          [&](int mm, int k, float v) { h_st[mm * es + k] = v; });
      stage_rows(
          rows, cols, tid, nt, static_cast<const float*>(scr),
          [&](int mm, int jl) -> const float* {
            const int m = m0 + mm;
            const int j = jl / G;
            if (j >= units || b0 + m % R >= batch) return nullptr;
            return scr + (size_t)m * vu + (jl - j * G) * units + j;
          },
          [&](int mm, int jl, float v) { g_st[mm * cols + jl] = v; });
      __syncthreads();
      if (item < n_tiles) {
        for (int mm = 0; mm < rows; ++mm) {
          const float4 h0 = *reinterpret_cast<const float4*>(h_st + mm * es + 8 * kq);
          const float4 h1 = *reinterpret_cast<const float4*>(h_st + mm * es + 8 * kq + 4);
          const float4 g0 = *reinterpret_cast<const float4*>(g_st + mm * cols + 8 * cq);
          const float4 g1 = *reinterpret_cast<const float4*>(g_st + mm * cols + 8 * cq + 4);
          const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
          const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(hv[a], gv[c], acc[a][c]);
        }
      }
    }
    if (item < n_tiles) {
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int k = 8 * kq + a;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int jl = 8 * cq + c;
          if (k < hidden && jl < G * units) dw_out[(size_t)k * gh + global_col(jl)] = acc[a][c];
        }
      }
    }
  }
  // No CTA exits while a peer may still store into it.
  cluster.sync();
}

// out[d][i] = sum over tiles, in tile order, of part[d][tile][i].
__global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
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

// dw and db from their per-tile partials; the first nonzero cudaError_t,
// else 0.
inline int launch_sums(const float* dw_part, const float* db_part, float* dw, float* db,
                       int n_tiles, int hidden, int gates, int n_dir, cudaStream_t stream) {
  const int threads = 256;
  const int widths[2] = {hidden * gates * hidden, gates * hidden};
  const float* parts[2] = {dw_part, db_part};
  float* outs[2] = {dw, db};
  for (int i = 0; i < 2; ++i) {
    long blocks = ((long)n_dir * widths[i] + threads - 1) / threads;
    if (blocks > 4096) blocks = 4096;
    sum_partials_kernel<<<(int)blocks, threads, 0, stream>>>(parts[i], outs[i], n_tiles,
                                                             widths[i], n_dir);
    const int code = (int)cudaGetLastError();
    if (code != 0) return code;
  }
  return 0;
}

}  // namespace rnn_bwd
