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
// and 0.034 ms). The backward needs 10 hd operations per pair (the score,
// dP, dV, dQ and dK products: 5 hd FMAs) and one exp, so it leans to
// operations: 0.085 ms at G = 4,320 against 0.076 ms for its 254 MB. Neither
// uses the tensor cores: hd = 16 and f32 limits of 1e-5 that TF32 breaks.
//
// The forward (train_attention_fwd_kernel) walks each group's causal
// triangle in query strips, like the backward. Its first port gave a thread
// a query row: keys 0..q one after another (dot, compare, rescale, exp, axpy
// on one row: a serial chain), the warps of a CTA walking 32, 64, 96 and 128
// keys at L = 128 (62.5 % of the warp slots busy), and each warp load of
// keep[r][j] touching 32 rows 4 L bytes apart (32 sectors for 128 useful
// bytes). Now a CTA takes 1-4 groups of one pair in step; warps take 8-row
// blocks of a strip, a lane 2 rows x 4 keys of each 32-key chunk (8
// independent pairs, 8 FMAs a float4 of k or v read from shared memory),
// and with strips of 8, 16 or 32 rows every warp of a strip walks the same
// chunks, so no warp waits at the strip's barrier for another's keys. The
// keep rows of a strip are copied once into shared memory for all of the
// CTA's groups and read along keys. Each lane keeps an online softmax of
// its own keys, a chunk at a time; the 8 key lanes of a row merge once, by
// shuffles in a fixed order, and write out and lse as contiguous rows. K, V,
// q and keep come in by cp.async, the next strip's while this one is walked.
//
// What holds the forward on this card: latency at 16 warps an SM (4 CTAs of
// 4 warps under the 128-register cap), not bytes or one pipe. A 32-key chunk
// costs a warp 264 FFMA (256 for the products, 8 for the exponents) among a
// few hundred instructions, and 136 shared-memory wavefronts (32 LDS.128 and
// 8 LDS.32: each float4 of k or v serves 8 FMAs). In uncommitted probes on
// the H100, CTAs of 256 threads with strips of 32 rows, passes of 2 or 4
// chunks (the latter spilling at the cap), q kept in registers, no register
// cap (1-2 CTAs an SM) and an 80-register cap (3 CTAs, spilling) all ran
// slower, as did keep read through L1 instead of staged, strips of 8 rows
// and a second walk_chunk path for diagonal chunks whose upper 16 keys lie
// above the block; taking away the K and V loads gained under a fifth, the
// merge ~1 %. Rescaling only when a lane's max passes its running max by
// more than 4 (so p <= e^4) gained a few per cent. The tensor cores (3xTF32
// mma) are the open way past it.
//
// The backward (the strip kernel below) forms each pair's score, P, dP and
// dS once, for dQ, dK and dV alike, fed from shared memory, and reads the
// keep mask along keys, never down a column (that costs 32 sectors a warp
// load). A CTA owns whole groups and walks each
// group's causal triangle once, in query strips of 16 or 32 rows, in order.
// Per strip, warps take 8-row x 32-key blocks of pairs (skipping those above
// the diagonal), a lane 2 rows x 4 keys, so each float4 of q or dO read from
// shared memory feeds 4 pairs and each of k or v 2; each pair's s,
// P = exp(s - lse), dP = dO.v * keep and dS = P (dP - D) are computed once,
// the keep mask read along keys (8 lanes a 32-byte sector), and P keep and
// dS go to the strip's shared buffers. After a barrier, dV += (P keep)^T dO
// and dK += dS^T Q in registers of the threads that own (4 keys, 4 dims) of
// them, and dQ = dS K for the strip's rows, written out; meanwhile cp.async
// brings the next strip's rows in. Sums run in a fixed order, without
// atomics or scratch, so a launch gives the same bits every time.
//
// What holds it on this card: latency, not instruction rate. At the transformer's
// shape it takes ~0.42 ms at G = 4,320 (chip_smoke.py, PERF.md), several
// times what its instructions need: 128 registers and ~45 KB a CTA hold an
// SM to 4 CTAs of 4 warps, and the dK/dV owners of the low keys work every
// strip while the owners of keys past the strip wait at its barriers. In
// uncommitted probes, 4 x 4 pair tiles and strips of 32 rows ran no faster;
// taking away the register cap (2 CTAs an SM), a second P keep / dS buffer
// (one barrier a strip), copies two strips ahead and CTAs of 256 threads
// ran slower. The launch geometry comes from the wrapper
// (hopper_train_attention.py: train_attention_bwd_launch_geometry); shared
// memory takes every L up to 512 at hd up to 32, and the register
// accumulators grow to 4 units a thread at L = 512, hd = 32. The TPU
// kernels' G_BLOCK and 128-multiple L have no counterpart. wgmma and TMA
// are later work.
//
// The streamed kernels take every shape past the resident ones: L above
// MAX_L (the longest default bucket; the loader's longer buckets, the
// longest sentence rounded up to 64, come here at the transformer's
// hd = 16) or hd in 33..128, where a group's K and V no longer fit a
// block's shared memory or a row no longer fits a thread's registers. They
// replace kernels that gave a row to a warp (keys one at a time, each dot
// product a butterfly of shuffles, K and V read from global memory), which
// ran at ~1 % of the bound below.
//
// What bounds them: a causal pair costs the forward 4 hd operations and the
// backward 10 hd (as above), while the rows of q, k, v, dO and out and the
// keep mask need be read once. At hd = 16 and L = 576 (G = 720, 90 pairs)
// the forward does ~34 operations a byte it must move and the backward
// ~63, above the card's 20 (67 TFLOP/s f32 over 3.35 TB/s): operations
// bound the long buckets; at hd = 64 and L = 128 bytes and operations come
// within a factor of 1.3 of each other. What a kernel must avoid is
// reading K and V (or q and dO) again for every row: a CTA owns a tile of
// 32 rows of one group (query rows for the forward and dQ, keys for dK/dV)
// in shared memory and streams the other side through shared memory in
// stages of 32 or 64 rows, two buffers filled by cp.async while the other
// is walked, one barrier a stage; each streamed row serves the tile's 32
// rows, and the pair's keep rows of a stage come in along keys. Warp w
// takes the tile's rows [8 w, 8 w + 8) and 32-column chunks of each stage;
// lane (r_l, c_l) holds rows r_l + 4 i (i < 2) and columns c_l + 8 j
// (j < 4), so every float4 read from shared memory feeds 8 FMAs (scores).
// Shared memory does not grow with L; CTAs are launched longest walk first
// (a tile's CTAs take the groups in order, so one pair's keep rows are read
// by CTAs that run together), and every warp walks the same chunks, of
// which only the diagonal one is masked.
// - The products acc_r += w_rc x_c (P keep V, dS K, P keep dO, dS Q): at
//   hd = 16 a lane sums its own columns over all 16 dims and the 8 column
//   lanes of a row merge once at the end (fold), as the resident forward
//   does; at hd 32-128 the warp's (8, 32) weights go through a shared block
//   and a lane sums all 32 columns for its 2 rows and hd / 8 dims, so no
//   accumulator grows past 32 registers.
// - forward (train_attention_fwd_stream_kernel): the online softmax of the
//   resident forward carried across stages (at hd > 16 the row's max is
//   shared by its 8 lanes, 3 shuffles a chunk); out and lse written once.
// - backward, two launches, no atomics: dQ (query tiles, key stages from 0
//   to the diagonal; it also writes D_q = dO_q . out_q into a (G, L)
//   scratch), then dK and dV (key tiles, query stages from the diagonal to
//   L, with q, dO, lse and D). P is recomputed in each, as FlashAttention-2
//   does (7 hd FMAs a pair where the bound counts 5); every sum runs in a
//   fixed order, so a launch gives the same bits.
// Register caps follow the CTAs an SM that shared memory allows: 4 (128
// registers) for the forward at hd <= 32, 3 at 64, 2 at 128; 3 for dQ (2 at
// hd 128); 2 for dK/dV, whose two accumulators take 64 registers at hd 16.
// In probes on the H100, a cap of 128 everywhere spilled up to 748 bytes
// and ran the backward at L = 576 in 2.11 ms against 1.61; 2 or 4 groups of
// 16 or 8 rows a CTA, sharing the keep rows, ran 6 % to 3x slower than one
// group of 32, and 64-column stages at hd = 64 slower than 32. The launch geometry comes from the
// wrapper (hopper_train_attention.py: train_attention_stream_launch_geometry)
// and valid_stream_geometry refuses any other. f32 FMAs throughout (TF32
// breaks the limits above); the tensor cores (3xTF32) are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MAX_L = 512;
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory one Hopper block may use

// ---- resident backward: the causal triangle in query strips ----------------

namespace strip {

constexpr int MAX_THREADS = 256;  // threads a CTA at most (groups * threads a group)
constexpr int RQ = 2;             // query rows of a lane's pairs: tq_l + 4 i, i < RQ
constexpr int ROWS = 4 * RQ;      // query rows of a warp's pair block
constexpr int KEYS = 32;          // keys of a warp's pair block

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
// Floats a shared-memory row of q, k, v or dO: HD + 4, so that the float4s
// of 8 consecutive rows at one offset fall in 8 distinct bank quads.
__host__ __device__ inline int row_floats(int hd_max) { return hd_max + 4; }
// Floats a row of the strip's P keep and dS: the keys rounded up to a pair
// block, + 8, so that a warp's 4 rows x 8 keys of stores hit 32 banks.
__host__ __device__ inline int strip_floats(int l) { return round_up(l, KEYS) + 8; }

// Floats of one group's shared memory: K and V rows (L rounded up to a
// pair block), the strip's Q and dO rows (two buffers each: the next
// strip's are copied in while this one is reduced) and out rows (one, read
// only for D), its P keep and dS, and lse and D of every row.
__host__ __device__ inline size_t group_floats(int l, int hd_max, int tq) {
  const size_t lr = round_up(l, KEYS), s = row_floats(hd_max);
  return 2 * lr * s + 5 * (size_t)tq * s + 2 * (size_t)tq * strip_floats(l) + 2 * lr;
}

__device__ inline unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// Asynchronous copies into shared memory; a false pred writes zeros.
__device__ inline void copy16(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ inline void copy4(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ inline void copies_done() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ inline float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// Rows [r0, r0 + n) of an (L, hd) matrix into shared rows of HD + 4 floats,
// zero past L and past hd: 16-byte copies when vec (hd % 4 == 0 and every
// pointer 16-byte aligned), else 4-byte ones.
template <int HD>
__device__ inline void copy_rows(float* dst, const float* __restrict__ src, int r0, int n, int l,
                                 int hd, bool live, bool vec, int t, int nts) {
  constexpr int S = HD + 4;
  if (vec) {
    for (int i = t; i < n * (HD / 4); i += nts) {
      const int row = i / (HD / 4), c = 4 * (i % (HD / 4)), r = r0 + row;
      const bool in = live && r < l && c < hd;
      copy16(dst + row * S + c, in ? src + (size_t)r * hd + c : src, in);
    }
  } else {
    for (int i = t; i < n * HD; i += nts) {
      const int row = i / HD, d = i % HD, r = r0 + row;
      const bool in = live && r < l && d < hd;
      copy4(dst + row * S + d, in ? src + (size_t)r * hd + d : src, in);
    }
  }
}

// D_q = dO_q . out_q of rows [r0, r0 + tq), from the strip's dO and out
// rows, each piece by the thread that copied it (its own copies are
// complete once it has waited for them): a 4-dim chunk from its last dim
// down when vec, else one dim, then a xor butterfly over the row's pieces.
template <int HD>
__device__ inline void rows_d(float* d_s, const float* dos, const float* outs, int r0, int tq,
                              bool vec, int t, int nts) {
  constexpr int S = HD + 4;
  const int pieces = vec ? HD / 4 : HD;  // lanes a row: 4, 8, 16 or 32
  for (int i = t; i < tq * pieces; i += nts) {
    const int row = i / pieces, j = i % pieces;
    float part;
    if (vec) {
      const float4 x = ld4(dos + row * S + 4 * j), y = ld4(outs + row * S + 4 * j);
      part = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, x.w * y.w)));
    } else {
      part = dos[row * S + j] * outs[row * S + j];
    }
    for (int o = pieces / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (j == 0) d_s[r0 + row] = part;
  }
}

// Rows [r0, r0 + tq) of q, k, v, dO and out, and their lse, copied in: k
// and v to their rows, q and dO to the given buffers, out to its one.
template <int HD>
__device__ inline void copy_strip(float* ks, float* vs, float* qb, float* db, float* outs,
                                  float* lse_s, const float* kg, const float* vg, const float* qg,
                                  const float* dog, const float* outg, const float* lseg, int r0,
                                  int tq, int l, int hd, bool live, bool vec, int t, int nts) {
  constexpr int S = HD + 4;
  copy_rows<HD>(ks + r0 * S, kg, r0, tq, l, hd, live, vec, t, nts);
  copy_rows<HD>(vs + r0 * S, vg, r0, tq, l, hd, live, vec, t, nts);
  copy_rows<HD>(qb, qg, r0, tq, l, hd, live, vec, t, nts);
  copy_rows<HD>(db, dog, r0, tq, l, hd, live, vec, t, nts);
  copy_rows<HD>(outs, outg, r0, tq, l, hd, live, vec, t, nts);
  for (int i = t; i < tq; i += nts) {
    const bool in = live && r0 + i < l;
    copy4(lse_s + r0 + i, in ? lseg + r0 + i : lseg, in);
  }
}

// dst[0..3] (< hd) = a[0..3], as one float4 when vec.
__device__ inline void store4(float* dst, const float* a, int room, bool vec) {
  if (vec && room >= 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < room) dst[c] = a[c];
  }
}

}  // namespace strip

// A CTA of `groups` slots, `nts` threads each, one group a slot. Each slot
// walks its group's causal triangle once, query strip by query strip
// (rows [i0, i0 + tq)), with two barriers a strip:
//   1. pairs: warp w takes the strip's 8-row x 32-key blocks w, w + W, ...
//      (blocks wholly above the diagonal skipped); lane (tq_l, tk_l) of a
//      block takes rows tq_l + 4i and keys tk_l + 8j (i < 2, j < 4), so 8
//      independent pairs; per pair s = q.k and dp = dO.v (2 hd FMAs), one
//      expf, the keep mask read from global memory along keys (8 lanes a
//      32-byte sector, loaded before the products), and P keep = P * keep,
//      dS = P (dp * keep - D_q) stored to the strip's buffers (0 for k > q
//      and past L).
//   2. reduce: dV += (P keep)^T dO_strip and dK += dS^T Q_strip by the thread
//      that owns (4 keys, 4 dims) units (NKU of them, accumulators in
//      registers across strips), over the strip's rows in order; dQ = dS K
//      for the strip's rows by the threads that own (row, 4 dims), counted
//      from the slot's last thread down, over keys 0..q in order, and
//      stored. Meanwhile the next strip's rows of q, k, v, dO, out and lse
//      are copied in (cp.async) to the other buffers, and each thread sums
//      D over the pieces it copied.
// Every product is computed once, every sum in a fixed order: no atomics,
// the same bits on every launch.
template <int HD, int NKU>
__global__ void __launch_bounds__(strip::MAX_THREADS, NKU == 1 ? 2 : 1)
train_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ keep,
                           const float* __restrict__ out, const float* __restrict__ lse,
                           const float* __restrict__ dout, float* __restrict__ dq,
                           float* __restrict__ dk, float* __restrict__ dv, int g_total, int l,
                           int hd, int groups_per_pair, int tq, int nts, int vec_flag) {
  using namespace strip;
  constexpr int S = HD + 4, C4 = HD / 4;
  extern __shared__ __align__(16) float smem[];
  const bool vec = vec_flag != 0;
  const int slot = threadIdx.x / nts, t = threadIdx.x % nts;
  const size_t g = (size_t)blockIdx.x * (blockDim.x / nts) + slot;
  const bool live = g < (size_t)g_total;  // a slot past G only keeps the barriers
  const int lr = round_up(l, KEYS), lp = strip_floats(l);
  float* ks = smem + slot * group_floats(l, HD, tq);
  float* vs = ks + lr * S;
  float* qs = vs + lr * S;        // [2][tq][S]
  float* dos = qs + 2 * tq * S;   // [2][tq][S]
  float* outs = dos + 2 * tq * S; // [tq][S]
  float* ps = outs + tq * S;      // [tq][lp]: P keep
  float* dss = ps + tq * lp;      // [tq][lp]: dS
  float* lse_s = dss + tq * lp;   // [lr]
  float* d_s = lse_s + lr;        // [lr]: D_q = dO_q . out_q
  const size_t off = live ? g * l * hd : 0;
  const float* qg = q + off;
  const float* kg = k + off;
  const float* vg = v + off;
  const float* dog = dout + off;
  const float* outg = out + off;
  const float* lseg = lse + (live ? g * l : 0);
  const float* keep_g = keep + (live ? (g / groups_per_pair) * l * l : 0);

  // Prologue: strip 0's rows and its D. K and V rows past the last strip
  // are never copied: only masked pairs read them.
  copy_strip<HD>(ks, vs, qs, dos, outs, lse_s, kg, vg, qg, dog, outg, lseg, 0, tq, l, hd, live,
                 vec, t, nts);
  copies_done();
  rows_d<HD>(d_s, dos, outs, 0, tq, vec, t, nts);
  __syncthreads();

  // dK / dV units: 4 keys (4 key4 .. 4 key4 + 3) x 4 dims (d0 .. d0 + 3).
  const int d0 = 4 * (t % C4);
  int key4[NKU];
  float dka[NKU][4][4], dva[NKU][4][4];
#pragma unroll
  for (int n = 0; n < NKU; ++n) {
    key4[n] = t / C4 + n * (nts / C4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) dka[n][j][c] = dva[n][j][c] = 0.0f;
  }
  const int warp = t / 32, nwarps = nts / 32, lane = t % 32;
  const int tq_l = lane >> 3, tk_l = lane & 7;
  const int n_strips = (l + tq - 1) / tq;

  for (int si = 0; si < n_strips; ++si) {
    const int i0 = si * tq, kc = min(i0 + tq, l);
    const float* qb = qs + (si & 1) * tq * S;
    const float* db = dos + (si & 1) * tq * S;

    // 1. pairs.
    const int nrb = tq / ROWS, nblocks = nrb * ((kc + KEYS - 1) / KEYS);
    for (int blk = warp; live && blk < nblocks; blk += nwarps) {
      const int rb = i0 + (blk % nrb) * ROWS, kb = (blk / nrb) * KEYS;
      if (kb > rb + ROWS - 1 || rb >= l) continue;
      // The block's keep mask (rows and keys clamped into the group), loaded
      // first so that its latency hides under the products.
      float sc[RQ][4], dp[RQ][4], kp[RQ][4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float* keep_r = keep_g + (size_t)min(rb + tq_l + 4 * i, l - 1) * l;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kp[i][j] = __ldg(keep_r + min(kb + tk_l + 8 * j, l - 1));
          sc[i][j] = dp[i][j] = 0.0f;
        }
      }
      const float* qrow = qb + (rb - i0 + tq_l) * S;
      const float* drow = db + (rb - i0 + tq_l) * S;
      const float* krow = ks + (kb + tk_l) * S;
      const float* vrow = vs + (kb + tk_l) * S;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ld4(krow + 8 * j * S + d);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float4 a = ld4(qrow + 4 * i * S + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(a.x, b[j].x, sc[i][j]);
            sc[i][j] = fmaf(a.y, b[j].y, sc[i][j]);
            sc[i][j] = fmaf(a.z, b[j].z, sc[i][j]);
            sc[i][j] = fmaf(a.w, b[j].w, sc[i][j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ld4(vrow + 8 * j * S + d);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float4 a = ld4(drow + 4 * i * S + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dp[i][j] = fmaf(a.x, b[j].x, dp[i][j]);
            dp[i][j] = fmaf(a.y, b[j].y, dp[i][j]);
            dp[i][j] = fmaf(a.z, b[j].z, dp[i][j]);
            dp[i][j] = fmaf(a.w, b[j].w, dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int r = rb + tq_l + 4 * i;
        const float lse_r = lse_s[r], d_r = d_s[r];
        float* prow = ps + (r - i0) * lp;
        float* srow = dss + (r - i0) * lp;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = kb + tk_l + 8 * j;
          const bool causal = key <= r && r < l;  // else s and dp may be of rows not copied in
          const float p = expf(sc[i][j] - lse_r);
          prow[key] = causal ? p * kp[i][j] : 0.0f;
          srow[key] = causal ? p * (dp[i][j] * kp[i][j] - d_r) : 0.0f;
        }
      }
    }
    __syncthreads();

    // The next strip's rows, copied in while this one is reduced.
    const bool next = si + 1 < n_strips;
    const int nb = (si + 1) & 1;
    if (next)
      copy_strip<HD>(ks, vs, qs + nb * tq * S, dos + nb * tq * S, outs, lse_s, kg, vg, qg, dog,
                     outg, lseg, i0 + tq, tq, l, hd, live, vec, t, nts);

    if (live) {
      // 2a. dK and dV: rows q >= the unit's first key (the rest are masked).
#pragma unroll 2
      for (int r = max(i0, 4 * key4[0]); r < kc; ++r) {
        const float4 o = ld4(db + (r - i0) * S + d0), x = ld4(qb + (r - i0) * S + d0);
        const float ov[4] = {o.x, o.y, o.z, o.w}, xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int n = 0; n < NKU; ++n) {
          if (r < 4 * key4[n]) continue;
          const float4 p = ld4(ps + (r - i0) * lp + 4 * key4[n]);
          const float4 e = ld4(dss + (r - i0) * lp + 4 * key4[n]);
          const float pv[4] = {p.x, p.y, p.z, p.w}, ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              dva[n][j][c] = fmaf(pv[j], ov[c], dva[n][j][c]);
              dka[n][j][c] = fmaf(ev[j], xv[c], dka[n][j][c]);
            }
        }
      }
      // 2b. dQ of the strip's rows, keys 0 .. q rounded up to 4 (dS = 0 past q).
      for (int u = nts - 1 - t; u < tq * C4; u += nts) {
        const int rl = u / C4, c0 = 4 * (u % C4), r = i0 + rl;
        if (r >= l) continue;
        float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const float* srow = dss + rl * lp;
#pragma unroll 2
        for (int key = 0; key <= r; key += 4) {
          const float4 e = ld4(srow + key);
          const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 b = ld4(ks + (key + j) * S + c0);
            a[0] = fmaf(ev[j], b.x, a[0]);
            a[1] = fmaf(ev[j], b.y, a[1]);
            a[2] = fmaf(ev[j], b.z, a[2]);
            a[3] = fmaf(ev[j], b.w, a[3]);
          }
        }
        if (c0 < hd) store4(dq + off + (size_t)r * hd + c0, a, hd - c0, vec);
      }
    }
    copies_done();
    if (next) rows_d<HD>(d_s, dos + nb * tq * S, outs, i0 + tq, tq, vec, t, nts);
    __syncthreads();
  }

  if (!live || d0 >= hd) return;
#pragma unroll
  for (int n = 0; n < NKU; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = 4 * key4[n] + j;
      if (key < l) {
        store4(dk + off + (size_t)key * hd + d0, dka[n][j], hd - d0, vec);
        store4(dv + off + (size_t)key * hd + d0, dva[n][j], hd - d0, vec);
      }
    }
}

// ---- resident forward: the causal triangle in query strips -----------------

namespace fwd {

constexpr int MAX_THREADS = 128;  // threads a CTA at most (4 * groups * tq)
constexpr int ROWS = 8;           // query rows of a warp's block: tq_l + 4 i, i < 2
constexpr int KEYS = 32;          // keys of a chunk: tk_l + 8 j, j < 4
constexpr float LOG2E = 1.4426950408889634f;
// How far a lane's max may rise past its running max m before its sum and
// accumulators are rescaled (natural log units): p stays within e^4.
constexpr float RESCALE = 4.0f;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
// Floats a row of the strip's keep: the keys rounded up to a chunk, + 8, so
// that a warp's loads of 4 rows x 8 consecutive keys hit 32 banks.
__host__ __device__ inline int keep_floats(int l) { return round_up(l, KEYS) + 8; }

// Floats of a CTA's shared memory: for each of its groups, K and V rows (L
// rounded up to a chunk) and two buffers of the strip's q rows, HD floats a
// row; two buffers of the strip's keep rows, shared by the groups (all of
// one pair).
__host__ __device__ inline size_t smem_floats(int l, int hd_max, int groups, int tq) {
  const size_t lr = round_up(l, KEYS);
  return (size_t)groups * 2 * (lr + tq) * hd_max + 2 * (size_t)tq * keep_floats(l);
}

// The float4 column where column c4 of shared row r is kept: rows are HD
// floats with no padding, and the columns of 8 consecutive rows are permuted
// so that one column of those rows falls in 8 distinct bank quads.
template <int HD>
__device__ inline int swz(int r, int c4) {
  return HD == 16 ? c4 ^ ((r >> 1) & 3) : c4 ^ (r & 7);
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error ~2^-22,
// results below 2^-126 flushed to 0; 2^-inf = 0).
__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows [r0, r0 + n) of an (L, hd) matrix into shared rows d0, d0 + 1, ... of
// HD floats (swizzled), zero past L and past hd: 16-byte copies when vec.
template <int HD>
__device__ inline void copy_rows(float* dst, int d0, const float* __restrict__ src, int r0, int n,
                                 int l, int hd, bool vec, int t, int nts) {
  constexpr int C4 = HD / 4;
  if (vec) {
    for (int i = t; i < n * C4; i += nts) {
      const int row = i / C4, c4 = i % C4, r = r0 + row;
      const bool in = r < l && 4 * c4 < hd;
      strip::copy16(dst + (d0 + row) * HD + 4 * swz<HD>(d0 + row, c4),
                    in ? src + (size_t)r * hd + 4 * c4 : src, in);
    }
  } else {
    for (int i = t; i < n * HD; i += nts) {
      const int row = i / HD, d = i % HD, r = r0 + row;
      const bool in = r < l && d < hd;
      strip::copy4(dst + (d0 + row) * HD + 4 * swz<HD>(d0 + row, d / 4) + d % 4,
                   in ? src + (size_t)r * hd + d : src, in);
    }
  }
}

// Rows [r0, r0 + n) x keys [0, kend) (kend a multiple of 32) of a pair's
// (L, L) keep mask into rows of lp floats, zero past L: thread t copies
// columns t % 8 * 4 + 32 c (16 bytes each) of rows t / 8, t / 8 + nts / 8,
// ... when vec (L % 4 == 0), else columns t % 32 + 32 c of rows t / 32, ...
__device__ inline void copy_keep(float* dst, const float* __restrict__ keep_p, int r0, int n,
                                 int kend, int l, int lp, bool vec, int t, int nts) {
  const int w = vec ? 4 : 1, sh = vec ? 3 : 5;  // 1 << sh threads a row
  for (int row = t >> sh; row < n; row += nts >> sh) {
    const int r = r0 + row;
    for (int c = w * (t & ((1 << sh) - 1)); c < kend; c += KEYS) {
      const bool in = r < l && c < l;
      const float* src = in ? keep_p + (size_t)r * l + c : keep_p;
      if (vec)
        strip::copy16(dst + row * lp + c, src, in);
      else
        strip::copy4(dst + row * lp + c, src, in);
    }
  }
}

// Strip s's rows into buffer s & 1: q rows [i0, i0 + tq) of each live group
// and the pair's keep rows [i0, i0 + tq) over the keys of their chunks; and,
// where the strip opens a chunk, that chunk's 32 K and V rows (zero past L).
template <int HD>
__device__ inline void copy_strip(float* ks, float* vs, float* qs, float* keep_s,
                                  const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ keep_p,
                                  size_t g0, int live_groups, int groups, int s, int tq, int l,
                                  int hd, int lr, int lp, bool vec, bool kvec, int t, int nts) {
  const int i0 = s * tq, b = s & 1;
  for (int sl = 0; sl < live_groups; ++sl) {
    const size_t off = (g0 + sl) * l * hd;
    if (i0 % KEYS == 0) {
      copy_rows<HD>(ks + (size_t)sl * lr * HD, i0, k + off, i0, KEYS, l, hd, vec, t, nts);
      copy_rows<HD>(vs + (size_t)sl * lr * HD, i0, v + off, i0, KEYS, l, hd, vec, t, nts);
    }
    copy_rows<HD>(qs + (size_t)(b * groups + sl) * tq * HD, 0, q + off, i0, tq, l, hd, vec, t, nts);
  }
  copy_keep(keep_s + (size_t)b * tq * lp, keep_p, i0, tq, round_up(i0 + 1, KEYS), l, lp, kvec, t,
            nts);
}

// Sums a[d] and a[d + H] of lanes l and l ^ o (d < H) into a[0 .. H): the
// lane with bit o set keeps the upper half, the other the lower.
template <int H>
__device__ inline void fold(float* a, int o, bool hi) {
#pragma unroll
  for (int d = 0; d < H; ++d) {
    const float send = hi ? a[d] : a[d + H], mine = hi ? a[d + H] : a[d];
    a[d] = mine + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

}  // namespace fwd

namespace fwd {

// One 32-key chunk of a lane's walk: keys kb + tk_l + 8 j (j < 4) of its
// rows i0 + rl[i] (i < 2). The scores, -inf above the diagonal; each row's
// max over them; the sum and accumulators rescaled only when that max
// passes the running max m by more than RESCALE (so every p <= e^RESCALE);
// then p = 2^((s - m) log2 e), z += p, acc += p keep v. (A path that walks
// only the lower 16 keys where the block's rows stop short of them ran
// slower on the H100: two copies of this body.)
template <int HD>
__device__ __forceinline__ void walk_chunk(const float* kg, const float* vg, const float* qb,
                                           const float* keep_b, const int* koff,
                                           const int (*qoff)[HD / 4], const int* rl, int i0,
                                           int kb, int tk_l, int lp, float (*acc)[HD], float* m,
                                           float* z) {
  constexpr int C4 = HD / 4, J = 4;  // J: the lane's keys in a chunk
  float sc[2][J];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) sc[i][j] = 0.0f;
  const float* krow = kg + (kb + tk_l) * HD;
#pragma unroll
  for (int c4 = 0; c4 < C4; ++c4) {
    float4 kx[J];
#pragma unroll
    for (int j = 0; j < J; ++j) kx[j] = strip::ld4(krow + 8 * j * HD + koff[c4]);
    const float4 qx[2] = {strip::ld4(qb + rl[0] * HD + qoff[0][c4]),
                          strip::ld4(qb + rl[1] * HD + qoff[1][c4])};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        float& e = sc[i][j];
        e = fmaf(qx[i].x, kx[j].x, e);
        e = fmaf(qx[i].y, kx[j].y, e);
        e = fmaf(qx[i].z, kx[j].z, e);
        e = fmaf(qx[i].w, kx[j].w, e);
      }
  }
  float w[2][J];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (kb + tk_l + 8 * j > i0 + rl[i]) sc[i][j] = -INFINITY;
    float cm = sc[i][0];
#pragma unroll
    for (int j = 1; j < J; ++j) cm = fmaxf(cm, sc[i][j]);
    if (cm > m[i] + RESCALE) {  // true at the first keys (m is -inf)
      const float alpha = ex2((m[i] - cm) * LOG2E);
      z[i] *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[i][d] *= alpha;
      m[i] = cm;
    }
    const float ml = (m[i] == -INFINITY ? 0.0f : m[i]) * LOG2E;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      w[i][j] = ex2(fmaf(sc[i][j], LOG2E, -ml));
      z[i] += w[i][j];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) w[i][j] *= keep_b[rl[i] * lp + kb + tk_l + 8 * j];
  const float* vrow = vg + (kb + tk_l) * HD;
#pragma unroll
  for (int c4 = 0; c4 < C4; ++c4) {
    float4 vx[J];
#pragma unroll
    for (int j = 0; j < J; ++j) vx[j] = strip::ld4(vrow + 8 * j * HD + koff[c4]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        acc[i][4 * c4] = fmaf(w[i][j], vx[j].x, acc[i][4 * c4]);
        acc[i][4 * c4 + 1] = fmaf(w[i][j], vx[j].y, acc[i][4 * c4 + 1]);
        acc[i][4 * c4 + 2] = fmaf(w[i][j], vx[j].z, acc[i][4 * c4 + 2]);
        acc[i][4 * c4 + 3] = fmaf(w[i][j], vx[j].w, acc[i][4 * c4 + 3]);
      }
  }
}

}  // namespace fwd

// A CTA of `groups` groups of one pair (group g takes keep[g / groups_per_pair];
// a pair's groups fill ceil(groups_per_pair / groups) CTAs, the last with
// fewer live groups) walks the groups' causal triangles in query strips of tq
// rows (8, 16 or 32), in step, one barrier a strip. Warp w takes rows
// [i0 + 8 (w % (tq / 8)), + 8) of group w / (tq / 8) in every strip, so every
// warp of a strip walks the same number of 32-key chunks (tq divides 32).
// Lane (tq_l, tk_l) takes rows tq_l + 4 i (i < 2) and keys tk_l + 8 j (j < 4)
// of each chunk (walk_chunk): 8 independent pairs, each float4 of k or v read
// from shared memory feeding 8 FMAs, the keep mask read along keys (8 lanes a
// 32-byte sector), a lane's own online softmax over its keys. At the end of
// the row block the 8 key lanes of a row merge (m, z, acc) by xor shuffles in
// a fixed order (acc reduce-scattered, so lane tk_l ends with dims
// [tk_l HD / 8, + HD / 8)), and write out = acc / z and lse = m + log z as
// contiguous rows.
// Meanwhile cp.async brings the next strip's q and keep rows (and K and V
// rows where it opens a chunk) into the other buffers. Every sum runs in a
// fixed order, without atomics: the same bits every launch.
template <int HD>
__global__ void __launch_bounds__(fwd::MAX_THREADS, HD <= 16 ? 4 : 1)
train_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ keep,
                           float* __restrict__ out, float* __restrict__ lse, int l, int hd,
                           int groups_per_pair, int groups, int tq, int vec_flag, int kvec_flag) {
  using namespace fwd;
  constexpr int C4 = HD / 4, DPL = HD / 8;  // DPL: dims of a row a lane writes
  extern __shared__ __align__(16) float smem[];
  const bool vec = vec_flag != 0, kvec = kvec_flag != 0;
  const int t = threadIdx.x, nts = blockDim.x;
  const int ctas_per_pair = (groups_per_pair + groups - 1) / groups;
  const int pair = blockIdx.x / ctas_per_pair, first = (blockIdx.x % ctas_per_pair) * groups;
  const int live_groups = min(groups, groups_per_pair - first);
  const size_t g0 = (size_t)pair * groups_per_pair + first;
  const int lr = round_up(l, KEYS), lp = keep_floats(l);
  float* ks = smem;                              // [groups][lr][HD]
  float* vs = ks + (size_t)groups * lr * HD;     // [groups][lr][HD]
  float* qs = vs + (size_t)groups * lr * HD;     // [2][groups][tq][HD]
  float* keep_s = qs + (size_t)2 * groups * tq * HD;  // [2][tq][lp]
  const float* keep_p = keep + (size_t)pair * l * l;

  const int warp = t / 32, lane = t % 32, tq_l = lane >> 3, tk_l = lane & 7;
  const int rbs = tq / ROWS, slot = warp / rbs, rbi = warp % rbs;
  const bool live = slot < live_groups;
  const size_t g = g0 + slot;
  const float* kg = ks + (size_t)slot * lr * HD;
  const float* vg = vs + (size_t)slot * lr * HD;
  // Swizzled float4 columns of the lane's key rows (kb + tk_l + 8 j: the
  // same for every chunk and j) and of its query rows (tq_l + 4 i).
  int koff[C4], qoff[2][C4];
#pragma unroll
  for (int c4 = 0; c4 < C4; ++c4) {
    koff[c4] = 4 * swz<HD>(tk_l, c4);
#pragma unroll
    for (int i = 0; i < 2; ++i) qoff[i][c4] = 4 * swz<HD>(tq_l + 4 * i, c4);
  }
  const int n_strips = (l + tq - 1) / tq;

  copy_strip<HD>(ks, vs, qs, keep_s, q, k, v, keep_p, g0, live_groups, groups, 0, tq, l, hd, lr,
                 lp, vec, kvec, t, nts);
  for (int s = 0; s < n_strips; ++s) {
    strip::copies_done();
    __syncthreads();  // strip s in; every warp done with strip s - 1's buffers
    if (s + 1 < n_strips)
      copy_strip<HD>(ks, vs, qs, keep_s, q, k, v, keep_p, g0, live_groups, groups, s + 1, tq, l,
                     hd, lr, lp, vec, kvec, t, nts);
    const int i0 = s * tq, rb = i0 + ROWS * rbi;
    if (!live || rb >= l) continue;
    const int b = s & 1;
    const float* qb = qs + (size_t)(b * groups + slot) * tq * HD;
    const float* keep_b = keep_s + (size_t)b * tq * lp;
    int rl[2];  // the lane's rows within the strip
    float acc[2][HD], m[2], z[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rl[i] = rb - i0 + tq_l + 4 * i;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[i][d] = 0.0f;
      m[i] = -INFINITY;
      z[i] = 0.0f;
    }
    const int kend = KEYS * ((rb + ROWS - 1) / KEYS + 1);  // the block's keys, whole chunks

    for (int kb = 0; kb < kend; kb += KEYS) {
      walk_chunk<HD>(kg, vg, qb, keep_b, koff, qoff, rl, i0, kb, tk_l, lp, acc, m, z);
    }

    // Merge the 8 key lanes of each row and write its out and lse.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mm = m[i];
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, o));
      const float scale = ex2((m[i] - mm) * LOG2E);  // 0 for a lane without keys
      float zz = z[i] * scale;
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) zz += __shfl_xor_sync(0xffffffffu, zz, o);
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[i][d] *= scale;
      fold<HD / 2>(acc[i], 4, tk_l & 4);
      fold<HD / 4>(acc[i], 2, tk_l & 2);
      fold<HD / 8>(acc[i], 1, tk_l & 1);
      const int r = i0 + rl[i];
      if (r >= l) continue;
      const float inv_z = 1.0f / zz;
      const int d0 = DPL * tk_l;
      float* orow = out + (g * l + r) * hd + d0;
      if (vec && d0 + DPL <= hd) {
        if (DPL == 2)
          *reinterpret_cast<float2*>(orow) = make_float2(acc[i][0] * inv_z, acc[i][1] * inv_z);
        else
          *reinterpret_cast<float4*>(orow) = make_float4(acc[i][0] * inv_z, acc[i][1] * inv_z,
                                                         acc[i][2] * inv_z, acc[i][3] * inv_z);
      } else {
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          if (d0 + e < hd) orow[e] = acc[i][e] * inv_z;
      }
      if (tk_l == 0) lse[g * l + r] = mm + logf(zz);
    }
  }
}

// ---- streamed kernels: every shape past the resident ones ------------------

namespace stream {

constexpr int ROWS = 32;          // the CTA's own rows: an 8-row block a warp
constexpr int THREADS = 4 * ROWS;  // 4 warps
constexpr int CHUNK = 32;         // columns of a warp's block: c_l + 8 j, j < 4
// Floats a row of a warp's (8, 32) weight block: 40, so that a lane's 2 x 4
// stores (rows r_l + 4 i, columns c_l + 8 j) hit 32 banks.
constexpr int WS = 40;

// Floats of a CTA's shared memory, kernel by kernel (kind 0 the forward, 1
// dQ, 2 dK/dV): the CTA's own ROWS rows, HD floats each (q; q and dO; k and
// v), two buffers of a stage's `cols` streamed rows (k and v; k and v; q,
// dO, lse and D), two of the stage's keep rows (ROWS x (cols + 8) along
// keys; for dK/dV cols x (ROWS + 4), the stage's queries along the CTA's
// keys), and at HD > 16 a weight block a warp.
__host__ __device__ inline size_t cta_floats(int kind, int hd_max, int cols) {
  const size_t own = (size_t)ROWS * hd_max, stage = (size_t)cols * hd_max;
  const size_t w = hd_max > 16 ? (size_t)THREADS / 32 * 8 * WS : 0;
  if (kind == 0) return own + 4 * stage + 2 * (size_t)ROWS * (cols + 8) + w;
  if (kind == 1) return 2 * own + 4 * stage + 2 * (size_t)ROWS * (cols + 8) + w;
  return 2 * own + 4 * stage + 4 * (size_t)cols + 2 * (size_t)cols * (ROWS + 4) + w;
}

// The CTA's place: rows [r0, r0 + ROWS) of group g. Tiles go longest walk
// first (the last query tiles, the first key tiles); a tile's CTAs take the
// groups in order, so the CTAs that read one pair's keep rows run together.
struct Place {
  int r0;
  size_t g;
};
__device__ inline Place place(int l, int g_total, bool last_first) {
  const int n_tiles = (l + ROWS - 1) / ROWS, idx = blockIdx.x / g_total;
  return {(last_first ? n_tiles - 1 - idx : idx) * ROWS, (size_t)(blockIdx.x % g_total)};
}

// Rows [r0, r0 + n) x keys [k0, k0 + nk) of a pair's (L, L) keep mask into
// rows of `stride` floats, zero past L: 16-byte copies when vec (L % 4 == 0).
__device__ inline void copy_keep(float* dst, const float* __restrict__ keep_p, int r0, int n,
                                 int k0, int nk, int l, int stride, bool vec, int t, int nts) {
  const int w = vec ? 4 : 1, per_row = nk / w;
  for (int i = t; i < n * per_row; i += nts) {
    const int row = i / per_row, c = w * (i % per_row), r = r0 + row, key = k0 + c;
    const bool in = r < l && key < l;
    const float* src = in ? keep_p + (size_t)r * l + key : keep_p;
    if (vec)
      strip::copy16(dst + row * stride + c, src, in);
    else
      strip::copy4(dst + row * stride + c, src, in);
  }
}

// Entries [r0, r0 + n) of an L-vector into dst, zero past L.
__device__ inline void copy_vec(float* dst, const float* __restrict__ src, int r0, int n, int l,
                                int t, int nts) {
  for (int i = t; i < n; i += nts) {
    const bool in = r0 + i < l;
    strip::copy4(dst + i, in ? src + r0 + i : src, in);
  }
}

// sc[i][j] = a_(ra + 4 i) . b_(cb + 8 j) (i < 2, j < 4) over HD dims, rows
// of HD floats in shared memory swizzled by their index in their buffer
// (fwd::swz; rows cb + 8 j share cb's swizzle).
template <int HD>
__device__ __forceinline__ void scores(float (&sc)[2][4], const float* a, int ra, const float* b,
                                       int cb) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
  // 8 float4 columns at a time: unrolled whole at hd 64 and 128, the library
  // took 57 s to build against 22, and ran no faster.
#pragma unroll 8
  for (int c4 = 0; c4 < HD / 4; ++c4) {
    float4 bx[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bx[j] = strip::ld4(b + (cb + 8 * j) * HD + 4 * fwd::swz<HD>(cb, c4));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 ax = strip::ld4(a + (ra + 4 * i) * HD + 4 * fwd::swz<HD>(ra + 4 * i, c4));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float& e = sc[i][j];
        e = fmaf(ax.x, bx[j].x, e);
        e = fmaf(ax.y, bx[j].y, e);
        e = fmaf(ax.z, bx[j].z, e);
        e = fmaf(ax.w, bx[j].w, e);
      }
    }
  }
}

// acc[i][d] += w[i][j] x_(cb + 8 j)[d] over the lane's 4 columns and all HD
// dims (the lane's partial sums; the 8 column lanes of a row merge at the end).
template <int HD>
__device__ __forceinline__ void accumulate_full(float (&acc)[2][HD], const float (&w)[2][4],
                                                const float* x, int cb) {
#pragma unroll
  for (int c4 = 0; c4 < HD / 4; ++c4) {
    float4 xv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xv[j] = strip::ld4(x + (cb + 8 * j) * HD + 4 * fwd::swz<HD>(cb, c4));
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][4 * c4] = fmaf(w[i][j], xv[j].x, acc[i][4 * c4]);
        acc[i][4 * c4 + 1] = fmaf(w[i][j], xv[j].y, acc[i][4 * c4 + 1]);
        acc[i][4 * c4 + 2] = fmaf(w[i][j], xv[j].z, acc[i][4 * c4 + 2]);
        acc[i][4 * c4 + 3] = fmaf(w[i][j], xv[j].w, acc[i][4 * c4 + 3]);
      }
  }
}

// acc[i][4 n + e] += sum_c W[r_l + 4 i][c] x_c[4 (c_l + 8 n) + e] over the
// 32 columns of the warp's block: the lanes' weights go through the warp's
// block wb, then each lane takes its 2 rows and HD / 8 dims (float4 n of
// the lane's dims is float4 column c_l + 8 n of a row).
template <int HD>
__device__ __forceinline__ void accumulate_split(float (&acc)[2][HD / 8], const float (&w)[2][4],
                                                 float* wb, const float* x, int rl, int cl) {
  __syncwarp();  // the warp's reads of the last block are done
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wb[(rl + 4 * i) * WS + cl + 8 * j] = w[i][j];
  __syncwarp();
  // Two groups of 4 columns at a time, for the build time as in scores.
#pragma unroll 2
  for (int c = 0; c < CHUNK; c += 4) {
    const float4 w0 = strip::ld4(wb + rl * WS + c), w1 = strip::ld4(wb + (rl + 4) * WS + c);
    const float wv[2][4] = {{w0.x, w0.y, w0.z, w0.w}, {w1.x, w1.y, w1.z, w1.w}};
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int n = 0; n < HD / 32; ++n) {
        const float4 xv = strip::ld4(x + (c + e) * HD + 4 * fwd::swz<HD>(c + e, cl + 8 * n));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[i][4 * n] = fmaf(wv[i][e], xv.x, acc[i][4 * n]);
          acc[i][4 * n + 1] = fmaf(wv[i][e], xv.y, acc[i][4 * n + 1]);
          acc[i][4 * n + 2] = fmaf(wv[i][e], xv.z, acc[i][4 * n + 2]);
          acc[i][4 * n + 3] = fmaf(wv[i][e], xv.w, acc[i][4 * n + 3]);
        }
      }
  }
}

// The products of a chunk: accumulate_split at HD > 16, else accumulate_full.
template <int HD, int DA>
__device__ __forceinline__ void accumulate(float (&acc)[2][DA], const float (&w)[2][4], float* wb,
                                           const float* x, int rl, int cl) {
  if constexpr (DA == HD)
    accumulate_full<HD>(acc, w, x, cl);
  else
    accumulate_split<HD>(acc, w, wb, x, rl, cl);
}

// Row i of the lane's accumulators, times `scale`, to its place in `row`
// (an hd-float row of global memory): at HD > 16 the lane's HD / 8 dims
// (float4 columns c_l + 8 n); else the 8 column lanes' partial sums are
// folded first (all lanes take part) and the lane writes dims
// [2 c_l, 2 c_l + 2).
template <int HD, int DA>
__device__ __forceinline__ void store_row(float* row, float (&a)[DA], float scale, int cl, int hd,
                                          bool vec, bool write) {
  if constexpr (DA == HD) {
    fwd::fold<HD / 2>(a, 4, cl & 4);
    fwd::fold<HD / 4>(a, 2, cl & 2);
    fwd::fold<HD / 8>(a, 1, cl & 1);
    if (!write) return;
    const int d0 = HD / 8 * cl;
    if (vec && d0 + 2 <= hd) {
      *reinterpret_cast<float2*>(row + d0) = make_float2(a[0] * scale, a[1] * scale);
    } else {
#pragma unroll
      for (int e = 0; e < HD / 8; ++e)
        if (d0 + e < hd) row[d0 + e] = a[e] * scale;
    }
  } else {
    if (!write) return;
#pragma unroll
    for (int n = 0; n < HD / 32; ++n) {
      const int d0 = 4 * (cl + 8 * n);
      const float x[4] = {a[4 * n] * scale, a[4 * n + 1] * scale, a[4 * n + 2] * scale,
                          a[4 * n + 3] * scale};
      if (d0 < hd) strip::store4(row + d0, x, hd - d0, vec);
    }
  }
}

}  // namespace stream

// The streamed forward. A CTA takes query rows [i0, i0 + ROWS) of one group
// (stream::place), warp w rows [i0 + 8 w, + 8), and streams keys 0 .. the
// tile's diagonal chunk in stages of `cols` keys: K and V rows and the
// pair's keep rows of the stage (along keys) by cp.async into one buffer
// while the other is walked, chunk by chunk. Lane (r_l, c_l) keeps, for rows
// r_l + 4 i, the online softmax of the resident forward: at HD = 16 its own
// max, sum and accumulators over its keys, merged over the 8 column lanes at
// the end; at HD > 16 the row's max over the chunk (3 shuffles), so that the
// 8 lanes share one scale and each accumulates HD / 8 dims over all 32 keys.
// Only the diagonal chunk is masked. out and lse are written once.
template <int HD>
__global__ void __launch_bounds__(stream::THREADS, HD <= 32 ? 4 : HD == 64 ? 3 : 2)
train_attention_fwd_stream_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ keep,
                                  float* __restrict__ out, float* __restrict__ lse, int g_total,
                                  int l, int hd, int groups_per_pair, int cols, int vec_flag,
                                  int kvec_flag) {
  using namespace stream;
  using fwd::LOG2E;
  using fwd::ex2;
  constexpr int DA = HD > 16 ? HD / 8 : HD;  // accumulators a row a lane
  extern __shared__ __align__(16) float smem[];
  const bool vec = vec_flag != 0, kvec = kvec_flag != 0;
  const int t = threadIdx.x, nts = blockDim.x;
  const Place pl = place(l, g_total, true);
  const int i0 = pl.r0, lp = cols + 8, stage = cols * HD;
  float* qs = smem;                       // [ROWS][HD]
  float* ks = qs + ROWS * HD;             // [2][cols][HD]
  float* vs = ks + 2 * stage;             // [2][cols][HD]
  float* keep_s = vs + 2 * stage;         // [2][ROWS][cols + 8]
  float* wbuf = keep_s + 2 * ROWS * lp;   // [warps][8][WS] (HD > 16)
  const size_t g = pl.g, off = g * l * hd;
  const float* keep_p = keep + (g / groups_per_pair) * l * l;
  const int warp = t / 32, lane = t % 32, rl = lane >> 3, cl = lane & 7, rb = 8 * warp;
  const bool live = i0 + rb < l;
  const int kend = (i0 / CHUNK + 1) * CHUNK;  // keys through the diagonal chunk
  const int n_stages = (kend + cols - 1) / cols;

  auto copy_stage = [&](int s) {
    const int kt = s * cols, nk = min(cols, kend - kt);
    float* kb = ks + (s & 1) * stage;
    fwd::copy_rows<HD>(kb, 0, k + off, kt, nk, l, hd, vec, t, nts);
    fwd::copy_rows<HD>(kb + 2 * stage, 0, v + off, kt, nk, l, hd, vec, t, nts);
    copy_keep(keep_s + (s & 1) * ROWS * lp, keep_p, i0, ROWS, kt, nk, l, lp, kvec, t, nts);
  };
  fwd::copy_rows<HD>(qs, 0, q + off, i0, ROWS, l, hd, vec, t, nts);
  copy_stage(0);

  float* wb = wbuf + warp * 8 * WS;
  float acc[2][DA], m[2], z[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int d = 0; d < DA; ++d) acc[i][d] = 0.0f;
    m[i] = -INFINITY;
    z[i] = 0.0f;
  }
  for (int s = 0; s < n_stages; ++s) {
    strip::copies_done();
    __syncthreads();  // stage s in; every warp done with stage s - 1's buffers
    if (s + 1 < n_stages) copy_stage(s + 1);
    if (!live) continue;
    const float* kb = ks + (s & 1) * stage;
    const float* keep_b = keep_s + (s & 1) * ROWS * lp;
    for (int c = 0; c < cols && s * cols + c < kend; c += CHUNK) {
      const int k0 = s * cols + c;
      float sc[2][4], w[2][4];
      scores<HD>(sc, qs, rb + rl, kb + c * HD, cl);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (k0 + CHUNK > i0) {  // the diagonal chunk
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (k0 + cl + 8 * j > i0 + rb + rl + 4 * i) sc[i][j] = -INFINITY;
        }
        float cm = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
        if constexpr (DA != HD) {  // one max for the row's 8 lanes
#pragma unroll
          for (int o = 1; o < 8; o <<= 1) cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
        }
        if (cm > m[i] + fwd::RESCALE) {  // true at the first keys (m is -inf)
          const float alpha = ex2((m[i] - cm) * LOG2E);
          z[i] *= alpha;
#pragma unroll
          for (int d = 0; d < DA; ++d) acc[i][d] *= alpha;
          m[i] = cm;
        }
        const float ml = (m[i] == -INFINITY ? 0.0f : m[i]) * LOG2E;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w[i][j] = ex2(fmaf(sc[i][j], LOG2E, -ml));
          z[i] += w[i][j];
          w[i][j] *= keep_b[(rb + rl + 4 * i) * lp + c + cl + 8 * j];
        }
      }
      accumulate<HD, DA>(acc, w, wb, kb + 2 * stage + c * HD, rl, cl);
    }
  }
  if (!live) return;

  // Merge the 8 column lanes of each row (their max, then their sums) and
  // write out and lse.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mm = m[i];
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, o));
    const float scale = ex2((m[i] - mm) * LOG2E);  // 1 at HD > 16; 0 for a lane without keys
    float zz = z[i] * scale;
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) zz += __shfl_xor_sync(0xffffffffu, zz, o);
    if constexpr (DA == HD) {  // the lanes' own scales, before their sums are folded
#pragma unroll
      for (int d = 0; d < DA; ++d) acc[i][d] *= scale;
    }
    const int r = i0 + rb + rl + 4 * i;
    const bool in = r < l;
    store_row<HD, DA>(out + (g * l + (in ? r : 0)) * hd, acc[i], 1.0f / zz, cl, hd, vec, in);
    if (in && cl == 0) lse[g * l + r] = mm + logf(zz);
  }
}

// The streamed dQ, and D. A CTA takes query rows [i0, i0 + ROWS) of one
// group, as the streamed forward, with their q and dO rows in shared memory,
// and streams keys 0 .. the tile's diagonal chunk in stages of `cols` (K, V
// and the keep rows, along keys). First each warp sums D_q = dO_q . out_q
// for its rows (a lane hd / 8 dims, then 3 shuffles) and writes it to dsum
// for the dK/dV kernel. Per pair s = q . k and dp = dO . v (scores),
// P = exp(s - lse_q), dS = P (dp keep - D_q), 0 above the diagonal; dQ += dS K
// as the forward's P keep V.
template <int HD>
__global__ void __launch_bounds__(stream::THREADS, HD == 128 ? 2 : 3)
train_attention_dq_stream_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ keep,
                                 const float* __restrict__ out, const float* __restrict__ lse,
                                 const float* __restrict__ dout, float* __restrict__ dq,
                                 float* __restrict__ dsum, int g_total, int l, int hd,
                                 int groups_per_pair, int cols, int vec_flag, int kvec_flag) {
  using namespace stream;
  constexpr int DA = HD > 16 ? HD / 8 : HD;
  extern __shared__ __align__(16) float smem[];
  const bool vec = vec_flag != 0, kvec = kvec_flag != 0;
  const int t = threadIdx.x, nts = blockDim.x;
  const Place pl = place(l, g_total, true);
  const int i0 = pl.r0, lp = cols + 8, stage = cols * HD;
  float* qs = smem;                       // [ROWS][HD]
  float* dos = qs + ROWS * HD;            // [ROWS][HD]
  float* ks = dos + ROWS * HD;            // [2][cols][HD]
  float* vs = ks + 2 * stage;             // [2][cols][HD]
  float* keep_s = vs + 2 * stage;         // [2][ROWS][cols + 8]
  float* wbuf = keep_s + 2 * ROWS * lp;   // [warps][8][WS] (HD > 16)
  const size_t g = pl.g, off = g * l * hd;
  const float* keep_p = keep + (g / groups_per_pair) * l * l;
  const int warp = t / 32, lane = t % 32, rl = lane >> 3, cl = lane & 7, rb = 8 * warp;
  const bool live = i0 + rb < l;
  const int kend = (i0 / CHUNK + 1) * CHUNK;
  const int n_stages = (kend + cols - 1) / cols;

  auto copy_stage = [&](int s) {
    const int kt = s * cols, nk = min(cols, kend - kt);
    float* kb = ks + (s & 1) * stage;
    fwd::copy_rows<HD>(kb, 0, k + off, kt, nk, l, hd, vec, t, nts);
    fwd::copy_rows<HD>(kb + 2 * stage, 0, v + off, kt, nk, l, hd, vec, t, nts);
    copy_keep(keep_s + (s & 1) * ROWS * lp, keep_p, i0, ROWS, kt, nk, l, lp, kvec, t, nts);
  };
  fwd::copy_rows<HD>(qs, 0, q + off, i0, ROWS, l, hd, vec, t, nts);
  fwd::copy_rows<HD>(dos, 0, dout + off, i0, ROWS, l, hd, vec, t, nts);
  copy_stage(0);

  // D_q and lse_q of the lane's rows (0 past L), D written for dK/dV.
  float lse_r[2], d_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i0 + rb + rl + 4 * i;
    const bool in = r < l;
    float part = 0.0f;
    if (in) {
      const float* dor = dout + (g * l + r) * hd;
      const float* outr = out + (g * l + r) * hd;
      for (int d = cl; d < hd; d += 8) part = fmaf(__ldg(dor + d), __ldg(outr + d), part);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    d_r[i] = part;
    lse_r[i] = in ? __ldg(lse + g * l + r) : 0.0f;
    if (in && cl == 0) dsum[g * l + r] = part;
  }

  float* wb = wbuf + warp * 8 * WS;
  float acc[2][DA];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int d = 0; d < DA; ++d) acc[i][d] = 0.0f;
  for (int s = 0; s < n_stages; ++s) {
    strip::copies_done();
    __syncthreads();
    if (s + 1 < n_stages) copy_stage(s + 1);
    if (!live) continue;
    const float* kb = ks + (s & 1) * stage;
    const float* keep_b = keep_s + (s & 1) * ROWS * lp;
    for (int c = 0; c < cols && s * cols + c < kend; c += CHUNK) {
      const int k0 = s * cols + c;
      float sc[2][4], dp[2][4], w[2][4];
      scores<HD>(sc, qs, rb + rl, kb + c * HD, cl);
      scores<HD>(dp, dos, rb + rl, kb + 2 * stage + c * HD, cl);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float kp = keep_b[(rb + rl + 4 * i) * lp + c + cl + 8 * j];
          const float ds = expf(sc[i][j] - lse_r[i]) * (dp[i][j] * kp - d_r[i]);
          const bool above = k0 + CHUNK > i0 && k0 + cl + 8 * j > i0 + rb + rl + 4 * i;
          w[i][j] = above ? 0.0f : ds;
        }
      accumulate<HD, DA>(acc, w, wb, kb + c * HD, rl, cl);
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i0 + rb + rl + 4 * i;
    store_row<HD, DA>(dq + (g * l + (r < l ? r : 0)) * hd, acc[i], 1.0f, cl, hd, vec, r < l);
  }
}

// The streamed dK and dV. A CTA takes keys [j0, j0 + ROWS) of one group
// (stream::place, the first key tiles first), with their K and V rows in
// shared memory, and streams query rows from the key tile's diagonal chunk
// to L in stages of `cols`: q and dO rows, lse and D (from the dQ kernel),
// and the pair's keep rows of the stage over the CTA's keys (a query row's
// keep along keys, never down a column). Warp w takes keys [j0 + 8 w, + 8),
// lane (r_l, c_l) keys r_l + 4 i and queries c_l + 8 j of each 32-query
// chunk: s = k . q and dp = v . dO (scores), P = exp(s - lse_q), P keep and
// dS = P (dp keep - D_q), 0 above the diagonal; dV += (P keep) dO and
// dK += dS Q as the forward's P keep V.
template <int HD>
__global__ void __launch_bounds__(stream::THREADS, 2)
train_attention_dkv_stream_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ keep,
                                  const float* __restrict__ lse, const float* __restrict__ dout,
                                  const float* __restrict__ dsum, float* __restrict__ dk,
                                  float* __restrict__ dv, int g_total, int l, int hd,
                                  int groups_per_pair, int cols, int vec_flag, int kvec_flag) {
  using namespace stream;
  constexpr int DA = HD > 16 ? HD / 8 : HD;
  constexpr int KS = ROWS + 4;  // floats a keep row of a stage: its query's keep of the CTA's keys
  extern __shared__ __align__(16) float smem[];
  const bool vec = vec_flag != 0, kvec = kvec_flag != 0;
  const int t = threadIdx.x, nts = blockDim.x;
  const Place pl = place(l, g_total, false);
  const int j0 = pl.r0, stage = cols * HD;
  float* ks = smem;                       // [ROWS][HD]
  float* vs = ks + ROWS * HD;             // [ROWS][HD]
  float* qs = vs + ROWS * HD;             // [2][cols][HD]
  float* dos = qs + 2 * stage;            // [2][cols][HD]
  float* lse_s = dos + 2 * stage;         // [2][cols]
  float* d_s = lse_s + 2 * cols;          // [2][cols]
  float* keep_s = d_s + 2 * cols;         // [2][cols][ROWS + 4]
  float* wbuf = keep_s + 2 * cols * KS;   // [warps][8][WS] (HD > 16)
  const size_t g = pl.g, off = g * l * hd;
  const float* keep_p = keep + (g / groups_per_pair) * l * l;
  const int warp = t / 32, lane = t % 32, rl = lane >> 3, cl = lane & 7, rb = 8 * warp;
  const bool live = j0 + rb < l;
  const int q0 = j0 / CHUNK * CHUNK;  // the diagonal chunk's first query
  const int qend = q0 + (l - q0 + CHUNK - 1) / CHUNK * CHUNK;
  const int n_stages = (qend - q0 + cols - 1) / cols;

  auto copy_stage = [&](int s) {
    const int qt = q0 + s * cols, nq = min(cols, qend - qt), b = s & 1;
    float* qb = qs + b * stage;
    fwd::copy_rows<HD>(qb, 0, q + off, qt, nq, l, hd, vec, t, nts);
    fwd::copy_rows<HD>(qb + 2 * stage, 0, dout + off, qt, nq, l, hd, vec, t, nts);
    copy_vec(lse_s + b * cols, lse + g * l, qt, nq, l, t, nts);
    copy_vec(d_s + b * cols, dsum + g * l, qt, nq, l, t, nts);
    copy_keep(keep_s + b * cols * KS, keep_p, qt, nq, j0, ROWS, l, KS, kvec, t, nts);
  };
  fwd::copy_rows<HD>(ks, 0, k + off, j0, ROWS, l, hd, vec, t, nts);
  fwd::copy_rows<HD>(vs, 0, v + off, j0, ROWS, l, hd, vec, t, nts);
  copy_stage(0);

  float* wb = wbuf + warp * 8 * WS;
  float dka[2][DA], dva[2][DA];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int d = 0; d < DA; ++d) dka[i][d] = dva[i][d] = 0.0f;
  for (int s = 0; s < n_stages; ++s) {
    strip::copies_done();
    __syncthreads();
    if (s + 1 < n_stages) copy_stage(s + 1);
    if (!live) continue;
    const int b = s & 1;
    const float* qb = qs + b * stage;
    const float* lse_b = lse_s + b * cols;
    const float* d_b = d_s + b * cols;
    const float* keep_b = keep_s + b * cols * KS;
    for (int c = 0; c < cols && q0 + s * cols + c < qend; c += CHUNK) {
      const int qc = q0 + s * cols + c;
      float sc[2][4], dp[2][4], pk[2][4], ds[2][4];
      scores<HD>(sc, ks, rb + rl, qb + c * HD, cl);
      scores<HD>(dp, vs, rb + rl, qb + 2 * stage + c * HD, cl);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = c + cl + 8 * j;
        const float lse_q = lse_b[qi], d_q = d_b[qi];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float kp = keep_b[qi * KS + rb + rl + 4 * i];
          const float p = expf(sc[i][j] - lse_q);
          const bool above = qc == q0 && qc + cl + 8 * j < j0 + rb + rl + 4 * i;
          pk[i][j] = above ? 0.0f : p * kp;
          ds[i][j] = above ? 0.0f : p * (dp[i][j] * kp - d_q);
        }
      }
      accumulate<HD, DA>(dva, pk, wb, qb + 2 * stage + c * HD, rl, cl);
      accumulate<HD, DA>(dka, ds, wb, qb + c * HD, rl, cl);
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = j0 + rb + rl + 4 * i;
    const size_t o = (g * l + (r < l ? r : 0)) * hd;
    store_row<HD, DA>(dk + o, dka[i], 1.0f, cl, hd, vec, r < l);
    store_row<HD, DA>(dv + o, dva[i], 1.0f, cl, hd, vec, r < l);
  }
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
  return g >= 1 && l >= 1 && hd >= 1 && hd <= 128 && n_pairs >= 1 && g % n_pairs == 0;
}

// The kernels that hold a group's rows in shared memory take the shape
// (the forward and the backward alike: at hd <= 32 a group of up to MAX_L
// rows fits a block's shared memory in strips of 16 rows); the streamed
// kernels take every other.
bool resident(int l, int hd) { return hd <= 32 && l <= MAX_L; }

// The strip backward's launch (hopper_train_attention.py:
// train_attention_bwd_launch_geometry): groups a CTA, strip rows, threads a
// group, dK/dV units a thread, shared bytes. Refused unless the kernel can
// run it: whole warps, at most MAX_THREADS a CTA, every (4 keys, 4 dims)
// unit of dK/dV owned, and the shared bytes those of the shape.
bool valid_bwd_geometry(int l, int hd, int groups, int tq, int nts, int nku, size_t smem) {
  const int hd_max = hd <= 16 ? 16 : 32;
  return (tq == 16 || tq == 32) && nts >= 32 && nts % 32 == 0 && groups >= 1 &&
         groups * nts <= strip::MAX_THREADS && (nku == 1 || nku == 2 || nku == 4) &&
         (size_t)nku * (nts / (hd_max / 4)) * 4 >= (size_t)l &&
         smem == sizeof(float) * groups * strip::group_floats(l, hd_max, tq) && smem <= MAX_SMEM;
}

// The strip forward's launch (hopper_train_attention.py:
// train_attention_fwd_launch_geometry): groups a CTA, strip rows, threads,
// shared bytes. Refused unless the kernel can run it: strips of 8, 16 or 32
// rows, a warp for each 8 rows of a strip and group, at most MAX_THREADS a
// CTA, and the shared bytes those of the shape.
bool valid_fwd_geometry(int l, int hd, int groups, int tq, int threads, size_t smem) {
  const int hd_max = hd <= 16 ? 16 : 32;
  return (tq == 8 || tq == 16 || tq == 32) && groups >= 1 && threads == 4 * groups * tq &&
         threads <= fwd::MAX_THREADS &&
         smem == sizeof(float) * fwd::smem_floats(l, hd_max, groups, tq) && smem <= MAX_SMEM;
}

// Rows of the streamed kernels' instances: hd padded to 16, 32, 64 or 128.
int stream_hd(int hd) { return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : 128; }

// A streamed kernel's launch (hopper_train_attention.py:
// train_attention_stream_launch_geometry; kind 0 the forward, 1 dQ, 2
// dK/dV): columns a stage, shared bytes. Refused unless the kernel can run
// it: stages of 32 or 64 columns, and the shared bytes those of the kind
// and hd.
bool valid_stream_geometry(int kind, int hd, int cols, size_t smem) {
  return (cols == 32 || cols == 64) &&
         smem == sizeof(float) * stream::cta_floats(kind, stream_hd(hd), cols) && smem <= MAX_SMEM;
}

// CTAs of a streamed kernel: ceil(L / ROWS) tiles of each group.
unsigned stream_ctas(int g, int l) {
  return (unsigned)((l + stream::ROWS - 1) / stream::ROWS) * g;
}

template <int HD>
int launch_fwd_stream(const void* q, const void* k, const void* v, const void* keep, void* out,
                      void* lse, int g, int l, int hd, int n_pairs, int cols, size_t smem,
                      cudaStream_t stream) {
  const int err = prepare(train_attention_fwd_stream_kernel<HD>, smem);
  if (err) return err;
  const uintptr_t bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out;
  const int vec = hd % 4 == 0 && bits % 16 == 0;
  const int kvec = l % 4 == 0 && (uintptr_t)keep % 16 == 0;
  train_attention_fwd_stream_kernel<HD><<<stream_ctas(g, l), stream::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(keep), static_cast<float*>(out), static_cast<float*>(lse), g, l,
      hd, g / n_pairs, cols, vec, kvec);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd_stream(const void* q, const void* k, const void* v, const void* keep,
                      const void* out, const void* lse, const void* dout, void* dq, void* dk,
                      void* dv, void* dsum, int g, int l, int hd, int n_pairs, int cols,
                      size_t smem, int kv_cols, size_t kv_smem, cudaStream_t stream) {
  int err = prepare(train_attention_dq_stream_kernel<HD>, smem);
  if (!err) err = prepare(train_attention_dkv_stream_kernel<HD>, kv_smem);
  if (err) return err;
  const uintptr_t bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out |
                         (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv;
  const int vec = hd % 4 == 0 && bits % 16 == 0;
  const int kvec = l % 4 == 0 && (uintptr_t)keep % 16 == 0;
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fkeep = static_cast<const float*>(keep);
  const float* flse = static_cast<const float*>(lse);
  const float* fdout = static_cast<const float*>(dout);
  float* fdsum = static_cast<float*>(dsum);
  train_attention_dq_stream_kernel<HD><<<stream_ctas(g, l), stream::THREADS, smem, stream>>>(
      fq, fk, fv, fkeep, static_cast<const float*>(out), flse, fdout, static_cast<float*>(dq),
      fdsum, g, l, hd, g / n_pairs, cols, vec, kvec);
  err = (int)cudaGetLastError();
  if (err) return err;
  train_attention_dkv_stream_kernel<HD><<<stream_ctas(g, l), stream::THREADS, kv_smem, stream>>>(
      fq, fk, fv, fkeep, flse, fdout, fdsum, static_cast<float*>(dk), static_cast<float*>(dv), g,
      l, hd, g / n_pairs, kv_cols, vec, kvec);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, const void* keep, void* out,
               void* lse, int g, int l, int hd, int n_pairs, int groups, int tq, int threads,
               size_t smem, cudaStream_t stream) {
  const int err = prepare(train_attention_fwd_kernel<HD>, smem);
  if (err) return err;
  const uintptr_t bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out;
  const int vec = hd % 4 == 0 && bits % 16 == 0;
  const int kvec = l % 4 == 0 && (uintptr_t)keep % 16 == 0;
  const int per_pair = g / n_pairs, ctas = n_pairs * ((per_pair + groups - 1) / groups);
  train_attention_fwd_kernel<HD><<<ctas, threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(keep), static_cast<float*>(out), static_cast<float*>(lse), l, hd,
      per_pair, groups, tq, vec, kvec);
  return (int)cudaGetLastError();
}

template <int HD, int NKU>
int launch_bwd(const void* q, const void* k, const void* v, const void* keep, const void* out,
               const void* lse, const void* dout, void* dq, void* dk, void* dv, int g, int l,
               int hd, int n_pairs, int groups, int tq, int nts, size_t smem,
               cudaStream_t stream) {
  const int err = prepare(train_attention_bwd_kernel<HD, NKU>, smem);
  if (err) return err;
  const uintptr_t bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out |
                         (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv;
  const int vec = hd % 4 == 0 && bits % 16 == 0;
  train_attention_bwd_kernel<HD, NKU><<<(g + groups - 1) / groups, groups * nts, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(keep), static_cast<const float*>(out),
      static_cast<const float*>(lse), static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), g, l, hd, g / n_pairs, tq, nts, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: (G, L, hd) f32; keep: (n_pairs, L, L) f32; out: (G, L, hd) f32;
// lse: (G, L) f32. n_pairs divides G. For the resident shapes (hd <= 32,
// L <= 512) only: the strip kernel with the launch geometry (groups a CTA,
// strip rows tq, threads a CTA, shared bytes smem), refused unless
// valid_fwd_geometry accepts it. Returns the first nonzero cudaError_t of
// the launch, else 0.
int train_attention_fwd(const void* q, const void* k, const void* v, const void* keep, void* out,
                        void* lse, int g, int l, int hd, int n_pairs, int groups, int tq,
                        int threads, size_t smem, void* stream) {
  if (!valid_shape(g, l, hd, n_pairs) || !resident(l, hd) ||
      !valid_fwd_geometry(l, hd, groups, tq, threads, smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd <= 16 ? launch_fwd<16>(q, k, v, keep, out, lse, g, l, hd, n_pairs, groups, tq, threads,
                                   smem, s)
                  : launch_fwd<32>(q, k, v, keep, out, lse, g, l, hd, n_pairs, groups, tq, threads,
                                   smem, s);
}

// As train_attention_fwd, plus its out and lse, dout (G, L, hd) f32 and the
// gradients dq, dk, dv (G, L, hd) f32; the strip kernel with the launch
// geometry (groups a CTA, strip rows tq, threads a group nts, dK/dV units a
// thread nku, shared bytes smem), refused unless valid_bwd_geometry
// accepts it.
int train_attention_bwd(const void* q, const void* k, const void* v, const void* keep,
                        const void* out, const void* lse, const void* dout, void* dq, void* dk,
                        void* dv, int g, int l, int hd, int n_pairs, int groups, int tq, int nts,
                        int nku, size_t smem, void* stream) {
  if (!valid_shape(g, l, hd, n_pairs) || !resident(l, hd) ||
      !valid_bwd_geometry(l, hd, groups, tq, nts, nku, smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD(HD, NKU)                                                                          \
  launch_bwd<HD, NKU>(q, k, v, keep, out, lse, dout, dq, dk, dv, g, l, hd, n_pairs, groups, tq, \
                      nts, smem, s)
  if (hd <= 16) {
    if (nku == 1) return BWD(16, 1);
    if (nku == 2) return BWD(16, 2);
  } else {
    if (nku == 1) return BWD(32, 1);
    if (nku == 2) return BWD(32, 2);
    if (nku == 4) return BWD(32, 4);
  }
#undef BWD
  return (int)cudaErrorInvalidValue;
}

// As train_attention_fwd, for every shape up to hd = 128 that the resident
// kernels do not take (L > 512 or hd > 32): the streamed forward with the
// launch geometry (keys a stage, shared bytes), refused unless
// valid_stream_geometry accepts it.
int train_attention_fwd_stream(const void* q, const void* k, const void* v, const void* keep,
                               void* out, void* lse, int g, int l, int hd, int n_pairs, int cols,
                               size_t smem, void* stream) {
  if (!valid_shape(g, l, hd, n_pairs) || resident(l, hd) ||
      !valid_stream_geometry(0, hd, cols, smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD(HD) launch_fwd_stream<HD>(q, k, v, keep, out, lse, g, l, hd, n_pairs, cols, smem, s)
  switch (stream_hd(hd)) {
    case 16: return FWD(16);
    case 32: return FWD(32);
    case 64: return FWD(64);
    default: return FWD(128);
  }
#undef FWD
}

// As train_attention_bwd, for the shapes of train_attention_fwd_stream: the
// streamed dQ kernel (keys a stage cols, shared bytes smem), which also
// writes D_q = dO_q . out_q to dsum, (G, L) f32 scratch, then the streamed
// dK/dV kernel (queries a stage kv_cols, kv_smem), each refused unless
// valid_stream_geometry accepts it.
int train_attention_bwd_stream(const void* q, const void* k, const void* v, const void* keep,
                               const void* out, const void* lse, const void* dout, void* dq,
                               void* dk, void* dv, void* dsum, int g, int l, int hd, int n_pairs,
                               int cols, size_t smem, int kv_cols, size_t kv_smem, void* stream) {
  if (!valid_shape(g, l, hd, n_pairs) || resident(l, hd) ||
      !valid_stream_geometry(1, hd, cols, smem) || !valid_stream_geometry(2, hd, kv_cols, kv_smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD(HD)                                                                              \
  launch_bwd_stream<HD>(q, k, v, keep, out, lse, dout, dq, dk, dv, dsum, g, l, hd, n_pairs, cols, \
                        smem, kv_cols, kv_smem, s)
  switch (stream_hd(hd)) {
    case 16: return BWD(16);
    case 32: return BWD(32);
    case 64: return BWD(64);
    default: return BWD(128);
  }
#undef BWD
}

}  // extern "C"
