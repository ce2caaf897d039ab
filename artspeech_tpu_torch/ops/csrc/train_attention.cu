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
// The wide instances. Above hd = 32 the rows no longer fit a thread's
// registers, and above L = MAX_L (the longest default bucket) a group no
// longer fits a block's shared memory; hd up to 128 and every L take the
// wide kernels, which give a row to a warp instead of a thread: lane l holds
// elements l, l + 32, ... of the warp's row (NPL = ceil(hd / 32) of them,
// rounded up to 1, 2 or 4; every element at or past hd is zero, so at
// hd < 32 the idle lanes add zeros to each sum), each dot product is a
// butterfly of shuffles over all 32 lanes (every lane ends with the same
// sum, so all lanes take the same softmax steps), and the other side's rows
// are read from global memory by the warp in coalesced spans (they stay in
// L1 and L2: a group's K and V at L = 512, hd = 128 are 512 KiB). No shared
// memory, and no state that grows with L but the backward's (G, L) D
// scratch, which the wrapper allocates. The loader's buckets past 512 (the
// longest sentence rounded up to 64, data/batching.py) come here at the
// transformer's hd = 16.
// - forward: a warp a query row, keys 0..q in order, the same online
//   softmax as above; four warps a block;
// - backward, two launches: dQ a warp a query row (it also writes
//   D_q = dO_q . out_q into a (G, L) scratch), then dK and dV a warp a key
//   row over queries L-1 down to k, reading D from the scratch.

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
  return g >= 1 && l >= 1 && hd >= 1 && hd <= 128 && n_pairs >= 1 && g % n_pairs == 0;
}

// The kernels that hold rows in registers and shared memory take the shape
// (the forward and the backward alike: at hd <= 32 a group of up to MAX_L
// rows fits a block's shared memory in strips of 16 rows); the wide kernels
// take every other.
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
// lse: (G, L) f32. 1 <= L, 1 <= hd <= 128, n_pairs divides G. Where
// resident (hd <= 32, L <= 512) the strip kernel runs with the launch geometry (groups
// a CTA, strip rows tq, threads a CTA, shared bytes smem), refused unless
// valid_fwd_geometry accepts it; else the wide kernel, and the geometry is
// not read. Returns the first nonzero cudaError_t of the launch, else 0.
int train_attention_fwd(const void* q, const void* k, const void* v, const void* keep, void* out,
                        void* lse, int g, int l, int hd, int n_pairs, int groups, int tq,
                        int threads, size_t smem, void* stream) {
  if (!valid_shape(g, l, hd, n_pairs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (resident(l, hd)) {
    if (!valid_fwd_geometry(l, hd, groups, tq, threads, smem)) return (int)cudaErrorInvalidValue;
    return hd <= 16 ? launch_fwd<16>(q, k, v, keep, out, lse, g, l, hd, n_pairs, groups, tq,
                                     threads, smem, s)
                    : launch_fwd<32>(q, k, v, keep, out, lse, g, l, hd, n_pairs, groups, tq,
                                     threads, smem, s);
  }
  // The wide forward: hd > 32 at any L, or any hd past MAX_L.
  if (hd <= 32) return launch_fwd_wide<1>(q, k, v, keep, out, lse, g, l, hd, n_pairs, s);
  if (hd <= 64) return launch_fwd_wide<2>(q, k, v, keep, out, lse, g, l, hd, n_pairs, s);
  return launch_fwd_wide<4>(q, k, v, keep, out, lse, g, l, hd, n_pairs, s);
}

// As train_attention_fwd, plus its out and lse, dout (G, L, hd) f32 and the
// gradients dq, dk, dv (G, L, hd) f32. Where resident the strip kernel runs
// with the launch geometry (groups a CTA, strip rows tq, threads a group
// nts, dK/dV units a thread nku, shared bytes smem) and dsum is not read;
// else the wide kernels, with dsum (G, L) f32 scratch for D_q = dO_q . out_q,
// and the geometry is not read.
int train_attention_bwd(const void* q, const void* k, const void* v, const void* keep,
                        const void* out, const void* lse, const void* dout, void* dq, void* dk,
                        void* dv, void* dsum, int g, int l, int hd, int n_pairs, int groups,
                        int tq, int nts, int nku, size_t smem, void* stream) {
  if (!valid_shape(g, l, hd, n_pairs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (resident(l, hd)) {
    if (!valid_bwd_geometry(l, hd, groups, tq, nts, nku, smem)) return (int)cudaErrorInvalidValue;
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
  if (hd <= 32)
    return launch_bwd_wide<1>(q, k, v, keep, out, lse, dout, dq, dk, dv, dsum, g, l, hd, n_pairs,
                              s);
  if (hd <= 64)
    return launch_bwd_wide<2>(q, k, v, keep, out, lse, dout, dq, dk, dv, dsum, g, l, hd, n_pairs,
                              s);
  return launch_bwd_wide<4>(q, k, v, keep, out, lse, dout, dq, dk, dv, dsum, g, l, hd, n_pairs,
                            s);
}

}  // extern "C"
