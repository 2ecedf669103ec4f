// Flash attention, forward, fp32, on Hopper's CUDA cores (sm_90a), plain C
// interface.  Route "ffma" of the launcher flash.flash_fwd; bf16 goes to
// the tensor-core kernel of flash_fwd_sm90.cu (route "wgmma"), built into
// the same library.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention/flash.py:38 (wrapper `flash_attention`,
// flash.py:81).  It computes what that kernel computes — the chunked
// online-softmax recurrence of models/layers.py `causal_attention` — not
// how.  For q (B, Sq, H, hd) and k, v (B, Sk, KV, hd), per query row:
//
//     s     = (q · kᵀ, fp32 accumulation) · scale        scale after the dot
//     s     = −1e30 where causal and key k_pos is not visible to q_pos
//             (q_pos = q_offset + row; visible: k_pos ≤ q_pos and
//             q_pos − k_pos < window, see flash_mask.cuh)
//     m_new = max(m, rowmax(s));  p = exp(s − m_new);  corr = exp(m − m_new)
//     l     = l·corr + Σ p                               (fp32 p)
//     acc   = acc·corr + round_to_v_dtype(p) · v         (fp32 accumulation)
//     o     = acc / max(l, 1e−30), cast to q's dtype
//
// with m = −1e30, l = 0, acc = 0 at the start and key tiles taken in order.
//
// Bound on this card: 4·hd fp32 FLOPs and one exp per visible (q, k) pair,
// on q, k, v and o read or written once.  Every FLOP is an FFMA on the CUDA
// cores (132 SMs × 128 lanes, 66.9 TFLOP/s at 1,980 MHz): 2·hd FFMA per pair
// (32 at hd 16, 128 at hd 64), far above the bytes.  One SM sub-partition
// issues one warp instruction a clock, and the SM's shared-memory pipe
// serves one 16-byte warp-wide load in 2 clocks when neighbouring lanes
// (2k, 2k + 1) read one address and in 4 otherwise, broadcast or not
// (scripts/smem_load_cycles.py), against 4 FFMA a clock for the SM.  So
// the kernel approaches the bound only if nearly every instruction it issues
// is an FFMA of q·kᵀ or P·V and each shared load feeds many of them:
//
//  * Warps own rows.  A CTA of 4 warps takes 64 query rows of one (batch,
//    head), 16 a warp; each warp computes its rows' scores, softmax and
//    output and exchanges P only within itself (__syncwarp, no CTA
//    barrier).  Query blocks are taken heaviest first (blockIdx.x
//    reversed), so the long causal rows start early.
//  * Register tiles.  In Q·Kᵀ a lane holds 4 rows × SN keys of the warp's
//    score tile (SN = 8 at BK = 64, 4 at BK = 32) and reads 4 + SN float4
//    of Q and K a 4-deep k-step.  In P·V it holds OM rows × ON columns of
//    O (ON in 16-byte runs) and reads, per 4 keys, OM float4 of P and ON
//    float4 of V.  Lanes are ordered so that neighbours share the operand
//    read most often, a K row in Q·Kᵀ and a V run in P·V (2 clocks a load,
//    not 4); the lanes that share a score row hold keys KG apart, so the
//    reads are conflict-free (pitches hd + 4).  A lane stores its P as
//    float4 in slot order and V's rows are placed in that order as they are
//    copied, so P·V walks slots with no index math.  OM × ON is 4 × 8 at
//    hd 64, 8 × 8 at hd 128.  At hd 128 a 32-key tile leaves a lane only 4
//    keys, so two lanes split Q·Kᵀ's k range and each holds 8 keys' partial
//    sums (each K read feeds 16 FFMA, not 8); one shuffle a score then gives
//    each lane its 4 keys' totals.
//  * hd 16 (SPLIT): a row's output is only 16 columns, too narrow for an
//    output tile, so P never leaves the registers of the lane that computed
//    it: each lane runs P·V over its own SN keys into a partial O of its 4
//    rows × 16 columns (each V float4 read feeds 16 FFMA), with its query
//    rows in registers as well, and the KG lanes of a row add their partial
//    O once, at the end of the walk, by shuffles.
//  * Masks only where a tile needs one.  A key tile in which every row of
//    the warp sees every key (tile_needs_mask in flash_mask.cuh) takes no
//    per-element test; the diagonal, window-edge and ragged-Sk tiles do.
//    Key tiles wholly after the block's last position, or wholly before its
//    first row's window, are not walked (key_tiles).  A hidden key's raw
//    score becomes MASKED = −2^99, keys past Sk −inf (no weight).  MASKED
//    is the reference's −1e30 in effect: a power of two, so its scaled
//    score MASKED·c is exact, a row whose every score so far is hidden has
//    p = 2^(MASKED·c − MASKED·c) = 1, as the reference's −1e30 gives it,
//    and the row's first visible key then wipes that with corr = 0; a row
//    that sees no key ends with the mean of v.  Rows past Sq are not
//    stored.  No shape has to divide a tile.
//  * exp2 with the folded scale.  The running max is kept in log2 units of
//    the scaled score: m = max(m, rowmax(raw)·c) with c = scale·log2(e), and
//    p = ex2(raw·c − m) is one FFMA and one MUFU per score (p moves by a
//    few fp32 ulps against exp of the scaled score).  Row maxima reduce
//    across the KG lanes of a row by shuffles once a tile; l stays a
//    per-lane partial sum, rescaled by the row's common factor, until the
//    epilogue.  acc is rescaled in place (O·corr) before the tile's P·V.
//  * Asynchronous copies.  Q once, then K and V tiles of BK keys, come by
//    cp.async (16 bytes, .cg, L2 only) into a ring of STAGES = 2 stages;
//    keys past Sk and rows past Sq are zero-filled by the copy's source
//    size.  A thread copies the same chunks of every tile (only the tile's
//    base moves).  The next tile's copy is in flight during this tile's
//    math, and a tile costs one CTA barrier: after it, tile i has landed
//    for every thread and every warp is past tile i − 1, whose stage the
//    copy of tile i + 1 then reuses.
//  * GQA by indexing: query head h reads kv head h / (H / KV), which is
//    what the reference's jnp.repeat(k, groups, axis=2) holds, with no
//    expanded copy.
//  * p enters l and the P·V product in fp32 (v's dtype), as both reference
//    functions do.  Every product is IEEE fp32 FFMA with one fixed order of
//    sums per entry; nothing runs in TF32.
//  * hd ∈ {16, 32, 48, 64, 80, 96, 128, 160, 192, 256} as template
//    instances (the models' 16, 64, 80 and 128 among them); the launcher
//    zero-pads any other hd ≤ 256 to the next instance, which adds exactly
//    0 to every q·k and gives zero output columns, and keeps the true hd's
//    scale.  Shape<HD> sizes each: BK = 64 up to hd 64, 32 above (two
//    stages of K and V, Q and P then fit two CTAs on an SM up to hd 128;
//    from hd 160 one), at most 255 registers a thread and no spills.
//
// It stays on the CUDA cores because Hopper's tensor cores take no fp32
// operands, and TF32 would round q, k, v and p to 10-bit mantissas, against
// the reference's fp32 contract.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "flash_mask.cuh"

namespace {

constexpr int STAGES = 2;              // K/V ring stages
constexpr int W = 4;                   // warps a CTA
constexpr int WR = 16;                 // query rows a warp: the CTA's block is W·WR = 64
constexpr int SM = 4;                  // score rows a lane
constexpr float MASKED = -0x1p99f;     // a hidden key's raw score (see the header)
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// Per head dim: BK keys per tile, OM output rows per lane, DS lanes that
// split Q·Kᵀ's k range (each then holds DS times the keys), and SPLIT: P·V
// split by keys among the lanes of a row, each on its own p in registers,
// with its query rows in registers too.
template <int HD>
struct Shape {
  static constexpr int BK = HD <= 64 ? 64 : 32, DS = HD == 128 ? 2 : 1;
  static constexpr int OM = HD % 32 ? 2 : HD % 64 == 0 && HD >= 128 ? 8 : 4;
  static constexpr bool SPLIT = HD == 16;
};

template <int HD>
struct Tile : Shape<HD> {
  using S = Shape<HD>;
  static constexpr int THREADS = 32 * W;
  static constexpr int BQ = W * WR;          // query rows per CTA
  static constexpr int RGS = WR / SM;        // row groups of a warp's score tile
  static constexpr int KG = 32 / RGS;        // lanes that share a score row: its key groups
  static constexpr int SN = S::BK / KG;      // keys per lane: kg + KG·j
  static constexpr int KGS = KG / S::DS;     // key groups in Q·Kᵀ: keys kg % KGS + KGS·j, SN·DS of them
  // The output tile: with SPLIT a lane's own SM rows × all HD columns (a
  // partial sum over its keys); else OM rows × ON columns of the row's total.
  static constexpr int OMR = S::SPLIT ? SM : S::OM;
  static constexpr int RGO = WR / OMR;       // row groups of a warp's output tile
  static constexpr int CG = 32 / RGO;        // lanes that share an output row: its column groups
  static constexpr int ON = S::SPLIT ? HD : HD / CG;  // columns per lane: 4·cg + 4·CG·c + e
  static constexpr int QP = HD + 4;          // Q and K pitch (floats): conflict-free row reads
  static constexpr int VP = S::SPLIT ? HD + 4 : HD;  // V pitch (SPLIT reads a row per key group)
  static constexpr int PP = S::BK + 4;       // P pitch
  static constexpr int STAGE = S::BK * (QP + VP);  // floats of one ring stage: K, then V
  static constexpr int WARP_BUF = S::SPLIT ? 0 : WR * (PP + 2);  // a warp's P, its rows' corr, then l
  static constexpr int SMEM = static_cast<int>(sizeof(float)) * (BQ * QP + STAGES * STAGE + W * WARP_BUF);
  static_assert(WR % SM == 0 && 32 % RGS == 0 && KG <= 8 && S::BK % KG == 0 && SN % 4 == 0, "score tile");
  static_assert(KG % S::DS == 0 && HD % (4 * S::DS) == 0 && (S::DS == 1 || !S::SPLIT), "split k range");
  static_assert(S::SPLIT || (WR % S::OM == 0 && 32 % RGO == 0 && RGO <= 8 && HD % (4 * CG) == 0), "output tile");
  static_assert(SMEM <= 232448, "shared memory");
  // V's row for tile key r: in key order with SPLIT, else the slot at which
  // its key group stores p.
  __device__ static constexpr int slot(int r) { return S::SPLIT ? r : (r % KG) * SN + r / KG; }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p of a raw score s: the running max m is in log2 units of the scaled
// score, so the scale, log2(e) and the max cost one FFMA ahead of ex2.
__device__ __forceinline__ float score_exp(float s, float c, float m) { return ex2(fmaf(s, c, -m)); }

// The per-element mask of an edge tile: keys past Sk get −inf, keys the
// causal mask hides MASKED.  Lane (rg, kg) holds rows rg + RGS·i at
// positions pos0 + RGS·i and keys k0 + kg + KG·j.
template <int SM, int SN, int RGS, int KG>
__device__ __forceinline__ void mask_scores(float (&s)[SM][SN], int k0, int pos0, int Sk, int causal,
                                            int window) {
#pragma unroll
  for (int i = 0; i < SM; ++i)
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      const int key = k0 + KG * j;
      if (key >= Sk) s[i][j] = -CUDART_INF_F;
      else if (causal && !visible(pos0 + RGS * i, key, window)) s[i][j] = MASKED;
    }
}

template <int HD>
__global__ void __launch_bounds__(Tile<HD>::THREADS, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 float* __restrict__ o, int Sq, int Sk, int H, int KV, float scale, int causal,
                 int q_offset, int window) {
  using T = Tile<HD>;
  constexpr bool SPLIT = T::SPLIT;
  constexpr int BK = T::BK, SN = T::SN, OM = T::OMR, ON = T::ON;
  constexpr int RGS = T::RGS, KG = T::KG, RGO = T::RGO, CG = T::CG, DS = T::DS, KGS = T::KGS;
  constexpr int QP = T::QP, VP = T::VP, PP = T::PP, CPR = HD / 4;  // 16-byte chunks a row
  extern __shared__ float4 smem4[];
  float* const Qs = reinterpret_cast<float*>(smem4);
  float* const ring = Qs + T::BQ * QP;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // Adjacent lanes share the operand each product reads most often, a K row
  // in Q·Kᵀ and a V run in P·V: a 16-byte shared load that two neighbouring
  // lanes share takes 2 cycles of the SM's shared-memory pipe, else 4.
  const int rg = lane % RGS, kg = lane / RGS;  // score tile: rows rg + RGS·i, keys kg + KG·j
  const int ro = lane % RGO, cg = lane / RGO;  // output tile: rows ro + RGO·i, columns 4·cg + 4·CG·c
  float* const Ps = ring + STAGES * T::STAGE + warp * T::WARP_BUF;  // this warp's P [WR][PP]
  float* const Cs = Ps + WR * PP;  // its rows' corr this tile [WR], then their l [WR]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * T::BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int w0 = q0 + warp * WR;                       // this warp's first row
  const int pos_lo = q_offset + w0;                    // its position
  const int pos_hi = q_offset + min(w0 + WR, Sq) - 1;  // its last stored row's

  const long long q_stride = (long long)H * HD;
  const long long kv_stride = (long long)KV * HD;
  const float* qb = q + ((long long)b * Sq * H + h) * HD;
  const float* kb = k + ((long long)b * Sk * KV + kvh) * HD;
  const float* vb = v + ((long long)b * Sk * KV + kvh) * HD;

  for (int idx = tid; idx < T::BQ * CPR; idx += T::THREADS) {  // Q, rows past Sq zero
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = q0 + r < Sq;
    cp_async16(Qs + r * QP + 4 * c, ok ? qb + (long long)(q0 + r) * q_stride + 4 * c : qb, ok);
  }
  cp_async_commit();
  // A thread's share of a K/V tile copy: where its rows' chunks divide the
  // CTA, chunk c0 of rows r0, r0 + RPP, … every tile, so only the tile's
  // base moves (hd 16, 32, 64, 128, 256); else chunk idx of the flat tile.
  constexpr int RPP = T::THREADS % CPR == 0 ? T::THREADS / CPR : 0;  // rows one pass of the CTA copies
  static_assert(RPP == 0 || BK % RPP == 0, "copy passes");
  const int r0 = tid / CPR, c0 = tid % CPR;
  const long long src0 = (long long)r0 * kv_stride + 4 * c0;
  auto copy_kv = [&](int kt, int stage) {  // K and V of key tile kt, keys past Sk zero
    float* Ks = ring + stage * T::STAGE;
    float* Vs = Ks + BK * QP;
    if constexpr (RPP > 0) {
      const int key0 = kt * BK + r0;
      const float* ks = kb + (long long)kt * BK * kv_stride + src0;
      const float* vs = vb + (long long)kt * BK * kv_stride + src0;
#pragma unroll
      for (int pass = 0; pass < BK / RPP; ++pass) {
        const bool ok = key0 + pass * RPP < Sk;
        const long long off = pass * RPP * kv_stride;
        cp_async16(Ks + (r0 + pass * RPP) * QP + 4 * c0, ok ? ks + off : kb, ok);
        cp_async16(Vs + T::slot(r0 + pass * RPP) * VP + 4 * c0, ok ? vs + off : vb, ok);
      }
    } else {
      for (int idx = tid; idx < BK * CPR; idx += T::THREADS) {
        const int r = idx / CPR, c = idx % CPR;
        const int key = kt * BK + r;
        const bool ok = key < Sk;
        const long long off = ok ? (long long)key * kv_stride + 4 * c : 0;
        cp_async16(Ks + r * QP + 4 * c, kb + off, ok);
        cp_async16(Vs + T::slot(r) * VP + 4 * c, vb + off, ok);
      }
    }
  };

  const KeyTiles tiles = key_tiles(q0, T::BQ, Sq, Sk, BK, q_offset, window, causal);
  if constexpr (STAGES > 1) {
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < tiles.count) copy_kv(tiles.first + st, st);
      cp_async_commit();
    }
  }
  // With SPLIT a lane holds its SM query rows in registers for the walk.
  float qv[SPLIT ? SM : 1][SPLIT ? HD : 4];
  if constexpr (SPLIT) {
    cp_async_wait<STAGES - 1>();  // Q's group; the K/V groups after it may still fly
    __syncthreads();
#pragma unroll
    for (int i2 = 0; i2 < SM; ++i2)
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 x = *reinterpret_cast<const float4*>(Qs + (warp * WR + rg + RGS * i2) * QP + d);
        qv[i2][d] = x.x, qv[i2][d + 1] = x.y, qv[i2][d + 2] = x.z, qv[i2][d + 3] = x.w;
      }
  }

  const float c = scale * LOG2E;
  float m[SM], l[SM], acc[OM][ON];
#pragma unroll
  for (int i = 0; i < SM; ++i) {
    m[i] = -CUDART_INF_F;  // the first tile's corr is 0
    l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < OM; ++i)
#pragma unroll
    for (int cc = 0; cc < ON; ++cc) acc[i][cc] = 0.f;

  // The ring stage of walk step i: K, then V.
  auto stage_of = [&](int i) -> const float* { return ring + (i % STAGES) * T::STAGE; };

  // S = Q·Kᵀ for this lane's SM rows × SN keys of the tile at Ks, k
  // ascending.  With DS = 2 the two lanes whose key groups differ by KGS
  // take one half of k each over SN·2 keys (KGS apart), so each K read feeds
  // twice the FFMA; then each keeps the keys of its own parity (kg + KG·j)
  // and adds the other half's partial sum for them, one shuffle a score.
  auto scores = [&](float (&s)[SM][SN], const float* Ks) {
    constexpr int SNS = SN * DS, HDS = HD / DS;
    const int dh = kg / KGS;  // this lane's half of k
    float part[SM][SNS];
#pragma unroll
    for (int i2 = 0; i2 < SM; ++i2)
#pragma unroll
      for (int j = 0; j < SNS; ++j) part[i2][j] = 0.f;
    const float* qr = Qs + (warp * WR + rg) * QP + dh * HDS;
    const float* kr = Ks + (kg % KGS) * QP + dh * HDS;
#pragma unroll 4
    for (int d = 0; d < HDS; d += 4) {
      float4 a[SM], bk[SNS];
#pragma unroll
      for (int i2 = 0; i2 < SM; ++i2) {
        if constexpr (SPLIT) a[i2] = make_float4(qv[i2][d], qv[i2][d + 1], qv[i2][d + 2], qv[i2][d + 3]);
        else a[i2] = *reinterpret_cast<const float4*>(qr + RGS * i2 * QP + d);
      }
#pragma unroll
      for (int j = 0; j < SNS; ++j) bk[j] = *reinterpret_cast<const float4*>(kr + KGS * j * QP + d);
#pragma unroll
      for (int i2 = 0; i2 < SM; ++i2)
#pragma unroll
        for (int j = 0; j < SNS; ++j) {
          part[i2][j] = fmaf(a[i2].x, bk[j].x, part[i2][j]);
          part[i2][j] = fmaf(a[i2].y, bk[j].y, part[i2][j]);
          part[i2][j] = fmaf(a[i2].z, bk[j].z, part[i2][j]);
          part[i2][j] = fmaf(a[i2].w, bk[j].w, part[i2][j]);
        }
    }
#pragma unroll
    for (int i2 = 0; i2 < SM; ++i2)
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        if constexpr (DS == 1) {
          s[i2][j] = part[i2][j];
        } else {
          const float mine = dh ? part[i2][2 * j + 1] : part[i2][2 * j];
          const float theirs = dh ? part[i2][2 * j] : part[i2][2 * j + 1];
          s[i2][j] = mine + __shfl_xor_sync(FULL, theirs, RGS * KGS);
        }
      }
  };

  // The per-element mask, on the tiles of walk step i that need one.
  auto mask_tile = [&](float (&s)[SM][SN], int i) {
    const int k0 = (tiles.first + i) * BK;
    const bool edge = tile_needs_mask(k0, BK, pos_lo, pos_hi, Sk, window, causal);
    if (edge) mask_scores<SM, SN, RGS, KG>(s, k0 + kg, pos_lo + rg, Sk, causal, window);
  };

  // Online softmax: p overwrites s (and, without SPLIT, goes to the warp's
  // P buffer); cr gets each row's corr.
  auto softmax = [&](float (&s)[SM][SN], float (&cr)[SM]) {
#pragma unroll
    for (int i2 = 0; i2 < SM; ++i2) {
      float mx = s[i2][0];
#pragma unroll
      for (int j = 1; j < SN; ++j) mx = fmaxf(mx, s[i2][j]);
#pragma unroll
      for (int off = 16; off >= RGS; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i2], mx * c);
      const float corr = ex2(m[i2] - m_new);
      m[i2] = m_new;
      cr[i2] = corr;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        s[i2][j] = score_exp(s[i2][j], c, m_new);
        sum += s[i2][j];
      }
      l[i2] = l[i2] * corr + sum;  // this lane's keys; the KG lanes of the row add up at the end
      if constexpr (!SPLIT) {
        float* prow = Ps + (rg + RGS * i2) * PP + kg * SN;
#pragma unroll
        for (int j = 0; j < SN; j += 4)
          *reinterpret_cast<float4*>(prow + j) =
              make_float4(s[i2][j], s[i2][j + 1], s[i2][j + 2], s[i2][j + 3]);
        if (kg == 0) Cs[rg + RGS * i2] = corr;
      }
    }
  };

  // O = O·corr + P·V with the tile's V at Vs, keys (SPLIT: this lane's) or slots ascending.
  auto pv = [&](const float (&s)[SM][SN], const float (&cr)[SM], const float* Vs) {
    if constexpr (!SPLIT) __syncwarp();
#pragma unroll
    for (int i2 = 0; i2 < OM; ++i2) {
      float f;
      if constexpr (SPLIT) f = cr[i2 % SM];
      else f = Cs[ro + RGO * i2];
#pragma unroll
      for (int cc = 0; cc < ON; ++cc) acc[i2][cc] *= f;
    }
    if constexpr (SPLIT) {
      const float* vr = Vs + kg * VP;
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int cc = 0; cc < ON; cc += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + KG * j * VP + cc);
#pragma unroll
          for (int i2 = 0; i2 < OM; ++i2) {
            const float p = s[i2 % SM][j];
            acc[i2][cc] = fmaf(p, vv.x, acc[i2][cc]);
            acc[i2][cc + 1] = fmaf(p, vv.y, acc[i2][cc + 1]);
            acc[i2][cc + 2] = fmaf(p, vv.z, acc[i2][cc + 2]);
            acc[i2][cc + 3] = fmaf(p, vv.w, acc[i2][cc + 3]);
          }
        }
    } else {
      const float* pr = Ps + ro * PP;
      const float* vr = Vs + 4 * cg;
#pragma unroll 2
      for (int t = 0; t < BK; t += 4) {
        float4 pp[OM];
#pragma unroll
        for (int i2 = 0; i2 < OM; ++i2) pp[i2] = *reinterpret_cast<const float4*>(pr + RGO * i2 * PP + t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float4 vv[ON / 4];
#pragma unroll
          for (int cc = 0; cc < ON / 4; ++cc)
            vv[cc] = *reinterpret_cast<const float4*>(vr + (t + e) * VP + 4 * CG * cc);
#pragma unroll
          for (int i2 = 0; i2 < OM; ++i2) {
            const float p = e == 0 ? pp[i2].x : e == 1 ? pp[i2].y : e == 2 ? pp[i2].z : pp[i2].w;
#pragma unroll
            for (int cc = 0; cc < ON / 4; ++cc) {
              acc[i2][4 * cc] = fmaf(p, vv[cc].x, acc[i2][4 * cc]);
              acc[i2][4 * cc + 1] = fmaf(p, vv[cc].y, acc[i2][4 * cc + 1]);
              acc[i2][4 * cc + 2] = fmaf(p, vv[cc].z, acc[i2][4 * cc + 2]);
              acc[i2][4 * cc + 3] = fmaf(p, vv[cc].w, acc[i2][4 * cc + 3]);
            }
          }
        }
      }
    }
  };

  for (int i = 0; i < tiles.count; ++i) {
    if constexpr (STAGES == 1) {  // synchronous: the copy waits for the previous tile's reads
      __syncthreads();
      copy_kv(tiles.first + i, 0);
      cp_async_commit();
    }
    cp_async_wait<STAGES == 1 ? 0 : STAGES - 2>();
    __syncthreads();  // tile i is in for every thread; every warp is past tile i − 1
    if constexpr (STAGES > 1) {
      if (i + STAGES - 1 < tiles.count) copy_kv(tiles.first + i + STAGES - 1, (i + STAGES - 1) % STAGES);
      cp_async_commit();  // an empty group keeps the count uniform
    }
    float s[SM][SN], cr[SM];
    scores(s, stage_of(i));
    mask_tile(s, i);
    softmax(s, cr);
    pv(s, cr, stage_of(i) + BK * QP);
  }
  cp_async_wait_all();  // no copy may outlive the block

  // l (and with SPLIT the partial O): the KG lanes of each row add theirs up.
#pragma unroll
  for (int i2 = 0; i2 < SM; ++i2) {
#pragma unroll
    for (int off = 16; off >= RGS; off >>= 1) l[i2] += __shfl_xor_sync(FULL, l[i2], off);
    if constexpr (!SPLIT) {
      if (kg == 0) Cs[WR + rg + RGS * i2] = l[i2];
    }
  }
  if constexpr (SPLIT) {
#pragma unroll
    for (int i2 = 0; i2 < OM; ++i2)
#pragma unroll
      for (int cc = 0; cc < ON; ++cc)
#pragma unroll
        for (int off = 16; off >= RGS; off >>= 1) acc[i2][cc] += __shfl_xor_sync(FULL, acc[i2][cc], off);
  } else {
    __syncwarp();
  }
  // Each output run is stored once: with SPLIT by one of the row's KG lanes.
#pragma unroll
  for (int i2 = 0; i2 < OM; ++i2) {
    const int row = w0 + ro + RGO * i2;
    if (row >= Sq) continue;
    const float denom = fmaxf(SPLIT ? l[i2 % SM] : Cs[WR + ro + RGO * i2], 1e-30f);
    float* orow = o + (((long long)b * Sq + row) * H + h) * HD + (SPLIT ? 0 : 4 * cg);
#pragma unroll
    for (int cc = 0; cc < ON / 4; ++cc) {
      if (SPLIT && (i2 * (ON / 4) + cc) % KG != kg) continue;
      *reinterpret_cast<float4*>(orow + (SPLIT ? 4 * cc : 4 * CG * cc)) =
          make_float4(acc[i2][4 * cc] / denom, acc[i2][4 * cc + 1] / denom, acc[i2][4 * cc + 2] / denom,
                      acc[i2][4 * cc + 3] / denom);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H, int KV,
           float scale, int causal, int q_offset, int window, cudaStream_t stream) {
  using T = Tile<HD>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + T::BQ - 1) / T::BQ, B * H);
  flash_fwd_kernel<HD><<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Sk, H, KV, scale, causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one fp32 forward pass on `stream`.  q, o: (B, Sq, H, hd); k, v:
// (B, Sk, KV, hd); all contiguous and 16-byte aligned; KV divides H;
// Sk ≥ 1; B·H ≤ 65535.  scale is the reference's 1/√hd of the true head
// dim, rounded to fp32; q_offset is row 0's position and window the sliding
// window (INT_MAX for none), both of the causal mask.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an hd that
// is not an instance).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                         int Sk, int H, int KV, int hd, float scale, int causal, int q_offset,
                         int window, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_FWD_CASE(HD) \
  case HD: return launch<HD>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal, q_offset, window, s);
  switch (hd) {
    FLASH_FWD_CASE(16)
    FLASH_FWD_CASE(32)
    FLASH_FWD_CASE(48)
    FLASH_FWD_CASE(64)
    FLASH_FWD_CASE(80)
    FLASH_FWD_CASE(96)
    FLASH_FWD_CASE(128)
    FLASH_FWD_CASE(160)
    FLASH_FWD_CASE(192)
    FLASH_FWD_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_FWD_CASE
}
