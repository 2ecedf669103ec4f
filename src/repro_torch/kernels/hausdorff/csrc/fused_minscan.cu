// Fused min-d² scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_fused_kernel` in
// src/repro/kernels/hausdorff/hausdorff.py:89 (launcher
// `fused_min_sqdists_pallas`, hausdorff.py:145).  It computes what that
// kernel computes, not how: for a (n_a, D) and b (n_b, D), every entry
//
//     d²(i, j) = max((a2[i] − 2·a_i·b_j) + b2[j], 0)
//
// is folded into the row mins  min_a[i] = min_j d²(i, j)  (A→B) and, in
// the bidirectional instance, the column mins  min_b[j] = min_i d²(i, j)
// (B→A), in one pass.  a2 / b2 are the hoisted squared norms with +inf at
// invalid rows (whose data the wrapper has zeroed), so invalid rows win
// neither min.
//
// Arithmetic (fixed; the bits of every entry are those of kernels 2 and 3,
// which share the streamed instance's tile body, csrc/minscan_tile.cuh):
// each dot product is one fmaf chain over k = 0..D−1 in order, from +0, in
// IEEE fp32 on the CUDA cores; the epilogue is (a2 − 2·acc) + b2, clamped
// by `v > 0 ? v : 0` (never fmaxf, so −0.0 cannot reach a fold); folds are
// atomicMin on the fp32 bits as unsigned int into outputs the wrapper set
// to +inf (for d² ≥ 0 the unsigned order is the float order, so the fold
// is exact and independent of the order of CTAs).  Since an entry's bits
// depend on nothing but its two rows, pruning, the launch plan and the
// instance move no bit.  Tensor cores take no IEEE fp32 and TF32 would
// break the fp32 margin contract.
//
// Bound on this card: fp32 FFMA throughput.  The scan does 2·n_a·n_b·D
// FLOPs on (n_a + n_b)·D inputs, far above the ridge point, so the FP32
// pipes bound it (132 SMs × 128 lanes × 2 FLOP per clock: 66.9 TFLOP/s at
// 1,980 MHz), not HBM.  An SM sub-partition issues one warp-instruction a
// clock, so every instruction that is not an FFMA takes an FFMA's slot:
// the design is about spending as few of them as it can, and about
// keeping the schedulers fed.
//
// Common to both instances:
//  * Operands arrive as fp32 rows whose stride (D rounded up to 4) is a
//    multiple of 16 bytes: the launcher widens bf16 exactly and zero-pads
//    a ragged D (a zero k-term leaves the chain's bits alone, since the
//    accumulator never holds −0).  Both instances run the chain over
//    BK-wide k-slices, zero past the row.
//  * Persistent grid: the launcher gives G CTAs (SMs × CTAs that fit on
//    one).  The tile pairs, ordered a-tile-major, are cut into G ranges of
//    equal length; a CTA walks its range, so every pair is covered once
//    and the waves are balanced to one pair.  A small query side still
//    fills every SM.
//  * Row mins stay in registers until the CTA's range leaves the a-tile,
//    then fold by shuffles and two atomicMin per row.
//  * Gate: a tile pair is skipped, before anything is loaded, iff
//    lb[I, J] > cut_a[I] and lb[I, J] > cut_b[J] for every prune-table
//    block (I, J) its rows lie in (blocks are whole multiples of the
//    128-row tile).  lb == nullptr disables the gate.  cut_b = −inf
//    (directed callers) makes the column condition vacuous.
//  * Directed instances (template DIRECTED): row mins only.  No column
//    fminf, shuffle, shared or global atomic; min_b is left as given.
//
// The resident instance (fused_minscan_resident), where the a-tile (all
// of D ≤ 256) fits in shared memory and a CTA walks at least 4 b-tiles per
// a-tile (`hausdorff.launch_plan` decides):
//  * 384 threads: warpgroup 2 is the producer, warpgroups 0 and 1 the
//    consumers.  The producer drops to few registers (`setmaxnreg.dec`) and
//    one of its threads issues every copy, by TMA (`cp.async.bulk.tensor`,
//    a 2-D tensor map per operand, rebuilt each launch and passed as a
//    __grid_constant__ parameter); rows past n and k past the row stride
//    arrive as zeros.  The consumers raise their registers with what the
//    producer gave back (`setmaxnreg.inc`).
//  * Tile pairs of 128 a-rows × 256 b-rows.  Each consumer thread holds an
//    8 × 16 block in registers, rows ty + 16p and columns tx + 16q: per 4 k
//    it issues 24 LDS.128 for 512 FFMA (the streamed tile body: 16 for 256).
//    The slice's eight 4-k steps are unrolled by two: unrolled whole, the
//    consumers spilled at their 232 registers and ran slower
//    (scripts/minscan_levers.py).
//  * Shared memory holds k-slices of 32 floats a row, 128-byte rows with
//    TMA's 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r & 7)):
//    a warp's float4 reads touch 4 (a) or 8 (b) consecutive rows, each at
//    another chunk, so no read conflicts; every row a thread reads has the
//    same r & 7, so one XOR per 4-k step finds them all.
//  * The a-tile (n_k slices) stays resident while the CTA's range stays on
//    it; the b-tile's slices stream through a ring of RING slots.  Each slot
//    has a full mbarrier (the producer's expected bytes) and an empty one
//    (one arrival per consumer thread); no __syncthreads in the k-loop, so
//    the consumer warps may drift apart by up to the ring.  When the range
//    reaches a new a-tile, its slice k travels with the b-slice k of the
//    tile's first pair, on that slot's full barrier, once the consumers
//    have arrived on slice k's a-free barrier at the end of the previous
//    a-tile: the load overlaps the previous tile's last slices.
//  * Bidirectional instance: a thread's 16 column mins fold by shuffles
//    into a shared row of 256 per tile parity, then, after a named barrier
//    among the consumers alone (`bar.sync 1, 256`), into min_b.
//  * The consumers' mbarrier waits do not trap: a trap in that branch holds
//    ptxas to the launch's 168 registers there.  A wait that outlasts 2^26
//    polls marks the thread late instead; its later waits poll once and its
//    rows are folded as NaN, which every check rejects.  The producer's
//    waits trap, so a broken hand-over fails the launch.
//
// The streamed instance (fused_minscan_streamed), for small shapes and a
// D whose a-tile does not fit: the tile body of minscan_tile.cuh, 256
// threads, 128 × 128 tile pairs, 8 × 8 entries a thread, BK-wide k-slices
// of a and b copied by cp.async into a ring of STAGES slots (padded row
// pitch, one __syncthreads per slice); column mins fold through a shared
// row per tile parity, flushed after the next slice's barrier.
// __launch_bounds__(256, 1): up to 255 registers a thread, no spill.
//
// Left for later work: the resident instance reaches about 69–72% of the
// bound at the main path's shapes (PERF.md), against a k-loop whose
// instruction mix would allow ~94%.  Two consumer warps per scheduler is
// all the registers allow at 8 × 16 entries a thread, so LDS latency at
// each 4-k step is hidden only by the other warp, and unrolled further the
// consumers spill; a b-tile order that lets the CTAs share b in L2 and
// prefetching the gate ahead of the ring when pruning are open.
// The streamed instance keeps its earlier design (about two thirds of the
// bound at large shapes, which now take the resident one).
//
// PTX used (PTX ISA: "Tensor Copy Instructions", "mbarrier", "setmaxnreg").

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime, no -lcuda
#include <cuda_runtime.h>

#include <cstdint>

#include "minscan_tile.cuh"

// Tuning knobs of the resident instance, overridden only by
// scripts/minscan_levers.py.
#ifndef MINSCAN_RING
#define MINSCAN_RING 3
#endif
#ifndef MINSCAN_STEP_UNROLL
#define MINSCAN_STEP_UNROLL 2
#endif
#ifndef MINSCAN_PRODUCER_REGS
#define MINSCAN_PRODUCER_REGS 40
#endif
#ifndef MINSCAN_QN
#define MINSCAN_QN 16
#endif

namespace {

using namespace minscan_tile;

struct Gate {
  const float* lb;
  long long ld_lb;
  const float* cut_a;
  const float* cut_b;
  int tiles_b, per_block_a, per_block_b;

  __device__ __forceinline__ bool skipped(int ti, int tj) const {
    if (lb == nullptr) return false;
    const int bi = ti / per_block_a;
    const int bj = tj / per_block_b;
    const float l = lb[bi * ld_lb + bj];
    return l > cut_a[bi] && l > cut_b[bj];
  }
};

// A position in a CTA's range of tile pairs, a-tile-major; moving it costs
// no division.
struct Cursor {
  long long p;
  int ti, tj;

  __device__ __forceinline__ void step(int tiles_b) {
    ++p;
    if (++tj == tiles_b) {
      tj = 0;
      ++ti;
    }
  }
  // To the first pair at or after this one, below end, that `skipped` keeps.
  template <class Skipped>
  __device__ __forceinline__ void skip_gated(Skipped skipped, int tiles_b, long long end) {
    while (p < end && skipped(ti, tj)) step(tiles_b);
  }
  __device__ __forceinline__ void skip_gated(const Gate& g, long long end) {
    skip_gated([&](int i, int j) { return g.skipped(i, j); }, g.tiles_b, end);
  }
};

// ---- the streamed instance --------------------------------------------------

template <bool DIRECTED>
__global__ void __launch_bounds__(THREADS, 1)
fused_minscan_streamed(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ a2, const float* __restrict__ b2,
                       Gate gate, unsigned* __restrict__ min_a, unsigned* __restrict__ min_b,
                       int n_a, int n_b, int ld, int n_k) {
  extern __shared__ __align__(16) float smem[];
  // STAGES × [a-slice, b-slice], then the two column-min rows.
  float* const ring = smem;
  unsigned* const col_s = reinterpret_cast<unsigned*>(ring + STAGES * SLICE * 2);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7);   // columns tx + 16q
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // rows ty + 16p
  const int tiles_b = gate.tiles_b;
  const long long n_pairs = static_cast<long long>((n_a + TILE - 1) / TILE) * tiles_b;
  const long long end = n_pairs * (blockIdx.x + 1) / gridDim.x;

  if (!DIRECTED) {
    col_s[tid] = INF_BITS;  // both parities: 2 × 128 slots
  }

  const long long pass_stride = static_cast<long long>(ROWS_PER_PASS) * ld;
  const long long begin = n_pairs * blockIdx.x / gridDim.x;
  const Cursor first{begin, static_cast<int>(begin / tiles_b), static_cast<int>(begin % tiles_b)};

  // Producer: the next (pair, slice) to copy into slot `fill`, and this
  // thread's share of that pair's tiles.
  Cursor lc = first;
  lc.skip_gated(gate, end);
  int lk = 0;
  int fill = 0;
  TileSrc src_b = tile_src(b, n_b, ld, lc.tj * TILE, tid);
  TileSrc src_a = tile_src(a, n_a, ld, lc.ti * TILE, tid);
  auto issue = [&]() {
    if (lc.p < end) {
      float* slot = ring + fill * SLICE * 2;
      load_slice(slot, src_a, a, pass_stride, ld, lk * BK, tid);
      load_slice(slot + SLICE, src_b, b, pass_stride, ld, lk * BK, tid);
      if (++lk == n_k) {
        lk = 0;
        lc.step(tiles_b);
        lc.skip_gated(gate, end);
        src_b = tile_src(b, n_b, ld, lc.tj * TILE, tid);
        src_a = tile_src(a, n_a, ld, lc.ti * TILE, tid);
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
    fill = fill + 1 == STAGES ? 0 : fill + 1;
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue();

  float row_min[8], a2r[8];
  int cur_ti = -1;
  long long prev_col0 = -1;  // columns waiting in col_s[parity ^ 1]
  int parity = 0;
  int use = 0;  // slot the consumer reads next

  auto flush_rows = [&]() {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      float v = row_min[p];
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      const int r = cur_ti * TILE + ty + 16 * p;
      if ((lane & 7) == 0 && r < n_a && __float_as_uint(v) != INF_BITS) {
        atomicMin(&min_a[r], __float_as_uint(v));
      }
    }
  };
  auto flush_cols = [&]() {  // after a barrier that follows the tile's epilogue
    unsigned* cs = col_s + (parity ^ 1) * TILE;
    if (tid < TILE) {
      const unsigned v = cs[tid];
      if (prev_col0 + tid < n_b && v != INF_BITS) atomicMin(&min_b[prev_col0 + tid], v);
      cs[tid] = INF_BITS;
    }
  };

  Cursor c = first;
  for (c.skip_gated(gate, end); c.p < end; c.step(tiles_b), c.skip_gated(gate, end)) {
    const int ti = c.ti;
    const int tj = c.tj;
    if (ti != cur_ti) {
      if (cur_ti >= 0) flush_rows();
      cur_ti = ti;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int r = ti * TILE + ty + 16 * q;
        row_min[q] = __int_as_float(INF_BITS);
        a2r[q] = r < n_a ? a2[r] : __int_as_float(INF_BITS);
      }
    }
    // Norms of this tile's columns, read now and used after the k-loop.
    float b2r[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = tj * TILE + tx + 16 * q;
      b2r[q] = c < n_b ? __ldg(b2 + c) : __int_as_float(INF_BITS);
    }

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int ks = 0; ks < n_k; ++ks) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // slot `use` has landed; the slot refilled below is free
      if (!DIRECTED && ks == 0 && prev_col0 >= 0) {
        flush_cols();
        prev_col0 = -1;
      }
      issue();
      const float* slot = ring + use * SLICE * 2;
      mma_slice(slot, slot + SLICE, ty, tx, acc);
      use = use + 1 == STAGES ? 0 : use + 1;
    }

    float col_min[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) col_min[q] = __int_as_float(INF_BITS);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = (a2r[i] - 2.f * acc[i][j]) + b2r[j];
        v = v > 0.f ? v : 0.f;
        row_min[i] = fminf(row_min[i], v);
        if (!DIRECTED) col_min[j] = fminf(col_min[j], v);
      }
    }
    if (!DIRECTED) {
      unsigned* cs = col_s + parity * TILE;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float v = col_min[q];
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 8));
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 16));
        if ((lane >> 3) == 0) atomicMin(&cs[tx + 16 * q], __float_as_uint(v));
      }
      prev_col0 = static_cast<long long>(tj) * TILE;
      parity ^= 1;
    }
  }
  cp_async_wait_all();  // no copy may outlive the block
  if (cur_ti >= 0) flush_rows();
  if (!DIRECTED && prev_col0 >= 0) {
    __syncthreads();
    flush_cols();
  }
}

// ---- the resident instance --------------------------------------------------

namespace resident {

constexpr int QN = MINSCAN_QN;                  // b rows a consumer thread holds, 16 apart
constexpr int TILE_B = 16 * QN;                 // b rows per tile pair (a: TILE = 128)
constexpr int SUB = TILE_B / TILE;              // TILE-row tiles in a b-tile
constexpr int RING = MINSCAN_RING;              // b-slice slots
constexpr int STEP_UNROLL = MINSCAN_STEP_UNROLL;  // 4-k steps of a slice unrolled
constexpr int CONSUMERS = 256;                  // warpgroups 0 and 1, 8 × QN entries a thread
constexpr int CTA_THREADS = CONSUMERS + 128;    // and the producer warpgroup
constexpr int ROW_BYTES = BK * 4;               // one slice row: 128 bytes, 128-byte swizzle
constexpr int SLICE_A = TILE * ROW_BYTES;       // 16 KiB
constexpr int SLICE_B = TILE_B * ROW_BYTES;     // 32 KiB
constexpr int GROUP = 16 * ROW_BYTES;           // bytes between a thread's rows (16 apart)
// 384 threads launch with 168 registers each; the producer gives back what
// the consumers take (both multiples of 8, 24–256).
constexpr int PRODUCER_REGS = MINSCAN_PRODUCER_REGS;
constexpr int CONSUMER_REGS = (168 * CTA_THREADS - PRODUCER_REGS * 128) / CONSUMERS / 8 * 8;
static_assert(BK == 32, "a slice row is one 128-byte swizzle span");
static_assert(QN == 8 || QN == 16, "a b-tile of one or two TILE-row tiles");
static_assert(CONSUMER_REGS <= 256 && PRODUCER_REGS >= 24 && PRODUCER_REGS % 8 == 0, "setmaxnreg range");

// Dynamic shared memory for rows of stride ld floats: the a-tile's n_k
// slices, the ring, the mbarriers (full and empty per slot, a-free per
// a-slice) and the two column-min rows.  Every slice starts on a multiple
// of 1,024 bytes from the (1,024-aligned) base, as the swizzle wants.
inline int smem_bytes(int ld) {
  const int n_k = (ld + BK - 1) / BK;
  return n_k * SLICE_A + RING * SLICE_B + 8 * (2 * RING + n_k) + 2 * TILE_B * static_cast<int>(sizeof(unsigned));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Poll until the phase of `bar` with this parity has completed, at most
// max_polls times; false if it never did.
__device__ __forceinline__ bool mbar_poll(uint32_t bar, uint32_t parity, uint32_t max_polls) {
  uint32_t done;
  for (uint32_t polls = 0; polls <= max_polls; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return true;
  }
  return false;
}

// The producer's wait traps after 2^26 polls (seconds).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (!mbar_poll(bar, parity, 1u << 26)) __trap();
}

// A consumer's wait marks the thread late instead (see the header).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity, bool& late) {
  late |= !mbar_poll(bar, parity, late ? 0u : 1u << 26);
}

// One box (32 floats × rows) of a 2-D tensor map into shared memory,
// counted on `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

__device__ __forceinline__ void named_sync_consumers() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// acc[p][q] += Σ_k a[ty + 16p][k] · b[tx + 16q][k] over one 32-wide slice,
// one fmaf per k in ascending order (as minscan_tile's mma_slice).  pa / pb
// are the byte offsets from the shared base of the thread's first a and b
// row with its swizzle in bits 4–6 (row·128 + ((r & 7) << 4)); chunk c of
// every row it reads is at that offset XOR c·16, plus 16 rows per p or q.
__device__ __forceinline__ void mma_slice_wide(const unsigned char* sm, uint32_t pa, uint32_t pb,
                                               float (&acc)[8][QN]) {
#pragma unroll (STEP_UNROLL)
  for (int c = 0; c < BK / 4; ++c) {
    const unsigned char* ap = sm + (pa ^ (c << 4));
    const unsigned char* bp = sm + (pb ^ (c << 4));
    float4 av[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) av[p] = *reinterpret_cast<const float4*>(ap + p * GROUP);
#pragma unroll
    for (int q = 0; q < QN; ++q) {
      const float4 bv = *reinterpret_cast<const float4*>(bp + q * GROUP);
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        float t = acc[p][q];
        t = fmaf(av[p].x, bv.x, t);
        t = fmaf(av[p].y, bv.y, t);
        t = fmaf(av[p].z, bv.z, t);
        t = fmaf(av[p].w, bv.w, t);
        acc[p][q] = t;
      }
    }
  }
}

}  // namespace resident

template <bool DIRECTED>
__global__ void __launch_bounds__(resident::CTA_THREADS, 1)
fused_minscan_resident(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                       const float* __restrict__ a2, const float* __restrict__ b2, Gate gate,
                       unsigned* __restrict__ min_a, unsigned* __restrict__ min_b, int n_a, int n_b, int n_k) {
  using namespace resident;
  extern __shared__ __align__(1024) unsigned char smem_r[];
  const unsigned char* const sm = smem_r;
  // Byte offsets from the base: a-slices, ring, mbarriers, column rows.
  const uint32_t base = smem_u32(smem_r);
  const uint32_t ring = n_k * SLICE_A;
  const uint32_t bars = base + ring + RING * SLICE_B;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (RING + s); };
  auto a_free = [&](int k) { return bars + 8 * (2 * RING + k); };
  unsigned* const col_s = reinterpret_cast<unsigned*>(smem_r + ring + RING * SLICE_B + 8 * (2 * RING + n_k));

  // Pairs (a-tile ti, b-tile tj) of TILE × TILE_B rows; the gate's tables
  // are in TILE-row tiles, so b-tile tj is TILE-row tiles SUB·tj ..
  // SUB·tj + SUB − 1 (the last past n_b on a ragged edge), skipped iff each
  // that holds rows is.
  // Every role works out its range itself, after the split: a value live
  // across setmaxnreg is spilled.
  const int tiles_b = gate.tiles_b;
  auto skipped = [&](int ti, int tj) {
    if (gate.lb == nullptr) return false;
    const int narrow_b = (n_b + TILE - 1) / TILE;
#pragma unroll
    for (int u = SUB * tj; u < SUB * tj + SUB; ++u) {
      if (u < narrow_b && !gate.skipped(ti, u)) return false;
    }
    return true;
  };
  auto range_end = [&] {
    return static_cast<long long>((n_a + TILE - 1) / TILE) * tiles_b * (blockIdx.x + 1) / gridDim.x;
  };
  auto range_start = [&](long long end) {
    const long long begin = static_cast<long long>((n_a + TILE - 1) / TILE) * tiles_b * blockIdx.x / gridDim.x;
    Cursor c{begin, static_cast<int>(begin / tiles_b), static_cast<int>(begin % tiles_b)};
    c.skip_gated(skipped, tiles_b, end);
    return c;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    for (int k = 0; k < n_k; ++k) mbar_init(a_free(k), CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (!DIRECTED) {
    for (int i = threadIdx.x; i < 2 * TILE_B; i += CTA_THREADS) col_s[i] = INF_BITS;
  }
  __syncthreads();

  // The role, warp-uniform (read from lane 0), for ptxas's register split.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ---- producer ----------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      if (base & 1023u) __trap();  // the swizzle's offsets assume a 1,024-aligned base
      const long long end = range_end();
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map_a)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
      int slot = 0;
      uint32_t phase = 0;   // of the ring's current pass
      uint32_t a_tiles = 0;  // a-tiles loaded so far
      int cur_ti = -1;
      for (Cursor c = range_start(end); c.p < end; c.step(tiles_b), c.skip_gated(skipped, tiles_b, end)) {
        const bool new_a = c.ti != cur_ti;
        cur_ti = c.ti;
        for (int ks = 0; ks < n_k; ++ks) {
          mbar_wait(empty(slot), phase ^ 1);
          if (new_a) {
            // slice ks of the previous a-tile is done with (a fresh
            // barrier's parity-1 phase counts as done)
            mbar_wait(a_free(ks), (a_tiles & 1) ^ 1);
            mbar_expect_tx(full(slot), SLICE_A + SLICE_B);
            tma_load(base + ks * SLICE_A, &map_a, full(slot), ks * BK, c.ti * TILE);
          } else {
            mbar_expect_tx(full(slot), SLICE_B);
          }
          tma_load(base + ring + slot * SLICE_B, &map_b, full(slot), ks * BK, c.tj * TILE_B);
          if (++slot == RING) {
            slot = 0;
            phase ^= 1;
          }
        }
        a_tiles += new_a;
      }
    }
  } else {
    // ---- consumers -----------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int tx = (warp & 1) * 8 + (lane & 7);   // columns tx + 16q, q < QN
    const int ty = (warp >> 1) * 4 + (lane >> 3);  // rows ty + 16p, p < 8
    const uint32_t a_row = ty * ROW_BYTES + ((ty & 7) << 4);
    const uint32_t b_row = ring + tx * ROW_BYTES + ((tx & 7) << 4);

    bool late = false;  // a full barrier never completed (see mbar_wait)
    int slot = 0;
    uint32_t phase = 0;
    int parity = 0;  // the column-min row this tile folds into
    float row_min[8];
    int cur_ti = -1;
    const long long end = range_end();
    Cursor c = range_start(end);

    auto flush_rows = [&]() {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        float v = row_min[p];
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 4));
        const int r = cur_ti * TILE + ty + 16 * p;
        if ((lane & 7) == 0 && r < n_a) {
          if (late) {
            atomicExch(&min_a[r], 0x7fffffffu);
          } else if (__float_as_uint(v) != INF_BITS) {
            atomicMin(&min_a[r], __float_as_uint(v));
          }
        }
      }
    };

    while (c.p < end) {
      Cursor next = c;
      next.step(tiles_b);
      next.skip_gated(skipped, tiles_b, end);
      const bool last_of_a = next.p >= end || next.ti != c.ti;
      if (c.ti != cur_ti) {
        if (cur_ti >= 0) flush_rows();
        cur_ti = c.ti;
#pragma unroll
        for (int p = 0; p < 8; ++p) row_min[p] = __int_as_float(INF_BITS);
      }
      const int col0 = c.tj * TILE_B;
      float acc[8][QN];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < QN; ++j) acc[i][j] = 0.f;

      for (int ks = 0; ks < n_k; ++ks) {
        mbar_wait(full(slot), phase, late);
        mma_slice_wide(sm, a_row + ks * SLICE_A, b_row + slot * SLICE_B, acc);
        mbar_arrive(empty(slot));
        if (last_of_a) mbar_arrive(a_free(ks));
        if (++slot == RING) {
          slot = 0;
          phase ^= 1;
        }
      }

      // The rows' and columns' norms, read after the k-loop (registers).
      float a2r[8], b2r[QN];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int r = cur_ti * TILE + ty + 16 * p;
        a2r[p] = r < n_a ? __ldg(a2 + r) : __int_as_float(INF_BITS);
      }
#pragma unroll
      for (int q = 0; q < QN; ++q) {
        const int col = col0 + tx + 16 * q;
        b2r[q] = col < n_b ? __ldg(b2 + col) : __int_as_float(INF_BITS);
      }
      float col_min[QN];
#pragma unroll
      for (int q = 0; q < QN; ++q) col_min[q] = __int_as_float(INF_BITS);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          float v = (a2r[i] - 2.f * acc[i][j]) + b2r[j];
          v = v > 0.f ? v : 0.f;
          row_min[i] = fminf(row_min[i], v);
          if (!DIRECTED) col_min[j] = fminf(col_min[j], v);
        }
      }
      if (!DIRECTED) {
        unsigned* cs = col_s + parity * TILE_B;
#pragma unroll
        for (int q = 0; q < QN; ++q) {
          float v = col_min[q];
          v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 8));
          v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 16));
          if ((lane >> 3) == 0) atomicMin(&cs[tx + 16 * q], __float_as_uint(v));
        }
        // Every consumer's folds into this row are in; a thread moves one
        // column to min_b.  The row is written again two tiles on, after
        // the next tile's barrier, which no thread passes before its reset
        // here.
        named_sync_consumers();
        if (t < TILE_B) {
          const unsigned v = cs[t];
          if (col0 + t < n_b) {
            if (late) {
              atomicExch(&min_b[col0 + t], 0x7fffffffu);
            } else if (v != INF_BITS) {
              atomicMin(&min_b[col0 + t], v);
            }
          }
          cs[t] = INF_BITS;
        }
        parity ^= 1;
      }
      c = next;
    }
    if (cur_ti >= 0) flush_rows();
  }
}

// ---- host ---------------------------------------------------------------------

// Raise a kernel's dynamic shared-memory limit on the current device to at
// least `smem`, once per device and size (a host call saved per launch).
template <class Kernel>
cudaError_t raise_smem_limit(Kernel kernel, int (&allowed)[64], int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < 64) allowed[dev] = smem;
  return err;
}

template <bool RESIDENT, bool DIRECTED>
cudaError_t allow_smem(int smem) {
  static int allowed[64] = {};
  if (RESIDENT) return raise_smem_limit(fused_minscan_resident<DIRECTED>, allowed, smem);
  return raise_smem_limit(fused_minscan_streamed<DIRECTED>, allowed, smem);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, taken from libcuda through the runtime's
// entry-point query so the library needs no -lcuda; null if libcuda lacks it.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 13000
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                       : nullptr;
  }();
  return fn;
}

// x (n rows of stride ld floats) as a 2-D map with boxes of 32 floats ×
// `rows` rows, 128-byte swizzle; rows past n and floats past ld read as 0.
bool make_map(EncodeTiled encode, CUtensorMap* map, const float* x, int n, int ld, int rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ld), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool DIRECTED>
cudaError_t launch_resident(const float* a, const float* b, const float* a2, const float* b2, Gate gate,
                            unsigned* ua, unsigned* ub, int n_a, int n_b, int ld, int n_k, int grid, int smem,
                            cudaStream_t s) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map_a, map_b;
  if (!make_map(encode, &map_a, a, n_a, ld, TILE) || !make_map(encode, &map_b, b, n_b, ld, resident::TILE_B)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem<true, DIRECTED>(smem);
  if (err != cudaSuccess) return err;
  fused_minscan_resident<DIRECTED><<<grid, resident::CTA_THREADS, smem, s>>>(map_a, map_b, a2, b2, gate, ua, ub,
                                                                         n_a, n_b, n_k);
  return cudaGetLastError();
}

template <bool DIRECTED>
cudaError_t launch_streamed(const float* a, const float* b, const float* a2, const float* b2, Gate gate,
                            unsigned* ua, unsigned* ub, int n_a, int n_b, int ld, int n_k, int grid, int smem,
                            cudaStream_t s) {
  cudaError_t err = allow_smem<false, DIRECTED>(smem);
  if (err != cudaSuccess) return err;
  fused_minscan_streamed<DIRECTED><<<grid, THREADS, smem, s>>>(a, b, a2, b2, gate, ua, ub, n_a, n_b, ld, n_k);
  return cudaGetLastError();
}

template <bool RESIDENT, bool DIRECTED>
int occupancy(int smem) {
  if (allow_smem<RESIDENT, DIRECTED>(smem) != cudaSuccess) return 0;
  int n = 0;
  const cudaError_t err =
      RESIDENT ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_minscan_resident<DIRECTED>,
                                                               resident::CTA_THREADS, smem)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_minscan_streamed<DIRECTED>, THREADS, smem);
  return err == cudaSuccess ? n : 0;
}

int instance_smem(int ld, int resident) { return resident ? resident::smem_bytes(ld) : smem_bytes(ld, 0); }

}  // namespace

// Shared memory (bytes) of one CTA of an instance for rows of stride ld
// floats.
extern "C" int fused_minscan_smem(int ld, int resident) { return instance_smem(ld, resident); }

// CTAs of an instance that fit on one SM with `smem` bytes (0 on error).
extern "C" int fused_minscan_occupancy(int resident, int directed, int smem) {
  if (resident) return directed ? occupancy<true, true>(smem) : occupancy<true, false>(smem);
  return directed ? occupancy<false, true>(smem) : occupancy<false, false>(smem);
}

// Launches one scan on `stream` over `grid` persistent CTAs.  a (n_a, ld),
// b (n_b, ld): fp32, ld a multiple of 4, 16-byte aligned, zero past D.
// min_a / min_b must hold +inf (or earlier partial mins to fold into);
// directed != 0 leaves min_b as given.  lb may be null (no gate); then
// ld_lb, cut_a and cut_b are ignored; the table blocks are given in
// 128-row tiles.  resident != 0 takes the resident instance (128 × 256
// tile pairs, ld ≤ 256), else the streamed one (128 × 128).  smem must be
// fused_minscan_smem(ld, resident).  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a bad size or a tensor TMA cannot map,
// cudaErrorNotSupported without libcuda's tensor-map encoder).
extern "C" int fused_minscan(const float* a, const float* b, const float* a2, const float* b2,
                             const float* lb, long long ld_lb, const float* cut_a, const float* cut_b,
                             float* min_a, float* min_b, int n_a, int n_b, int ld,
                             int resident, int directed, int tiles_per_block_a, int tiles_per_block_b,
                             int grid, int smem, void* stream) {
  if (n_a <= 0 || n_b <= 0) return 0;
  if (ld <= 0 || ld % 4 != 0 || grid <= 0 || smem != instance_smem(ld, resident)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile_b = resident ? resident::TILE_B : TILE;
  const Gate gate{lb, ld_lb, cut_a, cut_b, (n_b + tile_b - 1) / tile_b, tiles_per_block_a, tiles_per_block_b};
  const int n_k = (ld + BK - 1) / BK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* ua = reinterpret_cast<unsigned*>(min_a);
  unsigned* ub = reinterpret_cast<unsigned*>(min_b);
  cudaError_t err;
  if (resident) {
    err = directed ? launch_resident<true>(a, b, a2, b2, gate, ua, ub, n_a, n_b, ld, n_k, grid, smem, s)
                   : launch_resident<false>(a, b, a2, b2, gate, ua, ub, n_a, n_b, ld, n_k, grid, smem, s);
  } else {
    err = directed ? launch_streamed<true>(a, b, a2, b2, gate, ua, ub, n_a, n_b, ld, n_k, grid, smem, s)
                   : launch_streamed<false>(a, b, a2, b2, gate, ua, ub, n_a, n_b, ld, n_k, grid, smem, s);
  }
  return static_cast<int>(err);
}
