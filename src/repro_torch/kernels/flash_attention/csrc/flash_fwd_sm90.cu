// Flash attention, forward, bf16, on Hopper's tensor cores (sm_90a), plain C
// interface.  Route "wgmma" of the launcher flash.flash_fwd; fp32 keeps the
// CUDA-core body of flash_fwd.cu (route "ffma"), built into the same library.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention/flash.py:38 (wrapper `flash_attention`,
// flash.py:81) for bf16 operands.  It computes the recurrence that
// flash_fwd.cu's header states — scores (q·kᵀ in fp32)·scale, the causal
// mask (with its query offset and sliding window, flash_mask.cuh), running
// (m, l, acc) in fp32, p rounded to bf16 before P·V, l summed
// over the fp32 p, acc / max(l, 1e−30) cast to bf16 — with the arithmetic
// moved to the tensor cores:
//  * S = Q·Kᵀ is `wgmma.mma_async` m64nBNk16 (bf16 in, fp32 accumulate) with
//    both operands read from shared memory.  A bf16×bf16 product is exact in
//    fp32, so S is the reference's fp32 dot up to the order of its sums.  The
//    scale is applied after the product, folded with log2(e) into one FFMA
//    ahead of `ex2.approx` (p moves by a few fp32 ulps).
//  * O += P·V is `wgmma` m64n64k16 (and m64n16k16 at hd 16 and 80) with A = P taken
//    from registers: the fp32 accumulator of S, exponentiated in place and
//    converted to bf16 pairs, is the reference's p.astype(v.dtype) and is
//    already in the A-fragment layout.  B = V is read from shared memory in
//    its native (keys, hd) layout, MN-major (the transpose bit).
//
// Design (one CTA per (b·h, query block); hd ≤ 128: 384 threads, 128-row
// blocks and 128-key tiles, hd > 128: 256 threads, 64 and 64, see
// "Registers"):
//  * Block order.  The grid is 1-D and walks groups of at most `group`
//    (b, kv head) pairs with all their query heads (GQA heads stay with
//    their kv head); within a group the heaviest causal query block of
//    every head comes first, then the next-lighter ones, as flash_fwd.cu
//    orders its blocks.  The launcher sizes a group so that its K and V fit
//    half the card's L2 (flash.kv_group, from the device's L2 size), and
//    the pairs are split into groups whose sizes differ by one at most: a
//    small remainder group last would start its heaviest blocks late, with
//    too few heads to fill the card (StableLM-3B's 32 heads of 80 in
//    groups of 10, 10, 10 and 2 ran 5% behind the flat order).  In
//    the flat order (every head's block qb, then every head's qb − 1) a
//    head's K/V prefix was read again only one wave later, after the other
//    heads had streamed theirs: at OLMoE-1B-7B's 8 × 16 heads of 128 at
//    4,096 that is ~4.4 GB from HBM a call.  Within a group the CTAs in
//    flight re-read K and V from L2.  With GQA the query heads of a kv
//    head already share it within a wave, and the order lands within 1–3%
//    of the flat one there.  One group of all B·KV pairs is the flat
//    order.  No persistent grid: the order alone took OLMoE's heads from
//    the flat order's 1.59 ms to 1.04 ms (H100 80GB HBM3 at 700 W,
//    PERF.md), and a group's tail is light blocks already.
//  * Warpgroup 2 is the producer: it drops to 24 registers (`setmaxnreg`),
//    and one thread of its first warp issues every copy.  Q, K and V are
//    copied by TMA (`cp.async.bulk.tensor.4d`) straight from their
//    (B, S, heads, hd) layouts, one 4-D tensor map each (strides heads·hd·2
//    bytes), kv head h / (H / KV) (GQA by coordinate: no expanded copy).
//    K/V tiles of BN keys go through a ring of 3 stages, handed over with
//    full / empty `mbarrier`s (K and V of a stage have a full barrier
//    each).  A stage is free only when both consumers' P·V of it is done,
//    so with 2 stages the next tile's copy was issued just as it was
//    needed and its latency showed every tile; the third stage keeps one
//    tile in flight ahead (3 × 64 KiB of K/V and 32 KiB of Q at hd 128,
//    225 KiB of the 227 a block may hold).
//  * Warpgroups 0 and 1 are the consumers, 64 query rows each (hd > 128:
//    warpgroup 0 alone, and warpgroup 1 the producer); they raise
//    their registers to 240 with what the producer gave back (a CTA's
//    warps can only trade the registers it was launched with).  Each
//    overlaps its own work (FA3's intra-warpgroup pipeline): it issues
//    S_j = Q·K_jᵀ and O += P_{j−1}·V_{j−1} together, waits for S_j alone
//    and runs the softmax of tile j while P_{j−1}·V_{j−1} is still on the
//    tensor cores.  The two warpgroups take turns to issue
//    (a ping-pong on named barriers 1 and 2), so one's softmax overlaps the
//    other's products.  A lone consumer (hd > 128) keeps its own overlap.
//  * Shared memory holds each tile as 64-column regions with 128-byte rows
//    (128-byte swizzle) and, at hd 16 and 80, one 16-column region with
//    32-byte rows (32-byte swizzle): hd 16 = 16, hd 64 = 64, hd 80 = 64 + 16,
//    hd 128 = 2 × 64, hd 192 = 3 × 64, hd 256 = 4 × 64, one box per region
//    and load.  Q·Kᵀ walks the regions as k-steps of 16; P·V is one wgmma
//    per region (N = 64 or 16).
//  * Registers: the overlap keeps the scores of tile j (BN/2 fp32 per
//    thread), P of tile j − 1 (BN/4 bf16 pairs) and O (hd/2 fp32) live at
//    once: 64 + 32 + 64 at hd 128.  ptxas gives the consumer branch the 240
//    registers of its `setmaxnreg.inc` (its -v line still says 168, the
//    launch's budget; the machine code of the hd-128 instance uses 184,
//    with no spill), but only if no path of that branch can trap: one
//    `__trap()` there and ptxas holds the whole branch to 168, which spills
//    P at hd 128.  So the consumers' mbarrier waits do not trap (mbar_wait,
//    the three-argument form) and the producer's do.  At hd 192 and 256 O
//    alone holds 96 and 128, so those instances run one consumer warpgroup
//    in a 256-thread CTA: a budget of 255 registers, no `setmaxnreg` and no
//    ping-pong, 64-key tiles (32 + 16 + 128 at hd 256).
//  * Online softmax in the wgmma accumulator layout: a thread holds rows
//    r and r + 8 of its warp's 16, BN/4 keys each; row maxima reduce across
//    the 4 lanes of a quad, l stays a per-thread partial sum (rescaled by the
//    quad's common factor) until the epilogue.
//  * Masking keeps flash_fwd.cu's rules: key tiles wholly after the block's
//    last position or before its first row's window are never loaded
//    (key_tiles); tiles that hold a masked key for some row of a warpgroup,
//    and the tile holding Sk, are masked in registers from the
//    accumulator's (row, column) layout.  Keys past Sk (TMA fills them with
//    zeros, whose score 0 must not count) get −inf.  So do keys the plain
//    causal mask hides: every row sees key 0 in its first tile.  With a
//    query offset or a window (SPAN) a row may see no key at all, and a
//    hidden key's raw score becomes MASKED = −2^99: a power of two, so its
//    scaled score MASKED·c is exact and a row whose every score so far is
//    hidden has p = ex2(MASKED·c − MASKED·c) = 1, as the reference's −1e30
//    gives it.  The row's first visible key then wipes that with corr = 0;
//    a row that sees no key ends with the mean of v, as in the reference.
//    Rows past Sq are not stored.  No shape has to divide a tile.
//  * hd ∈ {16, 64, 80, 128, 192, 256} as template instances (the models'
//    16, 64, 80 and 128 among them), each twice: with a query offset or a
//    window (SPAN), and without, where the plain causal path keeps no
//    offset, window or sentinel logic; the launcher zero-pads any other
//    hd ≤ 256 to the next instance, exactly (a zero column adds 0 to q·k
//    and gives a zero output column), with the true hd's scale.
//
// Bound on this card: per visible (q, k) pair, 4·hd FLOPs on the bf16 tensor
// cores (132 SMs × 4,096 FLOP per clock: 1,070 TFLOP/s at 1,980 MHz) and one
// exp on the MUFU (132 × 16 per clock: 4.18·10¹² per second), on q, k, v and
// o read or written once: at hd 64 the FLOP and exp terms are equal (0.514 ms
// each at TinyLlama's 8 × 4,096 causal prefill) and the bytes far below.  So the products sit on the
// tensor cores and the exps of one warpgroup run while the other's (and its
// own previous tile's) products do.
//
// Why fp32 stays on the CUDA cores: Hopper's tensor cores take no fp32
// operands; TF32 would round q, k, v and p to 10-bit mantissas and break the
// reference's fp32 contract (ROADMAP.md, "The arithmetic contract").
//
// PTX used (PTX ISA: "Asynchronous Warpgroup Level Matrix Multiply-Accumulate
// Instructions", "Tensor Copy Instructions", "mbarrier", "setmaxnreg",
// "Matrix Descriptor Format").

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_mask.cuh"

namespace {

constexpr int PRODUCER_REGS = 24;   // two consumer warpgroups:
constexpr int CONSUMER_REGS = 240;  // 128·24 + 256·240 ≤ 384·168, the launch's registers
constexpr float NEG = -1e30f;       // the reference's initial running max
constexpr float MASKED = -0x1p99f;  // a masked key's raw score (see the header)

// A tile of `ROWS` rows: N64 regions of 64 columns (128-byte rows, 128-byte
// swizzle), then at hd 16 and 80 one of 16 columns (32-byte rows, 32-byte swizzle).
template <int HD, int ROWS>
struct Tile {
  static constexpr int N64 = HD / 64;
  static constexpr int N16 = (HD % 64) / 16;
  static_assert(N64 * 64 + N16 * 16 == HD && N16 <= 1, "head_dim must be 64·a + 16·b, b ≤ 1");
  static constexpr int R64 = ROWS * 128;  // bytes of a 64-column region
  static constexpr int R16 = ROWS * 32;   // bytes of the 16-column region
  static constexpr int BYTES = N64 * R64 + N16 * R16;
};

template <int HD>
struct Shape {
  static constexpr int NC = HD > 128 ? 1 : 2;     // consumer warpgroups (see the header)
  static constexpr int BM = 64 * NC;              // query rows per CTA
  static constexpr int CONSUMERS = 128 * NC;
  static constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
  static constexpr int BN = NC == 2 ? 128 : 64;   // keys per tile (see the header)
  static constexpr int STAGES = 3;                // the K/V ring (see the header)
  using Q = Tile<HD, BM>;
  using KV = Tile<HD, BN>;
  // Q, K[STAGES], V[STAGES], then 1 + 3·STAGES mbarriers; 1,024 bytes of
  // slack to align the base.
  static constexpr int SMEM = Q::BYTES + 2 * STAGES * KV::BYTES + 8 * (1 + 3 * STAGES) + 1024;
};

// --- shared-memory addresses, mbarriers, TMA ---------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Poll until the phase of `bar` with this parity has completed, at most
// 2^26 times (seconds); false if it never did.
__device__ __forceinline__ bool mbar_poll(uint32_t bar, uint32_t parity, uint32_t max_polls = 1u << 26) {
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

// The producer's wait: one that outlasts the polls traps, so a broken
// hand-over fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (!mbar_poll(bar, parity)) __trap();
}

// A consumer's wait.  A trap in the consumer branch holds ptxas to the
// launch's 168 registers there (see "Registers" in the header), so one that
// outlasts the polls marks the thread `late` instead: its later waits poll
// once and its rows are stored as NaN, which every check rejects.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity, bool& late) {
  late |= !mbar_poll(bar, parity, late ? 0u : 1u << 26);
}

// One box of a 4-D tensor map (hd, heads, S, B) into shared memory, counted
// on `bar`'s transaction bytes.  Boxes past the tensor's edge are zero-filled.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int col,
                                         int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// A whole tile: each 64-column region, then the 16-column one.
template <class T>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map64, const CUtensorMap* map16,
                                          uint32_t bar, int head, int row, int batch) {
#pragma unroll
  for (int r = 0; r < T::N64; ++r) tma_load(dst + r * T::R64, map64, bar, 64 * r, head, row, batch);
  if (T::N16) tma_load(dst + T::N64 * T::R64, map16, bar, 64 * T::N64, head, row, batch);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// --- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, the byte stride between
// 8-row groups (written as both the leading and the stride byte offset: the
// layouts here never span a second swizzle atom along the other dimension,
// so the one the hardware does not read is harmless), swizzle mode in bits
// 62-63 (1 = 128-byte, 3 = 32-byte).
// The address passes an empty asm first, so the descriptor is rebuilt at
// each use (a few integer ops) instead of every loop-invariant one being
// hoisted into registers the accumulators need.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t group_stride, uint32_t swizzle) {
  asm volatile("" : "+r"(addr));
  const uint64_t s = (group_stride >> 4) & 0x3FFF;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (s << 16) | (s << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of an accumulator across a wgmma.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64×128, fp32) (+)= A · B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D(64×64, fp32) (+)= A · B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D(64×64, fp32) += A · B, A (bf16 pairs) from registers, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D(64×16, fp32) += A · B, A (bf16 pairs) from registers, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n16k16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S(64×N) = A · Bᵀ from shared memory: the score tile's width picks the shape.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_m64n128k16(d, a, b, acc);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_m64n64k16(d, a, b, acc);
}

// A consumer warpgroup's registers.  Accumulator layout of m64nNk16 (PTX
// ISA, "Register Fragments and Shared Memory Matrix Layouts"): thread
// (warp w, lane t) holds rows 16w + t/4 (index bit 1 clear) and 16w + t/4 + 8
// (bit 1 set), columns 8·(i/4) + 2·(t%4) + (i%2).
template <int HD>
struct Consumer {
  using Tq = typename Shape<HD>::Q;
  using Tkv = typename Shape<HD>::KV;
  static constexpr int BN = Shape<HD>::BN;
  static constexpr int N64 = Tq::N64;
  static constexpr int N16 = Tq::N16;
  float s[BN / 2];            // scores of one key tile, then its fp32 p
  uint32_t p[BN / 4];         // p of the previous tile as bf16 pairs: P·V's A fragments
  float o64[N64 > 0 ? N64 : 1][32];  // output columns 64r .. 64r + 63 (none at hd 16)
  float o16[8];                      // columns 64·N64 .. +15 (hd 16 and 80)
  float m[2], l[2], corr[2];  // per row: running max (log2 units), partial l, last rescale

  // S = Q·Kᵀ: k-steps of 16 over each region; q is this warpgroup's Q base in
  // the 64-column regions (q16 in the 16-column one), k the K tile's base.
  __device__ __forceinline__ void issue_s(uint32_t q, uint32_t q16, uint32_t k) {
#pragma unroll
    for (int r = 0; r < N64; ++r)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, make_desc(q + r * Tq::R64 + kk * 32, 1024, 1),
                 make_desc(k + r * Tkv::R64 + kk * 32, 1024, 1), (r | kk) != 0);
    if (N16) wgmma_ss(s, make_desc(q16, 256, 3), make_desc(k + N64 * Tkv::R64, 256, 3), N64 > 0);
  }

  // O += P·V: BN/16 k-steps of 16 keys, one wgmma per region; v is the V tile's base.
  __device__ __forceinline__ void issue_pv(uint32_t v) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
#pragma unroll
      for (int r = 0; r < N64; ++r)
        wgmma_rs_m64n64k16(o64[r], a, make_desc(v + r * Tkv::R64 + kk * 16 * 128, 1024, 1));
      if (N16) wgmma_rs_m64n16k16(o16, a, make_desc(v + N64 * Tkv::R64 + kk * 16 * 32, 256, 3));
    }
  }

  __device__ __forceinline__ void pin_o() {
#pragma unroll
    for (int r = 0; r < N64; ++r) pin(o64[r]);
    if (N16) pin(o16);
  }

  __device__ __forceinline__ void rescale_o() {
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int r = 0; r < N64; ++r) o64[r][i] *= corr[(i >> 1) & 1];
    if (N16) {
#pragma unroll
      for (int i = 0; i < 8; ++i) o16[i] *= corr[(i >> 1) & 1];
    }
  }

  // The online-softmax step on the score tile of keys k0 .. k0 + BN − 1 for
  // the rows at positions pos0 and pos0 + 8.  With `mask`, keys past Sk get
  // −inf (no weight) and keys the causal mask hides get, with SPAN, MASKED,
  // and without it −inf (see the header).
  template <bool SPAN>
  __device__ __forceinline__ void softmax(int k0, int pos0, int col0, int Sk, bool mask, bool causal,
                                          int window, float scale_log2) {
    if (mask) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = k0 + col0 + 8 * (i >> 2) + (i & 1);
        const int pos = pos0 + 8 * ((i >> 1) & 1);
        if (SPAN) {
          if (col >= Sk) s[i] = -CUDART_INF_F;
          else if (causal && !visible(pos, col, window)) s[i] = MASKED;
        } else if (col >= Sk || (causal && col > pos)) {
          s[i] = -CUDART_INF_F;
        }
      }
    }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ex2(fmaf(s[i], scale_log2, -m[r]));
      sum[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
  }

  // fp32 p → bf16 pairs in the A-fragment layout of k-step kk: rows (r,
  // r + 8) × keys (2·(t%4), +8) of keys 16kk .. 16kk + 15.
  __device__ __forceinline__ void convert_p() {
#pragma unroll
    for (int j = 0; j < BN / 4; ++j) p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
  }
};

// SPAN: the causal mask has a query offset or a window.  Without them
// (every model's prefill) the instance folds q_offset = 0 and no window into
// its code, and walks and masks tiles as plain causal attention does.
template <int HD, bool SPAN>
__global__ void __launch_bounds__(Shape<HD>::THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tq16,
                      const __grid_constant__ CUtensorMap tk16, const __grid_constant__ CUtensorMap tv16,
                      __nv_bfloat16* __restrict__ o, int B, int Sq, int Sk, int H, int KV, int group,
                      float scale_log2, int causal, int q_offset_arg, int window_arg) {
  const int q_offset = SPAN ? q_offset_arg : 0;
  const int window = SPAN ? window_arg : 0x7fffffff;
  using Tq = typename Shape<HD>::Q;
  using Tkv = typename Shape<HD>::KV;
  constexpr int BN = Shape<HD>::BN;
  constexpr int BM = Shape<HD>::BM;
  constexpr int NC = Shape<HD>::NC;
  constexpr int CONSUMERS = Shape<HD>::CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  // Swizzled TMA boxes and wgmma descriptors want 1,024-byte-aligned tiles.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_tile = base;
  constexpr int STAGES = Shape<HD>::STAGES;
  const uint32_t bars = base + Tq::BYTES + 2 * STAGES * Tkv::BYTES;
  // mbarriers: full_q; full_k[2]; full_v[2]; empty[2] (K and V of a stage consumed).
  const uint32_t full_q = bars;
  auto k_tile = [&](int st) { return base + Tq::BYTES + st * Tkv::BYTES; };
  auto v_tile = [&](int st) { return base + Tq::BYTES + (STAGES + st) * Tkv::BYTES; };
  auto full_k = [&](int st) { return bars + 8 * (1 + st); };
  auto full_v = [&](int st) { return bars + 8 * (1 + STAGES + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * STAGES + st); };

  // The block order (see the header): the B·KV (b, kv head) pairs in
  // ceil(B·KV / group) groups of at most `group`, the first B·KV % n_groups
  // of them one pair larger, each with all its query heads; within a group
  // the heaviest causal query block of every head first.  A group's heads
  // are consecutive in b·H + h from its first pair's.
  const int n_qb = (Sq + BM - 1) / BM;
  const int n_groups = (B * KV + group - 1) / group;
  const int small = B * KV / n_groups;  // pairs in a smaller group
  const int n_big = B * KV % n_groups;  // groups of small + 1 pairs, first
  const int bid = blockIdx.x;
  const bool big = bid < n_big * (small + 1) * (H / KV) * n_qb;
  const int pairs = big ? small + 1 : small;          // in this block's group
  const int in_group = pairs * (H / KV) * n_qb;       // its blocks
  const int rest = big ? bid : bid - n_big * (small + 1) * (H / KV) * n_qb;
  const int first = (big ? 0 : n_big * (small + 1)) + rest / in_group * pairs;  // its first pair
  const int r = rest % in_group;
  const int heads = pairs * (H / KV);
  const int qb = n_qb - 1 - r / heads;
  const int bh = first * (H / KV) + r % heads;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = qb * BM;
  // Tiles kt0 .. kt0 + n_tiles − 1; the ring's stage and phase count from kt0.
  const int all_tiles = (Sk + BN - 1) / BN;
  const KeyTiles tiles = SPAN ? key_tiles(q0, BM, Sq, Sk, BN, q_offset, window, causal)
                              : KeyTiles{0, causal ? min(all_tiles, (min(q0 + BM, Sq) - 1) / BN + 1) : all_tiles};
  const int kt0 = tiles.first, n_tiles = tiles.count;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), 4 * NC);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The role, warp-uniform (read from lane 0), for ptxas's register split.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NC) {
    // ---- producer ------------------------------------------------------
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(full_q, Tq::BYTES);
      load_tile<Tq>(q_tile, &tq, &tq16, full_q, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(st), (i / STAGES - 1) & 1);
        mbar_expect_tx(full_k(st), Tkv::BYTES);
        load_tile<Tkv>(k_tile(st), &tk, &tk16, full_k(st), kvh, (kt0 + i) * BN, b);
        mbar_expect_tx(full_v(st), Tkv::BYTES);
        load_tile<Tkv>(v_tile(st), &tv, &tv16, full_v(st), kvh, (kt0 + i) * BN, b);
      }
    }
  } else {
    // ---- consumers -------------------------------------------------------
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int w = wg;  // rows q0 + 64w .. q0 + 64w + 63
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row0 = q0 + 64 * w + 16 * (t / 32) + lane / 4;
    const int pos0 = q_offset + row0;  // the row's position, for the mask
    const int col0 = 2 * (lane % 4);
    const uint32_t q64 = q_tile + w * 64 * 128;
    const uint32_t q16 = q_tile + Tq::N64 * Tq::R64 + w * 64 * 32;
    // A tile needs the mask if it holds Sk or, under the causal mask, a key
    // after this warpgroup's first position or (SPAN) before its last row's
    // window.
    auto masked = [&](int kt) {
      if constexpr (SPAN) {
        const long long k0 = static_cast<long long>(kt) * BN;
        const long long pos_w = static_cast<long long>(q_offset) + q0 + 64 * w;  // its first row's position
        return k0 + BN > Sk || (causal && (k0 + BN - 1 > pos_w || k0 < pos_w + 64 - window));
      } else {
        return kt * BN + BN > Sk || (causal && kt * BN + BN - 1 > q0 + 64 * w);
      }
    };
    // The ping-pong of two consumers (a lone consumer has no one to wait for).
    auto my_turn = [&] { if constexpr (Shape<HD>::NC == 2) named_sync(1 + w); };
    auto your_turn = [&] { if constexpr (Shape<HD>::NC == 2) named_arrive(2 - w); };

    bool late = false;  // a full barrier never completed (see mbar_wait)
    Consumer<HD> c;
    c.m[0] = c.m[1] = NEG;
    c.l[0] = c.l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int r = 0; r < Tq::N64; ++r) c.o64[r][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) c.o16[i] = 0.f;

    // Ping-pong: warpgroup w issues its products after named barrier 1 + w,
    // then lets the other one go.  Warpgroup 0 goes first.
    if constexpr (NC == 2) {
      if (w == 1) named_arrive(1);
    }

    mbar_wait(full_q, 0, late);
    mbar_wait(full_k(0), 0, late);
    my_turn();
    wgmma_fence();
    c.issue_s(q64, q16, k_tile(0));
    wgmma_commit();
    your_turn();
    wgmma_wait<0>();
    pin(c.s);
    c.template softmax<SPAN>(kt0 * BN, pos0, col0, Sk, masked(kt0), causal, window, scale_log2);
    c.convert_p();

    for (int i = 1; i < n_tiles; ++i) {
      const int kt = kt0 + i;
      const int st = i % STAGES, prev = (i - 1) % STAGES;
      mbar_wait(full_k(st), (i / STAGES) & 1, late);
      c.rescale_o();  // by the previous tile's factor, before its P·V lands
      my_turn();
      wgmma_fence();
      c.issue_s(q64, q16, k_tile(st));
      wgmma_commit();
      mbar_wait(full_v(prev), ((i - 1) / STAGES) & 1, late);
      c.issue_pv(v_tile(prev));
      wgmma_commit();
      your_turn();
      wgmma_wait<1>();  // S of tile kt is in; P·V of tile kt − 1 may still run
      pin(c.s);
      c.template softmax<SPAN>(kt * BN, pos0, col0, Sk, masked(kt), causal, window, scale_log2);
      wgmma_wait<0>();
      c.pin_o();
      pin(c.s);  // no conversion into p may start before P·V has read it
      if (lane == 0) mbar_arrive(empty(prev));
      c.convert_p();
    }

    const int last = n_tiles - 1;
    c.rescale_o();
    mbar_wait(full_v(last % STAGES), (last / STAGES) & 1, late);
    my_turn();
    wgmma_fence();
    c.issue_pv(v_tile(last % STAGES));
    wgmma_commit();
    your_turn();
    wgmma_wait<0>();
    c.pin_o();
    if constexpr (NC == 2) {
      if (w == 0) named_sync(1);  // takes warpgroup 1's last arrival
    }

    // Epilogue: the row's l over its quad, acc / max(l, 1e−30), bf16 stores.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      c.l[r] += __shfl_xor_sync(0xffffffffu, c.l[r], 1);
      c.l[r] += __shfl_xor_sync(0xffffffffu, c.l[r], 2);
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      const float denom = late ? CUDART_NAN_F : fmaxf(c.l[r], 1e-30f);
      __nv_bfloat16* orow = o + ((static_cast<long long>(b) * Sq + row) * H + h) * HD;
#pragma unroll
      for (int rr = 0; rr < Tq::N64; ++rr)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * rr + 8 * j + col0) =
              __floats2bfloat162_rn(c.o64[rr][4 * j + 2 * r] / denom, c.o64[rr][4 * j + 2 * r + 1] / denom);
      if (Tq::N16) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * Tq::N64 + 8 * j + col0) =
              __floats2bfloat162_rn(c.o16[4 * j + 2 * r] / denom, c.o16[4 * j + 2 * r + 1] / denom);
      }
    }
  }
}

// --- host ---------------------------------------------------------------------

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

// A bf16 (B, S, heads, hd) tensor as a 4-D map, innermost first, with boxes
// of `cols` columns × 1 head × `rows` rows × 1 batch.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int S, int heads, int hd, int cols,
              int rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2, (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool SPAN>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H, int KV,
           int group, float scale, int causal, int q_offset, int window, cudaStream_t stream) {
  using S = Shape<HD>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // q, k, v with 64-column boxes, then their 16-column boxes (hd 16 and 80);
  // an instance without one kind passes the other in its place, unread.
  CUtensorMap maps[6];
  const void* ptrs[3] = {q, k, v};
  const int seqs[3] = {Sq, Sk, Sk}, heads[3] = {H, KV, KV}, rows[3] = {S::BM, S::BN, S::BN};
  for (int i = 0; i < 3; ++i) {
    if (S::Q::N64 && !make_map(encode, &maps[i], ptrs[i], B, seqs[i], heads[i], HD, 64, rows[i],
                               CU_TENSOR_MAP_SWIZZLE_128B))
      return static_cast<int>(cudaErrorInvalidValue);
    if (S::Q::N16 && !make_map(encode, &maps[3 + i], ptrs[i], B, seqs[i], heads[i], HD, 16, rows[i],
                               CU_TENSOR_MAP_SWIZZLE_32B))
      return static_cast<int>(cudaErrorInvalidValue);
    if (!S::Q::N64) maps[i] = maps[3 + i];
    if (!S::Q::N16) maps[3 + i] = maps[i];
  }
  constexpr int smem = S::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<HD, SPAN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(B) * H * ((Sq + S::BM - 1) / S::BM);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_sm90_kernel<HD, SPAN><<<static_cast<unsigned>(blocks), S::THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], static_cast<__nv_bfloat16*>(o), B, Sq, Sk, H, KV,
      group, scale * 1.4426950408889634f, causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one bf16 forward pass on `stream`.  q, o: (B, Sq, H, hd); k, v:
// (B, Sk, KV, hd); all contiguous and 16-byte aligned; KV divides H; Sk ≥ 1;
// B·H·ceil(Sq / rows) < 2^31 (128 rows a block, 64 at hd > 128).  scale is the
// reference's 1/√hd of the true head dim, rounded to fp32; q_offset is row
// 0's position and window the sliding window (INT_MAX for none), both of the
// causal mask; group the (b, kv head) pairs per group of the block order,
// 1 to B·KV.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an hd that is not an instance, a group out of
// range or a tensor TMA cannot map, cudaErrorNotSupported without libcuda's
// tensor-map encoder).
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                              int H, int KV, int hd, float scale, int causal, int q_offset, int window,
                              int group, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (group < 1 || group > B * KV) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool span = causal && (q_offset != 0 || window != 0x7fffffff);
#define FLASH_SM90_CASE(HD)                                                                         \
  case HD:                                                                                          \
    return span ? launch<HD, true>(q, k, v, o, B, Sq, Sk, H, KV, group, scale, causal, q_offset, window, s) \
                : launch<HD, false>(q, k, v, o, B, Sq, Sk, H, KV, group, scale, causal, q_offset, window, s);
  switch (hd) {
    FLASH_SM90_CASE(16)
    FLASH_SM90_CASE(64)
    FLASH_SM90_CASE(80)
    FLASH_SM90_CASE(128)
    FLASH_SM90_CASE(192)
    FLASH_SM90_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_SM90_CASE
}
