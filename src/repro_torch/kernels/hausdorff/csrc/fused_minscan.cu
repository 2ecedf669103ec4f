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
// which share this kernel's tile body, csrc/minscan_tile.cuh): each dot product is one fmaf chain over
// k = 0..D−1 in order, from +0, in IEEE fp32 on the CUDA cores; the
// epilogue is (a2 − 2·acc) + b2, clamped by `v > 0 ? v : 0` (never fmaxf,
// so −0.0 cannot reach a fold); folds are atomicMin on the fp32 bits as
// unsigned int into outputs the wrapper set to +inf (for d² ≥ 0 the
// unsigned order is the float order, so the fold is exact and independent
// of the order of CTAs).  Since an entry's bits depend on nothing but its
// two rows, pruning, the launch plan and the instance move no bit.  Tensor
// cores take no IEEE fp32 and TF32 would break the fp32 margin contract.
//
// Bound on this card: fp32 FFMA throughput.  The scan does 2·n_a·n_b·D
// FLOPs on (n_a + n_b)·D inputs, far above the ridge point, so the FP32
// pipes bound it (132 SMs × 128 lanes × 2 FLOP per clock: 66.9 TFLOP/s at
// 1,980 MHz), not HBM.  An SM sub-partition issues one warp-instruction a
// clock, so every instruction that is not an FFMA takes an FFMA's slot:
// the design is about spending as few of them as it can.
//
// Design:
//  * Operands arrive as fp32 rows whose stride (D rounded up to 4) is a
//    multiple of 16 bytes: the launcher widens bf16 exactly and zero-pads
//    a ragged D (a zero k-term leaves the chain's bits alone, since the
//    accumulator never holds −0).
//  * A CTA of 256 threads computes 128×128 tile pairs; each thread an 8×8
//    block in registers, rows ty + 16p and columns tx + 16q, so a warp's
//    float4 reads of a [row][k] stage (row pitch BK + 4 floats, an odd
//    number of 16-byte units) touch 4 (a) and 8 (b) consecutive rows: one
//    wavefront each, no conflict.  Per 4 k a thread issues 16 LDS.128 for
//    256 FFMA.
//  * Staging: BK = 32-wide k-slices copied by cp.async (16 B, L2 only, zero-fill
//    past the ragged row and k edge) into a ring of STAGES slots, one
//    __syncthreads per slice; no staging registers, no scalar loads, no
//    transposing stores, STAGES − 1 slices in flight.  Each thread sets up
//    its copy addresses once per tile (TileSrc) and walks the pairs with a
//    cursor, so a slice costs no address arithmetic and no division.
//  * Persistent grid: the launcher gives G CTAs (SMs × CTAs that fit on
//    one).  The tile pairs, ordered a-tile-major, are cut into G ranges of
//    equal length; a CTA walks its range, so every pair is covered once
//    and the waves are balanced to one pair.  A small query side still
//    fills every SM.
//  * Resident a-tile (template RESIDENT): a CTA's range stays on one
//    a-tile for many b-tiles, so that a-tile (all of D) is loaded once into
//    shared memory when the range reaches it, and only b streams through
//    the ring.  Where it does not fit, or a CTA sees too few b-tiles per
//    a-tile, the launcher picks the streamed instance, whose slots hold an
//    a-slice and a b-slice (`hausdorff.launch_plan` decides).
//  * Directed instance (template DIRECTED): row mins only.  No column
//    fminf, shuffle, shared or global atomic; min_b is left as given.  The
//    bidirectional instance folds columns through a shared row per tile
//    parity, flushed to min_b after the next slice's barrier, so it adds
//    no barrier of its own.
//  * Row mins stay in registers until the CTA's range leaves the a-tile,
//    then fold by shuffles and two atomicMin per row.
//  * Gate: a tile pair is skipped, before anything is loaded, iff
//    lb[I, J] > cut_a[I] and lb[I, J] > cut_b[J], where (I, J) is the
//    prune-table block it lies in (blocks are whole multiples of the
//    128-row tile).  lb == nullptr disables the gate.  cut_b = −inf
//    (directed callers) makes the column condition vacuous.
//  * __launch_bounds__(256, 1): up to 255 registers a thread (254 used), so
//    no instance spills (ptxas -v, in the build log).
//
// Left for later work: the kernel reaches about two thirds of the bound.
// The code of one 32-wide slice holds 2,048 FFMA, 128 LDS.128 and 207–286
// other instructions, not all of which run each slice (cuobjdump, as
// scripts/minscan_levers.py counts them), so most of the rest is stalls
// that two warps per scheduler (one
// CTA of 8 warps at 254 registers per SM) do not hide, the slice barrier
// among them.  Per-slot mbarriers instead of __syncthreads (warps a slice
// or two apart), a wider register tile (8×16) or a second CTA per SM would
// attack that; a b-tile order that lets the CTAs share b in L2 (each CTA
// walks its own part of b) and prefetching the gate ahead of the ring when
// pruning are also open.  A deeper ring and 16- or 64-wide slices measured
// no better (scripts/minscan_levers.py).

#include <cuda_runtime.h>

#include "minscan_tile.cuh"

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
  // To the first pair at or after this one, below end, that the gate keeps.
  __device__ __forceinline__ void skip_gated(const Gate& g, long long end) {
    while (p < end && g.skipped(ti, tj)) step(g.tiles_b);
  }
};

template <bool RESIDENT, bool DIRECTED>
__global__ void __launch_bounds__(THREADS, 1)
fused_minscan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ a2, const float* __restrict__ b2,
                     Gate gate, unsigned* __restrict__ min_a, unsigned* __restrict__ min_b,
                     int n_a, int n_b, int ld, int n_k) {
  extern __shared__ __align__(16) float smem[];
  // RESIDENT: [n_k a-slices][STAGES b-slices]; else STAGES × [a-slice, b-slice].
  float* const ring = RESIDENT ? smem + n_k * SLICE : smem;
  unsigned* const col_s = reinterpret_cast<unsigned*>(ring + STAGES * SLICE * (RESIDENT ? 1 : 2));

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
  TileSrc src_a = RESIDENT ? TileSrc{a, 0u} : tile_src(a, n_a, ld, lc.ti * TILE, tid);
  auto issue = [&]() {
    if (lc.p < end) {
      float* slot = ring + fill * SLICE * (RESIDENT ? 1 : 2);
      if (RESIDENT) {
        load_slice(slot, src_b, b, pass_stride, ld, lk * BK, tid);
      } else {
        load_slice(slot, src_a, a, pass_stride, ld, lk * BK, tid);
        load_slice(slot + SLICE, src_b, b, pass_stride, ld, lk * BK, tid);
      }
      if (++lk == n_k) {
        lk = 0;
        lc.step(tiles_b);
        lc.skip_gated(gate, end);
        src_b = tile_src(b, n_b, ld, lc.tj * TILE, tid);
        if (!RESIDENT) src_a = tile_src(a, n_a, ld, lc.ti * TILE, tid);
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
      if (RESIDENT) {
        __syncthreads();  // every thread is done with the previous a-tile
        const TileSrc tile = tile_src(a, n_a, ld, ti * TILE, tid);
        for (int ks = 0; ks < n_k; ++ks) load_slice(smem + ks * SLICE, tile, a, pass_stride, ld, ks * BK, tid);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
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
      const float* slot = ring + use * SLICE * (RESIDENT ? 1 : 2);
      mma_slice(RESIDENT ? smem + ks * SLICE : slot, RESIDENT ? slot : slot + SLICE, ty, tx, acc);
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

// Raise an instance's dynamic shared-memory limit on the current device to
// at least `smem`, once per device and size (a host call saved per launch).
template <bool RESIDENT, bool DIRECTED>
cudaError_t allow_smem(int smem) {
  constexpr int MAX_DEVICES = 64;
  static int allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(fused_minscan_kernel<RESIDENT, DIRECTED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = smem;
  return err;
}

template <bool RESIDENT, bool DIRECTED>
cudaError_t launch(const float* a, const float* b, const float* a2, const float* b2, Gate gate,
                   unsigned* ua, unsigned* ub, int n_a, int n_b, int ld, int n_k, int grid,
                   int smem, cudaStream_t s) {
  cudaError_t err = allow_smem<RESIDENT, DIRECTED>(smem);
  if (err != cudaSuccess) return err;
  fused_minscan_kernel<RESIDENT, DIRECTED><<<grid, THREADS, smem, s>>>(a, b, a2, b2, gate, ua, ub,
                                                                       n_a, n_b, ld, n_k);
  return cudaGetLastError();
}

template <bool RESIDENT, bool DIRECTED>
int occupancy(int smem) {
  auto kernel = fused_minscan_kernel<RESIDENT, DIRECTED>;
  if (allow_smem<RESIDENT, DIRECTED>(smem) != cudaSuccess) return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem) != cudaSuccess) return 0;
  return n;
}

}  // namespace

// Shared memory (bytes) of one CTA for rows of stride ld floats.
extern "C" int fused_minscan_smem(int ld, int resident) { return smem_bytes(ld, resident); }

// CTAs of an instance that fit on one SM with `smem` bytes (0 on error).
extern "C" int fused_minscan_occupancy(int resident, int directed, int smem) {
  if (resident) return directed ? occupancy<true, true>(smem) : occupancy<true, false>(smem);
  return directed ? occupancy<false, true>(smem) : occupancy<false, false>(smem);
}

// Launches one scan on `stream` over `grid` persistent CTAs.  a (n_a, ld),
// b (n_b, ld): fp32, ld a multiple of 4, 16-byte aligned, zero past D.
// min_a / min_b must hold +inf (or earlier partial mins to fold into);
// directed != 0 leaves min_b as given.  lb may be null (no gate); then
// ld_lb, cut_a and cut_b are ignored.  smem must be
// fused_minscan_smem(ld, resident).  Returns cudaGetLastError() after the
// launch.
extern "C" int fused_minscan(const float* a, const float* b, const float* a2, const float* b2,
                             const float* lb, long long ld_lb, const float* cut_a, const float* cut_b,
                             float* min_a, float* min_b, int n_a, int n_b, int ld,
                             int resident, int directed, int tiles_per_block_a, int tiles_per_block_b,
                             int grid, int smem, void* stream) {
  if (n_a <= 0 || n_b <= 0) return 0;
  if (ld <= 0 || ld % 4 != 0 || grid <= 0 || smem != smem_bytes(ld, resident)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Gate gate{lb, ld_lb, cut_a, cut_b, (n_b + TILE - 1) / TILE, tiles_per_block_a, tiles_per_block_b};
  const int n_k = (ld + BK - 1) / BK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* ua = reinterpret_cast<unsigned*>(min_a);
  unsigned* ub = reinterpret_cast<unsigned*>(min_b);
  cudaError_t err;
  if (resident) {
    err = directed ? launch<true, true>(a, b, a2, b2, gate, ua, ub, n_a, n_b, ld, n_k, grid, smem, s)
                   : launch<true, false>(a, b, a2, b2, gate, ua, ub, n_a, n_b, ld, n_k, grid, smem, s);
  } else {
    err = directed ? launch<false, true>(a, b, a2, b2, gate, ua, ub, n_a, n_b, ld, n_k, grid, smem, s)
                   : launch<false, false>(a, b, a2, b2, gate, ua, ub, n_a, n_b, ld, n_k, grid, smem, s);
  }
  return static_cast<int>(err);
}
