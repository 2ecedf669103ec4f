// The bucket scan of kernels 2 and 3 (batched_minscan.cu, multiquery_minscan.cu)
// on the tile body of minscan_tile.cuh.
//
// Replaces the Pallas TPU kernels `_batched_kernel` (kernel 2) and
// `_multiquery_kernel` (kernel 3) in src/repro/kernels/hausdorff/batched.py
// (:74 and :378).  One pass folds, for every item, the d² entries of its
// query rows against its set's rows into the item's row mins (query→set)
// and, in the bidirectional instance, its column mins (set→query).
//
// Items.  Item (g, s), g < n_groups, s < n_sets, pairs the n_q query rows
// at q + g·q_gs + s·q_ss with the cap set rows at slab + s·s_ss (strides in
// floats); its norms are at q2 + g·q2_gs + s·q2_ss and b2 + s·b2_ss, its
// gate lb[i], cut[i] and its outputs min_a + i·n_q and min_b + i·cap, with
// i = g·n_sets + s.  Kernel 2 is one group: a query per set, or one shared
// by every set (q_ss = 0).  Kernel 3 is Q groups, query g shared by the
// sets of one slab.
//
// Gate.  Item i is computed iff lb[i] <= cut[i]; the test is written that
// way round, so a NaN bound skips the item as the Pallas kernels'
// `pl.when(lb <= cut)` does.  It is read before anything of the item is
// copied, and a skipped item's outputs keep what the wrapper put there
// (+inf, the certified "farther than cut" sentinel).  lb == nullptr
// disables the gate.
//
// Design (kernel 1's, extended to items):
//  * Persistent grid: G CTAs (SMs × CTAs that fit on one), each walking one
//    of G equal ranges of the tile pairs, ordered
//        p = ((g·tiles_q + ti)·n_sets + s')·tiles_s + tj,
//    so every (item, query tile, slab tile) is covered once, the waves are
//    balanced to one pair and a pass of few sets still fills every SM.  A
//    gated pass's ranges are not equal work (the host does not see which
//    items the gate keeps), so `batched.bucket_launch_plan` gives it more
//    CTAs than fit, each with a short range, for the block scheduler to
//    balance as they finish.  The s'-th set of a range is
//    s = s'·set_step mod n_sets, set_step coprime to n_sets (near
//    n_sets·0.618): the sets of any range are spread over the whole pass,
//    so a run of gated sets (a pass's padding lanes, or the sets far from
//    one query) is shared out among the CTAs.
//  * Resident query tile (template RESIDENT), where the query does not
//    depend on the set (q_ss = q2_ss = 0: stage 2a, a whole bucket against
//    one query, kernel 3): a range stays on one (query, query tile) for many sets, so
//    that tile (all of D) is loaded once when the range reaches it and only
//    the slab streams through the ring.  Per-set queries (both stage-1
//    passes, served pairwise) and a D whose tile does not fit take the
//    streamed instance, whose slots hold a query slice and a set slice.
//  * Row mins stay in registers until the range leaves the (item, query
//    tile), then fold by shuffles and atomicMin; column mins fold per slab
//    tile through a shared row per tile parity, flushed after the next
//    slice's barrier, so they add no barrier of their own.
//  * Directed instance (template DIRECTED): row mins only; min_b is left as
//    given.  Stage 1 runs it.
//  * __launch_bounds__(256, 1), as kernel 1: no instance spills.
//
// Bound on this card: fp32 FFMA throughput.  A computed item does 2·D
// FLOPs per (query row × set row); at the search's shapes (n_q = 128,
// caps 64–256, D = 256) that is ≥ 64 FLOPs per byte even if every query
// re-reads the slab, far above the H100's fp32 ridge point (~20 FLOP/B).
// IEEE fp32 under the fp_margin contract rules out the tensor cores.
//
// Left for later work: a query tile of fewer rows for stage 1's small
// subsets (n_q of tens of rows fills a 128-row tile with zeros), 64-row
// slab tiles for the cap-64 bucket, skipping slab tiles whose rows are all
// invalid (norms +inf) before they are copied, and ranges of equal kept
// work for gated passes (a count of the kept items on the device).
#pragma once

#include <cuda_runtime.h>

#include "minscan_tile.cuh"

namespace minscan_tile {
// Internal linkage, so that each library including this header (kernel
// 2's and kernel 3's) keeps its own instances and its own record of the
// shared-memory limit it has set.  With external linkage the
// function-local statics of these inline templates are GNU-unique
// symbols, which the dynamic loader merges across libraries: the second
// library would find the limit set for the first one's kernels and never
// raise it for its own, and no CTA of its would fit.
namespace {

struct Bucket {
  const float* q;
  long long q_gs, q_ss;
  const float* q2;
  long long q2_gs, q2_ss;
  const float* slab;
  long long s_ss;
  const float* b2;
  long long b2_ss;
  const float* lb;
  const float* cut;
  unsigned* min_a;
  unsigned* min_b;
  long long n_pairs;
  int n_groups, n_sets, n_q, cap, ld, n_k, tiles_q, tiles_s, set_step;
};

// A position in a CTA's range of tile pairs: (g, ti, s, tj), with s the
// set that the order's s' maps to.  Moving it costs no division: s' wraps
// exactly when s returns to 0.
struct BucketCursor {
  long long p;
  int g, ti, s, tj;

  __device__ __forceinline__ static BucketCursor at(const Bucket& k, long long p) {
    BucketCursor c;
    c.p = p;
    c.tj = static_cast<int>(p % k.tiles_s);
    long long r = p / k.tiles_s;
    const long long sp = r % k.n_sets;
    r /= k.n_sets;
    c.ti = static_cast<int>(r % k.tiles_q);
    c.g = static_cast<int>(r / k.tiles_q);
    c.s = static_cast<int>(sp * k.set_step % k.n_sets);
    return c;
  }
  __device__ __forceinline__ void step(const Bucket& k) {
    ++p;
    if (++tj < k.tiles_s) return;
    tj = 0;
    s += k.set_step;
    if (s >= k.n_sets) s -= k.n_sets;
    if (s != 0) return;
    if (++ti == k.tiles_q) {
      ti = 0;
      ++g;
    }
  }
  __device__ __forceinline__ long long item(const Bucket& k) const {
    return static_cast<long long>(g) * k.n_sets + s;
  }
  // To the first pair at or after this one, below end, whose item the gate
  // keeps; a gated item is passed over whole.
  __device__ __forceinline__ void skip_gated(const Bucket& k, long long end) {
    if (k.lb == nullptr) return;
    while (p < end) {
      const long long i = item(k);
      if (k.lb[i] <= k.cut[i]) return;
      p += k.tiles_s - 1 - tj;
      tj = k.tiles_s - 1;
      step(k);
    }
  }
};

template <bool RESIDENT, bool DIRECTED>
__global__ void __launch_bounds__(THREADS, 1) bucket_minscan_kernel(const Bucket k) {
  extern __shared__ __align__(16) float smem[];
  // RESIDENT: [n_k query slices][STAGES set slices]; else STAGES × [query slice, set slice].
  float* const ring = RESIDENT ? smem + k.n_k * SLICE : smem;
  unsigned* const col_s = reinterpret_cast<unsigned*>(ring + STAGES * SLICE * (RESIDENT ? 1 : 2));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7);   // columns tx + 16q
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // rows ty + 16p
  const long long begin = k.n_pairs * blockIdx.x / gridDim.x;
  const long long end = k.n_pairs * (blockIdx.x + 1) / gridDim.x;

  if (!DIRECTED) {
    col_s[tid] = INF_BITS;  // both parities: 2 × 128 slots
  }

  const long long pass_stride = static_cast<long long>(ROWS_PER_PASS) * k.ld;
  const BucketCursor first = BucketCursor::at(k, begin);

  // Producer: the next (pair, slice) to copy into slot `fill`, and this
  // thread's share of that pair's tiles.
  BucketCursor lc = first;
  lc.skip_gated(k, end);
  int lk = 0;
  int fill = 0;
  auto set_src = [&]() { return tile_src(k.slab + lc.s * k.s_ss, k.cap, k.ld, lc.tj * TILE, tid); };
  auto query_src = [&]() {
    return tile_src(k.q + lc.g * k.q_gs + lc.s * k.q_ss, k.n_q, k.ld, lc.ti * TILE, tid);
  };
  TileSrc src_b = set_src();
  TileSrc src_a = RESIDENT ? TileSrc{k.q, 0u} : query_src();
  auto issue = [&]() {
    if (lc.p < end) {
      float* slot = ring + fill * SLICE * (RESIDENT ? 1 : 2);
      if (RESIDENT) {
        load_slice(slot, src_b, k.slab, pass_stride, k.ld, lk * BK, tid);
      } else {
        load_slice(slot, src_a, k.q, pass_stride, k.ld, lk * BK, tid);
        load_slice(slot + SLICE, src_b, k.slab, pass_stride, k.ld, lk * BK, tid);
      }
      if (++lk == k.n_k) {
        lk = 0;
        lc.step(k);
        lc.skip_gated(k, end);
        src_b = set_src();
        if (!RESIDENT) src_a = query_src();
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
    fill = fill + 1 == STAGES ? 0 : fill + 1;
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue();

  float row_min[8], a2r[8];
  unsigned* row_out = nullptr;  // min_a of the rows in row_min: item·n_q + ti·TILE
  int row_n = 0;                // rows of that tile below n_q
  int res_g = -1, res_ti = -1;  // the resident query tile
  unsigned* col_out = nullptr;  // columns waiting in col_s[parity ^ 1]: item·cap + tj·TILE
  int col_n = 0;                // columns of that tile below cap
  int parity = 0;
  int use = 0;  // slot the consumer reads next

  auto flush_rows = [&]() {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      float v = row_min[p];
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      const int r = ty + 16 * p;
      if ((lane & 7) == 0 && r < row_n && __float_as_uint(v) != INF_BITS) {
        atomicMin(row_out + r, __float_as_uint(v));
      }
    }
  };
  auto flush_cols = [&]() {  // after a barrier that follows the tile's epilogue
    unsigned* cs = col_s + (parity ^ 1) * TILE;
    if (tid < TILE) {
      const unsigned v = cs[tid];
      if (tid < col_n && v != INF_BITS) atomicMin(col_out + tid, v);
      cs[tid] = INF_BITS;
    }
  };

  BucketCursor c = first;
  for (c.skip_gated(k, end); c.p < end; c.step(k), c.skip_gated(k, end)) {
    if (c.tj == 0 || c.p == begin) {  // the range enters an (item, query tile)
      if (row_out != nullptr) flush_rows();
      const int row0 = c.ti * TILE;
      row_out = k.min_a + c.item(k) * k.n_q + row0;
      row_n = k.n_q - row0;
      const float* q2 = k.q2 + c.g * k.q2_gs + c.s * k.q2_ss + row0;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int r = ty + 16 * p;
        row_min[p] = __int_as_float(INF_BITS);
        a2r[p] = r < row_n ? q2[r] : __int_as_float(INF_BITS);
      }
      if (RESIDENT && (c.g != res_g || c.ti != res_ti)) {
        res_g = c.g;
        res_ti = c.ti;
        __syncthreads();  // every thread is done with the previous query tile
        const TileSrc tile = tile_src(k.q + c.g * k.q_gs, k.n_q, k.ld, row0, tid);
        for (int ks = 0; ks < k.n_k; ++ks) load_slice(smem + ks * SLICE, tile, k.q, pass_stride, k.ld, ks * BK, tid);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
      }
    }
    // Norms of this tile's columns, read now and used after the k-loop.
    const int col0 = c.tj * TILE;
    const float* b2 = k.b2 + c.s * k.b2_ss + col0;
    float b2r[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = tx + 16 * q;
      b2r[q] = j < k.cap - col0 ? __ldg(b2 + j) : __int_as_float(INF_BITS);
    }

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int ks = 0; ks < k.n_k; ++ks) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // slot `use` has landed; the slot refilled below is free
      if (!DIRECTED && ks == 0 && col_out != nullptr) {
        flush_cols();
        col_out = nullptr;
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
      col_out = k.min_b + c.item(k) * k.cap + col0;
      col_n = k.cap - col0;
      parity ^= 1;
    }
  }
  cp_async_wait_all();  // no copy may outlive the block
  if (row_out != nullptr) flush_rows();
  if (!DIRECTED && col_out != nullptr) {
    __syncthreads();
    flush_cols();
  }
}

// Raise an instance's dynamic shared-memory limit on the current device to
// at least `smem`, once per device and size (a host call saved per launch).
template <bool RESIDENT, bool DIRECTED>
cudaError_t bucket_allow_smem(int smem) {
  constexpr int MAX_DEVICES = 64;
  static int allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(bucket_minscan_kernel<RESIDENT, DIRECTED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = smem;
  return err;
}

template <bool RESIDENT, bool DIRECTED>
cudaError_t bucket_launch_instance(const Bucket& k, int grid, int smem, cudaStream_t s) {
  cudaError_t err = bucket_allow_smem<RESIDENT, DIRECTED>(smem);
  if (err != cudaSuccess) return err;
  bucket_minscan_kernel<RESIDENT, DIRECTED><<<grid, THREADS, smem, s>>>(k);
  return cudaGetLastError();
}

template <bool RESIDENT, bool DIRECTED>
int bucket_occupancy_instance(int smem) {
  if (bucket_allow_smem<RESIDENT, DIRECTED>(smem) != cudaSuccess) return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bucket_minscan_kernel<RESIDENT, DIRECTED>, THREADS,
                                                    smem) != cudaSuccess) {
    return 0;
  }
  return n;
}

// CTAs of a bucket instance that fit on one SM with `smem` bytes (0 on error).
inline int bucket_occupancy(int resident, int directed, int smem) {
  if (resident) {
    return directed ? bucket_occupancy_instance<true, true>(smem) : bucket_occupancy_instance<true, false>(smem);
  }
  return directed ? bucket_occupancy_instance<false, true>(smem) : bucket_occupancy_instance<false, false>(smem);
}

inline long long gcd(long long a, long long b) {
  while (b != 0) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Checks a pass's plan and launches it on `stream`: k's pointers and
// strides set by the caller, its counts and n_k, tiles and pairs here.
// Returns a cudaError_t as int: cudaErrorInvalidValue for a plan that does
// not fit (a resident tile with a per-set query, a shared-memory size that
// is not smem_bytes(ld, resident), a set_step not coprime to n_sets), else
// cudaGetLastError() after the launch.
inline int bucket_launch(Bucket k, int n_groups, int n_sets, int n_q, int cap, int ld, int resident,
                         int directed, int grid, int smem, int set_step, cudaStream_t s) {
  if (n_groups <= 0 || n_sets <= 0 || n_q <= 0 || cap <= 0) return 0;
  if (ld <= 0 || ld % 4 != 0 || grid <= 0 || smem != smem_bytes(ld, resident) || set_step < 1 ||
      (set_step >= n_sets && n_sets > 1) || gcd(set_step, n_sets) != 1 ||
      (resident && (k.q_ss != 0 || k.q2_ss != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  k.n_groups = n_groups;
  k.n_sets = n_sets;
  k.n_q = n_q;
  k.cap = cap;
  k.ld = ld;
  k.n_k = (ld + BK - 1) / BK;
  k.tiles_q = (n_q + TILE - 1) / TILE;
  k.tiles_s = (cap + TILE - 1) / TILE;
  k.set_step = set_step;
  k.n_pairs = static_cast<long long>(n_groups) * k.tiles_q * n_sets * k.tiles_s;
  cudaError_t err;
  if (resident) {
    err = directed ? bucket_launch_instance<true, true>(k, grid, smem, s)
                   : bucket_launch_instance<true, false>(k, grid, smem, s);
  } else {
    err = directed ? bucket_launch_instance<false, true>(k, grid, smem, s)
                   : bucket_launch_instance<false, false>(k, grid, smem, s);
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace minscan_tile
