// Batched bucket min-d² scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_batched_kernel` in
// src/repro/kernels/hausdorff/batched.py:74 (launcher
// `batched_min_sqdists_pallas`, batched.py:123).  It computes what that
// kernel computes: for each set s of a padded bucket slab (S, cap, D) and a
// query (n_q, D), every entry
//
//     d²(s, i, j) = max((q2[s, i] − 2·q_s,i·b_s,j) + b2[s, j], 0)
//
// is folded into the row mins  min_a[s, i] = min_j d²(s, i, j)  (query→set)
// and the column mins  min_b[s, j] = min_i d²(s, i, j)  (set→query).  q2 / b2
// are the hoisted squared norms with +inf at invalid rows (whose data the
// wrapper has zeroed), so invalid rows win neither min.
//
// Per-set gate: set s is computed iff lb[s] <= cut[s].  The test is written
// that way round, so a NaN bound skips the set exactly as the Pallas
// kernel's `pl.when(lb[s] <= cut[s])` does.  A skipped set's outputs keep
// what the wrapper put there (+inf, the certified "farther than cut"
// sentinel) and the CTA does no loads at all.  lb == nullptr disables the
// gate.
//
// Set strides: the query, its norms, the slab and the slab norms each take
// a per-set stride in elements, 0 meaning one operand shared by every set.
// This is the explicit form of the vmap the cascade's stage 1 puts around
// the TPU kernel: per-lane subsets against each lane's set (query stride
// n_q·D, slab stride cap·D) and per-lane subsets against the one query
// (slab stride 0).  Stage 2a is the plain case: shared query, per-set slab.
//
// Design:
//  * One CTA of 256 threads per (set s, 128-row query tile): blockIdx.x is
//    the set, so consecutive CTAs share a query tile through L2.  A CTA
//    walks all of its set's 128-row slab tiles (bucket capacities are
//    64–256, so one or two) with the tile body of minscan_tile.cuh, which
//    kernel 3 shares: kernel 1's 8×8 register blocks and fixed-k-order FFMA
//    chain, so gated vs ungated sets, any grid and any batch composition
//    give the same bits, and a lane equals fused_minscan on that set's rows
//    bit for bit given the same norms.
//  * Row and column mins fold into min_a / min_b with atomicMin on the fp32
//    bit pattern (exact for d² ≥ 0), as kernel 1 does.
//  * The ragged edge (rows past n_q or cap, k past D) is masked in the tile
//    body: no row or D padding in the wrapper.  Inputs are fp32 only.
//
// Bound on this card: fp32 FFMA throughput.  A bucket pass does
// 2·S·n_q·cap·D FLOPs on S·cap·D + n_q·D inputs; at the search's shapes
// (n_q = 128, cap 64–256, D = 256) that is ≥ 64 FLOP per byte, far above
// the H100's fp32 ridge point, so the FP32 pipes bound it.  IEEE fp32 under
// the fp_margin contract rules out the tensor cores.
//
// Left for later work: a narrower slab tile for cap = 64 (half of each
// 128-row tile is masked work there), cp.async / TMA staging, and keeping
// the shared query tile resident across several sets per CTA.

#include <cuda_runtime.h>

#include "minscan_tile.cuh"

namespace {

using minscan_tile::THREADS;
using minscan_tile::TILE;

__global__ void __launch_bounds__(THREADS, 2)
batched_minscan_kernel(const float* __restrict__ q, long long q_stride,
                       const float* __restrict__ q2, long long q2_stride,
                       const float* __restrict__ slab, long long s_stride,
                       const float* __restrict__ b2, long long b2_stride,
                       const float* __restrict__ lb, const float* __restrict__ cut,
                       unsigned* __restrict__ min_a, unsigned* __restrict__ min_b,
                       int n_q, int cap, int d) {
  const long long s = blockIdx.x;
  if (lb != nullptr && !(lb[s] <= cut[s])) return;  // uniform across the CTA
  minscan_tile::scan_pair(q + s * q_stride, q2 + s * q2_stride, slab + s * s_stride,
                          b2 + s * b2_stride, min_a + s * n_q, min_b + s * cap,
                          n_q, cap, d, blockIdx.y * TILE);
}

}  // namespace

// Launches one bucket pass on `stream`.  min_a (n_sets, n_q) and min_b
// (n_sets, cap), row-major, must hold +inf (or earlier partial mins to fold
// into).  Strides are per set, in elements; 0 shares one operand across
// sets.  lb may be null (no gate); then cut is ignored.  Returns
// cudaGetLastError() after the launch.
extern "C" int batched_minscan(const float* q, long long q_stride,
                               const float* q2, long long q2_stride,
                               const float* slab, long long s_stride,
                               const float* b2, long long b2_stride,
                               const float* lb, const float* cut,
                               float* min_a, float* min_b,
                               int n_sets, int n_q, int cap, int d, void* stream) {
  if (n_sets <= 0 || n_q <= 0 || cap <= 0) return 0;
  const dim3 grid(n_sets, (n_q + TILE - 1) / TILE);
  batched_minscan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, q_stride, q2, q2_stride, slab, s_stride, b2, b2_stride, lb, cut,
      reinterpret_cast<unsigned*>(min_a), reinterpret_cast<unsigned*>(min_b),
      n_q, cap, d);
  return static_cast<int>(cudaGetLastError());
}
