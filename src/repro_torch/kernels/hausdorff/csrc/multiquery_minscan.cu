// Multi-query bucket min-d² scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_multiquery_kernel` in
// src/repro/kernels/hausdorff/batched.py:378 (launcher
// `multiquery_min_sqdists_pallas`, batched.py:431).  It computes what that
// kernel computes: for a query batch qs (Q, n_q, D) and a padded bucket
// slab (S, cap, D), for every (query q, set s) pair every entry
//
//     d²(q, s, i, j) = max((q2[q, i] − 2·qs[q, i]·slab[s, j]) + b2[s, j], 0)
//
// is folded into min_a[q, s, i] = min_j d² (query→set) and
// min_b[q, s, j] = min_i d² (set→query).  q2 / b2 are the hoisted squared
// norms with +inf at invalid rows (whose data the wrapper has zeroed).
//
// Per-(query, set) gate: pair (q, s) is computed iff lb[q, s] <= cut[q, s].
// The test is written that way round, so a NaN bound gates the pair as the
// Pallas kernel's `pl.when(lb[qq, s] <= cut[qq, s])` does.  A gated CTA
// returns before any load and the pair's outputs keep the +inf the wrapper
// put there (the certified "farther than this query's cut" sentinel).
// lb == nullptr disables the gate.
//
// Design:
//  * One CTA of 256 threads per (query q, set s, 128-row query tile), with
//    the tile body of minscan_tile.cuh (kernel 2's): it walks all of set
//    s's 128-row slab tiles (caps are 64–256, so one or two), keeps its row
//    mins in registers and folds column mins across query tiles with
//    atomicMin on the fp32 bits.  Each pair's bits are therefore those of
//    kernel 2 launched with query q against set s (and of kernel 1), for
//    any Q, gate or batch.
//  * blockIdx.x is s·Q + q: the query varies fastest, so the Q CTAs that
//    read set s's slab run side by side and share it through the 50 MB L2.
//    That is the reference's shared-slab idea (batched.py:364-375), done by
//    grid order instead of a slab block resident across the query sweep.
//    Query tiles go on blockIdx.y (at most 65,535); blockIdx.x takes up to
//    2^31 − 1 pairs.
//  * The ragged edge (rows past n_q or cap, k past D) is masked in the tile
//    body: no row or D padding in the wrapper.  Inputs are fp32 only.
//
// Bound on this card: fp32 FFMA throughput.  A computed pair does 2·D FLOPs
// per (valid query row × valid slab row); IEEE fp32 under the fp_margin
// contract rules out the tensor cores.  If the L2 reuse holds, the slab is
// read from device memory once per launch; if not, up to Q times.  At the
// search's shapes (n_q = 128, D = 256) either way is far above the fp32
// ridge point.
//
// Left for later work: cp.async / TMA staging, a narrower slab tile for
// cap = 64 (half of each 128-row tile is masked work there), and keeping a
// query tile resident across several sets per CTA.

#include <cuda_runtime.h>

#include "minscan_tile.cuh"

namespace {

using minscan_tile::THREADS;
using minscan_tile::TILE;

__global__ void __launch_bounds__(THREADS, 2)
multiquery_minscan_kernel(const float* __restrict__ qs, const float* __restrict__ q2,
                          const float* __restrict__ slab, const float* __restrict__ b2,
                          const float* __restrict__ lb, const float* __restrict__ cut,
                          unsigned* __restrict__ min_a, unsigned* __restrict__ min_b,
                          int n_queries, int n_sets, int n_q, int cap, int d) {
  const long long q = blockIdx.x % n_queries;
  const long long s = blockIdx.x / n_queries;
  const long long pair = q * n_sets + s;  // row-major (Q, S) index
  if (lb != nullptr && !(lb[pair] <= cut[pair])) return;  // uniform across the CTA
  minscan_tile::scan_pair(qs + q * n_q * d, q2 + q * n_q, slab + s * cap * d, b2 + s * cap,
                          min_a + pair * n_q, min_b + pair * cap, n_q, cap, d,
                          blockIdx.y * TILE);
}

}  // namespace

// Launches one multi-query bucket pass on `stream`.  qs (Q, n_q, D), q2
// (Q, n_q), slab (S, cap, D), b2 (S, cap) contiguous; min_a (Q, S, n_q) and
// min_b (Q, S, cap), row-major, must hold +inf (or earlier partial mins to
// fold into).  lb / cut are (Q, S) row-major; lb may be null (no gate),
// then cut is ignored.  Q·S must fit blockIdx.x and ceil(n_q / 128)
// blockIdx.y.  Returns cudaGetLastError() after the launch.
extern "C" int multiquery_minscan(const float* qs, const float* q2,
                                  const float* slab, const float* b2,
                                  const float* lb, const float* cut,
                                  float* min_a, float* min_b,
                                  int n_queries, int n_sets, int n_q, int cap, int d,
                                  void* stream) {
  if (n_queries <= 0 || n_sets <= 0 || n_q <= 0 || cap <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((long long)n_queries * n_sets), (n_q + TILE - 1) / TILE);
  multiquery_minscan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      qs, q2, slab, b2, lb, cut,
      reinterpret_cast<unsigned*>(min_a), reinterpret_cast<unsigned*>(min_b),
      n_queries, n_sets, n_q, cap, d);
  return static_cast<int>(cudaGetLastError());
}
