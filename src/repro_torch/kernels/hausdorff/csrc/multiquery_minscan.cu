// Multi-query bucket min-d² scan for Hopper (sm_90a), plain C interface:
// kernel 3.
//
// Replaces the Pallas TPU kernel `_multiquery_kernel` in
// src/repro/kernels/hausdorff/batched.py:378 (launcher
// `multiquery_min_sqdists_pallas`, batched.py:431).  It computes what that
// kernel computes: for a query batch qs (Q, n_q, D) and a padded bucket
// slab (S, cap, D), for every (query q, set s) pair every entry
//
//     d²(q, s, i, j) = max((q2[q, i] − 2·qs[q, i]·slab[s, j]) + b2[s, j], 0)
//
// is folded into min_a[q, s, i] = min_j d² (query→set) and, in the
// bidirectional instance, min_b[q, s, j] = min_i d² (set→query).  Pair
// (q, s) is computed iff lb[q, s] <= cut[q, s] (a NaN bound gates it, as
// `pl.when(lb[qq, s] <= cut[qq, s])` does); a gated pair's outputs keep the
// +inf the wrapper put there.
//
// The kernel is the bucket scan of bucket_scan.cuh with Q groups (item
// (q, s)), on kernel 1's tile body.  Its pairs run query-major: a CTA's
// range stays on one query tile across many sets, which it keeps resident
// in shared memory, and streams the slab once per query (Q · S · cap · D
// floats in all; at the search's shapes still ≥ 64 FLOPs per streamed
// byte, above the fp32 ridge point).  The other order, slab-resident with
// the queries streaming, would walk at most Q pairs per resident tile
// (Q ≤ 16 in a served flush) against hundreds of sets per query tile, and
// would fold row mins out of registers at every pair.  Each pair's bits
// are those of kernel 2 launched with query q against set s (and of
// kernel 1), for any Q, gate, plan or batch.

#include <cuda_runtime.h>

#include "bucket_scan.cuh"

// CTAs of an instance that fit on one SM with `smem` bytes (0 on error).
extern "C" int multiquery_minscan_occupancy(int resident, int directed, int smem) {
  return minscan_tile::bucket_occupancy(resident, directed, smem);
}

// Launches one multi-query bucket pass on `stream` over `grid` persistent
// CTAs.  qs (Q, n_q, ld) and slab (S, cap, ld): contiguous fp32 rows of ld
// floats (a multiple of 4), 16-byte aligned, zero past D; q2 (Q, n_q) and
// b2 (S, cap) contiguous.  min_a (Q, S, n_q) and min_b (Q, S, cap),
// row-major, must hold +inf (or earlier partial mins to fold into);
// directed != 0 leaves min_b as given.  lb / cut are (Q, S) row-major; lb
// may be null (no gate), then cut is ignored.  smem must be
// smem_bytes(ld, resident) and set_step coprime to n_sets, below it
// (`batched.bucket_launch_plan`).  Returns cudaErrorInvalidValue for a
// plan that does not fit, else cudaGetLastError() after the launch.
extern "C" int multiquery_minscan(const float* qs, const float* q2, const float* slab, const float* b2,
                                  const float* lb, const float* cut, float* min_a, float* min_b,
                                  int n_queries, int n_sets, int n_q, int cap, int ld, int resident,
                                  int directed, int grid, int smem, int set_step, void* stream) {
  minscan_tile::Bucket k{};
  k.q = qs;
  k.q_gs = static_cast<long long>(n_q) * ld;
  k.q2 = q2;
  k.q2_gs = n_q;
  k.slab = slab;
  k.s_ss = static_cast<long long>(cap) * ld;
  k.b2 = b2;
  k.b2_ss = cap;
  k.lb = lb;
  k.cut = cut;
  k.min_a = reinterpret_cast<unsigned*>(min_a);
  k.min_b = reinterpret_cast<unsigned*>(min_b);
  return minscan_tile::bucket_launch(k, n_queries, n_sets, n_q, cap, ld, resident, directed, grid, smem,
                                     set_step, static_cast<cudaStream_t>(stream));
}
