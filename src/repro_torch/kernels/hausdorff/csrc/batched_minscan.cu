// Batched bucket min-d² scan for Hopper (sm_90a), plain C interface:
// kernel 2.
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
// and, in the bidirectional instance, the column mins
// min_b[s, j] = min_i d²(s, i, j)  (set→query).  Set s is computed iff
// lb[s] <= cut[s] (a NaN bound skips it, as `pl.when(lb[s] <= cut[s])`
// does); a skipped set's outputs keep the +inf the wrapper put there.
//
// Set strides: the query, its norms, the slab and the slab norms each take
// a per-set stride in floats, 0 meaning one operand shared by every set.
// This is the explicit form of the vmap the cascade's stage 1 puts around
// the TPU kernel: per-lane subsets against each lane's set (query stride
// n_q·ld, slab stride cap·ld) and per-lane subsets against the one query
// (slab stride 0).  Stage 2a is the plain case: shared query, per-set slab.
//
// The kernel is the bucket scan of bucket_scan.cuh (one group of items,
// item s = set s), on kernel 1's tile body: a persistent grid over (set,
// query tile, slab tile) pairs, the shared query's tile resident in shared
// memory, a directed instance for stage 1, and every entry's bits those of
// fused_minscan on the set's rows with the same norms.

#include <cuda_runtime.h>

#include "bucket_scan.cuh"

// CTAs of an instance that fit on one SM with `smem` bytes (0 on error).
extern "C" int batched_minscan_occupancy(int resident, int directed, int smem) {
  return minscan_tile::bucket_occupancy(resident, directed, smem);
}

// Launches one bucket pass on `stream` over `grid` persistent CTAs.  q,
// slab: fp32 rows of ld floats (a multiple of 4), 16-byte aligned, zero
// past D.  min_a (n_sets, n_q) and min_b (n_sets, cap), row-major, must
// hold +inf (or earlier partial mins to fold into); directed != 0 leaves
// min_b as given.  Strides are per set, in floats; 0 shares one operand
// across sets, and a resident query tile needs q_stride = q2_stride = 0.
// lb may be null (no gate); then cut is ignored.  smem must be
// smem_bytes(ld, resident) and set_step coprime to n_sets, below it
// (`batched.bucket_launch_plan`).  Returns cudaErrorInvalidValue for a
// plan that does not fit, else cudaGetLastError() after the launch.
extern "C" int batched_minscan(const float* q, long long q_stride, const float* q2, long long q2_stride,
                               const float* slab, long long s_stride, const float* b2, long long b2_stride,
                               const float* lb, const float* cut, float* min_a, float* min_b,
                               int n_sets, int n_q, int cap, int ld, int resident, int directed,
                               int grid, int smem, int set_step, void* stream) {
  minscan_tile::Bucket k{};
  k.q = q;
  k.q_ss = q_stride;
  k.q2 = q2;
  k.q2_ss = q2_stride;
  k.slab = slab;
  k.s_ss = s_stride;
  k.b2 = b2;
  k.b2_ss = b2_stride;
  k.lb = lb;
  k.cut = cut;
  k.min_a = reinterpret_cast<unsigned*>(min_a);
  k.min_b = reinterpret_cast<unsigned*>(min_b);
  return minscan_tile::bucket_launch(k, 1, n_sets, n_q, cap, ld, resident, directed, grid, smem, set_step,
                                     static_cast<cudaStream_t>(stream));
}
