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
//    64–256, so one or two) and keeps its 8 row mins per thread in
//    registers across them; the row fold needs no other CTA.
//  * The tile body is kernel 1's (fused_minscan.cu): 8×8 register blocks,
//    k-slices of 8 through double-buffered shared memory.  Every dot
//    product is one thread's fp32 FFMA chain over k = 0..D-1 in a fixed
//    order, so gated vs ungated sets, any grid and any batch composition
//    give the same bits, and a lane equals fused_minscan on that set's rows
//    bit for bit given the same norms.  The clamp is `d2 > 0 ? d2 : 0`.
//  * Column mins cross the query tiles of one set: they are reduced per
//    tile in shared memory and folded into min_b with atomicMin on the fp32
//    bit pattern as unsigned int (exact and order-independent for d² ≥ 0),
//    as kernel 1 does; row mins take the same atomicMin.
//  * The ragged edge (rows past n_q or cap, k past D) is masked here: no
//    row or D padding in the wrapper.  Inputs are fp32 only.
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

namespace {

constexpr int TILE = 128;               // rows of the query and of a set per tile
constexpr int BK = 8;                   // k-slice staged per step
constexpr int THREADS = 256;            // 16 × 16 threads, 8 × 8 entries each
constexpr int PITCH = TILE + 4;         // padded smem row: conflict-free stores
constexpr unsigned INF_BITS = 0x7f800000u;

// Thread t stages row (t >> 1) of the tile, k-slots (t & 1)·4 .. +3.
__device__ __forceinline__ void load_slice(const float* __restrict__ x, int n, int d,
                                           int row0, int k0, int tid, float (&r)[4]) {
  const int row = row0 + (tid >> 1);
  const int k = k0 + (tid & 1) * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    r[q] = (row < n && k + q < d) ? x[(long long)row * d + k + q] : 0.f;
  }
}

__device__ __forceinline__ void store_slice(float (*s)[PITCH], int tid, const float (&r)[4]) {
  const int row = tid >> 1;
  const int k = (tid & 1) * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) s[k + q][row] = r[q];
}

// Local row / column of a thread's q-th entry: two groups of 4, 64 apart.
__device__ __forceinline__ int local_index(int t16, int q) {
  return (q < 4) ? t16 * 4 + q : 64 + t16 * 4 + (q - 4);
}

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

  __shared__ __align__(16) float As[2][BK][PITCH];
  __shared__ __align__(16) float Bs[2][BK][PITCH];
  __shared__ unsigned col_min_s[TILE];

  const float* a = q + s * q_stride;
  const float* a2 = q2 + s * q2_stride;
  const float* b = slab + s * s_stride;
  const float* bn = b2 + s * b2_stride;
  unsigned* out_a = min_a + s * n_q;
  unsigned* out_b = min_b + s * cap;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.y * TILE;
  const int n_tiles_b = (cap + TILE - 1) / TILE;
  const int n_k = (d + BK - 1) / BK;

  float row_min[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) row_min[r] = __int_as_float(0x7f800000);

  for (int tj = 0; tj < n_tiles_b; ++tj) {
    const int col0 = tj * TILE;
    // Same thread resets the slot it flushed for the previous tile.
    if (tid < TILE) col_min_s[tid] = INF_BITS;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    float ra[4], rb[4];
    load_slice(a, n_q, d, row0, 0, tid, ra);
    load_slice(b, cap, d, col0, 0, tid, rb);
    store_slice(As[0], tid, ra);
    store_slice(Bs[0], tid, rb);
    __syncthreads();

    for (int ks = 0; ks < n_k; ++ks) {
      const int cur = ks & 1;
      const bool more = ks + 1 < n_k;
      if (more) {
        load_slice(a, n_q, d, row0, (ks + 1) * BK, tid, ra);
        load_slice(b, cap, d, col0, (ks + 1) * BK, tid, rb);
      }
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
        const float fa[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float fb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(fa[i], fb[j], acc[i][j]);
      }
      if (more) {
        store_slice(As[cur ^ 1], tid, ra);
        store_slice(Bs[cur ^ 1], tid, rb);
      }
      __syncthreads();
    }

    // Norms are read here, not held across the k-loop: registers are scarce.
    float a2r[8], b2r[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = row0 + local_index(ty, r);
      const int j = col0 + local_index(tx, r);
      a2r[r] = (i < n_q) ? a2[i] : __int_as_float(0x7f800000);
      b2r[r] = (j < cap) ? bn[j] : __int_as_float(0x7f800000);
    }
    float col_min[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) col_min[j] = __int_as_float(0x7f800000);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = (a2r[i] - 2.f * acc[i][j]) + b2r[j];
        v = v > 0.f ? v : 0.f;
        row_min[i] = fminf(row_min[i], v);
        col_min[j] = fminf(col_min[j], v);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      col_min[j] = fminf(col_min[j], __shfl_xor_sync(0xffffffffu, col_min[j], 16));
    }
    if ((tid & 16) == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) atomicMin(&col_min_s[local_index(tx, j)], __float_as_uint(col_min[j]));
    }
    __syncthreads();
    if (tid < TILE && col0 + tid < cap && col_min_s[tid] != INF_BITS) {
      atomicMin(&out_b[col0 + tid], col_min_s[tid]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = row_min[i];
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 8));
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 4));
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    const int r = row0 + local_index(ty, i);
    if (tx == 0 && r < n_q && __float_as_uint(v) != INF_BITS) {
      atomicMin(&out_a[r], __float_as_uint(v));
    }
  }
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
