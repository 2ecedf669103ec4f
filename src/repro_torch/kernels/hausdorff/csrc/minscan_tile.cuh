// The tile body shared by the bucket scans (batched_minscan.cu, kernel 2,
// and multiquery_minscan.cu, kernel 3): one CTA of 256 threads folds one
// 128-row query tile of one (query, set) pair against every 128-row tile
// of the set, into the pair's row mins and column mins.
//
//     d²(i, j) = max((a2[i] − 2·a_i·b_j) + b2[j], 0)
//
// a2 / b2 are the hoisted squared norms with +inf at invalid rows (whose
// data the wrapper has zeroed), so invalid rows win neither min.  This is
// kernel 1's tile body (fused_minscan.cu): 8×8 register blocks, k-slices of
// 8 through double-buffered shared memory, and every dot product one
// thread's fp32 FFMA chain over k = 0..D-1 in a fixed order.  So the bits
// of a pair depend on nothing but its rows and norms: any grid, gate or
// batch gives the same bits, and both kernels equal kernel 1 on the pair.
// The clamp is `d2 > 0 ? d2 : 0`.
//
// Row mins stay in registers across the set's tiles and need no other CTA;
// column mins are reduced per tile in shared memory.  Both fold into the
// outputs with atomicMin on the fp32 bit pattern as unsigned int (exact and
// order-independent for d² ≥ 0), since several query tiles share a set.
// The ragged edge (rows past n_q or cap, k past D) is masked here.
#pragma once

#include <cuda_runtime.h>

namespace minscan_tile {

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

// One CTA: query rows row0 .. row0+127 of `a` (n_q rows, norms a2) against
// every tile of the set `b` (cap rows, norms bn), folded into out_a (n_q,)
// and out_b (cap,), which hold +inf or earlier partial mins.
__device__ __forceinline__ void scan_pair(const float* __restrict__ a, const float* __restrict__ a2,
                                          const float* __restrict__ b, const float* __restrict__ bn,
                                          unsigned* __restrict__ out_a, unsigned* __restrict__ out_b,
                                          int n_q, int cap, int d, int row0) {
  __shared__ __align__(16) float As[2][BK][PITCH];
  __shared__ __align__(16) float Bs[2][BK][PITCH];
  __shared__ unsigned col_min_s[TILE];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
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

}  // namespace minscan_tile
