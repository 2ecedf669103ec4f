// Fused bidirectional min-d² scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_fused_kernel` in
// src/repro/kernels/hausdorff/hausdorff.py:89 (launcher
// `fused_min_sqdists_pallas`, hausdorff.py:145).  It computes what that
// kernel computes, not how: for a (n_a, D) and b (n_b, D), every entry
//
//     d²(i, j) = max((a2[i] − 2·a_i·b_j) + b2[j], 0)
//
// is folded into the row mins  min_a[i] = min_j d²(i, j)  (A→B) and the
// column mins  min_b[j] = min_i d²(i, j)  (B→A) in one pass.  a2 / b2 are
// the hoisted squared norms with +inf at invalid rows (whose data the
// wrapper has zeroed), so invalid rows win neither min.
//
// Design:
//  * A CTA of 256 threads owns one 128-row a-tile and a chunk of 128-row
//    b-tiles (2-D grid: a-tile × b-chunk, so a small query side still
//    fills the card).  Each thread holds an 8×8 block of dot products in
//    registers; k-slices of 8 are staged through double-buffered shared
//    memory.
//  * Every dot product is accumulated with fp32 FFMA over k = 0..D-1 in
//    one fixed order, on the CUDA cores.  Tensor cores take no IEEE fp32
//    and TF32 would break the fp32 margin contract.  Since an entry's bits
//    do not depend on the tile grid, pruned == unpruned and any chunking
//    give bitwise-equal outputs.
//  * The Pallas kernel kept the column-min row resident across a
//    sequential grid; blocks here run in any order.  Both mins are folded
//    across CTAs with atomicMin on the fp32 bit pattern as unsigned int
//    into outputs the wrapper set to +inf.  For d² ≥ 0 the unsigned order
//    is the float order, so the fold is exact and order-independent.  The
//    clamp is `d2 > 0 ? d2 : 0`, never fmaxf, so −0.0 cannot reach it.
//  * Gate: a b-tile is skipped, before anything is loaded, iff
//    lb[I, J] > cut_a[I] and lb[I, J] > cut_b[J], where (I, J) is the
//    prune-table block the tile lies in (table blocks are whole multiples
//    of the 128-row tile).  lb == nullptr disables the gate.  cut_b = −inf
//    (directed callers) makes the column condition vacuous.
//  * Inputs are fp32 or bf16, converted to fp32 on load.
//
// Bound on this card: fp32 FFMA throughput.  The scan does 2·n_a·n_b·D
// FLOPs (one FMA per entry and k) on (n_a + n_b)·D inputs, far above the
// H100's fp32 ridge point, so the FP32 pipes (128 lanes × 2 FLOP per SM
// per clock) bound it, not HBM.
//
// Left for later work: cp.async / TMA staging with a deeper pipeline, a
// warp-specialised producer, larger register tiles or a persistent grid,
// and a directed-only specialisation that drops the column fold.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TILE = 128;               // rows of a and of b per CTA tile
constexpr int BK = 8;                   // k-slice staged per step
constexpr int THREADS = 256;            // 16 × 16 threads, 8 × 8 entries each
constexpr int PITCH = TILE + 4;         // padded smem row: conflict-free stores
constexpr unsigned INF_BITS = 0x7f800000u;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Thread t stages row (t >> 1) of the tile, k-slots (t & 1)·4 .. +3.
template <typename T>
__device__ __forceinline__ void load_slice(const T* __restrict__ x, int n, int d,
                                           int row0, int k0, int tid, float (&r)[4]) {
  const int row = row0 + (tid >> 1);
  const int k = k0 + (tid & 1) * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    r[q] = (row < n && k + q < d) ? to_f32(x[(long long)row * d + k + q]) : 0.f;
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

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
fused_minscan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     const float* __restrict__ a2, const float* __restrict__ b2,
                     const float* __restrict__ lb, long long ld_lb,
                     const float* __restrict__ cut_a, const float* __restrict__ cut_b,
                     unsigned* __restrict__ min_a, unsigned* __restrict__ min_b,
                     int n_a, int n_b, int d,
                     int tiles_per_block_a, int tiles_per_block_b, int tiles_per_chunk) {
  __shared__ __align__(16) float As[2][BK][PITCH];
  __shared__ __align__(16) float Bs[2][BK][PITCH];
  __shared__ unsigned col_min_s[TILE];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int ti = blockIdx.x;
  const int row0 = ti * TILE;
  const int n_tiles_b = (n_b + TILE - 1) / TILE;
  const int tj0 = blockIdx.y * tiles_per_chunk;
  const int tj1 = min(tj0 + tiles_per_chunk, n_tiles_b);
  const int bi = ti / tiles_per_block_a;
  const int n_k = (d + BK - 1) / BK;

  float row_min[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) row_min[q] = __int_as_float(0x7f800000);

  for (int tj = tj0; tj < tj1; ++tj) {
    if (lb != nullptr) {
      const int bj = tj / tiles_per_block_b;
      const float l = lb[(long long)bi * ld_lb + bj];
      if (l > cut_a[bi] && l > cut_b[bj]) continue;  // uniform across the CTA
    }
    const int col0 = tj * TILE;
    // Same thread resets the slot it flushed for the previous tile.
    if (tid < TILE) col_min_s[tid] = INF_BITS;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    float ra[4], rb[4];
    load_slice(a, n_a, d, row0, 0, tid, ra);
    load_slice(b, n_b, d, col0, 0, tid, rb);
    store_slice(As[0], tid, ra);
    store_slice(Bs[0], tid, rb);
    __syncthreads();

    for (int s = 0; s < n_k; ++s) {
      const int cur = s & 1;
      const bool more = s + 1 < n_k;
      if (more) {
        load_slice(a, n_a, d, row0, (s + 1) * BK, tid, ra);
        load_slice(b, n_b, d, col0, (s + 1) * BK, tid, rb);
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
    for (int q = 0; q < 8; ++q) {
      const int r = row0 + local_index(ty, q);
      const int c = col0 + local_index(tx, q);
      a2r[q] = (r < n_a) ? a2[r] : __int_as_float(0x7f800000);
      b2r[q] = (c < n_b) ? b2[c] : __int_as_float(0x7f800000);
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
    if (tid < TILE && col0 + tid < n_b && col_min_s[tid] != INF_BITS) {
      atomicMin(&min_b[col0 + tid], col_min_s[tid]);
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
    if (tx == 0 && r < n_a && __float_as_uint(v) != INF_BITS) {
      atomicMin(&min_a[r], __float_as_uint(v));
    }
  }
}

}  // namespace

// Launches one scan on `stream`.  dtype: 0 = fp32, 1 = bf16.  min_a /
// min_b must hold +inf (or earlier partial mins to fold into).  lb may be
// null (no gate); then ld_lb, cut_a and cut_b are ignored.  Returns
// cudaGetLastError() after the launch.
extern "C" int fused_minscan(const void* a, const void* b, int dtype,
                             const float* a2, const float* b2,
                             const float* lb, long long ld_lb,
                             const float* cut_a, const float* cut_b,
                             float* min_a, float* min_b,
                             int n_a, int n_b, int d,
                             int tiles_per_block_a, int tiles_per_block_b,
                             int tiles_per_chunk, void* stream) {
  if (n_a <= 0 || n_b <= 0) return 0;
  const int tiles_a = (n_a + TILE - 1) / TILE;
  const int tiles_b = (n_b + TILE - 1) / TILE;
  const dim3 grid(tiles_a, (tiles_b + tiles_per_chunk - 1) / tiles_per_chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* ua = reinterpret_cast<unsigned*>(min_a);
  unsigned* ub = reinterpret_cast<unsigned*>(min_b);
  if (dtype == 1) {
    fused_minscan_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        a2, b2, lb, ld_lb, cut_a, cut_b, ua, ub, n_a, n_b, d,
        tiles_per_block_a, tiles_per_block_b, tiles_per_chunk);
  } else {
    fused_minscan_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        a2, b2, lb, ld_lb, cut_a, cut_b, ua, ub, n_a, n_b, d,
        tiles_per_block_a, tiles_per_block_b, tiles_per_chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
