// The tile body of the three min-d² scans for Hopper (sm_90a): kernel 1
// (fused_minscan.cu) and the bucket scans, kernel 2 (batched_minscan.cu)
// and kernel 3 (multiquery_minscan.cu).  Every entry
//
//     d²(i, j) = max((a2[i] − 2·a_i·b_j) + b2[j], 0)
//
// is one fmaf chain over k = 0..D−1 in order, from +0, in IEEE fp32 on the
// CUDA cores, with the epilogue (a2 − 2·acc) + b2 and the clamp
// `v > 0 ? v : 0` (never fmaxf, so −0.0 cannot reach a fold).  a2 / b2 are
// the hoisted squared norms with +inf at invalid rows (whose data the
// wrapper has zeroed), so invalid rows win neither min.  Folds are
// atomicMin on the fp32 bits as unsigned int into outputs that hold +inf
// or earlier partial mins (for d² ≥ 0 the unsigned order is the float
// order, so a fold is exact and independent of the order of CTAs).  An
// entry's bits therefore depend on nothing but its two rows and norms: the
// three kernels, any grid, gate, batch or instance give the same bits.
//
// What is shared (designed for kernel 1 first; its notes are in
// fused_minscan.cu):
//  * Operands arrive as fp32 rows of `ld` floats (D rounded up to 4),
//    16-byte aligned, zero past D: a zero k-term leaves the chain's bits
//    alone, since the accumulator never holds −0.
//  * A CTA of 256 threads computes 128×128 tile pairs, each thread an 8×8
//    block in registers, rows ty + 16p and columns tx + 16q, read as
//    float4 along k from [row][k] stages whose row pitch (BK + 4 floats)
//    is an odd number of 16-byte units: one wavefront per 4 (a) or 8 (b)
//    rows, no bank conflict.  Per 4 k a thread issues 16 LDS.128 for 256
//    FFMA.
//  * BK-wide k-slices are copied by cp.async (16 B, L2 only, zero-fill past
//    the ragged row and k edge) into a ring of STAGES slots; a thread sets
//    up its copy addresses once per tile (TileSrc), so a slice costs no
//    address arithmetic.
//
// The bucket scan of kernels 2 and 3 over this body is bucket_scan.cuh.
#pragma once

#include <cuda_runtime.h>

// Tuning knobs, overridden only by scripts/minscan_levers.py, which builds
// variants of kernel 1 to measure what each design lever gives.
#ifndef MINSCAN_BK
#define MINSCAN_BK 32
#endif
#ifndef MINSCAN_STAGES
#define MINSCAN_STAGES 3
#endif
#ifndef MINSCAN_KK_UNROLL
#define MINSCAN_KK_UNROLL 8
#endif

namespace minscan_tile {

constexpr int TILE = 128;                 // rows of a and of b per tile
constexpr int BK = MINSCAN_BK;            // k-slice per ring slot
constexpr int STAGES = MINSCAN_STAGES;    // ring slots
constexpr int KK_UNROLL = MINSCAN_KK_UNROLL;  // 4-k steps of a slice unrolled
constexpr int THREADS = 256;              // 16 × 16 threads, 8 × 8 entries each
constexpr int PITCH = BK + 4;             // stage row pitch in floats, odd in 16 B units
constexpr int SLICE = TILE * PITCH;       // floats of one 128-row k-slice
constexpr unsigned INF_BITS = 0x7f800000u;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

constexpr int CHUNKS_PER_ROW = BK / 4;                 // 16-byte chunks of a slice row
constexpr int ROWS_PER_PASS = THREADS / CHUNKS_PER_ROW;  // rows one pass of the CTA copies
constexpr int PASSES = TILE / ROWS_PER_PASS;             // passes per 128-row slice

// One thread's share of copying a 128-row tile of x (n rows of stride ld
// floats), set up once per tile so that a slice costs no address
// arithmetic: the thread moves chunk (tid % CHUNKS_PER_ROW) of rows
// r0 + ROWS_PER_PASS·i, r0 = tid / CHUNKS_PER_ROW, so a warp reads whole
// row segments.
struct TileSrc {
  const float* row;  // x + (row0 + r0)·ld + kc
  unsigned ok;       // bit i: row row0 + r0 + ROWS_PER_PASS·i < n
};

__device__ __forceinline__ TileSrc tile_src(const float* x, int n, int ld, int row0, int tid) {
  const int r0 = tid / CHUNKS_PER_ROW;
  const int kc = (tid % CHUNKS_PER_ROW) * 4;
  TileSrc t{x + static_cast<long long>(row0 + r0) * ld + kc, 0u};
#pragma unroll
  for (int i = 0; i < PASSES; ++i) t.ok |= (row0 + r0 + i * ROWS_PER_PASS < n ? 1u : 0u) << i;
  return t;
}

// Copy k0..k0+BK−1 of the tile into one [row][PITCH] slice (zero-fill past
// the ragged row and k edge; x is a safe address for the empty copies).
__device__ __forceinline__ void load_slice(float* __restrict__ dst, const TileSrc& t, const float* x,
                                           long long pass_stride, int ld, int k0, int tid) {
  const int kc = (tid % CHUNKS_PER_ROW) * 4;
  float* d = dst + (tid / CHUNKS_PER_ROW) * PITCH + kc;
  const bool k_ok = k0 + kc < ld;
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const bool ok = k_ok && ((t.ok >> i) & 1u);
    cp_async16(d + i * ROWS_PER_PASS * PITCH, ok ? t.row + i * pass_stride + k0 : x, ok);
  }
}

// acc[p][q] += Σ_k a[ty + 16p][k] · b[tx + 16q][k] over one BK-wide slice,
// one fmaf per k in ascending order.
__device__ __forceinline__ void mma_slice(const float* __restrict__ as, const float* __restrict__ bs,
                                          int ty, int tx, float (&acc)[8][8]) {
  const float* ap = as + ty * PITCH;
  const float* bp = bs + tx * PITCH;
#pragma unroll (KK_UNROLL)
  for (int kk = 0; kk < BK; kk += 4) {
    float4 av[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) av[p] = *reinterpret_cast<const float4*>(ap + p * 16 * PITCH + kk);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 bv = *reinterpret_cast<const float4*>(bp + q * 16 * PITCH + kk);
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        float t = acc[p][q];
        t = fmaf(av[p].x, bv.x, t);
        t = fmaf(av[p].y, bv.y, t);
        t = fmaf(av[p].z, bv.z, t);
        t = fmaf(av[p].w, bv.w, t);
        acc[p][q] = t;
      }
    }
  }
}

// Dynamic shared memory of one CTA for rows of stride ld floats: the
// resident tile's k-slices (if any), the ring (one slice a slot resident,
// two streamed) and the two column-min rows.
inline int smem_bytes(int ld, int resident) {
  const int n_k = (ld + BK - 1) / BK;
  const int slices = resident ? n_k + STAGES : 2 * STAGES;
  return slices * SLICE * static_cast<int>(sizeof(float)) + 2 * TILE * static_cast<int>(sizeof(unsigned));
}

}  // namespace minscan_tile
