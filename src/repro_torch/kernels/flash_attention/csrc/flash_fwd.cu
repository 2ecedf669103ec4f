// Flash attention, forward, fp32, on Hopper's CUDA cores (sm_90a), plain C
// interface.  Route "ffma" of the launcher flash.flash_fwd; bf16 goes to
// the tensor-core kernel of flash_fwd_sm90.cu (route "wgmma"), built into
// the same library.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention/flash.py:38 (wrapper `flash_attention`,
// flash.py:81).  It computes what that kernel computes — the chunked
// online-softmax recurrence of models/layers.py `causal_attention` — not
// how.  For q (B, Sq, H, hd) and k, v (B, Sk, KV, hd), per query row:
//
//     s     = (q · kᵀ, fp32 accumulation) · scale        scale after the dot
//     s     = −1e30 where causal and key k_pos is not visible to q_pos
//             (q_pos = q_offset + row; visible: k_pos ≤ q_pos and
//             q_pos − k_pos < window, see flash_mask.cuh)
//     m_new = max(m, rowmax(s));  p = exp(s − m_new);  corr = exp(m − m_new)
//     l     = l·corr + Σ p                               (fp32 p)
//     acc   = acc·corr + round_to_v_dtype(p) · v         (fp32 accumulation)
//     o     = acc / max(l, 1e−30), cast to q's dtype
//
// with m = −1e30, l = 0, acc = 0 at the start and key tiles taken in order.
//
// Design:
//  * One CTA of 256 threads per (b·h, 64-row query block); query blocks
//    are taken heaviest first (blockIdx.x reversed), so the long causal
//    rows start early (with a window the blocks' work is about equal, and
//    the order harmless).  The CTA walks 64-key tiles of its kv head, staged
//    in shared memory as fp32 with Q; each thread owns 4 query rows
//    (ty + 16i) × 4 keys (tx + 16j) of the score tile and 4 rows × hd/16
//    output columns (tx + 16j).  Rows reduce across the 16 tx lanes of a
//    half-warp with shuffles.  Scores and P·V run on the CUDA cores in
//    fp32 FFMA, one fixed k order per dot product.
//  * GQA by indexing: query head h reads kv head h / (H / KV), which is
//    what the reference's jnp.repeat(k, groups, axis=2) holds, with no
//    expanded copy.
//  * Key tiles wholly after the block's last position, or wholly before
//    its first row's window, are skipped, not masked; masked keys inside the
//    walked tiles get the reference's −1e30 (key_tiles in flash_mask.cuh
//    says why both are exact, rows that see no key included).  Keys past Sk
//    (the ragged edge) get −inf, no weight; rows past Sq are not written.
//    So no shape has to divide the tiles.
//  * p enters l and the P·V product in fp32 (v's dtype), as both reference
//    functions do.
//  * hd ∈ {16, 32, 48, 64, 80, 96, 128, 160, 192, 256} as template
//    instances (the models' 16, 64, 80 and 128 among them); the launcher
//    zero-pads any other hd ≤ 256 to the next instance, which adds exactly
//    0 to every q·k and gives zero output columns, and keeps the true hd's
//    scale.
//
// Bound on this card: the work is 4·hd fp32 FLOPs and one exp per visible
// (q, k) pair on q, k, v, o read or written once, so the CUDA cores' FFMA
// rate bounds it, far above the bytes.  It stays on the CUDA cores because
// Hopper's tensor cores take no fp32 operands, and TF32 would round q, k, v
// and p to 10-bit mantissas, against the reference's fp32 contract.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "flash_mask.cuh"

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 (tx) × 16 (ty)
constexpr float NEG = -1e30f;   // the reference's masked-score sentinel

template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int VEC = 4;  // elements per 16-byte load
  __device__ static void load(const float* p, float (&r)[VEC]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  }
  __device__ static float round(float x) { return x; }
  __device__ static float store(float x) { return x; }
};

// Stage rows row0 .. row0+63 of one head (row r at src + r·stride) into
// dst[r][0..HD) as fp32, zeros past n.  Pointers are 16-byte aligned: the
// launcher checks the tensors, and HD·sizeof(T) is a multiple of 16.
template <typename T, int HD, int PITCH>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          long long stride, int row0, int n, int tid) {
  constexpr int VEC = Elem<T>::VEC;
  constexpr int PER_ROW = HD / VEC;
  for (int idx = tid; idx < BK * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VEC;
    float vals[VEC];
    if (row0 + r < n) {
      Elem<T>::load(src + (long long)(row0 + r) * stride + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      *reinterpret_cast<float4*>(&dst[r * PITCH + c + e]) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
    }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  // Qs and Ks [64][HD + 4], Vs [64][HD], Ps [64][64 + 4], fp32.
  return sizeof(float) * (2 * BQ * (HD + 4) + BK * HD + BQ * (BK + 4));
}

// Two CTAs per SM up to hd 80 (ptxas then holds 128 registers, and none
// spills); above it one, so that ptxas may use up to 255 (held to 128, hd
// 96 and hd 128 spilled).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, HD > 80 ? 1 : 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Sq, int Sk, int H, int KV, float scale, int causal,
                 int q_offset, int window) {
  constexpr int QP = HD + 4;    // Qs / Ks pitch: conflict-free float4 row reads
  constexpr int VP = HD;        // Vs pitch: rows are read along hd
  constexpr int PP = BK + 4;    // Ps pitch
  constexpr int DPT = HD / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QP;
  float* Vs = Ks + BK * QP;
  float* Ps = Vs + BK * VP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);

  const long long q_stride = (long long)H * HD;
  const long long kv_stride = (long long)KV * HD;
  const T* qb = q + ((long long)b * Sq * H + h) * HD;
  const T* kb = k + ((long long)b * Sk * KV + kvh) * HD;
  const T* vb = v + ((long long)b * Sk * KV + kvh) * HD;

  load_tile<T, HD, QP>(Qs, qb, q_stride, q0, Sq, tid);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const KeyTiles tiles = key_tiles(q0, BQ, Sq, Sk, BK, q_offset, window, causal);

  for (int kt = tiles.first; kt < tiles.first + tiles.count; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's P·V reads are done
    load_tile<T, HD, QP>(Ks, kb, kv_stride, k0, Sk, tid);
    load_tile<T, HD, VP>(Vs, vb, kv_stride, k0, Sk, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * QP + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * QP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_offset + q0 + ty + 16 * i;
      float row_max = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (k_pos >= Sk) x = -CUDART_INF_F;         // no key: exp gives 0
        else if (causal && !visible(q_pos, k_pos, window)) x = NEG;  // masked as the reference masks
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      corr[i] = __expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __expf(s[i][j] - m_new);
        row_sum += p;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = Elem<T>::round(p);
      }
      l[i] = l[i] * corr[i] + half_warp_sum(row_sum);
      m[i] = m_new;
    }
    __syncthreads();

    float pv[4][DPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) pv[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * PP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[DPT];
#pragma unroll
        for (int j = 0; j < DPT; ++j) vv[j] = Vs[(c + cc) * VP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? pr[i].x : cc == 1 ? pr[i].y : cc == 2 ? pr[i].z : pr[i].w;
#pragma unroll
          for (int j = 0; j < DPT; ++j) pv[i][j] = fmaf(p, vv[j], pv[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] = acc[i][j] * corr[i] + pv[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * Sq + row) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[tx + 16 * j] = Elem<T>::store(acc[i][j] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
           int KV, float scale, int causal, int q_offset, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KV, scale, causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one fp32 forward pass on `stream`.  q, o: (B, Sq, H, hd); k, v:
// (B, Sk, KV, hd); all contiguous and 16-byte aligned; KV divides H;
// Sk ≥ 1; B·H ≤ 65535.  scale is the reference's 1/√hd of the true head
// dim, rounded to fp32; q_offset is row 0's position and window the sliding
// window (INT_MAX for none), both of the causal mask.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an hd that
// is not an instance).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                         int Sk, int H, int KV, int hd, float scale, int causal, int q_offset,
                         int window, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_FWD_CASE(HD) \
  case HD: return launch<float, HD>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal, q_offset, window, s);
  switch (hd) {
    FLASH_FWD_CASE(16)
    FLASH_FWD_CASE(32)
    FLASH_FWD_CASE(48)
    FLASH_FWD_CASE(64)
    FLASH_FWD_CASE(80)
    FLASH_FWD_CASE(96)
    FLASH_FWD_CASE(128)
    FLASH_FWD_CASE(160)
    FLASH_FWD_CASE(192)
    FLASH_FWD_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_FWD_CASE
}
