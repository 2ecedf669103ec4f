// The causal mask of kernel 4, with its query offset and sliding window:
// which keys a query row sees and which key tiles a query block walks.
// Shared by flash_fwd.cu (route "ffma") and flash_fwd_sm90.cu (route
// "wgmma").
//
// The semantics are the reference's (src/repro/models/layers.py:114-126):
// the query at row i has the absolute position p = q_offset + i; key j is
// visible to it iff p ≥ j and p − j < window; every other score is masked
// before the softmax.  The launcher passes INT_MAX for "no window", and
// bounds |q_offset| + Sq + Sk below 2^31, so no difference here overflows.
#pragma once

namespace {

__device__ __forceinline__ bool visible(int p, int j, int window) {
  return j <= p && p - j < window;
}

struct KeyTiles {
  int first;  // first key tile walked
  int count;  // key tiles walked, ≥ 1
};

// The tiles of `bn` keys that query rows q0 .. min(q0 + rows, Sq) − 1 walk.
// Without the causal mask: all of them.  With it, a tile wholly after the
// last row's position or wholly before the first row's window is skipped.
// That is exact: in the reference such a chunk either follows a row's
// visible keys (p = 0, corr = 1) or precedes them, and then the row's first
// visible key wipes what it added (corr = exp(−1e30 − s) = 0).  A block
// holding a row that sees no key at all walks every tile: the reference
// gives such a row p = 1 on every key (all its scores sit at the masking
// value, which is then also its running max), that is the mean of v, and
// the kernels mask with a finite value there so that they give the same.
__device__ __forceinline__ KeyTiles key_tiles(int q0, int rows, int Sq, int Sk, int bn, int q_offset,
                                              int window, int causal) {
  const int all = (Sk + bn - 1) / bn;
  if (!causal) return {0, all};
  const int p_lo = q_offset + q0;
  const int p_hi = q_offset + min(q0 + rows, Sq) - 1;
  if (p_lo < 0 || window <= 0 || p_hi - window + 1 > Sk - 1) return {0, all};  // a row sees no key
  const int first = max(0, p_lo - window + 1) / bn;
  const int last = min(p_hi, Sk - 1) / bn;
  return {first, last - first + 1};
}

// Whether the walked key tile k0 .. k0 + bn − 1 needs a per-element mask
// for the query rows at positions p_lo .. p_hi (p_lo ≤ p_hi): it does
// unless it lies wholly below Sk and, under the causal mask, every one of
// those rows sees every key of it — its last key at or before the first
// row's position, its first key inside the last row's window.  Both tests
// are exact (visibility is monotone in the row and the key), so a tile that
// takes none masks nothing; rows that see no key find every tile masked.
// Used by flash_fwd.cu (route "ffma") per warp of query rows.
__device__ __forceinline__ bool tile_needs_mask(int k0, int bn, int p_lo, int p_hi, int Sk, int window,
                                                int causal) {
  if (k0 + bn > Sk) return true;
  return causal && (k0 + bn - 1 > p_lo || p_hi - k0 >= window);
}

}  // namespace
