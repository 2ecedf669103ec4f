#!/usr/bin/env python3
"""Measure what a 16-byte shared-memory load costs the SM by the pattern of
addresses its lanes read: the premise of the fp32 flash-attention kernel's
lane order (``src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu``).

    python3 scripts/smem_load_cycles.py

Builds a small kernel (``SOURCE`` below, one ``nvcc`` into a temporary
directory) in which every thread of 132 × 8 blocks of 256 threads issues
``ld.volatile.shared.v4.f32`` from one address per lane, 32,000 times, with
one FADD per load into 16 independent sums (so issue does not bound it).
The pattern sets each lane's address: one for the whole warp, one per
quarter-warp, groups of 4 or 8 neighbouring lanes on one address, the same
4 or 8 addresses in every quarter-warp, or 32 distinct.  Prints, per
pattern, the SM clocks one warp-wide load takes (kernel time by CUDA
events × the card's maximum SM clock × 132 SMs ÷ the loads), and the card's
name and power limit.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = r"""
#include <cuda_runtime.h>
__global__ void lds_kernel(float* out, int mode, int iters) {
  __shared__ float4 buf[1024];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  int idx;
  switch (mode) {
    case 0: idx = 0; break;                  // one address
    case 1: idx = lane / 8; break;           // one per quarter-warp
    case 2: idx = lane / 4; break;           // 4 neighbouring lanes per address
    case 3: idx = lane / 2; break;           // 2 neighbouring lanes per address
    case 4: idx = lane % 4; break;           // the same 4 addresses in every quarter-warp
    case 5: idx = lane % 8; break;           // the same 8 addresses in every quarter-warp
    default: idx = lane; break;              // 32 distinct
  }
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(buf + warp * 64 + idx));
  float acc[16] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      float x, y, z, w;
      asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(x), "=f"(y), "=f"(z), "=f"(w) : "r"(base + (u & 1) * 4096));
      acc[u] += x;
      acc[(u + 1) & 15] -= w * (it == -7);
    }
  }
  float s = 0.f;
  for (int u = 0; u < 16; ++u) s += acc[u];
  if (s == -1.f) out[0] = s;
}
extern "C" float lds_ms(int mode, int iters, int blocks, int threads) {
  float* out;
  cudaMalloc(&out, 4);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  lds_kernel<<<blocks, threads>>>(out, mode, 4);
  cudaEventRecord(a);
  lds_kernel<<<blocks, threads>>>(out, mode, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  cudaFree(out);
  return ms;
}
"""
PATTERNS = ("one_address", "one_per_quarter_warp", "4_neighbours_share", "2_neighbours_share",
            "same_4_in_each_quarter", "same_8_in_each_quarter", "32_distinct")


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("smem_load_cycles: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    print(smi("name,power.limit"), flush=True)
    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, blocks, threads = 2000, sms * 8, 256
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "lds.cu"
        src.write_text(SOURCE)
        so = Path(tmp) / "lds.so"
        _build.compile_library([src], so)
        lib = ctypes.CDLL(str(so))
        lib.lds_ms.restype = ctypes.c_float
        lib.lds_ms.argtypes = [ctypes.c_int] * 4
        for mode, name in enumerate(PATTERNS):
            ms = min(lib.lds_ms(mode, iters, blocks, threads) for _ in range(3))
            loads = blocks * threads // 32 * iters * 16  # warp-wide 16-byte loads
            clocks = ms * 1e-3 * mhz * 1e6 * sms / loads
            print(json.dumps({"pattern": name, "ms": ms, "sm_clocks_per_warp_load": clocks}), flush=True)
    print(smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
