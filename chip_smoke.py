#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases (each asserts; any failure exits non-zero):
  1. environment: torch/CUDA versions, the card's name and power limit,
     TF32 off for cuBLAS and cuDNN;
  2. build: compile the four kernels (the fused min-d² scan, the batched
     and multi-query bucket scans, flash attention with its two routes:
     bf16 on the tensor cores, fp32 on the CUDA cores) from the csrc/
     folders under src/repro_torch/kernels/ into build/kernels/, one nvcc
     per source, started together; ptxas's registers and spills per
     kernel, and no spill in any of the four instances (resident or
     streamed tile × directed or bidirectional) of kernels 1, 2 and 3 or
     in any head-dim instance of kernel 4 (bf16: 16, 64, 80, 128, 192,
     256; fp32: 16 to 256);
  3. kernel vs plain version on the same CUDA tensors (fp32 and bf16, masks,
     empty sides, pruning, a grid whose CTAs walk several tile pairs), per
     min-d² entry within 2·(D+2)·eps32·scale², HD within fp_value_margin
     of a float64 oracle; the directed instance's row mins bitwise the
     bidirectional one's; pruned bitwise unpruned in both instances; and
     both instances bitwise equal under four launch plans (planned, 7
     CTAs, forced streamed and forced resident a-tile) at D 1, 3, 17 and
     256, fp32 and bf16;
  4. exact path: set_distance on the paper's Random Clouds at
     262,144 × 262,144, D = 256, against backend="tiled" (its time the
     median of 3 calls after a warm-up), and the kernel's min-d² vectors
     at that shape entry by entry against the plain version;
  5. ProHD at 1,048,576 × 1,048,576, D = 256 (Random Clouds and the
     Gaussian-mixture proxy; times the median of 3 calls after a warm-up)
     against ProHD on backend="tiled", and its certificate against phase
     4's exact value at 262,144 per side (exact ground truth at 1M per
     side is cut for time);
  6. directed, partial and chamfer at 65,536 × 65,536, D = 256;
  6b. methods: on phase 4's clouds, random and systematic sampling at
     α = 0.01 (5 generator seeds; each value within fp_value_margin of
     the float64 HD of the same subsets, recovered by replaying the
     generator's state), adaptive ProHD (relative budget 0.1) and ProHD
     with rsvd and subspace PCA (each certificate brackets phase 4's
     exact H), all under auto on fused_cuda; ProHD's relative error
     against each sampler's median (reported); times at phase 5's
     1,048,576² Random Clouds;
  6c. drift: the streaming drift monitor over 1,048,576 × 256 Gaussian
     reference embeddings, a 65,536-vector reservoir, 32 batches of
     8,192 with every coordinate shifted by 4 from batch 16 on,
     check_drift (ProHD α 0.05 on kernel 1) after every 4th batch: no
     alert before the shift, an alert after it at a threshold between
     the exact H before and after, the last interval bracketing the
     exact H; init, observe and check times;
  6d. distributed: set_distance(backend="distributed") SPMD on a one-rank
     NCCL process group (FileStore in a temporary directory) over a 1-D
     DeviceMesh: ProHD on phase 5's 1,048,576² Random Clouds within
     fp_value_margin of single-device ProHD (fused_cuda) on the same
     clouds with equal selection counts, and the exact ring on phase 4's
     clouds within fp_value_margin of their float64 H (computed on the
     card), then again with 1,000 NaN rows padded into each cloud and
     masked out (the same bits); medians of 3 after a warm-up; the group
     is destroyed on success and on failure; then ProHD on phase 4's
     clouds across two ranks of a gloo group on the one card (two
     processes of this script, each with half the rows) within
     fp_value_margin of single-device ProHD with equal selection counts
     (gloo moves no CUDA tensor point to point, so the ring has no
     two-rank run on one card);
  7. CUDA-event times (median of 5 after warm-up) of the kernel, its bound,
     its plain version and torch.cdist + amin as a yardstick, at 65,536²
     (bidirectional) and at ProHD's sweep shape (over 65,536-column
     chunks of b) in both instances, with the kernel's outputs held entry
     by entry against the plain version's at every timed shape and
     instance (and the masked, directed wrapper call at the sweep shape).
  7b. the paper's exact baselines: hausdorff_twosweep_tiled at 65,536² ×
     256 (two launches of kernel 1's directed instance, counted on their
     own) against the fused bidirectional call, both values within
     fp_value_margin of the float64 H, CUDA-event times of both; the EBHD
     early break (hausdorff_earlybreak) on Random Clouds at 4,096² × 256 on
     the card and on the host's CPU, each within fp_value_margin of the
     float64 H, host-clock times.
Kernel 2 and the corpus search:
  3b. the batched bucket scan against its plain version on CUDA tensors
     (shared and per-set queries, a shared slab, ragged caps, an
     all-invalid set, gated sets, a NaN bound, many slab tiles, D 1, 3,
     17, 100 and 256), per min-d² entry within 2·(D+2)·eps32·scale²;
     gated sets +inf, gated vs ungated bitwise, each lane bitwise against
     kernel 1 on that set's rows, and every case bitwise equal under five
     launch plans (planned, 7 CTAs, forced streamed, forced resident query
     tile where the query is shared, set order 1) in both instances (the
     directed one's row mins the bidirectional one's);
  8. search: the clustered corpus (16,384 sets, D = 256, sizes 48..256) in
     a SetStore on the card, the certified cascade (top-10) bitwise equal
     to brute force, values within fp_value_margin of float64; one more
     (uncounted) run of the search with every kernel-2 wrapper call held
     entry by entry against the plain version on the same operands — both
     stage-1 passes of each bucket and every stage-2a pass, at the
     search's own batch, cap and n_q; then at
     2,048 sets directed, sequential and anytime ε = 0, each bitwise equal
     to brute force; store build, per-stage and cascade vs brute-force
     times;
  9. CUDA-event times of kernel 2 on the full cap-256, cap-128 and cap-64
     buckets (stage 1 walks all three) and on the search's largest
     stage-2a pass, with its bound, its plain version and torch.cdist +
     amin as a yardstick.
Kernel 3, search_batch and the serving layer:
  3c. the multi-query bucket scan against its plain version on CUDA
     tensors (Q 1-16, n_q 1-200, caps 8-256 with ragged validity, D 1-256,
     per-(query, set) gates with a NaN bound, a -inf cut, fully gated rows,
     an all-invalid query, the reference's failing tiny shapes), per min-d²
     entry within 2·(D+2)·eps32·scale²; gated pairs +inf, gated vs ungated
     bitwise, each pair bitwise equal to kernel 2 with that query, and
     every case bitwise equal under the five launch plans of 3b in both
     instances;
  10. search_batch over phase 8's store: 16 requests over 4 unique queries
     (k 10 and 5), each bitwise equal to its brute force, kernel 3 serving
     stage 2a, then one more (uncounted) run with every kernel-3 wrapper
     call held entry by entry against the plain version;
  10b. at phase 8's 2,048 sets, search_batch directed and anytime ε = 0,
     each bitwise equal to brute force;
  10c. sharded: search(shards=1) on phase 8's store and search_batch
     (shards=1) on phase 10's requests, ids, values and every stat but
     ``shards`` equal to the unsharded calls, ids and values to brute
     force, the cascade.shard_merge span present; times of one more
     unsharded and sharded call of each (the unsharded ones uncounted);
     kernel 2 launched by the sharded stage 1, kernel 1 by search and
     kernel 3 by search_batch;
  11. served: a QueryEngine over a ProHDService around phase 8's store
     answers phase 10's 16 requests in one flush, bitwise equal to phase
     10; ProHDService.submit serves 8 Random-Cloud pairs at 16,384 ×
     {16,384 … 4,096} × 256 through kernel 2, certified against the exact
     set_distance; then the same pairs flushed once more (uncounted, the
     same answers) with every kernel-2 wrapper call held entry by entry
     against the plain version at the served shapes;
  11b. obs: a JSONL capture (obs.capture(jsonl=...)) around one more
     search on phase 8's store, validated by obs.validate_events (one rid,
     no errors), its obs.report.stage_table printed; then a search on a
     512-set store of the same settings under torch.profiler with the
     profiler bridge on (capture(record_function=True)): the trace holds
     the cascade.stage0/1/2a/2b ranges, and every kernel-2 and kernel-1
     launch of the search lies inside one (kernel 2 in stage 1, kernel 1
     in 2b);
  12. CUDA-event times of kernel 3 at Q = 16 on the full cap-256 bucket
     (beside 16 launches of kernel 2 on the same work) and on search_batch's
     largest stage-2a pass, with its bound, its plain version (at Q = 2 on
     the full bucket) and Q calls of torch.cdist + amin as a yardstick.

Kernel 4 and the LM serving path (TinyLlama-1.1B, random bf16 weights from
the seed):
  13. both routes of the flash-attention kernel (bf16: wgmma; fp32: FFMA)
     against the plain version and a float64 oracle on CUDA tensors (causal
     and not, GQA groups 1, 2, 4, 8, hd 64, 80 and 128, Sq and Sk on either
     side of a 128-key tile's edge and of the diagonal tile, Sk < 128, one
     query row, TinyLlama's, StableLM-3B's and DeepSeek-67B's heads at
     4,096; every other head dim kind: 16, 192 and 256 (instances), 3, 40
     and 96 (zero-padded to the next instance); sliding windows inside one
     key tile, across several and past Sk; query offsets of a continued
     prefill, past the keys, and with rows that see no key at all), and
     against the plain version at kv chunks 64 and 512, per entry within
     the bound that flash_error derives (scripts/flash_planted_faults.py
     shows faulty kernels failing it);
  14. prefill_step at full width on 1 × 512 tokens (against the same model
     in float64 through the plain functions), 8 × 4,096 and 1 × 32,768
     tokens, each launching kernel 4 once per layer, every launch on the
     bf16 tensor-core route; one more (uncounted)
     8 × 4,096 prefill with every kernel-4 call held entry by entry against
     the plain version; serve_step at batch 32 with a 32,768-slot cache:
     a 64-token prompt fed one token at a time (its last logits against
     prefill_step's on the same prompt), then 32 greedy tokens; a 1 ×
     32,768 prefill with a 4,096-token sliding window (22 launches on the
     bf16 route); then smoke_lm_config(TinyLlama) (2 layers, 4/2 heads of
     16, fp32) at 2 × 512 through the fp32 route (2 launches), its logits
     within 1e-4 relative L2 of the same model in float64;
  14b. MoE: OLMoE-1B-7B at full width and depth (16 layers, d 2,048, 16/16
     heads of 128, 64 experts of d_ff 1,024, top 8, vocab 50,304, bf16,
     6.92 B parameters, random weights): prefill_step at 1 × 512 against
     the same weights in float64, walked one layer's weights at a time on
     the bf16 prefill's routing (every expert choice imposed, gates and the
     rest recomputed; the routes float64 would have flipped counted),
     within √R·2⁻⁸ with R = 17 per MoE layer; at 8 × 4,096 and 1 × 32,768
     (16 launches each, all on the bf16 route; wall time, tokens/s, peak
     memory, mean aux loss and dropped fraction); one more (uncounted)
     1 × 4,096 prefill with every kernel-4 call held entry by entry against
     the plain version; serve_step (dense-expert decode) at batch 8 with a
     32,768-slot cache: a 64-token prompt fed one token at a time, then 32
     greedy tokens, the last prompt logits against prefill_step's on a copy
     of the config that cannot drop (capacity factor E / top_k); then
     smoke_lm_config(Grok-1-314B) (2 layers, 4/2 heads of 16, 4 experts,
     top 2, fp32) at 2 × 512 through the fp32 route, within 1e-4 of its
     float64 copy on its own routing;
  15. CUDA-event times of kernel 4 at TinyLlama's (8, 4,096) and
     (1, 32,768), 32 query heads over 4 kv heads of 64, at (1, 8,192) with
     StableLM-3B's 32/32 heads of 80 and DeepSeek-67B's 64/8 of 128, at
     OLMoE-1B-7B's (8, 4,096) with 16/16 heads of 128, causal bf16, then TinyLlama's (1, 32,768) with a 4,096 window (against the
     causal call) and the smoke configs' heads (8, 4,096, 4/2 of 16, fp32),
     with its bound, its plain version and scaled_dot_product_attention as
     a yardstick (flash backend, causal; for the two new shapes the
     memory-efficient backend with an explicit (S, S) mask, and for the
     causal fp32 one also that backend's own causal mask, is_causal).

Training (TinyLlama-1.1B, random bf16 weights from the seed):
  16. kernel 4 under autograd: flash.flash_attention_grad (kernel 4's
     forward, the reference's recomputing backward in plain PyTorch)
     against torch.autograd through flash_attention_plain on CUDA tensors
     (bf16 and fp32; GQA 32/4 of 64 and MHA 16/16 of 128; S 4,096 and a
     ragged 1,000), dq, dk, dv per entry within attn_grad_error's bound,
     one kernel-4 launch per forward and none in the backward; the bf16
     model's gradients of lm_loss at 1 × 512 against the same weights in
     float64 through the plain functions, per parameter and whole within
     √(28·L + 4)·2⁻⁸ relative L2; then main path 7: train.loop.fit, 4
     AdamW steps (lr 1e-3, weight decay 0.01, fp32 master) at 4 × 4,096
     tokens in 2 microbatches (cell train_4k, global batch 256 cut to 4),
     remat on, a checkpoint every 2 steps in a temporary directory (15.4
     GB each; the card's machine caps a call's disk writes at 45 GiB), a
     failure injected at step 3 (the restored step-2 state bitwise what was
     written), a drift hook every 2 steps (ProHD on kernel 1 between the
     embedding table now and at the start, once held to the exact kernel-1
     HD); loss, grad norm, wall time, tokens/s and peak memory per step;
     2 × 22 × 2 kernel-4 launches per step, all on the bf16 route; then
     ``python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 4``
     as a subprocess (the fp32 smoke config, route "ffma"), exit code 0.

GNN and recsys (no kernel lies on their paths; random fp32 weights from
the seed, the configs' published widths):
  17. GAT (gat-cora: 2 layers, 8 heads × 8, 7 classes) at each GNN_SHAPES
     cell: full_graph_sm (2,708 nodes, 10,556 edges + self-loops, d_feat
     1,433: logits within 1e-4 relative L2 of float64, then 4 fit steps,
     AdamW lr 1e-3, weight decay 0.01); minibatch_lg (CSRGraph.random at
     232,965 nodes, ~114.6 M edges, d_feat 602, on the host; 4 fit steps
     on minibatch_iterator subgraphs of 1,024 seeds, fanouts 15 and 10,
     one subgraph's logits against float64, the host sampler's share of
     each step); ogb_products (2,449,029 nodes, 61,859,140 edges +
     self-loops, d_feat 100: one forward under no_grad, finite, its time
     and peak memory); molecule (128 graphs × 30 nodes × 64 edges, d_feat
     16: 4 fit steps of gat_graph_loss);
  18. FM, DIEN, BERT4Rec and BST at full size, each RECSYS_SHAPES cell:
     serve_p99 (score at 512, median of 10 synchronised calls, within 1e-4
     relative L2 of float64), serve_bulk (262,144; BERT4Rec 32,768; rows/s
     and peak memory), retrieval_cand (query_embedding at batch 1,
     retrieval_topk over 1,000,000 candidates at k 10, dot and l2: values
     within the fp32 bound of float64, ids float64's where its 10th and
     11th scores lie further apart), train_batch (4 fit steps at 65,536;
     DIEN 16,384 and BERT4Rec 8,192: wall time, examples/s, peak memory),
     gradients at batch 256 within 1e-4 relative L2 per tensor of float64;
     then sharded_lookup, sharded retrieval_topk and
     gat_forward_partitioned on one NCCL rank over a (1, 1) DeviceMesh,
     each against its unsharded call; and ``python -m
     repro_torch.launch.train --arch gat-cora`` and ``--arch dien`` (4
     steps each) as subprocesses, exit code 0.

Each main path (phases 4-6: set_distance; 6b, 6c and 6d, each its own;
phase 7b's two-sweep call; phase 8: search; phases 10 and 10b:
search_batch; 10c: shards=1; phase 11: the served paths; phases 14 and
14b: each prefill_step and each decode loop; phase 16: the fit call;
phases 17, 18 and the NCCL forms: each, with no launch allowed)
runs with the kernels' launch counters set to 0 just before it and read
just after; launches made only to compare a kernel with its plain version
are taken back out.
Prints JSON lines; the last line is {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

KERNEL_SOURCE = "src/repro_torch/kernels/hausdorff/csrc/fused_minscan.cu"
TPU_KERNEL = "src/repro/kernels/hausdorff/hausdorff.py:89"
KERNEL2_SOURCE = "src/repro_torch/kernels/hausdorff/csrc/batched_minscan.cu"
TPU_KERNEL2 = "src/repro/kernels/hausdorff/batched.py:74"
KERNEL3_SOURCE = "src/repro_torch/kernels/hausdorff/csrc/multiquery_minscan.cu"
TPU_KERNEL3 = "src/repro/kernels/hausdorff/batched.py:378"
KERNEL4_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_fwd_sm90.cu"
KERNEL4_FP32_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu"
TPU_KERNEL4 = "src/repro/kernels/flash_attention/flash.py:38"
# H100 SXM HBM3 rate from NVIDIA's data sheet (bytes/s).
HBM_BYTES_PER_S = 3.35e12
# FP32 lanes per SM on Hopper; one FMA = 2 FLOPs per lane per clock.
FP32_LANES_PER_SM = 128
# Dense bf16 tensor-core FLOPs per SM per clock on Hopper (4 tensor cores;
# 132 SMs at 1,830 MHz give the data sheet's 989 TFLOP/s) and MUFU ex2
# results per SM per clock.
BF16_FLOP_PER_SM_CLK = 4096
MUFU_PER_SM_CLK = 16

DEVICE = "cuda"
N_EXACT = 262_144
N_PROHD = 1_048_576
N_VARIANT = 65_536
D = 256
SWEEP_QUERIES = 41_930
CDIST_CHUNK = 65_536  # b-columns per torch.cdist call at the sweep shape (11 GB fp32)
# Phase 6b: the paper's sampling baselines at α = 0.01 under 5 generator
# seeds, adaptive ProHD (relative budget 0.1) and ProHD on the randomised
# PCA backends, on phase 4's clouds; times on phase 5's Random Clouds.
SAMPLE_ALPHA = 0.01
SAMPLE_SEEDS = 5
ADAPTIVE_BUDGET = 0.1
# Phase 6c: the drift monitor over a vector database's embeddings — a fixed
# reference of 1,048,576 Gaussian vectors at D, a 65,536-vector reservoir,
# 32 batches of 8,192, every coordinate shifted by DRIFT_SHIFT from batch 16
# on, check_drift after every 4th batch, an alert above DRIFT_THRESHOLD.
N_DRIFT_REF = 1_048_576
DRIFT_WINDOW = 65_536
DRIFT_BATCH = 8_192
DRIFT_BATCHES = 32
DRIFT_SHIFT_AT = 16
DRIFT_CHECK_EVERY = 4
DRIFT_SHIFT = 4.0
DRIFT_THRESHOLD = 40.0
N_RING_PAD = 1_000
# Phase 6d's multi-rank run: ProHD on phase 4's clouds over a gloo group of
# GLOO_RANKS processes on the one card (NCCL takes one rank per card).
GLOO_RANKS = 2
# The retrieval corpus: the repo's own corpus settings (benchmarks/tables.py,
# clustered_sets with sizes 48..256 step 8, 32 clusters, spread 10, σ 0.5)
# at the paper's D = 256; the query is 128 points around set 0's centroid.
N_CORPUS = 16_384
N_CORPUS_SMALL = 2_048
CORPUS_SIZES = tuple(range(48, 257, 8))
N_QUERY = 128
K_TOP = 10
# search_batch: each of 4 unique queries asked 4 times; the last request of
# each asks for the top K_SMALL.
N_UNIQUE = 4
N_REQUESTS = 16
K_SMALL = 5
# Served pairwise: Random Clouds, a-side size and the b-side sizes (each twice).
N_PAIR_A = 16_384
PAIR_B_SIZES = (16_384, 12_288, 9_000, 4_096)
# The LM path: TinyLlama-1.1B at full width.  LM_SHAPES' prefill_32k
# (32 × 32,768) is cut to 8 × 4,096 and 1 × 32,768; decode_32k (batch 128,
# cache 32,768: a 94.5 GB cache) to batch 32 (23.6 GB).
LM_ARCH = "tinyllama-1.1b"
PREFILL_SHAPES = ((8, 4_096), (1, 32_768))
F64_PROMPT = 512
DECODE_BATCH = 32
DECODE_CACHE = 32_768
DECODE_PROMPT = 64
DECODE_NEW = 32
# Phase 13's cases, (B, Sq, Sk, H, KV, hd, dtype, causal[, q_offset, window]):
# groups 1, 2, 4 and 8, the instance head dims, ragged Sq and Sk, and the
# models' heads at 4,096; then head dims that are no instance (3, 40, 96,
# padded to the next) and the new instances (16, 192, 256) in both dtypes;
# sliding windows (inside one key tile, across several, past Sk) and query
# offsets (a continued prefill with Sk > Sq, rows past the keys, and rows
# that see no key at all).  bf16 goes through the tensor-core kernel
# (128-row query blocks, 64 at hd > 128; 128-key tiles, 64 at hd > 80),
# fp32 through the CUDA-core one (64 and 64).
FLASH_CASES = (
    (2, 128, 128, 4, 4, 64, "float32", True),
    (2, 128, 128, 4, 4, 64, "float32", False),
    (1, 333, 333, 8, 4, 80, "bfloat16", True),
    (2, 333, 1, 8, 1, 128, "float32", True),
    (1, 1, 333, 32, 4, 64, "bfloat16", False),
    (2, 200, 192, 16, 2, 128, "bfloat16", False),
    (1, 513, 1000, 8, 8, 80, "float32", True),
    # Sq = Sk = 300: the diagonal tile is the third, ragged at both edges.
    (1, 300, 300, 8, 2, 64, "bfloat16", True),
    (1, 300, 300, 8, 2, 64, "bfloat16", False),
    (1, 300, 300, 8, 2, 128, "bfloat16", True),  # 64-key tiles: the diagonal is the fifth
    # Sk < 128: one ragged key tile below queries that run past it.
    (2, 200, 77, 8, 2, 64, "bfloat16", True),
    (2, 200, 77, 8, 2, 64, "bfloat16", False),
    # Sq one past a query block, Sk one short of a key tile.
    (1, 129, 255, 8, 1, 128, "bfloat16", True),
    # A single query row (causal: it sees key 0 alone).
    (2, 1, 1000, 8, 4, 128, "bfloat16", True),
    (2, 1, 1000, 8, 4, 80, "bfloat16", False),
    (1, 4096, 4096, 32, 4, 64, "bfloat16", True),
    (1, 4096, 4096, 32, 4, 64, "float32", True),
    (1, 4096, 4096, 64, 8, 128, "bfloat16", True),  # DeepSeek-67B's heads
    (1, 4096, 4096, 32, 32, 80, "bfloat16", True),  # StableLM-3B's heads
    # Every head dim: the smoke configs' 16, padded ones, the one-consumer instances.
    (2, 300, 300, 4, 2, 16, "bfloat16", True),
    (2, 300, 300, 4, 2, 16, "float32", True),
    (1, 333, 333, 8, 4, 40, "bfloat16", True),
    (1, 333, 333, 8, 4, 40, "float32", False),
    (1, 200, 192, 16, 2, 96, "bfloat16", False),
    (1, 200, 192, 16, 2, 96, "float32", True),
    (1, 300, 300, 8, 2, 256, "bfloat16", True),
    (1, 300, 300, 8, 2, 256, "float32", True),
    (1, 129, 255, 4, 4, 256, "bfloat16", False),
    (1, 257, 257, 4, 1, 192, "bfloat16", True),
    (1, 100, 100, 2, 1, 3, "bfloat16", True),
    # Sliding windows: inside one key tile, across several, past Sk.
    (1, 1024, 1024, 8, 2, 64, "bfloat16", True, 0, 50),
    (1, 1024, 1024, 8, 2, 64, "float32", True, 0, 50),
    (1, 1024, 1024, 8, 2, 128, "bfloat16", True, 0, 300),
    (1, 1024, 1024, 8, 2, 64, "float32", True, 0, 300),
    (1, 1000, 1000, 8, 2, 80, "bfloat16", True, 0, 5000),
    # Query offsets: a continued prefill (the last Sq of Sk positions), with
    # and without a window; rows past the keys; rows that see no key.
    (1, 300, 1000, 8, 2, 64, "bfloat16", True, 700, None),
    (1, 300, 1000, 8, 2, 64, "float32", True, 700, None),
    (1, 300, 1024, 8, 2, 64, "bfloat16", True, 724, 200),
    (1, 300, 1024, 4, 2, 256, "bfloat16", True, 724, 100),
    (1, 200, 1000, 8, 2, 64, "bfloat16", True, 1000, None),
    (1, 200, 1000, 8, 4, 64, "float32", True, 1500, None),
    (1, 200, 1000, 8, 2, 64, "bfloat16", True, 1100, 150),
    (1, 200, 1000, 8, 2, 64, "float32", True, 1100, 150),
)
# Phase 15's timed shapes (B, S, H, KV, hd, dtype, window), causal:
# TinyLlama's first, then StableLM-3B's, DeepSeek-67B's and OLMoE-1B-7B's
# heads (MHA, 16 of 128, at its prefill shape 8 × 4,096), then
# TinyLlama at 32,768 with a 4,096 window and the smoke configs' heads (4/2
# of 16, fp32 as the smoke configs run).
FLASH_TIMES = (
    (8, 4_096, 32, 4, 64, "bfloat16", None),
    (1, 32_768, 32, 4, 64, "bfloat16", None),
    (1, 8_192, 32, 32, 80, "bfloat16", None),
    (1, 8_192, 64, 8, 128, "bfloat16", None),
    (8, 4_096, 16, 16, 128, "bfloat16", None),
    (1, 32_768, 32, 4, 64, "bfloat16", 4_096),
    (8, 4_096, 4, 2, 16, "float32", None),
)
# Phase 14's windowed prefill: TinyLlama with this sliding window at 1 × 32,768.
LM_WINDOW = 4_096
# Phase 14b: OLMoE-1B-7B (16 layers, d 2,048, 16/16 heads of 128, 64 experts
# of d_ff 1,024, top 8, vocab 50,304, bf16) at full width and depth, random
# weights from the seed: prefill at PREFILL_SHAPES, an uncounted held
# prefill at MOE_HELD_SHAPE, the float64 check at F64_PROMPT tokens, decode
# at batch MOE_DECODE_BATCH with a DECODE_CACHE-slot cache (decode_32k's
# batch 128 would need a 550 GB cache; 8 need 34.4 GB); then Grok-1's smoke
# config (Grok-1-314B does not fit on one card).
MOE_ARCH = "olmoe-1b-7b"
MOE_SMOKE_ARCH = "grok-1-314b"
MOE_HELD_SHAPE = (1, 4_096)
MOE_DECODE_BATCH = 8
# Phase 7b: the paper's exact baselines.  Two-sweep against the fused call at
# phase 7's 65,536² (N_VARIANT); the early break on Random Clouds at
# N_EARLYBREAK² on the CPU and on the card.
# Phase 16 (training): cell train_4k of LM_SHAPES, its global batch of 256
# cut to 4 sequences of 4,096 tokens in 2 microbatches on one card.
TRAIN_SHAPE = (4, 4_096)
TRAIN_MICROBATCHES = 2
# A checkpoint is 15.4 GB (bf16 weights, AdamW's fp32 mu, nu and master), and
# a call on the card may write 45 GiB to its disk: a save every 2 steps
# (step 2 and the final step 3) writes 31 GB, where every step would write 62.
TRAIN_STEPS = 4
TRAIN_CKPT_EVERY = 2
TRAIN_FAIL_AT = 3
TRAIN_DRIFT_EVERY = 2
GRAD64_TOKENS = 512
# (B, S, H, KV, hd, dtype, kv chunk): kernel 4 under autograd; S 1,000 is
# ragged against the kernel's 128-row and 64/128-key tiles.
ATTN_GRAD_CASES = tuple(
    (1, s, h, kv, hd, dtype, 512 if s % 512 == 0 else 200)
    for dtype in ("bfloat16", "float32") for h, kv, hd in ((32, 4, 64), (16, 16, 128)) for s in (4_096, 1_000))
N_EARLYBREAK = 4_096
# Phase 11b: the profiled search runs on a corpus of this many sets.
N_OBS_SETS = 512
# Phases 17 and 18 (GNN and recsys): the reference's cells (GNN_SHAPES and
# RECSYS_SHAPES of configs/base.py) at the configs' published widths, random
# fp32 weights from the seed.  CELL_DIMS overrides a cell's dims (a CPU
# rehearsal shrinks them); every GNN cell uses the config's 7 classes.
GNN_ARCH = "gat-cora"
CELL_DIMS: dict = {}
GNN_STEPS = 4
# CSRGraph.random's mean degree is about avg_degree / 2 + 1 (a Pareto(2)
# draw scaled by avg_degree / 2, plus one): 982 gives ~114.6 M edges over
# minibatch_lg's 232,965 nodes.
MINIBATCH_AVG_DEGREE = 982
RECSYS_ARCHS = ("fm", "dien", "bert4rec", "bst")
RECSYS_STEPS = 4
# train_batch is 65,536; DIEN's 200 recurrent steps keep ~340 MB each for the
# backward at that batch (68 GB), BERT4Rec's blocks 42 GB each of scores and
# softmax: both cut.  serve_bulk is 262,144; BERT4Rec's (B, 2, 200, 200) fp32
# scores would be 84 GB there: cut.
RECSYS_TRAIN_BATCH = {"fm": 65_536, "dien": 16_384, "bert4rec": 8_192, "bst": 65_536}
RECSYS_BULK_BATCH = {"fm": 262_144, "dien": 262_144, "bert4rec": 32_768, "bst": 262_144}
RECSYS_SERVE_BATCH = 512
RECSYS_GRAD_BATCH = 256
SERVE_REPS = 10
N_CANDIDATES = 1_000_000
K_RETRIEVAL = 10
# fp32 gradients against float64, relative L2 per parameter tensor (relative
# to 1% of the whole gradient's norm where a tensor's own is smaller: a
# gradient that is zero in exact arithmetic is rounding noise).  Derivation
# in PERF.md §6 (the GNN and recsys slice).
GRAD64_TOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def scale_of(*xs) -> float:
    """Largest row norm over the given clouds (fp32 values)."""
    import torch

    return max(float(torch.linalg.vector_norm(x.float(), dim=1).max()) for x in xs)


def oracle_min_sqdists(a, b, valid_b=None):
    """float64 per-row min d² from a to the valid rows of b, in row chunks."""
    import torch

    from repro_torch.kernels.hausdorff import ref

    per_row = max(1, b.shape[0] * b.shape[1] * 8)
    chunk = max(1, (256 << 20) // per_row)
    return torch.cat([
        ref.min_dists_ref(a[i:i + chunk], b, valid_b, dtype=torch.float64)
        for i in range(0, a.shape[0], chunk)
    ])


def finalize64(mins, valid):
    import torch

    if valid is not None:
        mins = torch.where(valid, mins, -torch.inf)
    return float(torch.sqrt(torch.clamp(mins.max(), min=0.0)))


def launchers() -> dict:
    """The four kernels' launchers, by kernel name."""
    from repro_torch.kernels.flash_attention import flash as F
    from repro_torch.kernels.hausdorff import batched as KB
    from repro_torch.kernels.hausdorff import hausdorff as K

    return {"fused_minscan": K.fused_minscan, "batched_minscan": KB.batched_minscan,
            "multiquery_minscan": KB.multiquery_minscan, "flash_fwd": F.flash_fwd}


@contextlib.contextmanager
def uncounted():
    """Leave the kernels' launch counters as they were: for comparison launches."""
    from repro_torch.kernels.flash_attention import flash as F

    n, routes = counts(), route_counts()
    try:
        yield
    finally:
        for name, fn in launchers().items():
            fn.launches = n[name]
        F.flash_fwd.route_launches.update(routes)


def counts() -> dict:
    """The four kernels' launch counters, by kernel name."""
    return {name: fn.launches for name, fn in launchers().items()}


def route_counts() -> dict:
    """Kernel 4's launches per route (``flash.route``)."""
    from repro_torch.kernels.flash_attention import flash as F

    return dict(F.flash_fwd.route_launches)


def zero_counts() -> None:
    from repro_torch.kernels.flash_attention import flash as F

    for fn in launchers().values():
        fn.launches = 0
    for r in F.flash_fwd.route_launches:
        F.flash_fwd.route_launches[r] = 0


def entry_err(k, p, valid=None) -> float:
    """max |kernel − plain| over valid entries; both +inf at invalid ones."""
    import torch

    if valid is not None:
        assert torch.isinf(k[~valid]).all() and torch.isinf(p[~valid]).all()
        k, p = k[valid], p[valid]
    return float((k - p).abs().max())


def finite_err(k, p) -> float:
    """max |kernel − plain| where the plain version is finite; the two must
    be +inf at the same entries (invalid rows, gated sets)."""
    import torch

    fin = torch.isfinite(p)
    assert torch.equal(fin, torch.isfinite(k)), "kernel and plain version disagree on +inf entries"
    return float((k[fin] - p[fin]).abs().max()) if bool(fin.any()) else 0.0


def cuda_ms(fn, reps: int = 5) -> float:
    """Median ms of ``reps`` CUDA-event-timed calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env():
    import torch

    card = smi("name,power.limit")
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    env = {
        "phase": "env",
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "card": card,
        "sms": props.multi_processor_count,
        "max_sm_mhz": max_sm_mhz,
        "fp32_peak_tflops": props.multi_processor_count * FP32_LANES_PER_SM * 2 * max_sm_mhz * 1e6 / 1e12,
        "bf16_peak_tflops": props.multi_processor_count * BF16_FLOP_PER_SM_CLK * max_sm_mhz * 1e6 / 1e12,
        "mufu_per_s": props.multi_processor_count * MUFU_PER_SM_CLK * max_sm_mhz * 1e6,
    }
    emit(env)
    return env


def phase_build():
    """Build the four kernels from the checkout, one nvcc each, started
    together; every instance of kernels 1, 2 and 3, and every head-dim
    instance of kernel 4's two routes, must build without spills."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash as F
    from repro_torch.kernels.hausdorff import batched as KB
    from repro_torch.kernels.hausdorff import hausdorff as K

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        for f in [pool.submit(K.build), pool.submit(KB.build), pool.submit(KB.build_multiquery),
                  pool.submit(F.build)]:
            f.result()
    ptxas = {}
    instances = {}
    entry = {"fused_minscan": "fused_minscan_kernel", "batched_minscan": "bucket_minscan_kernel",
             "multiquery_minscan": "bucket_minscan_kernel"}
    text_of = {}
    for name in launchers():
        logs = sorted(_build.BUILD_DIR.glob(f"{name}-*.log"), key=lambda f: f.stat().st_mtime)
        text = text_of[name] = logs[-1].read_text() if logs else ""
        ptxas[name] = [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        if name in entry:
            instances[name] = {k: v for k, v in _build.ptxas_report(text).items() if entry[name] in k}
    # kernel 4: one instance per head dim of F.INSTANCES, on each route
    report = _build.ptxas_report(text_of["flash_fwd"])
    for route, entry4 in (("wgmma", "flash_fwd_sm90_kernel"), ("ffma", "flash_fwd_kernel")):
        instances[f"flash_fwd/{route}"] = {k: v for k, v in report.items() if entry4 in k}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas, "instances": instances})
    # four instances each of kernels 1-3: {resident, streamed} × {directed, bidirectional};
    # kernel 4: one per head dim, twice on the bf16 route (with and without an offset or window)
    for name, inst in instances.items():
        route = name.split("/")[-1]
        n = len(F.INSTANCES[route]) * (2 if route == "wgmma" else 1) if name.startswith("flash_fwd/") else 4
        assert len(inst) == n and all("registers" in v for v in inst.values()), (name, inst)
        assert all(v.get("spill_bytes") == 0 for v in inst.values()), (name, inst)


def phase_kernel_vs_plain(seed: int) -> float:
    import torch

    from repro_torch.core import exact, projections, tile_bounds
    from repro_torch.core.fp_margin import fp_value_margin, sqdist_tolerance
    from repro_torch.data.pointclouds import make_generator, random_clouds
    from repro_torch.kernels.hausdorff import hausdorff as K
    from repro_torch.kernels.hausdorff import ops

    # The last shape's grid has each CTA walk several b-tiles, as the main
    # path's launches do.
    shapes = [(8, 8, 2), (513, 129, 100), (1000, 333, 28), (64, 2000, 256), (4096, 4096, 256),
              (4096, 65_536, 256)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    walks = {}
    for n_a, n_b, d in shapes:
        plan = K.launch_plan(n_a, n_b, d, sms)
        walks[f"{n_a}x{n_b}"] = -(-plan.n_pairs // plan.grid)
    assert max(walks.values()) > 1, walks
    gen = make_generator(seed, DEVICE)
    max_err = 0.0
    rows = []
    for n_a, n_b, d in shapes:
        a32, b32 = random_clouds(gen, n_a, n_b, d)
        va = torch.rand(n_a, generator=gen, device=DEVICE) > 0.1
        vb = torch.rand(n_b, generator=gen, device=DEVICE) > 0.1
        va[0] = vb[0] = True
        for dtype in (torch.float32, torch.bfloat16):
            a, b = a32.to(dtype), b32.to(dtype)
            scale = scale_of(a, b)
            tol = sqdist_tolerance(d, scale)
            for masked in (False, True):
                ma, mb = (va, vb) if masked else (None, None)
                ka, kb = ops.fused_min_sqdists(a, b, valid_a=ma, valid_b=mb)
                pa, pb = exact.fused_min_sqdists_tiled(a, b, valid_a=ma, valid_b=mb)
                # the directed instance's row mins are the bidirectional one's, bit for bit
                da = ops.fused_min_sqdists(a, b, valid_a=ma, valid_b=mb, directed=True)[0]
                assert torch.equal(da, ka), (n_a, n_b, d, dtype, masked, "directed vs bidirectional")
                for k, p, v in ((ka, pa, ma), (kb, pb, mb)):
                    err = entry_err(k, p, v)
                    assert err <= tol, (n_a, n_b, d, dtype, masked, err, tol)
                    max_err = max(max_err, err)
                # HD against the float64 oracle.
                o_a = oracle_min_sqdists(a, b, mb)
                o_b = oracle_min_sqdists(b, a, ma)
                h64 = max(finalize64(o_a, ma), finalize64(o_b, mb))
                hk = float(torch.maximum(exact.finalize_mins(ka, ma), exact.finalize_mins(kb, mb)))
                margin = float(fp_value_margin(d, scale, hk))
                assert abs(hk - h64) <= margin, (n_a, n_b, d, dtype, masked, hk, h64, margin)

            # Empty sides: an empty query side gives 0.0, an empty target +inf.
            none_a = torch.zeros(n_a, dtype=torch.bool, device=DEVICE)
            none_b = torch.zeros(n_b, dtype=torch.bool, device=DEVICE)
            assert float(ops.directed_hausdorff(a, b, valid_a=none_a)) == 0.0
            assert float(ops.directed_hausdorff(a, b, valid_b=none_b)) == float("inf")
            ka, kb = ops.fused_min_sqdists(a, b, valid_a=none_a)
            assert torch.isinf(ka).all() and torch.isinf(kb).all()

            # Pruning on sorted clouds: bitwise equal to unpruned, and
            # across two prune-table block sizes.
            dirs = projections.direction_set(a, b, projections.default_num_directions(d))
            sa, pja, _, _ = tile_bounds.order_by_projection(a, projections.project(a, dirs))
            sb, pjb, _, _ = tile_bounds.order_by_projection(b, projections.project(b, dirs))
            base = ops.fused_min_sqdists(sa, sb)
            skips = {}
            for blk in (128, 512):
                pr = ops.fused_min_sqdists(sa, sb, prune_projs=(pja, pjb), block_a=blk, block_b=blk)
                assert torch.equal(pr[0], base[0]) and torch.equal(pr[1], base[1]), (n_a, n_b, d, blk)
                dr = ops.min_sqdists(sa, sb, prune_projs=(pja, pjb), block_a=blk, block_b=blk)
                assert torch.equal(dr, base[0]), (n_a, n_b, d, blk, "directed")
                du = ops.min_sqdists(sa, sb, block_a=blk, block_b=blk)
                assert torch.equal(du, base[0]), (n_a, n_b, d, blk, "directed unpruned")
                tables = tile_bounds.prune_tables(
                    sa, pja, None, sb, pjb, None, ops.fit_block(blk, n_a), ops.fit_block(blk, n_b)
                )
                skips[blk] = float(tile_bounds.skip_fraction(tables))
            rows.append({"shape": [n_a, n_b, d], "dtype": str(dtype).split(".")[-1],
                         "tol": tol, "skip_fraction": skips})
    torch.cuda.synchronize()

    # Pruning that bites: low-D clouds, many tiles skipped, still bitwise.
    a, b = random_clouds(gen, 8192, 8192, 2)
    dirs = projections.direction_set(a, b, 1)
    sa, pja, _, _ = tile_bounds.order_by_projection(a, projections.project(a, dirs))
    sb, pjb, _, _ = tile_bounds.order_by_projection(b, projections.project(b, dirs))
    base = ops.fused_min_sqdists(sa, sb)
    pr = ops.fused_min_sqdists(sa, sb, prune_projs=(pja, pjb), block_a=128, block_b=128)
    assert torch.equal(pr[0], base[0]) and torch.equal(pr[1], base[1])
    tables = tile_bounds.prune_tables(sa, pja, None, sb, pjb, None, 128, 128)
    bite = float(tile_bounds.skip_fraction(tables))
    assert bite > 0.25, bite
    dr = ops.min_sqdists(sa, sb, prune_projs=(pja, pjb), block_a=128, block_b=128)
    assert torch.equal(dr, base[0]), "directed pruned vs unpruned, low D"
    plans = plan_independence(gen, sms)
    emit({"phase": "kernel_vs_plain", "cases": rows, "max_abs_err": max_err,
          "pairs_per_cta": walks, "low_d_skip_fraction": bite, "launch_plans": plans})
    return max_err


def plan_independence(gen, sms: int) -> list[dict]:
    """Kernel 1's outputs bit for bit under different launch plans (the
    planned grid, 7 CTAs, a forced streamed and a forced resident a-tile),
    both instances, at D 1, 3, 17 and 256, fp32 and bf16, ragged sides."""
    import torch

    from repro_torch.data.pointclouds import random_clouds
    from repro_torch.kernels.hausdorff import hausdorff as K

    n_a, n_b = 1000, 3000
    rows = []
    for d in (1, 3, 17, 256):
        a32, b32 = random_clouds(gen, n_a, n_b, d)
        for dtype in (torch.float32, torch.bfloat16):
            a, b = a32.to(dtype).contiguous(), b32.to(dtype).contiguous()
            a2 = (a.float() ** 2).sum(1)
            b2 = (b.float() ** 2).sum(1)
            base = K.launch_plan(n_a, n_b, d, sms)
            plans = {"planned": None, "7 CTAs": base._replace(grid=7),
                     "streamed": K.launch_plan(n_a, n_b, d, sms, resident=False),
                     "resident": K.launch_plan(n_a, n_b, d, sms, resident=True)}
            for directed in (False, True):
                outs = {}
                for label, plan in plans.items():
                    ma = torch.full((n_a,), torch.inf, device=DEVICE)
                    mb = torch.full((n_b,), torch.inf, device=DEVICE)
                    K.fused_minscan(a, b, a2, b2, ma, mb, directed=directed, plan=plan)
                    outs[label] = (ma, mb)
                ref_a, ref_b = outs["planned"]
                for label, (ma, mb) in outs.items():
                    assert torch.equal(ma, ref_a), (d, dtype, directed, label)
                    if directed:
                        assert torch.isinf(mb).all(), (d, dtype, label, "directed wrote min_b")
                    else:
                        assert torch.equal(mb, ref_b), (d, dtype, label)
            rows.append({"d": d, "dtype": str(dtype).split(".")[-1], "planned": base._asdict(),
                         "plans": list(plans)})
    return rows


def bucket_plans_agree(launch, shapes, n_groups: int, n_sets: int, n_q: int, cap: int, d: int,
                       shared_query: bool, gated: bool, sms: int) -> dict:
    """A bucket pass (kernel 2 or 3: ``launch(min_a, min_b, directed=,
    plan=)`` on fixed operands and gate) bit for bit under five launch plans
    (planned, 7 CTAs, forced streamed, forced resident query tile where the
    query is shared, set order 1) and both instances: the directed row mins
    equal the bidirectional ones and its column mins stay +inf.  A forced
    resident tile with a per-set query is refused."""
    import torch

    from repro_torch.kernels.hausdorff import batched as KB

    def plan(**kw):
        return KB.bucket_launch_plan(n_groups, n_sets, n_q, cap, d, sms, shared_query=shared_query, gated=gated,
                                     **kw)

    base = plan()
    plans = {"planned": None, "7 CTAs": base._replace(grid=7), "streamed": plan(resident=False),
             "set order 1": base._replace(set_step=1)}
    if shared_query:
        plans["resident"] = plan(resident=True)
    else:
        try:
            plan(resident=True)
        except ValueError:
            pass
        else:
            raise AssertionError("a resident tile with a per-set query was accepted")
    outs = {}
    for directed in (False, True):
        for label, p in plans.items():
            ma = torch.full(shapes[0], torch.inf, device=DEVICE)
            mb = torch.full(shapes[1], torch.inf, device=DEVICE)
            launch(ma, mb, directed=directed, plan=p)
            outs[directed, label] = (ma, mb)
    ref_a, ref_b = outs[False, "planned"]
    for (directed, label), (ma, mb) in outs.items():
        assert torch.equal(ma, ref_a), (label, directed, "row mins")
        assert torch.isinf(mb).all() if directed else torch.equal(mb, ref_b), (label, directed, "column mins")
    return {"planned": base._asdict(), "plans": list(plans)}


def batched_case(gen, n_sets, n_q, cap, d, *, per_set_q=False, shared_slab=False):
    """Random operands for one kernel-2 case: (q, slab, valid_q, valid_slab)."""
    import torch

    q_shape = (n_sets, n_q, d) if per_set_q else (n_q, d)
    s_shape = (cap, d) if shared_slab else (n_sets, cap, d)
    q = torch.randn(q_shape, generator=gen, device=DEVICE)
    slab = torch.randn(s_shape, generator=gen, device=DEVICE) * 1.5 + 0.25
    valid_q = None
    if per_set_q:
        valid_q = torch.rand(n_sets, n_q, generator=gen, device=DEVICE) > 0.2
        valid_q[:, 0] = True
    valid_slab = None
    if not shared_slab:
        # each set a valid prefix of random length; set 1 all-invalid
        lens = torch.randint(1, cap + 1, (n_sets,), generator=gen, device=DEVICE)
        valid_slab = torch.arange(cap, device=DEVICE)[None, :] < lens[:, None]
        valid_slab[min(1, n_sets - 1)] = False
    return q, slab, valid_q, valid_slab


def phase_batched_vs_plain(seed: int) -> float:
    """Kernel 2 against its plain version, gate semantics, and each lane
    against kernel 1 on that set's rows (bitwise, same norms)."""
    import torch

    from repro_torch.core.fp_margin import sqdist_tolerance
    from repro_torch.data.pointclouds import make_generator
    from repro_torch.kernels.hausdorff import batched as KB
    from repro_torch.kernels.hausdorff import hausdorff as K

    gen = make_generator(seed + 10, DEVICE)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [
        ("shared query, ragged caps", dict(n_sets=64, n_q=128, cap=256, d=256)),
        ("shared query, two a-tiles, odd D", dict(n_sets=33, n_q=300, cap=200, d=100)),
        ("cap 64", dict(n_sets=40, n_q=128, cap=64, d=256)),
        ("per-set query (stage 1 pass 1)", dict(n_sets=48, n_q=40, cap=128, d=256, per_set_q=True)),
        ("per-set query, shared slab (stage 1 pass 2)",
         dict(n_sets=48, n_q=24, cap=128, d=256, per_set_q=True, shared_slab=True)),
        ("shared query, D 1", dict(n_sets=20, n_q=128, cap=64, d=1)),
        ("per-set query, D 3", dict(n_sets=24, n_q=40, cap=128, d=3, per_set_q=True)),
        ("shared query, two a-tiles, D 17", dict(n_sets=33, n_q=300, cap=256, d=17)),
        ("per-set query, many slab tiles (served pairwise)", dict(n_sets=3, n_q=200, cap=2000, d=256, per_set_q=True)),
    ]
    max_err = 0.0
    rows = []
    with uncounted():
        for label, kw in cases:
            q, slab, vq, vs = batched_case(gen, **kw)
            n_sets = kw["n_sets"]
            scale = max(float(torch.linalg.vector_norm(q, dim=-1).max()),
                        float(torch.linalg.vector_norm(slab, dim=-1).max()))
            tol = sqdist_tolerance(kw["d"], scale)
            # gate: a third of the sets skipped, one with a NaN bound
            lb = torch.rand(n_sets, generator=gen, device=DEVICE)
            cut = torch.full((n_sets,), 0.66, device=DEVICE)
            lb[0] = 0.0
            lb[min(2, n_sets - 1)] = torch.nan
            gated = ~(lb <= cut)
            ka, kb = KB.batched_min_sqdists(q, slab, valid_q=vq, valid_slab=vs, lb=lb, cut=cut)
            pa, pb = KB.batched_min_sqdists_mirror(q, slab, valid_q=vq, valid_slab=vs, lb=lb, cut=cut)
            torch.cuda.synchronize()
            assert torch.isinf(ka[gated]).all() and torch.isinf(kb[gated]).all(), label
            assert torch.isinf(pa[gated]).all() and torch.isinf(pb[gated]).all(), label
            err = max(finite_err(ka, pa), finite_err(kb, pb))
            assert err <= tol, (label, err, tol)
            max_err = max(max_err, err)
            # gated vs ungated: every computed lane keeps its bits
            ua, ub = KB.batched_min_sqdists(q, slab, valid_q=vq, valid_slab=vs)
            assert torch.equal(ua[~gated], ka[~gated]) and torch.equal(ub[~gated], kb[~gated]), label
            # lane s against kernel 1 on that set's rows, same norm tensors
            qp, q2 = KB._poison(q, vq)
            sp, b2 = KB._poison(slab, vs)
            lane_bitwise = True
            for s in range(0, n_sets, max(1, n_sets // 6)):
                qs_, q2s = (qp[s], q2[s]) if qp.ndim == 3 else (qp, q2)
                ss_, b2s = (sp[s], b2[s]) if sp.ndim == 3 else (sp, b2)
                m_a = torch.full((qs_.shape[0],), torch.inf, device=DEVICE)
                m_b = torch.full((ss_.shape[0],), torch.inf, device=DEVICE)
                K.fused_minscan(qs_.contiguous(), ss_.contiguous(), q2s.contiguous(),
                                b2s.contiguous(), m_a, m_b)
                lane_bitwise &= bool(torch.equal(m_a, ua[s]) and torch.equal(m_b, ub[s]))
            assert lane_bitwise, (label, "kernel 2 lane differs from kernel 1 on the same rows")
            # every launch plan and both instances, bitwise
            qe = qp if qp.ndim == 3 else qp.expand(n_sets, *qp.shape)
            q2e = q2 if q2.ndim == 2 else q2.expand(n_sets, *q2.shape)
            se = sp if sp.ndim == 3 else sp.expand(n_sets, *sp.shape)
            b2e = b2 if b2.ndim == 2 else b2.expand(n_sets, *b2.shape)
            plans = bucket_plans_agree(
                lambda ma, mb, **kw_: KB.batched_minscan(qe, q2e, se, b2e, ma, mb, lb=lb, cut=cut, **kw_),
                (ua.shape, ub.shape), 1, n_sets, kw["n_q"], kw["cap"], kw["d"],
                not kw.get("per_set_q", False), True, sms)
            rows.append({"case": label, "shape": [n_sets, kw["n_q"], kw["cap"], kw["d"]],
                         "max_abs_err": err, "tol": tol, "gated": int(gated.sum()),
                         "lane_vs_kernel1_bitwise": lane_bitwise, "launch_plans": plans})
    emit({"phase": "batched_vs_plain", "cases": rows, "max_abs_err": max_err})
    return max_err


def multiquery_case(gen, n_queries, n_q, n_sets, cap, d, *, n_valid=None):
    """Random operands for one kernel-3 case: (qs, slab, valid_qs,
    valid_slab), ragged validity on both sides (``n_valid`` pins every
    set's valid prefix, for the reference's tiny shapes)."""
    import torch

    qs = torch.randn(n_queries, n_q, d, generator=gen, device=DEVICE)
    slab = torch.randn(n_sets, cap, d, generator=gen, device=DEVICE) * 1.5 + 0.25
    valid_qs = torch.rand(n_queries, n_q, generator=gen, device=DEVICE) > 0.2
    valid_qs[:, 0] = True
    if n_valid is None:
        lens = torch.randint(1, cap + 1, (n_sets,), generator=gen, device=DEVICE)
    else:
        lens = torch.full((n_sets,), n_valid, device=DEVICE)
    valid_slab = torch.arange(cap, device=DEVICE)[None, :] < lens[:, None]
    valid_slab[min(1, n_sets - 1)] = False
    return qs, slab, valid_qs, valid_slab


def multiquery_gate(gen, n_queries, n_sets):
    """(lb, cut) for a kernel-3 case: about a third of the pairs gated, a
    NaN bound at (0, 2), and with Q > 1 a −inf cut gating all of query 1."""
    import torch

    lb = torch.rand(n_queries, n_sets, generator=gen, device=DEVICE)
    cut = torch.full((n_queries, n_sets), 0.66, device=DEVICE)
    lb[:, 0] = 0.0
    lb[0, min(2, n_sets - 1)] = torch.nan
    if n_queries > 1:
        cut[1] = -torch.inf
    return lb, cut


def lanes_vs_kernel2(qs, slab, valid_qs, valid_slab, lb, cut, ka, kb) -> bool:
    """Is every (query, set) pair of kernel 3's output bitwise kernel 2's
    with that query against the slab (same poisoned norms, same gate)?"""
    import torch

    from repro_torch.kernels.hausdorff import batched as KB

    qp, q2 = KB._poison(qs, valid_qs)
    sp, b2 = KB._poison(slab, valid_slab)
    n_sets = sp.shape[0]
    same = True
    for i in range(qp.shape[0]):
        m_a = torch.full((n_sets, qp.shape[1]), torch.inf, device=DEVICE)
        m_b = torch.full((n_sets, sp.shape[1]), torch.inf, device=DEVICE)
        KB.batched_minscan(qp[i].expand(n_sets, *qp[i].shape), q2[i].expand(n_sets, q2.shape[1]), sp, b2,
                           m_a, m_b, lb=None if lb is None else lb[i].contiguous(),
                           cut=None if cut is None else cut[i].contiguous())
        same &= bool(torch.equal(m_a, ka[i]) and torch.equal(m_b, kb[i]))
    return same


def phase_multiquery_vs_plain(seed: int) -> float:
    """Kernel 3 against its plain version, its gate semantics, and each pair
    against kernel 2 with that query (bitwise, same norms)."""
    import torch

    from repro_torch.core.fp_margin import sqdist_tolerance
    from repro_torch.data.pointclouds import make_generator
    from repro_torch.kernels.hausdorff import batched as KB

    gen = make_generator(seed + 20, DEVICE)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # (label, Q, n_q, S, cap, D, valid rows per set or None for ragged)
    cases = [
        ("one query, one row, cap 64, D 3", 1, 1, 24, 64, 3, None),
        ("Q 3, n_q 37, cap 128, D 17", 3, 37, 40, 128, 17, None),
        ("Q 16, n_q 128, cap 256, D 256", 16, 128, 48, 256, 256, None),
        ("Q 3, n_q 200 (two tiles), cap 256, D 256", 3, 200, 33, 256, 256, None),
        ("Q 16, n_q 37, cap 64, D 17", 16, 37, 20, 64, 17, None),
        ("Q 1, n_q 128, cap 128, D 256", 1, 128, 30, 128, 256, None),
        ("reference failing shape (n_q 1, n_b 1, D 1)", 3, 1, 6, 8, 1, 1),
        ("reference failing shape (n_q 38, n_b 8, D 17)", 3, 38, 6, 8, 17, 8),
        ("reference failing shape (n_q 1, n_b 2, D 2)", 3, 1, 6, 8, 2, 2),
    ]
    max_err = 0.0
    rows = []
    with uncounted():
        for label, nqs, n_q, n_sets, cap, d, n_valid in cases:
            qs, slab, vq, vs = multiquery_case(gen, nqs, n_q, n_sets, cap, d, n_valid=n_valid)
            if nqs >= 3:
                vq[nqs - 1] = False  # an all-invalid query
            lb, cut = multiquery_gate(gen, nqs, n_sets)
            gated = ~(lb <= cut)
            scale = max(float(torch.linalg.vector_norm(qs, dim=-1).max()),
                        float(torch.linalg.vector_norm(slab, dim=-1).max()))
            tol = sqdist_tolerance(d, scale)
            ka, kb = KB.multiquery_min_sqdists(qs, slab, valid_qs=vq, valid_slab=vs, lb=lb, cut=cut)
            pa, pb = KB.multiquery_min_sqdists_mirror(qs, slab, valid_qs=vq, valid_slab=vs, lb=lb, cut=cut)
            torch.cuda.synchronize()
            for t in (ka, kb, pa, pb):
                assert torch.isinf(t[gated]).all(), (label, "gated pair not +inf")
            err = max(finite_err(ka, pa), finite_err(kb, pb))
            assert err <= tol, (label, err, tol)
            max_err = max(max_err, err)
            ua, ub = KB.multiquery_min_sqdists(qs, slab, valid_qs=vq, valid_slab=vs)
            assert torch.equal(ua[~gated], ka[~gated]) and torch.equal(ub[~gated], kb[~gated]), label
            same = lanes_vs_kernel2(qs, slab, vq, vs, lb, cut, ka, kb)
            assert same, (label, "kernel 3 pair differs from kernel 2 with the same query")
            qp, q2 = KB._poison(qs, vq)
            sp, b2 = KB._poison(slab, vs)
            plans = bucket_plans_agree(
                lambda ma, mb, **kw_: KB.multiquery_minscan(qp, q2, sp, b2, ma, mb, lb=lb, cut=cut, **kw_),
                (ka.shape, kb.shape), nqs, n_sets, n_q, cap, d, True, True, sms)
            rows.append({"case": label, "shape": [nqs, n_q, n_sets, cap, d], "max_abs_err": err, "tol": tol,
                         "gated_pairs": int(gated.sum()), "pairs_vs_kernel2_bitwise": same,
                         "launch_plans": plans})
    emit({"phase": "multiquery_vs_plain", "cases": rows, "max_abs_err": max_err})
    return max_err


def bucket_bound(peak: float, n_sets: int, rows: int, n_q: int, cap: int, d: int, gated: bool = False):
    """(bound_ms, bound_by, flops) of a bucket pass over ``n_sets`` computed
    sets holding ``rows`` valid rows in all: the work this data needs is the
    valid rows' d² entries (padding rows need none), each input read once
    (the computed sets' slab rows and norms, the query, the gate) and each
    output written once."""
    flops = 2.0 * rows * n_q * d
    nbytes = 4.0 * (rows * d + n_q * d + rows + n_q
                    + n_sets * (n_q + cap) + (2 * n_sets if gated else 0))
    op_ms = flops / peak * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms else "bytes"), flops


def time_bucket(label, q, slab, valid_slab, lb, cut, env: dict) -> dict:
    """CUDA-event times of kernel 2, its plain version and torch.cdist + amin
    on one bucket pass, with the timed outputs held against each other."""
    import torch

    from repro_torch.core.fp_margin import sqdist_tolerance
    from repro_torch.kernels.hausdorff import batched as KB

    n_sets, cap, d = slab.shape
    n_q = q.shape[0]
    qp, q2 = KB._poison(q, None)
    sp, b2 = KB._poison(slab, valid_slab)
    qe, q2e = qp.expand(n_sets, n_q, d), q2.expand(n_sets, n_q)
    gl, gc = (None, None) if lb is None else (lb.float().contiguous(), cut.float().contiguous())
    min_a = torch.empty(n_sets, n_q, device=DEVICE)
    min_b = torch.empty(n_sets, cap, device=DEVICE)

    def kernel():
        min_a.fill_(torch.inf)
        min_b.fill_(torch.inf)
        KB.batched_minscan(qe, q2e, sp, b2, min_a, min_b, lb=gl, cut=gc)

    with uncounted():
        ms = cuda_ms(kernel)
    plain = {}

    def plain_scan():
        plain["mins"] = KB.batched_min_sqdists_mirror(q, slab, valid_slab=valid_slab, lb=lb, cut=cut)

    plain_ms = cuda_ms(plain_scan)
    pa, pb = plain.pop("mins")
    scale = max(float(torch.linalg.vector_norm(q, dim=-1).max()),
                float(torch.linalg.vector_norm(sp, dim=-1).max()))
    tol = sqdist_tolerance(d, scale)
    err = max(finite_err(min_a, pa), finite_err(min_b, pb))
    assert err <= tol, (label, err, tol)
    del pa, pb

    def library():
        dist = torch.cdist(q.expand(n_sets, n_q, d), sp)
        return dist.amin(dim=2), dist.amin(dim=1)

    library_ms = cuda_ms(library)
    torch.cuda.empty_cache()
    on = torch.ones(n_sets, dtype=torch.bool, device=DEVICE) if lb is None else lb <= cut
    computed = int(on.sum())
    rows = int(valid_slab[on].sum()) if valid_slab is not None else computed * cap
    bound_ms, bound_by, flops = bucket_bound(env["fp32_peak_tflops"] * 1e12, computed, rows, n_q, cap, d,
                                             gated=lb is not None)
    return {"label": label, "shape": [n_sets, n_q, cap, d], "computed_sets": computed,
            "valid_rows": rows,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "torch.cdist + amin (distances, not d²; yardstick)",
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err, "tol": tol,
            "achieved_tflops": flops / (ms * 1e-3) / 1e12}


def corpus_store(seed: int, n_sets: int):
    """The clustered corpus in a SetStore on the card, the query, and the
    sets' cluster labels."""
    import numpy as np
    import torch

    from repro_torch.data.pointclouds import clustered_sets, make_generator
    from repro_torch.index import SetStore

    t0 = time.perf_counter()
    sets, labels = clustered_sets(seed, n_sets, D, sizes=CORPUS_SIZES, n_clusters=32, spread=10.0, sigma=0.5)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = SetStore(dim=D, generator=make_generator(seed, "cpu"), device=DEVICE)
    store.add_many(sets)
    store.summaries()
    buckets = store.packed_buckets()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    q = (np.asarray(sets[0]).mean(axis=0)
         + np.random.RandomState(11).randn(N_QUERY, D).astype(np.float32) * 0.5).astype(np.float32)
    info = {"n_sets": n_sets, "generate_s": gen_s, "store_build_s": build_s,
            "buckets": {str(c): int(b.points.shape[0]) for c, b in sorted(buckets.items())},
            "slab_bytes": int(sum(b.points.numel() * 4 for b in buckets.values()))}
    return sets, store, q, info, labels


def hd64(q, s, directed: bool) -> float:
    """float64 (directed) Hausdorff distance of two host clouds."""
    import numpy as np

    q64, s64 = q.astype(np.float64), s.astype(np.float64)
    d2 = (q64 * q64).sum(1)[:, None] - 2.0 * q64 @ s64.T + (s64 * s64).sum(1)[None, :]
    d2 = np.maximum(d2, 0.0)
    h = float(np.sqrt(d2.min(1).max()))
    return h if directed else max(h, float(np.sqrt(d2.min(0).max())))


SCAN_FORMS = {
    (3, 3): "stage 1: per-lane subsets vs the lanes' sets",
    (3, 2): "stage 1: per-lane subsets vs the shared query",
    (2, 3): "stage 2a: shared query vs the bucket slab",
}


SERVED_SCAN_FORMS = {(3, 3): "served pairwise: per-lane α-subsets vs per-lane slabs"}


@contextlib.contextmanager
def checked_scans(rows: list, forms: dict = SCAN_FORMS):
    """Inside the block, hold every call of kernel 2's wrapper against the
    plain version on the same operands, per min-d² entry within
    2·(D+2)·eps32·scale², and append one row per call (its operand form,
    shape, gated lanes and error) to ``rows``.  A call whose operand form
    is not in ``forms`` fails."""
    import torch

    from repro_torch.core.fp_margin import sqdist_tolerance
    from repro_torch.kernels.hausdorff import batched as KB

    wrapper = KB.batched_min_sqdists

    def checked(q, slab, **kw):
        ka, kb = wrapper(q, slab, **kw)
        pa, pb = KB.batched_min_sqdists_mirror(q, slab, **kw)
        qp, _ = KB._poison(q, kw.get("valid_q"))
        sp, _ = KB._poison(slab, kw.get("valid_slab"))
        scale = max(float(torch.linalg.vector_norm(qp, dim=-1).max()),
                    float(torch.linalg.vector_norm(sp, dim=-1).max()))
        tol = sqdist_tolerance(q.shape[-1], scale)
        err = max(finite_err(ka, pa), finite_err(kb, pb))
        form = forms[(q.ndim, slab.ndim)]
        assert err <= tol, (form, tuple(q.shape), tuple(slab.shape), err, tol)
        lb, cut = kw.get("lb"), kw.get("cut")
        rows.append({"form": form, "q": list(q.shape), "slab": list(slab.shape),
                     "gated": 0 if lb is None else int((~(lb <= cut)).sum()),
                     "max_abs_err": err, "tol": tol})
        return ka, kb

    KB.batched_min_sqdists = checked
    try:
        yield
    finally:
        KB.batched_min_sqdists = wrapper


def check_search(res, bf, store, label: str) -> None:
    """A cascade result against brute force on the card: bitwise ids and
    values, kernel 2 serving every bucket pass, nothing absorbed."""
    import numpy as np

    assert np.array_equal(res.ids, bf.ids), (label, res.ids, bf.ids)
    assert np.array_equal(res.values, bf.values), (label, res.values, bf.values)
    for r in (res, bf):
        assert r.degraded is False and "fault" not in r.stats and "backend_fallbacks" not in r.stats, (label, r.stats)
    assert res.stats["masked_backend"] == "batched_cuda", (label, res.stats)


def stage1_eigh_s(passes1) -> float:
    """Seconds that ``torch.linalg.eigh`` alone takes on Gram matrices of
    stage 1's shapes: one (batch, D, D) call per bucket pass, as stage 1
    makes it (device synchronised, after a one-matrix warm-up)."""
    import torch

    total = 0.0
    for p in passes1:
        z = torch.randn(p["batch"], N_QUERY + p["capacity"], D, device=DEVICE)
        gram = z.transpose(-1, -2) @ z
        torch.linalg.eigh(gram[:1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.linalg.eigh(gram)
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
        del z, gram
    return total


def phase_search(seed: int) -> dict:
    """The corpus search on the card at 16,384 sets, then directed,
    sequential and anytime ε = 0 at 2,048 sets, each against brute force."""
    import numpy as np

    from repro_torch.core.fp_margin import fp_value_margin
    from repro_torch.hd import search
    from repro_torch.kernels.hausdorff import batched as KB
    from repro_torch.kernels.hausdorff import hausdorff as K
    from repro_torch.obs import trace

    sets, store, q, info, labels = corpus_store(seed, N_CORPUS)
    runs = {}
    with trace.capture() as events:
        n1, n2 = K.fused_minscan.launches, KB.batched_minscan.launches
        res = search(q, store, K_TOP, on_fault="raise", measure=True)
        launches = {"fused_minscan": K.fused_minscan.launches - n1,
                    "batched_minscan": KB.batched_minscan.launches - n2}
        spans = {e["name"]: e["dur_s"] for e in events() if e["type"] == "span"}
        passes = [e["attrs"] for e in events() if e["name"] == "cascade.stage2a_pass"]
        passes1 = [e["attrs"] for e in events() if e["name"] == "cascade.stage1_pass"]
    bf = search(q, store, K_TOP, method="exact", on_fault="raise", measure=True)
    check_search(res, bf, store, "16k cascade")
    assert launches["batched_minscan"] > 0 and launches["fused_minscan"] > 0, launches
    # the returned values against float64 on the host
    for sid, v in zip(res.ids.tolist(), res.values.tolist()):
        s = sets[sid]
        scale = float(np.linalg.norm(q, axis=1).max() + np.linalg.norm(s, axis=1).max())
        h = hd64(q, s, False)
        assert abs(v - h) <= float(fp_value_margin(D, scale, v)), (sid, v, h)
    warm = search(q, store, K_TOP, on_fault="raise", measure=True)
    check_search(warm, bf, store, "16k cascade, second run")
    # Kernel 2 at the shapes the search gives it: a third run, uncounted,
    # with every wrapper call held against the plain version.
    scans = []
    with uncounted(), checked_scans(scans):
        held = search(q, store, K_TOP, on_fault="raise")
    check_search(held, bf, store, "16k cascade, kernel 2 held to its plain version")
    assert len(scans) == launches["batched_minscan"], (len(scans), launches)
    assert {r["form"] for r in scans} == set(SCAN_FORMS.values()), scans
    assert sum(r["form"].startswith("stage 1") for r in scans) == 2 * len(passes1), (scans, passes1)
    runs["corpus"] = {
        **info, "k": K_TOP, "ids": res.ids.tolist(), "values": res.values.tolist(),
        "cascade_s": res.meta.elapsed_s, "cascade_warm_s": warm.meta.elapsed_s,
        "brute_force_s": bf.meta.elapsed_s,
        "stage_s": {k: spans.get(f"cascade.{k}") for k in ("stage0", "stage1", "stage2a", "stage2b")},
        "stats": {k: v for k, v in res.stats.items() if not isinstance(v, (list, dict))},
        "stage1_passes": passes1, "stage1_eigh_s": stage1_eigh_s(passes1),
        "stage2a_passes": passes, "launches": launches,
        "kernel2_held_to_plain": scans,
    }
    del warm, held
    big = {"sets": sets, "store": store, "q": q, "labels": labels, "res": res, "bf": bf}

    sets, small, q, info, labels = corpus_store(seed + 1, N_CORPUS_SMALL)
    checks = []
    for label, kw, bf_kw in (
        ("directed", dict(variant="directed"), dict(variant="directed")),
        ("sequential", dict(stage2="sequential"), {}),
        ("anytime eps=0", dict(mode="anytime", epsilon=0.0), {}),
    ):
        r = search(q, small, K_TOP, on_fault="raise", measure=True, **kw)
        b = search(q, small, K_TOP, method="exact", on_fault="raise", measure=True, **bf_kw)
        check_search(r, b, small, label)
        checks.append({"check": label, "ids": r.ids.tolist(), "cascade_s": r.meta.elapsed_s,
                       "brute_force_s": b.meta.elapsed_s, "exact_refines": r.stats["exact_refines"]})
    runs["small_corpus"] = {**info, "checks": checks}
    return {"runs": runs, "store": big["store"], "q": big["q"], "passes": passes,
            "held": held_summary("search", scans), "big": big,
            "small": {"sets": sets, "store": small, "q": q, "labels": labels}}


def phase_times_batched(corpus: dict, env: dict) -> list[dict]:
    """Kernel 2 timed on the full cap-256, cap-128 and cap-64 buckets
    (ungated; stage 1 walks all three) and on the largest stage-2a pass the
    search made (real lanes computed, pow2 padding lanes gated, as the
    search ran it)."""
    import torch

    store, q = corpus["store"], corpus["q"]
    q = torch.from_numpy(q).to(DEVICE)
    rows = []
    for cap in (256, 128, 64):
        bucket = store.packed_buckets()[cap]
        rows.append(time_bucket(f"full cap-{cap} bucket, ungated", q, bucket.points, bucket.valid, None, None, env))
    if corpus["passes"]:
        p = max(corpus["passes"], key=lambda a: a["lanes"] * a["capacity"])
        b = store.packed_buckets()[p["capacity"]]
        take = torch.arange(p["batch"], device=DEVICE) % p["lanes"]
        lb = torch.where(torch.arange(p["batch"], device=DEVICE) < p["lanes"], 0.0, torch.inf)
        cut = torch.ones(p["batch"], device=DEVICE)
        rows.append(time_bucket(f"stage-2a pass (cap {p['capacity']}, {p['lanes']} lanes, batch {p['batch']})",
                                q, b.points[take], b.valid[take], lb, cut, env))
    torch.cuda.empty_cache()
    emit({"phase": "times_batched", "rows": rows})
    return rows


def batch_queries(seed: int, sets, labels, q0):
    """search_batch's unique queries: ``q0`` (phase 8's query) and N_UNIQUE − 1
    more, 128 points each around the centroids of sets in other clusters,
    drawn from ``seed``."""
    import numpy as np

    picked, seen = [], {int(labels[0])}
    for sid, lab in enumerate(labels):
        if int(lab) not in seen:
            seen.add(int(lab))
            picked.append(sid)
        if len(picked) == N_UNIQUE - 1:
            break
    rng = np.random.RandomState(seed + 100)
    qs = [q0] + [(np.asarray(sets[sid]).mean(axis=0) + rng.randn(N_QUERY, D).astype(np.float32) * 0.5)
                 .astype(np.float32) for sid in picked]
    return qs, picked


def batch_requests(uniq):
    """The 16 requests: each unique query 4 times, the last of each at K_SMALL."""
    reqs = [(i % N_UNIQUE) for i in range(N_REQUESTS)]
    ks = [K_SMALL if i >= N_REQUESTS - N_UNIQUE else K_TOP for i in range(N_REQUESTS)]
    return [uniq[u] for u in reqs], ks, reqs


def check_batch(results, ks, owners, bfs, label: str, backend: str = "multiquery_cuda") -> None:
    """Every search_batch result bitwise its query's brute force (a prefix
    of it at K_SMALL), nothing absorbed, kernel 3 serving stage 2a."""
    import numpy as np

    for i, (r, k, u) in enumerate(zip(results, ks, owners)):
        bf = bfs[u]
        assert np.array_equal(r.ids, bf.ids[:k]), (label, i, r.ids, bf.ids[:k])
        assert np.array_equal(r.values, bf.values[:k]), (label, i, r.values, bf.values[:k])
        assert r.degraded is False and "fault" not in r.stats and "backend_fallbacks" not in r.stats, (label, i)
        assert r.stats["masked_backend"] == backend, (label, r.stats)


@contextlib.contextmanager
def checked_multiquery(rows: list, keep: dict):
    """Inside the block, hold every call of kernel 3's wrapper against the
    plain version on the same operands, per min-d² entry within
    2·(D+2)·eps32·scale², and append one row per call to ``rows``; keep the
    operands of the call with the most work (computed pairs × cap) in
    ``keep``, for timing the kernel at the path's own shape."""
    import torch

    from repro_torch.core.fp_margin import sqdist_tolerance
    from repro_torch.kernels.hausdorff import batched as KB

    wrapper = KB.multiquery_min_sqdists

    def checked(qs, slab, **kw):
        ka, kb = wrapper(qs, slab, **kw)
        pa, pb = KB.multiquery_min_sqdists_mirror(qs, slab, **kw)
        qp, _ = KB._poison(qs, kw.get("valid_qs"))
        sp, _ = KB._poison(slab, kw.get("valid_slab"))
        scale = max(float(torch.linalg.vector_norm(qp, dim=-1).max()),
                    float(torch.linalg.vector_norm(sp, dim=-1).max()))
        tol = sqdist_tolerance(qs.shape[-1], scale)
        err = max(finite_err(ka, pa), finite_err(kb, pb))
        assert err <= tol, (tuple(qs.shape), tuple(slab.shape), err, tol)
        lb, cut = kw.get("lb"), kw.get("cut")
        computed = qs.shape[0] * slab.shape[0] if lb is None else int((lb <= cut).sum())
        rows.append({"qs": list(qs.shape), "slab": list(slab.shape),
                     "gated_pairs": qs.shape[0] * slab.shape[0] - computed,
                     "max_abs_err": err, "tol": tol})
        if computed * slab.shape[1] > keep.get("work", -1):
            keep.update(work=computed * slab.shape[1], qs=qs, slab=slab, **kw)
        del pa, pb
        return ka, kb

    KB.multiquery_min_sqdists = checked
    try:
        yield
    finally:
        KB.multiquery_min_sqdists = wrapper


def phase_search_batch(seed: int, corpus: dict) -> dict:
    """search_batch over phase 8's 16,384-set store: 16 requests over 4
    unique queries, each bitwise equal to its brute force; then an
    uncounted run with every kernel-3 call held to the plain version."""
    from repro_torch.hd import search, search_batch
    from repro_torch.obs import trace

    big = corpus["big"]
    store = big["store"]
    uniq, picked = batch_queries(seed, big["sets"], big["labels"], big["q"])
    queries, ks, owners = batch_requests(uniq)
    with trace.capture() as events:
        before = counts()
        res = search_batch(queries, store, ks, on_fault="raise", measure=True)
        launches = {k: v - before[k] for k, v in counts().items()}
        spans = {e["name"]: e["dur_s"] for e in events() if e["type"] == "span"}
        passes = [e["attrs"] for e in events() if e["name"] == "cascade.stage2a_pass"]
    assert launches["multiquery_minscan"] > 0, launches
    assert res[0].stats["dedup_hits"] == N_REQUESTS - N_UNIQUE, res[0].stats
    # brute force: phase 8's for its query, three new ones
    bfs = [big["bf"]]
    bf_s = []
    for q in uniq[1:]:
        b = search(q, store, K_TOP, method="exact", on_fault="raise", measure=True)
        bfs.append(b)
        bf_s.append(b.meta.elapsed_s)
    check_batch(res, ks, owners, bfs, "16k search_batch")
    import numpy as np

    one = big["res"]
    assert np.array_equal(res[0].ids, one.ids) and np.array_equal(res[0].values, one.values), "vs phase 8 search"
    # kernel 3 at the batch's own shapes: one more run, uncounted, with
    # every wrapper call held to the plain version
    held_rows, keep = [], {}
    with uncounted(), checked_multiquery(held_rows, keep):
        held = search_batch(queries, store, ks, on_fault="raise")
    check_batch(held, ks, owners, bfs, "16k search_batch, kernel 3 held to its plain version")
    assert len(held_rows) == launches["multiquery_minscan"], (held_rows, launches)
    stats = {k: v for k, v in res[0].stats.items() if not isinstance(v, (list, dict))}
    out = {
        "n_sets": store.n_sets, "requests": N_REQUESTS, "unique": N_UNIQUE, "ks": ks,
        "query_sets": [0] + picked,
        "search_batch_s": res[0].meta.elapsed_s,
        "stage_s": {k: spans.get(f"cascade.{k}") for k in ("stage0", "stage2a", "stage2b")},
        "span_s": spans.get("index.search_batch"),
        "stats": stats, "stage2a_passes": passes, "launches": launches,
        "pairs_per_query": [r.stats["stage2_batched_candidates"] for r in res[:N_UNIQUE]],
        "refines_per_query": [r.stats["exact_refines"] for r in res[:N_UNIQUE]],
        "one_query_search_s": corpus["runs"]["corpus"]["cascade_s"],
        "brute_force_s": [corpus["runs"]["corpus"]["brute_force_s"], *bf_s],
        "kernel3_held_to_plain": held_rows,
        "ids": [r.ids.tolist() for r in res[:N_UNIQUE]],
    }
    emit({"phase": "search_batch", **out})
    return {"results": res, "queries": queries, "ks": ks, "owners": owners, "bfs": bfs, "keep": keep,
            "held": held_summary("search_batch", held_rows)}


def phase_search_batch_small(seed: int, corpus: dict) -> None:
    """search_batch directed and anytime ε = 0 at phase 8's 2,048 sets, each
    bitwise equal to brute force."""
    from repro_torch.hd import search, search_batch

    small = corpus["small"]
    store = small["store"]
    uniq, _ = batch_queries(seed + 1, small["sets"], small["labels"], small["q"])
    checks = []
    for label, kw, bf_kw in (
        ("directed", dict(variant="directed"), dict(variant="directed")),
        ("anytime eps=0", dict(mode="anytime", epsilon=0.0), {}),
    ):
        res = search_batch(uniq, store, K_TOP, on_fault="raise", measure=True, **kw)
        bfs = [search(q, store, K_TOP, method="exact", on_fault="raise", **bf_kw) for q in uniq]
        check_batch(res, [K_TOP] * len(uniq), list(range(len(uniq))), bfs, label)
        checks.append({"check": label, "search_batch_s": res[0].meta.elapsed_s,
                       "refines": [r.stats["exact_refines"] for r in res],
                       "launches": res[0].stats["multiquery_launches"]})
    emit({"phase": "search_batch_small", "n_sets": store.n_sets, "checks": checks})


def phase_served(seed: int, corpus: dict, batch: dict) -> dict:
    """The serving layer on the card: a QueryEngine (max_batch 16) over a
    ProHDService around phase 8's store answers phase 10's requests in one
    flush, bitwise equal to search_batch; ProHDService.submit serves 8
    Random-Cloud pairs through kernel 2, certified against the exact
    set_distance."""
    import asyncio

    import numpy as np

    from repro_torch.core.fp_margin import fp_value_margin
    from repro_torch.data.pointclouds import make_generator, random_clouds
    from repro_torch.hd import set_distance
    from repro_torch.serve import EngineConfig, ProHDService, QueryEngine, ServeConfig

    svc = ProHDService(ServeConfig(), store=corpus["big"]["store"])

    async def serve_all():
        eng = QueryEngine(svc, EngineConfig(max_batch=N_REQUESTS, max_wait_s=30.0))
        try:
            out = await asyncio.gather(*[eng.search(q, k) for q, k in zip(batch["queries"], batch["ks"])])
            return eng, out
        finally:
            await eng.close()

    before = counts()
    t0 = time.perf_counter()
    eng, served = asyncio.run(serve_all())
    engine_s = time.perf_counter() - t0
    engine_launches = {k: v - before[k] for k, v in counts().items()}
    assert eng.stats["flushes"] == 1 and eng.stats["batched_queries"] == N_REQUESTS, eng.stats
    for i, (r, d) in enumerate(zip(served, batch["results"])):
        assert np.array_equal(r.ids, d.ids) and np.array_equal(r.values, d.values), ("served", i)
        assert r.degraded is False, ("served", i)
    assert engine_launches["multiquery_minscan"] > 0, engine_launches

    gen = make_generator(seed + 30, DEVICE)
    pairs = [random_clouds(gen, N_PAIR_A, n_b, D) for n_b in PAIR_B_SIZES for _ in range(2)]
    before = counts()
    t0 = time.perf_counter()
    rids = [svc.submit(a, b) for a, b in pairs]
    out = svc.flush()
    pairwise_s = time.perf_counter() - t0
    pair_launches = {k: v - before[k] for k, v in counts().items()}
    assert pair_launches["batched_minscan"] > 0, pair_launches
    rows = []
    with uncounted():
        for rid, (a, b) in zip(rids, pairs):
            h = float(set_distance(a, b).value)
            scale = scale_of(a, b)
            m = float(fp_value_margin(D, scale, h))
            r = out[rid]
            assert r["lower"] <= h + m and h <= r["upper"] + m and r["hd"] <= h + m, (rid, r, h, m)
            rows.append({"n": [a.shape[0], b.shape[0]], "H": h, **r, "margin": m})
    # Kernel 2 at the shapes the served pairwise path gives it (per-lane
    # α-subsets against slabs of 4,096-16,384 rows, many slab tiles per
    # CTA): the same 8 pairs flushed again, uncounted, with every wrapper
    # call held to the plain version; the answers must not move.
    scans = []
    with uncounted(), checked_scans(scans, SERVED_SCAN_FORMS):
        rids2 = [svc.submit(a, b) for a, b in pairs]
        out2 = svc.flush()
    assert len(scans) == pair_launches["batched_minscan"], (scans, pair_launches)
    for rid, rid2 in zip(rids, rids2):
        assert out2[rid2] == out[rid], ("served pairwise, held run", rid, out[rid], out2[rid2])
    emit({"phase": "served", "engine_s": engine_s, "engine_stats": eng.stats,
          "engine_launches": engine_launches, "pairwise_s": pairwise_s,
          "pairwise_launches": pair_launches, "pairs": rows, "kernel2_held_to_plain": scans,
          "heartbeat": {"count": svc.heartbeat.count, "total_wall_s": svc.heartbeat.total_wall_s}})
    del pairs
    return {"launches": {"engine": engine_launches, "pairwise": pair_launches},
            "held": held_summary("serve pairwise", scans)}


def multiquery_bound(peak: float, qs, slab, valid_qs, valid_slab, lb, cut) -> tuple:
    """(bound_ms, bound_by, flops) of a kernel-3 pass: 2·D FLOPs per (valid
    query row × valid slab row) of each computed pair; bytes for each input
    read once (the queries, the computed sets' valid slab rows and norms,
    the gate) and each output written once."""
    n_queries, n_q, d = qs.shape
    n_sets, cap = slab.shape[:2]
    on = (lb <= cut) if lb is not None else None
    rows_q = (valid_qs.sum(dim=1).double() if valid_qs is not None
              else qs.new_full((n_queries,), n_q, dtype=qs.dtype).double())
    rows_s = (valid_slab.sum(dim=1).double() if valid_slab is not None
              else slab.new_full((n_sets,), cap, dtype=slab.dtype).double())
    pair_rows = rows_q[:, None] * rows_s[None, :]
    if on is not None:
        pair_rows = pair_rows * on.double()
        touched = on.any(dim=0)
    else:
        touched = slab.new_ones((n_sets,), dtype=bool)
    flops = 2.0 * d * float(pair_rows.sum())
    nbytes = 4.0 * (float(rows_q.sum()) * (d + 1) + float(rows_s[touched].sum()) * (d + 1)
                    + n_queries * n_sets * (n_q + cap) + (2 * n_queries * n_sets if on is not None else 0))
    op_ms = flops / peak * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms else "bytes"), flops


def time_multiquery(label, qs, slab, valid_qs, valid_slab, lb, cut, env: dict, *, plain_queries: int) -> dict:
    """CUDA-event times of kernel 3, of Q launches of kernel 2 on the same
    work, of the plain version (on the first ``plain_queries`` queries) and
    of Q calls of torch.cdist + amin, with the timed outputs checked."""
    import torch

    from repro_torch.core.fp_margin import sqdist_tolerance
    from repro_torch.kernels.hausdorff import batched as KB

    n_queries, n_q, d = qs.shape
    n_sets, cap = slab.shape[:2]
    qp, q2 = KB._poison(qs, valid_qs)
    sp, b2 = KB._poison(slab, valid_slab)
    gl, gc = (None, None) if lb is None else (lb.float().contiguous(), cut.float().contiguous())
    min_a = torch.empty(n_queries, n_sets, n_q, device=DEVICE)
    min_b = torch.empty(n_queries, n_sets, cap, device=DEVICE)

    def kernel3():
        min_a.fill_(torch.inf)
        min_b.fill_(torch.inf)
        KB.multiquery_minscan(qp, q2, sp, b2, min_a, min_b, lb=gl, cut=gc)

    a2_ = torch.empty(n_queries, n_sets, n_q, device=DEVICE)
    b2_ = torch.empty(n_queries, n_sets, cap, device=DEVICE)

    def kernel2_per_query():
        a2_.fill_(torch.inf)
        b2_.fill_(torch.inf)
        for i in range(n_queries):
            KB.batched_minscan(qp[i].expand(n_sets, n_q, d), q2[i].expand(n_sets, n_q), sp, b2, a2_[i], b2_[i],
                               lb=None if gl is None else gl[i].contiguous(),
                               cut=None if gc is None else gc[i].contiguous())

    with uncounted():
        ms = cuda_ms(kernel3)
        ms2 = cuda_ms(kernel2_per_query)
    assert torch.equal(min_a, a2_) and torch.equal(min_b, b2_), (label, "kernel 3 vs kernel 2 per query")
    del a2_, b2_
    m = plain_queries
    plain = {}

    def plain_scan():
        plain["mins"] = KB.multiquery_min_sqdists_mirror(
            qs[:m], slab, valid_qs=None if valid_qs is None else valid_qs[:m], valid_slab=valid_slab,
            lb=None if lb is None else lb[:m], cut=None if cut is None else cut[:m])

    plain_ms = cuda_ms(plain_scan, reps=3)
    pa, pb = plain.pop("mins")
    scale = max(float(torch.linalg.vector_norm(qp, dim=-1).max()), float(torch.linalg.vector_norm(sp, dim=-1).max()))
    tol = sqdist_tolerance(d, scale)
    err = max(finite_err(min_a[:m], pa), finite_err(min_b[:m], pb))
    assert err <= tol, (label, err, tol)
    del pa, pb

    def library():
        for i in range(n_queries):
            dist = torch.cdist(qp[i].expand(n_sets, n_q, d), sp)
            dist.amin(dim=2), dist.amin(dim=1)

    library_ms = cuda_ms(library, reps=3)
    torch.cuda.empty_cache()
    bound_ms, bound_by, flops = multiquery_bound(env["fp32_peak_tflops"] * 1e12, qs, slab, valid_qs, valid_slab,
                                                 lb, cut)
    return {"label": label, "shape": [n_queries, n_q, n_sets, cap, d],
            "computed_pairs": n_queries * n_sets if lb is None else int((lb <= cut).sum()),
            "ms": ms, "kernel2_x_q_ms": ms2, "plain_ms": plain_ms, "plain_queries": m,
            "library_ms": library_ms, "library": f"{n_queries} x torch.cdist + amin (distances, not d²; yardstick)",
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err, "tol": tol,
            "achieved_tflops": flops / (ms * 1e-3) / 1e12}


def phase_times_multiquery(corpus: dict, batch: dict, env: dict) -> list[dict]:
    """Kernel 3 timed at Q = 16 on the full cap-256 bucket (ungated) and on
    the largest stage-2a pass of phase 10's search_batch, as it ran."""
    import torch

    store = corpus["store"]
    bucket = store.packed_buckets()[256]
    qs = torch.stack([torch.from_numpy(q).to(DEVICE) for q in batch["queries"]])
    rows = [time_multiquery(f"Q {N_REQUESTS}, full cap-256 bucket, ungated", qs, bucket.points, None,
                            bucket.valid, None, None, env, plain_queries=2)]
    k = batch["keep"]
    if k:
        rows.append(time_multiquery(
            f"search_batch's largest stage-2a pass (Q {k['qs'].shape[0]}, cap {k['slab'].shape[1]}, "
            f"batch {k['slab'].shape[0]})", k["qs"], k["slab"], k.get("valid_qs"), k.get("valid_slab"),
            k.get("lb"), k.get("cut"), env, plain_queries=k["qs"].shape[0]))
    torch.cuda.empty_cache()
    emit({"phase": "times_multiquery", "rows": rows})
    return rows


def timed_calls(call, reps: int = 3):
    """One warm-up call of a set_distance front door (measure=True), then
    ``reps`` timed ones: (the warm-up's result, the median of the timed
    calls' device-synchronised wall times, their spread and values)."""
    res = call()
    runs, values = [], []
    for _ in range(reps):
        r = call()
        runs.append(r.meta.elapsed_s)
        values.append(float(r.value))
    return res, {"elapsed_s": statistics.median(runs), "elapsed_runs_s": runs,
                 "spread_s": max(runs) - min(runs), "warmup_s": res.meta.elapsed_s,
                 "repeat_values": values}


def phase_exact(seed: int):
    from repro_torch.core import exact
    from repro_torch.core.fp_margin import fp_value_margin, sqdist_tolerance
    from repro_torch.data.pointclouds import make_generator, random_clouds
    from repro_torch.hd import set_distance
    from repro_torch.kernels.hausdorff import hausdorff as K
    from repro_torch.kernels.hausdorff import ops

    a, b = random_clouds(make_generator(seed + 1, DEVICE), N_EXACT, N_EXACT, D)
    scale = scale_of(a, b)
    before = K.fused_minscan.launches
    res, times = timed_calls(lambda: set_distance(a, b, measure=True))
    launches = K.fused_minscan.launches - before
    assert res.meta.backend == "fused_cuda", res.meta
    assert launches > 0
    assert all(v == float(res.value) for v in times["repeat_values"]), times  # the kernel is deterministic
    tiled = set_distance(a, b, backend="tiled", measure=True)
    h, ht = float(res.value), float(tiled.value)
    margin = float(fp_value_margin(D, scale, h))
    assert abs(h - ht) <= margin, (h, ht, margin)
    # The kernel's min-d² vectors at this shape, entry by entry.
    tol = sqdist_tolerance(D, scale)
    with uncounted():
        ka, kb = ops.fused_min_sqdists(a, b)
    pa, pb = exact.fused_min_sqdists_tiled(a, b)
    err = max(entry_err(ka, pa), entry_err(kb, pb))
    assert err <= tol, (err, tol)
    del ka, kb, pa, pb
    emit({"phase": "exact", "n": N_EXACT, "d": D, "value": h, "tiled_value": ht,
          "margin": margin, "max_abs_err": err, "tol": tol, "launches": launches,
          **times, "tiled_elapsed_s": tiled.meta.elapsed_s})
    return a, b, h, scale, err


def phase_prohd(seed: int, a_exact, b_exact, h_exact: float, scale_exact: float):
    import torch

    from repro_torch.core.fp_margin import fp_value_margin
    from repro_torch.data.pointclouds import gaussian_mixture_pca, make_generator, random_clouds
    from repro_torch.hd import HDConfig, set_distance
    from repro_torch.kernels.hausdorff import hausdorff as K

    cfg = HDConfig(alpha=0.01, inner="full")
    from repro_torch.core.projections import default_num_directions

    out = {"phase": "prohd", "n": N_PROHD, "d": D, "alpha": 0.01,
           "m": default_num_directions(D), "inner": "full",
           "exact_at_full_size": "not run (cut for time)", "runs": []}
    for name, make in (("random_clouds", random_clouds), ("gaussian_mixture", gaussian_mixture_pca)):
        a, b = make(make_generator(seed + 2, DEVICE), N_PROHD, N_PROHD, D)
        scale = scale_of(a, b)
        before = K.fused_minscan.launches
        res, times = timed_calls(lambda: set_distance(a, b, method="prohd", config=cfg, measure=True))
        launches = K.fused_minscan.launches - before
        assert res.meta.backend == "fused_cuda", res.meta
        assert launches > 0
        v, up = float(res.value), float(res.upper)
        margin = float(fp_value_margin(D, scale, v))
        assert v <= up + margin, (name, v, up)
        # The same selection on the plain scan: the sweeps agree.
        tiled = set_distance(a, b, method="prohd", config=cfg, backend="tiled", measure=True)
        vt = float(tiled.value)
        assert abs(v - vt) <= margin, (name, v, vt, margin)
        assert abs(float(res.lower) - float(tiled.lower)) <= margin, (name, res.lower, tiled.lower)
        assert abs(up - float(tiled.upper)) <= margin, (name, up, tiled.upper)
        out["runs"].append({"data": name, "value": v, "tiled_value": vt, "margin": margin,
                            "lower": float(res.lower), "upper": up,
                            "n_sel_a": int(res.stats["n_sel_a"]), "n_sel_b": int(res.stats["n_sel_b"]),
                            "launches": launches, **times,
                            "tiled_elapsed_s": tiled.meta.elapsed_s})
        del a, b
        torch.cuda.empty_cache()

    # Certificate against the exact value of phase 4.
    res = set_distance(a_exact, b_exact, method="prohd", config=cfg, measure=True)
    assert res.meta.backend == "fused_cuda"
    v, lo, up = float(res.value), float(res.lower), float(res.upper)
    m = float(fp_value_margin(D, scale_exact, h_exact))
    assert v <= h_exact + m and lo <= h_exact + m and h_exact <= up + m, (v, lo, up, h_exact, m)
    vt = float(set_distance(a_exact, b_exact, method="prohd", config=cfg, backend="tiled").value)
    assert abs(v - vt) <= m, (v, vt, m)
    out["certificate"] = {"n": N_EXACT, "exact": h_exact, "value": v, "tiled_value": vt,
                          "lower": lo, "upper": up, "margin": m, "rel_err": (h_exact - v) / h_exact,
                          "elapsed_s": res.meta.elapsed_s}
    emit(out)
    return out


def phase_variants(seed: int):
    from repro_torch.core.fp_margin import fp_value_margin
    from repro_torch.data.pointclouds import make_generator, random_clouds
    from repro_torch.hd import HDConfig, set_distance

    a, b = random_clouds(make_generator(seed + 3, DEVICE), N_VARIANT, N_VARIANT, D)
    scale = scale_of(a, b)
    cfg = HDConfig(quantile=0.95)
    rows = []
    for variant in ("directed", "partial", "chamfer"):
        res = set_distance(a, b, variant=variant, config=cfg, measure=True)
        ref = set_distance(a, b, variant=variant, config=cfg, backend="tiled")
        assert res.meta.backend == "fused_cuda", res.meta
        v, r = float(res.value), float(ref.value)
        # chamfer sums two means of distances: twice one distance's margin.
        margin = float(fp_value_margin(D, scale, v)) * (2 if variant == "chamfer" else 1)
        assert abs(v - r) <= margin, (variant, v, r, margin)
        rows.append({"variant": variant, "value": v, "tiled_value": r, "margin": margin,
                     "elapsed_s": res.meta.elapsed_s})
    emit({"phase": "variants", "n": N_VARIANT, "d": D, "runs": rows})


def launched(call):
    """``call()`` and the kernel-1 launches it made (which must be some)."""
    from repro_torch.kernels.hausdorff import hausdorff as K

    before = K.fused_minscan.launches
    out = call()
    n = K.fused_minscan.launches - before
    assert n > 0, "the call did not launch kernel 1"
    return out, n


def phase_methods(seed: int, a, b, h_exact: float, scale: float, prohd_out: dict) -> dict:
    """set_distance's randomised cells on the card: random and systematic
    sampling, adaptive ProHD, ProHD with rsvd and subspace PCA, each under
    ``auto`` (fused_cuda, kernel 1).  Values on phase 4's clouds, times on
    phase 5's Random Clouds."""
    import torch

    from repro_torch.core import sampling
    from repro_torch.core.fp_margin import fp_value_margin
    from repro_torch.core.prohd import ProHDConfig
    from repro_torch.data.pointclouds import make_generator, random_clouds
    from repro_torch.hd import HDConfig, set_distance

    n = a.shape[0]
    m_exact = float(fp_value_margin(D, scale, h_exact))
    out = {"phase": "methods", "n": n, "d": D, "exact": h_exact, "margin": m_exact, "samplers": {}}
    for sampler in sampling.SAMPLERS:
        cfg = HDConfig(alpha=SAMPLE_ALPHA, sampler=sampler)
        runs = []
        for s in range(SAMPLE_SEEDS):
            gen = make_generator(seed * 100 + 40 + s, DEVICE)
            state = gen.get_state()
            res, launches = launched(lambda: set_distance(a, b, method="sampling", config=cfg, generator=gen,
                                                          measure=True))
            assert res.meta.backend == "fused_cuda", res.meta
            # The same draw, replayed: its subsets' float64 HD.
            replay = torch.Generator(device=DEVICE)
            replay.set_state(state)
            ia, ib = sampling.draw_indices(replay, n, b.shape[0], SAMPLE_ALPHA, sampler)
            assert ia.numel() + ib.numel() == res.stats["n_sampled"], res.stats
            v = float(res.value)
            h_sub = hd64(a[ia].cpu().numpy(), b[ib].cpu().numpy(), False)
            margin = float(fp_value_margin(D, scale, h_sub))
            assert abs(v - h_sub) <= margin, (sampler, s, v, h_sub, margin)
            runs.append({"seed": s, "value": v, "subset_hd64": h_sub, "margin": margin,
                         "n_sampled": res.stats["n_sampled"], "rel_err": abs(v - h_exact) / h_exact,
                         "launches": launches, "elapsed_s": res.meta.elapsed_s})
        out["samplers"][sampler] = {"runs": runs,
                                    "median_rel_err": statistics.median(r["rel_err"] for r in runs)}

    # ProHD's error (phase 5's α = 0.01, gram, same clouds) against each
    # sampler's median: the paper's "5–20× lower error" claim, reported.
    err_prohd = abs(prohd_out["certificate"]["rel_err"])
    out["prohd_rel_err"] = err_prohd
    out["sampler_err_over_prohd_err"] = {
        k: (v["median_rel_err"] / err_prohd if err_prohd > 0 else None) for k, v in out["samplers"].items()}

    def certified(label, res, launches):
        v, lo, up = float(res.value), float(res.lower), float(res.upper)
        assert res.meta.backend == "fused_cuda", (label, res.meta)
        assert v <= h_exact + m_exact and lo <= h_exact + m_exact and h_exact <= up + m_exact, (
            label, v, lo, up, h_exact, m_exact)
        return {"value": v, "lower": lo, "upper": up, "rel_err": (h_exact - v) / h_exact,
                "launches": launches, "elapsed_s": res.meta.elapsed_s}

    acfg = HDConfig(budget=ADAPTIVE_BUDGET, budget_relative=True)
    res, launches = launched(lambda: set_distance(a, b, method="adaptive", config=acfg, measure=True))
    ad = res.stats["adaptive"]
    out["adaptive"] = {**certified("adaptive", res, launches), "budget": ADAPTIVE_BUDGET, "relative": True,
                       "steps": ad.steps, "alpha": ad.alpha, "m": ad.m, "met_budget": ad.met_budget,
                       "certified_gap": ad.certified_gap}
    out["pca"] = {}
    for method in ("rsvd", "subspace"):
        pcfg = HDConfig(prohd=ProHDConfig(alpha=SAMPLE_ALPHA, pca_method=method))
        gen = make_generator(seed * 100 + 50, DEVICE)
        res, launches = launched(lambda: set_distance(a, b, method="prohd", config=pcfg, generator=gen,
                                                      measure=True))
        out["pca"][method] = certified(method, res, launches)

    # Times at 1,048,576² (phase 5's Random Clouds), beside phase 5's gram ProHD.
    a5, b5 = random_clouds(make_generator(seed + 2, DEVICE), N_PROHD, N_PROHD, D)
    gen = make_generator(seed * 100 + 60, DEVICE)
    calls = {f"sampling_{k}": (dict(method="sampling", generator=gen,
                                    config=HDConfig(alpha=SAMPLE_ALPHA, sampler=k)))
             for k in sampling.SAMPLERS}
    for method in ("rsvd", "subspace"):
        calls[f"prohd_{method}"] = dict(method="prohd", generator=gen,
                                        config=HDConfig(prohd=ProHDConfig(alpha=SAMPLE_ALPHA, pca_method=method)))
    times = {"prohd_gram": prohd_out["runs"][0]["elapsed_s"]}
    for label, kw in calls.items():
        (res, t), launches = launched(lambda: timed_calls(lambda: set_distance(a5, b5, measure=True, **kw)))
        assert res.meta.backend == "fused_cuda", (label, res.meta)
        times[label] = {**t, "launches": launches}
    out["times_1m"] = {"n": N_PROHD, **times}
    del a5, b5
    torch.cuda.empty_cache()
    emit(out)
    return out


def phase_drift(seed: int) -> dict:
    """The drift monitor as a vector database runs it: a fixed reference of
    N_DRIFT_REF embeddings, a DRIFT_WINDOW reservoir fed DRIFT_BATCHES
    batches, a shift from batch DRIFT_SHIFT_AT on, check_drift (ProHD on
    kernel 1) after every DRIFT_CHECK_EVERY-th batch."""
    import torch

    from repro_torch.core.fp_margin import fp_value_margin
    from repro_torch.core.prohd import ProHDConfig
    from repro_torch.core.streaming import DriftMonitorConfig, check_drift, init_drift_monitor, observe
    from repro_torch.data.pointclouds import make_generator
    from repro_torch.hd import set_distance

    gen = make_generator(seed + 20, DEVICE)
    reference = torch.randn((N_DRIFT_REF, D), generator=gen, device=DEVICE)
    cfg = DriftMonitorConfig(window=DRIFT_WINDOW, dim=D, threshold=DRIFT_THRESHOLD,
                             prohd=ProHDConfig(alpha=0.05, subset_backend="cuda"))

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    state, init_s = synced(lambda: init_drift_monitor(cfg, reference, make_generator(seed + 21, DEVICE)))
    observe_s, checks = [], []

    def exact_h():
        res, launches = launched(lambda: set_distance(state.reference, state.buffer, measure=True))
        assert res.meta.backend == "fused_cuda", res.meta
        return float(res.value), res.meta.elapsed_s

    h_before = None
    for i in range(DRIFT_BATCHES):
        batch = torch.randn((DRIFT_BATCH, D), generator=gen, device=DEVICE)
        if i >= DRIFT_SHIFT_AT:
            batch += DRIFT_SHIFT
        state, t = synced(lambda: observe(state, batch))
        observe_s.append(t)
        if (i + 1) % DRIFT_CHECK_EVERY:
            continue
        (rep, t), launches = launched(lambda: synced(lambda: check_drift(state, cfg)))
        row = {"after_batch": i + 1, "count": state.count, "shifted": i >= DRIFT_SHIFT_AT,
               "hd": float(rep.hd), "lower": float(rep.lower), "upper": float(rep.upper),
               "alert": bool(rep.alert), "launches": launches, "check_s": t}
        assert row["alert"] == row["shifted"], row  # no alert before the shift, an alert after
        checks.append(row)
        if i + 1 == DRIFT_SHIFT_AT:
            h_before, row["exact_s"] = exact_h()
            row["exact"] = h_before
    h_after, exact_s = exact_h()
    scale = scale_of(state.reference, state.buffer)
    last = checks[-1]
    margin = float(fp_value_margin(D, scale, h_after))
    assert last["lower"] <= h_after + margin and h_after <= last["upper"] + margin, (last, h_after, margin)
    # The threshold lies between the exact H before the shift and after it.
    assert h_before < DRIFT_THRESHOLD < h_after, (h_before, DRIFT_THRESHOLD, h_after)
    out = {"phase": "drift", "n_ref": N_DRIFT_REF, "d": D, "window": DRIFT_WINDOW, "batch": DRIFT_BATCH,
           "batches": DRIFT_BATCHES, "shift_at": DRIFT_SHIFT_AT, "shift": DRIFT_SHIFT,
           "threshold": DRIFT_THRESHOLD, "alpha": cfg.prohd.alpha, "exact_before": h_before,
           "exact_after": h_after, "exact_after_s": exact_s, "margin": margin, "checks": checks,
           "init_s": init_s, "observe_median_s": statistics.median(observe_s),
           "check_median_s": statistics.median(r["check_s"] for r in checks)}
    del state, reference
    torch.cuda.empty_cache()
    emit(out)
    return out


def h64_cuda(a, b) -> float:
    """float64 H(A, B) on the card: the GEMM form of d² in float64, over
    row chunks of at most 4 GiB of d²."""
    import torch

    a64, b64 = a.double(), b.double()
    b2 = (b64 * b64).sum(dim=1)
    row_max = torch.full((), -torch.inf, dtype=torch.float64, device=a.device)
    col_min = torch.full((b.shape[0],), torch.inf, dtype=torch.float64, device=a.device)
    chunk = max(1, (4 << 30) // (8 * b.shape[0]))
    for i in range(0, a.shape[0], chunk):
        x = a64[i:i + chunk]
        d2 = x @ b64.T
        d2.mul_(-2.0).add_(b2[None, :]).add_((x * x).sum(dim=1)[:, None]).clamp_(min=0.0)
        row_max = torch.maximum(row_max, d2.amin(dim=1).max())
        col_min = torch.minimum(col_min, d2.amin(dim=0))
        del d2
    return float(torch.sqrt(torch.maximum(row_max, col_min.max())))


def phase_distributed(seed: int, a, b, h_exact: float) -> dict:
    """The distributed backend through the front door, SPMD on a one-rank
    NCCL group over a DeviceMesh: distributed ProHD on phase 5's Random
    Clouds against single-device ProHD (fused_cuda) on the same clouds, and
    the exact ring on phase 4's clouds against their float64 H, unpadded
    and with N_RING_PAD NaN rows padded into each cloud and masked out."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.fp_margin import fp_value_margin
    from repro_torch.data.pointclouds import make_generator, random_clouds
    from repro_torch.hd import HDConfig, set_distance

    backend = "nccl" if DEVICE == "cuda" else "gloo"
    out = {"phase": "distributed", "process_group": backend, "ranks": 1}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, store=dist.FileStore(f"{tmp}/store", 1), rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=600),
                                device_id=torch.device(DEVICE, 0) if DEVICE == "cuda" else None)
        try:
            mesh = init_device_mesh(DEVICE, (1,), mesh_dim_names=("data",))

            def on_mesh(x, y, **kw):
                return set_distance(x, y, backend="distributed", mesh=mesh, measure=True, **kw)

            # ProHD at phase 5's 1M² Random Clouds, against fused_cuda ProHD.
            cfg = HDConfig(alpha=0.01, inner="full")
            a5, b5 = random_clouds(make_generator(seed + 2, DEVICE), N_PROHD, N_PROHD, D)
            scale5 = scale_of(a5, b5)
            with uncounted():
                single = set_distance(a5, b5, method="prohd", config=cfg, measure=True)
            assert single.meta.backend == "fused_cuda", single.meta
            res, times = timed_calls(lambda: on_mesh(a5, b5, method="prohd", config=cfg))
            assert res.meta.backend == "distributed", res.meta
            assert res.lower is None and res.upper is None  # no certificate on this path
            v, vs = float(res.value), float(single.value)
            margin = float(fp_value_margin(D, scale5, vs))
            assert abs(v - vs) <= margin, (v, vs, margin)
            n_sel = (int(res.stats["n_sel_a"]), int(res.stats["n_sel_b"]))
            n_sel_single = (int(single.stats["n_sel_a"]), int(single.stats["n_sel_b"]))
            assert n_sel == n_sel_single, (n_sel, n_sel_single)
            assert all(x == v for x in times["repeat_values"]), times
            out["prohd"] = {"n": N_PROHD, "d": D, "alpha": 0.01, "value": v, "single_device_value": vs,
                            "equal_bitwise": v == vs, "margin": margin, "n_sel": n_sel, **times,
                            "single_device_elapsed_s": single.meta.elapsed_s}
            del a5, b5
            torch.cuda.empty_cache()

            # The exact ring on phase 4's clouds, against their float64 H.
            t0 = time.perf_counter()
            h64 = h64_cuda(a, b)
            h64_s = time.perf_counter() - t0
            margin = float(fp_value_margin(D, scale_of(a, b), h64))
            res, times = timed_calls(lambda: on_mesh(a, b))
            h = float(res.value)
            assert res.meta.backend == "distributed", res.meta
            assert abs(h - h64) <= margin, (h, h64, margin)
            assert all(x == h for x in times["repeat_values"]), times
            pad = torch.full((N_RING_PAD, D), torch.nan, device=a.device)
            valid = torch.arange(a.shape[0] + N_RING_PAD, device=a.device) < a.shape[0]
            padded = on_mesh(torch.cat([a, pad]), torch.cat([b, pad]), masks=(valid, valid))
            hp = float(padded.value)
            assert hp == h, (hp, h)  # padding rows masked out change no bit
            out["ring"] = {"n": a.shape[0], "d": D, "value": h, "float64": h64, "margin": margin,
                           "fused_cuda_value": h_exact, "equals_fused_cuda_bitwise": h == h_exact,
                           **times, "padded_rows": N_RING_PAD, "padded_value": hp,
                           "padded_elapsed_s": padded.meta.elapsed_s, "float64_s": h64_s}
        finally:
            dist.destroy_process_group()
    out["gloo_prohd"] = gloo_prohd(seed, a, b)
    emit(out)
    return out


def gloo_prohd(seed: int, a, b) -> dict:
    """ProHD on phase 4's clouds across GLOO_RANKS ranks of one gloo group
    on the one card: as many processes of this script (``--gloo-rank``),
    each with its block of rows, against single-device ProHD (fused_cuda)
    on the whole clouds: the same value on every rank, within
    fp_value_margin of it, equal selection counts.  Gloo carries CUDA
    tensors through all_reduce, all_gather and broadcast (ProHD's
    collectives) but not point to point, so the exact ring has no
    multi-rank run on one card.  The ranks' launches are their own
    processes' and are not counted here."""
    import tempfile

    from repro_torch.core.fp_margin import fp_value_margin
    from repro_torch.hd import HDConfig, set_distance

    with uncounted():
        single = set_distance(a, b, method="prohd", config=HDConfig(alpha=0.01, inner="full"))
    assert single.meta.backend == "fused_cuda", single.meta
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--seed", str(seed), "--gloo-root", tmp, "--gloo-rank"]
        procs = [subprocess.Popen(cmd + [str(r)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(GLOO_RANKS)]
        deadline = time.monotonic() + 600
        try:
            outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    ranks = []
    for r, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, p.returncode, stderr[-3000:])
        ranks.append(json.loads(stdout.strip().splitlines()[-1]))
    checksum = float(a.double().sum() + b.double().sum())
    vs = float(single.value)
    n_sel = [int(single.stats["n_sel_a"]), int(single.stats["n_sel_b"])]
    margin = float(fp_value_margin(D, scale_of(a, b), vs))
    for r in ranks:
        assert r["checksum"] == checksum, (r["rank"], r["checksum"], checksum)  # phase 4's clouds
        assert r["value"] == ranks[0]["value"] and all(x == r["value"] for x in r["repeat_values"]), ranks
        assert abs(r["value"] - vs) <= margin, (r["value"], vs, margin)
        assert r["n_sel"] == n_sel, (r["n_sel"], n_sel)
    return {"process_group": "gloo", "ranks": GLOO_RANKS, "n": a.shape[0], "d": D, "alpha": 0.01,
            "value": ranks[0]["value"], "single_device_value": vs, "equal_bitwise": ranks[0]["value"] == vs,
            "margin": margin, "n_sel": n_sel, "by_rank": ranks}


def gloo_prohd_rank(seed: int, rank: int, root: str) -> dict:
    """One rank of :func:`gloo_prohd`: phase 4's clouds made again from the
    seed, this rank's block of rows, distributed ProHD through the front
    door (median of 3 after a warm-up)."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data.pointclouds import make_generator, random_clouds
    from repro_torch.hd import HDConfig, set_distance

    dist.init_process_group("gloo", store=dist.FileStore(f"{root}/store", GLOO_RANKS), rank=rank,
                            world_size=GLOO_RANKS, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = init_device_mesh(DEVICE, (GLOO_RANKS,), mesh_dim_names=("data",))
        a, b = random_clouds(make_generator(seed + 1, DEVICE), N_EXACT, N_EXACT, D)
        rows = slice(rank * N_EXACT // GLOO_RANKS, (rank + 1) * N_EXACT // GLOO_RANKS)
        cfg = HDConfig(alpha=0.01, inner="full")
        res, times = timed_calls(lambda: set_distance(a[rows], b[rows], method="prohd", backend="distributed",
                                                      mesh=mesh, config=cfg, measure=True))
        assert res.meta.backend == "distributed", res.meta
        return {"rank": rank, "value": float(res.value), "n_sel": [int(res.stats["n_sel_a"]),
                                                                   int(res.stats["n_sel_b"])],
                "checksum": float(a.double().sum() + b.double().sum()), **times}
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def stage1_scan_launches():
    """Inside the block, count kernel 2's launches made by stage-1 calls of
    its wrapper (the per-lane operand forms of ``SCAN_FORMS``) into the
    yielded dict's ``"stage1"``; every call still goes to the wrapper."""
    from repro_torch.kernels.hausdorff import batched as KB

    wrapper, seen = KB.batched_min_sqdists, {"stage1": 0}

    def noting(q, slab, **kw):
        before = KB.batched_minscan.launches
        out = wrapper(q, slab, **kw)
        if SCAN_FORMS[(q.ndim, slab.ndim)].startswith("stage 1"):
            seen["stage1"] += KB.batched_minscan.launches - before
        return out

    KB.batched_min_sqdists = noting
    try:
        yield seen
    finally:
        KB.batched_min_sqdists = wrapper


def phase_sharded(corpus: dict, batch: dict) -> dict:
    """search(shards=1) on phase 8's store and search_batch(shards=1) on
    phase 10's requests: ids, values and every stat but ``shards`` equal to
    the unsharded calls, ids and values to brute force; then one more
    unsharded and one more sharded call of each, for times.  The unsharded
    calls run uncounted, so the path's launches are the sharded calls'
    alone: kernels 1 and 2 from search (kernel 2 from its sharded stage 1
    among them) and kernel 3 from search_batch."""
    import numpy as np

    from repro_torch.hd import search, search_batch
    from repro_torch.obs import trace

    big = corpus["big"]
    store, q, one, bf = big["store"], big["q"], big["res"], big["bf"]

    def same_stats(sharded, plain, label):
        stats = dict(sharded.stats)
        assert stats.pop("shards") == 1, (label, sharded.stats)
        assert stats == plain.stats, (label, stats, plain.stats)

    start = counts()
    with stage1_scan_launches() as seen:
        with trace.capture() as events:
            res = search(q, store, K_TOP, shards=1, on_fault="raise", measure=True)
            spans = {e["name"]: e for e in events() if e["type"] == "span"}
        check_search(res, bf, store, "search shards=1 vs brute force")
        check_search(res, one, store, "search shards=1 vs unsharded")
        same_stats(res, one, "search shards=1")
        assert spans["cascade.shard_merge"]["attrs"]["shards"] == 1, spans.keys()
        assert spans["cascade.stage0"]["attrs"]["shards"] == 1
        with uncounted():
            again = search(q, store, K_TOP, on_fault="raise", measure=True)
        res2 = search(q, store, K_TOP, shards=1, on_fault="raise", measure=True)
    for r in (again, res2):
        check_search(r, bf, store, "search, timing run")
    search_launches = {k: v - start[k] for k, v in counts().items()}
    assert search_launches["fused_minscan"] > 0 and seen["stage1"] > 0, (search_launches, seen)
    assert search_launches["batched_minscan"] >= seen["stage1"], (search_launches, seen)
    unsharded_s = [corpus["runs"]["corpus"]["cascade_s"], corpus["runs"]["corpus"]["cascade_warm_s"],
                   again.meta.elapsed_s]
    out = {"phase": "sharded", "shards": 1, "search": {
        "n_sets": store.n_sets, "k": K_TOP, "ids": res.ids.tolist(),
        "sharded_s": [res.meta.elapsed_s, res2.meta.elapsed_s], "unsharded_s": unsharded_s,
        "stage_s": {k: spans[f"cascade.{k}"]["dur_s"] for k in ("stage0", "stage1", "shard_merge", "stage2a",
                                                                  "stage2b") if f"cascade.{k}" in spans},
        "merge_pruned": spans["cascade.shard_merge"]["attrs"]["pruned"],
        "launches": search_launches, "stage1_kernel2_launches": seen["stage1"]}}

    queries, ks, owners, bfs = batch["queries"], batch["ks"], batch["owners"], batch["bfs"]
    plain = batch["results"]
    runs = []
    start = counts()
    for label, shards in (("sharded", 1), ("unsharded", None), ("sharded", 1)):
        with uncounted() if shards is None else contextlib.nullcontext():
            rs = search_batch(queries, store, ks, shards=shards, on_fault="raise", measure=True)
        check_batch(rs, ks, owners, bfs, f"search_batch shards={shards}")
        for r, p in zip(rs, plain):
            assert np.array_equal(r.ids, p.ids) and np.array_equal(r.values, p.values), label
            if shards:
                same_stats(r, p, "search_batch shards=1")
        runs.append((label, rs[0].meta.elapsed_s))
    batch_launches = {k: v - start[k] for k, v in counts().items()}
    assert batch_launches["multiquery_minscan"] > 0, batch_launches
    out["search_batch"] = {
        "requests": len(queries),
        "sharded_s": [t for lbl, t in runs if lbl == "sharded"],
        "unsharded_s": [plain[0].meta.elapsed_s] + [t for lbl, t in runs if lbl == "unsharded"],
        "launches": batch_launches}
    emit(out)
    return out


def scan_bound(peak: float, n_a: int, n_b: int, directed: bool) -> tuple[float, str]:
    """Kernel 1's least time (ms) on these shapes: 2·n_a·n_b·D FLOPs at the
    FFMA peak, against a, b, a2, b2 read once and min_a (and min_b) written
    once at the HBM rate."""
    flops = 2.0 * n_a * n_b * D
    nbytes = 4.0 * ((n_a + n_b) * D + 2 * n_a + (1 if directed else 2) * n_b)
    op_ms = flops / peak * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes"


def phase_times(seed: int, env: dict) -> list[dict]:
    """Kernel 1 timed at 65,536² (bidirectional: exact and the variants) and
    at ProHD's sweep shape, 41,930 × 1,048,576, in both instances (the
    sweeps run the directed one), beside its plain version and cdist + amin."""
    import torch

    from repro_torch.core import exact
    from repro_torch.core.fp_margin import sqdist_tolerance
    from repro_torch.data.pointclouds import make_generator, random_clouds
    from repro_torch.kernels.hausdorff import hausdorff as K
    from repro_torch.kernels.hausdorff import ops

    peak = env["fp32_peak_tflops"] * 1e12
    gen = make_generator(seed + 4, DEVICE)
    shapes = [("exact/variants", N_VARIANT, N_VARIANT), ("prohd_sweep", SWEEP_QUERIES, N_PROHD)]
    rows = []
    for label, n_a, n_b in shapes:
        a, b = random_clouds(gen, n_a, n_b, D)
        a2 = (a * a).sum(1)
        b2 = (b * b).sum(1)
        min_a = torch.empty(n_a, device=DEVICE)
        min_b = torch.empty(n_b, device=DEVICE)
        plan = K.launch_plan(n_a, n_b, D, env["sms"])

        def kernel(directed=False):
            min_a.fill_(torch.inf)
            min_b.fill_(torch.inf)
            K.fused_minscan(a, b, a2, b2, min_a, min_b, directed=directed)

        ms = cuda_ms(kernel)
        plain = {}

        def plain_scan():
            plain["mins"] = exact.fused_min_sqdists_tiled(a, b)

        plain_ms = cuda_ms(plain_scan)
        # The timed kernel's outputs, entry by entry.
        tol = sqdist_tolerance(D, scale_of(a, b))
        err = max(entry_err(min_a, plain["mins"][0]), entry_err(min_b, plain["mins"][1]))
        assert err <= tol, (label, err, tol)
        instances = [(label, False, ms, err)]
        if label == "prohd_sweep":
            # The directed instance, as ProHD's sweeps launch it, held to the
            # same plain version's row mins.
            directed_ms = cuda_ms(lambda: kernel(directed=True))
            assert torch.isinf(min_b).all(), "the directed instance wrote min_b"
            derr = entry_err(min_a, plain["mins"][0])
            assert derr <= tol, (label, "directed", derr, tol)
            instances.append(("prohd_sweep_directed", True, directed_ms, derr))
            # ProHD's sweep as the main path makes it: the selected rows
            # padded to a static capacity (masked), directed, through ops.
            va = torch.rand(n_a, generator=gen, device=DEVICE) < 0.95
            km = ops.min_sqdists(a, b, valid_a=va)
            pm, _ = exact.fused_min_sqdists_tiled(a, b, valid_a=va)
            merr = entry_err(km, pm, va)
            assert merr <= tol, (label, "masked directed", merr, tol)
            del km, pm
        del plain["mins"]
        library = {}
        if label == "exact/variants":
            # The kernel's function: the distance matrix (17.2 GB fp32) and
            # its row and column mins.
            def lib_both():
                dist = torch.cdist(a, b)
                return dist.amin(1), dist.amin(0)

            library[False] = cuda_ms(lib_both)
        else:
            # One cdist over all of b would write 176 GB: columns in chunks,
            # each folded into the row mins (and its own column mins by amin).
            def lib_chunks(directed):
                row = torch.full((n_a,), torch.inf, device=DEVICE)
                cols = []
                for j in range(0, n_b, CDIST_CHUNK):
                    dist = torch.cdist(a, b[j:j + CDIST_CHUNK])
                    row = torch.minimum(row, dist.amin(1))
                    if not directed:
                        cols.append(dist.amin(0))
                    del dist
                return row, cols

            library[False] = cuda_ms(lambda: lib_chunks(False), reps=3)
            library[True] = cuda_ms(lambda: lib_chunks(True), reps=3)
        torch.cuda.empty_cache()
        for name, directed, t, e in instances:
            bound_ms, bound_by = scan_bound(peak, n_a, n_b, directed)
            rows.append({"shape": [n_a, n_b, D], "label": name, "directed": directed,
                         "plan": plan._asdict(), "ms": t, "plain_ms": plain_ms,
                         "max_abs_err": e, "tol": tol, "library_ms": library[directed],
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "share_of_bound": bound_ms / t,
                         "achieved_tflops": 2.0 * n_a * n_b * D / (t * 1e-3) / 1e12})
        del a, b, a2, b2, min_a, min_b
        torch.cuda.empty_cache()
    emit({"phase": "times", "rows": rows})
    return rows


@contextlib.contextmanager
def directed_flags(flags: list):
    """Inside the block, every kernel-1 launch appends its ``directed`` flag."""
    from repro_torch.kernels.hausdorff import hausdorff as K

    launch = K.fused_minscan

    def spy(*args, **kw):
        flags.append(kw.get("directed", False))
        launch(*args, **kw)  # the launcher counts on its module's name: the spy

    spy.launches = launch.launches
    K.fused_minscan = spy
    try:
        yield
    finally:
        K.fused_minscan = launch
        launch.launches = spy.launches


def phase_baselines(seed: int, env: dict) -> dict:
    """The paper's exact baselines: the two-sweep HD (two directed kernel-1
    launches) against the fused bidirectional call at 65,536² × 256, and the
    EBHD early break on Random Clouds at N_EARLYBREAK² × 256 on the CPU and
    on the card, each against the float64 H."""
    import torch

    from repro_torch.core import exact
    from repro_torch.core.fp_margin import fp_value_margin
    from repro_torch.data.pointclouds import make_generator, random_clouds
    from repro_torch.kernels.hausdorff import hausdorff as K
    from repro_torch.kernels.hausdorff import ops

    a, b = random_clouds(make_generator(seed + 7, DEVICE), N_VARIANT, N_VARIANT, D)
    scale = scale_of(a, b)
    flags = []
    zero_counts()
    with directed_flags(flags):
        two = float(ops.hausdorff_twosweep_tiled(a, b))
    torch.cuda.synchronize()
    launches = counts()
    assert launches == {**dict.fromkeys(launches, 0), "fused_minscan": 2}, launches
    assert flags == [True, True], flags  # kernel 1's directed instance, once per sweep
    with uncounted():
        fused = float(ops.hausdorff(a, b))
        h64 = h64_cuda(a, b)
        margin = float(fp_value_margin(D, scale, h64))
        assert abs(two - fused) <= margin and abs(two - h64) <= margin, (two, fused, h64, margin)
        twosweep_ms = cuda_ms(lambda: ops.hausdorff_twosweep_tiled(a, b))
        fused_ms = cuda_ms(lambda: ops.hausdorff(a, b))
    sweeps = {"shape": [N_VARIANT, N_VARIANT, D], "twosweep": two, "fused": fused, "float64": h64,
              "margin": margin, "launches": launches["fused_minscan"], "directed": flags,
              "twosweep_ms": twosweep_ms, "fused_ms": fused_ms, "ratio": twosweep_ms / fused_ms,
              "bound_ms_each_sweep": scan_bound(env["fp32_peak_tflops"] * 1e12, N_VARIANT, N_VARIANT, True)[0]}
    del a, b
    torch.cuda.empty_cache()

    a, b = random_clouds(make_generator(seed + 8, DEVICE), N_EARLYBREAK, N_EARLYBREAK, D)
    scale = scale_of(a, b)
    h64 = h64_cuda(a, b)
    margin = float(fp_value_margin(D, scale, h64))
    early = {"shape": [N_EARLYBREAK, N_EARLYBREAK, D], "float64": h64, "margin": margin}
    with uncounted():
        for where, x, y in (("cuda", a, b), ("cpu", a.cpu(), b.cpu())):
            before = sum(counts().values())
            t0 = time.perf_counter()
            val = float(exact.hausdorff_earlybreak(x, y))
            if where == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            assert sum(counts().values()) == before  # plain tensor code, no kernel of the port
            assert abs(val - h64) <= margin, (where, val, h64, margin)
            early[where] = {"value": val, "wall_s": dt}
        t0 = time.perf_counter()
        exact_val = float(ops.hausdorff(a, b))
        torch.cuda.synchronize()
        early["fused_kernel_wall_s"] = time.perf_counter() - t0
        early["fused_kernel_value"] = exact_val
    del a, b
    torch.cuda.empty_cache()
    out = {"twosweep": sweeps, "earlybreak": early}
    emit({"phase": "baselines", **out})
    return out


def phase_obs(seed: int, corpus: dict) -> dict:
    """The rest of obs on the card: a JSONL capture around one search on
    phase 8's store, validated and rendered with the port's export and
    report; then one torch.profiler run, with the profiler bridge on, of a
    search on a store of N_OBS_SETS sets (stage 1's batched eigh launches
    hundreds of kernels a candidate; at 512 sets stage 0 leaves ~70, and
    the trace of 2,048 sets took minutes to read), whose cascade.stage0/1/2a/2b ranges must enclose every
    kernel-2 and kernel-1 launch of the search.  A launch is the host-side
    launch call that the trace pairs with the kernel by CUPTI's correlation
    id; the port's kernels, built with the static CUDA runtime, are not
    linked to the annotation by the profiler's own tree."""
    import tempfile

    import torch
    from torch.autograd import DeviceType

    from repro_torch import obs
    from repro_torch.hd import search

    store, q = corpus["store"], corpus["q"]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "search.jsonl"
        with obs.capture(jsonl=str(path)):
            res = search(q, store, K_TOP, on_fault="raise")
        events = obs.read_jsonl(path)
    summary = obs.validate_events(events)
    assert summary["spans"] > 0 and len(summary["rids"]) == 1 and summary["errors"] == 0, summary
    assert res.ids.tolist() == corpus["runs"]["corpus"]["ids"]
    table = obs.report.stage_table(events)
    print(table, flush=True)

    _, small, q_small, _, _ = corpus_store(seed + 2, N_OBS_SETS)
    search(q_small, small, K_TOP, on_fault="raise")  # warm: first calls of the small store's shapes
    stages = ("cascade.stage0", "cascade.stage1", "cascade.stage2a", "cascade.stage2b")
    kernels = {"bucket_minscan_kernel": "batched_minscan", "fused_minscan_kernel": "fused_minscan"}
    launch_calls = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    zero_counts()
    t0 = time.perf_counter()
    with obs.capture(record_function=True), torch.profiler.profile(activities=acts) as prof:
        search(q_small, small, K_TOP, on_fault="raise")
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    launched = counts()
    ranges, launch_ns, ours = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            which = next((v for k, v in kernels.items() if k in name), None)
            if which is not None:
                ours.append((which, e.correlation_id()))
        elif name in launch_calls:
            launch_ns[e.correlation_id()] = e.start_ns()
        elif name in stages:
            ranges.append((name, e.start_ns(), e.end_ns()))
    enclosed = {s: dict.fromkeys(kernels.values(), 0) for s in (*stages, None)}
    for which, corr in ours:
        t = launch_ns.get(corr)
        stage = next((n for n, lo, hi in ranges if t is not None and lo <= t <= hi), None)
        enclosed[stage][which] += 1
    assert {n for n, _, _ in ranges} == set(stages), ranges
    for which in kernels.values():  # every launch of the search, inside a stage range
        assert sum(1 for w, _ in ours if w == which) == launched[which], (which, len(ours), launched)
        assert enclosed[None][which] == 0, enclosed
    assert enclosed["cascade.stage1"]["batched_minscan"] > 0 and enclosed["cascade.stage2b"]["fused_minscan"] > 0, \
        enclosed
    out = {"jsonl": summary, "stage_table_rows": table.count("\n") - 1, "profiled_sets": N_OBS_SETS,
           "traced_s": traced_s, "profiler_ranges": sorted({n for n, _, _ in ranges}),
           "launches_by_stage": {s: enclosed[s] for s in stages}, "launches": launched}
    emit({"phase": "obs", **out})
    return out


# ---------------------------------------------------------------------------
# kernel 4 and the LM serving path
# ---------------------------------------------------------------------------


def weighted_abs_v(q, k, v, *, causal: bool, q_offset: int = 0, window: int | None = None):
    """Σ_i w_i·|v_i| per output entry: the attention weights of (q, k) applied
    to |v|, in fp32 (float64 for float64) with p left unrounded.  It scales
    the p-rounding term of :func:`flash_error`."""
    import torch

    from repro_torch.kernels.flash_attention import flash as F

    wide = torch.promote_types(q.dtype, torch.float32)
    sk = k.shape[1]
    return F.flash_attention_plain(q.to(wide), k.to(wide), v.to(wide).abs(), causal=causal,
                                   chunk=512 if sk % 512 == 0 else sk, q_offset=q_offset, window=window)


def flash_error(out, want, abs_v, *, exact: bool = False) -> dict:
    """One attention output held entry by entry against another computation
    of it: ``want`` is the plain version's output, or (``exact``) the float64
    oracle's.  ``abs_v`` is :func:`weighted_abs_v` on the same operands.

    Per entry, with w = |want| and a = abs_v:
      fp32:  |Δ| ≤ 2e-5 + 1e-4·w (the reference's own, tests/test_kernels.py:115).
      bf16 against the plain version: add 2⁻⁷·w + 2⁻⁷·a.  Both round their
        fp32 result to bf16, which parts them by at most one bf16 spacing at
        w, ≤ 2⁻⁷·w.  Both round each weight p to bf16 (≤ 2⁻⁸·p each) before
        P·V, but against the running max of their own key tiles (the kernel's
        64, the plain version's chunk), so a weight may round two ways, ≤
        2⁻⁷·p apart; over a row that moves the output by ≤ 2⁻⁷·Σ w_i·|v_i|.
      bf16 against float64: add 2⁻⁸·w + (2⁻⁸ + 2⁻¹⁶)·a.  One output
        rounding (half a spacing, ≤ 2⁻⁸ of the fp32 result, which lies within
        2⁻⁸·a of w) and one rounding of each p, ≤ 2⁻⁸·p.
    Returns the worst |Δ|, the smallest per-entry tolerance, the largest
    |Δ| / tolerance (the check is that this is ≤ 1) and the number of
    entries over their tolerance."""
    import torch

    dt = torch.promote_types(want.dtype, abs_v.dtype)
    want = want.to(dt)
    w, a = want.abs(), abs_v.to(dt)
    diff = (out.to(dt) - want).abs()
    tol = 2e-5 + 1e-4 * w
    if out.dtype == torch.bfloat16:
        tol = tol + (2.0 ** -8 * w + (2.0 ** -8 + 2.0 ** -16) * a if exact
                     else 2.0 ** -7 * w + 2.0 ** -7 * a)
    return {"max_abs_err": float(diff.max()), "tol": float(tol.min()),
            "max_ratio": float((diff / tol).max()), "n_over": int((diff > tol).sum())}


def phase_flash_vs_plain(seed: int) -> float:
    import torch

    from repro_torch.data.pointclouds import make_generator
    from repro_torch.kernels.flash_attention import flash as F
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = make_generator(seed + 13, DEVICE)
    rows, worst = [], 0.0
    for case in FLASH_CASES:
        b, sq, sk, h, kv, hd, dtype_name, causal, q_offset, window = (*case, 0, None)[:10]
        mask = {"q_offset": q_offset, "window": window}
        dtype = getattr(torch, dtype_name)
        q = torch.randn((b, sq, h, hd), generator=gen, device=DEVICE).to(dtype)
        k = torch.randn((b, sk, kv, hd), generator=gen, device=DEVICE).to(dtype)
        v = torch.randn((b, sk, kv, hd), generator=gen, device=DEVICE).to(dtype)
        before = route_counts()
        out = F.flash_attention(q, k, v, causal=causal, **mask)
        torch.cuda.synchronize()
        assert out.shape == q.shape and out.dtype == dtype and bool(torch.isfinite(out).all())
        route = F.route(dtype, hd)
        assert route_counts()[route] == before[route] + 1, (route, before, route_counts())
        row = {"case": list(case), "route": route, "instance_hd": F.instance(route, hd)}
        abs_v = weighted_abs_v(q, k, v, causal=causal, **mask)
        chunks = (64, 512) if sk % 512 == 0 else (sk,)
        for c in chunks:
            e = flash_error(out, F.flash_attention_plain(q, k, v, causal=causal, chunk=c, **mask), abs_v)
            assert e["max_ratio"] <= 1, (row, f"plain chunk {c}", e)
            row[f"plain_chunk{c}"] = e
            worst = max(worst, e["max_abs_err"])
        if window is None:
            want = attention_ref(q.double(), k.double(), v.double(), causal=causal, q_offset=q_offset)
        else:  # the reference's recurrence in float64, one chunk: rows that see no key included
            want = F.flash_attention_plain(q.double(), k.double(), v.double(), causal=causal, chunk=sk, **mask)
        e = flash_error(out, want, abs_v, exact=True)
        assert e["max_ratio"] <= 1, (row, "float64", e)
        row["float64"] = e
        rows.append(row)
        worst = max(worst, e["max_abs_err"])
        del q, k, v, out, want, abs_v
    torch.cuda.empty_cache()
    emit({"phase": "flash_vs_plain", "cases": rows, "max_abs_err": worst})
    return worst


def bf16_logit_tolerance(n_layers: int) -> float:
    """Relative L2 distance of a bf16 forward's logits from exact
    arithmetic: each of its R bf16 roundings moves a value by at most
    u = 2^-8 relative, with independent signs, so the errors add as √R·u.
    R counts 14 per layer (3 in each RMSNorm, q/k/v, RoPE, p, the attention
    output, the o and down products, SwiGLU's h, two residual adds) and 3
    for the final norm.  Two bf16 computations: twice this."""
    return (14 * n_layers + 3) ** 0.5 * 2.0 ** -8


# fp32 logits against the float64 model: the reference's own fp32 relative
# tolerance (tests/test_kernels.py:115), as a relative L2 distance.
FP32_LOGIT_TOL = 1e-4


def rel_l2(a, b) -> float:
    import torch

    return float(torch.linalg.vector_norm(a.double() - b.double()) / torch.linalg.vector_norm(b.double()))


@contextlib.contextmanager
def flash_replaced(fn):
    """Inside the block, ``models.layers`` calls ``fn`` for kernel 4's wrapper."""
    from repro_torch.kernels.flash_attention import flash as F

    wrapper = F.flash_attention
    F.flash_attention = fn
    try:
        yield wrapper
    finally:
        F.flash_attention = wrapper


@contextlib.contextmanager
def flash_held(chunk: int):
    """Inside the block every kernel-4 call runs uncounted and is held entry
    by entry to the plain version (kv chunks of ``chunk``); yields the list
    of the calls' errors."""
    from repro_torch.kernels.flash_attention import flash as F

    held = []

    def checked(q, k, v, causal=True, **mask):
        got = wrapper(q, k, v, causal=causal, **mask)
        e = flash_error(got, F.flash_attention_plain(q, k, v, causal=causal, chunk=chunk, **mask),
                        weighted_abs_v(q, k, v, causal=causal, **mask))
        assert e["max_ratio"] <= 1, ("held prefill call", len(held), e)
        held.append({"q": list(q.shape), "k": list(k.shape), **e})
        return got

    with uncounted(), flash_replaced(checked) as wrapper:
        yield held


def timed_prefill(model, tokens, cfg) -> tuple:
    """(logits, wall seconds, kernel-4 launches) of one counted prefill_step;
    every launch must take the route of the config's dtype and head dim
    (TinyLlama's bf16: the tensor cores; the smoke config's fp32: FFMA)."""
    import torch

    from repro_torch.kernels.flash_attention import flash as F
    from repro_torch.models import transformer as T

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    logits = T.prefill_step(model, tokens, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = counts()
    assert n["flash_fwd"] == cfg.n_layers, n
    route = F.route(cfg.dtype, cfg.head_dim)
    assert route_counts() == {**dict.fromkeys(F.ROUTES, 0), route: cfg.n_layers}, route_counts()
    assert n["fused_minscan"] == n["batched_minscan"] == n["multiquery_minscan"] == 0, n
    assert logits.shape == (tokens.shape[0], cfg.vocab) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    return logits, dt, n["flash_fwd"]


def phase_lm(seed: int) -> dict:
    import dataclasses

    import torch

    from repro_torch.configs.base import load_arch, smoke_lm_config
    from repro_torch.data import synth
    from repro_torch.data.pointclouds import make_generator
    from repro_torch.kernels.flash_attention import flash as F
    from repro_torch.models import transformer as T

    cfg = load_arch(LM_ARCH).config
    gen = make_generator(seed + 14, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = T.init_lm_params(gen, cfg)
    torch.cuda.synchronize()
    out = {"arch": LM_ARCH, "params_billions": cfg.params_billions(), "init_s": time.perf_counter() - t0,
           "launches": 0, "route_launches": {"wgmma": 0, "ffma": 0}}

    # bf16 prefill against the same model in float64, through the plain functions.
    prompt = synth.lm_batch(gen, cfg, 1, F64_PROMPT)["tokens"][:, :F64_PROMPT]
    logits, dt, n = timed_prefill(model, prompt, cfg)
    out["launches"] += n
    out["route_launches"]["wgmma"] += n
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    model64 = T.TransformerLM(cfg64, device=DEVICE)
    model64.load_state_dict(model.state_dict())
    with uncounted(), flash_replaced(
            lambda q, k, v, causal=True, **mask: F.flash_attention_plain(q, k, v, causal=causal,
                                                                          chunk=cfg.attn_chunk, **mask)):
        logits64 = T.prefill_step(model64, prompt, cfg64)
    del model64
    torch.cuda.empty_cache()
    tol = bf16_logit_tolerance(cfg.n_layers)
    err = rel_l2(logits, logits64)
    assert err <= tol, ("bf16 vs float64 prefill", err, tol)
    out["float64"] = {"tokens": F64_PROMPT, "rel_l2": err, "tol": tol, "wall_s": dt,
                      "argmax_equal": bool(torch.equal(logits.argmax(-1), logits64.argmax(-1)))}

    # Counted prefills at the two cut prefill_32k shapes.
    out["prefill"] = []
    for b, s in PREFILL_SHAPES:
        tokens = synth.lm_batch(gen, cfg, b, s)["tokens"][:, :s]
        logits, dt, n = timed_prefill(model, tokens, cfg)
        out["launches"] += n
        out["route_launches"]["wgmma"] += n
        out["prefill"].append({"batch": b, "seq": s, "wall_s": dt, "tokens_per_s": b * s / dt,
                               "launches": n})
        if (b, s) == PREFILL_SHAPES[0]:
            held_tokens, held_logits = tokens, logits
        del tokens, logits
        torch.cuda.empty_cache()

    # The first shape once more, uncounted, every kernel-4 call held to the plain version.
    with flash_held(cfg.attn_chunk) as held:
        again = T.prefill_step(model, held_tokens, cfg)
    assert len(held) == cfg.n_layers, len(held)
    out["held_logits_equal"] = bool(torch.equal(again, held_logits))
    del again, held_tokens, held_logits
    torch.cuda.empty_cache()

    # Decode: a 64-token prompt fed one token at a time, then greedy tokens.
    prompt = synth.lm_batch(gen, cfg, DECODE_BATCH, DECODE_PROMPT)["tokens"][:, :DECODE_PROMPT]
    cache = T.init_kv_cache(cfg, DECODE_BATCH, DECODE_CACHE, device=DEVICE)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(DECODE_PROMPT):
        step_logits, nxt, cache = T.serve_step(model, cache, prompt[:, i], cfg)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    generated = []
    for _ in range(DECODE_NEW):
        generated.append(nxt)
        _, nxt, cache = T.serve_step(model, cache, nxt, cfg)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    assert sum(counts().values()) == 0, counts()  # decode attention is plain
    assert int(cache.length) == DECODE_PROMPT + DECODE_NEW
    tokens = torch.stack(generated, 1)
    assert tokens.shape == (DECODE_BATCH, DECODE_NEW)
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab
    logits = T.prefill_step(model, prompt, cfg)
    out["launches"] += counts()["flash_fwd"]
    for r, n in route_counts().items():
        out["route_launches"][r] += n
    err = rel_l2(step_logits, logits)
    assert err <= 2 * tol, ("decode vs prefill logits", err, 2 * tol)
    out["decode"] = {"batch": DECODE_BATCH, "cache": DECODE_CACHE, "prompt": DECODE_PROMPT,
                     "new_tokens": DECODE_NEW, "prompt_fill_s": fill_s,
                     "ms_per_step": gen_s / DECODE_NEW * 1e3,
                     "tokens_per_s": DECODE_BATCH * DECODE_NEW / gen_s,
                     "vs_prefill_rel_l2": err, "tol": 2 * tol,
                     "argmax_agree": float((step_logits.argmax(-1) == logits.argmax(-1)).float().mean())}
    out["held"] = held_summary("prefill {} x {}".format(*PREFILL_SHAPES[0]), held)
    del cache

    # A sliding window: TinyLlama with LM_WINDOW at 1 × 32,768, every layer's
    # kernel-4 launch skipping the key tiles before its blocks' windows.
    b, s = PREFILL_SHAPES[1]
    cfg_w = dataclasses.replace(cfg, window=LM_WINDOW)
    tokens = synth.lm_batch(gen, cfg, b, s)["tokens"][:, :s]
    logits, dt, n = timed_prefill(model, tokens, cfg_w)
    out["launches"] += n
    out["route_launches"]["wgmma"] += n
    out["windowed_prefill"] = {"batch": b, "seq": s, "window": LM_WINDOW, "wall_s": dt,
                               "tokens_per_s": b * s / dt, "launches": n}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model, tokens, logits
    torch.cuda.empty_cache()

    # The smoke config (2 layers, 4/2 heads of 16, fp32): kernel 4's fp32
    # route at hd 16, against the same model in float64 through the plain
    # functions.
    cfg_s = smoke_lm_config(load_arch(LM_ARCH).config)
    model_s = T.init_lm_params(gen, cfg_s)
    prompt = synth.lm_batch(gen, cfg_s, 2, F64_PROMPT)["tokens"][:, :F64_PROMPT]
    logits, dt, n = timed_prefill(model_s, prompt, cfg_s)
    out["launches"] += n
    out["route_launches"]["ffma"] += n
    cfg_s64 = dataclasses.replace(cfg_s, dtype=torch.float64)
    model_s64 = T.TransformerLM(cfg_s64, device=DEVICE)
    model_s64.load_state_dict(model_s.state_dict())
    with uncounted(), flash_replaced(
            lambda q, k, v, causal=True, **mask: F.flash_attention_plain(q, k, v, causal=causal,
                                                                          chunk=cfg_s.attn_chunk, **mask)):
        logits64 = T.prefill_step(model_s64, prompt, cfg_s64)
    err = rel_l2(logits, logits64)
    assert err <= FP32_LOGIT_TOL, ("fp32 smoke prefill vs float64", err, FP32_LOGIT_TOL)
    out["smoke"] = {"config": "smoke_lm_config(" + LM_ARCH + ")", "head_dim": cfg_s.head_dim,
                    "dtype": str(cfg_s.dtype), "batch": 2, "tokens": F64_PROMPT, "launches": n,
                    "wall_s": dt, "float64_rel_l2": err, "tol": FP32_LOGIT_TOL,
                    "argmax_equal": bool(torch.equal(logits.argmax(-1), logits64.argmax(-1)))}
    del model_s, model_s64
    torch.cuda.empty_cache()
    emit({"phase": "lm", **{k: v for k, v in out.items() if k != "held"}, "held": out["held"]})
    return out


def bf16_moe_logit_tolerance(n_layers: int) -> float:
    """:func:`bf16_logit_tolerance` for MoE layers: the FFN's two roundings
    (SwiGLU's h, the down product) become five (the dispatched tokens xd,
    h, the expert outputs y, the bf16 combine weights and the block's output
    cast), so R counts 17 per layer and 3 for the final norm."""
    return (17 * n_layers + 3) ** 0.5 * 2.0 ** -8


@contextlib.contextmanager
def moe_observed(impose=None):
    """Inside the block every ``layers.moe_block_routed`` call, which each
    ``moe_block`` makes (call i is layer i of one forward), records its
    metrics and the (k, G, S) experts it routed to.  With ``impose`` (one routing per layer) call i takes
    ``impose[i]`` in place of its own argmaxes and records, as ``free``,
    what they would have chosen."""
    from repro_torch.models import layers as L

    routed = L.moe_block_routed
    calls = []

    def observed(*args, experts=None, **kw):
        rec = {}
        if impose is not None:
            rec["free"] = routed(*args, **kw)[2]
            experts = impose[len(calls)]
        out, rec["metrics"], rec["experts"] = routed(*args, experts=experts, **kw)
        calls.append(rec)
        return out, rec["metrics"], rec["experts"]

    L.moe_block_routed = observed
    try:
        yield calls
    finally:
        L.moe_block_routed = routed


def moe_means(calls) -> dict:
    """Mean aux loss and dropped fraction over one forward's MoE layers."""
    import torch

    return {"aux_loss": float(torch.stack([c["metrics"].aux_loss for c in calls]).mean()),
            "dropped_frac": float(torch.stack([c["metrics"].dropped_frac for c in calls]).mean())}


def prefill_walk64(model, tokens, cfg):
    """``prefill_step``'s logits for ``model``'s weights in float64 through
    the plain functions, one layer's weights upcast at a time: a float64
    copy of OLMoE (55 GB) would not fit beside the bf16 model."""
    import dataclasses

    import torch

    from repro_torch.kernels.flash_attention import flash as F
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)

    def plain(q, k, v, causal=True, **mask):
        return F.flash_attention_plain(q, k, v, causal=causal, chunk=cfg.attn_chunk, **mask)

    with torch.no_grad(), uncounted(), flash_replaced(plain):
        x = T._embed(model, tokens, cfg64)
        positions = torch.arange(tokens.shape[1], device=x.device)
        for i in range(cfg.n_layers):
            lp = {n: p.double() for n, p in T._layer(model, i).items()}
            x = T._layer_fwd(cfg64, x, lp, positions)[0]
            del lp
        x = L.rmsnorm(x, model.final_norm.double(), cfg.norm_eps)
        return L.matmul_wide(x[:, -1], model.out.double())


def float64_check(model, tokens, cfg, logits, calls, tol: float) -> dict:
    """The bf16 (or fp32) prefill's logits against :func:`prefill_walk64` on
    the routing that prefill took (``calls`` of :func:`moe_observed`): a
    route that rounding flips is another computation, not an error, so the
    float64 model takes the same expert at each choice step and recomputes
    the gates and the rest.  Counts the (layer, token) routes whose expert
    set float64's own argmaxes would have changed."""
    import torch

    with moe_observed(impose=[c["experts"] for c in calls]) as calls64:
        logits64 = prefill_walk64(model, tokens, cfg)
    err = rel_l2(logits, logits64)
    assert err <= tol, ("prefill vs float64 on its routing", err, tol)
    flipped = sum(int((c["free"].sort(0).values != c["experts"].sort(0).values).any(0).sum())
                  for c in calls64)
    return {"tokens": int(tokens.numel()), "rel_l2": err, "tol": tol,
            "argmax_equal": bool(torch.equal(logits.argmax(-1), logits64.argmax(-1))),
            "routes": cfg.n_layers * int(tokens.numel()), "flipped_routes": flipped,
            "flipped_choices": sum(int((c["free"] != c["experts"]).sum()) for c in calls64)}


def phase_moe(seed: int) -> dict:
    """Phase 14b: OLMoE-1B-7B serving at full size (GShard ``moe_block`` in
    prefill, ``moe_dense_decode`` in decode, kernel 4 in every prefill
    layer), then Grok-1's smoke config."""
    import dataclasses

    import torch

    from repro_torch.configs.base import load_arch, smoke_lm_config
    from repro_torch.data import synth
    from repro_torch.data.pointclouds import make_generator
    from repro_torch.models import transformer as T

    cfg = load_arch(MOE_ARCH).config
    gen = make_generator(seed + 16, DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = T.init_lm_params(gen, cfg)
    torch.cuda.synchronize()
    assert model.layers["router"].dtype == torch.float32 and model.layers["wi_gate"].dtype == cfg.dtype
    out = {"arch": MOE_ARCH, "params_billions": cfg.params_billions(),
           "active_params_billions": cfg.active_params_billions(),
           "param_gb": sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9,
           "init_s": time.perf_counter() - t0, "launches": 0, "route_launches": {"wgmma": 0, "ffma": 0}}
    tol = bf16_moe_logit_tolerance(cfg.n_layers)

    # 1 × 512 against the float64 model on the bf16 path's routing; lm_forward's
    # aux loss is the mean of the layers' own.
    prompt = synth.lm_batch(gen, cfg, 1, F64_PROMPT)["tokens"][:, :F64_PROMPT]
    with moe_observed() as calls:
        logits, dt, n = timed_prefill(model, prompt, cfg)
    assert len(calls) == cfg.n_layers, len(calls)
    out["launches"] += n
    out["route_launches"]["wgmma"] += n
    means = moe_means(calls)
    with uncounted(), torch.no_grad():
        _, aux = T.lm_forward(model, prompt, cfg)
    assert abs(float(aux) - means["aux_loss"]) <= 1e-6 * abs(means["aux_loss"]), (float(aux), means)
    out["float64"] = {**float64_check(model, prompt, cfg, logits, calls, tol), "wall_s": dt, **means,
                      "lm_forward_aux_loss": float(aux)}
    emit({"phase": "moe_float64", **out["float64"]})

    # Counted prefills at the two cut prefill_32k shapes.
    out["prefill"] = []
    for b, s in PREFILL_SHAPES:
        tokens = synth.lm_batch(gen, cfg, b, s)["tokens"][:, :s]
        torch.cuda.reset_peak_memory_stats()
        with moe_observed() as calls:
            logits, dt, n = timed_prefill(model, tokens, cfg)
        out["launches"] += n
        out["route_launches"]["wgmma"] += n
        out["prefill"].append({"batch": b, "seq": s, "wall_s": dt, "tokens_per_s": b * s / dt,
                               "launches": n, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                               **moe_means(calls)})
        emit({"phase": "moe_prefill", **out["prefill"][-1]})
        del tokens, logits, calls
        torch.cuda.empty_cache()

    # One more prefill, uncounted, every kernel-4 call held to the plain version.
    b, s = MOE_HELD_SHAPE
    tokens = synth.lm_batch(gen, cfg, b, s)["tokens"][:, :s]
    with flash_held(cfg.attn_chunk) as held:
        T.prefill_step(model, tokens, cfg)
    assert len(held) == cfg.n_layers, len(held)
    out["held"] = held_summary(f"OLMoE prefill {b} x {s}", held)
    del tokens
    torch.cuda.empty_cache()

    # Decode: a 64-token prompt fed one token at a time, then greedy tokens.
    b = MOE_DECODE_BATCH
    prompt = synth.lm_batch(gen, cfg, b, DECODE_PROMPT)["tokens"][:, :DECODE_PROMPT]
    torch.cuda.reset_peak_memory_stats()
    cache = T.init_kv_cache(cfg, b, DECODE_CACHE, device=DEVICE)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(DECODE_PROMPT):
        step_logits, nxt, cache = T.serve_step(model, cache, prompt[:, i], cfg)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    generated = []
    for _ in range(DECODE_NEW):
        generated.append(nxt)
        _, nxt, cache = T.serve_step(model, cache, nxt, cfg)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    assert sum(counts().values()) == 0, counts()  # decode attention and the dense experts are plain
    assert int(cache.length) == DECODE_PROMPT + DECODE_NEW
    tokens = torch.stack(generated, 1)
    assert tokens.shape == (b, DECODE_NEW) and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab
    decode_peak = torch.cuda.max_memory_allocated() / 1e9
    del cache
    torch.cuda.empty_cache()
    # Decode runs every expert, so only a prefill that cannot drop computes
    # the same: capacity E / top_k makes each expert's slots the group size.
    cfg_nd = dataclasses.replace(cfg, capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    with moe_observed() as calls:
        logits = T.prefill_step(model, prompt, cfg_nd)
    assert all(float(c["metrics"].dropped_frac) == 0.0 for c in calls)
    out["launches"] += counts()["flash_fwd"]
    for r, n in route_counts().items():
        out["route_launches"][r] += n
    err = rel_l2(step_logits, logits)
    assert err <= 2 * tol, ("decode vs no-drop prefill logits", err, 2 * tol)
    with uncounted(), moe_observed() as calls:
        T.prefill_step(model, prompt, cfg)
    out["decode"] = {"batch": b, "cache": DECODE_CACHE, "prompt": DECODE_PROMPT,
                     "new_tokens": DECODE_NEW, "prompt_fill_s": fill_s,
                     "ms_per_step": gen_s / DECODE_NEW * 1e3, "tokens_per_s": b * DECODE_NEW / gen_s,
                     "peak_gb": decode_peak, "vs_prefill_rel_l2": err, "tol": 2 * tol,
                     "vs_prefill_capacity_factor": cfg_nd.capacity_factor,
                     "argmax_agree": float((step_logits.argmax(-1) == logits.argmax(-1)).float().mean()),
                     "default_cf_prompt_dropped_frac": moe_means(calls)["dropped_frac"]}
    emit({"phase": "moe_decode", **out["decode"]})
    del model, prompt, logits, step_logits, calls
    torch.cuda.empty_cache()

    # Grok-1's smoke config (2 layers, 4/2 heads of 16, 4 experts, top 2,
    # fp32): kernel 4's fp32 route, against float64 on its own routing.
    cfg_g = smoke_lm_config(load_arch(MOE_SMOKE_ARCH).config)
    model_g = T.init_lm_params(gen, cfg_g)
    prompt = synth.lm_batch(gen, cfg_g, 2, F64_PROMPT)["tokens"][:, :F64_PROMPT]
    with moe_observed() as calls:
        logits, dt, n = timed_prefill(model_g, prompt, cfg_g)
    out["launches"] += n
    out["route_launches"]["ffma"] += n
    out["smoke"] = {"config": f"smoke_lm_config({MOE_SMOKE_ARCH})", "head_dim": cfg_g.head_dim,
                    "experts": cfg_g.moe_experts, "top_k": cfg_g.moe_top_k, "dtype": str(cfg_g.dtype),
                    "batch": 2, "launches": n, "wall_s": dt, **moe_means(calls),
                    "float64": float64_check(model_g, prompt, cfg_g, logits, calls, FP32_LOGIT_TOL)}
    del model_g
    torch.cuda.empty_cache()
    emit({"phase": "moe", **{k: v for k, v in out.items() if k != "held"}, "held": out["held"]})
    return out


def visible_pairs(b: int, h: int, s: int, window) -> float:
    """(q, k) pairs a causal prefill of S tokens sees, over b·h heads: S(S+1)/2,
    or with a window W, W(W+1)/2 + (S − W)·W."""
    w = s if window is None else min(window, s)
    return b * h * (w * (w + 1) / 2 + (s - w) * w)


def phase_times_flash(seed: int, env: dict) -> list[dict]:
    import torch

    from repro_torch.data.pointclouds import make_generator
    from repro_torch.kernels.flash_attention import flash as F

    gen = make_generator(seed + 15, DEVICE)
    rows = []
    for b, s, cfg_h, cfg_kv, hd, dtype_name, window in FLASH_TIMES:
        dtype = getattr(torch, dtype_name)
        q = torch.randn((b, s, cfg_h, hd), generator=gen, device=DEVICE).to(dtype)
        k = torch.randn((b, s, cfg_kv, hd), generator=gen, device=DEVICE).to(dtype)
        v = torch.randn((b, s, cfg_kv, hd), generator=gen, device=DEVICE).to(dtype)
        out = torch.empty_like(q)
        with uncounted():
            ms = cuda_ms(lambda: F.flash_fwd(q, k, v, out, causal=True, window=window))
        plain = {}

        def plain_fn():
            plain["out"] = F.flash_attention_plain(q, k, v, causal=True, window=window)

        plain_ms = cuda_ms(plain_fn, reps=3)
        e = flash_error(out, plain["out"], weighted_abs_v(q, k, v, causal=True, window=window))
        assert e["max_ratio"] <= 1, ("timed kernel vs plain", b, s, hd, window, e)
        del plain["out"]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        extra = {}
        if window is None and dtype == torch.bfloat16:
            # The yardstick on its flash backend only: its math fallback would
            # materialise a (B, H, S, S) score tensor (137 GB at 32,768).
            backend = torch.nn.attention.SDPBackend.FLASH_ATTENTION
            with torch.nn.attention.sdpa_kernel(backend):
                library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
        else:
            # An explicit (S, S) mask, the band of the window or the causal
            # triangle, on the memory-efficient backend (the flash backend
            # takes no mask); kv heads expanded first, outside the timing.
            pos = torch.arange(s, device=DEVICE)
            band = pos[:, None] >= pos[None, :]
            if window is not None:
                band &= (pos[:, None] - pos[None, :]) < window
            kx = kt.repeat_interleave(cfg_h // cfg_kv, dim=1)
            vx = vt.repeat_interleave(cfg_h // cfg_kv, dim=1)
            backend = torch.nn.attention.SDPBackend.EFFICIENT_ATTENTION
            with torch.nn.attention.sdpa_kernel(backend):
                library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kx, vx, attn_mask=band))
                if window is None:  # the same backend with its own causal mask, no mask read
                    extra["library_is_causal_ms"] = cuda_ms(
                        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kx, vx, is_causal=True))
                    extra["vs_library_is_causal"] = ms / extra["library_is_causal_ms"]
            del band, kx, vx
        pairs = visible_pairs(b, cfg_h, s, window)
        flops = 4.0 * hd * pairs
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        peak = env["bf16_peak_tflops" if dtype == torch.bfloat16 else "fp32_peak_tflops"] * 1e12
        op_ms = max(flops / peak, pairs / env["mufu_per_s"]) * 1e3
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(op_ms, byte_ms)
        label = f"{b}x{s} {cfg_h}/{cfg_kv}x{hd} {dtype_name}" + ("" if window is None else f" window {window}")
        rows.append({"shape": [b, s, cfg_h, cfg_kv, hd], "dtype": dtype_name, "window": window, "label": label,
                     "route": F.route(q.dtype, hd), "instance_hd": F.instance(F.route(q.dtype, hd), hd),
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "sdpa_backend": backend.name,
                     **e, "bound_ms": bound_ms,
                     "bound_by": "operations" if op_ms >= byte_ms else "bytes",
                     "flops_ms": flops / peak * 1e3,
                     "exp_ms": pairs / env["mufu_per_s"] * 1e3, "bytes_ms": byte_ms,
                     "achieved_tflops": flops / (ms * 1e-3) / 1e12,
                     "share_of_bound": bound_ms / ms, "vs_library": ms / library_ms, **extra})
        del q, k, v, out, qt, kt, vt
        torch.cuda.empty_cache()
    for r in rows:  # a windowed shape against the causal one of the same shape
        same = [c for c in rows if c["window"] is None and (c["shape"], c["dtype"]) == (r["shape"], r["dtype"])]
        if r["window"] is not None and same:
            r["vs_causal_same_shape"] = r["ms"] / same[0]["ms"]
    emit({"phase": "times_flash", "rows": rows})
    return rows


# ---------------------------------------------------------------------------
# phase 16: training (kernel 4 under autograd, TinyLlama-1.1B through fit)
# ---------------------------------------------------------------------------


def attn_grad_error(got, want) -> dict:
    """A gradient of attention held entry by entry against another
    computation of it (``want``, torch.autograd through the plain
    recurrence).  Per entry, with w = |want| and r = the RMS of ``want``
    over the tensor (a gradient has no unit of its own, so the absolute
    part scales with its size):
      fp32:  |Δ| ≤ 2e-5·r + 1e-4·w, the reference's fp32 tolerance
        (tests/test_kernels.py:115) with r in the place of 1;
      bf16:  add 2⁻⁷·w.  Both sides take their gradient in fp32 and cast
        it to bf16 once; fp32 values within the fp32 part may round to
        neighbouring bf16 values, one spacing ≤ 2⁻⁷·w apart.
    Returns the worst |Δ|, the largest |Δ| / tolerance (≤ 1 to pass),
    the entries over their tolerance and whether the two are bitwise
    equal."""
    import torch

    want32 = want.double()
    w = want32.abs()
    r = float(torch.sqrt(torch.mean(want32 * want32)))
    tol = 2e-5 * r + 1e-4 * w
    if got.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * w
    diff = (got.double() - want32).abs()
    return {"max_abs_err": float(diff.max()), "max_ratio": float((diff / tol.clamp(min=1e-300)).max()),
            "n_over": int((diff > tol).sum()), "bitwise": bool(torch.equal(got, want))}


def phase_attn_grad(seed: int) -> dict:
    """Kernel 4 under autograd: ``flash.flash_attention_grad`` (kernel 4's
    forward, the recomputing plain backward) against torch.autograd through
    ``flash_attention_plain``, on CUDA tensors.  Comparison launches:
    counted here (one per case), taken back out of the main-path counts."""
    import torch

    from repro_torch.data.pointclouds import make_generator
    from repro_torch.kernels.flash_attention import flash as F

    gen = make_generator(seed + 16, DEVICE)
    rows, worst = [], 0.0
    with uncounted():
        for b, s, h, kv, hd, dtype_name, chunk in ATTN_GRAD_CASES:
            dtype = getattr(torch, dtype_name)
            q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                       for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
            dout = torch.randn((b, s, h, hd), generator=gen, device=DEVICE).to(dtype)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            before = route_counts()
            out = F.flash_attention_grad(*leaves, chunk=chunk)
            route = F.route(dtype, hd)
            assert route_counts()[route] == before[route] + 1, (route, before, route_counts())
            grads = torch.autograd.grad(out, leaves, dout)
            torch.cuda.synchronize()
            assert route_counts() == {**before, route: before[route] + 1}, "the backward launched a kernel"
            plain = [t.clone().requires_grad_() for t in (q, k, v)]
            out_p = F.flash_attention_plain(*plain, chunk=chunk)
            want = torch.autograd.grad(out_p, plain, dout)
            fwd = flash_error(out.detach(), out_p.detach(), weighted_abs_v(q, k, v, causal=True))
            assert fwd["max_ratio"] <= 1, ("forward", b, s, h, kv, hd, dtype_name, fwd)
            row = {"case": [b, s, h, kv, hd, dtype_name, chunk], "route": route, "forward": fwd}
            for name, g, wg in zip(("dq", "dk", "dv"), grads, want):
                assert g.shape == wg.shape and g.dtype == dtype and bool(torch.isfinite(g).all())
                e = attn_grad_error(g, wg)
                assert e["max_ratio"] <= 1, (row["case"], name, e)
                row[name] = e
                worst = max(worst, e["max_abs_err"])
            rows.append(row)
            del q, k, v, dout, leaves, out, grads, plain, out_p, want
            torch.cuda.empty_cache()
    out = {"phase": "attn_grad", "cases": rows, "max_abs_err": worst,
           "max_ratio": max(r[g]["max_ratio"] for r in rows for g in ("dq", "dk", "dv")),
           "all_bitwise": all(r[g]["bitwise"] for r in rows for g in ("dq", "dk", "dv"))}
    emit(out)
    return out


def bf16_grad_tolerance(n_layers: int) -> float:
    """Relative L2 distance of a bf16 model's gradients from exact
    arithmetic: each bf16 rounding moves a value by at most u = 2⁻⁸
    relative, with independent signs, so R roundings add to √R·u.  A
    gradient depends on the forward's roundings (14 per layer, 3 for the
    final norm: :func:`bf16_logit_tolerance`), on as many in the backward
    (each forward rounding point rounds its gradient once) and on its own
    cast to bf16: R = 28·L + 4."""
    return (28 * n_layers + 4) ** 0.5 * 2.0 ** -8


def grads_vs_float64(model, cfg, tokens) -> dict:
    """The bf16 model's gradients of ``lm_loss`` on ``tokens`` against the
    same weights in float64 through the plain functions (uncounted)."""
    import dataclasses

    import torch

    from repro_torch.kernels.flash_attention import flash as F
    from repro_torch.models import transformer as T

    def grads_of(m, c):
        named = dict(m.named_parameters())
        loss, _ = T.lm_loss(m, {"tokens": tokens}, c)
        return float(loss.detach()), dict(zip(named, torch.autograd.grad(loss, list(named.values()))))

    t0 = time.perf_counter()
    with uncounted():
        loss, grads = grads_of(model, cfg)
        torch.cuda.synchronize()
        bf16_s = time.perf_counter() - t0
        cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
        model64 = T.TransformerLM(cfg64, device=DEVICE)
        model64.load_state_dict(model.state_dict())
        with flash_replaced(lambda q, k, v, causal=True, **mask: F.flash_attention_plain(
                q, k, v, causal=causal, chunk=cfg.attn_chunk, **mask)):
            loss64, grads64 = grads_of(model64, cfg64)
    del model64
    tol = bf16_grad_tolerance(cfg.n_layers)
    per, num, den = {}, 0.0, 0.0
    for n, g in grads.items():
        assert g.dtype == model.get_parameter(n).dtype and bool(torch.isfinite(g).all()), n
        d2 = float(torch.sum((g.double() - grads64[n]) ** 2))
        r2 = float(torch.sum(grads64[n] ** 2))
        per[n] = (d2 / r2) ** 0.5
        num, den = num + d2, den + r2
    del grads, grads64
    torch.cuda.empty_cache()
    whole = (num / den) ** 0.5
    out = {"tokens": list(tokens.shape), "loss": loss, "loss_float64": loss64, "tol": tol,
           "rel_l2": per, "rel_l2_whole": whole, "ratio": {n: e / tol for n, e in per.items()},
           "max_ratio": max(per.values()) / tol, "whole_ratio": whole / tol, "bf16_grad_s": bf16_s}
    assert max(per.values()) <= tol and whole <= tol, out
    return out


@contextlib.contextmanager
def checkpoints_observed(keep_step: int):
    """Inside the block the background writer's ``checkpoint.save`` keeps
    the host snapshot it writes for ``keep_step`` and times every write,
    and every ``checkpoint.restore`` is timed and, for that step, held leaf
    by leaf, bitwise, to the snapshot (:func:`bitwise_as_saved`) before it
    returns.  Yields {"writes": [(step, s)], "restores": [(step, s, leaves
    equal, leaves, compare s)]}."""
    from repro_torch.train import checkpoint as C

    saved, seen = {}, {"writes": [], "restores": []}
    real_save, real_restore = C.save, C.restore

    def save(root, step, tree, **kw):
        if step == keep_step:
            saved[step] = tree
        t0 = time.perf_counter()
        out = real_save(root, step, tree, **kw)
        seen["writes"].append((step, time.perf_counter() - t0))
        return out

    def restore(root, tree_like, step=None, device=None):
        t0 = time.perf_counter()
        tree, got = real_restore(root, tree_like, step=step, device=device)
        t1 = time.perf_counter()
        same, leaves = bitwise_as_saved(tree, saved[got]) if got in saved else (0, -1)
        seen["restores"].append((got, t1 - t0, same, leaves, time.perf_counter() - t1))
        return tree, got

    C.save, C.restore = save, restore
    try:
        yield seen
    finally:
        C.save, C.restore = real_save, real_restore
        saved.clear()


def bitwise_as_saved(restored: dict, snapshot: dict) -> tuple[int, int]:
    """(leaves bitwise equal, leaves) of a restored tree (tensors on the
    card) against the host snapshot the checkpoint was written from,
    compared on the card as integer words."""
    import numpy as np
    import torch

    from repro_torch.train import checkpoint as C

    words = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    flat_r, flat_s = C._flatten(restored), C._flatten(snapshot)
    assert flat_r.keys() == flat_s.keys(), (sorted(flat_r)[:5], sorted(flat_s)[:5])
    same = 0
    for key, t in flat_r.items():
        snap = np.asarray(flat_s[key])
        want = torch.from_numpy(snap.view(f"i{snap.itemsize}")).to(t.device)
        same += int(tuple(t.shape) == snap.shape and torch.equal(t.view(words[t.element_size()]), want))
    return same, len(flat_r)


def phase_train(seed: int, env: dict) -> dict:
    """Main path 7: TinyLlama-1.1B at full width and depth, bf16, random
    weights, trained through ``train.loop.fit``; its gradients at step 0
    against float64 first (uncounted)."""
    import math
    import tempfile

    import torch

    from repro_torch.configs.base import load_arch
    from repro_torch.core.fp_margin import fp_value_margin
    from repro_torch.data import synth
    from repro_torch.data.pointclouds import make_generator
    from repro_torch.hd import set_distance
    from repro_torch.kernels.flash_attention import flash as F
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer
    from repro_torch.train.loop import TrainConfig, fit, make_set_distance_metric

    cfg = load_arch(LM_ARCH).config
    assert cfg.remat and cfg.dtype == torch.bfloat16
    gen = make_generator(seed + 17, DEVICE)
    model = T.init_lm_params(gen, cfg)
    out = {"arch": LM_ARCH, "params_billions": cfg.params_billions(), "remat": cfg.remat}

    # Gradients at the step-0 weights against float64.
    prompt = synth.lm_batch(gen, cfg, 1, GRAD64_TOKENS)["tokens"]
    out["float64"] = grads_vs_float64(model, cfg, prompt)
    emit({"phase": "train_grads_float64", **out["float64"]})

    b, s = TRAIN_SHAPE
    steps_run = []
    state = {"embed0": model.embed.detach().float(), "drift": []}  # fp32 holds bf16 exactly
    metric = make_set_distance_metric(variant="hausdorff", method="prohd")

    def data_iter(start):
        i = start
        while True:
            yield synth.lm_batch(make_generator(seed + 1000 + i, DEVICE), cfg, b, s)
            i += 1

    def log_fn(step, rec):
        rec = {"step": step, "loss": rec["loss"], "ce_loss": rec["ce_loss"], "grad_norm": rec["grad_norm"],
               "wall_s": rec["dt"], "tokens_per_s": b * s / rec["dt"], "straggler": rec["straggler"],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        steps_run.append(rec)
        emit({"phase": "train_step", **rec})

    def drift_hook(params, info):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = metric(params.embed.float(), state["embed0"])
        v, lo, up = float(res.value), float(res.lower), float(res.upper)
        rec = {"step": info["step"], "value": v, "lower": lo, "upper": up,
               "wall_s": time.perf_counter() - t0}
        if info["step"] > 0 and "exact" not in state:  # once: the exact kernel-1 HD of the same pair
            with uncounted():
                h = float(set_distance(params.embed.float(), state["embed0"]).value)
            scale = max(float(torch.linalg.vector_norm(x.float(), dim=1).max())
                        for x in (params.embed, state["embed0"]))
            m = float(fp_value_margin(cfg.d_model, scale, h))
            assert lo <= h + m and h <= up + m and v <= h + m, (v, lo, up, h, m)
            state["exact"] = rec["exact"] = h
            rec["margin"] = m
        state["drift"].append(rec)
        emit({"phase": "train_drift", **rec})

    restore_step = (TRAIN_FAIL_AT - 1) // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY  # the newest save before it
    with tempfile.TemporaryDirectory() as ckpt_dir, checkpoints_observed(restore_step) as seen:
        tc = TrainConfig(steps=TRAIN_STEPS, microbatches=TRAIN_MICROBATCHES, log_every=1,
                         ckpt_every=TRAIN_CKPT_EVERY, ckpt_dir=ckpt_dir, drift_every=TRAIN_DRIFT_EVERY)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        fit(params=model, optimizer=optimizer.adamw(lr=1e-3, weight_decay=0.01),
            loss_fn=lambda p, batch: T.lm_loss(p, batch, cfg), data_iter_fn=data_iter, cfg=tc,
            drift_hook=drift_hook, log_fn=log_fn, _fail_at=TRAIN_FAIL_AT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, routes = counts(), route_counts()
        # one restore, of the newest checkpoint before the failure, bitwise what was written
        assert len(seen["restores"]) == 1 and seen["restores"][0][0] == restore_step, seen
        _, restore_s, same, leaves, compare_s = seen["restores"][0]
        assert same == leaves > 0, seen
        ckpt_bytes = sum(f.stat().st_size for f in Path(ckpt_dir).glob(f"ckpt_{restore_step}/*"))
    assert [r["step"] for r in steps_run] == list(range(TRAIN_STEPS)), steps_run
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in steps_run), steps_run
    per_step = 2 * cfg.n_layers * TRAIN_MICROBATCHES  # forward + remat recompute, per microbatch
    assert n["flash_fwd"] == per_step * TRAIN_STEPS, (n, per_step)
    assert routes == {**dict.fromkeys(F.ROUTES, 0), "wgmma": n["flash_fwd"]}, routes
    assert n["fused_minscan"] > 0 and n["batched_minscan"] == n["multiquery_minscan"] == 0, n
    assert "exact" in state and [d["step"] for d in state["drift"]] == [0, TRAIN_DRIFT_EVERY], state["drift"]
    out.update({"shape": list(TRAIN_SHAPE), "microbatches": TRAIN_MICROBATCHES, "steps": steps_run,
                "launches": n, "route_launches": routes, "kernel4_per_step": per_step,
                "restored_step": restore_step, "restored_leaves_bitwise": f"{same}/{leaves}",
                "restore_s": restore_s, "restore_compare_s": compare_s, "checkpoint_gb": ckpt_bytes / 1e9,
                "checkpoint_write_s": [w for _, w in seen["writes"]],
                "checkpoint_saves": TRAIN_STEPS // TRAIN_CKPT_EVERY, "drift": state["drift"], "fit_wall_s": wall,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    del model, state
    torch.cuda.empty_cache()
    emit({"phase": "train", **{k: v for k, v in out.items() if k != "float64"}})
    return out


def phase_train_launcher() -> dict:
    """``python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 4``
    on the card, as a subprocess: the smoke config on kernel 4's fp32
    route."""
    import os

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", LM_ARCH, "--steps", "4"],
                          cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=600)
    out = {"phase": "train_launcher", "returncode": proc.returncode, "wall_s": time.perf_counter() - t0,
           "stdout": proc.stdout.strip().splitlines()[-6:]}
    emit(out)
    assert proc.returncode == 0 and "[train] done" in proc.stdout and "device=cuda" in proc.stdout, proc.stderr
    return out


def cell_dims(arch: str) -> dict:
    """{cell name: dims} of an arch's shape cells, with CELL_DIMS's overrides."""
    from repro_torch.configs.base import load_arch

    return {c.name: {**c.dims, **CELL_DIMS.get(c.name, {})} for c in load_arch(arch).shapes}


def model_config(arch: str):
    """The arch's published config (a CPU rehearsal replaces this)."""
    from repro_torch.configs.base import load_arch

    return load_arch(arch).config


def as_float64(model):
    """A float64 copy of a model's parameters (the card's float64 oracle)."""
    import copy

    return copy.deepcopy(model).double()


def peak_gb() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def host_ms(call, reps: int) -> tuple[float, list]:
    """One warm-up call, then ``reps`` calls each timed on the host clock
    between device synchronisations: (median ms, the runs)."""
    import torch

    call()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs), runs


def fit_steps(model, loss_fn, make_batch, steps: int, examples: int) -> dict:
    """``train.loop.fit`` for ``steps`` AdamW steps (lr 1e-3, weight decay
    0.01, the reference launcher's), no checkpoint: per step loss, wall
    time (fit's ``dt``: the batch and the step, device synchronised),
    examples/s; peak memory over the steps."""
    import math

    import torch

    from repro_torch.train import optimizer
    from repro_torch.train.loop import TrainConfig, fit

    recs = []

    def data_iter(start):
        i = start
        while True:
            yield make_batch(i)
            i += 1

    def log_fn(step, rec):
        recs.append({"step": step, "loss": rec["loss"], "grad_norm": rec["grad_norm"], "wall_s": rec["dt"],
                     "examples_per_s": examples / rec["dt"]})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fit(params=model, optimizer=optimizer.adamw(lr=1e-3, weight_decay=0.01), loss_fn=loss_fn,
        data_iter_fn=data_iter, cfg=TrainConfig(steps=steps, log_every=1, ckpt_every=0), log_fn=log_fn)
    torch.cuda.synchronize()
    assert [r["step"] for r in recs] == list(range(steps)), recs
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in recs), recs
    return {"steps": recs, "fit_wall_s": time.perf_counter() - t0, "peak_gb": peak_gb(),
            "examples_per_step": examples}


def loss_grads_vs_float64(model, loss_fn, batch) -> dict:
    """fp32 gradients of ``loss_fn`` against a float64 copy's on the same
    batch, relative L2 per parameter tensor (GRAD64_TOL, see there)."""
    import torch

    named = dict(model.named_parameters())
    loss, _ = loss_fn(model, batch)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    m64 = as_float64(model)
    named64 = dict(m64.named_parameters())
    loss64, _ = loss_fn(m64, batch)
    grads64 = dict(zip(named64, torch.autograd.grad(loss64, list(named64.values()))))
    total = float(torch.sqrt(sum(torch.sum(g * g) for g in grads64.values())))
    per = {}
    for n, g in grads.items():
        want = grads64[n]
        err = float(torch.linalg.vector_norm(g.double() - want))
        per[n] = err / max(float(torch.linalg.vector_norm(want)), 1e-2 * total)
    worst = max(per, key=per.get)
    out = {"loss": loss.item(), "loss64": loss64.item(), "max_rel": per[worst], "worst": worst,
           "tol": GRAD64_TOL, "tensors": len(per)}
    assert out["max_rel"] <= GRAD64_TOL and abs(out["loss"] - out["loss64"]) <= 1e-4 * abs(out["loss64"]), out
    del m64, grads64, grads
    return out


def gat_float64(model, batch, cfg) -> dict:
    """GAT's logits against the same weights and features in float64."""
    import torch

    from repro_torch.models import gnn as G

    with torch.no_grad():
        logits = G.gat_forward(model, batch, cfg)
        want = G.gat_forward(as_float64(model), {**batch, "feats": batch["feats"].double()}, cfg)
    err = rel_l2(logits, want)
    assert bool(torch.isfinite(logits).all()) and err <= FP32_LOGIT_TOL, err
    return {"rel_l2": err, "tol": FP32_LOGIT_TOL}


def phase_gnn(seed: int) -> dict:
    """Phase 17: GAT (gat-cora's config) at each GNN_SHAPES cell."""
    import numpy as np
    import torch

    from repro_torch.data import graphs, synth
    from repro_torch.data.pointclouds import make_generator
    from repro_torch.models import gnn as G

    cfg = model_config(GNN_ARCH)
    cells = cell_dims(GNN_ARCH)
    c = cfg.n_classes
    out = {"arch": GNN_ARCH, "n_classes": c}

    # full_graph_sm: the whole graph, forward against float64, then fit.
    d = cells["full_graph_sm"]
    gen = make_generator(seed + 40, DEVICE)
    model = G.init_gat_params(gen, cfg, d["d_feat"], c)
    batch = synth.gnn_batch(gen, cfg, n_nodes=d["n_nodes"], n_edges=d["n_edges"], d_feat=d["d_feat"], n_classes=c)
    rec = {"dims": d, "float64": gat_float64(model, batch, cfg)}
    with torch.no_grad():
        rec["forward_ms"], _ = host_ms(lambda: G.gat_forward(model, batch, cfg), 5)
    rec["train"] = fit_steps(model, lambda p, b: G.gat_node_loss(p, b, cfg), lambda i: batch, GNN_STEPS,
                             d["n_nodes"])
    emit({"phase": "gnn", "cell": "full_graph_sm", **rec})
    out["full_graph_sm"] = rec

    # minibatch_lg: a Reddit-scale CSR graph on the host, fanout-sampled subgraphs.
    d = cells["minibatch_lg"]
    t0 = time.perf_counter()
    graph = graphs.CSRGraph.random(np.random.default_rng(seed + 41), d["n_nodes"], MINIBATCH_AVG_DEGREE,
                                   d["d_feat"], c)
    rec = {"dims": d, "graph_build_s": time.perf_counter() - t0, "graph_edges": graph.n_edges,
           "graph_host_gb": (graph.indices.nbytes + graph.feats.nbytes + graph.indptr.nbytes) / 1e9}
    it = graphs.minibatch_iterator(graph, d["batch_nodes"], (d["fanout0"], d["fanout1"]), seed=seed)
    host = []

    def subgraph(_):
        t0 = time.perf_counter()
        sub = next(it)
        t1 = time.perf_counter()
        b = {k: torch.from_numpy(v).to(DEVICE) for k, v in sub.items()}
        torch.cuda.synchronize()
        host.append({"sample_s": t1 - t0, "to_device_s": time.perf_counter() - t1})
        return b

    first = subgraph(-1)
    n_sub = d["batch_nodes"] * (1 + d["fanout0"] + d["fanout0"] * d["fanout1"])
    assert first["feats"].shape == (n_sub, d["d_feat"]), first["feats"].shape
    rec["subgraph"] = {"nodes": n_sub, "edges": int(first["edge_src"].shape[0]),
                       "real_edges": int(first["edge_mask"].sum())}
    model = G.init_gat_params(gen, cfg, d["d_feat"], c)
    rec["float64"] = gat_float64(model, first, cfg)
    rec["train"] = fit_steps(model, lambda p, b: G.gat_node_loss(p, b, cfg), subgraph, GNN_STEPS,
                             d["batch_nodes"])
    rec["host"] = host[1:]
    shares = [(h["sample_s"] + h["to_device_s"]) / s["wall_s"] for h, s in zip(host[1:], rec["train"]["steps"])]
    rec["sampler_share"] = shares
    rec["sampler_share_median"] = statistics.median(shares)
    del graph, it, first
    emit({"phase": "gnn", "cell": "minibatch_lg", **rec})
    out["minibatch_lg"] = rec

    # ogb_products: one forward over the whole graph, no gradient.
    d = cells["ogb_products"]
    n, e = d["n_nodes"], d["n_edges"]
    src = torch.randint(0, n, (e,), generator=gen, device=DEVICE, dtype=torch.int32)
    dst = torch.randint(0, n, (e,), generator=gen, device=DEVICE, dtype=torch.int32)
    src, dst, mask = G.with_self_loops(src, dst, n)
    batch = {"feats": torch.randn((n, d["d_feat"]), generator=gen, device=DEVICE), "edge_src": src,
             "edge_dst": dst, "edge_mask": mask}
    model = G.init_gat_params(gen, cfg, d["d_feat"], c)
    runs = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            logits = G.gat_forward(model, batch, cfg)
            torch.cuda.synchronize()
            runs.append({"wall_s": time.perf_counter() - t0, "peak_gb": peak_gb()})
            assert logits.shape == (n, c) and bool(torch.isfinite(logits).all())
            del logits
    rec = {"dims": d, "edges_with_loops": int(src.shape[0]), "forward": runs,
           "edges_per_s": src.shape[0] / runs[-1]["wall_s"]}
    del batch, src, dst, mask
    torch.cuda.empty_cache()
    emit({"phase": "gnn", "cell": "ogb_products", **rec})
    out["ogb_products"] = rec

    # molecule: 128 graphs of 30 nodes and 64 edges, graph classification.
    d = cells["molecule"]
    model = G.init_gat_params(gen, cfg, d["d_feat"], c)

    def molecules(i):
        return synth.gnn_batch(make_generator(seed + 1000 + i, DEVICE), cfg, n_nodes=d["n_nodes"] * d["batch"],
                               n_edges=d["n_edges"] * d["batch"], d_feat=d["d_feat"], n_classes=c,
                               n_graphs=d["batch"])

    rec = {"dims": d, "train": fit_steps(model, lambda p, b: G.gat_graph_loss(p, b, cfg), molecules, GNN_STEPS,
                                          d["batch"])}
    emit({"phase": "gnn", "cell": "molecule", **rec})
    out["molecule"] = rec
    torch.cuda.empty_cache()
    return out


def retrieval_vs_float64(table, q, table64, q64, metric: str) -> dict:
    """``retrieval_topk`` at K_RETRIEVAL against float64 scores: every value
    within the fp32 bound (FP32_LOGIT_TOL of the score's scale: |q|·max|c|
    for dot, (|q| + max|c|)² for l2), and the ids those of float64 wherever
    the K-th and (K+1)-th float64 scores lie further apart than the bound."""
    import torch

    from repro_torch.models.retrieval import retrieval_topk

    top = retrieval_topk(table, q, K_RETRIEVAL, metric=metric)
    want = retrieval_topk(table64, q64, K_RETRIEVAL + 1, metric=metric)
    qn = float(torch.linalg.vector_norm(q64))
    cn = float(torch.linalg.vector_norm(table64, dim=1).max())
    bound = FP32_LOGIT_TOL * (qn * cn if metric == "dot" else (qn + cn) ** 2)
    err = float((top.scores.double() - want.scores[:, :K_RETRIEVAL]).abs().max())
    gap = float((want.scores[:, K_RETRIEVAL - 1] - want.scores[:, K_RETRIEVAL]).min())
    ids_equal = torch.equal(top.ids, want.ids[:, :K_RETRIEVAL])
    assert err <= bound, (metric, err, bound)
    assert ids_equal or gap <= bound, (metric, top.ids, want.ids, gap, bound)
    return {"max_abs_err": err, "bound": bound, "kth_gap64": gap, "ids_equal": ids_equal}


def phase_recsys(seed: int) -> dict:
    """Phase 18: FM, DIEN, BERT4Rec and BST at their published sizes, each
    cell of RECSYS_SHAPES."""
    import torch

    from repro_torch.data import synth
    from repro_torch.data.pointclouds import make_generator
    from repro_torch.models import recsys as R
    from repro_torch.models.retrieval import retrieval_topk

    cells = cell_dims(RECSYS_ARCHS[0])
    out = {}
    for i, arch in enumerate(RECSYS_ARCHS):
        cfg = model_config(arch)
        init, _, loss, score, qemb, cands = R.get_model(cfg)
        gen = make_generator(seed + 50 + i, DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = init(gen, cfg)
        torch.cuda.synchronize()
        rec = {"arch": arch, "init_s": time.perf_counter() - t0,
               "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
               "params_gb": sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9}

        # serve_p99: the median of SERVE_REPS synchronised calls after a warm-up.
        b = synth.recsys_batch(gen, cfg, cells["serve_p99"]["batch"], train=False)
        with torch.no_grad():
            rec["serve_p99_ms"], rec["serve_p99_runs_ms"] = host_ms(lambda: score(model, b, cfg), SERVE_REPS)
            s = score(model, b, cfg)
            m64 = as_float64(model)
            s64 = score(m64, b, cfg)
        assert s.shape == (cells["serve_p99"]["batch"],) and bool(torch.isfinite(s).all())
        rec["serve_float64_rel_l2"] = rel_l2(s, s64)
        assert rec["serve_float64_rel_l2"] <= FP32_LOGIT_TOL, rec

        # serve_bulk: rows/s at the cell's batch (BERT4Rec cut).
        bulk = RECSYS_BULK_BATCH[arch]
        b = synth.recsys_batch(gen, cfg, bulk, train=False)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ms, runs = host_ms(lambda: score(model, b, cfg), 3)
        rec["serve_bulk"] = {"batch": bulk, "ms": ms, "runs_ms": runs, "rows_per_s": bulk / ms * 1e3,
                             "peak_gb": peak_gb()}
        del b
        torch.cuda.empty_cache()

        # retrieval_cand: a query at batch 1 against 1M candidates, dot and l2.
        b = synth.recsys_batch(gen, cfg, cells["retrieval_cand"]["batch"], train=False)
        n_cand = cells["retrieval_cand"]["n_candidates"]
        with torch.no_grad():
            q, q64 = qemb(model, b, cfg), qemb(m64, b, cfg)
            table, table64 = cands(model, cfg, n_cand), cands(m64, cfg, n_cand)
            assert table.shape[0] == n_cand
            ret = {"query_embedding_ms": host_ms(lambda: qemb(model, b, cfg), 5)[0]}
            for metric in ("dot", "l2"):
                ms, _ = host_ms(lambda: retrieval_topk(table, q, K_RETRIEVAL, metric=metric), 5)
                ret[metric] = {"topk_ms": ms, **retrieval_vs_float64(table, q, table64, q64, metric)}
        rec["retrieval"] = ret
        del m64, table64, q64
        torch.cuda.empty_cache()

        # train_batch: fit (cut for DIEN and BERT4Rec), then gradients vs float64.
        tb = RECSYS_TRAIN_BATCH[arch]
        rec["train"] = fit_steps(
            model, lambda p, bt: loss(p, bt, cfg),
            lambda j: synth.recsys_batch(make_generator(seed + 2000 + j, DEVICE), cfg, tb, train=True),
            RECSYS_STEPS, tb)
        torch.cuda.empty_cache()
        rec["grads_float64"] = loss_grads_vs_float64(model, lambda p, bt: loss(p, bt, cfg),
                                                     synth.recsys_batch(gen, cfg, RECSYS_GRAD_BATCH, train=True))
        del model
        torch.cuda.empty_cache()
        emit({"phase": "recsys", **rec})
        out[arch] = rec
    return out


def phase_models_nccl(seed: int) -> dict:
    """The sharded forms on one NCCL rank over a (1, 1) ("data", "model")
    DeviceMesh: sharded_lookup of FM's table, sharded retrieval_topk over
    its 1M candidates, and gat_forward_partitioned on full_graph_sm, each
    against its unsharded call."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data import synth
    from repro_torch.data.graphs import partition_edges_by_dst
    from repro_torch.data.pointclouds import make_generator
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as R
    from repro_torch.models.embeddings import lookup, sharded_lookup
    from repro_torch.models.retrieval import retrieval_topk
    from repro_torch.sharding.axes import MeshRules

    backend = "nccl" if DEVICE == "cuda" else "gloo"
    out = {"phase": "models_nccl", "process_group": backend, "ranks": 1}
    gen = make_generator(seed + 70, DEVICE)
    fm_cfg = model_config("fm")
    fm = R.fm_init(gen, fm_cfg)
    ids = R._fm_ids(synth.recsys_batch(gen, fm_cfg, RECSYS_SERVE_BATCH, train=False), fm_cfg)
    cands = R.fm_candidate_table(fm, fm_cfg, cell_dims("fm")["retrieval_cand"]["n_candidates"])
    queries = torch.randn((4, fm_cfg.embed_dim), generator=gen, device=DEVICE)
    gcfg = model_config(GNN_ARCH)
    d = cell_dims(GNN_ARCH)["full_graph_sm"]
    gat = G.init_gat_params(gen, gcfg, d["d_feat"], gcfg.n_classes)
    graph = synth.gnn_batch(gen, gcfg, n_nodes=d["n_nodes"], n_edges=d["n_edges"], d_feat=d["d_feat"],
                            n_classes=gcfg.n_classes)
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        dist.init_process_group(backend, store=dist.FileStore(f"{tmp}/store", 1), rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=600),
                                device_id=torch.device(DEVICE, 0) if DEVICE == "cuda" else None)
        try:
            mesh = init_device_mesh(DEVICE, (1, 1), mesh_dim_names=("data", "model"))
            rules = MeshRules(batch=("data",), model="model", mesh=mesh)
            got = sharded_lookup(fm.embed, ids, rules, vocab=sum(fm_cfg.vocab_sizes))
            out["sharded_lookup"] = {"shape": list(got.shape), "bitwise": torch.equal(got, lookup(fm.embed, ids))}
            assert out["sharded_lookup"]["bitwise"], out
            out["retrieval"] = {}
            for metric in ("dot", "l2"):
                sh = retrieval_topk(cands, queries, K_RETRIEVAL, metric=metric, rules=rules)
                one = retrieval_topk(cands, queries, K_RETRIEVAL, metric=metric)
                r = {"ids_equal": torch.equal(sh.ids, one.ids),
                     "max_abs_err": float((sh.scores - one.scores).abs().max())}
                assert r["ids_equal"] and r["max_abs_err"] <= 2e-5 + 2e-4 * float(one.scores.abs().max()), r
                out["retrieval"][metric] = r
            host = {k: graph[k].cpu().numpy() for k in ("edge_src", "edge_dst", "edge_mask")}
            src, dst, msk, n_pad = partition_edges_by_dst(host["edge_src"], host["edge_dst"], host["edge_mask"],
                                                          d["n_nodes"], 1)
            assert n_pad == d["n_nodes"]
            part = {"feats": graph["feats"], "edge_src": torch.from_numpy(src).to(DEVICE),
                    "edge_dst": torch.from_numpy(dst).to(DEVICE), "edge_mask": torch.from_numpy(msk).to(DEVICE)}
            got = G.gat_forward_partitioned(gat, part, gcfg, rules)
            want = G.gat_forward(gat, graph, gcfg)
            excess = (got - want).abs() - (2e-5 + 2e-4 * want.abs())
            out["gat_partitioned"] = {"max_abs_err": float((got - want).abs().max()),
                                      "within_rtol_2e-4_atol_2e-5": bool((excess <= 0).all()),
                                      "edges": int(src.shape[0])}
            assert out["gat_partitioned"]["within_rtol_2e-4_atol_2e-5"], out
        finally:
            dist.destroy_process_group()
    del fm, cands
    torch.cuda.empty_cache()
    emit(out)
    return out


def phase_models_launcher() -> dict:
    """``python -m repro_torch.launch.train --arch gat-cora --steps 4`` and
    ``--arch dien --steps 4`` on the card, two subprocesses at once."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    procs = {a: subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", "--arch", a, "--steps", "4"],
                                 cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for a in (GNN_ARCH, "dien")}
    out = {"phase": "models_launcher", "runs": {}}
    try:
        for a, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            out["runs"][a] = {"returncode": proc.returncode, "stdout": stdout.strip().splitlines()[-3:]}
            assert proc.returncode == 0 and "[train] done" in stdout and "device=cuda" in stdout, (a, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    out["wall_s"] = time.perf_counter() - t0
    emit(out)
    return out


def held_summary(path: str, scans: list) -> dict:
    """One path's wrapper calls held to the plain version: how many, the
    worst |Δ|, the tightest tolerance any of them was held to and, where the
    tolerance is per entry, the largest |Δ| / tolerance."""
    out = {"path": path, "calls": len(scans), "max_abs_err": max(r["max_abs_err"] for r in scans),
           "min_tol": min(r["tol"] for r in scans)}
    if "max_ratio" in scans[0]:
        out["max_ratio"] = max(r["max_ratio"] for r in scans)
    return out


def kernel_entry(name, route, source, replaces, launches, max_err, rows, held=()) -> dict:
    main_row = rows[0]
    return {"name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max([max_err] + [r["max_abs_err"] for r in rows] + [h["max_abs_err"] for h in held]),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": main_row["library_ms"],
            "shape": main_row["shape"], "shapes": rows, "held_on_paths": list(held)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gloo-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--gloo-root", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.gloo_rank is not None:  # one rank of phase 6d's gloo group
        print(json.dumps(gloo_prohd_rank(args.seed, args.gloo_rank, args.gloo_root)), flush=True)
        return 0
    from repro_torch.kernels.hausdorff import batched as KB
    from repro_torch.kernels.hausdorff import hausdorff as K

    t_start = time.perf_counter()
    env = phase_env()
    phase_build()
    max_err = phase_kernel_vs_plain(args.seed)
    max_err2 = phase_batched_vs_plain(args.seed)
    max_err3 = phase_multiquery_vs_plain(args.seed)
    max_err4 = phase_flash_vs_plain(args.seed)

    # Main path 1: the pairwise front door (exact, ProHD, variants).
    zero_counts()
    t0 = time.perf_counter()
    a, b, h, scale, exact_err = phase_exact(args.seed)
    launches_exact = K.fused_minscan.launches
    prohd_out = phase_prohd(args.seed, a, b, h, scale)
    launches_prohd = K.fused_minscan.launches - launches_exact
    phase_variants(args.seed)
    pair_launches = K.fused_minscan.launches
    assert launches_exact > 0 and launches_prohd > 0, (launches_exact, launches_prohd)
    assert KB.batched_minscan.launches == 0 and KB.multiquery_minscan.launches == 0, counts()
    emit({"phase": "main_path", "path": "set_distance", "launches": pair_launches,
          "exact_launches": launches_exact, "prohd_launches": launches_prohd,
          "wall_s": time.perf_counter() - t0})

    # Main paths 1b and 1c: set_distance's randomised cells, the drift monitor.
    side_launches = {}
    for path, run in (("methods", lambda: phase_methods(args.seed, a, b, h, scale, prohd_out)),
                      ("drift", lambda: phase_drift(args.seed))):
        zero_counts()
        t0 = time.perf_counter()
        run()
        side_launches[path] = counts()
        assert side_launches[path]["fused_minscan"] > 0, (path, side_launches[path])
        assert sum(side_launches[path].values()) == side_launches[path]["fused_minscan"], side_launches[path]
        emit({"phase": "main_path", "path": path, "launches": side_launches[path],
              "wall_s": time.perf_counter() - t0})

    # Main path 1d: the distributed backend, one NCCL rank (ProHD, the ring).
    zero_counts()
    t0 = time.perf_counter()
    phase_distributed(args.seed, a, b, h)
    dist_launches = counts()
    assert dist_launches["fused_minscan"] > 0, dist_launches
    assert sum(dist_launches.values()) == dist_launches["fused_minscan"], dist_launches
    emit({"phase": "main_path", "path": "distributed", "launches": dist_launches,
          "wall_s": time.perf_counter() - t0})
    del a, b
    torch.cuda.empty_cache()

    # Main path 2: the corpus search.
    zero_counts()
    t0 = time.perf_counter()
    corpus = phase_search(args.seed)
    search_launches = counts()
    assert search_launches["batched_minscan"] > 0 and search_launches["fused_minscan"] > 0, search_launches
    assert search_launches["multiquery_minscan"] == 0, search_launches
    emit({"phase": "search", **corpus["runs"]})
    emit({"phase": "main_path", "path": "search", "launches": search_launches,
          "wall_s": time.perf_counter() - t0})

    # Main path 3: search_batch (16,384 sets, then directed / anytime at 2,048).
    zero_counts()
    t0 = time.perf_counter()
    batch = phase_search_batch(args.seed, corpus)
    phase_search_batch_small(args.seed, corpus)
    batch_launches = counts()
    assert batch_launches["multiquery_minscan"] > 0, batch_launches
    emit({"phase": "main_path", "path": "search_batch", "launches": batch_launches,
          "wall_s": time.perf_counter() - t0})

    # Main path 3b: search and search_batch with shards=1 over the same store.
    zero_counts()
    t0 = time.perf_counter()
    phase_sharded(corpus, batch)
    shard_launches = counts()
    assert all(shard_launches[k] > 0 for k in ("fused_minscan", "batched_minscan", "multiquery_minscan")), \
        shard_launches
    emit({"phase": "main_path", "path": "sharded", "launches": shard_launches,
          "wall_s": time.perf_counter() - t0})

    # Main path 4: the serving layer (QueryEngine search, ProHDService pairwise).
    zero_counts()
    t0 = time.perf_counter()
    served = phase_served(args.seed, corpus, batch)
    serve_launches = counts()
    assert serve_launches["multiquery_minscan"] > 0 and serve_launches["batched_minscan"] > 0, serve_launches
    emit({"phase": "main_path", "path": "serve", "launches": serve_launches, "by_request": served["launches"],
          "wall_s": time.perf_counter() - t0})

    # Phase 11b: the rest of obs (JSONL export, report, the profiler bridge).
    phase_obs(args.seed, corpus)

    rows = phase_times(args.seed, env)
    # Phase 7b: the paper's exact baselines (two-sweep: two kernel-1 launches).
    baselines = phase_baselines(args.seed, env)
    rows2 = phase_times_batched(corpus, env)
    rows3 = phase_times_multiquery(corpus, batch, env)
    held2, held3 = (corpus["held"], served["held"]), (batch["held"],)
    del corpus, batch
    torch.cuda.empty_cache()

    # Main path 5: LM serving, TinyLlama-1.1B prefill and decode (counted
    # per prefill_step call and over the decode loop inside phase_lm).
    t0 = time.perf_counter()
    lm = phase_lm(args.seed)
    # TinyLlama's bf16 prefills (the windowed one included) went through the
    # tensor-core route, the fp32 smoke config's through the FFMA route.
    smoke_n = lm["smoke"]["launches"]
    assert smoke_n == 2, lm["smoke"]
    assert lm["route_launches"] == {"wgmma": lm["launches"] - smoke_n, "ffma": smoke_n}, lm["route_launches"]
    emit({"phase": "main_path", "path": "lm_serve", "launches": {"flash_fwd": lm["launches"]},
          "route_launches": lm["route_launches"], "wall_s": time.perf_counter() - t0})
    # Main path 6: MoE LM serving, OLMoE-1B-7B prefill and decode, then Grok-1's
    # smoke config (counted per prefill_step call and over the decode loop).
    t0 = time.perf_counter()
    moe = phase_moe(args.seed)
    smoke_n = moe["smoke"]["launches"]
    assert smoke_n == 2, moe["smoke"]
    assert moe["route_launches"] == {"wgmma": moe["launches"] - smoke_n, "ffma": smoke_n}, moe["route_launches"]
    emit({"phase": "main_path", "path": "moe_serve", "launches": {"flash_fwd": moe["launches"]},
          "route_launches": moe["route_launches"], "wall_s": time.perf_counter() - t0})
    rows4 = phase_times_flash(args.seed, env)
    # Phase 16: training.  Kernel 4 under autograd (comparison launches, not
    # counted), then main path 7: TinyLlama-1.1B through fit (counted inside
    # phase_train around the fit call), then the launcher in a subprocess.
    attn_grad = phase_attn_grad(args.seed)
    t0 = time.perf_counter()
    train = phase_train(args.seed, env)
    emit({"phase": "main_path", "path": "train", "launches": train["launches"],
          "route_launches": train["route_launches"], "wall_s": time.perf_counter() - t0})
    phase_train_launcher()
    # Phases 17 and 18: GNN and recsys (no kernel on their path: each main
    # path runs with the counters at 0 and must leave them there).
    for path, run in (("gnn", phase_gnn), ("recsys", phase_recsys), ("models_nccl", phase_models_nccl)):
        zero_counts()
        t0 = time.perf_counter()
        run(args.seed)
        n = counts()
        assert not any(n.values()), (path, n)
        emit({"phase": "main_path", "path": path, "launches": n, "wall_s": time.perf_counter() - t0})
    phase_models_launcher()

    def total(name):
        return sum(c[name] for c in (search_launches, batch_launches, shard_launches, serve_launches))

    emit({"kernels": [
        kernel_entry("fused_minscan", "cuda", KERNEL_SOURCE, TPU_KERNEL,
                     pair_launches + total("fused_minscan") + dist_launches["fused_minscan"]
                     + sum(c["fused_minscan"] for c in side_launches.values())
                     + baselines["twosweep"]["launches"] + train["launches"]["fused_minscan"],
                     max(max_err, exact_err), rows),
        kernel_entry("batched_minscan", "cuda", KERNEL2_SOURCE, TPU_KERNEL2,
                     total("batched_minscan"), max_err2, rows2, held2),
        kernel_entry("multiquery_minscan", "cuda", KERNEL3_SOURCE, TPU_KERNEL3,
                     total("multiquery_minscan"), max_err3, rows3, held3),
        {**kernel_entry("flash_fwd", "cuda", KERNEL4_SOURCE, TPU_KERNEL4,
                        lm["launches"] + moe["launches"] + train["launches"]["flash_fwd"],
                        max([max_err4] + [r["forward"]["max_abs_err"] for r in attn_grad["cases"]]),
                        rows4, (lm["held"], moe["held"])),
         "routes": {"wgmma": {"dtype": "bfloat16", "source": KERNEL4_SOURCE, "replaces": TPU_KERNEL4,
                              "launches": lm["route_launches"]["wgmma"] + moe["route_launches"]["wgmma"]
                              + train["route_launches"]["wgmma"]},
                    "ffma": {"dtype": "float32", "source": KERNEL4_FP32_SOURCE, "replaces": TPU_KERNEL4,
                             "launches": lm["route_launches"]["ffma"] + moe["route_launches"]["ffma"]
                             + train["route_launches"]["ffma"]}}},
    ]})
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    print(smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
