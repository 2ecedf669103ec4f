"""Aggregate the dry run's JSON records into the dry-run and roofline tables.

Counterpart of ``repro/analysis/report.py``: the same tables from the
port's records (``launch.dryrun``), under the reference's mesh names
(``pod16x16``, ``pod2x16x16``).  The notes speak of the card.

    PYTHONPATH=src python -m repro_torch.analysis.report results/dryrun_torch
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

GB = 1 << 30

# one-sentence improvement note per (family-ish key, bottleneck)
NOTES = {
    ("lm-train", "collective"): "shrink TP degree / move the model axis to batch duty for small models; overlap FSDP gathers with layer compute; keep the TP region's gathers on bf16",
    ("lm-train", "compute"): "near roofline for compute; next: a backward attention kernel in place of the plain recomputing backward",
    ("lm-train", "memory"): "the plain attention backward holds chunk scores in HBM: a fused backward kernel keeps them on chip",
    ("lm-prefill", "memory"): "kernel 4 keeps the scores on chip; what is left is weights and activations: fuse the norms into the projections",
    ("lm-prefill", "compute"): "compute-bound as expected for 32k prefill: kernel 4's share is the attention half",
    ("lm-prefill", "collective"): "sequence-parallel prefill: keep S sharded through attention (ring exchange) instead of gathering it",
    ("lm-decode", "memory"): "weight-read bound (expected): int8 or fp8 weights, or a larger decode batch, amortise reads",
    ("lm-decode", "collective"): "split-KV combine is small; the logits gather for sampling dominates: sample from the vocab shards",
    ("lm-decode", "compute"): "unexpected for decode: check the attention FLOPs",
    ("gnn", "collective"): "node-partial all-reduces dominate: partition the graph so edges stay rank-local, or reduce-scatter node accumulators",
    ("gnn", "memory"): "edge gather/scatter traffic: fuse SDDMM + softmax + SpMM into one segment kernel",
    ("gnn", "compute"): "dense projections dominate: fine",
    ("recsys-train", "memory"): "dense AdamW over the full table each step: switch to a lazy, rows-touched sparse optimizer",
    ("recsys-train", "collective"): "embedding all-reduce over model: route ids to their shard (all-to-all) instead of a masked all-reduce",
    ("recsys-serve", "memory"): "gathers dominate: keep hot rows resident in L2 or shared memory",
    ("recsys-serve", "collective"): "embedding all-reduce: route ids with all-to-all",
    ("recsys-retrieval", "collective"): "resharding the candidate table model->batch each call: keep a sharded candidate matrix ready",
    ("recsys-retrieval", "compute"): "matvec-bound as designed",
    ("recsys-retrieval", "memory"): "candidate streaming is the floor; quantize candidates to int8",
}


def _family_key(arch: str, shape: str) -> str:
    if arch in ("gat-cora",):
        return "gnn"
    if arch in ("dien", "bert4rec", "bst", "fm"):
        if shape == "train_batch":
            return "recsys-train"
        if shape == "retrieval_cand":
            return "recsys-retrieval"
        return "recsys-serve"
    if shape.startswith("train"):
        return "lm-train"
    if shape.startswith("prefill"):
        return "lm-prefill"
    return "lm-decode"


def load_records(out_dir: Path, *, variants: bool = False) -> list[dict]:
    recs = []
    for f in sorted(out_dir.glob("*.json")):
        r = json.loads(f.read_text())
        is_variant = r.get("variant", "baseline") != "baseline"
        if is_variant == variants:
            recs.append(r)
    return recs


def variants_table(out_dir: Path) -> str:
    """§Perf A/B: baseline vs hillclimb-variant roofline terms."""
    base = {(r["arch"], r["shape"], r["mesh"]): r for r in load_records(out_dir)}
    lines = [
        "| arch | shape | variant | dominant term: before → after | wire GB/dev: before → after |",
        "|---|---|---|---|---|",
    ]
    for r in load_records(out_dir, variants=True):
        if r["status"] != "ok":
            continue
        b = base.get((r["arch"], r["shape"], r["mesh"]))
        if not b or b["status"] != "ok":
            continue
        rb, rv = b["roofline"], r["roofline"]
        tb = max(rb["t_compute_s"], rb["t_memory_s"], rb["t_collective_s"])
        tv = max(rv["t_compute_s"], rv["t_memory_s"], rv["t_collective_s"])
        lines.append(
            "| {a} | {s} | {v} | {b0:.1f} ms ({bb}) → {v0:.1f} ms ({vb}) = {x:.2f}× | {wb:.2f} → {wv:.2f} |".format(
                a=r["arch"], s=r["shape"], v=r["variant"],
                b0=tb * 1e3, bb=rb["bottleneck"], v0=tv * 1e3, vb=rv["bottleneck"],
                x=tb / tv if tv else float("inf"),
                wb=rb["wire_bytes_per_device"] / GB, wv=rv["wire_bytes_per_device"] / GB,
            )
        )
    return "\n".join(lines)


def dryrun_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | compile (s) | args GB/dev | temp GB/dev | wire GB/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP ({r['reason'][:40]}…) | — | — | — | — |"
            )
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | **ERROR** | — | — | — | — |")
            continue
        mem = r.get("memory", {})
        rf = r["roofline"]
        lines.append(
            "| {arch} | {shape} | {mesh} | ok | {c:.0f} | {a:.2f} | {t:.2f} | {w:.3f} |".format(
                arch=r["arch"], shape=r["shape"], mesh=r["mesh"], c=r.get("compile_s", 0),
                a=mem.get("argument_size_in_bytes", 0) / GB,
                t=mem.get("temp_size_in_bytes", 0) / GB,
                w=rf["wire_bytes_per_device"] / GB,
            )
        )
    return "\n".join(lines)


def roofline_table(recs: list[dict], mesh: str = "pod16x16") -> str:
    lines = [
        "| arch | shape | t_comp (ms) | t_mem (ms) | t_coll (ms) | bottleneck | MODEL_FLOPS | useful | MFU bound |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh or r["status"] != "ok":
            continue
        rf = r["roofline"]
        note_key = (_family_key(r["arch"], r["shape"]), rf["bottleneck"])
        lines.append(
            "| {arch} | {shape} | {tc:.2f} | {tm:.2f} | {tl:.2f} | **{b}** | {mf:.2e} | {u:.3f} | {mfu:.1%} |".format(
                arch=r["arch"], shape=r["shape"],
                tc=rf["t_compute_s"] * 1e3, tm=rf["t_memory_s"] * 1e3,
                tl=rf["t_collective_s"] * 1e3, b=rf["bottleneck"],
                mf=rf["model_flops"], u=rf["useful_flops_fraction"],
                mfu=rf["mfu_bound"],
            )
        )
    return "\n".join(lines)


def notes_table(recs: list[dict], mesh: str = "pod16x16") -> str:
    lines = ["| arch | shape | bottleneck | what would move it down |", "|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh or r["status"] != "ok":
            continue
        b = r["roofline"]["bottleneck"]
        note = NOTES.get((_family_key(r["arch"], r["shape"]), b), "—")
        lines.append(f"| {r['arch']} | {r['shape']} | {b} | {note} |")
    return "\n".join(lines)


def summarize(out_dir: Path) -> str:
    recs = load_records(out_dir)
    ok = sum(1 for r in recs if r["status"] == "ok")
    skip = sum(1 for r in recs if r["status"] == "skipped")
    err = sum(1 for r in recs if r["status"] not in ("ok", "skipped"))
    parts = [
        f"records: {len(recs)} (ok={ok} skipped={skip} error={err})",
        "",
        "## Dry-run",
        dryrun_table(recs),
        "",
        "## Roofline (single-pod 16x16)",
        roofline_table(recs),
        "",
        "## Bottleneck notes",
        notes_table(recs),
        "",
        "## Perf variants (A/B)",
        variants_table(out_dir),
    ]
    return "\n".join(parts)


if __name__ == "__main__":
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else Path("results/dryrun_torch")
    print(summarize(out))
