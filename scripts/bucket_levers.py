#!/usr/bin/env python3
"""Time the bucket scans (kernels 2 and 3) against an earlier tree's, and what each design lever gives.

    python3 scripts/bucket_levers.py [--parent-src OLD/src] [--reps 5] [--seed 0]

Run from the repository root on a machine with one NVIDIA GPU and nvcc.
Each tree runs in a child process of its own (both packages are named
``repro_torch``), which builds that tree's kernels and times, with CUDA
events (median of ``--reps`` launches after a warm-up, outputs refilled
with +inf before each), the passes the corpus search and ``search_batch``
give the kernels on ``chip_smoke.py``'s 16,384-set corpus at D = 256:

  * kernel 2, one 128-row query against the whole cap-256, cap-128 and
    cap-64 buckets (9,780, 4,821 and 1,783 sets; sizes 136–256, 72–128 and
    48–64 in steps of 8), ungated;
  * kernel 2, a stage-2a pass: 512 lanes of the cap-256 bucket, the last
    191 gated (the pass's power-of-two padding);
  * kernel 2, a stage-1 pass: 2,048 per-lane 34-row subsets against their
    lanes' sets, and 2,048 36-row subsets against the 128-row query;
  * kernel 3, 16 queries against the whole cap-256 bucket, ungated, and 4
    queries against 6,053 sets of it with about a third of the pairs kept
    by a random gate.

The data are random rows (``torch.randn`` from ``--seed``) with the
buckets' validity pattern: a kernel's time depends on the shapes, the
valid rows and the gate, not on the values.  ``--parent-src`` (an earlier
checkout's ``src/``, e.g. from ``git archive``) runs that tree too, in the
order parent, this tree, this tree, parent, and every output of the two
trees must agree bit for bit (their kernels share the arithmetic).  This
tree is also timed under forced launch plans: the streamed instance where
the planned one keeps the query tile resident, the set order 1 where the
planned one steps through the sets, one wave of persistent CTAs where a
gated pass gets short ranges, and the directed instance (stage 1 runs it)
beside the bidirectional one.  It prints one JSON line per
measurement, then a summary, the card's name and power limit, and exits
non-zero if a tree fails or two outputs differ.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# The child: build this tree's kernels, make the passes, time them.  Reads
# {"reps", "seed", "levers"} from argv[1]; prints one JSON line per timing.
CHILD = r'''
import hashlib, json, statistics, sys
import torch
from repro_torch.kernels.hausdorff import batched as KB

spec = json.loads(sys.argv[1])
reps, levers = spec["reps"], spec["levers"]
new_api = hasattr(KB, "bucket_launch_plan")
dev = "cuda"
g = torch.Generator(device=dev).manual_seed(spec["seed"])
D = 256


def bucket(n_sets, cap, sizes):
    x = torch.randn(n_sets, cap, D, device=dev, generator=g) + 0.5
    lens = torch.tensor(sizes, device=dev)[torch.randint(0, len(sizes), (n_sets,), device=dev, generator=g)]
    valid = torch.arange(cap, device=dev)[None, :] < lens[:, None]
    x = torch.where(valid[..., None], x, torch.zeros((), device=dev)).contiguous()
    return x, torch.where(valid, (x * x).sum(-1), torch.inf)


buckets = {256: bucket(9780, 256, range(136, 257, 8)), 128: bucket(4821, 128, range(72, 129, 8)),
           64: bucket(1783, 64, range(48, 65, 8))}
q = torch.randn(128, D, device=dev, generator=g)
q2 = (q * q).sum(-1)
qs16 = torch.randn(16, 128, D, device=dev, generator=g)
q2_16 = (qs16 * qs16).sum(-1)
sms = torch.cuda.get_device_properties(0).multi_processor_count


def ms(fn):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1))
    return statistics.median(out)


def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def run(case, launcher, operands, shapes, variants):
    for variant, kw in variants.items():
        ma, mb = torch.empty(shapes[0], device=dev), torch.empty(shapes[1], device=dev)

        def call():
            ma.fill_(torch.inf)
            mb.fill_(torch.inf)
            launcher(*operands, ma, mb, **kw)

        t = ms(call)
        directed = kw.get("directed", False)
        print(json.dumps({"case": case, "variant": variant, "ms": t, "digest_a": digest(ma),
                          "digest_b": None if directed else digest(mb),
                          "min_b_inf": bool(torch.isinf(mb).all())}), flush=True)


def variants_of(plan, lb, cut, extra):
    """The planned launch and the forced ones named in ``extra``."""
    out = {"planned": dict(lb=lb, cut=cut)}
    if not (new_api and levers):
        return out
    for name in extra:
        if name == "streamed":
            out[name] = dict(lb=lb, cut=cut, plan=plan(resident=False))
        elif name == "set order 1":
            out[name] = dict(lb=lb, cut=cut, plan=plan()._replace(set_step=1))
        elif name == "one wave":  # the persistent grid an ungated pass gets
            out[name] = dict(lb=lb, cut=cut, plan=plan(gated=False))
        elif name == "directed":
            out[name] = dict(lb=lb, cut=cut, directed=True)
    return out


def k2(case, qx, q2x, slab, b2, lb=None, cut=None, shared=True, extra=()):
    n_sets = slab.shape[0]

    def plan(**kw):
        kw.setdefault("gated", lb is not None)
        return KB.bucket_launch_plan(1, n_sets, qx.shape[1], slab.shape[1], D, sms, shared_query=shared, **kw)

    run(case, KB.batched_minscan, (qx, q2x, slab, b2), ((n_sets, qx.shape[1]), (n_sets, slab.shape[1])),
        variants_of(plan, lb, cut, extra))


def k3(case, qs, q2s, slab, b2, lb=None, cut=None, extra=()):
    def plan(**kw):
        kw.setdefault("gated", lb is not None)
        return KB.bucket_launch_plan(qs.shape[0], slab.shape[0], qs.shape[1], slab.shape[1], D, sms,
                                     shared_query=True, **kw)

    shapes = ((qs.shape[0], slab.shape[0], qs.shape[1]), (qs.shape[0], slab.shape[0], slab.shape[1]))
    run(case, KB.multiquery_minscan, (qs, q2s, slab, b2), shapes, variants_of(plan, lb, cut, extra))


for cap in (256, 128, 64):
    slab, b2 = buckets[cap]
    n = slab.shape[0]
    k2(f"kernel 2, full cap-{cap} bucket", q.expand(n, 128, D), q2.expand(n, 128), slab, b2,
       extra=("streamed", "directed") if cap == 256 else ())
slab, b2 = buckets[256]
take = torch.arange(512, device=dev) % 321
lb = torch.where(torch.arange(512, device=dev) < 321, 0.0, torch.inf)
k2("kernel 2, stage-2a pass (512 lanes, 321 kept)", q.expand(512, 128, D), q2.expand(512, 128),
   slab[take].contiguous(), b2[take].contiguous(), lb, torch.ones(512, device=dev),
   extra=("set order 1", "one wave"))
sub = torch.randn(2048, 34, D, device=dev, generator=g)
k2("kernel 2, stage-1 pass (2,048 × 34-row subsets vs their sets)", sub, (sub * sub).sum(-1),
   slab[:2048], b2[:2048], shared=False, extra=("directed",))
sub = torch.randn(2048, 36, D, device=dev, generator=g)
k2("kernel 2, stage-1 pass (2,048 × 36-row subsets vs the query)", sub, (sub * sub).sum(-1),
   q.expand(2048, 128, D), q2.expand(2048, 128), shared=False, extra=("directed",))
k3("kernel 3, Q 16, full cap-256 bucket", qs16, q2_16, slab, b2, extra=("streamed", "directed"))
keep = torch.rand(4, 6053, device=dev, generator=g) < 7858 / (4 * 6053)
k3("kernel 3, Q 4, 6,053 sets, a third kept", qs16[:4].contiguous(), q2_16[:4].contiguous(),
   slab[:6053], b2[:6053], torch.where(keep, 0.0, torch.inf), torch.ones(4, 6053, device=dev),
   extra=("set order 1", "one wave"))
'''


def child(src: Path, label: str, args, levers: bool) -> list[dict]:
    spec = json.dumps({"reps": args.reps, "seed": args.seed, "levers": levers})
    env = {**os.environ, "PYTHONPATH": str(src)}
    proc = subprocess.run([sys.executable, "-c", CHILD, spec], env=env, capture_output=True, text=True,
                          timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"{label} ({src}) failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    rows = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    for r in rows:
        r["tree"] = label
        print(json.dumps(r), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-src", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    this = ROOT / "src"
    order = [("change", this)]
    if args.parent_src is not None:
        order = [("parent", args.parent_src), ("change", this), ("change", this), ("parent", args.parent_src)]
    rows = []
    for i, (label, src) in enumerate(order):
        rows += child(src, label, args, levers=label == "change" and i <= 1)
    summary, digests = {}, {}
    for r in rows:
        s = summary.setdefault(f"{r['case']} / {r['variant']}", {"parent_ms": [], "change_ms": []})
        s[f"{r['tree']}_ms"].append(r["ms"])
        d = digests.setdefault(r["case"], {"a": set(), "b": set(), "directed_min_b_inf": True})
        d["a"].add(r["digest_a"])
        if r["digest_b"] is None:
            d["directed_min_b_inf"] &= r["min_b_inf"]
        else:
            d["b"].add(r["digest_b"])
    for s in summary.values():
        if s["parent_ms"] and s["change_ms"]:
            s["change_over_parent"] = statistics.median(s["change_ms"]) / statistics.median(s["parent_ms"])
    # every tree, plan and instance gives the same row mins; every
    # bidirectional run the same column mins; the directed one leaves them +inf
    bitwise = {case: len(d["a"]) == 1 and len(d["b"]) == 1 and d["directed_min_b_inf"] for case, d in digests.items()}
    ok = all(bitwise.values())
    summary["bitwise"] = bitwise
    print(json.dumps({"summary": summary}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
