"""Multi-pod dry run: every (architecture × shape × mesh) cell traced once.

Counterpart of ``repro/launch/dryrun.py``.  The reference compiles each
cell's step with ``jax.jit(...).lower().compile()`` on 256 or 512 host
devices and reads ``memory_analysis()`` and ``cost_analysis()``.  The port
makes a ``fake`` process group of the mesh's size (this process is rank 0;
collectives move nothing), builds the cell's arguments as fake DTensors
(``launch.specs.build_cell``: no memory), and runs the step once under
three counters, all per device over rank 0's local shards:

  * FLOPs (``analysis.roofline.count_flops``; kernel 4's fake op counts
    4·hd per visible (query, key) pair);
  * every collective, with its wire bytes and group
    (``analysis.roofline.count_collectives``);
  * memory (``torch.distributed._tools.mem_tracker.MemTracker``): the
    arguments' bytes and the step's peak.

With ``--device cuda`` (the default) the fake tensors are the card's, so
the trace is the card's program and reaches kernel 4's fake; ``--device
cpu`` traces the CPU's (the plain attention), for tests.  No device is
touched either way.  Each cell writes one JSON record with the
reference's keys (``status``, the costs, ``memory``, the ``roofline``
summary, ``n_devices``, ``total_s``).  A step that hits an op DTensor
cannot place ends ``status: "error"`` with the op's name; only the
reference's ``SkippedCell`` reasons skip.

Usage:
    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes [--jobs 8] [--device cpu]
    python -m repro_torch.analysis.report results/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

DEFAULT_OUT = Path("results/dryrun_torch")
GIB = 1 << 30


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _locals(tree) -> list:
    """Every tensor of ``tree`` (a module, dicts, tuples), DTensors as their
    local blocks."""
    import torch
    from torch.distributed.tensor import DTensor

    if isinstance(tree, torch.nn.Module):
        return _locals([p for p in tree.parameters()])
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _locals(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _locals(v)]
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    return []


def _bytes(tensors) -> int:
    """The bytes of the distinct storages behind ``tensors``."""
    storages = {id(t.untyped_storage()): t.untyped_storage().nbytes() for t in tensors}
    return sum(storages.values())


def trace_cell(built, device_spec=None) -> dict:
    """Run ``built``'s step once on its fake arguments under the three
    counters; the record's measured fields."""
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.analysis import roofline

    device_spec = device_spec or roofline.H100_SXM
    args_local = _locals(built.args)
    arg_bytes = _bytes(args_local)
    mt = MemTracker()
    mt.track_external(*args_local)
    t0 = time.time()
    with built.fake_mode, roofline.local_ops_only():
        flops = roofline.count_flops()
        colls = roofline.count_collectives()
        with mt, flops, colls:
            out = built.wrapped_fn()(*built.args)
    trace_s = time.time() - t0
    snapshot = mt.get_tracker_snapshot("peak")
    dev = max(snapshot, key=lambda d: snapshot[d].get("Total", 0))
    peak = snapshot[dev].get("Total", 0)
    by_kind = {getattr(k, "value", str(k)): v for k, v in snapshot[dev].items() if k != "Total"}
    out_bytes = _bytes([t for t in _locals(out) if isinstance(t, torch.Tensor)])
    stats = colls.stats
    rf = roofline.Roofline(flops_per_device=float(flops.total), bytes_per_device=built.model_bytes,
                           wire_bytes_per_device=stats.wire_bytes, collectives_by_op=stats.by_op,
                           model_flops=built.model_flops, n_devices=built.rules.mesh.size(), device=device_spec,
                           wire_seconds=stats.wire_seconds)
    summary = rf.summary()
    summary["flops_by_op"] = flops.by_op
    return {
        "compile_s": trace_s,
        "memory": {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": max(peak - arg_bytes, 0), "peak_bytes": peak,
                   "peak_by_kind": by_kind},
        "analytic_peak_bytes": built.analytic_peak_bytes,
        "device_bytes": device_spec.hbm_bytes,
        "device": device_spec.name,
        "microbatches": built.microbatches,
        "roofline": summary,
        "n_devices": built.rules.mesh.size(),
    }


def run_cell(arch_id: str, shape: str, multi_pod: bool, out_dir: Path | None, variant: str = "baseline", *,
             device: str = "cuda", device_spec=None) -> dict:
    """One cell on a production mesh: build, trace, and (with ``out_dir``)
    write its record."""
    from repro_torch.analysis import roofline
    from repro_torch.configs.base import load_arch
    from repro_torch.launch.mesh import fake_process_group, make_production_mesh
    from repro_torch.launch.specs import REFERENCE_BUDGET, SkippedCell, build_cell

    device_spec = device_spec or roofline.H100_SXM
    mname = mesh_name(multi_pod)
    record = {"arch": arch_id, "shape": shape, "mesh": mname, "status": "?", "variant": variant, "device_type": device}
    t_start = time.time()
    try:
        with fake_process_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
            spec = load_arch(arch_id)
            cells = [c for c in spec.shapes if c.name == shape]
            if not cells:
                raise KeyError(f"{arch_id} has no shape {shape}")
            built = build_cell(spec, cells[0], mesh, variant, device=device,
                               budget_bytes=device_spec.hbm_bytes * REFERENCE_BUDGET / (16 * GIB))
            record["lower_s"] = time.time() - t_start
            record.update(trace_cell(built, device_spec), status="ok")
        rf = record["roofline"]
        print(f"[{arch_id}/{shape}/{mname}] flops/dev={rf['flops_per_device']:.3e} model_flops={rf['model_flops']:.3e} "
              f"wire/dev={rf['wire_bytes_per_device']:.3e} peak={record['memory']['peak_bytes'] / GIB:.2f}GiB "
              f"analytic={record['analytic_peak_bytes'] / GIB:.2f}GiB bottleneck={rf['bottleneck']}", flush=True)
    except SkippedCell as e:
        record.update(status="skipped", reason=str(e))
        print(f"[{arch_id}/{shape}/{mname}] SKIPPED: {e}", flush=True)
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        record.update(status="error", error=f"{type(e).__name__}: {e}"[:2000],
                      traceback=traceback.format_exc()[-4000:])
        print(f"[{arch_id}/{shape}/{mname}] ERROR: {type(e).__name__}: {str(e)[:400]}", flush=True)
    record["total_s"] = time.time() - t_start
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        suffix = "" if variant == "baseline" else f"__{variant}"
        (out_dir / f"{arch_id}__{shape}__{mname}{suffix}.json").write_text(json.dumps(record, indent=1, default=str))
    return record


def all_cells():
    from repro_torch.configs.base import arch_ids, load_arch

    for aid in arch_ids():
        for cell in load_arch(aid).shapes:
            yield aid, cell.name


def _cost(task) -> tuple:
    """Longest first: LM training, then the other LM cells, by parameter count."""
    from repro_torch.configs.base import load_arch

    aid, shape, mp = task
    cfg = load_arch(aid).config
    lm = cfg.family == "lm"
    return (not (lm and shape.startswith("train")), not lm, -(cfg.params_billions() if lm else 0.0), not mp)


def _pool_cell(task) -> dict:
    aid, shape, mp, out_dir, variant, device, spec = task
    from repro_torch.analysis.roofline import DeviceSpec

    return run_cell(aid, shape, mp, Path(out_dir), variant, device=device, device_spec=DeviceSpec(**spec))


def run_all(multi_pod_values, out_dir: Path, jobs: int, only_missing: bool, *, device: str = "cuda",
            variant: str = "baseline", device_spec=None) -> list[dict]:
    """Every cell on each mesh, ``jobs`` worker processes at a time (each
    cell is isolated in its own fake process group; a failing cell is an
    ``error`` record, not the sweep's end), longest cells first.  Returns
    the records."""
    import dataclasses
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.analysis import roofline

    device_spec = device_spec or roofline.H100_SXM
    suffix = "" if variant == "baseline" else f"__{variant}"
    tasks = []
    for mp in multi_pod_values:
        for aid, shape in all_cells():
            path = out_dir / f"{aid}__{shape}__{mesh_name(mp)}{suffix}.json"
            if only_missing and path.exists() and json.loads(path.read_text()).get("status") in ("ok", "skipped"):
                continue
            tasks.append((aid, shape, mp))
    tasks.sort(key=_cost)
    print(f"dry-run: {len(tasks)} cells to run, jobs={jobs}", flush=True)
    spec = dataclasses.asdict(device_spec)
    with ProcessPoolExecutor(max_workers=jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(_pool_cell, [(a, s, mp, str(out_dir), variant, device, spec) for a, s, mp in tasks]))


def _device_spec(device: str):
    """The card's own rates when the fake tensors are the card's and a card
    is present, else the published ones (``roofline.H100_SXM``)."""
    import torch

    from repro_torch.analysis import roofline

    if device == "cuda" and torch.cuda.is_available():
        return roofline.DeviceSpec.from_card()
    return roofline.H100_SXM


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--only-missing", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device type of the fake tensors (nothing runs on it)")
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = ap.parse_args()

    if args.all:
        mps = [False, True] if args.both_meshes else [args.multi_pod]
        recs = run_all(mps, args.out, args.jobs, args.only_missing, device=args.device, variant=args.variant,
                       device_spec=_device_spec(args.device))
        sys.exit(1 if any(r["status"] not in ("ok", "skipped") for r in recs) else 0)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    rec = run_cell(args.arch, args.shape, args.multi_pod, args.out, args.variant, device=args.device,
                   device_spec=_device_spec(args.device))
    sys.exit(0 if rec["status"] in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
