"""Which tensors hold a dry-run cell's traced peak.

Builds one cell as ``python -m repro_torch.launch.dryrun`` does (a ``fake``
process group of the production mesh's size, fake tensors of the card's
type) and runs its step once under a dispatch mode that keeps every live
storage the step allocates (DTensors as their local tensors; not the
global-shape fakes of DTensor's sharding propagation), labelled by
the op that made it, the phase (forward or backward) and its shape and
dtype.  It snapshots the live set at the largest total of each stage of
the step (the forward, the backward, and what follows the backward: the
optimizer) and prints, per stage, that peak (the step's allocations,
without its arguments) and the labels that hold most of it, one JSON
object per line.

    python3 scripts/dryrun_census.py --arch grok-1-314b --shape train_4k [--multi-pod]
        [--layers N] [--device cuda|cpu] [--upcast-saved] [--top 25]

``--layers`` cuts the depth; ``--upcast-saved`` runs the wide contractions
as autograd through their upcast (the fp32 copies saved), for a before and
after.  ``--device cpu`` traces the CPU's program (attention as the plain
recurrence); the card's needs a CUDA build of torch.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import threading
import time
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

GIB = 2 ** 30


STAGES = ("forward", "backward", "after backward")


class _Depth(threading.local):
    depth = 0  # per thread: a CUDA backward runs on the autograd engine's own thread


_PROPAGATING = _Depth()


def _skip_sharding_propagation() -> None:
    """DTensor's sharding propagation runs each new op on fakes of the
    global shapes to learn its output's metadata: no rank holds those.
    Mark the thread while it runs, so the census leaves them out."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    real = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, *args, **kwargs):
        _PROPAGATING.depth += 1
        try:
            return real(self, *args, **kwargs)
        finally:
            _PROPAGATING.depth -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = marked


class Census(TorchDispatchMode):
    """Live storages by label; per stage, the live set at its largest total."""

    def __init__(self, snap_step: float = 0.25 * GIB):
        super().__init__()
        self.live: dict[int, tuple[int, str]] = {}
        self.cur = 0
        self.stage = 0
        self.snap_step = snap_step
        self.peak = dict.fromkeys(STAGES, 0)
        self.snap_at = dict.fromkeys(STAGES, 0.0)
        self.at_peak: dict = {s: {} for s in STAGES}

    def _free(self, key: int) -> None:
        nbytes, _ = self.live.pop(key, (0, ""))
        self.cur -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs first and comes back with its local ops
        out = func(*args, **(kwargs or {}))
        in_backward = torch._C._current_graph_task_id() != -1
        if in_backward or self.stage == 1:
            self.stage = 1 if in_backward else 2
        phase = "backward" if in_backward else "forward"
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or _PROPAGATING.depth:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                continue
            nbytes = st.nbytes()
            self.live[key] = (nbytes, f"{phase} {func} {tuple(t.shape)} {t.dtype}")
            self.cur += nbytes
            weakref.finalize(st, self._free, key)
        stage = STAGES[self.stage]
        if self.cur > self.peak[stage]:
            self.peak[stage] = self.cur
            if self.cur >= self.snap_at[stage] + self.snap_step:
                self.snap_at[stage] = self.cur
                self.at_peak[stage] = dict(self.live)
        return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--upcast-saved", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    from repro_torch.analysis import roofline
    from repro_torch.configs.base import load_arch
    from repro_torch.launch.mesh import fake_process_group, make_production_mesh
    from repro_torch.launch.specs import REFERENCE_BUDGET, build_cell

    _skip_sharding_propagation()
    if args.upcast_saved:
        import chip_smoke

        chip_smoke.upcast_saved().__enter__()
    spec = load_arch(args.arch)
    if args.layers:
        spec = dataclasses.replace(spec, config=dataclasses.replace(spec.config, n_layers=args.layers))
    cell = next(c for c in spec.shapes if c.name == args.shape)
    t0 = time.time()
    with fake_process_group(512 if args.multi_pod else 256):
        mesh = make_production_mesh(multi_pod=args.multi_pod, device_type=args.device)
        built = build_cell(spec, cell, mesh, device=args.device,
                           budget_bytes=roofline.H100_SXM.hbm_bytes * REFERENCE_BUDGET / (16 * GIB))
        census = Census()
        with built.fake_mode, census:
            built.wrapped_fn()(*built.args)
    print(json.dumps({"arch": args.arch, "shape": args.shape, "multi_pod": args.multi_pod,
                      "layers": spec.config.n_layers, "upcast_saved": args.upcast_saved,
                      "microbatches": built.microbatches, "argument_gib": _arg_bytes(built.args) / GIB,
                      "seconds": time.time() - t0}), flush=True)
    for stage in STAGES:
        groups = collections.defaultdict(lambda: [0, 0])
        for nbytes, label in census.at_peak[stage].values():
            groups[label][0] += nbytes
            groups[label][1] += 1
        print(json.dumps({"stage": stage, "peak_gib": census.peak[stage] / GIB,
                          "snapshot_gib": sum(b for b, _ in census.at_peak[stage].values()) / GIB}), flush=True)
        for label, (nbytes, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:args.top]:
            print(json.dumps({"stage": stage, "gib": nbytes / GIB, "count": n, "label": label}), flush=True)


def _arg_bytes(args) -> int:
    """The bytes of the step's arguments' local storages."""
    storages = {}
    for t in tree_leaves(args):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            storages[t.untyped_storage()._cdata] = t.untyped_storage().nbytes()
    return sum(storages.values())


if __name__ == "__main__":
    main()
