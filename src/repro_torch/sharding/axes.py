"""Logical-axis sharding rules, threaded through model code contextually.

Counterpart of ``repro/sharding/axes.py``.  Model code names the logical
axes of its tensors ("batch", "model", ...); :class:`MeshRules` maps them
to the dims of a ``torch.distributed.DeviceMesh``.  When no rules are
active, every annotation is a no-op and the same model code runs on one
device.

``MeshRules.spec(*names)`` returns a plain tuple of the resolved mesh-dim
names (a tuple of dims, one dim, or None per tensor dim): the port's
``PartitionSpec``, equal to ``tuple()`` of the reference's for the same
rules.  Nothing in the port reads a spec to place a tensor yet: the
specs document the reference's layout, which SPMD callers follow.  The port is SPMD: each rank already holds its own part of every
sharded tensor and calls the same code, so :func:`shard` — the reference's
``with_sharding_constraint``, a layout hint to GSPMD that changes no value
— returns its input unchanged.  The collectives that the reference's
``shard_map`` bodies run (``embeddings.sharded_lookup``,
``retrieval.retrieval_topk``, ``gnn.gat_forward_partitioned``) run on the
mesh's process groups instead.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

__all__ = ["MeshRules", "use_rules", "current_rules", "logical", "shard"]


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Logical → physical axis mapping."""

    batch: tuple[str, ...] = ()        # e.g. ("pod", "data")
    model: str | None = None           # tensor/expert axis
    fsdp: tuple[str, ...] = ()         # param-storage sharding axes
    mesh: object | None = dataclasses.field(default=None, compare=False)  # a DeviceMesh
    # feature toggles resolved per-config at spec-build time:
    shard_kv: bool = False             # kv-head dim divisible by |model|
    shard_expert: bool = False         # expert count divisible by |model|

    def resolve(self, name: str | None):
        if name is None:
            return None
        if name == "batch":
            return self.batch if self.batch else None
        if name == "model":
            return self.model
        if name == "fsdp":
            return self.fsdp if self.fsdp else None
        if name == "kv_model":
            return self.model if self.shard_kv else None
        if name == "expert_model":
            return self.model if self.shard_expert else None
        if name == "ff_model":  # expert-TP: shard ff when experts are not
            return None if self.shard_expert else self.model
        raise KeyError(f"unknown logical axis {name!r}")

    def spec(self, *names: str | None) -> tuple:
        """One entry per tensor dim: a mesh-dim name, a tuple of several,
        or None; a one-name tuple is written as the name, as
        ``PartitionSpec`` normalises it."""
        out = (self.resolve(n) for n in names)
        return tuple(r[0] if isinstance(r, tuple) and len(r) == 1 else r for r in out)


_STATE = threading.local()


def current_rules() -> MeshRules:
    return getattr(_STATE, "rules", None) or MeshRules()


@contextlib.contextmanager
def use_rules(rules: MeshRules):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def logical(*names: str | None) -> tuple:
    """The spec under the current rules (``()`` entries None when no rules are active)."""
    return current_rules().spec(*names)


def shard(x, *names: str | None):
    """The reference's sharding constraint: ``x`` itself (each rank already
    holds its part; a layout hint changes no value)."""
    return x

