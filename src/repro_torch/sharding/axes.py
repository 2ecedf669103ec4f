"""Logical-axis sharding rules, threaded through model code contextually.

Counterpart of ``repro/sharding/axes.py``.  Model code names the logical
axes of its tensors ("batch", "model", ...); :class:`MeshRules` maps them
to the dims of a ``torch.distributed.DeviceMesh``.  When no rules are
active, every annotation is a no-op and the same model code runs on one
device.

``MeshRules.spec(*names)`` returns a plain tuple of the resolved mesh-dim
names (a tuple of dims, one dim, or None per tensor dim): the port's
``PartitionSpec``, equal to ``tuple()`` of the reference's for the same
rules.  :func:`placements` turns a spec into DTensor placements, one per
mesh dim (GSPMD's ``NamedSharding`` is a ``DeviceMesh`` plus placements),
and :func:`distribute_tree` places a tree of tensors by a tree of specs.

:func:`shard` is the reference's ``with_sharding_constraint``: on a
DTensor it redistributes to the spec's placements (the collective GSPMD
would insert there: an all-gather, a reduce-scatter of a partial sum, a
local chunk); a plain tensor is returned as it is, so the SPMD forms that
hold each rank's part in plain tensors (``embeddings.sharded_lookup``,
``retrieval.retrieval_topk``, ``gnn.gat_forward_partitioned``) and the
one-device path run unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["MeshRules", "use_rules", "current_rules", "logical", "shard", "placements", "distribute_tree",
           "distribute_module", "place_full", "replicated", "local_block", "block_of", "block_shape_offset"]


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


def placements(spec, mesh) -> tuple:
    """A spec (one entry per tensor dim: None, a mesh-dim name or a tuple of
    names) as DTensor placements, one per mesh dim: ``Shard(d)`` on each mesh
    dim that tensor dim d names, ``Replicate()`` on the others.  A tuple
    entry shards one tensor dim over several mesh dims, major to minor as
    JAX orders them; DTensor nests them in mesh order, so the tuple must
    list them in that order.  A spec shorter than the tensor leaves the
    trailing dims replicated."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec or ()):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} lists mesh dims out of the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh dim {names[i]!r} shards two tensor dims in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def replicated(t: torch.Tensor, like) -> torch.Tensor:
    """``t`` (the same on every rank) as a replicated DTensor on ``like``'s
    mesh when ``like`` is a DTensor, else ``t`` itself: the plain tables a
    model builds (rope angles, positions, masks) meet sharded tensors this way."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def block_shape_offset(shape, mesh, place) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """This rank's block of a tensor of global ``shape`` under ``place``:
    (its shape, its offset), DTensor's chunking (``torch.chunk``'s: blocks
    of ceil(n / ranks), the last ones short or empty), nested in mesh order.
    Plain integers, so it runs under ``FakeTensorMode`` too."""
    shape, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(place):
        if p.is_shard():
            d, n = p.dim % len(shape), mesh.size(i)
            chunk = -(-shape[d] // n)
            start = min(coord[i] * chunk, shape[d])
            offset[d] += start
            shape[d] = min(shape[d], start + chunk) - start
    return tuple(shape), tuple(offset)


def local_block(full: torch.Tensor, mesh, place) -> torch.Tensor:
    """This rank's block of ``full`` under ``place`` (DTensor's chunking)."""
    shape, offset = block_shape_offset(full.shape, mesh, place)
    return full[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


def block_of(t, dim: int) -> tuple[int, int]:
    """(size, global offset) of this rank's block of DTensor ``t`` along ``dim``."""
    shape, offset = block_shape_offset(t.shape, t.device_mesh, t.placements)
    return shape[dim], offset[dim]


def _place(x, spec, mesh):
    target = placements(spec, mesh)
    if isinstance(x, DTensor):
        if tuple(x.placements) == target:
            return x
        return x.redistribute(mesh, target)
    return place_full(x, mesh, target)


def place_full(x: torch.Tensor, mesh, target) -> DTensor:
    """``x``, the same full value on every rank, as a DTensor with the
    placements ``target`` on ``mesh``: each rank keeps its block (no
    collective)."""
    return DTensor.from_local(local_block(x, mesh, target).contiguous(), mesh, tuple(target), run_check=False,
                              shape=x.shape, stride=x.stride())


def _is_spec(s) -> bool:
    """A spec is a tuple of None, names and non-empty tuples of names (a
    tree node of specs, such as a ``KVCache`` of specs, is not)."""
    def entry(e):
        return e is None or isinstance(e, str) or (isinstance(e, tuple) and e and all(isinstance(a, str) for a in e))

    return isinstance(s, tuple) and not hasattr(s, "_fields") and all(entry(e) for e in s)


def distribute_tree(tree, spec_tree, mesh):
    """``tree`` (nested dicts, lists and tuples of tensors) with every leaf
    a DTensor placed by the spec at the same place in ``spec_tree``.  A
    plain leaf holds the full value on every rank and each rank keeps its
    block (no collective); a DTensor leaf is redistributed."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, spec_tree[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(spec_tree):
        vals = [distribute_tree(v, s, mesh) for v, s in zip(tree, spec_tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    if isinstance(tree, torch.Tensor):
        return _place(tree, spec_tree, mesh)
    return tree


def _spec_at(spec_tree, dotted: str):
    node = spec_tree
    for part in dotted.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def distribute_module(module: torch.nn.Module, spec_tree, mesh) -> torch.nn.Module:
    """Replace every parameter of ``module`` by a DTensor parameter placed by
    its spec (``spec_tree`` nested like the reference's params, a parameter
    ``layers.wq`` at ``spec_tree["layers"]["wq"]``); ``requires_grad`` kept.
    Returns the module."""
    for name, p in list(module.named_parameters()):
        owner = module.get_submodule(name.rpartition(".")[0]) if "." in name else module
        leaf = name.rpartition(".")[2]
        dt = _place(p.detach(), _spec_at(spec_tree, name), mesh)
        param = torch.nn.Parameter(dt, requires_grad=p.requires_grad)
        if isinstance(owner, torch.nn.ParameterDict):
            owner[leaf] = param
        else:
            setattr(owner, leaf, param)
    return module


def shard(x, *names: str | None):
    """The reference's sharding constraint.  A DTensor is redistributed to
    the spec of ``names`` under the current rules (a partial sum is reduced
    on the way); a plain tensor, or no active mesh, returns ``x``."""
    rules = current_rules()
    if not isinstance(x, DTensor) or rules.mesh is None:
        return x
    return _place(x, rules.spec(*names), x.device_mesh)
