"""The dry run's cells: (architecture × shape × mesh) → a step and its fake arguments.

Counterpart of ``repro/launch/specs.py``.  ``build_cell`` returns a
:class:`BuiltCell` holding:

  * ``fn``            — the step callable (run it under ``wrapped_fn``, which
                        activates the cell's rules);
  * ``args``          — its arguments as fake tensors (``FakeTensorMode``,
                        no memory), every one a DTensor placed by its spec:
                        parameters, optimizer state, batch, cache;
  * ``in_specs`` / ``out_specs`` — the spec trees, equal to ``tuple()`` of
                        the reference's shardings; ``in_placements`` turns
                        them into DTensor placements on the mesh;
  * ``donate_argnums`` — recorded as the reference's, as metadata: the
                        port's step updates the parameters and the state in
                        place, which is its donation;
  * ``rules``, ``model_flops``, ``model_bytes`` and the analytic peak.

Every family and variant of the reference is built: the LMs (``dp_zero1``,
``window8k``), GAT (``partitioned``, ``partitioned_bf16``) and the recsys
models (``model_axes``, ``cached``).  The LM steps are the model's own
functions on DTensor parameters (``models.transformer``); the GNN and
recsys steps, which the reference runs as ``shard_map`` bodies under GSPMD,
run the port's SPMD forms (``embeddings.sharded_lookup``, the sharded
``retrieval_topk``, the edge-parallel and partitioned GAT) in ``local_map``
regions on each rank's blocks.

The microbatch search keeps the analytic peak (``bytes_model``) under a
budget: the reference's 15.5 GiB of a 16 GiB chip, here the same share of
the card's memory (``budget_bytes``; pass 15.5 GiB for the reference's
choice).  The reference's ``Calibration`` is not ported: it corrects XLA's
count of a scanned layer stack as one layer, and the port's eager trace
runs, and counts, every layer.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map
from torch.nn.utils.stateless import _reparametrize_module

from repro_torch.analysis import bytes_model
from repro_torch.analysis.roofline import H100_SXM
from repro_torch.configs.base import ArchSpec, GNNConfig, LMConfig, RecsysConfig, ShapeCell
from repro_torch.launch.mesh import axis_size, batch_shards
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as rec_mod
from repro_torch.models import transformer as lm_mod
from repro_torch.models.retrieval import TopK, retrieval_topk
from repro_torch.sharding.axes import MeshRules, _is_spec, _spec_at, block_shape_offset, placements, shard, use_rules
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.loop import make_train_step

__all__ = ["BuiltCell", "SkippedCell", "TensorSpec", "build_cell", "gnn_cell_dims", "recsys_batch_shapes",
           "GNN_CELL_META", "fake_dtensor", "REFERENCE_BUDGET"]

F32 = torch.float32
I32 = torch.int32
GIB = 1 << 30
REFERENCE_BUDGET = 15.5 * GIB  # the reference's budget on a 16 GB chip


class TensorSpec(NamedTuple):
    """An argument's global shape and dtype (the reference's ShapeDtypeStruct)."""
    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass
class BuiltCell:
    arch_id: str
    cell: ShapeCell
    fn: Callable
    args: tuple
    in_specs: Any
    out_specs: Any           # (params, state, metrics) order of the reference; metrics replicated
    donate_argnums: tuple[int, ...]
    rules: MeshRules
    model_flops: float       # analytic useful FLOPs (the roofline's MODEL_FLOPS)
    model_bytes: float = 0.0  # analytic per-device HBM traffic (bytes_model)
    analytic_peak_bytes: float = 0.0  # analytic per-device peak memory (bytes_model)
    microbatches: int = 1
    fake_mode: Any = None
    optimizer: Any = None    # a train cell's optimizer: its ``init`` makes the state ``fn`` takes

    def wrapped_fn(self):
        rules = self.rules

        def fn(*args):
            with use_rules(rules):
                return self.fn(*args)

        return fn

    @property
    def in_placements(self):
        mesh = self.rules.mesh
        return _map_specs(lambda s: placements(s, mesh), self.in_specs)


class SkippedCell(Exception):
    pass


def _map_specs(fn, tree):
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_map_specs(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return tree


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


def fake_dtensor(shape, dtype, mesh, spec, *, device, requires_grad: bool = False) -> DTensor:
    """A DTensor of global ``shape`` placed by ``spec``, whose local block is
    a fresh tensor of this rank's block shape (a fake one under an active
    ``FakeTensorMode``)."""
    place = placements(spec, mesh)
    local_shape, _ = block_shape_offset(tuple(shape), mesh, place)
    local = torch.empty(local_shape, dtype=dtype, device=device)
    dt = DTensor.from_local(local, mesh, place, run_check=False, shape=torch.Size(shape),
                            stride=_contiguous_stride(shape))
    return torch.nn.Parameter(dt, requires_grad=True) if requires_grad else dt


def _fake_module(module: torch.nn.Module, spec_tree, mesh, device) -> torch.nn.Module:
    """``module`` (built on the meta device) with every parameter a fake
    DTensor parameter placed by its spec."""
    for name, p in list(module.named_parameters()):
        owner = module.get_submodule(name.rpartition(".")[0]) if "." in name else module
        param = fake_dtensor(p.shape, p.dtype, mesh, _spec_at(spec_tree, name), device=device, requires_grad=True)
        if isinstance(owner, torch.nn.ParameterDict):
            owner[name.rpartition(".")[2]] = param
        else:
            setattr(owner, name.rpartition(".")[2], param)
    return module


def _fake_tree(tree, spec_tree, mesh, device):
    """Nested dicts of ``TensorSpec``s or tensors → fake DTensors by ``spec_tree``."""
    if isinstance(tree, dict):
        return {k: _fake_tree(v, spec_tree[k], mesh, device) for k, v in tree.items()}
    return fake_dtensor(tree.shape, tree.dtype, mesh, spec_tree, device=device)


def _fake_opt_state(optimizer, module: torch.nn.Module, ospecs: dict, mesh, device) -> dict:
    """The optimizer's state for ``module``'s parameters as fake DTensors
    placed by ``ospecs`` (nested like the reference's params)."""
    meta = {n: torch.empty(p.shape, dtype=p.dtype, device="meta") for n, p in module.named_parameters()}
    state = optimizer.init(meta)
    flat_specs = {k: {n: _spec_at(v, n) for n in meta} if isinstance(state[k], dict) else v
                  for k, v in ospecs.items()}
    return _fake_tree(state, flat_specs, mesh, device)


def _family_rules(mesh) -> MeshRules:
    axes = tuple(mesh.mesh_dim_names)
    return MeshRules(batch=tuple(a for a in ("pod", "data") if a in axes),
                     model="model" if "model" in axes else None, fsdp=(), mesh=mesh)


def _lm_optimizer(cfg: LMConfig):
    # grok's Adam state would not fit the reference's 16 GB chips → adafactor
    if cfg.params_billions() > 100:
        return opt_mod.adafactor(lr=1e-3)
    return opt_mod.adamw(lr=3e-4)


def _microbatches(fits: Callable[[int], bool]) -> int:
    mb = 1
    while mb < 16 and not fits(mb):
        mb *= 2
    return mb


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_flops(cfg: LMConfig, cell: ShapeCell) -> float:
    n_active = cfg.active_params_billions() * 1e9
    s, b = cell.dim("seq_len"), cell.dim("global_batch")
    if cell.kind == "train":
        return 6.0 * n_active * s * b
    if cell.kind == "prefill":
        return 2.0 * n_active * s * b
    return 2.0 * n_active * b  # decode: one token per sequence


def _lm_cell(arch_id, cfg: LMConfig, cell: ShapeCell, mesh, device, budget, microbatches) -> BuiltCell:
    if cell.skip_reason and cfg.window is None:
        raise SkippedCell(cell.skip_reason)
    rules = lm_mod.lm_rules(cfg, mesh)
    pspecs = lm_mod.lm_param_specs(cfg, rules)
    seq, gb = cell.dim("seq_len"), cell.dim("global_batch")
    nb, ms_eff = batch_shards(mesh), axis_size(mesh, "model")
    if cfg.model_axis_role == "batch":
        nb, ms_eff = mesh.size(), 1  # every axis is batch-like for the bytes model
    if gb % nb and cell.kind != "decode":
        raise SkippedCell(f"global_batch {gb} not divisible by {nb} batch shards")
    params = _fake_module(lm_mod.TransformerLM(cfg, device="meta"), pspecs, mesh, device)
    tok_spec = rules.spec("batch", None)
    flops = _lm_flops(cfg, cell)
    nbytes = bytes_model.lm_bytes(cfg, cell, ms=ms_eff, bs=nb)

    if cell.kind == "train":
        optimizer = _lm_optimizer(cfg)
        if cfg.model_axis_role == "batch" and not cfg.fsdp:  # ZeRO-1: replicated params, sharded state
            ospecs = optimizer.state_specs(lm_mod.zero1_opt_specs(pspecs, lm_mod.nested_shapes(cfg), mesh))
        else:  # TP / FSDP / ZeRO-3: the state mirrors the parameters
            ospecs = optimizer.state_specs(pspecs)
        mb = microbatches or _microbatches(
            lambda m: bytes_model.lm_peak_memory(cfg, cell, ms=ms_eff, bs=nb, microbatches=m) <= budget)
        step = make_train_step(functools.partial(_lm_loss, cfg=cfg), optimizer, microbatches=mb)
        args = (params, _fake_opt_state(optimizer, params, ospecs, mesh, device),
                {"tokens": fake_dtensor((gb, seq + 1), I32, mesh, tok_spec, device=device)})
        in_specs = (pspecs, ospecs, {"tokens": tok_spec})
        return BuiltCell(arch_id, cell, step, args, in_specs, (pspecs, ospecs, None), (0, 1), rules, flops,
                         nbytes, bytes_model.lm_peak_memory(cfg, cell, ms=ms_eff, bs=nb, microbatches=mb), mb,
                         optimizer=optimizer)

    peak = bytes_model.lm_peak_memory(cfg, cell, ms=ms_eff, bs=nb)
    if cell.kind == "prefill":
        args = (params, fake_dtensor((gb, seq), I32, mesh, tok_spec, device=device))
        return BuiltCell(arch_id, cell, functools.partial(lm_mod.prefill_step, cfg=cfg), args, (pspecs, tok_spec),
                         rules.spec("batch", "model"), (), rules, flops, nbytes, peak)

    # decode; batch-1 cells (long_500k under a window) cannot shard the batch
    b_ax = "batch" if gb % nb == 0 else None
    cache_spec = rules.spec(None, b_ax, "model", None, None)
    shape = (cfg.n_layers, gb, seq, cfg.n_kv_heads, cfg.head_dim)
    cache = lm_mod.KVCache(k=fake_dtensor(shape, cfg.dtype, mesh, cache_spec, device=device),
                           v=fake_dtensor(shape, cfg.dtype, mesh, cache_spec, device=device),
                           length=fake_dtensor((), I32, mesh, (), device=device))
    cache_specs = lm_mod.KVCache(k=cache_spec, v=cache_spec, length=())
    args = (params, cache, fake_dtensor((gb,), I32, mesh, rules.spec(b_ax), device=device))
    in_specs = (pspecs, cache_specs, rules.spec(b_ax))
    out_specs = (rules.spec(b_ax, "model"), rules.spec(b_ax), cache_specs)
    return BuiltCell(arch_id, cell, functools.partial(lm_mod.serve_step, cfg=cfg), args, in_specs, out_specs, (1,),
                     rules, flops, nbytes, peak)


def _lm_loss(params, batch, cfg):
    return lm_mod.lm_loss(params, batch, cfg)


# ---------------------------------------------------------------------------
# SPMD bodies in local_map regions
# ---------------------------------------------------------------------------


def _spmd(fn, module: torch.nn.Module, batch: dict, mesh, *, out_place, grad_place, in_batch=None,
          scale: float = 1.0):
    """``fn(module, batch)`` (one tensor) on each rank's blocks: the
    parameters and the batch enter as local tensors (the batch
    redistributed to ``in_batch``'s placements where given), the output,
    multiplied by ``scale``, leaves with ``out_place`` and is then reduced
    where that is a partial sum; a parameter's gradient takes
    ``grad_place(its placements)``."""
    names, ps = zip(*module.named_parameters())
    keys = list(batch)
    bvals = [batch[k] for k in keys]
    b_place = [tuple(in_batch[k]) if in_batch and k in in_batch else tuple(v.placements) for k, v in zip(keys, bvals)]
    in_place = tuple(p.placements for p in ps) + tuple(b_place)
    in_grad = tuple(grad_place(p.placements) for p in ps) + tuple(b_place)

    def body(*flat):
        with _reparametrize_module(module, dict(zip(names, flat[:len(ps)]))):
            out = fn(module, dict(zip(keys, flat[len(ps):])))
        return out * scale if scale != 1.0 else out

    out = local_map(body, out_placements=list(out_place), in_placements=in_place, in_grad_placements=in_grad,
                    device_mesh=mesh, redistribute_inputs=True)(*ps, *bvals)
    if any(p.is_partial() for p in out.placements):
        out = out.redistribute(mesh, [Replicate() if p.is_partial() else p for p in out.placements])
    return out


def _stacked(loss_fn):
    """``loss_fn(params, batch) → (loss, metrics)`` as one fp32 vector
    ``[loss, *metrics in key order]`` (one local_map output), and back."""
    keys: list[str] = []

    def flat(params, batch):
        loss, metrics = loss_fn(params, batch)
        keys[:] = sorted(metrics)
        return torch.stack([loss.float(), *(metrics[k].float() for k in keys)])

    def unflat(vec):
        return vec[0], {k: vec[i + 1] for i, k in enumerate(keys)}

    return flat, unflat


def _batch_dims(mesh, rules: MeshRules) -> list[int]:
    names = tuple(mesh.mesh_dim_names)
    return [names.index(a) for a in rules.batch]


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

GNN_CELL_META = {
    "full_graph_sm": {"n_classes": 7},
    "minibatch_lg": {"n_classes": 41},
    "ogb_products": {"n_classes": 47},
    "molecule": {"n_classes": 2},
}


def _pad_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def gnn_cell_dims(cell: ShapeCell, nb: int) -> dict:
    """Static (padded) node/edge counts for one GNN cell."""
    d = dict(cell.dims)
    if cell.name == "minibatch_lg":
        seeds = d["batch_nodes"]
        l1 = seeds * d["fanout0"]
        l2 = l1 * d["fanout1"]
        n = seeds + l1 + l2
        e = l1 + l2
    elif cell.name == "molecule":
        n = d["n_nodes"] * d["batch"]
        e = d["n_edges"] * d["batch"]
    else:
        n = d["n_nodes"]
        e = d["n_edges"]
    e_total = _pad_up(e + n, 512 * max(nb, 1))  # + self loops, shard-divisible
    return {"n": n, "e_raw": e, "e_total": e_total, "d_feat": d["d_feat"]}


def _gnn_flops(cfg: GNNConfig, dims: dict, n_classes: int) -> float:
    """SpMM + SDDMM + dense projections (2·MACs)."""
    n, e, f = dims["n"], dims["e_total"], dims["d_feat"]
    mid = cfg.n_heads * cfg.d_hidden
    proj = 2.0 * n * (f * mid + mid * cfg.n_heads * n_classes)
    edge = 2.0 * e * (mid + cfg.n_heads * n_classes) * 2  # SDDMM + SpMM
    return 3.0 * (proj + edge)  # fwd + bwd ≈ 3× fwd


def _gnn_cell(arch_id, cfg: GNNConfig, cell: ShapeCell, mesh, device, variant: str) -> BuiltCell:
    # edge-parallel with replicated node tables: "batch" spans EVERY mesh axis
    axes = tuple(mesh.mesh_dim_names)
    rules = MeshRules(batch=tuple(a for a in ("pod", "data", "model") if a in axes), model=None, fsdp=(), mesh=mesh)
    nb = mesh.size()
    dims = gnn_cell_dims(cell, nb)
    meta = GNN_CELL_META[cell.name]
    partitioned = variant.startswith("partitioned")
    if partitioned:  # the node table is owner-sharded: its rows divide the shards
        dims["n"] = _pad_up(dims["n"], nb)
    n, e_total = dims["n"], dims["e_total"]
    shapes = _gat_meta(cfg, dims["d_feat"], meta["n_classes"])
    pspecs = gnn_mod.gat_param_specs(shapes, rules)
    params = _fake_module(shapes, pspecs, mesh, device)

    batch = {"feats": TensorSpec((n, dims["d_feat"]), F32), "edge_src": TensorSpec((e_total,), I32),
             "edge_dst": TensorSpec((e_total,), I32), "edge_mask": TensorSpec((e_total,), F32)}
    node_spec = rules.spec("batch", None) if variant == "partitioned" else ()
    node_row = rules.spec("batch") if variant == "partitioned" else ()
    bspec = {"feats": node_spec, "edge_src": rules.spec("batch"), "edge_dst": rules.spec("batch"),
             "edge_mask": rules.spec("batch")}
    if cell.name == "molecule":
        batch.update(graph_ids=TensorSpec((n,), I32), labels=TensorSpec((cell.dim("batch"),), I32))
        bspec.update(graph_ids=(), labels=())
    else:
        batch.update(labels=TensorSpec((n,), I32), label_mask=TensorSpec((n,), torch.bool))
        bspec.update(labels=node_row, label_mask=node_row)

    everywhere = list(range(mesh.ndim))
    if partitioned and cell.name != "molecule":
        gd = torch.bfloat16 if variant.endswith("bf16") else None
        row = placements(rules.spec("batch"), mesh)
        in_batch = {"feats": placements(rules.spec("batch", None), mesh), "labels": row, "label_mask": row}
        body = functools.partial(_gnn_partitioned_loss, cfg=cfg, rules=rules, gather_dtype=gd)
        spmd = dict(out_place=[Replicate()] * mesh.ndim, in_batch=in_batch, scale=1.0)
    else:  # edge-parallel: a rank's loss is 1/P of the loss, its gradient its share
        loss = gnn_mod.gat_graph_loss if cell.name == "molecule" else gnn_mod.gat_node_loss
        in_batch = {"feats": [Replicate()] * mesh.ndim}
        body = functools.partial(_gnn_edge_loss, cfg=cfg, loss=loss, mesh=mesh, rules=rules)
        spmd = dict(out_place=[Partial()] * mesh.ndim, in_batch=in_batch, scale=1.0 / nb)
    loss_fn = _spmd_loss(body, mesh, grad_dims=everywhere, **spmd)
    optimizer = opt_mod.adamw(lr=5e-3, weight_decay=5e-4)
    ospecs = optimizer.state_specs(pspecs)
    step = make_train_step(loss_fn, optimizer)
    args = (params, _fake_opt_state(optimizer, params, ospecs, mesh, device), _fake_tree(batch, bspec, mesh, device))
    return BuiltCell(arch_id, cell, step, args, (pspecs, ospecs, bspec), (pspecs, ospecs, None), (0, 1), rules,
                     _gnn_flops(cfg, dims, meta["n_classes"]), bytes_model.gnn_bytes(cfg, dims, n_shards=nb),
                     optimizer=optimizer)


def _gat_meta(cfg: GNNConfig, in_dim: int, n_classes: int):
    """The GAT's parameters (``gnn.init_gat_params``' shapes) on the meta device."""
    from repro_torch.models.param_tree import ParamTree

    h, dh = cfg.n_heads, cfg.d_hidden
    shapes = {"l1": {"w": (in_dim, h, dh), "a_src": (h, dh), "a_dst": (h, dh), "b": (h, dh)},
              "l2": {"w": (h * dh, h, n_classes), "a_src": (h, n_classes), "a_dst": (h, n_classes),
                     "b": (h, n_classes)}}
    return ParamTree({k: {n: torch.empty(sh, dtype=cfg.dtype, device="meta") for n, sh in v.items()}
                      for k, v in shapes.items()})


def _gnn_edge_loss(params, batch, *, cfg, loss, mesh, rules):
    from repro_torch.core.distributed import batch_group

    return loss(params, batch, cfg, group=batch_group(mesh, rules.batch))


def _gnn_partitioned_loss(params, batch, *, cfg, rules, gather_dtype):
    return gnn_mod.gat_node_loss_partitioned(params, batch, cfg, rules, gather_dtype=gather_dtype)


def _spmd_loss(body, mesh, *, grad_dims, out_place, in_batch, scale):
    """A loss ``(params, batch) → (loss, metrics)`` whose body runs per rank;
    a parameter's gradient is a partial sum over ``grad_dims`` where it is
    replicated."""

    def grad_place(place):
        return [Partial() if (p == Replicate() and i in grad_dims) else p for i, p in enumerate(place)]

    def loss_fn(params, batch):
        flat, unflat = _stacked(body)
        return unflat(_spmd(flat, params, batch, mesh, out_place=out_place, grad_place=grad_place,
                            in_batch=in_batch, scale=scale))

    return loss_fn


# ---------------------------------------------------------------------------
# Recsys cells
# ---------------------------------------------------------------------------


def recsys_batch_shapes(cfg: RecsysConfig, cell: ShapeCell, *, train: bool) -> dict:
    b = cell.dim("batch")
    kind = cfg.interaction
    if kind == "fm-2way":
        out = {"ids": TensorSpec((b, cfg.n_sparse), I32)}
        if train:
            out["label"] = TensorSpec((b,), F32)
        return out
    if kind == "augru":
        out = {
            "profile_ids": TensorSpec((b, rec_mod.N_PROFILE), I32),
            "seq_items": TensorSpec((b, cfg.seq_len), I32),
            "seq_cates": TensorSpec((b, cfg.seq_len), I32),
            "seq_mask": TensorSpec((b, cfg.seq_len), F32),
            "target_item": TensorSpec((b,), I32),
            "target_cate": TensorSpec((b,), I32),
        }
        if train:
            out["label"] = TensorSpec((b,), F32)
        return out
    if kind == "bidir-seq":
        out = {"seq": TensorSpec((b, cfg.seq_len), I32), "pad_mask": TensorSpec((b, cfg.seq_len), F32)}
        if train:
            out.update(masked_pos=TensorSpec((b, 20), I32), masked_ids=TensorSpec((b, 20), I32),
                       neg_ids=TensorSpec((1024,), I32))
        else:
            out["target_item"] = TensorSpec((b,), I32)
        return out
    if kind == "transformer-seq":
        out = {"seq_items": TensorSpec((b, cfg.seq_len), I32), "target_item": TensorSpec((b,), I32)}
        if train:
            out["label"] = TensorSpec((b,), F32)
        return out
    raise KeyError(kind)


def _recsys_batch_specs(shapes: dict, rules: MeshRules) -> dict:
    return {k: () if k == "neg_ids" else rules.spec("batch", *([None] * (len(v.shape) - 1)))
            for k, v in shapes.items()}


def _recsys_flops(cfg: RecsysConfig, cell: ShapeCell, *, train: bool) -> float:
    b = cell.dim("batch")
    d = cfg.embed_dim
    kind = cfg.interaction
    if kind == "fm-2way":
        fwd = 2.0 * b * cfg.n_sparse * d
    elif kind == "augru":
        fwd = 2.0 * b * cfg.seq_len * (2 * d + cfg.gru_dim) * 3 * cfg.gru_dim * 2
        fwd += 2.0 * b * sum(a * bb for a, bb in zip((18 + 36 + 108 + 36, *cfg.mlp_dims), (*cfg.mlp_dims, 1)))
    elif kind == "bidir-seq":
        t = cfg.seq_len
        per_block = 2.0 * t * (4 * d * d + 2 * t * d + 8 * d * d)
        fwd = b * cfg.n_blocks * per_block
        if train:
            fwd += 2.0 * b * 20 * 1025 * d
    else:  # transformer-seq
        t = cfg.seq_len + 1
        per_block = 2.0 * t * (4 * d * d + 2 * t * d + 8 * d * d)
        flat = t * d
        mlp = 2.0 * sum(a * bb for a, bb in zip((flat, *cfg.mlp_dims), (*cfg.mlp_dims, 1)))
        fwd = b * (cfg.n_blocks * per_block + mlp)
    if cell.kind == "retrieval":
        fwd += 2.0 * b * cell.dim("n_candidates") * d
    return (3.0 if train else 1.0) * fwd


def _recsys_cell(arch_id, cfg: RecsysConfig, cell: ShapeCell, mesh, device, variant: str) -> BuiltCell:
    rules = _family_rules(mesh)
    init, param_specs_fn, loss, score, query_emb, cand_table = rec_mod.get_model(cfg)
    pspecs = param_specs_fn(cfg, rules)
    params = _fake_module(init(None, cfg), pspecs, mesh, device)
    nb = batch_shards(mesh)
    b = cell.dim("batch")
    if cell.kind != "retrieval" and b % nb:
        raise SkippedCell(f"batch {b} not divisible by {nb}")
    flops = _recsys_flops(cfg, cell, train=cell.kind == "train")
    nbytes = bytes_model.recsys_bytes(cfg, cell, ms=axis_size(mesh, "model"), bs=nb)
    batch_dims = _batch_dims(mesh, rules)
    n_b = 1
    for i in batch_dims:
        n_b *= mesh.size(i)
    # a rank's rows' mean is 1/n_b of the batch's: a partial sum over the batch dims, whole over "model"
    row_mean = [Partial() if i in batch_dims else Replicate() for i in range(mesh.ndim)]

    if cell.kind == "train":
        body = functools.partial(_recsys_loss, cfg=cfg, loss=loss)
        loss_fn = _spmd_loss(body, mesh, grad_dims=batch_dims, out_place=row_mean, in_batch=None, scale=1.0 / n_b)
        optimizer = opt_mod.adamw(lr=1e-3, weight_decay=0.0)
        ospecs = optimizer.state_specs(pspecs)
        shapes = recsys_batch_shapes(cfg, cell, train=True)
        bspec = _recsys_batch_specs(shapes, rules)
        args = (params, _fake_opt_state(optimizer, params, ospecs, mesh, device), _fake_tree(shapes, bspec, mesh, device))
        return BuiltCell(arch_id, cell, make_train_step(loss_fn, optimizer), args, (pspecs, ospecs, bspec),
                         (pspecs, ospecs, None), (0, 1), rules, flops, nbytes, optimizer=optimizer)

    if cell.kind == "serve":
        shapes = recsys_batch_shapes(cfg, cell, train=False)
        bspec = _recsys_batch_specs(shapes, rules)
        rows = placements(rules.spec("batch"), mesh)
        fn = functools.partial(_recsys_serve, cfg=cfg, score=score, mesh=mesh, out_place=rows)
        args = (params, _fake_tree(shapes, bspec, mesh, device))
        return BuiltCell(arch_id, cell, fn, args, (pspecs, bspec), rules.spec("batch"), (), rules, flops, nbytes)

    # retrieval: the query batch (of 1) replicated, candidates = the table's first N rows
    n_cand = cell.dim("n_candidates")
    shapes = recsys_batch_shapes(cfg, cell, train=False)
    shapes.pop("target_item", None)
    shapes.pop("label", None)
    spec_b = {k: () for k in shapes}
    fn = functools.partial(_recsys_retrieval, cfg=cfg, query_emb=query_emb, cand_table=cand_table, mesh=mesh,
                           rules=rules, n_cand=n_cand, variant=variant)
    out_specs = TopK((), ())
    if variant == "cached":
        args = (params, _fake_tree(shapes, spec_b, mesh, device),
                fake_dtensor((n_cand, cfg.embed_dim), F32, mesh, ("model", None), device=device))
        return BuiltCell(arch_id, cell, fn, args, (pspecs, spec_b, ("model", None)), out_specs, (), rules, flops,
                         nbytes)
    args = (params, _fake_tree(shapes, spec_b, mesh, device))
    return BuiltCell(arch_id, cell, fn, args, (pspecs, spec_b), out_specs, (), rules, flops, nbytes)


def _recsys_loss(params, batch, *, cfg, loss):
    return loss(params, batch, cfg)


@torch.no_grad()
def _recsys_serve(params, batch, *, cfg, score, mesh, out_place):
    return _spmd(lambda p, b: score(p, b, cfg), params, batch, mesh, out_place=out_place, grad_place=lambda pl: pl)


@torch.no_grad()
def _recsys_retrieval(params, batch, candidates=None, *, cfg, query_emb, cand_table, mesh, rules, n_cand, variant):
    whole = [Replicate()] * mesh.ndim
    q = _spmd(lambda p, b: query_emb(p, b, cfg), params, batch, mesh, out_place=whole,
              grad_place=lambda pl: pl)                                   # (B, D), the same on every rank
    if candidates is not None:   # prepared once, arriving sharded over "model"
        axes, cands = ("model",), candidates
    elif variant == "model_axes":  # scan the table over "model", where it lives
        axes, cands = ("model",), shard(cand_table(params, cfg, n_cand), "model", None)
    else:                          # reshard model → batch
        axes, cands = rules.batch, shard(cand_table(params, cfg, n_cand), "batch", None)

    def body(c, qq):
        r = retrieval_topk(c, qq, k=100, rules=rules, shard_axes=axes)
        return r.scores, r.ids

    scores, ids = local_map(body, out_placements=(whole, whole), in_placements=(cands.placements, q.placements),
                            device_mesh=mesh)(cands, q)
    return TopK(scores, ids)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def build_cell(spec: ArchSpec, cell: ShapeCell, mesh, variant: str = "baseline", *, device: str = "cuda",
               budget_bytes: float | None = None, microbatches: int | None = None, fake_mode=None) -> BuiltCell:
    """The cell's step and fake arguments on ``mesh`` (a ``DeviceMesh`` over
    the default process group, the dry run's ``fake`` one or a real one).

    ``variant`` selects the reference's alternatives:
      lm:      "dp_zero1"    — the model axis does batch duty, ZeRO-1 state sharding
               "window8k"    — an 8,192-token sliding window (long_500k decodable)
      recsys:  "model_axes"  — retrieval scans the model-sharded table in place
               "cached"      — the candidate matrix arrives sharded over "model"
      gnn:     "partitioned" — dst-owner node partitioning (no node all-reduces);
               "partitioned_bf16" gathers in bf16
    ``budget_bytes``: the microbatch search's per-device budget (default
    the reference's share of the card's memory, ``H100_SXM``);
    ``microbatches`` sets an LM train cell's count in place of that search
    (a cell cut to fit one card keeps its own).  The fake
    arguments live in ``fake_mode`` (a new ``FakeTensorMode`` by default),
    kept on the cell: run the step under it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if budget_bytes is None:
        budget_bytes = H100_SXM.hbm_bytes * REFERENCE_BUDGET / (16 * GIB)
    fake_mode = fake_mode or FakeTensorMode(allow_non_fake_inputs=True)
    cfg = spec.config
    with fake_mode:
        if cfg.family == "lm":
            if variant == "dp_zero1":
                cfg = dataclasses.replace(cfg, model_axis_role="batch")
            elif variant == "window8k":
                cfg = dataclasses.replace(cfg, window=8192)
            built = _lm_cell(spec.arch_id, cfg, cell, mesh, device, budget_bytes, microbatches)
        elif cfg.family == "gnn":
            built = _gnn_cell(spec.arch_id, cfg, cell, mesh, device, variant)
        elif cfg.family == "recsys":
            built = _recsys_cell(spec.arch_id, cfg, cell, mesh, device, variant)
        else:
            raise KeyError(cfg.family)
    built.fake_mode = fake_mode
    return built
