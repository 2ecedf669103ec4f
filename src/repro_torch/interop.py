"""Carry the reference's state across into the port's objects.

ProHD has no weights: its state is the configuration and the data.  This
module turns the fields of a reference ``HDConfig`` / ``ProHDConfig`` /
``ServeConfig`` / ``EngineConfig`` / ``DriftMonitorConfig`` / ``LMConfig``
/ ``GNNConfig`` / ``RecsysConfig``, passed as a plain dict
(``dataclasses.asdict``), and numpy arrays (clouds,
masks, projections, directions, a corpus, an LM's, GAT's or a recsys
model's parameters, an optimizer's or PowerSGD's state) into the port's
objects, so a test can
build both packages' inputs from one dict and one set of arrays.  It
imports nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig
from repro_torch.core.prohd import ProHDConfig
from repro_torch.core.streaming import DriftMonitorConfig
from repro_torch.device import as_tensor, resolve_device
from repro_torch.hd.config import HDConfig
from repro_torch.index.store import SetStore
from repro_torch.models.param_tree import ParamTree
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve.engine import EngineConfig
from repro_torch.serve.server import ServeConfig
from repro_torch.train.compression import PowerSGDState
from repro_torch.train.loop import named_params

__all__ = [
    "BACKEND_NAMES",
    "SUBSET_BACKEND_NAMES",
    "DROPPED_FIELDS",
    "backend_name",
    "hd_config_from_dict",
    "prohd_config_from_dict",
    "serve_config_from_dict",
    "engine_config_from_dict",
    "drift_config_from_dict",
    "cloud",
    "mask",
    "store_from_reference",
    "lm_config_from_dict",
    "lm_params_from_reference",
    "gnn_config_from_dict",
    "recsys_config_from_dict",
    "gnn_params_from_reference",
    "recsys_params_from_reference",
    "by_name",
    "opt_state_from_reference",
    "powersgd_state_from_reference",
]

# Reference name → port name, where they differ (front-door backends and
# masked bucket backends).
BACKEND_NAMES = {"fused_pallas": "fused_cuda", "batched_pallas": "batched_cuda",
                 "multiquery_pallas": "multiquery_cuda"}
SUBSET_BACKEND_NAMES = {"pallas": "cuda"}
# Reference fields with no counterpart in the port: ``interpret`` (no
# interpret mode for a CUDA kernel) and ``max_shape_classes`` (the
# service's cap on jit-compiled shape classes; PyTorch compiles nothing per
# shape).
DROPPED_FIELDS = frozenset({"interpret", "max_shape_classes"})


def backend_name(ref_backend: str) -> str:
    """The port's front-door or masked backend name for a reference one."""
    return BACKEND_NAMES.get(ref_backend, ref_backend)


def _fields(cls, d: dict[str, Any]) -> dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names - DROPPED_FIELDS
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return {k: v for k, v in d.items() if k in names}


def prohd_config_from_dict(d: dict[str, Any]) -> ProHDConfig:
    """A port ``ProHDConfig`` from a reference ``ProHDConfig``'s fields."""
    kw = _fields(ProHDConfig, d)
    if "subset_backend" in kw:
        kw["subset_backend"] = SUBSET_BACKEND_NAMES.get(kw["subset_backend"], kw["subset_backend"])
    return ProHDConfig(**kw)


def hd_config_from_dict(d: dict[str, Any]) -> HDConfig:
    """A port ``HDConfig`` from a reference ``HDConfig``'s fields (a nested
    ``prohd`` dict becomes a port ``ProHDConfig``)."""
    kw = _fields(HDConfig, d)
    if kw.get("prohd") is not None:
        kw["prohd"] = prohd_config_from_dict(dict(kw["prohd"]))
    return HDConfig(**kw)


def serve_config_from_dict(d: dict[str, Any]) -> ServeConfig:
    """A port ``ServeConfig`` from a reference ``ServeConfig``'s fields."""
    return ServeConfig(**_fields(ServeConfig, d))


def engine_config_from_dict(d: dict[str, Any]) -> EngineConfig:
    """A port ``EngineConfig`` from a reference ``EngineConfig``'s fields
    (a pinned masked backend is renamed as ``BACKEND_NAMES`` says)."""
    kw = _fields(EngineConfig, d)
    if kw.get("masked_backend") is not None:
        kw["masked_backend"] = backend_name(kw["masked_backend"])
    return EngineConfig(**kw)


def drift_config_from_dict(d: dict[str, Any]) -> DriftMonitorConfig:
    """A port ``DriftMonitorConfig`` from a reference one's fields (its
    nested ``prohd`` dict becomes a port ``ProHDConfig``; the threshold a
    Python float)."""
    kw = _fields(DriftMonitorConfig, d)
    if kw.get("prohd") is not None:
        kw["prohd"] = prohd_config_from_dict(dict(kw["prohd"]))
    if "threshold" in kw:
        kw["threshold"] = float(kw["threshold"])
    return DriftMonitorConfig(**kw)


def cloud(x: np.ndarray, device=None) -> torch.Tensor:
    """A numpy cloud, projection or direction matrix as an fp32/bf16 tensor
    (other float types become fp32)."""
    t = as_tensor(np.ascontiguousarray(x), device)
    return t if t.dtype in (torch.float32, torch.bfloat16) else t.float()


def mask(v: np.ndarray | None, device=None) -> torch.Tensor | None:
    """A numpy validity mask as a bool tensor (None stays None)."""
    return None if v is None else as_tensor(np.asarray(v, dtype=bool), device)


def store_from_reference(directions: np.ndarray, sets, *, min_bucket: int = 8,
                         device=None) -> SetStore:
    """A port ``SetStore`` holding the same corpus as a reference store:
    its direction bank (``np.asarray(ref_store.directions)``, which
    ``jax.random`` drew and the port cannot redraw) and its raw sets in id
    order (numpy), added in one ``add_many``."""
    store = SetStore(dim=int(np.asarray(directions).shape[0]),
                     directions=np.asarray(directions, np.float32),
                     min_bucket=min_bucket, device=device)
    store.add_many([np.asarray(s, np.float32) for s in sets])
    return store


def _config(cls, d: dict[str, Any]):
    kw = _fields(cls, d)
    if "dtype" in kw:
        kw["dtype"] = getattr(torch, np.dtype(kw["dtype"]).name)
    for k in ("vocab_sizes", "mlp_dims"):
        if k in kw:
            kw[k] = tuple(kw[k])
    return cls(**kw)


def lm_config_from_dict(d: dict[str, Any]) -> LMConfig:
    """A port ``LMConfig`` from a reference ``LMConfig``'s fields; its
    dtype (a jnp scalar type or any numpy-understood dtype) becomes the
    ``torch.dtype`` of the same name."""
    return _config(LMConfig, d)


def gnn_config_from_dict(d: dict[str, Any]) -> GNNConfig:
    """A port ``GNNConfig`` from a reference ``GNNConfig``'s fields (dtype as
    in :func:`lm_config_from_dict`)."""
    return _config(GNNConfig, d)


def recsys_config_from_dict(d: dict[str, Any]) -> RecsysConfig:
    """A port ``RecsysConfig`` from a reference ``RecsysConfig``'s fields
    (dtype as in :func:`lm_config_from_dict`; the size lists as tuples)."""
    return _config(RecsysConfig, d)


def _param_tree(params_np: dict, dtype, device) -> ParamTree:
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return torch.from_numpy(np.array(v, np.float32)).to(dtype)

    return ParamTree(conv(params_np), device=resolve_device(None, device))


def gnn_params_from_reference(params_np: dict, cfg: GNNConfig, *, device=None) -> ParamTree:
    """GAT's parameters (``models.gnn``) holding exactly the reference's
    values: ``params_np`` is its tree as numpy (``jax.tree.map(np.asarray,
    params)``), in ``cfg.dtype``."""
    return _param_tree(params_np, cfg.dtype, device)


def recsys_params_from_reference(params_np: dict, cfg: RecsysConfig, *, device=None) -> ParamTree:
    """A recsys model's parameters (``models.recsys``) holding exactly the
    reference's values, under its tree paths (lists as ``ModuleList``s:
    ``mlp.0.w``), in ``cfg.dtype``."""
    return _param_tree(params_np, cfg.dtype, device)


def lm_params_from_reference(params_np: dict, cfg: LMConfig, *, device=None) -> TransformerLM:
    """A ``TransformerLM`` holding exactly the reference's parameter values:
    ``params_np`` is the reference's param pytree as numpy arrays
    (``jax.tree.map(np.asarray, params)``), ``jax.random`` having drawn
    them.  Values pass through fp32 (exact for bf16) into each parameter's
    dtype: ``cfg.dtype``, or fp32 for an MoE router."""
    flat = {k: v for k, v in params_np.items() if k != "layers"}
    flat.update({f"layers.{k}": v for k, v in params_np["layers"].items()})
    model = TransformerLM(cfg, device=device)
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in flat.items()},
                          strict=True)
    return model


def by_name(tree_np: dict, name: str):
    """The entry of a reference pytree (nested dicts) under a port name
    whose dots join the keys: ``"layers.wq"`` → ``tree["layers"]["wq"]``,
    ``"mlp.0.w"`` → ``tree["mlp"][0]["w"]``."""
    for part in name.split("."):
        tree_np = tree_np[int(part)] if isinstance(tree_np, (list, tuple)) else tree_np[part]
    return tree_np


def _tensor_like(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr)).to(device)


def opt_state_from_reference(state_np: dict, model) -> dict:
    """The port's state of ``train.optimizer``'s ``adamw``, ``adafactor`` or
    ``sgd`` from the reference's (``jax.tree.map(np.asarray, state)``):
    each param-shaped subtree (``mu``, ``nu``, ``master``, Adafactor's
    ``v`` with its ``vr``/``vc`` or ``v`` per leaf) becomes a dict by the
    port's parameter names, on the parameters' device; ``count`` a 0-d
    int32 tensor.  ``model`` is what ``loop.fit`` trains: a module or a dict
    of named tensors."""
    named = named_params(model)
    device = next(iter(named.values())).device
    out = {}
    for key, sub in state_np.items():
        if key == "count":
            out[key] = _tensor_like(np.asarray(sub, np.int32), device)
        elif key == "v":
            out[key] = {n: {k: _tensor_like(a, device) for k, a in by_name(sub, n).items()} for n in named}
        else:
            out[key] = {n: _tensor_like(by_name(sub, n), device) for n in named}
    return out


def powersgd_state_from_reference(state_np, model) -> PowerSGDState:
    """The port's ``PowerSGDState`` from the reference's (a ``(q, error)``
    pair of param-shaped trees as numpy): its factors, drawn by
    ``jax.random``, and its error feedback, by parameter name."""
    named = named_params(model)
    device = next(iter(named.values())).device
    q_np, err_np = state_np
    return PowerSGDState(q={n: _tensor_like(by_name(q_np, n), device) for n in named},
                         error={n: _tensor_like(by_name(err_np, n), device) for n in named})
