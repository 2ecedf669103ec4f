"""Config system of the port's LM path: ``LMConfig``, shape cells, registry.

Counterpart of the LM part of ``repro/configs/base.py``.  Every ported
architecture is a module ``repro_torch/configs/<id>.py`` exporting
``CONFIG`` (the reference's hyperparameters, word for word) and ``SHAPES``;
``registry()`` maps arch-id → ``ArchSpec`` over the ported ones (the dense
and MoE LMs; GNN and recsys wait with their models).

``LMConfig.dtype`` is a ``torch.dtype`` (bf16 by default, fp32 in
``smoke_lm_config``).  ``remat`` is live: with a gradient recorded, each
layer of ``models.transformer.lm_forward`` runs under
``torch.utils.checkpoint`` and is recomputed in the backward, as the
reference's ``jax.checkpoint``.  The fields that only the reference's mesh
and jit read — ``fsdp``, ``model_axis_role`` and ``unroll`` — are kept as
inert fields, so a reference config dict maps over one to one
(``repro_torch.interop.lm_config_from_dict``); the port runs on one device
with no mesh, and its forward pass has no scan to unroll.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Mapping

import torch

__all__ = ["ShapeCell", "LM_SHAPES", "LMConfig", "ArchSpec", "arch_ids", "load_arch",
           "registry", "smoke_lm_config"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape × step-kind) cell of the dry-run matrix."""

    name: str
    kind: str  # "train" | "prefill" | "decode" | ...
    dims: Mapping[str, int] = dataclasses.field(default_factory=dict)
    skip_reason: str | None = None

    def dim(self, key: str) -> int:
        return int(self.dims[key])


LM_SHAPES = (
    ShapeCell("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeCell("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeCell("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeCell(
        "long_500k",
        "decode",
        {"seq_len": 524288, "global_batch": 1},
        skip_reason=(
            "pure full-attention arch: long_500k requires sub-quadratic "
            "attention per the assignment; see DESIGN.md §4"
        ),
    ),
)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Decoder-only transformer LM (dense or MoE), GQA attention."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    moe_experts: int = 0       # 0 → dense FFN
    moe_top_k: int = 0
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    fsdp: bool = False          # inert: mesh placement in the reference
    remat: bool = True          # recompute each layer in the backward (torch.utils.checkpoint)
    attn_chunk: int = 512       # kv-chunk of the plain online-softmax attention
    capacity_factor: float = 1.25
    window: int | None = None   # sliding-window attention (None = full)
    unroll: bool = False        # inert: lax.scan unrolling in the reference
    model_axis_role: str = "tensor"  # inert: the reference mesh's "model" axis

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def family(self) -> str:
        return "lm"

    def params_billions(self) -> float:
        """Total parameter count, in billions."""
        d, f, v, h = self.d_model, self.d_ff, self.vocab, self.head_dim
        attn = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) + (self.n_heads * h) * d
        if self.moe_experts:
            ffn = self.moe_experts * (3 * d * f) + d * self.moe_experts
        else:
            ffn = 3 * d * f  # SwiGLU: gate, up, down
        per_layer = attn + ffn + 2 * d
        return (self.n_layers * per_layer + 2 * v * d + d) / 1e9

    def active_params_billions(self) -> float:
        """Active (per-token) params — MoE counts only top-k experts."""
        if not self.moe_experts:
            return self.params_billions()
        d, f, h = self.d_model, self.d_ff, self.head_dim
        attn = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) + (self.n_heads * h) * d
        ffn = self.moe_top_k * (3 * d * f) + d * self.moe_experts
        per_layer = attn + ffn + 2 * d
        return (self.n_layers * per_layer + 2 * self.vocab * d + d) / 1e9


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    config: LMConfig
    shapes: tuple[ShapeCell, ...]


_ARCH_MODULES = {
    "stablelm-3b": "stablelm_3b",
    "deepseek-67b": "deepseek_67b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "grok-1-314b": "grok1_314b",
    "olmoe-1b-7b": "olmoe_1b_7b",
}


def arch_ids() -> tuple[str, ...]:
    return tuple(_ARCH_MODULES)


def load_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return ArchSpec(arch_id=arch_id, config=mod.CONFIG, shapes=tuple(mod.SHAPES))


def registry() -> dict[str, ArchSpec]:
    return {aid: load_arch(aid) for aid in _ARCH_MODULES}


def smoke_lm_config(cfg: LMConfig) -> LMConfig:
    """Shrink while preserving family traits (GQA ratio, MoE-ness)."""
    gqa = cfg.n_kv_heads < cfg.n_heads
    return dataclasses.replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if gqa else 4,
        d_ff=96,
        vocab=256,
        moe_experts=4 if cfg.moe_experts else 0,
        moe_top_k=2 if cfg.moe_experts else 0,
        attn_chunk=16,
        remat=False,
        fsdp=False,
        dtype=torch.float32,
    )
