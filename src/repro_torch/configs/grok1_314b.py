"""grok-1-314b [moe] — 8 experts top-2 (hf:xai-org/grok-1, unverified)."""
from repro_torch.configs.base import LM_SHAPES, LMConfig

CONFIG = LMConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,    # GQA
    d_ff=32768,      # per-expert FF
    vocab=131072,
    moe_experts=8,
    moe_top_k=2,
    fsdp=True,       # 314B total params
)
SHAPES = LM_SHAPES
