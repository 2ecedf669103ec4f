"""olmoe-1b-7b [moe] — 64 experts top-8 (arXiv:2409.02060)."""
from repro_torch.configs.base import LM_SHAPES, LMConfig

CONFIG = LMConfig(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,   # MHA
    d_ff=1024,       # per-expert FF (fine-grained experts)
    vocab=50304,
    moe_experts=64,
    moe_top_k=8,
)
SHAPES = LM_SHAPES
