"""stablelm-3b [dense] — hf:stabilityai/stablelm-2-1_6b family (unverified)."""
from repro_torch.configs.base import LM_SHAPES, LMConfig

CONFIG = LMConfig(
    name="stablelm-3b",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,   # MHA
    d_ff=6912,
    vocab=50304,
)
SHAPES = LM_SHAPES
