"""tinyllama-1.1b [dense] — llama2-arch small (arXiv:2401.02385)."""
from repro_torch.configs.base import LM_SHAPES, LMConfig

CONFIG = LMConfig(
    name="tinyllama-1.1b",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,    # GQA
    d_ff=5632,
    vocab=32000,
)
SHAPES = LM_SHAPES
