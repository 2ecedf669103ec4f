"""deepseek-67b [dense] — llama-arch (arXiv:2401.02954).

134 GB of bf16 weights: one card cannot hold it, so the port runs it only
at ``smoke_lm_config`` size (in the CPU tests).
"""
from repro_torch.configs.base import LM_SHAPES, LMConfig

CONFIG = LMConfig(
    name="deepseek-67b",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,    # GQA
    d_ff=22016,
    vocab=102400,
    fsdp=True,       # 67B: params+optimizer must shard over data axes too
)
SHAPES = LM_SHAPES
