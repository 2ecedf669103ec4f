"""bst [recsys] — Behavior Sequence Transformer, Alibaba (arXiv:1905.06874)."""
from repro_torch.configs.base import RECSYS_SHAPES, RecsysConfig

CONFIG = RecsysConfig(
    name="bst",
    interaction="transformer-seq",
    embed_dim=32,
    seq_len=20,
    n_blocks=1,
    n_heads=8,
    mlp_dims=(1024, 512, 256),
    item_vocab=20_971_520,   # Taobao-scale item table
)
SHAPES = RECSYS_SHAPES
