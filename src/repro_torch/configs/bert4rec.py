"""bert4rec [recsys] — bidirectional seq rec (arXiv:1904.06690)."""
from repro_torch.configs.base import RECSYS_SHAPES, RecsysConfig

CONFIG = RecsysConfig(
    name="bert4rec",
    interaction="bidir-seq",
    embed_dim=64,
    seq_len=200,
    n_blocks=2,
    n_heads=2,
    item_vocab=1_048_576,
)
SHAPES = RECSYS_SHAPES
