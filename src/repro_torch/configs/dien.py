"""dien [recsys] — Deep Interest Evolution Network (arXiv:1809.03672)."""
from repro_torch.configs.base import RECSYS_SHAPES, RecsysConfig

CONFIG = RecsysConfig(
    name="dien",
    interaction="augru",
    embed_dim=18,
    seq_len=100,
    gru_dim=108,
    mlp_dims=(200, 80),
    # (item, category, user-profile) hash sizes — production-scale tables
    vocab_sizes=(10_000_000, 100_000, 1_000_000),
    item_vocab=10_000_000,
)
SHAPES = RECSYS_SHAPES
