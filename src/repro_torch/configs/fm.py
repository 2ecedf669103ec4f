"""fm [recsys] — Factorization Machine (Rendle, ICDM'10), Criteo-style."""
from repro_torch.configs.base import RECSYS_SHAPES, RecsysConfig

CONFIG = RecsysConfig(
    name="fm",
    interaction="fm-2way",
    embed_dim=10,
    n_sparse=39,
    vocab_sizes=tuple([1_048_576] * 39),  # hashed per-field tables
    item_vocab=1_048_576,
)
SHAPES = RECSYS_SHAPES
