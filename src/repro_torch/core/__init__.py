"""``repro_torch.core`` — the estimators behind the ``repro_torch.hd`` front door.

Submodules are imported by path (``repro_torch.core.prohd``,
``.exact``, ``.masked``, …); the package itself exports the multi-device
entry points::

    from repro_torch.core import ShardedCloud, distributed_exact_hd, distributed_prohd
"""
from repro_torch.core.distributed import (
    ShardedCloud,
    batch_group,
    batch_size,
    distributed_exact_hd,
    distributed_prohd,
)

__all__ = [
    "ShardedCloud",
    "batch_group",
    "batch_size",
    "distributed_exact_hd",
    "distributed_prohd",
]
