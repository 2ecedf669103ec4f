"""``repro_torch.core`` — the estimators behind the ``repro_torch.hd`` front door.

Submodules are imported by path (``repro_torch.core.prohd``,
``.exact``, ``.masked``, …).  The package re-exports the substrate the
reference's ``repro.core`` re-exports (selection config and results, the
directed/tiled oracles, the fused scan, tile bounds) and the multi-device
entry points::

    from repro_torch.core import ProHDConfig, fused_min_sqdists_tiled, prune_tables
    from repro_torch.core import ShardedCloud, distributed_exact_hd, distributed_prohd

The reference's ``DeprecationWarning`` shims (``prohd``,
``hausdorff_tiled``, ``chamfer``, …) are not ported: the front door
``repro_torch.hd.set_distance`` serves them.
"""
from repro_torch.core.adaptive import AdaptiveResult
from repro_torch.core.distributed import (
    ShardedCloud,
    batch_group,
    batch_size,
    distributed_exact_hd,
    distributed_prohd,
)
from repro_torch.core.exact import (
    directed_hd_dense,
    directed_hd_earlybreak,
    directed_hd_tiled,
    fused_min_sqdists_tiled,
    hausdorff_earlybreak,
    hausdorff_twosweep_tiled,
)
from repro_torch.core.prohd import ProHDConfig, ProHDEstimate, prohd_masks
from repro_torch.core.tile_bounds import PruneTables, order_by_projection, prune_tables

__all__ = [
    "ProHDConfig",
    "ProHDEstimate",
    "prohd_masks",
    "directed_hd_dense",
    "directed_hd_tiled",
    "directed_hd_earlybreak",
    "fused_min_sqdists_tiled",
    "hausdorff_twosweep_tiled",
    "hausdorff_earlybreak",
    "PruneTables",
    "order_by_projection",
    "prune_tables",
    "AdaptiveResult",
    "ShardedCloud",
    "batch_group",
    "batch_size",
    "distributed_exact_hd",
    "distributed_prohd",
]
