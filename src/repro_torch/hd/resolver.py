"""Pure backend / block-size resolution for ``backend="auto"``.

Counterpart of ``repro/hd/resolver.py``: plain Python over static facts,
testable anywhere.  The device kind is the input tensor's
(``tensor.device.type``: ``"cuda"`` or ``"cpu"``), passed in by the engine.

Where this differs from the reference:

  * ``distributed`` is picked when the mesh's BATCH group (the ranks of
    ``batch_axes``) has more than one rank; the reference counts every
    device of the mesh.

  * On ``cuda``, every single-device dispatch (exact, prohd, sampling,
    adaptive) resolves to ``fused_cuda`` at any size — the reference's small-input ``dense``
    escape is not taken, so the plain versions never carry the main path
    on the card.
  * On ``fused_cuda`` the blocks are the kernel's prune-table granularity
    (``kernels.hausdorff.hausdorff.TABLE_BLOCK``), not the TPU's 512/512
    VMEM rule: they decide which tiles a prune table can gate, never
    which values come out.
  * On ``cpu`` the reference's rules hold: ``dense`` below the tile
    threshold, the plain fused scan (``tiled``) above it (sampling and
    adaptive, which have no ``dense`` cell: ``tiled`` at any size), blocks
    4096/4096 at D ≤ 64 and 2048/2048 above.
  * The corpus search's bucket passes (:func:`resolve_masked_backend`) take
    the batched bucket kernel on ``cuda`` and its plain version on ``cpu``;
    the device kind is the store's and the query's, not a global default.
    The TPU's 512/512 block rule is not copied: kernel 2's tile is fixed,
    and blocks only reach the plain per-pair backends.
  * ``search_batch``'s stage 2a (:func:`resolve_multiquery_backend`) takes
    the multi-query bucket kernel on ``cuda`` and its plain version
    everywhere else; the reference's TPU rule has no counterpart.
"""
from __future__ import annotations

from repro_torch.hd import registry
from repro_torch.kernels.hausdorff import hausdorff as _kernel

__all__ = [
    "TILE_THRESHOLD",
    "resolve_backend",
    "resolve_block_sizes",
    "resolve_masked_backend",
    "resolve_multiquery_backend",
    "resolve_anytime_refine_cap",
]

# Below this many rows on a side, one dense GEMM beats the scan machinery
# on the CPU.
TILE_THRESHOLD = 512

# At D ≤ 64 bigger (4096) tiles amortise the CPU scan's loop overhead best;
# at high D the d² tile dominates cache and 2048 wins.
LOW_D = 64


def resolve_backend(
    variant: str,
    method: str,
    n_a: int,
    n_b: int,
    d: int,
    *,
    device_kind: str = "cpu",
    n_devices: int = 1,
) -> str:
    """A concrete, registered backend for ``backend="auto"``; ``n_devices``
    is the size of the mesh's batch group (1 without a mesh)."""
    supported = registry.supported_backends(variant, method)
    if not supported:
        raise registry.UnsupportedCombination(variant, method, "auto")

    def pick(*prefs: str) -> str:
        for p in prefs:
            if p in supported:
                return p
        return supported[0]

    if n_devices > 1 and "distributed" in supported:
        return "distributed"
    if device_kind == "cuda":
        return pick("fused_cuda", "tiled", "dense")
    if min(n_a, n_b) < TILE_THRESHOLD:
        return pick("dense", "tiled")
    return pick("tiled", "dense")


def resolve_block_sizes(
    n_a: int,
    n_b: int,
    d: int,
    *,
    device_kind: str = "cpu",
    backend: str = "tiled",
) -> tuple[int, int]:
    """(block_a, block_b) defaults; entry points clamp them to the clouds."""
    del n_a, n_b, device_kind
    if backend == "fused_cuda":
        return _kernel.TABLE_BLOCK, _kernel.TABLE_BLOCK
    if d <= LOW_D:
        return 4096, 4096
    return 2048, 2048


def resolve_masked_backend(device_kind: str = "cpu") -> str:
    """The ``core.masked.EXACT_MASKED_BACKENDS`` name for the cascade's
    bucket passes (stages 1 and 2a): the batched bucket kernel on the card
    (``batched_cuda``), its plain version on the CPU (``batched_mirror``)."""
    if device_kind == "cuda":
        return "batched_cuda"
    return "batched_mirror"


def resolve_multiquery_backend(device_kind: str = "cpu") -> str:
    """The ``core.masked.EXACT_MASKED_BACKENDS`` name for ``search_batch``'s
    multi-query bucket passes (stage 2a): the multi-query bucket kernel on
    the card (``multiquery_cuda``), its plain version elsewhere
    (``multiquery_mirror``)."""
    if device_kind == "cuda":
        return "multiquery_cuda"
    return "multiquery_mirror"


def resolve_anytime_refine_cap(n_sets: int, budget: int | None) -> int:
    """Cap on raw exact refines the anytime drain may spend: ``n_sets``
    when unbounded (a drain that refines every candidate has resolved the
    frontier), else the budget clamped into [0, n_sets]."""
    if budget is None:
        return int(n_sets)
    return max(0, min(int(budget), int(n_sets)))
