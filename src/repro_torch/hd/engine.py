"""The front door: ``set_distance`` and ``HDEngine``.

Counterpart of ``repro/hd/engine.py``::

    from repro_torch.hd import HDConfig, set_distance

    res = set_distance(a, b)                               # exact, on the card
    res = set_distance(a, b, method="prohd",
                       config=HDConfig(alpha=0.02))        # certified estimate
    res = set_distance(a, b, variant="chamfer", device="cpu")
    res = set_distance(a, b, method="sampling",
                       generator=torch.Generator("cuda").manual_seed(1))
    res = set_distance(a_rows, b_rows, backend="distributed",
                       mesh=mesh)                  # SPMD: this rank's rows

Device rule (``repro_torch.device``): numpy inputs go to ``cuda`` unless
``device=`` says otherwise; tensors stay where they are; with no GPU and
no CPU request the call raises.  ``backend="auto"`` and the block sizes
are resolved once per call from the shapes, the device kind and the
mesh's batch group.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch.core import distributed as dist_mod
from repro_torch.device import as_mask, as_tensor, strict_fp32
from repro_torch.hd import registry, resolver
from repro_torch.hd.config import HDConfig
from repro_torch.hd.methods import DispatchContext
from repro_torch.hd.result import HDMeta, HDResult
from repro_torch.obs import trace as _obs

__all__ = ["set_distance", "HDEngine"]


def _reject_nonfinite(name: str, cloud: torch.Tensor, valid: torch.Tensor | None) -> None:
    """NaN/Inf on a valid row is an error; masked-out rows may hold garbage.

    Runs on the cloud's own device; only one boolean comes to the host.
    """
    finite = torch.isfinite(cloud).all(dim=-1)
    if valid is not None:
        finite = finite | ~valid
    if not bool(finite.all()):
        bad = int(torch.argmin(finite.to(torch.int8)))
        raise ValueError(
            f"cloud {name!r} has non-finite coordinates on valid row {bad} "
            "(NaN/Inf); certified intervals are undefined over them — "
            "clean the input, mask the row out, or pass validate=False"
        )


def set_distance(
    a,
    b,
    *,
    variant: str = "hausdorff",
    method: str = "exact",
    backend: str = "auto",
    masks: tuple[Any, Any] | None = None,
    config: HDConfig | None = None,
    prune_projs: tuple[Any, Any] | None = None,
    generator: torch.Generator | None = None,
    mesh: Any | None = None,
    batch_axes: tuple[str, ...] = ("data",),
    measure: bool = False,
    validate: bool = True,
    device: str | torch.device | None = None,
) -> HDResult:
    """A set distance between clouds ``a`` (n_a, D) and ``b`` (n_b, D).

    variant  — hausdorff | directed | partial | chamfer
    method   — exact | prohd | sampling | adaptive
    backend  — dense | tiled | fused_cuda | distributed | auto (default)
    masks    — optional (valid_a, valid_b) row-validity masks; honoured by
               the exact variants and by distributed ProHD, rejected by
               single-device prohd, sampling and adaptive
    config   — HDConfig (alpha, quantile, blocks, …)
    prune_projs — optional (proj_a, proj_b) projections enabling certified
               projection pruning on the exact scans (adds ``skip_fraction``)
    generator — torch.Generator on the clouds' device for the randomised
               methods (sampling; prohd's rsvd/subspace PCA): the
               counterpart of the reference's ``key``
    mesh     — a ``torch.distributed`` DeviceMesh: required by the
               distributed backend, which ``auto`` picks when the batch
               group has more than one rank.  Under it every rank of the
               group calls ``set_distance`` with its own rows (equal row
               counts on every rank, padding masked out) and gets the
               replicated result
    batch_axes — the mesh dims whose ranks row-shard the clouds
    measure  — synchronise the device and record wall time in ``meta.elapsed_s``
               (distributed: the local device, then the batch group)
    validate — reject NaN/Inf on valid rows (default True)
    device   — where numpy inputs go (default ``cuda``); tensors keep their own

    Unserved cells raise :class:`repro_torch.hd.registry.UnsupportedCombination`.
    """
    registry.validate_axes(variant, method, backend)
    strict_fp32()
    cfg = config if config is not None else HDConfig()
    a = as_tensor(a, device)
    b = as_tensor(b, a.device)
    with _obs.span("hd.set_distance", device=a.device, variant=variant, method=method) as sp:
        valid_a, valid_b = (None, None) if masks is None else masks
        valid_a = as_mask(valid_a, a.device)
        valid_b = as_mask(valid_b, a.device)
        if prune_projs is not None:
            prune_projs = tuple(as_tensor(p, a.device) for p in prune_projs)
        if validate:
            with _obs.span("hd.validate", device=a.device):
                _reject_nonfinite("a", a, valid_a)
                _reject_nonfinite("b", b, valid_b)
        n_a, d = a.shape
        n_b = b.shape[0]
        kind = a.device.type

        if backend == "auto":
            n_devices = dist_mod.batch_size(mesh, batch_axes) if mesh is not None else 1
            backend = resolver.resolve_backend(
                variant, method, n_a, n_b, d, device_kind=kind, n_devices=n_devices,
            )
        impl = registry.resolve(variant, method, backend)
        sp.set(backend=backend, n_a=n_a, n_b=n_b, d=d)

        block_a, block_b = cfg.block_a, cfg.block_b
        if block_a is None or block_b is None:
            rba, rbb = resolver.resolve_block_sizes(n_a, n_b, d, device_kind=kind, backend=backend)
            block_a = rba if block_a is None else block_a
            block_b = rbb if block_b is None else block_b

        ctx = DispatchContext(
            valid_a=valid_a, valid_b=valid_b, generator=generator, cfg=cfg,
            block_a=block_a, block_b=block_b, prune_projs=prune_projs,
            mesh=mesh, batch_axes=tuple(batch_axes),
        )
        t0 = time.perf_counter() if measure else 0.0
        value, lower, upper, stats = impl(a, b, ctx)
        elapsed = None
        if measure:
            if kind == "cuda":
                torch.cuda.synchronize(a.device)
            if backend == "distributed":
                torch.distributed.barrier(group=dist_mod.batch_group(mesh, batch_axes))
            elapsed = time.perf_counter() - t0

        meta = HDMeta(
            variant=variant, method=method, backend=backend,
            block_a=block_a, block_b=block_b, elapsed_s=elapsed,
        )
        return HDResult(value=value, lower=lower, upper=upper, stats=stats, meta=meta)


@dataclasses.dataclass(frozen=True)
class HDEngine:
    """One frozen dispatch decision, callable like the estimator it names::

        engine = HDEngine(method="prohd", config=HDConfig(alpha=0.05))
        res = engine(a, b)
    """

    variant: str = "hausdorff"
    method: str = "exact"
    backend: str = "auto"
    config: HDConfig = HDConfig()

    def __call__(self, a, b, *, masks=None, prune_projs=None, generator=None, mesh=None,
                 batch_axes: tuple[str, ...] = ("data",), measure: bool = False,
                 validate: bool = True, device=None) -> HDResult:
        return set_distance(
            a, b,
            variant=self.variant, method=self.method, backend=self.backend,
            masks=masks, config=self.config, prune_projs=prune_projs, generator=generator,
            mesh=mesh, batch_axes=batch_axes, measure=measure, validate=validate, device=device,
        )
