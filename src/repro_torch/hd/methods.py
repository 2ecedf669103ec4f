"""Registered implementations of the served (variant, method, backend) cells.

Counterpart of ``repro/hd/methods.py``.  Each adapter maps the uniform
front-door contract onto the estimator it serves
(``repro_torch.core.exact``, ``.prohd``, ``.variants``, ``.sampling``,
``.adaptive``, ``repro_torch.kernels.hausdorff.ops``)::

    impl(a, b, ctx: DispatchContext) -> (value, lower, upper, stats)

The served matrix (every other cell raises ``UnsupportedCombination``;
the reference's distributed cells are not ported yet)::

    (hausdorff, exact):    dense  tiled  fused_cuda
    (hausdorff, prohd):    dense  tiled  fused_cuda
    (hausdorff, sampling):        tiled  fused_cuda
    (hausdorff, adaptive):        tiled  fused_cuda
    (directed,  exact):    dense  tiled  fused_cuda
    (partial,   exact):    dense  tiled  fused_cuda
    (chamfer,   exact):    dense  tiled  fused_cuda

The reference serves sampling and adaptive on ``tiled`` alone, its
oracle being the one ProHD uses there.  On the card ProHD's oracle is
kernel 1, so the port also serves both on ``fused_cuda``, where the
subset scan (sampling) and every step's sweeps (adaptive) run kernel 1;
the two backends differ only in that scan.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import adaptive as adaptive_mod
from repro_torch.core import exact, sampling, tile_bounds, variants
from repro_torch.core.prohd import prohd as _prohd_call
from repro_torch.hd.config import HDConfig
from repro_torch.hd.registry import register
from repro_torch.kernels.hausdorff import ops as hd_ops

__all__ = ["DispatchContext"]

_SCAN_BACKENDS = ("dense", "tiled", "fused_cuda")


class DispatchContext(NamedTuple):
    """Everything an implementation needs beyond the two clouds."""

    valid_a: torch.Tensor | None
    valid_b: torch.Tensor | None
    # Randomised methods' source (sampling; prohd's rsvd/subspace PCA):
    # the counterpart of the reference's ``key``.
    generator: torch.Generator | None
    cfg: HDConfig
    block_a: int
    block_b: int
    # (proj_a, proj_b) per-row projections onto shared unit directions
    # (column 0 primary): certified projection pruning + skip_fraction.
    prune_projs: tuple[torch.Tensor, torch.Tensor] | None


def _reject_masks(ctx: DispatchContext, method: str) -> None:
    if ctx.valid_a is not None or ctx.valid_b is not None:
        raise ValueError(
            f"method={method!r} does not accept masks=; it selects its own "
            "subsets from full clouds (pre-filter the inputs)"
        )


def _require_generator(ctx: DispatchContext, method: str) -> torch.Generator:
    if ctx.generator is None:
        raise ValueError(f"method={method!r} is randomized and requires generator=")
    return ctx.generator


def _skip_stats(a, b, ctx: DispatchContext, *, directed: bool, block_a: int, block_b: int) -> dict:
    """skip_fraction of the tile grid the dispatched scan really ran."""
    if ctx.prune_projs is None:
        return {}
    proj_a, proj_b = ctx.prune_projs
    tables = tile_bounds.prune_tables(
        a, proj_a, ctx.valid_a, b, proj_b, ctx.valid_b, block_a, block_b, directed=directed
    )
    return {"skip_fraction": tile_bounds.skip_fraction(tables)}


# ---------------------------------------------------------------------------
# variant=hausdorff / directed, method=exact
# ---------------------------------------------------------------------------


@register("hausdorff", "exact", "dense")
def _hausdorff_exact_dense(a, b, ctx):
    v = exact.hausdorff_dense(a, b, valid_a=ctx.valid_a, valid_b=ctx.valid_b)
    return v, v, v, {}


@register("hausdorff", "exact", "tiled")
def _hausdorff_exact_tiled(a, b, ctx):
    v = exact.hausdorff_fused_tiled(
        a, b, valid_a=ctx.valid_a, valid_b=ctx.valid_b,
        block_a=ctx.block_a, block_b=ctx.block_b, prune_projs=ctx.prune_projs,
    )
    stats = _skip_stats(
        a, b, ctx, directed=False,
        block_a=min(ctx.block_a, a.shape[0]), block_b=min(ctx.block_b, b.shape[0]),
    )
    return v, v, v, stats


@register("hausdorff", "exact", "fused_cuda")
def _hausdorff_exact_cuda(a, b, ctx):
    v = hd_ops.hausdorff(
        a, b, valid_a=ctx.valid_a, valid_b=ctx.valid_b,
        prune_projs=ctx.prune_projs, block_a=ctx.block_a, block_b=ctx.block_b,
    )
    stats = _skip_stats(
        a, b, ctx, directed=False,
        block_a=hd_ops.fit_block(ctx.block_a, a.shape[0]),
        block_b=hd_ops.fit_block(ctx.block_b, b.shape[0]),
    )
    return v, v, v, stats


@register("directed", "exact", "dense")
def _directed_exact_dense(a, b, ctx):
    v = exact.directed_hd_dense(a, b, valid_a=ctx.valid_a, valid_b=ctx.valid_b)
    return v, v, v, {}


@register("directed", "exact", "tiled")
def _directed_exact_tiled(a, b, ctx):
    v = exact.directed_hd_tiled(
        a, b, valid_a=ctx.valid_a, valid_b=ctx.valid_b,
        block=ctx.block_b, prune_projs=ctx.prune_projs,
    )
    # the directed scan keeps all queries in ONE block (a single cut_a)
    stats = _skip_stats(
        a, b, ctx, directed=True, block_a=a.shape[0], block_b=min(ctx.block_b, b.shape[0]),
    )
    return v, v, v, stats


@register("directed", "exact", "fused_cuda")
def _directed_exact_cuda(a, b, ctx):
    v = hd_ops.directed_hausdorff(
        a, b, valid_a=ctx.valid_a, valid_b=ctx.valid_b,
        prune_projs=ctx.prune_projs, block_a=ctx.block_a, block_b=ctx.block_b,
    )
    stats = _skip_stats(
        a, b, ctx, directed=True,
        block_a=hd_ops.fit_block(ctx.block_a, a.shape[0]),
        block_b=hd_ops.fit_block(ctx.block_b, b.shape[0]),
    )
    return v, v, v, stats


# ---------------------------------------------------------------------------
# variant=partial / chamfer, method=exact: reductions of one fused scan
# ---------------------------------------------------------------------------


def _min_sqdists_both(a, b, ctx, backend: str):
    if backend == "fused_cuda":
        return hd_ops.fused_min_sqdists(
            a, b, valid_a=ctx.valid_a, valid_b=ctx.valid_b,
            block_a=ctx.block_a, block_b=ctx.block_b,
        )
    if backend == "tiled":
        return exact.fused_min_sqdists_tiled(
            a, b, valid_a=ctx.valid_a, valid_b=ctx.valid_b,
            block_a=ctx.block_a, block_b=ctx.block_b,
        )
    d2 = exact.pairwise_sqdist(a, b)
    if ctx.valid_b is not None:
        d2 = torch.where(ctx.valid_b[None, :], d2, torch.inf)
    min_a = d2.amin(dim=1)
    if ctx.valid_a is not None:
        d2 = torch.where(ctx.valid_a[:, None], d2, torch.inf)
    return min_a, d2.amin(dim=0)


def _partial_reduce(a, b, ctx, backend):
    min_a, min_b = _min_sqdists_both(a, b, ctx, backend)
    q = ctx.cfg.quantile
    return torch.maximum(
        variants.quantile_reduce(min_a, ctx.valid_a, a.shape[0], q),
        variants.quantile_reduce(min_b, ctx.valid_b, b.shape[0], q),
    )


def _chamfer_reduce(a, b, ctx, backend):
    min_a, min_b = _min_sqdists_both(a, b, ctx, backend)
    return variants.mean_min_dist(min_a, ctx.valid_a) + variants.mean_min_dist(min_b, ctx.valid_b)


def _register_minscan_variant(variant: str, reduce_fn) -> None:
    for backend in _SCAN_BACKENDS:

        @register(variant, "exact", backend)
        def impl(a, b, ctx, *, _backend=backend):
            return reduce_fn(a, b, ctx, _backend), None, None, {}


_register_minscan_variant("partial", _partial_reduce)
_register_minscan_variant("chamfer", _chamfer_reduce)


# ---------------------------------------------------------------------------
# method=prohd
# ---------------------------------------------------------------------------


def _register_prohd(backend: str) -> None:
    @register("hausdorff", "prohd", backend)
    def impl(a, b, ctx, *, _backend=backend):
        _reject_masks(ctx, "prohd")
        pc = ctx.cfg.prohd_config(_backend)
        est = _prohd_call(a, b, pc, generator=ctx.generator)
        lower = est.hd_proj if pc.compute_projected else None
        upper = est.hd_proj + est.bound if (pc.compute_projected and pc.compute_bound) else None
        stats = {"estimate": est, "n_sel_a": est.n_sel_a, "n_sel_b": est.n_sel_b}
        return est.hd, lower, upper, stats


for _b in _SCAN_BACKENDS:
    _register_prohd(_b)


# ---------------------------------------------------------------------------
# method=sampling / adaptive
# ---------------------------------------------------------------------------


def _subset_scan(backend: str, ctx: DispatchContext):
    """The exact scan of the sampled subsets: kernel 1 on ``fused_cuda``,
    the plain fused scan (the reference's block rule) on ``tiled``."""
    if backend == "fused_cuda":
        return hd_ops.hausdorff
    return lambda x, y: exact.hausdorff_fused_tiled(x, y, block_a=ctx.block_b, block_b=ctx.block_b)


def _register_sampling(backend: str) -> None:
    @register("hausdorff", "sampling", backend)
    def impl(a, b, ctx, *, _backend=backend):
        _reject_masks(ctx, "sampling")
        gen = _require_generator(ctx, "sampling")
        if ctx.cfg.sampler not in sampling.SAMPLERS:
            raise ValueError(f"unknown sampler {ctx.cfg.sampler!r}")
        fn = sampling.random_sampling_hd if ctx.cfg.sampler == "random" else sampling.systematic_sampling_hd
        hd, n = fn(gen, a, b, ctx.cfg.alpha, scan=_subset_scan(_backend, ctx))
        # Sampled-vs-sampled HD can land on either side of the truth (the
        # inner min inflates, the outer max deflates): no certified bounds.
        return hd, None, None, {"n_sampled": n}


def _register_adaptive(backend: str) -> None:
    @register("hausdorff", "adaptive", backend)
    def impl(a, b, ctx, *, _backend=backend):
        _reject_masks(ctx, "adaptive")
        cfg = ctx.cfg
        res = adaptive_mod.prohd_with_budget(
            a, b, budget=cfg.budget, relative=cfg.budget_relative, alpha0=cfg.adaptive_alpha0,
            max_alpha=cfg.adaptive_max_alpha, max_steps=cfg.adaptive_max_steps,
            generator=ctx.generator, backend=_backend,
        )
        est = res.estimate
        stats = {"adaptive": res, "estimate": est, "n_sel_a": est.n_sel_a, "n_sel_b": est.n_sel_b}
        return est.hd, est.hd_proj, est.hd_proj + est.bound, stats


for _b in ("tiled", "fused_cuda"):
    _register_sampling(_b)
    _register_adaptive(_b)
