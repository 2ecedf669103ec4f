"""Streaming HD drift monitor — the paper's vector-database use case.

Counterpart of ``repro/core/streaming.py``: "A quick Hausdorff distance
approximation can ... track distributional drift in a vector database"
(§I-A).  A fixed reference set plus a reservoir of recent vectors; every
:func:`check_drift` runs ProHD between them through the front door and
reports the estimate with its certified interval, intersected with a
second certified interval from set summaries (the reference's summary is
computed once, at init)::

    cfg = DriftMonitorConfig(window=65_536, dim=256, threshold=6.0,
                             prohd=ProHDConfig(alpha=0.05, subset_backend="cuda"))
    state = init_drift_monitor(cfg, reference, torch.Generator("cuda").manual_seed(0))
    state = observe(state, batch)          # a new state; the old one is unchanged
    rep = check_drift(state, cfg)          # rep.hd, rep.lower, rep.upper, rep.alert

The state is functional: :func:`observe` returns a new one and leaves the
old state's buffer and generator as they were.  Its reservoir is Vitter's
Algorithm R, one vectorised pass per batch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core.prohd import ProHDConfig as _ProHDConfig
from repro_torch.device import as_tensor, check_generator, clone_generator

__all__ = [
    "DriftMonitorConfig",
    "DriftState",
    "DriftReport",
    "init_drift_monitor",
    "observe",
    "check_drift",
]


@dataclasses.dataclass(frozen=True)
class DriftMonitorConfig:
    """Reservoir + ProHD settings for online drift detection."""

    window: int = 4096           # reservoir capacity of "recent" vectors
    dim: int = 64
    prohd: _ProHDConfig = _ProHDConfig(alpha=0.05)
    # Alert when the certified lower bound of H exceeds this.
    threshold: float = math.inf


class DriftState(NamedTuple):
    reference: torch.Tensor      # (n_ref, dim) frozen reference set
    buffer: torch.Tensor         # (window, dim) reservoir
    count: int                   # total vectors observed
    generator: torch.Generator   # reservoir-sampling randomness
    # The reference's SetSummary on ``directions``, computed once at init:
    # each check only summarises the reservoir.
    ref_summary: Any             # repro_torch.index.store.SetSummary
    directions: torch.Tensor     # (dim, m) shared direction bank


class DriftReport(NamedTuple):
    hd: torch.Tensor        # point estimate (paper-faithful)
    lower: torch.Tensor     # certified lower bound on true H
    upper: torch.Tensor     # certified upper bound on true H
    alert: torch.Tensor     # bool: certified lower bound crossed threshold


def _all_valid(x: torch.Tensor) -> torch.Tensor:
    return torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)


def init_drift_monitor(cfg: DriftMonitorConfig, reference, generator: torch.Generator, *,
                       device=None) -> DriftState:
    """A monitor whose reservoir starts as ``window`` copies of the
    reference's mean, summarised on ``index.store.direction_bank(cfg.dim)``.
    ``generator`` must be on the reference's device."""
    from repro_torch.index.store import direction_bank, summarize_set

    reference = as_tensor(reference, device)
    check_generator(generator, reference.device, "the drift monitor")
    buf = reference.mean(dim=0).expand(cfg.window, cfg.dim).to(reference.dtype).contiguous()
    dirs = direction_bank(cfg.dim, device=reference.device)
    ref_summary, _ = summarize_set(reference, _all_valid(reference), dirs)
    return DriftState(reference=reference, buffer=buf, count=0, generator=generator,
                      ref_summary=ref_summary, directions=dirs)


def observe(state: DriftState, batch) -> DriftState:
    """Fold a batch of vectors into the reservoir (Vitter's Algorithm R).

    While the buffer warms up, arrivals fill it in order; afterwards the
    arrival with count c (vectors seen before it) replaces a uniformly
    drawn slot with probability window / (c + 1).  Where several arrivals
    of one batch take the same slot, the last one wins, as in a sequential
    pass: the winner of each slot is the largest kept arrival index
    (``scatter_reduce`` amax), then one gather.  No host sync.
    """
    buf = state.buffer
    window = buf.shape[0]
    batch = as_tensor(batch, buf.device).to(buf.dtype)
    n = batch.shape[0]
    c0 = state.count
    n_warm = max(0, min(n, window - c0))
    if n_warm:
        buf = torch.slice_scatter(buf, batch[:n_warm], dim=0, start=c0, end=c0 + n_warm)
    gen = state.generator
    n_cold = n - n_warm
    if n_cold:
        gen = clone_generator(gen)
        dev = buf.device
        seen = torch.arange(c0 + n_warm, c0 + n, device=dev, dtype=torch.float64)
        pos = torch.randint(0, window, (n_cold,), generator=gen, device=dev)
        keep = torch.rand(n_cold, generator=gen, device=dev, dtype=torch.float64) < window / (seen + 1.0)
        arrival = torch.where(keep, torch.arange(n_cold, device=dev), -1)
        winner = torch.full((window,), -1, dtype=torch.int64, device=dev).scatter_reduce(
            0, pos, arrival, reduce="amax")
        cold = batch[n_warm:]
        buf = torch.where((winner >= 0)[:, None], cold[winner.clamp(min=0)], buf)
    return state._replace(buffer=buf, count=c0 + n, generator=gen)


def _summary_interval(state: DriftState, dim: int):
    """The reservoir's summary against the reference's: certified (lower,
    upper) on H, widened by the fp32 margin."""
    from repro_torch.index import bound_scale, certified_margins, interval_bounds
    from repro_torch.index.store import summarize_set

    buf_summary, _ = summarize_set(state.buffer, _all_valid(state.buffer), state.directions)
    return certified_margins(
        *interval_bounds(state.ref_summary, buf_summary),
        bound_scale(state.ref_summary, buf_summary),
        dim,
    )


def check_drift(state: DriftState, cfg: DriftMonitorConfig, *,
                generator: torch.Generator | None = None) -> DriftReport:
    """ProHD between the reference set and the current reservoir, through
    the ``repro_torch.hd`` front door on ``cfg.prohd.subset_backend``'s
    cell (``"cuda"`` → ``fused_cuda``, kernel 1).

    Its interval is intersected with the summary interval, so an
    estimator config with no certificate of its own (``compute_projected``
    or ``compute_bound`` off) still gets a non-vacuous one.  ``generator``
    is passed on for the randomised PCA backends.
    """
    from repro_torch import hd as _hd

    res = _hd.set_distance(
        state.reference, state.buffer, variant="hausdorff", method="prohd",
        backend=_hd.BACKEND_FOR_SUBSET[cfg.prohd.subset_backend],
        config=_hd.HDConfig(prohd=cfg.prohd), generator=generator,
    )
    lb0, ub0 = _summary_interval(state, cfg.dim)
    zero = torch.zeros((), dtype=torch.float32, device=lb0.device)
    lower = torch.clamp(res.lower, min=0.0) if res.lower is not None else zero
    upper = res.upper if res.upper is not None else torch.full_like(zero, math.inf)
    lower = torch.maximum(lower, lb0)
    upper = torch.minimum(upper, ub0)
    return DriftReport(hd=res.value, lower=lower, upper=upper, alert=lower > cfg.threshold)
