"""Sampling baselines from the paper's evaluation (§III-A Baselines).

Counterpart of ``repro/core/sampling.py``:

- Random Sampling: ``ceil(alpha * (n_a + n_b))`` points drawn uniformly
  without replacement from each set (the paper sizes both baselines to
  ProHD's *total* fraction, so the comparison is subset-size-fair).
- Systematic Random Sampling: a random permutation, then every
  ``floor(n / k)``-th point.

Both then compute the exact HD of the two gathered subsets with a
caller-given scan (``scan(a_s, b_s) -> H``): the plain fused scan by
default, kernel 1 (``kernels.hausdorff.ops.hausdorff``) on the front
door's ``fused_cuda`` cell — "differences between approximate methods
arise solely from the selection step".

Randomness comes from a ``torch.Generator`` on the clouds' device; the
two sides draw in a fixed order, a's indices first, as the reference's
``jax.random.split`` gives a's key first.  The draw is its own function
(:func:`draw_indices`), so a test can feed the scan other indices.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.core import exact
from repro_torch.device import check_generator

__all__ = [
    "SAMPLERS",
    "sample_count",
    "random_sample_mask",
    "systematic_sample_mask",
    "draw_indices",
    "sampled_hd",
    "random_sampling_hd",
    "systematic_sampling_hd",
]

SAMPLERS = ("random", "systematic")

Scan = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def sample_count(n_a: int, n_b: int, alpha: float) -> int:
    """ceil(alpha * (n_a + n_b)) — the per-set budget used by the paper."""
    return max(1, math.ceil(alpha * (n_a + n_b)))


def _perm(generator: torch.Generator, n: int) -> torch.Tensor:
    return torch.randperm(n, generator=generator, device=generator.device)


def random_sample_mask(generator: torch.Generator, n: int, k: int) -> torch.Tensor:
    """Uniform sample of k of n indices, as a boolean mask."""
    mask = torch.zeros(n, dtype=torch.bool, device=generator.device)
    mask[_perm(generator, n)[: min(k, n)]] = True
    return mask


def systematic_sample_mask(generator: torch.Generator, n: int, alpha: float) -> torch.Tensor:
    """Random permutation then every floor(1/alpha)-th point."""
    mask = torch.zeros(n, dtype=torch.bool, device=generator.device)
    mask[_perm(generator, n)[:: max(1, int(1.0 / alpha))]] = True
    return mask


def draw_indices(
    generator: torch.Generator, n_a: int, n_b: int, alpha: float, sampler: str = "random"
) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows each baseline keeps, ``(ia, ib)``, a's drawn first.

    random: the first ``min(k, n)`` of a permutation (uniform, without
    replacement); systematic: every ``max(1, n // min(k, n))``-th of a
    permutation, with ``k = sample_count(n_a, n_b, alpha)``.
    """
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}; expected one of {SAMPLERS}")
    k = sample_count(n_a, n_b, alpha)
    out = []
    for n in (n_a, n_b):
        perm = _perm(generator, n)
        kn = min(k, n)
        out.append(perm[:kn] if sampler == "random" else perm[:: max(1, int(n / kn))])
    return out[0], out[1]


def _plain_scan(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The reference's default oracle: the plain fused scan, blocks 2048."""
    return exact.hausdorff_fused_tiled(x, y, block_a=2048, block_b=2048)


def sampled_hd(a: torch.Tensor, b: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
               scan: Scan) -> tuple[torch.Tensor, int]:
    """Exact HD of the gathered subsets ``a[ia]``, ``b[ib]`` (contiguous
    copies, so the cost is O(|ia|·|ib|·D)) and the subsets' total size."""
    a_s = a.index_select(0, ia.to(a.device))
    b_s = b.index_select(0, ib.to(b.device))
    return scan(a_s, b_s), int(ia.numel()) + int(ib.numel())


def _sampling_hd(sampler, generator, a, b, alpha, scan):
    check_generator(generator, a.device, f"{sampler} sampling")
    ia, ib = draw_indices(generator, a.shape[0], b.shape[0], alpha, sampler)
    return sampled_hd(a, b, ia, ib, scan)


def random_sampling_hd(generator: torch.Generator, a, b, alpha: float, *, scan: Scan = _plain_scan):
    """Paper baseline: uniform-sample both clouds, exact HD on the samples.
    Returns ``(hd, n_sampled)``."""
    return _sampling_hd("random", generator, a, b, alpha, scan)


def systematic_sampling_hd(generator: torch.Generator, a, b, alpha: float, *, scan: Scan = _plain_scan):
    """Paper baseline: permute + stride-sample both clouds, exact HD on the
    samples.  Returns ``(hd, n_sampled)``."""
    return _sampling_hd("systematic", generator, a, b, alpha, scan)
