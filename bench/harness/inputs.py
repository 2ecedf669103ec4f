"""The benchmark's own input generators, drawn from the run's seed.

A copy of the program's generator, frozen here so that a later change to
the program cannot change the yardstick:

- :func:`fill_random_clouds` is ``repro_torch.data.pointclouds.random_clouds``
  (the paper's Random Clouds, sec. III-A), drawn in place into buffers the
  loop keeps, so a closed loop of fresh pairs allocates nothing per call.

Every draw takes its own ``torch.Generator`` seeded by :func:`sub_seed`, so
step ``i`` of a run sees the same inputs whether or not steps before it
ran, and the check after the window draws them again.
"""
from __future__ import annotations

import hashlib
import random

import torch

__all__ = ["sub_seed", "generator", "sampled", "fill_random_clouds"]


def sub_seed(seed: int, *tag) -> int:
    """A 63-bit seed for the stream ``tag`` of run ``seed`` (any int seed)."""
    h = hashlib.blake2b(repr((int(seed),) + tag).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def generator(seed: int, device, *tag) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *tag))
    return g


def sampled(records: list[dict], n, seed: int, all_steps: bool = False) -> list[dict]:
    """The steps a run compares: ``n`` of ``records`` drawn from the seed,
    or all of them (``n == "all"``, ``all_steps``, or ``n`` at least their
    count)."""
    if all_steps or n == "all" or n >= len(records):
        return list(records)
    rng = random.Random(sub_seed(seed, "sample"))
    return sorted(rng.sample(records, int(n)), key=lambda r: r["step"])


def fill_random_clouds(gen: torch.Generator, a: torch.Tensor, b: torch.Tensor, offset: float) -> None:
    """Paper sec. III-A into ``a`` and ``b``: uniform in the unit cube, B
    offset by ``offset`` a coordinate."""
    a.uniform_(0.0, 1.0, generator=gen)
    b.uniform_(0.0, 1.0, generator=gen)
    b.add_(offset)
