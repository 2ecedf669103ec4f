"""Point-cloud generators for the paper's evaluation data.

Counterpart of ``repro/data/pointclouds.py``.  ``random_clouds`` is the
paper's own "Random Clouds" spec (§III-A), exact: uniform in [0,1]^D with
cloud B offset by +0.1 per coordinate.  ``gaussian_mixture_pca`` is the
MNIST/CIFAR-after-PCA proxy: an anisotropic Gaussian mixture with a
decaying spectrum.

Both draw from a ``torch.Generator`` and make the data on the generator's
device, so a seeded generator on ``cuda`` makes a 1 GiB cloud on the card
without a host copy.  The numbers differ from ``jax.random``'s for the same
seed; tests feed both packages the same numpy arrays instead.
"""
from __future__ import annotations

import torch

__all__ = ["random_clouds", "gaussian_mixture_pca", "make_generator"]


def make_generator(seed: int, device="cuda") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def random_clouds(gen: torch.Generator, n_a: int, n_b: int, d: int, *, offset: float = 0.1,
                  dtype=torch.float32):
    """Paper §III-A: uniform in the unit cube, B offset by +offset per coordinate."""
    a = torch.rand((n_a, d), generator=gen, device=gen.device, dtype=dtype)
    b = torch.rand((n_b, d), generator=gen, device=gen.device, dtype=dtype)
    b += offset
    return a, b


def gaussian_mixture_pca(
    gen: torch.Generator,
    n_a: int,
    n_b: int,
    d: int,
    *,
    n_modes: int = 10,
    spread: float = 4.0,
    decay: float = 0.85,
    dtype=torch.float32,
):
    """Multi-modal clusters under a fast-decaying spectrum (scale decay^k
    on coordinate k) — the regime where PCA directions carry the spread."""
    dev = gen.device
    scales = decay ** torch.arange(d, dtype=torch.float32, device=dev)
    centers_a = torch.randn((n_modes, d), generator=gen, device=dev) * spread * scales
    centers_b = torch.randn((n_modes, d), generator=gen, device=dev) * spread * scales
    ca = torch.randint(0, n_modes, (n_a,), generator=gen, device=dev)
    cb = torch.randint(0, n_modes, (n_b,), generator=gen, device=dev)
    a = torch.randn((n_a, d), generator=gen, device=dev).mul_(scales).add_(centers_a[ca])
    b = torch.randn((n_b, d), generator=gen, device=dev).mul_(scales).add_(centers_b[cb])
    return a.to(dtype), b.to(dtype)
