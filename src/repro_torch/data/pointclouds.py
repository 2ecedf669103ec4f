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

``clustered_sets`` is the retrieval corpus: host-side numpy, drawn from
``np.random.RandomState(seed)`` exactly as the reference draws after its
seed line, so one int seed gives both packages the same sets bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "random_clouds",
    "gaussian_mixture_pca",
    "higgs_like",
    "make_generator",
    "make_dataset",
    "clustered_sets",
]


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


def higgs_like(gen: torch.Generator, n_a: int, n_b: int, *, d: int = 28, dtype=torch.float32):
    """Higgs proxy: two overlapping anisotropic clouds at D = 28 (signal vs
    background share most of the feature space; tails differ)."""
    dev = gen.device
    mixing = torch.randn((d, d), generator=gen, device=dev) / d**0.5
    a = torch.randn((n_a, d), generator=gen, device=dev) @ mixing
    shift = torch.zeros(d, device=dev)
    shift[: d // 4] = 0.8
    b = torch.randn((n_b, d), generator=gen, device=dev) @ mixing * 1.15 + shift
    return a.to(dtype), b.to(dtype)


def make_dataset(name: str, gen: torch.Generator, n_a: int, n_b: int, d: int, **kw):
    """Dataset factory used by benchmarks: 'random' | 'image' | 'higgs'."""
    if name == "random":
        return random_clouds(gen, n_a, n_b, d, **kw)
    if name == "image":
        return gaussian_mixture_pca(gen, n_a, n_b, d, **kw)
    if name == "higgs":
        return higgs_like(gen, n_a, n_b, d=d, **kw)
    raise ValueError(f"unknown dataset {name!r}")


def clustered_sets(
    seed: int,
    n_sets: int,
    d: int,
    *,
    sizes: tuple[int, ...] = (64, 128, 256),
    n_clusters: int = 32,
    spread: float = 10.0,
    sigma: float = 0.5,
):
    """Separated-clusters corpus: ``n_sets`` ragged point sets for retrieval.

    Each set is a Gaussian blob (σ = ``sigma``) around one of ``n_clusters``
    centers drawn N(0, spread²) per coordinate, with its size drawn from
    ``sizes``.  Returns ``(sets, labels)``: a list of (n_i, d) float32 numpy
    arrays and an (n_sets,) int array of cluster assignments.  The reference
    derives ``seed`` from a ``jax.random`` key; from there the draws are
    the same.
    """
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_clusters, d).astype(np.float32) * spread
    labels = rng.randint(0, n_clusters, size=n_sets)
    sets = []
    for i in range(n_sets):
        n = int(rng.choice(sizes))
        pts = centers[labels[i]] + rng.randn(n, d).astype(np.float32) * sigma
        sets.append(pts)
    return sets, labels
