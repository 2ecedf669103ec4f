"""The port's randomised PCA backends held to ``repro.core.projections``.

``rsvd`` and ``subspace`` run on the reference's own start matrix (the
Gaussian draw ``jax.random.normal(key, …)`` the reference makes inside
``_pca_rsvd`` / ``_pca_subspace``), so both packages iterate from one
start; ``qr`` and ``svd`` fix no sign, so subspaces are compared as
projectors U·Uᵀ, on data whose spectrum has a gap λ_m/λ_{m+1} ≥ 2.  The
port's own draws are checked for orthonormality, for captured variance
against ``gram`` on the reference's ``higgs_like`` data (the bounds of
``tests/test_core.py``), and, through ProHD, for a certificate that
brackets the exact distance.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.hd as jhd  # noqa: E402
from repro.data.pointclouds import higgs_like  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import exact, projections  # noqa: E402
from repro_torch.core.fp_margin import fp_value_margin  # noqa: E402
from repro_torch.core.prohd import ProHDConfig, prohd, prohd_masks  # noqa: E402
from repro_torch.hd import HDConfig, set_distance  # noqa: E402

jproj = importlib.import_module("repro.core.projections")


def _gapped(seed, n, d, m, gap=4.0):
    """n points whose covariance has λ_m/λ_{m+1} ≈ gap² under a random rotation."""
    rng = np.random.default_rng(seed)
    scales = np.concatenate([np.linspace(3.0, 2.0, m) * gap, np.linspace(1.0, 0.5, d - m)])
    rot, _ = np.linalg.qr(rng.standard_normal((d, d)))
    z = (rng.standard_normal((n, d)) * scales) @ rot.T + rng.standard_normal(d) * 5
    return z.astype(np.float32)


def _projector(u):
    u = np.asarray(u, np.float64)
    return u @ u.T


def _spectral_ratio(z, m):
    zc = z.astype(np.float64) - z.astype(np.float64).mean(0)
    w = np.linalg.eigvalsh(zc.T @ zc)[::-1]
    return w[m - 1] / w[m]


@pytest.mark.parametrize("method", ["rsvd", "subspace"])
@pytest.mark.parametrize("seed,n,d,m", [(0, 3000, 16, 4), (1, 5000, 64, 8), (2, 800, 24, 1)])
def test_iteration_on_reference_start_matches_reference_subspace(method, seed, n, d, m):
    z = _gapped(seed, n, d, m)
    assert _spectral_ratio(z, m) >= 2.0
    key = jax.random.PRNGKey(seed)
    jz = jnp.asarray(z)
    jmean = jnp.mean(jz, axis=0)
    tz = interop.cloud(z, "cpu")
    tmean = tz.mean(dim=0)
    if method == "rsvd":
        ref = jproj._pca_rsvd(jz, jmean, m, key=key)
        omega = jax.random.normal(key, (d, projections.rsvd_cols(d, m)), dtype=jnp.float32)
        port = projections._pca_rsvd(tz, tmean, m, omega=torch.from_numpy(np.array(omega)))
    else:
        ref = jproj._pca_subspace(jz, jmean, m, key=key)
        start = jax.random.normal(key, (d, m), dtype=jnp.float32)
        port = projections._pca_subspace(tz, tmean, m, start=torch.from_numpy(np.array(start)))
    assert port.shape == (d, m)
    np.testing.assert_allclose(_projector(port), _projector(ref), atol=1e-3)
    # and both are gram's (exact) subspace on gapped data
    gram = projections.pca_directions(tz, m)
    np.testing.assert_allclose(_projector(port), _projector(gram), atol=1e-3)


@pytest.mark.parametrize("method", ["gram", "rsvd", "subspace"])
def test_port_draws_are_orthonormal(method):
    z = _gapped(3, 2000, 16, 4)
    u = projections.pca_directions(interop.cloud(z, "cpu"), 4, method=method,
                                   generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(u.T @ u, np.eye(4), atol=1e-5)


def test_captured_variance_against_gram_on_higgs_like():
    # As tests/test_core.py: the invariant every backend shares on a
    # near-flat spectrum is the captured variance trace(UᵀCU).
    a, b = (np.array(x) for x in higgs_like(jax.random.PRNGKey(42), 2000, 2000))
    z = interop.cloud(np.concatenate([a, b]), "cpu")
    zc = (z - z.mean(0)).double()
    cov = zc.T @ zc
    var = {}
    for method in ("gram", "rsvd", "subspace"):
        u = projections.pca_directions(z, 3, method=method, generator=torch.Generator().manual_seed(42))
        var[method] = float(torch.trace(u.double().T @ cov @ u.double()))
    assert var["rsvd"] >= 0.97 * var["gram"]
    assert var["subspace"] >= 0.94 * var["gram"]


def test_randomised_methods_require_a_generator_on_the_data_device():
    z = interop.cloud(_gapped(4, 100, 8, 2), "cpu")
    a, b = z[:50], z[50:]
    for method in ("rsvd", "subspace"):
        with pytest.raises(ValueError, match="requires a generator"):
            projections.pca_directions(z, 2, method=method)
        with pytest.raises(ValueError, match="requires a generator"):
            projections.direction_set(a, b, 2, method=method)
        cfg = ProHDConfig(alpha=0.1, pca_method=method)
        with pytest.raises(ValueError, match="requires a generator"):
            prohd(a, b, cfg)
        with pytest.raises(ValueError, match="requires a generator"):
            prohd_masks(a, b, cfg)
    with pytest.raises(ValueError, match="unknown PCA method"):
        projections.pca_directions(z, 2, method="lanczos", generator=torch.Generator())
    with pytest.raises(ValueError, match="generator is on 'cpu'"):
        projections.random_start(torch.Generator(), 8, 2, torch.device("cuda"))
    # gram needs none and ignores one
    u0 = projections.direction_set(a, b, 2)
    u1 = projections.direction_set(a, b, 2, generator=torch.Generator())
    assert torch.equal(u0, u1)


@pytest.mark.parametrize("method", ["rsvd", "subspace"])
@pytest.mark.parametrize("backend", ["tiled", "fused_cuda"])
def test_prohd_with_randomised_pca_is_certified_like_the_reference(method, backend):
    # Whole slice: the front door's prohd cell with the randomised PCA
    # against the reference's front door on the same clouds.  The draws
    # differ, so each is held to the float64 exact distance.
    rng = np.random.default_rng(9)
    a = _gapped(5, 3000, 16, 4)
    b = _gapped(6, 2500, 16, 4) + rng.standard_normal(16).astype(np.float32)
    scale = float(max(np.linalg.norm(a, axis=1).max(), np.linalg.norm(b, axis=1).max()))
    h = float(exact.hausdorff_dense(torch.from_numpy(a).double(), torch.from_numpy(b).double()))
    margin = fp_value_margin(16, scale, h)
    pc = dict(alpha=0.02, pca_method=method)
    ref = jhd.set_distance(jnp.asarray(a), jnp.asarray(b), method="prohd", backend="tiled",
                           key=jax.random.PRNGKey(1),
                           config=jhd.HDConfig(prohd=importlib.import_module("repro.core.prohd").ProHDConfig(**pc)))
    res = set_distance(a, b, method="prohd", backend=backend, device="cpu",
                       generator=torch.Generator().manual_seed(1),
                       config=HDConfig(prohd=ProHDConfig(**pc)))
    for r in (ref, res):
        v, lo, up = float(r.value), float(r.lower), float(r.upper)
        assert v <= h + margin and lo <= h + margin and h <= up + margin, (v, lo, up, h)
    # how many rows the directions' extremes share depends on the draw
    assert 0 < int(res.stats["n_sel_a"]) <= 3000 and 0 < int(res.stats["n_sel_b"]) <= 2500
    with pytest.raises(ValueError, match="requires a generator"):
        set_distance(a, b, method="prohd", backend=backend, device="cpu",
                     config=HDConfig(prohd=ProHDConfig(**pc)))
