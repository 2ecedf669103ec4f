"""The port's ProHD (Alg. 3) held to ``repro.core.prohd.prohd``.

Both packages get the same numpy clouds (a Gaussian mixture with a
decaying, hence distinct, spectrum) and the same config dict
(``pca_method="gram"``).  Every ``ProHDEstimate`` value field must agree
within ``fp_value_margin(D, scale, value)``; selection counts must match;
the certificate ``hd ≤ H ≤ hd_proj + bound`` must hold against the dense
float64 exact distance.  ``eigh`` signs and ``topk`` tie order may differ
between the packages, so selected values, not index sets, are compared.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import prohd as tprohd_mod  # noqa: E402
from repro_torch.core.fp_margin import fp_value_margin  # noqa: E402

# ``repro.core.prohd`` the attribute is the function; import the module.
jprohd_mod = importlib.import_module("repro.core.prohd")

N = 4000


def _mixture(seed, n_a, n_b, d, n_modes=6, spread=4.0, decay=0.85):
    rng = np.random.default_rng(seed)
    scales = (decay ** np.arange(d)).astype(np.float32)
    ca = rng.standard_normal((n_modes, d)).astype(np.float32) * spread * scales
    cb = rng.standard_normal((n_modes, d)).astype(np.float32) * spread * scales
    a = ca[rng.integers(0, n_modes, n_a)] + rng.standard_normal((n_a, d)).astype(np.float32) * scales
    b = cb[rng.integers(0, n_modes, n_b)] + rng.standard_normal((n_b, d)).astype(np.float32) * scales
    return a.astype(np.float32), b.astype(np.float32)


def _exact64(a, b):
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    a2 = (a64 * a64).sum(1)[:, None]
    b2 = (b64 * b64).sum(1)[None, :]
    d2 = np.maximum(a2 - 2 * a64 @ b64.T + b2, 0.0)
    return float(np.sqrt(max(d2.min(1).max(), d2.min(0).max())))


def _scale(a, b):
    return float(max(np.linalg.norm(a, axis=1).max(), np.linalg.norm(b, axis=1).max()))


def _run_both(a, b, **cfg_fields):
    ref_cfg = jprohd_mod.ProHDConfig(**cfg_fields)
    est_ref = jprohd_mod.prohd(jnp.asarray(a), jnp.asarray(b), ref_cfg)
    port_cfg = interop.prohd_config_from_dict(dataclasses.asdict(ref_cfg))
    est = tprohd_mod.prohd(interop.cloud(a, "cpu"), interop.cloud(b, "cpu"), port_cfg)
    return est_ref, est


def _assert_estimates_agree(est_ref, est, d, scale):
    for field in ("hd", "bound", "hd_proj"):
        r = float(getattr(est_ref, field))
        p = float(getattr(est, field))
        assert abs(p - r) <= fp_value_margin(d, scale, r), (field, p, r)
    assert int(est.n_sel_a) == int(est_ref.n_sel_a)
    assert int(est.n_sel_b) == int(est_ref.n_sel_b)


@pytest.mark.parametrize("d", [8, 64])
def test_prohd_estimate_matches_reference_and_certificate_holds(d):
    a, b = _mixture(d, N, N, d)
    scale = _scale(a, b)
    est_ref, est = _run_both(a, b, alpha=0.01, pca_method="gram", subset_backend="tiled")
    _assert_estimates_agree(est_ref, est, d, scale)

    h = _exact64(a, b)
    m = fp_value_margin(d, scale, h)
    assert float(est.hd) <= h + m
    assert float(est.hd_proj) <= h + m
    assert h <= float(est.hd_proj) + float(est.bound) + m


@pytest.mark.parametrize("fields", [
    {"prune": True},
    {"inner": "subset", "subset_backend": "dense"},
    {"subset_backend": "pallas"},   # the port's "cuda": its plain version on CPU tensors
])
def test_prohd_config_variants_match_reference(fields):
    d = 8
    a, b = _mixture(11, 2000, 1800, d)
    ref_fields = {"alpha": 0.02, "pca_method": "gram", **fields}
    if ref_fields.get("subset_backend") == "pallas":
        # the reference's Pallas body does not trace on this jax: its
        # executable reference is the tiled mirror
        est_ref, _ = _run_both(a, b, **{**ref_fields, "subset_backend": "tiled"})
        port_cfg = interop.prohd_config_from_dict(ref_fields)
        assert port_cfg.subset_backend == "cuda"
        est = tprohd_mod.prohd(interop.cloud(a, "cpu"), interop.cloud(b, "cpu"), port_cfg)
    else:
        est_ref, est = _run_both(a, b, **ref_fields)
    _assert_estimates_agree(est_ref, est, d, _scale(a, b))


def test_selection_selects_the_same_values():
    """Masks may differ only by tie order: the selected centroid-direction
    projections are the same values."""
    d = 8
    a, b = _mixture(5, 1500, 1500, d)
    masks = jax.jit(jprohd_mod.prohd_masks, static_argnums=2)
    sel_ref = masks(jnp.asarray(a), jnp.asarray(b), jprohd_mod.ProHDConfig(alpha=0.02))
    sel = tprohd_mod.prohd_masks(interop.cloud(a, "cpu"), interop.cloud(b, "cpu"),
                                 tprohd_mod.ProHDConfig(alpha=0.02))
    for mr, pr, mp, pp in ((sel_ref.mask_a, sel_ref.proj_a, sel.mask_a, sel.proj_a),
                           (sel_ref.mask_b, sel_ref.proj_b, sel.mask_b, sel.proj_b)):
        vr = np.sort(np.asarray(pr)[np.asarray(mr), 0])
        vp = np.sort(pp.numpy()[mp.numpy(), 0])
        np.testing.assert_allclose(vp, vr, rtol=1e-5, atol=1e-5)


def test_take_selected_packs_in_order_with_static_capacity():
    from repro_torch.core.selection import take_selected

    pts = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    mask = torch.tensor([0, 1, 0, 0, 1, 1, 0, 0, 0, 1], dtype=torch.bool)
    out, valid = take_selected(pts, mask, 6)
    assert out.shape == (6, 2)
    assert valid.tolist() == [True, True, True, True, False, False]
    assert out[:, 0].tolist() == [2.0, 8.0, 10.0, 18.0, 2.0, 2.0]
