"""The port's masked exact HD and masked ProHD held to ``repro.core.masked``.

Same numpy inputs go through the reference (pure-JAX backends only:
``dense``, ``tiled``, ``fused_mirror``, ``batched_mirror``; never
``batched_pallas``, whose body does not trace on this jax) and the port on
CPU tensors, where ``batched_cuda`` runs the kernel's plain version.
Tolerances:

  * across packages and against float64: ``fp_value_margin(D, scale, v)``;
  * inside the port, for the batched backends: bitwise — padded vs raw,
    and a lane against the same set alone or in another batch.

The reference's own failing hypothesis cases (``ROADMAP.md``, "What the
reference is") are replayed here and judged against float64 and the
written conventions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import strategies  # noqa: E402
from repro.core import masked as jmasked  # noqa: E402
from repro_torch.core import masked  # noqa: E402
from repro_torch.core.fp_margin import fp_margin, fp_value_margin  # noqa: E402

PORT_BACKENDS = sorted(masked.EXACT_MASKED_BACKENDS)
# The backends whose lanes are bitwise whatever the padding or batch.
BATCHED = ("batched_cuda", "batched_mirror", "multiquery_cuda", "multiquery_mirror")
# The reference backend each port backend is held to.
REF_BACKEND = {"batched_cuda": "batched_mirror", "multiquery_cuda": "multiquery_mirror"}


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _scale(*xs):
    return float(max(np.linalg.norm(x.reshape(-1, x.shape[-1]), axis=1).max() for x in xs))


def _hd64(a, b, va=None, vb=None, directed=False):
    va = np.ones(a.shape[0], bool) if va is None else va
    vb = np.ones(b.shape[0], bool) if vb is None else vb
    a64, b64 = a[va].astype(np.float64), b[vb].astype(np.float64)

    def one(x, y):
        if x.shape[0] == 0:
            return 0.0
        if y.shape[0] == 0:
            return np.inf
        return float(np.sqrt(((x[:, None] - y[None]) ** 2).sum(-1).min(1).max()))

    return one(a64, b64) if directed else max(one(a64, b64), one(b64, a64))


def _pair(seed, n_q, n_b, d, cap):
    rng = np.random.RandomState(seed)
    q = rng.randn(n_q, d).astype(np.float32)
    b = (rng.randn(n_b, d) * rng.choice([0.3, 1.0, 20.0])).astype(np.float32)
    pb, vb = strategies.pad_cloud(b, cap, fill=7.7e8)
    return q, b, pb, vb


def test_registry_is_this_slices_backends():
    assert set(masked.EXACT_MASKED_BACKENDS) == {"dense", "tiled", "fused_mirror", "batched_cuda", "batched_mirror",
                                                 "multiquery_cuda", "multiquery_mirror"}
    assert masked.BATCHED_NATIVE_BACKENDS == ("batched_cuda", "batched_mirror")
    assert masked.MULTIQUERY_NATIVE_BACKENDS == ("multiquery_cuda", "multiquery_mirror")
    with pytest.raises(ValueError, match="unknown masked exact backend"):
        masked.masked_exact_hd(_t(np.zeros((2, 2), np.float32)), _t(np.zeros((2, 2), np.float32)),
                               backend="batched_pallas")


@pytest.mark.parametrize("directed", [False, True], ids=["H", "h"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_masked_exact_hd_matches_reference_and_float64(backend, directed):
    q, b, pb, vb = _pair(1, 19, 27, 6, 64)
    va = np.random.RandomState(2).rand(19) > 0.25
    va[0] = True
    port = float(masked.masked_exact_hd(_t(q), _t(pb), valid_a=_t(va), valid_b=_t(vb),
                                        directed=directed, backend=backend, block_a=64, block_b=64))
    ref = float(jmasked.masked_exact_hd(
        jnp.asarray(q), jnp.asarray(pb), valid_a=jnp.asarray(va), valid_b=jnp.asarray(vb),
        directed=directed, backend=REF_BACKEND.get(backend, backend), block_a=64, block_b=64))
    h64 = _hd64(q, b, va, None, directed)
    m = fp_value_margin(6, _scale(q, b), port)
    assert abs(port - ref) <= m
    assert abs(port - h64) <= m


@pytest.mark.parametrize("backend", BATCHED)
@pytest.mark.parametrize("shape", [(1, 1), (1, 17), (9, 1), (9, 6), (33, 48), (200, 150)], ids=str)
def test_batched_padded_equals_raw_bitwise(backend, shape):
    """The reference's padded-vs-raw sweep (``test_padded_vs_raw.py``), on
    the port's batched backends: garbage or zero fill, pow2 capacities."""
    nq, nb = shape
    rng = np.random.RandomState(nq * 100 + nb)
    q = rng.randn(nq, 5).astype(np.float32)
    b = (rng.randn(nb, 5) * rng.choice([0.3, 1.0, 50.0])).astype(np.float32)
    for directed in (False, True):
        raw = masked.masked_exact_hd(_t(q), _t(b), directed=directed, backend=backend)
        for cap in strategies.pow2_capacities(nb):
            for fill in (0.0, 1e9):
                pb, vb = strategies.pad_cloud(b, cap, fill=fill)
                got = masked.masked_exact_hd(_t(q), _t(pb), valid_b=_t(vb), directed=directed, backend=backend)
                assert torch.equal(got, raw), (backend, shape, cap, fill, directed)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_lane_invariant_to_batch_size_and_members(backend):
    q, _, pts, val = strategies.bucket_case(0, batch=13, cap=16, d=4, nq=9)
    q, pts, val = _t(np.asarray(q)), _t(np.asarray(pts)), _t(np.asarray(val))
    full = masked.masked_exact_hd_batched(q, pts, valid_slab=val, backend=backend, block_a=64, block_b=64)
    for i in range(13):
        solo = masked.masked_exact_hd_batched(q, pts[i:i + 1], valid_slab=val[i:i + 1],
                                              backend=backend, block_a=64, block_b=64)
        assert torch.equal(solo[0], full[i]), (backend, i)
    perm = torch.from_numpy(np.random.RandomState(1).permutation(13)[:8])
    sub = masked.masked_exact_hd_batched(q, pts[perm], valid_slab=val[perm],
                                         backend=backend, block_a=64, block_b=64)
    assert torch.equal(sub, full[perm])


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_batched_gate_and_empty_side_conventions_every_backend(backend):
    rng = np.random.RandomState(21)
    q = rng.randn(7, 3).astype(np.float32)
    slab = np.stack([strategies.pad_cloud(rng.randn(5, 3).astype(np.float32), 16, fill=1e9)[0]
                     for _ in range(4)])
    valid = np.stack([strategies.pad_cloud(np.zeros((5, 3)), 16)[1]] * 4)
    valid[2] = False
    lb = np.array([0.0, 3.0, 0.0, np.nan], np.float32)
    cut = np.ones(4, np.float32)
    for directed in (False, True):
        ungated = masked.masked_exact_hd_batched(_t(q), _t(slab), valid_slab=_t(valid),
                                                 directed=directed, backend=backend)
        assert torch.isinf(ungated[2])                         # empty target
        gated = masked.masked_exact_hd_batched(_t(q), _t(slab), valid_slab=_t(valid), lb=_t(lb),
                                               cut=_t(cut), directed=directed, backend=backend)
        assert torch.equal(gated[0], ungated[0])
        assert torch.isinf(gated[[1, 2, 3]]).all()             # gated (NaN too) and empty
    none_q = np.zeros(7, bool)
    h = masked.masked_exact_hd_batched(_t(q), _t(slab), valid_q=_t(none_q), valid_slab=_t(valid),
                                       lb=_t(lb), cut=_t(cut), directed=True, backend=backend)
    assert h.tolist() == [0.0, 0.0, 0.0, 0.0]                  # empty query wins


def _prohd_inputs(seed, n_sets=6, n_q=24, cap=32, d=8):
    rng = np.random.RandomState(seed)
    q = (rng.randn(n_q, d) + 0.5).astype(np.float32)
    slab = np.zeros((n_sets, cap, d), np.float32)
    valid = np.zeros((n_sets, cap), bool)
    for s in range(n_sets):
        n = rng.randint(cap // 2, cap + 1)
        slab[s, :n] = rng.randn(n, d) * rng.choice([0.5, 1.0, 2.0]) + rng.randn(d)
        valid[s, :n] = True
    return q, slab, valid


@pytest.mark.parametrize("directed", [False, True], ids=["H", "h"])
@pytest.mark.parametrize("backend", ["tiled", "batched_cuda"])
def test_masked_prohd_lanes_match_reference_and_certificate(backend, directed):
    q, slab, valid = _prohd_inputs(3)
    va = np.ones(q.shape[0], bool)
    cert = masked.masked_prohd_certified(_t(q), _t(va), _t(slab), _t(valid), alpha=0.1, m=2,
                                         directed=directed, backend=backend)
    for s in range(slab.shape[0]):
        ref = jmasked.masked_prohd_certified_jit(
            jnp.asarray(q), jnp.asarray(va), jnp.asarray(slab[s]), jnp.asarray(valid[s]),
            alpha=0.1, m=2, directed=directed, backend=REF_BACKEND.get(backend, backend))
        scale = _scale(q, slab[s][valid[s]])
        h64 = _hd64(q, slab[s], va, valid[s], directed)
        for field in ("hd", "lower", "upper"):
            port_v = float(getattr(cert, field)[s])
            ref_v = float(getattr(ref, field))
            assert abs(port_v - ref_v) <= fp_value_margin(8, scale, port_v), (field, s, port_v, ref_v)
        m = fp_value_margin(8, scale, h64)
        assert float(cert.hd[s]) <= h64 + m and float(cert.lower[s]) <= h64 + m
        assert h64 <= float(cert.upper[s]) + m


def test_masked_prohd_single_pair_equals_its_lane():
    q, slab, valid = _prohd_inputs(4, n_sets=3)
    va = torch.ones(q.shape[0], dtype=torch.bool)
    lanes = masked.masked_prohd_certified(_t(q), va, _t(slab), _t(valid), alpha=0.1, m=2,
                                          backend="batched_cuda")
    for s in range(3):
        one = masked.masked_prohd_certified(_t(q), va, _t(slab[s]), _t(valid[s]), alpha=0.1, m=2,
                                            backend="batched_cuda")
        assert one.hd.ndim == 0
        scale = _scale(q, slab[s][valid[s]])
        for field in ("hd", "lower", "upper"):
            v = float(getattr(one, field))
            assert abs(v - float(getattr(lanes, field)[s])) <= fp_value_margin(8, scale, v)


# -- the reference's failing hypothesis cases, judged against float64 -------


@pytest.mark.parametrize("case", [(0, 1, 1, 1, 0, False), (811, 38, 8, 17, 1, False)], ids=str)
def test_reference_failing_padded_vs_raw_cases(case):
    """Padded-vs-raw cases the reference fails: in the port the batched
    backends are bitwise, and every backend lands within the margin of
    float64."""
    seed, nq, nb, d, doublings, _ = case
    rng = np.random.RandomState(seed)
    q = rng.randn(nq, d).astype(np.float32)
    b = (rng.randn(nb, d) * rng.choice([0.2, 1.0, 30.0])).astype(np.float32)
    cap = strategies.pow2_capacities(nb, extra=doublings)[-1]
    pb, vb = strategies.pad_cloud(b, cap, fill=1e9)
    h64 = _hd64(q, b)
    for backend in PORT_BACKENDS:
        raw = masked.masked_exact_hd(_t(q), _t(b), backend=backend, block_a=64, block_b=64)
        got = masked.masked_exact_hd(_t(q), _t(pb), valid_b=_t(vb), backend=backend, block_a=64, block_b=64)
        if backend in BATCHED:
            assert torch.equal(got, raw), backend
        m = fp_value_margin(d, _scale(q, b), float(got))
        assert abs(float(got) - h64) <= m and abs(float(raw) - h64) <= m, backend


def test_reference_failing_cross_backend_case():
    """Cross-backend case (0, 1, 2, 1, 8, 0.0) the reference fails: every
    port backend within the margin of float64, and so of every other."""
    q, raws, pts, val = strategies.bucket_case(0, batch=1, cap=8, d=2, nq=1, offset=0.0,
                                               scales=(0.3, 1.0, 10.0))
    q, pts, val = np.asarray(q), np.asarray(pts), np.asarray(val)
    for directed in (False, True):
        h64 = _hd64(q, raws[0], directed=directed)
        for backend in PORT_BACKENDS:
            v = float(masked.masked_exact_hd_batched(_t(q), _t(pts), valid_slab=_t(val),
                                                     directed=directed, backend=backend)[0])
            assert abs(v - h64) <= fp_value_margin(2, _scale(q, raws[0]), v), (backend, directed)


@pytest.mark.parametrize("offset", [0.0, 1e5], ids=["unit", "cancellation"])
def test_reference_failing_cross_backend_disagreement_case(offset):
    """``test_fp_margin.py::test_cross_backend_disagreement_pinned[cancellation]``,
    which the reference fails: every port backend within ``fp_margin`` of
    float64 (difference form), so any two within twice it, at unit
    magnitude and under 1e5 cancellation."""
    d = 8
    rng = np.random.RandomState(17)
    for trial in range(8):
        q = (rng.randn(25, d) + offset).astype(np.float32)
        b = (rng.randn(40, d) * 3 + offset).astype(np.float32)
        scale = float(np.linalg.norm(q.astype(np.float64), axis=1).max()
                      + np.linalg.norm(b.astype(np.float64), axis=1).max())
        h64 = _hd64(q, b)
        vals = [float(masked.masked_exact_hd(_t(q), _t(b), backend=be, block_a=32, block_b=32))
                for be in PORT_BACKENDS]
        assert max(abs(v - h64) for v in vals) <= fp_margin(d, scale), (offset, trial, vals, h64)
        assert max(vals) - min(vals) <= 2.0 * fp_margin(d, scale), (offset, trial, vals)
