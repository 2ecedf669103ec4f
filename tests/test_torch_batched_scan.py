"""The port's batched bucket scan (plain path) held to the JAX reference.

Same numpy inputs go through the reference's
``repro.kernels.hausdorff.batched.batched_min_sqdists_mirror`` /
``batched_bucket_hd(use_pallas=False)`` (the Pallas body does not trace on
this jax) and the port's ``repro_torch.kernels.hausdorff.batched`` on CPU
tensors, which run its plain version.  Tolerances:

  * per min-d² entry: ``2·(D+2)·eps32·scale²`` — two fp32 GEMM-form
    computations in different k orders;
  * per HD value: ``fp_value_margin(D, scale, value)``.

Gate semantics follow the Pallas kernel's written test ``lb <= cut``: a
NaN bound gates the set.  The reference's pure-JAX mirror tests
``lb > cut`` instead and so computes a NaN-bound set; that case is judged
against the kernel's convention, not the mirror.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import exact as jexact  # noqa: E402
from repro.kernels.hausdorff import batched as jbatched  # noqa: E402
from repro_torch.core import exact  # noqa: E402
from repro_torch.core.fp_margin import fp_value_margin, sqdist_tolerance  # noqa: E402
from repro_torch.kernels.hausdorff import batched as B  # noqa: E402


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _case(seed, n_sets, n_q, cap, d, *, ragged=True):
    rng = np.random.RandomState(seed)
    q = rng.randn(n_q, d).astype(np.float32)
    slab = (rng.randn(n_sets, cap, d) * 1.5 + 0.25).astype(np.float32)
    valid = np.ones((n_sets, cap), bool)
    if ragged:
        lens = rng.randint(1, cap + 1, size=n_sets)
        valid = np.arange(cap)[None, :] < lens[:, None]
        slab[~valid] = 7.7e8   # garbage in padding rows must never leak
    return q, slab, valid


def _scale(*xs):
    return float(max(np.linalg.norm(x.reshape(-1, x.shape[-1]), axis=1).max() for x in xs))


def _hd64(a, b, va, vb, directed):
    """float64 (directed) HD over valid rows, empty-side conventions."""
    a64, b64 = a[va].astype(np.float64), b[vb].astype(np.float64)
    if a64.shape[0] == 0:
        h_ab = 0.0
    elif b64.shape[0] == 0:
        h_ab = np.inf
    else:
        h_ab = np.sqrt(((a64[:, None] - b64[None]) ** 2).sum(-1).min(1).max())
    if directed:
        return h_ab
    if b64.shape[0] == 0:
        return np.inf
    h_ba = 0.0 if a64.shape[0] == 0 else np.sqrt(((b64[:, None] - a64[None]) ** 2).sum(-1).min(1).max())
    return max(h_ab, h_ba)


@pytest.mark.parametrize("shape", [(7, 9, 16, 5), (12, 33, 64, 16), (3, 1, 8, 2)], ids=str)
def test_min_sqdists_match_reference_mirror(shape):
    n_sets, n_q, cap, d = shape
    q, slab, valid = _case(sum(shape), n_sets, n_q, cap, d)
    valid[min(1, n_sets - 1)] = False            # one all-invalid lane
    ra, rb = jbatched.batched_min_sqdists_mirror(
        jnp.asarray(q), jnp.asarray(slab), valid_slab=jnp.asarray(valid))
    pa, pb = B.batched_min_sqdists(_t(q), _t(slab), valid_slab=_t(valid))
    ra, rb, pa, pb = np.asarray(ra), np.asarray(rb), pa.numpy(), pb.numpy()
    tol = sqdist_tolerance(d, _scale(q, np.where(valid[..., None], slab, 0)))
    for port, ref in ((pa, ra), (pb, rb)):
        fin = np.isfinite(ref)
        assert np.array_equal(fin, np.isfinite(port))
        np.testing.assert_allclose(port[fin], ref[fin], rtol=0, atol=tol)
    assert np.isinf(pb[~valid]).all()


@pytest.mark.parametrize("directed", [False, True], ids=["H", "h"])
def test_bucket_hd_matches_reference_and_float64(directed):
    q, slab, valid = _case(3, 10, 20, 32, 6)
    ref = np.asarray(jbatched.batched_bucket_hd(
        jnp.asarray(q), jnp.asarray(slab), valid_slab=jnp.asarray(valid),
        directed=directed, use_pallas=False))
    port = B.batched_bucket_hd(_t(q), _t(slab), valid_slab=_t(valid), directed=directed).numpy()
    va = np.ones(q.shape[0], bool)
    scale = _scale(q, np.where(valid[..., None], slab, 0))
    for s in range(slab.shape[0]):
        m = fp_value_margin(6, scale, port[s])
        assert abs(port[s] - ref[s]) <= m
        assert abs(port[s] - _hd64(q, slab[s], va, valid[s], directed)) <= m


def test_gate_semantics_nan_bound_and_sentinel():
    q, slab, valid = _case(4, 6, 8, 16, 4)
    lb = np.array([0.0, 2.0, np.nan, 1.0, np.inf, 0.5], np.float32)
    cut = np.array([1.0, 1.0, 1.0, 1.0, np.inf, np.nan], np.float32)
    computed = lb <= cut                      # [T, F, F, T, T, F]
    pa, pb = B.batched_min_sqdists(_t(q), _t(slab), valid_slab=_t(valid), lb=_t(lb), cut=_t(cut))
    ua, ub = B.batched_min_sqdists(_t(q), _t(slab), valid_slab=_t(valid))
    assert torch.isinf(pa[~torch.from_numpy(computed)]).all()
    assert torch.isinf(pb[~torch.from_numpy(computed)]).all()
    # gated vs ungated: every computed lane keeps its bits
    assert torch.equal(pa[torch.from_numpy(computed)], ua[torch.from_numpy(computed)])
    assert torch.equal(pb[torch.from_numpy(computed)], ub[torch.from_numpy(computed)])
    # the reference mirror agrees on every lane whose bounds are not NaN
    ra, _ = jbatched.batched_min_sqdists_mirror(
        jnp.asarray(q), jnp.asarray(slab), valid_slab=jnp.asarray(valid),
        lb=jnp.asarray(lb), cut=jnp.asarray(cut))
    ra = np.asarray(ra)
    plain = ~(np.isnan(lb) | np.isnan(cut))
    assert np.array_equal(np.isinf(ra[plain]).all(1), np.isinf(pa.numpy()[plain]).all(1))
    # the mirror computes the NaN-bound lanes; the kernel's written test gates them
    assert np.isfinite(ra[2]).all() and torch.isinf(pa[2]).all()


def test_all_invalid_lane_and_directed_empty_query_precedence():
    q, slab, valid = _case(5, 4, 6, 8, 3)
    valid[2] = False                                   # empty target lane
    slab[2] = 7.7e8
    for directed in (False, True):
        hd = B.batched_bucket_hd(_t(q), _t(slab), valid_slab=_t(valid), directed=directed)
        assert torch.isinf(hd[2])                       # empty target: +inf
        assert torch.isfinite(hd[[0, 1, 3]]).all()
    none_q = np.zeros(q.shape[0], bool)
    lb = np.array([0.0, 5.0, 0.0, 5.0], np.float32)
    cut = np.ones(4, np.float32)
    # directed: the all-invalid query's 0.0 beats the gated +inf sentinel
    h = B.batched_bucket_hd(_t(q), _t(slab), valid_q=_t(none_q), valid_slab=_t(valid),
                            lb=_t(lb), cut=_t(cut), directed=True)
    assert h.tolist() == [0.0, 0.0, 0.0, 0.0]
    # undirected: the set→query direction's empty target keeps +inf, on
    # gated lanes and on a computed one; with both sides empty, both
    # directions are empty-query 0.0
    h = B.batched_bucket_hd(_t(q), _t(slab), valid_q=_t(none_q), valid_slab=_t(valid),
                            lb=_t(lb), cut=_t(cut))
    assert h.tolist() == [np.inf, np.inf, 0.0, np.inf]
    # the reference agrees on every convention
    for directed, want in ((True, [0.0] * 4), (False, [np.inf, np.inf, 0.0, np.inf])):
        ref = np.asarray(jbatched.batched_bucket_hd(
            jnp.asarray(q), jnp.asarray(slab), valid_q=jnp.asarray(none_q),
            valid_slab=jnp.asarray(valid), lb=jnp.asarray(lb), cut=jnp.asarray(cut),
            directed=directed, use_pallas=False))
        assert ref.tolist() == want


@pytest.mark.parametrize("shared_slab", [False, True], ids=["per-set slab", "shared slab"])
def test_per_set_query_matches_per_lane_fused_scan(shared_slab):
    """The explicit-vmap form: per-lane queries (stage 1's subsets) against
    each lane's set, or against one shared cloud, lane by lane against the
    reference's single-pair ``fused_min_sqdists_tiled``."""
    rng = np.random.RandomState(6)
    n_sets, n_q, cap, d = 5, 11, 16, 7
    qs = rng.randn(n_sets, n_q, d).astype(np.float32)
    vq = rng.rand(n_sets, n_q) > 0.3
    vq[:, 0] = True
    if shared_slab:
        slab, vs = rng.randn(cap, d).astype(np.float32), None
    else:
        _, slab, vs = _case(7, n_sets, 1, cap, d)
    pa, pb = B.batched_min_sqdists(_t(qs), _t(slab), valid_q=_t(vq), valid_slab=_t(vs))
    tol = sqdist_tolerance(d, _scale(qs, np.where(vs[..., None], slab, 0) if vs is not None else slab))
    for s in range(n_sets):
        b_s = slab if shared_slab else slab[s]
        vb_s = None if vs is None else vs[s]
        ra, rb = jexact.fused_min_sqdists_tiled(
            jnp.asarray(qs[s]), jnp.asarray(b_s), valid_a=jnp.asarray(vq[s]),
            valid_b=None if vb_s is None else jnp.asarray(vb_s))
        for port, ref in ((pa[s].numpy(), np.asarray(ra)), (pb[s].numpy(), np.asarray(rb))):
            fin = np.isfinite(ref)
            assert np.array_equal(fin, np.isfinite(port))
            np.testing.assert_allclose(port[fin], ref[fin], rtol=0, atol=tol)


def test_plain_version_bits_ignore_padding_batch_and_composition():
    """Each entry is one product-then-add chain over k in a fixed order, so
    neither padding nor the batch around a lane can move a bit."""
    q, slab, valid = _case(8, 9, 13, 32, 5)
    full_a, full_b = B.batched_min_sqdists(_t(q), _t(slab), valid_slab=_t(valid))
    perm = np.random.RandomState(0).permutation(9)[:4]
    sub_a, sub_b = B.batched_min_sqdists(_t(q), _t(slab[perm]), valid_slab=_t(valid[perm]))
    assert torch.equal(sub_a, full_a[perm]) and torch.equal(sub_b, full_b[perm])
    for s in range(9):
        n = int(valid[s].sum())
        ra, rb = B.batched_min_sqdists(_t(q), _t(slab[s, :n][None]))
        assert torch.equal(ra[0], full_a[s]) and torch.equal(rb[0], full_b[s, :n])


def test_plain_version_matches_port_fused_scan_within_tolerance():
    """The port's two plain scans agree entry by entry (different k orders)."""
    q, slab, valid = _case(9, 4, 40, 64, 16)
    pa, pb = B.batched_min_sqdists(_t(q), _t(slab), valid_slab=_t(valid))
    tol = sqdist_tolerance(16, _scale(q, np.where(valid[..., None], slab, 0)))
    for s in range(4):
        fa, fb = exact.fused_min_sqdists_tiled(_t(q), _t(slab[s]), valid_b=_t(valid[s]))
        assert torch.equal(torch.isfinite(fb), torch.isfinite(pb[s]))
        fin = torch.isfinite(fb)
        torch.testing.assert_close(pa[s], fa, rtol=0, atol=tol)
        torch.testing.assert_close(pb[s][fin], fb[fin], rtol=0, atol=tol)


def test_cuda_launcher_refuses_cpu_tensors_and_cpu_path_never_launches():
    q, slab, valid = _case(10, 2, 4, 8, 3)
    before = B.batched_minscan.launches
    B.batched_bucket_hd(_t(q), _t(slab), valid_slab=_t(valid))
    assert B.batched_minscan.launches == before
    z = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        B.batched_minscan(_t(q)[None].expand(2, 4, 3), z, _t(slab), torch.zeros(2, 8), z, torch.zeros(2, 8))
