"""The port's multi-query bucket scan (plain path) held to the JAX reference.

Same numpy inputs go through the reference's
``repro.kernels.hausdorff.batched.multiquery_min_sqdists_mirror`` /
``multiquery_bucket_hd(use_pallas=False)`` (the Pallas body does not trace
on this jax) and the port's ``repro_torch.kernels.hausdorff.batched`` on
CPU tensors, which run kernel 3's plain version.  Tolerances:

  * per min-d² entry: ``2·(D+2)·eps32·scale²`` — two fp32 GEMM-form
    computations in different k orders;
  * per HD value: ``fp_value_margin(D, scale, value)``;
  * inside the port: bitwise — each (query, set) pair against kernel 2's
    plain version with that query, gated against ungated, and any subset
    of the queries or of the sets.

Gate semantics follow the Pallas kernel's written test ``lb <= cut``: a
NaN bound gates the pair.  The reference's mirror vmaps the batched
mirror, which tests ``lb > cut`` and so computes a NaN-bound pair; that
case is judged against the kernel's convention, not the mirror.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.hausdorff import batched as jbatched  # noqa: E402
from repro_torch.core.fp_margin import fp_value_margin, sqdist_tolerance  # noqa: E402
from repro_torch.kernels.hausdorff import batched as B  # noqa: E402
from repro_torch.kernels.hausdorff import hausdorff as K  # noqa: E402


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _case(seed, n_queries, n_q, n_sets, cap, d):
    """Q ragged queries and a ragged slab with garbage in the padding; with
    Q ≥ 3 the last query is all-invalid, and set 1 is all-invalid."""
    rng = np.random.RandomState(seed)
    qs = rng.randn(n_queries, n_q, d).astype(np.float32)
    valid_qs = np.arange(n_q)[None, :] < rng.randint(1, n_q + 1, size=n_queries)[:, None]
    if n_queries >= 3:
        valid_qs[-1] = False
    qs[~valid_qs] = -3.3e8
    slab = (rng.randn(n_sets, cap, d) * 1.5 + 0.25).astype(np.float32)
    valid = np.arange(cap)[None, :] < rng.randint(1, cap + 1, size=n_sets)[:, None]
    valid[min(1, n_sets - 1)] = False
    slab[~valid] = 7.7e8
    return qs, valid_qs, slab, valid


def _gate(seed, n_queries, n_sets):
    rng = np.random.RandomState(seed + 1)
    lb = rng.rand(n_queries, n_sets).astype(np.float32)
    lb[:, 0] = 0.0
    return lb, np.full((n_queries, n_sets), 0.6, np.float32)


def _scale(qs, valid_qs, slab, valid):
    return float(max(np.linalg.norm(qs[valid_qs], axis=-1).max(initial=0.0),
                     np.linalg.norm(slab[valid], axis=-1).max(initial=0.0)))


def _hd64(a, b, directed):
    """float64 (directed) HD with ``exact.finalize_mins``'s conventions: an
    empty query side gives 0.0, else an empty target side +inf."""

    def one(x, y):
        if x.shape[0] == 0:
            return 0.0
        if y.shape[0] == 0:
            return np.inf
        return float(np.sqrt(((x[:, None].astype(np.float64) - y[None]) ** 2).sum(-1).min(1).max()))

    return one(a, b) if directed else max(one(a, b), one(b, a))


SHAPES = [(1, 9, 7, 16, 5), (3, 13, 6, 24, 7), (5, 33, 9, 17, 3), (3, 1, 4, 8, 1)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_min_sqdists_match_reference_mirror(shape):
    qs, vq, slab, vs = _case(sum(shape), *shape)
    lb, cut = _gate(sum(shape), shape[0], shape[2])
    ra, rb = jbatched.multiquery_min_sqdists_mirror(
        jnp.asarray(qs), jnp.asarray(slab), valid_qs=jnp.asarray(vq), valid_slab=jnp.asarray(vs),
        lb=jnp.asarray(lb), cut=jnp.asarray(cut))
    pa, pb = B.multiquery_min_sqdists(_t(qs), _t(slab), valid_qs=_t(vq), valid_slab=_t(vs),
                                      lb=_t(lb), cut=_t(cut))
    tol = sqdist_tolerance(shape[-1], _scale(qs, vq, slab, vs))
    for port, ref in ((pa.numpy(), np.asarray(ra)), (pb.numpy(), np.asarray(rb))):
        assert port.shape == ref.shape
        np.testing.assert_array_equal(np.isfinite(port), np.isfinite(ref))
        fin = np.isfinite(ref)
        assert np.abs(port[fin] - ref[fin]).max(initial=0.0) <= tol


@pytest.mark.parametrize("directed", [False, True], ids=["H", "h"])
def test_bucket_hd_matches_reference_and_float64(directed):
    shape = (3, 13, 6, 24, 7)
    qs, vq, slab, vs = _case(5, *shape)
    lb, cut = _gate(5, shape[0], shape[2])
    ref = np.asarray(jbatched.multiquery_bucket_hd(
        jnp.asarray(qs), jnp.asarray(slab), valid_qs=jnp.asarray(vq), valid_slab=jnp.asarray(vs),
        lb=jnp.asarray(lb), cut=jnp.asarray(cut), directed=directed, use_pallas=False))
    port = B.multiquery_bucket_hd(_t(qs), _t(slab), valid_qs=_t(vq), valid_slab=_t(vs),
                                  lb=_t(lb), cut=_t(cut), directed=directed).numpy()
    scale = _scale(qs, vq, slab, vs) * 2
    for q in range(shape[0]):
        for s in range(shape[2]):
            p, r = float(port[q, s]), float(ref[q, s])
            if not np.isfinite(r):
                assert p == r, (q, s)
                continue
            assert abs(p - r) <= fp_value_margin(7, scale, p), (q, s, p, r)
            if lb[q, s] <= cut[q, s]:
                h64 = _hd64(qs[q][vq[q]], slab[s][vs[s]], directed)
                assert abs(p - h64) <= fp_value_margin(7, scale, p), (q, s, p, h64)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_each_pair_bitwise_equals_batched_plain_version(shape):
    """Pair (q, s) is kernel 2's plain version with query q against set s:
    same bits, gate included."""
    qs, vq, slab, vs = _case(sum(shape) + 7, *shape)
    lb, cut = _gate(sum(shape) + 7, shape[0], shape[2])
    ma, mb = B.multiquery_min_sqdists(_t(qs), _t(slab), valid_qs=_t(vq), valid_slab=_t(vs),
                                      lb=_t(lb), cut=_t(cut))
    for q in range(shape[0]):
        ba, bb = B.batched_min_sqdists_mirror(_t(qs[q]), _t(slab), valid_q=_t(vq[q]), valid_slab=_t(vs),
                                              lb=_t(lb[q]), cut=_t(cut[q]))
        assert torch.equal(ma[q], ba) and torch.equal(mb[q], bb), q


def test_gated_vs_ungated_and_batch_composition_bitwise():
    shape = (5, 33, 9, 17, 3)
    qs, vq, slab, vs = _case(11, *shape)
    lb, cut = _gate(11, shape[0], shape[2])
    ga, gb = B.multiquery_min_sqdists(_t(qs), _t(slab), valid_qs=_t(vq), valid_slab=_t(vs),
                                      lb=_t(lb), cut=_t(cut))
    ua, ub = B.multiquery_min_sqdists(_t(qs), _t(slab), valid_qs=_t(vq), valid_slab=_t(vs))
    on = torch.from_numpy(lb <= cut)
    assert torch.equal(ga[on], ua[on]) and torch.equal(gb[on], ub[on])
    assert torch.isinf(ga[~on]).all() and torch.isinf(gb[~on]).all()
    # a subset of the queries and a subset of the sets keep their bits
    qi, si = [3, 0], [8, 2, 5]
    sa, sb = B.multiquery_min_sqdists(_t(qs[qi]), _t(slab[si]), valid_qs=_t(vq[qi]), valid_slab=_t(vs[si]))
    assert torch.equal(sa, ua[qi][:, si]) and torch.equal(sb, ub[qi][:, si])


def test_gate_semantics_nan_bound_neg_inf_cut_and_sentinel():
    """Pair (q, s) is computed iff lb <= cut: a NaN bound and a −inf cut
    gate it, and a gated pair is +inf on both sides (the kernel's written
    semantics; the reference mirror computes the NaN-bound pair)."""
    shape = (3, 8, 6, 16, 4)
    qs, vq, slab, vs = _case(4, *shape)
    vq[:] = True
    vs[:] = True
    lb = np.zeros((3, 6), np.float32)
    cut = np.ones((3, 6), np.float32)
    lb[0, 2] = np.nan
    cut[1] = -np.inf
    ma, mb = B.multiquery_min_sqdists(_t(qs), _t(slab), valid_qs=_t(vq), valid_slab=_t(vs), lb=_t(lb), cut=_t(cut))
    gated = ~(lb <= cut)
    assert gated.sum() == 7
    assert torch.isinf(ma[torch.from_numpy(gated)]).all() and torch.isinf(mb[torch.from_numpy(gated)]).all()
    assert torch.isfinite(ma[torch.from_numpy(~gated)]).all()
    hd = B.multiquery_bucket_hd(_t(qs), _t(slab), valid_qs=_t(vq), valid_slab=_t(vs), lb=_t(lb), cut=_t(cut))
    assert torch.isinf(hd[torch.from_numpy(gated)]).all()


def test_all_invalid_query_and_empty_set_conventions():
    """An all-invalid query gives 0.0 under ``directed`` (even gated) and
    +inf undirected; an empty set gives +inf; both sides empty give 0.0
    (``exact.finalize_mins`` each way)."""
    shape = (3, 6, 4, 8, 3)
    qs, vq, slab, vs = _case(9, *shape)
    lb = np.zeros((3, 4), np.float32)
    lb[:, 3] = 5.0
    cut = np.ones((3, 4), np.float32)
    h = B.multiquery_bucket_hd(_t(qs), _t(slab), valid_qs=_t(vq), valid_slab=_t(vs), lb=_t(lb), cut=_t(cut),
                               directed=True)
    assert h[2].tolist() == [0.0] * 4                     # all-invalid query: 0.0 wins
    assert torch.isinf(h[:2, 1]).all()                     # set 1 is empty
    H = B.multiquery_bucket_hd(_t(qs), _t(slab), valid_qs=_t(vq), valid_slab=_t(vs), lb=_t(lb), cut=_t(cut))
    assert torch.isinf(H[2, [0, 2, 3]]).all() and torch.isinf(H[:, 3]).all()
    assert float(H[2, 1]) == 0.0                           # both sides empty


@pytest.mark.parametrize("case", [(0, 1, 1, 1), (811, 38, 8, 17)], ids=str)
def test_reference_failing_tiny_shapes_against_float64(case):
    """The reference's failing padded-vs-raw shapes (``ROADMAP.md``), as
    a two-query batch: each pair within the margin of float64."""
    seed, n_q, n_b, d = case
    rng = np.random.RandomState(seed)
    qs = rng.randn(2, n_q, d).astype(np.float32)
    b = (rng.randn(n_b, d) * rng.choice([0.2, 1.0, 30.0])).astype(np.float32)
    cap = 1 << max(0, (n_b - 1).bit_length())
    slab = np.full((1, max(cap, 2), d), 1e9, np.float32)
    slab[0, :n_b] = b
    valid = np.zeros((1, slab.shape[1]), bool)
    valid[0, :n_b] = True
    for directed in (False, True):
        h = B.multiquery_bucket_hd(_t(qs), _t(slab), valid_slab=_t(valid), directed=directed)
        for q in range(2):
            h64 = _hd64(qs[q], b, directed)
            scale = float(np.linalg.norm(qs[q], axis=1).max() + np.linalg.norm(b, axis=1).max())
            assert abs(float(h[q, 0]) - h64) <= fp_value_margin(d, scale, h64), (q, directed)


def test_cuda_launcher_refuses_cpu_tensors_and_cpu_path_never_launches():
    qs, vq, slab, vs = _case(1, 2, 5, 3, 8, 4)
    before = B.multiquery_minscan.launches
    B.multiquery_min_sqdists(_t(qs), _t(slab), valid_qs=_t(vq), valid_slab=_t(vs))
    assert B.multiquery_minscan.launches == before
    q2 = torch.zeros(2, 5)
    b2 = torch.zeros(3, 8)
    out_a, out_b = torch.zeros(2, 3, 5), torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        B.multiquery_minscan(_t(qs), q2, _t(slab), b2, out_a, out_b)


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_directed_row_mins_are_bitwise_the_bidirectional_ones(gated):
    """``directed=True`` returns the bidirectional call's row mins bit for
    bit and leaves every column min +inf; the directed HD is the one the
    bidirectional mins give."""
    shape = (3, 13, 6, 24, 7)
    qs, vq, slab, vs = _case(21, *shape)
    kw = dict(valid_qs=_t(vq), valid_slab=_t(vs))
    if gated:
        lb, cut = _gate(21, shape[0], shape[2])
        kw.update(lb=_t(lb), cut=_t(cut))
    ha, hb = B.multiquery_min_sqdists(_t(qs), _t(slab), **kw)
    da, db = B.multiquery_min_sqdists(_t(qs), _t(slab), directed=True, **kw)
    assert torch.equal(da, ha) and torch.isinf(db).all() and db.shape == hb.shape
    h = B.multiquery_bucket_hd(_t(qs), _t(slab), directed=True, **kw)
    assert torch.equal(h, B._finalize_lanes(ha, _t(vq)[:, None, :]))


@pytest.mark.parametrize("bad", ["pairs", "ld", "smem", "grid", "set_step not coprime", "set_step 0"])
def test_launcher_refuses_bad_plans(bad):
    """Kernel 3's launcher checks a given plan against the pass (Q groups of
    one shared query) before it looks for a card."""
    n_queries, n_q, n_sets, cap, d = 3, 130, 4, 64, 6
    args = (torch.zeros(n_queries, n_q, d), torch.zeros(n_queries, n_q), torch.zeros(n_sets, cap, d),
            torch.zeros(n_sets, cap), torch.zeros(n_queries, n_sets, n_q), torch.zeros(n_queries, n_sets, cap))
    good = B.bucket_launch_plan(n_queries, n_sets, n_q, cap, d, 132, shared_query=True, resident=True)
    with pytest.raises(ValueError, match="CUDA"):
        B.multiquery_minscan(*args, plan=good)
    plan = {
        "pairs": good._replace(n_pairs=good.n_pairs - 1),
        "ld": good._replace(ld=4 * good.ld),
        "smem": good._replace(smem=K.smem_bytes(d, False)),
        "grid": good._replace(grid=-1),
        "set_step not coprime": good._replace(set_step=2),
        "set_step 0": good._replace(set_step=0),
    }[bad]
    with pytest.raises(ValueError, match="does not fit"):
        B.multiquery_minscan(*args, plan=plan)
