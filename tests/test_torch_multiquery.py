"""The port's ``search_batch`` held to ``repro.index.multiquery``'s contract.

One ragged corpus, made with numpy from a seed, is held in both packages
(the port takes the reference store's direction bank through
``interop.store_from_reference``).  The port runs on the CPU, where every
stage-2a pass takes a plain version (``multiquery_cuda`` runs kernel 3's
plain version).  What is checked:

  * per query, ``search_batch`` bitwise equal to the port's own ``search``
    and to its brute force, under every masked backend the port registers;
  * ids equal to the reference's ``search_batch`` with ``multiquery_mirror``
    pinned on both sides, values within ``fp_value_margin`` of the
    reference's and of a float64 oracle;
  * dedup, mixed k, k = 0 and k > n, an empty batch, validation errors,
    ``shards=`` raising, deadline 0 degrading every query, anytime ε = 0;
  * the masked-backend ladder on ``cuda`` and on ``cpu``, faults under
    ``degrade`` and ``raise``, and the batch's spans.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import strategies  # noqa: E402
from repro.index import SetStore as RefStore  # noqa: E402
from repro.index import search_batch as ref_search_batch  # noqa: E402
from repro_torch import interop, obs  # noqa: E402
from repro_torch.core import masked  # noqa: E402
from repro_torch.core.fp_margin import fp_value_margin  # noqa: E402
from repro_torch.hd import resolver  # noqa: E402
from repro_torch.index import SetStore, cascade, search, search_batch  # noqa: E402
from repro_torch.reliability import BackendUnavailable, Fault, InjectedFault, inject  # noqa: E402

K = 4
D = 4


@pytest.fixture(scope="module")
def corpus():
    sets, rng = strategies.ragged_corpus(29, n_sets=18, d=D, max_n=16)
    ref = RefStore(dim=D)
    ref.add_many(sets)
    port = interop.store_from_reference(np.asarray(ref.directions), sets, device="cpu")
    # queries near distinct sets so the batch's frontiers differ
    qs = [(np.asarray(sets[i]).mean(axis=0) + rng.randn(n_q, D) * 0.5).astype(np.float32)
          for i, n_q in ((0, 9), (5, 7), (11, 12), (2, 9))]
    return sets, qs, ref, port


def _same(res, want):
    np.testing.assert_array_equal(res.ids, want.ids)
    np.testing.assert_array_equal(res.values, want.values)


def _hd64(q, s):
    d2 = ((q[:, None].astype(np.float64) - s[None].astype(np.float64)) ** 2).sum(-1)
    return max(np.sqrt(d2.min(1).max()), np.sqrt(d2.min(0).max()))


@pytest.mark.parametrize("variant", ["hausdorff", "directed"])
def test_q1_bitwise_identical_to_search(corpus, variant):
    _, qs, _, port = corpus
    batch = search_batch([qs[0]], port, K, variant=variant)[0]
    single = search(qs[0], port, K, variant=variant)
    _same(batch, single)
    np.testing.assert_array_equal(batch.lower, single.lower)
    np.testing.assert_array_equal(batch.upper, single.upper)
    assert not batch.degraded and batch.stage_reached == "complete"


def test_batch_bitwise_per_query_and_shared_slab_when_pinned(corpus):
    _, qs, _, port = corpus
    res = search_batch(qs, port, K)
    for q, r in zip(qs, res):
        _same(r, search(q, port, K))
        _same(r, search(q, port, K, method="exact"))
        assert r.lower.tolist() == r.upper.tolist() == r.values.astype(np.float64).tolist()
    assert res[0].stats["masked_backend"] == "multiquery_mirror"
    assert res[0].stats["multiquery_launches"] > 0 and res[0].stats["batch_queries"] == len(qs)
    # CPU auto: one pass per (query, bucket); a pinned backend takes one
    # shared-slab pass per bucket
    shared = search_batch(qs, port, K, masked_backend="multiquery_mirror")
    assert 0 < shared[0].stats["multiquery_launches"] <= len(port.packed_buckets())
    assert shared[0].stats["multiquery_launches"] < res[0].stats["multiquery_launches"]
    for r, want in zip(shared, res):
        _same(r, want)


def test_ids_match_reference_values_within_margin_of_reference_and_float64(corpus):
    sets, qs, ref, port = corpus
    mine = search_batch(qs, port, K, masked_backend="multiquery_mirror")
    theirs = ref_search_batch(qs, ref, K, masked_backend="multiquery_mirror")
    for q, r, t in zip(qs, mine, theirs):
        np.testing.assert_array_equal(r.ids, t.ids)
        for sid, v, tv in zip(r.ids.tolist(), r.values.tolist(), t.values.tolist()):
            s = sets[sid]
            scale = float(np.linalg.norm(q, axis=1).max() + np.linalg.norm(s, axis=1).max())
            m = fp_value_margin(D, scale, v)
            assert abs(v - tv) <= m and abs(v - _hd64(q, s)) <= m, (sid, v, tv)


def test_duplicate_queries_dedup_and_match(corpus):
    _, qs, _, port = corpus
    res = search_batch([qs[0], qs[1], qs[0], qs[0]], port, K)
    assert res[0].stats["dedup_hits"] == 2 and res[0].stats["unique_queries"] == 2
    assert res[0].stats["dedup_hit_rate"] == pytest.approx(0.5)
    for dup in (res[2], res[3]):
        _same(dup, res[0])
    _same(res[0], search(qs[0], port, K))


def test_mixed_k_prefix_exact(corpus):
    _, qs, _, port = corpus
    res = search_batch([qs[0], qs[1], qs[0]], port, [2, 4, 6])
    np.testing.assert_array_equal(res[0].ids, res[2].ids[:2])
    np.testing.assert_array_equal(res[0].values, res[2].values[:2])
    for r, q, k in zip(res, [qs[0], qs[1], qs[0]], [2, 4, 6]):
        _same(r, search(q, port, k))
        assert r.stats["k"] == k


def test_k0_k_overflow_and_empty_batch(corpus):
    _, qs, _, port = corpus
    res = search_batch([qs[0], qs[1]], port, [0, port.n_sets + 7])
    assert res[0].ids.size == 0 and res[0].values.size == 0
    assert res[0].stats["k"] == 0 and not res[0].degraded
    _same(res[1], search(qs[1], port, port.n_sets))
    assert search_batch([], port, K) == []


def test_validation_errors(corpus):
    _, qs, _, port = corpus
    with pytest.raises(ValueError, match="empty SetStore"):
        search_batch([qs[0]], SetStore(dim=D, device="cpu"), K)
    with pytest.raises(ValueError, match="k"):
        search_batch([qs[0], qs[1]], port, [3])
    with pytest.raises(ValueError, match="k"):
        search_batch([qs[0]], port, -1)
    bad = qs[0].copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        search_batch([bad], port, K)
    with pytest.raises(ValueError, match="variant"):
        search_batch([qs[0]], port, K, variant="chamfer")
    with pytest.raises(ValueError, match="masked backend"):
        search_batch([qs[0]], port, K, masked_backend="multiquery_pallas")
    with pytest.raises(ValueError, match="shards"):
        search_batch([qs[0]], port, K, shards=2)
    with pytest.raises(ValueError, match="epsilon"):
        search_batch([qs[0]], port, K, epsilon=0.5)


def test_deadline_zero_degrades_every_query(corpus):
    _, qs, _, port = corpus
    res = search_batch(qs, port, K, deadline_s=0.0)
    for r in res:
        assert r.degraded and r.stage_reached in ("stage0", "stage2a", "stage2b")
        assert r.ids.size == K and np.all(r.lower <= r.upper)


@pytest.mark.parametrize("backend", sorted(masked.EXACT_MASKED_BACKENDS))
def test_every_masked_backend_matches_bruteforce(corpus, backend):
    _, qs, _, port = corpus
    res = search_batch(qs[:3], port, K, masked_backend=backend)
    for q, r in zip(qs[:3], res):
        _same(r, search(q, port, K, method="exact"))
    assert res[0].stats["masked_backend"] == backend


def test_anytime_eps0_is_exact_and_eps_gives_certified_recall(corpus):
    _, qs, _, port = corpus
    exact = search_batch(qs, port, K, mode="anytime", epsilon=0.0)
    for q, r in zip(qs, exact):
        _same(r, search(q, port, K, method="exact"))
        assert r.stats["converged"]
    loose = search_batch(qs, port, K, mode="anytime", epsilon=2.0)
    for r in loose:
        assert not r.degraded and np.all(r.lower <= r.upper) and 0.0 <= r.certified_recall_at_k <= 1.0


@pytest.mark.parametrize("first, device_kind, ladder", [
    (None, "cuda", ["multiquery_cuda"]),
    (None, "cpu", ["multiquery_mirror", "batched_mirror", "dense", "fused_mirror", "tiled"]),
    ("multiquery_cuda", "cpu", ["multiquery_cuda", "batched_mirror", "dense", "fused_mirror",
                                "multiquery_mirror", "tiled"]),
])
def test_masked_backend_ladder(first, device_kind, ladder):
    """On the card the ladder is kernel 3 alone; on the CPU the plain
    versions follow, never another kernel's backend."""
    first = first or resolver.resolve_multiquery_backend(4, 64, 256, device_kind=device_kind)
    assert cascade.masked_backend_ladder(first, device_kind) == ladder


def test_backend_unavailable_moves_the_ladder_and_keeps_the_ids(corpus):
    _, qs, _, port = corpus
    with inject(Fault("cascade.backend", action="backend_down", match="multiquery_mirror")):
        res = search_batch(qs[:2], port, K, on_fault="raise")
    assert res[0].stats["backend_fallbacks"] == ["multiquery_mirror"]
    assert res[0].stats["masked_backend"] == "batched_mirror"
    for q, r in zip(qs[:2], res):
        _same(r, search(q, port, K, method="exact"))
    downs = [Fault("cascade.backend", action="backend_down", match=b) for b in masked.EXACT_MASKED_BACKENDS]
    with inject(*downs), pytest.raises(BackendUnavailable):
        search_batch(qs[:2], port, K)


def test_fault_degrades_or_raises(corpus):
    _, qs, _, port = corpus
    with inject(Fault("cascade.stage2b", action="raise")):
        res = search_batch(qs[:2], port, K)
        assert all(r.degraded and r.stats["fault"][0]["type"] == "InjectedFault" for r in res)
        with pytest.raises(InjectedFault):
            search_batch(qs[:2], port, K, on_fault="raise")
    with inject(Fault("cascade.stage0", action="raise")), pytest.raises(InjectedFault):
        search_batch(qs[:2], port, K)


def test_spans_and_stats_reach_obs(corpus):
    _, qs, _, port = corpus
    obs.registry().reset()
    with obs.capture() as events:
        res = search_batch([qs[0], qs[1], qs[0]], port, K)
    spans = {e["name"]: e for e in events() if e["type"] == "span"}
    assert {"index.search_batch", "cascade.stage0", "cascade.stage2a", "cascade.stage2b"} <= set(spans)
    root = spans["index.search_batch"]
    assert root["parent_id"] is None and root["attrs"]["dedup_hits"] == 1
    assert all(e["rid"] == root["rid"] for e in spans.values())
    passes = [e["attrs"] for e in events() if e["name"] == "cascade.stage2a_pass"]
    assert len(passes) == res[0].stats["multiquery_launches"]
    assert obs.registry().snapshot()["index.search_batch.dedup_hits"]["sum"] == 1
    obs.registry().reset()


def test_refine_backend_resolved_once(corpus, monkeypatch):
    _, qs, _, port = corpus
    calls = []
    real = resolver.resolve_backend

    def counted(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(resolver, "resolve_backend", counted)
    res = search_batch(qs, port, K, backend="auto")
    assert len(calls) == 1 and res[0].stats["refine_backend"] in ("dense", "tiled")
