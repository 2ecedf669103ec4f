"""The port's SetStore and certified cascade held to ``repro.index``.

One corpus, made with numpy from a seed, is held in both packages: the
reference store draws its direction bank with ``jax.random`` and the port
takes that bank (``interop.store_from_reference``).  The reference runs
its pure-JAX masked backend (``batched_mirror``; ``batched_pallas`` does
not trace on this jax); the port runs on the CPU, where every bucket pass
takes the batched kernel's plain version.  What is checked:

  * store summaries within fp32 rounding of the reference's
    (``1e-5 · scale`` absolute — sums over ≤ 40 rows);
  * snapshots written by either package restore in the other, bit for bit;
  * top-k ids equal to the reference's, values within ``fp_value_margin``
    of the reference's and of a float64 oracle;
  * inside the port, the cascade bitwise equal to its own brute force
    (hausdorff/directed × batched/sequential, anytime ε = 0, after
    delete + compact);
  * every injection point under ``degrade`` and ``raise``, and the masked
    backend ladder (the kernel alone on the card);
  * the search's spans, events and stats in ``repro_torch.obs``;
  * the reference's failing cases of ``ROADMAP.md`` against float64 and
    the written conventions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import strategies  # noqa: E402
from repro.index import SetStore as RefStore  # noqa: E402
from repro.index import cascade as jcascade  # noqa: E402
from repro_torch import interop, obs  # noqa: E402
from repro_torch.core import masked  # noqa: E402
from repro_torch.core.fp_margin import fp_value_margin  # noqa: E402
from repro_torch.data.pointclouds import clustered_sets  # noqa: E402
from repro_torch.hd import resolver, search  # noqa: E402
from repro_torch.index import cascade  # noqa: E402
from repro_torch.index import SetStore, latest_snapshot  # noqa: E402
from repro_torch.reliability import BackendUnavailable, Fault, InjectedFault, inject  # noqa: E402
from repro_torch.reliability import faults  # noqa: E402

D = 6
K = 5


def _corpus(seed=0, n_sets=120, sizes=tuple(range(5, 41, 5))):
    sets, _ = clustered_sets(seed, n_sets, D, sizes=sizes, n_clusters=5, spread=3.0)
    q = (sets[0].mean(axis=0) + np.random.RandomState(seed + 1).randn(16, D) * 0.5).astype(np.float32)
    return sets, q


@pytest.fixture(scope="module")
def corpus():
    # two buckets (16, 32) keep the reference's jit cache small
    sets, q = _corpus(sizes=tuple(range(10, 33, 2)))
    ref = RefStore(dim=D, min_bucket=16)
    ref.add_many(sets)
    port = interop.store_from_reference(np.asarray(ref.directions), sets, min_bucket=16, device="cpu")
    return sets, q, ref, port


def _hd64(q, s, variant):
    d2 = ((q[:, None].astype(np.float64) - s[None].astype(np.float64)) ** 2).sum(-1)
    h = np.sqrt(d2.min(1).max())
    return h if variant == "directed" else max(h, np.sqrt(d2.min(0).max()))


def _scale(q, s):
    return float(np.linalg.norm(q, axis=1).max() + np.linalg.norm(s, axis=1).max())


def _assert_same(res, ref):
    np.testing.assert_array_equal(res.ids, ref.ids)
    np.testing.assert_array_equal(res.values, ref.values)


def test_clustered_sets_draws_the_references_numbers():
    import jax

    from repro.data.pointclouds import clustered_sets as ref_clustered

    key = jax.random.PRNGKey(3)
    ref_sets, ref_labels = ref_clustered(key, 9, 4, sizes=(3, 5), n_clusters=2)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    sets, labels = clustered_sets(seed, 9, 4, sizes=(3, 5), n_clusters=2)
    np.testing.assert_array_equal(labels, ref_labels)
    for a, b in zip(sets, ref_sets):
        np.testing.assert_array_equal(a, b)


def test_store_summaries_and_slabs_match_reference(corpus):
    sets, _, ref, port = corpus
    scale = max(float(np.abs(s).max()) for s in sets)
    rs, ps = ref.summaries(), port.summaries()
    for field in ("centroid", "r_min", "r_max", "proj_lo", "proj_hi"):
        np.testing.assert_allclose(getattr(ps, field).numpy(), np.asarray(getattr(rs, field)),
                                   rtol=0, atol=1e-5 * scale, err_msg=field)
    np.testing.assert_array_equal(ps.count.numpy(), np.asarray(rs.count))
    rb, pb = ref.packed_buckets(), port.packed_buckets()
    assert sorted(rb) == sorted(pb)
    for cap in rb:
        np.testing.assert_array_equal(pb[cap].set_ids, rb[cap].set_ids)
        np.testing.assert_array_equal(pb[cap].points.numpy(), np.asarray(rb[cap].points))
        np.testing.assert_array_equal(pb[cap].valid.numpy(), np.asarray(rb[cap].valid))
        np.testing.assert_allclose(pb[cap].sqnorms.numpy(), np.asarray(rb[cap].sqnorms),
                                   rtol=1e-6, atol=0)
    assert port.slot_index() == ref.slot_index()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_snapshot_written_by_one_package_restores_in_the_other(corpus, tmp_path, writer):
    sets, q, ref, port = corpus
    if writer == "port":
        port.save(tmp_path)
        back = RefStore.restore(tmp_path)
        want = port.summaries()
        got = back.summaries()
        for field in want._fields:
            np.testing.assert_array_equal(np.asarray(getattr(got, field)), getattr(want, field).numpy())
        np.testing.assert_array_equal(np.asarray(back.directions), port.directions.numpy())
        for sid in range(len(sets)):
            np.testing.assert_array_equal(np.asarray(back.get(sid)), sets[sid])
    else:
        ref.save(tmp_path)
        back = SetStore.restore(tmp_path, device="cpu")
        assert back.device.type == "cpu" and back.restore_report["dropped_buckets"] == []
        want = ref.summaries()
        got = back.summaries()
        for field in want._fields:
            np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
        for sid in range(len(sets)):
            np.testing.assert_array_equal(back.get(sid).numpy(), sets[sid])
        _assert_same(search(q, back, K), search(q, port, K))
    assert latest_snapshot(tmp_path) == 0


@pytest.mark.parametrize("variant", ["hausdorff", "directed"])
def test_cascade_ids_match_reference_values_within_margin(corpus, variant):
    sets, q, ref, port = corpus
    want = jcascade.search(jnp.asarray(q), ref, K, variant=variant, masked_backend="batched_mirror")
    got = search(q, port, K, variant=variant)
    assert got.stats["masked_backend"] == "batched_mirror" and not got.degraded
    np.testing.assert_array_equal(got.ids, want.ids)
    for sid, v, rv in zip(got.ids, got.values, want.values):
        m = fp_value_margin(D, _scale(q, sets[sid]), float(v))
        assert abs(float(v) - float(rv)) <= m
        assert abs(float(v) - _hd64(q, sets[sid], variant)) <= m


@pytest.mark.parametrize("stage2", ["batched", "sequential"])
@pytest.mark.parametrize("variant", ["hausdorff", "directed"])
def test_cascade_bitwise_equals_own_brute_force(corpus, variant, stage2):
    _, q, _, port = corpus
    bf = search(q, port, K, variant=variant, method="exact")
    res = search(q, port, K, variant=variant, stage2=stage2)
    _assert_same(res, bf)
    assert res.stats["stage0_pruned"] + res.stats["stage1_pruned"] > 0
    assert res.stats["exact_refines"] < port.n_sets


@pytest.mark.parametrize("variant", ["hausdorff", "directed"])
def test_anytime_at_zero_epsilon_is_the_exact_cascade(corpus, variant):
    _, q, _, port = corpus
    res = search(q, port, K, variant=variant, mode="anytime", epsilon=0.0)
    _assert_same(res, search(q, port, K, variant=variant, method="exact"))
    assert res.certified_recall_at_k == 1.0 and res.meta.mode == "anytime"
    loose = search(q, port, K, variant=variant, mode="anytime", epsilon=0.5, budget=2)
    assert loose.stats["anytime_refines"] <= 2
    truth = np.array([_hd64(q, s, variant) for s in corpus[0]])[loose.ids]
    m = np.array([fp_value_margin(D, _scale(q, corpus[0][i]), v) for i, v in zip(loose.ids, loose.values)])
    assert np.all(loose.lower - m <= truth) and np.all(truth <= loose.upper + m)


def test_delete_and_compact_equal_brute_force_over_survivors():
    sets, q = _corpus(seed=5, n_sets=90)
    store = SetStore(dim=D, device="cpu", compact_threshold=1.0)
    store.add_many(sets)
    store.packed_buckets()                         # tombstones patch the cache
    dead = np.random.RandomState(0).choice(len(sets), size=27, replace=False)
    for sid in dead:
        store.delete(int(sid))
    for stage2 in ("batched", "sequential"):
        res = search(q, store, K, stage2=stage2)
        _assert_same(res, search(q, store, K, method="exact"))
        assert not set(res.ids.tolist()) & set(dead.tolist())
    removed = store.compact()
    assert sum(removed.values()) == 27 and store.n_live == 63
    res = search(q, store, K)
    _assert_same(res, search(q, store, K, method="exact"))
    # the survivors' brute force, computed from scratch
    live = [i for i in range(len(sets)) if i not in set(dead.tolist())]
    truth = sorted((float(search(q, _single(sets[i]), 1, method="exact").values[0]), i) for i in live)
    np.testing.assert_array_equal(res.ids, [i for _, i in truth[:K]])


def _single(points):
    s = SetStore(dim=D, device="cpu")
    s.add(points)
    return s


CASCADE_POINTS = ["cascade.stage1", "cascade.stage2a", "cascade.stage2b"]


@pytest.mark.parametrize("point", CASCADE_POINTS + ["cascade.anytime"])
def test_fault_points_degrade_or_raise(corpus, point):
    sets, q, _, port = corpus
    kw = dict(mode="anytime", epsilon=0.25) if point == "cascade.anytime" else {}
    with inject(Fault(point)):
        res = search(q, port, K, on_fault="degrade", **kw)
    assert res.degraded and res.stats["fault"][0]["type"] == "InjectedFault"
    truth = np.array([_hd64(q, s, "hausdorff") for s in sets])[res.ids]
    m = np.array([fp_value_margin(D, _scale(q, sets[i]), max(u, 1.0)) for i, u in zip(res.ids, res.upper)])
    assert np.all(res.lower - m <= truth) and np.all(truth <= res.upper + m)
    with inject(Fault(point)), pytest.raises(InjectedFault):
        search(q, port, K, on_fault="raise", **kw)


def test_stage0_fault_always_raises_and_deadline_degrades(corpus):
    _, q, _, port = corpus
    with inject(Fault("cascade.stage0")), pytest.raises(InjectedFault):
        search(q, port, K, on_fault="degrade")
    res = search(q, port, K, deadline_s=0.0)
    assert res.degraded and res.stage_reached == "stage0" and "fault" not in res.stats


def test_store_fault_points_leave_the_store_unchanged(tmp_path):
    sets, q = _corpus(seed=7, n_sets=30)
    store = SetStore(dim=D, device="cpu", compact_threshold=1.0)
    store.add_many(sets)
    store.delete(3)
    with inject(Fault("store.compact")), pytest.raises(InjectedFault):
        store.compact()
    assert store.tombstone_fraction(store.slot_index()[4][0]) >= 0.0 and not store.is_live(3)
    assert sum(len(v) for v in store._members.values()) == 30
    store.save(tmp_path)
    with inject(Fault("store.restore")), pytest.raises(InjectedFault):
        SetStore.restore(tmp_path, device="cpu")
    assert set(faults.injection_points()) >= {
        "cascade.stage0", "cascade.stage1", "cascade.stage2a", "cascade.stage2b",
        "cascade.backend", "cascade.anytime", "store.restore", "store.compact",
    }


def test_backend_unavailable_moves_the_ladder_and_keeps_the_ids(corpus):
    _, q, _, port = corpus
    bf = search(q, port, K, method="exact")
    with inject(Fault("cascade.backend", action="backend_down", match="batched_mirror")):
        res = search(q, port, K, on_fault="raise")
    assert res.stats["backend_fallbacks"] == ["batched_mirror"]
    assert res.stats["masked_backend"] == "dense" and not res.degraded
    _assert_same(res, bf)
    # every backend down: the typed error propagates, never a degraded result
    downs = [Fault("cascade.backend", action="backend_down", match=b) for b in masked.EXACT_MASKED_BACKENDS]
    with inject(*downs), pytest.raises(BackendUnavailable):
        search(q, port, K)


@pytest.mark.parametrize("device_kind, first, ladder", [
    pytest.param("cuda", None, ["batched_cuda"], id="cuda-ladder0"),
    pytest.param("cpu", None, ["batched_mirror", "dense", "fused_mirror", "multiquery_mirror", "tiled"],
                 id="cpu-ladder1"),
    pytest.param("cpu", "multiquery_cuda",
                 ["multiquery_cuda", "batched_mirror", "dense", "fused_mirror", "multiquery_mirror", "tiled"],
                 id="cpu-multiquery_cuda"),
])
def test_masked_backend_ladder_per_device(device_kind, first, ladder):
    """On the card the ladder is the kernel alone (no plain version takes
    over a CUDA search); on the CPU the plain versions follow in order and
    no kernel's backend (``*_cuda``) joins a ladder it does not lead."""
    first = first or resolver.resolve_masked_backend(1, 64, 256, device_kind=device_kind)
    assert cascade.masked_backend_ladder(first, device_kind) == ladder


@pytest.mark.parametrize("budget, cap", [(None, 40), (7, 7), (40, 40), (100, 40), (0, 0)])
def test_anytime_refine_cap_clamps_the_budget(budget, cap):
    assert resolver.resolve_anytime_refine_cap(40, 10, budget) == cap


def test_search_spans_events_and_stats_reach_the_registry(corpus):
    _, q, _, port = corpus
    obs.registry().reset()
    with obs.capture() as events:
        res = search(q, port, K)
    spans = [e for e in events() if e["type"] == "span"]
    by_name = {e["name"]: e for e in spans}
    assert {"index.search", "cascade.stage0", "cascade.stage1", "cascade.stage2a"} <= set(by_name)
    root = by_name["index.search"]
    assert root["parent_id"] is None and all(e["rid"] == root["rid"] for e in spans)
    assert by_name["cascade.stage0"]["attrs"]["pruned"] == res.stats["stage0_pruned"]
    passes = [e["attrs"] for e in events() if e["name"] == "cascade.stage1_pass"]
    assert passes and all(p["batch"] >= p["lanes"] > 0 for p in passes)
    snap = obs.registry().snapshot()
    assert snap["span.index.search.s"]["count"] == 1 and snap["span.index.search.total"]["value"] == 1.0
    assert snap["index.search.exact_refines"]["sum"] == res.stats["exact_refines"]
    assert not obs.enabled()
    obs.registry().reset()


def test_request_validation():
    sets, q = _corpus(seed=2, n_sets=12)
    store = SetStore(dim=D, device="cpu")
    with pytest.raises(ValueError, match="empty SetStore"):
        search(q, store, 1)
    store.add_many(sets)
    with pytest.raises(ValueError, match="shards="):
        search(q, store, 1, shards=2)
    bad = q.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        search(bad, store, 1)
    res = search(q, store, 0)
    assert res.ids.shape == (0,)


# -- the reference's failing cases (ROADMAP "What the reference is") --------


def test_reference_failing_cascade_case_equals_brute_force():
    """Cascade top-k case (0, 1, 0, 'hausdorff', 2, 'batched'): in the port
    the cascade equals its brute force and float64's ranking."""
    sets, rng = strategies.ragged_corpus(0, dup_every=0)
    store = SetStore(dim=4, min_bucket=2, device="cpu")
    store.add_many(sets)
    q = strategies.query_near(rng, sets, 4)
    bf = search(q, store, 1, method="exact")
    for be in sorted(masked.EXACT_MASKED_BACKENDS):
        _assert_same(search(q, store, 1, stage2="batched", masked_backend=be), bf)
    truth = np.array([_hd64(q, s, "hausdorff") for s in sets])
    m = fp_value_margin(4, _scale(q, sets[bf.ids[0]]), float(bf.values[0]))
    assert truth[bf.ids[0]] <= truth.min() + 2 * m
    assert abs(float(bf.values[0]) - truth[bf.ids[0]]) <= m


def test_reference_failing_anytime_case_is_certified():
    """Anytime case (0, 1, 0, 0.0, None): ε = 0 is the exact cascade, with
    recall 1 and intervals that contain float64's value."""
    sets, rng = strategies.ragged_corpus(0, dup_every=0)
    store = SetStore(dim=4, device="cpu")
    store.add_many(sets)
    q = strategies.query_near(rng, sets, 4)
    for be in sorted(masked.EXACT_MASKED_BACKENDS):
        res = search(q, store, 1, mode="anytime", epsilon=0.0, masked_backend=be)
        _assert_same(res, search(q, store, 1, masked_backend=be))
        assert res.certified_recall_at_k == 1.0
        t = _hd64(q, sets[res.ids[0]], "hausdorff")
        assert abs(float(res.values[0]) - t) <= fp_value_margin(4, _scale(q, sets[res.ids[0]]), t)


def test_single_all_padded_slab_lane_conventions():
    """test_index.py:411, which the reference fails on this tree: a slab
    lane with no valid row gives +inf (empty target) on every backend,
    directed and undirected."""
    pts = torch.full((1, 8, 3), 7.7e8)
    valid = torch.zeros((1, 8), dtype=torch.bool)
    q = torch.from_numpy(np.random.RandomState(0).randn(5, 3).astype(np.float32))
    for be in sorted(masked.EXACT_MASKED_BACKENDS):
        for directed in (True, False):
            vals = masked.masked_exact_hd_batched(q, pts, valid_slab=valid, directed=directed, backend=be,
                                                  block_a=64, block_b=64)
            assert vals.shape == (1,) and torch.isinf(vals[0]), (be, directed)
