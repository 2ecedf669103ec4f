"""The port's serving layer held to ``repro.serve``'s contracts.

Covers what ``tests/test_serve.py``, ``tests/test_serve_roundtrip.py`` and
``tests/test_engine.py`` hold the reference to, on the port's
``ProHDService`` / ``QueryEngine`` on the CPU (every bucket pass takes a
plain version):

  * served pairwise ProHD within ``fp_value_margin`` of the reference's
    ``ProHDService`` on the same numpy clouds, and certified against
    float64; the port's service built from the reference's config dict;
  * a served search equal to the direct search, bit for bit;
  * the engine: concurrency, shape classes, max_batch flushes,
    ``Overloaded``, deadline top-up, transient-fault retry and persistent
    faults surfacing typed, heartbeat wall time, spans and the Prometheus
    exposition.
"""
import asyncio
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import strategies  # noqa: E402
from repro.serve.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serve.server import ProHDService as RefService  # noqa: E402
from repro.serve.server import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch import interop, obs  # noqa: E402
from repro_torch.core.fp_margin import fp_value_margin  # noqa: E402
from repro_torch.hd import search  # noqa: E402
from repro_torch.index import SetStore  # noqa: E402
from repro_torch.reliability import Fault, inject  # noqa: E402
from repro_torch.reliability.errors import InjectedFault, Overloaded  # noqa: E402
from repro_torch.serve import EngineConfig, ProHDService, QueryEngine, ServeConfig  # noqa: E402
from repro_torch.serve.server import _bucket  # noqa: E402
from repro_torch.train.fault_tolerance import run_with_recovery  # noqa: E402

K = 4


def _run(coro):
    return asyncio.run(coro)


def _clouds(seed, n_a, n_b, d):
    """The paper's Random Clouds with numpy: uniform [0,1]^D, B offset 0.1."""
    rng = np.random.RandomState(seed)
    return rng.rand(n_a, d).astype(np.float32), (rng.rand(n_b, d) + 0.1).astype(np.float32)


def _hd64(a, b):
    d2 = ((a[:, None].astype(np.float64) - b[None].astype(np.float64)) ** 2).sum(-1)
    return max(np.sqrt(d2.min(1).max()), np.sqrt(d2.min(0).max()))


# -- pairwise ----------------------------------------------------------------


def test_served_pairwise_matches_reference_service_and_float64():
    ref_cfg = RefServeConfig(alpha=0.1, bucket_sizes=(256, 512))
    ref, port = RefService(ref_cfg), ProHDService(interop.serve_config_from_dict(dataclasses.asdict(ref_cfg)),
                                                  device="cpu")
    pairs = [_clouds(i, 200 + 60 * i, 300 - 37 * i, 6) for i in range(4)]
    ids = [(ref.submit(a, b), port.submit(a, b)) for a, b in pairs]
    ref_out, port_out = ref.flush(), port.flush()
    for (rid, pid), (a, b) in zip(ids, pairs):
        r, p = ref_out[rid], port_out[pid]
        h = _hd64(a, b)
        scale = float(np.linalg.norm(a, axis=1).max() + np.linalg.norm(b, axis=1).max())
        m = fp_value_margin(6, scale, h)
        for field in ("hd", "lower", "upper"):
            assert abs(p[field] - r[field]) <= fp_value_margin(6, scale, p[field]), (field, p, r)
        assert p["lower"] <= h + m and h <= p["upper"] + m and p["hd"] <= h + m, (p, h)


def test_service_from_reference_configs():
    ref = RefServeConfig(alpha=0.05, bucket_sizes=(64, 128), max_shape_classes=3, max_retries=4)
    cfg = interop.serve_config_from_dict(dataclasses.asdict(ref))
    assert "max_shape_classes" in interop.DROPPED_FIELDS and not hasattr(cfg, "max_shape_classes")
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    eng = interop.engine_config_from_dict(dataclasses.asdict(RefEngineConfig(max_batch=5,
                                                                             masked_backend="multiquery_pallas")))
    assert eng.max_batch == 5 and eng.masked_backend == "multiquery_cuda"
    svc = ProHDService(cfg, device="cpu")
    a, b = _clouds(3, 100, 90, 4)
    rid = svc.submit(a, b)
    out = svc.flush()[rid]
    assert out["lower"] <= _hd64(a, b) * 1.0001 <= out["upper"] * 1.0001 + 1e-4


def test_bucketing_sides_independently_and_rounding_up():
    assert _bucket(100, (128, 512)) == 128 and _bucket(512, (128, 512)) == 512
    assert _bucket(513, (128, 512)) == 1024 and _bucket(1025, (128, 512)) == 2048
    svc = ProHDService(ServeConfig(alpha=0.1, bucket_sizes=(64,)), device="cpu")
    a, b = _clouds(5, 200, 30, 4)                       # larger than every bucket on one side
    rid = svc.submit(a, b)
    out = svc.flush()
    assert out[rid]["lower"] <= _hd64(a, b) * 1.0001 <= out[rid]["upper"] * 1.0001 + 1e-4
    assert svc.flush() == {}                            # the queue was cleared


# -- corpus search through the service ---------------------------------------


def _service_and_twin(sets, min_bucket=8):
    svc = ProHDService(ServeConfig(min_store_bucket=min_bucket, retry_backoff_s=0.0), device="cpu")
    twin = SetStore(dim=sets[0].shape[1], min_bucket=min_bucket, device="cpu")
    for s in sets:
        assert svc.add_set(s) == twin.add(s)
    return svc, twin


@pytest.mark.parametrize("variant", ["hausdorff", "directed"])
def test_served_search_equals_direct_search(variant):
    sets, rng = strategies.ragged_corpus(31, n_sets=18, dup_every=4)
    svc, twin = _service_and_twin(sets)
    q = strategies.query_near(rng, sets, 4)
    rid = svc.submit_search(q, k=3, variant=variant)
    pair = svc.submit(q, sets[1])
    out = svc.flush()
    want = search(q, twin, 3, variant=variant)
    np.testing.assert_array_equal(np.asarray(out[rid]["ids"]), want.ids)
    np.testing.assert_array_equal(np.asarray(out[rid]["values"], np.float32), want.values)
    assert out[rid]["stats"]["exact_refines"] == want.stats["exact_refines"] and pair in out


def test_bad_search_bounces_at_submit_and_faults_stay_per_request():
    sets, rng = strategies.ragged_corpus(35, n_sets=8)
    with pytest.raises(ValueError, match="no corpus to search"):
        ProHDService(device="cpu").submit_search(np.zeros((3, 4), np.float32), k=1)
    svc, twin = _service_and_twin(sets)
    q = strategies.query_near(rng, sets, 4)
    good = svc.submit_search(q, k=2)
    with pytest.raises(ValueError, match="k must be >= 1"):
        svc.submit_search(q, k=0)
    with pytest.raises(ValueError, match="unknown search variant"):
        svc.submit_search(q, k=1, variant="chamfer")
    with pytest.raises(ValueError, match=r"expected \(n_q, 4\)"):
        svc.submit_search(np.zeros((3, 5), np.float32), k=1)
    out = svc.flush()
    np.testing.assert_array_equal(np.asarray(out[good]["ids"]), search(q, twin, 2).ids)
    # a transient fault is retried; a persistent one fails that rid, typed
    with inject(Fault("serve.flush", action="raise", once=True)):
        rid = svc.submit_search(q, k=2)
        assert svc.flush()[rid]["ids"] == out[good]["ids"]
    with inject(Fault("serve.flush", action="raise")):
        rid = svc.submit_search(q, k=2)
        assert svc.flush()[rid]["error"] == "InjectedFault"
    svc = ProHDService(ServeConfig(max_queue=1), device="cpu")
    svc.submit(q, q)
    with pytest.raises(Overloaded):
        svc.submit(q, q)


# -- the query engine --------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    sets, rng = strategies.ragged_corpus(17, n_sets=18, d=4, max_n=16)
    svc = ProHDService(ServeConfig(retry_backoff_s=0.0), device="cpu")
    for s in sets:
        svc.add_set(s)
    qs = [(np.asarray(sets[i]).mean(axis=0) + rng.randn(n_q, 4) * 0.5).astype(np.float32)
          for i, n_q in ((0, 9), (4, 9), (9, 9), (14, 9), (2, 3))]
    return svc, qs


def _engine_run(svc, cfg, body):
    async def main():
        eng = QueryEngine(svc, cfg)
        try:
            return eng, await body(eng)
        finally:
            await eng.close()

    return _run(main())


def test_engine_concurrent_searches_bitwise_one_flush_per_class(served):
    svc, qs = served
    eng, results = _engine_run(svc, EngineConfig(max_wait_s=0.05),
                               lambda e: asyncio.gather(*[e.search(q, K) for q in qs]))
    for q, r in zip(qs, results):
        np.testing.assert_array_equal(r.ids, search(q, svc.store, K).ids)
        np.testing.assert_array_equal(r.values, search(q, svc.store, K).values)
        assert not r.degraded
    # the four 9-point queries share a shape class; the 3-point one has its own
    assert eng.stats["flushes"] == 2 and eng.stats["batched_queries"] == 5


def test_engine_max_batch_flushes_immediately(served):
    svc, qs = served
    eng, results = _engine_run(svc, EngineConfig(max_batch=4, max_wait_s=60.0), lambda e: asyncio.wait_for(
        asyncio.gather(*[e.search(q, K) for q in qs[:4]]), timeout=30))
    assert eng.stats["flushes"] == 1 and all(not r.degraded for r in results)


def test_engine_overloaded_backpressure(served):
    svc, qs = served

    async def body(eng):
        t1 = asyncio.ensure_future(eng.search(qs[0], K))
        t2 = asyncio.ensure_future(eng.search(qs[1], K))
        await asyncio.sleep(0)
        with pytest.raises(Overloaded) as exc:
            await eng.search(qs[2], K)
        assert exc.value.pending == 2 and exc.value.limit == 2
        return await asyncio.gather(t1, t2)

    _, (r1, r2) = _engine_run(svc, EngineConfig(max_queue=2, max_wait_s=0.2), body)
    assert not r1.degraded and not r2.degraded


def test_engine_per_query_deadline_and_topup(served):
    svc, qs = served

    async def body(eng):
        a = asyncio.ensure_future(eng.search(qs[0], K, deadline_s=0.0))
        b = asyncio.ensure_future(eng.search(qs[1], K))
        return await asyncio.gather(a, b)

    eng, (ra, rb) = _engine_run(svc, EngineConfig(max_wait_s=0.05), body)
    assert ra.degraded and ra.ids.size == K and np.all(ra.lower <= ra.upper)
    assert not rb.degraded and eng.stats["topups"] >= 1
    np.testing.assert_array_equal(rb.ids, search(qs[1], svc.store, K).ids)
    np.testing.assert_array_equal(rb.values, search(qs[1], svc.store, K).values)


def test_engine_transient_fault_retried_persistent_surfaces_typed(served):
    svc, qs = served
    with inject(Fault("engine.flush", action="raise", once=True)):
        _, r = _engine_run(svc, EngineConfig(max_wait_s=0.01), lambda e: e.search(qs[0], K))
    np.testing.assert_array_equal(r.ids, search(qs[0], svc.store, K).ids)
    assert not r.degraded

    async def body(eng):
        with pytest.raises(InjectedFault):
            await eng.search(qs[0], K)

    with inject(Fault("engine.flush", action="raise")):
        _engine_run(svc, EngineConfig(max_wait_s=0.01, max_retries=1), body)


def test_engine_admission_validation(served):
    svc, qs = served

    async def body(eng):
        with pytest.raises(ValueError, match="k"):
            await eng.search(qs[0], 0)
        with pytest.raises(ValueError, match="variant"):
            await eng.search(qs[0], K, variant="chamfer")
        with pytest.raises(ValueError, match="query"):
            await eng.search(np.zeros((3, 9), np.float32), K)
        bad = qs[0].copy()
        bad[0, 0] = np.inf
        with pytest.raises(ValueError, match="non-finite"):
            await eng.search(bad, K)

    _engine_run(svc, EngineConfig(), body)
    with pytest.raises(ValueError, match="corpus"):
        QueryEngine(ProHDService(device="cpu"), EngineConfig())


def test_heartbeat_wall_time_and_prometheus_exposition(served):
    svc, qs = served
    base_count, base_total = svc.heartbeat.count, svc.heartbeat.total_wall_s
    obs.registry().reset()
    with obs.capture() as events:
        _engine_run(svc, EngineConfig(max_wait_s=0.01), lambda e: e.search(qs[0], K))
    assert svc.heartbeat.count == base_count + 1 and svc.heartbeat.total_wall_s > base_total
    assert svc.heartbeat.last_wall_s > 0.0
    spans = {e["name"]: e for e in events() if e["type"] == "span"}
    root, flush = spans["engine.search"], spans["engine.flush"]
    assert flush["parent_id"] == root["span_id"] and flush["rid"] == root["rid"]
    assert spans["index.search_batch"]["parent_id"] == flush["span_id"]
    assert spans["index.search_batch"]["rid"] == root["rid"]
    text = obs.registry().to_prometheus()
    assert "# TYPE engine_flushes_total counter\nengine_flushes_total 1\n" in text
    assert "# TYPE engine_queue_depth gauge\n" in text
    assert '# TYPE engine_flush_batch_size histogram\n' in text
    assert 'engine_flush_batch_size_bucket{le="+Inf"} 1\n' in text and "engine_flush_batch_size_count 1\n" in text
    assert "heartbeat_beats_total 1\n" in text
    obs.registry().reset()


def test_run_with_recovery_retries_with_backoff_then_raises():
    sleeps, calls = [], []

    def flaky(start):
        calls.append(start)
        if len(calls) < 3:
            raise InjectedFault("boom")
        return 7

    assert run_with_recovery(flaky, lambda: 0, max_failures=2, retryable=(InjectedFault,),
                             backoff_s=0.5, sleep=sleeps.append) == 7
    assert sleeps == [0.5, 1.0] and len(calls) == 3
    with pytest.raises(InjectedFault):
        run_with_recovery(lambda s: (_ for _ in ()).throw(InjectedFault("x")), lambda: 0, max_failures=1,
                          retryable=(InjectedFault,), sleep=sleeps.append)
    with pytest.raises(ValueError):
        run_with_recovery(lambda s: (_ for _ in ()).throw(ValueError("not retryable")), lambda: 0)
