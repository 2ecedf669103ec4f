"""The port's corpus-sharded search (``shards=``) held to ``repro.index``.

Mirrors ``tests/test_sharded.py``.  ``search(..., shards=P)`` and
``search_batch(..., shards=P)`` run stages 0 and 1 over the first P
visible devices of the store's kind, in one process.  Two layers:

- ``shards=1`` in the pytest process, on the CPU: the whole sharded code path
  (context, row-split stage 0, block-dealt stage 1, cross-shard merge), its
  results bit for bit the unsharded call's, and every stat but ``shards``
  the same;
- P ∈ {2, 3, 8} through ``sharded.visible_devices`` monkeypatched to P CPU
  devices (the port's counterpart of the reference's
  ``--xla_force_host_platform_device_count``): ids and values bitwise
  equal to the unsharded call and to brute force, on a fresh and on a
  mutated (delete / update / compact) store, and the top-k ids equal to
  the reference's ``search`` on the same sets.

The reference's validation errors are raised: ``mode="anytime"`` or
``method="exact"`` with ``shards=``, ``shards=0``, and more shards than
visible devices.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.index import SetStore as RefStore  # noqa: E402
from repro.index import search as ref_search  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.index import SetStore, make_shard_context, search, search_batch, sharded  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

pytestmark = pytest.mark.sharded

DIM = 8
SHARDS = [2, 3, 8]


def _sets(n, rng, lo=3, hi=60):
    return [rng.normal(size=(int(rng.integers(lo, hi)), DIM)).astype(np.float32) for _ in range(n)]


def _corpus(n=120, seed=0):
    rng = np.random.default_rng(seed)
    store = SetStore(dim=DIM, device="cpu")
    store.add_many(_sets(n, rng))
    return store, rng


def _mutate(store, rng, n):
    for sid in range(0, n, 4):
        store.delete(sid)
    store.update(1, rng.normal(size=(25, DIM)).astype(np.float32))
    store.compact()


def _same(a, b):
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.values, b.values)


@pytest.fixture
def devices(monkeypatch):
    """Make ``visible_devices`` report 8 CPU devices."""
    monkeypatch.setattr(sharded, "visible_devices", lambda kind: [torch.device("cpu")] * 8)


class TestShardedSingleDevice:
    def test_shards1_bitwise_identity_search(self):
        store, _ = _corpus()
        for seed in range(3):
            q = np.random.default_rng(100 + seed).normal(size=(7, DIM)).astype(np.float32)
            a = search(q, store, 10)
            b = search(q, store, 10, shards=1)
            _same(a, b)
            assert b.stats.pop("shards") == 1
            assert a.stats == b.stats  # the same _stage1_batch calls: every stat

    def test_shards1_bitwise_identity_search_batch(self):
        store, rng = _corpus(seed=1)
        qs = [rng.normal(size=(int(rng.integers(4, 12)), DIM)).astype(np.float32) for _ in range(4)]
        for x, y in zip(search_batch(qs, store, 6), search_batch(qs, store, 6, shards=1)):
            _same(x, y)
            assert y.stats.pop("shards") == 1
            assert x.stats == y.stats

    def test_shards1_on_mutated_store(self):
        store, rng = _corpus(seed=2)
        _mutate(store, rng, 120)
        q = rng.normal(size=(6, DIM)).astype(np.float32)
        _same(search(q, store, 10), search(q, store, 10, shards=1))

    def test_directed_variant(self):
        store, rng = _corpus(seed=3, n=50)
        q = rng.normal(size=(6, DIM)).astype(np.float32)
        _same(search(q, store, 5, variant="directed"), search(q, store, 5, variant="directed", shards=1))
        x, = search_batch([q], store, 5, variant="directed")
        y, = search_batch([q], store, 5, variant="directed", shards=1)
        _same(x, y)

    def test_validation(self):
        store, rng = _corpus(seed=4, n=20)
        q = rng.normal(size=(4, DIM)).astype(np.float32)
        with pytest.raises(ValueError, match="anytime"):
            search(q, store, 3, shards=1, mode="anytime", epsilon=0.1)
        with pytest.raises(ValueError, match="anytime"):
            search_batch([q], store, 3, shards=1, mode="anytime", epsilon=0.1)
        with pytest.raises(ValueError, match="exact"):
            search(q, store, 3, shards=1, method="exact")
        with pytest.raises(ValueError, match="exceeds"):
            search(q, store, 3, shards=4096)
        with pytest.raises(ValueError, match="exceeds"):
            search_batch([q], store, 3, shards=2)
        with pytest.raises(ValueError, match=">= 1"):
            search(q, store, 3, shards=0)
        with pytest.raises(ValueError, match=">= 1"):
            make_shard_context(0)

    def test_shard_merge_span_emitted(self):
        store, rng = _corpus(seed=5, n=60)
        q = rng.normal(size=(5, DIM)).astype(np.float32)
        with trace.capture() as get_events:
            search(q, store, 5, shards=1)
            events = get_events()
        spans = {e["name"]: e for e in events if e["type"] == "span"}
        assert "cascade.shard_merge" in spans, "sharded search must emit the cascade.shard_merge span"
        merge = spans["cascade.shard_merge"]
        assert merge["attrs"]["shards"] == 1
        assert merge["attrs"]["pruned"] == spans["cascade.stage1"]["attrs"]["pruned"]
        assert merge["rid"] == spans["index.search"]["rid"]
        assert spans["cascade.stage0"]["attrs"]["shards"] == 1

    @pytest.mark.parametrize("call", ["search", "search_batch"])
    def test_unsharded_call_has_no_shard_trace_or_stat(self, call):
        # shards=None runs the sharded functions on one device but reports
        # nothing of shards: no stat, no stage-0 attribute, no merge span.
        store, rng = _corpus(seed=6, n=60)
        q = rng.normal(size=(5, DIM)).astype(np.float32)
        with trace.capture() as get_events:
            res = search(q, store, 5) if call == "search" else search_batch([q], store, 5)[0]
            events = get_events()
        spans = {e["name"]: e for e in events if e["type"] == "span"}
        assert "shards" not in res.stats
        assert "cascade.shard_merge" not in spans
        assert "shards" not in spans["cascade.stage0"]["attrs"]

    def test_visible_devices_and_context(self):
        assert sharded.visible_devices("cpu") == [torch.device("cpu")]
        ctx = make_shard_context(1, "cpu")
        assert ctx.n_shards == 1 and ctx.devices == [torch.device("cpu")]
        if not torch.cuda.is_available():
            with pytest.raises(ValueError, match="exceeds the 0 visible cuda"):
                make_shard_context(1)


@pytest.mark.parametrize("n,p", [(0, 3), (2, 3), (7, 3), (8, 8), (300, 8), (5, 1)])
def test_blocks_are_contiguous_and_cover_every_lane(n, p):
    blocks = sharded._blocks(n, p)
    assert len(blocks) == min(n, p)
    edges = [0] + [hi for _, hi in blocks]
    assert [lo for lo, _ in blocks] == edges[:-1] and edges[-1] == n
    sizes = [hi - lo for lo, hi in blocks]
    assert sizes == sorted(sizes, reverse=True) and (not sizes or sizes[0] - sizes[-1] <= 1)


# ---------------------------------------------------------------------------
# P shards on the CPU, and the reference's ids on the same sets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus300():
    """300 sets, 4 queries, the reference's top-10 ids before and after the
    mutation (the reference store drew the direction bank the port takes).
    Two buckets (16, 32) and one query size keep the reference's jit cache
    small (~25 s of compiles)."""
    rng = np.random.default_rng(0)
    sets = _sets(300, rng, 10, 33)
    qs = [rng.normal(size=(8, DIM)).astype(np.float32) for _ in range(4)]
    ref = RefStore(dim=DIM, min_bucket=16)
    ref.add_many(sets)
    ref_ids = [np.asarray(ref_search(jnp.asarray(q), ref, 10).ids) for q in qs]
    new = np.random.default_rng(1).normal(size=(33, DIM)).astype(np.float32)
    for sid in range(0, 300, 4):
        ref.delete(sid)
    ref.update(1, new)
    ref.compact()
    ref_ids_mut = [np.asarray(ref_search(jnp.asarray(q), ref, 10).ids) for q in qs[:2]]
    return {"sets": sets, "qs": qs, "directions": np.asarray(ref.directions), "new": new,
            "ref_ids": ref_ids, "ref_ids_mut": ref_ids_mut}


def _port_store(c):
    return interop.store_from_reference(c["directions"], c["sets"], min_bucket=16, device="cpu")


@pytest.mark.parametrize("p", SHARDS)
def test_search_identity_across_shards(corpus300, devices, p):
    store = _port_store(corpus300)
    for q, ids in zip(corpus300["qs"], corpus300["ref_ids"]):
        a = search(q, store, 10)
        b = search(q, store, 10, shards=p)
        _same(a, b)
        _same(b, search(q, store, 10, method="exact"))
        assert b.stats["shards"] == p and not b.degraded
        np.testing.assert_array_equal(b.ids, ids)


@pytest.mark.parametrize("p", SHARDS)
def test_search_batch_identity_across_shards(corpus300, devices, p):
    store = _port_store(corpus300)
    qs = corpus300["qs"]
    for x, y, ids in zip(search_batch(qs, store, 10), search_batch(qs, store, 10, shards=p),
                         corpus300["ref_ids"]):
        _same(x, y)
        assert y.stats["shards"] == p and not y.degraded
        np.testing.assert_array_equal(y.ids, ids)


@pytest.mark.parametrize("p", SHARDS)
def test_identity_survives_delete_update_compact(corpus300, devices, p):
    store = _port_store(corpus300)
    for sid in range(0, 300, 4):
        store.delete(sid)
    store.update(1, corpus300["new"])
    store.compact()
    qs = corpus300["qs"][:2]
    for q, ids in zip(qs, corpus300["ref_ids_mut"]):
        a = search(q, store, 10)
        b = search(q, store, 10, shards=p)
        _same(a, b)
        _same(b, search(q, store, 10, method="exact"))
        np.testing.assert_array_equal(b.ids, ids)
    for x, y in zip(search_batch(qs, store, 10), search_batch(qs, store, 10, shards=p)):
        _same(x, y)


@pytest.mark.parametrize("p", SHARDS)
def test_stage0_rows_are_the_unsharded_bits(corpus300, devices, p):
    store = _port_store(corpus300)
    q = torch.from_numpy(corpus300["qs"][0])
    qsum, sums = store.summarize(q), store.summaries()
    ctx = make_shard_context(p, "cpu")
    from repro_torch.index import cascade

    lb, ub = cascade.interval_bounds(qsum, sums, directed=False)
    got = sharded.stage0_bounds(ctx, qsum, sums, directed=False)
    for want, have in zip((lb, ub, cascade.bound_scale(qsum, sums)), got):
        assert torch.equal(want, have)
