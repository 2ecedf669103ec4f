"""The port's graph pipeline (``repro_torch.data.graphs``) held to the reference's bit for bit.

Both are host-side numpy; for the same ``np.random.Generator`` state the
CSR graph, every sampled subgraph, the minibatch stream and the
dst-owner edge partition must be the same arrays, dtypes included.
"""
import numpy as np
import pytest

from repro.data import graphs as ref_graphs
from repro_torch.data import graphs


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _graph(pkg, seed, n=300, deg=6, f=5, c=4):
    return pkg.CSRGraph.random(np.random.default_rng(seed), n, deg, f, c)


@pytest.mark.parametrize("seed", [0, 3])
def test_csr_random_bitwise(seed):
    ours, ref = _graph(graphs, seed), _graph(ref_graphs, seed)
    for f in ("indptr", "indices", "feats", "labels"):
        _same(getattr(ours, f), getattr(ref, f))
    assert ours.n_nodes == ref.n_nodes == 300 and ours.n_edges == ref.n_edges


@pytest.mark.parametrize("fanouts", [(4,), (5, 3), (15, 10)])
def test_sample_subgraph_bitwise(fanouts):
    seeds = np.random.default_rng(7).choice(300, 16, replace=False)
    ours = graphs.sample_subgraph(_graph(graphs, 1), seeds, fanouts, np.random.default_rng(11))
    ref = ref_graphs.sample_subgraph(_graph(ref_graphs, 1), seeds, fanouts, np.random.default_rng(11))
    _same(ours, ref)
    n = 16 * int(np.sum(np.cumprod((1,) + fanouts)))  # seeds, then each hop's children
    assert ours["feats"].shape[0] == n and ours["label_mask"].sum() == 16


def test_sample_subgraph_masks_missing_neighbours():
    """A node of degree 0 and one of degree below the fanout: their
    missing children are masked, not resampled, in both packages."""
    g = graphs.CSRGraph(indptr=np.array([0, 0, 2, 5], np.int64), indices=np.array([2, 0, 1, 1, 0], np.int32),
                        feats=np.arange(6, dtype=np.float32).reshape(3, 2), labels=np.array([0, 1, 2], np.int32))
    r = ref_graphs.CSRGraph(g.indptr, g.indices, g.feats, g.labels)
    seeds = np.array([0, 1, 2])
    ours = graphs.sample_subgraph(g, seeds, (3,), np.random.default_rng(0))
    _same(ours, ref_graphs.sample_subgraph(r, seeds, (3,), np.random.default_rng(0)))
    np.testing.assert_array_equal(ours["edge_mask"][:9], [0, 0, 0, 1, 1, 0, 1, 1, 1])


def test_minibatch_iterator_bitwise():
    it = graphs.minibatch_iterator(_graph(graphs, 2), 64, (4, 3), seed=5)
    rit = ref_graphs.minibatch_iterator(_graph(ref_graphs, 2), 64, (4, 3), seed=5)
    for _ in range(6):  # past the first epoch's end (300 // 64 = 4 batches an epoch)
        _same(next(it), next(rit))


@pytest.mark.parametrize("n_shards", [1, 2, 4, 3])
def test_partition_edges_by_dst_bitwise(n_shards):
    rng = np.random.default_rng(n_shards)
    n, e = 101, 700
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    mask = (rng.random(e) > 0.1).astype(np.float32)
    ours = graphs.partition_edges_by_dst(src, dst, mask, n, n_shards)
    _same(ours, ref_graphs.partition_edges_by_dst(src, dst, mask, n, n_shards))
    ps, pd, pm, n_pad = ours
    n_local = n_pad // n_shards
    cap = ps.shape[0] // n_shards
    owner = np.repeat(np.arange(n_shards), cap)
    assert np.all(pd // n_local == owner)  # every edge, padded ones too, is owner-local
    assert pm.sum() == mask.sum()
