"""The port's embeddings, retrieval top-k and sharding rules held to the reference's.

``models.embeddings`` (``lookup``, ``embedding_bag``, the segment
reductions), ``models.retrieval`` (``retrieval_topk``) and
``sharding.axes`` against ``repro.models.{embeddings,retrieval}`` and
``repro.sharding.axes`` on the same numpy inputs; then the SPMD forms over
gloo ranks on the CPU (P = 1 in the pytest process, P = 2 and 4 spawned,
``FileStore`` in the test's temporary directory): ``sharded_lookup``
against ``lookup``, sharded ``retrieval_topk`` against the reference's
unsharded one (a shard with fewer than k rows and ties across shards
included), and ``fm_score`` with its tables row-sharded over a "model"
axis against the reference's ``fm_score``.

Tolerances: gathered rows bitwise; scores rtol 2e-4, atol 2e-5 (the
reference's GAT tolerance); top-k ids equal, ties lowest index first as
``lax.top_k`` orders them.
"""
import datetime
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.models import embeddings as ref_emb  # noqa: E402
from repro.models import recsys as ref_rec  # noqa: E402
from repro.models import retrieval as ref_ret  # noqa: E402
from repro.sharding import axes as ref_axes  # noqa: E402
from repro_torch.models import embeddings as emb  # noqa: E402
from repro_torch.models import retrieval as ret  # noqa: E402
from repro_torch.sharding import axes  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 2e-4, 2e-5
SPAWN_TIMEOUT_S = 300


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_lookup_is_jnp_take_out_of_range_ids_included():
    """Trap: jnp.take wraps a negative id once and fills NaN past either
    end, where index_select would raise."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[5, -1, -4], [-5, 4, 2]], np.int32)
    ours = emb.lookup(_t(table), _t(ids)).numpy()
    ref = np.asarray(ref_emb.lookup(jnp.asarray(table), jnp.asarray(ids)))
    np.testing.assert_array_equal(ours, ref)  # NaN positions equal too
    assert np.isnan(ours[0, 0]).all() and np.isnan(ours[1, :2]).all()
    np.testing.assert_array_equal(ours[0, 1:], table[[3, 0]])


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(combiner):
    """Unsorted bags, an empty bag (2), and out-of-range bag ids (−1, 5),
    which segment_sum / segment_max drop; an empty bag is 0 (sum, mean)
    or −inf (max)."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((20, 6)).astype(np.float32)
    flat = rng.integers(0, 20, 14).astype(np.int32)
    seg = np.array([0, 3, 1, 0, 4, 3, 3, -1, 1, 5, 0, 4, 4, 1], np.int32)
    ours = emb.embedding_bag(_t(table), _t(flat), _t(seg), 5, combiner=combiner).numpy()
    ref = np.asarray(ref_emb.embedding_bag(jnp.asarray(table), jnp.asarray(flat), jnp.asarray(seg), 5,
                                           combiner=combiner))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
    assert np.all(ours[2] == (-np.inf if combiner == "max" else 0.0))
    with pytest.raises(ValueError):
        emb.embedding_bag(_t(table), _t(flat), _t(seg), 5, combiner="median")


def test_embedding_bag_mean_gradient_matches_reference():
    rng = np.random.default_rng(1)
    table = rng.standard_normal((9, 4)).astype(np.float32)
    flat = rng.integers(0, 9, 12).astype(np.int32)
    seg = np.repeat(np.arange(4), 3).astype(np.int32)
    w = rng.standard_normal((4, 4)).astype(np.float32)
    ref_g = jax.grad(lambda t: jnp.sum(ref_emb.embedding_bag(t, jnp.asarray(flat), jnp.asarray(seg), 4,
                                                             combiner="mean") * w))(jnp.asarray(table))
    t = _t(table).requires_grad_()
    (emb.embedding_bag(t, _t(flat), _t(seg), 4, combiner="mean") * _t(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_g), rtol=1e-6, atol=1e-7)


def _tied_candidates():
    """32 candidates in 8 dims with planted duplicates: rows 3, 11 and 20
    equal (tied scores), rows 7 and 8 equal."""
    rng = np.random.default_rng(2)
    c = rng.standard_normal((32, 8)).astype(np.float32)
    c[11] = c[20] = c[3]
    c[8] = c[7]
    q = np.stack([c[3] * 2.0, c[7], rng.standard_normal(8).astype(np.float32)])
    return c, q


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("k", [1, 5, 32])
def test_retrieval_topk_matches_reference_ties_lowest_index_first(metric, k):
    c, q = _tied_candidates()
    ours = ret.retrieval_topk(_t(c), _t(q), k, metric=metric)
    ref = ref_ret.retrieval_topk(jnp.asarray(c), jnp.asarray(q), k, metric=metric)
    assert ours.ids.dtype == torch.int32
    np.testing.assert_array_equal(ours.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_allclose(ours.scores.numpy(), np.asarray(ref.scores), rtol=1e-5, atol=1e-5)
    if k >= 3:
        assert list(ours.ids[0, :3].numpy()) == [3, 11, 20]


def test_top_k_orders_ties_as_lax_top_k():
    s = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, -np.inf, -np.inf]], np.float32)
    vals, idx = ret.top_k(_t(s), 6)
    r_vals, r_idx = jax.lax.top_k(jnp.asarray(s), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(r_vals))


NAMES = [None, "batch", "model", "fsdp", "kv_model", "expert_model", "ff_model"]
RULES = [dict(), dict(batch=("pod", "data"), model="model", fsdp=("data",)),
         dict(batch=("data",), model="model", shard_kv=True, shard_expert=True)]


@pytest.mark.parametrize("kw", RULES)
def test_mesh_rules_specs_equal_the_references(kw):
    ours, ref = axes.MeshRules(**kw), ref_axes.MeshRules(**kw)
    for n in NAMES:
        assert ours.resolve(n) == ref.resolve(n)
    assert ours.spec(*NAMES) == tuple(ref.spec(*NAMES))
    assert ours.spec() == tuple(ref.spec()) == ()
    with pytest.raises(KeyError):
        ours.resolve("nope")
    assert axes.current_rules() == axes.MeshRules()
    with axes.use_rules(ours) as r, ref_axes.use_rules(ref):
        assert r is ours and axes.current_rules() is ours
        assert axes.logical("batch", None, "model") == tuple(ref_axes.logical("batch", None, "model"))
        x = torch.ones(3)
        assert axes.shard(x, "batch") is x  # a layout hint: the same tensor
    assert axes.current_rules() == axes.MeshRules()


# ---------------------------------------------------------------------------
# SPMD over gloo ranks
# ---------------------------------------------------------------------------

WORKER = r'''
import datetime, sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs.base import load_arch, smoke_recsys_config
from repro_torch.models import recsys
from repro_torch.models.embeddings import sharded_lookup
from repro_torch.models.param_tree import ParamTree
from repro_torch.models.retrieval import retrieval_topk
from repro_torch.sharding.axes import MeshRules, use_rules


def block(x, r, p):
    n = x.shape[0] // p
    return torch.from_numpy(np.ascontiguousarray(x[r * n:(r + 1) * n]))


def run(root, world, rank):
    with np.load(f"{root}/inputs.npz") as f:
        a = dict(f)
    t = lambda k: torch.from_numpy(a[k])
    out = {}
    m1 = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    rules = MeshRules(model="model", mesh=m1)
    out["lookup_whole"] = sharded_lookup(t("table"), t("ids"), rules).numpy()
    out["lookup_block"] = sharded_lookup(block(a["table"], rank, world), t("ids"), rules,
                                         vocab=a["table"].shape[0]).numpy()
    with use_rules(rules):  # the context's rules; ids past the end read zeros
        out["lookup_oob"] = sharded_lookup(t("table"), t("ids_oob")).numpy()
    # a vocab the model axis does not divide: plain lookup of the whole table
    out["lookup_odd"] = sharded_lookup(t("table")[:-1], t("ids"), rules).numpy()
    m2 = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    brules = MeshRules(batch=("data",), mesh=m2)
    for metric in ("dot", "l2"):
        for k in (5, 12):
            top = retrieval_topk(block(a["cands"], rank, world), t("queries"), k, metric=metric, rules=brules)
            out[f"topk_{metric}_{k}_scores"], out[f"topk_{metric}_{k}_ids"] = top.scores.numpy(), top.ids.numpy()
    # fm_score with its tables row-sharded over "model" (world 2), or over the
    # "model" dim of a 2 x 2 mesh with the batch over "data" (world 4)
    cfg = smoke_recsys_config(load_arch("fm").config)
    if world in (2, 4):
        mesh = init_device_mesh("cpu", (world // 2, 2), mesh_dim_names=("data", "model"))
        frules = MeshRules(batch=("data",), model="model", mesh=mesh)
        m_rank = dist.get_rank(mesh.get_group("model"))
        d_rank = dist.get_rank(mesh.get_group("data"))
    else:
        frules, m_rank, d_rank = MeshRules(model="model", mesh=m1), 0, 0
    n_model = 2 if world in (2, 4) else 1
    model = ParamTree({"embed": block(a["fm_embed"], m_rank, n_model), "linear": block(a["fm_linear"], m_rank, n_model),
                       "bias": t("fm_bias")})
    ids = block(a["fm_ids"], d_rank, world // n_model)
    with use_rules(frules), torch.no_grad():
        out["fm_score"] = recsys.fm_score(model, {"ids": ids}, cfg).numpy()
    return out


if __name__ == "__main__":
    torch.set_num_threads(1)
    rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(f"{root}/store-{world}", world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        np.savez(f"{root}/out-{world}-{rank}.npz", **run(root, world, rank))
    finally:
        dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    c, q = _tied_candidates()
    c = np.concatenate([c, c[:8]])  # 40 rows: at P = 4 every shard has 10 < k = 12 rows
    fm_cfg = ref_base.smoke_recsys_config(ref_base.load_arch("fm").config)
    fm = ref_rec.fm_init(jax.random.PRNGKey(0), fm_cfg)
    return {"table": rng.standard_normal((64, 5)).astype(np.float32),
            "ids": rng.integers(0, 64, (6, 3)).astype(np.int32),
            "ids_oob": np.array([[0, 63, 64, 200]], np.int32),
            "cands": c, "queries": q,
            "fm_embed": np.asarray(fm["embed"]), "fm_linear": np.asarray(fm["linear"]),
            "fm_bias": np.asarray(fm["bias"]),
            "fm_ids": np.random.default_rng(4).integers(0, 512, (8, fm_cfg.n_sparse)).astype(np.int32)}


@pytest.fixture(scope="module", autouse=True)
def spawned(inputs, tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_emb")
    np.savez(root / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = {(p, r): subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(p), str(root)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for p in (2, 4) for r in range(p)}
    try:
        yield root, procs
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def spmd(spawned):
    root, procs = spawned
    ns = {"__name__": "torch_emb_worker"}
    exec(compile(WORKER, "torch_emb_worker", "exec"), ns)
    dist.init_process_group("gloo", store=dist.FileStore(str(root / "store-1"), 1), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = {1: [ns["run"](str(root), 1, 0)]}
    finally:
        dist.destroy_process_group()
    for (p, r), proc in procs.items():
        stdout, stderr = proc.communicate(timeout=SPAWN_TIMEOUT_S)
        assert proc.returncode == 0, f"P={p} rank {r}:\n{stdout}\n{stderr}"
    for p in (2, 4):
        out[p] = []
        for r in range(p):
            with np.load(root / f"out-{p}-{r}.npz") as f:
                out[p].append(dict(f))
    return out


@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_lookup_equals_lookup(spmd, inputs, p):
    want = inputs["table"][inputs["ids"]]
    for r in spmd[p]:  # every rank of the group gets every row, bitwise
        for key in ("lookup_whole", "lookup_block", "lookup_odd"):
            np.testing.assert_array_equal(r[key], want)
        oob = r["lookup_oob"][0]
        np.testing.assert_array_equal(oob[:2], inputs["table"][[0, 63]])
        assert np.all(oob[2:] == 0.0)  # the reference's sharded path: no block owns them


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("k", [5, 12])
def test_sharded_retrieval_topk_matches_reference(spmd, inputs, p, metric, k):
    ref = ref_ret.retrieval_topk(jnp.asarray(inputs["cands"]), jnp.asarray(inputs["queries"]), k, metric=metric)
    for r in spmd[p]:
        np.testing.assert_array_equal(r[f"topk_{metric}_{k}_ids"], np.asarray(ref.ids))
        np.testing.assert_allclose(r[f"topk_{metric}_{k}_scores"], np.asarray(ref.scores), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_fm_score_with_row_sharded_tables_matches_reference(spmd, inputs, p):
    cfg = ref_base.smoke_recsys_config(ref_base.load_arch("fm").config)
    params = {"embed": jnp.asarray(inputs["fm_embed"]), "linear": jnp.asarray(inputs["fm_linear"]),
              "bias": jnp.asarray(inputs["fm_bias"])}
    want = np.asarray(ref_rec.fm_score(params, {"ids": jnp.asarray(inputs["fm_ids"])}, cfg))
    n_data = 1 if p < 4 else 2
    got = np.concatenate([spmd[p][r]["fm_score"] for r in range(0, p, max(1, p // n_data))])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
