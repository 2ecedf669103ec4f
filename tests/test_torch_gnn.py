"""The port's GAT (``repro_torch.models.gnn``) held to ``repro.models.gnn``.

The reference draws the parameters (``init_gat_params``); the port gets
the same values through ``interop.gnn_params_from_reference``; the same
numpy graph goes through both.  Sizes are the reference's own test sizes:
GAT at N 240, E 960, F 24 (``tests/test_gnn_partitioned.py``) and a
molecule batch of 4 graphs × 30 nodes.

Tolerances: logits rtol 2e-4, atol 2e-5 (the reference's own GAT
tolerance, ``tests/test_gnn_partitioned.py:55``); losses rtol 1e-4;
gradients 1e-4 relative L2 per parameter tensor against
``jax.value_and_grad``.

The partitioned forms run SPMD over gloo ranks on the CPU: P = 1 in the
pytest process, P = 2 and 4 spawned as subprocesses (``FileStore`` in the
test's temporary directory), each rank given its node block and the edge
slice ``partition_edges_by_dst`` made; the ranks' logits, losses and the
all-reduced sum of their parameter gradients come back through files and
are held to the reference's single-device ``gat_forward``,
``gat_node_loss`` and its gradients on the unpartitioned graph.
"""
import dataclasses
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
from repro.models import gnn as ref_gnn  # noqa: E402
from repro.sharding import axes as ref_axes  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.data.graphs import partition_edges_by_dst  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models.param_tree import tree_of  # noqa: E402
from repro_torch.sharding.axes import MeshRules  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N, E, F, C = 240, 960, 24, 7
RTOL, ATOL = 2e-4, 2e-5
SPAWN_TIMEOUT_S = 300


def quick_jit(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's backend optimisation level
    0, which halves the compile time here; the HLO is the same (LLVM's
    vectorisation may order a sum differently, within rounding)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfgs():
    ref_cfg = ref_base.load_arch("gat-cora").config
    cfg = base.load_arch("gat-cora").config
    assert interop.gnn_config_from_dict(dataclasses.asdict(ref_cfg)) == cfg
    return ref_cfg, cfg


@pytest.fixture(scope="module")
def graph():
    """The reference test's graph (seeded numpy), with self-loops, 40
    masked edges and 64 padded ones; node 5 receives only masked edges
    and its self-loop is masked too (trap: empty segments)."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    src = np.concatenate([src, np.arange(N, dtype=np.int32), np.zeros(64, np.int32)])
    dst = np.concatenate([dst, np.arange(N, dtype=np.int32), np.zeros(64, np.int32)])
    mask = np.ones(len(src), np.float32)
    mask[-64:] = 0.0
    mask[rng.choice(E, 40, replace=False)] = 0.0
    mask[dst == 5] = 0.0
    feats = rng.standard_normal((N, F), dtype=np.float32)
    labels = rng.integers(0, C, N).astype(np.int32)
    label_mask = rng.random(N) > 0.3
    return {"feats": feats, "edge_src": src, "edge_dst": dst, "edge_mask": mask, "labels": labels,
            "label_mask": label_mask}


@pytest.fixture(scope="module")
def params(cfgs):
    ref_cfg, cfg = cfgs
    ref_p = ref_gnn.init_gat_params(jax.random.PRNGKey(0), ref_cfg, F, C)
    ref_np = jax.tree.map(np.asarray, ref_p)
    return ref_p, ref_np, interop.gnn_params_from_reference(ref_np, cfg, device="cpu")


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref_out(cfgs, params, graph):
    """The reference's logits, loss, metrics and gradients on the graph."""
    ref_cfg, _ = cfgs

    def both(p, b):
        return (ref_gnn.gat_forward(p, b, ref_cfg),
                jax.value_and_grad(lambda q: ref_gnn.gat_node_loss(q, b, ref_cfg), has_aux=True)(p))

    logits, ((loss, metrics), grads) = quick_jit(both, params[0], _j(graph))
    return {"logits": np.asarray(logits), "loss": float(loss), "acc": float(metrics["acc"]),
            "grads": jax.tree.map(np.asarray, grads)}


def test_init_shapes_distribution_and_specs(cfgs):
    ref_cfg, cfg = cfgs
    model = gnn.init_gat_params(torch.Generator().manual_seed(0), cfg, F, C)
    shapes = jax.eval_shape(lambda: ref_gnn.init_gat_params(jax.random.PRNGKey(0), ref_cfg, F, C))
    assert tree_of(model, lambda p: tuple(p.shape)) == jax.tree.map(lambda s: tuple(s.shape), shapes)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        if name.endswith(".b"):
            assert torch.all(p == 0)
        else:  # glorot uniform over [-lim, lim)
            lim = (6.0 / (p.shape[0] + p.shape[-1])) ** 0.5
            m = float(p.detach().abs().max())
            assert 0.5 * lim < m <= lim
    for rules in ((MeshRules(), ref_axes.MeshRules()),
                  (MeshRules(batch=("data",), model="model"), ref_axes.MeshRules(batch=("data",), model="model"))):
        ref_specs = ref_gnn.gat_param_specs(shapes, rules[1])
        assert gnn.gat_param_specs(model, rules[0]) == jax.tree.map(tuple, ref_specs)


def test_with_self_loops_matches_reference():
    src = np.array([3, 1, 0], np.int32)
    dst = np.array([2, 2, 1], np.int32)
    for pad_to in (None, 4, 9):
        ours = gnn.with_self_loops(torch.from_numpy(src), torch.from_numpy(dst), 4, pad_to=pad_to)
        ref = ref_gnn.with_self_loops(jnp.asarray(src), jnp.asarray(dst), 4, pad_to=pad_to)
        for o, r in zip(ours, ref):
            assert o.dtype == getattr(torch, str(np.asarray(r).dtype))
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_forward_matches_reference(cfgs, params, graph, ref_out):
    out = gnn.gat_forward(params[2], _t(graph), cfgs[1])
    assert out.shape == (N, C)
    np.testing.assert_allclose(out.detach().numpy(), ref_out["logits"], rtol=RTOL, atol=ATOL)


def test_empty_segment_node_gets_the_bias(cfgs, params, graph, ref_out):
    """Node 5 receives no real edge: segment_max gives −inf, clamped to
    −1e29, every weight is 0, and its output is layer 2's head-mean bias."""
    out = gnn.gat_forward(params[2], _t(graph), cfgs[1]).detach().numpy()
    b2 = params[1]["l2"]["b"].mean(0)
    np.testing.assert_allclose(out[5], b2, atol=1e-7)
    np.testing.assert_allclose(ref_out["logits"][5], b2, atol=1e-7)


def test_node_loss_and_gradients_match_reference(cfgs, params, graph, ref_out):
    model = params[2]
    loss, metrics = gnn.gat_node_loss(model, _t(graph), cfgs[1])
    np.testing.assert_allclose(loss.item(), ref_out["loss"], rtol=1e-4)
    assert float(metrics["acc"]) == pytest.approx(ref_out["acc"], abs=1e-6)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    for (name, _), g in zip(model.named_parameters(), grads):
        want = interop.by_name(ref_out["grads"], name)
        assert rel_l2(g.numpy(), want) <= 1e-4, name


def test_graph_loss_molecule_matches_reference(cfgs, params):
    """4 graphs × 30 nodes, 64 edges each inside its graph, plus self-loops."""
    ref_cfg, cfg = cfgs
    rng = np.random.default_rng(1)
    n_g, n_per, e_per = 4, 30, 64
    base_ids = np.repeat(np.arange(n_g) * n_per, e_per)
    src = (rng.integers(0, n_per, n_g * e_per) + base_ids).astype(np.int32)
    dst = (rng.integers(0, n_per, n_g * e_per) + base_ids).astype(np.int32)
    n = n_g * n_per
    src = np.concatenate([src, np.arange(n, dtype=np.int32)])
    dst = np.concatenate([dst, np.arange(n, dtype=np.int32)])
    batch = {"feats": rng.standard_normal((n, F), dtype=np.float32), "edge_src": src, "edge_dst": dst,
             "edge_mask": np.ones(len(src), np.float32), "labels": rng.integers(0, C, n_g).astype(np.int32),
             "graph_ids": np.repeat(np.arange(n_g), n_per).astype(np.int32)}
    (r_loss, _), r_grads = quick_jit(jax.value_and_grad(lambda p, b: ref_gnn.gat_graph_loss(p, b, ref_cfg),
                                                        has_aux=True), params[0], _j(batch))
    model = params[2]
    loss, metrics = gnn.gat_graph_loss(model, _t(batch), cfg)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-4)
    assert metrics["ce_loss"] is loss
    grads = torch.autograd.grad(loss, list(model.parameters()))
    for (name, _), g in zip(model.named_parameters(), grads):
        assert rel_l2(g.numpy(), interop.by_name(jax.tree.map(np.asarray, r_grads), name)) <= 1e-4, name


def test_entry_points_hold_tf32_off(monkeypatch, cfgs, params, graph):
    """Trap: every fp32 product runs with TF32 off, whatever the global flag."""
    seen = []
    real = gnn._aggregate
    monkeypatch.setattr(gnn, "_aggregate", lambda *a: (seen.append(torch.backends.cuda.matmul.allow_tf32),
                                                       real(*a))[1])
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        gnn.gat_node_loss(params[2], _t(graph), cfgs[1])
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen == [False, False]


# ---------------------------------------------------------------------------
# The partitioned forms, SPMD over gloo ranks
# ---------------------------------------------------------------------------

WORKER = r'''
import datetime, json, sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import interop
from repro_torch.configs.base import load_arch
from repro_torch.models import gnn
from repro_torch.sharding.axes import MeshRules


def run(root, world, rank):
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    rules = MeshRules(batch=("data",), mesh=mesh)
    cfg = load_arch("gat-cora").config
    out = {}
    with np.load(f"{root}/part-{world}.npz") as f:
        a = dict(f)
    with np.load(f"{root}/params.npz") as f:
        flat = dict(f)
    tree = {"l1": {}, "l2": {}}
    for k, v in flat.items():
        layer, name = k.split(".")
        tree[layer][name] = v
    model = interop.gnn_params_from_reference(tree, cfg, device="cpu")
    n_local = a["feats"].shape[0] // world
    e_local = a["edge_src"].shape[0] // world
    nodes, edges = slice(rank * n_local, (rank + 1) * n_local), slice(rank * e_local, (rank + 1) * e_local)
    batch = {"feats": a["feats"][nodes], "labels": a["labels"][nodes], "label_mask": a["label_mask"][nodes],
             **{k: a[k][edges] for k in ("edge_src", "edge_dst", "edge_mask")}}
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        out["logits"] = gnn.gat_forward_partitioned(model, batch, cfg, rules).numpy()
        out["logits_bf16"] = gnn.gat_forward_partitioned(model, batch, cfg, rules,
                                                         gather_dtype=torch.bfloat16).numpy()
    loss, metrics = gnn.gat_node_loss_partitioned(model, batch, cfg, rules)
    out["loss"], out["acc"] = np.float64(loss.item()), np.float64(metrics["acc"].item())
    grads = torch.autograd.grad(loss, list(model.parameters()))
    for (name, _), g in zip(model.named_parameters(), grads):
        g = g.clone()
        dist.all_reduce(g)
        out["grad." + name] = g.numpy()
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


@pytest.fixture(scope="module", autouse=True)
def spawned(params, graph, tmp_path_factory):
    """The P = 2 and 4 ranks, started with the module so they run beside
    its other tests: (root, {(P, rank): process})."""
    root = tmp_path_factory.mktemp("torch_gnn")
    np.savez(root / "params.npz", **{f"{l}.{k}": v for l, d in params[1].items() for k, v in d.items()})
    for p in (1, 2, 4):
        src, dst, msk, n_pad = partition_edges_by_dst(graph["edge_src"], graph["edge_dst"], graph["edge_mask"], N, p)
        feats = np.zeros((n_pad, F), np.float32)
        feats[:N] = graph["feats"]
        labels = np.zeros((n_pad,), np.int32)
        labels[:N] = graph["labels"]
        lm = np.zeros((n_pad,), bool)
        lm[:N] = graph["label_mask"]
        np.savez(root / f"part-{p}.npz", feats=feats, labels=labels, label_mask=lm, edge_src=src, edge_dst=dst,
                 edge_mask=msk)
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
    """{P: [rank r's outputs]}, P = 2 and 4 spawned, P = 1 in this process."""
    root, procs = spawned
    ns = {"__name__": "torch_gnn_worker"}
    exec(compile(WORKER, "torch_gnn_worker", "exec"), ns)
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


@pytest.fixture(scope="module")
def ref_bf16_gather(cfgs, params, graph):
    """The reference's partitioned forward on a one-device mesh with a bf16 gather."""
    mesh = jax.make_mesh((1,), ("data",))
    rules = ref_axes.MeshRules(batch=("data",), model=None, fsdp=(), mesh=mesh)
    b = {k: graph[k] for k in ("feats", "edge_src", "edge_dst", "edge_mask")}
    fwd = lambda p, x: ref_gnn.gat_forward_partitioned(p, x, cfgs[0], rules, gather_dtype=jnp.bfloat16)  # noqa: E731
    return np.asarray(quick_jit(fwd, params[0], _j(b)))


@pytest.mark.parametrize("p", [1, 2, 4])
def test_partitioned_forward_matches_single_device_reference(spmd, ref_out, ref_bf16_gather, p):
    logits = np.concatenate([r["logits"] for r in spmd[p]])
    np.testing.assert_allclose(logits[:N], ref_out["logits"], rtol=RTOL, atol=ATOL)
    bf16 = np.concatenate([r["logits_bf16"] for r in spmd[p]])
    np.testing.assert_allclose(bf16[:N], ref_bf16_gather, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_partitioned_loss_and_summed_gradients_match_reference(spmd, ref_out, p):
    for r in spmd[p]:  # every rank returns the global loss and accuracy
        np.testing.assert_allclose(float(r["loss"]), ref_out["loss"], rtol=1e-4)
        assert float(r["acc"]) == pytest.approx(ref_out["acc"], abs=1e-6)
    grads = spmd[p][0]
    for key in (k for k in grads if k.startswith("grad.")):
        assert rel_l2(grads[key], interop.by_name(ref_out["grads"], key[5:])) <= 1e-4, key
