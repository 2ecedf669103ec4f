"""The port's LM on DTensor parameters held to the reference's unsharded functions.

Four gloo ranks on the CPU, spawned as subprocesses (rendezvous through a
``FileStore`` under pytest's temporary directory), make a (2, 2) or a
(1, 4) mesh over ("data", "model") and place the smoke-size parameters by
``lm_param_specs`` (``axes.distribute_module``); the reference's values
are carried across by ``interop.lm_params_from_reference``.  Under the
rules, each rank runs ``prefill_step``, one ``serve_step`` on a cache
placed by ``kv_cache_specs``, and ``lm_loss`` with its gradients, and
rank 0 writes the gathered results.  The reference's unsharded functions
run here on the same weights and tokens.  Cases: TinyLlama (grouped-query
attention with its kv heads sharded), TinyLlama on (1, 4) (4 query heads
over 4 ranks, its 2 kv heads whole on every rank: each rank slices out
the kv head of its query head, ⌊r / 2⌋, and the kv gradient is a partial
sum over "model", the layout of TinyLlama's 32 / 4 heads on the (16, 16)
mesh), TinyLlama under ``dp_zero1`` (every axis a batch axis, parameters
replicated) and OLMoE (64 → 4 experts at smoke size, sharded over
"model"; its routing groups span two ranks).

Tolerances, fp32: the sharded functions differ from the unsharded port only
in the order of the sums split across ranks (a contraction of n terms
moves by at most n·u·Σ|terms|, u = 2^-24, n ≤ 96 here), well inside the
port's own tolerances against the reference: logits ``atol 2e-5, rtol
1e-4`` (``test_torch_lm.py``), the loss within rtol 1e-6 and each gradient
within relative L2 1e-5 (``test_torch_train_step.py``).

The edge-parallel GAT (``gnn.gat_node_loss(..., group=)``, the
reference's baseline GNN layout: node tables whole, edges split over the
ranks) gives the unsharded loss, and its gradients summed over the ranks
the unsharded gradients, within the same fp32 tolerances.

The recsys losses run as the dry run runs them (``launch.specs``: each
rank its rows, the tables row-sharded over "model", in a ``local_map``
region) and give the unsharded loss and gradients.

The checkpoint case is the port's copy of the reference's elastic reshard
(``tests/test_train.py``): a tree saved from a (4,) data mesh restores onto
the (2, 2) mesh with other specs, each rank's block bitwise the saved
array's slice.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.models import transformer as ref_lm  # noqa: E402

pytestmark = pytest.mark.distributed

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
SPAWN_TIMEOUT_S = 300
CASES = {  # name: (arch, mesh role of "model", batch, sequence, mesh ("data", "model"))
    "tinyllama": ("tinyllama-1.1b", "tensor", 4, 32, (2, 2)),
    "tinyllama_kv_whole": ("tinyllama-1.1b", "tensor", 4, 32, (1, 4)),
    "tinyllama_dp_zero1": ("tinyllama-1.1b", "batch", 4, 32, (2, 2)),
    "olmoe": ("olmoe-1b-7b", "tensor", 4, 32, (2, 2)),
}
FP32_GRAD_RTOL = 1e-5
RECSYS = ("fm", "dien", "bert4rec", "bst")

WORKER = r'''
import dataclasses, datetime, json, sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch.configs.base import load_arch, smoke_lm_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer as T
from repro_torch.sharding import axes
from repro_torch.train import checkpoint as ck

rank, world, root = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
cases = json.loads(sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(str(root / "store"), world), rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
meshes = {(2, 2): mesh, (1, 4): make_test_mesh((1, 4), ("data", "model"), device_type="cpu")}


def nested(npz):
    out = {"layers": {}}
    for k in npz.files:
        top, _, rest = k.partition("/")
        (out["layers"].__setitem__(rest, npz[k]) if top == "layers" else out.__setitem__(top, npz[k]))
    return out


results = {}
for name, (arch, role, b, s, shape) in cases.items():
    cfg = dataclasses.replace(smoke_lm_config(load_arch(arch).config), model_axis_role=role)
    data = np.load(root / f"{name}.npz")
    model = interop.lm_params_from_reference(nested(np.load(root / f"{name}_params.npz")), cfg, device="cpu")
    lm_mesh = meshes[tuple(shape)]
    rules = T.lm_rules(cfg, lm_mesh)
    axes.distribute_module(model, T.lm_param_specs(cfg, rules), lm_mesh)
    tokens = torch.from_numpy(data["tokens"])
    with axes.use_rules(rules):
        logits = T.prefill_step(model, tokens[:, :s], cfg).full_tensor()
        cache = axes.distribute_tree(T.init_kv_cache(cfg, b, 2 * s, device="cpu"), T.kv_cache_specs(cfg, rules),
                                     lm_mesh)
        step_logits, next_tok, cache = T.serve_step(model, cache, tokens[:, 0], cfg)
        step_logits, next_tok = step_logits.full_tensor(), next_tok.full_tensor()
        loss, _ = T.lm_loss(model, {"tokens": tokens}, cfg)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
        grads = {n: g.full_tensor().numpy() for n, g in zip(names, grads)}
        loss = loss.full_tensor()
    if rank == 0:
        np.savez(root / f"{name}_port.npz", logits=logits.numpy(), step_logits=step_logits.numpy(),
                 next_tok=next_tok.numpy(), loss=loss.detach().numpy(), shard_kv=rules.shard_kv,
                 **{"grad/" + n: g for n, g in grads.items()})

# the reference's edge-parallel GAT: each rank a quarter of the edges, node tables whole
from repro_torch.data import synth
from repro_torch.models import gnn as G

gcfg = load_arch("gat-cora").config
gen = torch.Generator().manual_seed(5)
gat = G.init_gat_params(gen, gcfg, 16, gcfg.n_classes)
graph = synth.gnn_batch(gen, gcfg, n_nodes=64, n_edges=200, d_feat=16, n_classes=gcfg.n_classes)
pad = (-graph["edge_src"].shape[0]) % world
graph["edge_mask"] = torch.cat([graph.get("edge_mask", torch.ones(graph["edge_src"].shape[0])), torch.zeros(pad)])
for key in ("edge_src", "edge_dst"):
    graph[key] = torch.cat([graph[key], graph[key].new_zeros(pad)])
whole_loss, _ = G.gat_node_loss(gat, graph, gcfg)
whole = torch.autograd.grad(whole_loss, list(gat.parameters()))
n = graph["edge_src"].shape[0] // world
mine = dict(graph, **{k: graph[k][rank * n:(rank + 1) * n] for k in ("edge_src", "edge_dst", "edge_mask")})
loss, _ = G.gat_node_loss(gat, mine, gcfg, group=dist.group.WORLD)
grads = [g.clone() for g in torch.autograd.grad(loss / world, list(gat.parameters()))]
for g in grads:
    dist.all_reduce(g)
if rank == 0:
    np.savez(root / "gat.npz", loss=loss.detach().numpy(), whole_loss=whole_loss.detach().numpy(),
             **{f"grad{i}": g.numpy() for i, g in enumerate(grads)},
             **{f"whole{i}": g.numpy() for i, g in enumerate(whole)})

# the recsys losses as the dry run runs them: each rank its rows, tables row-sharded over "model"
import functools

from torch.distributed.tensor import Partial, Replicate

from repro_torch.configs.base import smoke_recsys_config
from repro_torch.launch import specs as S
from repro_torch.models import recsys as R

rec_rules = S._family_rules(mesh)
row_mean = [Partial() if i in S._batch_dims(mesh, rec_rules) else Replicate() for i in range(mesh.ndim)]
for arch in ("fm", "dien", "bert4rec", "bst"):
    rcfg = smoke_recsys_config(load_arch(arch).config)
    init, spec_fn, loss_fn, *_ = R.get_model(rcfg)
    gen = torch.Generator().manual_seed(11)
    rp = init(gen, rcfg)
    batch = synth.recsys_batch(gen, rcfg, 16, train=True)
    whole_loss, _ = loss_fn(rp, batch, rcfg)
    whole = torch.autograd.grad(whole_loss, list(rp.parameters()))
    axes.distribute_module(rp, spec_fn(rcfg, rec_rules), mesh)
    body = functools.partial(S._recsys_loss, cfg=rcfg, loss=loss_fn)
    sharded_loss = S._spmd_loss(body, mesh, grad_dims=S._batch_dims(mesh, rec_rules), out_place=row_mean,
                                in_batch=None, scale=1.0 / 2)
    with axes.use_rules(rec_rules):
        loss, _ = sharded_loss(rp, axes.distribute_tree(batch, S._recsys_batch_specs(batch, rec_rules), mesh))
        grads = [g.full_tensor() for g in torch.autograd.grad(loss, list(rp.parameters()))]
    loss = loss.full_tensor()
    if rank == 0:
        np.savez(root / f"rec_{arch}.npz", loss=loss.detach().numpy(), whole_loss=whole_loss.detach().numpy(),
                 **{f"grad{i}": g.numpy() for i, g in enumerate(grads)},
                 **{f"whole{i}": g.numpy() for i, g in enumerate(whole)})

# elastic reshard: saved from a (4,) data mesh, restored onto (2, 2) with other specs
tree = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.ones(8)}
mesh4 = make_test_mesh((4,), ("data",), device_type="cpu")
ck.save(root / "ckpt", 11, axes.distribute_tree(tree, {"w": ("data", None), "b": ()}, mesh4))
got, step = ck.restore(root / "ckpt", tree, mesh=mesh, specs={"w": ("model", "data"), "b": ("data",)})
blocks = {k: bool(torch.equal(got[k].to_local(), axes.local_block(tree[k], mesh, got[k].placements)))
          for k in tree}
placements = {k: [repr(p) for p in got[k].placements] for k in tree}
(root / f"ckpt-rank{rank}.json").write_text(json.dumps({"step": step, "blocks": blocks, "placements": placements,
                                                         "local_shape": list(got["w"].to_local().shape)}))
dist.barrier()
dist.destroy_process_group()
'''


def _ref_params(arch):
    cfg = ref_base.smoke_lm_config(ref_base.load_arch(arch).config)
    params = ref_lm.init_lm_params(jax.random.PRNGKey(3), cfg)
    return cfg, params


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{case: (the port's gathered outputs, the reference's)} and the ranks'
    checkpoint records."""
    root = tmp_path_factory.mktemp("torch_sharded_lm")
    refs = {}
    for name, (arch, _, b, s, _) in CASES.items():
        cfg, params = _ref_params(arch)
        tokens = np.random.default_rng(7).integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
        np.savez(root / f"{name}.npz", tokens=tokens)
        flat = {f"layers/{k}": np.asarray(v) for k, v in params["layers"].items()}
        flat.update({k: np.asarray(v) for k, v in params.items() if k != "layers"})
        np.savez(root / f"{name}_params.npz", **flat)
        refs[name] = (cfg, params, tokens)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    cases = json.dumps(CASES)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(WORLD), str(root), cases], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        want = {}
        for name, (cfg, params, tokens) in refs.items():
            s = CASES[name][3]
            logits = ref_lm.prefill_step(params, jnp.asarray(tokens[:, :s]), cfg)
            cache = ref_lm.init_kv_cache(cfg, tokens.shape[0], 2 * s)
            step_logits, next_tok, _ = ref_lm.serve_step(params, cache, jnp.asarray(tokens[:, 0]), cfg)
            (loss, _), grads = jax.value_and_grad(ref_lm.lm_loss, has_aux=True)(
                params, {"tokens": jnp.asarray(tokens)}, cfg)
            flat = {f"layers.{k}": np.asarray(v) for k, v in grads["layers"].items()}
            flat.update({k: np.asarray(v) for k, v in grads.items() if k != "layers"})
            want[name] = {"logits": np.asarray(logits), "step_logits": np.asarray(step_logits),
                          "next_tok": np.asarray(next_tok), "loss": float(loss), "grads": flat}
        for r, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=SPAWN_TIMEOUT_S)
            assert proc.returncode == 0, f"rank {r}:\n{stdout}\n{stderr}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    got = {name: dict(np.load(root / f"{name}_port.npz")) for name in CASES}
    got["gat"] = dict(np.load(root / "gat.npz"))
    got.update({f"rec_{a}": dict(np.load(root / f"rec_{a}.npz")) for a in RECSYS})
    ckpt = [json.loads((root / f"ckpt-rank{r}.json").read_text()) for r in range(WORLD)]
    return got, want, ckpt


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_the_reference(results, case):
    got, want, _ = results
    g, w = got[case], want[case]
    np.testing.assert_allclose(g["logits"], w["logits"], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(g["step_logits"], w["step_logits"], atol=2e-5, rtol=1e-4)
    np.testing.assert_array_equal(g["next_tok"], w["next_tok"])


def test_whole_kv_heads_case_keeps_the_kv_heads_whole(results):
    """The (1, 4) case shards the query heads over "model" and not the kv
    heads, so its attention takes the branch that slices each rank's kv
    head; the (2, 2) TinyLlama case shards both."""
    got = results[0]
    assert not bool(got["tinyllama_kv_whole"]["shard_kv"])
    assert bool(got["tinyllama"]["shard_kv"])


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_the_reference(results, case):
    got, want, _ = results
    g, w = got[case], want[case]
    np.testing.assert_allclose(float(g["loss"]), w["loss"], rtol=1e-6)
    assert set(k.removeprefix("grad/") for k in g if k.startswith("grad/")) == set(w["grads"])
    for name, ref in w["grads"].items():
        mine = g["grad/" + name]
        assert mine.shape == ref.shape, name
        assert np.linalg.norm(mine - ref) <= FP32_GRAD_RTOL * np.linalg.norm(ref), name


def test_edge_parallel_gat_matches_the_unsharded_loss_and_gradients(results):
    """Each rank's loss is the whole loss; a quarter of each rank's
    gradient of it, summed over the ranks, is the whole gradient (the
    edge sums' all-reduce takes its exact adjoint)."""
    g = results[0]["gat"]
    np.testing.assert_allclose(float(g["loss"]), float(g["whole_loss"]), rtol=1e-6)
    for i in range(sum(k.startswith("grad") for k in g)):
        ref = g[f"whole{i}"]
        assert np.linalg.norm(g[f"grad{i}"] - ref) <= FP32_GRAD_RTOL * np.linalg.norm(ref), i


@pytest.mark.parametrize("arch", RECSYS)
def test_sharded_recsys_loss_matches_the_unsharded(results, arch):
    """The dry run's SPMD body of each recsys loss (``launch.specs``: rows
    over "data", tables over "model") on the (2, 2) mesh: the unsharded
    loss, and its gradients, each within relative L2 1e-5 of the unsharded
    gradient, relative to 1% of the whole gradient's norm where a tensor's
    own is smaller (BERT4Rec's ``out_b`` gradient is zero in exact
    arithmetic, as in ``test_torch_recsys.py``)."""
    g = results[0][f"rec_{arch}"]
    np.testing.assert_allclose(float(g["loss"]), float(g["whole_loss"]), rtol=1e-6)
    n = sum(k.startswith("grad") for k in g)
    total = np.sqrt(sum(np.linalg.norm(g[f"whole{i}"]) ** 2 for i in range(n)))
    for i in range(n):
        ref = g[f"whole{i}"]
        assert np.linalg.norm(g[f"grad{i}"] - ref) <= FP32_GRAD_RTOL * max(np.linalg.norm(ref), 0.01 * total), i


def test_checkpoint_reshards_bitwise_onto_another_mesh(results):
    _, _, ckpt = results
    for rec in ckpt:
        assert rec["step"] == 11
        assert rec["blocks"] == {"w": True, "b": True}
        assert rec["placements"]["w"] == ["Shard(dim=1)", "Shard(dim=0)"]
        assert rec["local_shape"] == [4, 4]
