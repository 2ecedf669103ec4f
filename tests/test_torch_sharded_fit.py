"""``fit`` and ``AsyncCheckpointer`` on DTensor parameters, against the unsharded ``fit``.

Two gloo ranks on the CPU, spawned as subprocesses (rendezvous through a
``FileStore`` under pytest's temporary directory), make a (1, 2) mesh over
("data", "model") and place the smoke TinyLlama's parameters by
``lm_param_specs``; the weights come from one numpy seed on every side.
Each rank runs ``fit`` under the LM's rules with an ``AsyncCheckpointer``
(every 2 steps), a failure injected at step 3 (after the first checkpoint)
and a drift hook (ProHD through the front door between the full hidden
states of a probe batch and their step-0 values).  The unsharded ``fit``
runs here on the same weights and batches.

Checks: only rank 0's background writer writes; the restore after the
failure gives back DTensors with the live leaves' mesh and placements; the
losses and gradient norms agree within ``test_torch_sharded_lm.py``'s
tolerances (loss rtol 1e-6; the gradient norm, a norm of gradients held
there to relative L2 1e-5, within rtol 1e-5), and so do the final
parameters (each tensor's displacement from the start within relative L2
1e-4, ``test_torch_train_loop.py``'s bound for two fits' parameters: AdamW's
g/(√v + ε) turns fp32 summation noise into step noise where |g| nears ε);
the drift values agree within rtol 1e-4.  A failed write on rank 0 raises
on both ranks.

The narrow-saving wide contractions on DTensors (``layers.matmul_wide`` on
a column-sharded weight, ``einsum_wide`` on experts sharded over "model",
bf16) give the outputs and gradients of autograd through the upcast
bitwise, with the same placements, partial sums included; Adafactor's
rank-1 second-moment estimate stays sharded like its gradient.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import transformer as T  # noqa: E402

pytestmark = pytest.mark.distributed

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
SPAWN_TIMEOUT_S = 300

# The model, data, drift hook and fit settings, run by the ranks and here.
COMMON = r'''
import numpy as np
import torch

from repro_torch.configs.base import load_arch, smoke_lm_config
from repro_torch.hd import HDConfig
from repro_torch.models import transformer as T
from repro_torch.train import optimizer
from repro_torch.train.loop import TrainConfig, fit, make_set_distance_metric

STEPS, CKPT_EVERY, FAIL_AT, DRIFT_EVERY, MICROBATCHES = 4, 2, 3, 2, 2
BATCH, SEQ = 4, 16
cfg = smoke_lm_config(load_arch("tinyllama-1.1b").config)


def numpy_model():
    """The smoke TinyLlama with weights from one numpy seed, on the CPU."""
    model = T.TransformerLM(cfg, device="cpu")
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = 1.0 if name == "embed" else 0.1 if p.dim() == 1 else p.shape[-2] ** -0.5
            p.copy_(torch.from_numpy((rng.standard_normal(p.shape) * scale).astype(np.float32)))
    return model


def data_iter(start):
    i = start
    while True:
        yield {"tokens": torch.from_numpy(np.random.default_rng(1000 + i).integers(0, cfg.vocab, (BATCH, SEQ + 1)))}
        i += 1


PROBE = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, SEQ)))


def make_drift_hook(drifts):
    metric = make_set_distance_metric(variant="hausdorff", method="prohd", config=HDConfig(alpha=0.25))
    ref = {}

    def hook(params, info):
        hidden, _ = T.lm_forward(params, PROBE, cfg)
        hidden = hidden.full_tensor() if hasattr(hidden, "full_tensor") else hidden
        flat = hidden.reshape(-1, cfg.d_model).float()
        if "h0" not in ref:
            ref["h0"] = flat
            return
        res = metric(ref["h0"], flat)
        drifts.append([info["step"], float(res.value), float(res.lower), float(res.upper)])

    return hook


def run_fit(model, ckpt_dir=None, fail_at=None):
    logs, drifts = [], []
    tc = TrainConfig(steps=STEPS, microbatches=MICROBATCHES, log_every=1, ckpt_every=CKPT_EVERY,
                     ckpt_dir=ckpt_dir, drift_every=DRIFT_EVERY)
    fit(params=model, optimizer=optimizer.adamw(lr=1e-3, weight_decay=0.01),
        loss_fn=lambda p, b: T.lm_loss(p, b, cfg), data_iter_fn=data_iter, cfg=tc,
        drift_hook=make_drift_hook(drifts), log_fn=lambda s, r: logs.append([s, r["loss"], r["grad_norm"]]),
        _fail_at=fail_at)
    return logs, drifts
'''

WORKER = COMMON + r'''
import datetime, json, sys
from pathlib import Path

import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import layers as L
from repro_torch.sharding import axes
from repro_torch.train import checkpoint as ck

rank, world, root = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(str(root / "store"), world), rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
mesh = make_test_mesh((1, 2), ("data", "model"), device_type="cpu")
rules = T.lm_rules(cfg, mesh)
model = numpy_model()
start = {n: p.detach().clone() for n, p in model.named_parameters()}
axes.distribute_module(model, T.lm_param_specs(cfg, rules), mesh)

writes, restores = [], []
real_save, real_restore = ck.save, ck.restore


def save(root_, step, tree, **kw):
    writes.append(step)
    return real_save(root_, step, tree, **kw)


def restore(root_, tree_like, *args, **kw):
    tree, step = real_restore(root_, tree_like, *args, **kw)
    got, like = ck._flatten(tree), ck._flatten(tree_like)
    restores.append({"step": step, "leaves": len(like), "dtensor_leaves": sum(isinstance(v, DTensor) for v in like.values()),
                     "placed_alike": all(not isinstance(v, DTensor) or (isinstance(got[k], DTensor)
                                         and got[k].device_mesh == v.device_mesh
                                         and tuple(got[k].placements) == tuple(v.placements))
                                         for k, v in like.items())})
    return tree, step


ck.save, ck.restore = save, restore
with axes.use_rules(rules):
    logs, drifts = run_fit(model, ckpt_dir=str(root / "ckpt"), fail_at=FAIL_AT)
ck.save, ck.restore = real_save, real_restore
final = {n: p.detach().full_tensor() for n, p in model.named_parameters()}

# a failed write on rank 0 raises on every rank
failing = ck.AsyncCheckpointer(root / "failing")
if rank == 0:
    def broken(*a, **k):
        raise OSError("disk full")
    ck.save = broken
failing.save(0, {"w": next(iter(model.parameters())).detach()})
try:
    failing.wait()
    failed = None
except Exception as e:
    failed = repr(e)
ck.save = real_save
dist.barrier()

# the wide contractions on DTensors: placements and partial sums as autograd's through the upcast
rng = np.random.default_rng(11)


def bf16(shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def plain(eq, a, b):
    return L._contract(eq, a.to(torch.float32), b.to(torch.float32))


wide_cases = {
    "matmul_column_sharded": (None, bf16((2, 8, 16)), [Replicate(), Replicate()], bf16((16, 12)),
                              [Replicate(), Shard(1)]),
    "einsum_experts_sharded": ("gecd,edf->gecf", bf16((2, 4, 6, 16)), [Replicate(), Shard(1)], bf16((4, 16, 12)),
                               [Replicate(), Shard(0)]),
    "matmul_row_sharded": (None, bf16((2, 8, 16)), [Replicate(), Shard(2)], bf16((16, 12)),
                           [Replicate(), Shard(0)]),
}
wide = {}
for name, (eq, a, pa, b, pb) in wide_cases.items():
    runs = []
    for fn in (L._contract_wide, plain):
        da = DTensor.from_local(axes.local_block(a, mesh, pa).clone(), mesh, pa, run_check=False,
                                shape=a.shape, stride=a.stride()).requires_grad_()
        db = DTensor.from_local(axes.local_block(b, mesh, pb).clone(), mesh, pb, run_check=False,
                                shape=b.shape, stride=b.stride()).requires_grad_()
        out = fn(eq, da, db)
        g = torch.from_numpy(np.random.default_rng(12).standard_normal(out.shape).astype(np.float32))
        ga, gb = torch.autograd.grad(out, (da, db), axes.place_full(g, mesh, [Replicate()] * 2))
        runs.append([(repr(t.placements), t.full_tensor()) for t in (out, ga, gb)])
    wide[name] = [pn == pp and bool(torch.equal(tn, tp)) for (pn, tn), (pp, tp) in zip(*runs)]

# Adafactor's rank-1 second-moment estimate stays sharded like the gradient
from repro_torch.train import optimizer as O

place = [Replicate(), Shard(2)]
w = torch.from_numpy(np.random.default_rng(13).standard_normal((3, 8, 12)).astype(np.float32))
gw = torch.from_numpy(np.random.default_rng(14).standard_normal((3, 8, 12)).astype(np.float32))
ada = O.adafactor(lr=1e-2)
dw, plain_w = axes.place_full(w.clone(), mesh, place), w.clone()
(_, state), (_, plain_state) = (ada.update({"w": g}, ada.init({"w": p}), {"w": p})
                                for g, p in ((axes.place_full(gw, mesh, place), dw), (gw, plain_w)))
vr, vc = state["v"]["w"]["vr"], state["v"]["w"]["vc"]
outer = O._outer(vr, vc, dw)
adafactor = {"outer_placements": repr(outer.placements), "outer_local": list(outer.to_local().shape),
             "outer_bitwise": bool(torch.equal(outer.full_tensor(),
                                               vr.full_tensor()[..., None] * vc.full_tensor()[..., None, :])),
             "param_err": float((dw.full_tensor() - plain_w).abs().max() / plain_w.abs().max())}

rec = {"writes": writes, "restores": restores, "logs": logs, "drifts": drifts, "failed": failed, "wide": wide,
       "adafactor": adafactor,
       "ckpt_steps": sorted(p.name for p in (root / "ckpt").glob("ckpt_*"))}
(root / f"rank{rank}.json").write_text(json.dumps(rec))
if rank == 0:
    np.savez(root / "final.npz", **{n: final[n].numpy() for n in final}, **{"start/" + n: start[n].numpy() for n in start})
dist.barrier()
dist.destroy_process_group()
'''

SHARED: dict = {}
exec(COMMON, SHARED)
STEPS, CKPT_EVERY, DRIFT_EVERY = SHARED["STEPS"], SHARED["CKPT_EVERY"], SHARED["DRIFT_EVERY"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(each rank's record, rank 0's final and starting parameters, the
    unsharded fit's logs, drift values and final parameters)."""
    root = tmp_path_factory.mktemp("torch_sharded_fit")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(WORLD), str(root)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        model = SHARED["numpy_model"]()
        logs, drifts = SHARED["run_fit"](model)
        unsharded = {n: p.detach().numpy() for n, p in model.named_parameters()}
        for r, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=SPAWN_TIMEOUT_S)
            assert proc.returncode == 0, f"rank {r}:\n{stdout}\n{stderr}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return ranks, dict(np.load(root / "final.npz")), (logs, drifts, unsharded)


def test_only_rank_zero_writes(results):
    ranks, _, _ = results
    # saves at step 2, then the final step; none at step 3 before the failure
    assert ranks[0]["writes"] == [CKPT_EVERY, STEPS - 1]
    assert ranks[1]["writes"] == []
    assert ranks[0]["ckpt_steps"] == ranks[1]["ckpt_steps"] == [f"ckpt_{CKPT_EVERY}", f"ckpt_{STEPS - 1}"]


def test_restore_keeps_the_live_placements(results):
    ranks, _, _ = results
    for rec in ranks:
        assert len(rec["restores"]) == 1, rec["restores"]
        got = rec["restores"][0]
        assert got["step"] == CKPT_EVERY and got["placed_alike"]
        assert got["dtensor_leaves"] >= 3 * len(list(T.TransformerLM(SHARED["cfg"], device="cpu").parameters()))


def test_losses_and_grad_norms_match_the_unsharded_fit(results):
    ranks, _, (logs, _, _) = results
    assert [s for s, _, _ in logs] == list(range(STEPS))
    for rec in ranks:
        got = rec["logs"]
        assert [s for s, _, _ in got] == list(range(STEPS))  # the failed step logged once, after the restore
        np.testing.assert_allclose([x[1] for x in got], [x[1] for x in logs], rtol=1e-6)
        np.testing.assert_allclose([x[2] for x in got], [x[2] for x in logs], rtol=1e-5)


def test_final_parameters_match_the_unsharded_fit(results):
    _, final, (_, _, unsharded) = results
    assert set(unsharded) == {k for k in final if not k.startswith("start/")}
    for name, want in unsharded.items():
        start = final["start/" + name]
        moved, want_moved = final[name] - start, want - start
        assert np.linalg.norm(moved - want_moved) <= 1e-4 * np.linalg.norm(want_moved), name


def test_drift_hook_matches_the_unsharded_fit(results):
    ranks, _, (_, drifts, _) = results
    assert [d[0] for d in drifts] == [DRIFT_EVERY]
    for rec in ranks:
        assert [d[0] for d in rec["drifts"]] == [DRIFT_EVERY]
        np.testing.assert_allclose(np.array(rec["drifts"])[:, 1:], np.array(drifts)[:, 1:], rtol=1e-4)


def test_failed_write_raises_on_every_rank(results):
    ranks, _, _ = results
    assert ranks[0]["failed"] == "OSError('disk full')"
    assert ranks[1]["failed"].startswith("RuntimeError(") and "checkpoint write on rank 0 failed" in ranks[1]["failed"]
    assert "disk full" in ranks[1]["failed"]


@pytest.mark.parametrize("case", ["matmul_column_sharded", "einsum_experts_sharded", "matmul_row_sharded"])
def test_wide_contraction_on_dtensors_matches_autograd_through_the_upcast(results, case):
    ranks, _, _ = results
    for rec in ranks:
        assert rec["wide"][case] == [True, True, True], rec["wide"][case]


def test_adafactor_rank_one_estimate_stays_sharded_like_the_gradient(results):
    """The factored second moment's product vr ⊗ vc on a parameter sharded
    over its last dim: each rank's block only (DTensor's broadcast rule
    would gather it whole), bitwise the product of the gathered statistics,
    and the update within fp32 reordering of the unsharded one."""
    ranks, _, _ = results
    for rec in ranks:
        got = rec["adafactor"]
        assert got["outer_placements"] == "(Replicate(), Shard(dim=2))" and got["outer_local"] == [3, 8, 6]
        assert got["outer_bitwise"] and got["param_err"] <= 1e-6
