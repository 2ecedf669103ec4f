"""The port's gradient compression held to ``repro.train.compression``, and
its explicit data-parallel step to the reference's ``make_explicit_dp_step``.

* int8: words and scales bit for bit on the same fp32 values (both round
  half to even); error feedback round for round; the feedback's sum stays
  within 1% of the raw sum over 50 rounds, as the reference's own test.
* PowerSGD from the reference's factors Q (``jax.random``'s, carried across
  by ``interop.powersgd_state_from_reference``): three rounds, the
  approximation and the new factors within rtol 1e-4 (both run LAPACK's
  Householder QR in fp32; the products' summation order differs).
* The explicit-DP step, P = 2: two gloo ranks spawned as subprocesses
  (rendezvous through a ``FileStore`` under pytest's tmp dir, as
  ``test_torch_distributed.py``), each with its half of every batch,
  against the reference's ``make_explicit_dp_step`` on a 2-device host mesh
  in a subprocess (``--xla_force_host_platform_device_count=2``), for
  compression None, "int8" and "powersgd", five SGD steps on the same numpy
  data and PowerSGD factors.  Losses and parameters within rtol 1e-5 (fp32;
  the two sides differ in summation order only, and on these seeded inputs
  no int8 word lies on a rounding boundary, so the int8 words agree).
"""
import json
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

from repro.train import compression as ref_comp  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402

pytestmark = pytest.mark.distributed

REPO = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT_S = 300
P = 2
N_STEPS = 5
LR = 0.2
RANK = 4
COMPRESSIONS = (None, "int8", "powersgd")


def _t(x):
    return torch.from_numpy(np.array(x))


def test_int8_words_and_scales_bit_for_bit():
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((64, 32)).astype(np.float32),
              (rng.standard_normal(1000) * 1e-6).astype(np.float32),
              np.zeros((3, 3), np.float32),                                   # the 1e-12 scale floor
              np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5], np.float32)]  # ties: half to even
    for x in arrays:
        q_ref, s_ref = ref_comp.quantize_int8(jnp.asarray(x))
        q, s = comp.quantize_int8(torch.from_numpy(x))
        assert q.dtype == torch.int8 and torch.equal(q, _t(q_ref))
        assert s.dtype == torch.float32 and torch.equal(s, _t(s_ref))
        assert torch.equal(comp.dequantize_int8(q, s), _t(ref_comp.dequantize_int8(q_ref, s_ref)))


def test_int8_error_feedback_round_for_round():
    rng = np.random.default_rng(1)
    shapes = {"w": (64, 32), "b": (32,)}
    err = comp.init_error_tree({n: torch.zeros(s) for n, s in shapes.items()})
    ref_err = ref_comp.init_error_tree({n: jnp.zeros(s) for n, s in shapes.items()})
    acc_raw, acc_cmp = np.zeros((64, 32)), np.zeros((64, 32))
    for _ in range(50):
        g = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
        dq, err = comp.int8_compress_tree({n: torch.from_numpy(v) for n, v in g.items()}, err)
        ref_dq, ref_err = ref_comp.int8_compress_tree({n: jnp.asarray(v) for n, v in g.items()}, ref_err)
        for n in shapes:
            assert torch.equal(dq[n], _t(ref_dq[n])) and torch.equal(err[n], _t(ref_err[n])), n
        acc_raw += g["w"]
        acc_cmp += dq["w"].numpy()
    assert np.linalg.norm(acc_raw - acc_cmp) / np.linalg.norm(acc_raw) < 0.01


def test_powersgd_from_the_reference_factors():
    rng = np.random.default_rng(2)
    grads_np = {"w": rng.standard_normal((64, 48)).astype(np.float32), "b": np.arange(5, dtype=np.float32),
                "k": rng.standard_normal((4, 6, 5)).astype(np.float32)}
    ref_state = ref_comp.init_powersgd({k: jnp.asarray(x) for k, x in grads_np.items()}, 4, jax.random.PRNGKey(3))
    params = {k: torch.zeros(x.shape) for k, x in grads_np.items()}
    state = interop.powersgd_state_from_reference(jax.tree.map(np.asarray, tuple(ref_state)), params)
    assert tuple(state.q["k"].shape) == (30, 4) and tuple(state.q["b"].shape) == (0,)
    grads = {k: torch.from_numpy(x) for k, x in grads_np.items()}
    for _ in range(3):
        approx, state = comp.powersgd_round(grads, state, None)
        ref_approx, ref_state = ref_comp.powersgd_round({k: jnp.asarray(x) for k, x in grads_np.items()},
                                                         ref_state, None)
        for k, g in grads_np.items():
            scale = np.abs(g).max()
            for got, want in ((approx[k], ref_approx[k]), (state.q[k], ref_state.q[k]),
                              (state.error[k], ref_state.error[k])):
                want = np.asarray(want)
                assert tuple(got.shape) == want.shape, k
                if want.size:
                    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                               atol=1e-4 * max(scale, np.abs(want).max()), err_msg=k)


def test_powersgd_captures_a_low_rank_gradient():
    rng = np.random.default_rng(6)
    g = {"w": torch.from_numpy((rng.standard_normal((64, 3)) @ rng.standard_normal((3, 48))).astype(np.float32))}
    state = comp.init_powersgd(g, 4, torch.Generator().manual_seed(0))
    for _ in range(3):  # a few power iterations via the warm-started Q
        approx, state = comp.powersgd_round(g, state, None)
    assert float(torch.linalg.vector_norm(approx["w"] - g["w"]) / torch.linalg.vector_norm(g["w"])) < 1e-2
    params = {"w": torch.zeros(1024, 1024), "b": torch.zeros(8)}
    assert comp.compression_ratio(params, 4) == ref_comp.compression_ratio(
        {k: jnp.zeros(tuple(v.shape)) for k, v in params.items()}, 4) < 0.01


# ---------------------------------------------------------------------------
# The explicit data-parallel step, P = 2
# ---------------------------------------------------------------------------

# The reference's side: shard_map over a 2-device host mesh.
REF_DP = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.train import optimizer as opt_mod, compression as comp
from repro.train.loop import make_explicit_dp_step
assert jax.device_count() == 2
root = sys.argv[1]
inputs = dict(np.load(f"{root}/inputs.npz"))
mesh = jax.make_mesh((2,), ("data",))
def loss_fn(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    l = jnp.mean((pred - batch["y"]) ** 2)
    return l, {"mse": l}
opt = opt_mod.sgd(lr=float(sys.argv[2]))
out = {}
for compression in json.loads(sys.argv[3]):
    step, init_comp = make_explicit_dp_step(loss_fn, opt, mesh, batch_axes=("data",),
                                            compression=compression, powersgd_rank=int(sys.argv[4]))
    p = {"w": jnp.asarray(inputs["w0"]), "b": jnp.asarray(inputs["b0"])}
    st = opt.init(p)
    if compression == "powersgd":
        cs = comp.PowerSGDState(q={"w": jnp.asarray(inputs["q_w"]), "b": jnp.zeros((0,))},
                                error=comp.init_error_tree(p))
    else:
        cs = init_comp(p)
    losses = []
    for i in range(inputs["xs"].shape[0]):
        batch = {"x": jnp.asarray(inputs["xs"][i]), "y": jnp.asarray(inputs["ys"][i])}
        p, st, cs, m = step(p, st, cs, batch)
        losses.append([float(m["loss"]), float(m["mse"])])
    out[str(compression)] = {"losses": losses, "w": np.asarray(p["w"]).tolist(), "b": np.asarray(p["b"]).tolist()}
with open(f"{root}/ref.json", "w") as fh:
    json.dump(out, fh)
'''

# The port's side: one gloo rank, its half of every batch.
PORT_DP = r'''
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import interop
from repro_torch.train import optimizer
from repro_torch.train.loop import make_explicit_dp_step

rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
lr, compressions, rank_r = float(sys.argv[4]), json.loads(sys.argv[5]), int(sys.argv[6])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(f"{root}/store", world), rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
try:
    inputs = dict(np.load(f"{root}/inputs.npz"))
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        l = torch.mean((pred - batch["y"]) ** 2)
        return l, {"mse": l}

    opt = optimizer.sgd(lr=lr)
    out = {}
    for compression in compressions:
        step, init_comp = make_explicit_dp_step(loss_fn, opt, mesh, batch_axes=("data",),
                                                compression=compression, powersgd_rank=rank_r)
        p = {"w": torch.tensor(inputs["w0"], requires_grad=True), "b": torch.tensor(inputs["b0"], requires_grad=True)}
        st = opt.init(p)
        if compression == "powersgd":
            cs = interop.powersgd_state_from_reference(
                ({"w": inputs["q_w"], "b": np.zeros((0,), np.float32)},
                 {"w": np.zeros_like(inputs["w0"]), "b": np.zeros_like(inputs["b0"])}), p)
        else:
            cs = init_comp(p)
        n = inputs["xs"].shape[1] // world
        losses = []
        for i in range(inputs["xs"].shape[0]):
            rows = slice(rank * n, (rank + 1) * n)
            batch = {"x": torch.from_numpy(inputs["xs"][i][rows]), "y": torch.from_numpy(inputs["ys"][i][rows])}
            st, cs, m = step(p, st, cs, batch)
            losses.append([float(m["loss"]), float(m["mse"])])
        out[str(compression)] = {"losses": losses, "w": p["w"].detach().numpy().tolist(),
                                 "b": p["b"].detach().numpy().tolist()}
    with open(f"{root}/rank-{rank}.json", "w") as fh:
        json.dump(out, fh)
finally:
    dist.destroy_process_group()
'''


def _inputs(root: Path) -> dict:
    rng = np.random.default_rng(5)
    w_true = rng.standard_normal((8, 8)).astype(np.float32)
    xs = rng.standard_normal((N_STEPS, 64, 8)).astype(np.float32)
    inputs = {"xs": xs, "ys": xs @ w_true, "w0": np.zeros((8, 8), np.float32),
              "b0": np.zeros((8,), np.float32), "q_w": rng.standard_normal((8, RANK)).astype(np.float32)}
    np.savez(root / "inputs.npz", **inputs)
    return inputs


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """(reference results, [rank 0's, rank 1's]), all three processes at once."""
    root = tmp_path_factory.mktemp("torch_dp")
    _inputs(root)
    names = json.dumps(list(COMPRESSIONS))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=2", JAX_PLATFORMS="cpu")
    procs = {"ref": subprocess.Popen([sys.executable, "-c", REF_DP, str(root), str(LR), names, str(RANK)],
                                     env=ref_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    for r in range(P):
        procs[r] = subprocess.Popen([sys.executable, "-c", PORT_DP, str(r), str(P), str(root), str(LR), names,
                                     str(RANK)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=SPAWN_TIMEOUT_S)
            assert proc.returncode == 0, f"{name}:\n{stdout}\n{stderr}"
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ref = json.loads((root / "ref.json").read_text())
    return ref, [json.loads((root / f"rank-{r}.json").read_text()) for r in range(P)]


@pytest.mark.parametrize("compression", COMPRESSIONS, ids=[str(c) for c in COMPRESSIONS])
def test_explicit_dp_step_matches_reference(dp_runs, compression):
    ref, ranks = dp_runs
    key = str(compression)
    assert ranks[0][key] == ranks[1][key]  # replicated parameters stay replicated
    got, want = ranks[0][key], ref[key]
    for k in ("w", "b"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(np.asarray(got["losses"]), np.asarray(want["losses"]), rtol=1e-5)
    assert got["losses"][-1][0] < got["losses"][0][0]  # it trains
