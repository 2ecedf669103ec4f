"""The port's training loop held to ``repro.train.loop.fit``, and its
fault-tolerance pieces to ``repro.train.fault_tolerance``.

* ``fit`` on TinyLlama's ``smoke_lm_config`` against the reference's ``fit``:
  the reference's weights carried across, the same numpy token batches
  (step i's from seed i), AdamW at the reference launcher's settings, six
  steps.  Logged losses within rtol 1e-5 (fp32 on both sides; the forward
  agrees to ~1e-7 and six updates move the loss by ~1e-6 of itself);
  final parameters: each tensor's displacement from the start within
  relative L2 1e-4 of the reference's (AdamW's step g/(√v + 1e-8) turns
  the gradient's fp32 summation noise into step noise where |g| nears
  1e-8, a few entries in thousands; the bulk agrees to ~1e-6).
* Recovery: an injected failure, a restore from the async checkpoint and a
  resume give bit for bit the parameters and optimizer state of an
  uninterrupted run; the drift hook runs under no_grad at its cadence.
* ``HeartbeatMonitor`` flags a hang; ``StragglerDetector`` flags the same
  steps as the reference's on the same durations.
* ``python -m repro_torch.launch.train --device cpu`` exits 0.
"""
import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.models import transformer as ref_lm  # noqa: E402
from repro.train import fault_tolerance as ref_ft  # noqa: E402
from repro.train import loop as ref_loop  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train import fault_tolerance as ft  # noqa: E402
from repro_torch.train import loop, optimizer  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
STEPS = 6
BATCH, SEQ = 4, 16


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _batch_np(i: int, vocab: int):
    return np.random.default_rng(1000 + i).integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)


def _iter(to_batch, vocab):
    def data_iter(start):
        i = start
        while True:
            yield {"tokens": to_batch(_batch_np(i, vocab))}
            i += 1
    return data_iter


@pytest.fixture(scope="module")
def smoke():
    ref_cfg = ref_base.smoke_lm_config(ref_base.load_arch("tinyllama-1.1b").config)
    # numpy copies: the reference's fit donates the arrays it is given
    params = jax.tree.map(np.array, ref_lm.init_lm_params(jax.random.PRNGKey(0), ref_cfg))
    cfg = interop.lm_config_from_dict(dataclasses.asdict(ref_cfg))
    return ref_cfg, params, cfg


def _port_model(smoke):
    _, params, cfg = smoke
    return interop.lm_params_from_reference(params, cfg, device="cpu")


def _port_fit(smoke, tc, **kw):
    _, _, cfg = smoke
    model = _port_model(smoke)
    model, state, logs = loop.fit(params=model, optimizer=optimizer.adamw(lr=1e-3, weight_decay=0.01),
                                  loss_fn=lambda p, b: T.lm_loss(p, b, cfg),
                                  data_iter_fn=_iter(torch.from_numpy, cfg.vocab), cfg=tc, **kw)
    return model, state, logs


def test_fit_matches_reference(smoke):
    ref_cfg, params, cfg = smoke
    tc = dict(steps=STEPS, log_every=1, ckpt_every=0)
    ref_p, _, ref_logs = ref_loop.fit(params=jax.tree.map(jnp.asarray, params),
                                      optimizer=ref_opt.adamw(lr=1e-3, weight_decay=0.01), loss_fn=lambda p, b: ref_lm.lm_loss(p, b, ref_cfg),
                                      data_iter_fn=_iter(jnp.asarray, cfg.vocab), cfg=ref_loop.TrainConfig(**tc))
    model, state, logs = _port_fit(smoke, loop.TrainConfig(**tc))
    assert [r["step"] for r in logs] == [r["step"] for r in ref_logs] == list(range(STEPS))
    for rec, ref in zip(logs, ref_logs):
        assert set(rec) == set(ref)
        for k in ("loss", "ce_loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(rec[k], ref[k], rtol=1e-5, atol=1e-7, err_msg=f"step {rec['step']} {k}")
    assert int(state["count"]) == STEPS
    for n, p in model.named_parameters():
        start = np.asarray(interop.by_name(params, n))
        got, want = p.detach().numpy() - start, np.asarray(interop.by_name(ref_p, n)) - start
        assert rel_l2(got, want) <= 1e-4, (n, rel_l2(got, want))


def test_recovery_is_bitwise_an_uninterrupted_run(smoke, tmp_path):
    calls = []
    tc = dict(steps=STEPS, log_every=1, ckpt_every=2, drift_every=3)

    def drift_hook(p, info):
        assert not torch.is_grad_enabled()
        calls.append(info["step"])

    straight, s_state, s_logs = _port_fit(smoke, loop.TrainConfig(**tc, ckpt_dir=str(tmp_path / "a")))
    failed, f_state, f_logs = _port_fit(smoke, loop.TrainConfig(**tc, ckpt_dir=str(tmp_path / "b")),
                                        drift_hook=drift_hook, _fail_at=4)
    # failure at step 4 (before it ran): restored from step 2's checkpoint, resumed at 3
    assert [r["step"] for r in f_logs] == [0, 1, 2, 3, 3, 4, 5]
    assert calls == [0, 3, 3]
    assert ck.latest_step(tmp_path / "b") == STEPS - 1
    for (n, p), q in zip(straight.named_parameters(), failed.parameters()):
        assert torch.equal(p, q), n
    for part in ("mu", "nu", "master"):
        assert all(torch.equal(s_state[part][n], f_state[part][n]) for n in s_state[part])
    assert int(f_state["count"]) == int(s_state["count"]) == STEPS
    assert [r["loss"] for r in f_logs[-2:]] == [r["loss"] for r in s_logs[-2:]]
    # the last checkpoint holds the final state
    tree, step = ck.restore(tmp_path / "b", {"params": loop.named_params(failed), "opt": f_state})
    assert step == STEPS - 1 and all(torch.equal(tree["params"][n], p) for n, p in failed.named_parameters())


def test_run_with_recovery_gives_up_after_max():
    calls = {"n": 0}

    def run(start):
        calls["n"] += 1
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        ft.run_with_recovery(run, lambda: 0, max_failures=2)
    assert calls["n"] == 3  # initial + 2 retries


def test_heartbeat_monitor_detects_a_hang_and_not_a_live_worker():
    hb = ft.Heartbeat()
    hung = threading.Event()
    mon = ft.HeartbeatMonitor(hb, timeout=0.2, on_hang=hung.set).start()
    try:
        assert hung.wait(timeout=3.0)
    finally:
        mon.stop()
    assert not mon._thread.is_alive()
    alive, stop = threading.Event(), threading.Event()
    hb = ft.Heartbeat()
    mon = ft.HeartbeatMonitor(hb, timeout=2.0, on_hang=alive.set).start()
    try:
        for _ in range(10):  # beats every 0.05 s for 0.5 s: never 2 s without one
            hb.beat()
            stop.wait(0.05)
        assert not alive.is_set()
    finally:
        mon.stop()


def test_straggler_detector_flags_the_reference_steps():
    rng = np.random.default_rng(3)
    durations = list(0.1 + 0.001 * (np.arange(40) % 3)) + [1.5] + list(0.1 + 0.002 * rng.random(30)) + [0.5, 0.9]
    ours = ft.StragglerDetector(window=32, threshold=3.0, warmup=8)
    ref = ref_ft.StragglerDetector(window=32, threshold=3.0, warmup=8)
    assert [ours.observe(d) for d in durations] == [ref.observe(d) for d in durations]
    assert ours.events == ref.events and len(ours.events) == 3


def test_launcher_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "tinyllama-1.1b",
                          "--steps", "4", "--device", "cpu", "--ckpt-dir", str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[train] done" in out.stdout and "device=cpu" in out.stdout
    assert ck.latest_step(tmp_path) == 3
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "gat-cora", "--steps", "2",
                          "--device", "cpu"], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "arch=gat-cora family=gnn" in out.stdout and "[train] done" in out.stdout
