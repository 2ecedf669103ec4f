"""The port's adaptive-α ProHD held to ``repro.core.adaptive``.

The gram PCA is deterministic, so the port must walk the reference's
schedule step for step: the same ``steps``, ``alpha``, ``m`` and
``met_budget``, with the estimate's values within ``fp_value_margin``.
That holds only where no step's certified gap lies within the margin of
its target, so every case first replays the reference's schedule and
asserts that on the reference's side.  The cells run through both front
doors (the port's on ``tiled`` and ``fused_cuda``; on CPU tensors the
latter's scan is kernel 1's plain version).
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.hd as jhd  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import adaptive  # noqa: E402
from repro_torch.core.fp_margin import fp_value_margin  # noqa: E402
from repro_torch.hd import HDConfig, set_distance  # noqa: E402

jprohd = importlib.import_module("repro.core.prohd")
jadaptive = importlib.import_module("repro.core.adaptive")


def _mixture(seed, n_a, n_b, d, decay, n_modes=6, spread=4.0):
    rng = np.random.default_rng(seed)
    scales = (decay ** np.arange(d)).astype(np.float32)
    ca = rng.standard_normal((n_modes, d)).astype(np.float32) * spread * scales
    cb = rng.standard_normal((n_modes, d)).astype(np.float32) * spread * scales
    a = ca[rng.integers(0, n_modes, n_a)] + rng.standard_normal((n_a, d)).astype(np.float32) * scales
    b = cb[rng.integers(0, n_modes, n_b)] + rng.standard_normal((n_b, d)).astype(np.float32) * scales
    return a.astype(np.float32), b.astype(np.float32)


def _line(seed, n_a, n_b, d):
    """Clouds along one axis with small noise of a decaying (so distinct)
    spectrum: a nearly one-dimensional pair, whose certificate is tight."""
    rng = np.random.default_rng(seed)
    rot, _ = np.linalg.qr(rng.standard_normal((d, d)))
    noise = 0.05 * 0.7 ** np.arange(d - 1)

    def cloud(n, shift):
        coords = np.concatenate([rng.standard_normal((n, 1)) * 10 + shift,
                                 rng.standard_normal((n, d - 1)) * noise], axis=1)
        return (coords @ rot.T).astype(np.float32)

    return cloud(n_a, 0.0), cloud(n_b, 3.0)


CASES = {
    # (clouds, budget kwargs of prohd_with_budget)
    "met_first_step_relative": (lambda: _line(0, 2000, 1800, 16), dict(budget=0.1)),
    "not_met_relative": (lambda: _mixture(1, 3000, 2500, 16, 0.7), dict(budget=0.5)),
    "met_absolute": (lambda: _mixture(0, 3000, 2500, 16, 0.6), dict(budget=20.0, relative=False)),
    "not_met_absolute": (lambda: _mixture(0, 3000, 2500, 16, 0.6), dict(budget=5.0, relative=False)),
    # m reaches D at step 1 and α reaches max_alpha at step 4: the schedule
    # stops early and reports max_steps, as the reference does
    "schedule_runs_out": (lambda: _mixture(2, 1500, 1500, 4, 0.7),
                          dict(budget=0.01, alpha0=0.1, max_alpha=0.5, max_steps=8)),
}


def _scale(a, b):
    return float(max(np.linalg.norm(a, axis=1).max(), np.linalg.norm(b, axis=1).max()))


def _replay_reference_schedule(a, b, budget, relative=True, alpha0=0.005, max_alpha=0.5, max_steps=8):
    """Every step's (gap, target) on the reference, as prohd_with_budget walks."""
    d = a.shape[1]
    m = max(1, int(d**0.5))
    alpha = alpha0
    steps = []
    for step in range(1, max_steps + 1):
        est = jprohd.prohd(jnp.asarray(a), jnp.asarray(b),
                           jprohd.ProHDConfig(alpha=alpha, num_pca_directions=min(m, d)))
        lower = float(est.hd_proj)
        gap = (lower + float(est.bound)) - lower
        target = budget * max(lower, 1e-12) if relative else budget
        steps.append((lower, float(est.bound), gap, target))
        if gap <= target:
            break
        if step % 2 == 1 and m < d:
            m = min(d, m + max(1, int(d**0.5)))
        else:
            alpha = min(max_alpha, alpha * 2)
            if alpha >= max_alpha and m >= d:
                break
    return steps


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("backend", ["tiled", "fused_cuda"])
def test_schedule_matches_reference_step_for_step(case, backend):
    make, kw = CASES[case]
    a, b = make()
    d = a.shape[1]
    scale = _scale(a, b)
    rel = kw.get("relative", True)
    for lower, bound, gap, target in _replay_reference_schedule(a, b, **kw):
        # the port's gap and target may each move by their own margin
        slack = fp_value_margin(d, scale, bound) + (kw["budget"] if rel else 0.0) * fp_value_margin(d, scale, lower)
        assert abs(gap - target) > slack, (case, gap, target, slack)
    ref = jadaptive.prohd_with_budget(jnp.asarray(a), jnp.asarray(b), **kw)
    port = adaptive.prohd_with_budget(interop.cloud(a, "cpu"), interop.cloud(b, "cpu"), backend=backend, **kw)
    assert (port.steps, port.alpha, port.m, port.met_budget) == (ref.steps, ref.alpha, ref.m, ref.met_budget)
    for field in ("hd", "hd_proj", "bound"):
        r, p = float(getattr(ref.estimate, field)), float(getattr(port.estimate, field))
        assert abs(p - r) <= fp_value_margin(d, scale, r), (field, p, r)
    assert abs(port.certified_gap - ref.certified_gap) <= fp_value_margin(d, scale, ref.certified_gap)
    assert int(port.estimate.n_sel_a) == int(ref.estimate.n_sel_a)


def test_expected_outcomes_of_the_cases():
    # the cases cover both outcomes, and an early stop
    outcomes = {}
    for case, (make, kw) in CASES.items():
        a, b = make()
        outcomes[case] = adaptive.prohd_with_budget(interop.cloud(a, "cpu"), interop.cloud(b, "cpu"), **kw)
    assert outcomes["met_first_step_relative"].met_budget and outcomes["met_first_step_relative"].steps == 1
    assert outcomes["met_absolute"].met_budget
    for case in ("not_met_relative", "not_met_absolute", "schedule_runs_out"):
        assert not outcomes[case].met_budget and outcomes[case].steps == 8
    assert outcomes["schedule_runs_out"].alpha == 0.5 and outcomes["schedule_runs_out"].m == 4


@pytest.mark.parametrize("case", ["met_first_step_relative", "not_met_relative"])
@pytest.mark.parametrize("backend", ["tiled", "fused_cuda"])
def test_front_door_adaptive_cell_matches_reference_front_door(case, backend):
    make, kw = CASES[case]
    a, b = make()
    d = a.shape[1]
    ref_cfg = jhd.HDConfig(budget=kw["budget"])
    ref = jhd.set_distance(jnp.asarray(a), jnp.asarray(b), method="adaptive", backend="tiled", config=ref_cfg)
    cfg = interop.hd_config_from_dict(dataclasses.asdict(ref_cfg))
    res = set_distance(a, b, method="adaptive", backend=backend, config=cfg, device="cpu")
    assert res.meta.backend == backend
    for field in ("value", "lower", "upper"):
        r, p = float(getattr(ref, field)), float(getattr(res, field))
        assert abs(p - r) <= fp_value_margin(d, _scale(a, b), r), (field, p, r)
    got, want = res.stats["adaptive"], ref.stats["adaptive"]
    assert (got.steps, got.alpha, got.m, got.met_budget) == (want.steps, want.alpha, want.m, want.met_budget)
    assert res.stats["estimate"] is got.estimate
    assert int(res.stats["n_sel_a"]) == int(ref.stats["n_sel_a"])


def test_each_step_runs_the_dispatching_backend(monkeypatch):
    from repro_torch.hd import engine

    seen = []
    real = engine.set_distance

    def spy(*args, **kwargs):
        seen.append((kwargs.get("method"), kwargs.get("backend")))
        return real(*args, **kwargs)

    monkeypatch.setattr(engine, "set_distance", spy)
    import repro_torch.hd as thd

    monkeypatch.setattr(thd, "set_distance", spy)
    a, b = _mixture(1, 600, 500, 9, 0.7)
    res = set_distance(a, b, method="adaptive", backend="fused_cuda", device="cpu",
                       config=HDConfig(budget=1e-6, adaptive_max_steps=3))
    assert seen == [("prohd", "fused_cuda")] * 3
    assert not res.stats["adaptive"].met_budget
    with pytest.raises(ValueError, match="masks"):
        set_distance(a, b, method="adaptive", device="cpu", masks=(np.ones(600, bool), None))
