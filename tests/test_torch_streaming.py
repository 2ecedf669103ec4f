"""The port's drift monitor held to ``repro.core.streaming``.

While the reservoir warms, both packages fill it in arrival order, so the
buffers must be bitwise equal; the cold phase draws from different
generators, so it is checked against a sequential Algorithm R on the
port's own draws (the last arrival that takes a slot wins) and for
uniform inclusion.  On one state (the reference's direction bank carried
across), ``check_drift`` must give the reference's ``alert`` with ``hd``,
``lower`` and ``upper`` within ``fp_value_margin``.  The reference's
``tests/test_streaming.py`` cases are ported at the end.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import streaming as jstreaming  # noqa: E402
from repro.core.prohd import ProHDConfig as RefProHDConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.exact import hausdorff_dense  # noqa: E402
from repro_torch.core.fp_margin import fp_value_margin  # noqa: E402
from repro_torch.core.prohd import ProHDConfig  # noqa: E402
from repro_torch.index.store import summarize_set  # noqa: E402
from repro_torch.core.streaming import (  # noqa: E402
    DriftMonitorConfig,
    check_drift,
    init_drift_monitor,
    observe,
)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _normal(seed, shape, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) + shift).astype(np.float32)


def _np(x):
    return np.array(x)  # a writable copy of a reference array


# warm batches only: a batch that crosses into the cold phase is held to
# the sequential Algorithm R below
@pytest.mark.parametrize("window,batches", [(8, (8,)), (32, (12, 12, 8)), (16, (5, 9)), (64, (1, 7, 56))])
def test_warm_fill_is_bitwise_the_reference(window, batches):
    dim = 4
    ref = _normal(0, (50, dim))
    jcfg = jstreaming.DriftMonitorConfig(window=window, dim=dim)
    jstate = jstreaming.init_drift_monitor(jcfg, jnp.asarray(ref), jax.random.PRNGKey(0))
    state = init_drift_monitor(interop.drift_config_from_dict(dataclasses.asdict(jcfg)), ref, _gen(),
                               device="cpu")
    seen = 0
    for i, n in enumerate(batches):
        batch = _normal(10 + i, (n, dim))
        jstate = jstreaming.observe(jstate, jnp.asarray(batch))
        state = observe(state, batch)
        seen += n
        assert state.count == int(jstate.count) == seen
        np.testing.assert_array_equal(state.buffer.numpy()[:seen], np.asarray(jstate.buffer)[:seen])


def _sequential_algorithm_r(state, batch):
    """Algorithm R one arrival at a time on the generator draws ``observe``
    makes (slots, then uniforms, for the cold arrivals only)."""
    buf = state.buffer.clone()
    window = buf.shape[0]
    g = torch.Generator()
    g.set_state(state.generator.get_state())
    n_warm = max(0, min(len(batch), window - state.count))
    buf[state.count:state.count + n_warm] = batch[:n_warm]
    n_cold = len(batch) - n_warm
    pos = torch.randint(0, window, (n_cold,), generator=g)
    u = torch.rand(n_cold, generator=g, dtype=torch.float64)
    for i in range(n_cold):
        if u[i] < window / (state.count + n_warm + i + 1.0):
            buf[pos[i]] = batch[n_warm + i]
    return buf


@pytest.mark.parametrize("window,batch", [(8, 40), (16, 200), (64, 100)])
def test_cold_batch_equals_sequential_algorithm_r_last_arrival_wins(window, batch):
    state = init_drift_monitor(DriftMonitorConfig(window=window, dim=3), _normal(1, (20, 3)), _gen(5),
                               device="cpu")
    for i in range(4):
        x = torch.from_numpy(_normal(20 + i, (batch, 3)))
        want = _sequential_algorithm_r(state, x)
        state = observe(state, x)
        assert torch.equal(state.buffer, want)


def test_cold_inclusion_is_uniform_over_arrivals():
    # Algorithm R keeps each of N arrivals with probability window / N.
    window, n, trials = 8, 32, 3000
    hits = np.zeros(n)
    cfg = DriftMonitorConfig(window=window, dim=1)
    stream = torch.arange(n, dtype=torch.float32)[:, None]
    for s in range(trials):
        state = init_drift_monitor(cfg, torch.zeros(4, 1), _gen(s))
        for j in range(0, n, 8):  # batches of 8: several arrivals may take one slot
            state = observe(state, stream[j:j + 8])
        kept = state.buffer[:, 0].long().numpy()
        assert len(set(kept.tolist())) == window
        hits[kept] += 1
    expected = trials * window / n
    chi2 = float(((hits - expected) ** 2 / expected).sum())
    assert chi2 < 61.10, chi2  # χ²(31) at p = 0.001


def test_observe_leaves_the_old_state_as_it_was():
    state = init_drift_monitor(DriftMonitorConfig(window=8, dim=2), _normal(2, (10, 2)), _gen(1),
                               device="cpu")
    state = observe(state, _normal(3, (8, 2)))
    buf, gstate = state.buffer.clone(), state.generator.get_state()
    new = observe(state, _normal(4, (30, 2)))
    assert torch.equal(state.buffer, buf) and torch.equal(state.generator.get_state(), gstate)
    assert state.count == 8 and new.count == 38
    assert new.generator is not state.generator
    # the same state folded twice gives the same reservoir
    assert torch.equal(observe(state, _normal(4, (30, 2))).buffer, new.buffer)


def _state_pair(cfg_kw, shift, window=256, dim=16):
    """Reference and port monitors over one reference set and one warm
    stream, the port carrying the reference's direction bank."""
    ref = _normal(0, (512, dim))
    jcfg = jstreaming.DriftMonitorConfig(window=window, dim=dim, **cfg_kw)
    cfg = interop.drift_config_from_dict(dataclasses.asdict(jcfg))
    jstate = jstreaming.init_drift_monitor(jcfg, jnp.asarray(ref), jax.random.PRNGKey(0))
    state = init_drift_monitor(cfg, ref, _gen(), device="cpu")
    # jax.random drew the reference's direction bank: carry it across
    dirs = torch.from_numpy(_np(jstate.directions))
    state = state._replace(directions=dirs,
                           ref_summary=summarize_set(state.reference, torch.ones(512, dtype=torch.bool), dirs)[0])
    for i in range(window // 128):
        batch = _normal(30 + i, (128, dim), shift)
        jstate = jstreaming.observe(jstate, jnp.asarray(batch))
        state = observe(state, batch)
    assert np.array_equal(state.buffer.numpy(), np.asarray(jstate.buffer))
    return jcfg, jstate, cfg, state


@pytest.mark.parametrize("shift,threshold,alert", [(0.0, 10.0, False), (20.0, 5.0, True), (6.0, 30.0, False)])
@pytest.mark.parametrize("certified", [True, False])
def test_check_drift_matches_reference(shift, threshold, alert, certified):
    pc = dict(alpha=0.1) if certified else dict(alpha=0.1, compute_projected=False, compute_bound=False)
    jcfg, jstate, cfg, state = _state_pair(dict(prohd=RefProHDConfig(**pc), threshold=threshold), shift)
    jrep = jstreaming.check_drift(jstate, jcfg)
    rep = check_drift(state, cfg)
    scale = float(max(np.linalg.norm(np.asarray(jstate.reference), axis=1).max(),
                      np.linalg.norm(np.asarray(jstate.buffer), axis=1).max()))
    for field in ("hd", "lower", "upper"):
        r, p = float(getattr(jrep, field)), float(getattr(rep, field))
        assert abs(p - r) <= fp_value_margin(16, scale, r), (field, p, r)
    assert bool(rep.alert) == bool(jrep.alert) == alert
    assert abs(float(rep.lower) - threshold) > fp_value_margin(16, scale, threshold)


def test_drift_config_interop_and_generator_device():
    jcfg = jstreaming.DriftMonitorConfig()
    cfg = interop.drift_config_from_dict(dataclasses.asdict(jcfg))
    assert cfg == DriftMonitorConfig() and cfg.threshold == float("inf")
    jcfg = jstreaming.DriftMonitorConfig(window=9, dim=3, threshold=2.5,
                                         prohd=RefProHDConfig(alpha=0.2, subset_backend="pallas"))
    cfg = interop.drift_config_from_dict(dataclasses.asdict(jcfg))
    assert (cfg.window, cfg.dim, cfg.threshold) == (9, 3, 2.5)
    assert cfg.prohd == ProHDConfig(alpha=0.2, subset_backend="cuda")
    with pytest.raises(ValueError, match="generator is on 'cpu'"):
        init_drift_monitor(cfg, torch.zeros(4, 3, device="meta"), _gen())


# ---------------------------------------------------------------------------
# the reference's tests/test_streaming.py, ported
# ---------------------------------------------------------------------------


def _ref_and_stream(dim=16, n_ref=512):
    return torch.randn((n_ref, dim), generator=_gen(0)), _gen(1)


def test_no_drift_when_same_distribution():
    ref, g = _ref_and_stream()
    cfg = DriftMonitorConfig(window=256, dim=16, prohd=ProHDConfig(alpha=0.1), threshold=10.0)
    state = init_drift_monitor(cfg, ref, g)
    for i in range(4):
        state = observe(state, torch.randn((128, 16), generator=_gen(100 + i)))
    rep = check_drift(state, cfg)
    assert not bool(rep.alert)
    assert float(rep.lower) <= float(rep.upper)


def test_drift_detected_on_shift():
    ref, g = _ref_and_stream()
    cfg = DriftMonitorConfig(window=256, dim=16, prohd=ProHDConfig(alpha=0.1), threshold=5.0)
    state = init_drift_monitor(cfg, ref, g)
    for i in range(4):
        state = observe(state, torch.randn((128, 16), generator=_gen(100 + i)) + 20.0)
    rep = check_drift(state, cfg)
    assert bool(rep.alert)
    h = float(hausdorff_dense(state.reference, state.buffer))
    assert float(rep.lower) <= h + 1e-3
    assert h <= float(rep.upper) + 1e-3


def test_reservoir_warms_sequentially():
    ref, g = _ref_and_stream(dim=4)
    state = init_drift_monitor(DriftMonitorConfig(window=8, dim=4), ref, g)
    batch = torch.arange(32.0).reshape(8, 4)
    state = observe(state, batch)
    assert state.count == 8
    assert torch.equal(state.buffer, batch)


def test_ref_summary_precomputed_once_and_tightens_interval():
    ref, g = _ref_and_stream()
    cfg = DriftMonitorConfig(window=256, dim=16, prohd=ProHDConfig(alpha=0.1))
    state = init_drift_monitor(cfg, ref, g)
    assert state.ref_summary.centroid.shape == (16,)
    assert state.directions.shape[0] == 16
    assert int(state.ref_summary.count) == ref.shape[0]
    state = observe(state, torch.randn((128, 16), generator=_gen(9)) + 6.0)
    rep = check_drift(state, cfg)
    h = float(hausdorff_dense(state.reference, state.buffer))
    assert float(rep.lower) <= h + 1e-3
    assert h <= float(rep.upper) + 1e-3


def test_summary_bounds_replace_vacuous_interval():
    ref, g = _ref_and_stream()
    cfg = DriftMonitorConfig(
        window=128, dim=16,
        prohd=ProHDConfig(alpha=0.1, compute_projected=False, compute_bound=False),
    )
    state = init_drift_monitor(cfg, ref, g)
    state = observe(state, torch.randn((128, 16), generator=_gen(3)) + 12.0)
    rep = check_drift(state, cfg)
    assert float(rep.lower) > 0.0
    assert bool(torch.isfinite(rep.upper))


def test_observe_keeps_fixed_shapes():
    # The reference's jit test: the port's counterpart is that observe
    # keeps the buffer's shape and dtype and only counts what it folds in.
    ref, g = _ref_and_stream(dim=8)
    state = init_drift_monitor(DriftMonitorConfig(window=16, dim=8), ref, g)
    state = observe(state, torch.ones((4, 8)))
    assert state.count == 4
    assert state.buffer.shape == (16, 8) and state.buffer.dtype == torch.float32
