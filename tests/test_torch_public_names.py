"""The main path's public names that the port carries beside the reference's.

``repro_torch.hd.is_supported``, ``hd.resolver.default_device_kind``, the
substrate ``repro_torch.core`` re-exports, ``core.exact.hausdorff_tiled``,
``core.projected.directed_hd_1d``, ``data.pointclouds.make_dataset``,
``core.variants.partial_hausdorff`` / ``chamfer``, ``HDResult.degraded`` /
``stage_reached``, ``obs.metrics``' ``Histogram.mean`` / ``quantile`` and
``MetricsRegistry.names``, and ``index.sharded.stage0_multiquery``, each
held to its counterpart in ``repro`` on the same numpy inputs.

``partial_hausdorff`` and ``chamfer``: the reference's direct functions
reach its Pallas kernel, which fails under the JAX installed here
(``pl.store`` is gone; ``tests/test_variants.py`` fails for that reason),
so they are held to the reference's front door on its pure-JAX ``tiled``
backend (the same reductions of the same scan), and with masks also to
float64 on the valid rows and to the conventions ``tests/test_variants.py``
writes down: q = 1 is the HD of the valid rows, all masked on both sides
is 0.0, an all-masked query side is +inf.

Tolerances: fp32 values ``atol 2e-5, rtol 1e-4`` (the reference's fp32
tolerance, ``tests/test_kernels.py:115``).  ``make_dataset`` draws from a
``torch.Generator`` where the reference draws from ``jax.random``, whose
numbers cannot be redrawn: its outputs are held to the reference's by shape,
dtype and distribution (the statistics each generator fixes: a cube's
bounds and offset, a spectrum's decay, a shift and a scale), each within
five standard errors of the draw.
"""
import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro.hd as ref_hd  # noqa: E402
from repro.core import exact as ref_exact  # noqa: E402
from repro.core import projected as ref_projected  # noqa: E402
from repro.core import variants as ref_variants  # noqa: E402
from repro.data import pointclouds as ref_pc  # noqa: E402
from repro.hd import resolver as ref_resolver  # noqa: E402
from repro.index import multiquery as ref_multiquery  # noqa: E402
from repro.index import sharded as ref_sharded  # noqa: E402
from repro.index.store import SetStore as RefStore  # noqa: E402
from repro.obs import metrics as ref_metrics  # noqa: E402

import repro_torch.core as core  # noqa: E402
import repro_torch.hd as hd  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import exact, projected, variants  # noqa: E402
from repro_torch.data import pointclouds as pc  # noqa: E402
from repro_torch.hd import registry, resolver  # noqa: E402
from repro_torch.index import multiquery, sharded  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

ATOL, RTOL = 2e-5, 1e-4
# The reference's shims, which the port leaves to the front door.
SHIMS = {"prohd", "hausdorff_dense", "hausdorff_tiled", "hausdorff_fused_tiled", "random_sampling_hd",
         "systematic_sampling_hd", "chamfer", "partial_hausdorff", "prohd_with_budget"}
DISTRIBUTED = {"ShardedCloud", "batch_group", "batch_size", "distributed_exact_hd", "distributed_prohd"}
# The port's fused_cuda serves the randomised cells the reference's fused_pallas does not.
PORT_ONLY = {("hausdorff", "sampling", "fused_cuda"), ("hausdorff", "adaptive", "fused_cuda")}


def _clouds(seed, n_a, n_b, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_a, d)).astype(np.float32),
            (rng.standard_normal((n_b, d)) + 0.3).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("backend", registry.CONCRETE_BACKENDS)
def test_is_supported_matches_reference(backend):
    assert "is_supported" in hd.__all__ and hd.is_supported is registry.is_supported
    ref_backend = {"fused_cuda": "fused_pallas"}.get(backend, backend)
    for v in registry.VARIANTS:
        for m in registry.METHODS:
            got = hd.is_supported(v, m, backend)
            assert got == ((v, m, backend) in hd.supported_combinations())
            assert got == (ref_hd.is_supported(v, m, ref_backend) or (v, m, backend) in PORT_ONLY), (v, m)
    assert not hd.is_supported("hausdorff", "exact", "auto")
    assert not hd.is_supported("nope", "exact", backend)


def test_default_device_kind(monkeypatch):
    """The process's kind: ``cpu`` here, as the reference's default device
    under ``JAX_PLATFORMS=cpu``, and ``cuda`` when a CUDA device shows.  The
    front door keeps taking the kind from its operands."""
    assert resolver.default_device_kind() == ref_resolver.default_device_kind() == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolver.default_device_kind() == "cuda"
    a, b = _clouds(0, 600, 700, 4)
    res = hd.set_distance(a, b, device="cpu")
    assert res.meta.backend == "tiled"


@pytest.mark.parametrize("name", ["resolve_masked_backend", "resolve_multiquery_backend"])
@pytest.mark.parametrize("args", [(1, 64, 256), (16, 0, 8)], ids=str)
def test_masked_resolvers_take_the_reference_call_forms(name, args):
    """The reference's call forms, ``(n_q | q_batch, cap, d, *,
    device_kind)``, on both packages: the same parameters, and the same
    answer on the CPU; on the card the port names its kernel where the
    reference names its Pallas kernel on the TPU (the shape is unused by
    both)."""
    ours, ref = getattr(resolver, name), getattr(ref_resolver, name)
    assert list(inspect.signature(ours).parameters) == list(inspect.signature(ref).parameters)
    assert ours(*args, device_kind="cpu") == ref(*args, device_kind="cpu") == ours(*args)
    assert ours(*args, device_kind="cuda") == ref(*args, device_kind="tpu").replace("_pallas", "_cuda")
    with pytest.raises(TypeError):
        ours(*args, "cuda")  # device_kind is keyword-only, as in the reference


@pytest.mark.parametrize("n_sets,k,budget", [(100, 10, None), (100, 10, 7), (100, 10, 250), (40, 3, 0),
                                             (40, 3, -2)], ids=str)
def test_anytime_refine_cap_takes_the_reference_call_form(n_sets, k, budget):
    assert (list(inspect.signature(resolver.resolve_anytime_refine_cap).parameters)
            == list(inspect.signature(ref_resolver.resolve_anytime_refine_cap).parameters))
    assert (resolver.resolve_anytime_refine_cap(n_sets, k, budget)
            == ref_resolver.resolve_anytime_refine_cap(n_sets, k, budget))


def test_core_reexports_the_reference_substrate():
    ref_names = set(ref_core.__all__) - SHIMS
    assert set(core.__all__) == ref_names | DISTRIBUTED
    from repro_torch.core import adaptive, distributed, prohd, tile_bounds

    for name in core.__all__:
        home = next(m for m in (adaptive, distributed, exact, prohd, tile_bounds) if hasattr(m, name))
        assert getattr(core, name) is getattr(home, name), name
    for name in ("ProHDEstimate", "PruneTables", "AdaptiveResult"):
        assert getattr(core, name)._fields == getattr(ref_core, name)._fields, name
    assert ({f.name for f in dataclasses.fields(core.ProHDConfig)}
            == {f.name for f in dataclasses.fields(ref_core.ProHDConfig)})


@pytest.mark.parametrize("name", ["directed_hd_dense", "directed_hd_tiled", "directed_hd_earlybreak",
                                  "hausdorff_earlybreak", "hausdorff_twosweep_tiled"])
def test_core_reexported_oracles_match_reference(name):
    a, b = _clouds(1, 300, 200, 5)
    got = getattr(core, name)(_t(a), _t(b))
    want = getattr(ref_core, name)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=RTOL)


def test_core_reexported_fused_scan_matches_reference():
    a, b = _clouds(2, 300, 200, 5)
    va = np.arange(300) % 7 != 0
    got = core.fused_min_sqdists_tiled(_t(a), _t(b), valid_a=_t(va), block_a=128, block_b=64)
    want = ref_core.fused_min_sqdists_tiled(jnp.asarray(a), jnp.asarray(b), valid_a=jnp.asarray(va),
                                            block_a=128, block_b=64)
    for g, w in zip(got, want):
        w = np.asarray(w)
        fin = np.isfinite(w)
        assert np.array_equal(np.isfinite(g.numpy()), fin)
        np.testing.assert_allclose(g.numpy()[fin], w[fin], atol=ATOL, rtol=RTOL)


def test_core_reexported_selection_and_tables_match_reference():
    a, b = _clouds(3, 800, 600, 6)
    sel_ref = jax.jit(ref_core.prohd_masks, static_argnums=2)(jnp.asarray(a), jnp.asarray(b),
                                                              ref_core.ProHDConfig(alpha=0.05))
    sel = core.prohd_masks(_t(a), _t(b), core.ProHDConfig(alpha=0.05))
    assert int(sel.mask_a.sum()) == int(np.asarray(sel_ref.mask_a).sum())
    assert int(sel.mask_b.sum()) == int(np.asarray(sel_ref.mask_b).sum())
    pa, pb = sel_ref.proj_a, sel_ref.proj_b
    sa, spa, _, perm_a = core.order_by_projection(_t(a), _t(np.asarray(pa)))
    sb, spb, _, _ = core.order_by_projection(_t(b), _t(np.asarray(pb)))
    order = jax.jit(ref_core.order_by_projection)
    rsa, rspa, _, rperm_a = order(jnp.asarray(a), pa)
    rsb, rspb, _, _ = order(jnp.asarray(b), pb)
    np.testing.assert_array_equal(perm_a.numpy(), np.asarray(rperm_a))
    tables = core.prune_tables(sa, spa, None, sb, spb, None, 128, 128)
    ref_tables = jax.jit(lambda *x: ref_core.prune_tables(x[0], x[1], None, x[2], x[3], None, 128, 128))(
        rsa, rspa, rsb, rspb)
    assert isinstance(tables, core.PruneTables)
    np.testing.assert_allclose(tables.lb.numpy(), np.asarray(ref_tables.lb), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tables.cut_a.numpy(), np.asarray(ref_tables.cut_a), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("block", [64, 2048])
@pytest.mark.parametrize("masked", [False, True])
def test_hausdorff_tiled_matches_reference(block, masked):
    a, b = _clouds(4, 500, 300, 7)
    kw, ref_kw = {}, {}
    if masked:
        va, vb = np.arange(500) % 5 != 1, np.arange(300) % 3 != 2
        kw = {"valid_a": _t(va), "valid_b": _t(vb)}
        ref_kw = {"valid_a": jnp.asarray(va), "valid_b": jnp.asarray(vb)}
    got = exact.hausdorff_tiled(_t(a), _t(b), block=block, **kw)
    want = ref_exact.hausdorff_tiled(jnp.asarray(a), jnp.asarray(b), block=block, **ref_kw)
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=RTOL)
    assert torch.equal(got, exact.hausdorff_fused_tiled(_t(a), _t(b), block_a=block, block_b=block, **kw))


@pytest.mark.parametrize("n_a,n_b", [(1, 1), (17, 300), (300, 17)])
def test_directed_hd_1d_matches_reference(n_a, n_b):
    rng = np.random.default_rng(n_a * 1000 + n_b)
    pa = rng.standard_normal(n_a).astype(np.float32)
    pb = (rng.standard_normal(n_b) * 2).astype(np.float32)  # unsorted
    assert "directed_hd_1d" in projected.__all__
    got = projected.directed_hd_1d(_t(pa), _t(pb))
    want = ref_projected.directed_hd_1d(jnp.asarray(pa), jnp.asarray(pb))
    assert float(got) == float(want)
    both = projected.hd_1d(_t(pa), _t(pb))
    assert float(both) == max(float(got), float(projected.directed_hd_1d(_t(pb), _t(pa))))


def _sem_ok(x, y, what):
    """Column means of two draws of one distribution within 5 standard errors."""
    se = np.sqrt(x.var(0) / len(x) + y.var(0) / len(y))
    assert (np.abs(x.mean(0) - y.mean(0)) <= 5 * se + 1e-6).all(), what


@pytest.mark.parametrize("name", ["random", "image", "higgs"])
def test_make_dataset_matches_reference_in_distribution(name):
    n_a, n_b, d = 20_000, 16_000, 12
    a, b = pc.make_dataset(name, pc.make_generator(0, "cpu"), n_a, n_b, d)
    ra, rb = (np.asarray(x, np.float64) for x in ref_pc.make_dataset(name, jax.random.PRNGKey(0), n_a, n_b, d))
    assert a.shape == ra.shape == (n_a, d) and b.shape == rb.shape == (n_b, d)
    assert a.dtype == b.dtype == torch.float32 and a.device.type == "cpu"
    a, b = a.double().numpy(), b.double().numpy()
    if name == "random":  # the unit cube, B offset by 0.1: the same law on both sides
        for x, rx, lo in ((a, ra, 0.0), (b, rb, 0.1)):
            assert x.min() >= lo and x.max() <= lo + 1.0
            _sem_ok(x, rx, name)
    elif name == "image":  # per-coordinate spread decays as 0.85^k on both sides
        for x in (a, b, ra, rb):
            noise = np.log(x.std(0))
            slope = np.polyfit(np.arange(d), noise, 1)[0]
            assert abs(slope - np.log(0.85)) < 0.06, slope
    else:  # B = A's law × 1.15 + 0.8 on the first d // 4 coordinates
        for x, y in ((a, b), (ra, rb)):
            shift = y.mean(0) - 1.15 * x.mean(0)
            se = np.sqrt(y.var(0) / len(y) + 1.15 ** 2 * x.var(0) / len(x))
            want = np.where(np.arange(d) < d // 4, 0.8, 0.0)
            assert (np.abs(shift - want) <= 5 * se).all()
            ratio = y.var(0).sum() / x.var(0).sum()
            assert abs(ratio - 1.15 ** 2) < 0.05, ratio
    with pytest.raises(ValueError, match="unknown dataset"):
        pc.make_dataset("mnist", pc.make_generator(0, "cpu"), 4, 4, d)
    with pytest.raises(ValueError, match="unknown dataset"):
        ref_pc.make_dataset("mnist", jax.random.PRNGKey(0), 4, 4, d)


def _variant_clouds(seed):
    a, b = _clouds(seed, 128, 100, 6)
    return a, b


@pytest.mark.parametrize("q", [0.0, 0.5, 0.95, 1.0])
def test_partial_hausdorff_and_chamfer_match_reference(q):
    a, b = _variant_clouds(20)
    got = variants.partial_hausdorff(_t(a), _t(b), quantile=q)
    want = ref_hd.set_distance(jnp.asarray(a), jnp.asarray(b), variant="partial", backend="tiled",
                               config=ref_hd.HDConfig(quantile=q)).value
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=RTOL)
    want_c = ref_hd.set_distance(jnp.asarray(a), jnp.asarray(b), variant="chamfer", backend="tiled").value
    np.testing.assert_allclose(float(variants.chamfer(_t(a), _t(b))), float(want_c), atol=ATOL, rtol=RTOL)
    for name in ("partial_hausdorff", "chamfer"):  # the reference's signatures
        assert name in variants.__all__
        assert inspect.signature(getattr(variants, name)).parameters.keys() == \
            inspect.signature(getattr(ref_variants, name)).parameters.keys()


def _float64_variants(a, b, va, vb, q):
    """(partial HD, chamfer) in float64 on the valid rows, by the written
    conventions: an empty target set gives +inf, an empty query side 0.0."""
    a, b = a[va].astype(np.float64), b[vb].astype(np.float64)
    d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))

    def ranked(mins):
        if mins.size == 0:
            return 0.0
        return np.sort(mins)[max(1, int(np.ceil(np.float32(q) * np.float32(mins.size)))) - 1]

    min_a = d.min(1) if b.shape[0] else np.full(a.shape[0], np.inf)
    min_b = d.min(0) if a.shape[0] else np.full(b.shape[0], np.inf)
    mean = [m.mean() if m.size else 0.0 for m in (min_a, min_b)]
    return max(ranked(min_a), ranked(min_b)), mean[0] + mean[1]


MASKED = {  # the masked conventions of tests/test_variants.py: (valid_a, valid_b) over 128 × 100 rows
    "quantile_one_is_hd_of_valid_rows": (np.arange(128) < 100, np.arange(100) < 80),
    "all_masked_both_sides_is_zero": (np.zeros(128, bool), np.zeros(100, bool)),
    "all_masked_query_side_is_infinite": (np.zeros(128, bool), None),
    "front_door_masked": (np.arange(128) < 70, None),
}


@pytest.mark.parametrize("case", list(MASKED))
@pytest.mark.parametrize("q", [0.0, 0.5, 1.0])
def test_masked_partial_hausdorff_and_chamfer(case, q):
    a, b = _variant_clouds(21)
    va, vb = MASKED[case]
    vb_full = np.ones(100, bool) if vb is None else vb
    kw = {"valid_a": _t(va), "valid_b": None if vb is None else _t(vb)}
    got = float(variants.partial_hausdorff(_t(a), _t(b), quantile=q, **kw))
    got_c = float(variants.chamfer(_t(a), _t(b), **kw))
    want, want_c = _float64_variants(a, b, va, vb_full, q)
    if np.isinf(want):
        assert np.isinf(got) and got > 0
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    if case == "quantile_one_is_hd_of_valid_rows" and q == 1.0:
        np.testing.assert_allclose(got, float(exact.hausdorff_dense(_t(a[:100]), _t(b[:80]))), rtol=1e-5)
    if case == "all_masked_both_sides_is_zero":
        assert got == 0.0 and got_c == 0.0
    if case == "all_masked_query_side_is_infinite":
        assert np.isinf(got)
    # the reference's front door on its pure-JAX tiled backend
    masks = (jnp.asarray(va), None if vb is None else jnp.asarray(vb))
    for variant, mine, cfg in (("partial", got, ref_hd.HDConfig(quantile=q)), ("chamfer", got_c, ref_hd.HDConfig())):
        ref = float(ref_hd.set_distance(jnp.asarray(a), jnp.asarray(b), variant=variant, backend="tiled",
                                        masks=masks, config=cfg).value)
        if np.isinf(ref) or np.isnan(ref):
            assert np.isinf(mine) == np.isinf(ref) and np.isnan(mine) == np.isnan(ref), (variant, mine, ref)
        else:
            np.testing.assert_allclose(mine, ref, atol=ATOL, rtol=RTOL)
    # the port's front door reduces the same scan: bitwise the direct call
    via = hd.set_distance(_t(a), _t(b), variant="partial", backend="tiled", masks=(kw["valid_a"], kw["valid_b"]),
                          config=hd.HDConfig(quantile=q)).value
    assert float(via) == got or (np.isnan(float(via)) and np.isnan(got))


def test_result_degraded_and_stage_reached_match_reference():
    a, b = _clouds(22, 64, 48, 4)
    got = hd.set_distance(_t(a), _t(b), backend="tiled")
    want = ref_hd.set_distance(jnp.asarray(a), jnp.asarray(b), backend="tiled")
    assert (got.degraded, got.stage_reached) == (want.degraded, want.stage_reached) == (False, "complete")
    meta = dataclasses.replace(got.meta, degraded=True, stage_reached="stage1")
    assert dataclasses.replace(got, meta=meta).degraded and dataclasses.replace(got, meta=meta).stage_reached == "stage1"


OBSERVED = [0.5, 1e-3, 2e-3, 0.02, 0.02, 3.0, 7e4, 1e-5]


def test_histogram_mean_quantile_and_names_match_reference():
    mine, ref = metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    for reg in (mine, ref):
        reg.counter("b.count")
        reg.gauge("a.gauge")
        h = reg.histogram("c.lat", unit="s")
        assert h.mean == 0.0 and h.quantile(0.5) == 0.0
        for v in OBSERVED:
            h.observe(v)
    assert mine.names() == ref.names() == ["a.gauge", "b.count", "c.lat"]
    h, rh = mine.histogram("c.lat"), ref.histogram("c.lat")
    assert h.mean == rh.mean
    for q in (0.0, 0.5, 1.0):
        assert h.quantile(q) == rh.quantile(q)
    for q in (-0.1, 1.5):
        with pytest.raises(ValueError):
            rh.quantile(q)
        with pytest.raises(ValueError, match="outside"):
            h.quantile(q)


@pytest.mark.parametrize("directed", [False, True])
def test_stage0_multiquery_matches_reference(directed):
    rng = np.random.default_rng(23)
    sets = [rng.normal(size=(int(rng.integers(4, 30)), 6)).astype(np.float32) for _ in range(40)]
    qs = [rng.normal(size=(n, 6)).astype(np.float32) for n in (5, 9, 12)]
    ref = RefStore(dim=6, min_bucket=16)
    ref.add_many(sets)
    store = interop.store_from_reference(np.asarray(ref.directions), sets, min_bucket=16, device="cpu")
    ref_q = ref_multiquery._stack_query_summaries([ref.summarize(jnp.asarray(q)) for q in qs])
    want = ref_sharded.stage0_multiquery(ref_sharded.make_shard_context(1), ref_q, ref.summaries(),
                                         directed=directed)
    qsums = multiquery._stack_query_summaries([store.summarize(torch.from_numpy(q)) for q in qs])
    got = sharded.stage0_multiquery(sharded.make_shard_context(1, "cpu"), qsums, store.summaries(),
                                    directed=directed)
    assert "stage0_multiquery" in sharded.__all__
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64 and g.shape == w.shape == (len(qs), len(sets))
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
    # the stage-0 rows of search_batch: stage0_bounds' bits
    for g, w in zip(got, sharded.stage0_bounds(sharded.make_shard_context(1, "cpu"), qsums, store.summaries(),
                                               directed=directed)):
        assert np.array_equal(g, w.double().numpy())
