"""The main path's public names that the port carries beside the reference's.

``repro_torch.hd.is_supported``, ``hd.resolver.default_device_kind``, the
substrate ``repro_torch.core`` re-exports, ``core.exact.hausdorff_tiled``,
``core.projected.directed_hd_1d`` and ``data.pointclouds.make_dataset``,
each held to its counterpart in ``repro`` on the same numpy inputs.

Tolerances: fp32 values ``atol 2e-5, rtol 1e-4`` (the reference's fp32
tolerance, ``tests/test_kernels.py:115``).  ``make_dataset`` draws from a
``torch.Generator`` where the reference draws from ``jax.random``, whose
numbers cannot be redrawn: its outputs are held to the reference's by shape,
dtype and distribution (the statistics each generator fixes: a cube's
bounds and offset, a spectrum's decay, a shift and a scale), each within
five standard errors of the draw.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro.hd as ref_hd  # noqa: E402
from repro.core import exact as ref_exact  # noqa: E402
from repro.core import projected as ref_projected  # noqa: E402
from repro.data import pointclouds as ref_pc  # noqa: E402
from repro.hd import resolver as ref_resolver  # noqa: E402

import repro_torch.core as core  # noqa: E402
import repro_torch.hd as hd  # noqa: E402
from repro_torch.core import exact, projected  # noqa: E402
from repro_torch.data import pointclouds as pc  # noqa: E402
from repro_torch.hd import registry, resolver  # noqa: E402

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
