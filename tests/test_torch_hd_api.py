"""The port's ``set_distance`` front door held to ``repro.hd``.

Served matrix, ``auto`` resolution (CPU keeps the reference's choices, a
CUDA device kind resolves to ``fused_cuda``), every served (variant,
method) against the reference's ``set_distance`` on the same numpy clouds
within ``fp_value_margin``, the device rule, config interop, and the rule
that the port imports nothing of JAX or of the reference package.
"""
import ast
import dataclasses
import importlib
import pkgutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.hd as jhd  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.fp_margin import fp_value_margin  # noqa: E402
from repro_torch.hd import (  # noqa: E402
    BACKENDS,
    METHODS,
    TILE_THRESHOLD,
    VARIANTS,
    HDConfig,
    HDEngine,
    UnsupportedCombination,
    resolve_backend,
    resolve_block_sizes,
    set_distance,
    supported_combinations,
)
from repro_torch.hd.registry import CONCRETE_BACKENDS  # noqa: E402
from repro_torch.kernels.hausdorff import hausdorff as K  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SERVED = {
    (v, "exact", b)
    for v in ("hausdorff", "directed", "partial", "chamfer")
    for b in ("dense", "tiled", "fused_cuda")
} | {("hausdorff", "prohd", b) for b in ("dense", "tiled", "fused_cuda")} | {
    ("hausdorff", m, b) for m in ("sampling", "adaptive") for b in ("tiled", "fused_cuda")
}
RANDOMISED = {"sampling"}  # methods that need a generator
CFG = dict(alpha=0.1, quantile=0.9, block_a=128, block_b=128)


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(7)
    a = rng.random((160, 8), dtype=np.float32)
    b = rng.random((140, 8), dtype=np.float32) + np.float32(0.1)
    return a, b


def _scale(a, b):
    return float(max(np.linalg.norm(a, axis=1).max(), np.linalg.norm(b, axis=1).max()))


def test_served_matrix_is_exactly_the_slice():
    assert set(supported_combinations()) == SERVED
    assert "fused_cuda" in BACKENDS and "fused_pallas" not in BACKENDS
    # the reference's matrix less its distributed cells, fused_pallas renamed,
    # plus kernel 1 (fused_cuda) under sampling and adaptive
    ref = {(v, m, interop.backend_name(b)) for v, m, b in jhd.supported_combinations()
           if b != "distributed"}
    extra = {("hausdorff", m, "fused_cuda") for m in ("sampling", "adaptive")}
    assert set(supported_combinations()) == ref | extra


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("method", METHODS)
def test_every_cell_computes_or_raises_unsupported(clouds, variant, method):
    a, b = clouds
    for backend in CONCRETE_BACKENDS:
        if (variant, method, backend) in SERVED:
            gen = torch.Generator().manual_seed(0) if method in RANDOMISED else None
            res = set_distance(a, b, variant=variant, method=method, backend=backend,
                               config=HDConfig(**CFG), device="cpu", generator=gen)
            assert res.meta.backend == backend
            assert np.isfinite(float(res.value))
        else:
            with pytest.raises(UnsupportedCombination):
                set_distance(a, b, variant=variant, method=method, backend=backend, device="cpu")


@pytest.mark.parametrize("n", [100, TILE_THRESHOLD, 5000])
def test_auto_on_cpu_keeps_the_reference_choice(n):
    for variant, method, _ in SERVED:
        ref = jhd.resolve_backend(variant, method, n, n, 16, device_kind="cpu")
        assert resolve_backend(variant, method, n, n, 16, device_kind="cpu") == ref
        for d in (8, 256):
            assert resolve_block_sizes(n, n, d, device_kind="cpu", backend=ref) == \
                jhd.resolve_block_sizes(n, n, d, device_kind="cpu", backend=ref)


@pytest.mark.parametrize("n", [8, 100, 1_000_000])
def test_auto_on_cuda_resolves_every_dispatch_to_the_kernel(n):
    for variant, method, _ in SERVED:
        assert resolve_backend(variant, method, n, n, 256, device_kind="cuda") == "fused_cuda"
    assert resolve_block_sizes(n, n, 256, device_kind="cuda", backend="fused_cuda") == (
        K.TABLE_BLOCK, K.TABLE_BLOCK)
    for method in ("sampling", "adaptive"):
        assert resolve_backend("hausdorff", method, n, n, 256, device_kind="cuda") == "fused_cuda"


@pytest.mark.parametrize("variant", ["hausdorff", "directed", "partial", "chamfer"])
@pytest.mark.parametrize("backend", ["dense", "tiled"])
@pytest.mark.parametrize("masked", [False, True])
def test_exact_variants_match_reference(clouds, variant, backend, masked):
    a, b = clouds
    masks = None
    if masked:
        rng = np.random.default_rng(3)
        masks = (rng.random(160) > 0.3, rng.random(140) > 0.3)
    jmasks = None if masks is None else tuple(jnp.asarray(m) for m in masks)
    ref = jhd.set_distance(jnp.asarray(a), jnp.asarray(b), variant=variant, backend=backend,
                           masks=jmasks, config=jhd.HDConfig(**CFG))
    cfg = interop.hd_config_from_dict(dataclasses.asdict(jhd.HDConfig(**CFG)))
    for port_backend in (backend, "fused_cuda"):
        res = set_distance(a, b, variant=variant, backend=port_backend, masks=masks,
                           config=cfg, device="cpu")
        r, p = float(ref.value), float(res.value)
        # chamfer sums two means of distances: twice one distance's margin
        margin = fp_value_margin(8, _scale(a, b), r) * (2 if variant == "chamfer" else 1)
        assert abs(p - r) <= margin, (variant, port_backend, p, r)
        assert (res.lower is None) == (ref.lower is None)


@pytest.mark.parametrize("backend", ["dense", "tiled"])
def test_prohd_matches_reference(clouds, backend):
    a, b = clouds
    ref = jhd.set_distance(jnp.asarray(a), jnp.asarray(b), method="prohd", backend=backend,
                           config=jhd.HDConfig(**CFG))
    res = set_distance(a, b, method="prohd", backend=backend, config=HDConfig(**CFG), device="cpu")
    m = lambda v: fp_value_margin(8, _scale(a, b), v)  # noqa: E731
    for field in ("value", "lower", "upper"):
        r, p = float(getattr(ref, field)), float(getattr(res, field))
        assert abs(p - r) <= m(r), (field, p, r)
    assert int(res.stats["n_sel_a"]) == int(ref.stats["n_sel_a"])
    assert res.certified


def test_prune_projs_add_skip_fraction_and_keep_values(clouds):
    a, b = clouds
    proj = lambda x: x[:, :2].copy()  # noqa: E731  (any shared projection is sound)
    for backend in ("tiled", "fused_cuda"):
        plain = set_distance(a, b, backend=backend, config=HDConfig(**CFG), device="cpu")
        pruned = set_distance(a, b, backend=backend, config=HDConfig(**CFG), device="cpu",
                              prune_projs=(proj(a), proj(b)))
        assert "skip_fraction" in pruned.stats
        assert float(pruned.value) == float(plain.value)


def test_numpy_input_without_gpu_raises_unless_cpu_requested(clouds, monkeypatch):
    a, b = clouds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        set_distance(a, b)
    res = set_distance(a, b, device="cpu")
    assert res.value.device.type == "cpu"
    # CPU tensors keep their device with no device= at all
    res = set_distance(torch.from_numpy(a), torch.from_numpy(b))
    assert res.value.device.type == "cpu"
    assert res.meta.backend == "dense"  # auto on the CPU, under the tile threshold


def test_engine_measure_and_nonfinite_validation(clouds):
    a, b = clouds
    eng = HDEngine(variant="chamfer", config=HDConfig(**CFG))
    res = eng(a, b, measure=True, device="cpu")
    assert res.meta.elapsed_s is not None and res.meta.elapsed_s >= 0
    assert float(res.value) == float(set_distance(a, b, variant="chamfer", config=HDConfig(**CFG),
                                                  device="cpu").value)
    bad = a.copy()
    bad[3, 1] = np.nan
    with pytest.raises(ValueError, match="valid row 3"):
        set_distance(bad, b, device="cpu")
    valid_a = np.ones(160, bool)
    valid_a[3] = False
    assert np.isfinite(float(set_distance(bad, b, masks=(valid_a, None), device="cpu").value))
    with pytest.raises(ValueError, match="masks"):
        set_distance(a, b, method="prohd", masks=(valid_a, None), device="cpu")


def test_interop_round_trips_a_reference_config():
    from repro.core.prohd import ProHDConfig as RefProHDConfig

    ref_cfg = jhd.HDConfig(alpha=0.05, quantile=0.8, block_a=256, interpret=True,
                           prohd=RefProHDConfig(alpha=0.03, subset_backend="pallas", prune=True))
    d = dataclasses.asdict(ref_cfg)
    port = interop.hd_config_from_dict(d)
    assert port.prohd.subset_backend == "cuda"
    back = dataclasses.asdict(port)
    expected = {k: v for k, v in d.items() if k not in interop.DROPPED_FIELDS}
    expected["prohd"] = {**d["prohd"], "subset_backend": "cuda"}
    assert back == expected
    assert interop.backend_name("fused_pallas") == "fused_cuda"
    assert interop.backend_name("tiled") == "tiled"
    with pytest.raises(ValueError, match="no fields"):
        interop.hd_config_from_dict({"alpha": 0.1, "not_a_field": 1})
    x = np.arange(6, dtype=np.float64).reshape(3, 2)
    t = interop.cloud(x, "cpu")
    assert t.dtype == torch.float32 and t.tolist() == x.tolist()
    assert interop.mask(np.array([1, 0, 1]), "cpu").tolist() == [True, False, True]
    assert interop.mask(None, "cpu") is None


def test_interop_carries_the_sampling_and_adaptive_fields():
    assert interop.DROPPED_FIELDS == {"interpret", "max_shape_classes"}
    ref_cfg = jhd.HDConfig(sampler="systematic", budget=0.25, budget_relative=False,
                           adaptive_alpha0=0.02, adaptive_max_alpha=0.3, adaptive_max_steps=5)
    port = interop.hd_config_from_dict(dataclasses.asdict(ref_cfg))
    assert (port.sampler, port.budget, port.budget_relative) == ("systematic", 0.25, False)
    assert (port.adaptive_alpha0, port.adaptive_max_alpha, port.adaptive_max_steps) == (0.02, 0.3, 5)
    defaults = {k: v for k, v in dataclasses.asdict(jhd.HDConfig()).items()
                if k not in interop.DROPPED_FIELDS}
    assert dataclasses.asdict(HDConfig()) == defaults
    from repro_torch.hd import BACKEND_FOR_SUBSET

    assert BACKEND_FOR_SUBSET == {interop.SUBSET_BACKEND_NAMES.get(k, k): interop.backend_name(v)
                                  for k, v in jhd.BACKEND_FOR_SUBSET.items()}


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


def test_port_and_chip_smoke_import_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "flash_planted_faults.py"]
    assert len(files) > 20
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)
            assert not mod.startswith("."), (f, mod)


def test_every_port_module_imports_without_cuda_or_triton():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    assert "repro_torch.kernels.hausdorff.ops" in names
    for name in names:
        importlib.import_module(name)
