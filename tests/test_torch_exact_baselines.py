"""The paper's exact baselines in the port: EBHD's early-break double loop
(``directed_hd_earlybreak`` / ``hausdorff_earlybreak``) and the two-sweep
tiled HD (``hausdorff_twosweep_tiled``), held to the JAX reference and to a
float64 H on the same numpy inputs.

``exact.hausdorff_twosweep_tiled`` runs ``directed_hd_tiled`` twice; its
kernel wrapper ``ops.hausdorff_twosweep_tiled`` runs kernel 1 directed
twice, on the CPU through its plain version; on the card each sweep is one
launch of the directed instance, which ``chip_smoke.py`` checks (launch
count, value against the fused call).
Shapes include ROADMAP's tiny shapes where the reference fails its own
conformance cases (n 1, D 1; 38 × 8 at D 17); those are judged against the
float64 H and the written conventions, not against the reference's output.

Tolerance: ``fp_value_margin(D, scale, H)``, the repo's pinned envelope
between two fp32 exact-HD computations of one pair (``core/fp_margin.py``);
the difference form of the early break is tighter than the GEMM form it
bounds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import exact as ref_exact  # noqa: E402
from repro_torch.core import exact  # noqa: E402
from repro_torch.core.fp_margin import fp_value_margin  # noqa: E402
from repro_torch.kernels.hausdorff import ops  # noqa: E402

# (n_a, n_b, D): the reference's tiny failing shapes first, then ragged ones.
SHAPES = [(1, 1, 1), (1, 2, 1), (38, 8, 17), (5, 1, 3), (96, 130, 16), (257, 300, 5)]


def _clouds(seed, n_a, n_b, d):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n_a, d)).astype(np.float32)
    b = (rng.standard_normal((n_b, d)) * 1.5 + 0.3).astype(np.float32)
    return a, b


def _h64(a, b, valid_a=None, valid_b=None):
    """float64 directed HDs and H over the valid rows (the written
    conventions: an empty query side gives 0, an empty target side +inf)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    va = np.ones(len(a), bool) if valid_a is None else valid_a
    vb = np.ones(len(b), bool) if valid_b is None else valid_b
    d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))

    def directed(dm, vq, vt):
        if not vq.any():
            return 0.0
        if not vt.any():
            return np.inf
        return float(np.where(vt[None, :], dm, np.inf).min(axis=1)[vq].max())

    return max(directed(d, va, vb), directed(d.T, vb, va))


def _margin(a, b, h):
    scale = max(float(np.linalg.norm(a, axis=1).max()), float(np.linalg.norm(b, axis=1).max()))
    return float(fp_value_margin(a.shape[1], scale, h))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_earlybreak_matches_reference_and_float64(shape):
    a, b = _clouds(sum(shape), *shape)
    got = float(exact.hausdorff_earlybreak(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(ref_exact.hausdorff_earlybreak(jnp.asarray(a), jnp.asarray(b)))
    h = _h64(a, b)
    m = _margin(a, b, h)
    assert abs(got - h) <= m, (got, h, m)
    assert abs(got - want) <= m, (got, want, m)
    for x, y in ((a, b), (b, a)):
        d = float(exact.directed_hd_earlybreak(torch.from_numpy(x), torch.from_numpy(y)))
        dw = float(ref_exact.directed_hd_earlybreak(jnp.asarray(x), jnp.asarray(y)))
        assert abs(d - dw) <= m, (d, dw, m)


@pytest.mark.parametrize("chunk", [1, 3, 64, 1024])
def test_earlybreak_value_does_not_depend_on_the_chunk(chunk, monkeypatch):
    """The inner loop in chunks of B, the break checked after each: the same
    directed HD whatever the chunk (a row that breaks cannot raise the max)."""
    a, b = _clouds(11, 200, 150, 8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    monkeypatch.setattr(exact, "_EARLYBREAK_CHUNK", chunk)
    got = float(exact.directed_hd_earlybreak(ta, tb))
    monkeypatch.setattr(exact, "_EARLYBREAK_CHUNK", len(b))
    full = float(exact.directed_hd_earlybreak(ta, tb))
    np.testing.assert_allclose(got, full, rtol=1e-6)
    h = _h64(a, b, valid_b=np.ones(len(b), bool))
    d64 = float(np.sqrt(((a[:, None].astype(np.float64) - b[None]) ** 2).sum(-1)).min(1).max())
    assert abs(got - d64) <= _margin(a, b, h)


def test_earlybreak_conventions_on_empty_sides_and_identical_clouds():
    """An empty query side gives 0, an empty target side +inf (the
    reference's loop gives the same values where it runs; it cannot index
    an empty B), identical clouds 0."""
    a, _ = _clouds(2, 30, 1, 4)
    ta = torch.from_numpy(a)
    empty = torch.zeros((0, 4))
    assert float(exact.directed_hd_earlybreak(empty, ta)) == 0.0
    assert float(exact.directed_hd_earlybreak(ta, empty)) == float("inf")
    assert float(exact.hausdorff_earlybreak(ta, ta.flip(0))) == 0.0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("masked", [False, True], ids=["raw", "masked"])
def test_twosweep_matches_reference_fused_and_float64(shape, masked):
    a, b = _clouds(7 + sum(shape), *shape)
    va = vb = None
    if masked:
        rng = np.random.default_rng(sum(shape))
        va = rng.random(len(a)) < 0.7
        vb = rng.random(len(b)) < 0.7
        va[0] = vb[0] = True  # keep both sides non-empty; the empty side has its own test
    t = {k: (None if x is None else torch.from_numpy(x)) for k, x in (("a", a), ("b", b), ("va", va), ("vb", vb))}
    got = float(exact.hausdorff_twosweep_tiled(t["a"], t["b"], valid_a=t["va"], valid_b=t["vb"], block=64))
    j = {k: (None if x is None else jnp.asarray(x)) for k, x in (("va", va), ("vb", vb))}
    want = float(ref_exact.hausdorff_twosweep_tiled(jnp.asarray(a), jnp.asarray(b), valid_a=j["va"],
                                                    valid_b=j["vb"], block=64))
    fused = float(exact.hausdorff_fused_tiled(t["a"], t["b"], valid_a=t["va"], valid_b=t["vb"]))
    wrapper = float(ops.hausdorff_twosweep_tiled(t["a"], t["b"], valid_a=t["va"], valid_b=t["vb"]))
    h = _h64(a, b, va, vb)
    m = _margin(a, b, h)
    for name, x in (("port", got), ("reference", want), ("fused", fused), ("ops", wrapper)):
        assert abs(x - h) <= m, (name, x, h, m)
    assert abs(got - want) <= m and abs(got - fused) <= m and abs(got - wrapper) <= m


def test_twosweep_on_the_cpu_is_two_directed_tiled_sweeps():
    """``exact``'s version is two ``directed_hd_tiled`` sweeps; the kernel
    wrapper's, on CPU tensors, is kernel 1's plain version run directed
    twice (on the card, two launches of the directed instance)."""
    a, b = (torch.from_numpy(x) for x in _clouds(5, 70, 90, 6))
    want = torch.maximum(exact.directed_hd_tiled(a, b, block=32), exact.directed_hd_tiled(b, a, block=32))
    assert torch.equal(exact.hausdorff_twosweep_tiled(a, b, block=32), want)
    assert torch.equal(ops.hausdorff_twosweep_tiled(a, b),
                       torch.maximum(ops.directed_hausdorff(a, b), ops.directed_hausdorff(b, a)))


def test_twosweep_all_padded_side_follows_the_written_conventions():
    """One side all invalid: its directed HD is 0 (an empty query side), the
    other direction +inf (no target), so H = +inf — float64 and the
    reference agree."""
    a, b = _clouds(3, 12, 9, 3)
    vb = np.zeros(len(b), bool)
    got = float(exact.hausdorff_twosweep_tiled(torch.from_numpy(a), torch.from_numpy(b),
                                               valid_b=torch.from_numpy(vb)))
    want = float(ref_exact.hausdorff_twosweep_tiled(jnp.asarray(a), jnp.asarray(b), valid_b=jnp.asarray(vb)))
    assert got == want == _h64(a, b, valid_b=vb) == float("inf")


def test_baselines_are_exported_as_the_reference_exports_them():
    for name in ("directed_hd_earlybreak", "hausdorff_earlybreak", "hausdorff_twosweep_tiled"):
        assert name in exact.__all__ and name in ref_exact.__all__
    from repro_torch.hd import registry

    combos = registry.supported_combinations()
    assert combos and not any("earlybreak" in c[2] or "twosweep" in c[2] for c in combos)
