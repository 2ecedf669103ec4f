"""The port's flash attention (plain version on CPU tensors) and oracle held
to the JAX reference.

Same numpy inputs go through the reference's Pallas ``flash_attention``
(interpret mode, as ``tests/test_kernels.py`` runs it on the CPU), its
``attention_ref`` and ``models.layers.causal_attention``, and through the
port's ``repro_torch.kernels.flash_attention`` (``flash_attention`` runs
the plain version on CPU tensors; the CUDA kernel is checked by
``chip_smoke.py`` on the card).  The reference's kernel takes kv
pre-expanded to H heads, so for GQA it gets ``np.repeat``-expanded k/v
while the port takes the KV heads as they are.

Tolerances: fp32 ``atol 2e-5, rtol 1e-4`` (the reference's own,
``tests/test_kernels.py:115``); bf16 ``atol 3e-2`` against the reference
(``tests/test_kernels.py:124``) and ``2^-7·max|v|`` against float64 — one
rounding of p to bf16 (≤ 2^-8 relative, so ≤ 2^-8·max|v| on the weighted
average) plus the output's rounding to bf16 (≤ 2^-8·max|v|).  The last
tests hold ``chip_smoke.py``'s tighter per-entry bound for the card
against other kv chunks, against an emulation of the tensor-core kernel's
arithmetic and against emulated kernel faults.  The routing tests pin
which kernel each dtype takes (``flash.route``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.flash import flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as ref_attention  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.kernels.flash_attention import flash as F  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

# The shapes of tests/test_kernels.py:96-101: (b, sq, sk, h, hd, block_q, block_k).
FLASH_SHAPES = [
    (2, 128, 128, 4, 64, 64, 64),
    (1, 256, 256, 2, 128, 128, 64),
    (2, 64, 64, 1, 32, 32, 32),
    (1, 512, 512, 2, 64, 128, 128),
]
ATOL, RTOL = 2e-5, 1e-4


def _qkv(seed, b, sq, sk, h, kv, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd)).astype(dtype)
    k = rng.standard_normal((b, sk, kv, hd)).astype(dtype)
    v = rng.standard_normal((b, sk, kv, hd)).astype(dtype)
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _ref_flash(q, k, v, causal, bq, bk):
    groups = q.shape[2] // k.shape[2]
    kx, vx = np.repeat(k, groups, axis=2), np.repeat(v, groups, axis=2)
    return np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(kx), jnp.asarray(vx), causal=causal,
                                block_q=bq, block_k=bk))


def _f64(q, k, v, causal):
    return attention_ref(*(torch.from_numpy(np.asarray(x, np.float64)) for x in (q, k, v)),
                         causal=causal).numpy()


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_matches_reference(shape, causal):
    b, sq, sk, h, hd, bq, bk = shape
    q, k, v = _qkv(sq + h, b, sq, sk, h, h, hd)
    got = F.flash_attention(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, _ref_flash(q, k, v, causal, bq, bk), atol=ATOL, rtol=RTOL)
    want = np.asarray(ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_attention_ref_matches_reference(causal):
    q, k, v = _qkv(7, 2, 96, 96, 4, 4, 32)
    got = attention_ref(*_t(q, k, v), causal=causal).numpy()
    want = np.asarray(ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_flash_attention_bf16():
    x = np.random.default_rng(0).standard_normal((2, 128, 2, 64)).astype(jnp.bfloat16)
    q =torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    got = F.flash_attention(q, q, q).float().numpy()
    want = np.asarray(ref_flash(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x), block_q=64, block_k=64),
                      np.float32)
    np.testing.assert_allclose(got, want, atol=3e-2)
    x32 = x.astype(np.float32)
    tol = 2.0 ** -7 * np.abs(x32).max()
    assert np.abs(got - _f64(x32, x32, x32, True)).max() <= tol


@pytest.mark.parametrize("groups", [2, 8])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_gqa_reads_kv_head_h_over_groups(groups, causal):
    """Query head h reads kv head h // groups — what the reference's
    jnp.repeat expansion holds (h % KV would pass at groups 1 only)."""
    q, k, v = _qkv(groups, 1, 64, 64, 8, 8 // groups, 64)
    got = F.flash_attention(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, _ref_flash(q, k, v, causal, 32, 16), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window,offset", [(None, 0), (24, 0), (None, 32)],
                         ids=["full", "window24", "offset32"])
def test_causal_attention_matches_reference_layers(window, offset):
    """layers.causal_attention on CPU tensors: the plain chunked recurrence,
    GQA 2:1, chunk 16, with the reference's window and query offset."""
    q, k, v = _qkv(11, 2, 64 - offset, 64, 4, 2, 16)
    spec = L.AttnSpec(4, 2, 16, 16, window)
    got = L.causal_attention(*_t(q, k, v), spec, q_offset=offset).numpy()
    ref_spec = ref_layers.AttnSpec(4, 2, 16, 16, window)
    want = np.asarray(ref_layers.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                  ref_spec, q_offset=offset))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("sq,sk,h,kv,hd", [(333, 333, 4, 2, 64), (1, 333, 2, 2, 80),
                                           (333, 1, 8, 1, 64), (65, 129, 2, 1, 128)], ids=str)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ragged_shapes_against_float64(sq, sk, h, kv, hd, causal):
    """Shapes that divide no tile (the kernel masks their edges); the plain
    version against the float64 oracle."""
    q, k, v = _qkv(sq + sk, 2, sq, sk, h, kv, hd)
    got = F.flash_attention(*_t(q, k, v), causal=causal).numpy()
    want = _f64(q, k, v, causal)
    assert got.shape == (2, sq, h, hd)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_plain_version_chunk_independence():
    q, k, v = _qkv(3, 1, 256, 256, 4, 2, 64)
    outs = [F.flash_attention_plain(*_t(q, k, v), chunk=c).numpy() for c in (16, 64, 256)]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=ATOL, rtol=RTOL)


def test_plain_version_keeps_the_reference_chunk_assertion():
    q, k, v = _t(*_qkv(0, 1, 8, 24, 2, 2, 64))
    with pytest.raises(ValueError, match="divisible"):
        F.flash_attention_plain(q, k, v, chunk=16)
    with pytest.raises(ValueError, match="causal"):
        F.flash_attention_plain(q, k, v, causal=False, window=4)


def test_launcher_rejects_cpu_tensors():
    q, k, v = _t(*_qkv(0, 1, 8, 8, 2, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        F.flash_fwd(q, k, v, torch.empty_like(q))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_launcher_rejects_cpu_tensors_of_either_route_and_counts_nothing(dtype):
    q, k, v = (x.to(dtype) for x in _t(*_qkv(0, 1, 8, 8, 2, 2, 64)))
    before = (F.flash_fwd.launches, dict(F.flash_fwd.route_launches))
    with pytest.raises(ValueError, match="CUDA"):
        F.flash_fwd(q, k, v, torch.empty_like(q))
    assert (F.flash_fwd.launches, F.flash_fwd.route_launches) == before


def test_wrapper_on_cpu_runs_the_plain_version_and_never_launches():
    q, k, v = _t(*_qkv(1, 1, 64, 64, 4, 2, 64))
    before = F.flash_fwd.launches
    got = F.flash_attention(q, k, v)
    assert F.flash_fwd.launches == before
    torch.testing.assert_close(got, F.flash_attention_plain(q, k, v), atol=0, rtol=0)


@pytest.mark.parametrize("hd", F.HEAD_DIMS)
def test_route_sends_bf16_to_the_tensor_cores_and_fp32_to_the_cuda_cores(hd):
    assert F.route(torch.bfloat16, hd) == "wgmma"
    assert F.route(torch.float32, hd) == "ffma"
    assert F.ROUTES["wgmma"] == F.SOURCE_SM90 and F.ROUTES["ffma"] == F.SOURCE
    assert F.SOURCE_SM90.is_file() and F.SOURCE.is_file()


@pytest.mark.parametrize("dtype,hd", [(torch.float16, 64), (torch.float64, 64), (torch.bfloat16, 32),
                                      (torch.float32, 96), (torch.bfloat16, 256)], ids=str)
def test_route_raises_on_other_dtypes_and_head_dims(dtype, hd):
    with pytest.raises(ValueError, match="head_dim|float32 or bfloat16"):
        F.route(dtype, hd)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_wrapper_on_cpu_leaves_every_route_counter_at_zero(dtype):
    q, k, v = (x.to(dtype) for x in _t(*_qkv(2, 1, 64, 64, 4, 2, 64)))
    saved = dict(F.flash_fwd.route_launches)
    try:
        for r in F.flash_fwd.route_launches:
            F.flash_fwd.route_launches[r] = 0
        F.flash_attention(q, k, v)
        L.causal_attention(q, k, v, L.AttnSpec(4, 2, 64, 16, None))
        assert F.flash_fwd.route_launches == dict.fromkeys(F.ROUTES, 0)
    finally:
        F.flash_fwd.route_launches.update(saved)


def test_causal_attention_off_the_kernel_path_raises_off_cpu():
    """A window or an offset has no kernel yet: off the CPU it raises
    instead of falling back (meta tensors stand in for CUDA ones)."""
    q = torch.empty((1, 8, 4, 64), device="meta")
    k = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        L.causal_attention(q, k, k, L.AttnSpec(4, 2, 64, 16, 4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        L.causal_attention(q, k, k, L.AttnSpec(4, 2, 64, 16, None), q_offset=8)


def _load_script(name: str, rel: str):
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parents[1] / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_planted_faults_each_hit_the_kernel_source_once():
    faults = _load_script("flash_planted_faults", "scripts/flash_planted_faults.py")
    text = F.SOURCE_SM90.read_text()
    assert len(faults.FAULTS) == 7
    assert faults.CAUSAL_ONLY <= set(faults.FAULTS)
    for name, (old, new) in faults.FAULTS.items():
        assert text.count(old) == 1 and new != old, name


def _tensor_core_arithmetic(q, k, v, causal, tile):
    """The wgmma kernel's arithmetic, emulated: scores as fp32 sums of the
    exact bf16 products in another order (float64, rounded once), key tiles
    of ``tile`` (128; 64 at hd 128), the running max in log2 units with the scale and log2(e) folded
    into one multiply-add ahead of exp2, masked keys at −inf, l over the
    fp32 p, p rounded to bf16 against the tile's own running max."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    kx, vx = F.expand_kv(k, h // k.shape[2]), F.expand_kv(v, h // k.shape[2])
    raw = torch.einsum("bqhd,bkhd->bhqk", q.double(), kx.double()).float()
    c = torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32) * torch.tensor(1.4426950408889634,
                                                                         dtype=torch.float32)
    m = torch.full((b, h, sq), F.NEG)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, hd))
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, tile):
        s = raw[..., k0:k0 + tile]
        if causal:
            s = torch.where(k0 + torch.arange(s.shape[-1])[None, :] > rows, -torch.inf, s)
        m_new = torch.maximum(m, s.amax(-1) * c)
        corr = torch.exp2(m - m_new)
        p = torch.exp2((s.double() * c.double() - m_new.double()[..., None]).float())
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(),
                                                   vx[:, k0:k0 + tile].float())
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("hd,tile", [(64, 128), (128, 64)], ids=["hd64", "hd128"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_smoke_tolerance_takes_the_tensor_core_arithmetic(causal, hd, tile):
    """chip_smoke's per-entry bf16 bound holds the wgmma kernel's arithmetic
    (other summation order, its key tiles, exp2 with the folded scale, −inf
    masks) against the plain version at chunks 64 and 512 and against
    float64 — the derivation's premises, checked on the CPU."""
    smoke = _load_script("chip_smoke", "chip_smoke.py")
    q, k, v = (x.to(torch.bfloat16) for x in _t(*_qkv(5, 1, 1024, 1024, 4, 2, hd)))
    got = _tensor_core_arithmetic(q, k, v, causal, tile)
    abs_v = smoke.weighted_abs_v(q, k, v, causal=causal)
    for c in (64, 512):
        e = smoke.flash_error(got, F.flash_attention_plain(q, k, v, causal=causal, chunk=c), abs_v)
        assert e["max_ratio"] <= 1, (c, e)
    want = attention_ref(q.double(), k.double(), v.double(), causal=causal)
    assert smoke.flash_error(got, want, abs_v, exact=True)["max_ratio"] <= 1


def test_smoke_tolerance_takes_other_chunks_and_rejects_wrong_kv_heads_and_dropped_tiles():
    """chip_smoke's per-entry bf16 bound: the plain version at other kv
    chunks (p rounded against other running maxima) stays inside it; a kv
    head read as h % KV, or a dropped last key tile, does not."""
    smoke = _load_script("chip_smoke", "chip_smoke.py")
    q, k, v = (x.to(torch.bfloat16) for x in _t(*_qkv(7, 2, 256, 256, 8, 2, 64)))
    for causal in (True, False):
        abs_v = smoke.weighted_abs_v(q, k, v, causal=causal)
        want = F.flash_attention_plain(q, k, v, causal=causal, chunk=64)
        for c in (16, 32, 128, 256):
            got = F.flash_attention_plain(q, k, v, causal=causal, chunk=c)
            assert smoke.flash_error(got, want, abs_v)["max_ratio"] <= 1, (causal, c)
        wrong_head = F.flash_attention_plain(q, k.repeat(1, 1, 4, 1), v.repeat(1, 1, 4, 1),
                                             causal=causal, chunk=64)
        assert smoke.flash_error(wrong_head, want, abs_v)["max_ratio"] > 1, causal
    dropped = F.flash_attention_plain(q, k[:, :192], v[:, :192], causal=False, chunk=64)
    err = smoke.flash_error(dropped, F.flash_attention_plain(q, k, v, causal=False, chunk=64),
                            smoke.weighted_abs_v(q, k, v, causal=False))
    assert err["max_ratio"] > 1 and err["n_over"] > 0
