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
which kernel each dtype takes (``flash.route``) for every head dim from 1
to 256, and the instance head dim the launcher pads to.  Head dims off the
kernels' instances (24, 40, 96), sliding windows and query offsets (a
continued prefill with Sk > Sq, and q_offset ≥ Sk, where rows may see no
key at all) are held to the reference's ``causal_attention`` at the fp32
tolerance above.
"""
import itertools

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


@pytest.mark.parametrize("hd", [1, 16, 40, 64, 80, 96, 128, 200, 256])
def test_route_sends_bf16_to_the_tensor_cores_and_fp32_to_the_cuda_cores(hd):
    assert F.route(torch.bfloat16, hd) == "wgmma"
    assert F.route(torch.float32, hd) == "ffma"
    assert F.ROUTES["wgmma"] == F.SOURCE_SM90 and F.ROUTES["ffma"] == F.SOURCE
    assert F.SOURCE_SM90.is_file() and F.SOURCE.is_file()


@pytest.mark.parametrize("dtype,hd", [(torch.float16, 64), (torch.float64, 64), (torch.bfloat16, 0),
                                      (torch.float32, 257), (torch.bfloat16, 512)], ids=str)
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
    """A window and an offset take the kernel: off the CPU the call reaches
    the launcher, which refuses anything but a CUDA tensor, and never falls
    back to the plain version (meta tensors stand in for CUDA ones)."""
    q = torch.empty((1, 8, 4, 64), device="meta")
    k = torch.empty((1, 8, 2, 64), device="meta")
    before = F.flash_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        L.causal_attention(q, k, k, L.AttnSpec(4, 2, 64, 16, 4))
    with pytest.raises(ValueError, match="CUDA"):
        L.causal_attention(q, k, k, L.AttnSpec(4, 2, 64, 16, None), q_offset=8)
    assert F.flash_fwd.launches == before


def _load_script(name: str, rel: str):
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parents[1] / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_planted_faults_each_hit_the_kernel_source_once():
    """Each fault text occurs once in the source; the block-order fault also
    runs at a case of chip_smoke's phase 13, which spans several groups."""
    faults = _load_script("flash_planted_faults", "scripts/flash_planted_faults.py")
    smoke = _load_script("chip_smoke", "chip_smoke.py")
    text = F.SOURCE_SM90.read_text()
    assert len(faults.FAULTS) == 8
    assert faults.CAUSAL_ONLY <= set(faults.FAULTS)
    for name, (old, new) in faults.FAULTS.items():
        assert text.count(old) == 1 and new != old, name
    assert set(faults.ORDER_FAULTS) <= set(faults.FAULTS)
    assert faults.ORDER_CASE in smoke.FLASH_CASES
    b, _, sk, _, kv, hd, dtype, _ = faults.ORDER_CASE
    assert dtype == "bfloat16" and b * kv % F.kv_group(b, sk, kv, hd, 50 * 2 ** 20) != 0  # groups of two sizes


def test_lever_variants_each_hit_the_kernel_source_once():
    """scripts/flash_levers.py undoes one design choice per variant: each of
    its texts occurs once in its route's source and changes it (the bf16
    route's ``VARIANTS`` in flash_fwd_sm90.cu, the fp32 route's
    ``FP32_VARIANTS`` in flash_fwd.cu)."""
    levers = _load_script("flash_levers", "scripts/flash_levers.py")
    assert set(levers.VARIANTS) == {"two_stages", "key_tiles_64", "trap_in_consumers"}
    assert set(levers.FP32_VARIANTS) == {"mask_every_tile", "one_stage", "expf_separate_scale"}
    for variants, source in ((levers.VARIANTS, F.SOURCE_SM90), (levers.FP32_VARIANTS, F.SOURCE)):
        text = source.read_text()
        for name, reps in variants.items():
            for old, new in reps:
                assert text.count(old) == 1 and new != old, name


def test_parent_ab_script_finds_the_group_in_this_entry_point():
    """scripts/flash_parent_ab.py loads, and the text by which it tells an
    entry point that takes the block order's group stands in this source."""
    _load_script("flash_parent_ab", "scripts/flash_parent_ab.py")
    assert F.SOURCE_SM90.read_text().count("int group, void* stream") == 1


def test_span_faults_each_hit_the_offset_and_window_instance_once():
    """The planted faults of the instance for offsets and windows: each text
    occurs once in the source, each fault names the cases it must fail, and
    those cases hold an offset or a window (the instance they reach)."""
    faults = _load_script("flash_planted_faults", "scripts/flash_planted_faults.py")
    text = F.SOURCE_SM90.read_text()
    assert len(faults.SPAN_FAULTS) == 3
    for name, (old, new, cases) in faults.SPAN_FAULTS.items():
        assert text.count(old) == 1 and new != old, name
        assert cases and set(cases) <= set(faults.SPAN_CASES), name
    for case, (*_, q_offset, window) in faults.SPAN_CASES.items():
        assert q_offset != 0 or window is not None, case


def test_fp32_planted_faults_each_hit_the_fp32_source_once():
    """The planted faults of the fp32 route: each text occurs once in
    flash_fwd.cu and changes it; each reaches some fp32 case of chip_smoke's
    phase 13 (the cases the script runs), and every case is reached by
    some fault."""
    faults = _load_script("flash_planted_faults", "scripts/flash_planted_faults.py")
    smoke = _load_script("chip_smoke", "chip_smoke.py")
    text = F.SOURCE.read_text()
    assert set(faults.FP32_FAULTS) == {"skip_middle_tile", "no_rescale_acc", "kv_head_mod",
                                       "interior_one_tile_too_far", "stage_read_early"}
    for name, (old, new) in faults.FP32_FAULTS.items():
        assert text.count(old) == 1 and new != old, name
    cases = faults.fp32_cases(smoke.FLASH_CASES)
    assert cases and all(c[6] == "float32" for c in cases)
    reach = {name: [faults.fp32_reaches(name, c) for c in cases] for name in faults.FP32_FAULTS}
    assert all(any(r) for r in reach.values()), reach
    assert all(any(r[i] for r in reach.values()) for i in range(len(cases)))
    # the kv-head fault needs 1 < KV < H; the unmasked diagonal needs the mask or a ragged Sk
    assert not faults.fp32_reaches("kv_head_mod", (1, 8, 8, 4, 4, 64, "float32", True))
    assert not faults.fp32_reaches("interior_one_tile_too_far", (1, 128, 128, 4, 4, 64, "float32", False))
    assert faults.fp32_reaches("interior_one_tile_too_far", (1, 128, 100, 4, 4, 64, "float32", False))


MASKED = -(2.0 ** 99)  # the kernels' masked raw score (flash_fwd_sm90.cu, flash_fwd.cu)
INT_MAX = 2 ** 31 - 1


def _key_tiles(q0, rows, sq, sk, bn, q_offset, window, causal):
    """``key_tiles`` of csrc/flash_mask.cuh: (first tile, tile count) that the
    query rows q0 .. min(q0 + rows, sq) − 1 walk."""
    n = -(-sk // bn)
    if not causal:
        return 0, n
    p_lo, p_hi = q_offset + q0, q_offset + min(q0 + rows, sq) - 1
    if p_lo < 0 or window <= 0 or p_hi - window + 1 > sk - 1:
        return 0, n
    first = max(0, p_lo - window + 1) // bn
    return first, min(p_hi, sk - 1) // bn - first + 1


def _tile_needs_mask(k0, bn, p_lo, p_hi, sk, window, causal):
    """``tile_needs_mask`` of csrc/flash_mask.cuh: whether the key tile k0 ..
    k0 + bn − 1 needs a per-element mask for the rows at positions p_lo ..
    p_hi."""
    if k0 + bn > sk:
        return True
    return bool(causal) and (k0 + bn - 1 > p_lo or p_hi - k0 >= window)


def _ffma_tiles(inst):
    """``Shape<HD>`` of csrc/flash_fwd.cu at instance ``inst``: (query rows
    per warp, warps per CTA, keys per tile)."""
    return 16, 4, (64 if inst <= 64 else 32)


def test_ffma_tiles_mirror_the_kernel_source_and_the_launcher():
    """The Python mirrors of the fp32 kernel's tile shapes (this file's and
    the planted-fault script's) match the source's ``Shape`` and
    ``flash._block_rows``."""
    text = F.SOURCE.read_text()
    assert "constexpr int W = 4; " in text and "constexpr int WR = 16; " in text
    assert "static constexpr int BK = HD <= 64 ? 64 : 32, DS = HD == 128 ? 2 : 1;" in text
    faults = _load_script("flash_planted_faults", "scripts/flash_planted_faults.py")
    for inst in F.INSTANCES["ffma"]:
        wr, warps, bk = _ffma_tiles(inst)
        assert faults.fp32_tiles(inst) == (wr * warps, wr, bk)
        assert F._block_rows("ffma", inst) == wr * warps


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_tile_classification_is_exact_per_element(causal):
    """The fp32 kernel's interior tiles: for every warp's rows of every
    query block and every key tile, a tile takes no mask exactly when every
    one of those rows sees every key of it and it ends at or before Sk
    (per-element ``visible`` over a grid of (Sq, Sk, q_offset, window));
    ``key_tiles`` walks every tile that some row sees a key of."""
    for sq, sk, off, window, bn, wr in itertools.product(
            (1, 17, 100, 130), (1, 33, 64, 100, 200), (0, 5, 64, 150, 300),
            (INT_MAX, 1, 7, 40, 64, 100), (32, 64), (16, 32)):
        if not causal and (off or window != INT_MAX):
            continue
        pos = off + np.arange(sq)[:, None]
        col = np.arange(-(-sk // bn) * bn)[None, :]
        vis = (col <= pos) & (pos - col < window) if causal else np.ones((sq, 1), bool)
        seen = (col < sk) & vis
        bq = 4 * wr
        for q0 in range(0, sq, bq):
            first, count = _key_tiles(q0, bq, sq, sk, bn, off, window, causal)
            block = seen[q0:q0 + bq]
            sees = block.reshape(block.shape[0], -1, bn).any(axis=(0, 2))
            assert all(first <= t < first + count for t in np.flatnonzero(sees)), (sq, sk, off, window, q0)
            for w0 in range(q0, min(q0 + bq, sq), wr):
                rows = seen[w0:min(w0 + wr, sq)]
                p_lo, p_hi = off + w0, off + min(w0 + wr, sq) - 1
                for kt in range(-(-sk // bn)):
                    interior = bool(rows[:, kt * bn:(kt + 1) * bn].all())
                    assert _tile_needs_mask(kt * bn, bn, p_lo, p_hi, sk, window, causal) == (not interior), \
                        (sq, sk, off, window, bn, wr, w0, kt)


def _ffma_arithmetic(q, k, v, causal, *, q_offset=0, window=None):
    """The fp32 kernel's arithmetic, emulated: query blocks of the
    instance's rows and, per block, only the key tiles ``key_tiles`` walks;
    per warp of rows the per-element mask only on the tiles
    ``tile_needs_mask`` names (MASKED for hidden keys, no weight past Sk);
    the running max in log2 units, c = fp32(scale)·fp32(log2 e) rounded
    once, m = max(m, rowmax(raw)·c), p = ex2 of one FMA raw·c − m; l and
    acc rescaled by corr each tile and acc += p·V in fp32."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    inst = F.instance("ffma", hd)
    wr, warps, bk = _ffma_tiles(inst)
    win = INT_MAX if window is None else max(window, 0)
    kx, vx = F.expand_kv(k, h // k.shape[2]), F.expand_kv(v, h // k.shape[2])
    raw = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx.float())
    c = (torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32) * torch.tensor(1.4426950408889634,
                                                                          dtype=torch.float32)).double()
    out = torch.empty((b, h, sq, hd))
    for q0 in range(0, sq, wr * warps):
        first, count = _key_tiles(q0, wr * warps, sq, sk, bk, q_offset, win, causal)
        for w0 in range(q0, min(q0 + wr * warps, sq), wr):
            rows = slice(w0, min(w0 + wr, sq))
            pos = q_offset + torch.arange(w0, rows.stop)[:, None]
            m = torch.full((b, h, rows.stop - w0), -torch.inf)
            l = torch.zeros((b, h, rows.stop - w0))
            acc = torch.zeros((b, h, rows.stop - w0, hd))
            for k0 in range(first * bk, (first + count) * bk, bk):
                s = raw[..., rows, k0:k0 + bk]  # keys past Sk are absent: no weight
                if causal and _tile_needs_mask(k0, bk, q_offset + w0, q_offset + rows.stop - 1, sk, win, causal):
                    col = k0 + torch.arange(s.shape[-1])[None, :]
                    s = torch.where((col <= pos) & (pos - col < win), s, MASKED)
                m_new = torch.maximum(m, (s.amax(-1).double() * c).float())
                corr = torch.exp2(m - m_new)
                p = torch.exp2((s.double() * c - m_new.double()[..., None]).float())
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vx[:, k0:k0 + bk].float())
                m = m_new
            out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("case", [(512, 512, 0, None, True), (512, 512, 0, None, False),
                                  (512, 512, 0, 100, True), (256, 1024, 768, None, True),
                                  (128, 512, 480, 50, True)],
                         ids=["causal", "full", "window100", "continued", "rows_seeing_no_key"])
def test_smoke_tolerance_takes_the_fp32_kernel_arithmetic(hd, case):
    """chip_smoke's per-entry fp32 bound (the premise of phases 13-15 and of
    the fp32 prefill's held calls) holds the fp32 kernel's emulated
    arithmetic — its block and key tiles, exp2 with the folded scale, masks
    on edge tiles only — against the plain version at chunks 64 and 512 and
    against float64, rows that see no key included."""
    smoke = _load_script("chip_smoke", "chip_smoke.py")
    sq, sk, off, window, causal = case
    q, k, v = _t(*_qkv(hd + sq + off, 1, sq, sk, 4, 2, hd))
    mask = {"q_offset": off, "window": window}
    got = _ffma_arithmetic(q, k, v, causal, **mask)
    abs_v = smoke.weighted_abs_v(q, k, v, causal=causal, **mask)
    for chunk in (64, 512):
        e = smoke.flash_error(got, F.flash_attention_plain(q, k, v, causal=causal, chunk=chunk, **mask), abs_v)
        assert e["max_ratio"] <= 1, (chunk, e)
    want = F.flash_attention_plain(q.double(), k.double(), v.double(), causal=causal, chunk=sk, **mask)
    assert smoke.flash_error(got, want, abs_v, exact=True)["max_ratio"] <= 1
    if window is not None and off + sq - window > sk - 1:  # the last row sees no key: the mean of v
        torch.testing.assert_close(got[:, -1], v.mean(dim=1).repeat_interleave(2, dim=1), atol=ATOL, rtol=RTOL)


def _tensor_core_arithmetic(q, k, v, causal, tile, *, q_offset=0, window=None, block=128):
    """The wgmma kernel's arithmetic, emulated: scores as fp32 sums of the
    exact bf16 products in another order (float64, rounded once), per query
    block of ``block`` rows only the key tiles of ``tile`` keys (128; 64 at
    hd > 128) that ``key_tiles`` walks, the running max in log2 units with the
    scale and log2(e) folded into one multiply-add ahead of exp2, hidden keys
    at MASKED with an offset or a window (−inf without), keys past Sk at
    −inf, l over the fp32 p, p rounded to bf16 against the tile's own
    running max."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    win = INT_MAX if window is None else max(window, 0)
    hidden = MASKED if q_offset != 0 or window is not None else -torch.inf
    kx, vx = F.expand_kv(k, h // k.shape[2]), F.expand_kv(v, h // k.shape[2])
    raw = torch.einsum("bqhd,bkhd->bhqk", q.double(), kx.double()).float()
    c = torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32) * torch.tensor(1.4426950408889634,
                                                                         dtype=torch.float32)
    out = torch.empty((b, h, sq, hd))
    for q0 in range(0, sq, block):
        rows = slice(q0, min(q0 + block, sq))
        pos = q_offset + torch.arange(q0, rows.stop)[:, None]
        m = torch.full((b, h, rows.stop - q0), F.NEG)
        l = torch.zeros((b, h, rows.stop - q0))
        acc = torch.zeros((b, h, rows.stop - q0, hd))
        first, count = _key_tiles(q0, block, sq, sk, tile, q_offset, win, causal)
        for k0 in range(first * tile, (first + count) * tile, tile):
            s = raw[..., rows, k0:k0 + tile]
            if causal:
                col = k0 + torch.arange(s.shape[-1])[None, :]
                s = torch.where((col <= pos) & (pos - col < win), s, hidden)
            m_new = torch.maximum(m, s.amax(-1) * c)
            corr = torch.exp2(m - m_new)
            p = torch.exp2((s.double() * c.double() - m_new.double()[..., None]).float())
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(),
                                                       vx[:, k0:k0 + tile].float())
            m = m_new
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("hd,tile", [(64, 128), (128, 128)], ids=["hd64", "hd128"])
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


# --- every head dim, sliding windows, query offsets --------------------------

# (sq, sk, q_offset, window): a causal prefill with a window, a continued
# prefill (Sk > Sq, the queries the last Sq positions), rows past the keys
# (q_offset ≥ Sk: every row sees all Sk keys), and the same with a window
# short enough that the last rows see no key at all (the reference's
# −1e30 then gives every key p = 1: the mean of v).
MASK_CASES = [(32, 32, 0, 5), (16, 48, 32, None), (16, 48, 32, 7), (8, 32, 40, None), (8, 32, 40, 12)]
MASK_IDS = ["window5", "continued", "continued_window7", "offset_past_sk", "offset_past_sk_empty_rows"]


@pytest.mark.parametrize("hd", [16, 24, 40, 96, 256])
@pytest.mark.parametrize("case", MASK_CASES, ids=MASK_IDS)
def test_every_head_dim_window_and_offset_match_reference_layers(hd, case):
    """layers.causal_attention and flash_attention_plain on CPU tensors
    against the reference's layers.causal_attention, GQA 2:1, kv chunk 16."""
    sq, sk, off, window = case
    q, k, v = _qkv(hd + sq + off, 2, sq, sk, 4, 2, hd)
    ref_spec = ref_layers.AttnSpec(4, 2, hd, 16, window)
    want = np.asarray(ref_layers.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                  ref_spec, q_offset=off))
    got = L.causal_attention(*_t(q, k, v), L.AttnSpec(4, 2, hd, 16, window), q_offset=off).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    plain = F.flash_attention_plain(*_t(q, k, v), chunk=sk, q_offset=off, window=window).numpy()
    np.testing.assert_allclose(plain, want, atol=ATOL, rtol=RTOL)


def test_rows_that_see_no_key_get_the_mean_of_v():
    """The reference's convention for a row whose every key is masked: all
    scores sit at −1e30, so each key gets p = 1 and the row is the mean of v
    (the kernels reproduce it; here the plain version, on its own inputs)."""
    q, k, v = _t(*_qkv(3, 1, 4, 32, 2, 2, 16))
    got = F.flash_attention_plain(q, k, v, chunk=16, q_offset=40, window=5)  # positions 40-43 see no key
    torch.testing.assert_close(got, v.mean(dim=1, keepdim=True).expand_as(got), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hd", [16, 24, 40, 96, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_every_head_dim_matches_the_pallas_kernel(hd, causal):
    """The reference's Pallas kernel in interpret mode (causal or full, no
    offset, no window) against the port's wrapper on CPU tensors."""
    q, k, v = _qkv(hd, 1, 64, 64, 2, 1, hd)
    got = F.flash_attention(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, _ref_flash(q, k, v, causal, 32, 32), atol=ATOL, rtol=RTOL)


def test_route_raises_for_no_head_dim_from_1_to_256():
    for dtype, which in ((torch.bfloat16, "wgmma"), (torch.float32, "ffma")):
        for hd in range(1, F.MAX_HEAD_DIM + 1):
            assert F.route(dtype, hd) == which
            inst = F.instance(which, hd)
            assert hd <= inst <= F.MAX_HEAD_DIM and inst in F.INSTANCES[which]
            assert all(i < hd for i in F.INSTANCES[which] if i < inst)  # the smallest that fits


@pytest.mark.parametrize("which", ["wgmma", "ffma"])
def test_instances_cover_the_models_and_fit_the_kernels(which):
    """Every instance is a multiple of 16 (whole 16-byte rows for TMA and the
    float4 loads), the models' head dims 16, 64, 80 and 128 are instances
    (no padding on their path), and the bf16 kernel's tile type admits each
    (64·a + 16·b, b ≤ 1)."""
    inst = F.INSTANCES[which]
    assert inst == tuple(sorted(inst)) and inst[-1] == F.MAX_HEAD_DIM
    assert all(i % 16 == 0 for i in inst)
    assert {16, 64, 80, 128} <= set(inst)
    if which == "wgmma":
        assert all(i % 64 in (0, 16) for i in inst)


def test_window_needs_the_causal_mask_and_offsets_fit_int32():
    q, k, v = _t(*_qkv(0, 1, 8, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="causal"):
        F._mask_args(False, 0, 4, 8, 8)
    with pytest.raises(ValueError, match="int32"):
        F._mask_args(True, 2 ** 31, None, 8, 8)
    assert F._mask_args(True, 3, None, 8, 8) == (3, 2 ** 31 - 1)
    assert F._mask_args(True, 0, -5, 8, 8) == (0, 0)  # sees no key, as window 0
    with pytest.raises(ValueError, match="causal"):
        F.flash_attention(q, k, v, causal=False, window=4)


@pytest.mark.parametrize("hd,tile,block", [(64, 128, 128), (256, 64, 64)], ids=["hd64", "hd256"])
@pytest.mark.parametrize("case", [(512, 512, 0, 100), (256, 768, 512, 300), (128, 300, 400, None),
                                  (128, 300, 400, 120)],
                         ids=["window100", "continued_window300", "offset_past_sk", "offset_empty_rows"])
def test_smoke_tolerance_takes_the_windowed_tensor_core_arithmetic(hd, tile, block, case):
    """The wgmma kernel's masking with a window and an offset, emulated
    (only the key tiles key_tiles walks, MASKED for hidden keys, −inf past
    Sk): held by chip_smoke's bf16 bound to the plain version at chunk 64
    and to the plain version in float64, rows that see no key included."""
    smoke = _load_script("chip_smoke", "chip_smoke.py")
    sq, sk, off, window = case
    q, k, v = (x.to(torch.bfloat16) for x in _t(*_qkv(hd + sq, 1, sq, sk, 4, 2, hd)))
    got = _tensor_core_arithmetic(q, k, v, True, tile, q_offset=off, window=window, block=block)
    abs_v = smoke.weighted_abs_v(q, k, v, causal=True, q_offset=off, window=window)
    want = F.flash_attention_plain(q, k, v, chunk=64 if sk % 64 == 0 else sk, q_offset=off, window=window)
    assert smoke.flash_error(got, want, abs_v)["max_ratio"] <= 1
    want64 = F.flash_attention_plain(q.double(), k.double(), v.double(), chunk=sk, q_offset=off, window=window)
    assert smoke.flash_error(got, want64, abs_v, exact=True)["max_ratio"] <= 1


# --- the block order of the wgmma kernel -------------------------------------


def _block_order(i, b, h, kv, n_qb, group):
    """csrc/flash_fwd_sm90.cu's map of the linear block index ``i`` to (batch,
    query head, query block): the b·kv (batch, kv head) pairs in
    ceil(b·kv / group) groups of at most ``group``, the first b·kv % n_groups
    of them one pair larger, each with all its query heads; within a group
    the heaviest causal query block of every head first."""
    g_heads = h // kv
    n_groups = -(-b * kv // group)
    small, n_big = divmod(b * kv, n_groups)
    big = i < n_big * (small + 1) * g_heads * n_qb
    pairs = small + 1 if big else small
    in_group = pairs * g_heads * n_qb
    rest = i if big else i - n_big * (small + 1) * g_heads * n_qb
    first = (0 if big else n_big * (small + 1)) + rest // in_group * pairs
    r = rest % in_group
    heads = pairs * g_heads
    qb = n_qb - 1 - r // heads
    bh = first * g_heads + r % heads
    return bh // h, bh % h, qb


L2 = 50 * 2 ** 20  # the H100's L2


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,l2", [
    (2, 4000, 4000, 13, 13, 128, L2),  # MHA, groups of 9, 9 and 8 (phase 13's case)
    (8, 4096, 4096, 16, 16, 128, L2),  # OLMoE-1B-7B's heads: 128 pairs in 11 groups of 11-12
    (8, 4096, 4096, 48, 8, 128, L2),  # Grok-1's: GQA 6, 64 pairs
    (1, 8192, 8192, 64, 8, 128, L2),  # DeepSeek-67B's: 8 pairs of 4 MiB, groups of 4
    (3, 333, 333, 10, 5, 64, 800_000),  # a small L2: 15 pairs in groups of 4, 4, 4, 3; Sq ragged
    (2, 129, 70_000, 4, 1, 256, L2),  # one pair's K and V (72 MB) past the share: groups of 1
    (1, 1, 1000, 8, 4, 80, L2),  # one query row, one query block
    (1, 300, 300, 4, 4, 16, 1),  # no L2 to speak of: a pair to a group
], ids=str)
def test_block_order_is_a_bijection_heaviest_first_within_l2_groups(b, sq, sk, h, kv, hd, l2):
    """The kernel's block order over ragged grids: every (batch, head, query
    block) once; within a group every head's heaviest causal block first;
    a group holds whole kv heads (GQA query heads stay with theirs) whose K
    and V fit ``flash.L2_SHARE`` of the L2, or a single (batch, kv head)."""
    inst = F.instance("wgmma", hd)
    n_qb = -(-sq // F._block_rows("wgmma", hd))
    group = F.kv_group(b, sk, kv, inst, l2)
    assert 1 <= group <= b * kv
    per_pair = 2 * sk * inst * 2
    assert group == 1 or group * per_pair <= F.L2_SHARE * l2
    assert group == b * kv or (group + 1) * per_pair > F.L2_SHARE * l2  # as many as fit
    n = b * h * n_qb
    order = [_block_order(i, b, h, kv, n_qb, group) for i in range(n)]
    assert sorted(order) == [(bb, hh, qq) for bb in range(b) for hh in range(h) for qq in range(n_qb)]
    # a group starts where the query block jumps back up to the heaviest
    starts = [i for i in range(n) if i == 0 or order[i][2] > order[i - 1][2]]
    sizes = []
    for g0, g1 in zip(starts, [*starts[1:], n]):
        blocks = order[g0:g1]
        pairs = {(bb, hh // (h // kv)) for bb, hh, _ in blocks}
        assert len(blocks) == len(pairs) * (h // kv) * n_qb  # whole kv heads, every query head
        qbs = [qq for _, _, qq in blocks]
        assert qbs == sorted(qbs, reverse=True)  # heaviest first
        sizes.append(len(pairs))
    if n_qb > 1:  # one query block leaves no jump to find a group by
        assert len(sizes) == -(-b * kv // group)
        assert max(sizes) <= group and max(sizes) - min(sizes) <= 1  # within the share, balanced


def test_kv_group_reads_the_share_and_clamps():
    """``flash.kv_group``: (batch, kv head) pairs whose K and V (bf16) fit
    the L2 share, at least one, at most all."""
    assert F.kv_group(8, 4096, 16, 128, L2) == int(F.L2_SHARE * L2) // (2 * 4096 * 128 * 2) == 12
    assert F.kv_group(1, 8192, 8, 128, L2) == 6
    assert F.kv_group(2, 10, 2, 64, L2) == 4  # everything fits: one group, the flat order
    assert F.kv_group(1, 10 ** 6, 4, 256, L2) == 1
