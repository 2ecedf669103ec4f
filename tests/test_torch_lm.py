"""The port's LM serving path held to the JAX reference.

Each LM config, dense and MoE, at ``smoke_lm_config`` size (fp32; one
bf16 case): the
reference draws the parameters with ``jax.random``, and
``interop.lm_params_from_reference`` carries the same values into a
``TransformerLM``; the same numpy tokens then go through both packages'
``lm_forward``, ``prefill_step`` and ``serve_step`` (the port on CPU
tensors, where attention runs the flash kernel's plain version).

Tolerances: fp32 ``atol 2e-5, rtol 1e-4`` per logit / hidden entry (the
reference's fp32 attention tolerance, ``tests/test_kernels.py:115``); greedy
tokens equal.  bf16: each bf16 rounding on the path adds a relative error
of at most u = 2^-8, with independent signs, so a forward pass with R
rounding points lands within ``√R·u`` (relative L2) of exact arithmetic and
two such passes within ``2·√R·u`` of each other.  R counts 14 roundings per
layer (3 in each RMSNorm, q/k/v, RoPE, p, the attention output, the o and
down products, SwiGLU's h, two residual adds) and 3 for the final norm.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.data import synth as ref_synth  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_lm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ["tinyllama-1.1b", "stablelm-3b", "deepseek-67b", "olmoe-1b-7b", "grok-1-314b"]
MOE_ARCHS = ["olmoe-1b-7b", "grok-1-314b"]
ATOL, RTOL = 2e-5, 1e-4
N_STEPS = 8


def bf16_tolerance(n_layers: int) -> float:
    """√R·u, relative L2, for a bf16 forward of ``n_layers`` (module docstring)."""
    return float(np.sqrt(14 * n_layers + 3)) * 2.0 ** -8


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def _pair(arch: str, dtype: str = "float32"):
    """(reference cfg, reference params, port cfg, port model) for one arch."""
    ref_cfg = dataclasses.replace(ref_base.smoke_lm_config(ref_base.load_arch(arch).config),
                                  dtype=jnp.dtype(dtype))
    params = ref_lm.init_lm_params(jax.random.PRNGKey(0), ref_cfg)
    cfg = interop.lm_config_from_dict(dataclasses.asdict(ref_cfg))
    model = interop.lm_params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return ref_cfg, params, cfg, model


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    ref_cfg = ref_base.load_arch(arch).config
    cfg = base.load_arch(arch).config
    assert interop.lm_config_from_dict(dataclasses.asdict(ref_cfg)) == cfg
    assert cfg.dtype == torch.bfloat16
    assert cfg.params_billions() == ref_cfg.params_billions()
    assert cfg.active_params_billions() == ref_cfg.active_params_billions()
    smoke = base.smoke_lm_config(cfg)
    assert interop.lm_config_from_dict(dataclasses.asdict(ref_base.smoke_lm_config(ref_cfg))) == smoke
    assert smoke.dtype == torch.float32
    assert base.load_arch(arch).shapes == base.LM_SHAPES
    assert [c.name for c in base.LM_SHAPES] == [c.name for c in ref_base.LM_SHAPES]
    assert [dict(c.dims) for c in base.LM_SHAPES] == [dict(c.dims) for c in ref_base.LM_SHAPES]


def test_registry_holds_the_ported_dense_lms():
    """Every LM arch of the reference's registry, dense and MoE, and no other."""
    ref_lms = {a for a in ref_base.arch_ids() if ref_base.load_arch(a).config.family == "lm"}
    assert set(base.arch_ids()) == set(base.registry()) == set(ARCHS) == ref_lms
    assert {a for a in ARCHS if base.load_arch(a).config.moe_experts} == set(MOE_ARCHS)
    with pytest.raises(KeyError):
        base.load_arch("gat-cora")


def test_rmsnorm_rope_swiglu_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    pos = np.arange(12)
    np.testing.assert_allclose(L.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
                               np.asarray(ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(L.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0).numpy(),
                               np.asarray(ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
                               atol=ATOL, rtol=RTOL)
    h = rng.standard_normal((2, 12, 16)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * 0.25 for s in ((16, 24), (16, 24), (24, 16))]
    np.testing.assert_allclose(L.swiglu(torch.from_numpy(h), *map(torch.from_numpy, w)).numpy(),
                               np.asarray(ref_layers.swiglu(jnp.asarray(h), *map(jnp.asarray, w))),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("length", [1, 7, 16])
def test_decode_attention_matches_reference(length):
    rng = np.random.default_rng(length)
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 16, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 16, 2, 16)).astype(np.float32)
    spec = L.AttnSpec(4, 2, 16, 16, None)
    got = L.decode_attention(*map(torch.from_numpy, (q, kc, vc)), spec,
                             length=torch.tensor(length)).numpy()
    want = ref_layers.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                       ref_layers.AttnSpec(4, 2, 16, 16, None), length=length)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_forward_match_reference(arch):
    ref_cfg, params, cfg, model = _pair(arch)
    toks = _tokens(1, 2, 32, cfg.vocab)
    want = jax.jit(functools.partial(ref_lm.prefill_step, cfg=ref_cfg))(params, toks)
    np.testing.assert_allclose(T.prefill_step(model, toks, cfg).numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    with torch.no_grad():  # lm_forward and lm_logits record a gradient under grad mode
        hidden, aux = T.lm_forward(model, toks, cfg)
        logits = T.lm_logits(model, hidden, cfg)
    ref_hidden, ref_aux = jax.jit(functools.partial(ref_lm.lm_forward, cfg=ref_cfg))(params, toks)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(ref_hidden), atol=ATOL, rtol=RTOL)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=ATOL, rtol=RTOL)
    assert (float(aux) == 0.0) == (arch not in MOE_ARCHS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_lm.lm_logits(params, ref_hidden, ref_cfg)),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window", [4, 12, 40], ids=["window4", "window12", "window40"])
def test_windowed_prefill_matches_reference(window):
    """A smoke-size sliding-window config (the reference's ``cfg.window``,
    beyond its chunk of 16 and beyond the 32 prompt tokens): the port's and
    the reference's prefill on the same parameters."""
    ref_cfg, params, cfg, model = _pair("tinyllama-1.1b")
    ref_w = dataclasses.replace(ref_cfg, window=window)
    cfg_w = dataclasses.replace(cfg, window=window)
    assert interop.lm_config_from_dict(dataclasses.asdict(ref_w)) == cfg_w
    toks = _tokens(9, 2, 32, cfg.vocab)
    want = np.asarray(jax.jit(functools.partial(ref_lm.prefill_step, cfg=ref_w))(params, toks))
    got = T.prefill_step(model, toks, cfg_w).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    unwindowed = T.prefill_step(model, toks, cfg).numpy()
    assert np.array_equal(got, unwindowed) == (window >= 32)  # a window past the prompt changes nothing


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_head_dim_16_has_a_kernel_instance(arch):
    """The smoke configs run head dim 64 / 4 = 16, which both kernel-4
    routes take as a template instance (no padding on the smoke path)."""
    from repro_torch.kernels.flash_attention import flash as F

    cfg = base.smoke_lm_config(base.load_arch(arch).config)
    assert cfg.head_dim == 16
    for dtype in (torch.float32, torch.bfloat16):
        which = F.route(dtype, cfg.head_dim)
        assert F.instance(which, cfg.head_dim) == 16


def _decode_both(ref_cfg, params, cfg, model, toks, seq_len):
    """N_STEPS serve_steps on both sides, feeding the prompt's tokens."""
    step = jax.jit(functools.partial(ref_lm.serve_step, cfg=ref_cfg))
    ref_cache = ref_lm.init_kv_cache(ref_cfg, toks.shape[0], seq_len)
    cache = T.init_kv_cache(cfg, toks.shape[0], seq_len, device="cpu")
    out = []
    for i in range(N_STEPS):
        ref_logits, ref_next, ref_cache = step(params, ref_cache, toks[:, i])
        logits, nxt, cache = T.serve_step(model, cache, toks[:, i], cfg)
        out.append((np.asarray(ref_logits), np.asarray(ref_next), logits.numpy(), nxt.numpy()))
    return out, ref_cache, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_reference(arch):
    ref_cfg, params, cfg, model = _pair(arch)
    toks = _tokens(2, 2, N_STEPS, cfg.vocab)
    steps, ref_cache, cache = _decode_both(ref_cfg, params, cfg, model, toks, 16)
    for ref_logits, ref_next, logits, nxt in steps:
        np.testing.assert_allclose(logits, ref_logits, atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(nxt, ref_next)
        assert nxt.dtype == np.int32
    assert int(cache.length) == int(ref_cache.length) == N_STEPS
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(ref_cache.k), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(ref_cache.v), atol=ATOL, rtol=RTOL)


def test_cache_end_clamps_the_write_like_the_reference():
    """Past the cache's end the reference's dynamic_update_slice writes the
    last slot and every slot stays valid; the port mirrors it."""
    ref_cfg, params, cfg, model = _pair("tinyllama-1.1b")
    toks = _tokens(3, 2, N_STEPS, cfg.vocab)
    steps, ref_cache, cache = _decode_both(ref_cfg, params, cfg, model, toks, 5)
    for ref_logits, ref_next, logits, nxt in steps:
        np.testing.assert_allclose(logits, ref_logits, atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(nxt, ref_next)
    assert int(cache.length) == int(ref_cache.length) == N_STEPS
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(ref_cache.k), atol=ATOL, rtol=RTOL)


def test_decode_logits_agree_with_prefill():
    """Feeding a prompt one token at a time ends at prefill's logits."""
    _, _, cfg, model = _pair("stablelm-3b")
    toks = _tokens(4, 2, N_STEPS, cfg.vocab)
    cache = T.init_kv_cache(cfg, 2, 16, device="cpu")
    for i in range(N_STEPS):
        logits, _, cache = T.serve_step(model, cache, toks[:, i], cfg)
    np.testing.assert_allclose(logits.numpy(), T.prefill_step(model, toks, cfg).numpy(),
                               atol=ATOL, rtol=RTOL)


def test_lm_precision_holds_only_inside_the_call():
    """The LM's matmul flags are set for its calls and restored after them."""
    import torch

    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction
    seen = []
    orig = L.matmul_wide

    def spy(a, b):
        seen.append((matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction))
        return orig(a, b)

    _, _, cfg, model = _pair("tinyllama-1.1b")
    toks = _tokens(5, 1, 4, cfg.vocab)
    try:
        matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = True, True
        L.matmul_wide = spy
        T.prefill_step(model, toks, cfg)
        T.serve_step(model, T.init_kv_cache(cfg, 1, 4, device="cpu"), toks[:, 0], cfg)
        after = matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction
    finally:
        L.matmul_wide = orig
        matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = saved
    assert seen and set(seen) == {(False, False)}
    assert after == (True, True)


def test_bf16_prefill_and_decode_match_reference():
    ref_cfg, params, cfg, model = _pair("tinyllama-1.1b", "bfloat16")
    assert model.embed.dtype == torch.bfloat16
    tol = 2 * bf16_tolerance(cfg.n_layers)
    toks = _tokens(5, 2, 32, cfg.vocab)
    want = np.asarray(jax.jit(functools.partial(ref_lm.prefill_step, cfg=ref_cfg))(params, toks))
    got = T.prefill_step(model, toks, cfg)
    assert got.dtype == torch.float32
    assert rel_l2(got.numpy(), want) <= tol
    steps, _, _ = _decode_both(ref_cfg, params, cfg, model, toks, 16)
    for ref_logits, ref_next, logits, nxt in steps:
        assert rel_l2(logits, ref_logits) <= tol
        # Greedy tokens agree wherever the reference's top-2 gap exceeds
        # what the two roundings may move a logit.
        top2 = np.sort(ref_logits, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * tol * np.abs(ref_logits).max()
        np.testing.assert_array_equal(nxt[clear], ref_next[clear])


def test_init_kv_cache_shapes_and_length():
    cfg = base.smoke_lm_config(base.load_arch("tinyllama-1.1b").config)
    cache = T.init_kv_cache(cfg, 3, 10, device="cpu")
    assert cache.k.shape == cache.v.shape == (cfg.n_layers, 3, 10, cfg.n_kv_heads, cfg.head_dim)
    assert cache.k.dtype == cfg.dtype
    assert cache.length.shape == () and cache.length.dtype == torch.int32 and int(cache.length) == 0


def test_init_lm_params_distributions():
    cfg = dataclasses.replace(base.smoke_lm_config(base.load_arch("tinyllama-1.1b").config),
                              d_model=128, d_ff=256, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    model = T.init_lm_params(gen, cfg)
    names = {n for n, _ in model.named_parameters()}
    assert names == {"embed", "out", "final_norm", *(f"layers.{n}" for n in (
        "ln1", "ln2", "wq", "wk", "wv", "wo", "wi_gate", "wi_up", "wo_ffn"))}
    assert all(p.dtype == torch.bfloat16 and p.requires_grad for p in model.parameters())
    for name in ("final_norm", "layers.ln1", "layers.ln2"):
        assert not model.get_parameter(name).any()
    assert abs(model.embed.float().std().item() - 1.0) < 0.05
    for name in ("out", "layers.wq", "layers.wk", "layers.wi_gate", "layers.wo_ffn"):
        p = model.get_parameter(name).float()
        assert abs(p.std().item() * p.shape[-2] ** 0.5 - 1.0) < 0.05, name


def test_lm_batch():
    cfg = base.smoke_lm_config(base.load_arch("tinyllama-1.1b").config)
    tokens = synth.lm_batch(torch.Generator().manual_seed(0), cfg, 4, 16)["tokens"]
    ref = ref_synth.lm_batch(jax.random.PRNGKey(0), ref_base.smoke_lm_config(
        ref_base.load_arch("tinyllama-1.1b").config), 4, 16)["tokens"]
    assert tokens.shape == tuple(ref.shape) and tokens.dtype == torch.int32
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab


def test_entry_points_default_to_cuda():
    cfg = base.smoke_lm_config(base.load_arch("tinyllama-1.1b").config)
    if torch.cuda.is_available():
        assert T.TransformerLM(cfg).embed.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_kv_cache(cfg, 2, 8)
    _, params, _, model = _pair("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.lm_params_from_reference(jax.tree.map(np.asarray, params), cfg)


def test_token_ids_from_outside_are_checked():
    _, _, cfg, model = _pair("tinyllama-1.1b")
    with pytest.raises(ValueError, match="token ids"):
        T.prefill_step(model, np.array([[0, cfg.vocab]]), cfg)
    with pytest.raises(ValueError, match="token ids"):
        T.serve_step(model, T.init_kv_cache(cfg, 1, 4, device="cpu"), [-1], cfg)


def test_moe_configs_are_not_ported_yet():
    """An MoE config builds the reference's expert-stacked parameters: a
    dense config given experts constructs, under the reference's names and
    shapes, with the router first among the FFN weights."""
    cfg = dataclasses.replace(base.smoke_lm_config(base.load_arch("tinyllama-1.1b").config),
                              moe_experts=4, moe_top_k=2)
    model = T.TransformerLM(cfg, device="cpu")
    ref_cfg = dataclasses.replace(ref_base.smoke_lm_config(ref_base.load_arch("tinyllama-1.1b").config),
                                  moe_experts=4, moe_top_k=2)
    ref = jax.eval_shape(lambda k: ref_lm.init_lm_params(k, ref_cfg), jax.random.PRNGKey(0))
    assert list(model.layers) == list(ref["layers"])
    for name, p in model.layers.items():
        assert tuple(p.shape) == ref["layers"][name].shape, name
    assert tuple(model.layers["wi_gate"].shape) == (2, 4, 64, 96)
    assert tuple(model.layers["wo_ffn"].shape) == (2, 4, 96, 64)
    toks = _tokens(6, 1, 8, cfg.vocab)
    hidden, aux = T.lm_forward(model, toks, cfg)  # zero weights: uniform routing
    assert hidden.shape == (1, 8, cfg.d_model) and float(aux) == pytest.approx(1.0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_stays_fp32_in_a_bf16_model(arch):
    """The reference keeps the router fp32 whatever the model's dtype; so do
    the port's constructor, its initialiser and ``lm_params_from_reference``
    (whose values reach the router without a bf16 rounding)."""
    cfg = dataclasses.replace(base.smoke_lm_config(base.load_arch(arch).config), dtype=torch.bfloat16)
    model = T.init_lm_params(torch.Generator().manual_seed(0), cfg)
    assert model.layers["router"].dtype == torch.float32
    assert all(p.dtype == torch.bfloat16 for n, p in model.named_parameters() if n != "layers.router")
    p = model.layers["router"]
    assert abs(p.std().item() * p.shape[-2] ** 0.5 - 1.0) < 0.1
    ref_cfg, params, _, _ = _pair(arch, "bfloat16")
    ref_router = np.asarray(params["layers"]["router"])
    assert ref_router.dtype == np.float32
    carried = interop.lm_params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    assert carried.layers["router"].dtype == torch.float32
    np.testing.assert_array_equal(carried.layers["router"].detach().numpy(), ref_router)
    assert carried.layers["wi_gate"].dtype == torch.bfloat16
