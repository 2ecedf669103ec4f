"""The port's training step held to the JAX reference.

* ``lm_loss`` and its gradients against ``jax.value_and_grad`` of
  ``repro.models.transformer.lm_loss`` on ``smoke_lm_config`` of TinyLlama
  (dense), Grok-1 (MoE: the aux loss is in the loss) and a bf16 TinyLlama,
  the reference's weights carried across by ``interop.lm_params_from_reference``
  and the same numpy tokens given to both.
* ``cfg.remat`` on against off, and one train step at microbatches 1
  against 2, within the port; microbatches 2 against the reference's step.
* The named attention backward (``flash.flash_attention_backward_plain``)
  against ``jax.vjp`` of the reference's ``layers.causal_attention``
  (windows and a query offset included) and against autograd of the plain
  recurrence; the autograd Function around kernel 4's wrapper.
* No silent zero gradient: every kernel launcher refuses inputs that
  require grad under grad mode.

Tolerances.  fp32: loss within rtol 1e-6, each gradient tensor within
relative L2 1e-5 of the reference's (both sides fp32; they differ only in
summation order, ~1e-7 per op over a few dozen ops).  bf16: each bf16
rounding moves a value by at most u = 2^-8 relative with independent
signs, so R roundings add to √R·u; a gradient depends on the forward's 14
roundings per layer and 3 for the final norm, and on as many in the
backward (each forward rounding point rounds its gradient once) plus the
gradient's own cast: R = 28·L + 4, and two bf16 computations lie within
2·√R·u of each other.  Within the port, remat and the microbatch split
change nothing but the order of the accumulation: remat bitwise; the
microbatch split's gradients (one SGD step at lr 1) within the fp32 1e-5.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_lm  # noqa: E402
from repro.train import loop as ref_loop  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels.flash_attention import flash as F  # noqa: E402
from repro_torch.kernels.hausdorff import batched as KB  # noqa: E402
from repro_torch.kernels.hausdorff import hausdorff as K  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import loop, optimizer  # noqa: E402

FP32_GRAD_RTOL = 1e-5


def bf16_grad_tolerance(n_layers: int) -> float:
    """2·√R·u with R = 28·L + 4 (module docstring)."""
    return 2 * float(np.sqrt(28 * n_layers + 4)) * 2.0 ** -8


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def _pair(arch: str, dtype: str = "float32"):
    """(reference cfg, reference params, port cfg) for one arch."""
    ref_cfg = dataclasses.replace(ref_base.smoke_lm_config(ref_base.load_arch(arch).config),
                                  dtype=jnp.dtype(dtype))
    params = ref_lm.init_lm_params(jax.random.PRNGKey(0), ref_cfg)
    cfg = interop.lm_config_from_dict(dataclasses.asdict(ref_cfg))
    return ref_cfg, params, cfg


def _model(arch, dtype="float32", **changes):
    ref_cfg, params, cfg = _pair(arch, dtype)
    cfg = dataclasses.replace(cfg, **changes)
    return cfg, interop.lm_params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)


def _port_value_and_grad(model, cfg, tokens):
    loss, metrics = T.lm_loss(model, {"tokens": torch.from_numpy(tokens)}, cfg)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(named, grads))


CASES = [("tinyllama-1.1b", "float32"), ("grok-1-314b", "float32"), ("tinyllama-1.1b", "bfloat16")]


@pytest.mark.parametrize("arch,dtype", CASES, ids=[f"{a}-{d}" for a, d in CASES])
def test_lm_loss_and_grads_match_reference(arch, dtype):
    ref_cfg, params, _ = _pair(arch, dtype)
    cfg, model = _model(arch, dtype)
    tokens = _tokens(1, 2, 32, cfg.vocab)
    (ref_loss, ref_m), ref_g = jax.jit(jax.value_and_grad(
        lambda p, b: ref_lm.lm_loss(p, b, ref_cfg), has_aux=True))(params, {"tokens": jnp.asarray(tokens)})
    loss, metrics, grads = _port_value_and_grad(model, cfg, tokens)
    assert set(grads) == {n for n, _ in model.named_parameters()}
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
        np.testing.assert_allclose(float(metrics["ce_loss"]), float(ref_m["ce_loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(metrics["aux_loss"]), float(ref_m["aux_loss"]), rtol=1e-6, atol=1e-7)
        if cfg.moe_experts:
            assert float(metrics["aux_loss"]) > 0.5  # a live aux term, 0.01·aux in the loss
        tol = FP32_GRAD_RTOL
    else:
        tol = bf16_grad_tolerance(cfg.n_layers)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=tol)
    for n, g in grads.items():
        ref = np.asarray(interop.by_name(jax.tree.map(lambda x: np.asarray(x, np.float32), ref_g), n))
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == ref.shape, n
        assert rel_l2(g.float().numpy(), ref) <= tol, (n, rel_l2(g.float().numpy(), ref), tol)


def test_remat_changes_no_bit():
    tokens = _tokens(2, 2, 32, 256)
    out = []
    for remat in (False, True):
        cfg, model = _model("tinyllama-1.1b", remat=remat)
        out.append(_port_value_and_grad(model, cfg, tokens))
    (l0, m0, g0), (l1, m1, g1) = out
    assert torch.equal(l0, l1) and torch.equal(m0["ce_loss"], m1["ce_loss"])
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


def _deltas(model, before: dict) -> dict:
    return {n: p.detach().numpy() - before[n] for n, p in model.named_parameters()}


def _port_step(arch: str, microbatches: int, tokens):
    """One SGD step (lr 1): each parameter moves by minus its gradient, so
    the moves hold the accumulated gradients."""
    cfg, model = _model(arch)
    before = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    step = loop.make_train_step(lambda p, b: T.lm_loss(p, b, cfg), optimizer.sgd(lr=1.0),
                                microbatches=microbatches)
    _, metrics = step(model, {}, {"tokens": torch.from_numpy(tokens)})
    return _deltas(model, before), metrics


def test_microbatches_one_against_two():
    tokens = _tokens(3, 4, 16, 256)
    d1, r1 = _port_step("tinyllama-1.1b", 1, tokens)
    d2, r2 = _port_step("tinyllama-1.1b", 2, tokens)
    np.testing.assert_allclose(float(r2["loss"]), float(r1["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(r2["grad_norm"]), float(r1["grad_norm"]), rtol=FP32_GRAD_RTOL)
    for n in d1:
        assert rel_l2(d2[n], d1[n]) <= FP32_GRAD_RTOL, (n, rel_l2(d2[n], d1[n]))


def test_microbatched_step_matches_reference():
    """Two microbatches of the MoE smoke config against the reference's
    jitted ``make_train_step(microbatches=2)``."""
    ref_cfg, params, _ = _pair("grok-1-314b")
    tokens = _tokens(3, 4, 16, 256)
    ref_step = ref_loop.make_train_step(lambda p, b: ref_lm.lm_loss(p, b, ref_cfg), ref_opt.sgd(lr=1.0),
                                        microbatches=2, donate=False)
    ref_p, _, ref_m = ref_step(params, {}, {"tokens": jnp.asarray(tokens)})
    deltas, metrics = _port_step("grok-1-314b", 2, tokens)
    for k in ("loss", "ce_loss", "aux_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(ref_m[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(ref_m["grad_norm"]), rtol=FP32_GRAD_RTOL)
    for n, d in deltas.items():
        ref = np.asarray(interop.by_name(ref_p, n)) - np.asarray(interop.by_name(params, n))
        assert rel_l2(d, ref) <= FP32_GRAD_RTOL, (n, rel_l2(d, ref))


# ---------------------------------------------------------------------------
# The attention backward
# ---------------------------------------------------------------------------

# (b, sq, sk, h, kv, hd, chunk, window, q_offset)
ATTN_CASES = [
    (2, 32, 32, 4, 2, 16, 8, None, 0),
    (1, 48, 48, 4, 1, 8, 16, 12, 0),      # GQA 4, a window across chunks
    (2, 16, 16, 4, 4, 32, 16, None, 0),   # one chunk, MHA
    (1, 8, 32, 4, 2, 16, 8, 10, 24),      # a continued prefill: q_offset, window
]


def _attn_inputs(case, seed=0):
    b, sq, sk, h, kv, hd = case[:6]
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal(s).astype(np.float32)
                     for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd), (b, sq, h, hd)))
    return q, k, v, dout


@pytest.mark.parametrize("case", ATTN_CASES, ids=[str(c) for c in ATTN_CASES])
def test_attention_backward_matches_reference_vjp(case):
    b, sq, sk, h, kv, hd, chunk, window, q_offset = case
    q, k, v, dout = _attn_inputs(case)
    spec = ref_layers.AttnSpec(n_heads=h, n_kv_heads=kv, head_dim=hd, chunk=chunk, window=window)
    _, vjp = jax.vjp(lambda q_, k_, v_: ref_layers.causal_attention(q_, k_, v_, spec, q_offset=q_offset),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    got = F.flash_attention_backward_plain(*(torch.from_numpy(x) for x in (q, k, v, dout)), chunk=chunk,
                                           q_offset=q_offset, window=window)
    for name, g, r in zip("qkv", got, ref):
        assert tuple(g.shape) == r.shape and g.dtype == torch.float32
        # fp32 on both sides; per entry the reference's fp32 tolerance,
        # the absolute part scaled by the gradient's largest entry
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=2e-5 * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("case", ATTN_CASES, ids=[str(c) for c in ATTN_CASES])
def test_attention_backward_is_autograd_of_the_plain_recurrence(case, dtype):
    """The chunk-checkpointed backward recomputes exactly what autograd of
    the plain recurrence saves: bitwise, in every dtype."""
    chunk, window, q_offset = case[6:]
    q, k, v, dout = (torch.from_numpy(x).to(dtype) for x in _attn_inputs(case, seed=1))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = F.flash_attention_plain(*leaves, chunk=chunk, q_offset=q_offset, window=window)
    want = torch.autograd.grad(out, leaves, dout)
    got = F.flash_attention_backward_plain(q, k, v, dout, chunk=chunk, q_offset=q_offset, window=window)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)
    # the autograd Function around the wrapper: the wrapper's forward (on the
    # CPU its plain version, at its own chunk), this backward
    out = F.flash_attention_grad(*leaves, chunk=chunk, q_offset=q_offset, window=window)
    assert torch.equal(out, F.flash_attention(q, k, v, q_offset=q_offset, window=window))
    for g, w in zip(torch.autograd.grad(out, leaves, dout), want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# No silent zero gradient from a kernel
# ---------------------------------------------------------------------------


def _launches():
    n = 8
    a, b = torch.randn(n, 4), torch.randn(n, 4)
    q = torch.randn(1, 2, 4, 4)  # as many entries as a
    return {
        "kernel 1": lambda x: K.fused_minscan(x, b, (x * x).sum(1), (b * b).sum(1), torch.empty(n),
                                              torch.empty(n)),
        "kernel 2": lambda x: KB.batched_minscan(x[None], (x * x).sum(1)[None], b[None], (b * b).sum(1)[None],
                                                 torch.empty(1, n), torch.empty(1, n)),
        "kernel 3": lambda x: KB.multiquery_minscan(x[None], (x * x).sum(1)[None], b[None], (b * b).sum(1)[None],
                                                    torch.empty(1, 1, n), torch.empty(1, 1, n)),
        "kernel 4": lambda x: F.flash_fwd(x.reshape(q.shape), q, q, torch.empty_like(q)),
        "a": a,
    }


@pytest.mark.parametrize("kernel", ["kernel 1", "kernel 2", "kernel 3", "kernel 4"])
def test_launcher_refuses_inputs_that_require_grad(kernel):
    launch = _launches()
    x = launch["a"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match='backend="tiled"'):
        launch[kernel](x)
    # grad off: no refusal; the launcher goes on to its own device check
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        launch[kernel](x)


def test_front_door_and_attention_keep_their_gradient_on_the_cpu():
    """Through the dispatch code on CPU tensors the plain versions run, and
    their results carry the gradient: the refusal is for kernel launches
    only."""
    from repro_torch.models import layers as L

    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((64, 8)), dtype=torch.float32, requires_grad=True)
    y = torch.tensor(rng.standard_normal((40, 8)), dtype=torch.float32)
    for backend in ("tiled", "fused_cuda", "auto"):
        res = loop.make_set_distance_metric(variant="chamfer", backend=backend)(x, y)
        (g,) = torch.autograd.grad(res.value, x)
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0, backend
    q, k, v, _ = (torch.from_numpy(a).requires_grad_() for a in _attn_inputs(ATTN_CASES[0]))
    spec = L.AttnSpec(n_heads=4, n_kv_heads=2, head_dim=16, chunk=8, window=None)
    out = L.causal_attention(q, k, v, spec)
    assert out.grad_fn is not None
