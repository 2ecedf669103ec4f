"""The port's GShard MoE (``models.layers``) held to the JAX reference.

The same numpy inputs go through ``repro.models.layers.moe_block`` /
``moe_dense_decode`` (eager, on the CPU) and the port's counterparts on CPU
tensors, at the smoke configs' MoE sizes (E 4, top 2, d 64, f 96) and a few
edges: over-capacity drops, top_k = E (the choice loop exhausts
``remaining``, and with probabilities that underflow to 0 it picks an
expert a second time), a tie at the decode threshold, bf16.

The reference's dispatch mask is read where it computes it: its
``shard(dispatch, "batch", None, "expert_model", None)`` call, spied on
(``shard`` is a no-op without mesh rules, so the spy changes no value).

Tolerances: fp32 ``atol 2e-5, rtol 1e-4`` (the reference's fp32 attention
tolerance, ``tests/test_kernels.py:115``); ``dropped_frac`` exactly (it
counts).  bf16: ``moe_block`` rounds to bf16 at R = 5 points (the
dispatched tokens ``xd``, SwiGLU's ``h``, the expert outputs ``y``, the
``combine`` weights and the output); each moves a value by at most
u = 2^-8 relative with independent signs, so a bf16 block lies within
``√R·u`` (relative L2) of exact arithmetic (the reference runs that case in
fp32 on the same bf16 values: its CPU backend refuses the bf16 products).

Routing: both sides take the first argmax of fp32 probabilities that two
softmax implementations compute.  Where a near-tie (within 1e-6) makes the
port's choice differ from the reference's, the comparison runs on the
reference's routing (``moe_block_routed(experts=...)``) and the test says
so in its output; any other difference fails.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ATOL, RTOL = 2e-5, 1e-4
E, D, F = 4, 64, 96
BF16_TOL = np.sqrt(5) * 2.0 ** -8


def _weights(seed, e=E, d=D, f=F, router_scale=1.0):
    rng = np.random.default_rng(seed)
    router = (rng.standard_normal((d, e)) * d ** -0.5 * router_scale).astype(np.float32)
    wi_gate = (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    wi_up = (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    wo = (rng.standard_normal((e, f, d)) * f ** -0.5).astype(np.float32)
    return router, wi_gate, wi_up, wo


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _reference(x, w, *, top_k, capacity_factor, group_size, monkeypatch):
    """The reference's (out, metrics, dispatch) on numpy inputs."""
    seen = []

    def spy(a, *names):
        if names == ("batch", None, "expert_model", None):
            seen.append(np.asarray(a))
        return a

    monkeypatch.setattr(ref_layers, "shard", spy)
    out, metrics = ref_layers.moe_block(jnp.asarray(x), *map(jnp.asarray, w), top_k=top_k,
                                        capacity_factor=capacity_factor, group_size=group_size)
    monkeypatch.undo()
    assert len(seen) == 1
    return np.asarray(out), metrics, seen[0]


def _reference_experts(x, router, *, top_k, group_size):
    """The reference's choice loop on its own fp32 probabilities: (k, G, S)."""
    tokens = x.reshape(-1, x.shape[-1])
    g_size = min(group_size, tokens.shape[0])
    xs = jnp.asarray(tokens.reshape(-1, g_size, x.shape[-1]))
    probs = np.asarray(jax.nn.softmax(
        jnp.einsum("gsd,de->gse", xs, jnp.asarray(router), preferred_element_type=jnp.float32), axis=-1))
    remaining, taken = probs.copy(), []
    for _ in range(top_k):
        idx = remaining.argmax(-1)
        taken.append(idx)
        remaining = remaining * (1.0 - np.eye(probs.shape[-1], dtype=np.float32)[idx])
    return np.stack(taken), probs


def _port(x, w, *, top_k, capacity_factor, group_size, dtype=torch.float32):
    """The port's (out, metrics, dispatch) on the reference's routing: its own
    where the two agree, the reference's where a near-tie parts them."""
    xt = torch.from_numpy(x).to(dtype)
    wt = [torch.from_numpy(w[0])] + [torch.from_numpy(a).to(dtype) for a in w[1:]]
    want, probs = _reference_experts(np.asarray(xt.float()), w[0], top_k=top_k, group_size=group_size)
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, group_size=group_size)
    out, metrics, experts = L.moe_block_routed(xt, *wt, **kw)
    got = experts.numpy()
    if not np.array_equal(got, want):
        for g, s in zip(*np.nonzero((got != want).any(0))):
            j = int(np.nonzero(got[:, g, s] != want[:, g, s])[0][0])
            gap = abs(probs[g, s, got[j, g, s]] - probs[g, s, want[j, g, s]])
            assert gap <= 1e-6, ("routing differs beyond a near-tie", j, g, s, gap)
        print("near-tie: comparing on the reference's routing")
        out, metrics, _ = L.moe_block_routed(xt, *wt, experts=torch.from_numpy(want), **kw)
    xs = xt.reshape(-1, min(group_size, xt.reshape(-1, D).shape[0]), D)
    cap = L.moe_capacity(xs.shape[1], top_k, capacity_factor, E)
    route = L.moe_route(xs, wt[0], top_k=top_k, cap=cap, experts=torch.from_numpy(want))
    return out, metrics, (route.combine > 0).numpy()


CASES = {
    # (x shape, top_k, capacity_factor, group_size)
    "one_group": ((2, 12, D), 2, 1.25, 2048),
    "three_groups": ((3, 16, D), 2, 1.25, 16),
    "over_capacity_one_group": ((2, 12, D), 2, 0.25, 2048),
    "over_capacity_three_groups": ((48, D), 2, 0.25, 16),
    "top_k_equals_e": ((2, 12, D), E, 1.25, 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_block_matches_reference(case, monkeypatch):
    shape, top_k, cf, gs = CASES[case]
    x, w = _x(1, shape), _weights(2)
    want, ref_metrics, ref_dispatch = _reference(x, w, top_k=top_k, capacity_factor=cf, group_size=gs,
                                                 monkeypatch=monkeypatch)
    got, metrics, dispatch = _port(x, w, top_k=top_k, capacity_factor=cf, group_size=gs)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(dispatch, ref_dispatch.astype(bool))
    assert metrics.aux_loss.dtype == metrics.dropped_frac.dtype == torch.float32
    np.testing.assert_allclose(float(metrics.aux_loss), float(ref_metrics.aux_loss), atol=ATOL, rtol=RTOL)
    assert float(metrics.dropped_frac) == float(ref_metrics.dropped_frac)
    if case.startswith("over_capacity"):
        assert float(metrics.dropped_frac) > 0.25


def test_moe_block_remaining_runs_out(monkeypatch):
    """top_k = E with router logits so large that softmax underflows to 0:
    once a token's positive probabilities are taken, ``remaining`` is all
    zeros, the argmax is expert 0 again, with gate 0 — it still takes a
    capacity slot and counts towards the aux loss, as in the reference."""
    x, w = _x(3, (2, 12, D)), _weights(4, router_scale=1e3)
    ref_probs = _reference_experts(x, w[0], top_k=E, group_size=2048)[1]
    assert (ref_probs == 0).any()
    want, ref_metrics, ref_dispatch = _reference(x, w, top_k=E, capacity_factor=1.25, group_size=2048,
                                                 monkeypatch=monkeypatch)
    got, metrics, dispatch = _port(x, w, top_k=E, capacity_factor=1.25, group_size=2048)
    experts = L.moe_block_routed(torch.from_numpy(x), *map(torch.from_numpy, w), top_k=E)[2].numpy()
    assert any(len(set(experts[:, 0, s])) < E for s in range(experts.shape[2]))  # a repeat
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(dispatch, ref_dispatch.astype(bool))
    np.testing.assert_allclose(float(metrics.aux_loss), float(ref_metrics.aux_loss), atol=ATOL, rtol=RTOL)
    assert float(metrics.dropped_frac) == float(ref_metrics.dropped_frac)


def test_moe_block_bf16_matches_reference(monkeypatch):
    """Identical bf16 inputs (the router fp32, as in the models).  The
    reference's CPU backend refuses its bf16 batched products (bf16 × bf16
    → fp32 ``DotThunk``, eager and jitted), so the reference runs in fp32 on
    the same bf16 values: each rounds nothing the port's bf16 block does,
    and the port lies within ``√R·u`` of it (one bf16 side), the same
    routing and the same drops."""
    x = np.asarray(torch.from_numpy(_x(5, (2, 16, D))).to(torch.bfloat16).float())
    w = _weights(6)
    w = (w[0], *(np.asarray(torch.from_numpy(a).to(torch.bfloat16).float()) for a in w[1:]))
    want, ref_metrics, ref_dispatch = _reference(x, w, top_k=2, capacity_factor=1.25, group_size=2048,
                                                 monkeypatch=monkeypatch)
    got, metrics, dispatch = _port(x, w, top_k=2, capacity_factor=1.25, group_size=2048, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and metrics.aux_loss.dtype == torch.float32
    err = np.linalg.norm(got.double().numpy() - want) / np.linalg.norm(want)
    assert err <= BF16_TOL, (err, BF16_TOL)
    np.testing.assert_array_equal(dispatch, ref_dispatch.astype(bool))
    assert float(metrics.dropped_frac) == float(ref_metrics.dropped_frac)
    np.testing.assert_allclose(float(metrics.aux_loss), float(ref_metrics.aux_loss), atol=ATOL, rtol=RTOL)


def test_moe_block_refuses_ragged_groups():
    x, w = torch.from_numpy(_x(7, (10, D))), [torch.from_numpy(a) for a in _weights(8)]
    with pytest.raises(ValueError, match="not divisible"):
        L.moe_block(x, *w, top_k=2, group_size=4)


@pytest.mark.parametrize("top_k", [1, 2, E])
def test_moe_dense_decode_matches_reference(top_k):
    x, w = _x(9, (6, D)), _weights(10)
    want = ref_layers.moe_dense_decode(jnp.asarray(x), *map(jnp.asarray, w), top_k=top_k)
    got = L.moe_dense_decode(torch.from_numpy(x), *map(torch.from_numpy, w), top_k=top_k)
    assert got.shape == (6, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_moe_dense_decode_threshold_tie_takes_both():
    """Experts 1 and 2 have equal router columns and sit at the top-2
    threshold on every token (logits 3a, a, a, −a with a > 0), so both
    pass ``probs >= thresh``: three experts run, as in the reference."""
    rng = np.random.default_rng(11)
    v = rng.standard_normal(D).astype(np.float32)
    x = rng.standard_normal((6, D)).astype(np.float32)
    x *= np.sign(x @ v)[:, None]
    router, wi_gate, wi_up, wo = _weights(12)
    router = np.stack([3 * v, v, v, -v], axis=1) * D ** -0.5
    xt = torch.from_numpy(x)
    probs = torch.softmax(xt @ torch.from_numpy(router), dim=-1)
    assert torch.equal(probs[:, 1], probs[:, 2]) and bool((probs[:, 1] > probs[:, 3]).all())
    want = ref_layers.moe_dense_decode(jnp.asarray(x), *map(jnp.asarray, (router, wi_gate, wi_up, wo)),
                                       top_k=2)
    got = L.moe_dense_decode(xt, *map(torch.from_numpy, (router, wi_gate, wi_up, wo)), top_k=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # Against the top-2 alone (experts 0 and 1): the tie's third expert shows.
    p = probs.numpy()
    gates = np.zeros_like(p)
    gates[:, :2] = p[:, :2] / p[:, :2].sum(-1, keepdims=True)
    h = torch.nn.functional.silu(torch.einsum("bd,edf->bef", xt, torch.from_numpy(wi_gate)))
    h = h * torch.einsum("bd,edf->bef", xt, torch.from_numpy(wi_up))
    top2 = torch.einsum("bed,be->bd", torch.einsum("bef,efd->bed", h, torch.from_numpy(wo)),
                        torch.from_numpy(gates)).numpy()
    assert not np.allclose(got.numpy(), top2, atol=1e-3)


def test_no_drop_moe_block_equals_dense_decode():
    """With capacity_factor = E / top_k every expert can take every token of
    its group, nothing drops, and the dispatched block computes what the
    dense decode path computes on the same tokens."""
    x, w = torch.from_numpy(_x(13, (24, D))), [torch.from_numpy(a) for a in _weights(14)]
    out, metrics = L.moe_block(x, *w, top_k=2, capacity_factor=E / 2, group_size=8)
    assert float(metrics.dropped_frac) == 0.0
    dense = L.moe_dense_decode(x, *w, top_k=2)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=ATOL, rtol=RTOL)
    _, dropping = L.moe_block(x, *w, top_k=2, capacity_factor=0.5, group_size=8)
    assert float(dropping.dropped_frac) > 0.0
