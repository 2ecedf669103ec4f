"""The port's optimizers held to ``repro.train.optimizer`` step for step.

The same numpy parameters and the same numpy gradients, five steps, go
through the reference's ``update`` and the port's; after every step the
parameters and every state leaf are compared.  The parameter tree mixes a
matrix, a stacked (L, m, n) tensor, a vector and a (1, n) row (not
factored by Adafactor), nested as the reference's LM params are.

Tolerance: fp32 state and fp32 parameters within rtol 1e-6 (atol 1e-7·the
leaf's largest entry): the same fp32 ops in the same order, except that
XLA may fuse a product into an add and round once where PyTorch rounds
twice, one fp32 ulp per op.  bf16 parameters: the cast of the fp32 master
(or of p − lr·step without one) may round the other way where those ulps
straddle a bf16 half-spacing, so each entry is within one bf16 spacing,
2⁻⁷·|p|, and almost every entry is bitwise equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import optimizer as ref_opt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402

N_STEPS = 5
SHAPES = {"w": (16, 8), "layers": {"wq": (2, 6, 5), "ln": (2, 1, 7)}, "b": (8,)}


def _tree(fn, shapes=SHAPES, prefix=""):
    return {k: _tree(fn, v, prefix + k + ".") if isinstance(v, dict) else fn(prefix + k, v)
            for k, v in shapes.items()}


def _names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _names(v, prefix + k + ".")
        else:
            yield prefix + k


def _draw(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return _tree(lambda n, s: (scale * rng.standard_normal(s)).astype(np.float32))


MAKERS = {
    "adamw": (lambda m: ref_opt.adamw(lr=1e-2, weight_decay=0.1, master_fp32=m),
              lambda m: optimizer.adamw(lr=1e-2, weight_decay=0.1, master_fp32=m)),
    "adafactor": (lambda m: ref_opt.adafactor(lr=1e-2, weight_decay=0.01, master_fp32=m),
                  lambda m: optimizer.adafactor(lr=1e-2, weight_decay=0.01, master_fp32=m)),
    "sgd": (lambda m: ref_opt.sgd(lr=0.1), lambda m: optimizer.sgd(lr=0.1)),
    "sgd-momentum": (lambda m: ref_opt.sgd(lr=0.1, momentum=0.9), lambda m: optimizer.sgd(lr=0.1, momentum=0.9)),
}
CASES = [(opt, dtype, master) for opt in ("adamw", "adafactor") for dtype in ("float32", "bfloat16")
         for master in (True, False)] + [(opt, dtype, True) for opt in ("sgd", "sgd-momentum")
                                         for dtype in ("float32", "bfloat16")]


def _assert_param(got: torch.Tensor, want: np.ndarray, what: str):
    want = np.asarray(want, np.float32)
    if got.dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7 * np.abs(want).max(), err_msg=what)
        return
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want)), what
    assert np.mean(got == want) >= 0.99, what


def _assert_state(state: dict, ref_state: dict, names, what: str):
    for key, sub in ref_state.items():
        if key == "count":
            assert int(state["count"]) == int(sub) and state["count"].dtype == torch.int32
            continue
        for n in names:
            ref_leaf = interop.by_name(sub, n)
            pairs = ([(state[key][n][k], ref_leaf[k]) for k in ref_leaf] if key == "v"
                     else [(state[key][n], ref_leaf)])
            for got, want in pairs:
                want = np.asarray(want)
                assert tuple(got.shape) == want.shape and got.dtype == torch.float32, (what, key, n)
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7 * np.abs(want).max() + 1e-30,
                                           err_msg=f"{what} {key} {n}")


@pytest.mark.parametrize("opt,dtype,master", CASES, ids=[f"{o}-{d}-master{m}" for o, d, m in CASES])
def test_steps_match_reference(opt, dtype, master):
    make_ref, make_port = MAKERS[opt]
    init = _draw(0)
    ref_params = jax.tree.map(lambda x: jnp.asarray(x, dtype), init)
    names = list(_names(init))
    # copies: ``jnp.asarray`` may alias the numpy buffers on the CPU, and the
    # port's in-place update must not write under the reference's pending step
    params = {n: torch.from_numpy(interop.by_name(init, n)).to(getattr(torch, dtype), copy=True) for n in names}
    r, p = make_ref(master), make_port(master)
    ref_state, state = r.init(ref_params), p.init(params)
    _assert_state(state, jax.tree.map(np.asarray, ref_state), names, "init")
    update = jax.jit(r.update)
    for i in range(N_STEPS):
        grads_np = _draw(100 + i, scale=10.0 ** (i - 2))  # gradient scales 1e-2 … 1e2
        ref_params, ref_state = update(jax.tree.map(lambda x: jnp.asarray(x, dtype), grads_np), ref_state,
                                       ref_params)
        grads = {n: torch.from_numpy(interop.by_name(grads_np, n)).to(getattr(torch, dtype)) for n in names}
        out, state = p.update(grads, state, params)
        assert out is params
        for n in names:
            assert params[n].dtype == getattr(torch, dtype)
            _assert_param(params[n], np.asarray(interop.by_name(ref_params, n), np.float32), f"step {i} {n}")
        _assert_state(state, jax.tree.map(np.asarray, ref_state), names, f"step {i}")
        if master and opt in ("adamw", "adafactor"):
            for n in names:  # the live parameters are the master, cast
                assert torch.equal(params[n], state["master"][n].to(params[n].dtype))


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros(64, 32), "b": torch.zeros(32), "stack": torch.zeros(3, 64, 32),
              "row": torch.zeros(1, 32)}
    st = optimizer.adafactor().init(params)
    assert st["v"]["w"]["vr"].shape == (64,) and st["v"]["w"]["vc"].shape == (32,)
    assert st["v"]["stack"]["vr"].shape == (3, 64) and st["v"]["stack"]["vc"].shape == (3, 32)
    assert st["v"]["b"]["v"].shape == (32,) and st["v"]["row"]["v"].shape == (1, 32)
    ref = ref_opt.adafactor().init(jax.tree.map(lambda t: jnp.zeros(tuple(t.shape)), params))
    for n, v in st["v"].items():
        assert {k: tuple(t.shape) for k, t in v.items()} == {k: t.shape for k, t in ref["v"][n].items()}


def test_bf16_params_keep_an_fp32_master():
    params = {"w": torch.zeros(16, 16, dtype=torch.bfloat16)}
    opt = optimizer.adamw(lr=1e-2, weight_decay=0.0)
    state = opt.init(params)
    g = {"w": torch.full((16, 16), 1e-3, dtype=torch.bfloat16)}
    opt.update(g, state, params)
    assert params["w"].dtype == torch.bfloat16 and state["master"]["w"].dtype == torch.float32
    assert state["master"]["w"] is not params["w"]
    for _ in range(5):
        _, state = opt.update(g, state, params)
    assert float(state["master"]["w"].abs().max()) > 0


def test_converges_on_a_quadratic():
    gen = torch.Generator().manual_seed(0)
    w_true = torch.randn(8, 8, generator=gen)
    for opt in (optimizer.adamw(lr=3e-2, weight_decay=0.0), optimizer.adafactor(lr=3e-2),
                optimizer.sgd(lr=0.3, momentum=0.9)):
        params = {"w": torch.zeros(8, 8, requires_grad=True), "b": torch.zeros(8, requires_grad=True)}
        state = opt.init(params)
        losses = []
        for i in range(80):
            x = torch.randn(32, 8, generator=gen)
            loss = torch.mean((x @ params["w"] + params["b"] - x @ w_true) ** 2)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            _, state = opt.update(grads, state, params)
            losses.append(float(loss.detach()))
        assert losses[-1] < 0.2 * losses[0]
