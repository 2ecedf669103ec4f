"""The port's wide contractions save their narrow operands under autograd.

``layers.matmul_wide`` and ``layers.einsum_wide`` are the reference's
``preferred_element_type=f32`` contractions: on bf16 operands they upcast
and contract in fp32.  Under autograd they now save the bf16 operands and
upcast them again in the backward, where autograd through the upcast kept
the fp32 copies (or permuted fp32 copies of them) alive until the backward.

The plain version is that formulation, kept here (:func:`_plain`): the
forward values and every gradient must be bitwise its own.  What is saved
is read with ``saved_tensors_hooks`` (inside ``torch.utils.checkpoint``
regions, through a spy on the checkpoint's own hook, which sees each
tensor the layer saves): against the plain version, the saves lost must
all be fp32 tensors of an operand's size (the copies) and the saves gained
the bf16 operands themselves (their storage, not copies), so the bytes
gained are at most the bf16 operands' bytes.

Cases, all bf16 on the CPU: every equation the LM blocks use, ``matmul``
on 2-D, 3-D, transposed (column-major) operands, an fp32 router; SwiGLU;
``moe_block`` at the smoke Grok-1 config; one ``lm_loss`` step of the
smoke TinyLlama under remat.
"""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.utils.checkpoint as torch_checkpoint  # noqa: E402

from repro_torch.configs.base import load_arch, smoke_lm_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

BF16 = torch.bfloat16


def _plain(eq, a, b):
    """The formulation before: autograd through the upcast."""
    wide = L.wide_dtype(a.dtype)
    return L._contract(eq, a.to(wide), b.to(wide))


def _tensor(rng, shape, dtype=BF16, scale=1.0):
    return torch.from_numpy(np.asarray(rng.standard_normal(shape) * scale, np.float32)).to(dtype)


class _Saved:
    """Every tensor saved for a backward inside the block: (dtype, shape,
    storage pointer), outside and inside checkpoint regions."""

    def __init__(self, monkeypatch):
        self.records = []
        real = torch_checkpoint._checkpoint_hook
        record = self._record

        class Spy(real):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                inner = self.pack_hook
                self.pack_hook = lambda x: inner(record(x))

        monkeypatch.setattr(torch_checkpoint, "_checkpoint_hook", Spy)
        self.hooks = torch.autograd.graph.saved_tensors_hooks(self._record, lambda x: x)

    def _record(self, x):
        self.records.append((x.dtype, tuple(x.shape), x.untyped_storage().data_ptr()))
        return x

    def __enter__(self):
        self.hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self.hooks.__exit__(*exc)


class _Operands:
    """A spy on ``layers._contract_wide`` that keeps each call's operands'
    (dtype, shape, storage pointer, bytes)."""

    def __init__(self, monkeypatch, impl):
        self.seen = []

        def spy(eq, a, b):
            for t in (a, b):
                self.seen.append((t.dtype, tuple(t.shape), t.untyped_storage().data_ptr(),
                                  t.numel() * t.element_size()))
            return impl(eq, a, b)

        monkeypatch.setattr(L, "_contract_wide", spy)


def _run(monkeypatch, impl, fn, inputs):
    """``fn(*inputs)``'s outputs, the gradients of a fixed random weighting
    of them, the saved records and the contraction operands, with
    ``layers._contract_wide`` = ``impl``."""
    with monkeypatch.context() as m:
        ops = _Operands(m, impl)
        leaves = [x.detach().requires_grad_(x.is_floating_point()) for x in inputs]
        with _Saved(m) as saved:
            outs = fn(*leaves)
        outs = [o for o in (outs if isinstance(outs, tuple) else (outs,)) if isinstance(o, torch.Tensor)]
        rng = np.random.default_rng(99)
        total = sum((o.float() * _tensor(rng, o.shape, torch.float32)).sum() for o in outs)
        grads = torch.autograd.grad(total, [x for x in leaves if x.requires_grad])
    return [o.detach() for o in outs], grads, saved.records, ops.seen


def _check(monkeypatch, fn, inputs):
    """Bitwise against the plain version; the saves differ only by the fp32
    operand copies given up and the bf16 operands kept."""
    got, got_g, saved, ops = _run(monkeypatch, L._contract_wide, fn, inputs)
    want, want_g, saved_plain, _ = _run(monkeypatch, _plain, fn, inputs)
    for g, w in zip(got + list(got_g), want + list(want_g)):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
    sig = collections.Counter((d, s) for d, s, _ in saved)
    sig_plain = collections.Counter((d, s) for d, s, _ in saved_plain)
    lost, gained = sig_plain - sig, sig - sig_plain
    numels = {int(np.prod(s)) for _, s, _, _ in ops}
    narrow = [op for op in ops if op[0] != torch.float32]
    assert lost and all(d == torch.float32 and int(np.prod(s)) in numels for d, s in lost), lost
    # each save gained is a bf16 operand itself (its storage), not a copy
    op_bytes = {p: b for _, _, p, b in narrow}
    assert all(d == BF16 for d, _ in gained), gained
    for sig_, n in gained.items():
        assert sum(1 for d, s, p in saved if (d, s) == sig_ and p in op_bytes) >= n, sig_
    kept = {p for d, s, p in saved if (d, s) in gained and p in op_bytes}
    assert sum(op_bytes[p] for p in kept) <= sum(op_bytes.values())

    def fp32_bytes(records):
        return sum(int(np.prod(s)) * 4 for d, s, _ in records if d == torch.float32)

    assert fp32_bytes(saved) < fp32_bytes(saved_plain)
    return lost


EINSUMS = [  # the LM blocks' equations (moe_block, moe_dense_decode), operand shapes
    ("gsec,gsd->gecd", (2, 64, 4, 40), (2, 64, 64)),
    ("gecd,edf->gecf", (2, 4, 40, 64), (4, 64, 96)),
    ("gsec,gecd->gsd", (2, 64, 4, 40), (2, 4, 40, 64)),
    ("bd,edf->bef", (8, 64), (4, 64, 96)),
    ("bed,be->bd", (8, 4, 64), (8, 4)),
]


@pytest.mark.parametrize("eq,sa,sb", EINSUMS, ids=[e[0] for e in EINSUMS])
def test_einsum_wide_saves_narrow_operands(monkeypatch, eq, sa, sb):
    rng = np.random.default_rng(1)
    _check(monkeypatch, lambda a, b: L.einsum_wide(eq, a, b), [_tensor(rng, sa), _tensor(rng, sb)])


MATMULS = {  # name: (a, b) from a numpy generator
    "2d": lambda r: (_tensor(r, (48, 64)), _tensor(r, (64, 96))),
    "3d": lambda r: (_tensor(r, (2, 24, 64)), _tensor(r, (64, 96))),
    "b_column_major": lambda r: (_tensor(r, (48, 64)), _tensor(r, (96, 64)).t()),
    "a_column_major": lambda r: (_tensor(r, (64, 48)).t(), _tensor(r, (64, 96))),
    "fp32_router": lambda r: (_tensor(r, (2, 24, 64)), _tensor(r, (64, 4), torch.float32)),
}


@pytest.mark.parametrize("case", list(MATMULS))
def test_matmul_wide_saves_narrow_operands(monkeypatch, case):
    _check(monkeypatch, L.matmul_wide, list(MATMULS[case](np.random.default_rng(2))))


def test_float64_and_fp32_keep_autograd_through_the_contraction(monkeypatch):
    """Where the upcast changes nothing the contraction is autograd's own:
    no narrow-saving Function in the graph."""
    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.float64):
        a = _tensor(rng, (8, 16), dtype).requires_grad_()
        out = L.matmul_wide(a, _tensor(rng, (16, 4), dtype))
        assert out.dtype == dtype and "WideContraction" not in type(out.grad_fn).__name__


def test_plan_log_passes_metadata_queries():
    """Fake tensors of the card's type answer ``.device`` through the
    dispatcher (``prim.device``) inside a contraction: no data moves, so
    the logged plan leaves it out (the dry run's MoE cells)."""
    rng = np.random.default_rng(8)
    a, b = _tensor(rng, (6, 16), torch.float32), _tensor(rng, (16, 4), torch.float32)
    with L._PlanLog(a, b) as log:
        assert torch.ops.prim.device.default(a) == a.device
        out = torch.matmul(a, b)
    plan = log.plan()
    assert [s[0] for s in plan.steps] == [torch.ops.aten.mm.default] and plan.product == 0
    assert torch.equal(out, a @ b)


def test_no_grad_runs_the_plain_contraction():
    rng = np.random.default_rng(4)
    a, b = _tensor(rng, (8, 16)).requires_grad_(), _tensor(rng, (16, 4))
    with torch.no_grad():
        out = L.matmul_wide(a, b)
    assert out.grad_fn is None and torch.equal(out, _plain(None, a.detach(), b))


def test_swiglu_saves_narrow_operands(monkeypatch):
    rng = np.random.default_rng(5)
    x = _tensor(rng, (2, 16, 64))
    w = [_tensor(rng, s, scale=s[0] ** -0.5) for s in ((64, 96), (64, 96), (96, 64))]
    _check(monkeypatch, L.swiglu, [x, *w])


def test_moe_block_saves_narrow_operands(monkeypatch):
    """Grok-1's smoke config (E 4, top 2, d 64, f 96) in bf16, two groups."""
    cfg = smoke_lm_config(load_arch("grok-1-314b").config)
    rng = np.random.default_rng(6)
    e, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff
    x = _tensor(rng, (2, 32, d))
    router = _tensor(rng, (d, e), torch.float32, d ** -0.5)
    wg, wu = (_tensor(rng, (e, d, f), scale=d ** -0.5) for _ in range(2))
    wo = _tensor(rng, (e, f, d), scale=f ** -0.5)

    def block(x, router, wg, wu, wo):
        out, metrics = L.moe_block(x, router, wg, wu, wo, top_k=cfg.moe_top_k, group_size=32)
        return out, metrics.aux_loss

    lost = _check(monkeypatch, block, [x, router, wg, wu, wo])
    # the (G, E, C, D) dispatched tokens' fp32 copies are among the saves given up
    assert any(s[-1] == d and int(np.prod(s)) == 2 * e * L.moe_capacity(32, cfg.moe_top_k, 1.25, e) * d
               for _, s in lost), lost


def test_lm_loss_step_under_remat_saves_narrow_operands(monkeypatch):
    """One ``lm_loss`` forward and backward of the smoke TinyLlama in bf16
    with every layer under ``torch.utils.checkpoint``: the gate/up products
    and the logits save bf16 operands, and the loss and every parameter's
    gradient are bitwise the plain version's."""
    cfg = dataclasses.replace(smoke_lm_config(load_arch("tinyllama-1.1b").config), dtype=BF16, remat=True)
    model = T.TransformerLM(cfg, device="cpu")
    rng = np.random.default_rng(7)
    names = [n for n, _ in model.named_parameters()]
    values = [_tensor(rng, p.shape, p.dtype, 1.0 if n == "embed" else 0.1 if p.dim() == 1 else p.shape[-2] ** -0.5)
              for n, p in model.named_parameters()]
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 33)).astype(np.int64))
    calls = []

    def loss(*params):
        for n, v in zip(names, params):  # the leaves as the module's parameters
            owner, _, leaf = n.rpartition(".")
            target = model.get_submodule(owner) if owner else model
            target._parameters[leaf] = v
        calls.append(1)
        return T.lm_loss(model, {"tokens": tokens}, cfg)[0]

    _check(monkeypatch, loss, values)
    assert len(calls) == 2
