"""Transformer building blocks of the port: RMSNorm, RoPE, GQA attention
(prefill and cached decode), SwiGLU, and GShard MoE (``moe_block`` for
prefill, ``moe_dense_decode`` for decode).

Counterpart of ``repro/models/layers.py``.  Every function takes plain
tensors (one device) or DTensors (a mesh, under the rules of
``sharding.axes``).  On DTensors the ops GSPMD partitions for the
reference run in ``local_map`` regions on each rank's block, with the
collectives GSPMD derives made explicit:

* ``causal_attention`` runs per rank on its local heads (kernel 4 on the
  card).  Where the query heads are sharded and the kv heads are whole
  (grouped-query attention with fewer kv heads than "model" ranks), each
  rank slices the kv heads its query heads read, so the local call sees
  the same grouping; a sharding that splits a kv group is refused.
* ``decode_attention`` on a cache sharded along S combines each rank's
  max, exp-sum and weighted values by one max and two sums over the
  sequence-sharding dims; the cache is never gathered.
* ``moe_block`` and ``moe_dense_decode`` route every token on every rank
  (the router is replicated) and run the experts, or the FFN columns, that
  the rank holds; the output is a partial sum over "model".

Precision: where the reference upcasts (``astype(f32)``) or contracts with
``preferred_element_type=f32``, the port computes in fp32 — in float64 when
the inputs are float64, so that one code path also gives the float64
oracle.  An fp32-output product of bf16 inputs is an fp32 matmul of the
upcast operands: bf16 products are exact in fp32, so it is the reference's
bf16 × bf16 → fp32 contraction (TF32 stays off, see
:func:`repro_torch.device.lm_precision`).  Under autograd such a product
saves its bf16 operands, as the reference's program keeps no fp32 copy of
them, and its backward upcasts them again (exactly) and runs autograd's own
gradient products on them: the gradients are bitwise those of autograd
through the upcast, and no fp32 operand copy outlives the op.

``causal_attention`` on a CUDA tensor runs the hand-written flash kernel
(kernel 4, :func:`repro_torch.kernels.flash_attention.flash.flash_attention`)
for every case the reference serves: any head dim up to 256, a sliding
window, a query offset; under autograd it goes through
``flash.flash_attention_grad``, kernel 4's forward with the reference's
recomputing backward (plain PyTorch, as the reference's is plain JAX).  On
the CPU every case runs the plain chunked recurrence under ordinary
autograd.  The reference's ``_expand_kv`` is
:func:`repro_torch.kernels.flash_attention.flash.expand_kv` (the plain
recurrence there needs it; the kernel indexes kv heads instead).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.flash_attention import flash as F
from repro_torch.sharding.axes import block_of, replicated
from repro_torch.sharding.collectives import all_gather_rows

__all__ = ["wide_dtype", "matmul_wide", "einsum_wide", "rmsnorm", "rope", "AttnSpec",
           "causal_attention", "decode_attention", "swiglu", "MoEMetrics", "MoERoute", "moe_capacity",
           "moe_route", "moe_block", "moe_block_routed", "moe_dense_decode"]


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32, or float64 for float64: the reference's fp32 upcast."""
    return torch.promote_types(dtype, torch.float32)


def matmul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a wide (fp32 / float64) output and accumulation: the
    reference's ``einsum(..., preferred_element_type=f32)``.  Under autograd
    it saves ``a`` and ``b``, not their upcasts (module docstring)."""
    return _contract_wide(None, a, b)


def einsum_wide(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` on upcast operands: the reference's
    ``einsum(eq, a, b, preferred_element_type=f32)``.  Under autograd it
    saves ``a`` and ``b``, not their upcasts (module docstring)."""
    return _contract_wide(eq, a, b)


def _contract(eq: str | None, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b) if eq is None else torch.einsum(eq, a, b)


def _contract_wide(eq: str | None, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    wide = wide_dtype(a.dtype)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad) and (a.dtype, b.dtype) != (wide, wide):
        return _WideContraction.apply(eq, a, b)
    return _contract(eq, a.to(wide), b.to(wide))


# ``torch.matmul`` and ``torch.einsum`` decompose, below autograd, into ops
# that only move data (views, permutes, copies) around one ``mm`` or
# ``bmm``.  The backward of the narrow-saving contraction replays that
# decomposition, as logged once per operand layout, on the re-upcast
# operands and applies autograd's own formulas for each op: the same
# products on the same layouts, so the same bits.
_ATEN = torch.ops.aten
_PRODUCTS = (_ATEN.mm.default, _ATEN.bmm.default)
_PLANS: dict = {}


class _Slot(NamedTuple):
    """A tensor argument of a logged op: 0 and 1 are the upcast operands,
    k + 2 the output of the op logged k-th."""
    index: int


class _Plan(NamedTuple):
    steps: tuple   # (op, args with _Slot for tensors, kwargs, shape of the op's tensor input)
    product: int   # the index of the mm / bmm step


class _PlanLog(TorchDispatchMode):
    """Logs the aten ops one contraction runs (:class:`_Plan`)."""

    def __init__(self, *operands):
        super().__init__()
        self.slots = {id(t): i for i, t in enumerate(operands)}
        self.alive = list(operands)  # an id stays unique while its tensor lives
        self.steps = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not isinstance(out, torch.Tensor):  # a metadata query (prim.device on fake tensors) moves no data
            return out
        tensors = [x for x in args if isinstance(x, torch.Tensor)]
        if any(id(t) not in self.slots for t in tensors) or len(tensors) != (2 if func in _PRODUCTS else 1):
            raise NotImplementedError(f"wide contraction: {func} is not a data move around one product")
        self.steps.append((func, tuple(_Slot(self.slots[id(x)]) if isinstance(x, torch.Tensor) else x
                                       for x in args), kwargs, tuple(tensors[0].shape)))
        self.slots[id(out)] = len(self.alive)
        self.alive.append(out)
        return out

    def plan(self) -> _Plan:
        products = [i for i, s in enumerate(self.steps) if s[0] in _PRODUCTS]
        used = [a.index for s in self.steps for a in s[1] if isinstance(a, _Slot)]
        if len(products) != 1 or len(used) != len(set(used)) or any(
                self.steps[i][1][0].index != i + 1 for i in range(products[0] + 1, len(self.steps))):
            raise NotImplementedError("wide contraction: not one product between chains of data moves")
        return _Plan(tuple(self.steps), products[0])


def _grad_through(step, grad: torch.Tensor) -> torch.Tensor:
    """The gradient at a data move's input, by autograd's formula for it."""
    func, args, _, in_shape = step
    if func in (_ATEN.view.default, _ATEN._unsafe_view.default):
        return grad.reshape(in_shape)
    if func is _ATEN.permute.default:
        inv = [0] * len(args[1])
        for i, d in enumerate(args[1]):
            inv[d % len(inv)] = i
        return grad.permute(inv)
    if func is _ATEN.unsqueeze.default:
        return grad.squeeze(args[1])
    if func is _ATEN.clone.default:
        return grad
    raise NotImplementedError(f"wide contraction: no gradient rule for {func}")


def _col_major(t: torch.Tensor) -> bool:
    return t.stride(0) == 1 and t.stride(1) == t.shape[0]


def _product_grads(func, left, right, grad, need_left: bool, need_right: bool):
    """autograd's gradients of ``mm`` / ``bmm``: for ``mm`` a column-major
    operand gets its gradient computed transposed, as autograd does."""
    gl = gr = None
    if func is _ATEN.bmm.default:
        if need_left:
            gl = grad.bmm(right.transpose(1, 2))
        if need_right:
            gr = left.transpose(1, 2).bmm(grad)
        return gl, gr
    if need_left:
        gl = right.mm(grad.t()).t() if _col_major(left) else grad.mm(right.t())
    if need_right:
        gr = grad.t().mm(left).t() if _col_major(right) else left.t().mm(grad)
    return gl, gr


class _WideContraction(torch.autograd.Function):
    """:func:`_contract` on upcast operands, saving the narrow ones."""

    @staticmethod
    def forward(ctx, eq, a, b):
        wide = wide_dtype(a.dtype)
        aw, bw = a.to(wide), b.to(wide)
        key = (eq, type(a), a.shape, a.stride(), type(b), b.shape, b.stride(), wide)
        plan = _PLANS.get(key)
        if plan is None:
            with _PlanLog(aw, bw) as log:
                out = _contract(eq, aw, bw)
            plan = _PLANS[key] = log.plan()
        else:
            out = _contract(eq, aw, bw)
        ctx.plan, ctx.wide = plan, wide
        ctx.save_for_backward(a, b)
        return out

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        steps, k = ctx.plan.steps, ctx.plan.product
        vals = [a.to(ctx.wide), b.to(ctx.wide)]
        for func, args, kwargs, _ in steps[:k]:
            vals.append(func(*(vals[x.index] if isinstance(x, _Slot) else x for x in args), **kwargs))
        for step in reversed(steps[k + 1:]):
            grad = _grad_through(step, grad)
        roots = {0: 0, 1: 1}  # each slot's operand
        for i, (_, args, _, _) in enumerate(steps[:k]):
            roots[i + 2] = roots[args[0].index]
        (li, ri), need = (x.index for x in steps[k][1]), ctx.needs_input_grad[1:]
        grads = dict(zip((li, ri), _product_grads(steps[k][0], vals[li], vals[ri], grad,
                                                  need[roots[li]], need[roots[ri]])))
        for i in reversed(range(k)):
            g = grads.pop(i + 2, None)
            if g is not None:
                grads[steps[i][1][0].index] = _grad_through(steps[i], g)
        return (None, *(None if grads.get(i) is None else grads[i].to(t.dtype) for i, t in enumerate((a, b))))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # variance in fp32; the output multiplies in x's dtype, as the reference's
    x32 = x.to(wide_dtype(x.dtype))
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, n, head_dim); positions: (S,) or (B, S).
    Angles in fp32, as the reference computes them."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = replicated(theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half), x)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class AttnSpec(NamedTuple):
    n_heads: int
    n_kv_heads: int
    head_dim: int
    chunk: int
    window: int | None  # sliding window; None = full
    unroll: bool = False  # inert: the reference's scan unrolling


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, spec: AttnSpec, *,
                     q_offset: int = 0) -> torch.Tensor:
    """Causal attention, q (B, Sq, H, hd), k/v (B, Sk, KV, hd) → (B, Sq, H, hd).

    CUDA: kernel 4, with ``spec.window`` and ``q_offset``; when a gradient
    is recorded, through ``flash.flash_attention_grad``, whose backward
    recomputes the plain recurrence over ``spec.chunk`` keys at a time.
    CPU: the plain chunked recurrence over ``spec.chunk`` keys at a time.
    DTensors: the same, per rank on its local heads (module docstring)."""
    if isinstance(q, DTensor):
        return _causal_attention_sharded(q, k, v, spec, q_offset)
    if q.device.type == "cpu":
        return F.flash_attention_plain(q, k, v, causal=True, chunk=spec.chunk,
                                       q_offset=q_offset, window=spec.window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return F.flash_attention_grad(q, k, v, causal=True, chunk=spec.chunk, q_offset=q_offset,
                                      window=spec.window)
    return F.flash_attention(q, k, v, causal=True, q_offset=q_offset, window=spec.window)


def _mesh_dims(t: DTensor, placement) -> list[int]:
    """The mesh dims of more than one rank on which ``t`` has ``placement``."""
    return [i for i, p in enumerate(t.placements) if p == placement and t.device_mesh.size(i) > 1]


def _causal_attention_sharded(q: DTensor, k: DTensor, v: DTensor, spec: AttnSpec, q_offset: int):
    """:func:`causal_attention` on DTensors: q (B, S, H, hd) and k, v (B, S,
    KV, hd) sharded on B and the heads only, each rank's local heads through
    the one-device path.  Where q's heads are sharded over a mesh dim on
    which k's are whole, the rank's kv heads are sliced out, and their
    gradient is a partial sum over that dim."""
    mesh = q.device_mesh
    for name, t in (("q", q), ("k", k), ("v", v)):
        if any(p.is_partial() or (p.is_shard() and p.dim not in (0, 2)) for p in t.placements):
            raise ValueError(f"{name} must be sharded on batch and heads only, got {t.placements}")
    h_loc, h_off = block_of(q, 2)
    kv_loc, kv_off = block_of(k, 2)
    groups = spec.n_heads // spec.n_kv_heads
    sel = None
    if kv_loc * groups == h_loc and kv_off * groups == h_off:
        kv_grad = list(k.placements)  # both sharded alike (or both whole)
    elif kv_loc == spec.n_kv_heads:
        lo, hi = h_off // groups, (h_off + h_loc - 1) // groups + 1
        if (hi - lo) * groups != h_loc and hi - lo != 1:
            raise ValueError(f"query heads [{h_off}, {h_off + h_loc}) split a group of {groups}: "
                             f"no local call has their grouping")
        sel = (lo, hi)
        head_dims = [i for i, p in enumerate(q.placements) if p == Shard(2) and k.placements[i] == Replicate()]
        kv_grad = [Partial() if i in head_dims else p for i, p in enumerate(k.placements)]
    else:
        raise ValueError(f"kv heads {k.placements} and query heads {q.placements} are sharded differently")

    def body(ql, kl, vl):
        if sel is not None:
            kl, vl = kl[:, :, sel[0]:sel[1]], vl[:, :, sel[0]:sel[1]]
        local = spec._replace(n_heads=ql.shape[2], n_kv_heads=kl.shape[2])
        return causal_attention(ql, kl, vl, local, q_offset=q_offset)

    return local_map(body, out_placements=list(q.placements), in_placements=(q.placements, k.placements, v.placements),
                     in_grad_placements=(q.placements, kv_grad, kv_grad), device_mesh=mesh)(q, k, v)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     spec: AttnSpec, *, length) -> torch.Tensor:
    """One-token decode against the cache.  q (B, H, hd); caches (B, S, KV, hd);
    positions ``< length`` attend (``length`` an int or a 0-d tensor).
    Scale folded into q in fp32, as the reference does.  On a cache that is
    a DTensor sharded along S, each rank attends over its block and the
    blocks combine by a max and two sums over the sharding dims."""
    if isinstance(k_cache, DTensor):
        return _decode_attention_sharded(q, k_cache, v_cache, spec, length)
    return _decode_local(q, k_cache, v_cache, spec, length)


def _decode_local(q, k_cache, v_cache, spec: AttnSpec, length, *, s_off: int = 0, group=None):
    """:func:`decode_attention` over cache positions ``[s_off, s_off + S)``;
    with ``group`` the max and the sums run over it."""
    b, h, hd = q.shape
    s = k_cache.shape[1]
    kv = spec.n_kv_heads
    groups = h // kv
    wide = wide_dtype(q.dtype)
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(b, kv, groups, hd).to(wide) * scale
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(wide))  # (B, KV, G, S)
    pos = s_off + torch.arange(s, device=q.device)
    valid = pos < length
    if spec.window is not None:
        valid &= pos >= (length - spec.window)
    logits = torch.where(valid, logits, F.NEG)
    m = logits.amax(dim=-1, keepdim=True)
    if group is not None:
        m = funcol.all_reduce(m, "max", group)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(wide))
    if group is not None:
        denom = funcol.all_reduce(denom, "sum", group)
        out = funcol.all_reduce(out, "sum", group)
    out = out / denom[..., None]
    return out.reshape(b, h, hd).to(q.dtype)


def _decode_attention_sharded(q, k_cache: DTensor, v_cache: DTensor, spec: AttnSpec, length):
    """Split-KV decode: the cache (B, S, KV, hd) sharded on B and S; q is
    replicated over the S-sharding dims (its heads gathered), and the
    output follows q's placements."""
    mesh = k_cache.device_mesh
    if any(p.is_partial() or (p.is_shard() and p.dim not in (0, 1)) for p in k_cache.placements):
        raise ValueError(f"the cache must be sharded on batch and S only, got {k_cache.placements}")
    seq_dims = _mesh_dims(k_cache, Shard(1))
    if len(seq_dims) > 1:
        raise ValueError(f"S may be sharded over one mesh dim, got {k_cache.placements}")
    q_place = [k_cache.placements[i] if k_cache.placements[i] == Shard(0) else Replicate()
               for i in range(mesh.ndim)]
    s_loc, s_off = block_of(k_cache, 1)
    group = (mesh, seq_dims[0]) if seq_dims else None
    ln = length.to_local() if isinstance(length, DTensor) else length

    def body(ql, kl, vl):
        return _decode_local(ql, kl, vl, spec, ln, s_off=s_off, group=group)

    return local_map(body, out_placements=q_place, in_placements=(q_place, k_cache.placements, v_cache.placements),
                     device_mesh=mesh, redistribute_inputs=True)(q, k_cache, v_cache)


def swiglu(x: torch.Tensor, wi_gate: torch.Tensor, wi_up: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: gate and up products wide, the down product in x's dtype."""
    g = matmul_wide(x, wi_gate)
    u = matmul_wide(x, wi_up)
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    return torch.matmul(h, wo)


# ---------------------------------------------------------------------------
# GShard MoE
# ---------------------------------------------------------------------------


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor      # load-balance loss (Switch-style), fp32
    dropped_frac: torch.Tensor  # fraction of (token, choice) slots over capacity, fp32


class MoERoute(NamedTuple):
    """What the router and GShard's choice loop decided for token groups."""
    experts: torch.Tensor   # (k, G, S) int64: the expert taken at each of the k choice steps
    combine: torch.Tensor   # (G, S, E, C) wide: each kept slot's renormalised gate, else 0
    metrics: MoEMetrics


def moe_capacity(g_size: int, top_k: int, capacity_factor: float, e: int) -> int:
    """Slots per expert and group: ``g_size·top_k·cf / E`` truncated, at least 1."""
    return max(1, int(g_size * top_k * capacity_factor / e))


def _token_groups(x: torch.Tensor, group_size: int) -> torch.Tensor:
    """(B, S, D) or (T, D) → (G, min(group_size, T), D)."""
    tokens = x.reshape(-1, x.shape[-1])
    t = tokens.shape[0]
    g_size = min(group_size, t)
    n_groups = t // g_size
    if n_groups * g_size != t:
        raise ValueError(f"{t} tokens not divisible into {g_size}-groups")
    return tokens.reshape(n_groups, g_size, x.shape[-1])


def moe_route(xs: torch.Tensor, router_w: torch.Tensor, *, top_k: int, cap: int,
              experts: torch.Tensor | None = None) -> MoERoute:
    """The router (wide, on upcast ``xs`` (G, S, D)) and the reference's top-k
    choice loop: each step takes the first argmax of the probabilities not
    yet taken, the token's place in its expert is its rank in the group
    after the expert's earlier fills, and places ``>= cap`` are dropped.

    ``experts`` (k, G, S), when given, stands in for each step's argmax and
    everything else — gates, places, drops, the aux loss — follows from it
    as usual: a float64 oracle thereby takes a bf16 run's routing.

    ``combine`` is scattered slot by slot: each (g, s, e, c) slot receives
    at most one nonzero gate, so it holds the values of the reference's sum
    of one-hot products without materialising a (G, S, E, C) temporary per
    step."""
    wide = wide_dtype(xs.dtype)
    g, s, _ = xs.shape
    e = router_w.shape[1]
    probs = torch.softmax(matmul_wide(xs, router_w), dim=-1)  # (G, S, E)
    dev = xs.device
    gi = torch.arange(g, device=dev)[:, None]
    si = torch.arange(s, device=dev)[None, :]
    combine = torch.zeros((g, s, e, cap), dtype=wide, device=dev)
    remaining = probs
    base_count = torch.zeros((g, 1, e), dtype=torch.long, device=dev)
    gates_sum = torch.zeros((g, s), dtype=wide, device=dev)
    dropped = torch.zeros((), dtype=torch.long, device=dev)
    aux_me = torch.zeros((g, e), dtype=wide, device=dev)
    aux_ce = torch.zeros((g, e), dtype=wide, device=dev)
    taken = []
    for j in range(top_k):
        idx = torch.argmax(remaining, dim=-1) if experts is None else experts[j]  # (G, S)
        gate = torch.gather(remaining, -1, idx[..., None])[..., 0]  # the max when idx is the argmax
        onehot = torch.nn.functional.one_hot(idx, e)  # (G, S, E) int64
        pos = torch.gather(torch.cumsum(onehot, dim=1) - onehot + base_count, -1, idx[..., None])[..., 0]
        base_count = base_count + onehot.sum(dim=1, keepdim=True)
        keep = (pos < cap).to(wide)
        dropped = dropped + (pos >= cap).sum()
        # a dropped choice adds 0 to its expert's last slot: no value changes
        combine.index_put_((gi, si, idx, torch.clamp(pos, max=cap - 1)), gate * keep, accumulate=True)
        gates_sum = gates_sum + gate * keep
        aux_me = aux_me + torch.mean(probs, dim=1)
        aux_ce = aux_ce + torch.mean(onehot.to(wide), dim=1)
        remaining = remaining * (1.0 - onehot.to(wide))
        taken.append(idx)
    # renormalise combine weights over the k kept choices
    combine = combine / torch.clamp(gates_sum, min=1e-9)[..., None, None]
    aux_loss = torch.mean(torch.sum((aux_me / top_k) * (aux_ce / top_k), dim=-1)) * e
    metrics = MoEMetrics(aux_loss=aux_loss.to(torch.float32),
                         dropped_frac=dropped.to(torch.float32) / (g * s * top_k))
    return MoERoute(experts=torch.stack(taken), combine=combine, metrics=metrics)


def moe_block_routed(x: torch.Tensor, router_w: torch.Tensor, wi_gate: torch.Tensor,
                     wi_up: torch.Tensor, wo: torch.Tensor, *, top_k: int,
                     capacity_factor: float = 1.25, group_size: int = 2048,
                     experts: torch.Tensor | None = None):
    """:func:`moe_block` that also returns the routing it took, (k, G, S)
    expert ids, and takes one (``experts``) in place of its own argmaxes
    (:func:`moe_route`).  Returns (out, MoEMetrics, experts)."""
    xs = _token_groups(x, group_size)
    cap = moe_capacity(xs.shape[1], top_k, capacity_factor, router_w.shape[1])
    route = moe_route(xs, router_w, top_k=top_k, cap=cap, experts=experts)
    out = _moe_experts(xs, route.combine, wi_gate, wi_up, wo)
    return out.reshape(x.shape).to(x.dtype), route.metrics, route.experts


def _moe_experts(xs, combine, wi_gate, wi_up, wo):
    """Dispatch, the experts' SwiGLU and combine for the experts of
    ``combine`` (G, S, E, C) and the weights (E, D, F) / (E, F, D)."""
    dispatch = (combine > 0.0).to(xs.dtype)
    xd = einsum_wide("gsec,gsd->gecd", dispatch, xs).to(xs.dtype)
    del dispatch
    hg = einsum_wide("gecd,edf->gecf", xd, wi_gate)
    hu = einsum_wide("gecd,edf->gecf", xd, wi_up)
    h = (torch.nn.functional.silu(hg) * hu).to(xs.dtype)
    del hg, hu
    y = torch.einsum("gecf,efd->gecd", h, wo)  # in x's dtype, as the reference's
    return einsum_wide("gsec,gecd->gsd", combine.to(xs.dtype), y)


def _group_span(x: DTensor, g_size: int):
    """None when each rank's tokens hold whole routing groups; else (the
    process group over x's token-sharding dims, the k ranks a group spans,
    this rank's index in that process group)."""
    mesh = x.device_mesh
    dims = [i for i, p in enumerate(x.placements) if p == Shard(0) and mesh.size(i) > 1]
    t_loc = x.numel() // x.shape[-1]
    for i in dims:
        t_loc //= mesh.size(i)
    if t_loc % g_size == 0:
        return None
    if g_size % t_loc:
        raise ValueError(f"a rank's {t_loc} tokens neither hold nor divide routing groups of {g_size}")
    from repro_torch.core.distributed import batch_group

    group = batch_group(mesh, [mesh.mesh_dim_names[i] for i in dims])
    return group, g_size // t_loc, torch.distributed.get_rank(group)


def _moe_sharded(x: DTensor, router_w, wi_gate, wi_up, wo, local_fn, n_out: int):
    """Run ``local_fn(x, router, wi_gate, wi_up, wo, e_off)`` per rank on its
    tokens, the whole router and its block of the experts (E sharded) or of
    the FFN columns (F sharded); x must be whole on the mesh dims that
    shard the weights.  The first output is a partial sum over those dims
    with x's other placements; the rest (per-token-group means) are means
    over every mesh dim.  A replicated input's gradient is a partial sum:
    each rank's share comes from its own tokens and experts."""
    mesh = x.device_mesh
    ep_dims = [i for i, p in enumerate(wi_gate.placements) if p.is_shard() and p.dim in (0, 2)]
    if any(x.placements[i] != Replicate() for i in ep_dims):
        raise ValueError(f"tokens {x.placements} must be whole over the experts' mesh dims {ep_dims}")
    _, e_off = block_of(wi_gate, 0)
    out_place = [Partial() if i in ep_dims else p for i, p in enumerate(x.placements)]
    # a mean over the ranks as a partial sum of each rank's share: the
    # gradient of a local_map output reaches each rank whole, which is right
    # for a sum and not for an average
    mean_place = [Partial()] * mesh.ndim
    n_ranks = mesh.size()
    ins = (x, router_w, wi_gate, wi_up, wo)
    in_place = tuple(t.placements for t in ins)

    def body(*local):
        out, *means = local_fn(*local, e_off)
        return (out, *(m / n_ranks for m in means))

    return local_map(body, out_placements=(out_place, *[mean_place] * (n_out - 1)), in_placements=in_place,
                     in_grad_placements=tuple([Partial() if p == Replicate() else p for p in pl] for pl in in_place),
                     device_mesh=mesh)(*ins)


def moe_block(x: torch.Tensor, router_w: torch.Tensor, wi_gate: torch.Tensor, wi_up: torch.Tensor,
              wo: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
              group_size: int = 2048) -> tuple[torch.Tensor, MoEMetrics]:
    """GShard top-k routing with capacity + dispatch/combine einsums.

    x (B, S, D) or (T, D); router_w (D, E); wi_gate, wi_up (E, D, F); wo
    (E, F, D).  Tokens are split into groups of ``group_size``; each group
    has expert capacity C = ``moe_capacity``.  Over-capacity (token, choice)
    pairs are dropped (their combine weight is 0); ``dropped_frac`` reports
    them.  On DTensors each rank routes its tokens over every expert and
    runs the experts (or FFN columns) it holds: ``out`` is then a partial
    sum over "model", the metrics means over the mesh."""
    if isinstance(x, DTensor):
        g_size = min(group_size, x.numel() // x.shape[-1])  # the reference's groups, of all tokens
        span = _group_span(x, g_size)

        def local(xl, rl, wg, wu, wol, e_off):
            tokens = xl.reshape(-1, xl.shape[-1])
            if span is not None:  # the group holds k ranks' tokens: route it whole, keep this rank's rows
                group, k, r = span
                tokens = all_gather_rows(tokens, group)[(r // k) * g_size:(r // k + 1) * g_size]
            xs = _token_groups(tokens, g_size)
            route = moe_route(xs, rl, top_k=top_k, cap=moe_capacity(xs.shape[1], top_k, capacity_factor,
                                                                   rl.shape[1]))
            combine = route.combine[:, :, e_off:e_off + wg.shape[0]]
            out = _moe_experts(xs, combine, wg, wu, wol).reshape(-1, xl.shape[-1])
            if span is not None:
                t_loc = xl.numel() // xl.shape[-1]
                out = out[(r % k) * t_loc:(r % k + 1) * t_loc]
            return out.reshape(xl.shape).to(xl.dtype), route.metrics.aux_loss, route.metrics.dropped_frac

        out, aux, dropped = _moe_sharded(x, router_w, wi_gate, wi_up, wo, local, 3)
        return out, MoEMetrics(aux_loss=aux, dropped_frac=dropped)
    out, metrics, _ = moe_block_routed(x, router_w, wi_gate, wi_up, wo, top_k=top_k,
                                       capacity_factor=capacity_factor, group_size=group_size)
    return out, metrics


def moe_dense_decode(x: torch.Tensor, router_w: torch.Tensor, wi_gate: torch.Tensor,
                     wi_up: torch.Tensor, wo: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """Decode-path MoE: every expert runs on every token (B, D), combined with
    the top-k gates renormalised.  The top k are every probability at or
    above the k-th largest, so a tie at that threshold takes more than k
    experts, as the reference's does."""
    if isinstance(x, DTensor):
        def local(xl, rl, wg, wu, wol, e_off):
            return _moe_dense_local(xl, rl, wg, wu, wol, top_k, e_off),

        return _moe_sharded(x, router_w, wi_gate, wi_up, wo, local, 1)[0]
    return _moe_dense_local(x, router_w, wi_gate, wi_up, wo, top_k, 0)


def _moe_dense_local(x, router_w, wi_gate, wi_up, wo, top_k: int, e_off: int):
    """:func:`moe_dense_decode` over the experts ``[e_off, e_off + E_local)``
    of the weights given (all of them at ``e_off`` 0 and full weights)."""
    probs = torch.softmax(matmul_wide(x, router_w), dim=-1)  # (B, E)
    thresh = torch.topk(probs, top_k, dim=-1).values[:, -1:]
    gates = torch.where(probs >= thresh, probs, 0.0)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    gates = gates[:, e_off:e_off + wi_gate.shape[0]]
    hg = einsum_wide("bd,edf->bef", x, wi_gate)
    hu = einsum_wide("bd,edf->bef", x, wi_up)
    h = (torch.nn.functional.silu(hg) * hu).to(x.dtype)
    y = torch.einsum("bef,efd->bed", h, wo)  # in x's dtype, as the reference's
    return einsum_wide("bed,be->bd", y, gates.to(x.dtype)).to(x.dtype)
