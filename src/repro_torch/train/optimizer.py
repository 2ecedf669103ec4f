"""The reference's optimizers in PyTorch: AdamW, Adafactor and SGD.

Counterpart of ``repro/train/optimizer.py``.  The reference writes its own
optimizers (no optax), and those functions are the specification here, not
``torch.optim``: the same ``init(params) → state`` / ``update(grads, state,
params) → (params, state)`` shape and the same arithmetic, op for op, in
fp32 — bias corrections from an int32 step count cast to fp32, the fp32
master copy with ``master_fp32`` (the live parameters may be bf16),
Adafactor's factored row/column statistics wherever the last two dims are
both > 1, its ``eps`` of 1e-30 and RMS update clipping.

``params`` and ``grads`` are dicts of named tensors (``dict(model.
named_parameters())``; the reference's nested pytree flattened with ``.``),
and the state a dict of such dicts.  ``update`` writes each new parameter
into its tensor in place under ``torch.no_grad()`` and returns the same
dict: a module's parameters stay the module's.

``state_specs(param_specs)`` gives the state's specs from the parameters'
(the reference's: AdamW's mu, nu and master mirror them, Adafactor's row
statistics drop the last dim's entry and its column statistics the one
before, SGD's mu mirrors them; the count is replicated).  On DTensor
parameters ``init`` makes DTensor state placed like each parameter, and
``update`` takes each gradient to its state's placements first (a partial
sum over the batch axes is all-reduced there, or reduce-scattered where the
state is sharded more finely, as ZeRO-1's is) and each new master to its
parameter's placements last (ZeRO-1's all-gather).  Adafactor's rank-1
estimate ``vr ⊗ vc`` is computed on each rank's block, placed like the
gradient (:func:`_outer`).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

__all__ = ["Optimizer", "adamw", "adafactor", "sgd"]


class Optimizer(NamedTuple):
    init: Callable[[dict], dict]
    update: Callable[[dict, dict, dict], tuple[dict, dict]]  # (grads, state, params) → (params, new state)
    state_specs: Callable[[Any], dict]  # param specs → state specs


def _zeros32(params: dict) -> dict:
    return {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}


def _master_copy(params: dict) -> dict:
    # a copy even for fp32 parameters: the master must not alias them
    return {n: p.detach().to(torch.float32, copy=True) for n, p in params.items()}


def _outer(vr: torch.Tensor, vc: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``vr[..., None] * vc[..., None, :]``, the factored second moment's
    rank-1 estimate, placed like ``like`` (the gradient).  On a mesh each
    rank multiplies its own row and column blocks: DTensor's rule for a
    broadcast product follows ``vr``'s placements and would gather the
    columns whole on every rank, a (…, rows / p, cols) fp32 temporary and
    two more after it (the dry run's Grok-1 train step on (16, 16))."""
    if not isinstance(like, DTensor):
        return vr[..., None] * vc[..., None, :]
    rows, cols = like.ndim - 2, like.ndim - 1

    def dropped(dim):  # ``like``'s placements on a statistic without ``dim``
        return [Replicate() if p == Shard(dim) else Shard(p.dim - (p.dim > dim)) if p.is_shard() else p
                for p in like.placements]

    return local_map(lambda r, c: r[..., None] * c[..., None, :], out_placements=list(like.placements),
                     in_placements=(dropped(cols), dropped(rows)), device_mesh=like.device_mesh,
                     redistribute_inputs=True)(vr, vc)


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` with ``ref``'s placements (``t`` itself off a mesh)."""
    if isinstance(t, DTensor) and tuple(t.placements) != tuple(ref.placements):
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


@torch.no_grad()
def _write(params: dict, master: dict) -> dict:
    """Each parameter ← its master, cast to the parameter's dtype."""
    for n, p in params.items():
        p.copy_(_like(master[n], p).to(p.dtype))
    return params


def _settled(t: torch.Tensor) -> torch.Tensor:
    """A DTensor with its partial placements reduced (replicated there)."""
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        from torch.distributed.tensor import Replicate

        return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p for p in t.placements])
    return t


def _leaf_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _leaf_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _count_and_masters(state: dict, params: dict):
    count = state["count"] + 1
    masters = state.get("master") or {n: p.detach().to(torch.float32) for n, p in params.items()}
    return count, masters


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, master_fp32: bool = True) -> Optimizer:
    def init(params: dict) -> dict:
        dev = next(iter(params.values())).device
        state = {"mu": _zeros32(params), "nu": _zeros32(params),
                 "count": torch.zeros((), dtype=torch.int32, device=dev)}
        if master_fp32:
            state["master"] = _master_copy(params)
        return state

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict):
        count, masters = _count_and_masters(state, params)
        c1 = 1.0 - b1 ** count.to(torch.float32)
        c2 = 1.0 - b2 ** count.to(torch.float32)
        mu, nu, master = {}, {}, {}
        for n, g in grads.items():
            g = _like(g, state["mu"][n]).to(torch.float32)
            mu[n] = b1 * state["mu"][n] + (1 - b1) * g
            nu[n] = b2 * state["nu"][n] + (1 - b2) * g * g
            step = (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps)
            master[n] = masters[n] - lr * (step + weight_decay * masters[n])
        new_state = {"mu": mu, "nu": nu, "count": count}
        if master_fp32:
            new_state["master"] = master
        return _write(params, master), new_state

    def state_specs(param_specs):
        specs = {"mu": param_specs, "nu": param_specs, "count": ()}
        if master_fp32:
            specs["master"] = param_specs
        return specs

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018) — factored second moment, no momentum
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0, master_fp32: bool = True) -> Optimizer:
    def init(params: dict) -> dict:
        def mk(p):
            z = dict(dtype=torch.float32, device=p.device)
            if isinstance(p, DTensor):  # the statistics placed as the parameter's means
                zero = torch.zeros_like(p, dtype=torch.float32)
                if _factored(p.shape):
                    return {"vr": _settled(torch.mean(zero, dim=-1)), "vc": _settled(torch.mean(zero, dim=-2))}
                return {"v": zero}
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **z),                       # row stats
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}        # col stats
            return {"v": torch.zeros(p.shape, **z)}

        dev = next(iter(params.values())).device
        state = {"v": {n: mk(p) for n, p in params.items()},
                 "count": torch.zeros((), dtype=torch.int32, device=dev)}
        if master_fp32:
            state["master"] = _master_copy(params)
        return state

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict):
        count, masters = _count_and_masters(state, params)
        beta = 1.0 - count.to(torch.float32) ** -decay
        new_v, master = {}, {}
        for n, g in grads.items():
            v = state["v"][n]
            g = _like(g, masters[n]).to(torch.float32)
            g2 = g * g + eps
            if "vr" in v:
                vr = _like(beta * v["vr"] + (1 - beta) * torch.mean(g2, dim=-1), v["vr"])
                vc = _like(beta * v["vc"] + (1 - beta) * torch.mean(g2, dim=-2), v["vc"])
                denom = torch.sqrt(_outer(vr, vc, g) / torch.clamp(
                    torch.mean(vr, dim=-1, keepdim=True)[..., None], min=eps))
                new_v[n] = {"vr": vr, "vc": vc}
            else:
                nv = beta * v["v"] + (1 - beta) * g2
                denom = torch.sqrt(nv)
                new_v[n] = {"v": nv}
            step = g / torch.clamp(denom, min=eps)
            # RMS update clipping
            rms = torch.sqrt(torch.mean(step * step) + eps)
            step = step / torch.clamp(rms / clip_threshold, min=1.0)
            master[n] = _like(masters[n] - lr * (step + weight_decay * masters[n]), masters[n])
        new_state = {"v": new_v, "count": count}
        if master_fp32:
            new_state["master"] = master
        return _write(params, master), new_state

    def state_specs(param_specs):
        def mk(spec):
            # vr drops the last dim's entry, vc the second-to-last's
            parts = tuple(spec or ())
            if len(parts) >= 2:
                return {"vr": parts[:-1], "vc": parts[:-2] + parts[-1:]}
            return {"v": parts}

        specs = {"v": _leaf_map(mk, param_specs), "count": ()}
        if master_fp32:
            specs["master"] = param_specs
        return specs

    return Optimizer(init, update, state_specs)


def sgd(lr: float = 0.1, momentum: float = 0.0) -> Optimizer:
    """Plain SGD (with heavy-ball momentum when ``momentum`` is nonzero)."""

    def init(params: dict) -> dict:
        return {"mu": _zeros32(params)} if momentum else {}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict):
        if momentum:
            mu = {n: momentum * state["mu"][n] + _like(g, state["mu"][n]).to(torch.float32)
                  for n, g in grads.items()}
            _write(params, {n: _like(p.to(torch.float32), mu[n]) - lr * mu[n] for n, p in params.items()})
            return params, {"mu": mu}
        _write(params, {n: p.to(torch.float32) - lr * _like(grads[n], p).to(torch.float32)
                        for n, p in params.items()})
        return params, state

    def state_specs(param_specs):
        return {"mu": param_specs} if momentum else {}

    return Optimizer(init, update, state_specs)
