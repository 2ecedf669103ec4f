"""Training loop: the step builders and the orchestration layer.

Counterpart of ``repro/train/loop.py``.  Two step modes:

  * :func:`make_train_step` — one device: gradients by autograd, with
    gradient accumulation over microbatches in fp32 buffers (the
    reference's ``lax.scan`` of ``acc_body``), then the optimizer.
  * :func:`make_explicit_dp_step` — data parallel over a
    ``torch.distributed`` group with *replicated* params and a rank-local
    batch: the gradient sync is explicit, so it can run compressed (int8 /
    PowerSGD, ``repro_torch.train.compression``).

:func:`fit` wires the rest, in the reference's order per step: data,
injected failure, step, heartbeat, straggler, log, checkpoint, drift hook;
async checkpointing and restore-retry through ``run_with_recovery``.

``params`` is what ``loss_fn(params, batch) → (loss, metrics)`` takes: an
``nn.Module`` (its parameters that require grad are the trained ones, by
name) or a dict of named tensors that require grad.  The optimizer updates
them in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.device import lm_precision
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import compression as comp_mod
from repro_torch.train.fault_tolerance import Heartbeat, StragglerDetector, run_with_recovery
from repro_torch.train.optimizer import Optimizer, _settled

__all__ = ["TrainConfig", "named_params", "make_set_distance_metric", "make_train_step",
           "make_explicit_dp_step", "fit"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1          # gradient-accumulation chunks per step
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    max_failures: int = 3
    drift_every: int = 0           # 0 = off; else drift hook cadence
    compression: str | None = None  # None | "int8" | "powersgd"
    powersgd_rank: int = 4


def named_params(params) -> dict[str, torch.Tensor]:
    """The trained tensors by name: a module's parameters that require
    grad, or the dict itself."""
    if isinstance(params, torch.nn.Module):
        return {n: p for n, p in params.named_parameters() if p.requires_grad}
    return dict(params)


# ---------------------------------------------------------------------------
# Set-distance metrics (losses / drift signals) via the repro_torch.hd front door
# ---------------------------------------------------------------------------


def make_set_distance_metric(variant: str = "chamfer", method: str = "exact", backend: str = "auto",
                             config=None):
    """Build ``metric(x, y, *, generator=None) -> HDResult`` for training code.

    A front-door engine call, so the estimator, variant and backend are
    run-time configuration.  Chamfer is the smooth choice for a loss term;
    ``method="prohd"`` gives the certified drift signal (see
    ``repro_torch.core.streaming`` for the stateful monitor).

    Differentiability caveat: only the plain PyTorch backends ("tiled",
    "dense") carry a gradient — the CUDA kernels define no backward, and
    ``backend="auto"`` picks them on the card.  Pass ``backend="tiled"``
    explicitly when the metric sits under autograd: a kernel launch with
    inputs that require grad, under grad mode, raises instead of returning
    a value that would carry no gradient.
    """
    from repro_torch.hd import HDConfig, HDEngine

    engine = HDEngine(variant=variant, method=method, backend=backend,
                      config=config if config is not None else HDConfig())

    def metric(x, y, *, generator=None):
        return engine(x, y, generator=generator)

    return metric


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def _grads(loss_fn, params, named: dict, batch):
    """(loss, metrics, grads) of one forward and backward, both under the LM
    precision rule (autograd's backward runs after the forward's own
    context has closed)."""
    with lm_precision():
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), metrics, dict(zip(named, grads))


def _split(batch: dict, microbatches: int) -> list[dict]:
    """The batch's leading dim cut into ``microbatches`` equal parts.  A
    DTensor is cut on each rank, so every microbatch keeps the batch's
    placements and each rank's share of it."""
    out = [{} for _ in range(microbatches)]
    for k, x in batch.items():
        b = x.shape[0]
        local = x.to_local() if isinstance(x, DTensor) else x
        if local.shape[0] % microbatches:
            raise ValueError(f"batch {k!r} of {local.shape[0]} rows does not split into {microbatches} microbatches")
        parts = local.reshape(microbatches, local.shape[0] // microbatches, *local.shape[1:])
        for i, part in enumerate(parts):
            if isinstance(x, DTensor):
                part = DTensor.from_local(part, x.device_mesh, x.placements, run_check=False,
                                          shape=(b // microbatches, *x.shape[1:]),
                                          stride=torch.empty(b // microbatches, *x.shape[1:], device="meta").stride())
            out[i][k] = part
    return out


def _detached(metrics: dict) -> dict:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}


def make_train_step(loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict]], optimizer: Optimizer, *,
                    microbatches: int = 1):
    """``step(params, opt_state, batch) → (opt_state, metrics)``; the
    parameters are updated in place.  ``metrics`` holds ``loss_fn``'s (the
    last microbatch's), ``loss`` and ``grad_norm`` (fp32 L2 over every
    gradient), as device tensors.

    With ``microbatches > 1`` the batch's leading dim is split and each
    part's gradients added into fp32 buffers, then loss and gradients are
    divided by the count — the reference's ``acc_body``; no gradient
    accumulates in the parameters' dtype."""

    def step(params, opt_state, batch):
        named = named_params(params)
        if microbatches == 1:
            loss, metrics, grads = _grads(loss_fn, params, named, batch)
        else:
            grads = {n: None if isinstance(p, DTensor) else torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in named.items()}
            loss = 0.0
            for mb in _split(batch, microbatches):
                mb_loss, metrics, g = _grads(loss_fn, params, named, mb)
                for n, gn in g.items():
                    if grads[n] is None:  # a DTensor gradient keeps its placements (a partial sum stays one)
                        grads[n] = gn.to(torch.float32)
                    elif isinstance(gn, DTensor):
                        grads[n] = grads[n] + gn.to(torch.float32)
                    else:
                        grads[n].add_(gn.to(torch.float32))
                del g
                loss = loss + mb_loss
            grads = {n: g / microbatches if isinstance(g, DTensor) else g.div_(microbatches) for n, g in grads.items()}
            loss = loss / microbatches
        _, opt_state = optimizer.update(grads, opt_state, named)
        gnorm = torch.sqrt(sum(_settled(torch.sum(g.to(torch.float32) ** 2)) for g in grads.values()))
        return opt_state, dict(_detached(metrics), loss=loss, grad_norm=gnorm)

    return step


def make_explicit_dp_step(loss_fn, optimizer: Optimizer, mesh, *, batch_axes: tuple[str, ...] = ("data",),
                          compression: str | None = None, powersgd_rank: int = 4):
    """Explicit data-parallel step with a (compressed) gradient all-reduce.

    SPMD over the process group of ``mesh``'s ``batch_axes``
    (``repro_torch.core.distributed.batch_group``; gloo on the CPU, NCCL on
    the card): every rank holds the same parameters and calls
    ``step(params, opt_state, comp_state, batch)`` with its OWN rows of
    the batch; it computes local gradients, all-reduces them — as int8
    (``compression="int8"``), PowerSGD factors (``"powersgd"``) or fp
    means (None) — and every rank applies the same update.  Returns
    ``(step_fn, init_comp_state)``; ``step_fn`` returns ``(opt_state,
    comp_state, metrics)`` with the loss and metrics averaged over the
    group, and ``init_comp_state(params, generator=None)`` makes the
    compressor's error feedback (and PowerSGD's factors, from
    ``generator``, by default a CPU generator seeded 0)."""
    from repro_torch.core.distributed import batch_group

    if compression not in (None, "int8", "powersgd"):
        raise ValueError(f"compression must be None, 'int8' or 'powersgd', got {compression!r}")
    group = batch_group(mesh, batch_axes)
    n_ranks = dist.get_world_size(group)

    def pmean(x: torch.Tensor) -> torch.Tensor:
        x = x.detach().clone()
        dist.all_reduce(x, group=group)
        return x / n_ranks

    def step(params, opt_state, comp_state, batch):
        named = named_params(params)
        loss, metrics, g = _grads(loss_fn, params, named, batch)
        if compression == "int8":
            g, comp_state = comp_mod.compressed_psum_int8(g, comp_state, group)
        elif compression == "powersgd":
            g, comp_state = comp_mod.powersgd_round(g, comp_state, group)
        else:
            g = {n: pmean(x) for n, x in g.items()}
        metrics = {k: pmean(v) for k, v in metrics.items()}
        _, opt_state = optimizer.update(g, opt_state, named)
        return opt_state, comp_state, dict(metrics, loss=pmean(loss))

    def init_comp_state(params, generator: torch.Generator | None = None):
        named = named_params(params)
        if compression == "int8":
            return comp_mod.init_error_tree(named)
        if compression == "powersgd":
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            return comp_mod.init_powersgd(named, powersgd_rank, generator)
        return {}

    return step, init_comp_state


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------


def fit(*, params: Any, optimizer: Optimizer, loss_fn, data_iter_fn: Callable[[int], Iterator[Any]],
        cfg: TrainConfig, drift_hook: Callable[[Any, dict], None] | None = None,
        log_fn: Callable[[int, dict], None] | None = None,
        _fail_at: int | None = None) -> tuple[Any, dict, list[dict]]:
    """Run the full fault-tolerant loop.  Returns (params, opt_state, logs).

    ``params`` is trained in place.  As in the reference, ``_fail_at``
    injects one failure at that step (a test hook), after which the loop
    restores the latest checkpoint and resumes at its step + 1.  Two
    things differ, both because PyTorch runs eagerly: a step ends when its
    metrics reach the host (the device is synchronised there, so ``dt``
    is the step's time and not its enqueue time), and the restore first
    waits for an in-flight checkpoint write, so it resumes from the newest
    save.  ``drift_hook`` runs under ``torch.no_grad()``: a monitor takes
    no part in the gradient.

    DTensor parameters (and the optimizer state, which takes their
    placements) run on every rank of their mesh: each checkpoint is
    gathered on every rank and written by rank 0, and the restore puts
    every leaf back with its live leaf's mesh and placements."""
    named = named_params(params)
    opt_state = optimizer.init(named)
    step_fn = make_train_step(loss_fn, optimizer, microbatches=cfg.microbatches)
    hb = Heartbeat()
    straggler = StragglerDetector()
    logs: list[dict] = []
    ckpt = ckpt_mod.AsyncCheckpointer(cfg.ckpt_dir) if cfg.ckpt_dir else None
    failed_once = {"armed": _fail_at is not None}

    def state() -> dict:
        return {"params": named, "opt": opt_state}

    def restore() -> int:
        nonlocal opt_state
        if ckpt:
            ckpt.wait()
        if cfg.ckpt_dir and ckpt_mod.latest_step(cfg.ckpt_dir) is not None:
            tree, step = ckpt_mod.restore(cfg.ckpt_dir, state())
            with torch.no_grad():
                for n, p in named.items():
                    p.copy_(tree["params"][n])
            opt_state = tree["opt"]
            return step + 1
        return 0

    def run(start: int) -> int:
        nonlocal opt_state
        it = data_iter_fn(start)
        for step in range(start, cfg.steps):
            t0 = time.monotonic()
            batch = next(it)
            if failed_once["armed"] and step == _fail_at:
                failed_once["armed"] = False
                raise RuntimeError(f"injected failure at step {step}")
            opt_state, metrics = step_fn(params, opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            hb.beat()
            dt = time.monotonic() - t0
            is_straggler = straggler.observe(dt)
            if step % cfg.log_every == 0 or step == cfg.steps - 1:
                rec = dict(metrics, step=step, dt=dt, straggler=is_straggler)
                logs.append(rec)
                if log_fn:
                    log_fn(step, rec)
            if ckpt and cfg.ckpt_every and step % cfg.ckpt_every == 0 and step > 0:
                ckpt.save(step, state())
            if drift_hook and cfg.drift_every and step % cfg.drift_every == 0:
                with torch.no_grad():
                    drift_hook(params, {"step": step})
        if ckpt:
            ckpt.save(cfg.steps - 1, state())
            ckpt.wait()
        return cfg.steps

    run_with_recovery(run, restore, max_failures=cfg.max_failures)
    return params, opt_state, logs
