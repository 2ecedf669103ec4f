"""Where the port's tensors live, and its fp32 arithmetic contract.

Device rule: numpy inputs go to ``cuda`` unless the caller passes
``device=``; a tensor stays on its own device.  When no GPU is present and
the caller asked for none of the CPU, the call raises — there is no silent
CPU fallback.

Precision rule of the Hausdorff path: every matmul is IEEE fp32 with fp32
accumulation.  cuBLAS and cuDNN may use TF32 for fp32 inputs when their
flags allow it; :func:`strict_fp32` turns both flags off and is called
where the port does its matmuls.

The LM path (``repro_torch.models``) is bf16 and exempt from the IEEE-fp32
rule for its bf16 products; :func:`lm_precision` is its rule, held only for
the duration of an LM entry point's call.

Randomness rule: a randomised entry point draws from an explicit
``torch.Generator`` (the counterpart of the reference's ``key=``), which
must live on the device of the tensors it draws for
(:func:`check_generator`); :func:`clone_generator` copies one so that a
functional state can advance the copy and leave the original as it was.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = [
    "strict_fp32",
    "lm_precision",
    "resolve_device",
    "as_tensor",
    "as_mask",
    "check_generator",
    "clone_generator",
    "widen",
]


def strict_fp32() -> None:
    """Pin fp32 matmuls to IEEE fp32 (no TF32 in cuBLAS or cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def lm_precision():
    """Inside the block (or the decorated call), the LM's rule; on exit the
    flags are as they were.

    * ``allow_tf32`` off: it governs the fp32 matmuls, which are the
      reference's ``einsum(..., preferred_element_type=f32)`` contractions
      of upcast bf16 operands (``layers.matmul_wide``: the logits and the
      SwiGLU gate/up products) and the plain attention's products.
    * ``allow_bf16_reduced_precision_reduction`` off: it governs the
      bf16-output matmuls (the q/k/v/o projections and the SwiGLU down
      product), which then accumulate in fp32 throughout.
    """
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = saved


def resolve_device(x=None, device=None) -> torch.device:
    """The device a call runs on: ``device`` if given, else the tensor's
    own device, else ``cuda`` (raising when no GPU is present)."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' or CPU tensors "
            "to run on the CPU"
        )
    return dev


def as_tensor(x, device=None) -> torch.Tensor:
    """A numpy array or tensor as a tensor on the resolved device."""
    dev = resolve_device(x, device)
    if isinstance(x, torch.Tensor):
        return x if x.device == dev else x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def as_mask(v, device) -> torch.Tensor | None:
    """An optional row-validity mask as a bool tensor on ``device``."""
    if v is None:
        return None
    return as_tensor(v, device).to(torch.bool)


def check_generator(generator: torch.Generator, device: torch.device, what: str) -> torch.Generator:
    """``generator`` itself when it draws on ``device``'s kind; a CPU
    generator cannot drive a CUDA draw, nor a CUDA one a CPU draw."""
    if not isinstance(generator, torch.Generator):
        raise ValueError(f"{what} needs a torch.Generator, got {type(generator).__name__}")
    if generator.device.type != torch.device(device).type:
        raise ValueError(
            f"{what}: the generator is on {generator.device.type!r} but the data is on "
            f"{torch.device(device).type!r}; make the generator on the data's device "
            "(torch.Generator(device=...))"
        )
    return generator


def clone_generator(generator: torch.Generator) -> torch.Generator:
    """A new generator on the same device in the same state."""
    g = torch.Generator(device=generator.device)
    g.set_state(generator.get_state())
    return g


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, the reference's ``astype(float32)`` — or in float64
    when it is float64, so a float64 copy of a model runs the same code
    as an oracle without dropping to fp32 anywhere."""
    return x if x.dtype == torch.float64 else x.float()
