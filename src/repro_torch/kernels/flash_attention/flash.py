"""Flash attention: the hand-written CUDA forward kernels, their launcher,
the wrapper, its autograd Function and the plain version.

Counterpart of ``repro/kernels/flash_attention/flash.py`` (the Pallas
``_flash_kernel``, ``flash.py:38``).  All of them compute the chunked
online-softmax recurrence of the reference's ``models/layers.py``
``causal_attention``: scores ``(q·kᵀ in fp32) · 1/√hd``, causal masking
with the ``-1e30`` sentinel (with the reference's query offset and sliding
window: the query at row i sits at ``q_offset + i`` and sees key j iff
``q_offset + i ≥ j`` and ``q_offset + i − j < window``), running
``(acc, m, l)`` in fp32, ``p`` rounded to v's dtype before the P·V
product, and ``acc / max(l, 1e-30)`` cast to q's dtype.

* :func:`flash_fwd` launches one of two kernels, built from the checkout
  into one library at first call, on PyTorch's current stream, never
  synchronising.  :func:`route` picks the kernel from the dtype alone, for
  every head dim from 1 to 256 (the reference's Pallas kernel takes any hd
  and is sized for hd ≤ 256).  Each kernel has template instances at some
  head dims (``INSTANCES``); the launcher zero-pads q, k and v of any other
  hd to the next instance and slices the output, which is exact (a zero
  column adds 0 to every q·k and gives a zero output column) and keeps the
  true hd's scale.  The cost is the padded copies and the wider work
  (hd 96 runs as 128 on the bf16 route, hd 40 as 64).  The two kernels:

  - ``"wgmma"`` (bf16, the model path): ``csrc/flash_fwd_sm90.cu``, on the
    H100's tensor cores.  A producer warpgroup copies Q, K and V by TMA
    from their native layouts into a 3-stage shared-memory ring of
    128-key tiles; two consumer warpgroups (one above hd 128, where O
    alone takes 96 or 128 registers a thread, with 64-key tiles) run Q·Kᵀ
    and P·V as ``wgmma`` (bf16 in, fp32 accumulate; P taken from
    registers) and the online softmax on the accumulators.  Its blocks run
    in groups of (batch, kv head) pairs whose K and V fit ``L2_SHARE`` of
    the card's L2 (:func:`kv_group`), each group's heaviest causal query
    blocks first.  Its bound on the H100 is the tensor cores' bf16 rate
    (1,070 TFLOP/s at 1,980 MHz) for the 4·hd FLOPs and the MUFU rate
    (4.18·10¹² /s) for the exp of each visible (q, k) pair, equal at
    hd 64 (0.514 ms each at TinyLlama's 8 × 4,096 causal prefill) and far
    above the bytes; so each warpgroup runs its exps under its own
    previous P·V and the two take turns on the tensor cores.  A query
    offset or a window runs a second instance per head dim; the plain
    causal instance keeps neither in its code.
  - ``"ffma"`` (fp32): ``csrc/flash_fwd.cu``, IEEE fp32 FFMA on the CUDA
    cores (Hopper's tensor cores take no fp32 operands, and TF32 would
    round the operands to 10-bit mantissas, against the reference's fp32
    contract).  Its bound is the FFMA rate (66.9 TFLOP/s) for the 4·hd
    FLOPs of each visible (q, k) pair, 8.22 ms at TinyLlama's 8 × 4,096
    causal prefill, so it spends few other instructions and few
    shared-memory clocks: each warp owns 16 query rows and exchanges P
    only within itself; lanes hold register tiles of scores (4 × 8) and
    outputs, ordered so that neighbouring lanes share the operand read
    most often; at hd 16 P stays in registers and each lane takes its own
    keys' share of P·V; K and V come by ``cp.async`` through a 2-stage
    ring with one CTA barrier a tile; only the key tiles at the diagonal,
    a window's edge or Sk take a per-element mask; and p is ``ex2`` of one
    FFMA with the scale folded into log2 units.

  ``flash_fwd.launches`` counts every launch and
  ``flash_fwd.route_launches`` each route's.
* :func:`flash_attention` is the wrapper: a kernel on CUDA tensors, the
  plain version on CPU tensors, never the one in place of the other.  Its
  output carries no gradient, so on CUDA tensors that require grad, under
  grad mode, it raises (:func:`repro_torch.kernels.refuse_grad`).  On CUDA
  tensors it calls the custom op ``torch.ops.repro_torch.flash_fwd``, whose
  body is the launcher.  Its fake (``register_fake``) gives the output's
  shape and dtype and launches nothing, so a trace under ``FakeTensorMode``
  (the dry run, ``launch.dryrun``) reaches kernel 4 as one op; its FLOP
  formula (``register_flop_formula``) counts 4·hd per visible (query, key)
  pair (:func:`visible_pairs`), the count behind the kernel's bound.
* :func:`flash_attention_grad` is attention under autograd: the wrapper's
  forward, unchanged, in a ``torch.autograd.Function`` that saves q, k and
  v; its backward is :func:`flash_attention_backward_plain`, the
  reference's own recipe.  The reference has no backward kernel
  (``repro/kernels/flash_attention/flash.py:18-22``): its chunk body runs
  under ``jax.checkpoint(body, nothing_saveable)``
  (``repro/models/layers.py:145-151``), so its backward recomputes each kv
  chunk's scores from the ``(acc, m, l)`` carry.  The backward here does
  the same in plain PyTorch; it is not a kernel, and no kernel of the
  reference stands behind it.
* :func:`flash_attention_plain` follows the reference's op sequence chunk
  by chunk (it also serves ``layers.causal_attention`` on the CPU).

k and v may carry fewer heads than q (GQA): query head h reads kv head
``h // (H // KV)``.  The kernels index it; the plain version expands k
and v as the reference's ``_expand_kv`` does (:func:`expand_kv`).
"""
from __future__ import annotations

import ctypes
import operator
from pathlib import Path

import numpy as np
import torch
import torch.utils.checkpoint
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, refuse_grad

__all__ = ["NEG", "MAX_HEAD_DIM", "INSTANCES", "ROUTES", "SOURCE", "SOURCE_SM90", "build", "expand_kv",
           "flash_fwd", "flash_attention", "flash_attention_grad", "flash_attention_backward_plain",
           "flash_attention_plain", "instance", "kv_group", "route", "visible_pairs"]

NEG = -1e30  # large-finite: no inf − inf in the online softmax
MAX_HEAD_DIM = 256
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
SOURCE_SM90 = Path(__file__).resolve().parent / "csrc" / "flash_fwd_sm90.cu"
# route -> the kernel source it launches
ROUTES = {"wgmma": SOURCE_SM90, "ffma": SOURCE}
# route -> the head dims its kernel has template instances for
INSTANCES = {"wgmma": (16, 64, 80, 128, 192, 256),
             "ffma": (16, 32, 48, 64, 80, 96, 128, 160, 192, 256)}
_MAX_GRID_Y = 65535
_INT_MAX = 2 ** 31 - 1
# The share of the card's L2 that one group of the wgmma kernel's block
# order may fill with its K and V (:func:`kv_group`); the rest holds the
# streamed Q and O tiles.
L2_SHARE = 0.5

_lib: ctypes.CDLL | None = None


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = _build.load_library("flash_fwd", [SOURCE, SOURCE_SM90])
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, f, i, i, i, p]
        lib.flash_fwd.restype = i
        lib.flash_fwd_sm90.argtypes = [p, p, p, p, i, i, i, i, i, i, f, i, i, i, i, p]
        lib.flash_fwd_sm90.restype = i
        _lib = lib
    return _lib


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel that takes (dtype, head_dim): ``"wgmma"`` for bfloat16,
    ``"ffma"`` for float32, for every head_dim from 1 to ``MAX_HEAD_DIM``.
    Raises on any other dtype or head_dim."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} not supported; the kernels take 1 to {MAX_HEAD_DIM}")
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "ffma"
    raise ValueError(f"flash_fwd takes float32 or bfloat16, got {dtype}")


def instance(which: str, hd: int) -> int:
    """The head dim the kernel of route ``which`` runs for ``hd``: the
    smallest of its ``INSTANCES`` that is ≥ hd (hd itself where it is one)."""
    return next(i for i in INSTANCES[which] if i >= hd)


def _block_rows(which: str, hd: int) -> int:
    """Query rows per CTA: the wgmma kernel's 128 (64 above hd 128), the
    ffma kernel's 64 (four warps of 16 rows)."""
    return 128 if which == "wgmma" and instance(which, hd) <= 128 else 64


def _check(q, k, v, out) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_fwd takes CUDA tensors, got {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_fwd takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v), ("out", out)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {dev}, got {t.dtype} on {t.device}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or out.shape != q.shape:
        raise ValueError(f"need q/out (B, Sq, H, hd) and k, v (B, Sk, KV, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, {tuple(out.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads do not divide into {k.shape[2]} kv heads")
    if k.shape[1] == 0:
        raise ValueError("k and v hold no keys")
    which = route(q.dtype, hd)
    if which == "ffma" and b * h > _MAX_GRID_Y:
        raise ValueError(f"B·H = {b * h} exceeds the grid's {_MAX_GRID_Y}")
    if which == "wgmma" and b * h * -(-q.shape[1] // _block_rows(which, hd)) > _INT_MAX:
        raise ValueError(f"B·H·ceil(Sq / {_block_rows(which, hd)}) exceeds the grid's {_INT_MAX} blocks")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def kv_group(b: int, sk: int, kv: int, hd: int, l2_bytes: int) -> int:
    """The most (batch, kv head) pairs a group of the wgmma kernel's block
    order holds: as many as keep the group's K and V (bf16, ``sk`` keys of
    ``hd`` columns each, ``hd`` the instance's) within ``L2_SHARE`` of an L2
    of ``l2_bytes``, at least 1 and at most all ``b·kv``.  The kernel splits
    the pairs into ceil(b·kv / group) groups whose sizes differ by one at
    most.  A group's blocks run together, heaviest causal query block
    first, so every head of the group re-reads its K and V from L2 while
    the group runs."""
    per_pair = 2 * sk * hd * 2
    return max(1, min(b * kv, int(l2_bytes * L2_SHARE) // per_pair))


def _mask_args(causal: bool, q_offset, window, sq: int, sk: int) -> tuple[int, int]:
    """(q_offset, window) as the kernels take them: ints, INT_MAX for no
    window, a negative window as 0 (both see no key).  Raises on a window
    without the causal mask, as the plain version does, and on positions the
    kernels' 32-bit arithmetic cannot hold."""
    q_offset = operator.index(q_offset)
    if window is not None and not causal:
        raise ValueError("a window applies to causal attention only")
    if abs(q_offset) + sq + sk >= _INT_MAX:
        raise ValueError(f"|q_offset| + Sq + Sk = {abs(q_offset) + sq + sk} exceeds the kernels' int32 positions")
    window = _INT_MAX if window is None else min(max(operator.index(window), 0), _INT_MAX)
    return q_offset, window


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0, window: int | None = None) -> None:
    """One launch: attention of q (B, Sq, H, hd) over k, v (B, Sk, KV, hd)
    into ``out`` (B, Sq, H, hd).  All contiguous, 16-byte aligned, one
    dtype (float32 or bfloat16) on one CUDA device; 1 ≤ hd ≤ 256.
    ``q_offset`` (q[0]'s position) and ``window`` shape the causal mask as
    in ``layers.causal_attention``.  The kernel is :func:`route`'s, at
    :func:`instance`'s head dim (q, k and v zero-padded to it where it is
    not hd); a failed launch raises, and so does a call under grad mode
    with an input that requires grad."""
    refuse_grad("flash.flash_fwd", q, k, v)
    _check(q, k, v, out)
    b, sq, h, hd = q.shape
    q_offset, window = _mask_args(causal, q_offset, window, sq, k.shape[1])
    if b == 0 or sq == 0:
        return
    which = route(q.dtype, hd)
    inst = instance(which, hd)
    dst = out
    if inst != hd:
        q, k, v = (torch.nn.functional.pad(t, (0, inst - hd)) for t in (q, k, v))
        dst = torch.empty_like(q)
    lib = build()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dst.data_ptr())
    shape = (b, sq, k.shape[1], h, k.shape[2], inst, 1.0 / (hd ** 0.5), int(causal), q_offset, window)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which == "wgmma":
            l2 = torch.cuda.get_device_properties(q.device).L2_cache_size
            group = kv_group(b, k.shape[1], k.shape[2], inst, l2)
            err = lib.flash_fwd_sm90(*args, *shape, group, stream)
        else:
            err = lib.flash_fwd(*args, *shape, stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd ({which}) launch failed: CUDA error {err}")
    flash_fwd.launches += 1
    flash_fwd.route_launches[which] += 1
    if dst is not out:
        out.copy_(dst[..., :hd])


flash_fwd.launches = 0
flash_fwd.route_launches = dict.fromkeys(ROUTES, 0)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, q_offset: int,
              window: int | None) -> torch.Tensor:
    """Kernel 4 as an op: a new output, filled by :func:`flash_fwd`."""
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    flash_fwd(q, k, v, out, causal=causal, q_offset=q_offset, window=window)
    return out


@_flash_op.register_fake
def _flash_op_fake(q, k, v, causal, q_offset, window):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def visible_pairs(sq: int, sk: int, *, causal: bool = True, q_offset: int = 0, window: int | None = None) -> int:
    """The (query, key) pairs one head attends: Sq·Sk without the causal
    mask; with it, row i (at position ``q_offset + i``) sees keys ``j ≤
    q_offset + i`` with ``q_offset + i − j < window``."""
    if not causal:
        return sq * sk
    pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos, sk - 1)
    lo = np.zeros_like(pos) if window is None else np.maximum(pos - window + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_flops(q_shape, k_shape, v_shape, causal, q_offset, window, *args, **kwargs) -> int:
    b, sq, h, hd = q_shape
    return 4 * hd * b * h * visible_pairs(sq, k_shape[1], causal=causal, q_offset=q_offset, window=window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    q_offset: int = 0, window: int | None = None) -> torch.Tensor:
    """Forward attention, q (B, Sq, H, hd), k/v (B, Sk, KV, hd) → (B, Sq, H, hd)
    in q's dtype, the causal mask shifted by ``q_offset`` and cut to a
    sliding ``window``.  CUDA tensors go through the kernel (or the call
    raises); CPU tensors through :func:`flash_attention_plain`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset, window=window)
    refuse_grad("flash.flash_attention", q, k, v)
    if q.device.type != "cuda":  # the launcher's refusal, before the op's meta kernel could answer
        raise ValueError(f"flash_fwd takes CUDA tensors, got {q.device}")
    return torch.ops.repro_torch.flash_fwd(q, k, v, causal, operator.index(q_offset), window)


def expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, hd) → (B, S, KV·groups, hd), each kv head repeated
    ``groups`` times in place (the reference's ``layers._expand_kv``)."""
    return k if groups == 1 else k.repeat_interleave(groups, dim=2)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, chunk: int = 512, q_offset: int = 0,
                          window: int | None = None) -> torch.Tensor:
    """The kernel's plain version: the reference's chunked recurrence
    (``layers.causal_attention``), op for op, over kv chunks of ``chunk``
    keys; Sk must be a multiple of ``min(chunk, Sk)``.  Products are fp32
    (float64 for float64 inputs) with p rounded to v's dtype before P·V.
    ``q_offset`` is q[0]'s absolute position and ``window`` a sliding
    window, both of the causal mask."""
    return _recurrence(q, k, v, causal=causal, chunk=chunk, q_offset=q_offset, window=window, remat=False)


def _recurrence(q, k, v, *, causal: bool, chunk: int, q_offset: int, window: int | None,
                remat: bool) -> torch.Tensor:
    """:func:`flash_attention_plain`; with ``remat`` each kv chunk's step runs
    under ``torch.utils.checkpoint``, so autograd keeps only the ``(acc, m,
    l)`` carry between chunks and recomputes the chunk's scores in the
    backward (the reference's ``jax.checkpoint(body, nothing_saveable)``)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads do not divide into {kv} kv heads")
    if window is not None and not causal:
        raise ValueError("a window applies to causal attention only")
    k = expand_kv(k, h // kv)
    v = expand_kv(v, h // kv)
    scale = 1.0 / (hd ** 0.5)
    chunk = min(chunk, sk)
    n_chunks = sk // chunk if chunk else 0
    if chunk == 0 or n_chunks * chunk != sk:
        raise ValueError(f"Sk={sk} not divisible by chunk={chunk}")
    wide = torch.promote_types(q.dtype, torch.float32)
    qw = q.to(wide)
    q_pos = q_offset + torch.arange(sq, device=q.device)

    def body(acc, m, l, k_j, v_j, j):
        s = torch.einsum("bqhd,bchd->bhqc", qw, k_j.to(wide)) * scale
        if causal:
            k_pos = j * chunk + torch.arange(chunk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            s = torch.where(mask[None, None], s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqc,bchd->bhqd", p.to(v.dtype).to(wide), v_j.to(wide))
        l = l * corr + p.sum(dim=-1)
        return acc, m_new, l

    acc = torch.zeros((b, h, sq, hd), dtype=wide, device=q.device)
    m = torch.full((b, h, sq), NEG, dtype=wide, device=q.device)
    l = torch.zeros((b, h, sq), dtype=wide, device=q.device)
    for j in range(n_chunks):
        k_j = k[:, j * chunk:(j + 1) * chunk]
        v_j = v[:, j * chunk:(j + 1) * chunk]
        if remat:
            acc, m, l = torch.utils.checkpoint.checkpoint(body, acc, m, l, k_j, v_j, j, use_reentrant=False,
                                                          preserve_rng_state=False)
        else:
            acc, m, l = body(acc, m, l, k_j, v_j, j)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   dout: torch.Tensor, *, causal: bool = True, chunk: int = 512,
                                   q_offset: int = 0, window: int | None = None):
    """``(dq, dk, dv)``: the vector-Jacobian product of
    :func:`flash_attention_plain` (same mask and ``chunk``) at (q, k, v)
    with ``dout``, each in its input's dtype.

    The reference's backward recipe: the recurrence runs once more, one kv
    chunk at a time, each chunk's step under ``torch.utils.checkpoint``, so
    between chunks only the ``(acc, m, l)`` carry is held and each chunk's
    (B, H, Sq, chunk) scores are recomputed while its gradient is taken;
    the gradients of a kv head's ``H // KV`` query heads (GQA) sum into it
    through :func:`expand_kv`'s backward."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = _recurrence(*leaves, causal=causal, chunk=chunk, q_offset=q_offset, window=window, remat=True)
        return torch.autograd.grad(out, leaves, dout)


class _FlashAttention(torch.autograd.Function):
    """Forward: :func:`flash_attention` (kernel 4 on CUDA tensors).
    Backward: :func:`flash_attention_backward_plain`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, chunk, q_offset, window):
        ctx.save_for_backward(q, k, v)
        ctx.mask = {"causal": causal, "chunk": chunk, "q_offset": q_offset, "window": window}
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset, window=window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_backward_plain(q, k, v, dout, **ctx.mask), None, None, None, None)


def flash_attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                         chunk: int = 512, q_offset: int = 0, window: int | None = None) -> torch.Tensor:
    """:func:`flash_attention` with a gradient: the same forward (kernel 4
    on CUDA tensors, once per call), and in the backward
    :func:`flash_attention_backward_plain` over kv chunks of ``chunk``
    keys."""
    return _FlashAttention.apply(q, k, v, causal, chunk, q_offset, window)
