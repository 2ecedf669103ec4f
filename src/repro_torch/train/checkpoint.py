"""Atomic, async checkpoints in the reference's layout.

Counterpart of ``repro/train/checkpoint.py``.  One directory per step:

    <root>/ckpt_<step>.tmp.<nonce>/   ← written first
        manifest.json                 ← step, sorted keys, shapes, dtypes, extra
        arrays.npz                    ← leaf key → array
    <root>/ckpt_<step>/               ← atomic os.rename when complete
    <root>/LATEST                     ← step number, written last

A tree is nested dicts (and tuples or lists) of tensors or numpy arrays; a
leaf's key is its path joined by ``/``, a dict key's own dots read as
``/`` too — the module's ``layers.wq`` under ``params`` is
``params/layers/wq``, as the reference's nested pytree names it — so the
two packages read each other's checkpoints.

A bfloat16 leaf is stored as its 2-byte words under the npy descr
``<V2``, the bytes the reference writes for it, with ``"bfloat16"`` in the
manifest.  On read the manifest's dtype decides: such words come back as
``torch.bfloat16`` (numpy alone has no bf16 type).

Fault-tolerance contract: a crash mid-save never corrupts an existing
checkpoint (tmp dir + rename); a crash between rename and LATEST update
just loses the pointer — ``latest_step`` falls back to scanning for the
newest complete directory.  :class:`AsyncCheckpointer` snapshots to host
memory synchronously and writes on a background thread.

Sharded trees: ``save`` of DTensor leaves gathers each to its full array
(every rank must call it, as every rank runs the step), writes on rank 0
alone and ends with a barrier, so the files are the reference's layout
whatever mesh wrote them.  :class:`AsyncCheckpointer` gathers the same way
in the caller's thread and writes on rank 0's background thread; its
``wait`` holds every rank until that write has landed.  ``restore`` puts a
DTensor leaf of ``tree_like`` back as a DTensor with that leaf's mesh and
placements; ``restore(..., mesh=, specs=)`` is the reference's elastic
reshard: each leaf comes back a DTensor placed by its spec on ``mesh``.
Either way each rank keeps its block of the full array it reads, whatever
mesh wrote the checkpoint.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import threading
import uuid
import zipfile
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.sharding.axes import _is_spec, distribute_tree, place_full

__all__ = ["SEP", "atomic_snapshot_dir", "write_latest", "read_latest", "save", "AsyncCheckpointer",
           "latest_step", "restore"]

SEP = "/"
_BF16_DESCR = "<V2"  # numpy's descr of ml_dtypes' bfloat16, which the reference saves


@contextlib.contextmanager
def atomic_snapshot_dir(root: str | os.PathLike, name: str) -> Iterator[Path]:
    """Write-to-tmp-then-rename directory snapshot — the atomicity primitive.

    Yields a fresh ``<root>/<name>.tmp.<nonce>/`` to populate; on a clean
    exit it is renamed over ``<root>/<name>``; on any exception it is
    deleted and the previous snapshot is untouched.  The checkpoints here
    and the ``SetStore`` snapshots (``repro_torch.index.store``) ride it.
    """
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / name
    tmp = root / f"{name}.tmp.{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True)
    try:
        yield tmp
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def write_latest(root: str | os.PathLike, token: str | int) -> None:
    """Update the ``LATEST`` pointer (written after the snapshot rename)."""
    (Path(root) / "LATEST").write_text(str(token))


def read_latest(root: str | os.PathLike) -> str | None:
    """The raw ``LATEST`` token (a hint to verify), or None when absent."""
    pointer = Path(root) / "LATEST"
    if not pointer.exists():
        return None
    return pointer.read_text().strip()


def _flatten(tree, prefix: str = "", is_leaf=lambda _: False) -> dict[str, Any]:
    """{leaf key: leaf} in the tree's order; dict keys' dots become ``/``."""
    if is_leaf(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = ((str(k).replace(".", SEP), v) for k, v in tree.items())
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else k, is_leaf))
    return flat


def _unflatten(tree_like, flat: dict[str, Any], prefix: str = ""):
    """``tree_like``'s structure with its leaves taken from ``flat``."""
    def key(k):
        return f"{prefix}{SEP}{k}" if prefix else str(k)

    if isinstance(tree_like, dict):
        return {k: _unflatten(v, flat, key(str(k).replace(".", SEP))) for k, v in tree_like.items()}
    if isinstance(tree_like, (tuple, list)):
        vals = [_unflatten(v, flat, key(i)) for i, v in enumerate(tree_like)]
        return type(tree_like)(*vals) if hasattr(tree_like, "_fields") else type(tree_like)(vals)
    return flat[prefix]


def _host(x) -> np.ndarray:
    """A leaf as a host numpy array (a bf16 tensor as its uint16 words); a
    tensor is copied, so the caller may update it in place afterwards."""
    if isinstance(x, DTensor):
        x = x.detach().full_tensor()
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16).view(_Bf16Words)
        return x.numpy()
    return np.asanyarray(x)


class _Bf16Words(np.ndarray):
    """Marks a uint16 array that holds bfloat16 words."""


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if isinstance(a, _Bf16Words) else str(a.dtype)


def _write_npz(path: Path, arrays: dict[str, np.ndarray]) -> None:
    """``np.savez``'s archive (stored, zip64 members), with bf16 words under
    the reference's ``<V2`` descr."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, a in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if isinstance(a, _Bf16Words):
                    a = np.asarray(a, order="C")
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": _BF16_DESCR, "fortran_order": False, "shape": a.shape})
                    fid.write(a.view(np.uint16).tobytes())
                else:
                    np.lib.format.write_array(fid, np.asarray(a), allow_pickle=False)


def save(root: str | os.PathLike, step: int, tree: Any, *, extra: dict | None = None) -> Path:
    """Synchronous atomic save.  Returns the final checkpoint path.  A tree
    with DTensor leaves is gathered on every rank (call it on all of them),
    written by rank 0, and followed by a barrier."""
    root = Path(root)
    flat = _flatten(tree)
    if any(isinstance(v, DTensor) for v in flat.values()):
        arrays = {k: _host(v) for k, v in flat.items()}
        if dist.get_rank() == 0:
            save(root, step, arrays, extra=extra)
        dist.barrier()
        return root / f"ckpt_{step}"
    with atomic_snapshot_dir(root, f"ckpt_{step}") as tmp:
        arrays = {k: _host(v) for k, v in flat.items()}
        _write_npz(tmp / "arrays.npz", arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays),
            "shapes": {k: list(a.shape) for k, a in arrays.items()},
            "dtypes": {k: _dtype_name(a) for k, a in arrays.items()},
            "extra": extra or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
    write_latest(root, step)
    return root / f"ckpt_{step}"


class AsyncCheckpointer:
    """Snapshot-then-write-in-background.  One in-flight save at a time
    (a newer save waits for the previous write to land — bounded memory);
    a failed write raises on the next ``wait`` (or ``save``), once.

    A tree with DTensor leaves is gathered on every rank in the caller's
    thread (every rank calls ``save``, as every rank runs the step) and
    written by rank 0 alone.  ``wait`` then holds every rank until rank 0's
    write has landed, and a failed write raises on every rank, so that no
    rank reads ``LATEST`` early and the ranks fail together."""

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._sharded = False  # the in-flight save is rank 0's write of a DTensor tree

    def save(self, step: int, tree: Any, *, extra: dict | None = None) -> None:
        self.wait()
        flat = _flatten(tree)
        self._sharded = any(isinstance(v, DTensor) for v in flat.values())
        # synchronous device→host snapshot: after this the caller may mutate
        snapshot = _unflatten(tree, {k: _host(v) for k, v in flat.items()})
        if self._sharded and dist.get_rank() != 0:
            return

        def _write():
            try:
                save(self.root, step, snapshot, extra=extra)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:  # rank 0 has joined its writer before it sends
            self._sharded = False
            failed = [None if self._error is None else repr(self._error)]
            dist.broadcast_object_list(failed, src=0)
            if failed[0] is not None and self._error is None:
                self._error = RuntimeError(f"checkpoint write on rank 0 failed: {failed[0]}")
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(root: str | os.PathLike) -> int | None:
    """The newest complete checkpoint's step: ``LATEST`` when it names a
    complete one, else a scan of the ``ckpt_<step>`` directories."""
    root = Path(root)
    token = read_latest(root)
    if token is not None:
        try:
            step = int(token)
            if (root / f"ckpt_{step}" / "manifest.json").exists():
                return step
        except ValueError:
            pass
    # fall back: scan for complete checkpoints (crash-between-rename-and-LATEST)
    steps = []
    for d in root.glob("ckpt_*"):
        m = re.fullmatch(r"ckpt_(\d+)", d.name)
        if m and (d / "manifest.json").exists():
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    arr = np.asarray(arr, order="C")  # 0-d kept 0-d
    if not arr.flags.writeable:
        arr = arr.copy()
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def restore(root: str | os.PathLike, tree_like: Any, step: int | None = None,
            device=None, *, mesh=None, specs: Any | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``tree_like``: ``(tree, step)``, each
    leaf a tensor with the manifest's dtype, on ``device`` or else on the
    device of ``tree_like``'s leaf (the CPU for a numpy leaf; the mesh's
    device type with ``mesh``).  A DTensor leaf of ``tree_like`` comes back
    a DTensor with its mesh and placements.

    With ``mesh`` and ``specs`` (nested like ``tree_like``, a spec per leaf)
    every leaf is a DTensor placed by its spec: the elastic-reshard path,
    whose target mesh may differ from the one the checkpoint was written on."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    path = root / f"ckpt_{step}"
    dtypes = json.loads((path / "manifest.json").read_text())["dtypes"]
    out = {}
    flat_specs = _flatten(specs, is_leaf=_is_spec) if mesh is not None and specs is not None else None
    with np.load(path / "arrays.npz") as data:
        for key, like in _flatten(tree_like).items():
            if flat_specs is not None:
                dev = device if device is not None else mesh.device_type
                if dev == "cuda":
                    dev = torch.device("cuda", torch.cuda.current_device())
                out[key] = distribute_tree(_tensor(data[key], dtypes[key], dev), flat_specs[key], mesh)
                continue
            dev = device if device is not None else (like.device if isinstance(like, torch.Tensor) else "cpu")
            out[key] = _tensor(data[key], dtypes[key], dev)
            if isinstance(like, DTensor):
                out[key] = place_full(out[key], like.device_mesh, like.placements)
    return _unflatten(tree_like, out), step
