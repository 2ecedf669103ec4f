"""The port's checkpoints: the reference's crash contract, and the two
packages reading each other's checkpoints.

* The reference's ``TestCheckpoint`` cases (``tests/test_train.py``) on
  ``repro_torch.train.checkpoint``: roundtrip, LATEST fallback, an
  interrupted save, async, a stale pointer, a crash between write and
  rename, an async error surfaced once.
* A reference-written checkpoint with fp32, int32 and bf16 leaves restored
  by the port; a port-written fp32 training state (a smoke LM's parameters
  and AdamW state, keyed ``params/layers/wq``, ``opt/mu/embed``,
  ``opt/count``) restored by the reference into its own pytree; a
  port-written bf16 leaf byte-equal to the reference's.

Every comparison is exact: a checkpoint moves bits.
"""
import dataclasses
import json
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.models import transformer as ref_lm  # noqa: E402
from repro.train import checkpoint as ref_ck  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402


def _equal(got: torch.Tensor, want) -> bool:
    want = torch.from_numpy(np.array(want))
    return got.dtype == want.dtype and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the reference's TestCheckpoint cases
# ---------------------------------------------------------------------------


def test_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4), "n": {"b": torch.ones(5, dtype=torch.int32)},
            "h": torch.linspace(-3, 3, 7).to(torch.bfloat16)}
    ck.save(tmp_path, 7, tree)
    got, step = ck.restore(tmp_path, tree)
    assert step == 7
    for k in ("a", "h"):
        assert got[k].dtype == tree[k].dtype and torch.equal(got[k], tree[k])
    assert got["n"]["b"].dtype == torch.int32 and torch.equal(got["n"]["b"], tree["n"]["b"])
    manifest = json.loads((tmp_path / "ckpt_7" / "manifest.json").read_text())
    assert manifest["dtypes"] == {"a": "float32", "n/b": "int32", "h": "bfloat16"}


def test_latest_pointer_and_fallback(tmp_path):
    tree = {"a": torch.zeros(2)}
    ck.save(tmp_path, 1, tree)
    ck.save(tmp_path, 5, tree)
    assert ck.latest_step(tmp_path) == 5
    (tmp_path / "LATEST").unlink()  # a crash before the pointer write
    assert ck.latest_step(tmp_path) == 5


def test_interrupted_save_never_corrupts(tmp_path):
    tree = {"a": torch.ones(4)}
    ck.save(tmp_path, 1, tree)
    (tmp_path / "ckpt_2.tmp.dead").mkdir()  # a stale tmp dir from a crashed save
    assert ck.latest_step(tmp_path) == 1
    _, step = ck.restore(tmp_path, tree)
    assert step == 1


def test_async_checkpointer(tmp_path):
    acp = ck.AsyncCheckpointer(tmp_path)
    tree = {"a": torch.arange(1000.0), "b": torch.arange(10.0).to(torch.bfloat16)}
    acp.save(3, tree)
    tree["a"].add_(1.0)  # the snapshot was taken: updating in place changes nothing saved
    acp.wait()
    got, step = ck.restore(tmp_path, tree)
    assert step == 3
    assert torch.equal(got["a"], torch.arange(1000.0)) and torch.equal(got["b"], tree["b"])


def test_stale_latest_pointer_falls_back(tmp_path):
    tree = {"a": torch.zeros(2)}
    ck.save(tmp_path, 3, tree)
    (tmp_path / "LATEST").write_text("9")  # names a step that never completed
    assert ck.latest_step(tmp_path) == 3
    _, step = ck.restore(tmp_path, tree)
    assert step == 3


def test_crash_between_write_and_rename_keeps_previous(tmp_path):
    tree = {"a": torch.arange(4.0)}
    ck.save(tmp_path, 1, tree)

    class Boom(Exception):
        pass

    with pytest.raises(Boom):
        with ck.atomic_snapshot_dir(tmp_path, "ckpt_2") as tmp:
            (tmp / "manifest.json").write_text("{}")
            raise Boom()
    assert not list(tmp_path.glob("*.tmp.*"))   # no half-written debris
    assert not (tmp_path / "ckpt_2").exists()   # nothing partial renamed
    got, step = ck.restore(tmp_path, tree)
    assert step == 1 and torch.equal(got["a"], tree["a"])


def test_async_checkpointer_surfaces_error_on_wait(tmp_path, monkeypatch):
    acp = ck.AsyncCheckpointer(tmp_path)

    def bad_save(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "save", bad_save)
    acp.save(1, {"a": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        acp.wait()
    acp.wait()  # the error is surfaced once, then cleared
    monkeypatch.undo()
    acp.save(2, {"a": torch.zeros(2)})  # the checkpointer is still usable
    acp.wait()
    assert ck.latest_step(tmp_path) == 2


def test_restore_places_leaves_on_the_device_asked(tmp_path):
    tree = {"a": torch.arange(3.0)}
    ck.save(tmp_path, 0, tree)
    got, _ = ck.restore(tmp_path, {"a": np.zeros(3, np.float32)}, device="cpu")
    assert isinstance(got["a"], torch.Tensor) and torch.equal(got["a"], tree["a"])
    with pytest.raises(FileNotFoundError):
        ck.restore(tmp_path / "empty", tree)


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


def _mixed_tree_np():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "layers": {"wq": rng.standard_normal((2, 3, 5)).astype(np.float32)},
            "count": np.asarray(7, np.int32),
            "h": (rng.standard_normal((2, 3)) * 10).astype(np.float32)}


def test_reference_checkpoint_restored_by_the_port(tmp_path):
    """fp32, int32 and bf16 leaves; the bf16 one is what the reference's own
    ``restore`` cannot read back (ROADMAP.md Queue 3)."""
    tree_np = _mixed_tree_np()
    ref_tree = {**jax.tree.map(jnp.asarray, tree_np), "h": jnp.asarray(tree_np["h"], jnp.bfloat16)}
    ref_ck.save(tmp_path, 4, ref_tree)
    like = {"w": torch.zeros(4, 6), "layers.wq": torch.zeros(2, 3, 5), "count": torch.zeros((), dtype=torch.int32),
            "h": torch.zeros(2, 3, dtype=torch.bfloat16)}
    got, step = ck.restore(tmp_path, like)
    assert step == 4
    assert _equal(got["w"], tree_np["w"]) and _equal(got["layers.wq"], tree_np["layers"]["wq"])
    assert _equal(got["count"], tree_np["count"])
    assert got["h"].dtype == torch.bfloat16
    assert torch.equal(got["h"].float(), torch.from_numpy(np.asarray(ref_tree["h"], np.float32)))


def test_port_training_state_restored_by_the_reference(tmp_path):
    """A smoke LM's parameters and AdamW state after one update, saved by the
    port, restored by the reference into its own params and state pytree."""
    ref_cfg = ref_base.smoke_lm_config(ref_base.load_arch("tinyllama-1.1b").config)
    ref_params = ref_lm.init_lm_params(jax.random.PRNGKey(0), ref_cfg)
    cfg = interop.lm_config_from_dict(dataclasses.asdict(ref_cfg))
    model = interop.lm_params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    named = dict(model.named_parameters())
    opt = optimizer.adamw(lr=1e-3)
    state = opt.init(named)
    gen = torch.Generator().manual_seed(1)
    _, state = opt.update({n: torch.randn(p.shape, generator=gen) for n, p in named.items()}, state, named)
    ck.save(tmp_path, 1, {"params": named, "opt": state})

    ref_like = {"params": ref_params, "opt": ref_opt.adamw(lr=1e-3).init(ref_params)}
    got, step = ref_ck.restore(tmp_path, ref_like)
    assert step == 1
    keys = json.loads((tmp_path / "ckpt_1" / "manifest.json").read_text())["keys"]
    assert {"params/layers/wq", "opt/mu/embed", "opt/nu/layers/wo_ffn", "opt/master/out", "opt/count"} <= set(keys)
    assert int(got["opt"]["count"]) == 1
    for n, p in named.items():
        assert _equal(p.detach(), interop.by_name(got["params"], n)), n
        for part in ("mu", "nu", "master"):
            assert _equal(state[part][n], interop.by_name(got["opt"][part], n)), (part, n)


def _npy_member(root, step: int, key: str) -> bytes:
    with zipfile.ZipFile(root / f"ckpt_{step}" / "arrays.npz") as zf:
        return zf.read(key + ".npy")


def test_port_bf16_leaf_is_byte_equal_to_the_reference(tmp_path):
    w = (np.random.default_rng(2).standard_normal((2, 3)) * 100).astype(np.float32)
    ref_ck.save(tmp_path / "ref", 0, {"w": jnp.asarray(w, jnp.bfloat16)})
    ck.save(tmp_path / "port", 0, {"w": torch.from_numpy(w).to(torch.bfloat16)})
    assert _npy_member(tmp_path / "port", 0, "w") == _npy_member(tmp_path / "ref", 0, "w")
    manifests = [json.loads((tmp_path / side / "ckpt_0" / "manifest.json").read_text())
                 for side in ("ref", "port")]
    assert manifests[0]["dtypes"] == manifests[1]["dtypes"] == {"w": "bfloat16"}
    assert manifests[0]["shapes"] == manifests[1]["shapes"]
