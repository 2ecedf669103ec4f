"""The port's ``build_cell`` held to the reference's on every production cell.

Every (architecture × shape) cell on the (16, 16) and (2, 16, 16) meshes:
the reference builds it on ``jax.sharding.AbstractMesh`` (its lowering is
not part of this comparison), the port on a ``DeviceMesh`` over a ``fake``
process group of the mesh's size, with fake arguments.  Equal: the skip
reasons, ``model_flops``, ``model_bytes``, the analytic peak and the
microbatch count (the port at the reference's 15.5 GiB budget), every
argument's global shape and dtype, the input and output spec trees, and
``donate_argnums``.  At the card's own budget every LM cell's analytic
peak fits the card's memory.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro_torch.analysis.roofline import H100_SXM  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_production_mesh  # noqa: E402
from repro_torch.sharding.axes import _is_spec  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

MESHES = {"pod16x16": False, "pod2x16x16": True}
CELLS = [(aid, c.name) for aid in base.arch_ids() for c in base.load_arch(aid).shapes]
GIB = 1 << 30


@pytest.fixture(scope="module", params=list(MESHES))
def meshes(request):
    multi = MESHES[request.param]
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi else ((16, 16), ("data", "model"))
    with fake_process_group(int(np.prod(shape))):
        yield make_production_mesh(multi_pod=multi, device_type="cpu"), jax.sharding.AbstractMesh(shape, names)


def _flat(tree, leaf, prefix=""):
    """{dotted path: leaf} of nested dicts, lists, tuples and namedtuples."""
    if leaf(tree):
        return {prefix: tree}
    if isinstance(tree, torch.nn.Module):
        return {f"{prefix}.{n}" if prefix else n: p for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, leaf, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _ref_leaf(x):
    return isinstance(x, (jax.ShapeDtypeStruct, NamedSharding))


def _build(aid, shape, mesh, ref_mesh, **kw):
    spec, ref_spec = base.load_arch(aid), ref_base.load_arch(aid)
    cell = next(c for c in spec.shapes if c.name == shape)
    ref_cell = next(c for c in ref_spec.shapes if c.name == shape)
    try:
        ref = ref_specs.build_cell(ref_spec, ref_cell, ref_mesh)
    except ref_specs.SkippedCell as e:
        ref = e
    try:
        port = specs.build_cell(spec, cell, mesh, device="cpu", **kw)
    except specs.SkippedCell as e:
        port = e
    return port, ref


@pytest.mark.parametrize("aid,shape", CELLS)
def test_cell_equals_the_reference(meshes, aid, shape):
    mesh, ref_mesh = meshes
    port, ref = _build(aid, shape, mesh, ref_mesh, budget_bytes=specs.REFERENCE_BUDGET)
    if isinstance(ref, Exception):
        assert isinstance(port, specs.SkippedCell) and str(port) == str(ref)
        return
    assert not isinstance(port, Exception), port
    assert port.model_flops == ref.model_flops
    assert port.model_bytes == ref.model_bytes
    assert port.analytic_peak_bytes == ref.tpu_peak_bytes
    assert port.donate_argnums == ref.donate_argnums
    ref_mb = inspect.getclosurevars(ref.fn).nonlocals.get("microbatches", 1) if inspect.isfunction(ref.fn) else 1
    assert port.microbatches == ref_mb
    # every argument: global shape and dtype
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in _flat(port.args, lambda x: False).items()}
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(ref.args, _ref_leaf).items()}
    assert got == want
    assert all(isinstance(v, DTensor) for v in _flat(port.args, lambda x: False).values())
    # the spec trees
    assert _flat(port.in_specs, _is_spec) == {k: tuple(v.spec) for k, v in _flat(ref.in_shardings, _ref_leaf).items()}
    ref_out = ref.out_shardings
    port_out = port.out_specs
    if port.cell.kind == "train":  # the reference's metrics are replicated; the port leaves them None
        ref_out, port_out = ref_out[:2], port_out[:2]
    assert _flat(port_out, _is_spec) == {k: tuple(v.spec) for k, v in _flat(ref_out, _ref_leaf).items()}
    # the arguments sit where their specs say
    placed = _flat(port.in_placements, lambda x: isinstance(x, tuple) and all(hasattr(p, "is_shard") for p in x))
    for k, v in _flat(port.args, lambda x: False).items():
        assert tuple(v.placements) == tuple(placed[k]), k


def test_lm_cells_fit_the_cards_memory(meshes):
    mesh, _ = meshes
    budget = H100_SXM.hbm_bytes * specs.REFERENCE_BUDGET / (16 * GIB)
    for aid in ("tinyllama-1.1b", "stablelm-3b", "deepseek-67b", "grok-1-314b", "olmoe-1b-7b"):
        spec = base.load_arch(aid)
        for cell in spec.shapes:
            if cell.skip_reason:
                continue
            built = specs.build_cell(spec, cell, mesh, device="cpu")
            assert built.analytic_peak_bytes <= budget <= H100_SXM.hbm_bytes, (aid, cell.name)


def test_train_cells_carry_their_optimizer_and_take_a_microbatch_count(meshes):
    """A train cell's ``optimizer`` makes the state its step takes (the same
    keys as the fake state argument), and ``microbatches=`` replaces the
    LM train cell's searched count in its step and its analytic peak."""
    from repro_torch.analysis import bytes_model

    mesh, _ = meshes
    for aid in ("tinyllama-1.1b", "gat-cora", "fm"):
        spec = base.load_arch(aid)
        cell = next(c for c in spec.shapes if c.kind == "train")
        built = specs.build_cell(spec, cell, mesh, device="cpu")
        state = built.optimizer.init(dict(built.args[0].named_parameters()))
        assert set(_flat(state, lambda x: False)) == set(_flat(built.args[1], lambda x: False)), aid
    spec = base.load_arch("tinyllama-1.1b")
    cell = next(c for c in spec.shapes if c.name == "train_4k")
    searched = specs.build_cell(spec, cell, mesh, device="cpu")
    forced = specs.build_cell(spec, cell, mesh, device="cpu", microbatches=2 * searched.microbatches)
    assert forced.microbatches == inspect.getclosurevars(forced.fn).nonlocals["microbatches"] \
        == 2 * searched.microbatches
    ms, bs = mesh.size(mesh.mesh_dim_names.index("model")), mesh.size() // mesh.size(
        mesh.mesh_dim_names.index("model"))
    assert forced.analytic_peak_bytes == bytes_model.lm_peak_memory(spec.config, cell, ms=ms, bs=bs,
                                                                    microbatches=forced.microbatches)
