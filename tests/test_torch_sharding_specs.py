"""The port's sharding specs held to the reference's, and its placements to a
hand-written block rule.

For each of the five LMs on the production meshes (16, 16) and (2, 16, 16)
and the test mesh (2, 2, 2), and for both mesh roles of the "model" axis
(tensor parallel, and the ``dp_zero1`` variant's batch duty): ``lm_rules``,
``lm_param_specs``, ``zero1_opt_specs``, ``kv_cache_specs`` and the three
optimizers' ``state_specs`` equal ``tuple()`` of the reference's, whose
meshes are ``jax.sharding.AbstractMesh`` (no devices).  The port's meshes
are ``DeviceMesh``es over a ``fake`` process group of the mesh's size.

``placements`` is checked against the block each rank must hold, written
out by hand: a dim sharded over several mesh dims is split major to minor
in the spec's (and the mesh's) order, ``torch.chunk``-sized.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.models import transformer as ref_lm  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_test_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.sharding import axes  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

LMS = ("tinyllama-1.1b", "stablelm-3b", "deepseek-67b", "grok-1-314b", "olmoe-1b-7b")
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ROLES = ("tensor", "batch")


def _tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def _ref_mesh(shape, names):
    return jax.sharding.AbstractMesh(shape, names)


@pytest.fixture(scope="module", params=list(MESHES))
def mesh(request):
    shape, names = MESHES[request.param]
    with fake_process_group(int(np.prod(shape))):
        yield request.param, make_test_mesh(shape, names, device_type="cpu")


def _configs(aid, role):
    port_cfg = dataclasses.replace(base.load_arch(aid).config, model_axis_role=role)
    ref_cfg = dataclasses.replace(ref_base.load_arch(aid).config, model_axis_role=role)
    return port_cfg, ref_cfg


@pytest.mark.parametrize("role", ROLES)
@pytest.mark.parametrize("aid", LMS)
def test_lm_specs_equal_the_reference(mesh, aid, role):
    name, m = mesh
    ref_m = _ref_mesh(*MESHES[name])
    cfg, ref_cfg = _configs(aid, role)
    rules, ref_rules = T.lm_rules(cfg, m), ref_lm.lm_rules(ref_cfg, ref_m)
    for field in ("batch", "model", "fsdp", "shard_kv", "shard_expert"):
        assert getattr(rules, field) == getattr(ref_rules, field), field
    pspecs = T.lm_param_specs(cfg, rules)
    assert pspecs == _tuples(ref_lm.lm_param_specs(ref_cfg, ref_rules))
    cache = T.kv_cache_specs(cfg, rules)
    ref_cache = ref_lm.kv_cache_specs(ref_cfg, ref_rules)
    assert (cache.k, cache.v, cache.length) == (tuple(ref_cache.k), tuple(ref_cache.v), tuple(ref_cache.length))
    shapes = jax.eval_shape(lambda: ref_lm.init_lm_params(jax.random.PRNGKey(0), ref_cfg))
    zero1 = T.zero1_opt_specs(pspecs, T.nested_shapes(cfg), m)
    assert zero1 == _tuples(ref_lm.zero1_opt_specs(ref_lm.lm_param_specs(ref_cfg, ref_rules), shapes, ref_m))
    assert T.nested_shapes(cfg) == jax.tree.map(lambda s: tuple(s.shape), shapes)


OPTIMIZERS = {
    "adamw": (lambda: opt.adamw(), lambda: ref_opt.adamw()),
    "adamw_no_master": (lambda: opt.adamw(master_fp32=False), lambda: ref_opt.adamw(master_fp32=False)),
    "adafactor": (lambda: opt.adafactor(), lambda: ref_opt.adafactor()),
    "sgd_momentum": (lambda: opt.sgd(momentum=0.9), lambda: ref_opt.sgd(momentum=0.9)),
    "sgd": (lambda: opt.sgd(), lambda: ref_opt.sgd()),
}


@pytest.mark.parametrize("which", list(OPTIMIZERS))
@pytest.mark.parametrize("aid", LMS)
def test_optimizer_state_specs_equal_the_reference(mesh, aid, which):
    name, m = mesh
    ref_m = _ref_mesh(*MESHES[name])
    make, ref_make = OPTIMIZERS[which]
    for role in ROLES:
        cfg, ref_cfg = _configs(aid, role)
        pspecs = T.lm_param_specs(cfg, T.lm_rules(cfg, m))
        ref_pspecs = ref_lm.lm_param_specs(ref_cfg, ref_lm.lm_rules(ref_cfg, ref_m))
        assert make().state_specs(pspecs) == _tuples(ref_make().state_specs(ref_pspecs))
        shapes = jax.eval_shape(lambda: ref_lm.init_lm_params(jax.random.PRNGKey(0), ref_cfg))
        zero1 = T.zero1_opt_specs(pspecs, T.nested_shapes(cfg), m)
        ref_zero1 = ref_lm.zero1_opt_specs(ref_pspecs, shapes, ref_m)
        assert make().state_specs(zero1) == _tuples(ref_make().state_specs(ref_zero1))


def _hand_block(shape, spec, names, sizes, coord):
    """The block a rank at ``coord`` holds, by hand: tensor dim d split into
    equal consecutive parts over its mesh dims, major to minor."""
    sl = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        dims = () if entry is None else (entry,) if isinstance(entry, str) else entry
        parts, index = 1, 0
        for ax in dims:
            i = names.index(ax)
            index = index * sizes[i] + coord[i]
            parts *= sizes[i]
        step = n // parts
        sl.append(slice(index * step, (index + 1) * step))
    return tuple(sl)


SPECS = [(), (None, "model"), (("pod", "data"), "model"), (("pod", "data", "model"), None),
         ("data", None, "model"), (None, ("data", "model"))]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_placements_give_the_hand_written_blocks(mesh, spec):
    name, m = mesh
    shape, names = MESHES[name]
    if any(ax not in names for e in spec if e is not None for ax in ((e,) if isinstance(e, str) else e)):
        spec = tuple(e if e is None else tuple(a for a in ((e,) if isinstance(e, str) else e) if a in names) or None
                     for e in spec)
    full = torch.arange(512 * 256 * 16).reshape(512, 256, 16)
    place = axes.placements(spec, m)
    n_sharded = 0
    for d, entry in enumerate(spec):
        for ax in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            assert place[names.index(ax)] == Shard(d)
            n_sharded += 1
    assert sum(p == Replicate() for p in place) == len(names) - n_sharded
    for coord in itertools.product(*(range(s) for s in shape)):
        m.get_coordinate = lambda c=coord: list(c)
        got = axes.local_block(full, m, place)
        assert torch.equal(got, full[_hand_block(full.shape, spec, names, shape, coord)]), coord
    del m.get_coordinate


def test_placements_refuse_out_of_order_and_reused_mesh_dims(mesh):
    _, m = mesh
    last = m.mesh_dim_names[-1]
    with pytest.raises(ValueError, match="order"):
        axes.placements(((last, m.mesh_dim_names[0]),), m)
    with pytest.raises(ValueError, match="shards two"):
        axes.placements((last, last), m)
