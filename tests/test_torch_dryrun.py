"""The port's dry run, traced in this process on ``fake`` process groups.

* The reference's eight ``tests/test_launch_specs.py`` cases, shrunk the
  same way (smoke configs, vocab 256, d_model 64, sequences of at most 64
  and batches of at most 8 or 16), built and traced on a (2, 2, 2) mesh:
  every one ``ok``, with FLOPs, wire bytes and a memory peak.
* A pure data-parallel cell (``dp_zero1`` prefill: every axis a batch axis,
  parameters replicated) counts, per device, exactly 1/8 of the one-device
  count on a (1, 1, 1) mesh.
* The eager trace counts every layer: a step's FLOPs are exactly linear in
  the layer count, dense and MoE (the reference's ``Calibration`` corrects
  a scan counted once; the port needs none).
* Kernel 4's fake op returns the output's shape and dtype, launches
  nothing, and counts 4·hd FLOPs per visible (query, key) pair.
* A step with an op DTensor cannot place ends ``status: "error"`` naming
  the op.

The traces use the CPU's fake tensors (``device="cpu"``), where attention
is the plain recurrence; on the card the same trace reaches kernel 4's fake.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.configs.base import load_arch, smoke_lm_config, smoke_recsys_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash as F  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_test_mesh  # noqa: E402

CASES = [
    ("tinyllama-1.1b", "train_4k", "baseline"),
    ("tinyllama-1.1b", "decode_32k", "baseline"),
    ("tinyllama-1.1b", "train_4k", "dp_zero1"),
    ("olmoe-1b-7b", "train_4k", "baseline"),
    ("gat-cora", "molecule", "baseline"),
    ("fm", "serve_p99", "baseline"),
    ("fm", "retrieval_cand", "model_axes"),
    ("bert4rec", "train_batch", "baseline"),
]
CAPS = {"seq_len": 64, "global_batch": 8, "batch": 16, "n_candidates": 512, "n_nodes": 64, "n_edges": 128}


def shrink(spec, shape, **lm):
    """The reference test's shrink, on the port's configs."""
    cfg = spec.config
    if cfg.family == "lm":
        cfg = dataclasses.replace(smoke_lm_config(cfg), vocab=256, d_model=64, **lm)
    elif cfg.family == "recsys":
        cfg = smoke_recsys_config(cfg)
    cell = next(c for c in spec.shapes if c.name == shape)
    dims = {k: min(v, CAPS[k]) if k in CAPS else v for k, v in cell.dims.items()}
    return dataclasses.replace(spec, config=cfg), dataclasses.replace(cell, dims=dims)


def _trace(arch, shape, variant="baseline", mesh_shape=(2, 2, 2), **lm):
    spec, cell = shrink(load_arch(arch), shape, **lm)
    n = mesh_shape[0] * mesh_shape[1] * mesh_shape[2]
    with fake_process_group(n):
        mesh = make_test_mesh(mesh_shape, device_type="cpu")
        built = specs.build_cell(spec, cell, mesh, variant, device="cpu")
        return built, dryrun.trace_cell(built)


@pytest.mark.parametrize("arch,shape,variant", CASES)
def test_reference_cases_trace_on_a_small_mesh(arch, shape, variant):
    built, rec = _trace(arch, shape, variant)
    rf = rec["roofline"]
    assert rec["n_devices"] == 8
    assert rf["flops_per_device"] > 0 or arch == "fm"  # FM's sums have no FLOP formula
    assert rf["wire_bytes_per_device"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_size_in_bytes"] > 0
    assert rf["bottleneck"] in ("compute", "memory", "collective")


def test_data_parallel_flops_per_device_are_an_eighth_of_one_device():
    _, eight = _trace("tinyllama-1.1b", "prefill_32k", "dp_zero1")
    _, one = _trace("tinyllama-1.1b", "prefill_32k", "dp_zero1", mesh_shape=(1, 1, 1))
    assert eight["roofline"]["flops_per_device"] * 8 == one["roofline"]["flops_per_device"]
    assert one["roofline"]["wire_bytes_per_device"] == 0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
def test_flops_are_linear_in_the_layer_count(arch):
    flops = [_trace(arch, "prefill_32k", n_layers=n)[1]["roofline"]["flops_per_device"] for n in (1, 2, 3)]
    assert flops[2] - flops[1] == flops[1] - flops[0] > 0


@pytest.mark.parametrize("q_offset,window", [(0, None), (64, None), (0, 40), (100, 17)])
def test_kernel4_fake_gives_shapes_and_flops_and_launches_nothing(q_offset, window):
    launches = F.flash_fwd.launches
    b, sq, sk, h, kv, hd = 2, 96, 96 + q_offset, 8, 2, 80
    with FakeTensorMode():
        q = torch.empty(b, sq, h, hd, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(b, sk, kv, hd, dtype=torch.bfloat16, device="cuda")
        with roofline.count_flops() as counted:
            out = F.flash_attention(q, k, k, q_offset=q_offset, window=window)
    assert out.shape == q.shape and out.dtype == q.dtype and out.device.type == "cuda"
    assert F.flash_fwd.launches == launches
    pairs = sum(1 for i in range(sq) for j in range(sk)
                if j <= q_offset + i and (window is None or q_offset + i - j < window))
    assert counted.total == 4 * hd * b * h * pairs == counted.by_op["repro_torch.flash_fwd"]


def test_an_op_dtensor_cannot_place_ends_the_cell_in_error(monkeypatch):
    real = specs.build_cell

    def build(*args, **kwargs):
        built = real(*args, **kwargs)
        built.fn = lambda params, tokens: torch.renorm(params.embed, 2, 0, 1.0)
        return built

    monkeypatch.setattr(specs, "build_cell", build)
    rec = dryrun.run_cell("tinyllama-1.1b", "prefill_32k", False, None, device="cpu")
    assert rec["status"] == "error" and "aten.renorm" in rec["error"]
    assert isinstance(rec["total_s"], float)
