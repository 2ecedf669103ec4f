"""The port's analysis modules held to the reference's.

* ``bytes_model``: every LM, GNN and recsys cell, at several (model shards,
  batch shards) pairs and microbatch counts, equal to the reference's
  formulas value for value.
* ``count_collectives``: the collectives of the reference's HLO snippet
  (``tests/test_analysis.py``), issued on a ``fake`` process group with the
  same result shapes and group sizes, give ``parse_collectives``'s
  ``CollectiveStats``.  The snippet's asynchronous all-gather pair is the one
  line left out of the equality: the parser halves its (operand, result)
  tuple, an estimate of the result, where the counter sees the result.
* ``Roofline``: with the reference's v5e constants as the ``DeviceSpec``,
  every term and the summary equal the reference's.
* ``report``: the dry-run, roofline and variant tables equal the
  reference's on the same records (the notes, which name the card's
  remedies, excluded).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.distributed._functional_collectives as funcol  # noqa: E402

from repro.analysis import bytes_model as ref_bm  # noqa: E402
from repro.analysis import report as ref_report  # noqa: E402
from repro.analysis import roofline as ref_roofline  # noqa: E402
from repro.configs import base as ref_base  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro_torch.analysis import bytes_model as bm  # noqa: E402
from repro_torch.analysis import report  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import fake_process_group  # noqa: E402
from repro_torch.sharding.collectives import all_reduce_sum  # noqa: E402

PAIRS = [(1, 1), (16, 16), (16, 32), (1, 256), (8, 4)]
LMS = ("tinyllama-1.1b", "stablelm-3b", "deepseek-67b", "grok-1-314b", "olmoe-1b-7b")
RECSYS = ("dien", "bert4rec", "bst", "fm")


@pytest.mark.parametrize("aid", LMS)
def test_lm_bytes_model_equals_the_reference(aid):
    spec, ref_spec = base.load_arch(aid), ref_base.load_arch(aid)
    for cell, ref_cell in zip(spec.shapes, ref_spec.shapes):
        for ms, bs in PAIRS:
            assert bm.lm_bytes(spec.config, cell, ms=ms, bs=bs) == ref_bm.lm_bytes(ref_spec.config, ref_cell,
                                                                                   ms=ms, bs=bs)
            for mb in (1, 2, 4):
                assert bm.lm_peak_memory(spec.config, cell, ms=ms, bs=bs, microbatches=mb) == \
                    ref_bm.lm_peak_memory(ref_spec.config, ref_cell, ms=ms, bs=bs, microbatches=mb)


def test_gnn_and_recsys_bytes_models_equal_the_reference():
    spec, ref_spec = base.load_arch("gat-cora"), ref_base.load_arch("gat-cora")
    for cell, ref_cell in zip(spec.shapes, ref_spec.shapes):
        for nb in (1, 256, 512):
            dims, ref_dims = specs.gnn_cell_dims(cell, nb), ref_specs.gnn_cell_dims(ref_cell, nb)
            assert dims == ref_dims
            assert bm.gnn_bytes(spec.config, dims, n_shards=nb) == ref_bm.gnn_bytes(ref_spec.config, ref_dims,
                                                                                    n_shards=nb)
    for aid in RECSYS:
        spec, ref_spec = base.load_arch(aid), ref_base.load_arch(aid)
        for cell, ref_cell in zip(spec.shapes, ref_spec.shapes):
            for ms, bs in PAIRS:
                assert bm.recsys_bytes(spec.config, cell, ms=ms, bs=bs) == \
                    ref_bm.recsys_bytes(ref_spec.config, ref_cell, ms=ms, bs=bs)


HLO_SYNC = """
ENTRY %main {
  %ar = f32[16,1024]{1,0} all-reduce(%x), replica_groups=[32,16]<=[512], to_apply=%add
  %ag = bf16[8,512,256]{2,1,0} all-gather(%y), replica_groups={{0,1,2,3}}, dimensions={1}
  %rs = bf16[8,32]{1,0} reduce-scatter(%z), replica_groups=[1,16]<=[16], to_apply=%add
  %cp = f32[128]{0} collective-permute(%w), source_target_pairs={{0,1}}
  %a2a = f32[4,16]{1,0} all-to-all(%v), replica_groups={{0,1}}
}
"""


def test_count_collectives_equals_parse_collectives():
    with fake_process_group(16):
        g16, g4, g2 = dist.new_group(list(range(16))), dist.new_group([0, 1, 2, 3]), dist.new_group([0, 1])
        with roofline.count_collectives() as counted:
            funcol.all_reduce(torch.ones(16, 1024), "sum", g16).wait()
            funcol.all_gather_tensor(torch.ones(2, 512, 256, dtype=torch.bfloat16), 0, g4).wait()
            funcol.reduce_scatter_tensor(torch.ones(128, 32, dtype=torch.bfloat16), "sum", 0, g16).wait()
            funcol.permute_tensor(torch.ones(128), [1, 0], g2).wait()
            funcol.all_to_all_single(torch.ones(4, 16), None, None, g2).wait()
        want = ref_roofline.parse_collectives(HLO_SYNC)
        assert counted.stats.by_op == want.by_op
        assert counted.stats.wire_bytes == want.wire_bytes
        # c10d collectives (the SPMD bodies') and the async pair's true result
        with roofline.count_collectives() as c10d:
            x = torch.ones(8)
            dist.all_reduce(x, group=g4)
            all_reduce_sum(torch.ones(8), g4)
            parts = [torch.empty(64, dtype=torch.bfloat16) for _ in range(4)]
            dist.all_gather(parts, torch.ones(64, dtype=torch.bfloat16), group=g4)
        assert c10d.stats.by_op == {"all-reduce": {"count": 2, "bytes": 2 * 8 * 4 * 2.0},
                                    "all-gather": {"count": 1, "bytes": 256 * 2.0}}
        # groups within one node of 8 ride NVLink, the rest the network
        assert roofline.link_bandwidth(range(8)) == roofline.NVLINK_BW
        assert roofline.link_bandwidth([0, 8]) == roofline.NET_BW


V5E = roofline.DeviceSpec(name="v5e", peak_flops=ref_roofline.PEAK_FLOPS, hbm_bw=ref_roofline.HBM_BW,
                          hbm_bytes=16 * (1 << 30), link_bw=ref_roofline.LINK_BW)


@pytest.mark.parametrize("case", [(197e12, 819e9, 25e9, 197e12 * 256 * 0.5, 256),
                                  (3.1e13, 4.4e11, 9.9e10, 1.2e15, 512), (0.0, 1e9, 0.0, 0.0, 1)])
def test_roofline_equals_the_reference_under_its_constants(case):
    flops, nbytes, wire, model, n = case
    by_op = {"all-reduce": {"count": 3, "bytes": wire}}
    got = roofline.Roofline(flops, nbytes, wire, by_op, model, n, device=V5E)
    want = ref_roofline.Roofline(flops, nbytes, wire, by_op, model, n)
    for term in ("t_compute", "t_memory", "t_collective", "bottleneck", "t_bound"):
        assert getattr(got, term) == getattr(want, term), term
    np.testing.assert_equal(got.summary(), want.summary())


def _records(tmp_path):
    ok = {"arch": "tinyllama-1.1b", "shape": "train_4k", "mesh": "pod16x16", "status": "ok", "variant": "baseline",
          "compile_s": 12.5, "memory": {"argument_size_in_bytes": 3 << 30, "temp_size_in_bytes": 5 << 29},
          "roofline": ref_roofline.Roofline(2e14, 9e11, 4e10, {}, 6.9e15, 256).summary()}
    var = dict(ok, variant="dp_zero1", roofline=ref_roofline.Roofline(2e14, 9e11, 1e10, {}, 6.9e15, 256).summary())
    dec = dict(ok, shape="decode_32k", roofline=ref_roofline.Roofline(1e9, 9e10, 1e6, {}, 1e11, 256).summary())
    skip = {"arch": "tinyllama-1.1b", "shape": "long_500k", "mesh": "pod16x16", "status": "skipped",
            "variant": "baseline", "reason": "pure full-attention arch: long_500k requires sub-quadratic"}
    err = {"arch": "fm", "shape": "serve_p99", "mesh": "pod2x16x16", "status": "error", "variant": "baseline"}
    for i, r in enumerate((ok, var, dec, skip, err)):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    return tmp_path


def test_report_tables_equal_the_reference(tmp_path):
    out = _records(tmp_path)
    recs, ref_recs = report.load_records(out), ref_report.load_records(out)
    assert recs == ref_recs
    assert report.dryrun_table(recs) == ref_report.dryrun_table(ref_recs)
    assert report.roofline_table(recs) == ref_report.roofline_table(ref_recs)
    assert report.variants_table(out) == ref_report.variants_table(out)
    notes, ref_notes = report.notes_table(recs).splitlines(), ref_report.notes_table(ref_recs).splitlines()
    assert [ln.rsplit("|", 2)[0] for ln in notes] == [ln.rsplit("|", 2)[0] for ln in ref_notes]
    assert report.summarize(out).split("## Bottleneck notes")[0] == ref_report.summarize(out).split(
        "## Bottleneck notes")[0]
