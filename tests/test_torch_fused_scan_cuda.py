"""Kernel 1's resident instance on the card, held bit for bit to the streamed
instance and to kernel 2's bucket scan.

The resident instance (``csrc/fused_minscan.cu``: a TMA / mbarrier
pipeline over 128 × 256 tile pairs) computes every d² entry with the same
fmaf chain and epilogue as the streamed instance and kernel 2
(``csrc/minscan_tile.cuh``), so their row and column mins agree bit for
bit: at sides that are no multiple of 128 or 256, D 1, 3, 17 and 256,
directed and bidirectional, ungated (against kernel 2 too) and gated by
prune tables of an odd and an even number of 128-row tiles (against the
streamed instance under the same tables).  The launch counter per instance and
the ``hd.scan`` span's ``instance`` show which instance ran, and the build
log shows no instance spilling.  Needs a CUDA device; on the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fused_scan_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import projections, tile_bounds  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.hausdorff import batched as B  # noqa: E402
from repro_torch.kernels.hausdorff import hausdorff as K  # noqa: E402
from repro_torch.kernels.hausdorff import ops  # noqa: E402

# (n_a, n_b): ragged against the 128-row a-tile and the 256-row b-tile
SHAPES = ((1000, 3000), (129, 1111), (300, 257))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only there")
    return torch.device("cuda")


def _sorted_clouds(seed, n_a, n_b, d, dev):
    """Clouds sorted along their primary projection (so the gate bites),
    with their projections."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand(n_a, d, generator=g, device=dev)
    b = torch.rand(n_b, d, generator=g, device=dev) + 0.1
    dirs = projections.direction_set(a, b, projections.default_num_directions(d))
    sa, pa, _, _ = tile_bounds.order_by_projection(a, projections.project(a, dirs))
    sb, pb, _, _ = tile_bounds.order_by_projection(b, projections.project(b, dirs))
    return sa.contiguous(), pa, sb.contiguous(), pb


def _kernel1(a, b, plan, directed, tables=None, blocks=(K.TABLE_BLOCK, K.TABLE_BLOCK)):
    a2, b2 = (a * a).sum(1), (b * b).sum(1)
    ma = torch.full((a.shape[0],), torch.inf, device=a.device)
    mb = torch.full((b.shape[0],), torch.inf, device=a.device)
    lb, cut_a, cut_b = tables if tables is not None else (None, None, None)
    name = K.fused_minscan(a, b, a2, b2, ma, mb, lb=lb, cut_a=cut_a, cut_b=cut_b, block_a=blocks[0],
                           block_b=blocks[1], directed=directed, plan=plan)
    return name, ma, mb


def _kernel2(a, b, directed):
    a2, b2 = (a * a).sum(1), (b * b).sum(1)
    ma = torch.full((1, a.shape[0]), torch.inf, device=a.device)
    mb = torch.full((1, b.shape[0]), torch.inf, device=a.device)
    B.batched_minscan(a[None], a2[None], b[None], b2[None], ma, mb, directed=directed)
    return ma[0], mb[0]


@pytest.mark.cuda
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("d", [1, 3, 17, 256])
def test_resident_bitwise_streamed_and_bucket_scan(dev, d, directed):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n_a, n_b in SHAPES:
        a, pa, b, pb = _sorted_clouds(d * 7 + n_a, n_a, n_b, d, dev)
        plans = {"resident": K.launch_plan(n_a, n_b, d, sms, resident=True),
                 "streamed": K.launch_plan(n_a, n_b, d, sms, resident=False)}
        plans["resident, 5 CTAs"] = plans["resident"]._replace(grid=5)
        k2a, k2b = _kernel2(a, b, directed)
        # prune tables of 1 and 4 tiles of 128 rows: a 256-row b-tile spans two blocks or one
        gated = {}
        for block in (128, 512):
            blocks = (ops.fit_block(block, n_a), ops.fit_block(block, n_b))
            gated[block] = (tile_bounds.prune_tables(a, pa, None, b, pb, None, *blocks, directed=directed), blocks)
        pruned = {block: _kernel1(a, b, plans["streamed"], directed, *gated[block])[1:] for block in gated}
        for label, plan in plans.items():
            name, ma, mb = _kernel1(a, b, plan, directed)
            assert name == K.instance(plan.resident, directed)
            case = (n_a, n_b, d, directed, label)
            assert torch.equal(ma, k2a), case
            if directed:
                assert torch.isinf(mb).all(), case  # min_b left as given
            else:
                assert torch.equal(mb, k2b), case
            for block, (want_a, want_b) in pruned.items():
                _, pra, prb = _kernel1(a, b, plan, directed, *gated[block])
                assert torch.equal(pra, want_a), (*case, block)
                assert torch.equal(prb, want_b), (*case, block)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("directed", [False, True])
def test_instance_counter_and_scan_span(dev, directed):
    """The main path's shapes take the resident instance, a 256² refine the
    streamed one; the counter and the ``hd.scan`` span say so."""
    g = torch.Generator(device=dev).manual_seed(5)
    for (n_a, n_b, d), resident in (((512, 131_072, 16), True), ((256, 256, 256), False)):
        a = torch.rand(n_a, d, generator=g, device=dev)
        b = torch.rand(n_b, d, generator=g, device=dev)
        want = K.instance(resident, directed)
        before = dict(K.fused_minscan.instance_launches)
        with obs.capture() as get_events:
            ops.fused_min_sqdists(a, b, directed=directed)
            scans = [r for r in get_events() if r["type"] == "span" and r["name"] == "hd.scan"]
        after = K.fused_minscan.instance_launches
        assert {k: after[k] - before[k] for k in K.INSTANCES} == {k: int(k == want) for k in K.INSTANCES}
        assert [s["attrs"]["instance"] for s in scans] == [want]


@pytest.mark.cuda
def test_no_instance_spills(dev):
    """ptxas's report of the library that ran: four instances, no spill."""
    K.build()
    logs = sorted(_build.BUILD_DIR.glob("fused_minscan-*.log"), key=lambda f: f.stat().st_mtime)
    report = {k: v for k, v in _build.ptxas_report(logs[-1].read_text()).items() if "fused_minscan_" in k}
    assert len(report) == 4, report
    assert all(v.get("spill_bytes") == 0 for v in report.values()), report
