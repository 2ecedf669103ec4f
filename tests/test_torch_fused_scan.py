"""The port's fused min-d² scan (plain path) held to the JAX reference.

Same numpy inputs go through ``repro.core.exact.fused_min_sqdists_tiled``
(the reference kernel's pure-JAX mirror; the Pallas body does not trace on
this jax), the reference oracle ``repro.kernels.hausdorff.ref``, and the
port's ``repro_torch.kernels.hausdorff.ops.fused_min_sqdists`` on CPU
tensors (its plain version).  Tolerances:

  * per min-d² entry: ``2·(D+2)·eps32·scale²`` — two fp32 GEMM-form
    computations in different k orders;
  * per HD value: ``fp_value_margin(D, scale, value)`` against float64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import exact as jexact  # noqa: E402
from repro.kernels.hausdorff import ref as jref  # noqa: E402
from repro_torch.core import exact, projections, tile_bounds  # noqa: E402
from repro_torch.core.fp_margin import fp_value_margin, sqdist_tolerance  # noqa: E402
from repro_torch.kernels.hausdorff import hausdorff as K  # noqa: E402
from repro_torch.kernels.hausdorff import ops, ref  # noqa: E402

BLOCK = 128


def _clouds(seed, n_a, n_b, d, offset=0.1):
    rng = np.random.default_rng(seed)
    a = rng.random((n_a, d), dtype=np.float32)
    b = rng.random((n_b, d), dtype=np.float32) + np.float32(offset)
    return a, b


def _masks(seed, n_a, n_b):
    rng = np.random.default_rng(seed + 1)
    va = rng.random(n_a) > 0.2
    vb = rng.random(n_b) > 0.2
    va[0] = vb[0] = True
    return va, vb


def _scale(a, b):
    return float(max(np.linalg.norm(a, axis=1).max(), np.linalg.norm(b, axis=1).max()))


def _oracle_min_sqdists(a, b, vb=None):
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    d2 = ((a64[:, None, :] - b64[None, :, :]) ** 2).sum(-1)
    if vb is not None:
        d2 = np.where(vb[None, :], d2, np.inf)
    return d2.min(axis=1)


def _hd64(a, b, va=None, vb=None):
    def directed(x, y, vx, vy):
        m = _oracle_min_sqdists(x, y, vy)
        if vx is not None:
            m = np.where(vx, m, -np.inf)
        return np.sqrt(max(m.max(), 0.0))

    return max(directed(a, b, va, vb), directed(b, a, vb, va))


def _port_mins(a, b, va=None, vb=None, **kw):
    t = lambda x: None if x is None else torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    ma, mb = ops.fused_min_sqdists(t(a), t(b), valid_a=t(va), valid_b=t(vb), **kw)
    return ma.numpy(), mb.numpy()


def _assert_entries(port, refv, valid, tol):
    keep = np.ones(port.shape, bool) if valid is None else valid
    assert np.all(np.isinf(port[~keep]))
    np.testing.assert_allclose(port[keep], refv[keep], rtol=0, atol=tol)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(40, 30, 5), (300, 170, 33), (129, 257, 64)])
def test_fused_min_sqdists_matches_reference(shape, masked):
    n_a, n_b, d = shape
    a, b = _clouds(3, n_a, n_b, d)
    va, vb = _masks(3, n_a, n_b) if masked else (None, None)
    tol = sqdist_tolerance(d, _scale(a, b))

    pa, pb = _port_mins(a, b, va, vb, block_a=BLOCK, block_b=BLOCK)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    ja, jb = jexact.fused_min_sqdists_tiled(
        jnp.asarray(a), jnp.asarray(b), valid_a=j(va), valid_b=j(vb), block_a=BLOCK, block_b=BLOCK
    )
    _assert_entries(pa, np.asarray(ja), va, tol)
    _assert_entries(pb, np.asarray(jb), vb, tol)
    # the reference's independent oracle, both directions
    _assert_entries(pa, np.asarray(jref.min_dists_ref(jnp.asarray(a), jnp.asarray(b), j(vb))), va, tol)
    _assert_entries(pb, np.asarray(jref.min_dists_ref(jnp.asarray(b), jnp.asarray(a), j(va))), vb, tol)

    h = max(
        float(exact.finalize_mins(torch.from_numpy(pa), None if va is None else torch.from_numpy(va))),
        float(exact.finalize_mins(torch.from_numpy(pb), None if vb is None else torch.from_numpy(vb))),
    )
    h64 = _hd64(a, b, va, vb)
    assert abs(h - h64) <= fp_value_margin(d, _scale(a, b), h)
    h_ref = float(jref.hausdorff_ref(jnp.asarray(a), jnp.asarray(b), j(va), j(vb)))
    assert abs(h - h_ref) <= fp_value_margin(d, _scale(a, b), h)


def test_port_oracle_matches_reference_oracle():
    a, b = _clouds(5, 50, 40, 7)
    va, vb = _masks(5, 50, 40)
    ta, tb, tva, tvb = map(torch.from_numpy, (a, b, va, vb))
    np.testing.assert_allclose(
        ref.min_dists_ref(ta, tb, tvb).numpy(),
        np.asarray(jref.min_dists_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb))),
        rtol=1e-6, atol=1e-6,
    )
    h = float(ref.hausdorff_ref(ta, tb, tva, tvb, dtype=torch.float64))
    assert h == pytest.approx(_hd64(a, b, va, vb), rel=1e-12)


@pytest.mark.parametrize("seed,shape", [(0, (1, 1, 1)), (811, (38, 8, 17))])
def test_reference_failing_shapes_against_float64(seed, shape):
    """Shapes the reference fails in its own conformance sweep, judged
    against the float64 oracle, masked and raw."""
    n_a, n_b, d = shape
    a, b = _clouds(seed, n_a, n_b, d)
    tol = sqdist_tolerance(d, _scale(a, b))
    for va, vb in ((None, None), _masks(seed, n_a, n_b)):
        pa, pb = _port_mins(a, b, va, vb)
        _assert_entries(pa, _oracle_min_sqdists(a, b, vb), va, tol)
        _assert_entries(pb, _oracle_min_sqdists(b, a, va), vb, tol)
        h = max(
            float(exact.finalize_mins(torch.from_numpy(pa), None if va is None else torch.from_numpy(va))),
            float(exact.finalize_mins(torch.from_numpy(pb), None if vb is None else torch.from_numpy(vb))),
        )
        assert abs(h - _hd64(a, b, va, vb)) <= fp_value_margin(d, _scale(a, b), h)


def test_masked_garbage_rows_and_padding_never_leak():
    """Invalid rows holding NaN/inf change nothing: the valid entries equal
    those of the clouds without those rows (within the d² tolerance)."""
    a, b = _clouds(9, 90, 70, 12)
    tol = sqdist_tolerance(12, _scale(a, b))
    ga = np.concatenate([a, np.full((10, 12), np.nan, np.float32)])
    gb = np.concatenate([b, np.full((6, 12), np.inf, np.float32)])
    va = np.arange(100) < 90
    vb = np.arange(76) < 70
    pa, pb = _port_mins(ga, gb, va, vb, block_a=64, block_b=64)
    ra, rb = _port_mins(a, b, block_a=64, block_b=64)
    assert not np.isnan(pa).any() and not np.isnan(pb).any()
    np.testing.assert_allclose(pa[:90], ra, rtol=0, atol=tol)
    np.testing.assert_allclose(pb[:70], rb, rtol=0, atol=tol)
    assert np.isinf(pa[90:]).all() and np.isinf(pb[70:]).all()


def test_empty_sides():
    """Empty query side → 0.0; empty target side → +inf (as the reference)."""
    a, b = _clouds(1, 20, 15, 4)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    none_a = torch.zeros(20, dtype=torch.bool)
    none_b = torch.zeros(15, dtype=torch.bool)
    assert float(ops.directed_hausdorff(ta, tb, valid_a=none_a)) == 0.0
    assert float(ops.directed_hausdorff(ta, tb, valid_b=none_b)) == float("inf")
    ma, mb = ops.fused_min_sqdists(ta, tb, valid_a=none_a)
    assert torch.isinf(ma).all() and torch.isinf(mb).all()
    ref_empty = jexact.hausdorff_fused_tiled(
        jnp.asarray(a), jnp.asarray(b), valid_a=jnp.zeros(20, bool), valid_b=jnp.zeros(15, bool)
    )
    port_empty = ops.hausdorff(ta, tb, valid_a=none_a, valid_b=none_b)
    assert float(port_empty) == float(ref_empty) == 0.0


def _sorted_with_projs(a, b, m):
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    dirs = projections.direction_set(ta, tb, m)
    sa, pa, _, _ = tile_bounds.order_by_projection(ta, projections.project(ta, dirs))
    sb, pb, _, _ = tile_bounds.order_by_projection(tb, projections.project(tb, dirs))
    return sa, pa, sb, pb


@pytest.mark.parametrize("d,offset", [(2, 0.1), (16, 3.0)])
def test_pruned_equals_unpruned_bitwise(d, offset):
    """At a fixed tile grid, the pruned scan returns bitwise the unpruned
    row and column mins, and the bounds do skip tiles."""
    a, b = _clouds(4, 1500, 1100, d, offset=offset)
    sa, pa, sb, pb = _sorted_with_projs(a, b, projections.default_num_directions(d))
    for blk in (128, 256):
        base = ops.fused_min_sqdists(sa, sb, block_a=blk, block_b=blk)
        pruned = ops.fused_min_sqdists(sa, sb, prune_projs=(pa, pb), block_a=blk, block_b=blk)
        assert torch.equal(base[0], pruned[0]) and torch.equal(base[1], pruned[1])
        tables = tile_bounds.prune_tables(sa, pa, None, sb, pb, None, blk, blk)
        assert float(tile_bounds.skip_fraction(tables)) > 0.0
    hd_pr = exact.directed_hd_tiled(sa, sb, block=128, prune_projs=(pa, pb))
    assert torch.equal(hd_pr, exact.directed_hd_tiled(sa, sb, block=128))


def test_prune_tables_match_reference():
    """lb / cut tables agree with the reference's on the same projections."""
    import jax

    from repro.core import tile_bounds as jtb

    a, b = _clouds(6, 700, 500, 6)
    sa, pa, sb, pb = _sorted_with_projs(a, b, 2)
    port = tile_bounds.prune_tables(sa, pa, None, sb, pb, None, 128, 128)
    ref_tables = jax.jit(lambda *x: jtb.prune_tables(x[0], x[1], None, x[2], x[3], None, 128, 128))
    refp = ref_tables(*(jnp.asarray(t.numpy()) for t in (sa, pa, sb, pb)))
    np.testing.assert_allclose(port.lb.numpy(), np.asarray(refp.lb), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.cut_a.numpy(), np.asarray(refp.cut_a), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.cut_b.numpy(), np.asarray(refp.cut_b), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        tile_bounds.skip_mask(port).numpy(), np.asarray(jtb.skip_mask(refp))
    )


def test_fit_block_is_a_tile_multiple():
    assert ops.fit_block(512, 8) == K.TILE
    assert ops.fit_block(512, 10_000) == 512
    assert ops.fit_block(200, 10_000) == 256
    assert ops.fit_block(512, 300) == 384


@pytest.mark.parametrize("resident", [None, True, False])
@pytest.mark.parametrize("ctas_per_sm", [1, 2])
@pytest.mark.parametrize("n_a,n_b", [(8, 8), (41_930, 1 << 20), (4096, 65_536), (1 << 20, 1 << 21)])
def test_launch_grid_covers_every_tile_pair(n_a, n_b, ctas_per_sm, resident):
    """One launch covers every tile pair once, of either instance's tile
    (128 × 256 rows resident, 128 × 128 streamed): the CTAs' pair ranges
    tile [0, tiles_a·tiles_b) without gap or overlap, and a small query
    side still fills 132 SMs."""
    plan = K.launch_plan(n_a, n_b, 256, 132, ctas_per_sm=ctas_per_sm, resident=resident)
    tiles_a, tiles_b = -(-n_a // K.TILE), -(-n_b // K.tile_b(plan.resident))
    assert plan.n_pairs == tiles_a * tiles_b
    assert plan.grid == min(plan.n_pairs, 132 * ctas_per_sm) and plan.grid <= 2**31 - 1
    ranges = [K.pair_range(plan, c) for c in range(plan.grid)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.n_pairs
    assert all(r[1] == s[0] for r, s in zip(ranges, ranges[1:]))
    lengths = [e - b for b, e in ranges]
    assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1  # balanced to one pair
    assert plan.grid >= min(plan.n_pairs, 132)
    # pair p is tile pair (p // tiles_b, p % tiles_b): a bijection onto the grid of tiles
    last = plan.n_pairs - 1
    assert divmod(last, tiles_b) == (tiles_a - 1, tiles_b - 1)


@pytest.mark.parametrize("d", [1, 3, 17, 256, 257, 784, 4096])
def test_launch_plan_shared_memory_fits(d):
    """Every plan stays within a block's 232,448 bytes of shared memory: the
    resident instance where its a-tile fits beside the ring (D up to 256)
    and a CTA walks enough of its 256-row b-tiles, else streamed; a
    resident tile that cannot fit is refused."""
    for n_a, n_b in ((65_536, 65_536), (41_930, 1 << 20), (256, 256), (1 << 20, 128)):
        plan = K.launch_plan(n_a, n_b, d, 132)
        assert plan.smem == K.plan_smem_bytes(d, plan.resident) <= K.MAX_SMEM
        assert plan.ld % 4 == 0 and plan.ld >= d
        tiles_b = -(-n_b // K.tile_b(True))
        walk = min(tiles_b, -(-n_a // K.TILE) * tiles_b // min(-(-n_a // K.TILE) * tiles_b, 132))
        assert plan.resident == (d <= 256 and walk >= 4), (n_a, n_b, d, plan)
    streamed = K.launch_plan(65_536, 65_536, d, 132, resident=False)
    assert not streamed.resident and streamed.smem == K.smem_bytes(d, False) <= K.MAX_SMEM
    if d <= 256:
        assert K.launch_plan(256, 256, d, 132, resident=True).resident
    else:
        with pytest.raises(ValueError, match="resident"):
            K.launch_plan(256, 256, d, 132, resident=True)


@pytest.mark.parametrize("n_a,n_b,d,resident", [
    (41_930, 1 << 20, 256, True),   # rc256.prohd_1m's sweeps
    (262_144, 262_144, 256, True),  # rc256.exact_256k
    (256, 256, 256, False),         # a stage-2b refine
    (65_536, 65_536, 784, False),   # MNIST's D
    (65_536, 65_536, 4096, False),  # an LM's width
])
def test_launch_plan_picks_the_instance(n_a, n_b, d, resident):
    """The main path's shapes take the resident instance; small shapes and
    wide D the streamed one, whose layout is the tile body's."""
    plan = K.launch_plan(n_a, n_b, d, 132)
    assert plan.resident == resident
    assert plan.smem == (K.resident_smem_bytes(d) if resident else K.smem_bytes(d, False))
    assert K.instance(plan.resident, True) == ("resident" if resident else "streamed") + ".directed"


def test_resident_layout_mirrors_the_kernel_source():
    """The Python mirror of the resident instance's layout takes the kernel
    source's defaults; at D 256 (the largest that fits) its shared memory
    is the a-tile's 8 slices, the 3-slot ring of 256-row slices, 14
    mbarriers and two column rows."""
    import re

    src = K.SOURCE.read_text()
    macro = lambda name: int(re.search(rf"#define {name} (\d+)", src).group(1))  # noqa: E731
    assert K._RING == macro("MINSCAN_RING")
    assert K.tile_b(True) == 16 * macro("MINSCAN_QN") and K.tile_b(False) == K.TILE
    assert K.resident_smem_bytes(256) == 8 * 16_384 + 3 * 32_768 + 8 * 14 + 2 * 256 * 4 == 231_536
    assert K.resident_smem_bytes(256) <= K.MAX_SMEM < K.resident_smem_bytes(257)
    assert K.INSTANCES == tuple(K.instance(r, d) for r in (True, False) for d in (True, False))


@pytest.mark.parametrize("n_b", [769, 4096, 262_144, 1 << 20])
def test_prune_blocks_are_whole_resident_tiles(n_b):
    """Where the plan takes the resident instance, the ops wrapper's
    default prune-table block is a whole number of its 256-row b-tiles
    (a block of an odd number of 128-row tiles still gates correctly: the
    kernel then checks both blocks a b-tile spans)."""
    plan = K.launch_plan(41_930, n_b, 256, 132)
    assert plan.resident
    assert K.TABLE_BLOCK % K.tile_b(True) == 0
    assert ops.fit_block(K.TABLE_BLOCK, n_b) % K.tile_b(True) == 0


def test_cuda_launcher_refuses_cpu_tensors_and_cpu_path_never_launches():
    a, b = _clouds(2, 10, 10, 3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    z = torch.zeros(10)
    with pytest.raises(ValueError, match="CUDA"):
        K.fused_minscan(ta, tb, z, z, z.clone(), z.clone())
    with pytest.raises(ValueError, match="CUDA"):
        K.fused_minscan(ta, tb, z, z, z.clone(), z.clone(), directed=True)
    before = K.fused_minscan.launches
    ops.fused_min_sqdists(ta, tb)
    ops.fused_min_sqdists(ta, tb, directed=True)
    assert K.fused_minscan.launches == before


@pytest.mark.parametrize("directed", [1, "yes", None])
def test_cuda_launcher_validates_directed(directed):
    a, b = _clouds(2, 10, 10, 3)
    z = torch.zeros(10)
    with pytest.raises(TypeError, match="directed"):
        K.fused_minscan(torch.from_numpy(a), torch.from_numpy(b), z, z, z.clone(), z.clone(),
                        directed=directed)


@pytest.mark.parametrize("masked", [False, True])
def test_min_sqdists_on_cpu_is_the_plain_row_mins(masked):
    """The directed wrapper (ProHD's sweeps) on CPU tensors returns the plain
    version's row mins, bit for bit, and the reference's within tolerance."""
    a, b = _clouds(7, 300, 450, 19)
    va, vb = _masks(7, 300, 450) if masked else (None, None)
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    got = ops.min_sqdists(t(a), t(b), valid_a=t(va), valid_b=t(vb))
    want, _ = exact.fused_min_sqdists_tiled(t(a), t(b), valid_a=t(va), valid_b=t(vb),
                                            block_a=K.TABLE_BLOCK, block_b=K.TABLE_BLOCK)
    assert torch.equal(got, want)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    _assert_entries(got.numpy(), np.asarray(jref.min_dists_ref(jnp.asarray(a), jnp.asarray(b), j(vb))),
                    va, sqdist_tolerance(19, _scale(a, b)))
