"""The port's batched bucket scan (plain path) held to the JAX reference.

Same numpy inputs go through the reference's
``repro.kernels.hausdorff.batched.batched_min_sqdists_mirror`` /
``batched_bucket_hd(use_pallas=False)`` (the Pallas body does not trace on
this jax) and the port's ``repro_torch.kernels.hausdorff.batched`` on CPU
tensors, which run its plain version.  Tolerances:

  * per min-d² entry: ``2·(D+2)·eps32·scale²`` — two fp32 GEMM-form
    computations in different k orders;
  * per HD value: ``fp_value_margin(D, scale, value)``.

The launch plan of the bucket scans (``bucket_launch_plan``, kernels 2 and
3), the launchers' operand staging and their refusal of plans that do not
fit are Python, and are tested here too: the kernels themselves run only
on the card (``chip_smoke.py`` phases 3b and 3c).

Gate semantics follow the Pallas kernel's written test ``lb <= cut``: a
NaN bound gates the set.  The reference's pure-JAX mirror tests
``lb > cut`` instead and so computes a NaN-bound set; that case is judged
against the kernel's convention, not the mirror.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import exact as jexact  # noqa: E402
from repro.kernels.hausdorff import batched as jbatched  # noqa: E402
from repro_torch.core import exact  # noqa: E402
from repro_torch.core.fp_margin import fp_value_margin, sqdist_tolerance  # noqa: E402
from repro_torch.kernels.hausdorff import batched as B  # noqa: E402
from repro_torch.kernels.hausdorff import hausdorff as K  # noqa: E402


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _case(seed, n_sets, n_q, cap, d, *, ragged=True):
    rng = np.random.RandomState(seed)
    q = rng.randn(n_q, d).astype(np.float32)
    slab = (rng.randn(n_sets, cap, d) * 1.5 + 0.25).astype(np.float32)
    valid = np.ones((n_sets, cap), bool)
    if ragged:
        lens = rng.randint(1, cap + 1, size=n_sets)
        valid = np.arange(cap)[None, :] < lens[:, None]
        slab[~valid] = 7.7e8   # garbage in padding rows must never leak
    return q, slab, valid


def _scale(*xs):
    return float(max(np.linalg.norm(x.reshape(-1, x.shape[-1]), axis=1).max() for x in xs))


def _hd64(a, b, va, vb, directed):
    """float64 (directed) HD over valid rows, empty-side conventions."""
    a64, b64 = a[va].astype(np.float64), b[vb].astype(np.float64)
    if a64.shape[0] == 0:
        h_ab = 0.0
    elif b64.shape[0] == 0:
        h_ab = np.inf
    else:
        h_ab = np.sqrt(((a64[:, None] - b64[None]) ** 2).sum(-1).min(1).max())
    if directed:
        return h_ab
    if b64.shape[0] == 0:
        return np.inf
    h_ba = 0.0 if a64.shape[0] == 0 else np.sqrt(((b64[:, None] - a64[None]) ** 2).sum(-1).min(1).max())
    return max(h_ab, h_ba)


@pytest.mark.parametrize("shape", [(7, 9, 16, 5), (12, 33, 64, 16), (3, 1, 8, 2)], ids=str)
def test_min_sqdists_match_reference_mirror(shape):
    n_sets, n_q, cap, d = shape
    q, slab, valid = _case(sum(shape), n_sets, n_q, cap, d)
    valid[min(1, n_sets - 1)] = False            # one all-invalid lane
    ra, rb = jbatched.batched_min_sqdists_mirror(
        jnp.asarray(q), jnp.asarray(slab), valid_slab=jnp.asarray(valid))
    pa, pb = B.batched_min_sqdists(_t(q), _t(slab), valid_slab=_t(valid))
    ra, rb, pa, pb = np.asarray(ra), np.asarray(rb), pa.numpy(), pb.numpy()
    tol = sqdist_tolerance(d, _scale(q, np.where(valid[..., None], slab, 0)))
    for port, ref in ((pa, ra), (pb, rb)):
        fin = np.isfinite(ref)
        assert np.array_equal(fin, np.isfinite(port))
        np.testing.assert_allclose(port[fin], ref[fin], rtol=0, atol=tol)
    assert np.isinf(pb[~valid]).all()


@pytest.mark.parametrize("directed", [False, True], ids=["H", "h"])
def test_bucket_hd_matches_reference_and_float64(directed):
    q, slab, valid = _case(3, 10, 20, 32, 6)
    ref = np.asarray(jbatched.batched_bucket_hd(
        jnp.asarray(q), jnp.asarray(slab), valid_slab=jnp.asarray(valid),
        directed=directed, use_pallas=False))
    port = B.batched_bucket_hd(_t(q), _t(slab), valid_slab=_t(valid), directed=directed).numpy()
    va = np.ones(q.shape[0], bool)
    scale = _scale(q, np.where(valid[..., None], slab, 0))
    for s in range(slab.shape[0]):
        m = fp_value_margin(6, scale, port[s])
        assert abs(port[s] - ref[s]) <= m
        assert abs(port[s] - _hd64(q, slab[s], va, valid[s], directed)) <= m


def test_gate_semantics_nan_bound_and_sentinel():
    q, slab, valid = _case(4, 6, 8, 16, 4)
    lb = np.array([0.0, 2.0, np.nan, 1.0, np.inf, 0.5], np.float32)
    cut = np.array([1.0, 1.0, 1.0, 1.0, np.inf, np.nan], np.float32)
    computed = lb <= cut                      # [T, F, F, T, T, F]
    pa, pb = B.batched_min_sqdists(_t(q), _t(slab), valid_slab=_t(valid), lb=_t(lb), cut=_t(cut))
    ua, ub = B.batched_min_sqdists(_t(q), _t(slab), valid_slab=_t(valid))
    assert torch.isinf(pa[~torch.from_numpy(computed)]).all()
    assert torch.isinf(pb[~torch.from_numpy(computed)]).all()
    # gated vs ungated: every computed lane keeps its bits
    assert torch.equal(pa[torch.from_numpy(computed)], ua[torch.from_numpy(computed)])
    assert torch.equal(pb[torch.from_numpy(computed)], ub[torch.from_numpy(computed)])
    # the reference mirror agrees on every lane whose bounds are not NaN
    ra, _ = jbatched.batched_min_sqdists_mirror(
        jnp.asarray(q), jnp.asarray(slab), valid_slab=jnp.asarray(valid),
        lb=jnp.asarray(lb), cut=jnp.asarray(cut))
    ra = np.asarray(ra)
    plain = ~(np.isnan(lb) | np.isnan(cut))
    assert np.array_equal(np.isinf(ra[plain]).all(1), np.isinf(pa.numpy()[plain]).all(1))
    # the mirror computes the NaN-bound lanes; the kernel's written test gates them
    assert np.isfinite(ra[2]).all() and torch.isinf(pa[2]).all()


def test_all_invalid_lane_and_directed_empty_query_precedence():
    q, slab, valid = _case(5, 4, 6, 8, 3)
    valid[2] = False                                   # empty target lane
    slab[2] = 7.7e8
    for directed in (False, True):
        hd = B.batched_bucket_hd(_t(q), _t(slab), valid_slab=_t(valid), directed=directed)
        assert torch.isinf(hd[2])                       # empty target: +inf
        assert torch.isfinite(hd[[0, 1, 3]]).all()
    none_q = np.zeros(q.shape[0], bool)
    lb = np.array([0.0, 5.0, 0.0, 5.0], np.float32)
    cut = np.ones(4, np.float32)
    # directed: the all-invalid query's 0.0 beats the gated +inf sentinel
    h = B.batched_bucket_hd(_t(q), _t(slab), valid_q=_t(none_q), valid_slab=_t(valid),
                            lb=_t(lb), cut=_t(cut), directed=True)
    assert h.tolist() == [0.0, 0.0, 0.0, 0.0]
    # undirected: the set→query direction's empty target keeps +inf, on
    # gated lanes and on a computed one; with both sides empty, both
    # directions are empty-query 0.0
    h = B.batched_bucket_hd(_t(q), _t(slab), valid_q=_t(none_q), valid_slab=_t(valid),
                            lb=_t(lb), cut=_t(cut))
    assert h.tolist() == [np.inf, np.inf, 0.0, np.inf]
    # the reference agrees on every convention
    for directed, want in ((True, [0.0] * 4), (False, [np.inf, np.inf, 0.0, np.inf])):
        ref = np.asarray(jbatched.batched_bucket_hd(
            jnp.asarray(q), jnp.asarray(slab), valid_q=jnp.asarray(none_q),
            valid_slab=jnp.asarray(valid), lb=jnp.asarray(lb), cut=jnp.asarray(cut),
            directed=directed, use_pallas=False))
        assert ref.tolist() == want


@pytest.mark.parametrize("shared_slab", [False, True], ids=["per-set slab", "shared slab"])
def test_per_set_query_matches_per_lane_fused_scan(shared_slab):
    """The explicit-vmap form: per-lane queries (stage 1's subsets) against
    each lane's set, or against one shared cloud, lane by lane against the
    reference's single-pair ``fused_min_sqdists_tiled``."""
    rng = np.random.RandomState(6)
    n_sets, n_q, cap, d = 5, 11, 16, 7
    qs = rng.randn(n_sets, n_q, d).astype(np.float32)
    vq = rng.rand(n_sets, n_q) > 0.3
    vq[:, 0] = True
    if shared_slab:
        slab, vs = rng.randn(cap, d).astype(np.float32), None
    else:
        _, slab, vs = _case(7, n_sets, 1, cap, d)
    pa, pb = B.batched_min_sqdists(_t(qs), _t(slab), valid_q=_t(vq), valid_slab=_t(vs))
    tol = sqdist_tolerance(d, _scale(qs, np.where(vs[..., None], slab, 0) if vs is not None else slab))
    for s in range(n_sets):
        b_s = slab if shared_slab else slab[s]
        vb_s = None if vs is None else vs[s]
        ra, rb = jexact.fused_min_sqdists_tiled(
            jnp.asarray(qs[s]), jnp.asarray(b_s), valid_a=jnp.asarray(vq[s]),
            valid_b=None if vb_s is None else jnp.asarray(vb_s))
        for port, ref in ((pa[s].numpy(), np.asarray(ra)), (pb[s].numpy(), np.asarray(rb))):
            fin = np.isfinite(ref)
            assert np.array_equal(fin, np.isfinite(port))
            np.testing.assert_allclose(port[fin], ref[fin], rtol=0, atol=tol)


def test_plain_version_bits_ignore_padding_batch_and_composition():
    """Each entry is one product-then-add chain over k in a fixed order, so
    neither padding nor the batch around a lane can move a bit."""
    q, slab, valid = _case(8, 9, 13, 32, 5)
    full_a, full_b = B.batched_min_sqdists(_t(q), _t(slab), valid_slab=_t(valid))
    perm = np.random.RandomState(0).permutation(9)[:4]
    sub_a, sub_b = B.batched_min_sqdists(_t(q), _t(slab[perm]), valid_slab=_t(valid[perm]))
    assert torch.equal(sub_a, full_a[perm]) and torch.equal(sub_b, full_b[perm])
    for s in range(9):
        n = int(valid[s].sum())
        ra, rb = B.batched_min_sqdists(_t(q), _t(slab[s, :n][None]))
        assert torch.equal(ra[0], full_a[s]) and torch.equal(rb[0], full_b[s, :n])


def test_plain_version_matches_port_fused_scan_within_tolerance():
    """The port's two plain scans agree entry by entry (different k orders)."""
    q, slab, valid = _case(9, 4, 40, 64, 16)
    pa, pb = B.batched_min_sqdists(_t(q), _t(slab), valid_slab=_t(valid))
    tol = sqdist_tolerance(16, _scale(q, np.where(valid[..., None], slab, 0)))
    for s in range(4):
        fa, fb = exact.fused_min_sqdists_tiled(_t(q), _t(slab[s]), valid_b=_t(valid[s]))
        assert torch.equal(torch.isfinite(fb), torch.isfinite(pb[s]))
        fin = torch.isfinite(fb)
        torch.testing.assert_close(pa[s], fa, rtol=0, atol=tol)
        torch.testing.assert_close(pb[s][fin], fb[fin], rtol=0, atol=tol)


def test_cuda_launcher_refuses_cpu_tensors_and_cpu_path_never_launches():
    q, slab, valid = _case(10, 2, 4, 8, 3)
    before = B.batched_minscan.launches
    B.batched_bucket_hd(_t(q), _t(slab), valid_slab=_t(valid))
    assert B.batched_minscan.launches == before
    z = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        B.batched_minscan(_t(q)[None].expand(2, 4, 3), z, _t(slab), torch.zeros(2, 8), z, torch.zeros(2, 8))


# ---------------------------------------------------------------------------
# The launch plan of the bucket scans (kernels 2 and 3) and the launcher's
# operand staging, both in Python that runs here.
# ---------------------------------------------------------------------------


def _pair_tiles(plan, n_sets, n_q, cap, begin, end):
    """(item, query tile, slab tile) of pairs begin..end−1, in the order the
    kernel walks them: p = ((g·tiles_q + ti)·n_sets + s')·tiles_s + tj, set
    s = s'·set_step mod n_sets, item g·n_sets + s."""
    tiles_q, tiles_s = -(-n_q // B.TILE), -(-cap // B.TILE)
    p = np.arange(begin, end, dtype=np.int64)
    tj, r = p % tiles_s, p // tiles_s
    sp, r = r % n_sets, r // n_sets
    ti, g = r % tiles_q, r // tiles_q
    s = sp * plan.set_step % n_sets
    return g * n_sets + s, ti, tj


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("ctas_per_sm", [1, 2])
@pytest.mark.parametrize("cap", [64, 128, 256])
@pytest.mark.parametrize("n_q", [100, 300], ids=["n_q<=128", "n_q>128"])
@pytest.mark.parametrize("n_groups,n_sets", [(1, 512), (1, 3), (16, 9780), (4, 20_000)],
                         ids=["kernel2", "kernel2-few-sets", "kernel3", "kernel3-QS>65535"])
def test_bucket_launch_plan_covers_every_tile_pair_once(n_groups, n_sets, n_q, cap, ctas_per_sm, gated):
    """The CTAs' equal ranges tile [0, n_pairs), differ by at most one pair,
    and map onto every (item, query tile, slab tile) exactly once, whatever
    the grid; an ungated pass gets one persistent wave, a gated one ranges
    of at most 16 pairs; a resident plan's ranges stay on few query
    tiles."""
    plan = B.bucket_launch_plan(n_groups, n_sets, n_q, cap, 256, 132, shared_query=True, gated=gated,
                                ctas_per_sm=ctas_per_sm)
    tiles_q, tiles_s = -(-n_q // B.TILE), -(-cap // B.TILE)
    assert plan.n_pairs == n_groups * n_sets * tiles_q * tiles_s
    slots = 132 * ctas_per_sm
    if gated:  # ranges of at most _GATED_RANGE pairs, at least one wave
        assert plan.grid == min(plan.n_pairs, max(slots, -(-plan.n_pairs // B._GATED_RANGE)))
        assert plan.grid == min(plan.n_pairs, slots) or -(-plan.n_pairs // plan.grid) <= B._GATED_RANGE
    else:
        assert plan.grid == min(plan.n_pairs, slots)
    ranges = [K.pair_range(plan, c) for c in range(plan.grid)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.n_pairs
    assert all(r[1] == s[0] for r, s in zip(ranges, ranges[1:]))
    lengths = [e - b for b, e in ranges]
    assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1
    assert np.gcd(plan.set_step, n_sets) == 1 and 1 <= plan.set_step < max(2, n_sets)
    item, ti, tj = _pair_tiles(plan, n_sets, n_q, cap, 0, plan.n_pairs)
    flat = (item * tiles_q + ti) * tiles_s + tj
    assert np.array_equal(np.bincount(flat, minlength=plan.n_pairs), np.ones(plan.n_pairs, np.int64))
    if plan.resident:
        walk = n_sets * tiles_s  # pairs per (query, query tile)
        for b, e in ranges[:: max(1, plan.grid // 16)]:
            _, ti_r, _ = _pair_tiles(plan, n_sets, n_q, cap, b, e)
            assert len(np.unique(ti_r)) <= -(-(e - b) // walk) + 1


@pytest.mark.parametrize("shared_query", [True, False], ids=["shared query", "per-set query"])
@pytest.mark.parametrize("d", [1, 3, 17, 256, 288, 292, 784])
def test_bucket_plan_resident_choice_fits_shared_memory(d, shared_query):
    """A resident query tile is chosen only for a shared query whose tile
    fits beside the ring (D up to 288 within 232,448 B) when a CTA walks
    enough pairs, else the streamed instance; forcing a resident tile that
    cannot be raises, forcing streamed never does."""
    for n_groups, n_sets, n_q, cap in ((1, 512, 128, 256), (16, 9780, 128, 256), (1, 8, 40, 64), (1, 1, 128, 16_384)):
        plan = B.bucket_launch_plan(n_groups, n_sets, n_q, cap, d, 132, shared_query=shared_query)
        assert plan.smem == K.smem_bytes(d, plan.resident) <= K.MAX_SMEM
        assert plan.ld % 4 == 0 and plan.ld >= d
        walk = min(n_sets * -(-cap // B.TILE), plan.n_pairs // plan.grid)
        assert plan.resident == (shared_query and d <= 288 and walk >= 4), (n_sets, cap, d, plan)
        streamed = B.bucket_launch_plan(n_groups, n_sets, n_q, cap, d, 132, shared_query=shared_query,
                                        resident=False)
        assert not streamed.resident and streamed.smem <= K.MAX_SMEM
        if shared_query and d <= 288:
            assert B.bucket_launch_plan(n_groups, n_sets, n_q, cap, d, 132, shared_query=True, resident=True).resident
        else:
            with pytest.raises(ValueError, match="resident"):
                B.bucket_launch_plan(n_groups, n_sets, n_q, cap, d, 132, shared_query=shared_query, resident=True)
    assert K.smem_bytes(256, True) == 203_776


@pytest.mark.parametrize("shared", ["query", "slab", "none"])
@pytest.mark.parametrize("d", [1, 3, 17, 100])
def test_staged_ragged_d_operand_is_bitwise_the_plain_version(d, shared):
    """The launcher stages each operand to rows of ld = D rounded up to 4,
    zero past D; a shared operand from the one set it repeats (never the
    expand).  The plain arithmetic on the staged operands gives the
    unstaged output bit for bit: a zero k-term moves no bit."""
    rng = np.random.RandomState(d)
    n_sets, n_q, cap = 5, 9, 20
    q = torch.from_numpy(rng.randn(n_q if shared == "query" else n_sets * n_q, d).astype(np.float32))
    slab = torch.from_numpy((rng.randn(cap if shared == "slab" else n_sets * cap, d) * 2).astype(np.float32))
    q = q.expand(n_sets, n_q, d) if shared == "query" else q.reshape(n_sets, n_q, d)
    slab = slab.expand(n_sets, cap, d) if shared == "slab" else slab.reshape(n_sets, cap, d)
    q2, b2 = (q * q).sum(-1), (slab * slab).sum(-1)
    ld = K._row_stride(d)
    qx, q_stride = B._staged_operand(q, ld)
    sx, s_stride = B._staged_operand(slab, ld)
    for x, stride, is_shared, n in ((qx, q_stride, shared == "query", n_q), (sx, s_stride, shared == "slab", cap)):
        assert x.shape == ((n, ld) if is_shared else (n_sets, n, ld)) and x.is_contiguous()
        assert stride == (0 if is_shared else n * ld)
        assert torch.all(x[..., d:] == 0)
    want = B._scan_plain(q, q2, slab, b2, n_sets, False)
    got = B._scan_plain(qx, q2, sx, b2, n_sets, False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if d % 4 == 0:  # already rows of ld floats: nothing is copied
        assert B._staged_operand(slab, ld)[0].data_ptr() == slab.data_ptr()


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("form", ["shared query", "per-set query", "shared slab"])
def test_directed_row_mins_are_bitwise_the_bidirectional_ones(form, gated):
    """``directed=True`` (stage 1's scan) returns the bidirectional call's
    row mins bit for bit and leaves every column min +inf, gated or not."""
    rng = np.random.RandomState(12)
    n_sets, n_q, cap, d = 6, 11, 24, 9
    q = rng.randn(n_sets, n_q, d).astype(np.float32) if form == "per-set query" else rng.randn(n_q, d).astype(np.float32)
    if form == "shared slab":
        q = rng.randn(n_sets, n_q, d).astype(np.float32)
        slab, valid = rng.randn(cap, d).astype(np.float32), None
    else:
        _, slab, valid = _case(12, n_sets, 1, cap, d)
    kw = dict(valid_slab=_t(valid))
    if gated:
        kw.update(lb=_t(np.array([0, 2, np.nan, 0, 1, 0], np.float32)), cut=_t(np.ones(n_sets, np.float32)))
    ha, hb = B.batched_min_sqdists(_t(q), _t(slab), **kw)
    da, db = B.batched_min_sqdists(_t(q), _t(slab), directed=True, **kw)
    assert torch.equal(da, ha) and torch.isinf(db).all() and db.shape == hb.shape
    h = B.batched_bucket_hd(_t(q), _t(slab), directed=True, **kw)
    assert torch.equal(h, B._finalize_lanes(ha, None))


@pytest.mark.parametrize("bad", ["pairs", "ld", "smem", "grid", "set_step not coprime", "set_step 0",
                                 "resident per-set query"])
def test_launcher_refuses_bad_plans(bad):
    """The launcher checks a given plan against the pass before it looks
    for a card: a plan for another pass, or a resident tile for a per-set
    query, raises; a plan that fits gets as far as the CUDA check."""
    n_sets, n_q, cap, d = 6, 7, 200, 5
    shared = bad != "resident per-set query"
    q, q2 = torch.zeros(n_sets, n_q, d), torch.zeros(n_sets, n_q)
    if shared:
        q, q2 = q[:1].expand(n_sets, n_q, d), q2[:1].expand(n_sets, n_q)
    args = (q, q2, torch.zeros(n_sets, cap, d), torch.zeros(n_sets, cap),
            torch.zeros(n_sets, n_q), torch.zeros(n_sets, cap))
    good = B.bucket_launch_plan(1, n_sets, n_q, cap, d, 132, shared_query=shared)
    with pytest.raises(ValueError, match="CUDA"):
        B.batched_minscan(*args, plan=good)
    plan = {
        "pairs": good._replace(n_pairs=good.n_pairs + 1),
        "ld": good._replace(ld=good.ld + 4),
        "smem": good._replace(smem=good.smem - 16),
        "grid": good._replace(grid=0),
        "set_step not coprime": good._replace(set_step=2),
        "set_step 0": good._replace(set_step=0),
        "resident per-set query": good._replace(resident=True, smem=K.smem_bytes(d, True)),
    }[bad]
    with pytest.raises(ValueError, match="does not fit"):
        B.batched_minscan(*args, plan=plan)
