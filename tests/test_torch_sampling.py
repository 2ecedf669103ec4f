"""The port's sampling baselines held to ``repro.core.sampling``.

``jax.random`` cannot be replayed in torch, so the reference's own indices
are re-derived here (``jax.random.split`` then ``choice`` or
``permutation``, as the reference draws them) and fed to the port's scan;
the value must match the reference's ``random_sampling_hd`` /
``systematic_sampling_hd`` within ``fp_value_margin``.  The port's own
draws are checked for their count, no replacement, the systematic stride
and uniform inclusion.  The front door's sampling cell is held to the
reference's where the sample is the whole cloud, and ProHD must beat
random sampling on structured data, as in ``tests/test_core.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.hd as jhd  # noqa: E402
from repro.core import sampling as jsampling  # noqa: E402
from repro.data.pointclouds import higgs_like  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import exact, sampling  # noqa: E402
from repro_torch.core.fp_margin import fp_value_margin  # noqa: E402
from repro_torch.core.prohd import ProHDConfig, prohd  # noqa: E402
from repro_torch.device import check_generator  # noqa: E402
from repro_torch.hd import HDConfig, set_distance  # noqa: E402
from repro_torch.kernels.hausdorff import ops as hd_ops  # noqa: E402

SCANS = {
    "tiled": lambda x, y: exact.hausdorff_fused_tiled(x, y, block_a=2048, block_b=2048),
    "fused_cuda": hd_ops.hausdorff,  # on CPU tensors: its plain version
}


def _clouds(seed, n_a, n_b, d):
    rng = np.random.default_rng(seed)
    a = rng.random((n_a, d), dtype=np.float32)
    b = rng.random((n_b, d), dtype=np.float32) + np.float32(0.1)
    return a, b


def _scale(a, b):
    return float(max(np.linalg.norm(a, axis=1).max(), np.linalg.norm(b, axis=1).max()))


def _hd64(a, b):
    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d2 = np.maximum((a64 * a64).sum(1)[:, None] - 2 * a64 @ b64.T + (b64 * b64).sum(1)[None], 0.0)
    return float(np.sqrt(max(d2.min(1).max(), d2.min(0).max())))


def _reference_indices(key, n_a, n_b, alpha, sampler):
    """The rows the reference's baseline keeps, drawn as it draws them."""
    k = jsampling.sample_count(n_a, n_b, alpha)
    ka, kb = jax.random.split(key)
    if sampler == "random":
        ia = jax.random.choice(ka, n_a, shape=(min(k, n_a),), replace=False)
        ib = jax.random.choice(kb, n_b, shape=(min(k, n_b),), replace=False)
    else:
        ia = jax.random.permutation(ka, n_a)[:: max(1, int(n_a / min(k, n_a)))]
        ib = jax.random.permutation(kb, n_b)[:: max(1, int(n_b / min(k, n_b)))]
    return torch.from_numpy(np.asarray(ia).astype(np.int64)), torch.from_numpy(np.asarray(ib).astype(np.int64))


@pytest.mark.parametrize("sampler", ["random", "systematic"])
@pytest.mark.parametrize("backend", ["tiled", "fused_cuda"])
@pytest.mark.parametrize("seed,n_a,n_b,d,alpha", [
    (0, 3000, 2500, 8, 0.02),
    (1, 1200, 4000, 32, 0.05),
    (2, 700, 90, 5, 0.3),     # k exceeds the smaller side: it is taken whole
])
def test_port_scan_on_reference_indices_matches_reference(sampler, backend, seed, n_a, n_b, d, alpha):
    a, b = _clouds(seed, n_a, n_b, d)
    key = jax.random.PRNGKey(seed + 10)
    ref_fn = jsampling.random_sampling_hd if sampler == "random" else jsampling.systematic_sampling_hd
    ref_hd, ref_n = ref_fn(key, jnp.asarray(a), jnp.asarray(b), alpha)
    ia, ib = _reference_indices(key, n_a, n_b, alpha, sampler)
    hd, n = sampling.sampled_hd(interop.cloud(a, "cpu"), interop.cloud(b, "cpu"), ia, ib, SCANS[backend])
    assert n == ref_n
    r = float(ref_hd)
    assert abs(float(hd) - r) <= fp_value_margin(d, _scale(a, b), r), (float(hd), r)
    # and the float64 HD of the same subsets
    h64 = _hd64(a[ia.numpy()], b[ib.numpy()])
    assert abs(float(hd) - h64) <= fp_value_margin(d, _scale(a, b), h64)


@pytest.mark.parametrize("n_a,n_b,alpha", [(1000, 800, 0.01), (50, 4000, 0.02), (300, 300, 0.7)])
def test_random_draw_count_and_no_replacement(n_a, n_b, alpha):
    g = torch.Generator().manual_seed(3)
    ia, ib = sampling.draw_indices(g, n_a, n_b, alpha, "random")
    k = sampling.sample_count(n_a, n_b, alpha)
    assert k == jsampling.sample_count(n_a, n_b, alpha)
    for idx, n in ((ia, n_a), (ib, n_b)):
        assert idx.numel() == min(k, n)
        assert idx.unique().numel() == idx.numel()
        assert int(idx.min()) >= 0 and int(idx.max()) < n


@pytest.mark.parametrize("n_a,n_b,alpha", [(1000, 800, 0.01), (50, 4000, 0.02), (301, 299, 0.1)])
def test_systematic_draw_is_a_strided_permutation(n_a, n_b, alpha):
    g = torch.Generator().manual_seed(4)
    replay = torch.Generator()
    replay.set_state(g.get_state())
    ia, ib = sampling.draw_indices(g, n_a, n_b, alpha, "systematic")
    k = sampling.sample_count(n_a, n_b, alpha)
    for idx, n in ((ia, n_a), (ib, n_b)):  # a's permutation is drawn first
        perm = torch.randperm(n, generator=replay)
        stride = max(1, int(n / min(k, n)))
        assert torch.equal(idx, perm[::stride])
        assert idx.numel() == -(-n // stride)
        assert idx.unique().numel() == idx.numel()


@pytest.mark.parametrize("sampler", ["random", "systematic"])
def test_inclusion_is_uniform_over_many_seeds(sampler):
    # n 40, k = ceil(0.125·80) = 10 (systematic: stride 4, 10 points): each
    # index is kept with probability 1/4.  Without replacement the counts
    # vary less than a multinomial's, so the chi-square bound is loose.
    n, trials = 40, 2000
    hits = torch.zeros(n)
    for s in range(trials):
        ia, _ = sampling.draw_indices(torch.Generator().manual_seed(s), n, n, 0.125, sampler)
        assert ia.numel() == 10
        hits[ia] += 1
    expected = trials * 10 / n
    chi2 = float(((hits - expected) ** 2 / expected).sum())
    assert chi2 < 72.05, chi2  # χ²(39) at p = 0.001


def test_masks_mark_the_drawn_rows():
    g = torch.Generator().manual_seed(0)
    m = sampling.random_sample_mask(g, 100, 7)
    assert m.dtype == torch.bool and int(m.sum()) == 7
    m = sampling.systematic_sample_mask(g, 100, 0.1)
    assert int(m.sum()) == 10


def test_generator_must_live_on_the_data_device():
    a, b = _clouds(0, 64, 64, 4)
    ta, tb = interop.cloud(a, "cpu"), interop.cloud(b, "cpu")
    with pytest.raises(ValueError, match="generator is on 'cpu'"):
        check_generator(torch.Generator(), torch.device("cuda"), "x")
    with pytest.raises(ValueError, match="torch.Generator"):
        sampling.random_sampling_hd(7, ta, tb, 0.1)
    hd, n = sampling.random_sampling_hd(torch.Generator(), ta, tb, 0.1)
    assert n == 26 and np.isfinite(float(hd))
    with pytest.raises(ValueError, match="unknown sampler"):
        sampling.draw_indices(torch.Generator(), 10, 10, 0.1, "stratified")


@pytest.mark.parametrize("sampler", ["random", "systematic"])
@pytest.mark.parametrize("backend", ["tiled", "fused_cuda"])
def test_front_door_sampling_cell_matches_reference_front_door(sampler, backend):
    # α = 0.6: k = ceil(0.6·(n_a + n_b)) exceeds both sides, so each side is
    # sampled whole whatever the draw, and both front doors give exact H.
    a, b = _clouds(5, 600, 520, 12)
    cfg = dict(alpha=0.6, sampler=sampler)
    ref = jhd.set_distance(jnp.asarray(a), jnp.asarray(b), method="sampling", backend="tiled",
                           key=jax.random.PRNGKey(0), config=jhd.HDConfig(**cfg))
    port_cfg = interop.hd_config_from_dict(dataclasses.asdict(jhd.HDConfig(**cfg)))
    res = set_distance(a, b, method="sampling", backend=backend, config=port_cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    r = float(ref.value)
    assert abs(float(res.value) - r) <= fp_value_margin(12, _scale(a, b), r)
    assert res.stats["n_sampled"] == int(ref.stats["n_sampled"]) == 1120
    assert res.lower is None and res.upper is None and res.meta.backend == backend


def test_front_door_sampling_checks():
    a, b = _clouds(6, 200, 200, 4)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="requires generator"):
        set_distance(a, b, method="sampling", device="cpu")
    with pytest.raises(ValueError, match="masks"):
        set_distance(a, b, method="sampling", device="cpu", generator=g,
                     masks=(np.ones(200, bool), None))
    with pytest.raises(ValueError, match="unknown sampler"):
        set_distance(a, b, method="sampling", device="cpu", generator=g,
                     config=HDConfig(sampler="stratified"))
    # The front door draws exactly what draw_indices draws from that state.
    g = torch.Generator().manual_seed(11)
    replay = torch.Generator()
    replay.set_state(g.get_state())
    res = set_distance(a, b, method="sampling", backend="tiled", device="cpu", generator=g,
                       config=HDConfig(alpha=0.05, sampler="systematic"))
    ia, ib = sampling.draw_indices(replay, 200, 200, 0.05, "systematic")
    want, n = sampling.sampled_hd(interop.cloud(a, "cpu"), interop.cloud(b, "cpu"), ia, ib, SCANS["tiled"])
    assert float(res.value) == float(want) and res.stats["n_sampled"] == n


def test_prohd_beats_sampling_on_structured_data():
    # The paper's headline claim at matched subset size (Higgs-like data),
    # ported from tests/test_core.py on the reference's own clouds.
    a, b = (np.array(x) for x in higgs_like(jax.random.PRNGKey(7), 20000, 20000))
    ta, tb = interop.cloud(a, "cpu"), interop.cloud(b, "cpu")
    h = float(exact.hausdorff_fused_tiled(ta, tb))
    est = prohd(ta, tb, ProHDConfig(alpha=0.01))
    errs_rand = []
    for s in range(3):
        hd_r, _ = sampling.random_sampling_hd(torch.Generator().manual_seed(s), ta, tb, 0.01)
        errs_rand.append(abs(float(hd_r) - h) / h)
    err_prohd = abs(float(est.hd) - h) / h
    assert err_prohd < min(errs_rand), (err_prohd, errs_rand)
