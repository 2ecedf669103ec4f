"""The benchmark's generators against the statistics of their sources."""
import torch

from bench.harness import inputs as I
from repro_torch.data.pointclouds import make_generator, random_clouds

BIG_SEED = 2**31 + 12_345


def test_sub_seeds_are_stable_distinct_and_fit_a_generator():
    s = I.sub_seed(BIG_SEED, "pair", 3)
    assert s == I.sub_seed(BIG_SEED, "pair", 3)
    assert s != I.sub_seed(BIG_SEED, "pair", 4) and s != I.sub_seed(BIG_SEED + 1, "pair", 3)
    assert 0 <= s < 2**63
    I.generator(2**40, "cpu", "x").manual_seed(s)


def test_random_clouds_match_the_paper_spec_and_the_program_generator():
    a, b = torch.empty(20_000, 16), torch.empty(20_000, 16)
    I.fill_random_clouds(I.generator(BIG_SEED, "cpu", "pair", 0), a, b, 0.1)
    ra, rb = random_clouds(make_generator(5, "cpu"), 20_000, 20_000, 16)
    for mine, theirs in ((a, ra), (b, rb)):
        assert float(mine.min()) >= float(theirs.min()) - 0.01 and float(mine.max()) <= float(theirs.max()) + 0.01
        assert abs(float(mine.mean()) - float(theirs.mean())) < 0.01
        assert abs(float(mine.var()) - 1 / 12) < 0.005
    assert abs(float(b.mean() - a.mean()) - 0.1) < 0.01
    a2, b2 = torch.empty_like(a), torch.empty_like(b)
    I.fill_random_clouds(I.generator(BIG_SEED, "cpu", "pair", 0), a2, b2, 0.1)
    assert torch.equal(a, a2) and torch.equal(b, b2)


def test_sampled_steps_are_drawn_from_the_seed():
    recs = [{"step": i} for i in range(10)]
    one = I.sampled(recs, 3, BIG_SEED)
    assert one == I.sampled(recs, 3, BIG_SEED) and len(one) == 3
    assert [r["step"] for r in one] == sorted(r["step"] for r in one)
    assert I.sampled(recs, "all", 1) == recs == I.sampled(recs, 3, 1, all_steps=True) == I.sampled(recs, 12, 1)
