"""Quickstart on the PyTorch/CUDA port: one front door, three estimators,
the same synthetic cloud pair (the port of ``examples/quickstart.py``).

Everything goes through ``repro_torch.hd.set_distance``: on the card the
exact scan, ProHD's sweeps and the random-sampling baseline's subset scan
all run the hand-written fused min-d² kernel.

    PYTHONPATH=src python examples/torch_quickstart.py               # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain versions
"""
import argparse

import torch

from repro_torch.data.pointclouds import higgs_like, make_generator
from repro_torch.hd import HDConfig, set_distance


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args()
    dev = torch.device(args.device)

    a, b = higgs_like(make_generator(0, dev), 50_000, 50_000)
    print(f"clouds: A={tuple(a.shape)}  B={tuple(b.shape)}  on {dev}")

    # Exact Hausdorff; backend="auto" picks the kernel on the card, the
    # plain fused scan on the CPU.
    res = set_distance(a, b, measure=True)
    h_exact = float(res.value)
    t_exact = res.meta.elapsed_s
    print(f"exact    H = {h_exact:.5f}   ({t_exact:.2f}s, backend={res.meta.backend})")

    # ProHD: the same call with method="prohd" returns the estimate WITH its
    # certified interval.
    est = set_distance(a, b, method="prohd", config=HDConfig(alpha=0.01), measure=True)
    t_prohd = est.meta.elapsed_s
    n_sel = int(est.stats["n_sel_a"]) + int(est.stats["n_sel_b"])
    print(
        f"ProHD    Ĥ = {float(est.value):.5f}   err={abs(float(est.value) - h_exact) / h_exact * 100:.3f}%  "
        f"({t_prohd:.2f}s, {t_exact / t_prohd:.0f}x faster, |A_sel|+|B_sel|={n_sel})"
    )
    print(
        f"certified interval: [{float(est.lower):.5f}, {float(est.upper):.5f}] "
        f"(contains H: {float(est.lower) <= h_exact <= float(est.upper)})"
    )

    # Random-sampling baseline: method="sampling", randomness from a
    # generator on the clouds' device.
    samp = set_distance(a, b, method="sampling", generator=make_generator(1, dev),
                        config=HDConfig(alpha=0.01))
    print(
        f"random   Ĥ = {float(samp.value):.5f}   "
        f"err={abs(float(samp.value) - h_exact) / h_exact * 100:.3f}%  "
        f"(subset={int(samp.stats['n_sampled'])}, backend={samp.meta.backend})"
    )


if __name__ == "__main__":
    main()
