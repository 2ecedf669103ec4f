"""Streaming drift monitoring with ProHD on the PyTorch/CUDA port (the
port of ``examples/drift_monitor.py``, the paper's vector-DB use case).

A reference embedding set is fixed; a stream of vectors arrives in
batches.  After a distribution shift is injected, the certified lower
bound crosses the alert threshold.  ``check_drift`` dispatches through the
``repro_torch.hd`` front door (on the card: ProHD's sweeps on the fused
min-d² kernel); the last line cross-checks its interval against an exact
front-door call.

    PYTHONPATH=src python examples/torch_drift_monitor.py               # on the card
    PYTHONPATH=src python examples/torch_drift_monitor.py --device cpu  # plain versions
"""
import argparse

import torch

from repro_torch.core.prohd import ProHDConfig
from repro_torch.core.streaming import DriftMonitorConfig, check_drift, init_drift_monitor, observe
from repro_torch.data.pointclouds import make_generator
from repro_torch.hd import set_distance


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args()
    dev = torch.device(args.device)

    gen = make_generator(0, dev)
    dim = 32
    reference = torch.randn((2048, dim), generator=gen, device=dev)
    # subset_backend="cuda": the kernel on the card, its plain version on CPU tensors
    cfg = DriftMonitorConfig(window=1024, dim=dim, threshold=6.0,
                             prohd=ProHDConfig(alpha=0.05, subset_backend="cuda"))
    state = init_drift_monitor(cfg, reference, make_generator(1, dev))

    for step in range(20):
        batch = torch.randn((256, dim), generator=gen, device=dev)
        if step >= 12:  # inject drift
            batch = batch * 1.5 + 4.0
        state = observe(state, batch)
        if step % 4 == 3:
            rep = check_drift(state, cfg)
            flag = "  << ALERT" if bool(rep.alert) else ""
            print(
                f"step {step:3d}: hd={float(rep.hd):7.3f}  "
                f"certified=[{float(rep.lower):7.3f}, {float(rep.upper):7.3f}]{flag}"
            )

    # sanity: the certified interval really brackets the exact distance
    exact = set_distance(state.reference, state.buffer, measure=True)
    rep = check_drift(state, cfg)
    print(
        f"\nexact H = {float(exact.value):.3f} ({exact.meta.backend}, "
        f"{exact.meta.elapsed_s * 1e3:.0f}ms)  in certified interval: "
        f"{float(rep.lower) <= float(exact.value) <= float(rep.upper)}"
    )


if __name__ == "__main__":
    main()
