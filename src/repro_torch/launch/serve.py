"""Serving launcher: drive the batched ProHD set-distance service.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 --n 2000 --d 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Submits ``--requests`` pairs of the paper's Random Clouds (uniform
[0, 1]^D, B offset by 0.1), made on the device from a generator seeded by
``--seed``, flushes them, then repeats with a second draw for the
steady-state time.  Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args()

    import torch

    from repro_torch.data.pointclouds import make_generator, random_clouds
    from repro_torch.device import resolve_device
    from repro_torch.serve.server import ProHDService, ServeConfig

    dev = resolve_device(None, args.device)
    gen = make_generator(args.seed, dev)
    svc = ProHDService(ServeConfig(alpha=args.alpha), device=dev)

    def submit_round(vary: bool) -> None:
        for i in range(args.requests):
            n = args.n - (i % 4) * (args.n // 10) if vary else args.n
            a, b = random_clouds(gen, n, n, args.d)
            svc.submit(a, b)

    def timed_flush() -> tuple[int, float]:
        t0 = time.perf_counter()
        results = svc.flush()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return len(results), time.perf_counter() - t0

    submit_round(vary=True)
    n_res, dt = timed_flush()
    lat = dt / max(n_res, 1)
    print(f"[serve] {n_res} requests in {dt:.2f}s ({lat*1e3:.0f} ms/req incl. first-launch builds) on {dev}")
    submit_round(vary=False)
    _, dt = timed_flush()
    print(f"[serve] steady-state: {dt/args.requests*1e3:.1f} ms/request on {dev}")


if __name__ == "__main__":
    main()
