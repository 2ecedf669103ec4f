"""Serving example on the PyTorch/CUDA port: batched ProHD set-distance
requests through ``ProHDService`` (the port of ``examples/serve_prohd.py``;
the paper's kind is a metric service).

Six requests of mixed sizes are queued and flushed at once; the service
buckets them by shape and answers each with ProHD's estimate and its
certified interval (on the card through the batched bucket scan, kernel 2,
lane by lane).  Each interval is then checked against the exact
``set_distance`` of the same pair, and the script fails if one is not sound.

    PYTHONPATH=src python examples/torch_serve_prohd.py               # on the card
    PYTHONPATH=src python examples/torch_serve_prohd.py --device cpu  # plain versions
"""
import argparse
import time

import torch

from repro_torch.data.pointclouds import make_generator, random_clouds
from repro_torch.hd import set_distance
from repro_torch.serve.server import ProHDService, ServeConfig

SIZES = (700, 900, 1500, 3000, 800, 2500)
D = 12


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args()
    dev = torch.device(args.device)

    svc = ProHDService(ServeConfig(alpha=0.05), device=dev)
    # heterogeneous request mix (different sizes bucket separately)
    requests = []
    for i, n in enumerate(SIZES):
        a, b = random_clouds(make_generator(i, dev), n, n - 100, D)
        requests.append((svc.submit(a, b), a, b))

    t0 = time.perf_counter()
    results = svc.flush()
    dt = time.perf_counter() - t0
    print(f"served {len(results)} requests in {dt:.2f}s on {dev}\n")

    sound = []
    for rid, a, b in requests:
        r = results[rid]
        h = float(set_distance(a, b, backend="tiled").value)
        ok = r["lower"] <= h * 1.0001 and h <= r["upper"] * 1.0001
        sound.append(ok)
        print(f"req {rid}: n=({a.shape[0]},{b.shape[0]}) hd≈{r['hd']:.4f} "
              f"certified=[{r['lower']:.4f},{r['upper']:.4f}] exact={h:.4f} sound={ok}")
    assert all(sound), sound


if __name__ == "__main__":
    main()
