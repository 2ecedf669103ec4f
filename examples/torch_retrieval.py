"""HD-k-NN retrieval over a 10k-set corpus on the PyTorch/CUDA port — the
paper's vector-DB story (the port of ``examples/retrieval.py``).

Builds a :class:`repro_torch.index.SetStore` of ragged point sets
(separated Gaussian clusters, sizes 64/128/256, D 16), then serves a
top-10 Hausdorff-nearest-sets query two ways through the same front door:

- ``repro_torch.hd.search(...)``                  — the certified bound cascade
- ``repro_torch.hd.search(..., method="exact")``  — brute force over the corpus

and asserts that the cascade returned the IDENTICAL top-k, ids and values
bit for bit (it provably does: a candidate is pruned only when its
certified lower bound exceeds the k-th smallest certified upper bound).
On the card the cascade's stages 1 and 2a run the batched bucket scan
(kernel 2) and stage 2b and the brute force the fused min-d² scan
(kernel 1); on the CPU their plain versions.

    PYTHONPATH=src python examples/torch_retrieval.py                          # on the card
    PYTHONPATH=src python examples/torch_retrieval.py --device cpu --sets 1000  # plain versions
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.data.pointclouds import clustered_sets
from repro_torch.hd import search
from repro_torch.index import SetStore

D, K = 16, 10


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--sets", type=int, default=10_000, help="corpus size (default: 10,000)")
    args = ap.parse_args()
    dev = torch.device(args.device)

    sets, labels = clustered_sets(0, args.sets, D, sizes=(64, 128, 256))
    t0 = time.perf_counter()
    store = SetStore(dim=D, device=dev)
    store.add_many(sets)
    store.summaries()  # materialize the packed corpus up front
    store.packed_buckets()
    print(f"corpus: {store.n_sets} sets / {store.total_points} points packed into buckets "
          f"{list(store.bucket_capacities)} on {dev} in {time.perf_counter() - t0:.2f}s")

    # a fresh query blob near one cluster
    rng = np.random.RandomState(1)
    query = sets[42].mean(axis=0) + rng.randn(128, D).astype(np.float32) * 0.5
    query = torch.from_numpy(query).to(dev)

    search(query, store, K)  # warm-up: first launches, kernel builds on the card
    res = search(query, store, K, measure=True)
    print(f"\ncascade top-{K} in {res.meta.elapsed_s * 1e3:.0f}ms:")
    for sid, v in zip(res.ids, res.values):
        print(f"  set {sid:5d}  (cluster {labels[sid]:2d})  H = {v:.4f}")
    s = res.stats
    print(f"stats: {s['candidates_scanned']} candidates -> {s['stage0_pruned']} pruned by summary bounds, "
          f"{s['stage1_pruned']} by masked ProHD, {s['exact_refines']} exact refines "
          f"(prune_fraction={s['prune_fraction']:.4f})")

    ref = search(query, store, K, method="exact", measure=True)
    same = np.array_equal(res.ids, ref.ids) and np.array_equal(res.values, ref.values)
    print(f"\nbrute force: {ref.meta.elapsed_s:.1f}s ({ref.meta.elapsed_s / res.meta.elapsed_s:.1f}x the "
          f"cascade's time), identical top-{K}: {same}")
    assert same, (res.ids, ref.ids, res.values, ref.values)


if __name__ == "__main__":
    main()
