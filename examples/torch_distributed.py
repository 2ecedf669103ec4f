"""Multi-device exact HD and ProHD on the PyTorch/CUDA port, SPMD over
``torch.distributed``.

Spawns ``--ranks`` processes that meet through a ``FileStore`` in a
temporary directory.  Every rank makes the same Random-Cloud pair from
``--seed`` on its device, keeps its own block of rows and calls
``set_distance(..., backend="distributed", mesh=mesh)``; the value comes
back replicated.  Rank 0 also computes the single-device values on the
whole clouds.  Prints one JSON line per rank and a summary line; exits 1
if any rank failed.

    PYTHONPATH=src python examples/torch_distributed.py --ranks 4 --backend gloo --device cpu --n 8192 --d 16
    PYTHONPATH=src python examples/torch_distributed.py --ranks 1 --backend nccl    # one rank per GPU

NCCL takes one rank per GPU; CUDA rank r uses device ``r mod device_count``.
"""
import argparse
import datetime
import json
import statistics
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist


def rank_main(args) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data.pointclouds import make_generator, random_clouds
    from repro_torch.hd import HDConfig, set_distance

    rank, world = args.rank, args.ranks
    dev = torch.device("cuda", rank % torch.cuda.device_count()) if args.device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dist.init_process_group(args.backend, store=dist.FileStore(f"{args.root}/store", world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=args.timeout))
    out = {"rank": rank, "device": str(dev), "backend": args.backend}
    try:
        mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("data",))
        a, b = random_clouds(make_generator(args.seed, dev), args.n, args.n, args.d)
        rows = slice(rank * args.n // world, (rank + 1) * args.n // world)
        cfg = HDConfig(alpha=args.alpha)
        for method in args.methods.split(","):
            try:
                runs = [set_distance(a[rows], b[rows], method=method, backend="distributed", mesh=mesh,
                                     config=cfg, measure=True) for _ in range(1 + args.reps)]
                out[method] = {"value": float(runs[-1].value), "warmup_s": runs[0].meta.elapsed_s,
                               "median_s": statistics.median(r.meta.elapsed_s for r in runs[1:])}
            except Exception as e:  # noqa: BLE001 — reported, and the run exits 1
                out[method] = {"error": f"{type(e).__name__}: {str(e)[:400]}"}
        if rank == 0:
            for method in args.methods.split(","):
                out[method]["single_device_value"] = float(set_distance(a, b, method=method, config=cfg).value)
    finally:
        dist.destroy_process_group()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", default="nccl", help="process-group backend: nccl | gloo")
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    ap.add_argument("--methods", default="exact,prohd", help="comma-separated: exact, prohd")
    ap.add_argument("--n", type=int, default=65_536, help="points per cloud (a multiple of --ranks)")
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3, help="timed calls after a warm-up")
    ap.add_argument("--timeout", type=int, default=120, help="seconds a collective may wait")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.n % args.ranks:
        ap.error("--n must be a multiple of --ranks (equal rows on every rank)")
    if args.rank is not None:
        print(json.dumps(rank_main(args)), flush=True)
        return 0

    with tempfile.TemporaryDirectory() as root:
        cmd = [sys.executable, __file__, *sys.argv[1:], "--root", root]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for r in range(args.ranks)]
        results = []
        try:
            for r, p in enumerate(procs):
                stdout, stderr = p.communicate(timeout=args.timeout * 4 + 600)
                lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
                res = json.loads(lines[-1]) if lines else {"rank": r, "error": stderr.strip()[-1500:]}
                res["returncode"] = p.returncode
                results.append(res)
                print(json.dumps(res), flush=True)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    failed = [r["rank"] for r in results if r["returncode"] or "error" in r
              or any("error" in v for v in r.values() if isinstance(v, dict))]
    print(json.dumps({"ranks": args.ranks, "backend": args.backend, "device": args.device, "n": args.n,
                      "d": args.d, "failed_ranks": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
