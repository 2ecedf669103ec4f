"""The port's multi-device ProHD and exact HD held to ``repro.core.distributed``.

The port is SPMD over ``torch.distributed``: each rank holds its own rows.
Here the ranks are gloo processes on the CPU (kernel 1's plain version
carries every scan), P ∈ {2, 4} spawned as subprocesses that rendezvous
through a ``FileStore`` in the test's temporary directory, and P = 1 in
the pytest process.  The ranks import only ``repro_torch``; the reference's
numbers are computed here and the ranks' results come back as JSON.

Cases (numpy inputs from a seed, α 0.02 as in the reference's test):
Higgs-like 4,096 × 28, Random Clouds 2,048 × 8, and 4,000 × 8 Random
Clouds padded to 4,096 with NaN rows masked invalid.  Meshes: 1-D over
every rank; at P = 4 also 2 × 2 with ``batch_axes=("data", "model")``
(one flattened group of 4) and with ``batch_axes=("data",)`` (two groups
of 2, the "model" ranks replicas).

Tolerances: exact within ``fp_value_margin`` of the float64 H and within
rtol 1e-5 of the reference's ``hausdorff_dense``; ProHD within rtol 1e-4
of the reference's single-device ``prohd`` (unpadded cases) and of its
``distributed_prohd`` on a one-device mesh (the ragged case zero-padded
there: the reference's masked centroid multiplies by the mask, so a NaN
pad row would poison it), with equal selection counts.
"""
import datetime
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import distributed as jdist  # noqa: E402
from repro.core.exact import hausdorff_dense as jhausdorff_dense  # noqa: E402
from repro_torch.core.fp_margin import fp_value_margin  # noqa: E402

jprohd_mod = importlib.import_module("repro.core.prohd")

pytestmark = pytest.mark.distributed

REPO = Path(__file__).resolve().parent.parent
ALPHA = 0.02
CASES = ("higgs", "random", "ragged")
DIMS = {"higgs": 28, "random": 8, "ragged": 8}
MESHES = {1: ("1d",), 2: ("1d",), 4: ("1d", "2x2", "2x2-data")}
RUNS = [(p, mesh) for p, meshes in MESHES.items() for mesh in meshes]
SPAWN_TIMEOUT_S = 300

# The ranks' program.  ``run`` is also called in the pytest process for P = 1.
WORKER = r'''
import datetime, json, sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core.distributed import ShardedCloud, distributed_exact_hd, distributed_prohd
from repro_torch.core.prohd import ProHDConfig
from repro_torch.hd import HDConfig, set_distance


def rows(x, r, p):
    n = x.shape[0] // p
    return torch.from_numpy(np.ascontiguousarray(x[r * n:(r + 1) * n]))


def run(inputs, cases, alpha):
    rank, world = dist.get_rank(), dist.get_world_size()
    meshes = {"1d": (init_device_mesh("cpu", (world,), mesh_dim_names=("data",)), ("data",), rank, world)}
    if world == 4:
        m2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        meshes["2x2"] = (m2, ("data", "model"), rank, 4)
        meshes["2x2-data"] = (m2, ("data",), rank // 2, 2)  # rank = 2·data + model
    out = {}
    for name, (mesh, axes, r, p) in meshes.items():
        for case in cases:
            a, b = inputs[case + "_a"], inputs[case + "_b"]
            va, vb = inputs[case + "_va"], inputs[case + "_vb"]
            A = ShardedCloud(rows(a, r, p), rows(va, r, p))
            B = ShardedCloud(rows(b, r, p), rows(vb, r, p))
            key = f"{name}/{case}"
            out[key + "/exact"] = float(distributed_exact_hd(mesh, A, B, batch_axes=axes))
            hd, nsa, nsb = distributed_prohd(mesh, A, B, ProHDConfig(alpha=alpha), batch_axes=axes)
            out[key + "/prohd"] = [float(hd), int(nsa), int(nsb)]
            hd, _, _ = distributed_prohd(mesh, A, B, ProHDConfig(alpha=alpha, inner="subset"), batch_axes=axes)
            out[key + "/prohd_subset"] = float(hd)
            masks = (A.valid, B.valid)
            fd = set_distance(A.points, B.points, masks=masks, backend="distributed", mesh=mesh,
                              batch_axes=axes, measure=True)
            out[key + "/fd_exact"] = [float(fd.value), float(fd.lower), float(fd.upper), fd.meta.backend]
            fd = set_distance(A.points, B.points, masks=masks, method="prohd", backend="distributed",
                              mesh=mesh, batch_axes=axes, config=HDConfig(alpha=alpha))
            out[key + "/fd_prohd"] = [float(fd.value), int(fd.stats["n_sel_a"]), int(fd.stats["n_sel_b"]),
                                      fd.lower is None and fd.upper is None]
            fd = set_distance(A.points, B.points, masks=masks, mesh=mesh, batch_axes=axes)
            out[key + "/auto"] = [fd.meta.backend, float(fd.value)]
    return out


if __name__ == "__main__":
    torch.set_num_threads(1)
    rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    store = dist.FileStore(f"{root}/store-{world}", world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        with np.load(f"{root}/inputs.npz") as f:
            inputs = dict(f)
        out = run(inputs, json.loads(sys.argv[4]), float(sys.argv[5]))
        with open(f"{root}/rank-{world}-{rank}.json", "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()
'''


def _higgs_like(seed, n, d=28):
    rng = np.random.default_rng(seed)
    mixing = rng.standard_normal((d, d)) / np.sqrt(d)
    a = rng.standard_normal((n, d)) @ mixing
    shift = np.concatenate([np.full((d // 4,), 0.8), np.zeros((d - d // 4,))])
    b = rng.standard_normal((n, d)) @ mixing * 1.15 + shift
    return a.astype(np.float32), b.astype(np.float32)


def _random_clouds(seed, n, d):
    rng = np.random.default_rng(seed)
    a = rng.random((n, d), dtype=np.float32)
    b = rng.random((n, d), dtype=np.float32) + np.float32(0.1)
    return a, b


def _h64(a, b):
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    d2 = np.maximum((a64 * a64).sum(1)[:, None] - 2 * a64 @ b64.T + (b64 * b64).sum(1)[None], 0.0)
    return float(np.sqrt(max(d2.min(1).max(), d2.min(0).max())))


def _scale(a, b):
    return float(max(np.linalg.norm(a, axis=1).max(), np.linalg.norm(b, axis=1).max()))


@pytest.fixture(scope="module")
def data():
    """{case: (a, b, valid_a, valid_b, a_real, b_real)}: the inputs the
    ranks shard, and the real rows."""
    out = {}
    for case, (a, b) in {"higgs": _higgs_like(0, 4096), "random": _random_clouds(1, 2048, 8)}.items():
        ones = np.ones((a.shape[0],), bool)
        out[case] = (a, b, ones, ones, a, b)
    a, b = _random_clouds(2, 4000, 8)
    pad = np.full((96, 8), np.nan, np.float32)
    valid = np.arange(4096) < 4000
    out["ragged"] = (np.concatenate([a, pad]), np.concatenate([b, pad]), valid, valid, a, b)
    return out


def _jit_dist_prohd(mesh, inner):
    # jitted: the reference's shard_map runs op by op otherwise (~15 s a call here)
    cfg = jprohd_mod.ProHDConfig(alpha=ALPHA, inner=inner)
    return jax.jit(lambda A, B: jdist.distributed_prohd(mesh, A, B, cfg))


@pytest.fixture(scope="module")
def ref(data):
    """The reference's numbers on the same inputs (the pytest process, one device)."""
    mesh = jax.make_mesh((1,), ("data",))
    out = {}
    for case, (a, b, va, vb, ar, br) in data.items():
        r = {"h64": _h64(ar, br), "scale": _scale(ar, br),
             "dense": float(jhausdorff_dense(jnp.asarray(ar), jnp.asarray(br)))}
        if case != "ragged":
            est = jprohd_mod.prohd(jnp.asarray(a), jnp.asarray(b), jprohd_mod.ProHDConfig(alpha=ALPHA))
            r["prohd"] = [float(est.hd), int(est.n_sel_a), int(est.n_sel_b)]
        # zero pads for the reference (NaN * False is NaN in its centroid)
        az, bz = np.where(va[:, None], a, 0.0), np.where(vb[:, None], b, 0.0)
        A = jdist.ShardedCloud(jnp.asarray(az), jnp.asarray(va))
        B = jdist.ShardedCloud(jnp.asarray(bz), jnp.asarray(vb))
        hd, nsa, nsb = _jit_dist_prohd(mesh, "full")(A, B)
        r["dist_prohd"] = [float(hd), int(nsa), int(nsb)]
        hd, _, _ = _jit_dist_prohd(mesh, "subset")(A, B)
        r["dist_prohd_subset"] = float(hd)
        r["dist_exact"] = float(jdist.distributed_exact_hd(mesh, A, B))
        out[case] = r
    return out


def _worker_module():
    ns = {"__name__": "torch_distributed_worker"}
    exec(compile(WORKER, "torch_distributed_worker", "exec"), ns)
    return ns


def _inputs(data):
    return {f"{case}_{k}": v for case, arrs in data.items() for k, v in zip(("a", "b", "va", "vb"), arrs)}


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """{P: [rank 0's results, rank 1's, …]}: P = 2 and 4 spawned (all six
    processes at once), P = 1 in the pytest process."""
    root = tmp_path_factory.mktemp("torch_dist")
    np.savez(root / "inputs.npz", **_inputs(data))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = {
        (p, r): subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(p), str(root), json.dumps(CASES), str(ALPHA)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for p in (2, 4) for r in range(p)
    }
    try:
        # P = 1 in the pytest process while the spawned ranks run.
        store = dist.FileStore(str(root / "store-1"), 1)
        dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=120))
        try:
            out = {1: [_worker_module()["run"](_inputs(data), CASES, ALPHA)]}
        finally:
            dist.destroy_process_group()
        for (p, r), proc in procs.items():
            stdout, stderr = proc.communicate(timeout=SPAWN_TIMEOUT_S)
            assert proc.returncode == 0, f"P={p} rank {r}:\n{stdout}\n{stderr}"
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for p in (2, 4):
        out[p] = [json.loads((root / f"rank-{p}-{r}.json").read_text()) for r in range(p)]
    return out


def _ids(runs_list):
    return [f"P{p}-{mesh}-{case}" for p, mesh in runs_list for case in CASES]


GRID = [(p, mesh, case) for p, mesh in RUNS for case in CASES]


@pytest.mark.parametrize("p,mesh,case", GRID, ids=_ids(RUNS))
def test_exact_ring_within_margin_of_float64_and_reference(runs, ref, p, mesh, case):
    r = ref[case]
    v = runs[p][0][f"{mesh}/{case}/exact"]
    assert abs(v - r["h64"]) <= fp_value_margin(DIMS[case], r["scale"], r["h64"])
    np.testing.assert_allclose(v, r["dense"], rtol=1e-5)
    np.testing.assert_allclose(v, r["dist_exact"], rtol=1e-5)


@pytest.mark.parametrize("p,mesh,case", GRID, ids=_ids(RUNS))
def test_prohd_matches_reference(runs, ref, p, mesh, case):
    r = ref[case]
    hd, nsa, nsb = runs[p][0][f"{mesh}/{case}/prohd"]
    # against the reference's distributed_prohd on a one-device mesh
    np.testing.assert_allclose(hd, r["dist_prohd"][0], rtol=1e-4)
    assert (nsa, nsb) == tuple(r["dist_prohd"][1:])
    if "prohd" in r:  # and its single-device prohd (unpadded inputs)
        np.testing.assert_allclose(hd, r["prohd"][0], rtol=1e-4)
        assert (nsa, nsb) == tuple(r["prohd"][1:])
    # ProHD (inner="full") never overestimates H
    assert hd <= r["h64"] + fp_value_margin(DIMS[case], r["scale"], r["h64"])


@pytest.mark.parametrize("p,mesh,case", GRID, ids=_ids(RUNS))
def test_prohd_subset_inner_matches_reference(runs, ref, p, mesh, case):
    np.testing.assert_allclose(runs[p][0][f"{mesh}/{case}/prohd_subset"], ref[case]["dist_prohd_subset"],
                               rtol=1e-4)


@pytest.mark.parametrize("p,mesh,case", GRID, ids=_ids(RUNS))
def test_front_door_equals_the_direct_call(runs, p, mesh, case):
    res = runs[p][0]
    key = f"{mesh}/{case}"
    value, lower, upper, backend = res[key + "/fd_exact"]
    assert backend == "distributed"
    assert value == lower == upper == res[key + "/exact"]
    hd, nsa, nsb, no_certificate = res[key + "/fd_prohd"]
    assert [hd, nsa, nsb] == res[key + "/prohd"]
    assert no_certificate  # the distributed path computes no certificate


@pytest.mark.parametrize("p,mesh", RUNS, ids=[f"P{p}-{m}" for p, m in RUNS])
def test_auto_picks_distributed_only_for_a_group_of_several_ranks(runs, ref, p, mesh):
    group = {"1d": p, "2x2": 4, "2x2-data": 2}[mesh]
    for case in CASES:
        backend, value = runs[p][0][f"{mesh}/{case}/auto"]
        if group > 1:
            assert backend == "distributed"
            assert value == runs[p][0][f"{mesh}/{case}/exact"]
        else:
            assert backend == "tiled"  # the single-device CPU rule on this rank's rows
            np.testing.assert_allclose(value, ref[case]["dense"], rtol=1e-5)


@pytest.mark.parametrize("p", [2, 4])
def test_every_rank_gets_the_same_result(runs, p):
    first = runs[p][0]
    for other in runs[p][1:]:
        assert other == first


def test_refusals_without_mesh_and_without_the_batch_axes(tmp_path):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.hd import set_distance

    a, b = (torch.from_numpy(x) for x in _random_clouds(3, 64, 4))
    for method in ("exact", "prohd"):
        with pytest.raises(ValueError, match="requires mesh="):
            set_distance(a, b, method=method, backend="distributed")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        for method in ("exact", "prohd"):
            with pytest.raises(ValueError, match="not dims of the mesh"):
                set_distance(a, b, method=method, backend="distributed", mesh=mesh, batch_axes=("model",))
        with pytest.raises(ValueError, match="not dims of the mesh"):
            set_distance(a, b, mesh=mesh, batch_axes=("data", "model"))  # under auto too
    finally:
        dist.destroy_process_group()
