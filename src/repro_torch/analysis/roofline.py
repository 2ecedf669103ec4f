"""Three-term roofline of one traced step, per device.

Counterpart of ``repro/analysis/roofline.py``.  Terms (seconds):

    compute    = FLOPs_per_device       / DeviceSpec.peak_flops   (bf16)
    memory     = bytes_per_device       / DeviceSpec.hbm_bw
    collective = Σ wire bytes of each collective / its link's bandwidth

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
parses the collectives out of the partitioned HLO text.  The port traces
the step once on fake tensors (``launch.dryrun``) and counts what the
rank's program issues: FLOPs on its local shards, and every collective
through :func:`count_collectives`, a dispatch mode that records each one,
functional (DTensor's redistributions) or ``c10d`` (the collectives of the
SPMD bodies, ``sharding.collectives``), with its result bytes and group.
The per-op wire factors are the reference's:

    all-gather ×1        (each device receives ≈ the full result)
    all-reduce ×2        (ring: reduce-scatter + all-gather phases)
    reduce-scatter ×G    (sends ≈ the operand = result × group size)
    all-to-all ×1, collective-permute ×1

The card's rates come from the card (:meth:`DeviceSpec.from_card`): bf16
peak = SMs × 4,096 FLOP per clock × the maximum SM clock, HBM bandwidth =
2 × the memory clock × the bus width.  The links are public figures: a
group whose ranks share one node of 8 GPUs talks over NVLink 4 (450 GB/s a
direction per GPU, NVIDIA H100 datasheet), any other over the node's
network (NDR InfiniBand, 400 Gb/s = 50 GB/s per GPU).
"""
from __future__ import annotations

import contextlib
import dataclasses
import subprocess

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["DeviceSpec", "H100_SXM", "NVLINK_BW", "NET_BW", "GPUS_PER_NODE", "CollectiveStats",
           "count_collectives", "count_flops", "link_bandwidth", "local_ops_only", "Roofline"]

BF16_FLOP_PER_SM_CLK = 4096   # Hopper tensor cores, dense bf16 (H100 datasheet: 989 TF at 1,830 MHz, 132 SMs)
NVLINK_BW = 450e9             # bytes/s a direction per GPU, NVLink 4 (H100 SXM datasheet: 900 GB/s bidirectional)
NET_BW = 50e9                 # bytes/s per GPU over NDR InfiniBand (400 Gb/s, one adapter per GPU)
GPUS_PER_NODE = 8             # an HGX H100 node: one NVLink domain


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """The rates and memory of one device."""

    name: str
    peak_flops: float    # bf16 FLOP/s
    hbm_bw: float        # bytes/s
    hbm_bytes: float     # device memory, bytes
    link_bw: float = NET_BW  # the rate of a collective whose group spans nodes

    @classmethod
    def from_card(cls, index: int = 0) -> "DeviceSpec":
        """Read from the card: its SMs and memory from the CUDA runtime, its
        maximum SM and memory clocks from ``nvidia-smi``."""
        props = torch.cuda.get_device_properties(index)

        def smi(field: str) -> float:
            out = subprocess.run(["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits",
                                  f"--id={index}"], capture_output=True, text=True, check=True).stdout
            return float(out.split()[0])

        sm_hz = smi("clocks.max.sm") * 1e6
        mem_hz = smi("clocks.max.memory") * 1e6
        bus_bits = getattr(props, "memory_bus_width", 5120)
        return cls(name=props.name, peak_flops=props.multi_processor_count * BF16_FLOP_PER_SM_CLK * sm_hz,
                   hbm_bw=2.0 * mem_hz * bus_bits / 8, hbm_bytes=float(props.total_memory))


# The card the port targets, from its published figures (132 SMs at 1,980 MHz,
# HBM3 at 2,619 MHz on a 5,120-bit bus, 80 GiB): what a run with no card uses.
H100_SXM = DeviceSpec(name="NVIDIA H100 80GB HBM3", peak_flops=132 * BF16_FLOP_PER_SM_CLK * 1980e6,
                      hbm_bw=2.0 * 2619e6 * 5120 / 8, hbm_bytes=80.0 * (1 << 30))


def link_bandwidth(ranks) -> float:
    """NVLink when every rank of the group sits in one node, else the network."""
    nodes = {int(r) // GPUS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else NET_BW


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    wire_seconds: float = 0.0
    by_op: dict = dataclasses.field(default_factory=dict)

    def add(self, op: str, nbytes: float, bandwidth: float | None = None):
        self.wire_bytes += nbytes
        if bandwidth:
            self.wire_seconds += nbytes / bandwidth
        rec = self.by_op.setdefault(op, {"count": 0, "bytes": 0.0})
        rec["count"] += 1
        rec["bytes"] += nbytes


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _group_ranks(args) -> list[int]:
    """The global ranks of a collective's group: a ProcessGroup argument
    (``c10d``) or a group name (functional collectives)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            return dist.get_process_group_ranks(dist.ProcessGroup.unbox(a))
    name = next(a for a in reversed(args) if isinstance(a, str))
    return dist.get_process_group_ranks(_resolve_process_group(name))


# op name → the reference's collective
_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "broadcast_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}


class count_collectives(TorchDispatchMode):
    """Within the block, record every collective the program issues with
    the reference's wire factors (``stats``, a :class:`CollectiveStats`).
    An all-to-all that sends to one rank and receives from one is a
    collective-permute.  DTensor ops are let through to their local ops,
    so the count is one rank's."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in ("_c10d_functional", "c10d", "_c10d_functional_autograd"):
            op = _OPS.get(func._opname)
            if op is not None:
                self._record(op, func._opname, out, args)
        return out

    def _record(self, op: str, name: str, out, args):
        ranks = _group_ranks(args)
        if name == "all_to_all_single" and sum(map(bool, args[1])) <= 1 and sum(map(bool, args[2])) <= 1:
            op = "collective-permute"
        # functional collectives return their result; c10d ops return (tensors,
        # work) and write the results into their first argument
        result = out if name.startswith(("all_", "reduce_scatter_tensor")) else args[0]
        nbytes = _nbytes(result)
        factor = 2.0 if op == "all-reduce" else float(len(ranks)) if op == "reduce-scatter" else 1.0
        self.stats.add(op, nbytes * factor, link_bandwidth(ranks))


@contextlib.contextmanager
def local_ops_only():
    """Hide DTensor's sharding propagation from the dispatch modes in the
    block: to learn an op's output shape it runs the op on fake tensors of
    the GLOBAL shapes, through whatever modes are active, which a FLOP or
    memory counter would otherwise take for the rank's work.  Inside the
    block that run sees no mode (a fake tensor mode of its own); the local
    ops each rank runs are seen as before."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    name = next(n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
                if n in vars(ShardingPropagator))
    orig = vars(ShardingPropagator)[name]

    def hidden(self, *args, **kwargs):
        with _disable_current_modes():
            return orig(self, *args, **kwargs)

    setattr(ShardingPropagator, name, hidden)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


class count_flops(TorchDispatchMode):
    """Within the block, the FLOPs of every op with a formula in PyTorch's
    FLOP registry (``torch.utils.flop_counter``; kernel 4's own is
    registered with it), counted on the tensors the op runs on: DTensor ops
    are let through to their local ops, so a sharded step counts one
    rank's FLOPs (``FlopCounterMode`` on DTensors counts the global op's).
    ``total`` and ``by_op`` (op name → FLOPs)."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_op: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.total += n
            name = str(func._overloadpacket)
            self.by_op[name] = self.by_op.get(name, 0) + n
        return out


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    collectives_by_op: dict
    model_flops: float
    n_devices: int
    device: DeviceSpec = H100_SXM
    wire_seconds: float | None = None  # Σ bytes / link rate; None: every byte at device.link_bw

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.device.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.device.hbm_bw

    @property
    def t_collective(self) -> float:
        if self.wire_seconds is not None:
            return self.wire_seconds
        return self.wire_bytes_per_device / self.device.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory, "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline step time lower bound (perfect overlap of all three engines)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / total traced FLOPs: remat, dispatch and padding
        waste show up here as a fraction < 1."""
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else float("nan")

    @property
    def mfu_bound(self) -> float:
        """Upper bound on model-FLOPs utilisation at the roofline step time."""
        if self.t_bound <= 0:
            return float("nan")
        return (self.model_flops / self.n_devices / self.t_bound) / self.device.peak_flops

    def summary(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "model_flops": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu_bound": self.mfu_bound,
            "collectives": self.collectives_by_op,
        }
