"""Closed loop of ``set_distance`` on fresh pairs, and its check.

Traffic keys: ``call`` (``method``:
``exact`` or ``prohd``; ProHD's ``alpha`` and ``inner``), ``warmup_steps``,
``trace_steps`` and ``check`` (``sample``: calls compared a run, drawn from
the seed; ``limits``).  Configuration keys: ``generator``
(``random_clouds``), ``d``, ``offset``, ``points_per_side``.

Step ``i`` draws its pair from the seed's stream ``("pair", i)`` into two
buffers the loop keeps, calls the program, and waits until the result is
on the host.  The check draws the sampled steps' pairs again and compares
the program's answers with the plain reference (``reference.pairwise``).
Its numbers, each the worst over the compared calls:

- ``value_rel_err``: |value - the reference's| / the reference's;
- ``bracket_miss`` (ProHD): how far the paper's guarantee lower <= H <=
  upper is missed, relative to H, against the reference's value (a lower
  end of H) and ``hausdorff_above`` (an upper end);
- ``n_sel_out`` (ProHD): rows a side selected beyond the capacity of the
  alpha-extremes or short of the centroid axis's own 2k;
- ``unanswered``: calls with no finite answer (added by the runner).
"""
from __future__ import annotations

import math

import torch

from bench.harness import flops as F
from bench.harness.inputs import fill_random_clouds, generator, sampled
from bench.reference import pairwise as ref

__all__ = ["Driver", "ProgramCall", "ReferenceCall"]

FIELDS = ("value", "lower", "upper", "n_sel_a", "n_sel_b")
# Rows of the other cloud that ``hausdorff_above`` measures each row to.
ABOVE_ROWS = 4096


class ProgramCall:
    """The system under test: ``repro_torch.hd.set_distance``."""

    def __init__(self, call: dict):
        from repro_torch.hd import HDConfig, set_distance

        self._set_distance = set_distance
        self.method = call["method"]
        self.kwargs = {}
        if self.method == "prohd":
            self.kwargs = {"method": "prohd", "config": HDConfig(alpha=float(call["alpha"]), inner=call["inner"])}
        elif self.method != "exact":
            raise ValueError(f"unknown method {self.method!r}")

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> dict:
        res = self._set_distance(a, b, **self.kwargs)
        if self.method == "exact":
            v = float(res.value)
            return {"value": v, "lower": v, "upper": v}
        got = torch.stack([res.value.float(), res.lower.float(), res.upper.float(),
                           res.stats["n_sel_a"].float(), res.stats["n_sel_b"].float()]).tolist()
        out = dict(zip(FIELDS, got))
        out["n_sel_a"], out["n_sel_b"] = int(out["n_sel_a"]), int(out["n_sel_b"])
        return out


class ReferenceCall:
    """The plain reference in the program's place, in ``precision``: the
    control is ``ReferenceCall(call, "tf32")``."""

    def __init__(self, call: dict, precision: str):
        self.call, self.precision = call, precision

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> dict:
        if self.call["method"] == "exact":
            v = ref.hausdorff(a, b, self.precision)
            return {"value": v, "lower": v, "upper": v}
        return ref.prohd(a, b, float(self.call["alpha"]), self.precision)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, *, program=None):
        self.config, self.traffic, self.seed, self.device = config, traffic, int(seed), torch.device(device)
        self.n_a = self.n_b = int(config["points_per_side"])
        self.d = int(config["d"])
        self.call = traffic["call"]
        self.a = torch.empty((self.n_a, self.d), dtype=torch.float32, device=self.device)
        self.b = torch.empty((self.n_b, self.d), dtype=torch.float32, device=self.device)
        self.program = (program or Driver.default_program)(self)

    def default_program(self) -> ProgramCall:
        return ProgramCall(self.call)

    def build(self) -> None:
        """Build or load the program's kernel library (its ``nvcc`` build
        on a checkout's first run), so that set-up can time it apart."""
        if self.device.type == "cuda":
            from repro_torch.kernels.hausdorff import hausdorff

            hausdorff.build()

    def control_program(self) -> ReferenceCall:
        return ReferenceCall(self.call, "tf32")

    def draw(self, step: int) -> tuple[torch.Tensor, torch.Tensor]:
        fill_random_clouds(generator(self.seed, self.device, "pair", step), self.a, self.b,
                           float(self.config["offset"]))
        return self.a, self.b

    def warmup(self) -> None:
        for s in range(int(self.traffic["warmup_steps"])):
            self.program(*self.draw(-1 - s))

    def step(self, i: int) -> dict:
        a, b = self.draw(i)
        with torch.profiler.record_function("bench.call"):
            out = self.program(a, b)
        return {"step": i, "requests": 1, "failed": 0, "out": out}

    def failed_step(self, i: int) -> dict:
        return {"step": i, "requests": 1, "failed": 1, "out": None}

    def free(self) -> None:
        """Drop the program and what it holds; the input buffers stay."""
        self.program = None

    def check(self, records: list[dict], *, all_steps: bool = False) -> tuple[dict, dict]:
        """({number: reading}, {step: the reference's answer}):
        ``unanswered`` counts the calls that gave no answer; each other
        number is the worst over the sampled calls."""
        limits = self.traffic["check"]["limits"]
        worst = {name: 0.0 for name in limits}
        worst["unanswered"] = float(sum(rec["out"] is None for rec in records))
        refs = {}
        for rec in sampled(records, self.traffic["check"]["sample"], self.seed, all_steps):
            a, b = self.draw(rec["step"])
            want = ReferenceCall(self.call, "float64")(a, b)
            if "bracket_miss" in limits:
                want["above"] = ref.hausdorff_above(a, b, ABOVE_ROWS)
            refs[rec["step"]] = want
            for name in limits:
                worst[name] = max(worst[name], self._number(name, rec["out"], want))
        return worst, refs

    def _number(self, name: str, got: dict | None, want: dict) -> float:
        """One compared number of one call; a missing or non-finite answer
        reads +inf."""
        if got is None or not all(math.isfinite(got.get(f, math.nan)) for f in FIELDS if f in got):
            return math.inf
        if name == "value_rel_err":
            return abs(got["value"] - want["value"]) / want["value"]
        if name == "bracket_miss":
            return max(got["lower"] - want["value"], want["above"] - got["upper"], 0.0) / want["value"]
        if name == "n_sel_out":
            alpha, m = float(self.call["alpha"]), max(1, int(self.d ** 0.5))
            return float(max(max(n_sel - ref.selection_capacity(n, m, alpha), ref.selection_floor(n, alpha) - n_sel, 0)
                             for n_sel, n in ((got["n_sel_a"], self.n_a), (got["n_sel_b"], self.n_b))))
        raise KeyError(f"no compared number {name!r}")

    def flops(self, rec: dict, want: dict | None) -> float | None:
        """Useful FLOPs of the call ``rec`` (ProHD's from the reference's
        selection ``want``)."""
        if self.call["method"] == "exact":
            return F.pair_flops("exact", self.d, self.n_a, self.n_b)
        if want is None:
            return None
        return F.pair_flops("prohd", self.d, self.n_a, self.n_b, want["n_sel_a"], want["n_sel_b"])

