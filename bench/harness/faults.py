"""Faults planted under the loop, to show that the check catches them.

Each is a program factory for ``run_cell(..., program=...)``: it wraps the
system under test of the cell's driver and breaks it in one way that the
cell can have:

- ``altered``: an answer changed where it is produced (the value raised
  by one part in a thousand);
- ``half``: half of the work left out (the pair's scan over half of B);
- ``stale``: a step that returns its state unchanged (the previous call's
  answer, computed once).
"""
from __future__ import annotations

import functools

__all__ = ["FAULTS"]


def _pairwise(kind: str, driver):
    base = driver.default_program()
    last = {}

    def call(a, b):
        if kind == "half":
            return base(a, b[: b.shape[0] // 2])
        if kind == "stale":
            if "out" not in last:
                last["out"] = base(a, b)
            return last["out"]
        out = dict(base(a, b))
        out["value"] *= 1.001
        return out

    return call


FAULTS = {kind: functools.partial(_pairwise, kind) for kind in ("altered", "half", "stale")}
