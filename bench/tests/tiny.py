"""Tiny copies of the benchmark's cells, for the CPU tests."""
from __future__ import annotations

import copy

from bench.harness import spec as S

# Each cell at a size the CPU holds in well under a second a step.
SIZES = {
    "rc256.exact_256k": 700,
    "rc256.prohd_1m": 3000,
}


def tiny_cell(name: str) -> S.Cell:
    cell = S.load_cell(name)
    cell.config, cell.traffic = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cell.config["points_per_side"] = SIZES[name]
    return cell
