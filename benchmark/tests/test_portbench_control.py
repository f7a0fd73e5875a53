"""The control of each cell, at the cell's own size, on three seeds: the
reference in the precision below the configuration's (its KV cache at
fp8 e5m2), put in the program's place, has to fail the cell's check.
Needs the card (the cells' sizes); a run takes some minutes a cell."""

from __future__ import annotations

import pytest

from benchmark.run import ROOT, load_json, run_cell

CELLS = {"mistral7b.stream": 6.0, "mixtral8x7b.stream": 8.0, "mistral7b.chat": 20.0,
         "mixtral8x7b.batch32": 20.0}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_the_cells_check(card, cell):
    limits = load_json(ROOT, "workloads", cell)["check"]["limits"]
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        r = run_cell(cell, seed, CELLS[cell], False, control=True)
        assert r["correct"], r["compared"]
        low = r["controls"]["kv_fp8"]
        assert any(low[k] > v for k, v in limits.items()), (low, limits)
