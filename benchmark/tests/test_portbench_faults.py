"""Each cell at its own size and with its own limits, the timed path
broken underneath (``conftest.plant``): a decode step that writes no K/V
row, and in the served cells every other slot left out of the step. The
check has to come out false. Needs the card (the cells' sizes); each line
the test prints gives the numbers the broken run compared."""

from __future__ import annotations

import json

import pytest

from benchmark.run import run_cell
from benchmark.tests.conftest import plant

SECONDS = {"mistral7b.stream": 6.0, "mixtral8x7b.stream": 8.0, "mistral7b.chat": 20.0,
           "mixtral8x7b.batch32": 20.0}
CASES = [("mistral7b.stream", "state_unchanged"), ("mixtral8x7b.stream", "state_unchanged"),
         ("mistral7b.chat", "state_unchanged"), ("mistral7b.chat", "half_batch"),
         ("mixtral8x7b.batch32", "state_unchanged"), ("mixtral8x7b.batch32", "half_batch")]
SEED = 2**31 + 31


@pytest.mark.card
@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_fails_the_cells_check(card, monkeypatch, cell, fault):
    plant(monkeypatch, fault)
    r = run_cell(cell, SEED, SECONDS[cell], False)
    print(json.dumps({"cell": cell, "fault": fault, "seed": SEED,
                      "compared": {k: v["value"] for k, v in r["compared"].items()}}))
    assert not r["correct"], r["compared"]
