"""roofline.py gives the per-token figures of its docstring."""

from __future__ import annotations

import pytest

from benchmark import roofline as RL
from benchmark import weights as W
from benchmark.tests.conftest import ROOT


def dims(name):
    return W.Dims.from_json(__import__("json").load(open(f"{ROOT}/configs/{name}.json")))


def test_mistral_token_bytes():
    d = dims("mistral-7b-fp8")
    assert RL.attn_bytes(d) == 41_943_040 and RL.expert_bytes(d) == 176_160_768
    assert RL.token_weight_bytes(d) == 7_110_393_856
    assert RL.kv_position_bytes(d) == 131_072
    w = RL.Work()
    w.decode(d, [1281])  # the token at position 1280
    assert w.bytes == 7_279_366_144
    assert w.bound_s == pytest.approx(2.173e-3, abs=5e-7) and w.bytes_bound_s == w.bound_s


def test_mixtral_token_bytes():
    d = dims("mixtral-8x7b-fp8")
    assert RL.router_bytes(d) == 32_768
    assert RL.token_weight_bytes(d) == 12_748_587_008
    assert RL.all_weight_bytes(d) == 46_702_526_464
    w = RL.Work()
    w.decode(d, [1281])
    assert w.bound_s == pytest.approx(3.856e-3, abs=5e-7)


def test_experts_read():
    d = dims("mixtral-8x7b-fp8")
    assert RL.experts_read(d, 1) == pytest.approx(2.0)
    assert 8 - RL.experts_read(d, 24) < 0.01
    assert RL.experts_read(dims("mistral-7b-fp8"), 32) == 1.0


def test_prefill_is_bounded_by_operations():
    d = dims("mistral-7b-fp8")
    w = RL.Work()
    w.prefill(d, 1024)
    assert w.flops > 2 * 1024 * 7e9 and w.bytes_bound_s == 0.0
