"""The reading of a traced slice: busy time as the union of the device's
intervals, idle stretches named by what the host was doing."""

from __future__ import annotations

import pytest

from benchmark.trace import summarize


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_union_and_breakdown():
    events = [
        ev("bench.slice", "user_annotation", 1000, 1000),
        ev("bench.tick", "user_annotation", 1000, 600),
        ev("aten::mm", "cpu_op", 1300, 200),
        ev("k1", "kernel", 900, 200),        # clipped to the slice: 100 us
        ev("k2", "kernel", 1050, 100),       # overlaps k1: counted once
        ev("k2", "kernel", 1150, 50),
        ev("k3", "kernel", 1600, 300),
        ev("k3", "gpu_user_annotation", 1000, 900),  # not a device operation
        ev("k4", "kernel", 1903, 50),        # 3-us gap before it
    ]
    s = summarize(events)
    assert s.window_s == pytest.approx(1000e-6)
    # busy: [1000, 1200) + [1600, 1900) + [1903, 1953)
    assert s.busy_s == pytest.approx(550e-6)
    ops = dict(s.device_ops)
    assert ops["k1"] == pytest.approx(100e-6) and ops["k2"] == pytest.approx(150e-6)
    gaps = dict(s.idle_gaps)
    assert gaps["host: aten::mm"] == pytest.approx(400e-6)  # [1200, 1600): mid 1400 in mm
    assert gaps["device: gaps under 10 us between operations"] == pytest.approx(3e-6)
    assert gaps["host: no traced event"] == pytest.approx(47e-6)  # [1953, 2000)
