"""The reading of the program's ``calm.*`` spans in a traced slice: device
time joined to the launching call by correlation, self time, and idle by
the innermost span; and the slice's breakdown naming idle by them."""

from __future__ import annotations

import pytest

from benchmark import spans
from benchmark.trace import summarize


def ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    ev("bench.slice", "user_annotation", 1000, 1000),
    ev("bench.tick", "user_annotation", 1000, 800),
    ev("calm.serve.tick", "user_annotation", 1000, 800),
    ev("calm.serve.admit", "user_annotation", 1000, 300),
    ev("calm.model.prefill", "user_annotation", 1050, 200),
    ev("cudaLaunchKernel", "cuda_runtime", 1060, 5, corr=1),
    ev("calm.serve.step", "user_annotation", 1300, 100),
    ev("cudaGraphLaunch", "cuda_runtime", 1350, 10, corr=2),
    ev("calm.serve.readback", "user_annotation", 1400, 300),
    ev("cudaMemcpyAsync", "cuda_runtime", 1405, 290, corr=3),
    ev("calm.serve.sample", "user_annotation", 1700, 100),
    ev("k1", "kernel", 1200, 200, corr=1),
    ev("k2", "kernel", 1450, 50, corr=2),
    ev("Memcpy DtoH", "gpu_memcpy", 1500, 50, corr=3),
    ev("k3", "kernel", 1555, 95),  # 5 us after the copy; launched by nothing traced
    ev("calm.serve.tick", "user_annotation", 2100, 100),  # after the slice: left out
]


def test_device_self_and_idle_by_span():
    r = spans.read(EVENTS)
    s = r.spans
    assert set(s) == {"calm.serve.tick", "calm.serve.admit", "calm.model.prefill",
                      "calm.serve.step", "calm.serve.readback", "calm.serve.sample"}
    assert s["calm.serve.tick"].count == 1
    # device: by the launching call's innermost span, and every span around it
    assert s["calm.model.prefill"].device_s == pytest.approx(200e-6)
    assert s["calm.serve.admit"].device_s == pytest.approx(200e-6)
    assert s["calm.serve.step"].device_s == pytest.approx(50e-6)
    assert s["calm.serve.readback"].device_s == pytest.approx(50e-6)
    assert s["calm.serve.tick"].device_s == pytest.approx(300e-6)
    # self: the duration less the children's cover
    assert s["calm.serve.tick"].self_s == pytest.approx(0.0)
    assert s["calm.serve.admit"].self_s == pytest.approx(100e-6)
    assert s["calm.serve.tick"].host_s == pytest.approx(800e-6)
    # idle: [1000, 1200) in the prefill, [1400, 1450) in the readback, the
    # 5-us gap left out, [1650, 2000) after the tick
    assert s["calm.model.prefill"].idle_s == pytest.approx(200e-6)
    assert s["calm.serve.readback"].idle_s == pytest.approx(50e-6)
    assert s["calm.serve.tick"].idle_s == 0.0
    assert r.idle_s == pytest.approx(600e-6)
    assert r.idle_outside_s == pytest.approx(350e-6)
    assert r.busy_s == pytest.approx(395e-6)
    # per instance: the nested spans' host seconds, by name
    tick = s["calm.serve.tick"].each[0]
    assert tick.start == 1000
    assert tick.inner == pytest.approx({"calm.serve.admit": 300e-6,
                                        "calm.model.prefill": 200e-6,
                                        "calm.serve.step": 100e-6,
                                        "calm.serve.readback": 300e-6,
                                        "calm.serve.sample": 100e-6})


def test_breakdown_names_idle_by_the_program_spans():
    """The slice's summary reads the same busy and window, and names the
    idle inside a tick by the program's spans, not by ``bench.tick``."""
    s = summarize(EVENTS)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx(395e-6)
    gaps = dict(s.idle_gaps)
    assert gaps["host: calm.model.prefill"] == pytest.approx(200e-6)
    assert gaps["host: cudaMemcpyAsync"] == pytest.approx(50e-6)
    assert not any("bench.tick" in n for n in gaps)
