"""The traffic is deterministic for a seed, and the open loop's due times
follow its rate."""

from __future__ import annotations

import numpy as np

from benchmark import mix
from benchmark.run import Context, load_json, load_module
from benchmark import weights as W
from benchmark.tests.conftest import ROOT


def ctx(seed, seconds=30.0, cell="mistral7b.chat"):
    c = load_json(ROOT, "workloads", cell)
    d = W.Dims.from_json(load_json(ROOT, "configs", c["config"]))
    x = Context(c, d, seed, seconds, False, "cpu")
    if "system_bytes" in c["params"]:
        x.state = [mix.text(x.rng, c["params"]["system_bytes"]) for _ in range(4)]
    return x


def test_open_loop_schedule_is_the_seeds():
    drv = load_module(ROOT, "traffic", "open_loop")
    a, b = drv.schedule(ctx(2**31 + 7), 4.0), drv.schedule(ctx(2**31 + 7), 4.0)
    assert a == b
    c = drv.schedule(ctx(2**31 + 8), 4.0)
    assert [x[1] for x in a] != [x[1] for x in c]
    # every seed: the same schedule, other texts
    assert [(x[0], len(x[1]), x[2]) for x in a] == [(x[0], len(x[1]), x[2]) for x in c]


def test_open_loop_due_times_follow_the_rate():
    drv = load_module(ROOT, "traffic", "open_loop")
    for rate in (2.0, 4.0, 9.5):
        s = drv.schedule(ctx(123456789012, 40.0), rate)
        due = np.array([x[0] for x in s])
        assert len(s) == round(rate * 40.0)
        assert np.all(np.diff(due) > 0) and due[-1] <= 40.0
        assert abs(due[-1] - 40.0) < 0.1 * 40.0
        gaps = np.diff(np.concatenate([[0.0], due]))
        assert abs(gaps.mean() * rate - 1) < 0.1
        # exponential: the gaps' spread equals their mean
        assert abs(gaps.std() / gaps.mean() - 1) < 0.15


def test_lognormal_sizes():
    s = mix.lognormal(1001, median=256, sigma=1.0, lo=32, hi=2048)
    assert np.median(s) == 256 and s.min() >= 32 and s.max() <= 2048


def test_text_is_one_token_a_byte():
    t = mix.text(np.random.default_rng(5), 300)
    assert len(t.encode()) == 300 and "<" not in t and "|" not in t
    assert W.encode(t) == [W.BOS] + [W.BYTE0 + b for b in t.encode()]


def test_closed_loop_pool_is_the_seeds():
    drv = load_module(ROOT, "traffic", "closed_loop")
    c = ctx(99, cell="mixtral8x7b.batch32")
    p1, p2 = drv.Pool(c), drv.Pool(c)
    a = [p1.next() for _ in range(300)]
    assert a == [p2.next() for _ in range(300)]
    b = [drv.Pool(ctx(100, cell="mixtral8x7b.batch32")).next() for _ in range(1)]
    assert b[0][0] != a[0][0] and (len(b[0][0]), b[0][1]) == (len(a[0][0]), a[0][1])
