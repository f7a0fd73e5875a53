"""The port's sharded continuous batching against the JAX package: the
SPMD ``Server(mesh, plan)`` at tp=2, dp=2 x tp=2, dp=2 with a mid-flight
admission, gf4 at tp=2, the mesh-paged pool (fp16 and gf4, and its prefix
cache), the multi-host modes (two hosts of two ranks: dense, on-device
sampling, paged with ``dp_devices``), ``Engine(lazy_weights=True)`` and
the refusals JAX makes (the cases of tests/test_serve.py at :112, :129,
:149, :179, :227, :330, :851, :975 and :1008).

One world of 4 gloo ranks on the CPU is spawned for the module and runs
every case; the rank bodies live in the jax-free ``test_torch_serve_ranks``.
Each case's texts are held to the JAX server's on the same container
(tests/test_serve.py holds JAX's sharded servers to its plain one, so the
plain one is the reference here), its ids to the port's unsharded server,
and every rank of a mesh (or of a host) must return the same.
"""

import os

import pytest
import torch

from calm_tpu import serve as JS
from calm_tpu_torch import serve as TS
from calm_tpu_torch.parallel import spawn
from tests import test_torch_serve_ranks as R
from tests.modelgen import tiny_config, write_tiny_model

torch.set_num_threads(1)

SYS = "abcd efgh " * 4  # a shared system prompt: two full 16-row pages
TP2 = [("hello world", 8), ("the quick brown", 8)]
DP2 = TP2 + [("pack my box", 8)]
GF4 = [("hello world", 8), ("the quick", 8)]
PAGED = [("hello world", 6), ("the quick", 6), ("pack my box", 6)]
MID = (("hello world", 12), ("the quick", 6))
PREFIX = [SYS + "one", SYS + "two"]
BY_HOST = {0: [("hello world", 8), ("pack my box", 8)], 1: [("the quick brown", 8)]}
PAGED_KW = dict(page_rows=16, pool_pages=10)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard_serve")
    out = {"fp16": str(d / "m.calm"), "gf4": str(d / "g.calm")}
    write_tiny_model(out["fp16"], tiny_config(dtype="fp16", seq_len=64), seed=1)
    write_tiny_model(out["gf4"], tiny_config(dtype="gf4", seq_len=64), seed=1)
    return out


def _cases(p):
    return [
        ("tp2", "serve_case", (p["fp16"], TP2, 2, 2), {}),
        ("dp2_tp2", "serve_case", (p["fp16"], DP2, 4, 2, 2), {}),
        ("dp2_mid_flight", "mid_flight_case", (p["fp16"], *MID, 2, 2), {}),
        ("tp2_gf4", "serve_case", (p["gf4"], GF4, 2, 2), {}),
        ("paged_tp2", "serve_case", (p["fp16"], PAGED, 2, 2),
         dict(PAGED_KW, kv_dtype="fp16")),
        ("paged_tp2_gf4", "serve_case", (p["gf4"], PAGED, 2, 2), PAGED_KW),
        ("paged_tp2_prefix", "prefix_case", (p["fp16"], PREFIX, 6, 2),
         dict(PAGED_KW, kv_dtype="fp16", prefix_cache_tokens=4096)),
        *[(f"multihost_{m}", "multihost_case", (p["fp16"], BY_HOST, m), {})
          for m in ("dense", "device", "paged")],
        ("lazy", "lazy_case", (p["fp16"], 2), {}),
        ("refusals", "refusals_case", (p["fp16"],), {}),
        ("deadline", "deadline_case", (p["fp16"],), {}),
        ("modules", "modules_case", (("jax", "calm_tpu", "ml_dtypes"),), {}),
    ]


@pytest.fixture(scope="module")
def ranks(paths):
    return spawn(R.run, 4, _cases(paths), device="cpu", timeout_s=600)


def result(ranks, name):
    """The case's result on the ranks of its mesh, after checking that
    they agree."""
    got = [r[name] for r in ranks if r[name] is not None]
    assert got and all(g == got[0] for g in got[1:]), f"{name}: ranks disagree"
    return got[0]


def _texts(srv, reqs):
    out = []
    for prompt, n in reqs:  # one at a time: a request's text is its own
        out.append(srv.submit(prompt, max_tokens=n, temperature=0.0))
        srv.run_until_drained(max_ticks=100)
    assert all(r.done for r in out)
    return out


@pytest.fixture(scope="module")
def want(paths):
    """{(container, kv dtype, paged, prompt, max_tokens): (JAX text, the
    port's unsharded ids)} for every request of the cases."""
    runs = {("fp16", None, False): (TP2 + DP2 + list(MID) + BY_HOST[0] + BY_HOST[1]
                                    + [("hello world", 6)]),
            ("fp16", "fp16", False): PAGED + [(p, 6) for p in PREFIX],
            ("fp16", "fp16", True): BY_HOST[0] + BY_HOST[1],
            ("gf4", None, False): GF4 + PAGED}
    out = {}
    for (name, kv, paged), reqs in runs.items():
        kw = dict(kv_dtype=kv, **(dict(page_rows=16, pool_pages=8) if paged else {}))
        j = _texts(JS.Server(paths[name], batch=1, **kw), reqs)
        t = _texts(TS.Server(paths[name], batch=1, device="cpu", **kw), reqs)
        for (prompt, n), a, b in zip(reqs, j, t):
            out[(name, kv, paged, prompt, n)] = (a.text, b.ids)
    return out


def _check(got, reqs, want, name, kv=None, paged=False):
    assert len(got) == len(reqs)
    for (done, text, ids), (prompt, n) in zip(got, reqs):
        assert done
        assert (text, ids) == want[(name, kv, paged, prompt, n)], prompt


@pytest.mark.parametrize("case,name,reqs", [
    ("tp2", "fp16", TP2), ("dp2_tp2", "fp16", DP2), ("tp2_gf4", "gf4", GF4)])
def test_sharded_server_matches_jax(ranks, want, case, name, reqs):
    _check(result(ranks, case)["reqs"], reqs, want, name)


def test_dp_sharded_mid_flight_admission(ranks, want):
    """A request admitted while dp-sharded decode is in flight lands in a
    slot of its own dp shard without disturbing the running one."""
    _check(result(ranks, "dp2_mid_flight"), list(MID), want, "fp16")


@pytest.mark.parametrize("case,name,kv", [("paged_tp2", "fp16", "fp16"),
                                          ("paged_tp2_gf4", "gf4", None)])
def test_paged_tp_mesh_matches_jax(ranks, want, case, name, kv):
    """The mesh-paged pool: each rank holds its kv head of the pool, the
    admissions prefill through the sharded prefill, every page goes back."""
    got = result(ranks, case)
    _check(got["reqs"], PAGED, want, name, kv)
    assert got["mesh"] and got["pages"] == 0 and got["kv_heads"] == 1


def test_paged_tp_mesh_prefix_cache(ranks, want):
    """Prefix pinning on the mesh-paged pool: the second request hits the
    first's pinned pages, and both texts are JAX's."""
    got = result(ranks, "paged_tp2_prefix")
    _check([r[:3] for r in got["reqs"]], [(p, 6) for p in PREFIX], want, "fp16", "fp16")
    assert got["reqs"][0][3] == 0 and got["reqs"][1][3] >= 16
    assert got["hits"] == 1 and got["pages"] == 0


@pytest.mark.parametrize("mode", ["dense", "device", "paged"])
def test_multihost_serving(ranks, want, mode):
    """Two hosts of two ranks, each host submitting only its own requests
    into its own slot range: dense (dp across hosts x tp=2), with device
    sampling, and paged (each host its own group of two decoders); the
    ranks of a host agree, and every text is JAX's."""
    by_host = {}
    for r in ranks:
        host, got, own = r[f"multihost_{mode}"]
        assert own == (2 * host, 2 * host + 2)
        assert by_host.setdefault(host, got) == got, "the ranks of a host disagree"
    assert sorted(by_host) == [0, 1]
    for host, got in by_host.items():
        _check(got, BY_HOST[host], want, "fp16", *(("fp16", True) if mode == "paged" else ()))


def test_lazy_weights_hold_one_shard(ranks):
    """``Engine(lazy_weights=True)`` leaves the weights to the server: each
    tp rank holds half of every tp-sharded tensor and the whole of each
    replicated one, and the banner and byte counts read the container."""
    got = result(ranks, "lazy")
    assert got["lazy_weights"] is None
    assert got["banner"][0] == got["banner"][1] and got["counts"][0] == got["counts"][1]
    for field, whole in got["whole"].items():
        shard = got["shard"][field]
        assert shard * (2 if field in got["sharded"] else 1) == whole, field
    total = sum(got["whole"].values())
    replicated = sum(v for k, v in got["whole"].items() if k not in got["sharded"])
    assert sum(got["shard"].values()) == (total - replicated) // 2 + replicated


def test_sharded_refusals(ranks):
    """JAX's refusals stay errors: a batch that does not split over dp, a
    mesh-paged pool beside dp or device sampling, speculative serving on a
    mesh, paged serving across hosts without dp_devices."""
    got = result(ranks, "refusals")
    assert [what for what, _ in got] == [
        "batch % dp", "mesh-paged dp", "mesh-paged device sampling",
        "speculative on a mesh", "paged across hosts without dp_devices"]
    assert all(err == "ValueError" for _, err in got), got


def test_lazy_engine_counts(paths):
    """A lazy Engine reads config, tokenizer and byte counts from the
    container, as JAX's, and holds no weights."""
    from calm_tpu.engine import Engine as JEngine
    from calm_tpu_torch.engine import Engine

    lazy = Engine(paths["gf4"], device="cpu", lazy_weights=True)
    j = JEngine(paths["gf4"], lazy_weights=True)
    assert lazy.weights is None and j.weights is None
    assert (lazy.n_bytes, lazy.n_params, lazy.n_bandwidth) == (j.n_bytes, j.n_params,
                                                                j.n_bandwidth)
    assert lazy.tokenizer.encode("hello", bos=True) == j.tokenizer.encode("hello", bos=True)
    assert os.path.basename(paths["gf4"]) in lazy.banner()


def test_sharded_deadlines_are_agreed(ranks, want):
    """A deadline that one rank finds passed ends the request on every
    rank at the same tick (timed out, nothing generated); the other
    request is served as JAX serves it."""
    got = result(ranks, "deadline")
    assert got[1] == (True, True, 0, "")
    assert got[0][:3] == (True, False, 6)
    assert got[0][3] == want[("fp16", None, False, "hello world", 6)][0]


def test_ranks_import_no_jax(ranks):
    """Every rank served through the port alone."""
    assert [r["modules"] for r in ranks] == [[]] * 4
