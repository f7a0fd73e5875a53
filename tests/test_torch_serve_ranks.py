"""Rank bodies of the port's sharded serving tests
(``test_torch_shard_serve.py``).

Every rank of a spawned gloo world imports this module, so it imports
neither JAX nor the JAX package. Each case builds the SPMD ``Server`` on
its mesh, with every rank of the mesh (or of a host) given the same
requests, and returns what each rank's requests came to. It defines no
tests of its own.
"""

from __future__ import annotations

import os
import sys

import torch

from calm_tpu_torch.engine import Engine
from calm_tpu_torch.parallel import ShardingPlan, make_mesh, make_multihost_mesh
from calm_tpu_torch.parallel.sharding import weight_pspecs
from calm_tpu_torch.serve import Server

CPU = "cpu"  # the ranks compute on the CPU (the mesh's default is the GPU)
HOSTS = 2    # the multi-host cases: two hosts of two ranks


def _plan(tp=1, dp=1):
    return ShardingPlan(tp="tp" if tp > 1 else None, dp="dp" if dp > 1 else None)


def _drain(srv, reqs, ticks=100):
    """Submit (prompt, max_tokens) greedy requests, drain: (done, text, ids)
    of each."""
    out = [srv.submit(p, max_tokens=n, temperature=0.0) for p, n in reqs]
    srv.run_until_drained(max_ticks=ticks)
    return [(r.done, r.text, list(r.ids)) for r in out]


def serve_case(rank, path, reqs, batch, tp=1, dp=1, **kw):
    """``reqs`` drained by ``Server(mesh, plan)`` on a dp x tp mesh (None
    past it): each request's (done, text, ids), and a paged pool's pages
    in use at the end."""
    mesh = make_mesh(tp=tp, dp=dp, device=CPU)
    if mesh is None:
        return None
    srv = Server(path, batch=batch, mesh=mesh, plan=_plan(tp, dp), **kw)
    out = dict(reqs=_drain(srv, reqs))
    if srv._paged is not None:
        out.update(pages=srv._paged.pages_in_use(), mesh=srv._paged.mesh is not None,
                   kv_heads=srv._paged.pool.k.shape[2])
    return out


def mid_flight_case(rank, path, first, second, batch, dp):
    """``first`` admitted, 4 ticks, then ``second`` admitted mid-flight on
    a dp mesh: both requests' (done, text, ids)."""
    mesh = make_mesh(dp=dp, device=CPU)
    if mesh is None:
        return None
    srv = Server(path, batch=batch, mesh=mesh, plan=_plan(dp=dp))
    r1 = srv.submit(first[0], max_tokens=first[1], temperature=0.0)
    for _ in range(4):
        srv.tick()
    r2 = srv.submit(second[0], max_tokens=second[1], temperature=0.0)
    srv.run_until_drained(max_ticks=100)
    return [(r.done, r.text, list(r.ids)) for r in (r1, r2)]


def prefix_case(rank, path, prompts, n_tokens, tp, **kw):
    """Requests one after another on a mesh-paged server with a prefix
    cache: each one's (done, text, ids, cached_prefix), the cache's hits."""
    mesh = make_mesh(tp=tp, device=CPU)
    if mesh is None:
        return None
    srv = Server(path, batch=1, mesh=mesh, plan=_plan(tp), **kw)
    out = []
    for p in prompts:
        r = srv.submit(p, max_tokens=n_tokens, temperature=0.0)
        srv.run_until_drained(max_ticks=60)
        out.append((r.done, r.text, list(r.ids), r.cached_prefix))
    return dict(reqs=out, hits=srv.prefix_cache.hits, pages=srv._paged.pages_in_use())


def multihost_case(rank, path, by_host, mode, batch=4):
    """Two hosts of two ranks (``LOCAL_WORLD_SIZE`` = 2), each host's ranks
    submitting only that host's requests (``by_host[host]``): ``mode``
    "dense" (dp=2 across hosts x tp=2), "device" (the same, sampling on the
    device) or "paged" (no mesh: each host a group of two decoders).
    Returns (host, its requests' (done, text, ids), the server's own slot
    range)."""
    os.environ["LOCAL_WORLD_SIZE"] = str(HOSTS)
    try:
        if mode == "paged":
            srv = Server(path, batch=batch, kv_dtype="fp16", page_rows=16,
                         dp_devices=[CPU, CPU], prefix_cache_tokens=2048, device=CPU)
        else:
            mesh = make_multihost_mesh(tp=2, dp_dcn=HOSTS, device=CPU)
            srv = Server(path, batch=batch, mesh=mesh, plan=_plan(tp=2, dp=2),
                         device_sampling=mode == "device")
        host = srv._pid
        return host, _drain(srv, by_host[host]), (srv._own_lo, srv._own_hi)
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]


def deadline_case(rank, path):
    """Two requests with a deadline on a tp=2 mesh, whose first rank sees
    the second one's deadline passed at once (its clock set 100 s back):
    every rank must end that request at the same tick, or their prefills
    and steps would part. Returns each request's (done, timed_out,
    n_generated, text)."""
    mesh = make_mesh(tp=2, device=CPU)
    if mesh is None:
        return None
    srv = Server(path, batch=2, mesh=mesh, plan=_plan(tp=2))
    a = srv.submit("hello world", max_tokens=6, temperature=0.0, timeout_s=600)
    b = srv.submit("the quick", max_tokens=6, temperature=0.0, timeout_s=600)
    if rank == 0:
        b.submitted_at -= 100 * 600
    srv.run_until_drained(max_ticks=40)
    return [(r.done, r.timed_out, r.n_generated, r.text) for r in (a, b)]


def _bytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def lazy_case(rank, path, tp):
    """``Engine(lazy_weights=True)`` under a tp server: the engine's
    weights before the server installs its shard (None), the bytes of
    each field of this rank's shard and of the whole load, the fields the
    plan shards over tp, and the lazy engine's banner and byte counts."""
    mesh = make_mesh(tp=tp, device=CPU)
    if mesh is None:
        return None
    plan = _plan(tp)
    lazy = Engine(path, device=CPU, lazy_weights=True)
    srv = Server(path, batch=2, mesh=mesh, plan=plan)
    whole = Engine(path, device=CPU)

    def fields(w):
        out = {"embed": _bytes(w.embed.data), "output": _bytes(w.output.data),
               "final_norm": _bytes(w.final_norm)}
        for f in w.layers.__dataclass_fields__:
            x = getattr(w.layers, f)
            out["layers." + f] = (_bytes(getattr(x, "data", x)) +
                                  _bytes(getattr(x, "scale", None)))
        return out
    specs = weight_pspecs(whole.cfg, plan)
    return dict(lazy_weights=lazy.weights, banner=(lazy.banner(), whole.banner()),
                counts=((lazy.n_bytes, lazy.n_bandwidth, lazy.n_params),
                        (whole.n_bytes, whole.n_bandwidth, whole.n_params)),
                shard=fields(srv.engine.weights), whole=fields(whole.weights),
                sharded={k for k, v in specs.items() if "tp" in v})


def refusals_case(rank, path):
    """The refusals JAX makes, on a dp2 x tp2 mesh: (what, the error's
    type name) of each."""
    mesh = make_mesh(tp=2, dp=2, device=CPU)
    plan = _plan(tp=2, dp=2)
    tp = make_mesh(tp=2, device=CPU)
    out = []
    for what, kw in (("batch % dp", dict(batch=3, mesh=mesh, plan=plan)),
                     ("mesh-paged dp", dict(batch=2, mesh=mesh, plan=plan, page_rows=16)),
                     ("mesh-paged device sampling",
                      dict(batch=2, mesh=tp, plan=_plan(tp=2), page_rows=16,
                           device_sampling=True)),
                     ("speculative on a mesh",
                      dict(batch=2, mesh=mesh, plan=plan, draft_path=path))):
        if kw["mesh"] is None:
            continue
        try:
            Server(path, **kw)
            out.append((what, None))
        except Exception as e:  # noqa: BLE001 — the test reads the type
            out.append((what, type(e).__name__))
    os.environ["LOCAL_WORLD_SIZE"] = str(HOSTS)
    try:
        Server(path, batch=4, page_rows=16, device=CPU)
        out.append(("paged across hosts without dp_devices", None))
    except Exception as e:  # noqa: BLE001
        out.append(("paged across hosts without dp_devices", type(e).__name__))
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    return out if tp is not None else None  # the ranks of every mesh


def modules_case(rank, forbidden):
    """The modules of ``forbidden`` packages this rank imported, after
    serving every case."""
    return sorted(m for m in sys.modules if m.split(".")[0] in forbidden)


def run(rank, cases):
    """Every (name, function name, args, kwargs) of ``cases`` in order, on
    every rank: {name: result}."""
    torch.manual_seed(0)
    out = {}
    for name, fn, args, kw in cases:
        out[name] = globals()[fn](rank, *args, **kw)
    return out
