"""Meshes over ``torch.distributed``: the port of ``calm_tpu.parallel.mesh``.

A sharded run is one process a rank, all running the same program (the
counterpart of the JAX package's ``shard_map`` body). :func:`make_grid`
lays the ranks out on a grid of named axes, slowest first, and makes one
process group per axis: :func:`make_mesh` on JAX's grid, ``reshape(dp, sp,
ep, tp)`` (``calm_tpu/parallel/mesh.py:43-49``), ``pipeline.make_pp_mesh``
on ``(pp, tp)``. The :class:`Mesh` it returns knows each axis's size and
this rank's index on it (the counterpart of ``lax.axis_index``) and has
the collectives the model calls: :meth:`Mesh.psum`, :meth:`Mesh.pmax`,
:meth:`Mesh.pmin`, :meth:`Mesh.all_gather`, :meth:`Mesh.psum_scatter` and
:meth:`Mesh.ppermute`.

The backend is the caller's (:func:`init_multihost`): NCCL across GPUs, or
gloo where NCCL cannot run, on CPU tensors and for several ranks that share
one GPU (NCCL refuses two ranks on one device). :func:`spawn` starts such a
run on one machine, with a ``file://`` rendezvous in a temporary directory.

Like the package's other entry points, a mesh, a health check and a spawned
run compute on the GPU unless ``device="cpu"`` is asked for: each rank's
own card, ``cuda:<local rank mod device count>``, and NoGPUError where
there is none.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import pickle
import tempfile
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from calm_tpu_torch.device import hbm_gbps, pick

AXES = ("dp", "sp", "ep", "tp")  # the grid's order, slowest first


@dataclasses.dataclass(frozen=True)
class Topology:
    n_devices: int
    device_kind: str
    hbm_gb_per_chip: float
    hbm_gbps_per_chip: float | None  # nominal HBM rate (device.HBM_GBPS)


def detect_topology() -> Topology:
    """The GPUs this process sees, with each card's memory and nominal HBM
    rate; a CPU-only machine is one "cpu" device."""
    if not torch.cuda.is_available():
        return Topology(1, "cpu", 0.0, None)
    p = torch.cuda.get_device_properties(0)
    return Topology(torch.cuda.device_count(), p.name, p.total_memory / 1e9,
                    hbm_gbps(p.name))


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str = "nccl") -> None:
    """Join a run of ``num_processes`` ranks as rank ``process_id``:
    ``init_process_group`` with an explicit backend and rendezvous
    (``tcp://host:port`` or ``file://path``). Nothing on a machine tells a
    program of its cluster, so all three are the caller's. A no-op when
    this process has joined already."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id)


def rank_device(device=None) -> torch.device:
    """Where this rank computes: ``device`` if given, else its own GPU,
    ``cuda:<local rank mod device count>`` (the local rank from
    ``LOCAL_RANK``, else the global rank). Raises NoGPUError when a GPU is
    asked for and none is present."""
    if device is not None:
        return pick(device)
    pick("cuda")
    local = int(os.environ.get("LOCAL_RANK",
                               dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


class Mesh:
    """This rank's place on a grid of ranks over named axes and a process
    group per axis. Axes of size 1 have no group and their collectives
    return the input. The reductions and gathers run on the tensor where
    it lies: gloo takes CUDA tensors for them (and NCCL does); gloo's
    point-to-point sends move host memory, so :meth:`ppermute` stages a
    CUDA tensor through the host on a gloo group."""

    def __init__(self, shape: dict[str, int], coords: dict[str, int],
                 groups: dict, world_group, ranks: list[int], device,
                 axis_ranks: dict | None = None):
        self.shape = shape            # axis name -> size
        self.coords = coords          # axis name -> this rank's index
        self._groups = groups         # axis name -> process group (size > 1)
        self._axis_ranks = axis_ranks or {}  # axis name -> its group's global ranks
        self.world_group = world_group  # every rank of the mesh
        self.ranks = ranks            # global ranks in grid order
        self.device = torch.device(device)

    @property
    def size(self) -> int:
        return len(self.ranks)

    def axis_size(self, axis: str | None) -> int:
        return 1 if axis is None else self.shape[axis]

    def axis_index(self, axis: str | None) -> int:
        return 0 if axis is None else self.coords[axis]

    def _group(self, axis):
        return None if axis is None else self._groups.get(axis)

    def _reduce(self, x: torch.Tensor, axes, op) -> torch.Tensor:
        for axis in (axes if isinstance(axes, tuple) else (axes,)):
            g = self._group(axis)
            if g is not None:
                x = x.contiguous().clone()
                dist.all_reduce(x, op=op, group=g)
        return x

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The sum of ``x`` over an axis (or a tuple of axes, one after the
        other), as ``lax.psum``."""
        return self._reduce(x, axes, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._reduce(x, axes, dist.ReduceOp.MAX)

    def pmin(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._reduce(x, axes, dist.ReduceOp.MIN)

    def all_gather(self, x: torch.Tensor, axis: str | None, dim: int = 0) -> torch.Tensor:
        """The axis's shards of ``x`` concatenated along ``dim`` in rank
        order (``lax.all_gather(tiled=True)``)."""
        g = self._group(axis)
        if g is None:
            return x
        h = x.movedim(dim, 0).contiguous()
        out = h.new_empty((self.shape[axis] * h.shape[0],) + tuple(h.shape[1:]))
        dist.all_gather_into_tensor(out, h, group=g)
        return out.movedim(0, dim)

    def psum_scatter(self, x: torch.Tensor, axis: str | None, dim: int = 0) -> torch.Tensor:
        """The sum over the axis of ``x``, of which this rank keeps its
        ``1/n`` block along ``dim`` (``lax.psum_scatter(tiled=True)``)."""
        g = self._group(axis)
        if g is None:
            return x
        n = self.shape[axis]
        h = x.movedim(dim, 0).contiguous()
        if h.shape[0] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
        out = h.new_empty((h.shape[0] // n,) + tuple(h.shape[1:]))
        dist.reduce_scatter_tensor(out, h, group=g)
        return out.movedim(0, dim)

    def ppermute(self, x: torch.Tensor, axis: str | None, perm) -> torch.Tensor:
        """``lax.ppermute``: for each (src, dst) of ``perm`` (indices on
        the axis) the rank at src sends ``x`` to the rank at dst; returns
        what this rank received, zeros where no one sends to it. One
        ``batch_isend_irecv`` over the axis's group."""
        g = self._group(axis)
        if g is None:
            return x if (0, 0) in perm else torch.zeros_like(x)
        me, ranks = self.coords[axis], self._axis_ranks[axis]
        host = x.is_cuda and dist.get_backend(g) == "gloo"
        src = x.detach().contiguous()
        src = src.cpu() if host else src
        out = torch.zeros_like(src)
        ops = []
        for s, d in perm:
            if s == me and d == me:
                out.copy_(src)
            elif s == me:
                ops.append(dist.P2POp(dist.isend, src, ranks[d], g))
            elif d == me:
                ops.append(dist.P2POp(dist.irecv, out, ranks[s], g))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out.to(x.device) if host else out


def make_grid(axes: dict[str, int], device=None) -> Mesh | None:
    """The first prod(sizes) ranks of the world on the grid
    ``arange(n).reshape(*sizes)`` of the named ``axes`` (slowest first),
    with one process group per axis of size > 1. Every rank of the world
    must call it, in the same order as its other groups (``new_group`` is
    collective); the ranks past the grid get None. ``device``: where this
    rank computes, by :func:`rank_device` (this rank's GPU unless given;
    NoGPUError without one)."""
    device = rank_device(device)
    names, sizes = list(axes), [int(v) for v in axes.values()]
    n = int(np.prod(sizes))
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"need {n} ranks, have {world}")
    grid = np.arange(n).reshape(sizes)
    me = dist.get_rank()
    groups, axis_ranks = {}, {}
    for i, axis in enumerate(names):
        if sizes[i] == 1:
            continue
        others = [range(s) for j, s in enumerate(grid.shape) if j != i]
        for rest in itertools.product(*others):
            idx = list(rest)
            idx.insert(i, slice(None))
            ranks = [int(r) for r in grid[tuple(idx)]]
            g = dist.new_group(ranks)
            if me in ranks:
                groups[axis], axis_ranks[axis] = g, ranks
    world_group = None if n == world else dist.new_group(list(range(n)))
    if me >= n:
        return None
    coords = dict(zip(names, (int(c) for c in np.argwhere(grid == me)[0])))
    return Mesh(dict(zip(names, sizes)), coords, groups, world_group, list(range(n)),
                device, axis_ranks)


def make_mesh(tp: int = 1, ep: int = 1, dp: int = 1, sp: int = 1,
              device=None) -> Mesh | None:
    """The first dp * sp * ep * tp ranks of the world on JAX's grid
    ``arange(n).reshape(dp, sp, ep, tp)`` (:func:`make_grid`)."""
    return make_grid(dict(zip(AXES, (dp, sp, ep, tp))), device)


def make_multihost_mesh(tp: int = 1, ep: int = 1, dp_dcn: int = 1,
                        device=None) -> Mesh | None:
    """The same grid over the global world: dp, which runs no per-layer
    collective, is the axis that crosses hosts (``calm_tpu/parallel/mesh.py
    :92-101``). ``device`` as in :func:`make_mesh`."""
    return make_mesh(tp=tp, ep=ep, dp=dp_dcn, device=device)


def host_layout(group=None) -> tuple[int, int]:
    """(hosts, this rank's host) of the ranks of ``group`` (the world when
    None): the counterpart of JAX's ``process_count()`` and
    ``process_index()`` for a run of one process a rank. The launcher says
    how many ranks a host runs (``LOCAL_WORLD_SIZE``, as ``torchrun`` sets
    it); without it, or without a process group, every rank is on one
    host. Ranks are numbered host by host, as ``torchrun`` numbers them."""
    if not dist.is_initialized():
        return 1, 0
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local < 1 or world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE={local} does not divide the {world} ranks")
    return world // local, rank // local


def health_check(mesh: Mesh | None = None, timeout_s: float = 60.0,
                 device=None) -> dict:
    """Fail fast on a sick run before loading weights (``calm_tpu/parallel/
    mesh.py:104-165``): an all-reduce of ones over every rank of the mesh
    (the world without one), on the mesh's device, under a watchdog
    thread. Raises RuntimeError on a hang past ``timeout_s``, an error, or
    a wrong sum; returns a small report. Without a mesh the probe runs on
    ``device``, by :func:`rank_device` (this rank's GPU unless given)."""
    device = mesh.device if mesh is not None else rank_device(device)
    group = mesh.world_group if mesh is not None else None
    n = mesh.size if mesh is not None else dist.get_world_size()
    t0 = time.perf_counter()
    result: dict = {}

    def probe():
        try:
            x = torch.ones(8, device=device)
            dist.all_reduce(x, group=group)
            result["out"] = x.cpu()
        except Exception as e:  # noqa: BLE001 — reported with context below
            result["err"] = e

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise RuntimeError(f"health check HUNG (> {timeout_s:.0f} s) across {n} ranks: "
                           "the all-reduce never completed; suspect a missing rank "
                           "or a sick link")
    if "err" in result:
        raise RuntimeError(f"health check FAILED across {n} ranks: {result['err']}"
                           ) from result["err"]
    if not torch.all(result["out"] == float(n)):
        raise RuntimeError(f"health check WRONG RESULT: all-reduce over {n} ranks "
                           f"returned {result['out'][:4].tolist()}, expected {n}")
    return {"ranks": n, "backend": dist.get_backend(group),
            "device": str(device), "psum_seconds": time.perf_counter() - t0}


def _rank_main(fn, rank: int, world: int, tmp: str, device, args):
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)  # one machine: the local rank is the rank
    out = os.path.join(tmp, f"rank{rank}.pkl")
    try:
        device = rank_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                                world_size=world, rank=rank)
        try:
            res = ("ok", fn(rank, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — the parent raises it
        res = ("err", traceback.format_exc())
    with open(out + ".tmp", "wb") as f:
        pickle.dump(res, f)
    os.replace(out + ".tmp", out)


def spawn(fn, world: int, *args, device=None, timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes (the spawn
    start method), joined over gloo with a ``file://`` rendezvous in a
    temporary directory (so runs side by side share no port), each on one
    thread and on ``device``: each rank's own GPU unless given (several
    ranks may share one card, ``device="cuda:0"``, over gloo), NoGPUError
    without one. Returns each rank's result
    in rank order; raises with a rank's traceback if one failed, and
    stops every process on a timeout. ``fn`` and its results must pickle:
    ``fn`` lives in a module that imports no JAX, since every rank imports
    it."""
    if device is None:
        pick("cuda")  # refuse here, before any process starts
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="calm_spawn_") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, tmp, device, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        paths = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        results: dict[int, tuple] = {}
        deadline = time.monotonic() + timeout_s
        try:
            # until every rank reported, one failed (the others may wait on
            # it in a collective), or the time is up
            while len(results) < world and time.monotonic() < deadline:
                for r, path in enumerate(paths):
                    if r not in results and os.path.exists(path):
                        with open(path, "rb") as f:
                            results[r] = pickle.load(f)
                if any(st != "ok" for st, _ in results.values()):
                    break
                if any(not p.is_alive() and r not in results and not os.path.exists(paths[r])
                       for r, p in enumerate(procs)):
                    time.sleep(0.2)  # a result may land just after its process ends
                    lost = [r for r, p in enumerate(procs)
                            if not p.is_alive() and not os.path.exists(paths[r])]
                    if lost:
                        raise RuntimeError(f"spawn: ranks {lost} exited "
                                           f"{[procs[r].exitcode for r in lost]} "
                                           "without a result")
                time.sleep(0.01)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        for r in sorted(results):
            if results[r][0] != "ok":
                raise RuntimeError(f"spawn: rank {r} failed:\n{results[r][1]}")
        if len(results) < world:
            raise RuntimeError(f"spawn: {world - len(results)} of {world} ranks "
                               f"gave no result within {timeout_s:.0f} s")
        return [results[r][1] for r in range(world)]
