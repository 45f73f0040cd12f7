"""Rank launcher of the port, after the JAX package's
``parallel/launcher.py`` and the reference's launcher skeleton (shard the
seeds, spawn the workers, join, re-assemble, ``train_ffns.py:174-193``).

``launch(rank_fn, mesh, payload)`` runs ``rank_fn(rank_mesh, payload)``
on every rank of ``mesh`` and returns what each rank returned, in rank
order:

- a CPU mesh spawns n processes (start method ``spawn``), one gloo rank
  each, with one intra-op thread each;
- a CUDA mesh spawns one process a card, NCCL between them;
- a loopback mesh runs n threads of this process on one card.

The processes rendezvous on a ``file://`` store in a fresh temporary
directory (no port is ever bound, so launches in parallel cannot
collide). The payload goes to the ranks once, through a file in that
directory, and each rank's result comes back the same way. A rank that
raises or outlives ``timeout`` fails the launch: every rank still
running is killed, the directory removed, and the error raised here. A
rank whose parent dies exits on its own.

On a mesh of two axes every rank makes the process group of every row
and column of the mesh (``dist.new_group``), all in the same order and
at once, before the rank body starts: NCCL makes a group's communicator
as the group is made, and a group that only some ranks made would hang
the others. A loopback mesh gives each axis group its own
``LoopbackState``, so a group's threads meet only each other.

``run_strided`` is the per-rank body of the data-parallel trainers: the
rank's column of the strided seed split (``train_ffns.py:182``) over the
whole mesh or one axis of it, through its step. ``run_replicated`` is
that of tensor parallelism: every rank takes every seed. Both run inside
any process group that exists, the one ``launch`` makes or a caller's
own. ``to_device`` carries a trainer's parameters and optimizer state
(``optim.py``'s containers, or a tuple of both) to and from the ranks.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import shutil
import tempfile
import threading
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ..data import shard_seeds_strided
from ..optim import tree_map
from .mesh import LoopbackState, Mesh

DEFAULT_TIMEOUT_S = 900.0


class PerRank:
    """An argument of ``call_each`` that differs by rank: rank r takes
    ``values[r]``."""

    def __init__(self, values):
        self.values = list(values)


class _MeshMarker:
    def __reduce__(self):
        return "MESH"        # the one marker, also after a trip by pickle


MESH = _MeshMarker()    # in ``call_each`` arguments: the rank's mesh


def call_each(mesh: Mesh, calls) -> list:
    """A rank body that makes several calls in one launch: ``calls`` is a
    list of ``(fn, args, kwargs)``; in ``args`` and ``kwargs`` the ``MESH``
    marker stands for the rank's mesh and a ``PerRank`` for the rank's
    own value. Returns the results in order."""
    def arg(a):
        if a is MESH:
            return mesh
        return a.values[mesh.rank] if isinstance(a, PerRank) else a

    return [fn(*map(arg, args), **{k: arg(v) for k, v in kwargs.items()})
            for fn, args, kwargs in calls]


def run_replicated(step: Callable, params, seeds, mesh: Mesh,
                   on_step: Optional[Callable[[int], None]] = None):
    """Every seed of the schedule through the rank's ``step`` (JAX's
    ``launch(..., seed_spec=P())``). After each step the ring's error
    words are read (``Mesh.check``), so a ring wait that gave up fails
    the step it happened in."""
    for t, seed in enumerate(seeds):
        params = step(params, int(seed))
        mesh.check()
        if on_step is not None:
            on_step(t)
    return params


def run_strided(step: Callable, params, seeds, mesh: Mesh,
                on_step: Optional[Callable[[int], None]] = None,
                axis: Optional[str] = None):
    """The rank's share of the schedule strided over ``axis`` (``None``:
    the whole mesh): with n ranks along it, the rank of index i takes
    global seed ``seeds[t * n + i]`` at its step ``t``."""
    cols = shard_seeds_strided(seeds, mesh.axis_size(axis))
    return run_replicated(step, params, cols[:, mesh.axis_index(axis)],
                          mesh, on_step)


def _watch_parent(parent_pid: int) -> None:
    while True:
        if os.getppid() != parent_pid:
            os._exit(3)
        time.sleep(0.5)


def _rank_main(rank: int, mesh: Mesh, store: str, rank_fn: Callable,
               timeout: float, parent_pid: int) -> None:
    threading.Thread(target=_watch_parent, args=(parent_pid,),
                     daemon=True).start()
    cuda = mesh.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "nccl" if cuda else "gloo", init_method=f"file://{store}/rdzv",
            rank=rank, world_size=mesh.size,
            timeout=timedelta(seconds=timeout),
            **({"device_id": torch.device("cuda", rank)} if cuda else {}))
        # every rank has joined the group before any may leave it: a rank
        # that exits while a slower one still connects breaks the latter
        dist.barrier()
        me = mesh.for_rank(rank, group=dist.group.WORLD,
                           groups=_axis_groups(mesh, rank))
        payload = torch.load(os.path.join(store, "payload.pt"),
                             weights_only=False)
        out = rank_fn(me, payload)
        torch.save(out, os.path.join(store, f"out{rank}.pt.tmp"))
        os.replace(os.path.join(store, f"out{rank}.pt.tmp"),
                   os.path.join(store, f"out{rank}.pt"))
        me.close()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(store, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        # no collective clean-up: the other ranks may be gone already
        os._exit(1)


def _axis_groups(mesh: Mesh, rank: int) -> dict:
    """On a mesh of two axes, make the process group of every group of
    every axis, on every rank in the same order (``dist.new_group`` is
    collective over the world, and under NCCL with a bound device each
    makes its communicator at once), and return the rank's own of each
    axis. A 1-D mesh has the world group alone."""
    if len(mesh.shape) == 1:
        return {}
    mine = {}
    for axis in mesh.shape:
        for ranks in mesh.axis_groups(axis):
            group = dist.new_group(ranks)
            if rank in ranks:
                mine[axis] = group
    return mine


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def _launch_processes(rank_fn, mesh: Mesh, payload, timeout: float) -> list:
    n = mesh.size
    store = tempfile.mkdtemp(prefix="ranks-")
    ctx = mp.get_context("spawn")
    procs = []
    try:
        torch.save(payload, os.path.join(store, "payload.pt"))
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, mesh, store, rank_fn, timeout,
                                   os.getpid()))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.exitcode for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            late = [r for r, c in enumerate(codes) if c is None]
            if bad or not late or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        if bad or late:
            _stop(procs)
            errs = []
            for r in range(n):
                path = os.path.join(store, f"err{r}.txt")
                if os.path.exists(path):
                    with open(path) as f:
                        errs.append(f"rank {r}:\n{f.read()}")
            why = (f"ranks {bad} failed (exit codes "
                   f"{[codes[r] for r in bad]})" if bad else
                   f"ranks {late} did not finish within {timeout} s")
            raise RuntimeError(f"launch of {n} ranks: {why}"
                               + ("\n" + "\n".join(errs) if errs else ""))
        return [torch.load(os.path.join(store, f"out{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        _stop(procs)
        shutil.rmtree(store, ignore_errors=True)


def _launch_threads(rank_fn, mesh: Mesh, payload, timeout: float) -> list:
    n = mesh.size
    state = LoopbackState(n, mesh.torch_device)
    states = [state]
    groups: list = [{} for _ in range(n)]
    if len(mesh.shape) > 1:
        for axis in mesh.shape:
            for ranks in mesh.axis_groups(axis):
                states.append(LoopbackState(len(ranks), mesh.torch_device))
                for r in ranks:
                    groups[r][axis] = states[-1]
    outs: list = [None] * n
    errs: dict = {}

    def body(r):
        try:
            outs[r] = rank_fn(mesh.for_rank(r, loop_state=state,
                                            groups=groups[r]), payload)
        except BaseException as e:    # noqa: BLE001 - re-raised below
            errs[r] = e
            for s in states:
                s.abort()

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    try:
        if any(t.is_alive() for t in threads):
            for s in states:
                s.abort()
            raise RuntimeError(f"loopback launch of {n} ranks did not "
                               f"finish within {timeout} s")
        if errs:
            r = min(errs)
            raise RuntimeError(f"loopback rank {r} failed: {errs[r]!r}") \
                from errs[r]
        return outs
    finally:
        for s in states:
            s.close()


def launch(rank_fn: Callable[[Mesh, Any], Any], mesh: Mesh, payload=None,
           *, timeout: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``rank_fn(rank_mesh, payload)`` on every rank of ``mesh`` (see
    the module docstring); returns the ranks' results in rank order.
    ``rank_fn`` must be importable by name (a module-level function) and
    its results picklable."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a Mesh from make_mesh, got "
                        f"{type(mesh).__name__}")
    if mesh.in_rank:
        raise ValueError("launch takes the whole mesh, not a rank's view: "
                         "inside a rank call the per-rank body directly")
    if mesh.loopback:
        return _launch_threads(rank_fn, mesh, payload, timeout)
    return _launch_processes(rank_fn, mesh, payload, timeout)


def to_device(tree, device):
    """Every tensor of ``tree`` (parameters, an optimizer state, a tuple of
    both, or None) on ``device``, detached; a tensor already there is
    kept, not copied."""
    return tree_map(lambda t: t.detach().to(device), tree)


def launch_replicated(rank_fn: Callable, params, seeds, mesh: Mesh, *args,
                      timeout: float = DEFAULT_TIMEOUT_S) -> list:
    """``launch`` of a trainer that hands every rank the whole schedule:
    ``rank_fn(rank_mesh, (params, seeds, *args))`` on every rank, the
    parameters on the CPU for the trip (in loopback they stay on the
    card). An optimizer state in ``args`` travels as the trainer puts it
    there (``to_device``)."""
    if not mesh.loopback:
        params = to_device(params, "cpu")
    return launch(rank_fn, mesh, (params, seeds) + args, timeout=timeout)


def launch_strided(rank_fn: Callable, params, seeds, mesh: Mesh, *args,
                   axis: Optional[str] = None,
                   timeout: float = DEFAULT_TIMEOUT_S) -> list:
    """``launch_replicated`` of a strided data-parallel trainer, the seeds
    strided over ``axis`` (``None``: the whole mesh) by the rank body. The
    split is checked here first, so an indivisible schedule raises before
    anything is spawned."""
    shard_seeds_strided(seeds, mesh.axis_size(axis))
    return launch_replicated(rank_fn, params, seeds, mesh, *args,
                             timeout=timeout)


def refuse_unported(**options) -> None:
    """Raise ``NotImplementedError`` for the first option, given as
    ``name=(value, default)``, that is not at its default: the parts of
    the JAX strategies that are not ported yet."""
    for name, (value, default) in options.items():
        if value is not default and value != default:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet (ROADMAP.md Queue 1); "
                f"leave it at {default!r}")
