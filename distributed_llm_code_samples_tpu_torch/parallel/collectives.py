"""The ``comm="psum"`` transport on ``torch.distributed``, after the JAX
package's ``parallel/collectives.py`` (XLA's collectives there): NCCL on
the card, gloo on the CPU. Each takes a rank's mesh view and the mesh
``axis`` it runs along (``None``, the default: the whole mesh), and
returns a new tensor; the caller's is not changed.

A loopback mesh has no process group: there the threads of the rank's
axis group meet in their ``LoopbackState`` and one of them computes
every rank's result in plain torch (no kernel; a sum adds in rank order
within the group; the hop and the all-to-all move the blocks)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.ring import (A2A, CAT, MAX, PERM, SUM, SUM_SCATTER, Ring,
                        tiled_all_to_all)


def axis_index(mesh, axis: Optional[str] = None) -> int:
    """The rank's index along ``axis`` (``lax.axis_index``)."""
    return mesh.axis_index(axis)


def _loopback(op: str, xm: torch.Tensor, mesh, axis) -> torch.Tensor:
    return mesh.axis_group(axis).loop.call(op, xm, mesh.axis_index(axis))


def all_reduce(x: torch.Tensor, mesh, *,
               axis: Optional[str] = None) -> torch.Tensor:
    """Sum across the ranks of ``axis`` (``dist.all_reduce(SUM)``)."""
    if mesh.loopback:
        return _loopback(SUM, x.contiguous(), mesh, axis)
    y = x.contiguous().clone()
    dist.all_reduce(y, group=mesh.axis_group(axis))
    return y


def pmax(x: torch.Tensor, mesh, *,
         axis: Optional[str] = None) -> torch.Tensor:
    """The elementwise max across the ranks of ``axis`` (``lax.pmax``;
    ``dist.all_reduce(MAX)``): the row max of the vocab-parallel
    cross-entropy and of the fused head's logsumexp merge
    (``parallel/lm.py``)."""
    if mesh.loopback:
        return _loopback(MAX, x.contiguous(), mesh, axis)
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.axis_group(axis))
    return y


def psum_scalar(x: torch.Tensor, mesh, *,
                axis: Optional[str] = None) -> torch.Tensor:
    """The sum of a 0-d tensor over the ranks of ``axis`` (``lax.psum`` of
    a scalar: ``optim.clipped(axis=...)``'s squared norm), 0-d."""
    return all_reduce(x.reshape(1), mesh, axis=axis).reshape(())


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of a 0-d tensor over every rank of the mesh (``lax.psum``
    over all of its axes): the guard's finite flag as an int32
    (``runtime/guardrails.py``), 0-d."""
    return all_reduce(x.reshape(1), mesh).reshape(())


def all_gather(x: torch.Tensor, mesh, *, dim: int = 0,
               axis: Optional[str] = None) -> torch.Tensor:
    """Concatenate the blocks of the ranks of ``axis`` along ``dim`` in
    their order (``all_gather_into_tensor``; the reference's ``torch.cat``
    of the gathered shards, ``train_ffns.py:209``)."""
    xm = x.movedim(dim, 0).contiguous()
    if mesh.loopback:
        return _loopback(CAT, xm, mesh, axis).movedim(0, dim)
    out = torch.empty((mesh.axis_size(axis) * xm.shape[0],)
                      + tuple(xm.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xm, group=mesh.axis_group(axis))
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, mesh, *, dim: int = 0,
                   axis: Optional[str] = None) -> torch.Tensor:
    """Sum across the ranks of ``axis``, then the rank of index i keeps
    block i of ``dim`` (``reduce_scatter_tensor``,
    ``train_ffns.py:255-256``).

    On gloo this is ``all_reduce`` followed by the rank's own block:
    gloo's ``reduce_scatter_tensor`` ends the whole process with a failed
    check instead of raising. That route serves the CPU ranks only; on the
    card it is NCCL's ``reduce_scatter_tensor``."""
    n, group = mesh.axis_size(axis), mesh.axis_group(axis)
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"dim {dim} of size {xm.shape[0]} does not split "
                         f"into {n} ranks")
    if mesh.loopback:
        out = _loopback(SUM_SCATTER, xm, mesh, axis)
    elif dist.get_backend(group) == "gloo":
        y = xm.clone()
        dist.all_reduce(y, group=group)
        out = y.chunk(n)[mesh.axis_index(axis)].clone()
    else:
        out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, xm, group=group)
    return out.movedim(0, dim)


def ppermute(x: torch.Tensor, mesh, *,
             axis: Optional[str] = None) -> torch.Tensor:
    """The ring's one hop over the ranks of ``axis`` (``lax.ppermute``
    with ``perm=[(i, (i + 1) % n)]``): the rank of index i returns the
    block of the rank of index i - 1. One ``isend`` to the right
    neighbour and one ``irecv`` from the left in one
    ``batch_isend_irecv`` (NCCL or gloo); in loopback the plain hop. It
    is not the hop kernel ``ops.ring.ppermute_dma``: JAX's ring
    attention hops over XLA's ``ppermute``."""
    n = mesh.axis_size(axis)
    xm = x.contiguous()
    if n == 1:
        return xm.clone()
    if mesh.loopback:
        return _loopback(PERM, xm, mesh, axis)
    group, i = mesh.axis_group(axis), mesh.axis_index(axis)

    def peer(j: int) -> int:     # P2POp takes the peer's global rank
        return j if group is None else dist.get_global_rank(group, j)

    out = torch.empty_like(xm)
    ops = [dist.P2POp(dist.isend, xm, peer((i + 1) % n), group=group),
           dist.P2POp(dist.irecv, out, peer((i - 1) % n), group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _all_to_all_single(xm: torch.Tensor, ring: Ring) -> torch.Tensor:
    if xm.shape[0] % ring.n:
        raise ValueError(f"leading dim {xm.shape[0]} not divisible by "
                         f"{ring.n} peers (the split unit of all_to_all)")
    out = torch.empty_like(xm)
    dist.all_to_all_single(out, xm, group=ring.group)
    return out


def all_to_all(x: torch.Tensor, mesh, *, split_dim: int, concat_dim: int,
               axis: Optional[str] = None) -> torch.Tensor:
    """The tiled all-to-all (``lax.all_to_all(tiled=True)``) over the ranks
    of ``axis``: ``split_dim`` splits into n blocks, block j goes to the
    rank of index j, and the received blocks concatenate along
    ``concat_dim`` in their order (``dist.all_to_all_single`` on the split
    dim moved to the front; in loopback the plain exchange)."""
    peers = Ring(mesh.axis_size(axis), mesh.axis_index(axis),
                 group=mesh.axis_group(axis))
    exchange = _all_to_all_single
    if mesh.loopback:
        def exchange(xm, ring):
            return _loopback(A2A, xm, mesh, axis)
    return tiled_all_to_all(x, peers, split_dim, concat_dim,
                            exchange=exchange)


COMMS = ("psum", "pallas_ring")


def check_comm(comm: str, mesh, comms=COMMS) -> None:
    """``comm`` is one of the strategy's transports ``comms`` (``"psum"``
    and its kernel transport), and one the mesh can run: a loopback mesh
    has no process group, so only the kernels."""
    if comm not in comms:
        raise ValueError(f"unknown comm {comm!r} (expected "
                         + " or ".join(map(repr, comms)) + ")")
    if comm == "psum" and getattr(mesh, "loopback", False):
        raise ValueError(f"a loopback mesh (n ranks on one card) runs the "
                         f"{comms[1]} transport only: psum needs a process "
                         "group")
