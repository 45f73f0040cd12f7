"""The ``comm="psum"`` transport on ``torch.distributed``, after the JAX
package's ``parallel/collectives.py`` (XLA's collectives there): NCCL on
the card, gloo on the CPU. Each takes a rank's mesh view and returns a
new tensor; the caller's is not changed."""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum across the ranks (``dist.all_reduce(SUM)``)."""
    y = x.contiguous().clone()
    dist.all_reduce(y, group=mesh.group)
    return y


def all_gather(x: torch.Tensor, mesh, *, dim: int = 0) -> torch.Tensor:
    """Concatenate the ranks' blocks along ``dim`` in rank order
    (``all_gather_into_tensor``; the reference's ``torch.cat`` of the
    gathered shards, ``train_ffns.py:209``)."""
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((mesh.size * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xm, group=mesh.group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, mesh, *, dim: int = 0) -> torch.Tensor:
    """Sum across the ranks, then rank r keeps block r of ``dim``
    (``reduce_scatter_tensor``, ``train_ffns.py:255-256``).

    On gloo this is ``all_reduce`` followed by the rank's own block:
    gloo's ``reduce_scatter_tensor`` ends the whole process with a failed
    check instead of raising. That route serves the CPU ranks only; on the
    card it is NCCL's ``reduce_scatter_tensor``."""
    n = mesh.size
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"dim {dim} of size {xm.shape[0]} does not split "
                         f"into {n} ranks")
    if dist.get_backend(mesh.group) == "gloo":
        y = xm.clone()
        dist.all_reduce(y, group=mesh.group)
        out = y.chunk(n)[mesh.rank].clone()
    else:
        out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, xm, group=mesh.group)
    return out.movedim(0, dim)


COMMS = ("psum", "pallas_ring")


def check_comm(comm: str, mesh) -> None:
    """``comm`` is a transport the strategies know, and one the mesh can
    run: a loopback mesh has no process group, so only the ring."""
    if comm not in COMMS:
        raise ValueError(f"unknown comm {comm!r} "
                         "(expected 'psum' or 'pallas_ring')")
    if comm == "psum" and getattr(mesh, "loopback", False):
        raise ValueError("a loopback mesh (n ranks on one card) runs the "
                         "pallas_ring transport only: psum needs a process "
                         "group")
