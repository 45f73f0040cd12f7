"""The ``comm="psum"`` transport on ``torch.distributed``, after the JAX
package's ``parallel/collectives.py`` (XLA's collectives there): NCCL on
the card, gloo on the CPU. Each takes a rank's mesh view and returns a
new tensor; the caller's is not changed."""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.ring import SUM, tiled_all_to_all


def all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum across the ranks (``dist.all_reduce(SUM)``). A loopback mesh
    has no process group: there its n threads sum their tensors in rank
    order in plain torch (no kernel), the one collective its trainers
    take from this module (expert parallelism's router gradients)."""
    if getattr(mesh, "loopback", False):
        return mesh.ring().loopback.call(SUM, x.contiguous(), mesh.rank)
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


def _all_to_all_single(xm: torch.Tensor, mesh) -> torch.Tensor:
    if xm.shape[0] % mesh.size:
        raise ValueError(f"leading dim {xm.shape[0]} not divisible by "
                         f"{mesh.size} peers (the split unit of all_to_all)")
    out = torch.empty_like(xm)
    dist.all_to_all_single(out, xm, group=mesh.group)
    return out


def all_to_all(x: torch.Tensor, mesh, *, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all (``lax.all_to_all(tiled=True)``): ``split_dim``
    splits into n blocks, block j goes to rank j, and the received blocks
    concatenate along ``concat_dim`` in rank order
    (``dist.all_to_all_single`` on the split dim moved to the front)."""
    return tiled_all_to_all(x, mesh, split_dim, concat_dim,
                            exchange=_all_to_all_single)


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
