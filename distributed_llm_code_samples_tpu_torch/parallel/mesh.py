"""The 1-D meshes of the port, after the JAX package's
``parallel/mesh.py``.

A JAX mesh names devices along axes and collectives address an axis by
name. Here a mesh names a world size along one of the ported axes,
``DATA_AXIS`` (DDP, FSDP) or ``EXPERT_AXIS`` (expert parallelism), and a
device kind: on CUDA one process a card over NCCL, on the CPU n gloo
processes (``parallel/launcher.py`` spawns both), or, with
``loopback=True``, n threads of one process on one card whose peer
collectives are single cooperative launches over n workspaces.

``make_mesh`` builds the mesh a caller hands to a trainer. Inside a
rank the launcher gives the trainer that mesh's rank view: the same
mesh with its ``rank``, the ``torch.distributed`` group and the rank's
``Ring`` for the ``comm="pallas_ring"`` and ``"pallas_a2a"``
transports.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

import torch

from .. import resolve_device
from ..ops.ring import Loopback, PeerWorkspace, Ring, ppermute_dma

DATA_AXIS = "data"
EXPERT_AXIS = "expert"
AXES = (DATA_AXIS, EXPERT_AXIS)


class LoopbackState:
    """What the n threads of a loopback mesh share: one workspace of n
    regions and its ``Loopback``, made by the first thread that asks."""

    def __init__(self, n: int, device: torch.device):
        self.n, self.device = n, device
        self.loop: Optional[Loopback] = None
        self._lock = threading.Lock()

    def get(self, nbytes: int) -> Loopback:
        with self._lock:
            if self.loop is None:
                self.loop = Loopback(PeerWorkspace(nbytes, self.device,
                                                   n=self.n))
            elif self.loop.workspace.capacity < nbytes:
                raise ValueError(f"the loopback workspace holds "
                                 f"{self.loop.workspace.capacity} bytes, "
                                 f"{nbytes} were asked for")
            return self.loop

    def abort(self) -> None:
        with self._lock:
            if self.loop is not None:
                self.loop.abort()

    def close(self) -> None:
        if self.loop is not None:
            self.loop.workspace.close()
            self.loop = None


@dataclass
class Mesh:
    """``shape`` ``{DATA_AXIS: n}`` or ``{EXPERT_AXIS: n}`` on ``device``
    (``"cuda"`` or ``"cpu"``). ``rank``, ``group`` and the ring are set in
    a rank's view only."""
    shape: dict
    device: str = "cuda"
    loopback: bool = False
    rank: Optional[int] = None
    group: Any = field(default=None, repr=False)
    _loop_state: Optional[LoopbackState] = field(default=None, repr=False)
    _ring: Optional[Ring] = field(default=None, repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def in_rank(self) -> bool:
        return self.rank is not None

    @property
    def torch_device(self) -> torch.device:
        """The rank's device: ``cuda:<rank>`` (one process a card), the
        current card (loopback) or the CPU."""
        if self.device == "cpu":
            return torch.device("cpu")
        if self.loopback:
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cuda", self.rank)

    def for_rank(self, rank: int, group=None,
                 loop_state: Optional[LoopbackState] = None) -> "Mesh":
        return dataclasses.replace(self, rank=rank, group=group,
                                   _loop_state=loop_state, _ring=None)

    def ring(self, nbytes: int = 0, probe: bool = True) -> Ring:
        """This rank's ``Ring`` with room for a tensor of ``nbytes``. The
        first call opens it (on the card a ``PeerWorkspace``, collective
        over the ranks) and, with ``probe``, sends each rank's index one
        hop (``ppermute_dma``), which must bring the left neighbour's: a
        ring whose peers are mapped wrong stops here, not in the
        gradients. (Expert parallelism opens it without the probe: it
        launches no ring kernel.) A later call that needs more room
        reopens it larger; every rank makes the same calls, so they stay
        collective."""
        if not self.in_rank:
            raise ValueError("a mesh's ring exists inside its ranks only")
        ring = self._ring
        ws = ring.workspace if ring is not None else None
        if ring is not None and (ws is None or ws.capacity >= nbytes):
            return ring
        n, r = self.size, self.rank
        if n == 1 or self.device == "cpu":
            ring = Ring(n, r, group=self.group)
        elif self.loopback:
            ring = Ring(n, r, loopback=self._loop_state.get(nbytes))
        else:
            if ws is not None:
                ws.close()
            ring = Ring(n, r, group=self.group, workspace=PeerWorkspace(
                nbytes, self.torch_device, group=self.group))
        self._ring = ring
        if n > 1 and probe:
            got = ppermute_dma(torch.full((1,), float(r),
                                          device=self.torch_device), ring)
            if int(got.item()) != (r - 1) % n:
                raise RuntimeError(f"ring check: rank {r} received "
                                   f"{int(got.item())}, not its left "
                                   f"neighbour {(r - 1) % n}")
        return ring

    def check(self) -> None:
        """Raise if a ring kernel of this rank gave up waiting (it reads
        the workspace's error word, so it synchronises the card)."""
        ring = self._ring
        if ring is not None and ring.workspace is not None:
            ring.workspace.check()
        if ring is not None and ring.loopback is not None:
            ring.loopback.workspace.check()

    def close(self) -> None:
        """Close the rank's workspace (collective), if it has one."""
        if self._ring is not None and self._ring.workspace is not None:
            self._ring.workspace.close()
        self._ring = None


def make_mesh(axes: Mapping[str, int] | None = None, device=None,
              loopback: bool = False) -> Mesh:
    """A mesh of ``axes`` (``{DATA_AXIS: n}`` or ``{EXPERT_AXIS: n}``) on
    ``device``: CUDA unless the CPU is asked for (``resolve_device``).
    ``axes=None`` on CUDA takes every visible card on the data axis, as
    the JAX ``make_mesh`` takes every device. On CUDA each rank needs a
    card of its own unless ``loopback``. Meshes of two axes (the data x
    expert mesh, TP, the hybrid) are not ported and raise."""
    dev = resolve_device(device).type
    if axes is None:
        if dev != "cuda":
            raise ValueError("a CPU mesh needs its size: make_mesh("
                             "{DATA_AXIS: n}, device='cpu')")
        axes = {DATA_AXIS: torch.cuda.device_count()}
    axes = dict(axes)
    if len(axes) != 1 or not set(axes) <= set(AXES):
        raise NotImplementedError(
            f"mesh axes {sorted(axes)}: only {DATA_AXIS!r} is ported for "
            f"DDP and FSDP, and {EXPERT_AXIS!r} for expert parallelism, each "
            "as a 1-D mesh (TP, the hybrid, the data x expert mesh and the "
            "other axes are not yet)")
    n = math.prod(axes.values())
    if n < 1:
        raise ValueError(f"mesh {axes} has no ranks")
    if loopback and dev != "cuda":
        raise ValueError("loopback runs n ranks on one card; it needs CUDA")
    if dev == "cuda" and not loopback and n > torch.cuda.device_count():
        raise ValueError(f"mesh {axes} needs {n} cards, only "
                         f"{torch.cuda.device_count()} visible")
    return Mesh(axes, dev, loopback)


def require_axes(mesh: Mesh, *axes: str) -> None:
    """Fail with a readable message when a strategy is handed a mesh
    without the axis names it shards over."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a Mesh from make_mesh, got "
                        f"{type(mesh).__name__}")
    missing = [a for a in axes if a not in mesh.shape]
    if missing:
        raise ValueError(
            f"mesh has axes {dict(mesh.shape)} but this strategy needs "
            f"{missing} — build it with make_mesh({{'"
            + "': n, '".join(axes) + "': n})")
