"""The meshes of the port, after the JAX package's ``parallel/mesh.py``.

A JAX mesh names devices along axes and collectives address an axis by
name. Here a mesh names a world size along the ported axes,
``DATA_AXIS`` (DDP, FSDP), ``EXPERT_AXIS`` (expert parallelism) or
``MODEL_AXIS`` (tensor parallelism) or ``SEQ_AXIS`` (sequence
parallelism), alone or as the 2-D data x model mesh of the hybrid or the
data x seq mesh of long context, and a device kind: on CUDA one process
a card over NCCL, on the CPU n gloo processes (``parallel/launcher.py``
spawns both), or, with ``loopback=True``, n threads of one process on
one card whose peer collectives are single cooperative launches over n
workspaces (on the CPU, for tests, n threads whose collectives are the
plain versions).

Ranks sit on the mesh as JAX's devices do: JAX reshapes its device list
to the axes' sizes in their order, so rank r's coordinates are r
unravelled over ``shape`` (on ``{DATA_AXIS: dp, MODEL_AXIS: tp}`` rank r
is at ``(r // tp, r % tp)``, and a model group is a run of consecutive
ranks).

``make_mesh`` builds the mesh a caller hands to a trainer. Inside a
rank the launcher gives the trainer that mesh's rank view: the same
mesh with its ``rank``, the ``torch.distributed`` group, the group of
each axis (``axis_group``), and the rank's ``Ring`` for the
``comm="pallas_ring"`` and ``"pallas_a2a"`` transports.
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
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, SEQ_AXIS)
# the meshes of two axes that are ported, in either order
MESHES_2D = ({DATA_AXIS, MODEL_AXIS}, {DATA_AXIS, SEQ_AXIS})


class LoopbackState:
    """What the n threads of one loopback group share: its ``Loopback``,
    which runs the plain collectives from the start, and for the ring
    kernels a workspace of n regions, made by the first thread that
    asks."""

    def __init__(self, n: int, device: torch.device):
        self.n, self.device = n, device
        self.loop = Loopback(n)
        self._lock = threading.Lock()

    def get(self, nbytes: int) -> Loopback:
        with self._lock:
            ws = self.loop.workspace
            if ws is None:
                self.loop.workspace = PeerWorkspace(nbytes, self.device,
                                                    n=self.n)
            elif ws.capacity < nbytes:
                raise ValueError(f"the loopback workspace holds "
                                 f"{ws.capacity} bytes, {nbytes} were "
                                 "asked for")
            return self.loop

    def abort(self) -> None:
        self.loop.abort()

    def close(self) -> None:
        if self.loop.workspace is not None:
            self.loop.workspace.close()
            self.loop.workspace = None


@dataclass
class Mesh:
    """``shape`` (``{axis: n}``, or ``{DATA_AXIS: dp, MODEL_AXIS: tp}``)
    on ``device`` (``"cuda"`` or ``"cpu"``). ``rank``, ``group``, the
    axis groups and the ring are set in a rank's view only."""
    shape: dict
    device: str = "cuda"
    loopback: bool = False
    rank: Optional[int] = None
    group: Any = field(default=None, repr=False)
    _loop_state: Optional[LoopbackState] = field(default=None, repr=False)
    _groups: dict = field(default_factory=dict, repr=False)
    _ring: Optional[Ring] = field(default=None, repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def in_rank(self) -> bool:
        return self.rank is not None

    def axis_size(self, axis: Optional[str] = None) -> int:
        """The ranks along ``axis`` (``None``: the whole mesh)."""
        if axis is None:
            return self.size
        require_axes(self, axis)
        return self.shape[axis]

    def coords(self, rank: int) -> dict:
        """Rank ``rank``'s coordinate on each axis (see the module
        docstring)."""
        out, rest = {}, rank
        for axis, n in reversed(list(self.shape.items())):
            out[axis], rest = rest % n, rest // n
        return {axis: out[axis] for axis in self.shape}

    def axis_index(self, axis: Optional[str] = None) -> int:
        """This rank's index along ``axis`` (``None``: its rank)."""
        if not self.in_rank:
            raise ValueError("a rank's index exists inside its ranks only")
        return self.rank if axis is None else self.coords(self.rank)[axis]

    def axis_groups(self, axis: str) -> list:
        """Every group along ``axis``: the ranks that differ only in their
        ``axis`` coordinate, each group in that coordinate's order, the
        groups in the order of their first rank."""
        require_axes(self, axis)
        groups: dict = {}
        for r in range(self.size):
            c = self.coords(r)
            key = tuple(v for a, v in c.items() if a != axis)
            groups.setdefault(key, []).append(r)
        return list(groups.values())

    def axis_group(self, axis: Optional[str] = None):
        """This rank's group along ``axis`` (``None``: the whole mesh):
        its ``torch.distributed`` group, or in loopback the
        ``LoopbackState`` its group's threads share."""
        if not self.in_rank:
            raise ValueError("a mesh's groups exist inside its ranks only")
        if axis is not None:
            require_axes(self, axis)
            if len(self.shape) > 1:
                return self._groups[axis]
        return self._loop_state if self.loopback else self.group

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
                 loop_state: Optional[LoopbackState] = None,
                 groups: Optional[dict] = None) -> "Mesh":
        """Rank ``rank``'s view: ``group`` the whole mesh's process group
        (``loop_state`` its loopback state) and, on a mesh of two axes,
        ``groups`` the rank's group of each axis."""
        return dataclasses.replace(self, rank=rank, group=group,
                                   _loop_state=loop_state,
                                   _groups=dict(groups or {}), _ring=None)

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
        if n > 1 and self.loopback:
            # CPU threads need no workspace: their calls run the plain
            # versions (ops/ring.py ``Loopback``)
            ring = Ring(n, r, loopback=self._loop_state.loop
                        if self.device == "cpu"
                        else self._loop_state.get(nbytes))
        elif n == 1 or self.device == "cpu":
            ring = Ring(n, r, group=self.group)
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
        if ring is not None and ring.loopback is not None \
                and ring.loopback.workspace is not None:
            ring.loopback.workspace.check()

    def close(self) -> None:
        """Close the rank's workspace (collective), if it has one."""
        if self._ring is not None and self._ring.workspace is not None:
            self._ring.workspace.close()
        self._ring = None


def make_mesh(axes: Mapping[str, int] | None = None, device=None,
              loopback: bool = False) -> Mesh:
    """A mesh of ``axes`` (one of ``DATA_AXIS``, ``EXPERT_AXIS``,
    ``MODEL_AXIS`` and ``SEQ_AXIS``, or ``{DATA_AXIS: dp, MODEL_AXIS: tp}``
    or ``{DATA_AXIS: dp, SEQ_AXIS: n}``) on ``device``:
    CUDA unless the CPU is asked for (``resolve_device``). ``axes=None``
    on CUDA takes every visible card on the data axis, as the JAX
    ``make_mesh`` takes every device. On CUDA each rank needs a card of
    its own unless ``loopback``. The other axes and the data x expert
    mesh are not ported and raise."""
    dev = resolve_device(device).type
    if axes is None:
        if dev != "cuda":
            raise ValueError("a CPU mesh needs its size: make_mesh("
                             "{DATA_AXIS: n}, device='cpu')")
        axes = {DATA_AXIS: torch.cuda.device_count()}
    axes = dict(axes)
    if not set(axes) <= set(AXES) or (len(axes) > 1
                                      and set(axes) not in MESHES_2D):
        raise NotImplementedError(
            f"mesh axes {list(axes)}: the ported meshes are the 1-D mesh "
            f"of one of {list(AXES)} and the {DATA_AXIS!r} x {MODEL_AXIS!r} "
            f"and {DATA_AXIS!r} x {SEQ_AXIS!r} meshes (the data x expert "
            "mesh and the other axes are not yet)")
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
