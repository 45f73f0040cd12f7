"""Optimizers, as in the JAX package's ``optim.py``: the reference's
inline SGD (``train_ffns.py:29, :114``) and the stateful rules that make
ZeRO-1 and ZeRO-3's sharded state meaningful (momentum, Adam, AdamW),
global-norm clipping and the LR schedules.

An optimizer is an object with ``init(params) -> state`` and
``update(grads, state, params, lr, mesh=None) -> (params, state)``, the
JAX ``(init, update)`` pair as methods. Each is a small class rather than
a pair of closures so that it pickles: a trainer given the whole mesh
hands it to spawned ranks. ``params`` is one of the port's parameter
containers (a tuple type such as ``FFNStackParams``, or ``LMParams``),
and the state's param-shaped leaves come in the same container. The
update math is written out by hand, leaf by leaf, in the JAX order of
operations and in JAX's types (a Python constant rounded to a bf16
leaf's dtype before it multiplies, ``weak``; an f32 tensor promoting a
bf16 leaf, ``scale_by``); ``torch.optim`` is not used. ``mesh`` is the
rank's mesh view: ``clipped(axis=...)`` sums its squared norm over that
axis, the counterpart of JAX's ``lax.psum`` inside ``shard_map``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from . import LR


# -- parameter trees ----------------------------------------------------------

def named_leaves(tree) -> list[tuple[str, torch.Tensor]]:
    """``(field name, tensor)`` of every leaf of a parameter container, in
    ``jax.tree_util.tree_leaves`` order of its JAX counterpart: a tuple
    type's fields, or the container's own ``named_leaves()``
    (``LMParams``)."""
    if hasattr(tree, "named_leaves"):
        return tree.named_leaves()
    if hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), t) for i, t in enumerate(tree)]
    raise TypeError(f"not a parameter container: {type(tree).__name__}")


def leaves(tree) -> list[torch.Tensor]:
    return [t for _, t in named_leaves(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensors of ``tree`` (and the matching tensors of
    ``rest``), keeping the structure: tensors, ``None``, parameter
    containers, and tuples, lists and dicts of them."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else fn(tree, *rest)
    if hasattr(tree, "with_leaves"):
        return tree.with_leaves([fn(*xs) for xs in zip(
            leaves(tree), *(leaves(r) for r in rest))])
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    raise TypeError(f"cannot map over {type(tree).__name__}")


def tree_tensors(tree) -> list[torch.Tensor]:
    """Every tensor of ``tree`` (a state or a parameter container), in the
    order ``tree_map`` visits them."""
    out: list[torch.Tensor] = []
    tree_map(lambda t: out.append(t) or t, tree)
    return out


# -- SGD ----------------------------------------------------------------------

def weak(c: float, like: torch.Tensor) -> float:
    """The Python constant ``c`` as JAX's weak typing takes it against a
    leaf of ``like``'s dtype: rounded to that dtype before it multiplies
    (0.9 is 0.8984375 in bf16). Torch would multiply a bf16 leaf by the
    constant at f32 width and round once; against an f32 leaf the two
    agree."""
    return float(torch.tensor(c, dtype=like.dtype))


def scale_by(c, t: torch.Tensor) -> torch.Tensor:
    """``c * t`` in JAX's types: a Python constant ``c`` takes ``t``'s dtype
    first (``weak``); a tensor ``c`` (a scheduled f32 LR, Adam's bias
    correction) is strongly typed, so a bf16 ``t`` is promoted to f32, as
    ``jnp`` promotes and as torch does not for a 0-d tensor."""
    if not isinstance(c, torch.Tensor):
        return t * weak(c, t)
    a, b = promoted(t, c)
    return a * b


def promoted(a: torch.Tensor, b: torch.Tensor):
    """``a`` and ``b`` in the dtype a JAX binary op of the two computes in
    (bf16 with f32 is f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def rounded_like(new, old):
    """Each leaf of ``new`` in the dtype of its leaf in ``old``, rounded to
    nearest even: where JAX's rule promotes a bf16 param to f32 (Adam's
    step, a scheduled LR), the port rounds the result once, at the end of
    the step (JAX's own scan cannot carry the f32 result; ROADMAP Queue
    3)."""
    return tree_map(lambda n, o: n if n.dtype == o.dtype else n.to(o.dtype),
                    new, old)


@torch.no_grad()
def sgd(params, grads, lr: float = LR):
    """``p - lr * g`` for every tensor of ``params`` (a tuple type such as
    ``FFNStackParams``, or a list of tensors), the JAX ``sgd``'s
    arithmetic: a float ``lr`` is weak-typed there, so it takes the param
    dtype first (0.1 is 0.10009765625 in bf16), then ``lr * g`` is rounded
    to the param dtype and subtracted. A tensor ``lr`` (a schedule's f32)
    promotes a bf16 step to f32, rounded to the param dtype once.

    It updates ``params`` in place and returns it, which saves one copy
    of the parameters; callers that need the old values clone first, as
    ``train_single`` does."""
    for p, g in zip(leaves(params), leaves(grads)):
        step = scale_by(lr, g.to(p.dtype))
        if step.dtype == p.dtype:
            p.sub_(step)
        else:
            p.copy_(p.to(step.dtype) - step)
    return params


class Optimizer:
    """A stateful update rule: ``init(params) -> state`` and
    ``update(grads, state, params, lr, mesh=None) -> (params, state)``.
    ``stateless`` marks an empty-state rule (plain SGD)."""
    stateless = False

    @property
    def name(self) -> str:
        return type(self).__name__.lower()

    def init(self, params):
        raise NotImplementedError

    def update(self, grads, state, params, lr, mesh=None):
        raise NotImplementedError


def check_state_args(optimizer, opt_state, return_state) -> None:
    """The stateful-trainer surface contract, shared by every launcher
    that threads optimizer state: state in/out requires an optimizer."""
    if optimizer is None and (return_state or opt_state is not None):
        raise ValueError("opt_state/return_state need an optimizer")


class SGD(Optimizer):
    """The reference's stateless SGD as an ``Optimizer`` (empty state), so
    every strategy that takes an optimizer degrades to its semantics. It
    updates ``params`` in place."""
    stateless = True
    name = "sgd"

    def init(self, params):
        return ()

    def update(self, grads, state, params, lr, mesh=None):
        return sgd(params, grads, lr), state


def sgd_optimizer() -> Optimizer:
    return SGD()


@dataclass(frozen=True)
class Momentum(Optimizer):
    """Heavy-ball momentum: ``v = beta*v + g``, ``p = p - lr*v``, with
    ``beta`` and a float ``lr`` rounded to the param dtype first (JAX's
    weak types); a tensor ``lr`` (a schedule's) promotes the step to f32,
    rounded to the param dtype at the end."""
    beta: float = 0.9

    @property
    def name(self) -> str:
        return f"momentum({self.beta})"

    def init(self, params):
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def update(self, grads, vel, params, lr, mesh=None):
        vel = tree_map(lambda v, g: scale_by(self.beta, v) + g.to(v.dtype),
                       vel, grads)
        new = tree_map(lambda p, v: torch.sub(*promoted(p, scale_by(lr, v))),
                       params, vel)
        return rounded_like(new, params), vel


def momentum(beta: float = 0.9) -> Optimizer:
    return Momentum(beta)


class AdamState(NamedTuple):
    mu: Any               # first moments, like params
    nu: Any               # second moments, like params
    count: torch.Tensor   # int32 step counter for the bias correction


@dataclass(frozen=True)
class Adam(Optimizer):
    """Adam with bias correction, written out: ``mu = b1*mu + (1-b1)*g``;
    ``nu = b2*nu + (1-b2)*g^2``; ``p -= lr * (mu/(1-b1^t)) /
    (sqrt(nu/(1-b2^t)) + eps)``, ``t`` the int32 count as float32.

    On bf16 params it computes in JAX's types: the moments stay in the
    param dtype (JAX's ``zeros_like`` state) with ``b1``, ``1 - b1``,
    ``b2`` and ``1 - b2`` rounded to bf16 first; the f32 bias corrections
    promote ``mu / c1`` and everything after it to f32, as ``jnp`` does.
    JAX's rule then returns f32 params, which its scan cannot carry
    (ROADMAP Queue 3); the port rounds each new param to the param dtype
    once, at the end of the step (round to nearest even)."""
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    @property
    def name(self) -> str:
        return f"adam({self.b1},{self.b2},{self.eps})"

    def init(self, params):
        dev = leaves(params)[0].device
        return AdamState(mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(torch.zeros_like, params),
                         count=torch.zeros((), dtype=torch.int32,
                                           device=dev))

    @torch.no_grad()
    def update(self, grads, state, params, lr, mesh=None):
        b1, b2, eps = self.b1, self.b2, self.eps
        count = state.count + 1
        t = count.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
        mu = tree_map(lambda m, g: scale_by(b1, m) + scale_by(
            1.0 - b1, g.to(m.dtype)), state.mu, grads)
        nu = tree_map(lambda n, g: scale_by(b2, n) + scale_by(
            1.0 - b2, torch.square(g.to(n.dtype))), state.nu, grads)

        def step(p, m, n):
            # c1 and c2 are f32 tensors: from here on JAX computes in f32
            m, c = promoted(m, c1)
            n, c_ = promoted(n, c2)
            u = scale_by(lr, m / c) / (torch.sqrt(n / c_) + eps)
            return torch.sub(*promoted(p, u))

        new = tree_map(step, params, mu, nu)
        return rounded_like(new, params), AdamState(mu=mu, nu=nu,
                                                    count=count)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    return Adam(b1, b2, eps)


def default_decays(name: str, p: torch.Tensor) -> bool:
    """AdamW's default decay mask (JAX ``optim.py:138-142``): a leaf
    decays iff ``ndim >= 2`` and its field name neither starts with
    ``ln`` nor is ``bias``/``gain``/``scale``: matmul weights and
    embedding tables decay, LayerNorm gains (stacked ``[L, d]``, 2-D)
    and biases do not."""
    return (p.dim() >= 2 and not name.startswith("ln")
            and name not in ("bias", "gain", "scale"))


@dataclass(frozen=True)
class AdamW(Optimizer):
    """AdamW: Adam with decoupled weight decay, ``p *= 1 - lr * wd`` on the
    leaves the mask selects, before the Adam step. ``decay_mask``
    (``leaf -> bool``, module-level to pickle) replaces the default
    path-aware mask ``default_decays``."""
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-2
    decay_mask: Optional[Callable] = None

    @property
    def name(self) -> str:
        return f"adamw({self.b1},{self.b2},{self.eps},{self.weight_decay})"

    def init(self, params):
        return Adam(self.b1, self.b2, self.eps).init(params)

    def decays(self, params) -> list[bool]:
        """Whether each leaf of ``params`` (``named_leaves`` order)
        decays."""
        if self.decay_mask is None:
            return [default_decays(n, p) for n, p in named_leaves(params)]
        return [bool(self.decay_mask(p)) for p in leaves(params)]

    @torch.no_grad()
    def update(self, grads, state, params, lr, mesh=None):
        factor = 1.0 - lr * self.weight_decay
        mask = iter(self.decays(params))
        decayed = tree_map(lambda p: scale_by(factor, p) if next(mask)
                           else p, params)
        new, state = Adam(self.b1, self.b2, self.eps).update(
            grads, state, decayed, lr)
        return rounded_like(new, params), state


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-2, decay_mask=None) -> Optimizer:
    return AdamW(b1, b2, eps, weight_decay, decay_mask)


def _sum_squares(grads) -> torch.Tensor:
    return sum(torch.sum(torch.square(g.to(torch.float32)))
               for g in leaves(grads))


def global_norm(grads) -> torch.Tensor:
    """L2 norm over every leaf of a gradient container."""
    return torch.sqrt(_sum_squares(grads))


@dataclass(frozen=True)
class Clipped(Optimizer):
    """``opt`` behind global-norm clipping: the grads are scaled by
    ``min(1, max_norm / ||g||)`` first. With ``axis`` the update runs on
    gradient shards (FSDP's, ZeRO-1's): the squared norm is summed over
    that axis of the rank's ``mesh`` (``collectives.all_reduce``) so every
    shard clips by the same global norm."""
    opt: Optimizer
    max_norm: float
    axis: Optional[str] = None

    def __post_init__(self):
        if self.max_norm <= 0:
            raise ValueError(f"max_norm must be > 0, got {self.max_norm}")

    @property
    def name(self) -> str:
        return f"clipped({self.opt.name},{self.max_norm},{self.axis})"

    @property
    def stateless(self) -> bool:
        return self.opt.stateless

    def init(self, params):
        return self.opt.init(params)

    @torch.no_grad()
    def update(self, grads, state, params, lr, mesh=None):
        grads = clip_by_norm(grads, self.max_norm, mesh, self.axis)
        return self.opt.update(grads, state, params, lr, mesh=mesh)


def clip_by_norm(grads, max_norm: float, mesh=None,
                 axis: Optional[str] = None):
    """Every leaf of ``grads`` times ``min(1, max_norm / ||g||)``, the
    squared norm summed in f32 (and with ``axis`` over that axis of the
    rank's ``mesh``, ``collectives.psum_scalar``: the gradients are
    shards), the scale cast to each leaf's dtype: ``Clipped``'s step and
    the guard's ``clip_by_global_norm``."""
    sq = _sum_squares(grads)
    if axis is not None:
        if mesh is None:
            raise ValueError(f"clipping over axis {axis!r} sums its norm "
                             "over a mesh axis: it needs the rank's mesh")
        from .parallel.collectives import psum_scalar
        sq = psum_scalar(sq, mesh, axis=axis)
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-16), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


def clipped(opt: Optimizer, max_norm: float,
            axis: str | None = None) -> Optimizer:
    return Clipped(opt, max_norm, axis)


@dataclass(frozen=True)
class WarmupCosine:
    """Linear warmup from 0 to ``peak_lr`` over ``warmup_steps``, then a
    cosine to ``min_lr`` at ``total_steps``: ``step -> lr`` on an int
    tensor step, in float32."""
    peak_lr: float
    warmup_steps: int
    total_steps: int
    min_lr: float = 0.0

    def __call__(self, step: torch.Tensor) -> torch.Tensor:
        t = step.to(torch.float32)
        warm = self.peak_lr * (t + 1.0) / max(self.warmup_steps, 1)
        frac = torch.clamp((t - self.warmup_steps) / max(
            self.total_steps - self.warmup_steps, 1), 0.0, 1.0)
        cos = self.min_lr + 0.5 * (self.peak_lr - self.min_lr) * (
            1.0 + torch.cos(math.pi * frac))
        return torch.where(t < self.warmup_steps, warm, cos)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_lr: float = 0.0) -> WarmupCosine:
    return WarmupCosine(peak_lr, warmup_steps, total_steps, min_lr)


@dataclass(frozen=True)
class ConstantWithWarmup:
    """Linear warmup to ``peak_lr``, constant after."""
    peak_lr: float
    warmup_steps: int

    def __call__(self, step: torch.Tensor) -> torch.Tensor:
        t = step.to(torch.float32)
        return torch.clamp(self.peak_lr * (t + 1.0) /
                           max(self.warmup_steps, 1), max=self.peak_lr)


def constant_with_warmup(peak_lr: float,
                         warmup_steps: int) -> ConstantWithWarmup:
    return ConstantWithWarmup(peak_lr, warmup_steps)


@dataclass(frozen=True)
class Scheduled(Optimizer):
    """``opt`` with the LR of ``schedule(step)``: the state is ``(inner,
    count)`` with its own int32 step counter, and the trainer's ``lr`` is
    superseded."""
    opt: Optimizer
    schedule: Callable

    @property
    def name(self) -> str:
        return f"scheduled({self.opt.name})"

    def init(self, params):
        dev = leaves(params)[0].device
        return (self.opt.init(params),
                torch.zeros((), dtype=torch.int32, device=dev))

    def update(self, grads, state, params, lr, mesh=None):
        inner, count = state
        params, inner = self.opt.update(grads, inner, params,
                                        self.schedule(count), mesh=mesh)
        return params, (inner, count + 1)


def scheduled(opt: Optimizer, schedule) -> Optimizer:
    return Scheduled(opt, schedule)


OPTIMIZERS = {
    "sgd": sgd_optimizer,
    "momentum": momentum,
    "adam": adam,
    "adamw": adamw,
}
