"""Sampling for the decode engine, as in the JAX package's
``decode/sampling.py``: temperature, top-k and top-p (nucleus)
truncation, then a Gumbel-max draw (an exact sample of the truncated
softmax); ``temperature == 0`` is greedy argmax, first maximum on ties.

The noise of a row comes from a generator keyed only on ``(engine seed,
uid, position)``, where ``position`` is the global index of the token
being generated. A sequence's continuation is therefore a function of
``(seed, uid, its own tokens)`` alone, never of the slot it landed in or
its neighbours, so continuous batching stays token-identical to decoding
the sequence alone. The draws are not ``jax.random``'s: a test that holds
the port against the JAX engine hands JAX's Gumbel draws in through
``noise_fn``.
"""

from __future__ import annotations

import torch

# the engine's sampling domain (the JAX package's _BASE_KEY)
_BASE_KEY = 0x5A3D
_MASK64 = (1 << 64) - 1


def check_sampling(temperature: float, top_k: int, top_p: float,
                   vocab: int) -> None:
    """``temperature == 0`` is greedy; ``top_k == 0`` / ``top_p == 0``
    disable those truncations."""
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0 (0 = greedy), got "
                         f"{temperature}")
    if top_k < 0 or top_k > vocab:
        raise ValueError(f"top_k={top_k} outside [0, vocab={vocab}]")
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p={top_p} outside [0, 1]")
    if temperature == 0 and (top_k or top_p):
        raise ValueError("top_k/top_p require temperature > 0 "
                         "(greedy ignores them)")


def _nucleus_mask(z: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep the smallest descending-probability prefix whose mass reaches
    ``top_p`` (the crossing token is kept, so the argmax always
    survives); ``z [S, V]`` -> ``z`` with -inf outside."""
    order = torch.argsort(-z, dim=-1, stable=True)
    probs = torch.softmax(z, dim=-1)
    sorted_p = torch.gather(probs, -1, order)
    before = torch.cumsum(sorted_p, dim=-1) - sorted_p
    keep = torch.zeros_like(z, dtype=torch.bool).scatter(
        -1, order, before < top_p)
    return torch.where(keep, z, torch.full_like(z, float("-inf")))


def _mix(x: int) -> int:
    """splitmix64 finalizer: a well-spread 64-bit key from ``x``."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def row_key(seed: int, uid: int, position: int) -> int:
    """The generator seed of one row: a hash of ``(seed, uid, position)``
    and nothing else."""
    k = _mix(_BASE_KEY ^ _mix(seed))
    k = _mix(k ^ _mix(uid))
    return _mix(k ^ _mix(position)) >> 1     # manual_seed takes < 2**63


def gumbel_noise(seed: int, uids, positions, vocab: int,
                 device) -> torch.Tensor:
    """``[S, V]`` f32 Gumbel draws, row ``i`` from a generator seeded with
    ``row_key(seed, uids[i], positions[i])`` on ``device``."""
    dev = torch.device(device)
    rows = []
    for uid, pos in zip(uids, positions):
        g = torch.Generator(device=dev)
        g.manual_seed(row_key(seed, int(uid), int(pos)))
        u = torch.rand(vocab, generator=g, dtype=torch.float32, device=dev)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        rows.append(-torch.log(-torch.log(u)))
    return torch.stack(rows)


def make_pick(temperature: float, top_k: int, top_p: float, vocab: int,
              seed: int, noise_fn=None):
    """Build ``pick(logits [S, V], uids [S], positions [S]) -> [S]`` int64.
    ``uids``/``positions`` are host sequences of ints. ``noise_fn(uids,
    positions, vocab) -> [S, V]`` replaces the Gumbel draws (a test hands
    in JAX's own); by default they come from ``gumbel_noise``."""
    check_sampling(temperature, top_k, top_p, vocab)
    if temperature == 0:
        return lambda z, uids, positions: torch.argmax(z, dim=-1)

    def pick(logits, uids, positions):
        z = logits.to(torch.float32) / temperature
        if top_k:
            kth = torch.topk(z, top_k, dim=-1).values[:, -1:]
            z = torch.where(z < kth, torch.full_like(z, float("-inf")), z)
        if top_p:
            z = _nucleus_mask(z, top_p)
        if noise_fn is None:
            g = gumbel_noise(seed, uids, positions, vocab, z.device)
        else:
            g = torch.as_tensor(noise_fn(uids, positions, vocab),
                                dtype=torch.float32, device=z.device)
        # -inf + gumbel stays -inf: truncated tokens never win
        return torch.argmax(z + g, dim=-1)

    return pick
