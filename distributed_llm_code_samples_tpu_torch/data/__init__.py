"""Seeds-as-dataset data layer, as in the JAX package's ``data/``.

Each training step is defined by one integer seed; a step's
``(x, dloss_dx)`` is a pure function of it. The seed schedule is drawn
with numpy exactly as the JAX package draws it, so both packages walk
the same seeds. The batches themselves come from a ``torch.Generator``
and differ from JAX's threefry draws: the tests hand JAX's batches to
the port through ``train_single(batch_fn=...)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import DLOSS_DX_COEF

# In-graph fault-injection flags carried on the seed (the JAX package's
# runtime/chaos.py sets them): the same x as the base seed, a NaN/Inf
# upstream gradient. Schedule seeds live in [0, 100_000), so bits 28/29
# are always free.
POISON_NAN_BIT = 1 << 29
POISON_INF_BIT = 1 << 28
_POISON_MASK = POISON_NAN_BIT | POISON_INF_BIT


def strip_poison(seed) -> int:
    """The underlying schedule seed, poison flags cleared."""
    return int(seed) & ~_POISON_MASK


def batch_from_seed(seed, batch_size: int, model_size: int, *,
                    dtype=torch.float32, device="cpu"):
    """One step's ``(x, dloss_dx)`` from its integer seed.

    ``x = normal([batch, d])`` and the mocked loss gradient
    ``dloss_dx = 0.1 * normal([batch, d])`` (``train_ffns.py:149-150``),
    drawn in that order from a ``torch.Generator`` on ``device`` seeded
    with the stripped seed. The result is a pure function of (stripped
    seed, device type); its numbers differ from the JAX package's
    (threefry) and between the CPU and CUDA generators.

    A seed with ``POISON_NAN_BIT``/``POISON_INF_BIT`` gives the same ``x``
    as its base seed and a NaN/Inf ``dloss_dx`` (Inf wins if both)."""
    seed = int(seed)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(strip_poison(seed))
    x = torch.randn(batch_size, model_size, generator=gen, device=device)
    dloss_dx = DLOSS_DX_COEF * torch.randn(batch_size, model_size,
                                           generator=gen, device=device)
    if seed & POISON_NAN_BIT:
        dloss_dx.fill_(float("nan"))
    if seed & POISON_INF_BIT:
        dloss_dx.fill_(float("inf"))
    return x.to(dtype), dloss_dx.to(dtype)


def mock_data(seeds, batch_size: int, model_size: int, *,
              dtype=torch.float32, device="cpu"):
    """Generator of ``batch_from_seed`` over a seed schedule, the
    host-side analogue of the reference's ``mock_data``
    (``train_ffns.py:144-151``)."""
    for seed in np.asarray(seeds).tolist():
        yield batch_from_seed(seed, batch_size, model_size, dtype=dtype,
                              device=device)


def lm_batch_from_seed(seed, batch: int, seq_len: int, vocab: int, *,
                       device="cpu"):
    """One LM step's ``(tokens, targets)`` from its integer seed: a
    ``[batch, seq_len + 1]`` uniform token draw from a ``torch.Generator``
    on ``device`` seeded with the stripped seed, split next-token style
    (``targets`` is ``tokens`` shifted left by one). int64. Its numbers
    differ from the JAX package's draws: the tests hand JAX's batches to
    ``train_lm_single(batch_fn=...)``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(strip_poison(seed))
    toks = torch.randint(0, vocab, (batch, seq_len + 1), generator=gen,
                         device=device)
    return toks[:, :-1], toks[:, 1:]


_CORPUS = None


def load_text_corpus() -> np.ndarray:
    """The embedded real-text corpus as a ``uint8`` byte array, the port's
    own copy of the JAX package's ``data_assets/corpus.txt`` (about 237 KB
    of English prose: the license texts of a Debian image, freely
    redistributable). Byte-level vocabulary (256): every byte is a
    token."""
    global _CORPUS
    if _CORPUS is None:
        import os
        path = os.path.join(os.path.dirname(__file__), "..", "data_assets",
                            "corpus.txt")
        with open(path, "rb") as f:
            _CORPUS = np.frombuffer(f.read(), dtype=np.uint8)
    return _CORPUS


def text_batch_from_seed(seed, batch: int, seq_len: int, corpus=None):
    """One real-text LM step from its integer seed: ``batch`` windows of
    ``seq_len + 1`` bytes of the corpus, split next-token style like
    ``lm_batch_from_seed`` (int64 ``tokens, targets [batch, seq_len]`` on
    the CPU). The window starts come from a ``torch.Generator`` seeded
    with the seed, in ``[0, len - seq_len)`` as JAX's bound (the last
    window ends on the corpus's final byte); their numbers differ from
    JAX's draws, and the tests hand JAX's windows across through
    ``TokenTable``. ``corpus`` defaults to the embedded one."""
    data = np.asarray(load_text_corpus() if corpus is None else corpus)
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    starts = torch.randint(0, data.shape[0] - seq_len, (batch,),
                           generator=gen).numpy()
    seqs = torch.from_numpy(data[starts[:, None] + np.arange(seq_len + 1)]
                            .astype(np.int64))
    return seqs[:, :-1], seqs[:, 1:]


def make_seed_schedule(num_steps: int, random_seed: int = 0) -> np.ndarray:
    """``num_steps`` int32 seeds in ``[0, 100_000)`` (``train_ffns.py:360``),
    bit for bit the JAX package's schedule: ``random_seed != 0`` seeds
    numpy's ``default_rng``, ``0`` draws from OS entropy."""
    rng = (np.random.default_rng(random_seed) if random_seed != 0
           else np.random.default_rng())
    return rng.integers(0, 100_000, size=(num_steps,)).astype(np.int32)


def shard_seeds_strided(seeds, n_ranks: int) -> np.ndarray:
    """Strided seed split, ``[steps_per_rank, n_ranks]``: column ``r`` is
    rank ``r``'s schedule, and rank ``r``'s step ``t`` takes global seed
    ``seeds[t * n_ranks + r]`` (``train_ffns.py:182``), as the JAX
    package's ``shard_seeds_strided``. A schedule that does not split
    evenly raises (``train_ffns.py:175``)."""
    seeds = np.asarray(seeds)
    if seeds.shape[0] % n_ranks != 0:
        raise ValueError(
            f"num_steps={seeds.shape[0]} not divisible by n_ranks={n_ranks} "
            "(reference asserts the same, train_ffns.py:175)")
    return seeds.reshape(-1, n_ranks)


class BatchTable:
    """A ``batch_fn`` over batches made elsewhere: ``{seed: (x, dloss_dx)}``
    of numpy arrays, handed out as tensors of the asked type on the asked
    device. It pickles, so spawned ranks can take it (the tests hand the
    JAX package's batches to the port's multi-rank trainers with it)."""

    def __init__(self, batches):
        self.batches = {int(k): (np.asarray(x), np.asarray(d))
                        for k, (x, d) in dict(batches).items()}

    def __call__(self, seed, batch_size: int, model_size: int, *,
                 dtype=torch.float32, device="cpu"):
        x, d = self.batches[int(seed)]
        if x.shape != (batch_size, model_size):
            raise ValueError(f"seed {int(seed)}'s batch is {x.shape}, not "
                             f"{(batch_size, model_size)}")
        return (torch.from_numpy(x).to(device, dtype),
                torch.from_numpy(d).to(device, dtype))


class TokenTable:
    """An LM ``batch_fn`` over batches made elsewhere: ``{seed: (tokens,
    targets)}`` of integer numpy arrays, handed out as int64 tensors on
    the CPU (the trainer moves them). It pickles, so spawned ranks can
    take it, as ``BatchTable`` does for the FFN trainers."""

    def __init__(self, batches):
        self.batches = {int(k): (np.array(t), np.array(g))
                        for k, (t, g) in dict(batches).items()}

    def __call__(self, seed):
        t, g = self.batches[int(seed)]
        return (torch.from_numpy(t).long(), torch.from_numpy(g).long())
