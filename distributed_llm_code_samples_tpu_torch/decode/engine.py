"""Decode engine: paged KV and continuous batching, as in the JAX
package's ``decode/engine.py`` (the core of ``DecodeEngine``).

- **Paged KV** (``decode/paged.py``): one block pool for every sequence;
  a finished sequence frees its blocks with a host-side table edit.
- **Continuous batching**: a host scheduler admits queued prompts into
  free slots between steps, first come first served, reserving each
  request's whole block budget at admission.
- **Buckets**: decode runs at a power-of-two slot count and prefill at a
  power-of-two chunk size; pad rows point at the scratch block with
  length, token and uid 0.
- **Chunked prefill**: a long prompt enters one chunk per engine step
  (``chunk_attn`` over the gathered cache), so it never stalls the
  running decodes for more than a chunk.
- **Decode attention** (``EngineConfig.kernel``): ``"fused"``, the
  default here, reads the pool through the paged decode-attention kernel
  (``ops/paged_attention.py``; the CUDA kernel on the card, its plain
  version on the CPU). ``"gather"`` gathers each slot's blocks and runs
  ``decode_attn``, the oracle path. The JAX engine's default is
  ``"gather"``; on the card the plain path must not be the main path.
- **Sampling** (``decode/sampling.py``): keyed on ``(seed, uid,
  position)``, so a sequence's tokens never depend on its batch.
- **Guardrail**: each step checks every row's logits are finite; a
  non-finite row fails that request (reason ``nonfinite_logits``, no
  retry) and scrubs its blocks, leaving every other sequence untouched.

PyTorch runs eagerly: each step is a sequence of launches, and there is
no compiled-program cache. The pool is updated in place. Left out of
this port (a non-default value of their ``EngineConfig`` fields raises
``NotImplementedError``): speculative decoding, the prefix cache, the
spill tier, sub-block sharing; and, with no field here, preemption,
deadlines, queue limits, QoS, telemetry, tracing, snapshots, weight
hot-swap, KV handoff and tensor parallelism.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.attention import chunk_attn, rope
from ..models.lm import LMParams, decode_attn
from ..ops.norm import layernorm
from ..runtime.guardrails import rows_finite
from .paged import (SCRATCH_BLOCK, PagedKV, fused_decode_attn, gather_layer,
                    init_pool, scrub_blocks, write_chunk, write_rows)
from .sampling import check_sampling, make_pick


def blocks_needed(prompt_len: int, max_new: int, block_size: int) -> int:
    """Full block reservation of one request: the last generated token
    is returned, never cached, so ``prompt_len + max_new - 1`` positions
    round up to blocks."""
    return -(-(prompt_len + max_new - 1) // block_size)


def _buckets(limit: int) -> tuple[int, ...]:
    """Power-of-two sizes below ``limit``, then ``limit`` itself."""
    out = []
    b = 1
    while b < limit:
        out.append(b)
        b *= 2
    out.append(limit)
    return tuple(out)


def _bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


# fields of the JAX EngineConfig this port does not implement, with the
# only value it accepts for each
_NOT_PORTED = {"speculate": 0, "prefix_cache": False, "spill_blocks": 0,
               "spill_restore_per_step": 2, "spill_low_water": 0,
               "prefix_partial": False}


@dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration, with the JAX field names.
    ``block_size`` and ``prefill_chunk`` are powers of two (so a chunk
    never straddles a block); ``n_blocks`` includes the scratch block;
    ``temperature=0`` is greedy and ``top_k=0`` / ``top_p=0`` disable
    those truncations. ``kernel`` is ``"fused"`` (default) or
    ``"gather"``. The fields in ``_NOT_PORTED`` accept only their
    default; ``prefix_cache`` defaults to False here (True in JAX)."""
    block_size: int = 16
    n_blocks: int = 65
    max_slots: int = 4
    max_blocks_per_seq: int = 8
    prefill_chunk: int = 16
    kv_dtype: str = "f32"
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    seed: int = 0
    use_rope: bool = False
    speculate: int = 0
    kernel: str = "fused"
    prefix_cache: bool = False
    spill_blocks: int = 0
    spill_restore_per_step: int = 2
    spill_low_water: int = 0
    prefix_partial: bool = False

    @property
    def capacity(self) -> int:
        """Max cached positions per sequence."""
        return self.max_blocks_per_seq * self.block_size


@dataclass
class _Seq:
    """Host-side record of one request."""
    uid: int
    prompt: list[int]
    max_new: int
    out: list[int] = field(default_factory=list)
    prefilled: int = 0
    blocks: list[int] = field(default_factory=list)

    @property
    def prompt_done(self) -> bool:
        return self.prefilled >= len(self.prompt)

    @property
    def finished(self) -> bool:
        return len(self.out) >= self.max_new


class DecodeEngine:
    """The serving loop. ``submit()`` queues prompts; ``step()`` runs one
    scheduler iteration (admit -> at most one prefill chunk -> one decode
    dispatch over every ready slot); ``run()`` drains everything and
    returns ``{uid: prompt + generated tokens}``. Runs on the device of
    ``params``. ``noise_fn`` is handed to ``make_pick`` (tests pass JAX's
    Gumbel draws)."""

    def __init__(self, params: LMParams, n_heads: int,
                 config: EngineConfig | None = None, noise_fn=None):
        cfg = config or EngineConfig()
        for name, ok in _NOT_PORTED.items():
            if getattr(cfg, name) != ok:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(cfg, name)!r} is not "
                    f"ported (only {ok!r})")
        if cfg.block_size < 1 or cfg.block_size & (cfg.block_size - 1):
            raise ValueError(f"block_size must be a power of two, got "
                             f"{cfg.block_size}")
        if cfg.max_slots < 1 or cfg.max_blocks_per_seq < 1:
            raise ValueError("max_slots and max_blocks_per_seq must be "
                             ">= 1")
        if cfg.prefill_chunk < 1 or (cfg.prefill_chunk
                                     & (cfg.prefill_chunk - 1)):
            raise ValueError(f"prefill_chunk must be a power of two >= 1, "
                             f"got {cfg.prefill_chunk}")
        if cfg.kernel not in ("gather", "fused"):
            raise ValueError(f"kernel must be 'gather' or 'fused', got "
                             f"{cfg.kernel!r}")
        check_sampling(cfg.temperature, cfg.top_k, cfg.top_p, params.vocab)
        self.params = params
        self.n_heads = n_heads
        self.cfg = cfg
        self.device = params.device
        self.dh = params.d_model // n_heads
        self.kv_heads = params.blocks.wk.shape[1] // self.dh
        self.pool: PagedKV = init_pool(params.n_layers, cfg.n_blocks,
                                       self.kv_heads, cfg.block_size,
                                       self.dh, cfg.kv_dtype, self.device)
        self.pick = make_pick(cfg.temperature, cfg.top_k, cfg.top_p,
                              params.vocab, cfg.seed, noise_fn)
        s, mb = cfg.max_slots, cfg.max_blocks_per_seq
        self.tables = np.full((s, mb), SCRATCH_BLOCK, np.int32)
        self.lengths = np.zeros((s,), np.int32)
        self.next_token = np.zeros((s,), np.int32)
        self.uids = np.zeros((s,), np.int32)
        self.slots: list[_Seq | None] = [None] * s
        self.waiting: collections.deque[_Seq] = collections.deque()
        self.finished: dict[int, list[int]] = {}
        self.failed: dict[int, dict] = {}
        self.prompt_lens: dict[int, int] = {}
        self.free_blocks = list(range(1, cfg.n_blocks))
        self.slot_buckets = _buckets(cfg.max_slots)
        self.chunk_buckets = _buckets(cfg.prefill_chunk)
        self.steps = 0
        self.tokens_generated = 0
        self.prefill_dispatches = 0
        self.decode_dispatches = 0
        self._occ_sum = 0.0
        self._next_uid = 0

    # -- requests --------------------------------------------------------

    def submit(self, prompt, max_new: int, uid: int | None = None) -> int:
        """Queue one request; an impossible one fails here, never
        mid-serve."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if any(not 0 <= t < self.params.vocab for t in prompt):
            raise ValueError("prompt token out of vocab range")
        cached = len(prompt) + max_new - 1
        if cached > self.cfg.capacity:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new} needs {cached} "
                f"cached positions, exceeding the per-sequence cache "
                f"capacity {self.cfg.capacity} (max_blocks_per_seq * "
                "block_size)")
        if cached > self.params.max_seq_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new} needs {cached} "
                f"cached positions, exceeding max_seq_len "
                f"{self.params.max_seq_len}")
        if (blocks_needed(len(prompt), max_new, self.cfg.block_size)
                > self.cfg.n_blocks - 1):
            raise ValueError("request needs more blocks than the pool "
                             f"holds ({self.cfg.n_blocks - 1} usable)")
        if uid is None:
            uid = self._next_uid
        elif uid < 0:
            raise ValueError(f"uid must be >= 0, got {uid}")
        elif (uid in self.finished or uid in self.failed
              or any(s is not None and s.uid == uid for s in self.slots)
              or any(s.uid == uid for s in self.waiting)):
            raise ValueError(f"uid {uid} already in use")
        self._next_uid = max(self._next_uid, uid) + 1
        self.prompt_lens[uid] = len(prompt)
        self.waiting.append(_Seq(uid=uid, prompt=prompt, max_new=max_new))
        return uid

    def _admit(self) -> int:
        """FCFS admission while both a free slot and the head request's
        whole block reservation are available; a head that does not fit
        blocks the queue."""
        admitted = 0
        while self.waiting:
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                break
            seq = self.waiting[0]
            need = blocks_needed(len(seq.prompt), seq.max_new,
                                 self.cfg.block_size)
            if need > len(self.free_blocks):
                break
            self.waiting.popleft()
            slot = free_slots[0]
            seq.blocks = [self.free_blocks.pop(0) for _ in range(need)]
            row = np.full((self.cfg.max_blocks_per_seq,), SCRATCH_BLOCK,
                          np.int32)
            row[:need] = seq.blocks
            self.tables[slot] = row
            self.lengths[slot] = 0
            self.uids[slot] = seq.uid
            self.slots[slot] = seq
            admitted += 1
        return admitted

    def _evict(self, slot: int, scrub: bool = False) -> _Seq:
        seq = self.slots[slot]
        if scrub:
            # a non-finite run may have left NaN in its blocks and in
            # the scratch block every pad row and table tail points at
            scrub_blocks(self.pool, seq.blocks + [SCRATCH_BLOCK])
        self.free_blocks.extend(seq.blocks)
        seq.blocks = []
        self.tables[slot] = SCRATCH_BLOCK
        self.lengths[slot] = 0
        self.next_token[slot] = 0
        self.uids[slot] = 0
        self.slots[slot] = None
        return seq

    def _release(self, slot: int) -> None:
        seq = self.slots[slot]
        self.finished[seq.uid] = seq.prompt + seq.out
        self._evict(slot)

    def _quarantine(self, slot: int, reason: str) -> None:
        seq = self._evict(slot, scrub=True)
        self.failed[seq.uid] = {"reason": reason, "retries": 0,
                                "n_out": len(seq.out)}

    def _emit(self, slot: int, pick: int) -> None:
        seq = self.slots[slot]
        seq.out.append(pick)
        self.tokens_generated += 1
        self.next_token[slot] = pick
        if seq.finished:
            self._release(slot)

    # -- the forward -----------------------------------------------------

    def _attn_qkv(self, l: int, a, positions):
        blk = self.params.blocks
        dh = self.dh
        q = (a @ blk.wq[l].T).reshape(a.shape[0], -1, dh)
        k = (a @ blk.wk[l].T).reshape(a.shape[0], -1, dh)
        v = (a @ blk.wv[l].T).reshape(a.shape[0], -1, dh)
        if self.cfg.use_rope:
            pos = positions[:, None, None]
            q = rope(q[:, :, None, :], pos)[:, :, 0, :]
            k = rope(k[:, :, None, :], pos)[:, :, 0, :]
        return q, k, v

    def _trunk(self, x, positions, write_attn):
        """The per-layer forward prefill and decode share: LN, q/k/v, the
        caller's ``write_attn(l, q, k, v) -> y [N, H, dh]`` (cache write
        and attention, the one step where the two differ), output
        projection, FFN."""
        blk = self.params.blocks
        n = x.shape[0]
        for l in range(self.params.n_layers):
            a = layernorm(blk.ln1[l], x)
            q, k, v = self._attn_qkv(l, a, positions)
            y = write_attn(l, q, k, v)
            x = x + y.reshape(n, -1) @ blk.wo[l].T
            h = layernorm(blk.ln2[l], x)
            x = x + torch.relu(h @ blk.w1[l].T) @ blk.w2[l].T
        return x

    def _logits(self, h):
        return h @ self.params.wte.T

    def _cached_attn(self, l: int, q, tables, n_attend):
        """Single-query attention over the block tables: the paged
        kernel (``fused``) or gather + ``decode_attn`` (``gather``)."""
        if self.cfg.kernel == "fused":
            return fused_decode_attn(self.pool, l, q, tables, n_attend)
        views = [gather_layer(self.pool, l, t) for t in tables]
        ck = torch.stack([k for k, _ in views])
        cv = torch.stack([v for _, v in views])
        return decode_attn(q, ck, cv, n_attend)

    def _tensor(self, a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    @torch.no_grad()
    def _prefill_step(self, slot: int) -> None:
        seq = self.slots[slot]
        remaining = len(seq.prompt) - seq.prefilled
        # largest power-of-two bucket that fits: chunk starts stay
        # multiples of the chunk, so no chunk straddles a block
        c = max(b for b in self.chunk_buckets if b <= remaining)
        pos0 = seq.prefilled
        self.prefill_dispatches += 1
        p = self.params
        table = self._tensor(self.tables[slot], torch.int32)
        positions = self._tensor(np.arange(pos0, pos0 + c))
        tokens = self._tensor(seq.prompt[pos0:pos0 + c])
        x = p.wte[tokens] + p.wpe[positions]

        def write_attn(l, q, k, v):
            write_chunk(self.pool, l, table, pos0, k, v, self.cfg.kv_dtype)
            ck, cv = gather_layer(self.pool, l, table)
            return chunk_attn(q.transpose(0, 1), ck, cv, pos0).transpose(0, 1)

        x = self._trunk(x, positions, write_attn)
        logits = self._logits(layernorm(p.ln_f, x[-1:]))
        nxt = self.pick(logits, [seq.uid], [pos0 + c])
        nxt, ok = torch.stack([nxt[0], rows_finite(logits)[0].long()]).tolist()
        if not ok:
            self._quarantine(slot, "nonfinite_logits")
            return
        seq.prefilled += c
        if seq.prompt_done:
            self.lengths[slot] = len(seq.prompt)
            self._emit(slot, int(nxt))

    def _marshal(self, ready: list[int]):
        """Bucket-pad the decode operands: pad rows point at the scratch
        block with zeroed length, token and uid."""
        b = _bucket_for(len(ready), self.slot_buckets)
        idx = ready + [0] * (b - len(ready))
        tables = self.tables[idx].copy()
        lengths = self.lengths[idx].copy()
        tokens = self.next_token[idx].copy()
        uids = self.uids[idx].copy()
        tables[len(ready):] = SCRATCH_BLOCK
        lengths[len(ready):] = 0
        tokens[len(ready):] = 0
        uids[len(ready):] = 0
        return b, tables, lengths, tokens, uids

    @torch.no_grad()
    def _decode_dispatch(self, ready: list[int]) -> None:
        bs = self.cfg.block_size
        b, tables, lengths, tokens, uids = self._marshal(ready)
        self.decode_dispatches += 1
        p = self.params
        phys = tables[np.arange(b), lengths // bs]
        tables_t = self._tensor(tables, torch.int32)
        pos_t = self._tensor(lengths)
        n_attend = self._tensor(lengths + 1, torch.int32)
        phys_t = self._tensor(phys)
        off_t = self._tensor(lengths % bs)
        x = p.wte[self._tensor(tokens)] + p.wpe[pos_t]

        def write_attn(l, q, k, v):
            write_rows(self.pool, l, phys_t, off_t, k, v, self.cfg.kv_dtype)
            return self._cached_attn(l, q, tables_t, n_attend)

        x = self._trunk(x, pos_t, write_attn)
        logits = self._logits(layernorm(p.ln_f, x))
        picks = self.pick(logits, uids.tolist(), (lengths + 1).tolist())
        out = torch.stack([picks, rows_finite(logits).long()]).cpu().numpy()
        for j, slot in enumerate(ready):
            if not out[1, j]:        # pad rows are never in `ready`
                self._quarantine(slot, "nonfinite_logits")
                continue
            self.lengths[slot] += 1
            self._emit(slot, int(out[0, j]))

    # -- the loop ----------------------------------------------------------

    def step(self) -> bool:
        """One scheduler iteration: admit, at most one prefill chunk, then
        one decode dispatch over every ready slot. Returns whether any
        work ran."""
        self._admit()
        did = False
        pre = next((i for i, s in enumerate(self.slots)
                    if s is not None and not s.prompt_done), None)
        if pre is not None:
            self._prefill_step(pre)
            did = True
        ready = [i for i, s in enumerate(self.slots)
                 if s is not None and s.prompt_done]
        if ready:
            self._decode_dispatch(ready)
            did = True
        if did:
            self.steps += 1
            self._occ_sum += self.active / self.cfg.max_slots
        return did

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def mean_occupancy(self) -> float:
        return self._occ_sum / self.steps if self.steps else 0.0

    def run(self) -> dict[int, list[int]]:
        """Step until every submitted request finished or failed."""
        while self.waiting or self.active:
            if not self.step():
                raise RuntimeError("decode engine stalled: waiting "
                                   "requests but no admissible work")
        return dict(self.finished)
