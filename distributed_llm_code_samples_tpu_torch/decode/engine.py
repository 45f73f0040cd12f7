"""Decode engine: paged KV and continuous batching, as in the JAX
package's ``decode/engine.py``.

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
- **Radix prefix cache** (``decode/prefix.py``, ``prefix_cache``, on by
  default as in JAX): every fully prefilled full prompt block enters a
  host-side radix tree; admission maps each cached block of a new prompt
  into its table (refcounted) and starts its prefill past them. A hit
  block holds the bytes the sequence's own prefill would have written,
  and at least one prompt token always prefills, so shared output equals
  unshared output at every ``kv_dtype``. ``prefix_partial`` also shares
  part of a block: the donor's leading rows are copied into a private
  block (``paged.copy_block_rows``) and the prefill starts mid-block.
- **Copy-on-write**: a shared block is read-only. No scheduler write
  aims at one (hits cover only fully prefilled prompt blocks), and
  ``_cow_private`` enforces it with a bit-identical private copy
  (``paged.copy_block``) before any write window that would touch one;
  ``cow_copies`` counts them (0 in steady state). The copy is queued on
  the stream the next dispatch reads on.
- **Guardrail and quarantine**: each step checks every row's logits are
  finite; a non-finite row quarantines its request (reason
  ``nonfinite_logits``): private blocks scrubbed, shared blocks only
  released while sharers remain, every other sequence untouched. With
  ``ServePolicy.max_retries`` left the request is replayed, else it
  fails.
- **Replay**: a preempted or retried request re-prefills its prompt and
  then teacher-forces its recorded tokens through the decode dispatch
  (``_Seq.emitted``), so its KV write history, int8 requant included, is
  the uninterrupted run's.
- **ServePolicy**: a bounded queue (``AdmissionError``), per-request
  deadlines counted from the original submission, quarantine retries,
  and pool-pressure preemption of the youngest resident (never the last
  one). Each step's one prefill chunk goes to the OLDEST resident with an
  unfinished prompt (smallest ``admit_index``), so the oldest resident
  always progresses and preemption cannot livelock.
- **Speculative decoding** (``speculate=k``, greedy only): every decode
  dispatch is a verify dispatch of ``k + 1`` single-query sub-steps over
  the trunk. Sub-step 0 feeds each slot's pending token, sub-step ``i``
  the ``i``-th draft (``decode/draft.py``; during replay the recorded
  tokens). The acceptance chain stays on the device: a row stays alive
  while its drafts equal the previous picks, and a dead row's KV write
  goes to the scratch block, so the pool's write history is the plain
  engine's at every ``kv_dtype``. One read-back after the loop gives the
  picks, the accepted counts and the finite flags; a slot emits ``1 +
  accepted`` tokens.
- **Spill tier** (``spill_blocks``, ``decode/spill.py``): pool pressure
  demotes refs-0 cached blocks to host RAM (one CRC-checked wire
  document each) instead of discarding them; a hit on a spilled edge
  restores it into a fresh block (at most ``spill_restore_per_step`` a
  step; the admission waits for the rest). A restore that fails its CRC
  quarantines the request that asked for it (reason ``corrupt_spill``).

PyTorch runs eagerly: each step is a sequence of launches, and there is
no compiled-program cache. The pool is updated in place. Left out of
this port, with no field here: QoS, telemetry, tracing, snapshots,
weight hot-swap, KV handoff and tensor parallelism.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.attention import chunk_attn, rope
from ..models.lm import LMParams, decode_attn
from ..ops.norm import layernorm
from ..runtime.guardrails import rows_finite
from ..runtime import wire
from .draft import draft_tokens
from .paged import (SCRATCH_BLOCK, PagedKV, copy_block, copy_block_rows,
                    extract_blocks, fused_decode_attn, gather_layer,
                    implant_block, init_pool, scrub_blocks, write_chunk,
                    write_rows)
from .paged import corrupt_block as _pool_corrupt_block
from .prefix import PrefixCache
from .sampling import check_sampling, check_speculation, make_pick
from .spill import SpillTier

# the poison operand of ``arm_poison``: no row, or every row
POISON_NONE = -1
POISON_ALL = -2


class AdmissionError(RuntimeError):
    """A request was shed at submit time (the bounded queue is full): the
    serving 503, distinct from the ``ValueError`` of a malformed request.
    ``reason`` names the cause."""

    def __init__(self, msg: str, reason: str = "queue_full"):
        super().__init__(msg)
        self.reason = reason


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


@dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration, with the JAX field names and
    defaults but ``kernel``. ``block_size`` and ``prefill_chunk`` are
    powers of two (so a chunk never straddles a block); ``n_blocks``
    includes the scratch block; ``temperature=0`` is greedy and
    ``top_k=0`` / ``top_p=0`` disable those truncations. ``kernel`` is
    ``"fused"`` (default) or ``"gather"``. ``prefix_cache`` turns on the
    radix prefix cache and ``prefix_partial`` (which needs it) sub-block
    sharing. ``speculate`` drafts that many tokens a decode step (greedy
    only). ``spill_blocks`` arms the host tier of that many blocks (needs
    the prefix cache), ``spill_restore_per_step`` bounds its restores a
    step and ``spill_low_water`` demotes at the top of a step until that
    many blocks are free (0 = only on demand)."""
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
    prefix_cache: bool = True
    spill_blocks: int = 0
    spill_restore_per_step: int = 2
    spill_low_water: int = 0
    prefix_partial: bool = False

    @property
    def capacity(self) -> int:
        """Max cached positions per sequence."""
        return self.max_blocks_per_seq * self.block_size


@dataclass(frozen=True)
class ServePolicy:
    """Host-side scheduling and reliability settings, as in JAX; all
    zeros (the default) is strict reserve-on-admit FCFS.

    - ``queue_limit``: bounded waiting queue; a submit past it raises
      ``AdmissionError``. 0 = off.
    - ``deadline_steps``: per-request time to live in engine steps from
      the original submit; an unfinished request past it fails with
      reason ``deadline``, waiting or running. 0 = off.
    - ``max_retries``: how often a quarantined request is queued again
      for replay before it is reported failed. 0 = fail at once.
    - ``preempt_after_steps``: when the head of the queue has a free slot
      but not its blocks for this many consecutive steps, the youngest
      running sequence goes back to the queue (replayed later). The
      last running sequence is never evicted. 0 = off."""
    queue_limit: int = 0
    deadline_steps: int = 0
    max_retries: int = 0
    preempt_after_steps: int = 0

    def __post_init__(self):
        for name in ("queue_limit", "deadline_steps", "max_retries",
                     "preempt_after_steps"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, got "
                                 f"{getattr(self, name)}")


@dataclass
class _Seq:
    """Host-side record of one request.

    ``nodes[i]`` is the ``PrefixNode`` backing ``blocks[i]`` while that
    leading block is shared through the radix cache, None when private.
    ``emitted`` counts the ``out`` tokens fed through the decode path
    since the last admission: ``emitted < len(out)`` is the replay state
    after a retry or a preemption, in which the recorded tokens are
    teacher-forced and the fresh picks discarded."""
    uid: int
    prompt: list[int]
    max_new: int
    out: list[int] = field(default_factory=list)
    prefilled: int = 0
    blocks: list[int] = field(default_factory=list)
    nodes: list = field(default_factory=list)
    emitted: int = 0
    retries: int = 0
    submit_step: int = 0
    admit_index: int = -1
    t_submit: float = field(default_factory=time.time)
    t_first: float | None = None

    @property
    def prompt_done(self) -> bool:
        return self.prefilled >= len(self.prompt)

    @property
    def replaying(self) -> bool:
        return self.emitted < len(self.out)

    @property
    def finished(self) -> bool:
        return len(self.out) >= self.max_new and not self.replaying


class DecodeEngine:
    """The serving loop. ``submit()`` queues prompts; ``step()`` runs one
    scheduler iteration (expire deadlines -> admit -> at most one prefill
    chunk -> one decode dispatch over every ready slot); ``run()`` drains
    everything and returns ``{uid: prompt + generated tokens}``. Runs on
    the device of ``params``. ``noise_fn`` is handed to ``make_pick``
    (tests pass JAX's Gumbel draws)."""

    def __init__(self, params: LMParams, n_heads: int,
                 config: EngineConfig | None = None,
                 policy: ServePolicy | None = None, noise_fn=None):
        cfg = config or EngineConfig()
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
        if cfg.spill_blocks < 0:
            raise ValueError(f"spill_blocks must be >= 0, got "
                             f"{cfg.spill_blocks}")
        if cfg.spill_restore_per_step < 1:
            raise ValueError(
                f"spill_restore_per_step must be >= 1, got "
                f"{cfg.spill_restore_per_step} (a zero budget would "
                "starve every admission whose prefix spilled)")
        if cfg.spill_low_water < 0:
            raise ValueError(f"spill_low_water must be >= 0, got "
                             f"{cfg.spill_low_water}")
        if (cfg.spill_blocks > 0 or cfg.prefix_partial) \
                and not cfg.prefix_cache:
            raise ValueError("spill_blocks / prefix_partial extend the "
                             "radix prefix cache; they require "
                             "prefix_cache=True")
        if cfg.kernel not in ("gather", "fused"):
            raise ValueError(f"kernel must be 'gather' or 'fused', got "
                             f"{cfg.kernel!r}")
        check_sampling(cfg.temperature, cfg.top_k, cfg.top_p, params.vocab)
        check_speculation(cfg.speculate, cfg.temperature)
        self.params = params
        self.n_heads = n_heads
        self.cfg = cfg
        self.policy = policy or ServePolicy()
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
        self.spill = (SpillTier(cfg.spill_blocks)
                      if cfg.prefix_cache and cfg.spill_blocks > 0 else None)
        self.prefix = (PrefixCache(cfg.block_size, spill=self.spill)
                       if cfg.prefix_cache else None)
        self.steps = 0
        self.tokens_generated = 0
        self.prefill_dispatches = 0
        self.decode_dispatches = 0
        self._occ_sum = 0.0
        self._next_uid = 0
        # the audit ring of request records (bounded)
        self.request_events: collections.deque[dict] = \
            collections.deque(maxlen=4096)
        self._corrupted: set[int] = set()   # corrupt_block's block ids
        self._poison_uid = POISON_NONE      # armed for the next step only
        self._admit_counter = 0             # admission order
        self._head_blocked = 0              # the head's pool-starved streak
        self._head_blocked_uid: int | None = None   # whose streak it is
        self.quarantined = 0
        self.retried = 0
        self.preempted = 0
        self.rejected = 0
        self.expired = 0
        self.block_allocs = 0
        self.block_frees = 0
        self.block_scrubs = 0
        # the prefix cache's counters: hit blocks mapped at admission,
        # candidate full blocks walked (the hit rate's denominator),
        # prompt tokens the hits skipped, sub-block hits, copy-on-write
        # copies, and the most blocks shared at the end of a step
        self.prefix_hit_blocks = 0
        self.prefix_lookup_blocks = 0
        self.prefill_tokens_saved = 0
        self.partial_hits = 0
        self.cow_copies = 0
        self.shared_blocks_peak = 0
        # speculation: drafted tokens proposed to verify dispatches, and
        # those the verify kept (replayed tokens count in neither)
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        # the spill tier: blocks demoted, their wire bytes, blocks
        # restored, prompt tokens the restores kept off the prefill path,
        # and the host seconds the restores took
        self.spilled_blocks = 0
        self.spill_bytes = 0
        self.restores = 0
        self.restore_tokens_saved = 0
        self.restore_stall_s = 0.0
        # this step's restore budget and restores (reset in step())
        self._restores_left = cfg.spill_restore_per_step
        self._step_restores = 0

    # -- requests --------------------------------------------------------

    def submit(self, prompt, max_new: int, uid: int | None = None) -> int:
        """Queue one request; an impossible one fails here, never
        mid-serve. A full queue sheds it with ``AdmissionError``."""
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
        auto_uid = uid is None
        if auto_uid:
            uid = self._next_uid
        elif uid < 0:
            # negative uids are the poison sentinels
            raise ValueError(f"uid must be >= 0, got {uid}")
        elif (uid in self.finished or uid in self.failed
              or any(s is not None and s.uid == uid for s in self.slots)
              or any(s.uid == uid for s in self.waiting)):
            # a twin would sample in lockstep (the key folds the uid)
            raise ValueError(f"uid {uid} already in use")
        if (self.policy.queue_limit
                and len(self.waiting) >= self.policy.queue_limit):
            # an auto uid is not consumed, so its record carries -1
            self.rejected += 1
            self._event("rejected", -1 if auto_uid else uid,
                        reason="queue_full", queue_len=len(self.waiting))
            raise AdmissionError(
                f"waiting queue full ({len(self.waiting)} >= "
                f"queue_limit {self.policy.queue_limit}); request "
                f"uid {uid} shed")
        self._next_uid = max(self._next_uid, uid) + 1
        self.prompt_lens[uid] = len(prompt)
        self.waiting.append(_Seq(uid=uid, prompt=prompt, max_new=max_new,
                                 submit_step=self.steps))
        return uid

    def _event(self, event: str, uid: int, reason: str | None = None,
               **extra) -> None:
        self.request_events.append({"step": self.steps, "uid": int(uid),
                                    "event": event, "reason": reason,
                                    **extra})

    def arm_poison(self, uid: int) -> None:
        """Test hook: ``uid``'s logits row (every row for ``POISON_ALL``)
        comes out NaN in the next engine step's dispatches, which the
        guardrail then flags."""
        self._poison_uid = int(uid)

    def corrupt_block(self, block: int) -> None:
        """Test hook: poison one physical pool block between steps
        (``paged.corrupt_block``). The block is scrubbed on any later
        release, and a block the radix cache holds is poisoned in the
        tree at once: no new sharer matches it, while its bytes stay
        until the last live sharer releases it."""
        _pool_corrupt_block(self.pool, block)
        self._corrupted.add(int(block))
        if self.prefix is not None:
            node = self.prefix.node_for_block(block)
            if node is not None:
                node.poisoned = True

    def corrupt_spill(self, spill_id: int) -> bool:
        """Test hook: flip one byte of a host-tier entry
        (``SpillTier.corrupt``). The damage shows when a hit restores the
        entry: its CRC check fails, the edge detaches, and the restoring
        request is quarantined (reason ``corrupt_spill``). False when the
        entry is gone or there is no tier."""
        if self.spill is None:
            return False
        return self.spill.corrupt(int(spill_id))

    # -- admission ---------------------------------------------------------

    def _admit(self) -> int:
        """FCFS admission while both a free slot and the head request's
        whole block reservation are available; a head that does not fit
        blocks the queue. With the prefix cache on, the head's cached
        prompt blocks are mapped (locked before any eviction) and only the
        rest draw on the free list, refs-0 cached blocks counting as free.
        With ``preempt_after_steps``, a head starved of blocks for that
        many consecutive steps evicts the youngest running sequence.

        With the spill tier, the matched path splits into a resident
        prefix and a spilled suffix. The suffix draws on the free list
        like misses and is restored first, at most the step's restore
        budget; past it the admission waits for the next step, keeping
        what was restored. A restore that fails its CRC check detaches
        the edge and quarantines the head (``corrupt_spill``)."""
        admitted = 0
        bumped = False
        bs = self.cfg.block_size
        while self.waiting:
            seq = self.waiting[0]
            need = blocks_needed(len(seq.prompt), seq.max_new, bs)
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                break
            hits = [] if self.prefix is None else self.prefix.match(
                seq.prompt)
            n_res = 0
            while n_res < len(hits) and not hits[n_res].spilled:
                n_res += 1
            resident, spilled_sfx = hits[:n_res], hits[n_res:]
            avail = len(self.free_blocks)
            if self.prefix is not None:
                # hit nodes are about to be locked, not evicted
                avail += (self.prefix.evictable_blocks()
                          - sum(1 for n in resident if n.refs == 0))
            if need - n_res > avail:
                pa = self.policy.preempt_after_steps
                if pa > 0:
                    if self._head_blocked_uid != seq.uid:
                        # a new head earns its own streak
                        self._head_blocked = 0
                        self._head_blocked_uid = seq.uid
                    if not bumped:          # one tick a step
                        self._head_blocked += 1
                        bumped = True
                    if (self._head_blocked >= pa
                            and self._preempt_youngest()):
                        continue
                break
            self._head_blocked = 0
            self._head_blocked_uid = None
            if spilled_sfx:
                todo = spilled_sfx[:max(0, self._restores_left)]
                # lock the resident prefix and each restored node, so a
                # demotion the restores force cannot take the path away
                self.prefix.lock(resident, self.steps)
                locked = list(resident)
                corrupt = None
                try:
                    for node in todo:
                        self._restore_node(node)
                        self.prefix.lock([node], self.steps)
                        locked.append(node)
                except wire.WireError:
                    corrupt = todo[len(locked) - n_res]
                finally:
                    for n in locked:
                        self.prefix.release(n, self.steps)
                if corrupt is not None:
                    # the damaged edge and its spilled descendants leave
                    # the tree; the request that would read them is
                    # quarantined before it takes a slot
                    self.free_blocks.extend(
                        self.prefix.detach_subtree(corrupt))
                    self._quarantine_waiting(0, "corrupt_spill")
                    continue
                if len(todo) < len(spilled_sfx):
                    # budget spent: the restored blocks stay cached and
                    # the admission continues next step
                    break
            self.waiting.popleft()
            slot = free_slots[0]
            need_priv = need - len(hits)
            if hits:
                self.prefix.lock(hits, self.steps)
                self.prefix_hit_blocks += len(hits)
                self.prefill_tokens_saved += len(hits) * bs
            if self.prefix is not None:
                self.prefix_lookup_blocks += self.prefix.match_cap(
                    len(seq.prompt))
                if need_priv > len(self.free_blocks):
                    self._reclaim_cached(need_priv - len(self.free_blocks))
            seq.nodes = list(hits)
            seq.blocks = [n.block for n in hits] + [
                self.free_blocks.pop(0) for _ in range(need_priv)]
            # the hit region is prefilled content: the clock starts past it
            seq.prefilled = len(hits) * bs
            if self.cfg.prefix_partial:
                # the donor's first m rows into the first private block
                # (need_priv >= 1: the final-token block is never a hit)
                part = self.prefix.partial_match(seq.prompt, hits)
                if part is not None:
                    donor, m = part
                    copy_block_rows(self.pool, donor.block,
                                    seq.blocks[len(hits)], m)
                    donor.last_use = self.steps
                    seq.prefilled += m
                    self.partial_hits += 1
                    self.prefill_tokens_saved += m
            self.block_allocs += need
            row = np.full((self.cfg.max_blocks_per_seq,), SCRATCH_BLOCK,
                          np.int32)
            row[:need] = seq.blocks
            self.tables[slot] = row
            self.lengths[slot] = 0
            self.uids[slot] = seq.uid
            self.slots[slot] = seq
            seq.admit_index = self._admit_counter
            self._admit_counter += 1
            self._event("admitted", seq.uid,
                        wait_steps=self.steps - seq.submit_step,
                        replay=len(seq.out), prefix_hit_blocks=len(hits))
            admitted += 1
        return admitted

    def _scrub(self, blocks) -> None:
        scrub_blocks(self.pool, blocks)
        self._corrupted.difference_update(blocks)
        self.block_scrubs += len(blocks)

    def _reclaim_cached(self, n: int) -> None:
        """Turn up to ``n`` refs-0 cached blocks back into free blocks
        (LRU leaves); a corrupted one is scrubbed on the way out. With the
        spill tier the same blocks are demoted instead (``_demote``)."""
        if self.spill is not None:
            self._demote(n)
            return
        got = self.prefix.evict_lru(n, self.steps)
        bad = [b for b in got if b in self._corrupted]
        if bad:
            self._scrub(bad)
        self.free_blocks.extend(got)

    def _demote(self, n: int) -> None:
        """Spill up to ``n`` refs-0 cached device leaves to the host tier
        (``prefix.spill_victims``, LRU): each block's bytes leave through
        ``extract_blocks`` as one wire document, the node turns spilled
        and the block joins the free list. A poisoned or corrupted victim
        never spills: it is detached and scrubbed. Entries the tier drops
        for room take their now unrestorable edges out of the tree."""
        for node in self.prefix.spill_victims(n, self.steps):
            b = node.block
            if node.poisoned or b in self._corrupted:
                sub = self.prefix.detach_subtree(node)
                bad = [x for x in sub if x in self._corrupted]
                if bad:
                    self._scrub(bad)
                self.free_blocks.extend(sub)
                continue
            got = extract_blocks(self.pool, [b])
            doc = {"k": got["k"][:, 0], "v": got["v"][:, 0],
                   "k_scale": (None if got["k_scale"] is None
                               else got["k_scale"][:, 0]),
                   "v_scale": (None if got["v_scale"] is None
                               else got["v_scale"][:, 0])}
            before = self.spill.bytes_spilled
            sid, dropped = self.spill.put(node, doc)
            self.prefix.mark_spilled(node, sid)
            self.spilled_blocks += 1
            self.spill_bytes += self.spill.bytes_spilled - before
            self.free_blocks.append(b)
            for victim in dropped:
                if victim.parent is not None:    # still in the tree
                    self.free_blocks.extend(
                        self.prefix.detach_subtree(victim))

    def _restore_node(self, node) -> None:
        """Bring one spilled node back into a fresh device block: take
        the tier entry (``WireError`` on a failed CRC, the caller's
        quarantine), copy its bytes in (``implant_block``), and make the
        node resident with a fresh LRU clock. ``restore_stall_s`` adds
        the host time this takes."""
        t0 = time.perf_counter()
        # a free block first: a corrupt entry must leave the free list as
        # it was
        if not self.free_blocks:
            self._reclaim_cached(1)
        if not self.free_blocks:
            raise RuntimeError("spill restore needs a free block and the "
                               "pool has none")
        doc = self.spill.take(node.spill_id)
        dst = self.free_blocks.pop(0)
        implant_block(self.pool, dst, doc["k"], doc["v"], doc["k_scale"],
                      doc["v_scale"])
        self.prefix.mark_restored(node, dst, self.steps)
        self.restores += 1
        self.restore_tokens_saved += self.cfg.block_size
        self.restore_stall_s += time.perf_counter() - t0
        self._step_restores += 1
        self._restores_left -= 1

    # -- block sharing -----------------------------------------------------

    def _cache_full_blocks(self, slot: int) -> None:
        """Insert a slot's newly fully prefilled full prompt blocks into
        the radix tree (after every prefill chunk). The sequence keeps
        each block and holds one ref. When another sequence cached the
        same path meanwhile (both prefilled at once), the slot remaps onto
        the cached block and frees its own copy, whose bytes are the
        same. When that cached twin is spilled, the slot's block becomes
        its device copy and the tier entry goes (JAX's engine remaps the
        table onto the spilled twin's block id, -1)."""
        if self.prefix is None:
            return
        seq = self.slots[slot]
        full = min(seq.prefilled, len(seq.prompt)) // self.cfg.block_size
        while len(seq.nodes) < full:
            i = len(seq.nodes)
            node = self.prefix.insert(seq.prompt, i, seq.blocks[i],
                                      self.steps)
            if node is None:            # parent evicted or poisoned
                seq.nodes.append(None)
                continue
            if node.spilled:
                # the cached twin was demoted meanwhile (the final-token
                # block, which no match covers, or a concurrent sharer's):
                # our block holds its bytes and becomes its device copy
                self.spill.drop(node.spill_id)
                self.prefix.mark_restored(node, seq.blocks[i], self.steps)
            elif node.block != seq.blocks[i]:
                # late dedup: remap onto the cached twin, free ours
                self.free_blocks.append(seq.blocks[i])
                self.block_frees += 1
                self.block_allocs += 1
                seq.blocks[i] = node.block
                self.tables[slot][i] = node.block
            self.prefix.lock([node], self.steps)
            seq.nodes.append(node)

    def _cow_private(self, slot: int, lo: int, hi: int) -> None:
        """The copy-on-write barrier: before a write to table entries
        ``lo..hi`` of ``slot``, any of them still backed by a radix node
        becomes a private bit-identical copy (table remapped, the node's
        ref released), so no write lands in a block another sequence or
        the cache reads."""
        seq = self.slots[slot]
        if self.prefix is None or not seq.nodes:
            return
        for li in range(lo, min(hi + 1, len(seq.nodes))):
            node = seq.nodes[li]
            if node is None:
                continue
            if not self.free_blocks:
                self._reclaim_cached(1)
            if not self.free_blocks:
                raise RuntimeError(
                    "copy-on-write of a shared block needs a free "
                    "block and the pool has none (refs-0 cache empty)")
            dst = self.free_blocks.pop(0)
            copy_block(self.pool, node.block, dst)
            self.prefix.release(node, self.steps)
            seq.nodes[li] = None
            seq.blocks[li] = dst
            self.tables[slot][li] = dst
            self.block_allocs += 1
            self.block_frees += 1
            self.cow_copies += 1

    def _evict(self, slot: int, drop_shared: bool = False) -> _Seq:
        """Take a sequence off its slot. Private blocks go back to the
        free list, scrubbed if corrupted or under ``drop_shared`` (the
        quarantine: a poisoned run's bytes are not trusted). Shared
        blocks are released instead: while sharers remain their bytes are
        untouched; a clean last release leaves the block cached, a
        distrusted one scrubs it and detaches it with its descendants.
        Released deepest first, so refcounts stay monotone."""
        seq = self.slots[slot]
        to_free: list[int] = []
        to_scrub: set[int] = set()
        for li in reversed(range(len(seq.blocks))):
            b = seq.blocks[li]
            node = seq.nodes[li] if li < len(seq.nodes) else None
            if node is not None:
                self.prefix.release(node, self.steps)
                if node.refs == 0 and (drop_shared
                                       or b in self._corrupted):
                    sub = self.prefix.detach_subtree(node)
                    to_scrub.update(x for x in sub
                                    if x == b or x in self._corrupted)
                    to_free.extend(sub)
            else:
                if drop_shared or b in self._corrupted:
                    to_scrub.add(b)
                to_free.append(b)
        if to_scrub:
            self._scrub(sorted(to_scrub))
        self.block_frees += len(seq.blocks)
        self.free_blocks.extend(to_free)
        seq.blocks = []
        seq.nodes = []
        self.tables[slot] = SCRATCH_BLOCK
        self.lengths[slot] = 0
        self.next_token[slot] = 0
        self.uids[slot] = 0
        self.slots[slot] = None
        return seq

    # -- lifecycle ---------------------------------------------------------

    def _release(self, slot: int) -> None:
        seq = self.slots[slot]
        self.finished[seq.uid] = seq.prompt + seq.out
        now = time.time()
        self._event("completed", seq.uid,
                    latency_s=round(now - seq.t_submit, 4),
                    ttft_s=(None if seq.t_first is None
                            else round(seq.t_first - seq.t_submit, 4)),
                    n_new=len(seq.out), retries=seq.retries)
        self._evict(slot)

    def _requeue(self, seq: _Seq) -> None:
        """Back to the queue for replay: prefill restarts from zero and
        the recorded tokens will be teacher-forced. ``submit_step`` stays,
        so the deadline still counts from the original submission."""
        seq.prefilled = 0
        seq.emitted = 0
        self.waiting.append(seq)

    def _preempt_youngest(self) -> bool:
        """Evict the most recently admitted running sequence back to the
        queue. Never the last running one, and ``step`` gives the prefill
        chunk to the oldest resident, so the oldest resident always makes
        progress. Returns whether one was evicted."""
        victims = [(s.admit_index, i) for i, s in enumerate(self.slots)
                   if s is not None]
        if len(victims) < 2:
            return False
        _, slot = max(victims)
        seq = self._evict(slot)
        self.preempted += 1
        self._event("preempted", seq.uid, reason="pool_pressure",
                    n_out=len(seq.out))
        self._requeue(seq)
        self._head_blocked = 0
        return True

    def _fail_or_retry(self, seq: _Seq, reason: str) -> None:
        """The quarantine's verdict: replay with retry budget left (the
        fault's pick was never appended), else report the uid failed."""
        self.quarantined += 1
        if seq.retries < self.policy.max_retries:
            seq.retries += 1
            self.retried += 1
            self._event("quarantined", seq.uid, reason=reason,
                        retrying=True)
            self._event("retried", seq.uid, reason=reason,
                        attempt=seq.retries,
                        max_retries=self.policy.max_retries)
            self._requeue(seq)
            return
        self._event("quarantined", seq.uid, reason=reason,
                    retrying=False, retries=seq.retries)
        self.failed[seq.uid] = {"reason": reason, "retries": seq.retries,
                                "n_out": len(seq.out)}

    def _quarantine(self, slot: int, reason: str) -> None:
        """Free exactly this sequence's slot and blocks, scrubbing what it
        alone held, and the scratch block every pad row and table tail
        points at (a NaN there would poison every gather)."""
        seq = self._evict(slot, drop_shared=True)
        self._scrub([SCRATCH_BLOCK])
        self._fail_or_retry(seq, reason)

    def _quarantine_waiting(self, head_i: int, reason: str) -> None:
        """Quarantine a request that faulted before taking a slot: no
        blocks to free, the same retry-or-fail verdict."""
        seq = self.waiting[head_i]
        del self.waiting[head_i]
        self._fail_or_retry(seq, reason)

    def _expire_deadlines(self) -> None:
        """Fail every request, waiting or running, still unfinished
        ``deadline_steps`` engine steps after its original submission.
        Runs before admission, so an expired waiter never takes a slot."""
        dl = self.policy.deadline_steps
        if dl <= 0:
            return

        def expire(seq: _Seq) -> None:
            self.expired += 1
            self._event("expired", seq.uid, reason="deadline",
                        n_out=len(seq.out))
            self.failed[seq.uid] = {"reason": "deadline",
                                    "retries": seq.retries,
                                    "n_out": len(seq.out)}

        def overdue(seq: _Seq) -> bool:
            return self.steps - seq.submit_step >= dl

        for slot, seq in enumerate(self.slots):
            if seq is not None and overdue(seq):
                self._evict(slot)
                expire(seq)
        if any(overdue(seq) for seq in self.waiting):
            keep = collections.deque()
            for seq in self.waiting:
                if overdue(seq):
                    expire(seq)
                else:
                    keep.append(seq)
            self.waiting = keep

    def _emit(self, slot: int, pick: int) -> None:
        """Fold one picked token into a slot: a live sequence appends the
        pick; a replaying one discards it and teacher-forces its recorded
        token."""
        seq = self.slots[slot]
        if seq.replaying:
            tok = seq.out[seq.emitted]
        else:
            tok = pick
            seq.out.append(tok)
            self.tokens_generated += 1
            if seq.t_first is None:
                seq.t_first = time.time()
        seq.emitted += 1
        self.next_token[slot] = tok
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

    def _logits(self, h, uids):
        """The tied head; rows of the armed poison uid come out NaN."""
        logits = h @ self.params.wte.T
        poison = self._poison_uid
        if poison != POISON_NONE:
            bad = [poison in (int(u), POISON_ALL) for u in uids]
            logits[torch.tensor(bad, device=logits.device)] = float("nan")
        return logits

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
        bs = self.cfg.block_size
        remaining = len(seq.prompt) - seq.prefilled
        # largest power-of-two bucket that fits: from a block boundary the
        # chunks stay block-aligned, so no chunk straddles a block
        c = max(b for b in self.chunk_buckets if b <= remaining)
        if seq.prefilled % bs:
            # a sub-block hit started mid-block: stay inside this block
            # until the boundary, then chunk as usual
            gap = bs - seq.prefilled % bs
            c = max(b for b in self.chunk_buckets if b <= min(c, gap))
        pos0 = seq.prefilled
        self._cow_private(slot, pos0 // bs, (pos0 + c - 1) // bs)
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
        logits = self._logits(layernorm(p.ln_f, x[-1:]), [seq.uid])
        nxt = self.pick(logits, [seq.uid], [pos0 + c])
        nxt, ok = torch.stack([nxt[0], rows_finite(logits)[0].long()]).tolist()
        if not ok:
            self._quarantine(slot, "nonfinite_logits")
            return
        seq.prefilled += c
        self._cache_full_blocks(slot)
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
        for slot in ready:                  # the copy-on-write barrier
            self._cow_private(slot, int(self.lengths[slot]) // bs,
                              int(self.lengths[slot]) // bs)
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
        logits = self._logits(layernorm(p.ln_f, x), uids)
        picks = self.pick(logits, uids.tolist(), (lengths + 1).tolist())
        out = torch.stack([picks, rows_finite(logits).long()]).cpu().numpy()
        for j, slot in enumerate(ready):
            if not out[1, j]:        # pad rows are never in `ready`
                self._quarantine(slot, "nonfinite_logits")
                continue
            self.lengths[slot] += 1
            self._emit(slot, int(out[0, j]))

    # -- speculative decoding ----------------------------------------------

    def _draft_for(self, seq: _Seq, budget: int) -> tuple[list[int], int]:
        """Up to ``budget`` draft tokens for one slot and how many of them
        are replayed tokens. During replay the recorded tokens are the
        draft (all accepted on a healthy replay); past them the n-gram
        drafter proposes from ``prompt + out``. Both are functions of the
        history alone."""
        if budget <= 0:
            return [], 0
        rec = seq.out[seq.emitted:seq.emitted + budget]
        if len(rec) < budget:
            guess = draft_tokens(seq.prompt + seq.out, budget - len(rec))
            return rec + guess[:budget - len(rec)], len(rec)
        return rec[:budget], budget

    @torch.no_grad()
    def _verify_dispatch(self, ready: list[int]) -> None:
        """The speculative decode dispatch: draft for each slot (at most
        ``max_new - emitted - 1`` tokens, so no emission passes
        ``max_new`` or the reservation), run ``speculate + 1`` sub-steps,
        read back once, and emit each slot's ``1 + accepted`` picks. A
        non-finite row within a slot's used sub-steps ``0..accepted``
        quarantines it with nothing emitted: its drafted rows landed only
        in its own blocks, which the quarantine scrubs."""
        k = self.cfg.speculate
        bs = self.cfg.block_size
        for slot in ready:
            # the window lengths .. lengths + k is barred as a whole: a
            # dead row writes to scratch, but no write may aim at a
            # shared block
            self._cow_private(slot, int(self.lengths[slot]) // bs,
                              (int(self.lengths[slot]) + k) // bs)
        b, tables, lengths, tokens, uids = self._marshal(ready)
        drafts = np.zeros((b, k), np.int64)
        dlens = np.zeros((b,), np.int64)
        replayed = np.zeros((b,), np.int64)
        for j, slot in enumerate(ready):
            seq = self.slots[slot]
            d, n_rec = self._draft_for(seq,
                                       min(k, seq.max_new - seq.emitted - 1))
            dlens[j] = len(d)
            drafts[j, :len(d)] = d
            replayed[j] = n_rec
            self.drafted_tokens += len(d) - n_rec
        self.decode_dispatches += 1
        p = self.params
        mb = tables.shape[1]
        # a dead row's position can pass the table and the position
        # table near the end of a reservation; its result is thrown away,
        # so its reads are clamped (a live row never gets that far)
        top = min(mb * bs, p.max_seq_len) - 1
        rows = torch.arange(b, device=self.device)
        tables_t = self._tensor(tables, torch.int32)
        tables_l = tables_t.long()
        len_t = self._tensor(lengths)
        drafts_t = self._tensor(drafts)
        dlens_t = self._tensor(dlens)
        uid_list = uids.tolist()
        cur = self._tensor(tokens)
        alive = torch.ones((b,), dtype=torch.bool, device=self.device)
        acc = torch.zeros((b,), dtype=torch.int64, device=self.device)
        picks, finite = [], []
        for i in range(k + 1):
            pos = len_t + i
            x = p.wte[cur] + p.wpe[pos.clamp(max=top)]
            phys = torch.where(
                alive, tables_l[rows, (pos // bs).clamp(max=mb - 1)],
                SCRATCH_BLOCK)
            off = pos % bs
            n_attend = (pos + 1).clamp(max=mb * bs).to(torch.int32)

            def write_attn(l, q, kk, vv, phys=phys, off=off,
                           n_attend=n_attend):
                write_rows(self.pool, l, phys, off, kk, vv,
                           self.cfg.kv_dtype)
                return self._cached_attn(l, q, tables_t, n_attend)

            x = self._trunk(x, pos, write_attn)
            logits = self._logits(layernorm(p.ln_f, x), uids)
            pk = self.pick(logits, uid_list, (lengths + i + 1).tolist())
            picks.append(pk)
            finite.append(rows_finite(logits).long())
            if i < k:
                d = drafts_t[:, i]
                alive = alive & (dlens_t > i) & (d == pk)
                acc = acc + alive.long()
                cur = d
        out = torch.cat([torch.stack(picks, 1), torch.stack(finite, 1),
                         acc[:, None]], 1).cpu().numpy()
        for j, slot in enumerate(ready):
            m = int(out[j, -1])
            if not out[j, k + 1:k + 2 + m].all():
                self._quarantine(slot, "nonfinite_logits")
                continue
            self.accepted_tokens += max(0, m - int(replayed[j]))
            self.lengths[slot] += m + 1
            for t in range(m + 1):
                if self.slots[slot] is None:
                    break               # released at its final emission
                self._emit(slot, int(out[j, t]))

    # -- the loop ----------------------------------------------------------

    def _prefill_slot(self) -> int | None:
        """The slot that gets this step's prefill chunk: the resident with
        an unfinished prompt admitted first. A refilled slot can sit below
        an older resident, so the lowest slot index would let the youngest
        take every chunk while the head's streak evicts it again (a
        livelock); the oldest first always progresses."""
        pending = [(s.admit_index, i) for i, s in enumerate(self.slots)
                   if s is not None and not s.prompt_done]
        return min(pending)[1] if pending else None

    def step(self) -> bool:
        """One scheduler iteration: demote to the low water mark, expire
        deadlines, admit (preempting when the policy says so), at most one
        prefill chunk, for the oldest resident with an unfinished prompt,
        then one decode dispatch over every ready slot (a verify dispatch
        under speculation). Returns whether any work ran; restores alone
        count. An armed poison applies to exactly this step."""
        self._restores_left = self.cfg.spill_restore_per_step
        self._step_restores = 0
        if (self.spill is not None and self.cfg.spill_low_water > 0
                and len(self.free_blocks) < self.cfg.spill_low_water):
            self._demote(self.cfg.spill_low_water - len(self.free_blocks))
        self._expire_deadlines()
        self._admit()
        did = False
        pre = self._prefill_slot()
        if pre is not None:
            self._prefill_step(pre)
            did = True
        ready = [i for i, s in enumerate(self.slots)
                 if s is not None and s.prompt_done]
        if ready:
            if self.cfg.speculate:
                self._verify_dispatch(ready)
            else:
                self._decode_dispatch(ready)
            did = True
        if self._step_restores:
            # a budget-deferred admission restored blocks: progress
            did = True
        if did:
            self.steps += 1
            self._poison_uid = POISON_NONE
            self._occ_sum += self.active / self.cfg.max_slots
            if self.prefix is not None:
                self.shared_blocks_peak = max(self.shared_blocks_peak,
                                              self.prefix.shared_blocks())
        return did

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def mean_occupancy(self) -> float:
        return self._occ_sum / self.steps if self.steps else 0.0

    def run(self) -> dict[int, list[int]]:
        """Step until every submitted request finished or failed. A step
        that only expired requests runs no work and is not a stall."""
        while self.waiting or self.active:
            if not self.step():
                if self.waiting or self.active:
                    raise RuntimeError("decode engine stalled: waiting "
                                       "requests but no admissible work")
                break
        return dict(self.finished)

    def generate(self, prompts, max_new: int) -> list[list[int] | None]:
        """Submit every prompt, drain, and return the full token lists in
        submission order; a request shed by ``queue_limit`` or failed
        for good yields None (the reason is in ``failed`` or
        ``request_events``)."""
        uids = []
        for p in prompts:
            try:
                uids.append(self.submit(p, max_new))
            except AdmissionError:
                uids.append(None)
        done = self.run()
        return [None if u is None else done.get(u) for u in uids]
