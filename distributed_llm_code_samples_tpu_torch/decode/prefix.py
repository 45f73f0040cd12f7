"""Radix prefix cache: content-keyed, refcounted shared KV blocks, as in
the JAX package's ``decode/prefix.py``.

Most serving requests share a long system prompt, so N admissions would
pay N identical prefills and hold N copies of the same KV bytes. The
paged pool already reads every KV row through per-slot int32 block
tables, so sharing is host-side bookkeeping: this module is the radix
tree the scheduler walks at admission, mapping every cached full block
of the prompt into the new slot's table instead of prefilling it again.

Granularity and identity:

- A node caches exactly one full block of ``block_size`` tokens; its key
  is the token path from the root (the radix edge is the block's token
  tuple). A full prompt block's stored bytes are a function of the
  tokens up to the block's end and the ``EngineConfig`` alone: KV rows
  depend only on causally earlier tokens, and the engine's greedy
  power-of-two chunks are block-aligned, so even an int8 block's requant
  history is fixed by its position. A hit block holds the bytes the
  admitting sequence's own prefill would have written.
- The walk is capped at ``(len(prompt) - 1) // block_size`` blocks, so at
  least one prompt token is always prefilled and the first pick comes
  from the prefill path, as in the unshared engine.

Refcounts and lifetime:

- ``refs`` counts live sequences whose table names the node's block
  (locked at admission, released on any eviction). A sequence locks its
  whole matched path, so ``child.refs > 0`` implies ``parent.refs > 0``:
  refcounts never increase from root to leaf, and every refs-0 node can
  be reclaimed leaf by leaf.
- refs-0 nodes stay cached (the reuse across requests) until pool
  pressure evicts them: ``evict_lru`` frees least-recently-used refs-0
  leaves only, which keeps every cached path reachable.
- ``poisoned`` marks a node whose block was corrupted: it leaves
  ``match`` and ``insert`` at once, but its bytes stay while sharers
  remain (a poisoned sharer never zeroes an innocent survivor's
  prefix). The engine scrubs and detaches it at refs 0.

The spill tier (``decode/spill.py``, ``spill=``): with it, pool pressure
demotes refs-0 device leaves (``spill_victims``) into host RAM instead of
detaching them. A spilled node (``spilled``, ``spill_id``; ``block`` -1)
keeps its place in the tree and still matches; it leaves every
block-indexed view. Only a node whose children are all spilled is
demoted, so spilled nodes form a suffix of every path and a resident
node's ancestors are resident. Poisoned nodes never spill. Detaching a
node in any way drops its tier entry.

Each weights version has a root of its own (``version``, 0 by default):
a block's bytes also depend on the weights, so a match never crosses
versions, while eviction and refcounts stay global.

Plain host Python: the device never sees the tree; the engine owns every
pool write and free-list edit.
"""

from __future__ import annotations

import heapq


class PrefixNode:
    """One cached full block. ``edge`` is the block's token tuple (the
    radix edge from ``parent``), ``block`` the physical pool block,
    ``refs`` the live-sequence lock count, ``last_use`` the engine step of
    the last lock, release or insert (the LRU clock)."""

    __slots__ = ("edge", "block", "refs", "last_use", "poisoned", "spilled",
                 "spill_id", "parent", "children")

    def __init__(self, edge, block, parent, step):
        self.edge = edge
        self.block = int(block)
        self.refs = 0
        self.last_use = int(step)
        self.poisoned = False
        self.spilled = False
        self.spill_id: int | None = None
        self.parent = parent
        self.children: dict[tuple[int, ...], PrefixNode] = {}

    def path_tokens(self) -> list[int]:
        """The full token path from the root."""
        toks: list[int] = []
        node = self
        while node.parent is not None:
            toks = list(node.edge) + toks
            node = node.parent
        return toks


class PrefixCache:
    """The host-side radix tree over full prompt blocks."""

    def __init__(self, block_size: int, spill=None):
        self.block_size = int(block_size)
        # the host tier (decode/spill.py) or None: detach drops its entries
        self.spill = spill
        self.root = PrefixNode((), -1, None, 0)     # version-0 root
        self._roots: dict[int, PrefixNode] = {0: self.root}
        self._by_block: dict[int, PrefixNode] = {}

    def _root(self, version: int) -> PrefixNode:
        root = self._roots.get(int(version))
        if root is None:
            root = PrefixNode((), -1, None, 0)
            self._roots[int(version)] = root
        return root

    # -- introspection ---------------------------------------------------

    def __len__(self) -> int:
        return len(self._by_block)

    def nodes(self) -> list[PrefixNode]:
        """Every cached node, in pre-order under each version root (edges
        in sorted order)."""
        out = []
        for version in sorted(self._roots):
            root = self._roots[version]
            stack = [root]
            while stack:
                node = stack.pop()
                if node is not root:
                    out.append(node)
                for edge in sorted(node.children, reverse=True):
                    stack.append(node.children[edge])
        return out

    def evictable_blocks(self) -> int:
        """refs-0 cached blocks: capacity the admission count adds to the
        free list."""
        return sum(1 for n in self._by_block.values() if n.refs == 0)

    def shared_blocks(self) -> int:
        """Blocks named by two or more live tables right now."""
        return sum(1 for n in self._by_block.values() if n.refs >= 2)

    def node_for_block(self, block: int) -> PrefixNode | None:
        return self._by_block.get(int(block))

    # -- the radix walk --------------------------------------------------

    def match_cap(self, prompt_len: int) -> int:
        """Most hit blocks for a prompt: every full block but the one
        holding the final token."""
        return max(0, (int(prompt_len) - 1) // self.block_size)

    def match(self, prompt, version: int = 0) -> list[PrefixNode]:
        """The longest cached path of full prompt blocks under
        ``version``'s root, capped by ``match_cap``, root outward. Stops
        at the first miss or poisoned node. Spilled nodes match (a restore
        beats a prefill) and form a suffix of the path. Does not lock."""
        blk = self.block_size
        node = self._roots.get(int(version))
        if node is None:
            return []
        out = []
        for i in range(self.match_cap(len(prompt))):
            child = node.children.get(tuple(prompt[i * blk:(i + 1) * blk]))
            if child is None or child.poisoned:
                break
            out.append(child)
            node = child
        return out

    def warm_blocks(self, prompt, version: int = 0) -> int:
        """How many leading full blocks of ``prompt`` the tree holds under
        ``version``. Read-only: no lock, no LRU touch."""
        return len(self.match(prompt, version))

    def partial_match(self, prompt, hits,
                      version: int = 0) -> tuple[PrefixNode, int] | None:
        """Sub-block probe past the full-block walk: among the children of
        the last hit (the root when ``hits`` is empty), the resident,
        non-poisoned edge sharing the longest leading run of the remaining prompt
        tokens. Returns ``(donor, m)``, or None when no edge shares a
        token. ``m`` is capped at ``len(remaining) - 1`` (one token always
        prefills) and is below ``block_size``. Read-only."""
        blk = self.block_size
        node = hits[-1] if hits else self._roots.get(int(version))
        if node is None:
            return None
        rest = [int(t) for t in prompt[len(hits) * blk:]]
        best, best_m = None, 0
        for edge, child in node.children.items():
            if child.poisoned or child.spilled:
                continue
            m = 0
            for a, b in zip(edge, rest):
                if a != b:
                    break
                m += 1
            if m > best_m:
                best, best_m = child, m
        best_m = min(best_m, len(rest) - 1)
        if best is None or best_m < 1:
            return None
        return best, best_m

    def lock(self, nodes, step: int) -> None:
        for n in nodes:
            n.refs += 1
            n.last_use = int(step)

    def release(self, node: PrefixNode, step: int) -> None:
        if node.refs <= 0:
            raise RuntimeError(f"release of unlocked prefix block "
                               f"{node.block}")
        node.refs -= 1
        node.last_use = int(step)

    # -- insertion -------------------------------------------------------

    def insert(self, prompt, block_index: int, block: int, step: int,
               version: int = 0) -> PrefixNode | None:
        """Cache prompt block ``block_index``, just fully prefilled into
        physical ``block``. Returns the node now backing that logical
        block: a new node owning ``block``, or the existing node when
        another sequence already cached this path (late dedup: the caller
        remaps its table onto the cached block and frees its duplicate).
        Returns None when the parent path is not cached, poisoned or
        spilled (a resident node under a spilled one would break the
        spilled-suffix rule): the block stays private. The returned node
        may itself be spilled; the caller then makes ``block`` its device
        copy."""
        blk = self.block_size
        node = self._root(version)
        for i in range(block_index):
            node = node.children.get(tuple(prompt[i * blk:(i + 1) * blk]))
            if node is None or node.poisoned or node.spilled:
                return None
        edge = tuple(int(t) for t in
                     prompt[block_index * blk:(block_index + 1) * blk])
        if len(edge) != blk:
            raise ValueError(f"block {block_index} of a {len(prompt)}-"
                             f"token prompt is not full (block {blk})")
        child = node.children.get(edge)
        if child is not None:
            return child if not child.poisoned else None
        child = PrefixNode(edge, block, node, step)
        node.children[edge] = child
        self._by_block[child.block] = child
        return child

    # -- eviction and detach ---------------------------------------------

    def evict_lru(self, n_blocks: int, step: int) -> list[int]:
        """Reclaim up to ``n_blocks`` physical blocks from refs-0 cached
        leaves, least recently used first. A parent whose last child
        goes becomes a candidate in the same call, so cold paths drain
        from the leaf inward."""
        heap = [(n.last_use, n.block, n) for n in self._by_block.values()
                if n.refs == 0 and not n.children]
        heapq.heapify(heap)
        out: list[int] = []
        while heap and len(out) < n_blocks:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            self._detach(victim)
            out.append(victim.block)
            # version roots carry the empty edge and are never candidates
            if parent.edge and parent.refs == 0 and not parent.children:
                heapq.heappush(heap,
                               (parent.last_use, parent.block, parent))
        return out

    # -- the spill tier: demotion and restore ---------------------------

    def spill_victims(self, n_blocks: int, step: int) -> list[PrefixNode]:
        """Up to ``n_blocks`` demotion victims, least recently used first:
        refs-0 resident nodes whose children are all spilled. Nothing is
        detached; the engine spills each victim (``mark_spilled``) or, if
        poisoned, detaches and scrubs it. A parent becomes a candidate in
        the same call once its last resident child is picked."""
        heap = [(n.last_use, n.block, n) for n in self._by_block.values()
                if n.refs == 0
                and all(c.spilled for c in n.children.values())]
        heapq.heapify(heap)
        picked: list[PrefixNode] = []
        picked_ids: set[int] = set()
        while heap and len(picked) < n_blocks:
            _, _, victim = heapq.heappop(heap)
            picked.append(victim)
            picked_ids.add(id(victim))
            parent = victim.parent
            if (parent.edge and parent.refs == 0
                    and all(c.spilled or id(c) in picked_ids
                            for c in parent.children.values())):
                heapq.heappush(heap,
                               (parent.last_use, parent.block, parent))
        return picked

    def mark_spilled(self, node: PrefixNode, spill_id: int) -> int:
        """The node's bytes now live in tier entry ``spill_id``; returns
        its former device block (for the free list). The node stays in
        the tree and still matches."""
        block = node.block
        self._by_block.pop(block, None)
        node.block = -1
        node.spilled = True
        node.spill_id = int(spill_id)
        return block

    def mark_restored(self, node: PrefixNode, block: int,
                      step: int) -> None:
        """The node's bytes are in device ``block`` again; its LRU clock
        restarts at ``step``."""
        node.spilled = False
        node.spill_id = None
        node.block = int(block)
        node.last_use = int(step)
        self._by_block[node.block] = node

    def _forget(self, node: PrefixNode) -> None:
        """Drop a detaching node's tier entry: an unreachable edge's host
        copy is garbage."""
        if node.spilled and self.spill is not None:
            self.spill.drop(node.spill_id)
        node.spilled = False
        node.spill_id = None

    def _detach(self, node: PrefixNode) -> None:
        del node.parent.children[node.edge]
        self._by_block.pop(node.block, None)
        self._forget(node)
        node.parent = None

    def detach_subtree(self, node: PrefixNode) -> list[int]:
        """Remove ``node`` and every descendant (all refs 0 by the
        monotone-refs rule), returning their device blocks (spilled ones
        hold none; their tier entries are dropped). Used when a block can
        no longer be trusted: the descendants stay clean but become
        unreachable, so they return to the free list with it."""
        if node.refs != 0:
            raise RuntimeError(f"detach of live prefix block "
                               f"{node.block} (refs {node.refs})")
        out: list[int] = []
        stack = [node]
        self._detach(node)
        while stack:
            cur = stack.pop()
            if cur.block >= 0:
                out.append(cur.block)
            self._by_block.pop(cur.block, None)
            if cur is not node:
                self._forget(cur)
            stack.extend(cur.children.values())
            cur.children = {}
        return out

    def snapshot(self) -> list[dict]:
        """The tree as a JSON-serializable pre-order node list with parent
        links (indices into the list)."""
        order = self.nodes()
        index = {id(n): i for i, n in enumerate(order)}
        version_of = {id(root): v for v, root in self._roots.items()}

        def _version(n: PrefixNode) -> int:
            while n.parent is not None:
                n = n.parent
            return version_of.get(id(n), 0)

        return [{
            "tokens": list(n.edge),
            "block": n.block,
            "refs": n.refs,
            "last_use": n.last_use,
            "poisoned": n.poisoned,
            "spilled": n.spilled,
            "version": _version(n),
            "parent": (None if not n.parent.edge
                       else index[id(n.parent)]),
        } for n in order]
