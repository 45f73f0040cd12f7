"""The host-RAM spill tier behind the radix prefix cache, as in the JAX
package's ``decode/spill.py``.

Without the tier, pool pressure evicts a refs-0 cached prefix block and
a returning session prefills it again. With it, the engine demotes the
block instead: its bytes (storage dtype, int8 scales too) leave the card
as one wire document (``runtime/wire.py``, a CRC-32 per array) and the
node stays in the tree, spilled. A later hit on the spilled edge restores
the bytes into a fresh pool block instead of prefilling them.

- **Bounded.** ``put`` past ``capacity_blocks`` drops the oldest-spilled
  entries and returns their nodes, which the caller detaches: their
  edges can no longer be restored. A spilled node's LRU clock cannot
  move until it is restored, so oldest-spilled is least recently used.
- **Checked.** ``take`` verifies the CRCs on the way out: bytes damaged
  in host RAM raise ``WireError`` and are never decoded; the engine
  quarantines the restoring request. ``take`` consumes the entry either
  way.
- **Process memory only.** Nothing is persisted.

Plain host Python; the engine owns every pool write and free-list edit.
"""

from __future__ import annotations

from ..runtime import wire


class SpillTier:
    """Bounded host-RAM store of spilled KV blocks keyed by a monotone
    spill id. Entries are ``wire.serialize_doc`` bytes, kept in insertion
    order for the overflow drops."""

    def __init__(self, capacity_blocks: int):
        if int(capacity_blocks) < 1:
            raise ValueError(f"spill tier capacity must be >= 1 block, "
                             f"got {capacity_blocks}")
        self.capacity = int(capacity_blocks)
        self._store: dict[int, bytes] = {}    # spill_id -> wire bytes
        self._nodes: dict[int, object] = {}   # spill_id -> PrefixNode
        self._next_id = 0
        self.spills = 0          # entries ever admitted
        self.drops = 0           # entries removed without a restore
        self.restores = 0        # clean CRC-verified promotions
        self.bytes_spilled = 0   # wire bytes ever admitted
        self.bytes_resident = 0  # wire bytes held now

    def __len__(self) -> int:
        return len(self._store)

    def utilization(self) -> float:
        """Occupied share of the capacity."""
        return len(self._store) / self.capacity

    def put(self, node, doc: dict) -> tuple[int, list]:
        """Admit one block document for ``node``. Returns ``(spill_id,
        victims)``: the oldest-spilled nodes whose entries were dropped to
        keep the capacity, which the caller must detach. ``doc`` holds
        ``extract_blocks``' arrays of ONE block (k and v at the storage
        dtype, the int8 scales or None)."""
        data = wire.serialize_doc(doc)
        sid = self._next_id
        self._next_id += 1
        self._store[sid] = data
        self._nodes[sid] = node
        self.spills += 1
        self.bytes_spilled += len(data)
        self.bytes_resident += len(data)
        victims = []
        while len(self._store) > self.capacity:
            old = next(iter(self._store))
            victims.append(self._nodes[old])
            self.drop(old)
        return sid, victims

    def drop(self, spill_id: int) -> bool:
        """Remove an entry without restoring it (overflow, a detached
        node). Idempotent: False when it is gone already."""
        data = self._store.pop(spill_id, None)
        self._nodes.pop(spill_id, None)
        if data is None:
            return False
        self.bytes_resident -= len(data)
        self.drops += 1
        return True

    def take(self, spill_id: int) -> dict:
        """Restore: CRC-verify and return the block document, removing
        the host copy either way. Raises ``wire.WireError`` when the bytes
        fail a check (the entry is consumed, so the damage cannot be
        served again) and ``KeyError`` when the entry is absent."""
        data = self._store.pop(spill_id)
        self._nodes.pop(spill_id, None)
        self.bytes_resident -= len(data)
        try:
            doc = wire.deserialize_doc(data)
        except wire.WireError:
            self.drops += 1
            raise
        self.restores += 1
        return doc

    def corrupt(self, spill_id: int) -> bool:
        """Test hook: flip one byte of a stored entry, as a host-RAM bit
        flip would. The byte sits three quarters in, in an array's payload
        rather than the zip directory, so ``take`` raises ``WireError``.
        False when the entry is gone (restored or dropped)."""
        data = self._store.get(spill_id)
        if data is None:
            return False
        buf = bytearray(data)
        buf[(3 * len(buf)) // 4] ^= 0xFF
        self._store[spill_id] = bytes(buf)
        return True
