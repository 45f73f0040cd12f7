"""The n-gram prompt-copy drafter of speculative decoding, as in the JAX
package's ``decode/draft.py``.

The engine's speculative path (``decode/engine.py``, ``speculate=k``)
asks for up to ``k`` guesses of the next tokens and verifies them
greedily in one dispatch. The guess is "what came after the last time
this suffix appeared" in the history: no second model, no parameters.

A draft is a pure function of the history ``prompt + out``: no state, no
randomness, no clock. A retried or preempted request therefore drafts
again exactly as before, and its replay rebuilds the same KV writes.

Plain host Python, a verbatim copy of the JAX function.
"""

from __future__ import annotations


def draft_tokens(history, k: int, max_n: int = 3) -> list[int]:
    """Propose up to ``k`` continuation tokens for ``history``.

    Finds the LONGEST suffix of ``history`` (length ``max_n`` down to
    1) that occurred earlier, preferring the MOST RECENT earlier
    occurrence (recency beats frequency for loop-shaped continuations),
    and copies the tokens that followed it. Returns ``[]`` when no
    token of the suffix ever occurred before — the verify step then
    degenerates to a plain decode step (one token, nothing risked).
    May return fewer than ``k`` tokens when the match sits near the
    end of the history."""
    if k <= 0:
        return []
    h = [int(t) for t in history]
    n_h = len(h)
    if n_h < 2:
        return []
    for n in range(min(max_n, n_h - 1), 0, -1):
        suffix = h[n_h - n:]
        # j is the END index of a candidate earlier occurrence; scan
        # right-to-left so the first hit is the most recent one
        for j in range(n_h - 2, n - 2, -1):
            if h[j - n + 1:j + 1] == suffix:
                return h[j + 1:j + 1 + k]
    return []
