"""Speculative decoding: n-gram prompt-lookup drafts (own copy of
``fusioninfer_tpu/engine/spec.py``; numpy only).

Model-free speculation (vLLM's ``[ngram]`` method): the last ``n``
tokens of a sequence are matched against its own earlier context
(prompt + generated so far); on a hit, the tokens that followed the
match are proposed as drafts.  The engine scores a row's input token
and its drafts as one window of the one ragged forward
(:func:`engine.model_runner.fused_step`), so ``k + 1`` positions cost
about one decode step's weight pass and every accepted draft is a token
that took no step of its own.  Strongest on extractive traffic
(summarization, RAG, code edits) where the output quotes the prompt.

Proposal is exact-match and the verifier is the model itself, so a
greedy stream is the same with speculation on or off: acceptance only
shortens the steps, it never changes a token.
"""

from __future__ import annotations

import numpy as np


class NgramProposer:
    """Propose up to ``k`` draft tokens by longest-suffix n-gram lookup.

    Tries ``max_ngram`` down to ``min_ngram``: the MOST RECENT earlier
    occurrence of the sequence's last-n-token suffix wins, and the tokens
    that followed it are the draft.  O(len · n) vectorized compares per
    call via a sliding-window view.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, tokens: list[int], k: int) -> list[int]:
        """Drafts for the continuation of ``tokens`` (possibly empty)."""
        if k < 1:
            return []
        arr = np.asarray(tokens, np.int64)
        L = arr.shape[0]
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            pattern = arr[L - n:]
            # windows over arr[:-1]: every match has ≥1 follower, and the
            # suffix's own position (L-n) is structurally excluded;
            # overlapping periodic matches remain, which is what extends
            # a run like "... a b a b" with more "a b"
            windows = np.lib.stride_tricks.sliding_window_view(arr[:-1], n)
            hits = np.nonzero((windows == pattern).all(axis=1))[0]
            if hits.size:
                # latest match with k full followers (recency bias), else
                # the match with the most followers: a run's latest match
                # sits at the end with almost nothing after it
                full = hits[L - (hits + n) >= k]
                best = int(full[-1]) if full.size else int(
                    hits[np.argmax(L - (hits + n))])
                start = best + n
                return arr[start: start + k].tolist()
        return []
