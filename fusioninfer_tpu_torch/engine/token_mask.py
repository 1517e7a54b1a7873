"""Token-level grammar masks: guided decoding over multi-byte vocabs
(own copy of ``fusioninfer_tpu/engine/token_mask.py``, plain Python and
numpy).

The byte machines in ``engine/guided.py`` constrain generation one BYTE
at a time.  With the byte tokenizer that is the whole story (one token =
one byte); real vocabs are multi-byte, where a single sampled token
advances the grammar by several bytes and may cross structural
boundaries (``","`` closes a number, separates object members and opens
the next key — three grammar states in one token).

* :func:`token_byte_strings` — each vocab id's byte string from the
  serving tokenizer (an explicit ``token_bytes()`` hook, as
  :class:`engine.tokenizer.TrieTokenizer` has, or the byte tokenizer's
  offset).
* :class:`TokenTrie` — the vocab as a byte trie, with per-subtree
  "all bytes are plain string content" summaries.
* :class:`GrammarTokenMasker` — per-step ``[vocab]`` legality: a token
  is sampleable iff walking its bytes through a fork of the request's
  machine stays legal.  Computed by trie DFS with two accelerations:
  whole all-string subtrees are accepted in one vectorized store when
  the machine is in a string run, and finished masks are memoized by the
  machine's exact state signature — a long string or digit run hits the
  cache every step.

The masker is exact, not approximate: structural tokens embedding
quotes/braces thread through real machine forks, so a token is legal
only if EVERY byte of it is.  ``finish_reason: "stop"`` output parses
(and conforms, for ``json_schema``) exactly as in the single-byte case.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np

from fusioninfer_tpu_torch.engine.guided import _STR_BYTES

# -- vocab byte-string recovery ----------------------------------------------


def token_byte_strings(tokenizer, vocab_size: int) -> Optional[list]:
    """``[vocab_size]`` list of ``bytes`` (the token's exact byte
    string) or ``None`` (special/unmapped — never legal under a
    grammar).  Returns ``None`` overall when the tokenizer exposes no
    byte mapping at all; guided requests are then rejected at admission
    rather than served unconstrained (``engine/engine.py``).  A
    ``transformers`` tokenizer's vocab (the JAX package's
    ``_hf_token_bytes``) waits for the port's ``HFTokenizer``."""
    hook = getattr(tokenizer, "token_bytes", None)
    if callable(hook):
        tb = list(hook())
        tb = tb[:vocab_size] + [None] * (vocab_size - len(tb))
        return [b if b else None for b in tb]  # b"" would advance nothing
    offset = getattr(tokenizer, "OFFSET", None)
    if offset is not None:  # in-repo ByteTokenizer: ids offset..offset+255
        out: list[Optional[bytes]] = [None] * vocab_size
        for b in range(256):
            if offset + b < vocab_size:
                out[offset + b] = bytes([b])
        return out if any(x is not None for x in out) else None
    return None


# -- the trie ----------------------------------------------------------------


class _TrieNode:
    __slots__ = ("children", "token_ids", "sub_tokens", "all_str")

    def __init__(self):
        self.children: dict[int, _TrieNode] = {}
        self.token_ids: list[int] = []
        self.sub_tokens: Optional[np.ndarray] = None  # ids at/below this node
        self.all_str: bool = True  # every edge byte strictly below ∈ _STR_BYTES


_IS_STR_BYTE = np.zeros(256, bool)
_IS_STR_BYTE[list(_STR_BYTES)] = True


class TokenTrie:
    """The vocab's byte strings as a trie, with subtree summaries the
    masker's string-run shortcut needs."""

    def __init__(self, token_bytes: Sequence[Optional[bytes]]):
        self.vocab_size = len(token_bytes)
        self.root = _TrieNode()
        for tid, tb in enumerate(token_bytes):
            if not tb:
                continue
            node = self.root
            for b in tb:
                nxt = node.children.get(b)
                if nxt is None:
                    nxt = node.children[b] = _TrieNode()
                node = nxt
            node.token_ids.append(tid)
        self._summarize(self.root)

    def _summarize(self, node: _TrieNode) -> tuple[np.ndarray, bool]:
        """Post-order: fill ``sub_tokens`` and ``all_str`` (iterative —
        real vocabs nest deeper than the recursion limit is worth)."""
        stack = [(node, False)]
        while stack:
            n, expanded = stack.pop()
            if not expanded:
                stack.append((n, True))
                stack.extend((c, False) for c in n.children.values())
                continue
            parts = [np.asarray(n.token_ids, np.int32)] if n.token_ids else []
            all_str = True
            for b, c in n.children.items():
                parts.append(c.sub_tokens)
                all_str &= c.all_str and bool(_IS_STR_BYTE[b])
            n.sub_tokens = (np.concatenate(parts) if parts
                            else np.empty(0, np.int32))
            n.all_str = all_str
        return node.sub_tokens, node.all_str


# -- the masker --------------------------------------------------------------


class GrammarTokenMasker:
    """Per-step ``[vocab] bool`` legality for a guided machine.

    Thread-safe for the engine's use (one engine thread computes masks;
    the cache dict is guarded anyway since admission-time validation may
    probe from server threads).  Cached arrays are returned by reference
    and must be treated as read-only."""

    _CACHE_CAP = 4096  # distinct machine states; cleared wholesale past this

    def __init__(self, token_bytes: Sequence[Optional[bytes]]):
        self.token_bytes: list[Optional[bytes]] = list(token_bytes)
        self.trie = TokenTrie(self.token_bytes)
        self._cache: dict[tuple, np.ndarray] = {}
        self._lock = threading.Lock()

    @property
    def vocab_size(self) -> int:
        return self.trie.vocab_size

    def token_mask(self, machine) -> np.ndarray:
        sig = machine.signature()
        with self._lock:
            hit = self._cache.get(sig)
        if hit is not None:
            return hit
        mask = self._compute(machine)
        with self._lock:
            if len(self._cache) >= self._CACHE_CAP:
                self._cache.clear()
            self._cache[sig] = mask
        return mask

    def _compute(self, machine) -> np.ndarray:
        mask = np.zeros(self.trie.vocab_size, bool)
        stack = [(self.trie.root, machine.fork())]
        while stack:
            node, m = stack.pop()
            allowed = m.allowed_bytes()
            run = m.str_run_invariant()
            for b, child in node.children.items():
                if not allowed[b]:
                    continue
                if run and _IS_STR_BYTE[b] and child.all_str:
                    # whole subtree is plain string content: every token
                    # in it keeps the machine inside the string run
                    mask[child.sub_tokens] = True
                    continue
                m2 = m.fork()
                m2.advance(b)
                if child.token_ids:
                    mask[child.token_ids] = True
                if child.children and not m2.done:
                    stack.append((child, m2))
        return mask

    def advance_token(self, machine, token: int) -> None:
        """Advance a machine over one SAMPLED token's bytes (the mask
        guarantees legality; a ValueError here is an engine bug)."""
        tb = self.token_bytes[token]
        if tb:
            for b in tb:
                machine.advance(b)
