"""Dependency-free tokenizers (own copies of the JAX package's
``ByteTokenizer`` and ``TrieTokenizer``): any vocab ≥ 259 works, no
downloads.  The JAX package's ``HFTokenizer`` (a local ``transformers``
tokenizer) is not ported yet."""

from __future__ import annotations


class ByteTokenizer:
    """Bytes 0-255 mapped to ids 3-258; BOS=1, EOS=2, PAD=0."""

    PAD_ID = 0
    BOS_ID = 1
    EOS_ID = 2
    OFFSET = 3

    @property
    def vocab_size(self) -> int:
        return 256 + self.OFFSET

    @property
    def eos_token_id(self) -> int:
        return self.EOS_ID

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [b + self.OFFSET for b in text.encode("utf-8")]
        return ([self.BOS_ID] if add_bos else []) + ids

    def decode(self, ids: list[int]) -> str:
        # ids beyond the byte range decode to nothing, so generation stays
        # well-defined under random weights with a larger vocab
        data = bytes(i - self.OFFSET for i in ids
                     if self.OFFSET <= i < self.OFFSET + 256)
        return data.decode("utf-8", errors="replace")


class TrieTokenizer:
    """Greedy longest-match tokenizer over an explicit byte vocab.

    A dependency-free stand-in for a BPE tokenizer: ids 0..2 are
    PAD/BOS/EOS, ids 3..258 the single bytes (so any text encodes), and
    ids 259+ the supplied multi-byte merges, matched longest-first.
    Exposes the ``token_bytes()`` hook guided decoding's token masker
    keys on (``engine/token_mask.py``): the vocab shape real BPE
    tokenizers have, without a download."""

    PAD_ID = 0
    BOS_ID = 1
    EOS_ID = 2
    OFFSET = None  # not a plain byte tokenizer: mask via token_bytes()

    def __init__(self, merges: list):
        merged = [bytes(m) for m in merges]
        if any(len(m) < 2 for m in merged):
            raise ValueError("merges must be multi-byte (singles are built in)")
        self._tokens: list = [None, None, None]
        self._tokens += [bytes([b]) for b in range(256)]
        self._tokens += merged
        self._by_bytes = {tb: i for i, tb in enumerate(self._tokens)
                          if tb is not None}
        self._max_len = max(len(m) for m in merged)

    @property
    def vocab_size(self) -> int:
        return len(self._tokens)

    @property
    def eos_token_id(self) -> int:
        return self.EOS_ID

    def token_bytes(self) -> list:
        return list(self._tokens)

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        data = text.encode("utf-8")
        ids = [self.BOS_ID] if add_bos else []
        i = 0
        while i < len(data):
            for ln in range(min(self._max_len, len(data) - i), 0, -1):
                tid = self._by_bytes.get(data[i:i + ln])
                if tid is not None:
                    ids.append(tid)
                    i += ln
                    break
        return ids

    def decode(self, ids: list[int]) -> str:
        out = b"".join(self._tokens[i] or b"" for i in ids
                       if 0 <= i < len(self._tokens))
        return out.decode("utf-8", errors="replace")
