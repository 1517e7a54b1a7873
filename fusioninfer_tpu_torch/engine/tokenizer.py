"""Dependency-free byte-level tokenizer (own copy of the JAX package's
``ByteTokenizer``): any vocab ≥ 259 works, no downloads."""

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
