"""Content-addressed KV block hashing (own copy of
``fusioninfer_tpu/utils/blockhash.py``).

The chain is ``H(parent, block_tokens)`` (blake2b-128), so a block's
identity includes its whole prefix; ``namespace`` partitions the content
address space.  The bytes must be identical to the JAX package's: the
router computes the same chain for an incoming prompt to score which
replica holds its prefix.  Token ids serialize as little-endian signed
8-byte integers.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Sequence

import numpy as np


def token_block_bytes(block: Iterable[int]) -> bytes:
    """Serialize one block of token ids (int64-LE)."""
    if not hasattr(block, "__len__"):
        block = list(block)
    return np.asarray(block, np.int64).astype("<i8").tobytes()


def block_hashes(tokens: Sequence[int], page_size: int,
                 namespace: bytes = b"") -> list[bytes]:
    """Hash chain over the FULL pages of ``tokens``."""
    out: list[bytes] = []
    parent = b"root" + namespace
    for i in range(len(tokens) // page_size):
        h = hashlib.blake2b(digest_size=16)
        h.update(parent)
        h.update(token_block_bytes(tokens[i * page_size: (i + 1) * page_size]))
        parent = h.digest()
        out.append(parent)
    return out
