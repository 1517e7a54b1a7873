"""Automatic prefix caching: content-addressed KV page sharing (port of
``fusioninfer_tpu/engine/prefix_cache.py``).

* Full prompt pages are content-addressed by a hash chain
  (``H(parent_hash, block_tokens)``, :mod:`utils.blockhash`), so a
  block's identity includes its whole prefix.
* A new request reuses the longest chain of cached pages (capped at
  ``len(prompt) - 1`` tokens: the last token is recomputed for its
  logits), takes a reference on each, and prefills only the suffix.
* Released pages with a registered hash become evictable (LRU) but stay
  addressable until the pool needs them, so back-to-back requests with a
  shared system prompt skip most of their prefill.

Shared pages are never written: the suffix prefill starts past them, and
generated tokens land on private pages (positions beyond the reused
prefix).  Which page holds which content is host metadata only.
"""

from __future__ import annotations

import collections
from typing import Optional

from fusioninfer_tpu_torch.engine.kv_cache import CacheConfig, PageAllocator
from fusioninfer_tpu_torch.utils.blockhash import block_hashes


class PrefixCachingAllocator(PageAllocator):
    """Page allocator with content-addressed sharing.

    Page states: *free* (no content), *owned* (referenced by ≥1 sequence;
    hashed pages may be shared by several), *evictable* (hashed content,
    zero references: reusable as-is via its hash, reclaimable under
    pressure, LRU order).
    """

    def __init__(self, cache_cfg: CacheConfig):
        super().__init__(cache_cfg)
        self._hash_to_page: dict[bytes, int] = {}
        self._page_hash: dict[int, bytes] = {}
        self._refs: dict[int, int] = {}  # page -> #sequences referencing
        self._evictable: "collections.OrderedDict[int, None]" = collections.OrderedDict()
        # per sequence: pages acquired via sharing (no write permission)
        self._shared_of: dict[str, list[int]] = {}
        self.hit_tokens_total = 0
        self.query_tokens_total = 0

    # -- capacity ------------------------------------------------------------

    @property
    def free_pages(self) -> int:  # evictable pages are reclaimable
        return len(self._free) + len(self._evictable)

    def utilization(self) -> float:
        total = self.cache_cfg.n_pages - 1
        used = total - self.free_pages
        return 0.0 if total == 0 else used / total

    def _take_free_page(self) -> int:
        if self._free:
            return self._free.pop()
        # reclaim the least-recently-used evictable page
        page, _ = self._evictable.popitem(last=False)
        del self._hash_to_page[self._page_hash.pop(page)]
        return page

    # -- prefix matching -----------------------------------------------------

    def _usable_chain(self, prompt_tokens: list, namespace: bytes,
                      chain: Optional[list]) -> list:
        """The prompt's block-hash chain capped at the usable block count
        (``(len(prompt) - 1) // page_size``: the last token is always
        recomputed for its logits, so its block is never reused).
        ``chain``, the FULL chain computed once at admission, spares the
        hashing; it is capped here."""
        ps = self.cache_cfg.page_size
        usable_blocks = max(0, (len(prompt_tokens) - 1) // ps)
        if chain is not None:
            return chain[:usable_blocks]
        return block_hashes(prompt_tokens, ps, namespace)[:usable_blocks]

    def match_prefix(self, seq_id: str, prompt_tokens: list[int],
                     namespace: bytes = b"",
                     chain: Optional[list] = None) -> int:
        """Acquire the longest cached page chain for this prompt; returns
        the number of prefix TOKENS covered (a multiple of page_size,
        capped at ``len(prompt) - 1``)."""
        ps = self.cache_cfg.page_size
        self.query_tokens_total += len(prompt_tokens)
        shared: list[int] = []
        for h in self._usable_chain(prompt_tokens, namespace, chain):
            page = self._hash_to_page.get(h)
            if page is None:
                break
            # recency bump, in the JAX order (dict insertion = MRU order)
            self._hash_to_page[h] = self._hash_to_page.pop(h)
            shared.append(page)
        for page in shared:
            self._refs[page] = self._refs.get(page, 0) + 1
            self._evictable.pop(page, None)
        if shared:
            self._shared_of[seq_id] = list(shared)
            self._owned.setdefault(seq_id, []).extend(shared)
        self.hit_tokens_total += len(shared) * ps
        return len(shared) * ps

    # -- allocation ----------------------------------------------------------

    def can_allocate(self, n_tokens: int) -> bool:
        need = self.pages_needed(n_tokens)
        return need <= self.free_pages and need <= self.cache_cfg.max_pages_per_seq

    def _peek_match(self, prompt_tokens: list[int],
                    namespace: bytes = b"",
                    chain: Optional[list] = None) -> tuple[int, int]:
        """(matched pages, matched pages currently evictable): a dry run
        of :meth:`match_prefix` that acquires nothing."""
        matched = evictable = 0
        for h in self._usable_chain(prompt_tokens, namespace, chain):
            page = self._hash_to_page.get(h)
            if page is None:
                break
            matched += 1
            evictable += 1 if page in self._evictable else 0
        return matched, evictable

    def can_admit(self, prompt_tokens: list, extra_tokens: int = 1,
                  namespace: bytes = b"",
                  chain: Optional[list] = None) -> bool:
        """Reuse-aware admission: a request whose prompt is mostly cached
        needs only the uncovered pages.  Matched-but-evictable pages count
        as free AND as matched, so they come off both sides."""
        need_total = self.pages_needed(len(prompt_tokens) + extra_tokens)
        if need_total > self.cache_cfg.max_pages_per_seq:
            return False
        matched, evictable = self._peek_match(list(prompt_tokens), namespace,
                                              chain)
        return need_total - matched <= self.free_pages - evictable

    def allocate(self, seq_id: str, n_tokens: int) -> list[int]:
        """Grow ``seq_id``'s table to cover ``n_tokens`` in total (shared
        prefix pages count toward the total)."""
        have = len(self._owned.get(seq_id, []))
        need_total = self.pages_needed(n_tokens)
        extra = need_total - have
        if need_total > self.cache_cfg.max_pages_per_seq:
            raise MemoryError(
                f"sequence of {n_tokens} tokens exceeds max_pages_per_seq="
                f"{self.cache_cfg.max_pages_per_seq}")
        if extra > self.free_pages:
            raise MemoryError(
                f"KV cache exhausted: need {extra} pages, have {self.free_pages}")
        pages = [self._take_free_page() for _ in range(max(0, extra))]
        self._owned.setdefault(seq_id, []).extend(pages)
        return pages

    def extend(self, seq_id: str, current_tokens: int, new_tokens: int) -> list[int]:
        return self.allocate(seq_id, current_tokens + new_tokens)

    # -- publishing ----------------------------------------------------------

    def register_blocks(self, seq_id: str, prompt_tokens: list[int],
                        namespace: bytes = b"",
                        chain: Optional[list] = None) -> None:
        """Content-address this sequence's full private prompt pages so
        later requests can share them.  ``chain`` is the prompt's FULL
        precomputed block-hash chain (uncapped: the publish covers every
        complete page, including the one :meth:`_usable_chain` leaves
        out of matching)."""
        ps = self.cache_cfg.page_size
        pages = self._owned.get(seq_id, [])
        hashes = (chain if chain is not None
                  else block_hashes(prompt_tokens, ps, namespace))
        for page, h in zip(pages, hashes):
            if page in self._page_hash:
                continue  # already published (shared prefix)
            if h in self._hash_to_page:
                continue  # another sequence's page already holds this content
            self._page_hash[page] = h
            self._hash_to_page[h] = page
            self._refs[page] = self._refs.get(page, 0) + 1

    def has_block(self, h: bytes) -> bool:
        """Is this content hash addressable in the pool right now?"""
        return h in self._hash_to_page

    # -- release -------------------------------------------------------------

    def _drop_page_ref(self, page: int) -> None:
        """One owner lets go of ``page``: unref shared or hashed pages
        (keeping their content as evictable at zero references), free
        private ones.  The base class's ``trim_window`` and ``release``
        route every drop through here, so a windowed sequence's trimmed
        pages keep the sharing semantics."""
        if page in self._refs:
            self._refs[page] -= 1
            if self._refs[page] <= 0:
                del self._refs[page]
                self._evictable[page] = None
                self._evictable.move_to_end(page)
        else:
            self._free.append(page)

    def release(self, seq_id: str) -> None:
        self._shared_of.pop(seq_id, None)
        super().release(seq_id)

    def prefix_hit_rate(self) -> float:
        if self.query_tokens_total == 0:
            return 0.0
        return self.hit_tokens_total / self.query_tokens_total
