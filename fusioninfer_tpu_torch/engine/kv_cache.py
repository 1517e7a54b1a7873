"""Paged KV cache (port of ``fusioninfer_tpu/engine/kv_cache.py``).

Device side: two stacked tensors ``[n_layers, n_kv_heads, n_pages,
page_size, head_dim]`` (k and v), head-major like the JAX package's pool.
With ``kv_dtype="int8"`` the pages hold int8 codes and two f32 scale
pools ``[n_layers, n_kv_heads, n_pages, 1, page_size]`` (k_scale,
v_scale) hold one scale per (token, head).
The last page is the reserved "trash" page padded positions write to.
Host side: a free-list allocator; allocation never touches the device.
A sliding-window model's pages wholly below its window are given back as
it decodes (:meth:`PageAllocator.trim_window`), their table entries
turned into trash-page placeholders.  Prefix caching
(``engine/prefix_cache.py``) subclasses it through the
:meth:`PageAllocator._drop_page_ref` and :meth:`PageAllocator.can_admit`
hooks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fusioninfer_tpu_torch.models.config import ModelConfig


@dataclass(frozen=True)
class CacheConfig:
    n_pages: int = 256  # includes the reserved trash page
    page_size: int = 128
    max_pages_per_seq: int = 32
    # "model" = pages in the model dtype; "int8" = per-(token, kv-head)
    # symmetric int8 pages plus f32 scales: Hd + 4 bytes per token and
    # head instead of 2·Hd in bf16
    kv_dtype: str = "model"

    @property
    def trash_page(self) -> int:
        return self.n_pages - 1

    @property
    def max_len(self) -> int:
        return self.max_pages_per_seq * self.page_size

    @property
    def quantized(self) -> bool:
        return self.kv_dtype == "int8"

    def validate(self) -> "CacheConfig":
        if self.page_size < 1 or self.n_pages < 2 or self.max_pages_per_seq < 1:
            raise ValueError(f"invalid cache config {self}")
        if self.kv_dtype not in ("model", "int8"):
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}")
        usable = self.n_pages - 1  # trash page reserved
        if self.max_pages_per_seq > usable:
            raise ValueError(
                f"max_pages_per_seq={self.max_pages_per_seq} exceeds usable pages "
                f"{usable} (n_pages={self.n_pages} minus the trash page)")
        return self


def init_kv_cache(cfg: ModelConfig, cache_cfg: CacheConfig,
                  device) -> dict:
    shape = (cfg.n_layers, cfg.n_kv_heads, cache_cfg.n_pages,
             cache_cfg.page_size, cfg.head_dim)
    if cache_cfg.quantized:
        scale_shape = (cfg.n_layers, cfg.n_kv_heads, cache_cfg.n_pages, 1,
                       cache_cfg.page_size)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(scale_shape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(scale_shape, dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
    }


def page_bytes(cfg: ModelConfig, page_size: int, kv_dtype: str = "model") -> int:
    """Device bytes one KV page costs (k + v, all layers)."""
    if kv_dtype == "int8":
        per_token = cfg.head_dim + 4  # int8 codes + one f32 scale
    else:
        per_token = cfg.head_dim * torch.empty((), dtype=cfg.torch_dtype).element_size()
    return 2 * cfg.n_layers * page_size * cfg.n_kv_heads * per_token


def model_param_bytes(cfg: ModelConfig) -> int:
    """Weight footprint from shapes alone (dense models)."""
    D, H, KV, Hd, Fd, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff, cfg.n_layers)
    per_layer = (D * H * Hd + 2 * D * KV * Hd + H * Hd * D + 3 * D * Fd
                 + 2 * D + (2 * Hd if cfg.qk_norm else 0))
    n = L * per_layer + cfg.vocab_size * D + D
    if not cfg.tie_embeddings:
        n += D * cfg.vocab_size
    return n * torch.empty((), dtype=cfg.torch_dtype).element_size()


# share of device memory weights + KV pool may take (vLLM's
# gpu_memory_utilization; the JAX engine's default)
HBM_UTILIZATION = 0.85


def auto_cache_config(cfg: ModelConfig, page_size: int, max_model_len: int,
                      max_batch_size: int, device,
                      kv_dtype: str = "model",
                      prefix_caching: bool = True) -> CacheConfig:
    """Size the page pool for ``max_batch_size`` sequences of
    ``max_model_len`` tokens.  On a CUDA device the request-shaped pool
    is first checked against ``torch.cuda.mem_get_info`` (total memory ×
    ``HBM_UTILIZATION`` minus the weights): a pool that cannot fit fails
    at startup instead of mid-serving.  With ``prefix_caching`` (the
    engine's default) released pages stay cached as evictable content,
    so pages beyond peak demand raise the hit rate: the pool then grows
    into the remaining memory, capped at 4× demand.  Without prefix
    caching, or off the card, the pool stays demand-sized: extra pages
    could never be allocated."""
    pages_per_seq = max(1, -(-max_model_len // page_size))
    min_pages = pages_per_seq * max_batch_size + 1
    n_pages = min_pages
    device = torch.device(device)
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        budget = int(total * HBM_UTILIZATION) - model_param_bytes(cfg)
        fit = budget // max(1, page_bytes(cfg, page_size, kv_dtype))
        if fit < min_pages:
            raise ValueError(
                f"model {cfg.name} with max_model_len={max_model_len} × "
                f"max_batch_size={max_batch_size} needs {min_pages} KV pages "
                f"but only {max(0, int(fit))} fit in {HBM_UTILIZATION:.0%} of "
                f"{total / 2**30:.1f} GiB after weights")
        if prefix_caching:
            n_pages = min(int(fit), 4 * min_pages)
    return CacheConfig(n_pages=n_pages, page_size=page_size,
                       max_pages_per_seq=pages_per_seq,
                       kv_dtype=kv_dtype).validate()


class PageAllocator:
    """Host-side free list over cache pages (trash page never handed out)."""

    def __init__(self, cache_cfg: CacheConfig):
        self.cache_cfg = cache_cfg
        self._free: list[int] = list(range(cache_cfg.n_pages - 1))
        self._owned: dict[str, list[int]] = {}
        self._trim_mark: dict[str, int] = {}  # seq -> pages already trimmed

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.cache_cfg.n_pages - 1) - len(self._free)

    def utilization(self) -> float:
        total = self.cache_cfg.n_pages - 1
        return 0.0 if total == 0 else self.used_pages / total

    def pages_needed(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.cache_cfg.page_size))

    def can_allocate(self, n_tokens: int) -> bool:
        need = self.pages_needed(n_tokens)
        return need <= len(self._free) and need <= self.cache_cfg.max_pages_per_seq

    def can_admit(self, prompt_tokens: list, extra_tokens: int = 1,
                  namespace: bytes = b"", chain=None) -> bool:
        """Admission check for a new request (the prefix-caching subclass
        counts the cached pages it would reuse; ``namespace`` and
        ``chain``, the prompt's precomputed block-hash chain, serve it)."""
        del namespace, chain  # no content addressing in the base allocator
        return self.can_allocate(len(prompt_tokens) + extra_tokens)

    def allocate(self, seq_id: str, n_tokens: int) -> list[int]:
        need = self.pages_needed(n_tokens)
        if need > len(self._free):
            raise MemoryError(f"KV cache exhausted: need {need} pages, have {len(self._free)}")
        if need > self.cache_cfg.max_pages_per_seq:
            raise MemoryError(
                f"sequence of {n_tokens} tokens exceeds "
                f"max_pages_per_seq={self.cache_cfg.max_pages_per_seq}")
        pages = [self._free.pop() for _ in range(need)]
        self._owned.setdefault(seq_id, []).extend(pages)
        return pages

    def extend(self, seq_id: str, current_tokens: int, new_tokens: int) -> list[int]:
        """Grow a sequence's page list to cover ``current + new`` tokens."""
        have = len(self._owned.get(seq_id, []))
        need_total = self.pages_needed(current_tokens + new_tokens)
        if need_total > self.cache_cfg.max_pages_per_seq:
            raise MemoryError("sequence exceeds max_pages_per_seq")
        extra = need_total - have
        if extra <= 0:
            return []
        if extra > len(self._free):
            raise MemoryError("KV cache exhausted on extend")
        pages = [self._free.pop() for _ in range(extra)]
        self._owned[seq_id].extend(pages)
        return pages

    def pages_of(self, seq_id: str) -> list[int]:
        return list(self._owned.get(seq_id, []))

    def _drop_page_ref(self, page: int) -> None:
        """One owner lets go of ``page``.  Subclass hook: the prefix-
        caching allocator unrefs shared pages here instead of freeing."""
        self._free.append(page)

    def trim_window(self, seq_id: str, first_live_page: int) -> int:
        """Sliding-window reclamation: drop the pages wholly below the
        window (indices < ``first_live_page``), leaving trash-page
        placeholders so that table positions keep their mapping.  The
        walks start at the window's first live page, so a trimmed entry is
        never read.  A per-sequence watermark makes the per-step call
        O(pages newly below the window).  Returns the pages dropped."""
        pages = self._owned.get(seq_id)
        if not pages:
            return 0
        trash = self.cache_cfg.trash_page
        start = self._trim_mark.get(seq_id, 0)
        end = min(first_live_page, len(pages))
        freed = 0
        for i in range(start, end):
            if pages[i] != trash:
                self._drop_page_ref(pages[i])
                pages[i] = trash
                freed += 1
        if end > start:
            self._trim_mark[seq_id] = end
        return freed

    def release(self, seq_id: str) -> None:
        trash = self.cache_cfg.trash_page
        self._trim_mark.pop(seq_id, None)
        for page in self._owned.pop(seq_id, []):
            if page != trash:
                self._drop_page_ref(page)

    def page_table_row(self, seq_id: str) -> np.ndarray:
        """Fixed-width page table row, trash-padded."""
        row = np.full(self.cache_cfg.max_pages_per_seq,
                      self.cache_cfg.trash_page, np.int32)
        pages = self._owned.get(seq_id, [])
        row[: len(pages)] = pages
        return row
