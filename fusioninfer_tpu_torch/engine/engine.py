"""Continuous-batching inference engine (port of the serve path of
``fusioninfer_tpu/engine/engine.py``).

Admits requests into a running batch (same-bucket fresh prompts prefill
as one batch), then advances every running sequence one token per
:meth:`NativeEngine.step` with one batched decode step over the paged
pool.  Under KV pressure the youngest sequence (latest arrival) is
preempted: its pages are released and the request re-queued with its
tokens so far, to be re-prefilled.

This port serves the configuration ``engine serve`` runs by default
without prefix caching: monolithic prefill, one decode step per engine
step, bf16 KV pages.  Prefix caching, chunked prefill, fused steps,
speculative decoding, LoRA, guided decoding and the PD/KV fabric are
later slices and are absent here, not switched off.

Concurrency: one engine-loop thread owns all scheduling state and is the
only caller of :meth:`step`; other threads enter only through the locked
:meth:`add_request` / :meth:`cancel` edges.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from fusioninfer_tpu_torch.engine.kv_cache import (
    CacheConfig,
    PageAllocator,
    init_kv_cache,
)
from fusioninfer_tpu_torch.engine.model_runner import (
    decode_step,
    pick_bucket,
    prefill,
    prefill_buckets,
)
from fusioninfer_tpu_torch.engine.sampler import (
    SamplingParams,
    apply_penalties,
    sample,
)
from fusioninfer_tpu_torch.engine.sched import TokenBudget
from fusioninfer_tpu_torch.models.config import ModelConfig
from fusioninfer_tpu_torch.models.transformer import init_params
from fusioninfer_tpu_torch.ops.paged_attention import pick_kv_splits

logger = logging.getLogger("fusioninfer.torch.engine")


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``cuda`` unless the caller asks for another.
    A CUDA device without CUDA raises; there is no CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run "
            "the plain PyTorch path on the CPU")
    return dev


@dataclass
class Request:
    request_id: str
    prompt_tokens: list[int]
    params: SamplingParams = field(default_factory=SamplingParams)
    # < 0 means "not stamped yet": add_request stamps it on the engine clock
    arrival_time: float = -1.0
    # set on preemption: prompt + tokens generated so far, re-prefilled on
    # re-admission so the stream continues where it stopped
    resume_tokens: Optional[list[int]] = None


@dataclass
class StepOutput:
    request_id: str
    token: int
    finished: bool
    finish_reason: Optional[str] = None
    is_first_token: bool = False


@dataclass
class _SeqState:
    request: Request
    tokens: list[int]  # prompt + generated
    n_prompt: int
    slot: int
    seed: int = 0

    @property
    def n_generated(self) -> int:
        return len(self.tokens) - self.n_prompt


class _WaitQueue:
    """(arrival, tiebreak) heap: FCFS; a preempted request keeps its
    arrival and so returns ahead of later arrivals."""

    def __init__(self):
        self._heap: list[tuple] = []
        self._tie = itertools.count()

    def push(self, request: Request) -> None:
        heapq.heappush(self._heap, (request.arrival_time, next(self._tie),
                                    request))

    def peek(self) -> Request:
        return self._heap[0][2]

    def pop(self) -> Request:
        return heapq.heappop(self._heap)[2]

    def remove_ids(self, ids: set[str]) -> int:
        kept = [e for e in self._heap if e[2].request_id not in ids]
        removed = len(self._heap) - len(kept)
        if removed:
            self._heap = kept
            heapq.heapify(self._heap)
        return removed

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class NativeEngine:
    def __init__(self, cfg: ModelConfig,
                 cache_cfg: Optional[CacheConfig] = None,
                 max_batch_size: int = 8, params: Optional[dict] = None,
                 seed: int = 0, device=None, kv_splits: Optional[int] = None):
        """``device``: where weights, pool and every forward live; None
        means ``cuda`` (raises without CUDA).  ``params``: the port's
        parameter dict (e.g. from :func:`convert.params_from_jax`), moved
        to ``device``; None draws random weights from ``seed``.
        ``kv_splits``: decode's split-walk fan-out; None picks it once from
        the static cache config (:func:`ops.paged_attention.pick_kv_splits`),
        0 forces the single walk."""
        self.cfg = cfg.validate()
        self.cache_cfg = (cache_cfg or CacheConfig()).validate()
        self.device = resolve_device(device)
        self.max_batch_size = max_batch_size
        if params is None:
            logger.info("initializing random weights for %s", cfg.name)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, self.device)
        else:
            params = _to_device(params, self.device)
        self.params = params
        self.cache = init_kv_cache(cfg, self.cache_cfg, self.device)
        self.alloc = PageAllocator(self.cache_cfg)
        self.buckets = prefill_buckets(self.cache_cfg.max_len)
        self.kv_splits = (pick_kv_splits(self.cache_cfg.max_pages_per_seq,
                                         self.cache_cfg.page_size)
                          if kv_splits is None else kv_splits)
        self._seed_counter = itertools.count(1)
        self._base_seed = seed
        V = cfg.vocab_size
        # per-slot penalty state: prompt+output counts (repetition) and
        # output-only counts (presence/frequency); stop-id suppression
        self._token_counts = torch.zeros((max_batch_size, V), dtype=torch.int32,
                                         device=self.device)
        self._output_counts = torch.zeros_like(self._token_counts)
        self._suppress = torch.zeros((max_batch_size, V), dtype=torch.bool,
                                     device=self.device)
        self.waiting = _WaitQueue()
        self.running: dict[int, _SeqState] = {}  # slot -> state
        self._free_slots = list(reversed(range(max_batch_size)))
        self._cancelled: set[str] = set()
        self._lock = threading.Lock()
        self.sched = TokenBudget()
        # counters (stats / the server's /health)
        self.prompt_tokens_total = 0
        self.generation_tokens_total = 0
        self.preemptions_total = 0
        self.finished_total = 0
        self.errors_total = 0
        self.cancelled_total = 0

    # -- public API ----------------------------------------------------------

    def add_request(self, request: Request) -> None:
        if request.params.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if not request.prompt_tokens:
            raise ValueError("prompt must not be empty")
        if len(request.prompt_tokens) + request.params.max_tokens > self.cache_cfg.max_len:
            raise ValueError(
                f"prompt+max_tokens exceeds engine max_len {self.cache_cfg.max_len}")
        V = self.cfg.vocab_size
        if any(not 0 <= t < V for t in request.prompt_tokens):
            raise ValueError(f"prompt token outside vocab [0, {V})")
        if any(not 0 <= t < V for t in request.params.stop_token_ids):
            raise ValueError(f"stop token id outside vocab [0, {V})")
        if request.arrival_time < 0:
            request.arrival_time = time.monotonic()
        with self._lock:
            self.waiting.push(request)

    def cancel(self, request_id: str) -> None:
        """Abandon a request; takes effect at the next step."""
        with self._lock:
            self._cancelled.add(request_id)

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def step(self) -> list[StepOutput]:
        """Admit + prefill new work, then one batched decode pass."""
        self._process_cancellations()
        self.sched.begin_step()
        outputs = self._admit()
        outputs += self._decode()
        return outputs

    # -- scheduling ----------------------------------------------------------

    def _process_cancellations(self) -> None:
        with self._lock:
            cancelled, self._cancelled = self._cancelled, set()
            if not cancelled:
                return
            self.cancelled_total += self.waiting.remove_ids(cancelled)
        for state in [s for s in self.running.values()
                      if s.request.request_id in cancelled]:
            self._finish(state, outcome="cancelled")

    def _admit(self) -> list[StepOutput]:
        """Admit waiting requests in arrival order while slots and pages
        allow, then prefill same-bucket fresh prompts as one batch each
        (groups of power-of-two size, as the JAX engine groups them)."""
        outputs: list[StepOutput] = []
        pending: list[tuple[Request, list[int], bool]] = []
        while True:
            if len(self._free_slots) <= len(pending):
                with self._lock:
                    head = self.waiting.peek().arrival_time if self.waiting else None
                if head is None or not self._preempt_youngest(
                        exclude_slot=-1, than_arrival=head):
                    break
                continue
            with self._lock:
                if not self.waiting:
                    break
                request = self.waiting.pop()
            prefix = request.resume_tokens or request.prompt_tokens
            blocked = False
            while not self.alloc.can_allocate(len(prefix) + 1):
                if not self._preempt_youngest(exclude_slot=-1,
                                              than_arrival=request.arrival_time):
                    with self._lock:
                        self.waiting.push(request)
                    blocked = True
                    break
            if blocked:
                break
            resumed = request.resume_tokens is not None
            request.resume_tokens = None
            pending.append((request, prefix, resumed))

        fresh: list[tuple[Request, list[int], bool]] = []
        for idx, (request, prefix, resumed) in enumerate(pending):
            try:
                self.alloc.allocate(request.request_id, len(prefix) + 1)
            except MemoryError:
                # capacity raced ahead of the pop-time check: back-pressure,
                # requeue the rest in order and stop admitting
                self.alloc.release(request.request_id)
                self._requeue(pending[idx:])
                break
            fresh.append((request, prefix, resumed))

        by_bucket: dict[int, list] = {}
        for item in fresh:
            by_bucket.setdefault(pick_bucket(self.buckets, len(item[1])), []).append(item)
        for bucket in sorted(by_bucket):
            items = by_bucket[bucket]
            while items:
                n = 1 << (len(items).bit_length() - 1)
                group, items = items[:n], items[n:]
                outputs.extend(self._prefill_group(bucket, group))
        return outputs

    def _requeue(self, items) -> None:
        with self._lock:
            for request, prefix, resumed in items:
                if resumed:
                    request.resume_tokens = list(prefix)
                self.waiting.push(request)

    def _preempt_youngest(self, exclude_slot: int,
                          than_arrival: Optional[float] = None) -> bool:
        """Release the youngest running sequence (≠ exclude) back to
        waiting.  With ``than_arrival`` only a victim that arrived strictly
        later than the displacing work is taken."""
        cands = [s for s in self.running if s != exclude_slot]
        if not cands:
            return False
        slot = max(cands, key=lambda s: self.running[s].request.arrival_time)
        if (than_arrival is not None
                and self.running[slot].request.arrival_time <= than_arrival):
            return False
        self._preempt_slot(slot)
        return True

    def _preempt_slot(self, slot: int) -> None:
        state = self.running.pop(slot)
        self.alloc.release(state.request.request_id)
        self._free_slots.append(slot)
        self.preemptions_total += 1
        state.request.resume_tokens = list(state.tokens)
        with self._lock:
            self.waiting.push(state.request)
        logger.info("preempted %s for KV capacity", state.request.request_id)

    def _request_seed(self, request: Request) -> int:
        if request.params.seed is not None:
            return int(request.params.seed)
        # unseeded: stable per engine seed + admission order
        return (self._base_seed * 1_000_003 + next(self._seed_counter)) & 0x7FFFFFFF

    def _prefill_group(self, bucket: int, items) -> list[StepOutput]:
        """One batched prefill forward for same-bucket prompts; a failed
        forward fails (and releases) the whole group."""
        B = len(items)
        mp = self.cache_cfg.max_pages_per_seq
        padded = np.zeros((B, bucket), np.int64)
        rows = np.full((B, mp), self.cache_cfg.trash_page, np.int64)
        lens = np.zeros((B,), np.int64)
        for i, (request, prefix, _) in enumerate(items):
            padded[i, : len(prefix)] = prefix
            rows[i] = self.alloc.page_table_row(request.request_id)
            lens[i] = len(prefix)
        try:
            logits = prefill(self.cfg, self.cache_cfg, self.params, self.cache,
                             self._tensor(padded), self._tensor(lens),
                             self._tensor(rows))
        except (RuntimeError, ValueError) as e:
            logger.exception("batched prefill of %d requests failed", B)
            outputs = []
            for request, _, _ in items:
                self.alloc.release(request.request_id)
                outputs.append(self._fail(request, e))
            return outputs
        self.sched.charge_weight_pass()
        self.sched.charge_prefill(sum(len(p) for _, p, _ in items))
        return self._activate_group(items, logits)

    def _activate_group(self, items, logits: torch.Tensor) -> list[StepOutput]:
        """Sample each prompt's first token with its full sampling
        semantics, claim a slot, install the slot's penalty rows, emit."""
        B, V = logits.shape
        dev = self.device
        counts = torch.zeros((B, V), dtype=torch.int32, device=dev)
        outs = torch.zeros_like(counts)
        sup = torch.zeros((B, V), dtype=torch.bool, device=dev)
        seeds, gens = [], []
        for i, (request, prefix, _) in enumerate(items):
            n_prompt = len(request.prompt_tokens)
            ids = self._tensor(np.asarray(prefix, np.int64))
            counts[i].index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
            outs[i].index_add_(0, ids[n_prompt:],
                               torch.ones_like(ids[n_prompt:], dtype=torch.int32))
            p = request.params
            if p.min_tokens > 0 and p.stop_token_ids:
                sup[i, list(p.stop_token_ids)] = True
            seeds.append(self._request_seed(request))
            gens.append(len(prefix) - n_prompt)
        params = [r.params for r, _, _ in items]
        tokens = self._sample(logits, params, counts, outs, sup, seeds, gens)
        outputs = []
        for i, (request, prefix, resumed) in enumerate(items):
            token = tokens[i]
            slot = self._free_slots.pop()
            state = _SeqState(request=request, tokens=list(prefix) + [token],
                              n_prompt=len(request.prompt_tokens), slot=slot,
                              seed=seeds[i])
            counts[i, token] += 1
            outs[i, token] += 1
            self._token_counts[slot] = counts[i]
            self._output_counts[slot] = outs[i]
            self._suppress[slot] = sup[i]
            self.running[slot] = state
            if not resumed:
                self.prompt_tokens_total += len(prefix)
            self.generation_tokens_total += 1
            outputs.append(self._emit(state, token, first=not resumed))
        return outputs

    def _sample(self, logits, params: list[SamplingParams], counts, outs, sup,
                seeds: list[int], gen_counts: list[int]) -> list[int]:
        """Penalties → min-tokens suppression → sample, for rows aligned
        with ``params`` (host ints out)."""
        dev = self.device

        def col(vals, dtype):
            return torch.tensor(vals, dtype=dtype, device=dev)

        if any(p.needs_token_counts for p in params):
            logits = apply_penalties(
                logits, counts, outs,
                col([p.presence_penalty for p in params], torch.float32),
                col([p.frequency_penalty for p in params], torch.float32),
                col([p.repetition_penalty for p in params], torch.float32))
        early = [g < p.min_tokens for p, g in zip(params, gen_counts)]
        if any(early):
            logits = torch.where(col(early, torch.bool)[:, None] & sup,
                                 torch.tensor(float("-inf"), device=dev), logits)
        toks = sample(logits,
                      col([p.temperature for p in params], torch.float32),
                      col([p.top_k for p in params], torch.int64),
                      col([p.top_p for p in params], torch.float32),
                      col([p.min_p for p in params], torch.float32),
                      seeds, gen_counts)
        return [int(t) for t in toks.tolist()]

    # -- decode --------------------------------------------------------------

    def _decode(self) -> list[StepOutput]:
        failures = self._ensure_decode_capacity()
        live = {s: st for s, st in self.running.items()
                if st.n_generated < st.request.params.max_tokens}
        if not live:
            return failures
        B = self.max_batch_size
        mp = self.cache_cfg.max_pages_per_seq
        tokens = np.zeros((B,), np.int64)
        positions = np.zeros((B,), np.int32)
        tables = np.full((B, mp), self.cache_cfg.trash_page, np.int32)
        active = np.zeros((B,), bool)
        for slot, st in live.items():
            tokens[slot] = st.tokens[-1]
            # the input token was sampled last step; its KV lands at len-1
            positions[slot] = len(st.tokens) - 1
            tables[slot] = self.alloc.page_table_row(st.request.request_id)
            active[slot] = True
        logits = decode_step(self.cfg, self.cache_cfg, self.params, self.cache,
                             self._tensor(tokens), self._tensor(positions),
                             self._tensor(tables), self._tensor(active),
                             kv_splits=self.kv_splits)
        self.sched.charge_weight_pass()
        slots = sorted(live)
        idx = torch.tensor(slots, device=self.device)
        params = [live[s].request.params for s in slots]
        sampled = self._sample(
            logits[idx], params, self._token_counts[idx], self._output_counts[idx],
            self._suppress[idx], [live[s].seed for s in slots],
            [live[s].n_generated for s in slots])
        tok_t = torch.tensor(sampled, device=self.device)
        self._token_counts[idx, tok_t] += 1
        self._output_counts[idx, tok_t] += 1
        self.sched.charge_decode(len(live))
        outputs = list(failures)
        for slot, token in zip(slots, sampled):
            st = live[slot]
            st.tokens.append(token)
            self.generation_tokens_total += 1
            outputs.append(self._emit(st, token))
        return outputs

    def _ensure_decode_capacity(self) -> list[StepOutput]:
        """Grow page tables for rows crossing a page boundary; on
        exhaustion preempt youngest-first so the oldest proceed."""
        failures: list[StepOutput] = []
        for slot in sorted(self.running,
                           key=lambda s: self.running[s].request.arrival_time):
            st = self.running.get(slot)
            if st is None or st.n_generated >= st.request.params.max_tokens:
                continue
            while True:
                try:
                    # input token occupies index len-1 -> len tokens covered
                    self.alloc.extend(st.request.request_id, len(st.tokens) - 1, 1)
                    break
                except MemoryError:
                    if self._preempt_youngest(exclude_slot=slot,
                                              than_arrival=st.request.arrival_time):
                        continue
                    if len(self.running) > 1:
                        self._preempt_slot(slot)
                        break
                    logger.error("request %s exceeds total KV capacity",
                                 st.request.request_id)
                    self._finish(st, outcome="error")
                    failures.append(StepOutput(
                        request_id=st.request.request_id, token=st.tokens[-1],
                        finished=True, finish_reason="error:kv_capacity"))
                    break
        return failures

    # -- bookkeeping ---------------------------------------------------------

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _fail(self, request: Request, e: Exception) -> StepOutput:
        self.errors_total += 1
        return StepOutput(request_id=request.request_id, token=0, finished=True,
                          finish_reason=f"error:{e}")

    def _emit(self, state: _SeqState, token: int,
              first: bool = False) -> StepOutput:
        params = state.request.params
        finish_reason = None
        if token in params.stop_token_ids:
            finish_reason = "stop"
        elif state.n_generated >= params.max_tokens:
            finish_reason = "length"
        if finish_reason:
            self._finish(state)
        return StepOutput(request_id=state.request.request_id, token=token,
                          finished=finish_reason is not None,
                          finish_reason=finish_reason, is_first_token=first)

    def _finish(self, state: _SeqState, outcome: str = "finished") -> None:
        self.running.pop(state.slot, None)
        self._free_slots.append(state.slot)
        self.alloc.release(state.request.request_id)
        if outcome == "finished":
            self.finished_total += 1
        elif outcome == "cancelled":
            self.cancelled_total += 1
        else:
            self.errors_total += 1


def _to_device(params: dict, device: torch.device) -> dict:
    out = {k: v.to(device) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: v.to(device) for k, v in params["layers"].items()}
    return out
