"""Continuous-batching inference engine (port of the serve path of
``fusioninfer_tpu/engine/engine.py``).

Admits requests into a running batch, then advances every running
sequence one token per :meth:`NativeEngine.step`.  As in the JAX engine:

* **Prefix caching** (on by default): full prompt pages are
  content-addressed (:mod:`engine.prefix_cache`); a request reuses the
  longest cached chain and computes only its suffix.  In one admission
  round only the first of several identical prompts prefills; the others
  defer a round and hit its pages.
* **Token budget**: each step may process ``token_budget`` tokens, the
  running batch's decode tokens first; the remainder buys prefill.  A
  prompt (or cache-miss suffix) longer than the chunk size, or over the
  step's remainder, prefills in budgeted chunks across steps while the
  batch keeps decoding (:class:`_PrefillingState`).
* **One ragged forward**: every forward that reads paged context (decode
  rows, cache-hit suffixes, chunk advances) packs a
  :class:`engine.fused.RaggedBatch` and runs
  :func:`model_runner.fused_step`; with ``fused_step`` on, a step that
  has both decode rows and chunk rows runs them in ONE forward.  Fresh
  prompts that need no chunking prefill through flash attention, same-
  bucket ones as one batch.
* **Preemption** under KV pressure takes the youngest sequence, running
  or mid-prefill, never one older than the work displacing it.  With
  prefix caching its written pages are parked as cached content first,
  so its re-admission recomputes at most one page.
* **Speculative decoding** (``speculative_k``): n-gram drafts from a
  row's own context (:class:`engine.spec.NgramProposer`) ride its decode
  window, the input token and up to k drafts scored by the same ragged
  forward; every live row rides a window of ``1 + k`` slots.  A greedy
  row accepts drafts while they equal the window's argmax; a sampled row
  by delta-draft rejection sampling (:func:`sampler.spec_window_draws`).
  Rows with penalties, logprobs or ``logit_bias``, or still under
  ``min_tokens``, take no drafts.
* **The candidate sampler**: a row with ``0 < top_k <= 64`` and
  ``min_p`` off draws from its 64 best logits in ``lax.top_k``'s order
  (:func:`sampler.sample_topk`), as the JAX engine's fused lm_head
  top-k path and its unfused sampler both do.  The port has the one
  decode tail: the lm_head product already runs as one GEMM over the
  slot rows, so projecting inside the sampler would only move it.
* **logprobs and logit_bias**: logprobs come from the raw
  (unpenalized) logits; a request's bias is added after the penalties
  and the min-tokens suppression, at admission and every decode step.
* **Guided decoding** (``response_format`` json_object / json_schema):
  a request's byte machine (:func:`guided.machine_for`) masks every
  token whose bytes the grammar does not allow
  (:class:`token_mask.GrammarTokenMasker`, after the penalties and the
  min-tokens suppression) at its first token and every decode step, and
  finishes it with ``"stop"`` the moment its top-level value closes.
  Guided rows take no drafts and ride no burst: they step once a pass
  beside the rest of the batch.  A resumed request replays its
  generated tokens through a fresh machine.
* **Decode bursts** (``decode_burst_steps`` > 1): the running rows take
  up to that many decode + sample steps in one dispatch
  (:func:`model_runner.decode_burst`, replayed as a CUDA graph on the
  card by :class:`engine.graphs.BurstRunner`), each sampled token fed
  back on the device.  The span is 1 or ``decode_burst_steps`` and
  clamps to 1 while admission work is pending; rows that need host work
  each token (guided masks, logprobs, ``logit_bias``) step one token in
  the same pass.
  With ``pipeline_bursts`` the successor burst is dispatched from the
  device-side control carry before the current one's tokens are read.
* **Sliding windows** (``cfg.sliding_window``): the walks start at the
  page that holds a query's first visible key, so a decoding row's pages
  wholly below its window are given back
  (:meth:`PageAllocator.trim_window`) before it asks for new ones, and
  before a successor burst is priced, and a sequence holds about a
  window of pages however long it runs.  Preempted windowed rows are
  not parked in the prefix cache (their tables hold trash placeholders).
* **Row-invariant forwards**: on the card every projection and norm
  reduces a row in an order fixed by the weight's shape (:mod:`ops.gemm`,
  :mod:`ops.rms_norm`) and the walks' per-token bits do not depend on
  the other rows, so a forward runs over its live tokens and a stream's
  tokens do not depend on what shares its forwards
  (:func:`model_runner.fused_step`).

Left out, and absent rather than switched off: LoRA,
SLO tiers and priorities (the wait queue orders by arrival), deadlines,
the host KV tier and the PD/KV fabric.

Concurrency: one engine-loop thread owns all scheduling state and is the
only caller of :meth:`step`; other threads enter only through the locked
:meth:`add_request` / :meth:`cancel` edges.
"""

from __future__ import annotations

import collections
import heapq
import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from fusioninfer_tpu_torch.engine.fused import pack_ragged_batch, pow2_rows
from fusioninfer_tpu_torch.engine.graphs import BurstRunner
from fusioninfer_tpu_torch.engine.guided import (
    SchemaByteMachine,
    compile_schema_str,
    machine_for,
)
from fusioninfer_tpu_torch.engine.kv_cache import (
    CacheConfig,
    PageAllocator,
    init_kv_cache,
)
from fusioninfer_tpu_torch.engine.model_runner import (
    fused_step,
    pick_bucket,
    prefill,
    prefill_buckets,
)
from fusioninfer_tpu_torch.engine.prefix_cache import PrefixCachingAllocator
from fusioninfer_tpu_torch.engine.sampler import (
    SamplingParams,
    apply_penalties,
    sample,
    sample_mode,
    spec_window_draws,
    topk_ordered,
)
from fusioninfer_tpu_torch.engine.sched import TokenBudget, derive_token_budget
from fusioninfer_tpu_torch.engine.spec import NgramProposer
from fusioninfer_tpu_torch.engine.token_mask import GrammarTokenMasker
from fusioninfer_tpu_torch.models.config import ModelConfig
from fusioninfer_tpu_torch.models.transformer import init_params, tied_head
from fusioninfer_tpu_torch.ops.paged_attention import (
    engine_cluster_size,
    pick_kv_splits,
)
from fusioninfer_tpu_torch.utils.blockhash import block_hashes

logger = logging.getLogger("fusioninfer.torch.engine")

# prefix-cache hits whose un-cached suffix is at most this many tokens
# batch through ONE ragged forward
_SUFFIX_BATCH_WINDOW = 128


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
    # re-admission so the stream continues where it stopped (with prefix
    # caching the re-prefill hits the pages the preemption parked)
    resume_tokens: Optional[list[int]] = None
    # set by every preemption (mid-decode and mid-prefill, where
    # resume_tokens stays None: nothing was emitted yet); cleared when the
    # re-admission is counted in the preempt-resume ledger
    was_preempted: bool = False


@dataclass
class StepOutput:
    request_id: str
    token: int
    finished: bool
    finish_reason: Optional[str] = None
    is_first_token: bool = False
    logprob: Optional[float] = None  # set when the request asked for logprobs
    top_logprobs: Optional[dict[int, float]] = None  # token id -> logprob


@dataclass
class _SeqState:
    request: Request
    tokens: list[int]  # prompt + generated
    n_prompt: int
    slot: int
    seed: int = 0
    # the request's guided byte machine (JsonByteMachine or
    # SchemaByteMachine), advanced by every emitted token; None = unguided
    guided: Optional[object] = None

    @property
    def n_generated(self) -> int:
        return len(self.tokens) - self.n_prompt


@dataclass
class _PrefillingState:
    """A prompt mid-chunked-prefill: pages are allocated, ``pos`` tokens
    are already in the KV pages, no batch slot yet (one is reserved:
    admission counts prefilling toward slot pressure)."""

    request: Request
    prefix: list[int]  # full token prefix to write (prompt, or resume tokens)
    resumed: bool
    pos: int  # next global position to write (starts at the reused length)


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
                 seed: int = 0, device=None, kv_splits: Optional[int] = None,
                 enable_prefix_caching: bool = True,
                 prefill_chunk_size: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 fused_step: bool = True,
                 speculative_k: Optional[int] = None,
                 decode_burst_steps: int = 1,
                 pipeline_bursts: bool = True):
        """``device``: where weights, pool and every forward live; None
        means ``cuda`` (raises without CUDA).  ``params``: the port's
        parameter dict (e.g. from :func:`convert.params_from_jax`), moved
        to ``device``; None draws random weights from ``seed``.
        ``kv_splits``: the split-walk fan-out; None picks it once from
        the static cache config (:func:`ops.paged_attention.pick_kv_splits`),
        0 forces the single walk.

        ``enable_prefix_caching``: content-address full prompt pages and
        reuse the longest cached prefix across requests.
        ``prefill_chunk_size``: a prompt (or cache-miss suffix) longer than
        this prefills in budgeted chunks across steps; without
        ``token_budget`` it also seeds the budget.  ``token_budget``:
        tokens one :meth:`step` may process, decode charged first;
        None with no chunk size means monolithic prefill.
        ``fused_step``: a step with both decode rows and prefill chunks
        runs them in one forward; output streams are the same either way,
        on the card as on the CPU: a row's bits depend on nothing else
        that rides its forward (:func:`model_runner.fused_step`), so a
        stream's tokens are the same alone, in a batch and beside a
        chunk.  ``speculative_k``: n-gram speculative decoding with up to
        this many drafts a row and step (None = off); greedy streams are
        token-identical with it on or off, on the card as on the CPU.

        ``decode_burst_steps``: up to this many decode + sample steps a
        dispatch for the rows that need no host work each token (1 =
        per-token stepping); burst engines keep the split path whatever
        ``fused_step`` says, and speculation forces span 1.
        ``pipeline_bursts``: dispatch the successor burst before reading
        the current one's tokens while the running set holds still.
        Streams are the same with bursts on or off, pipelined or not."""
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
        if self.device.type == "cuda":
            params = tied_head(params)  # the GEMM kernel reads [D, V] in place
        self.params = params
        self.cache = init_kv_cache(cfg, self.cache_cfg, self.device)
        self.prefix_caching = enable_prefix_caching
        self.alloc = (PrefixCachingAllocator(self.cache_cfg)
                      if enable_prefix_caching else PageAllocator(self.cache_cfg))
        self.buckets = prefill_buckets(self.cache_cfg.max_len)
        mp = self.cache_cfg.max_pages_per_seq
        self.kv_splits = (pick_kv_splits(mp, self.cache_cfg.page_size)
                          if kv_splits is None else kv_splits)
        # the single walk's cluster size, fixed once from static shapes so
        # that a row's bits never depend on what shares its launch; sized
        # for one token a slot also when the slots carry spec windows
        # (measured faster at that shape than the size fixed from
        # B·(1 + speculative_k) tokens, PERF.md)
        self.walk_cluster = (engine_cluster_size(max_batch_size, cfg.n_kv_heads,
                                                 mp, self.device)
                             if self.kv_splits == 0 else None)
        # descriptor rows and the chunk lm_head group are pinned per engine,
        # as in the JAX engine: R = pow2(2B), NC = pow2(B)
        self._ragged_rows = pow2_rows(2 * max_batch_size)
        self._ragged_chunk_rows = pow2_rows(max_batch_size)
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
        self.prefilling: list[_PrefillingState] = []  # FCFS chunk queue
        # request_id -> the prompt's block-hash chain, computed once at
        # admission and consumed by match_prefix and register_blocks
        self._admission_chains: dict[str, list] = {}
        self._free_slots = list(reversed(range(max_batch_size)))
        self._cancelled: set[str] = set()
        self._lock = threading.Lock()
        if prefill_chunk_size is not None and prefill_chunk_size < 1:
            raise ValueError("prefill_chunk_size must be >= 1")
        if token_budget is not None and token_budget < 1:
            raise ValueError("token_budget must be >= 1")
        if token_budget is None and prefill_chunk_size is not None:
            token_budget = prefill_chunk_size
        self.prefill_chunk = prefill_chunk_size
        self.sched = TokenBudget(token_budget)
        if self.prefill_chunk is None and token_budget is not None:
            # the budget is the chunking threshold
            self.prefill_chunk = token_budget
        self._step_prefill_left = 0  # set by step(); spent by _admit
        self.fused_step_enabled = fused_step
        if speculative_k is not None and speculative_k < 1:
            raise ValueError("speculative_k must be >= 1")
        self.spec_k = speculative_k
        self.proposer = NgramProposer() if speculative_k else None
        if decode_burst_steps < 1:
            raise ValueError("decode_burst_steps must be >= 1")
        self.burst_steps = decode_burst_steps
        self.pipeline_bursts = pipeline_bursts
        # the dispatched burst whose tokens are not read yet: (handle,
        # {slot: state} it decodes, span, mode)
        self._inflight = None
        self.bursts = BurstRunner(self) if decode_burst_steps > 1 else None
        # the only two spans a dispatch can record, seeded as the JAX
        # ledger seeds them
        self.sched.burst_span_steps[1] = 0
        if decode_burst_steps > 1:
            self.sched.burst_span_steps[decode_burst_steps] = 0
        # slot -> (ids, vals) device tensors of a request's logit_bias,
        # built once at activation
        self._slot_bias: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        # guided decoding: the grammar token masker over the vocab's byte
        # strings (set_guided_vocab; None = guided requests rejected), and
        # device [V] legality rows keyed by (slot, machine signature): in a
        # string or digit run the signatures repeat step after step, so a
        # row's mask is uploaded once, not every step
        self._masker = None
        self._guided_legal_dev: collections.OrderedDict = collections.OrderedDict()
        # counters (stats / the server's /health)
        self.prompt_tokens_total = 0
        self.generation_tokens_total = 0
        self.preemptions_total = 0
        self.finished_total = 0
        self.errors_total = 0
        self.cancelled_total = 0
        # drafts proposed and accepted, counting emitted drafts only (a
        # finish mid-window discards the rest)
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        # pages a sliding window gave back while its rows decoded
        self.window_pages_trimmed_total = 0

    # -- public API ----------------------------------------------------------

    def set_guided_vocab(self, token_bytes) -> None:
        """Install per-token byte strings (``[V]`` list of bytes or None,
        :func:`token_mask.token_byte_strings`) and build the grammar token
        masker: guided decoding then works for any tokenizer whose vocab
        has a byte mapping."""
        V = self.cfg.vocab_size
        tb = list(token_bytes)[:V]
        tb += [None] * (V - len(tb))  # the model's vocab may exceed the tokenizer's
        self._masker = GrammarTokenMasker(tb)
        # rows cached under a previous vocab would mask by its byte strings
        self._guided_legal_dev.clear()

    @property
    def guided_enabled(self) -> bool:
        return self._masker is not None

    @property
    def token_budget(self) -> Optional[int]:
        return self.sched.tokens_per_step

    def set_token_budget(self, tokens_per_step: int) -> None:
        """Install (or retune) the per-step token budget; enables budgeted
        chunked prefill on an engine built without one."""
        if tokens_per_step < 1:
            raise ValueError("token_budget must be >= 1")
        self.sched.tokens_per_step = tokens_per_step
        if self.prefill_chunk is None:
            self.prefill_chunk = tokens_per_step

    def calibrate_token_budget(self, target_step_s: float = 0.05,
                               floor: int = 32, cap: int = 4096) -> int:
        """Derive the token budget from a MEASURED forward: time one
        suffix-prefill forward of up to 256 tokens on this engine's path
        (the ragged walk, as serving runs it), convert tokens/second into
        the tokens/step that keep a step under ``target_step_s``, and
        install it.  The probe writes into scratch pages released before
        returning (pages are overwritten before they are read)."""
        n = min(256, self.buckets[-1],
                self.cache_cfg.max_pages_per_seq * self.cache_cfg.page_size)
        probe = Request("__budget_probe__", [1] * n)
        self.alloc.allocate(probe.request_id, n)
        try:
            self._suffix_forward(probe, probe.prompt_tokens, 0, n)  # first use
            self._sync()
            t0 = time.perf_counter()
            self._suffix_forward(probe, probe.prompt_tokens, 0, n)
            self._sync()
            dt = time.perf_counter() - t0
        finally:
            self.alloc.release(probe.request_id)
        budget = derive_token_budget(dt / n, target_step_s=target_step_s,
                                     floor=floor, cap=cap)
        self.set_token_budget(budget)
        return budget

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
        self._validate_guided(request)
        if request.arrival_time < 0:
            request.arrival_time = time.monotonic()
        with self._lock:
            self.waiting.push(request)

    def _validate_guided(self, request: Request) -> None:
        """Admission-time guided checks: a masker is installed and the
        schema compiles, so a bad request is refused (a 400 from the
        server) instead of failing the engine thread mid-serve."""
        p = request.params
        if (p.guided_json or p.guided_schema) and self._masker is None:
            raise ValueError("guided JSON needs a token→byte mapping; the serving "
                             "tokenizer does not provide one")
        if p.guided_schema:
            SchemaByteMachine(compile_schema_str(p.guided_schema))

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

    @property
    def num_prefilling(self) -> int:
        return len(self.prefilling)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self.prefilling)

    def kv_cache_usage(self) -> float:
        return self.alloc.utilization()

    def prefix_cache_hit_rate(self) -> float:
        if not self.prefix_caching:
            return 0.0
        return self.alloc.prefix_hit_rate()

    def step(self) -> list[StepOutput]:
        """Admit new work, then advance chunked prefills and decode the
        running batch: one fused forward when both exist and ``fused_step``
        is on, else a chunk forward and a decode forward."""
        self._process_cancellations()
        # the budget is charged with the running batch's decode tokens
        # first; _admit and the chunk advance spend the remainder.  A
        # speculating row may score 1 + speculative_k tokens: the worst
        # case is charged, so a step never overruns its budget
        per_row = 1 + (self.spec_k or 0)
        self._step_prefill_left = self.sched.begin_step(
            per_row * sum(1 for st in self.running.values()
                          if st.n_generated < st.request.params.max_tokens))
        outputs = self._admit()
        if self._use_fused_step():
            outputs += self._fused_step()
        else:
            outputs += self._advance_prefilling()
            outputs += self._decode()
        return outputs

    # -- scheduling ----------------------------------------------------------

    def _process_cancellations(self) -> None:
        with self._lock:
            cancelled, self._cancelled = self._cancelled, set()
            if not cancelled:
                return
            for rid in cancelled:
                self._admission_chains.pop(rid, None)
            self.cancelled_total += self.waiting.remove_ids(cancelled)
        for state in [s for s in self.running.values()
                      if s.request.request_id in cancelled]:
            self._finish(state, outcome="cancelled")
        kept = []
        for st in self.prefilling:
            if st.request.request_id in cancelled:
                self.alloc.release(st.request.request_id)
                self.cancelled_total += 1
                logger.info("cancelled %s mid-prefill", st.request.request_id)
            else:
                kept.append(st)
        self.prefilling = kept

    def _avail_slots(self) -> int:
        """Free batch slots minus one reserved per mid-prefill sequence
        (every chunked prefill can activate on completion)."""
        return len(self._free_slots) - len(self.prefilling)

    def _admission_chain(self, prefix: list[int]) -> Optional[list]:
        """The prompt's full block-hash chain, computed once per admission
        (None without prefix caching)."""
        if not self.prefix_caching:
            return None
        return block_hashes(list(prefix), self.cache_cfg.page_size)

    def _admit(self) -> list[StepOutput]:
        """Admit waiting requests in arrival order while slots and pages
        allow (reuse-aware with prefix caching), then route each: a long
        prompt or cache-miss suffix, or one over the step's budget, to the
        chunked queue; a short cache-hit suffix into one batched ragged
        forward with the other hits; a fresh prompt into a flash prefill
        of its padding bucket.  Only the first of identical prompts
        prefills in a round; duplicates defer a round and hit its pages."""
        outputs: list[StepOutput] = []
        pending: list[tuple[Request, list[int], bool]] = []
        while True:
            if self._avail_slots() <= len(pending):
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
            chain = self._admission_chain(prefix)
            blocked = False
            while not self.alloc.can_admit(prefix, 1, chain=chain):
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
            if chain is not None:
                self._admission_chains[request.request_id] = chain
            pending.append((request, prefix, resumed))

        while pending:
            fresh: list[tuple[Request, list[int], bool]] = []
            short_hits: list[tuple[Request, list[int], bool, int]] = []
            deferred_idx: list[int] = []
            seen_prompts: set = set()
            stopped_at: Optional[int] = None
            for idx, (request, prefix, resumed) in enumerate(pending):
                key = tuple(prefix)
                if self.prefix_caching and key in seen_prompts:
                    deferred_idx.append(idx)
                    continue
                rid = request.request_id
                try:
                    reused = (self.alloc.match_prefix(
                        rid, prefix, chain=self._admission_chains.get(rid))
                        if self.prefix_caching else 0)
                    self.alloc.allocate(rid, len(prefix) + 1)
                except MemoryError:
                    # capacity raced ahead of the pop-time check: back-
                    # pressure; requeue the rest in order and stop
                    self.alloc.release(rid)
                    stopped_at = idx
                    break
                if resumed or request.was_preempted:
                    request.was_preempted = False
                    self.sched.preempt_resumes_total += 1
                    self.sched.preempt_resume_reused_tokens_total += reused
                suffix_len = len(prefix) - reused
                over_budget = (self.sched.tokens_per_step is not None
                               and suffix_len > self._step_prefill_left)
                if (self.prefill_chunk is not None
                        and (suffix_len > self.prefill_chunk or over_budget)):
                    if suffix_len <= self.prefill_chunk:
                        self.sched.admission_deferred_total += 1
                    if not reused:
                        seen_prompts.add(key)
                    self.prefilling.append(_PrefillingState(
                        request=request, prefix=prefix, resumed=resumed,
                        pos=reused))
                elif reused:
                    self._reserve_prefill(suffix_len)
                    if suffix_len <= _SUFFIX_BATCH_WINDOW:
                        short_hits.append((request, prefix, resumed, reused))
                        continue
                    outputs.extend(self._prefill_suffix_batch(
                        [(request, prefix, resumed, reused)]))
                else:
                    self._reserve_prefill(suffix_len)
                    seen_prompts.add(key)
                    fresh.append((request, prefix, resumed))

            if stopped_at is not None:
                keep = sorted(set(deferred_idx)
                              | set(range(stopped_at, len(pending))))
                self._requeue_front([pending[i] for i in keep])
                deferred_idx = []

            by_bucket: dict[int, list] = {}
            for item in fresh:
                by_bucket.setdefault(
                    pick_bucket(self.buckets, len(item[1])), []).append(item)
            for bucket in sorted(by_bucket):
                items = by_bucket[bucket]
                while items:
                    n = 1 << (len(items).bit_length() - 1)
                    group, items = items[:n], items[n:]
                    outputs.extend(self._prefill_fresh_group(bucket, group))
            if short_hits:
                outputs.extend(self._prefill_suffix_batch(short_hits))
            pending = [pending[i] for i in deferred_idx]
        return outputs

    def _requeue_front(self, items) -> None:
        """Return un-admitted requests to the wait queue (their arrival
        puts them back at the head), restoring resume state."""
        with self._lock:
            for request, prefix, resumed in items:
                if resumed:
                    request.resume_tokens = list(prefix)
                self.waiting.push(request)
                self._admission_chains.pop(request.request_id, None)

    def _fail_admission(self, request: Request, e: Exception) -> StepOutput:
        """Never lose a popped request silently: fail it to the client."""
        self.errors_total += 1
        self._admission_chains.pop(request.request_id, None)
        return StepOutput(request_id=request.request_id, token=0, finished=True,
                          finish_reason=f"error:{e}")

    def _preempt_youngest(self, exclude_slot: int,
                          than_arrival: Optional[float] = None) -> bool:
        """Release the youngest sequence (≠ exclude), running or
        mid-prefill, back to waiting; a mid-prefill one wins a tie.  With
        ``than_arrival`` only a victim that arrived strictly later than
        the displacing work is taken."""
        run = [s for s in self.running if s != exclude_slot]
        slot = (max(run, key=lambda s: self.running[s].request.arrival_time)
                if run else None)
        pf_idx = (max(range(len(self.prefilling)),
                      key=lambda i: self.prefilling[i].request.arrival_time)
                  if self.prefilling else None)
        pick_prefilling = pf_idx is not None and (
            slot is None
            or self.prefilling[pf_idx].request.arrival_time
            >= self.running[slot].request.arrival_time)
        victim = (self.prefilling[pf_idx].request if pick_prefilling
                  else self.running[slot].request if slot is not None else None)
        if victim is None or (than_arrival is not None
                              and victim.arrival_time <= than_arrival):
            return False
        if pick_prefilling:
            st = self.prefilling.pop(pf_idx)
            # park the chunk progress: re-admission picks it back up
            self._park_preempted(st.request, st.prefix, st.pos)
            self.alloc.release(st.request.request_id)
            self.preemptions_total += 1
            st.request.was_preempted = True
            if st.resumed:
                st.request.resume_tokens = list(st.prefix)
            with self._lock:
                self.waiting.push(st.request)
            logger.info("preempted %s mid-prefill for KV capacity",
                        st.request.request_id)
            return True
        self._preempt_running_slot(slot)
        return True

    def _park_preempted(self, request: Request, tokens: list[int],
                        written: int) -> int:
        """KV-preserving preemption: before a victim's pages are
        released, register its complete written pages as content-
        addressed blocks (the chain its resume looks up), so they survive
        the release as evictable content and the resume recomputes at
        most the last partial page.  ``written`` counts the positions
        whose KV is in the pages (a running victim's last sampled token
        is not yet).  A sliding-window engine parks nothing: its trimmed
        tables break the page-to-block alignment the chain needs.
        Returns the pages parked."""
        if not self.prefix_caching or self.cfg.sliding_window is not None:
            return 0
        ps = self.cache_cfg.page_size
        pages = self.alloc.pages_of(request.request_id)
        usable = min(written // ps, len(pages))
        if usable <= 0:
            return 0
        chain = block_hashes(list(tokens), ps)[:usable]
        self.alloc.register_blocks(request.request_id, list(tokens), chain=chain)
        self.sched.preempt_parks_total += 1
        self.sched.preempt_parked_pages_total += usable
        return usable

    def _preempt_running_slot(self, slot: int) -> None:
        state = self.running.pop(slot)
        self._park_preempted(state.request, state.tokens, len(state.tokens) - 1)
        self.alloc.release(state.request.request_id)
        self._free_slots.append(slot)
        self.preemptions_total += 1
        state.request.was_preempted = True
        state.request.resume_tokens = list(state.tokens)
        with self._lock:
            self.waiting.push(state.request)
        logger.info("preempted %s for KV capacity", state.request.request_id)

    def _request_seed(self, request: Request) -> int:
        if request.params.seed is not None:
            # the draw takes a seed's uint32 bits, as the JAX engine does
            return int(request.params.seed) & 0xFFFF_FFFF
        # unseeded: stable per engine seed + admission order
        return (self._base_seed * 1_000_003 + next(self._seed_counter)) & 0x7FFFFFFF

    # -- forwards ------------------------------------------------------------

    def _prefill_fresh_group(self, bucket: int, items) -> list[StepOutput]:
        """One batched flash-prefill forward for same-bucket fresh prompts;
        a failed forward fails (and releases) the whole group."""
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
            return self._fail_group([r for r, _, _ in items], e)
        self.sched.charge_weight_pass()
        self.sched.charge_prefill(sum(len(p) for _, p, _ in items))
        return self._activate_group(
            [(request, prefix, resumed, logits[i: i + 1])
             for i, (request, prefix, resumed) in enumerate(items)])

    def _ragged_forward(self, packed):
        """Dispatch ONE flat ragged forward over the packed tokens and
        charge its weight pass → ``(logits [B, W, V], chunk_logits [NC,
        V])``.  Every engine forward that reads paged context (decode rows
        and their spec windows, chunk advances, cache-hit suffixes, mixed
        steps) lands here."""
        arrays = (packed.tokens, packed.row_starts, packed.q_begins,
                  packed.q_lens, packed.page_tables, packed.sel, packed.chunk_sel)
        logits, chunk_logits = fused_step(
            self.cfg, self.cache_cfg, self.params, self.cache,
            *self._upload_int32(arrays), kv_splits=self.kv_splits,
            cluster=self.walk_cluster, n_tokens=packed.packed_tokens)
        self.sched.charge_weight_pass()
        return logits, chunk_logits

    def _batched_window_forward(self, entries) -> torch.Tensor:
        """ONE ragged forward for per-sequence token windows, ``entries``
        ``[(request, window_tokens, start)]`` → last-token logits [B, V];
        raises on a failed forward (the caller fails its group)."""
        mp = self.cache_cfg.max_pages_per_seq
        chunk_entries = [
            (toks, start, self.alloc.page_table_row(request.request_id), 0)
            for request, toks, start in entries]
        packed = pack_ragged_batch(
            np.zeros((0, 1), np.int32), np.zeros((0,), np.int32),
            np.zeros((0,), np.int32), np.zeros((0, mp), np.int32),
            np.zeros((0,), np.int32), chunk_entries, self.cache_cfg.trash_page,
            rows=self._ragged_rows, chunk_rows=self._ragged_chunk_rows)
        return self._ragged_forward(packed)[1][: len(entries)]

    def _suffix_forward(self, request: Request, prefix: list[int],
                        start: int, length: int) -> torch.Tensor:
        """One forward writing ``prefix[start:start+length]`` at positions
        [start, start+length) → last-token logits [1, V]: the one ragged
        dispatch as a one-chunk pack, so a sequence's K/V bits are the same
        whether its chunk ran alone, batched or beside decode rows."""
        return self._batched_window_forward(
            [(request, prefix[start: start + length], start)])[0][None]

    def _prefill_suffix_batch(self, items) -> list[StepOutput]:
        """One ragged forward for cache-hit suffixes ``[(request, prefix,
        resumed, reused)]``, each a window of its un-cached tail at its own
        start; a failed forward fails the whole group."""
        try:
            logits = self._batched_window_forward(
                [(request, prefix[reused:], reused)
                 for request, prefix, _, reused in items])
        except (RuntimeError, ValueError) as e:
            logger.exception("suffix prefill of %d requests failed", len(items))
            return self._fail_group([r for r, _, _, _ in items], e)
        self.sched.charge_prefill(
            sum(len(prefix) - reused for _, prefix, _, reused in items))
        return self._activate_group(
            [(request, prefix, resumed, logits[i][None])
             for i, (request, prefix, resumed, _) in enumerate(items)])

    def _fail_group(self, requests, e: Exception) -> list[StepOutput]:
        outputs = []
        for request in requests:
            self.alloc.release(request.request_id)
            outputs.append(self._fail_admission(request, e))
        return outputs

    # -- chunked prefill -----------------------------------------------------

    def _chunk_budget(self) -> int:
        """Prefill tokens this step may still spend: what is left after
        decode's charge and admission's spending, floored at one token per
        in-flight prefill so a saturated decode batch never starves one."""
        return max(self._step_prefill_left,
                   min(len(self.prefilling), self.max_batch_size))

    def _reserve_prefill(self, n: int) -> None:
        """Claim ``n`` tokens of this STEP's prefill remainder at routing
        time (the lifetime ledger is charged after the forward)."""
        self._step_prefill_left = max(0, self._step_prefill_left - n)

    def _spend_prefill(self, n: int, chunks: int = 0) -> None:
        self._reserve_prefill(n)
        self.sched.charge_prefill(n, chunks=chunks)

    def _chunk_plan(self) -> tuple[list[_PrefillingState], list[int]]:
        """The mid-prefill sequences this step advances and each one's
        chunk: the step's prefill budget split evenly, at least 1 each."""
        take = list(self.prefilling[: self.max_batch_size])
        share = max(1, self._chunk_budget() // len(take))
        cap = max(1, self._step_prefill_left // len(take))
        return take, [min(share, len(st.prefix) - st.pos, cap) for st in take]

    def _advance_prefilling(self) -> list[StepOutput]:
        """Advance every mid-prefill sequence one budgeted chunk, in one
        ragged forward; sequences whose last chunk completes activate into
        their reserved slots."""
        if not self.prefilling:
            return []
        take, chunks = self._chunk_plan()
        try:
            logits = self._batched_window_forward(
                [(st.request, st.prefix[st.pos: st.pos + chunks[i]], st.pos)
                 for i, st in enumerate(take)])
        except (RuntimeError, ValueError) as e:
            logger.exception("batched chunk advance of %d prefills failed",
                             len(take))
            self.prefilling = [st for st in self.prefilling if st not in take]
            return self._fail_group([st.request for st in take], e)
        return self._finish_chunks(take, chunks, logits)

    def _finish_chunks(self, take, chunks, chunk_logits) -> list[StepOutput]:
        """Charge a chunk forward that succeeded; activate the prefills it
        completed off their chunk rows' last-token logits."""
        self._spend_prefill(sum(chunks), chunks=len(take))
        done = []
        for i, st in enumerate(take):
            st.pos += chunks[i]
            if st.pos == len(st.prefix):
                self.prefilling.remove(st)
                done.append((st.request, st.prefix, st.resumed,
                             chunk_logits[i][None]))
        return self._activate_group(done) if done else []

    def _use_fused_step(self) -> bool:
        """One forward for this step's decode AND chunk work?  Never on a
        burst engine: its span-1 burst carries the dispatch-ahead control
        chain that a mixed forward cannot (the JAX engine's rule)."""
        return (self.fused_step_enabled and self.burst_steps == 1
                and self._inflight is None and bool(self.prefilling)
                and any(st.n_generated < st.request.params.max_tokens
                        for st in self.running.values()))

    def _fused_step(self) -> list[StepOutput]:
        """Advance every mid-prefill sequence one budgeted chunk AND decode
        the running batch in ONE forward: rows 0..B-1 are the decode slots
        (spec windows included), rows B.. the chunk windows.  Chunk
        activations are emitted first, then the decode tokens, as on the
        split path.  A failed forward fails the chunk rows and decodes
        split this step."""
        failures, _ = self._ensure_decode_capacity()
        live = self._live()
        if not live or not self.prefilling:
            # preemption took one row kind away since step()'s gate
            return failures + self._advance_prefilling() + self._decode()
        take, chunks = self._chunk_plan()
        spec_drafts = self._propose_drafts(live) if self.spec_k else {}
        window, counts, positions, tables = self._decode_window(live, spec_drafts)
        entries = [(st.prefix[st.pos: st.pos + chunks[i]], st.pos,
                    self.alloc.page_table_row(st.request.request_id), 0)
                   for i, st in enumerate(take)]
        packed = pack_ragged_batch(
            window, counts, positions, tables, np.zeros_like(counts), entries,
            self.cache_cfg.trash_page, rows=self._ragged_rows,
            chunk_rows=self._ragged_chunk_rows)
        try:
            logits_w, chunk_logits = self._ragged_forward(packed)
        except (RuntimeError, ValueError) as e:
            logger.exception("fused step of %d chunks failed", len(take))
            self.prefilling = [st for st in self.prefilling if st not in take]
            return (failures + self._fail_group([st.request for st in take], e)
                    + self._decode())
        self.sched.record_fused(packed.packed_tokens)
        outputs = failures + self._finish_chunks(take, chunks, chunk_logits)
        return outputs + self._decode_finish(live, logits_w, spec_drafts)

    # -- activation ----------------------------------------------------------

    def _activate_group(self, entries) -> list[StepOutput]:
        """Publish each prompt's pages to the prefix cache, sample its
        first token with its full sampling semantics, claim a slot,
        install the slot's penalty rows and logit bias and emit.
        ``entries``: ``[(request, prefix, resumed, logits_row [1, V])]``."""
        logits = torch.cat([row for _, _, _, row in entries])
        B, V = logits.shape
        dev = self.device
        counts = torch.zeros((B, V), dtype=torch.int32, device=dev)
        outs = torch.zeros_like(counts)
        sup = torch.zeros((B, V), dtype=torch.bool, device=dev)
        seeds, gens, biases, machines = [], [], [], []
        for i, (request, prefix, _, _) in enumerate(entries):
            rid = request.request_id
            chain = self._admission_chains.pop(rid, None)
            if self.prefix_caching:
                self.alloc.register_blocks(rid, prefix, chain=chain)
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
            biases.append(self._bias_tensors(p))
            machine = machine_for(p)
            if machine is not None:
                for t in prefix[n_prompt:]:  # a resume replays its generated bytes
                    self._masker.advance_token(machine, t)
            machines.append(machine)
        params = [e[0].params for e in entries]
        tokens, logprobs = self._sample(logits, params, counts, outs, sup, seeds,
                                        gens, biases,
                                        [(-1, m) if m is not None else None
                                         for m in machines])
        outputs = []
        for i, (request, prefix, resumed, _) in enumerate(entries):
            token = tokens[i]
            slot = self._free_slots.pop()
            state = _SeqState(request=request, tokens=list(prefix) + [token],
                              n_prompt=len(request.prompt_tokens), slot=slot,
                              seed=seeds[i], guided=machines[i])
            counts[i, token] += 1
            outs[i, token] += 1
            self._token_counts[slot] = counts[i]
            self._output_counts[slot] = outs[i]
            self._suppress[slot] = sup[i]
            if biases[i] is not None:
                self._slot_bias[slot] = biases[i]
            else:
                self._slot_bias.pop(slot, None)
            self.running[slot] = state
            if not resumed:
                self.prompt_tokens_total += len(prefix)
            self.generation_tokens_total += 1
            outputs.append(self._emit(state, token, first=not resumed,
                                      logprobs=logprobs[i],
                                      force_finish=self._guided_advance(state, token)))
        return outputs

    def _bias_tensors(self, params: SamplingParams):
        """A request's ``logit_bias`` as ``(ids, vals)`` device tensors, or
        None."""
        if not params.logit_bias:
            return None
        return (torch.tensor([t for t, _ in params.logit_bias], dtype=torch.int64,
                             device=self.device),
                torch.tensor([b for _, b in params.logit_bias], dtype=torch.float32,
                             device=self.device))

    def _sample(self, logits, params: list[SamplingParams], counts, outs, sup,
                seeds: list[int], gen_counts: list[int], biases, guided=None):
        """Penalties → min-tokens suppression → guided masks → logit bias
        → sample, for rows aligned with ``params`` (``biases[i]``: row i's
        ``(ids, vals)`` or None; ``guided[i]``: row i's ``(slot,
        machine)`` or None) → ``(host tokens, logprobs)``, where
        ``logprobs[i]`` is None unless row i asked for them
        (:meth:`_logprobs`, off the raw ``logits``).  A candidate row
        (top-k ≤ 64) takes its candidates from the masked logits."""
        dev = self.device
        raw = logits

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
        rows = [i for i, g in enumerate(guided or ()) if g is not None]
        if rows:
            legal = torch.stack([self._guided_legal(*guided[i]) for i in rows])
            idx = col(rows, torch.int64)
            logits = logits.index_put((idx,), logits[idx].masked_fill(~legal, float("-inf")))
        if any(b is not None for b in biases):
            logits = logits.clone()
            for i, b in enumerate(biases):
                if b is not None:
                    logits[i].index_add_(0, b[0], b[1])
        toks = sample(logits, [p.temperature for p in params],
                      [p.top_k for p in params], [p.top_p for p in params],
                      [p.min_p for p in params], seeds, gen_counts,
                      mode=sample_mode(params))
        return ([int(t) for t in toks.tolist()],
                self._logprobs(raw, [p.logprobs for p in params], toks))

    def _guided_legal(self, slot: int, machine) -> torch.Tensor:
        """A guided row's ``[V]`` legality on the device, kept in an LRU of
        eight rows keyed by ``(slot, machine signature)``."""
        key = (slot, machine.signature())
        row = self._guided_legal_dev.get(key)
        if row is None:
            row = torch.from_numpy(self._masker.token_mask(machine)).to(self.device)
            if len(self._guided_legal_dev) >= 8:  # bound the device memory held
                self._guided_legal_dev.popitem(last=False)
            self._guided_legal_dev[key] = row
        else:
            self._guided_legal_dev.move_to_end(key)
        return row

    def _guided_advance(self, state: _SeqState, token: int) -> Optional[str]:
        """Advance a guided row's machine by an emitted token's bytes →
        ``"stop"`` the moment its top-level value closes, else None."""
        if state.guided is None:
            return None
        self._masker.advance_token(state.guided, token)
        return "stop" if state.guided.done else None

    @staticmethod
    def _logprobs(raw, ns: list[Optional[int]], toks):
        """Per row: None where ``ns[i]`` is None, else ``(logprob of the
        chosen token, {token id: logprob} of the top ``ns[i]`` or None for
        0)`` under ``log_softmax`` of the raw logits ``raw [N, V]``, the
        top ones in :func:`sampler.topk_ordered`'s order."""
        out: list = [None] * len(ns)
        rows = [i for i, n in enumerate(ns) if n is not None]
        if not rows:
            return out
        sel = torch.tensor(rows, device=raw.device)
        logp = torch.log_softmax(raw[sel].float(), dim=-1)
        chosen = torch.gather(logp, 1, toks[sel][:, None])[:, 0].tolist()
        n_top = max(ns[i] for i in rows)
        if n_top:
            vals, ids = (t.tolist() for t in topk_ordered(logp, n_top))
        for j, i in enumerate(rows):
            tops = (dict(zip(ids[j][: ns[i]], vals[j][: ns[i]])) if ns[i] else None)
            out[i] = (chosen[j], tops)
        return out

    # -- decode --------------------------------------------------------------

    def _live(self) -> dict[int, _SeqState]:
        return {s: st for s, st in self.running.items()
                if st.n_generated < st.request.params.max_tokens}

    def _decode_window(self, live: dict, spec_drafts: dict):
        """Per-slot decode windows (dead slots: zero-length, trash pages):
        the input token and, with speculation on, the slot's drafts, in a
        window of ``1 + speculative_k`` columns even on steps without
        drafts, so a row's window never depends on a neighbour's drafts →
        window [B, W], window lengths [B], positions [B] (of column 0),
        tables [B, mp], all int32."""
        B = self.max_batch_size
        window = np.zeros((B, 1 + (self.spec_k or 0)), np.int32)
        counts = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        tables = np.full((B, self.cache_cfg.max_pages_per_seq),
                         self.cache_cfg.trash_page, np.int32)
        for slot, st in live.items():
            drafts = spec_drafts.get(slot, [])
            window[slot, 0] = st.tokens[-1]
            window[slot, 1: 1 + len(drafts)] = drafts
            counts[slot] = 1 + len(drafts)
            # the input token was sampled last step; its KV lands at len-1
            positions[slot] = len(st.tokens) - 1
            tables[slot] = self.alloc.page_table_row(st.request.request_id)
        return window, counts, positions, tables

    def _decode(self) -> list[StepOutput]:
        """Decode the running batch.  An in-flight burst is consumed
        first (and nothing else decodes this pass).  On a burst engine
        the rows that need no host work each token ride one burst of the
        pass's span; the others, and every row of a per-token engine,
        take the same ragged forward as the fused step with zero chunk
        rows."""
        if self._inflight is not None:
            return self._consume_inflight()
        failures, span = self._ensure_decode_capacity(self._burst_span())
        live = self._live()
        if not live:
            return failures
        burst_rows = ({s: st for s, st in live.items() if self._row_bursts(st)}
                      if self.burst_steps > 1 and not self.spec_k else {})
        if burst_rows:
            ctl_i, ctl_f, tables = self._decode_controls(burst_rows)
            mode = sample_mode(st.request.params for st in burst_rows.values())
            handle = self._dispatch_burst(ctl_i, ctl_f, tables, span, mode)
            self._inflight = (handle, dict(burst_rows), span, mode)
            failures = failures + self._consume_inflight()
            # rows needing host work each token step once in this pass
            live = {s: st for s, st in live.items() if s not in burst_rows}
            if not live:
                return failures
        spec_drafts = self._propose_drafts(live) if self.spec_k else {}
        window, counts, positions, tables = self._decode_window(live, spec_drafts)
        packed = pack_ragged_batch(
            window, counts, positions, tables, np.zeros_like(counts), [],
            self.cache_cfg.trash_page, rows=self._ragged_rows, chunk_rows=0)
        logits_w, _ = self._ragged_forward(packed)
        return failures + self._decode_finish(live, logits_w, spec_drafts)

    # -- decode bursts -------------------------------------------------------

    @staticmethod
    def _row_bursts(st: _SeqState) -> bool:
        """Can this row ride a burst?  Guided masks, logprobs and
        ``logit_bias`` need host work each token: such a row steps once
        per pass while the rest of the batch bursts."""
        p = st.request.params
        return st.guided is None and p.logprobs is None and not p.logit_bias

    def _decode_need(self, st: _SeqState, span: int) -> int:
        """Tokens of page coverage this row needs from the next decode
        pass: a burst row the whole span (clipped to its budget), any
        other row one token."""
        if span <= 1 or not self._row_bursts(st):
            return 1
        return max(1, min(span, st.request.params.max_tokens - st.n_generated))

    def _admission_pending(self) -> bool:
        """Any scheduler work besides decoding the running batch?"""
        return bool(self.waiting or self.prefilling or self._cancelled)

    def _burst_span(self) -> int:
        """The next pass's span: 1 or ``decode_burst_steps``, never in
        between (two graphs per mode).  1 with speculation, with no row
        that can burst, when no such row has a full span of budget left,
        and while admission work is pending (counted in
        ``burst_clamped``), so a burst never adds queue wait."""
        k = self.burst_steps
        if k <= 1 or self.spec_k:
            return 1
        eligible = [st for st in self.running.values()
                    if st.n_generated < st.request.params.max_tokens
                    and self._row_bursts(st)]
        if not eligible:
            return 1
        if max(st.request.params.max_tokens - st.n_generated for st in eligible) < k:
            return 1
        if self._admission_pending():
            self.sched.burst_clamped_total += 1
            return 1
        return k

    def _decode_controls(self, rows: dict):
        """Per-slot control arrays of a burst over ``rows`` (dead slots:
        inactive, neutral params, trash pages) → ``(ctl_i [B, 8] int32,
        ctl_f [B, 6] f32, tables [B, mp] int32)`` in
        :data:`model_runner.CTL_I_COLS` / ``CTL_F_COLS`` order."""
        B = self.max_batch_size
        ctl_i = np.zeros((B, 8), np.int32)
        ctl_f = np.zeros((B, 6), np.float32)
        ctl_f[:, 1] = 1.0  # top_p
        ctl_f[:, 5] = 1.0  # repetition
        tables = np.full((B, self.cache_cfg.max_pages_per_seq),
                         self.cache_cfg.trash_page, np.int32)
        for slot, st in rows.items():
            p = st.request.params
            # the input token was sampled last step; its KV lands at len-1
            ctl_i[slot] = (st.tokens[-1], len(st.tokens) - 1, p.top_k, p.min_tokens,
                           st.n_generated,
                           np.array(st.seed, np.uint32).view(np.int32), 0, 1)
            ctl_f[slot] = (p.temperature, p.top_p, p.min_p, p.presence_penalty,
                           p.frequency_penalty, p.repetition_penalty)
            tables[slot] = self.alloc.page_table_row(st.request.request_id)
        return ctl_i, ctl_f, tables

    def _dispatch_burst(self, ctl_i, ctl_f, tables, span: int, mode: str):
        """Dispatch one burst (returns before it runs on the card); a
        span-k burst streams the weights k times."""
        self.sched.record_span(span)
        self.sched.charge_weight_pass(span)
        return self.bursts.launch(ctl_i, ctl_f, tables, span, mode)

    def _pipeline_ready(self, snapshot: dict, span: int) -> bool:
        """May the successor burst dispatch from the device-side carry?
        Only in steady state: no pending scheduler work, the running set
        exactly the snapshot (the same objects), and a row with a full
        span of budget left after the in-flight burst."""
        if not self.pipeline_bursts or self.spec_k or self._admission_pending():
            return False
        if len(self.running) != len(snapshot):
            return False
        if any(self.running.get(s) is not st for s, st in snapshot.items()):
            return False
        return max(st.request.params.max_tokens - st.n_generated - span
                   for st in snapshot.values()) >= span

    def _extend_for_successor(self, snapshot: dict, span: int) -> bool:
        """Extend pages to cover a successor burst (positions ``len - 1 +
        span .. len - 2 + 2·span``), all or nothing, priced against the
        free pool first: a successor that does not fit is not
        dispatched, and never preempts anyone."""
        extra, plan = 0, []
        for st in snapshot.values():
            # a windowed row gives back its pages below the successor's
            # window before the pricing: this chained path skips
            # _ensure_decode_capacity, whose trim would come too late
            self._trim_window(st, len(st.tokens) + span)
            rem_after = st.request.params.max_tokens - st.n_generated - span
            if rem_after < 1:
                continue  # finishes in flight; its overrun writes go to trash
            need = min(span, rem_after)
            base = len(st.tokens) - 1 + span
            have = len(self.alloc.pages_of(st.request.request_id))
            extra += max(0, self.alloc.pages_needed(base + need) - have)
            plan.append((st, base, need))
        if extra > self.alloc.free_pages:
            return False
        try:
            for st, base, need in plan:
                self.alloc.extend(st.request.request_id, base, need)
        except MemoryError:  # past max_pages_per_seq: no pipelining
            return False
        return True

    def _consume_inflight(self) -> list[StepOutput]:
        """Read and emit the in-flight burst, first dispatching its
        successor from the device-side control carry when the pipeline
        conditions hold (the dispatch comes before the blocking read:
        that order hides the round trip).  Rows cancelled, finished or
        preempted since the dispatch are discarded, and so is a row's
        tail after its finish."""
        handle, snapshot, span, mode = self._inflight
        self._inflight = None
        successor = None
        if (self._pipeline_ready(snapshot, span)
                and self._extend_for_successor(snapshot, span)):
            tables = np.full((self.max_batch_size, self.cache_cfg.max_pages_per_seq),
                             self.cache_cfg.trash_page, np.int32)
            for s, st in snapshot.items():
                tables[s] = self.alloc.page_table_row(st.request.request_id)
            successor = (self._dispatch_burst(handle.next_ctl, handle.ctl_f, tables,
                                              span, mode),
                         dict(snapshot), span, mode)
            self.sched.dispatch_ahead_total += 1
        self.sched.charge_decode(span * len(snapshot))
        sampled = handle.tokens()  # [span, B]: blocks here
        outputs: list[StepOutput] = []
        for slot, st in snapshot.items():
            if self.running.get(slot) is not st:
                continue
            for k in range(span):
                token = int(sampled[k, slot])
                st.tokens.append(token)
                self.generation_tokens_total += 1
                outputs.append(self._emit(st, token))
                if outputs[-1].finished:
                    break
        if successor is not None and any(
                self.running.get(s) is st for s, st in snapshot.items()):
            self._inflight = successor
        return outputs

    # -- speculative decoding ------------------------------------------------

    def _spec_eligible(self, st: _SeqState) -> bool:
        """Speculation stays where it cannot change what a row emits:
        no penalties (they would need counts that evolve inside the
        window), no logprobs, no guided grammar (drafts would bypass its
        mask), no ``logit_bias`` (window scoring ignores it), past
        ``min_tokens``."""
        p = st.request.params
        return (p.presence_penalty == 0.0
                and p.frequency_penalty == 0.0
                and p.repetition_penalty == 1.0
                and p.logprobs is None
                and not p.guided_json
                and not p.guided_schema
                and not p.logit_bias
                and st.n_generated >= p.min_tokens)

    def _propose_drafts(self, live: dict) -> dict[int, list[int]]:
        """Each eligible live row's drafts, at most ``speculative_k`` and
        leaving room for the bonus token within ``max_tokens`` and the
        engine's ``max_len``.  Pages are extended for the window one
        token at a time off its end: drafts shrink rather than preempt
        anyone, so speculation never costs another row its pages."""
        spec_drafts: dict[int, list[int]] = {}
        for slot, st in live.items():
            if not self._spec_eligible(st):
                continue
            room = min(st.request.params.max_tokens - st.n_generated - 1,
                       self.spec_k, self.cache_cfg.max_len - len(st.tokens))
            if room < 1:
                continue
            drafts = self.proposer.propose(st.tokens, room)
            while drafts:
                try:
                    self.alloc.extend(st.request.request_id, len(st.tokens) - 1,
                                      1 + len(drafts))
                    break
                except MemoryError:
                    drafts.pop()
            if drafts:
                spec_drafts[slot] = drafts
        return spec_drafts

    def _spec_bursts(self, live: dict, logits_w, spec_drafts: dict) -> dict:
        """Each drafted row's accepted drafts and the token after them →
        ``{slot: (burst tokens, accepted)}``.  A greedy row accepts while
        its draft equals the window's argmax at that position and ends
        with the argmax after the last accepted one (the tokens sequential
        greedy steps emit).  A sampled row accepts while ``u < p_draft``
        (:func:`sampler.spec_window_draws`) and ends with the replacement
        at the first rejection, or the bonus draw after all."""
        slots = list(spec_drafts)
        dev = self.device
        argmax_w = logits_w[torch.tensor(slots, device=dev)].argmax(dim=-1).tolist()
        sampled = [s for s in slots if live[s].request.params.temperature > 0.0]
        draws = {}
        if sampled:
            C = 1 + self.spec_k
            draft_next = np.zeros((len(sampled), C), np.int64)
            for i, s in enumerate(sampled):
                draft_next[i, : len(spec_drafts[s])] = spec_drafts[s]
            params = [live[s].request.params for s in sampled]
            out = spec_window_draws(
                logits_w[torch.tensor(sampled, device=dev)].float(),
                self._tensor(draft_next), [p.temperature for p in params],
                [p.top_k for p in params], [p.top_p for p in params],
                [p.min_p for p in params], [live[s].seed for s in sampled],
                [live[s].n_generated for s in sampled])
            # one copy to the host; f64 holds the vocab ids and the f32
            # probabilities exactly
            host = torch.stack([t.double() for t in out]).cpu().numpy()
            draws = {s: host[:, i] for i, s in enumerate(sampled)}
        bursts = {}
        for i, slot in enumerate(slots):
            drafts = spec_drafts[slot]
            accepted = 0
            if slot in draws:
                full, p_draft, u, repl = draws[slot]
                while accepted < len(drafts) and u[accepted] < p_draft[accepted]:
                    accepted += 1
                tail = int(repl[accepted] if accepted < len(drafts)
                           else full[len(drafts)])
            else:
                while accepted < len(drafts) and drafts[accepted] == argmax_w[i][accepted]:
                    accepted += 1
                tail = argmax_w[i][accepted]
            bursts[slot] = (drafts[:accepted] + [tail], accepted)
        return bursts

    # -- decode sampling -----------------------------------------------------

    def _decode_finish(self, live: dict, logits_w, spec_drafts: dict) -> list[StepOutput]:
        """The decode sampling tail shared by the split and fused paths,
        off slot-aligned logits [B, W, V]: a row without drafts samples
        off position 0 (:meth:`_sample`: penalties, min-tokens
        suppression, logit bias, logprobs); a drafted row emits its burst
        (:meth:`_spec_bursts`) up to a finish.  Charges the decode tokens
        the forward scored, ``len(live) + Σ drafts``."""
        one = [s for s in live if s not in spec_drafts]
        sampled = {}
        if one:
            idx = torch.tensor(one, device=self.device)
            params = [live[s].request.params for s in one]
            toks, lps = self._sample(
                logits_w[idx, 0], params, self._token_counts[idx],
                self._output_counts[idx], self._suppress[idx],
                [live[s].seed for s in one], [live[s].n_generated for s in one],
                [self._slot_bias.get(s) for s in one],
                [(s, live[s].guided) if live[s].guided is not None else None
                 for s in one])
            sampled = {s: (t, lp) for s, t, lp in zip(one, toks, lps)}
        bursts = self._spec_bursts(live, logits_w, spec_drafts) if spec_drafts else {}
        self.sched.charge_decode(len(live) + sum(len(d) for d in spec_drafts.values()))
        outputs, bumped = [], []
        for slot, st in live.items():
            if slot not in bursts:
                token, lp = sampled[slot]
                st.tokens.append(token)
                bumped.append((slot, token))
                self.generation_tokens_total += 1
                outputs.append(self._emit(st, token, logprobs=lp,
                                          force_finish=self._guided_advance(st, token)))
                continue
            burst, accepted = bursts[slot]
            self.spec_proposed_total += len(spec_drafts[slot])
            for i, token in enumerate(burst):
                st.tokens.append(token)
                bumped.append((slot, token))
                self.generation_tokens_total += 1
                if i < accepted:
                    self.spec_accepted_total += 1
                outputs.append(self._emit(st, token))
                if outputs[-1].finished:
                    break
        self._bump_counts(bumped)
        return outputs

    def _bump_counts(self, pairs: list[tuple[int, int]]) -> None:
        """Count emitted ``(slot, token)`` pairs into both penalty tables."""
        if not pairs:
            return
        slot_t, tok_t = self._tensor(np.asarray(pairs, np.int64).T)
        ones = torch.ones(len(pairs), dtype=torch.int32, device=self.device)
        self._token_counts.index_put_((slot_t, tok_t), ones, accumulate=True)
        self._output_counts.index_put_((slot_t, tok_t), ones, accumulate=True)

    def _ensure_decode_capacity(self, span: int = 1) -> tuple[list[StepOutput], int]:
        """Grow page tables for rows crossing a page boundary; on
        exhaustion preempt youngest-first so the oldest proceed.  With
        ``span`` > 1 each burst row is extended for its whole burst,
        all or nothing: if the pool cannot cover the whole batch's
        headroom the pass decays to span 1 before anyone is preempted.
        → ``(failures, span achieved)``."""
        failures: list[StepOutput] = []
        if span > 1:
            extra = 0
            for st in self.running.values():
                if st.n_generated >= st.request.params.max_tokens:
                    continue
                need = self._decode_need(st, span)
                have = len(self.alloc.pages_of(st.request.request_id))
                extra += max(0, self.alloc.pages_needed(len(st.tokens) - 1 + need) - have)
            if extra > self.alloc.free_pages:
                span = 1
        for slot in sorted(self.running,
                           key=lambda s: self.running[s].request.arrival_time):
            st = self.running.get(slot)
            if st is None or st.n_generated >= st.request.params.max_tokens:
                continue
            # trim BEFORE asking for pages: a page newly below the window
            # may be the very one this step needs
            self._trim_window(st, len(st.tokens))
            while True:
                try:
                    # input token occupies index len-1 -> len tokens covered
                    self.alloc.extend(st.request.request_id, len(st.tokens) - 1,
                                      self._decode_need(st, span))
                    break
                except MemoryError:
                    if span > 1:
                        # burst headroom never costs anyone their pages
                        span = 1
                        continue
                    if self._preempt_youngest(exclude_slot=slot,
                                              than_arrival=st.request.arrival_time):
                        continue
                    if len(self.running) > 1 or self.prefilling:
                        # older work holds the pages: step aside
                        self._preempt_running_slot(slot)
                        break
                    logger.error("request %s exceeds total KV capacity",
                                 st.request.request_id)
                    self._finish(st, outcome="error")
                    failures.append(StepOutput(
                        request_id=st.request.request_id, token=st.tokens[-1],
                        finished=True, finish_reason="error:kv_capacity"))
                    break
        return failures, span

    def _trim_window(self, st: _SeqState, length: int) -> None:
        """A windowed row whose next query sees keys from ``length -
        window`` on gives back the pages wholly below that key (the walks
        start at page ``(length - window) // page_size``); counted in
        ``window_pages_trimmed_total``.  A full-attention model keeps
        every page."""
        window = self.cfg.sliding_window
        if window is not None and length > window:
            self.window_pages_trimmed_total += self.alloc.trim_window(
                st.request.request_id, (length - window) // self.cache_cfg.page_size)

    # -- bookkeeping ---------------------------------------------------------

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _upload_int32(self, arrays) -> list[torch.Tensor]:
        """int32 host arrays → device tensors of the same shapes through
        ONE copy; each starts on a 16-byte boundary of the buffer."""
        offsets, n = [], 0
        for a in arrays:
            offsets.append(n)
            n += -(-a.size // 4) * 4
        buf = np.zeros((n,), np.int32)
        for a, o in zip(arrays, offsets):
            buf[o: o + a.size] = a.ravel()
        dev = torch.from_numpy(buf).to(self.device)
        return [dev[o: o + a.size].view(a.shape) for a, o in zip(arrays, offsets)]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _emit(self, state: _SeqState, token: int, first: bool = False,
              logprobs: Optional[tuple] = None,
              force_finish: Optional[str] = None) -> StepOutput:
        """``logprobs``: ``(logprob, top_logprobs)`` of a row that asked;
        ``force_finish``: a finish reason that wins over the others (a
        guided row's closed grammar)."""
        params = state.request.params
        finish_reason = force_finish
        if finish_reason is None and token in params.stop_token_ids:
            finish_reason = "stop"
        elif finish_reason is None and state.n_generated >= params.max_tokens:
            finish_reason = "length"
        if finish_reason:
            self._finish(state)
        lp, tops = logprobs if logprobs is not None else (None, None)
        return StepOutput(request_id=state.request.request_id, token=token,
                          finished=finish_reason is not None,
                          finish_reason=finish_reason, is_first_token=first,
                          logprob=lp, top_logprobs=tops)

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
