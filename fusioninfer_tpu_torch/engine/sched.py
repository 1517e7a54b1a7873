"""Token-budgeted step scheduling (own copy of
``fusioninfer_tpu/engine/sched.py``; Sarathi-style stall-free batching).

One :class:`TokenBudget` per engine is the scheduler's ledger: every
:meth:`NativeEngine.step` gets a budget of tokens it may process, which
is *first* charged with the running batch's decode tokens; the remainder
is spent on adaptively-sized prefill chunks.  Chunk size therefore
shrinks under decode load instead of stalling running streams, and grows
to the full budget when the batch is idle.

The class is pure bookkeeping (no clocks, no device work), so the
engine's scheduling decisions stay a deterministic function of its
state.  :func:`derive_token_budget` converts a MEASURED per-token
prefill latency into a tokens/step budget; the engine times the forward
(:meth:`NativeEngine.calibrate_token_budget`) and this function only
does the arithmetic.  The ledger keeps every counter of the JAX one,
also those of features this port does not have yet (the host KV tier,
deadlines, SLO tiers), which stay 0, so that a snapshot reads the same
in both packages.  Decode bursts feed ``burst_span_steps``
(:meth:`record_span`, one entry per dispatch, seeded by the engine with
its two spans), ``burst_clamped_total``, ``dispatch_ahead_total`` and
``weight_passes_total`` (a span-k burst is k weight passes).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

# upper bounds for the fused-step packed-tokens histogram (real tokens
# per fused mixed-batch dispatch); the last implicit bucket is +Inf
PACKED_TOKENS_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def derive_token_budget(
    per_token_s: float,
    target_step_s: float = 0.05,
    floor: int = 32,
    cap: int = 4096,
) -> int:
    """Tokens/step that keep one step's prefill work under
    ``target_step_s`` given a measured ``per_token_s`` prefill cost.

    ``floor`` guards against a pathological measurement starving prefill
    (a budget below the batch size would trickle single tokens);
    ``cap`` bounds the budget on very fast hosts so a step never
    monopolizes the device with one enormous chunk anyway.
    """
    if per_token_s <= 0.0:
        return cap
    return max(floor, min(cap, int(target_step_s / per_token_s)))


@dataclass
class TokenBudget:
    """Per-step token ledger + lifetime scheduler counters.

    ``tokens_per_step is None`` disables budgeting (monolithic prefill,
    the library default); the counters still accumulate so the stats can
    always report the scheduler's behavior.
    """

    tokens_per_step: Optional[int] = None

    # lifetime counters (the server's /health reports them)
    steps_total: int = 0
    decode_tokens_total: int = 0
    prefill_tokens_total: int = 0
    chunks_total: int = 0
    # requests routed to the chunked-prefill queue because the STEP
    # budget was spent (not because the prompt exceeded the chunk
    # threshold) — the admission-smoothing decision counter
    admission_deferred_total: int = 0
    # decode bursts clamped to span 1 because admission work was pending
    burst_clamped_total: int = 0
    # successor bursts dispatched BEFORE the in-flight fetch (the
    # dispatch-ahead pipelining counter)
    dispatch_ahead_total: int = 0
    # adaptive-burst histogram: dispatched span -> dispatch count
    burst_span_steps: dict = field(default_factory=dict)
    # hierarchical-KV restore ledger (engine/kv_host_tier.py): pages
    # re-injected from the host tier into HBM, the tokens they covered
    # (charged against the step's prefill remainder — a restore is
    # prefill work the engine did NOT have to recompute, but its H2D
    # upload still spends step bandwidth), and restore plans truncated
    # because the step budget was already spent (the backpressure that
    # keeps restores from starving decode)
    kv_restores_total: int = 0
    kv_restore_tokens_total: int = 0
    kv_restore_deferred_total: int = 0
    # overload robustness (docs/design/scheduler.md "Overload and SLO
    # tiers"): queued requests shed because their deadline expired
    # before admission (they would only have burned prefill budget and
    # then failed mid-stream)
    deadline_shed_total: int = 0
    # running sequences preempted because their tier's decode load was
    # squeezing a more urgent tier's reserved budget share (the
    # mid-stream yield the SLO-tier ledger exists for)
    tier_preemptions_total: int = 0
    # KV-preserving preemption ledger: victims whose computed pages were
    # parked (registered content-addressed + offloaded to the host tier
    # when one is wired) instead of dropped for full recompute, the
    # pages parked, and preempted requests re-admitted (with the KV
    # tokens their resume re-used from parked pages instead of
    # recomputing)
    preempt_parks_total: int = 0
    preempt_parked_pages_total: int = 0
    preempt_resumes_total: int = 0
    preempt_resume_reused_tokens_total: int = 0
    # fused mixed-batch steps: decode rows + budgeted prefill chunks in
    # ONE forward (one weight pass instead of one per row-kind)
    fused_steps_total: int = 0
    # weight-streaming forwards dispatched on the serving path (fresh
    # prefill, suffix/chunk, verify, decode, fused — a decode burst of
    # span k streams the weights k times).  weight_passes / steps is the
    # serving-path-gap metric the fused step exists to push toward 1.
    weight_passes_total: int = 0
    # packed-tokens histogram for fused dispatches: non-cumulative
    # counts keyed by PACKED_TOKENS_BUCKETS upper bound (inf = overflow)
    fused_packed_tokens: dict = field(default_factory=dict)
    fused_packed_tokens_sum: int = 0

    def begin_step(self, decode_charge: int) -> int:
        """Open a step's ledger: charge the running batch's decode
        tokens first and return the PREFILL remainder.  With no budget
        configured the remainder is unbounded (monolithic semantics).
        The engine charges ``1 + speculative_k`` tokens per live row with
        speculation on (the worst case a window scores) and books what
        the forward did score, ``len(live) + Σ drafts``, through
        :meth:`charge_decode`."""
        self.steps_total += 1
        if self.tokens_per_step is None:
            return 1 << 30
        return max(0, self.tokens_per_step - decode_charge)

    def charge_decode(self, n: int) -> None:
        self.decode_tokens_total += n

    def charge_prefill(self, n: int, chunks: int = 0) -> None:
        self.prefill_tokens_total += n
        self.chunks_total += chunks

    def record_span(self, span: int) -> None:
        self.burst_span_steps[span] = self.burst_span_steps.get(span, 0) + 1

    def charge_weight_pass(self, n: int = 1) -> None:
        self.weight_passes_total += n

    def record_fused(self, packed_tokens: int) -> None:
        """One fused mixed-batch dispatch packing ``packed_tokens`` real
        (non-padding) tokens."""
        self.fused_steps_total += 1
        self.fused_packed_tokens_sum += packed_tokens
        for b in PACKED_TOKENS_BUCKETS:
            if packed_tokens <= b:
                self.fused_packed_tokens[b] = (
                    self.fused_packed_tokens.get(b, 0) + 1)
                return
        inf = float("inf")
        self.fused_packed_tokens[inf] = self.fused_packed_tokens.get(inf, 0) + 1

    def weight_passes_per_step(self) -> float:
        """Lifetime weight-streaming forwards per engine step (1.0 =
        every step is one weight pass, the fused-step target; ≥ 2 is
        the split prefill+decode dispatch under mixed load)."""
        if not self.steps_total:
            return 0.0
        return self.weight_passes_total / self.steps_total

    def utilization(self) -> float:
        """Lifetime fraction of budgeted tokens actually spent (0 when
        no budget is configured or no step has run)."""
        if not self.tokens_per_step or not self.steps_total:
            return 0.0
        spent = self.decode_tokens_total + self.prefill_tokens_total
        return min(1.0, spent / (self.tokens_per_step * self.steps_total))

    def snapshot(self) -> dict:
        """JSON-ready view for bench records and debugging."""
        return {
            "token_budget": self.tokens_per_step or 0,
            "steps": self.steps_total,
            "decode_tokens": self.decode_tokens_total,
            "prefill_tokens": self.prefill_tokens_total,
            "chunks": self.chunks_total,
            "admission_deferred": self.admission_deferred_total,
            "burst_clamped": self.burst_clamped_total,
            "dispatch_ahead": self.dispatch_ahead_total,
            "burst_span_steps": {str(k): v for k, v in
                                 sorted(self.burst_span_steps.items())},
            "kv_restores": self.kv_restores_total,
            "kv_restore_tokens": self.kv_restore_tokens_total,
            "kv_restore_deferred": self.kv_restore_deferred_total,
            "deadline_shed": self.deadline_shed_total,
            "tier_preemptions": self.tier_preemptions_total,
            "preempt_parks": self.preempt_parks_total,
            "preempt_parked_pages": self.preempt_parked_pages_total,
            "preempt_resumes": self.preempt_resumes_total,
            "preempt_resume_reused_tokens":
                self.preempt_resume_reused_tokens_total,
            "budget_utilization": round(self.utilization(), 4),
            "fused_steps": self.fused_steps_total,
            "weight_passes": self.weight_passes_total,
            "weight_passes_per_step": round(self.weight_passes_per_step(), 4),
            "fused_packed_tokens_sum": self.fused_packed_tokens_sum,
        }
