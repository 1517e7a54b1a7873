"""Per-step scheduling ledger (own copy of the counters of
``fusioninfer_tpu/engine/sched.py::TokenBudget`` that the serve path
without a token budget keeps).

Pure bookkeeping: no clocks, no device work.  Without a budget every
step's prefill remainder is unbounded (monolithic prefill); the counters
feed the engine's stats.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class TokenBudget:
    steps_total: int = 0
    decode_tokens_total: int = 0
    prefill_tokens_total: int = 0
    # weight-streaming forwards dispatched (one per prefill group and
    # one per decode step)
    weight_passes_total: int = 0

    def begin_step(self) -> None:
        self.steps_total += 1

    def charge_decode(self, n: int) -> None:
        self.decode_tokens_total += n

    def charge_prefill(self, n: int) -> None:
        self.prefill_tokens_total += n

    def charge_weight_pass(self, n: int = 1) -> None:
        self.weight_passes_total += n

    def weight_passes_per_step(self) -> float:
        if not self.steps_total:
            return 0.0
        return self.weight_passes_total / self.steps_total

    def snapshot(self) -> dict:
        return {
            "steps": self.steps_total,
            "decode_tokens": self.decode_tokens_total,
            "prefill_tokens": self.prefill_tokens_total,
            "weight_passes": self.weight_passes_total,
            "weight_passes_per_step": round(self.weight_passes_per_step(), 4),
        }
