"""Token sampling: greedy, temperature, top-k, top-p, min-p, penalties,
seeds (port of ``fusioninfer_tpu/engine/sampler.py``).

Each row carries its own sampling params.  A sampled row draws from a
``torch.Generator`` seeded by ``(request seed, tokens generated so far)``
— counter-based like the JAX package's ``fold_in(seed, n)`` keys — so a
seeded request produces the same tokens whether it runs alone or packed
with others, and after a preemption resumes the stream where it stopped.
The bits differ from the JAX package's (different generators).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0
    min_p: float = 0.0  # drop tokens with p < min_p * p_max
    max_tokens: int = 128
    min_tokens: int = 0  # stop tokens suppressed until this many generated
    stop_token_ids: tuple[int, ...] = ()
    # decoded-text stop sequences, matched by the server
    stop_strings: tuple[str, ...] = ()
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    seed: Optional[int] = None

    @property
    def needs_token_counts(self) -> bool:
        return (self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0
                or self.repetition_penalty != 1.0)


def apply_penalties(logits, token_counts, output_counts, presence, frequency,
                    repetition) -> torch.Tensor:
    """OpenAI/vLLM semantics: presence/frequency penalize generated tokens;
    the repetition penalty spans prompt + output.  logits [B, V] f32,
    counts [B, V] int, per-row params [B]."""
    seen = token_counts > 0
    rep = repetition[:, None]
    logits = torch.where(seen, torch.where(logits > 0, logits / rep,
                                           logits * rep), logits)
    logits = logits - presence[:, None] * (output_counts > 0)
    return logits - frequency[:, None] * output_counts


def filter_logits(logits, temperature, top_k, top_p, min_p=None) -> torch.Tensor:
    """Temperature-scaled logits with min_p/top-k/top-p masks applied
    (-inf outside the sampleable support)."""
    B, V = logits.shape
    ninf = torch.tensor(float("-inf"), device=logits.device)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    if min_p is not None:
        probs = torch.softmax(scaled, dim=-1)
        floor = min_p[:, None] * probs.amax(dim=-1, keepdim=True)
        scaled = torch.where(probs < floor, ninf, scaled)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = (torch.where(top_k > 0, top_k, torch.full_like(top_k, V)) - 1
             ).clamp(0, V - 1).long()
    kth = torch.gather(sorted_desc, 1, k_idx[:, None])
    scaled = torch.where(scaled < kth, ninf, scaled)
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cumulative = torch.cumsum(sorted_probs, dim=-1)
    cutoff = (cumulative - sorted_probs) < top_p[:, None]
    threshold = torch.where(cutoff, sorted_logits,
                            torch.tensor(float("inf"), device=logits.device)
                            ).amin(dim=-1, keepdim=True)
    return torch.where(scaled < threshold, ninf, scaled)


def row_generator(seed: int, counter: int, device) -> torch.Generator:
    """The generator of draw ``counter`` of stream ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(counter)) & 0x7FFF_FFFF_FFFF_FFFF)
    return g


def sample(logits, temperature, top_k, top_p, min_p, seeds, counters) -> torch.Tensor:
    """One token per row → [B] int64; temperature <= 0 is greedy.

    ``temperature``/``top_k``/``top_p``/``min_p`` are [B] tensors on the
    logits' device; ``seeds``/``counters`` are host sequences of ints
    (read only for sampled rows)."""
    greedy_tok = torch.argmax(logits, dim=-1)
    temps = temperature.tolist()
    sampled_rows = [i for i, t in enumerate(temps) if t > 0.0]
    if not sampled_rows:
        return greedy_tok
    rows = torch.tensor(sampled_rows, device=logits.device)
    scaled = filter_logits(logits[rows], temperature[rows], top_k[rows],
                           top_p[rows], min_p[rows])
    probs = torch.softmax(scaled, dim=-1)
    out = greedy_tok.clone()
    for j, i in enumerate(sampled_rows):
        g = row_generator(seeds[i], counters[i], logits.device)
        out[i] = torch.multinomial(probs[j], 1, generator=g)[0]
    return out
