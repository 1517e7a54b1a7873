"""Token sampling: greedy, temperature, top-k, top-p, min-p, penalties,
seeds, the candidate sampler and the speculative window draws (port of
``fusioninfer_tpu/engine/sampler.py``).

Each row carries its own sampling params.  A sampled row draws from a
``torch.Generator`` seeded by ``(request seed, tokens generated so far)``
(:func:`row_generator`), counter-based like the JAX package's
``fold_in(seed, n)`` keys, so a seeded request produces the same tokens
whether it runs alone or packed with others, and after a preemption
resumes the stream where it stopped.  The bits differ from the JAX
package's (different generators).

Every row draws by its own params, never by its batch's: a row with
``0 < top_k <= LM_HEAD_TOPK`` and ``min_p`` off draws from its candidate
set (:func:`sample_topk` over :func:`topk_ordered`'s 64 best logits, the
set the JAX package's fused lm_head top-k path computes); a row with no
filter draws from its temperature-scaled logits; any other row from
:func:`filter_logits`.  ``sample`` sorts the rows into these kinds on
the host from their params, so a batch skips the work of the kinds it
lacks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

# generator streams of one (seed, counter): 0 draws the token; the
# speculative window's acceptance uniform and rejection replacement take
# 1 and 2, whose keys sit this far past stream 0's.  Stream 0 of another
# counter reaches them only ~427 807 tokens away (the seed step is
# 1 000 003), beyond any sequence length, and in the low 32 bits (the
# CPU generator's seed) they differ from stream 0 of the same key too.
_STREAM_STEP = 0x9E37_79B9
# candidate-set width: the largest `top_k` that draws from the candidates
LM_HEAD_TOPK = 64


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
    # OpenAI `logprobs`: the chosen token's log-probability and the top-N
    # alternatives per step, from the raw (unpenalized) distribution
    logprobs: Optional[int] = None
    # OpenAI `logit_bias`: additive per-token-id adjustments, applied after
    # penalties and the min-tokens suppression every step
    logit_bias: tuple[tuple[int, float], ...] = ()

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


def topk_ordered(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(vals, idx)`` ``[N, min(k, V)]``: each row's largest values of
    ``x [N, V]``, value descending, equal values by ascending index (the
    order of ``lax.top_k``).  ``torch.topk``'s order among equal values
    is unspecified on CUDA and the order defines the candidate draw, so
    it comes from a stable sort.  ``k == 1`` is the first maximum, as
    ``torch.argmax`` gives it."""
    k = min(k, x.shape[-1])
    if k == 1:
        idx = torch.argmax(x, dim=-1, keepdim=True)
        return torch.gather(x, 1, idx), idx
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


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


def row_generator(seed: int, counter: int, device, stream: int = 0) -> torch.Generator:
    """The generator of draw ``counter`` of stream ``seed``; ``stream`` 1
    and 2 are the speculative window's uniform and replacement draws of
    that position."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(counter) + stream * _STREAM_STEP)
                  & 0x7FFF_FFFF_FFFF_FFFF)
    return g


def _draw(probs: torch.Tensor, seeds, counters, stream: int = 0) -> torch.Tensor:
    """One multinomial draw per row of ``probs [N, V]``, row ``i`` from
    :func:`row_generator` ``(seeds[i], counters[i], stream)`` → [N] int64."""
    return torch.stack([
        torch.multinomial(probs[i], 1, generator=row_generator(
            seeds[i], counters[i], probs.device, stream))[0]
        for i in range(probs.shape[0])])


def _is_candidate_row(temp: float, top_k: int, min_p: float, cap: int) -> bool:
    return temp > 0.0 and 0 < top_k <= cap and min_p <= 0.0


def _is_plain_row(temp: float, top_k: int, top_p: float, min_p: float) -> bool:
    return temp > 0.0 and top_k == 0 and top_p >= 1.0 and min_p <= 0.0


def sample_topk(vals, idx, temperature, top_k, top_p, seeds, counters) -> torch.Tensor:
    """The candidate sampler → [N] int64, where ``sample``'s candidate rows
    draw (the JAX package's fused lm_head top-k path draws the same way).

    ``vals``/``idx`` [N, K]: penalized UNSCALED logits in
    :func:`topk_ordered`'s order and their vocab ids;
    ``temperature``/``top_k``/``top_p``/``seeds``/``counters`` host
    sequences of N.  Temperature scaling, a rank-based top-k mask (rank <
    top_k IS the top-k set; exact ties at the boundary resolve by vocab
    index), the nucleus mask over the candidate distribution, one draw
    over [K].  Greedy rows read candidate 0, the first maximum."""
    out = idx[:, 0].clone()
    rows = [i for i, t in enumerate(temperature) if t > 0.0]
    if not rows:
        return out
    dev = vals.device
    K = vals.shape[1]
    sel = torch.tensor(rows, device=dev)
    temp = torch.tensor([max(float(temperature[i]), 1e-6) for i in rows], device=dev)
    kk = torch.tensor([max(int(top_k[i]), 1) for i in rows], device=dev)
    pp = torch.tensor([float(top_p[i]) for i in rows], device=dev)
    ninf = torch.tensor(float("-inf"), device=dev)
    scaled = vals[sel] / temp[:, None]
    scaled = torch.where(torch.arange(K, device=dev)[None, :] < kk[:, None], scaled, ninf)
    probs = torch.softmax(scaled, dim=-1)
    cumulative = torch.cumsum(probs, dim=-1)
    scaled = torch.where((cumulative - probs) < pp[:, None], scaled, ninf)
    j = _draw(torch.softmax(scaled, dim=-1), [seeds[i] for i in rows],
              [counters[i] for i in rows])
    out[sel] = torch.gather(idx[sel], 1, j[:, None])[:, 0]
    return out


def sample(logits, temperature, top_k, top_p, min_p, seeds, counters) -> torch.Tensor:
    """One token per row of ``logits [N, V]`` → [N] int64; temperature <=
    0 is greedy.  ``temperature``/``top_k``/``top_p``/``min_p``/``seeds``/
    ``counters`` are host sequences of N.

    A candidate row draws through :func:`sample_topk` over
    :func:`topk_ordered`'s candidates, a plain row from
    its temperature-scaled logits, any other row from
    :func:`filter_logits`: a row's draw never depends on its
    neighbours."""
    out = torch.argmax(logits, dim=-1)
    dev = logits.device
    cap = min(LM_HEAD_TOPK, logits.shape[-1])
    cand, plain, rest = [], [], []
    for i, t in enumerate(temperature):
        if t <= 0.0:
            continue
        if _is_candidate_row(t, top_k[i], min_p[i], cap):
            cand.append(i)
        elif _is_plain_row(t, top_k[i], top_p[i], min_p[i]):
            plain.append(i)
        else:
            rest.append(i)

    def col(rows, vals, dtype=torch.float32):
        return torch.tensor([vals[i] for i in rows], dtype=dtype, device=dev)

    if cand:
        sel = torch.tensor(cand, device=dev)
        vals, idx = topk_ordered(logits[sel], cap)
        out[sel] = sample_topk(vals, idx, *([xs[i] for i in cand] for xs in (
            temperature, top_k, top_p, seeds, counters)))
    if plain:
        sel = torch.tensor(plain, device=dev)
        scaled = logits[sel] / col(plain, temperature).clamp(min=1e-6)[:, None]
        out[sel] = _draw(torch.softmax(scaled, dim=-1), [seeds[i] for i in plain],
                         [counters[i] for i in plain])
    if rest:
        sel = torch.tensor(rest, device=dev)
        scaled = filter_logits(logits[sel], col(rest, temperature),
                               col(rest, top_k, torch.int64), col(rest, top_p),
                               col(rest, min_p))
        out[sel] = _draw(torch.softmax(scaled, dim=-1), [seeds[i] for i in rest],
                         [counters[i] for i in rest])
    return out


def spec_window_draws(logits_w, draft_next, temperature, top_k, top_p, min_p,
                      seeds, counters):
    """What the host's speculative acceptance walk needs for rows of
    window logits ``[B, C, V]`` f32 (delta-draft speculative sampling,
    Leviathan et al.), → ``(full, p_draft, u, repl)``, each [B, C]:

    * ``full[b, j]``: the token :func:`sample` draws for row ``b`` at
      counter ``counters[b] + j`` on position j's logits (candidate
      routing included); ``full[b, k]`` is the bonus token after all k
      drafts were accepted, the one-token path's draw;
    * ``p_draft[b, j]``: the probability of ``draft_next[b, j]`` (the
      draft proposed after position j) under :func:`filter_logits`'s
      distribution over the full vocab;
    * ``u[b, j]``: the acceptance uniform, generator stream 1 of that
      (seed, counter);
    * ``repl[b, j]``: the rejection replacement, drawn from that
      distribution with the draft removed (for a delta proposal,
      norm((p - q)^+) is p restricted to != draft), stream 2.

    ``draft_next`` [B, C] int on the logits' device; the params, seeds
    and counters host sequences of B.  The walk accepts while ``u <
    p_draft`` (strict: ``u`` may be 0 and a draft outside the support has
    p_draft 0), emits ``repl`` at the first rejection and the bonus
    ``full[:, k]`` after a full acceptance; that keeps the target
    distribution exactly."""
    B, C, V = logits_w.shape
    dev = logits_w.device
    flat = logits_w.reshape(B * C, V)

    def rep(xs):
        return [xs[b] for b in range(B) for _ in range(C)]

    seeds_f = rep(seeds)
    counters_f = [int(counters[b]) + j for b in range(B) for j in range(C)]
    temps, ks, ps, mps = rep(temperature), rep(top_k), rep(top_p), rep(min_p)
    full = sample(flat, temps, ks, ps, mps, seeds_f, counters_f)
    scaled = filter_logits(
        flat, torch.tensor(temps, dtype=torch.float32, device=dev),
        torch.tensor(ks, dtype=torch.int64, device=dev),
        torch.tensor(ps, dtype=torch.float32, device=dev),
        torch.tensor(mps, dtype=torch.float32, device=dev))
    rows = torch.arange(B * C, device=dev)
    d = draft_next.reshape(B * C).long()
    p_draft = torch.softmax(scaled, dim=-1)[rows, d]
    u = torch.stack([
        torch.rand((), generator=row_generator(s, c, dev, stream=1), device=dev)
        for s, c in zip(seeds_f, counters_f)])
    masked = scaled.clone()
    masked[rows, d] = float("-inf")
    # a support of the draft alone leaves nothing to replace it with; its
    # p_draft is 1 and the walk accepts it, so any row serves there
    masked = torch.where(torch.isfinite(masked).any(dim=-1, keepdim=True), masked, scaled)
    repl = _draw(torch.softmax(masked, dim=-1), seeds_f, counters_f, stream=2)
    return (full.reshape(B, C), p_draft.reshape(B, C), u.reshape(B, C),
            repl.reshape(B, C))
