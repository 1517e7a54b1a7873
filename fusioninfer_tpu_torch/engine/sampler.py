"""Token sampling: greedy, temperature, top-k, top-p, min-p, penalties,
seeds, the candidate sampler and the speculative window draws (port of
``fusioninfer_tpu/engine/sampler.py``).

Each row carries its own sampling params, as tensors.  A sampled row's
randomness is a pure function of ``(request seed, tokens generated so
far, stream)``: :func:`gumbel_noise` hashes the three and each column
index into uniforms with integer tensor ops, on the logits' device, and
a draw is the Gumbel-max ``argmax(scaled logits + noise)``.  This is the
counterpart of the JAX package's ``make_row_keys`` (``fold_in(seed,
n)``): no generator object, nothing built on the host, so the same draw
runs eagerly, inside a decode burst whose counters advance on the
device, and inside a CUDA graph replayed with new seeds.  The draw never
depends on the batch, and neither do a row's logits: every projection
and norm reduces a row in an order fixed by the weight's shape
(:mod:`ops.gemm`, :mod:`ops.rms_norm`), so a seeded request produces the
same tokens whether it runs alone or packed with others, beside a
prefill chunk in one fused forward (``--decode-burst 1 --fused-step``),
per token or in bursts, and after a preemption resumes the stream where
it stopped, on the card as on the CPU; greedy streams are the same with
speculation on or off.  The bits differ from the JAX package's (a
different hash).

Every row draws by its own params, never by its batch's: a row with
``0 < top_k <= LM_HEAD_TOPK`` and ``min_p`` off draws from its candidate
set (:func:`sample_topk` over :func:`topk_ordered`'s 64 best logits, the
set the JAX package's fused lm_head top-k path computes); a row with no
filter draws from its temperature-scaled logits; any other row from
:func:`filter_logits`.  :func:`sample`'s static ``mode``
(:func:`sample_mode`, the JAX engine's ``_sample_mode``) only skips the
work of row kinds a batch lacks: a row gets the same token in every mode
that can see it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import torch

# candidate-set width: the largest `top_k` that draws from the candidates
LM_HEAD_TOPK = 64
SAMPLE_MODES = ("greedy", "plain", "topk", "filtered")
# draw streams of one (seed, counter): 0 draws the token; the speculative
# window's acceptance uniform and rejection replacement take 1 and 2
N_STREAMS = 3

_MASK32 = 0xFFFF_FFFF
# odd multipliers below 2**31: a 32-bit value times one stays inside
# int64, so the hash is exact on every device
_MUL_A = 0x7FEB_352D
_MUL_B = 0x2C1B_3C6D
# spreads column indices over the 32-bit key space
_COLUMN_STEP = 0x9E37_79B9


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
    # OpenAI `response_format: json_object`: constrain output to valid
    # JSON via byte-level grammar masking (engine/guided.py)
    guided_json: bool = False
    # OpenAI `response_format: json_schema`: canonical-JSON schema string
    # compiled to a schema-constrained byte machine (guided.SchemaByteMachine)
    guided_schema: str = ""
    # OpenAI `logit_bias`: additive per-token-id adjustments, applied after
    # penalties and the min-tokens suppression every step
    logit_bias: tuple[tuple[int, float], ...] = ()

    @property
    def needs_token_counts(self) -> bool:
        return (self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0
                or self.repetition_penalty != 1.0)


def sample_mode(params: Iterable[SamplingParams]) -> str:
    """The static mode of :func:`sample` for a batch, from its rows'
    params on the host (the JAX engine's ``_sample_mode``): "greedy" when
    every row is greedy, "plain" when no sampled row filters, "topk" when
    every sampled row is a candidate row, else "filtered"."""
    mode = "greedy"
    for p in params:
        if p.temperature <= 0.0:
            continue
        if p.min_p > 0.0:
            return "filtered"
        if 0 < p.top_k <= LM_HEAD_TOPK:
            row = "topk"
        elif p.top_k == 0 and p.top_p >= 1.0:
            row = "plain"
        else:
            return "filtered"
        if mode == "greedy":
            mode = row
        elif mode != row:
            return "filtered"
    return mode


def apply_penalties(logits, token_counts, output_counts, presence, frequency,
                    repetition) -> torch.Tensor:
    """OpenAI/vLLM semantics: presence/frequency penalize generated tokens;
    the repetition penalty spans prompt + output.  logits [B, V] f32,
    counts [B, V] int, per-row params [B].  Neutral params (0, 0, 1)
    leave every logit's bits as they were."""
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
    (-inf outside the sampleable support).  Masks fill in place of
    building constant tensors from the host, so the call can be
    captured in a CUDA graph."""
    B, V = logits.shape
    ninf = float("-inf")
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    if min_p is not None:
        probs = torch.softmax(scaled, dim=-1)
        floor = min_p[:, None] * probs.amax(dim=-1, keepdim=True)
        scaled = scaled.masked_fill(probs < floor, ninf)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = (torch.where(top_k > 0, top_k, torch.full_like(top_k, V)) - 1
             ).clamp(0, V - 1).long()
    kth = torch.gather(sorted_desc, 1, k_idx[:, None])
    scaled = scaled.masked_fill(scaled < kth, ninf)
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cumulative = torch.cumsum(sorted_probs, dim=-1)
    cutoff = (cumulative - sorted_probs) < top_p[:, None]
    threshold = sorted_logits.masked_fill(~cutoff, float("inf")).amin(dim=-1, keepdim=True)
    return scaled.masked_fill(scaled < threshold, ninf)


# -- the counter-based draw ---------------------------------------------------


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer finalizer over int64 tensors holding
    values in ``[0, 2**32)``."""
    x = x ^ (x >> 16)
    x = (x * _MUL_A) & _MASK32
    x = x ^ (x >> 15)
    x = (x * _MUL_B) & _MASK32
    return x ^ (x >> 16)


def _row_keys(seeds: torch.Tensor, counters: torch.Tensor, stream: int) -> torch.Tensor:
    """[N] int64 keys in ``[0, 2**32)``, one per ``(seed, counter,
    stream)``; ``seeds`` are taken modulo 2**32 (their uint32 bits)."""
    s = _mix32(seeds.long() & _MASK32)
    return _mix32((s + counters.long() * N_STREAMS + stream) & _MASK32)


def uniforms(seeds, counters, stream: int, n: int) -> torch.Tensor:
    """``[N, n]`` f32 uniforms in (0, 1): column ``j`` of row ``i`` is a
    pure function of ``(seeds[i], counters[i], stream, j)`` (24-bit
    resolution, exactly representable), so a row's draws never depend on
    its batch, on ``n`` beyond column ``j`` or on the device's state."""
    key = _row_keys(seeds, counters, stream)[:, None]
    cols = torch.arange(n, device=key.device, dtype=torch.int64)
    h = _mix32((_mix32(key ^ ((cols * _COLUMN_STEP) & _MASK32)) + key) & _MASK32)
    return ((h >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)


def gumbel_noise(seeds, counters, stream: int, n: int) -> torch.Tensor:
    """``[N, n]`` standard Gumbel noise from :func:`uniforms`; ``argmax
    (scaled logits + noise)`` draws from ``softmax(scaled logits)``."""
    return -torch.log(-torch.log(uniforms(seeds, counters, stream, n)))


def _col(x, dtype, device) -> torch.Tensor:
    """A per-row parameter as a tensor: a tensor passes as it is (cast if
    needed), a host sequence is uploaded (outside CUDA-graph capture)."""
    return torch.as_tensor(x, dtype=dtype, device=device)


def _params(logits, temperature, top_k, top_p, min_p, seeds, counters):
    dev = logits.device
    return (_col(temperature, torch.float32, dev), _col(top_k, torch.int64, dev),
            _col(top_p, torch.float32, dev), _col(min_p, torch.float32, dev),
            _col(seeds, torch.int64, dev), _col(counters, torch.int64, dev))


def sample_topk(vals, idx, temperature, top_k, top_p, seeds, counters,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The candidate sampler → [N] int64, where candidate rows draw (the
    JAX package's fused lm_head top-k path draws the same way).

    ``vals``/``idx`` [N, K]: penalized UNSCALED logits in
    :func:`topk_ordered`'s order and their vocab ids; per-row params as
    tensors or host sequences of N.  Temperature scaling, a rank-based
    top-k mask (rank < top_k IS the top-k set; exact ties at the boundary
    resolve by vocab index), the nucleus mask over the candidate
    distribution, one Gumbel-max draw over [K] (``noise``: stream 0's
    first K columns, computed here when None).  Greedy rows read
    candidate 0, the first maximum."""
    dev = vals.device
    temp = _col(temperature, torch.float32, dev)
    kk = _col(top_k, torch.int64, dev).clamp(min=1)
    pp = _col(top_p, torch.float32, dev)
    K = vals.shape[1]
    ninf = float("-inf")
    scaled = vals / temp.clamp(min=1e-6)[:, None]
    scaled = scaled.masked_fill(torch.arange(K, device=dev)[None, :] >= kk[:, None], ninf)
    probs = torch.softmax(scaled, dim=-1)
    cumulative = torch.cumsum(probs, dim=-1)
    scaled = scaled.masked_fill((cumulative - probs) >= pp[:, None], ninf)
    if noise is None:
        noise = gumbel_noise(_col(seeds, torch.int64, dev),
                             _col(counters, torch.int64, dev), 0, K)
    j = torch.argmax(scaled + noise[:, :K], dim=-1)
    drawn = torch.gather(idx, 1, j[:, None])[:, 0]
    return torch.where(temp > 0.0, drawn, idx[:, 0])


def sample(logits, temperature, top_k, top_p, min_p, seeds, counters,
           mode: str = "filtered") -> torch.Tensor:
    """One token per row of ``logits [N, V]`` → [N] int64; temperature <=
    0 is greedy.  The per-row params are tensors on the logits' device
    (or host sequences, uploaded once); nothing is read back to the
    host, so the call can be captured in a CUDA graph.

    ``mode`` (:func:`sample_mode`) is static: "greedy" computes the
    argmax alone, "plain" the temperature draw, "topk" the candidate
    draw, "filtered" all three kinds, each row taking its own.  A
    candidate row draws through :func:`sample_topk`, a plain row from its
    temperature-scaled logits, any other row from :func:`filter_logits`:
    in every mode that can see a row, the row gets the same token, and
    it never depends on its neighbours."""
    if mode not in SAMPLE_MODES:
        raise ValueError(f"unknown sample mode {mode!r}")
    greedy = torch.argmax(logits, dim=-1)
    if mode == "greedy":
        return greedy
    temp, kk, pp, mp, seeds, counters = _params(logits, temperature, top_k, top_p,
                                                min_p, seeds, counters)
    drawn_rows = temp > 0.0
    K = min(LM_HEAD_TOPK, logits.shape[-1])
    if mode == "topk":
        vals, idx = topk_ordered(logits, K)
        return torch.where(drawn_rows, sample_topk(vals, idx, temp, kk, pp, seeds,
                                                   counters), greedy)
    noise = gumbel_noise(seeds, counters, 0, logits.shape[-1])
    scaled = logits / temp.clamp(min=1e-6)[:, None]
    plain = torch.argmax(scaled + noise, dim=-1)
    if mode == "plain":
        return torch.where(drawn_rows, plain, greedy)
    filtered = torch.argmax(filter_logits(logits, temp, kk, pp, mp) + noise, dim=-1)
    vals, idx = topk_ordered(logits, K)
    cand = sample_topk(vals, idx, temp, kk, pp, seeds, counters, noise=noise)
    is_cand = (kk > 0) & (kk <= LM_HEAD_TOPK) & (mp <= 0.0)
    is_plain = (kk == 0) & (pp >= 1.0) & (mp <= 0.0)
    tok = torch.where(is_cand, cand, torch.where(is_plain, plain, filtered))
    return torch.where(drawn_rows, tok, greedy)


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
    * ``u[b, j]``: the acceptance uniform, stream 1 of that (seed,
      counter);
    * ``repl[b, j]``: the rejection replacement, drawn from that
      distribution with the draft removed (for a delta proposal,
      norm((p - q)^+) is p restricted to != draft), stream 2.

    ``draft_next`` [B, C] int on the logits' device; per-row params,
    seeds and counters as tensors or host sequences of B.  Every draw is
    made on the device.  The walk accepts while ``u < p_draft`` (strict:
    a draft outside the support has p_draft 0), emits ``repl`` at the
    first rejection and the bonus ``full[:, k]`` after a full acceptance;
    that keeps the target distribution exactly."""
    B, C, V = logits_w.shape
    dev = logits_w.device
    flat = logits_w.reshape(B * C, V)
    temp, kk, pp, mp, seeds, counters = _params(flat[:B], temperature, top_k, top_p,
                                                min_p, seeds, counters)

    def rep(x):
        return x.repeat_interleave(C)

    temps, ks, ps, mps, seeds_f = rep(temp), rep(kk), rep(pp), rep(mp), rep(seeds)
    counters_f = rep(counters) + torch.arange(C, device=dev).repeat(B)
    full = sample(flat, temps, ks, ps, mps, seeds_f, counters_f)
    scaled = filter_logits(flat, temps, ks, ps, mps)
    rows = torch.arange(B * C, device=dev)
    d = draft_next.reshape(B * C).long()
    p_draft = torch.softmax(scaled, dim=-1)[rows, d]
    u = uniforms(seeds_f, counters_f, 1, 1)[:, 0]
    masked = scaled.clone()
    masked[rows, d] = float("-inf")
    # a support of the draft alone leaves nothing to replace it with; its
    # p_draft is 1 and the walk accepts it, so any row serves there
    masked = torch.where(torch.isfinite(masked).any(dim=-1, keepdim=True), masked, scaled)
    repl = torch.argmax(masked + gumbel_noise(seeds_f, counters_f, 2, V), dim=-1)
    return (full.reshape(B, C), p_draft.reshape(B, C), u.reshape(B, C),
            repl.reshape(B, C))
