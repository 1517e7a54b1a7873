"""Speculative decoding of the PyTorch port against the JAX package.

* ``engine/spec.py``: ``NgramProposer`` proposes the JAX proposer's
  drafts on random and periodic sequences.
* ``sampler.spec_window_draws``: the emitted marginal equals the filtered
  target distribution (the JAX test's V 12, N 4000, atol 0.04), and
  ``full`` is what ``sample`` draws at the same counter.
* The engine: greedy streams with ``speculative_k`` 4 and 7 are
  token-identical to the JAX engine's at the same k and to the port's
  with speculation off, with prefix caching on, the fused step on and
  off, ``kv_splits`` 0 and 8, both page types and a tight pool that
  preempts after rejected drafts; drafts proposed and accepted and the
  token-budget ledger equal JAX's; ``max_tokens`` is exact and a stop
  token inside an accepted burst ends the stream there; sampled
  ``top_k=1`` reproduces greedy; seeded sampled streams are
  deterministic under speculation.

Float32 ``qwen3-tiny``, weights through ``convert.params_from_jax``; the
JAX engine runs with ``fused_sampling=False``, the port's one sampling
path (speculation turns it off in the JAX engine anyway).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from fusioninfer_tpu.engine import engine as jeng
from fusioninfer_tpu.engine import kv_cache as jkv
from fusioninfer_tpu.engine import sampler as jsamp
from fusioninfer_tpu.engine import spec as jspec
from fusioninfer_tpu.models import config as jcfg
from fusioninfer_tpu.models import transformer as jtr
from fusioninfer_tpu_torch import cli
from fusioninfer_tpu_torch.convert import params_from_jax
from fusioninfer_tpu_torch.engine import engine as teng
from fusioninfer_tpu_torch.engine import kv_cache as tkv
from fusioninfer_tpu_torch.engine import sampler as tsamp
from fusioninfer_tpu_torch.engine import spec as tspec
from fusioninfer_tpu_torch.engine.server import engine_from_args
from fusioninfer_tpu_torch.models import config as tcfg

# the empirical marginal of N draws against the target distribution: the
# JAX test's bound (4000 draws: one standard error is <= 0.008)
MARGINAL_ATOL = 0.04


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several test files per core: keep torch's intra-op
    pool to one thread for these small shapes, and restore it after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    cj = dataclasses.replace(jcfg.get_preset("qwen3-tiny"), dtype="float32")
    ct = dataclasses.replace(tcfg.get_preset("qwen3-tiny"), dtype="float32")
    pj = jtr.init_params(cj, jax.random.key(0))
    pt = params_from_jax(jax.tree.map(np.asarray, pj), ct, "cpu")
    return cj, ct, pj, pt


def _ledger(engine) -> dict:
    return engine.sched.snapshot()


# -- the proposer ------------------------------------------------------------------


def _proposer_sequences():
    rng = np.random.default_rng(3)
    seqs = [[int(t) for t in rng.integers(0, n_sym, length)]
            for n_sym, length in ((4, 40), (8, 120), (50, 60), (3, 7), (200, 300))]
    seqs += [[1, 2, 3] * 9, [5, 6, 7, 8] * 5 + [5, 6], [9] * 12, [4, 4, 5] * 6 + [4],
             [7], [], [1, 2]]
    return seqs


@pytest.mark.parametrize("ngram", [(3, 1), (2, 2), (4, 1)])
@pytest.mark.parametrize("seq_i", range(len(_proposer_sequences())))
def test_ngram_proposer_matches_jax(seq_i, ngram):
    seq = _proposer_sequences()[seq_i]
    ours, ref = tspec.NgramProposer(*ngram), jspec.NgramProposer(*ngram)
    for k in (0, 1, 3, 4, 7):
        for cut in range(0, len(seq) + 1, max(1, len(seq) // 9)):
            assert ours.propose(seq[:cut], k) == ref.propose(seq[:cut], k), (cut, k)


def test_ngram_proposer_rejects_bad_ranges():
    for bad in ((0, 1), (2, 3)):
        with pytest.raises(ValueError):
            tspec.NgramProposer(*bad)


# -- the window draws --------------------------------------------------------------


def test_marginal_distribution_preserved():
    """emit = draft if u < p(draft) else the replacement ⇒ the emitted
    marginal equals the filtered target distribution, whatever token is
    proposed; the bonus-token draw ``full`` has that marginal too."""
    V, N = 12, 4000
    base = torch.randn((1, V), generator=torch.Generator().manual_seed(0)) * 2.0
    target = torch.softmax(tsamp.filter_logits(
        base, torch.tensor([0.8]), torch.tensor([0]), torch.tensor([0.9]),
        torch.tensor([0.0])), dim=-1)[0].numpy()
    draft = int(np.argsort(target)[-2])  # a plausible draft token
    logits_w = base.expand(N, V)[:, None, :].contiguous()
    full, p_d, u, repl = tsamp.spec_window_draws(
        logits_w, torch.full((N, 1), draft), [0.8] * N, [0] * N, [0.9] * N, [0.0] * N,
        [7] * N, list(range(N)))
    accept = (u[:, 0] < p_d[:, 0]).numpy()
    emitted = np.where(accept, draft, repl[:, 0].numpy())
    np.testing.assert_allclose(np.bincount(emitted, minlength=V) / N, target,
                               atol=MARGINAL_ATOL)
    np.testing.assert_allclose(np.bincount(full[:, 0].numpy(), minlength=V) / N, target,
                               atol=MARGINAL_ATOL)
    np.testing.assert_allclose(p_d[:, 0].numpy(), target[draft], rtol=1e-6)
    assert (repl[:, 0] != draft).all()


ROW_KINDS = {
    "greedy": dict(temperature=0.0, top_k=0, top_p=1.0, min_p=0.0),
    "plain": dict(temperature=0.9, top_k=0, top_p=1.0, min_p=0.0),
    "candidate top_k": dict(temperature=0.7, top_k=5, top_p=0.95, min_p=0.0),
    "top_p": dict(temperature=1.1, top_k=0, top_p=0.8, min_p=0.0),
    "min_p": dict(temperature=0.8, top_k=5, top_p=1.0, min_p=0.05),
    "top_k over the cap": dict(temperature=0.8, top_k=100, top_p=1.0, min_p=0.0),
}


def test_full_is_sample_at_the_same_counter():
    """``full[b, j]`` is the token ``sample`` draws for row b at counter
    ``counters[b] + j`` on position j's logits, for every kind of row
    (candidate routing included); u and the replacement come from other
    streams than that draw."""
    B, C, V = len(ROW_KINDS), 4, 200
    gen = torch.Generator().manual_seed(1)
    logits_w = torch.randn((B, C, V), generator=gen) * 3.0
    kinds = list(ROW_KINDS.values())
    cols = {k: [kind[k] for kind in kinds] for k in ("temperature", "top_k", "top_p",
                                                     "min_p")}
    seeds, counters = [11 + b for b in range(B)], [5 * b for b in range(B)]
    draft_next = torch.randint(0, V, (B, C), generator=gen)
    full, _, u, repl = tsamp.spec_window_draws(
        logits_w, draft_next, cols["temperature"], cols["top_k"], cols["top_p"],
        cols["min_p"], seeds, counters)
    for j in range(C):
        one = tsamp.sample(logits_w[:, j], cols["temperature"], cols["top_k"],
                           cols["top_p"], cols["min_p"], seeds,
                           [c + j for c in counters])
        assert torch.equal(full[:, j], one), j
    key = torch.tensor([seeds[1]]), torch.tensor([counters[1]])
    assert float(tsamp.uniforms(*key, 1, 1)[0, 0]) == float(u[1, 0])
    assert float(tsamp.uniforms(*key, 0, 1)[0, 0]) != float(u[1, 0])


# -- engine streams ----------------------------------------------------------------


def _drive(engine, make_request, make_params, waves, max_steps=600):
    """Add each wave ``(step, [(id, prompt, max_tokens)])`` at its step and
    step until the engine drains → streams of (token, finish_reason)."""
    streams: dict[str, list] = {}
    last = max(at for at, _ in waves)
    for step in range(max_steps):
        for at, wave in waves:
            if at == step:
                for rid, p, n in wave:
                    engine.add_request(make_request(rid, p, make_params(n)))
        if step > last and not engine.has_work():
            return streams
        for out in engine.step():
            streams.setdefault(out.request_id, []).append((out.token, out.finish_reason))
    raise AssertionError("engine did not drain")


def _engines(weights, *, n_pages, mp, kv_dtype="model", **kw):
    cj, ct, pj, pt = weights
    cc = dict(n_pages=n_pages, page_size=16, max_pages_per_seq=mp, kv_dtype=kv_dtype)
    je = jeng.NativeEngine(cj, jkv.CacheConfig(**cc), params=pj, fused_sampling=False,
                           max_batch_size=4, **kw)
    te = teng.NativeEngine(ct, tkv.CacheConfig(**cc), params=pt, device="cpu",
                           max_batch_size=4, **kw)
    return je, te


def _greedy(n):
    return dict(temperature=0.0, max_tokens=n)


def _pair(weights, waves, params=_greedy, **kw):
    """The waves on the JAX engine and the port's, both built from ``kw``
    → (jax engine, port engine, jax streams, port streams)."""
    je, te = _engines(weights, **kw)
    ref = _drive(je, jeng.Request, lambda n: jsamp.SamplingParams(**params(n)), waves)
    ours = _drive(te, teng.Request, lambda n: tsamp.SamplingParams(**params(n)), waves)
    return je, te, ref, ours


def _extractive_waves(vocab):
    """Prompts that repeat themselves (so the n-gram lookup proposes, and
    the random model's loops accept), one sharing a warm prompt's pages,
    and a long one that chunks while the others decode."""
    rng = np.random.default_rng(0)
    motif = [int(t) for t in rng.integers(3, vocab, 11)]
    shared = motif * 4
    return [(0, [("warm", shared + [5, 6], 24)]),
            (3, [("hit", shared + [int(t) for t in rng.integers(3, vocab, 7)], 24),
                 ("loop", [9, 10, 11, 12] * 6, 24),
                 ("rand", [int(t) for t in rng.integers(3, vocab, 30)], 24)]),
            (6, [("long", [int(t) for t in rng.integers(3, vocab, 80)] * 1, 16)])]


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("kv_splits", [0, 8])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("k", [4, 7])
def test_greedy_streams_identical_to_jax(weights, k, kv_dtype, kv_splits, fused):
    waves = _extractive_waves(weights[0].vocab_size)
    kw = dict(n_pages=48, mp=10, kv_dtype=kv_dtype, token_budget=48, fused_step=fused,
              kv_splits=kv_splits)
    je, te, ref, ours = _pair(weights, waves, speculative_k=k, **kw)
    assert ours == ref
    assert {r: len(s) for r, s in ours.items()} == {
        "warm": 24, "hit": 24, "loop": 24, "rand": 24, "long": 16}
    assert all(s[-1][1] == "length" for s in ours.values())
    assert (te.spec_proposed_total, te.spec_accepted_total) == (
        je.spec_proposed_total, je.spec_accepted_total)
    assert te.spec_accepted_total > 0 and te.spec_proposed_total > te.spec_accepted_total
    assert _ledger(te) == _ledger(je)
    assert te.prefix_cache_hit_rate() == je.prefix_cache_hit_rate() > 0
    assert te.sched.chunks_total > 0 and (te.sched.fused_steps_total > 0) == fused
    # the same streams with speculation off, in fewer steps with it on
    _, off = _engines(weights, **kw)
    plain = _drive(off, teng.Request, lambda n: tsamp.SamplingParams(**_greedy(n)), waves)
    assert plain == ours
    assert te.sched.steps_total < off.sched.steps_total


@pytest.mark.parametrize("kv_splits", [0, 8])
def test_tight_pool_preemption_after_rejected_drafts(weights, kv_splits):
    """6 usable pages of 16 tokens for four sequences with prefix caching
    and a budget: a row is preempted after rejected drafts wrote KV past
    its committed tokens, its committed pages are parked, and its resume
    (a prefix hit on them) continues the stream it would have emitted in
    a pool with room."""
    cj = weights[0]
    prompts = [[int(t) for t in np.random.default_rng(i).integers(3, cj.vocab_size, n)]
               for i, n in enumerate((5, 17, 40, 60))]
    prompts[1] = prompts[1][:6] * 3  # a periodic prompt: drafts from the start
    waves = [(0, [(f"r{i}", p, 20) for i, p in enumerate(prompts)])]
    je, te, ref, ours = _pair(weights, waves, n_pages=7, mp=6, token_budget=16,
                              kv_splits=kv_splits, speculative_k=4)
    assert ours == ref
    assert all(len(s) == 20 for s in ours.values())
    assert te.preemptions_total == je.preemptions_total > 0
    assert te.spec_proposed_total == je.spec_proposed_total > te.spec_accepted_total
    assert te.spec_accepted_total == je.spec_accepted_total
    assert _ledger(te) == _ledger(je)
    assert te.sched.preempt_parks_total > 0
    _, roomy = _engines(weights, n_pages=64, mp=6, token_budget=16, kv_splits=kv_splits)
    assert _drive(roomy, teng.Request, lambda n: tsamp.SamplingParams(**_greedy(n)),
                  waves) == ours


def test_max_tokens_exact_and_stop_inside_a_burst(weights):
    """Every stream ends at exactly ``max_tokens`` (drafts leave room for
    the bonus token); a stop token that an accepted burst emits ends the
    stream there and the burst's later tokens are discarded, as in the
    JAX engine, with the accepted drafts counted up to it only."""
    waves = [(0, [("loop", [9, 10, 11, 12] * 6, 13), ("rep", [3, 4, 5] * 8, 7)])]
    kw = dict(n_pages=32, mp=8, speculative_k=4)
    je, te, ref, ours = _pair(weights, waves, **kw)
    assert ours == ref and [len(ours[r]) for r in ("loop", "rep")] == [13, 7]
    # a token the loop emits inside an accepted burst becomes a stop token
    stream = [t for t, _ in ours["loop"]]
    stop = stream[6]
    cut = stream.index(stop) + 1

    def stopping(n):
        return dict(temperature=0.0, max_tokens=n, stop_token_ids=(stop,))

    je2, te2, ref2, ours2 = _pair(weights, waves, params=stopping, **kw)
    assert ours2 == ref2
    assert [t for t, _ in ours2["loop"]] == stream[:cut]
    assert ours2["loop"][-1][1] == "stop"
    assert te2.spec_accepted_total == je2.spec_accepted_total
    assert te2.generation_tokens_total == je2.generation_tokens_total


def test_sampled_top_k1_reproduces_greedy(weights):
    """A top_k=1 filtered distribution is a delta: speculation accepts
    exactly the greedy drafts and the stream is the greedy one."""
    waves = [(0, [("loop", [9, 10, 11, 12] * 6, 20), ("rand", [int(t) for t in np.random
                  .default_rng(2).integers(3, 200, 25)], 20)])]
    _, te, _, greedy = _pair(weights, waves, n_pages=32, mp=8, speculative_k=4)
    _, sampled = _engines(weights, n_pages=32, mp=8, speculative_k=4)
    out = _drive(sampled, teng.Request, lambda n: tsamp.SamplingParams(
        temperature=0.8, top_k=1, max_tokens=n, seed=5), waves)
    assert out == greedy
    assert sampled.spec_accepted_total == te.spec_accepted_total > 0


def test_seeded_sampled_streams_deterministic_under_spec(weights):
    """Seeded sampled rows speculate (delta-draft rejection sampling) and
    give the same stream on every run; another seed gives another."""
    waves = [(0, [("a", [3, 4, 5] * 10, 16), ("b", [7, 8] * 12, 16)])]

    def run(seed):
        _, te = _engines(weights, n_pages=32, mp=8, speculative_k=4)
        out = _drive(te, teng.Request, lambda n: tsamp.SamplingParams(
            temperature=0.7, top_k=20, max_tokens=n, seed=seed), waves)
        return out, te

    (a, ea), (b, _), (c, _) = run(3), run(3), run(4)
    assert a == b and a != c
    assert ea.spec_proposed_total > 0
    assert all(len(s) == 16 for s in a.values())


def test_spec_ineligible_rows_take_no_drafts(weights):
    """Penalties, logprobs, logit_bias and rows under min_tokens ride the
    window with no drafts; their streams equal speculation off."""
    waves = [(0, [("loop", [9, 10, 11, 12] * 6, 12)])]
    for extra in (dict(repetition_penalty=1.2), dict(logprobs=2),
                  dict(logit_bias=((5, 1.5),)), dict(min_tokens=12, stop_token_ids=(0,))):
        runs = {}
        for k in (None, 4):
            _, te = _engines(weights, n_pages=32, mp=8, speculative_k=k)
            runs[k] = _drive(te, teng.Request, lambda n: tsamp.SamplingParams(
                temperature=0.0, max_tokens=n, **extra), waves)
            assert te.spec_proposed_total == 0
        assert runs[None] == runs[4], extra


def test_speculative_flag_and_validation(weights):
    args = cli.build_parser().parse_args(
        ["engine", "serve", "qwen3-tiny", "--device", "cpu", "--max-model-len", "256",
         "--no-token-budget", "--speculative-ngram", "4"])
    engine = engine_from_args(args)
    assert engine.spec_k == 4 and engine.proposer is not None
    args = cli.build_parser().parse_args(
        ["engine", "serve", "qwen3-tiny", "--device", "cpu", "--max-model-len", "256",
         "--no-token-budget"])
    assert engine_from_args(args).spec_k is None
    with pytest.raises(ValueError):
        teng.NativeEngine(weights[1], params=weights[3], device="cpu", speculative_k=0)
