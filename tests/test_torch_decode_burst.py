"""Decode bursts of the PyTorch port against the JAX package (the cases of
``tests/test_decode_burst.py``).

* The engine: with ``decode_burst_steps`` 4 or 8, pipelined and not,
  greedy streams are token-identical to the JAX burst engine's with the
  same settings, and ``sched.snapshot()`` is equal, ``burst_span_steps``,
  ``dispatch_ahead`` and ``burst_clamped`` included: a finish mid-burst,
  a stop token mid-burst, a batch, prefix caching with page growth,
  logprobs rows stepping once a pass beside bursting rows, a pool too
  small for burst headroom, short budgets, steady state, staggered
  admission, a cancel mid-flight, int8 pages.  Seeded streams (top-k,
  top-p, min-p, penalties, min_tokens) are the same on the port's burst
  and per-token engines.
* ``model_runner.decode_burst`` run eagerly equals ``n_steps`` sequential
  fixed-M ``decode_step`` + penalties + suppression + ``sample`` calls,
  bit for bit, in every sample mode.

Float32 ``qwen3-tiny``, weights through ``convert.params_from_jax``; the
JAX engine runs with ``fused_sampling=False``, the port's one sampling
path.  LoRA is not ported; windowed bursts are held in
``test_torch_window_reclaim.py`` (and here against a windowed JAX burst
engine).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from fusioninfer_tpu.engine import engine as jeng
from fusioninfer_tpu.engine import kv_cache as jkv
from fusioninfer_tpu.engine import sampler as jsamp
from fusioninfer_tpu.models import config as jcfg
from fusioninfer_tpu.models import transformer as jtr
from fusioninfer_tpu_torch.convert import params_from_jax
from fusioninfer_tpu_torch.engine import engine as teng
from fusioninfer_tpu_torch.engine import kv_cache as tkv
from fusioninfer_tpu_torch.engine import model_runner as tmr
from fusioninfer_tpu_torch.engine import sampler as tsamp
from fusioninfer_tpu_torch.models import config as tcfg

CACHE = dict(n_pages=64, page_size=8, max_pages_per_seq=8)


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


def _port(weights, burst, cache=CACHE, **kw):
    _, ct, _, pt = weights
    return teng.NativeEngine(ct, tkv.CacheConfig(**cache), params=pt, device="cpu",
                             max_batch_size=4, decode_burst_steps=burst, **kw)


def _jax(weights, burst, cache=CACHE, **kw):
    cj, _, pj, _ = weights
    return jeng.NativeEngine(cj, jkv.CacheConfig(**cache), params=pj, max_batch_size=4,
                             fused_sampling=False, decode_burst_steps=burst, **kw)


def _drive(engine, make_request, make_params, requests, events=(), max_steps=400):
    """Add ``[(id, prompt, params kwargs)]``, step until drained, calling
    ``events[step](engine, make_request, make_params)`` before that step →
    ``({id: [(token, finish_reason)]}, [{id: outputs that step}])``."""
    for rid, prompt, kw in requests:
        engine.add_request(make_request(rid, prompt, make_params(**kw)))
    events = dict(events)
    streams: dict[str, list] = {}
    per_step = []
    for step in range(max_steps):
        if step in events:
            events[step](engine, make_request, make_params)
        if step > max(events, default=-1) and not engine.has_work():
            return streams, per_step
        counts: dict[str, int] = {}
        for out in engine.step():
            streams.setdefault(out.request_id, []).append((out.token, out.finish_reason))
            counts[out.request_id] = counts.get(out.request_id, 0) + 1
        per_step.append(counts)
    raise AssertionError("engine did not drain")


def _port_run(weights, burst, requests, events=(), cache=CACHE, **kw):
    engine = _port(weights, burst, cache, **kw)
    streams, per_step = _drive(engine, teng.Request, tsamp.SamplingParams, requests,
                               events)
    assert engine.num_running == 0
    return streams, per_step, engine


def _against_jax(weights, burst, requests, events=(), cache=CACHE, **kw):
    """The port's burst engine against the JAX one with the same settings:
    the same streams and the same scheduler ledger → (streams, per-step
    outputs, the port's engine)."""
    streams, per_step, te = _port_run(weights, burst, requests, events, cache, **kw)
    je = _jax(weights, burst, cache, **kw)
    ref, _ = _drive(je, jeng.Request, jsamp.SamplingParams, requests, events)
    assert streams == ref
    assert te.sched.snapshot() == je.sched.snapshot()
    return streams, per_step, te


def _greedy(rid, prompt, n, **kw):
    return (rid, prompt, dict(temperature=0.0, max_tokens=n, **kw))


class TestBurstIdentity:
    def test_greedy_identity_mid_burst_finish(self, weights):
        """max_tokens 10 with span 4: the last burst overruns by 2, and the
        overrun is discarded; the stream equals per-token stepping's."""
        reqs = [_greedy("g", [2, 4, 6, 8], 10)]
        streams, _, _ = _against_jax(weights, 4, reqs)
        assert streams == _port_run(weights, 1, reqs)[0]
        assert [f for _, f in streams["g"]][-1] == "length" and len(streams["g"]) == 10

    @pytest.mark.parametrize("pipelined", [True, False])
    def test_sampled_identity_with_penalties(self, weights, pipelined):
        """Seeded top-k / top-p / min-p rows with penalties and min_tokens:
        the burst's penalty order and counters give the per-token
        engine's streams."""
        reqs = [("s0", [1, 3, 5], dict(temperature=0.9, top_k=20, top_p=0.95, seed=7,
                                       presence_penalty=0.4, frequency_penalty=0.2,
                                       repetition_penalty=1.2, max_tokens=12)),
                ("s1", [9, 9, 2], dict(temperature=0.7, min_p=0.02, seed=11, min_tokens=6,
                                       stop_token_ids=(0,), max_tokens=12)),
                ("s2", [4, 4, 4, 7], dict(temperature=1.1, seed=3, max_tokens=12))]
        burst, _, engine = _port_run(weights, 4, reqs, pipeline_bursts=pipelined)
        assert burst == _port_run(weights, 1, reqs)[0]
        assert engine.sched.burst_span_steps[4] > 0

    def test_batched_identity(self, weights):
        reqs = [_greedy(f"r{i}", [2 + i, 4, 6], 8) for i in range(4)]
        streams, _, _ = _against_jax(weights, 4, reqs)
        assert streams == _port_run(weights, 1, reqs)[0]

    def test_stop_token_mid_burst_truncates(self, weights):
        """A stop token landing mid-burst ends the stream there."""
        probe = _port_run(weights, 1, [_greedy("p", [2, 4, 6], 8)])[0]["p"]
        stop = probe[3][0]
        reqs = [_greedy("x", [2, 4, 6], 8, stop_token_ids=(stop,))]
        streams, _, _ = _against_jax(weights, 8, reqs)
        assert streams["x"][-1] == (stop, "stop") and len(streams["x"]) <= 4

    def test_burst_with_prefix_caching_and_page_growth(self, weights):
        """Bursts of 8 cross page boundaries (page 8): the pre-extension
        covers the whole burst, with the prefix-caching allocator."""
        reqs = [_greedy("long", list(range(2, 12)), 24)]
        streams, _, _ = _against_jax(weights, 8, reqs, enable_prefix_caching=True)
        assert streams == _port_run(weights, 1, reqs, enable_prefix_caching=True)[0]


class TestBurstFallbacks:
    def test_logprobs_rows_fall_back(self, weights):
        """A logprobs row alone steps one token a pass, its logprobs
        arriving with every token."""
        reqs = [_greedy("lp", [2, 4], 5, logprobs=3)]
        engine = _port(weights, 8)
        engine.add_request(teng.Request("lp", [2, 4], tsamp.SamplingParams(
            temperature=0.0, max_tokens=5, logprobs=3)))
        outs = []
        while engine.has_work():
            assert engine._burst_span() == 1
            outs += engine.step()
        assert len(outs) == 5 and all(o.logprob is not None for o in outs)
        streams, _, _ = _against_jax(weights, 8, reqs)
        assert [t for t, _ in streams["lp"]] == [o.token for o in outs]

    def test_mixed_batch_fallback_is_row_granular(self, weights):
        """One logprobs row does not stop its greedy neighbours bursting;
        it advances one token a step (two on its admission step)."""
        reqs = [_greedy(f"g{i}", [2 + i, 4, 6], 16) for i in range(2)]
        reqs.append(_greedy("lp", [9, 8, 7], 16, logprobs=2))
        streams, per_step, _ = _against_jax(weights, 8, reqs)
        assert any(v > 2 for counts in per_step for k, v in counts.items()
                   if k.startswith("g")), "the greedy rows never bursted"
        seen = 0
        for counts in per_step:
            n = counts.get("lp", 0)
            assert n <= (2 if seen == 0 else 1)
            seen += n
        assert seen == 16
        base = _port_run(weights, 1, reqs[:2])[0]
        assert {k: v for k, v in streams.items() if k.startswith("g")} == base

    def test_memory_pressure_decays_span(self, weights):
        """A pool too small for burst headroom decays to span 1 rather
        than preempt, and still finishes everyone."""
        tiny = dict(CACHE, n_pages=10)
        reqs = [_greedy(f"m{i}", [3 + i, 5], 20) for i in range(3)]
        streams, _, engine = _against_jax(weights, 8, reqs, cache=tiny)
        assert streams == _port_run(weights, 1, reqs, cache=tiny)[0]
        assert engine.sched.burst_span_steps[1] > 0

    def test_span_stays_one_when_remaining_short(self, weights):
        """Every row within a span of its budget: span 1."""
        streams, _, engine = _against_jax(weights, 8, [_greedy("short", [2, 4], 3)])
        assert len(streams["short"]) == 3
        assert engine.sched.burst_span_steps[8] == 0

    @pytest.mark.parametrize("bad", ["zero", "window"])
    def test_burst_rejects_bad_config(self, weights, bad):
        """A span below 1 is refused.  A sliding window is not a bad config
        any more: its bursts trim pages below the window, and a windowed
        burst engine serves the JAX windowed burst engine's stream."""
        cj, ct, pj, pt = weights
        if bad == "zero":
            with pytest.raises(ValueError):
                _port(weights, 0)
            return
        te = teng.NativeEngine(dataclasses.replace(ct, sliding_window=24),
                               tkv.CacheConfig(**CACHE), params=pt, device="cpu",
                               max_batch_size=4, decode_burst_steps=8)
        je = jeng.NativeEngine(dataclasses.replace(cj, sliding_window=24),
                               jkv.CacheConfig(**CACHE), params=pj, max_batch_size=4,
                               fused_sampling=False, decode_burst_steps=8)
        reqs = [_greedy("w", [2, 4, 6], 40)]
        ours, _ = _drive(te, teng.Request, tsamp.SamplingParams, reqs)
        ref, _ = _drive(je, jeng.Request, jsamp.SamplingParams, reqs)
        assert ours == ref and len(ours["w"]) == 40
        assert te.sched.snapshot() == je.sched.snapshot()
        assert te.sched.burst_span_steps[8] > 0 and te.window_pages_trimmed_total > 0


class TestBurstPipelining:
    """The successor burst dispatches from the device-side carry before
    the current burst's tokens are read; any change of the running set
    breaks the chain, and streams equal the unpipelined engine's."""

    @pytest.mark.parametrize("pipelined", [True, False])
    def test_steady_state_identity(self, weights, pipelined):
        reqs = [_greedy(f"r{i}", [2 + i, 4, 6], 40) for i in range(3)]
        streams, _, engine = _against_jax(weights, 4, reqs, pipeline_bursts=pipelined)
        assert (engine.sched.dispatch_ahead_total > 0) == pipelined
        assert streams == _port_run(weights, 1, reqs)[0]

    def test_pipeline_engages(self, weights):
        engine = _port(weights, 4, pipeline_bursts=True)
        engine.add_request(teng.Request("r", [2, 4, 6], tsamp.SamplingParams(
            temperature=0.0, max_tokens=56)))
        saw = False
        for _ in range(40):
            if not engine.has_work():
                break
            engine.step()
            saw = saw or engine._inflight is not None
        assert saw, "the pipeline never engaged in steady state"
        assert engine._inflight is None or not engine.has_work()

    def test_stop_mid_stream_identity(self, weights):
        probe = _port_run(weights, 1, [_greedy("p", [2, 4, 6], 30)])[0]["p"]
        stop = probe[17][0]
        reqs = [_greedy("x", [2, 4, 6], 30, stop_token_ids=(stop,))]
        piped, _, _ = _against_jax(weights, 4, reqs, pipeline_bursts=True)
        assert piped == _against_jax(weights, 4, reqs, pipeline_bursts=False)[0]
        assert piped["x"][-1] == (stop, "stop")

    def test_staggered_admission_breaks_chain_correctly(self, weights):
        """A request arriving mid-pipeline admits promptly; both streams
        equal the JAX engine's with the same arrival step."""
        def arrive(engine, make_request, make_params):
            engine.add_request(make_request("b", [9, 8, 7], make_params(
                temperature=0.0, max_tokens=24)))

        reqs = [_greedy("a", [2, 4, 6], 32)]
        piped, _, _ = _against_jax(weights, 4, reqs, events={5: arrive})
        base = _port_run(weights, 4, reqs, events={5: arrive}, pipeline_bursts=False)[0]
        assert piped == base

    def test_cancel_mid_flight(self, weights):
        def cancel(engine, make_request, make_params):
            engine.cancel("gone")

        reqs = [_greedy("keep", [2, 4, 6], 32), _greedy("gone", [9, 8, 7], 32)]
        streams, _, engine = _against_jax(weights, 4, reqs, events={4: cancel})
        assert engine.cancelled_total == 1 and len(streams["gone"]) < 32
        base = _port_run(weights, 4, reqs[:1], pipeline_bursts=False)[0]
        assert streams["keep"] == base["keep"]
        assert engine.kv_cache_usage() == 0.0

    def test_memory_pressure_skips_pipelining(self, weights):
        tiny = dict(CACHE, n_pages=12)
        reqs = [_greedy(f"m{i}", [3 + i, 5], 24) for i in range(2)]
        piped, _, _ = _against_jax(weights, 4, reqs, cache=tiny, pipeline_bursts=True)
        assert piped == _against_jax(weights, 4, reqs, cache=tiny,
                                     pipeline_bursts=False)[0]

    def test_kv_released_after_pipelined_run(self, weights):
        reqs = [_greedy(f"r{i}", [2 + i, 4], 30) for i in range(3)]
        _, _, engine = _against_jax(weights, 8, reqs, pipeline_bursts=True)
        assert engine.kv_cache_usage() == 0.0


def test_burst_int8_kv_identity(weights):
    int8 = dict(CACHE, kv_dtype="int8")
    reqs = [_greedy("q", [2, 4, 6, 8], 20)]
    streams, _, _ = _against_jax(weights, 8, reqs, cache=int8)
    assert streams == _port_run(weights, 1, reqs, cache=int8)[0]


# -- decode_burst against sequential steps ----------------------------------------

BURST_ROWS = {
    "greedy": [dict(temperature=0.0)] * 3,
    "plain": [dict(temperature=0.9, seed=1), dict(temperature=0.0),
              dict(temperature=1.3, seed=2, presence_penalty=0.5)],
    "topk": [dict(temperature=0.8, top_k=40, seed=3), dict(temperature=0.0),
             dict(temperature=0.7, top_k=5, top_p=0.9, seed=4, min_tokens=9,
                  stop_token_ids=(5, 9))],
    "filtered": [dict(temperature=0.8, top_k=40, seed=5),
                 dict(temperature=0.9, min_p=0.05, seed=6, repetition_penalty=1.3),
                 dict(temperature=1.0, top_p=0.8, seed=7, frequency_penalty=0.4)],
}


@pytest.mark.parametrize("kind", list(BURST_ROWS))
def test_eager_burst_equals_sequential_steps(weights, kind):
    """Three rows mid-decode (slot 3 dead): ``decode_burst`` over 5 steps
    against 5 calls of the fixed-M ``decode_step``, ``apply_penalties``,
    the min-tokens suppression and ``sample`` with the tokens fed back
    on the host, from copies of the same pool and count tables: the same
    tokens, counts and pool bits, and the carry holds the advanced
    controls."""
    engine = _port(weights, 1)
    prompts = ([5, 6, 7, 8, 9], [11, 12], [3, 3, 3, 4, 4, 4, 4])
    for i, (prompt, kw) in enumerate(zip(prompts, BURST_ROWS[kind])):
        engine.add_request(teng.Request(f"r{i}", prompt, tsamp.SamplingParams(
            max_tokens=40, **kw)))
    engine.step()
    engine.step()
    assert tsamp.sample_mode(st.request.params for st in engine.running.values()) == kind
    rows = {s: st for s, st in engine.running.items()}
    engine._ensure_decode_capacity(8)
    ctl_i, ctl_f, tables = engine._decode_controls(rows)
    n = 5
    t = torch.from_numpy

    def state():
        return ({k: v.clone() for k, v in engine.cache.items()},
                engine._token_counts.clone(), engine._output_counts.clone())

    cache_b, tc_b, oc_b = state()
    sampled, carry = tmr.decode_burst(engine.cfg, engine.cache_cfg, engine.params, cache_b,
                                      t(ctl_i), t(ctl_f), tc_b, oc_b, engine._suppress,
                                      t(tables), n_steps=n, sample_mode=kind)
    cache_s, tc_s, oc_s = state()
    toks, pos, gen = t(ctl_i[:, 0]), t(ctl_i[:, 1]), t(ctl_i[:, 4])
    act = t(ctl_i[:, 7]) > 0
    seeds = t(ctl_i[:, 5]).long() & 0xFFFF_FFFF
    f = t(ctl_f)
    for step in range(n):
        logits = tmr.decode_step(engine.cfg, engine.cache_cfg, engine.params, cache_s, toks,
                                 pos, t(tables), act)
        logits = tsamp.apply_penalties(logits, tc_s, oc_s, f[:, 3], f[:, 4], f[:, 5])
        logits = torch.where((gen < t(ctl_i[:, 3]))[:, None] & engine._suppress,
                             float("-inf"), logits)
        tok = tsamp.sample(logits, f[:, 0], t(ctl_i[:, 2]), f[:, 1], f[:, 2], seeds, gen,
                           mode=kind)
        assert torch.equal(sampled[step], tok), step
        for b in np.flatnonzero(ctl_i[:, 7]):
            tc_s[b, tok[b]] += 1
            oc_s[b, tok[b]] += 1
        toks = torch.where(act, tok.int(), toks)
        pos, gen = pos + act.int(), gen + act.int()
    assert torch.equal(tc_b, tc_s) and torch.equal(oc_b, oc_s)
    assert all(torch.equal(cache_b[k], cache_s[k]) for k in cache_b)
    assert torch.equal(carry[:, 0], toks) and torch.equal(carry[:, 1], pos)
    assert torch.equal(carry[:, 4], gen) and torch.equal(carry[:, 5:], t(ctl_i[:, 5:]))
    assert not ctl_i[3, 7] and (sampled[:, 3] >= 0).all()
