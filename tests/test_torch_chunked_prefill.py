"""Token-budgeted chunked prefill of the PyTorch port against the JAX package.

The port's ``engine/sched.py`` is its own copy of the JAX token ledger:
``derive_token_budget`` and every ``TokenBudget`` counter must come out
equal.  Its engine must serve greedy streams token-identical to the JAX
``NativeEngine`` with prefix caching on and a token budget, with the
fused step on and off, on the single walk (``kv_splits=0``) and the
split walk (``kv_splits=8``), on model-dtype and int8 pages: prompts
that share a prefix, a duplicate in one admission round, a long prompt
chunked while others decode, and tight pools that preempt running and
mid-prefill sequences (whose parked pages the resume re-acquires).
Float32 ``qwen3-tiny``; the prefix hit rates and the ledgers must be
equal too.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from fusioninfer_tpu.engine import engine as jeng
from fusioninfer_tpu.engine import kv_cache as jkv
from fusioninfer_tpu.engine import sampler as jsamp
from fusioninfer_tpu.engine import sched as jsched
from fusioninfer_tpu.models import config as jcfg
from fusioninfer_tpu.models import transformer as jtr
from fusioninfer_tpu_torch import cli
from fusioninfer_tpu_torch.convert import params_from_jax
from fusioninfer_tpu_torch.engine import engine as teng
from fusioninfer_tpu_torch.engine import kv_cache as tkv
from fusioninfer_tpu_torch.engine import sampler as tsamp
from fusioninfer_tpu_torch.engine import sched as tsched
from fusioninfer_tpu_torch.engine.server import engine_from_args
from fusioninfer_tpu_torch.models import config as tcfg


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


# -- the ledger ----------------------------------------------------------------


@pytest.mark.parametrize("per_token_s", [0.0, -1.0, 1e-7, 1e-6, 2.5e-5, 1e-4, 1e-3, 1.0])
@pytest.mark.parametrize("target,floor,cap", [(0.05, 32, 4096), (0.02, 8, 512)])
def test_derive_token_budget_matches_jax(per_token_s, target, floor, cap):
    ours = tsched.derive_token_budget(per_token_s, target, floor, cap)
    assert ours == jsched.derive_token_budget(per_token_s, target, floor, cap)
    assert floor <= ours <= cap


@pytest.mark.parametrize("tokens_per_step", [None, 64])
def test_token_budget_counters_match_jax(tokens_per_step):
    def script(budget):
        out = [budget.begin_step(5), budget.begin_step(100)]
        budget.charge_decode(5)
        budget.charge_prefill(59, chunks=2)
        budget.charge_prefill(3)
        budget.charge_weight_pass()
        budget.charge_weight_pass(2)
        for n in (1, 8, 9, 600, 5000, 4096):
            budget.record_fused(n)
        budget.admission_deferred_total += 1
        budget.preempt_parks_total += 2
        out += [budget.utilization(), budget.weight_passes_per_step(),
                budget.fused_packed_tokens, budget.snapshot()]
        return out

    ours = script(tsched.TokenBudget(tokens_per_step))
    ref = script(jsched.TokenBudget(tokens_per_step))
    assert ours == ref
    assert dataclasses.asdict(tsched.TokenBudget()) == dataclasses.asdict(
        jsched.TokenBudget())


# -- engine streams ----------------------------------------------------------------


def _drive(engine, make_request, make_params, waves, cancel=None, max_steps=500):
    """Add each wave ``(step, [(id, prompt, max_tokens)])`` at its step,
    cancel ``cancel = (step, id)`` at its step, and step until the engine
    drains → (streams of (token, finish_reason), steps taken)."""
    streams: dict[str, list] = {}
    last = max(at for at, _ in waves)
    for step in range(max_steps):
        for at, wave in waves:
            if at == step:
                for rid, p, n in wave:
                    engine.add_request(make_request(rid, p, make_params(n)))
        if cancel is not None and cancel[0] == step:
            engine.cancel(cancel[1])
        if step > last and not engine.has_work():
            return streams, step
        for out in engine.step():
            streams.setdefault(out.request_id, []).append(
                (out.token, out.finish_reason))
    raise AssertionError("engine did not drain")


def _pair(weights, waves, *, n_pages, mp, kv_dtype="model", cancel=None, **kw):
    """Run ``waves`` on the JAX engine and on the port's, both configured
    by ``kw`` → (jax engine, port engine, jax streams, port streams)."""
    cj, ct, pj, pt = weights
    cc = dict(n_pages=n_pages, page_size=16, max_pages_per_seq=mp, kv_dtype=kv_dtype)
    je = jeng.NativeEngine(cj, jkv.CacheConfig(**cc), params=pj, fused_sampling=False,
                           **kw)
    te = teng.NativeEngine(ct, tkv.CacheConfig(**cc), params=pt, device="cpu", **kw)
    ref, _ = _drive(je, jeng.Request,
                    lambda n: jsamp.SamplingParams(temperature=0.0, max_tokens=n),
                    waves, cancel)
    ours, _ = _drive(te, teng.Request,
                     lambda n: tsamp.SamplingParams(temperature=0.0, max_tokens=n),
                     waves, cancel)
    return je, te, ref, ours


def _mixed_waves(vocab):
    """A warm prompt; then three prompts sharing its two full pages (one
    its duplicate, twice in one round); then a 100-token prompt that
    chunks while they decode."""
    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(3, vocab, 40)]
    first = shared + [int(t) for t in rng.integers(3, vocab, 5)]
    return [(0, [("warm", first, 10)]),
            (4, [("a", shared + [int(t) for t in rng.integers(3, vocab, 9)], 10),
                 ("dup1", first, 10), ("dup2", first, 10),
                 ("b", shared + [int(t) for t in rng.integers(3, vocab, 30)], 10)]),
            (7, [("long", [int(t) for t in rng.integers(3, vocab, 100)], 10)])]


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("kv_splits", [0, 8])
@pytest.mark.parametrize("fused", [False, True])
def test_greedy_streams_identical_to_jax(weights, fused, kv_splits, kv_dtype):
    je, te, ref, ours = _pair(weights, _mixed_waves(weights[0].vocab_size), n_pages=40,
                              mp=10, kv_dtype=kv_dtype, token_budget=24,
                              fused_step=fused, kv_splits=kv_splits)
    assert ours == ref
    assert all(len(s) == 10 and s[-1][1] == "length" for s in ours.values())
    assert te.prefix_cache_hit_rate() == je.prefix_cache_hit_rate() > 0
    assert _ledger(te) == _ledger(je)
    assert te.sched.chunks_total > 0
    assert (te.sched.fused_steps_total > 0) == fused
    # the suffix of every hit and every chunk was computed once, nothing else
    assert (te.sched.prefill_tokens_total
            == te.alloc.query_tokens_total - te.alloc.hit_tokens_total)


@pytest.mark.parametrize("kv_splits", [0, 8])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", ["running victim", "mid-prefill victim"])
def test_tight_pool_preemption_identical_to_jax(weights, case, fused, kv_splits):
    """The tight pool of ``test_torch_engine.py``'s stream test (6 usable
    pages of 16 tokens), now with prefix caching and a budget: a running
    sequence is preempted and its pages parked.  Then 7 usable pages
    filled by a decoding 30-token prompt and a 70-token one mid-prefill:
    the older row's next page preempts the prefilling one, whose written
    chunks are parked and re-acquired by its resume."""
    cj = weights[0]
    if case == "running victim":
        lens, n_pages, budget, n_tok = (5, 17, 40, 60), 7, 16, 20
    else:
        lens, n_pages, budget, n_tok = (30, 70), 8, 8, 20
    prompts = [[int(t) for t in np.random.default_rng(i).integers(3, cj.vocab_size, n)]
               for i, n in enumerate(lens)]
    waves = [(0, [(f"r{i}", p, n_tok) for i, p in enumerate(prompts)])]
    je, te, ref, ours = _pair(weights, waves, n_pages=n_pages, mp=6, token_budget=budget,
                              fused_step=fused, kv_splits=kv_splits)
    assert ours == ref
    assert all(len(s) == n_tok for s in ours.values())
    assert te.preemptions_total == je.preemptions_total > 0
    assert _ledger(te) == _ledger(je)
    assert te.prefix_cache_hit_rate() == je.prefix_cache_hit_rate()
    if case == "mid-prefill victim":
        assert te.sched.preempt_parks_total > 0
        assert te.sched.preempt_resume_reused_tokens_total > 0


@pytest.mark.parametrize("fused", [False, True])
def test_cancel_mid_chunk_releases_pages(weights, fused):
    """A long prompt cancelled between its chunks: its pages go back, the
    other stream is untouched, both engines alike."""
    cj = weights[0]
    rng = np.random.default_rng(4)
    waves = [(0, [("stream", [int(t) for t in rng.integers(3, cj.vocab_size, 9)], 16),
                  ("long", [int(t) for t in rng.integers(3, cj.vocab_size, 90)], 4)])]
    je, te, ref, ours = _pair(weights, waves, n_pages=24, mp=8, token_budget=16,
                              fused_step=fused, cancel=(3, "long"))
    assert ours == ref and "long" not in ours and len(ours["stream"]) == 16
    assert te.cancelled_total == je.cancelled_total == 1
    assert te.alloc.free_pages == je.alloc.free_pages == 23
    assert not te.prefilling


def test_short_prompts_bypass_chunking(weights):
    """A prompt within the budget prefills in one flash forward."""
    _, ct, _, pt = weights
    te = teng.NativeEngine(ct, tkv.CacheConfig(n_pages=24, page_size=16,
                                               max_pages_per_seq=8),
                           params=pt, device="cpu", token_budget=32)
    te.add_request(teng.Request("s", list(range(3, 23)),
                                tsamp.SamplingParams(temperature=0.0, max_tokens=2)))
    outs = te.step()
    assert [o.is_first_token for o in outs] == [True, False]
    assert te.sched.chunks_total == 0 and te.num_prefilling == 0


def test_budget_validation_and_calibration(weights):
    """``set_token_budget`` turns chunking on; ``calibrate_token_budget``
    times a forward, installs a budget within [floor, cap] and releases
    its probe pages."""
    _, ct, _, pt = weights
    te = teng.NativeEngine(ct, tkv.CacheConfig(n_pages=24, page_size=16,
                                               max_pages_per_seq=8),
                           params=pt, device="cpu")
    assert te.token_budget is None and te.prefill_chunk is None
    with pytest.raises(ValueError):
        te.set_token_budget(0)
    with pytest.raises(ValueError):
        teng.NativeEngine(ct, params=pt, device="cpu", token_budget=0)
    free = te.alloc.free_pages
    budget = te.calibrate_token_budget(floor=16, cap=2048)
    assert 16 <= budget <= 2048
    assert te.token_budget == te.prefill_chunk == budget
    assert te.alloc.free_pages == free
    te.set_token_budget(48)
    assert te.token_budget == 48 and te.prefill_chunk == budget
    seeded = teng.NativeEngine(ct, params=pt, device="cpu", prefill_chunk_size=40)
    assert seeded.token_budget == seeded.prefill_chunk == 40


@pytest.mark.parametrize("argv,expect", [
    ([], dict(prefix_caching=True, fused=True, budget="calibrated")),
    (["--tokens-per-step", "64"], dict(prefix_caching=True, fused=True, budget=64)),
    (["--no-token-budget"], dict(prefix_caching=True, fused=True, budget=None)),
    (["--no-token-budget", "--prefill-chunk-size", "48"],
     dict(prefix_caching=True, fused=True, budget=48)),
    (["--no-prefix-caching", "--no-fused-step", "--tokens-per-step", "32"],
     dict(prefix_caching=False, fused=False, budget=32)),
])
def test_serve_flags(argv, expect):
    """``engine serve``'s scheduling flags, with the JAX server's meanings."""
    args = cli.build_parser().parse_args(
        ["engine", "serve", "qwen3-tiny", "--device", "cpu", "--max-model-len", "256"]
        + argv)
    engine = engine_from_args(args)
    assert engine.prefix_caching == expect["prefix_caching"]
    assert engine.fused_step_enabled == expect["fused"]
    if expect["budget"] == "calibrated":
        assert 32 <= engine.token_budget <= 4096
    else:
        assert engine.token_budget == expect["budget"]
