"""Sliding-window page reclamation of the PyTorch port against the JAX
package (the cases of ``tests/test_window_reclaim.py``, of
``tests/test_sliding_window.py``'s engine tests and of
``tests/test_decode_burst.py``'s windowed pipelined bursts).

* The allocators: ``trim_window`` frees and placeholds as the JAX
  allocator does (free counts and page tables equal), keeps the position
  mapping through a later extend, and unrefs shared prefix pages.
* The engine: float32 ``mistral-tiny`` (window 24) greedy streams are
  token-identical to the JAX ``NativeEngine``'s on the same weights
  (``convert.params_from_jax``), per token, with speculation and in
  pipelined and unpipelined bursts; pages are trimmed (the engine's
  ``window_pages_trimmed_total`` above 0), peak residency stays window
  bounded in a pool that could not hold the full contexts, no row is
  preempted, and the pool drains.  The JAX engine runs with
  ``fused_sampling=False``, the port's one sampling path.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from fusioninfer_tpu.engine import engine as jeng
from fusioninfer_tpu.engine import kv_cache as jkv
from fusioninfer_tpu.engine import prefix_cache as jpc
from fusioninfer_tpu.engine import sampler as jsamp
from fusioninfer_tpu.models import config as jcfg
from fusioninfer_tpu.models import transformer as jtr
from fusioninfer_tpu_torch.convert import params_from_jax
from fusioninfer_tpu_torch.engine import engine as teng
from fusioninfer_tpu_torch.engine import kv_cache as tkv
from fusioninfer_tpu_torch.engine import prefix_cache as tpc
from fusioninfer_tpu_torch.engine import sampler as tsamp
from fusioninfer_tpu_torch.models import config as tcfg

# window 24, page 16: at most 3 live pages a sequence
TIGHT = dict(n_pages=17, page_size=16, max_pages_per_seq=15)
ROOMY = dict(n_pages=65, page_size=16, max_pages_per_seq=16)
SMALL = dict(n_pages=33, page_size=16, max_pages_per_seq=8)
BURST_CACHE = dict(n_pages=64, page_size=8, max_pages_per_seq=8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several test files per core: keep torch's intra-op
    pool to one thread for these small shapes, and restore it after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mistral():
    cj = dataclasses.replace(jcfg.get_preset("mistral-tiny"), dtype="float32")
    ct = dataclasses.replace(tcfg.get_preset("mistral-tiny"), dtype="float32")
    pj = jtr.init_params(cj, jax.random.key(0))
    pt = params_from_jax(jax.tree.map(np.asarray, pj), ct, "cpu")
    return cj, ct, pj, pt


def _engines(weights, cache: dict, max_batch_size: int = 2, **kw):
    cj, ct, pj, pt = weights
    je = jeng.NativeEngine(cj, jkv.CacheConfig(**cache), params=pj,
                           max_batch_size=max_batch_size, fused_sampling=False, **kw)
    te = teng.NativeEngine(ct, tkv.CacheConfig(**cache), params=pt, device="cpu",
                           max_batch_size=max_batch_size, **kw)
    return je, te


def _drive(engine, make_request, make_params, requests, max_steps=400):
    """Add ``[(id, prompt, max_tokens)]`` as greedy requests and step until
    drained → ``({id: tokens}, {id: finish}, peak used pages)``."""
    for rid, prompt, n in requests:
        engine.add_request(make_request(rid, list(prompt),
                                        make_params(temperature=0.0, max_tokens=n)))
    streams, finish, peak = {}, {}, 0
    for _ in range(max_steps):
        if not engine.has_work():
            break
        for o in engine.step():
            assert not (o.finish_reason or "").startswith("error"), o
            streams.setdefault(o.request_id, []).append(o.token)
            if o.finished:
                finish[o.request_id] = o.finish_reason
        peak = max(peak, engine.alloc.used_pages)
    assert not engine.has_work(), "engine did not drain"
    return streams, finish, peak


def _both(weights, cache: dict, requests, max_batch_size: int = 2, **kw):
    """The same greedy requests through a JAX and a port engine built alike
    → (JAX run, port run, port engine)."""
    je, te = _engines(weights, cache, max_batch_size, **kw)
    ref = _drive(je, jeng.Request, jsamp.SamplingParams, requests)
    ours = _drive(te, teng.Request, tsamp.SamplingParams, requests)
    return ref, ours, te


# -- the allocators -------------------------------------------------------------


@pytest.mark.parametrize("alloc_kind", ["base", "prefix"])
def test_trim_frees_and_placeholds(alloc_kind):
    """JAX ``test_base_trim_frees_and_placeholds``, on both allocators of
    each package: the same frees, tables and drained pool."""
    kinds = {"base": (jkv.PageAllocator, tkv.PageAllocator),
             "prefix": (jpc.PrefixCachingAllocator, tpc.PrefixCachingAllocator)}
    cc = dict(n_pages=17, page_size=16, max_pages_per_seq=8)
    seen = []
    for mk, cache_cls in zip(kinds[alloc_kind], (jkv.CacheConfig, tkv.CacheConfig)):
        alloc = mk(cache_cls(**cc))
        alloc.allocate("s", 80)  # 5 pages
        free0 = alloc.free_pages
        before = alloc.page_table_row("s")
        assert alloc.trim_window("s", 2) == 2
        assert alloc.free_pages == free0 + 2
        row = alloc.page_table_row("s")
        assert row[0] == row[1] == cc["n_pages"] - 1
        np.testing.assert_array_equal(row[2:5], before[2:5])
        assert alloc.trim_window("s", 2) == 0  # the watermark: idempotent
        alloc.release("s")
        assert alloc.free_pages == cc["n_pages"] - 1
        seen.append((free0, before.tolist(), row.tolist()))
    assert seen[0] == seen[1]


def test_trim_then_extend_keeps_position_mapping():
    """JAX ``test_trim_then_extend_keeps_position_mapping``."""
    rows = []
    for alloc in (jkv.PageAllocator(jkv.CacheConfig(n_pages=17, page_size=16,
                                                    max_pages_per_seq=8)),
                  tkv.PageAllocator(tkv.CacheConfig(n_pages=17, page_size=16,
                                                    max_pages_per_seq=8))):
        alloc.allocate("s", 40)  # 3 pages
        alloc.trim_window("s", 1)
        new = alloc.extend("s", 40, 20)  # 60 tokens: 4 pages
        assert len(new) == 1
        row = alloc.page_table_row("s")
        assert row[0] == 16 and row[3] == new[0]  # position 48.. at index 3
        rows.append(row.tolist())
    assert rows[0] == rows[1]


def test_prefix_alloc_shared_pages_unref_not_freed():
    """JAX ``test_prefix_alloc_shared_pages_unref_not_freed``: a trimmed
    shared page loses one reference and stays the other owner's."""
    prompt = list(range(1, 34))  # 33 tokens: 2 full pages and a tail
    states = []
    for mk, cc in ((jpc.PrefixCachingAllocator, jkv.CacheConfig),
                   (tpc.PrefixCachingAllocator, tkv.CacheConfig)):
        alloc = mk(cc(n_pages=17, page_size=16, max_pages_per_seq=8))
        alloc.allocate("a", 34)
        alloc.register_blocks("a", prompt)
        assert alloc.match_prefix("b", prompt + [7, 8, 9]) == 32
        alloc.allocate("b", 40)
        shared = alloc.pages_of("b")[:2]
        alloc.trim_window("b", 2)
        assert all(p in alloc._refs for p in shared)
        assert alloc.pages_of("b")[0] == 16
        assert alloc.pages_of("a")[:2] == shared
        states.append((alloc.pages_of("a"), alloc.pages_of("b"), dict(alloc._refs),
                       alloc.free_pages))
        alloc.release("a")
        alloc.release("b")
        assert alloc.free_pages == 16
    assert states[0] == states[1]


# -- the engine -----------------------------------------------------------------


def test_long_generations_fit_tight_cache(mistral):
    """JAX ``test_long_generations_fit_tight_cache``: two sequences of 230
    tokens each in 16 usable pages of 16, impossible untrimmed; the port's
    streams equal the JAX engine's, no preemption, the peak stays within
    8 used pages and the pool drains."""
    rng = np.random.default_rng(0)
    requests = [(f"r{i}", rng.integers(1, 4096, 30).tolist(), 200) for i in range(2)]
    ref, ours, te = _both(mistral, TIGHT, requests)
    assert ours[0] == ref[0]
    assert ours[1] == ref[1] == {"r0": "length", "r1": "length"}
    assert {k: len(v) for k, v in ours[0].items()} == {"r0": 200, "r1": 200}
    assert te.preemptions_total == 0
    assert ours[2] <= 8, ours[2]
    assert te.window_pages_trimmed_total > 0
    assert te.alloc.free_pages == TIGHT["n_pages"] - 1


def test_trim_never_changes_tokens(mistral):
    """JAX ``test_trim_never_changes_tokens``: a tight pool that trims
    under pressure and a roomy one give the JAX engine's tokens."""
    prompt = np.random.default_rng(1).integers(1, 4096, 40).tolist()
    ref, tight, te = _both(mistral, TIGHT, [("r", prompt, 60)])
    _, _, _, pt = mistral
    roomy = teng.NativeEngine(mistral[1], tkv.CacheConfig(**ROOMY), params=pt,
                              device="cpu", max_batch_size=2)
    wide = _drive(roomy, teng.Request, tsamp.SamplingParams, [("r", prompt, 60)])
    assert tight[0] == wide[0] == ref[0]
    assert te.window_pages_trimmed_total > 0 and roomy.window_pages_trimmed_total > 0


def test_full_attention_model_never_trims():
    """JAX ``test_full_attention_model_never_trims``: qwen3-tiny keeps
    every page until release."""
    qwen = dataclasses.replace(tcfg.get_preset("qwen3-tiny"), dtype="float32")
    cache = tkv.CacheConfig(n_pages=33, page_size=16, max_pages_per_seq=8)
    engine = teng.NativeEngine(qwen, cache, device="cpu", max_batch_size=2)
    streams, _, _ = _drive(engine, teng.Request, tsamp.SamplingParams,
                           [("r", [1, 2, 3, 4], 40)])
    assert len(streams["r"]) == 40
    assert engine.window_pages_trimmed_total == 0
    assert engine.alloc.free_pages == cache.n_pages - 1


def test_serves_end_to_end_with_long_context(mistral):
    """JAX ``test_serves_end_to_end_with_long_context``: a 50-token prompt
    generates past the window boundary, as the JAX engine does."""
    prompt = np.random.default_rng(3).integers(1, 4096, 50).tolist()
    ref, ours, te = _both(mistral, SMALL, [("r", prompt, 12)])
    assert len(ours[0]["r"]) == 12
    assert ours[0] == ref[0]
    assert te.window_pages_trimmed_total > 0


def test_spec_decode_composes_with_window(mistral):
    """JAX ``test_spec_decode_composes_with_window``: speculative windows on
    a windowed model give the tokens of the engine without speculation,
    and both give the JAX engine's."""
    requests = [("r", [5, 6, 7] * 12, 10)]
    ref, base, _ = _both(mistral, SMALL, requests)
    ref_spec, spec, te = _both(mistral, SMALL, requests, speculative_k=4)
    assert spec[0] == base[0] == ref[0] == ref_spec[0]
    assert te.spec_proposed_total > 0


def test_sliding_window_pipelined_identity(mistral):
    """JAX ``test_sliding_window_pipelined_identity``: pipelined bursts of 4
    (the successor trims before it is priced) equal unpipelined bursts and
    the JAX burst engine's streams, and the pool drains; with 48 tokens
    after a 3-token prompt the rows cross the window."""
    requests = [("w", [2, 4, 6], 48)]
    runs = {}
    for piped in (False, True):
        ref, ours, te = _both(mistral, BURST_CACHE, requests, max_batch_size=4,
                              decode_burst_steps=4, pipeline_bursts=piped)
        assert ours[0] == ref[0] and ours[1] == ref[1]
        assert te.window_pages_trimmed_total > 0
        assert te.kv_cache_usage() == 0.0
        runs[piped] = (ours[0], te.sched.dispatch_ahead_total)
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] > 0 and runs[False][1] == 0


def test_pipelined_bursts_fit_tight_cache(mistral):
    """Two windowed rows bursting 8 steps a dispatch, pipelined, in the
    tight pool: the successor burst trims before it is priced, so the
    chain keeps dispatching ahead as the JAX engine's does (the same
    streams and scheduler ledger), with no preemption and a window-bounded
    peak."""
    rng = np.random.default_rng(2)
    requests = [(f"b{i}", rng.integers(1, 4096, 30).tolist(), 120) for i in range(2)]
    je, te = _engines(mistral, TIGHT, decode_burst_steps=8)
    ref = _drive(je, jeng.Request, jsamp.SamplingParams, requests)
    ours = _drive(te, teng.Request, tsamp.SamplingParams, requests)
    assert ours[0] == ref[0] and ours[1] == ref[1]
    assert te.sched.snapshot() == je.sched.snapshot()
    assert te.sched.dispatch_ahead_total > 0 and te.preemptions_total == 0
    assert ours[2] <= 8, ours[2]
