"""Prefix caching of the PyTorch port against the JAX package.

The port keeps its own copies of the block hash chain
(``utils/blockhash.py``), the allocator hooks (``engine/kv_cache.py``)
and ``PrefixCachingAllocator`` (``engine/prefix_cache.py``).  Here the
hashes must be byte-equal to the JAX ones (the router computes the same
chain), one scripted sequence of allocator calls must give the same page
ids, free counts, admission answers and hit rate in both allocators, the
pool sizing must agree, and the port's engine must serve greedy streams
token-identical to the JAX ``NativeEngine`` with prefix caching on: hits
from a shared prefix and a duplicate prompt in one admission round
(``test_torch_chunked_prefill.py`` adds the token budget and preemption
that parks a victim's pages).  Exact equality throughout.
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
from fusioninfer_tpu.utils import blockhash as jbh
from fusioninfer_tpu_torch.convert import params_from_jax
from fusioninfer_tpu_torch.engine import engine as teng
from fusioninfer_tpu_torch.engine import kv_cache as tkv
from fusioninfer_tpu_torch.engine import prefix_cache as tpc
from fusioninfer_tpu_torch.engine import sampler as tsamp
from fusioninfer_tpu_torch.models import config as tcfg
from fusioninfer_tpu_torch.utils import blockhash as tbh

MAX_TOKENS = 10


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


# -- block hashes ------------------------------------------------------------


@pytest.mark.parametrize("namespace", [b"", b"lora:a1"])
@pytest.mark.parametrize("n,ps", [(0, 16), (15, 16), (16, 16), (100, 16), (300, 128),
                                  (1024, 128)])
def test_block_hashes_byte_equal_to_jax(n, ps, namespace):
    toks = [int(t) for t in np.random.default_rng(n).integers(0, 151_936, n)]
    ours = tbh.block_hashes(toks, ps, namespace)
    assert ours == jbh.block_hashes(toks, ps, namespace)
    assert len(ours) == n // ps
    assert all(isinstance(h, bytes) and len(h) == 16 for h in ours)


def test_token_block_bytes_equal_to_jax():
    block = [0, 1, -1, 2**40, 151_935, -(2**63)]
    assert tbh.token_block_bytes(block) == jbh.token_block_bytes(block)
    assert tbh.token_block_bytes(iter(block)) == jbh.token_block_bytes(iter(block))
    assert tbh.token_block_bytes(np.asarray(block, np.int64)) == jbh.token_block_bytes(block)


def test_namespace_and_prefix_change_the_chain():
    a = list(range(64))
    b = [99] + a[1:]
    assert tbh.block_hashes(a, 16)[0] != tbh.block_hashes(a, 16, b"lora:x")[0]
    # a block's identity includes its whole prefix: every later block differs
    ha, hb = tbh.block_hashes(a, 16), tbh.block_hashes(b, 16)
    assert all(x != y for x, y in zip(ha, hb))


# -- allocators ----------------------------------------------------------------


def _script(alloc_cls, cfg_cls):
    """One script of allocator calls: shared prefixes, a hit after
    release, a partially cached prompt, eviction of LRU cached pages under
    a tight pool, admission answers and hit-rate bookkeeping.  Returns
    everything observable, in order."""
    cc = cfg_cls(n_pages=11, page_size=4, max_pages_per_seq=8)  # 10 usable
    a = alloc_cls(cc)
    log = []

    def snap(tag):
        log.append((tag, a.free_pages, a.used_pages, round(a.utilization(), 6)))

    p1 = list(range(10, 23))  # 13 tokens: 3 full pages, 3 usable
    p2 = p1[:8] + [7, 7, 7, 7, 7]  # shares 2 pages with p1
    p3 = list(range(50, 69))  # needs every free and cached page
    log.append(("admit p1", a.can_admit(p1, 1)))
    log.append(("match p1", a.match_prefix("s1", p1)))
    log.append(("alloc s1", a.allocate("s1", len(p1) + 1)))
    a.register_blocks("s1", p1)
    snap("after s1")
    log.append(("peek p2", a._peek_match(p2)))
    log.append(("match p2", a.match_prefix("s2", p2)))
    log.append(("alloc s2", a.allocate("s2", len(p2) + 1)))
    log.append(("pages s2", a.pages_of("s2")))
    a.register_blocks("s2", p2)
    log.append(("extend s2", a.extend("s2", len(p2), 4)))
    a.release("s1")
    snap("s1 released: its private pages stay cached")
    log.append(("has p1 block 2", a.has_block(tbh.block_hashes(p1, 4)[2])))
    log.append(("admit p3", a.can_admit(p3, 1)))
    log.append(("match p3", a.match_prefix("s3", p3)))
    log.append(("alloc s3", a.allocate("s3", len(p3) + 1)))
    a.register_blocks("s3", p3)
    snap("after s3: evicted the LRU cached page")
    log.append(("has p1 block 2 now", a.has_block(tbh.block_hashes(p1, 4)[2])))
    a.release("s2")
    a.release("s3")
    snap("all released")
    log.append(("rematch p1", a.match_prefix("s4", p1 + [1, 2, 3])))
    log.append(("alloc s4", a.allocate("s4", len(p1) + 4)))
    log.append(("admit huge", a.can_admit(list(range(40)), 1)))
    with pytest.raises(MemoryError):
        a.allocate("s5", 40)
    log.append(("hit rate", a.prefix_hit_rate()))
    log.append(("tokens", a.hit_tokens_total, a.query_tokens_total))
    a.release("s4")
    snap("end")
    return log


def test_prefix_allocator_script_matches_jax():
    ours = _script(tpc.PrefixCachingAllocator, tkv.CacheConfig)
    ref = _script(jpc.PrefixCachingAllocator, jkv.CacheConfig)
    assert ours == ref
    entry = {e[0]: e[1:] for e in ref}
    assert entry["hit rate"][0] > 0
    assert entry["has p1 block 2"] == (True,) and entry["has p1 block 2 now"] == (False,)


def test_base_allocator_hooks_match_jax():
    def script(alloc_cls, cfg_cls):
        a = alloc_cls(cfg_cls(n_pages=9, page_size=4, max_pages_per_seq=4))
        out = [a.used_pages, a.utilization(), a.can_admit(list(range(9)), 1)]
        out.append(a.allocate("x", 10))
        out += [a.used_pages, a.utilization(), a.can_admit(list(range(20)), 1),
                a.can_admit(list(range(13)), 1), a.can_admit(list(range(5)), 3)]
        a.release("x")
        out += [a.used_pages, a.free_pages, a.allocate("y", 3)]
        return out

    assert script(tkv.PageAllocator, tkv.CacheConfig) == script(jkv.PageAllocator,
                                                                 jkv.CacheConfig)


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("prefix_caching", [True, False])
@pytest.mark.parametrize("max_len", [2048, 4096])
def test_pool_sizing_matches_jax(monkeypatch, kv_dtype, prefix_caching, max_len):
    """qwen3-8b on an 80 GiB card: the port sizes its pool from
    ``torch.cuda.mem_get_info`` (faked here) as the JAX package does from
    the device's byte limit; with prefix caching it grows into free
    memory up to 4× demand.  Off the card the pool stays demand-sized."""
    total = 80 * 2**30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (total, total))
    ours = tkv.auto_cache_config(tcfg.get_preset("qwen3-8b"), 128, max_len, 8, "cuda",
                                 kv_dtype, prefix_caching=prefix_caching)
    ref = jkv.auto_cache_config(jcfg.get_preset("qwen3-8b"), 128, max_len, 8,
                                hbm_bytes=total, prefix_caching=prefix_caching,
                                kv_dtype=kv_dtype)
    assert ours == tkv.CacheConfig(**dataclasses.asdict(ref))
    demand = 8 * max_len // 128 + 1
    assert ours.n_pages == (4 * demand if prefix_caching else demand)
    cpu = tkv.auto_cache_config(tcfg.get_preset("qwen3-8b"), 128, max_len, 8, "cpu",
                                kv_dtype, prefix_caching=prefix_caching)
    assert cpu.n_pages == demand


# -- engine ------------------------------------------------------------------


def _run_staged(engine, make_request, make_params, waves, max_steps=400):
    """Add each wave of prompts ``(step, [(id, prompt)])`` at its step and
    step until the engine drains; returns the streams."""
    streams: dict[str, list[int]] = {}
    for step in range(max_steps):
        for at, wave in waves:
            if at == step:
                for rid, p in wave:
                    engine.add_request(make_request(rid, p, make_params()))
        if step > max(at for at, _ in waves) and not engine.has_work():
            break
        for out in engine.step():
            assert not (out.finish_reason or "").startswith("error"), out
            streams.setdefault(out.request_id, []).append(out.token)
    assert not engine.has_work(), "engine did not drain"
    return streams


def _shared_waves(vocab):
    """A warm request, then three sharing its 2-page prefix (one of them
    its exact duplicate, twice, in one admission round), then an
    extension of the first prompt."""
    rng = np.random.default_rng(7)
    shared = [int(t) for t in rng.integers(3, vocab, 32)]
    tails = [[int(t) for t in rng.integers(3, vocab, n)] for n in (3, 11, 20)]
    first = shared + tails[0]
    return [(0, [("warm", first)]),
            (3, [("a", shared + tails[1]), ("dup1", first), ("dup2", first),
                 ("b", shared + tails[2])]),
            (6, [("ext", first + tails[1])])]


def _engines(weights, kv_dtype, kv_splits, n_pages=40, mp=10, **kw):
    cj, ct, pj, pt = weights
    cc = dict(n_pages=n_pages, page_size=16, max_pages_per_seq=mp, kv_dtype=kv_dtype)
    je = jeng.NativeEngine(cj, jkv.CacheConfig(**cc), params=pj, kv_splits=kv_splits,
                           fused_sampling=False, **kw)
    te = teng.NativeEngine(ct, tkv.CacheConfig(**cc), params=pt, device="cpu",
                           kv_splits=kv_splits, **kw)
    return je, te


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("kv_splits", [0, 8])
def test_greedy_streams_with_prefix_hits_identical_to_jax(weights, kv_dtype, kv_splits):
    """Prefix caching on (both engines' default), monolithic prefill:
    hits compute only their suffixes through the ragged forward, the
    duplicates defer a round and hit the first's pages; streams, hit
    rates and the prefill ledger equal the JAX engine's."""
    je, te = _engines(weights, kv_dtype, kv_splits)
    assert te.prefix_caching and isinstance(te.alloc, tpc.PrefixCachingAllocator)
    waves = _shared_waves(weights[0].vocab_size)
    params = dict(temperature=0.0, max_tokens=MAX_TOKENS)
    ref = _run_staged(je, jeng.Request, lambda: jsamp.SamplingParams(**params), waves)
    ours = _run_staged(te, teng.Request, lambda: tsamp.SamplingParams(**params), waves)
    assert ours == ref
    assert all(len(s) == MAX_TOKENS for s in ours.values())
    assert te.prefix_cache_hit_rate() == je.prefix_cache_hit_rate() > 0
    assert te.alloc.hit_tokens_total == je.alloc.hit_tokens_total
    # hits computed only their suffixes: every prompt token was either
    # reused from the cache or prefilled, once
    assert te.sched.prefill_tokens_total == je.sched.prefill_tokens_total
    assert (te.sched.prefill_tokens_total
            == te.alloc.query_tokens_total - te.alloc.hit_tokens_total)
    assert te.sched.weight_passes_total == je.sched.weight_passes_total


def test_cached_prompt_admits_under_pressure(weights):
    """Reuse-aware admission: with the pool full of another request's
    cached pages, the same prompt again needs one fresh page and admits,
    on both engines alike."""
    cj, ct, pj, pt = weights
    prompt = [int(t) for t in np.random.default_rng(3).integers(3, cj.vocab_size, 70)]
    waves = [(0, [("first", prompt)]), (8, [("again", prompt)])]
    params = dict(temperature=0.0, max_tokens=4)
    je, te = _engines(weights, "model", 0, n_pages=7, mp=6)
    ref = _run_staged(je, jeng.Request, lambda: jsamp.SamplingParams(**params), waves)
    ours = _run_staged(te, teng.Request, lambda: tsamp.SamplingParams(**params), waves)
    assert ours == ref and ours["again"] == ours["first"]
    assert te.alloc.hit_tokens_total == je.alloc.hit_tokens_total == 64
