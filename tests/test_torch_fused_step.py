"""The port's one ragged forward against the JAX package.

* ``engine/fused.py``: ``pack_ragged_batch`` lays out the same arrays as
  the JAX packing for decode-only, chunks-only and mixed batches, dead
  slots and padding.
* ``model_runner.fused_step``: one mixed batch (decode rows, a cache-hit
  suffix from mid-sequence, a chunk) gives the JAX ``fused_step``'s
  logits, chunk logits and pool contents, on model-dtype and int8 pages,
  through the single and the split walk.
* The engine: the fused step changes no stream, halves the weight
  passes of mixed steps, and every forward that reads pages goes through
  ``fused_step`` (the three standalone paged primitives are never
  called); with the launch faked, the engine hands the single walk one
  fixed cluster size whatever the launch's token count.
"""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusioninfer_tpu.engine import fused as jfused
from fusioninfer_tpu.engine import kv_cache as jkv
from fusioninfer_tpu.engine import model_runner as jmr
from fusioninfer_tpu.models import config as jcfg
from fusioninfer_tpu.models import transformer as jtr
from fusioninfer_tpu_torch.convert import params_from_jax
from fusioninfer_tpu_torch.engine import engine as teng
from fusioninfer_tpu_torch.engine import fused as tfused
from fusioninfer_tpu_torch.engine import kv_cache as tkv
from fusioninfer_tpu_torch.engine import model_runner as tmr
from fusioninfer_tpu_torch.engine import sampler as tsamp
from fusioninfer_tpu_torch.models import config as tcfg
from fusioninfer_tpu_torch.models import transformer as ttr
from fusioninfer_tpu_torch.ops import _build, dispatch
from fusioninfer_tpu_torch.ops import gemm as tgemm
from fusioninfer_tpu_torch.ops import paged_attention as tpa
from fusioninfer_tpu_torch.ops import rms_norm as trn

# f32 end to end; two layers of f32 matmuls summed in different orders
# (the tolerances of tests/test_torch_model.py)
LOGITS_ATOL = 1e-4
KV_ATOL = 1e-5
# int8 pages: a fresh K/V element whose f32 value differs in its last
# bits between the frameworks may round to the neighbouring code, one
# quantization step (max|row| / 127) away; at these widths one such step
# moves the logits by up to ~1e-3
LOGITS_ATOL_INT8 = 2e-3
TRASH = 23


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


# -- packing -------------------------------------------------------------------


def _decode_group(B, live, mp=4, W=1, seed=0):
    rng = np.random.default_rng(seed)
    window = rng.integers(1, 100, (B, W)).astype(np.int32)
    counts = np.zeros((B,), np.int32)
    counts[list(live)] = W
    positions = rng.integers(0, 60, (B,)).astype(np.int32)
    tables = rng.integers(0, TRASH, (B, mp)).astype(np.int32)
    return window, counts, positions, tables, np.zeros((B,), np.int32)


def _chunks(lens, mp=4, seed=1):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(1, 100, n)], int(rng.integers(0, 40)),
             rng.integers(0, TRASH, (mp,)).astype(np.int32), 0) for n in lens]


PACKS = {
    "decode only, every slot live": (lambda: _decode_group(8, range(8)), [], {}),
    "decode only, dead slots": (lambda: _decode_group(8, (0, 3, 6)), [],
                                dict(rows=16, chunk_rows=0)),
    "spec-width window": (lambda: _decode_group(4, (1, 2), W=3), [], {}),
    "chunks only": (lambda: _decode_group(0, ()), [7, 1, 30],
                    dict(rows=16, chunk_rows=8)),
    "mixed": (lambda: _decode_group(8, (0, 2, 5, 7)), [5, 120],
              dict(rows=16, chunk_rows=8)),
    "mixed, flat axis padded past 16": (lambda: _decode_group(2, (1,)), [17],
                                        dict(min_tokens=4)),
    "inert padding rows": (lambda: _decode_group(1, (0,)), [2], dict(rows=8,
                                                                     chunk_rows=4)),
}


@pytest.mark.parametrize("case", list(PACKS))
def test_pack_ragged_batch_equals_jax(case):
    make_decode, chunk_lens, kw = PACKS[case]
    decode = make_decode()
    mp = decode[3].shape[1] if decode[0].shape[0] else 4
    if not decode[0].shape[0]:
        decode = (decode[0], decode[1], decode[2], np.zeros((0, mp), np.int32), decode[4])
    entries = _chunks(chunk_lens, mp)
    ours = tfused.pack_ragged_batch(*decode, entries, TRASH, **kw)
    ref = jfused.pack_ragged_batch(*decode, entries, TRASH, **kw)
    for f in dataclasses.fields(jfused.RaggedBatch):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert ours.packed_tokens == int(decode[1].sum()) + sum(chunk_lens)
    assert ours.tokens.shape[0] >= max(ours.packed_tokens, kw.get("min_tokens", 16))


def test_pow2_rows_and_row_limits_match_jax():
    assert [tfused.pow2_rows(n) for n in range(0, 20)] == [
        jfused.pow2_rows(n) for n in range(0, 20)]
    decode = _decode_group(8, range(8))
    for mod in (tfused, jfused):
        with pytest.raises(ValueError, match="fixed row count"):
            mod.pack_ragged_batch(*decode, _chunks([3] * 9), TRASH, rows=16)
        with pytest.raises(ValueError, match="chunk_sel"):
            mod.pack_ragged_batch(*decode, _chunks([3] * 3), TRASH, rows=16, chunk_rows=2)


# -- fused_step ----------------------------------------------------------------


def _pools_from_jax(jcache, ct, tcc):
    """The JAX pool's contents in the port's pool (same layout)."""
    tcache = tkv.init_kv_cache(ct, tcc, "cpu")
    for name, arr in jcache.items():
        tcache[name].copy_(torch.from_numpy(np.array(arr)))
    return tcache


@pytest.mark.parametrize("live_only", [False, True])
@pytest.mark.parametrize("kv_splits", [0, 8])
@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_fused_step_matches_jax(weights, kv_dtype, kv_splits, live_only):
    """Two prompts prefilled into their pages, then ONE mixed forward: two
    decode rows (one slot dead), a 23-token cache-hit suffix at position 32
    over a page the first prompt wrote, and a 9-token chunk from 0.  With
    ``live_only`` the port's forward runs over the 34 live tokens alone,
    as the engine runs it; without, over all 64 of the padded flat axis."""
    cj, ct, pj, pt = weights
    n_pages, ps, mp = TRASH + 1, 16, 8
    cc = dict(n_pages=n_pages, page_size=ps, max_pages_per_seq=mp, kv_dtype=kv_dtype)
    jcc, tcc = jkv.CacheConfig(**cc), tkv.CacheConfig(**cc)
    rng = np.random.default_rng(2)
    lens = np.asarray([40, 21], np.int32)
    toks = np.zeros((2, 64), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(3, cj.vocab_size, n)
    rows = np.full((2, mp), TRASH, np.int32)
    rows[0, :4] = [3, 0, 9, 4]
    rows[1, :4] = [7, 12, 1, 5]
    jcache = jkv.init_kv_cache(cj, jcc)
    jcache, jlog = jmr.prefill(cj, jcc, pj, jcache, jnp.asarray(toks),
                               jnp.asarray(lens), jnp.asarray(rows))
    tcache = _pools_from_jax(jcache, ct, tcc)

    B = 3
    window = np.zeros((B, 1), np.int32)
    window[[0, 2], 0] = np.asarray(jlog).argmax(-1)
    counts = np.asarray([1, 0, 1], np.int32)
    positions = np.asarray([40, 0, 21], np.int32)
    tables = np.full((B, mp), TRASH, np.int32)
    tables[0], tables[2] = rows[0], rows[1]
    hit_table = np.full((mp,), TRASH, np.int32)
    hit_table[:4] = [3, 0, 14, 15]  # shares row 0's first two pages
    chunk_table = np.full((mp,), TRASH, np.int32)
    chunk_table[0] = 16
    entries = [([int(t) for t in rng.integers(3, cj.vocab_size, 23)], 32, hit_table, 0),
               ([int(t) for t in rng.integers(3, cj.vocab_size, 9)], 0, chunk_table, 0)]
    packed = jfused.pack_ragged_batch(window, counts, positions, tables,
                                      np.zeros((B,), np.int32), entries, TRASH,
                                      rows=8, chunk_rows=4)
    ops = (packed.tokens, packed.row_starts, packed.q_begins, packed.q_lens,
           packed.page_tables, packed.sel, packed.chunk_sel)
    jcache, jl, jc = jmr.fused_step(cj, jcc, pj, jcache, *map(jnp.asarray, ops),
                                    kv_splits=kv_splits)
    assert packed.tokens.shape[0] == 64 and packed.packed_tokens == 34
    tl, tc = tmr.fused_step(ct, tcc, pt, tcache, *map(torch.from_numpy, ops),
                            kv_splits=kv_splits,
                            n_tokens=packed.packed_tokens if live_only else 64)
    assert tl.shape == (B, 1, cj.vocab_size) and tc.shape == (4, cj.vocab_size)
    atol = LOGITS_ATOL_INT8 if kv_dtype == "int8" else LOGITS_ATOL
    np.testing.assert_allclose(tl.numpy()[[0, 2]], np.asarray(jl)[[0, 2]],
                               atol=atol, rtol=0)
    np.testing.assert_allclose(tc.numpy()[:2], np.asarray(jc)[:2], atol=atol, rtol=0)
    for name in tcache:
        # the trash page takes colliding padding writes in either order
        ours = tcache[name].numpy()[:, :, : n_pages - 1]
        ref = np.asarray(jcache[name])[:, :, : n_pages - 1]
        if kv_dtype == "int8" and name in ("k", "v"):
            # a code may round the other way (LOGITS_ATOL_INT8), rarely
            diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        else:
            np.testing.assert_allclose(ours, ref, atol=KV_ATOL, rtol=0)
    # the suffix wrote its own pages, the chunk its page, from their starts
    assert np.abs(tcache["k"].numpy()[:, :, [14, 15, 16]]).sum() > 0


def test_decode_step_is_the_zero_chunk_fused_step(weights):
    cj, ct, pj, pt = weights
    tcc = tkv.CacheConfig(n_pages=TRASH + 1, page_size=16, max_pages_per_seq=4)
    cache = tkv.init_kv_cache(ct, tcc, "cpu")
    gen = torch.Generator().manual_seed(0)
    for name in cache:
        cache[name].normal_(generator=gen)
    tokens = torch.tensor([5, 9, 11], dtype=torch.int32)
    positions = torch.tensor([17, 0, 40], dtype=torch.int32)
    tables = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]], dtype=torch.int32)
    active = torch.tensor([True, False, True])
    c1 = {k: v.clone() for k, v in cache.items()}
    c2 = {k: v.clone() for k, v in cache.items()}
    ours = tmr.decode_step(ct, tcc, pt, c1, tokens, positions, tables, active)
    rows = torch.arange(3, dtype=torch.int32)
    ref, chunk = tmr.fused_step(ct, tcc, pt, c2, tokens, positions, rows,
                                active.to(torch.int32), tables, rows[:, None], rows[:0],
                                n_tokens=3)
    assert torch.equal(ours, ref[:, 0]) and chunk.shape == (0, cj.vocab_size)
    assert all(torch.equal(c1[k], c2[k]) for k in c1)


# -- the engine --------------------------------------------------------------------


def _mixed_requests(vocab):
    rng = np.random.default_rng(5)
    return [("stream", [1, 2, 3], 20),
            ("long", [int(t) for t in rng.integers(1, vocab, 100)], 8),
            ("short", [int(t) for t in rng.integers(1, vocab, 9)], 4)]


def _run(engine, requests):
    for rid, prompt, n in requests:
        engine.add_request(teng.Request(rid, prompt, tsamp.SamplingParams(
            temperature=0.0, max_tokens=n)))
    streams: dict[str, list[int]] = {}
    for _ in range(400):
        if not engine.has_work():
            break
        for out in engine.step():
            streams.setdefault(out.request_id, []).append(out.token)
    assert not engine.has_work()
    return streams


def test_fused_step_changes_no_stream_and_saves_weight_passes(weights):
    _, ct, _, pt = weights
    runs = {}
    for fused in (False, True):
        engine = teng.NativeEngine(ct, tkv.CacheConfig(n_pages=65, page_size=16,
                                                       max_pages_per_seq=16),
                                   max_batch_size=4, params=pt, device="cpu",
                                   token_budget=16, fused_step=fused)
        runs[fused] = (_run(engine, _mixed_requests(ct.vocab_size)), engine.sched)
    (split, s_sched), (fused, f_sched) = runs[False], runs[True]
    assert split == fused
    assert f_sched.fused_steps_total > 0 and s_sched.fused_steps_total == 0
    assert f_sched.weight_passes_per_step() < s_sched.weight_passes_per_step()
    assert f_sched.fused_packed_tokens_sum > 0


def test_every_paged_forward_goes_through_fused_step(weights, monkeypatch):
    """Prefix hits, chunk advances, mixed steps and decode: every forward
    that reads pages is one ``fused_step`` (one weight pass each, flash
    prefill the rest), and no engine path calls the standalone paged
    primitives."""
    _, ct, _, pt = weights
    calls = []
    real = tmr.fused_step

    def counted(*a, **k):
        calls.append(a[4].shape[0])
        return real(*a, **k)

    def forbidden(*_a, **_k):
        raise AssertionError("an engine path called a standalone paged primitive")

    monkeypatch.setattr(teng, "fused_step", counted)
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "paged_verify_attention"):
        monkeypatch.setattr(tpa, name, forbidden)
    engine = teng.NativeEngine(ct, tkv.CacheConfig(n_pages=65, page_size=16,
                                                   max_pages_per_seq=16),
                               max_batch_size=4, params=pt, device="cpu", token_budget=16)
    reqs = _mixed_requests(ct.vocab_size)
    _run(engine, reqs)
    _run(engine, [("again", reqs[1][1] + [7, 8], 3)])  # a cache hit
    assert engine.prefix_cache_hit_rate() > 0
    flash_groups = engine.sched.weight_passes_total - len(calls)
    assert len(calls) > 0 and 0 < flash_groups <= 2


def test_engine_fixes_one_walk_cluster_whatever_T(weights, monkeypatch):
    """With the launch faked (the C entry zeroes its output, as in
    ``test_torch_walk_cluster.py``), an engine on the single walk hands
    the kernel the cluster size fixed from its static shapes in every
    launch (decode-only, chunk-only and mixed, T from 1 to 40: the live
    tokens), where the shape rule would have changed it with T."""
    cfg = tcfg.get_preset("qwen3-tiny")  # bf16: the kernel's dtype
    calls = []

    def fake_entry(source, fn):
        def launch(*args):
            out, T = args[9], args[10]
            calls.append((fn, T, args[-2]))
            ctypes.memset(out, 0, T * cfg.n_heads * cfg.head_dim * 2)
            return 0
        return launch

    monkeypatch.setattr(tpa, "_sm_count", lambda device: 132)
    monkeypatch.setattr(dispatch, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "entry", fake_entry)
    monkeypatch.setattr(tpa, "_stream", lambda t: 0)
    # only the walk's launch is faked: the projections and norms run their
    # plain versions (test_torch_gemm.py fakes theirs)
    for mod in (tmr, ttr):
        monkeypatch.setattr(mod, "matmul", tgemm.reference_matmul)
        monkeypatch.setattr(mod, "rms_norm", trn.reference_rms_norm)
        monkeypatch.setattr(mod, "add_rms_norm", trn.reference_add_rms_norm)
    monkeypatch.setattr(ttr, "qk_norm_rope_kv", trn.reference_qk_norm_rope_kv)
    # the static shapes of an engine on the card: 8 rows, KV 2, mp 8
    fixed = tpa.pick_cluster_size(8, cfg.n_kv_heads, 8, 132)
    monkeypatch.setattr(teng, "engine_cluster_size",
                        lambda n, kv, mp, device: tpa.pick_cluster_size(n, kv, mp, 132))
    engine = teng.NativeEngine(cfg, tkv.CacheConfig(n_pages=40, page_size=16,
                                                    max_pages_per_seq=8),
                               device="cpu", kv_splits=0, token_budget=40)
    assert engine.walk_cluster == fixed == 8
    rng = np.random.default_rng(0)
    reqs = [("a", [int(t) for t in rng.integers(3, 200, 45)], 6),
            ("b", [int(t) for t in rng.integers(3, 200, 90)], 3)]
    dispatch.reset_launches()
    try:
        _run(engine, reqs)
        assert dispatch.launches()["ragged_paged_attention"] == len(calls)
    finally:
        dispatch.reset_launches()
    assert {fn for fn, _, _ in calls} == {"ragged_paged_attention"}
    Ts = {T for _, T, _ in calls}
    assert {cl for _, _, cl in calls} == {fixed}
    assert min(Ts) == 1 and max(Ts) >= 40
    assert {tpa.pick_cluster_size(T, cfg.n_kv_heads, 8, 132) for T in Ts} != {fixed}
    assert engine.sched.fused_steps_total > 0


@pytest.mark.parametrize("spec_k", [None, 3])
def test_decode_forwards_run_their_gemms_at_fixed_rows(weights, monkeypatch, spec_k):
    """The GEMM rows a decode forward runs are fixed by its live tokens,
    nothing else.  A spy on ``qkv_proj``'s row count: every decode-only
    forward of a per-token engine (the fused step off, so chunk forwards run apart)
    runs its GEMMs and its walk over the same live tokens, with one slot
    live or all B: no padding to a fixed row count, since the GEMM and
    norm kernels keep a row's bits whatever the row count (W = 1 +
    speculative_k columns a slot, live columns only)."""
    _, ct, _, pt = weights
    gemm_rows, walk_tokens, live_rows, in_decode = [], [], [], [False]
    real_qkv, real_attn = tmr.qkv_proj, tmr._ragged_attn

    def qkv(cfg, layer, h, rope, **kw):
        if in_decode[0]:
            gemm_rows.append(h.shape[0])
        return real_qkv(cfg, layer, h, rope, **kw)

    def attn(q, *a, **k):
        if in_decode[0]:
            walk_tokens.append(q.shape[0])
        return real_attn(q, *a, **k)

    monkeypatch.setattr(tmr, "qkv_proj", qkv)
    monkeypatch.setattr(tmr, "_ragged_attn", attn)
    engine = teng.NativeEngine(ct, tkv.CacheConfig(n_pages=65, page_size=16,
                                                   max_pages_per_seq=16),
                               max_batch_size=4, params=pt, device="cpu",
                               token_budget=16, fused_step=False, speculative_k=spec_k)
    real_decode = engine._decode

    def decode():
        live_rows.append(len(engine._live()))
        in_decode[0] = True
        try:
            return real_decode()
        finally:
            in_decode[0] = False

    engine._decode = decode
    _run(engine, [("one", [1, 2, 3] * 4, 6)])
    _run(engine, [(f"r{i}", [4 + i, 5, 6] * 4, 6) for i in range(4)]
         + [("long", list(range(3, 60)), 2)])
    W = 1 + (spec_k or 0)
    assert 1 in live_rows and 4 in live_rows
    assert gemm_rows and gemm_rows == walk_tokens
    assert min(walk_tokens) == 1 and max(walk_tokens) <= 4 * W
    if spec_k is None:
        assert set(walk_tokens) <= {1, 2, 3, 4} and 4 in walk_tokens
