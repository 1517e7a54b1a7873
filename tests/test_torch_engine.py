"""The PyTorch port's engine and server against the JAX engine.

Greedy token streams must be identical to the JAX ``NativeEngine``'s on
the same weights (float32 ``qwen3-tiny``), with the decode path on the
single page walk (``kv_splits=0``) and on the split walk
(``kv_splits=8``).  Seeded sampling is checked within the port only: the
two frameworks' generators give different bits.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from fusioninfer_tpu.engine import engine as jeng
from fusioninfer_tpu.engine import kv_cache as jkv
from fusioninfer_tpu.engine import sampler as jsamp
from fusioninfer_tpu.models import config as jcfg
from fusioninfer_tpu.models import transformer as jtr
from fusioninfer_tpu_torch import cli
from fusioninfer_tpu_torch.convert import params_from_jax
from fusioninfer_tpu_torch.engine import engine as teng
from fusioninfer_tpu_torch.engine import kv_cache as tkv
from fusioninfer_tpu_torch.engine import sampler as tsamp
from fusioninfer_tpu_torch.engine.server import EngineServer
from fusioninfer_tpu_torch.models import config as tcfg

PROMPT_LENS = (5, 17, 40, 90)
MAX_TOKENS = 12


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


def _prompts(vocab, lens=PROMPT_LENS):
    return [[int(t) for t in np.random.default_rng(i).integers(3, vocab, n)]
            for i, n in enumerate(lens)]


def _run(engine, make_request, make_params, prompts, max_steps=400):
    for i, p in enumerate(prompts):
        engine.add_request(make_request(f"r{i}", p, make_params()))
    streams: dict[str, list[int]] = {}
    finish = {}
    for _ in range(max_steps):
        if not engine.has_work():
            break
        for out in engine.step():
            streams.setdefault(out.request_id, []).append(out.token)
            if out.finished:
                finish[out.request_id] = out.finish_reason
    assert not engine.has_work(), "engine did not drain"
    return streams, finish


@pytest.mark.parametrize("kv_splits", [0, 8])
@pytest.mark.parametrize("n_pages,lens", [(64, PROMPT_LENS), (7, (5, 17, 40, 60))])
def test_greedy_streams_identical_to_jax(weights, kv_splits, n_pages, lens):
    """n_pages=7 leaves 6 usable pages of 16 tokens: the 60-token prompt
    waits for admission and the 40-token one is preempted when its decode
    crosses a page boundary, then resumes — on both engines alike."""
    cj, ct, pj, pt = weights
    prompts = _prompts(cj.vocab_size, lens)
    mp = min(7, n_pages - 1)
    jcc = jkv.CacheConfig(n_pages=n_pages, page_size=16, max_pages_per_seq=mp)
    je = jeng.NativeEngine(cj, jcc, params=pj, enable_prefix_caching=False,
                           fused_step=False, kv_splits=kv_splits)
    ref, ref_fin = _run(je, jeng.Request, lambda: jsamp.SamplingParams(
        temperature=0.0, max_tokens=MAX_TOKENS), prompts)
    tcc = tkv.CacheConfig(n_pages=n_pages, page_size=16, max_pages_per_seq=mp)
    te = teng.NativeEngine(ct, tcc, params=pt, device="cpu", kv_splits=kv_splits,
                           enable_prefix_caching=False, fused_step=False)
    assert te.kv_splits == kv_splits
    ours, fin = _run(te, teng.Request, lambda: tsamp.SamplingParams(
        temperature=0.0, max_tokens=MAX_TOKENS), prompts)
    assert ours == ref
    assert fin == ref_fin == dict.fromkeys(ref, "length")
    assert all(len(s) == MAX_TOKENS for s in ours.values())
    if n_pages == 7:
        assert te.preemptions_total > 0 and je.preemptions_total > 0


def test_default_kv_splits_follow_the_static_heuristic(weights):
    _, ct, _, pt = weights
    long_ctx = tkv.CacheConfig(n_pages=40, page_size=128, max_pages_per_seq=32)
    short_ctx = tkv.CacheConfig(n_pages=40, page_size=128, max_pages_per_seq=16)
    assert teng.NativeEngine(ct, long_ctx, params=pt, device="cpu").kv_splits == 8
    assert teng.NativeEngine(ct, short_ctx, params=pt, device="cpu").kv_splits == 0


def _sampled(pt, ct, seed):
    te = teng.NativeEngine(ct, tkv.CacheConfig(n_pages=32, page_size=16,
                                               max_pages_per_seq=8),
                           params=pt, device="cpu")
    streams, _ = _run(te, teng.Request, lambda: tsamp.SamplingParams(
        temperature=1.0, top_k=50, top_p=0.9, max_tokens=MAX_TOKENS, seed=seed),
        _prompts(ct.vocab_size)[:2])
    return streams


def test_seeded_sampling_reproducible_within_port(weights):
    _, ct, _, pt = weights
    a = _sampled(pt, ct, seed=7)
    assert a == _sampled(pt, ct, seed=7)
    assert a != _sampled(pt, ct, seed=8)


def test_filter_logits_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 64), dtype=np.float32) * 3
    temp = np.asarray([0.7, 1.0, 1.5], np.float32)
    top_k = np.asarray([5, 0, 20], np.int32)
    top_p = np.asarray([1.0, 0.8, 0.5], np.float32)
    min_p = np.asarray([0.0, 0.05, 0.1], np.float32)
    ref = np.asarray(jsamp.filter_logits(*(jax.numpy.asarray(a) for a in (
        logits, temp, top_k, top_p, min_p))))
    ours = tsamp.filter_logits(*(torch.from_numpy(a) for a in (
        logits, temp, top_k, top_p, min_p))).numpy()
    np.testing.assert_array_equal(np.isinf(ours), np.isinf(ref))
    np.testing.assert_allclose(ours[~np.isinf(ours)], ref[~np.isinf(ref)],
                               atol=1e-6, rtol=0)


def test_penalties_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 32), dtype=np.float32)
    counts = rng.integers(0, 3, (2, 32)).astype(np.int32)
    outs = np.minimum(counts, rng.integers(0, 2, (2, 32))).astype(np.int32)
    pres = np.asarray([0.5, 0.0], np.float32)
    freq = np.asarray([0.1, 0.3], np.float32)
    rep = np.asarray([1.2, 1.0], np.float32)
    ref = np.asarray(jsamp.apply_penalties(*(jax.numpy.asarray(a) for a in (
        logits, counts, outs, pres, freq, rep))))
    ours = tsamp.apply_penalties(*(torch.from_numpy(a) for a in (
        logits, counts, outs, pres, freq, rep))).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_cancel_and_validation(weights):
    _, ct, _, pt = weights
    te = teng.NativeEngine(ct, tkv.CacheConfig(n_pages=16, page_size=16,
                                               max_pages_per_seq=4),
                           params=pt, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        te.add_request(teng.Request("big", [5] * 60,
                                    tsamp.SamplingParams(max_tokens=10)))
    with pytest.raises(ValueError, match="empty"):
        te.add_request(teng.Request("e", [], tsamp.SamplingParams()))
    with pytest.raises(ValueError, match="stop token id outside vocab"):
        te.add_request(teng.Request("s", [5], tsamp.SamplingParams(
            max_tokens=4, stop_token_ids=(ct.vocab_size,))))
    te.add_request(teng.Request("a", [5, 6, 7], tsamp.SamplingParams(
        temperature=0.0, max_tokens=20)))
    te.step()
    assert te.num_running == 1
    te.cancel("a")
    te.step()
    assert not te.has_work() and te.cancelled_total == 1
    assert te.alloc.free_pages == 15


def test_cuda_default_raises_without_cuda(weights, monkeypatch):
    _, ct, _, pt = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teng.NativeEngine(ct, params=pt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["engine", "serve", "qwen3-tiny", "--port", "0"])


# -- server ----------------------------------------------------------------


@pytest.fixture(scope="module")
def server():
    cfg = tcfg.get_preset("qwen3-tiny")
    eng = teng.NativeEngine(cfg, tkv.CacheConfig(n_pages=64, page_size=16,
                                                 max_pages_per_seq=16),
                            device="cpu", seed=3)
    srv = EngineServer(eng, host="127.0.0.1", port=0)
    srv.start()
    yield srv
    srv.stop(timeout=10)
    assert not srv._engine_thread.is_alive()
    assert not srv._http_thread.is_alive()


def _post(srv, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/completions",
        data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=30)


def test_server_blocking_completion(server):
    with _post(server, {"prompt": "hello there", "max_tokens": 8,
                        "temperature": 0.0}) as resp:
        out = json.loads(resp.read())
    assert out["object"] == "text_completion"
    assert out["usage"]["prompt_tokens"] == len("hello there") + 1  # + BOS
    choice = out["choices"][0]
    assert choice["finish_reason"] in ("length", "stop")
    if choice["finish_reason"] == "length":
        assert out["usage"]["completion_tokens"] == 8


def test_server_sse_matches_blocking(server):
    body = {"prompt": "stream me", "max_tokens": 6, "temperature": 0.0}
    with _post(server, body) as resp:
        blocking = json.loads(resp.read())
    ids, finish = [], None
    with _post(server, {**body, "stream": True}) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        lines = [raw.decode().strip() for raw in resp]
    assert lines[-1] == "data: [DONE]" or "data: [DONE]" in lines
    for line in lines:
        if line.startswith("data: {"):
            choice = json.loads(line[6:])["choices"][0]
            if "token_id" in choice:
                ids.append(choice["token_id"])
            finish = choice["finish_reason"] or finish
    assert finish == blocking["choices"][0]["finish_reason"]
    assert len(ids) == blocking["usage"]["completion_tokens"]


def test_server_models_health_and_bad_requests(server):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/v1/models",
                                timeout=30) as resp:
        assert json.loads(resp.read())["data"][0]["id"] == "qwen3-tiny"
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/health",
                                timeout=30) as resp:
        assert json.loads(resp.read())["status"] == "ok"
    for bad in ({"prompt": "x", "response_format": {"type": "yaml"}},
                {"prompt": "x", "logit_bias": {"999999": 1.0}}, {"prompt": "x", "n": 2},
                {"prompt": "x", "min_p": 2.0}):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(server, bad)
        assert err.value.code == 400
        err.value.close()


def test_server_concurrent_requests(server):
    results = []

    def one(i):
        with _post(server, {"prompt": f"req {i}", "max_tokens": 4,
                            "temperature": 0.0}) as resp:
            results.append(json.loads(resp.read()))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 5
