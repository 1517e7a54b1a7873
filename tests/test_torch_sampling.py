"""The port's candidate sampler, logprobs and logit_bias against the JAX
package.

* ``sampler.topk_ordered`` gives ``lax.top_k``'s order exactly on
  planted ties (value descending, then the lower index; candidate 0 is
  ``torch.argmax``), and the candidates a row draws from (the lm_head
  product, ``apply_penalties``, the min-tokens suppression, then
  ``topk_ordered``'s 64) are ``lax.top_k``'s over JAX's ``lm_head`` +
  ``apply_penalties``: values within ``TOPK_VAL_ATOL``, and each chosen
  index holds the value JAX ranks at its place within that tolerance (a
  near-tie may swap).  JAX's blocked ``lm_head_topk`` is not the oracle:
  its bit claims fail in this suite.
* Every row draws by its own params (candidate rows through
  ``sample_topk``), so a seeded row never depends on its neighbours.
* The engine: seeded streams (greedy, top-k, penalties, min_tokens,
  min_p, beside chunked prefill) are the same in a batch and alone;
  logprobs are within ``LOGPROB_ATOL`` of the JAX engine's with the same
  tokens and top ids; ``logit_bias`` greedy streams equal JAX's.
* The server: ``logprobs`` and ``logit_bias`` are parsed with JAX's
  clamping and the completion carries JAX's ``logprobs`` object.
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
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
from fusioninfer_tpu_torch.engine import sampler as tsamp
from fusioninfer_tpu_torch.engine.server import EngineServer
from fusioninfer_tpu_torch.models import config as tcfg
from fusioninfer_tpu_torch.models import transformer as ttr

# f32 logits of the two frameworks' head products (D 256) differ in their
# last bits; 1e-5 is ~100 ulps at these magnitudes
TOPK_VAL_ATOL = 1e-5
# log_softmax of those logits over a 4096 vocab: the same order of error
LOGPROB_ATOL = 1e-5
K = tsamp.LM_HEAD_TOPK


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


# -- top-k order -------------------------------------------------------------------


@pytest.mark.parametrize("V,k", [(300, 64), (40, 64), (64, 64), (500, 1), (500, 5)])
def test_topk_ordered_is_lax_top_k_on_planted_ties(V, k):
    """Rows full of exact ties (a few distinct values, -inf runs): the
    order is lax.top_k's exactly, and candidate 0 is torch.argmax."""
    rng = np.random.default_rng(V + k)
    x = rng.choice(np.asarray([-1.5, 0.25, 2.0, 3.0, -np.inf], np.float32), (6, V))
    x[1] = -np.inf
    x[2, ::7] = 3.0
    x[3] = rng.standard_normal(V).astype(np.float32)
    x[3, [5, 9, V - 1]] = 9.0
    vals, idx = tsamp.topk_ordered(torch.from_numpy(x), k)
    jv, ji = jax.lax.top_k(jnp.asarray(x), min(k, V))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert torch.equal(idx[:, 0], torch.argmax(torch.from_numpy(x), dim=-1))


def _penalty_inputs(N, V, seed, penalties: bool, early: bool):
    rng = np.random.default_rng(seed)
    tc = rng.integers(0, 3, (N, V)).astype(np.int32) * (rng.random((N, V)) < 0.05)
    oc = (tc * (rng.random((N, V)) < 0.5)).astype(np.int32)
    pres = rng.uniform(0, 1.5, N).astype(np.float32) if penalties else np.zeros(N, np.float32)
    freq = rng.uniform(0, 0.5, N).astype(np.float32) if penalties else np.zeros(N, np.float32)
    rep = rng.uniform(1.0, 1.6, N).astype(np.float32) if penalties else np.ones(N, np.float32)
    ear = (rng.random(N) < 0.5) if early else np.zeros(N, bool)
    sup = rng.random((N, V)) < 0.02
    sup[:, 0] = True
    return tc.astype(np.int32), oc, pres, freq, rep, ear, sup


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("penalties,early", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("V", [4096, 40])
def test_lm_head_topk_matches_full_topk(tied, penalties, early, V):
    """The port's lm_head top-k candidates (its lm_head, apply_penalties,
    the min-tokens suppression, topk_ordered: what ``sample`` hands a
    candidate row) against lax.top_k over JAX's full [N, V] logits (JAX
    lm_head, apply_penalties, the min-tokens suppression)."""
    N, D = 8, 256
    rng = np.random.default_rng(V + 2 * tied + penalties + early)
    h = rng.standard_normal((N, D)).astype(np.float32)
    head = (rng.standard_normal((V, D) if tied else (D, V)) / 16).astype(np.float32)
    tc, oc, pres, freq, rep, ear, sup = _penalty_inputs(N, V, V, penalties, early)
    jhead = jnp.asarray(head.T if tied else head)
    ref = (jnp.asarray(h) @ jhead).astype(jnp.float32)
    ref = jsamp.apply_penalties(ref, jnp.asarray(tc), jnp.asarray(oc), jnp.asarray(pres),
                                jnp.asarray(freq), jnp.asarray(rep))
    ref = np.asarray(jnp.where(jnp.asarray(ear)[:, None] & jnp.asarray(sup), -jnp.inf, ref))
    jv, _ = jax.lax.top_k(jnp.asarray(ref), min(K, V))
    jv = np.asarray(jv)
    t = torch.from_numpy
    logits = ttr.lm_head(None, {"embed": t(head)} if tied else {"lm_head": t(head)}, t(h))
    if penalties:
        logits = tsamp.apply_penalties(logits, t(tc), t(oc), t(pres), t(freq), t(rep))
    if early:
        logits = torch.where(t(ear)[:, None] & t(sup), float("-inf"), logits)
    vals, idx = tsamp.topk_ordered(logits, K)
    assert vals.shape == idx.shape == (N, min(K, V))
    np.testing.assert_allclose(vals.numpy(), jv, atol=TOPK_VAL_ATOL, rtol=0)
    # each chosen index holds (in JAX's logits) the value JAX ranks at its
    # place: a near-tie may swap two indices, nothing else may differ
    np.testing.assert_allclose(np.take_along_axis(ref, idx.numpy(), 1), jv,
                               atol=TOPK_VAL_ATOL, rtol=0)
    assert all(len(set(row)) == idx.shape[1] for row in idx.tolist())
    if early:  # a suppressed id is a candidate only at -inf (V <= K)
        hit = np.take_along_axis(sup, idx.numpy(), 1) & ear[:, None]
        assert hit.any() == (V <= K) and np.isneginf(vals.numpy()[hit]).all()


# -- the sampler ------------------------------------------------------------------


def test_every_row_draws_by_its_own_params_in_every_mode():
    """Whatever kinds of rows share a batch (a candidate row, a top_p row,
    a plain row, a greedy row), each seeded row draws the token it draws
    alone; the candidate row is ``sample_topk`` over ``topk_ordered``'s
    candidates, greedy rows are the argmax."""
    V = 500
    logits = torch.randn((4, V), generator=torch.Generator().manual_seed(3)) * 2
    args = dict(temperature=[0.7, 1.0, 0.9, 0.0], top_k=[12, 0, 0, 0],
                top_p=[0.9, 0.8, 1.0, 1.0], min_p=[0.0] * 4, seeds=[1, 2, 3, 4],
                counters=[7, 8, 9, 10])
    mixed = tsamp.sample(logits, *args.values())

    def alone(i):
        return tsamp.sample(logits[i:i + 1], *([v[i]] for v in args.values()))[0]

    assert all(mixed[i] == alone(i) for i in range(4))
    assert mixed[3] == torch.argmax(logits[3])
    # the candidate row is sample_topk over topk_ordered's candidates
    vals, idx = tsamp.topk_ordered(logits[:1], K)
    assert mixed[0] == tsamp.sample_topk(vals, idx, [0.7], [12], [0.9], [1], [7])[0]
    greedy = dict(args, temperature=[0.0] * 4)
    assert torch.equal(tsamp.sample(logits, *greedy.values()),
                       torch.argmax(logits, dim=-1))


def test_draw_depends_only_on_seed_counter_and_stream():
    """The counter-based draw: a row's uniforms are the same alone and in
    any batch, whatever the column count (a prefix stays a prefix) and
    the index dtype; a seed counts by its uint32 bits; another counter or
    stream gives other values, and streams 1 and 2 look independent of
    stream 0 (means near 1/2, correlations near 0 over 4000 keys)."""
    seeds = torch.tensor([7, 7, 123456789, 2**32 + 7, -1, 0])
    counters = torch.tensor([0, 1, 0, 0, 5, 2**20])
    batch = tsamp.uniforms(seeds, counters, 0, 64)
    for i in range(len(seeds)):
        assert torch.equal(tsamp.uniforms(seeds[i:i + 1], counters[i:i + 1], 0, 64)[0],
                           batch[i])
    assert torch.equal(tsamp.uniforms(seeds.int(), counters.int(), 0, 9), batch[:, :9])
    assert torch.equal(batch[3], batch[0]) and not torch.equal(batch[0], batch[1])
    assert torch.equal(tsamp.uniforms(seeds[4:5] & 0xFFFF_FFFF, counters[4:5], 0, 64)[0],
                       batch[4])
    n = 4000
    keys = torch.arange(n) * 7919, torch.arange(n) % 13
    u = torch.stack([tsamp.uniforms(*keys, s, 1)[:, 0] for s in range(3)]).double()
    assert ((u > 0) & (u < 1)).all()
    assert (u.mean(dim=1) - 0.5).abs().max() < 0.03
    corr = torch.corrcoef(u)
    assert (corr - torch.eye(3, dtype=corr.dtype)).abs().max() < 0.06
    g = tsamp.gumbel_noise(*keys, 0, 1)[:, 0].double()
    assert abs(g.mean() - 0.5772) < 0.06  # the Euler-Mascheroni constant


ROW_KINDS = {
    "greedy": dict(temperature=0.0, top_k=0, top_p=1.0, min_p=0.0),
    "plain": dict(temperature=0.9, top_k=0, top_p=1.0, min_p=0.0),
    "candidate": dict(temperature=0.7, top_k=12, top_p=0.9, min_p=0.0),
    "top_p": dict(temperature=1.1, top_k=0, top_p=0.8, min_p=0.0),
    "min_p": dict(temperature=0.8, top_k=0, top_p=1.0, min_p=0.05),
    "top_k over the cap": dict(temperature=0.8, top_k=100, top_p=1.0, min_p=0.0),
}
# the modes a row of each kind can be sampled in (sample_mode's rule)
SEEN_BY = {"greedy": tsamp.SAMPLE_MODES, "plain": ("plain", "filtered"),
           "candidate": ("topk", "filtered"), "top_p": ("filtered",),
           "min_p": ("filtered",), "top_k over the cap": ("filtered",)}


@pytest.mark.parametrize("kind", list(ROW_KINDS))
def test_tensor_sampler_gives_a_row_the_same_token_in_every_mode(kind):
    """Rows of one kind, their params as device tensors: the same tokens
    in every mode that can see them, the same as each row alone, and in
    a mixed batch under "filtered" (the mode ``sample_mode`` picks for
    it); a greedy row is the argmax."""
    V, N = 500, 6
    logits = torch.randn((N, V), generator=torch.Generator().manual_seed(4)) * 2.5
    p = tsamp.SamplingParams(**ROW_KINDS[kind])
    cols = (torch.full((N,), p.temperature), torch.full((N,), p.top_k),
            torch.full((N,), p.top_p), torch.full((N,), p.min_p),
            torch.arange(N) + 40, torch.arange(N) * 3)
    assert tsamp.sample_mode([p] * N) == SEEN_BY[kind][0]
    toks = {m: tsamp.sample(logits, *cols, mode=m) for m in SEEN_BY[kind]}
    ref = toks[SEEN_BY[kind][0]]
    assert all(torch.equal(t, ref) for t in toks.values())
    for i in range(N):
        alone = tsamp.sample(logits[i:i + 1], *(c[i:i + 1] for c in cols),
                             mode=SEEN_BY[kind][0])
        assert alone[0] == ref[i]
    if kind == "greedy":
        assert torch.equal(ref, torch.argmax(logits, dim=-1))
    # the same rows beside one row of every kind, under "filtered"
    others = [tsamp.SamplingParams(**kw) for kw in ROW_KINDS.values()]
    mixed = [p] * N + others
    assert tsamp.sample_mode(mixed) in ("filtered", SEEN_BY[kind][0])
    big = torch.cat([logits, torch.randn((len(others), V)) * 2.5])
    out = tsamp.sample(big, [q.temperature for q in mixed], [q.top_k for q in mixed],
                       [q.top_p for q in mixed], [q.min_p for q in mixed],
                       list(range(40, 40 + N)) + [1] * len(others),
                       list(range(0, 3 * N, 3)) + [0] * len(others), mode="filtered")
    assert torch.equal(out[:N], ref)


@pytest.mark.parametrize("burst", [1, 4])
def test_seeded_streams_resume_after_preemption(weights, burst):
    """Seeded sampled requests in a pool too small for all of them: the
    preempted ones resume their streams where they stopped (the draw's
    counter is the tokens generated), per token and in bursts, as in an
    ample pool."""
    _, ct, _, pt = weights
    prompts = _prompts(ct.vocab_size, lens=(20, 25, 30))
    reqs = [(f"r{i}", p, tsamp.SamplingParams(temperature=0.9, top_k=30 * (i % 2),
                                              seed=10 + i, max_tokens=40))
            for i, p in enumerate(prompts)]

    def run(n_pages):
        engine = teng.NativeEngine(ct, tkv.CacheConfig(n_pages=n_pages, page_size=8,
                                                       max_pages_per_seq=12),
                                   max_batch_size=3, params=pt, device="cpu",
                                   decode_burst_steps=burst)
        return _tokens(_drive(engine, teng.Request, reqs)), engine

    tight, engine = run(15)
    assert engine.preemptions_total > 0
    assert tight == run(40)[0]


# -- the engine --------------------------------------------------------------------


def _drive(engine, make_request, requests, max_steps=400):
    """Add ``[(id, prompt, params)]`` and step until drained → {id: [out]}."""
    for rid, prompt, params in requests:
        engine.add_request(make_request(rid, prompt, params))
    outs: dict[str, list] = {}
    for _ in range(max_steps):
        if not engine.has_work():
            return outs
        for out in engine.step():
            outs.setdefault(out.request_id, []).append(out)
    raise AssertionError("engine did not drain")


def _tokens(outs):
    return {r: [(o.token, o.finish_reason) for o in v] for r, v in outs.items()}


def _prompts(vocab, lens=(9, 30, 17, 70)):
    return [[int(t) for t in np.random.default_rng(i).integers(3, vocab, n)]
            for i, n in enumerate(lens)]


SEEDED_BATCHES = {
    "greedy": [dict(temperature=0.0)] * 4,
    "top-k rows": [dict(temperature=0.8, top_k=40, seed=1),
                   dict(temperature=1.2, top_k=K, top_p=0.9, seed=2),
                   dict(temperature=0.0), dict(temperature=0.5, top_k=3, seed=3)],
    "penalties and min_tokens": [
        dict(temperature=0.0, repetition_penalty=1.3, presence_penalty=0.5),
        dict(temperature=0.9, top_k=20, frequency_penalty=0.4, seed=4),
        dict(temperature=0.0, min_tokens=6, stop_token_ids=(5, 9)),
        dict(temperature=0.7, top_k=8, seed=5)],
    "a min_p row beside top-k rows": [
        dict(temperature=0.8, top_k=30, seed=6), dict(temperature=0.8, min_p=0.05, seed=7),
        dict(temperature=0.0), dict(temperature=0.9, top_k=30, seed=8)],
}


@pytest.mark.parametrize("batch", list(SEEDED_BATCHES))
def test_seeded_streams_do_not_depend_on_the_batch(weights, batch):
    """Four requests decoding together, a long prompt chunked into fused
    steps beside the decode rows, against each request served alone:
    the same tokens, whatever kinds of rows share the batch."""
    _, ct, _, pt = weights
    prompts = _prompts(ct.vocab_size)
    reqs = [(f"r{i}", p, tsamp.SamplingParams(max_tokens=14, **kw))
            for i, (p, kw) in enumerate(zip(prompts, SEEDED_BATCHES[batch]))]

    def run(requests):
        engine = teng.NativeEngine(ct, tkv.CacheConfig(n_pages=40, page_size=16,
                                                       max_pages_per_seq=8),
                                   max_batch_size=4, params=pt, device="cpu",
                                   token_budget=24)
        return _tokens(_drive(engine, teng.Request, requests)), engine

    together, engine = run(reqs)
    assert engine.sched.fused_steps_total > 0
    for req in reqs:
        assert run([req])[0] == {req[0]: together[req[0]]}, req[0]


def _jax_pair(weights, requests, **kw):
    """``[(id, prompt, params kwargs)]`` through the JAX engine (its
    unfused sampler) and the port's → (jax outputs, port outputs)."""
    cj, ct, pj, pt = weights
    cc = dict(n_pages=40, page_size=16, max_pages_per_seq=8)
    je = jeng.NativeEngine(cj, jkv.CacheConfig(**cc), params=pj, max_batch_size=4,
                           fused_sampling=False, **kw)
    te = teng.NativeEngine(ct, tkv.CacheConfig(**cc), params=pt, device="cpu",
                           max_batch_size=4, **kw)
    ref = _drive(je, jeng.Request, [(r, p, jsamp.SamplingParams(**a))
                                    for r, p, a in requests])
    ours = _drive(te, teng.Request, [(r, p, tsamp.SamplingParams(**a))
                                     for r, p, a in requests])
    return ref, ours


@pytest.mark.parametrize("budget", [None, 24])
def test_logprobs_match_jax(weights, budget):
    """Greedy rows asking for logprobs 0, 3 and 5 beside one that does not
    (and, with a budget, a chunked prompt): the same tokens, each chosen
    token's logprob within LOGPROB_ATOL of JAX's, the same top ids with
    their logprobs within it; the first token's too (admission)."""
    prompts = _prompts(weights[0].vocab_size)
    reqs = [(f"r{i}", p, dict(temperature=0.0, max_tokens=10, logprobs=n))
            for i, (p, n) in enumerate(zip(prompts, (3, None, 0, 5)))]
    ref, ours = _jax_pair(weights, reqs, token_budget=budget)
    assert _tokens(ours) == _tokens(ref)
    for rid, outs in ours.items():
        n = dict((r, a["logprobs"]) for r, _, a in reqs)[rid]
        for a, b in zip(outs, ref[rid]):
            if n is None:
                assert a.logprob is None and a.top_logprobs is None
                continue
            assert abs(a.logprob - b.logprob) <= LOGPROB_ATOL
            if n == 0:
                assert a.top_logprobs is None and b.top_logprobs is None
                continue
            assert list(a.top_logprobs) == list(b.top_logprobs)
            np.testing.assert_allclose(list(a.top_logprobs.values()),
                                       list(b.top_logprobs.values()),
                                       atol=LOGPROB_ATOL, rtol=0)
            # greedy: the chosen token is the first of its top logprobs
            assert next(iter(a.top_logprobs)) == a.token


def test_logit_bias_greedy_streams_equal_jax(weights):
    """Biases that ban a row's greedy choices and force others, from the
    first token on (admission) and every decode step, beside an unbiased
    row and a penalized one: token-identical to the JAX engine."""
    prompts = _prompts(weights[0].vocab_size)
    _, plain = _jax_pair(weights, [("p", prompts[0], dict(temperature=0.0, max_tokens=8))])
    first = [o.token for o in plain["p"]]
    reqs = [("ban", prompts[0], dict(temperature=0.0, max_tokens=8,
                                      logit_bias=tuple((t, -100.0) for t in first[:3]))),
            ("force", prompts[1], dict(temperature=0.0, max_tokens=8,
                                        logit_bias=((77, 100.0),))),
            ("none", prompts[2], dict(temperature=0.0, max_tokens=8)),
            ("pen", prompts[3], dict(temperature=0.0, max_tokens=8, presence_penalty=0.7,
                                      logit_bias=((5, 2.5), (6, -1.0))))]
    ref, ours = _jax_pair(weights, reqs, token_budget=24)
    assert _tokens(ours) == _tokens(ref)
    assert not set(first[:3]) & {o.token for o in ours["ban"]}
    assert [o.token for o in ours["force"]] == [77] * 8


# -- the server --------------------------------------------------------------------


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


def _post(srv, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/completions",
        data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=30)


def test_server_parses_logprobs_and_logit_bias_like_jax(server):
    P = server._sampling_params
    assert P({"logprobs": 9}).logprobs == 5 and P({"logprobs": -2}).logprobs == 0
    assert P({"logprobs": 3}).logprobs == 3 and P({}).logprobs is None
    assert P({"logit_bias": {"5": 300, "7": -1e9, "9": 0.5}}).logit_bias == (
        (5, 100.0), (7, -100.0), (9, 0.5))
    for bad in ({"logit_bias": [1, 2]}, {"logit_bias": {"-1": 1.0}},
                {"logit_bias": {str(server.engine.cfg.vocab_size): 1.0}}):
        with pytest.raises(ValueError):
            P(bad)


def test_server_logprobs_object(server):
    """A blocking completion with ``logprobs: 3``: JAX's object, one entry
    per completion token, text-keyed tops of at most 3 whose best is the
    greedy token's own logprob; the SSE stream carries one entry per
    token chunk; a ``logit_bias`` of +100 on byte 'z' forces it."""
    body = {"prompt": "logprobs please", "max_tokens": 6, "temperature": 0.0,
            "logprobs": 3, "stop_token_ids": []}
    with _post(server, body) as resp:
        out = json.loads(resp.read())
    choice, n = out["choices"][0], out["usage"]["completion_tokens"]
    lp = choice["logprobs"]
    assert set(lp) == {"tokens", "token_logprobs", "top_logprobs", "text_offset"}
    assert len(lp["tokens"]) == len(lp["token_logprobs"]) == len(lp["top_logprobs"]) == n
    for chosen, tops in zip(lp["token_logprobs"], lp["top_logprobs"]):
        assert chosen <= 0.0 and 1 <= len(tops) <= 3
        assert max(tops.values()) == pytest.approx(chosen)
    with _post(server, {**body, "stream": True}) as resp:
        chunks = [json.loads(raw.decode()[6:]) for raw in resp
                  if raw.startswith(b"data: {")]
    streamed = [c["choices"][0] for c in chunks if "token_id" in c["choices"][0]]
    assert len(streamed) == n
    for c in streamed:
        assert len(c["logprobs"]["token_logprobs"]) == 1
        assert len(c["logprobs"]["top_logprobs"][0]) == 3
    z = ord("z") + 3  # ByteTokenizer: byte b is id b + 3
    with _post(server, {"prompt": "x", "max_tokens": 4, "temperature": 0.0,
                        "logit_bias": {str(z): 100}}) as resp:
        assert json.loads(resp.read())["choices"][0]["text"] == "zzzz"
