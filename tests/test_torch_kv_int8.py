"""int8 KV pages in the PyTorch port, held against the JAX package.

``kv_quantize`` must give the JAX package's codes and scales bit for
bit; the quantizing scatter must fill the pools as JAX ``_scatter_kv``
does; both ragged walks' plain versions on int8 pages must match the JAX
kernels (Pallas interpret mode) and the JAX oracle on the dequantized
pages; and the port's ``NativeEngine`` with ``kv_dtype="int8"`` must
stream the JAX engine's greedy tokens on float32 ``qwen3-tiny``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusioninfer_tpu.engine import engine as jeng
from fusioninfer_tpu.engine import kv_cache as jkv
from fusioninfer_tpu.engine import model_runner as jmr
from fusioninfer_tpu.engine import sampler as jsamp
from fusioninfer_tpu.models import config as jcfg
from fusioninfer_tpu.models import quantization as jquant
from fusioninfer_tpu.models import transformer as jtr
from fusioninfer_tpu.ops import paged_attention as jpa
from fusioninfer_tpu_torch.convert import params_from_jax
from fusioninfer_tpu_torch.engine import engine as teng
from fusioninfer_tpu_torch.engine import kv_cache as tkv
from fusioninfer_tpu_torch.engine import model_runner as tmr
from fusioninfer_tpu_torch.engine import sampler as tsamp
from fusioninfer_tpu_torch.models import config as tcfg
from fusioninfer_tpu_torch.models import quantization as tquant
from fusioninfer_tpu_torch.ops import dispatch
from fusioninfer_tpu_torch.ops import paged_attention as tpa

# f32 math on both sides over the same int8 codes and scales; the two
# frameworks sum in different orders and fold the scales at different
# points of the same product
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several test files per core: keep torch's intra-op
    pool to one thread for these small shapes, and restore it after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _zero_launches():
    dispatch.reset_launches()
    yield
    dispatch.reset_launches()


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("shape,dtype", [((4, 7, 64), "float32"),
                                         ((3, 2, 128), "bfloat16")])
def test_kv_quantize_bit_identical_to_jax(shape, dtype):
    x = np.random.default_rng(0).standard_normal(shape, dtype=np.float32) * 3
    x[0, 0] = 0.0  # an all-zero row takes the 1e-8 scale floor
    x[1, 0, :4] = [1.5, -2.5, 0.5, 127.0]  # ties round half to even
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    jq, js = jquant.kv_quantize(jx)
    tq, ts = tquant.kv_quantize(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))


def test_cache_config_pools_and_page_bytes_match_jax():
    with pytest.raises(ValueError, match="kv_dtype"):
        tkv.CacheConfig(kv_dtype="fp8").validate()
    for name in ("qwen3-tiny", "qwen3-8b"):
        jc, tc = jcfg.get_preset(name), tcfg.get_preset(name)
        for kv_dtype in ("model", "int8"):
            assert tkv.page_bytes(tc, 128, kv_dtype) == jkv.page_bytes(jc, 128, kv_dtype)
    jc, tc = jcfg.get_preset("qwen3-tiny"), tcfg.get_preset("qwen3-tiny")
    cc = dict(n_pages=9, page_size=16, max_pages_per_seq=4, kv_dtype="int8")
    jcache = jkv.init_kv_cache(jc, jkv.CacheConfig(**cc))
    tcache = tkv.init_kv_cache(tc, tkv.CacheConfig(**cc), "cpu")
    assert sorted(tcache) == sorted(jcache) == ["k", "k_scale", "v", "v_scale"]
    for key, arr in jcache.items():
        assert tuple(tcache[key].shape) == arr.shape
        assert str(tcache[key].dtype).removeprefix("torch.") == str(arr.dtype)
    auto = tkv.auto_cache_config(tc, 16, 64, 2, "cpu", "int8")
    assert auto.quantized and auto == tkv.CacheConfig(9, 16, 4, "int8")


@pytest.mark.parametrize("head_axis", [1, 2])
def test_int8_scatter_matches_jax(head_axis):
    """Prefill-shaped ([B, S, KV, Hd], head axis 2) and decode-shaped
    ([B, KV, Hd], head axis 1) writes into pools that already hold data:
    identical codes and scales, the untouched slots left as they were."""
    rng = np.random.default_rng(head_axis)
    L, KV, n_pages, ps, Hd = 2, 2, 9, 16, 64
    pools = {
        "k": rng.integers(-127, 128, (L, KV, n_pages, ps, Hd), dtype=np.int8),
        "v": rng.integers(-127, 128, (L, KV, n_pages, ps, Hd), dtype=np.int8),
        "k_scale": rng.random((L, KV, n_pages, 1, ps), dtype=np.float32),
        "v_scale": rng.random((L, KV, n_pages, 1, ps), dtype=np.float32),
    }
    lead = (3, 5) if head_axis == 2 else (4,)
    shape = lead + (KV, Hd)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    # one distinct (page, slot) per written token, as the engine's maps
    # give, the trash page's slots among them
    flat = rng.choice(n_pages * ps, size=int(np.prod(lead)), replace=False)
    flat[0] = n_pages * ps - 1
    page = (flat // ps).astype(np.int32).reshape(lead)
    slot = (flat % ps).astype(np.int32).reshape(lead)
    ref = jmr._scatter_kv({n: jnp.asarray(a) for n, a in pools.items()}, 1,
                          jnp.asarray(k), jnp.asarray(v), jnp.asarray(page),
                          jnp.asarray(slot), head_axis=head_axis)
    ours = {n: torch.from_numpy(a.copy()) for n, a in pools.items()}
    tmr._scatter_kv(ours, 1, torch.from_numpy(k), torch.from_numpy(v),
                    torch.from_numpy(page).long(), torch.from_numpy(slot).long(),
                    head_axis=head_axis)
    for name in pools:
        np.testing.assert_array_equal(_bits(ours[name].numpy()), _bits(ref[name]))


# the JAX suite's mixed fused-step shape: decode rows, a zero-length row,
# a spec window and a budgeted chunk (tests/test_paged_attention.py:203)
_MIXED = dict(q_lens=[1, 0, 3, 10, 1], starts=[37, 0, 20, 5, 63])


def _int8_ragged_inputs(q_lens, starts, KV=2, G=2, Hd=64, ps=16, n_pages=17,
                        mp=4, L=2, seed=0):
    """Flat ragged operands over a stacked int8 pool quantized from
    normal values by the JAX package's ``kv_quantize``."""
    rng = np.random.default_rng(seed)
    q_lens = np.asarray(q_lens, np.int32)
    starts = np.asarray(starts, np.int32)
    q_begins = np.concatenate([[0], np.cumsum(q_lens)[:-1]]).astype(np.int32)
    T = int(q_lens.sum())
    q = rng.standard_normal((T, KV * G, Hd), dtype=np.float32)
    k8, ks = jquant.kv_quantize(jnp.asarray(
        rng.standard_normal((L, KV, n_pages, ps, Hd), dtype=np.float32)))
    v8, vs = jquant.kv_quantize(jnp.asarray(
        rng.standard_normal((L, KV, n_pages, ps, Hd), dtype=np.float32)))
    tables = np.full((len(q_lens), mp), n_pages - 1, np.int32)
    perm = iter(rng.permutation(n_pages - 1))
    for r in range(len(q_lens)):
        need = -(-int(starts[r] + q_lens[r]) // ps) if q_lens[r] else 0
        for i in range(min(need, mp)):
            tables[r, i] = next(perm)
    live = np.zeros(T, bool)
    for b, n in zip(q_begins, q_lens):
        live[b:b + n] = True
    pages = tuple(np.array(a) for a in (k8, v8, ks[..., None, :], vs[..., None, :]))
    return q, pages, (tables, starts, q_begins, q_lens), live


def _dequant(pages, layer):
    k8, v8, ks, vs = pages
    return (k8[layer].astype(np.float32) * ks[layer, :, :, 0, :, None],
            v8[layer].astype(np.float32) * vs[layer, :, :, 0, :, None])


class TestInt8RaggedWalks:
    @pytest.mark.parametrize("split", [False, True])
    def test_plain_walks_match_jax_kernel(self, split):
        q, pages, desc, live = _int8_ragged_inputs(**_MIXED, seed=1)
        layer = 1
        k8, v8, ks, vs = (jnp.asarray(a) for a in pages)
        jdesc = [jnp.asarray(a) for a in desc]
        if split:
            ref = jpa.ragged_paged_attention_kvsplit(
                jnp.asarray(q), k8, v8, *jdesc, ks, vs, kv_splits=2,
                interpret=True, layer=layer)
            walk = tpa.reference_ragged_paged_attention_kvsplit
        else:
            ref = jpa.ragged_paged_attention(jnp.asarray(q), k8, v8, *jdesc, ks, vs,
                                             interpret=True, layer=layer)
            walk = tpa.reference_ragged_paged_attention
        tk8, tv8, tks, tvs = (torch.from_numpy(a[layer]) for a in pages)
        ours = walk(torch.from_numpy(q), tk8, tv8,
                    *(torch.from_numpy(a) for a in desc), tks, tvs).numpy()
        np.testing.assert_allclose(ours[live], np.asarray(ref)[live], atol=ATOL, rtol=0)
        assert not ours[~live].any()

    @pytest.mark.parametrize("window", [None, 24])
    @pytest.mark.parametrize("split", [False, True])
    def test_plain_walks_match_jax_oracle_on_dequantized_pages(self, window, split):
        """Folding the scales after the dot and into the probabilities is
        the same function as attention over the dequantized pages."""
        q, pages, desc, _ = _int8_ragged_inputs(**_MIXED, seed=2)
        kd, vd = _dequant(pages, 0)
        oracle = np.asarray(jpa.reference_ragged_paged_attention(
            jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd),
            *(jnp.asarray(a) for a in desc), window=window))
        walk = (tpa.reference_ragged_paged_attention_kvsplit if split
                else tpa.reference_ragged_paged_attention)
        tk8, tv8, tks, tvs = (torch.from_numpy(a[0]) for a in pages)
        ours = walk(torch.from_numpy(q), tk8, tv8,
                    *(torch.from_numpy(a) for a in desc), tks, tvs,
                    window=window).numpy()
        np.testing.assert_allclose(ours, oracle, atol=ATOL, rtol=0)

    @pytest.mark.parametrize("split", [False, True])
    def test_cpu_wrappers_route_to_plain_without_launch(self, split):
        q, pages, desc, _ = _int8_ragged_inputs(**_MIXED, seed=3)
        tq = torch.from_numpy(q)
        k8, v8, ks, vs = (torch.from_numpy(a) for a in pages)
        td = [torch.from_numpy(a) for a in desc]
        wrapper, plain = ((tpa.ragged_paged_attention_kvsplit,
                           tpa.reference_ragged_paged_attention_kvsplit) if split else
                          (tpa.ragged_paged_attention,
                           tpa.reference_ragged_paged_attention))
        out = wrapper(tq, k8, v8, *td, ks, vs, layer=1)
        torch.testing.assert_close(out, plain(tq, k8[1], v8[1], *td, ks[1], vs[1]),
                                   atol=0, rtol=0)
        assert dispatch.launches() == dict.fromkeys(dispatch.KERNELS, 0)

    def test_page_dtype_and_scales_go_together(self):
        q, pages, desc, _ = _int8_ragged_inputs(**_MIXED, seed=4)
        tq = torch.from_numpy(q)
        k8, v8, ks, vs = (torch.from_numpy(a) for a in pages)
        td = [torch.from_numpy(a) for a in desc]
        with pytest.raises(ValueError, match="need their f32 scales"):
            tpa.ragged_paged_attention(tq, k8, v8, *td, layer=0)
        with pytest.raises(ValueError, match="only int8"):
            tpa.ragged_paged_attention(tq, k8.float(), v8.float(), *td, ks, vs, layer=0)
        with pytest.raises(ValueError, match="go together"):
            tpa.ragged_paged_attention_kvsplit(tq, k8, v8, *td, ks, None, layer=0)


@pytest.fixture(scope="module")
def weights():
    cj = dataclasses.replace(jcfg.get_preset("qwen3-tiny"), dtype="float32")
    ct = dataclasses.replace(tcfg.get_preset("qwen3-tiny"), dtype="float32")
    pj = jtr.init_params(cj, jax.random.key(0))
    pt = params_from_jax(jax.tree.map(np.asarray, pj), ct, "cpu")
    return cj, ct, pj, pt


def _run(engine, make_request, make_params, prompts, max_steps=400):
    for i, p in enumerate(prompts):
        engine.add_request(make_request(f"r{i}", p, make_params()))
    streams: dict[str, list[int]] = {}
    for _ in range(max_steps):
        if not engine.has_work():
            break
        for out in engine.step():
            streams.setdefault(out.request_id, []).append(out.token)
    assert not engine.has_work(), "engine did not drain"
    return streams


@pytest.mark.parametrize("kv_splits,n_pages,lens", [
    (0, 64, (5, 17, 40, 90)),
    (8, 7, (5, 17, 40, 60)),
])
def test_int8_greedy_streams_identical_to_jax(weights, kv_splits, n_pages, lens):
    """int8 pages on both engines, the single walk without preemption and
    the split walk with it: n_pages=7 leaves 6 usable pages of 16 tokens,
    so the 60-token prompt waits and the 40-token one is preempted when
    its decode crosses a page boundary, then resumes from a re-prefill."""
    cj, ct, pj, pt = weights
    prompts = [[int(t) for t in np.random.default_rng(i).integers(3, cj.vocab_size, n)]
               for i, n in enumerate(lens)]
    cc = dict(n_pages=n_pages, page_size=16, max_pages_per_seq=min(7, n_pages - 1),
              kv_dtype="int8")
    je = jeng.NativeEngine(cj, jkv.CacheConfig(**cc), params=pj,
                           enable_prefix_caching=False, fused_step=False,
                           kv_splits=kv_splits)
    ref = _run(je, jeng.Request, lambda: jsamp.SamplingParams(
        temperature=0.0, max_tokens=12), prompts)
    te = teng.NativeEngine(ct, tkv.CacheConfig(**cc), params=pt, device="cpu",
                           kv_splits=kv_splits)
    assert te.cache["k"].dtype == torch.int8 and "k_scale" in te.cache
    ours = _run(te, teng.Request, lambda: tsamp.SamplingParams(
        temperature=0.0, max_tokens=12), prompts)
    assert ours == ref
    assert all(len(s) == 12 for s in ours.values())
    assert (te.preemptions_total > 0) == (je.preemptions_total > 0) == (n_pages == 7)
