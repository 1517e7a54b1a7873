"""Parity of the PyTorch port's model and model runner with the JAX package.

Weights come from the JAX package's ``init_params`` and cross over as
numpy arrays through ``convert.params_from_jax``; token inputs come from
one numpy generator.  Everything runs in float32 on the CPU, where the
port's attention is its plain PyTorch version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusioninfer_tpu.engine import kv_cache as jkv
from fusioninfer_tpu.engine import model_runner as jmr
from fusioninfer_tpu.models import config as jcfg
from fusioninfer_tpu.models import transformer as jtr
from fusioninfer_tpu_torch.convert import params_from_jax
from fusioninfer_tpu_torch.engine import kv_cache as tkv
from fusioninfer_tpu_torch.engine import model_runner as tmr
from fusioninfer_tpu_torch.models import config as tcfg
from fusioninfer_tpu_torch.models import transformer as ttr

# f32 end to end; two layers of f32 matmuls summed in different orders
LOGITS_ATOL = 1e-4
KV_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several test files per core: keep torch's intra-op
    pool to one thread for these small shapes, and restore it after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    cj = dataclasses.replace(jcfg.get_preset("qwen3-tiny"), dtype="float32")
    ct = dataclasses.replace(tcfg.get_preset("qwen3-tiny"), dtype="float32")
    pj = jtr.init_params(cj, jax.random.key(0))
    pt = params_from_jax(jax.tree.map(np.asarray, pj), ct, "cpu")
    return cj, ct, pj, pt


def test_presets_match_jax():
    for name in ("qwen3-tiny", "qwen3-8b"):
        a = dataclasses.asdict(jcfg.get_preset(name))
        b = dataclasses.asdict(tcfg.get_preset(name))
        for key in b:
            assert a[key] == b[key], (name, key)
    assert tcfg.get_preset("qwen3-8b").torch_dtype == torch.bfloat16


def test_moe_configs_refused():
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        tcfg.ModelConfig(name="moe", n_experts=4).validate()


def test_params_from_jax_carries_bf16_tree_exactly():
    cj = jcfg.get_preset("qwen3-tiny")
    ct = tcfg.get_preset("qwen3-tiny")
    pj = jtr.init_params(cj, jax.random.key(1))
    pt = params_from_jax(jax.tree.map(np.asarray, pj), ct, "cpu")
    assert pt["layers"]["wq"].dtype == torch.bfloat16
    for name, w in pj["layers"].items():
        np.testing.assert_array_equal(
            pt["layers"][name].float().numpy(), np.asarray(w, np.float32))
    np.testing.assert_array_equal(pt["embed"].float().numpy(),
                                  np.asarray(pj["embed"], np.float32))


def test_init_params_shapes_match_jax():
    cfg = tcfg.get_preset("qwen3-tiny")
    pt = ttr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.eval_shape(lambda: jtr.init_params(jcfg.get_preset("qwen3-tiny"),
                                                    jax.random.key(0)))
    assert tuple(pt["embed"].shape) == shapes["embed"].shape
    assert {k: tuple(v.shape) for k, v in pt["layers"].items()} == {
        k: v.shape for k, v in shapes["layers"].items()}


def test_rms_norm_and_rope_match_jax():
    # f32 values up to ~8: a few ulps (9.5e-7 each) of rounding apart
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 64), dtype=np.float32)
    w = rng.standard_normal((64,), dtype=np.float32)
    pos = rng.integers(0, 4000, (2, 7))
    np.testing.assert_allclose(
        ttr.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        np.asarray(jtr.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        atol=4e-6, rtol=0)
    np.testing.assert_allclose(
        ttr.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(jtr.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        atol=2e-5, rtol=0)


def test_full_forward_logits_match_jax(models):
    cj, ct, pj, pt = models
    toks = np.random.default_rng(0).integers(0, cj.vocab_size, (2, 40))
    ref = np.asarray(jtr.forward(cj, pj, jnp.asarray(toks)))
    ours = ttr.forward(ct, pt, torch.from_numpy(toks)).numpy()
    assert ours.shape == (2, 40, cj.vocab_size)
    np.testing.assert_allclose(ours, ref, atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("kv_splits", [0, 8])
def test_prefill_then_decode_match_jax(models, kv_splits):
    """Prefill two prompts into their pages, then three decode steps fed
    with JAX's greedy tokens: logits and pool contents agree."""
    cj, ct, pj, pt = models
    n_pages, ps, mp = 16, 16, 8
    jcc = jkv.CacheConfig(n_pages=n_pages, page_size=ps, max_pages_per_seq=mp)
    tcc = tkv.CacheConfig(n_pages=n_pages, page_size=ps, max_pages_per_seq=mp)
    rng = np.random.default_rng(1)
    lens = np.asarray([20, 33], np.int32)
    S = tmr.pick_bucket(tmr.prefill_buckets(tcc.max_len), int(lens.max()))
    assert S == jmr.pick_bucket(jmr.prefill_buckets(jcc.max_len), int(lens.max()))
    toks = np.zeros((2, S), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(3, cj.vocab_size, n)
    rows = np.full((2, mp), n_pages - 1, np.int32)
    rows[0, :4] = [3, 0, 9, 4]
    rows[1, :4] = [7, 12, 1, 5]

    jcache = jkv.init_kv_cache(cj, jcc)
    jcache, jlog = jmr.prefill(cj, jcc, pj, jcache, jnp.asarray(toks),
                               jnp.asarray(lens), jnp.asarray(rows))
    tcache = tkv.init_kv_cache(ct, tcc, "cpu")
    tlog = tmr.prefill(ct, tcc, pt, tcache, torch.from_numpy(toks).long(),
                       torch.from_numpy(lens).long(), torch.from_numpy(rows).long())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGITS_ATOL, rtol=0)

    positions = lens.copy()
    active = np.asarray([True, True])
    nxt = np.asarray(jlog).argmax(-1).astype(np.int32)
    for _ in range(3):
        jcache, jlog = jmr.decode_step(cj, jcc, pj, jcache, jnp.asarray(nxt),
                                       jnp.asarray(positions), jnp.asarray(rows),
                                       jnp.asarray(active))
        tlog = tmr.decode_step(ct, tcc, pt, tcache, torch.from_numpy(nxt).long(),
                               torch.from_numpy(positions), torch.from_numpy(rows),
                               torch.from_numpy(active), kv_splits=kv_splits)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGITS_ATOL, rtol=0)
        nxt = np.asarray(jlog).argmax(-1).astype(np.int32)
        positions = positions + 1
    for name in ("k", "v"):
        # the trash page takes colliding padding writes in either order
        ours = tcache[name].numpy()[:, :, : n_pages - 1]
        ref = np.asarray(jcache[name])[:, :, : n_pages - 1]
        np.testing.assert_allclose(ours, ref, atol=KV_ATOL, rtol=0)
    # row 1's third page holds its prompt tail: written, not left zero
    assert np.abs(tcache["k"].numpy()[:, :, rows[1, 2]]).sum() > 0
