"""Parity of the PyTorch port's attention ops with the JAX package.

The same numpy inputs go through the JAX kernels (Pallas interpret mode,
as the JAX package's own tests run them on the CPU) and their plain
oracles, and through the port's plain versions and CPU wrappers.  The
CUDA kernels themselves only run on the card (``chip_smoke.py``); here
the wrappers must route CPU tensors to the plain versions and leave the
launch counters at zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusioninfer_tpu.ops import masks as jmasks
from fusioninfer_tpu.ops import paged_attention as jpa
from fusioninfer_tpu.ops.flash_attention import flash_attention as jax_flash
from fusioninfer_tpu.ops.flash_attention import reference_attention as jax_attention
from fusioninfer_tpu_torch.ops import dispatch
from fusioninfer_tpu_torch.ops import flash_attention as tfa
from fusioninfer_tpu_torch.ops import masks as tmasks
from fusioninfer_tpu_torch.ops import paged_attention as tpa

# f32 inputs on both sides; the two frameworks sum in different orders
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


def _flash_inputs(B, S, H, KV, Hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, Hd), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, Hd), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, Hd), dtype=np.float32)
    return q, k, v


class TestFlashAttention:
    @pytest.mark.parametrize("S", [64, 128])
    @pytest.mark.parametrize("window", [None, 16])
    def test_plain_matches_jax_kernel_and_oracle(self, S, window):
        q, k, v = _flash_inputs(2, S, 4, 2, 64, seed=S + (window or 0))
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        kern = np.asarray(jax_flash(jq, jk, jv, causal=True, interpret=True,
                                    window=window))
        oracle = np.asarray(jax_attention(jq, jk, jv, window=window))
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        ours = tfa.reference_attention(tq, tk, tv, causal=True, window=window)
        assert ours.shape == (2, S, 4 * 64)
        np.testing.assert_allclose(ours.numpy(), kern, atol=ATOL, rtol=0)
        np.testing.assert_allclose(ours.numpy(), oracle, atol=ATOL, rtol=0)

    def test_cpu_wrapper_routes_to_plain_without_launch(self):
        q, k, v = (torch.from_numpy(a) for a in _flash_inputs(2, 64, 4, 2, 64, 3))
        out = tfa.flash_attention(q, k, v, causal=True, window=16)
        torch.testing.assert_close(
            out, tfa.reference_attention(q, k, v, causal=True, window=16),
            atol=0, rtol=0)
        assert dispatch.launches()["flash_attention"] == 0

    def test_attend_matches_jax(self):
        qp = np.arange(40)[:, None]
        kp = np.arange(40)[None, :]
        for window, causal in [(None, True), (7, True), (7, False)]:
            ours = tmasks.attend(torch.from_numpy(qp), torch.from_numpy(kp),
                                 window, causal=causal).numpy()
            ref = np.asarray(jmasks.attend(jnp.asarray(qp), jnp.asarray(kp),
                                           window, causal=causal))
            np.testing.assert_array_equal(ours, ref)


# the JAX suite's mixed fused-step shape: decode rows, a zero-length row,
# a spec window and a budgeted chunk (tests/test_paged_attention.py:203)
_MIXED = dict(q_lens=[1, 0, 3, 10, 1], starts=[37, 0, 20, 5, 63])


def _ragged_inputs(q_lens, starts, KV=2, G=2, Hd=64, ps=16, n_pages=17, mp=4,
                   L=2, seed=0):
    """Flat ragged operand set over a stacked [L, KV, n_pages, ps, Hd] pool;
    each row gets its own permuted pages."""
    rng = np.random.default_rng(seed)
    q_lens = np.asarray(q_lens, np.int32)
    starts = np.asarray(starts, np.int32)
    q_begins = np.concatenate([[0], np.cumsum(q_lens)[:-1]]).astype(np.int32)
    T = int(q_lens.sum())
    q = rng.standard_normal((T, KV * G, Hd), dtype=np.float32)
    kp = rng.standard_normal((L, KV, n_pages, ps, Hd), dtype=np.float32)
    vp = rng.standard_normal((L, KV, n_pages, ps, Hd), dtype=np.float32)
    tables = np.full((len(q_lens), mp), n_pages - 1, np.int32)
    perm = iter(rng.permutation(n_pages - 1))
    for r in range(len(q_lens)):
        need = -(-int(starts[r] + q_lens[r]) // ps) if q_lens[r] else 0
        for i in range(min(need, mp)):
            tables[r, i] = next(perm)
    live = np.zeros(T, bool)
    for b, n in zip(q_begins, q_lens):
        live[b:b + n] = True
    return (q, kp, vp, tables, starts, q_begins, q_lens), live


def _jax(args):
    return tuple(jnp.asarray(a) for a in args)


def _torch(args):
    return tuple(torch.from_numpy(a) for a in args)


class TestRaggedPagedAttention:
    def test_single_walk_plain_matches_jax_kernel(self):
        args, live = _ragged_inputs(**_MIXED, seed=1)
        q, kp, vp, *desc = args
        layer = 1
        ref = np.asarray(jpa.ragged_paged_attention(
            *_jax((q, kp, vp, *desc)), interpret=True, layer=layer))
        tq, tkp, tvp, *tdesc = _torch(args)
        ours = tpa.reference_ragged_paged_attention(
            tq, tkp[layer], tvp[layer], *tdesc).numpy()
        np.testing.assert_allclose(ours[live], ref[live], atol=ATOL, rtol=0)
        assert not ours[~live].any()  # tokens in no row are zeros

    @pytest.mark.parametrize("window", [None, 24])
    @pytest.mark.parametrize("split", [False, True])
    def test_plain_walks_match_jax_oracle(self, window, split):
        """Both plain walks against the JAX package's gathered-context
        oracle (windowed too), on every token."""
        args, _ = _ragged_inputs(**_MIXED, seed=1)
        q, kp, vp, *desc = args
        oracle = np.asarray(jpa.reference_ragged_paged_attention(
            *_jax((q, kp[1], vp[1], *desc)), window=window))
        tq, tkp, tvp, *tdesc = _torch(args)
        walk = (tpa.reference_ragged_paged_attention_kvsplit if split
                else tpa.reference_ragged_paged_attention)
        ours = walk(tq, tkp[1], tvp[1], *tdesc, window=window).numpy()
        np.testing.assert_allclose(ours, oracle, atol=ATOL, rtol=0)

    @pytest.mark.parametrize("kv_splits", [1, 2, 8])
    def test_split_walk_plain_matches_jax_kernel(self, kv_splits):
        args, live = _ragged_inputs(**_MIXED, seed=2)
        q, kp, vp, *desc = args
        layer = 1
        ref = np.asarray(jpa.ragged_paged_attention_kvsplit(
            *_jax((q, kp, vp, *desc)), kv_splits=kv_splits, interpret=True,
            layer=layer))
        tq, tkp, tvp, *tdesc = _torch(args)
        ours = tpa.reference_ragged_paged_attention_kvsplit(
            tq, tkp[layer], tvp[layer], *tdesc).numpy()
        np.testing.assert_allclose(ours[live], ref[live], atol=ATOL, rtol=0)
        assert not ours[~live].any()

    def test_split_partials_span_all_chunks(self):
        """Long rows over mp=16 pages (2 per chunk): every chunk holds
        keys, the partial walk and combine still match the single walk."""
        args, _ = _ragged_inputs(q_lens=[1, 5, 0, 1], starts=[250, 100, 0, 3],
                                 mp=16, n_pages=40, L=1, seed=3)
        q, kp, vp, *desc = _torch(args)
        acc, m, l = tpa.reference_kvsplit_partials(q, kp[0], vp[0], *desc)
        assert acc.shape == (tpa.KV_SPLIT_CHUNKS, q.shape[0], 2, 2, 64)
        assert torch.isfinite(m[:, 0]).all()  # the 251-token row fills all 8
        split = tpa.combine_kvsplit_partials(acc, m, l, q.dtype)
        single = tpa.reference_ragged_paged_attention(q, kp[0], vp[0], *desc)
        torch.testing.assert_close(split, single, atol=ATOL, rtol=0)
        aq, akp, avp, *adesc = args
        ref = np.asarray(jpa.reference_ragged_paged_attention(
            *_jax((aq, akp[0], avp[0], *adesc))))
        np.testing.assert_allclose(split.numpy(), ref, atol=ATOL, rtol=0)

    @pytest.mark.parametrize("split", [False, True])
    def test_cpu_wrappers_route_to_plain_without_launch(self, split):
        args, _ = _ragged_inputs(**_MIXED, seed=4)
        q, kp, vp, *desc = _torch(args)
        if split:
            out = tpa.ragged_paged_attention_kvsplit(q, kp, vp, *desc, layer=1)
            ref = tpa.reference_ragged_paged_attention_kvsplit(q, kp[1], vp[1], *desc)
        else:
            out = tpa.ragged_paged_attention(q, kp, vp, *desc, layer=1)
            ref = tpa.reference_ragged_paged_attention(q, kp[1], vp[1], *desc)
        torch.testing.assert_close(out, ref, atol=0, rtol=0)
        assert dispatch.launches() == dict.fromkeys(dispatch.KERNELS, 0)

    def test_stacked_pool_requires_layer(self):
        args, _ = _ragged_inputs(**_MIXED, seed=5)
        q, kp, vp, *desc = _torch(args)
        with pytest.raises(ValueError, match="require layer"):
            tpa.ragged_paged_attention(q, kp, vp, *desc)
        with pytest.raises(ValueError, match="only applies"):
            tpa.ragged_paged_attention(q, kp[0], vp[0], *desc, layer=0)

    def test_token_rows_match_jax(self):
        q_begins = np.asarray([0, 1, 1, 4, 14], np.int32)
        q_lens = np.asarray([1, 0, 3, 10, 1], np.int32)
        ours = tpa.ragged_token_rows(torch.from_numpy(q_begins),
                                     torch.from_numpy(q_lens), 17)
        ref = jpa.ragged_token_rows(jnp.asarray(q_begins), jnp.asarray(q_lens), 17)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    @pytest.mark.parametrize("mp,ps", [(16, 128), (32, 128), (64, 64), (2, 16)])
    def test_kv_split_heuristic_matches_jax(self, mp, ps):
        assert tpa.pick_kv_splits(mp, ps) == jpa.pick_kv_splits(mp, ps)
        assert (tpa.RAGGED_BLOCK_Q, tpa.KV_SPLIT_CHUNKS, tpa.KV_SPLIT_MIN_CTX_TOKENS) == (
            jpa.RAGGED_BLOCK_Q, jpa.KV_SPLIT_CHUNKS, jpa.KV_SPLIT_MIN_CTX_TOKENS)


def test_dispatch_refuses_mixed_or_unknown_devices():
    cpu = torch.zeros(2)
    meta = torch.zeros(2, device="meta")
    assert dispatch.use_kernel(cpu) is False
    with pytest.raises(ValueError, match="expected all cuda or all cpu"):
        dispatch.use_kernel(cpu, meta)
