"""The port's paged decode, suffix prefill and verify against the JAX package.

The same numpy inputs go through the JAX kernels (Pallas interpret mode,
as the JAX package's own tests run them on the CPU) and their gathered
oracles, and through the port's plain versions and CPU wrappers, on
float32 and bfloat16 pages and on int8 pages with scales.  Rows the JAX
kernels leave unspecified (padding past ``counts``/``true_len``) are
compared against the oracles only, which zero them like the port.  The
CUDA kernels themselves run on the card (``chip_smoke.py``); here the
wrappers must route CPU tensors to the plain versions without a launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusioninfer_tpu.models import quantization as jquant
from fusioninfer_tpu.ops import paged_attention as jpa
from fusioninfer_tpu_torch.ops import dispatch
from fusioninfer_tpu_torch.ops import paged_attention as tpa

# f32 inputs on both sides; the two frameworks sum in different orders
ATOL = 2e-5
# bf16 inputs and outputs: one bf16 ulp of an O(1) output is 2^-8, and
# the two sides round the probabilities at different points
BF16_ATOL = 2e-2

KV, G, HD, PS, N_PAGES, MP = 2, 2, 64, 16, 17, 4


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


def _pages(rng, kind: str, L: int = 1):
    """(k, v, k_scales, v_scales) numpy pools ``[L, KV, n_pages, ps, Hd]``:
    float32, bfloat16-valued float32, or int8 codes with f32 scales
    ``[L, KV, n_pages, 1, ps]`` from the JAX package's ``kv_quantize``."""
    shape = (L, KV, N_PAGES, PS, HD)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    if kind == "float32":
        return k, v, None, None
    if kind == "bfloat16":
        return (np.array(jnp.asarray(k).astype(jnp.bfloat16).astype(jnp.float32)),
                np.array(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32)),
                None, None)
    k8, ks = jquant.kv_quantize(jnp.asarray(k))
    v8, vs = jquant.kv_quantize(jnp.asarray(v))
    return (np.array(k8), np.array(v8), np.array(ks)[..., None, :],
            np.array(vs)[..., None, :])


def _tables(rng, B: int) -> np.ndarray:
    return rng.permutation(N_PAGES - 1)[:B * MP].reshape(B, MP).astype(np.int32)


def _dequant(pages, layer: int):
    """The oracle's view: f32 pages of one layer, int8 ones dequantized."""
    k, v, ks, vs = pages
    if ks is None:
        return k[layer], v[layer]
    return (k[layer].astype(np.float32) * ks[layer, :, :, 0, :, None],
            v[layer].astype(np.float32) * vs[layer, :, :, 0, :, None])


def _jax_call(fn, q, pages, rest, kind, layer, **kw):
    """The JAX kernel on the stacked pool, in the working dtype."""
    dtype = jnp.bfloat16 if kind == "bfloat16" else jnp.float32
    k, v, ks, vs = pages
    page_dtype = jnp.int8 if kind == "int8" else dtype
    args = [jnp.asarray(q).astype(dtype), jnp.asarray(k).astype(page_dtype),
            jnp.asarray(v).astype(page_dtype), *(jnp.asarray(a) for a in rest)]
    if ks is not None:
        args += [jnp.asarray(ks), jnp.asarray(vs)]
    out = fn(*args, interpret=True, layer=layer, **kw)
    return np.asarray(out.astype(jnp.float32))


def _torch_pages(pages, kind):
    dtype = torch.bfloat16 if kind == "bfloat16" else None
    out = []
    for a in pages:
        t = None if a is None else torch.from_numpy(a)
        out.append(t.to(dtype) if t is not None and dtype is not None else t)
    return out


def _tol(kind):
    return BF16_ATOL if kind == "bfloat16" else ATOL


KINDS = ["float32", "bfloat16", "int8"]


class TestPagedDecode:
    @pytest.mark.parametrize("kind", KINDS)
    def test_plain_matches_jax_kernel_and_oracle(self, kind):
        """Three sequences, one inactive (length 0): its row is zeros."""
        rng = np.random.default_rng(1)
        pages = _pages(rng, kind, L=2)
        B = 3
        q = rng.standard_normal((B, KV * G, HD), dtype=np.float32)
        tables = _tables(rng, B)
        lengths = np.array([37, 0, 64], np.int32)
        ref = _jax_call(jpa.paged_decode_attention, q, pages, (tables, lengths),
                        kind, layer=1)
        kd, vd = _dequant(pages, 1)
        oracle = np.asarray(jpa.reference_paged_attention(
            *(jnp.asarray(a) for a in (q, kd, vd, tables, lengths))))
        tk, tv, tks, tvs = _torch_pages(pages, kind)
        tq = torch.from_numpy(q).to(tk.dtype if kind == "bfloat16" else torch.float32)
        ours = tpa.reference_paged_attention(
            tq, tk[1], tv[1], torch.from_numpy(tables), torch.from_numpy(lengths),
            None if tks is None else tks[1], None if tvs is None else tvs[1])
        ours = ours.float().numpy()
        assert ours.shape == (B, KV * G * HD)
        np.testing.assert_allclose(ours, ref, atol=_tol(kind), rtol=0)
        np.testing.assert_allclose(ours, oracle, atol=_tol(kind), rtol=0)
        assert not ours[1].any()

    @pytest.mark.parametrize("kind", ["float32", "int8"])
    def test_sliding_window_matches_jax(self, kind):
        rng = np.random.default_rng(2)
        pages = _pages(rng, kind)
        q = rng.standard_normal((2, KV * G, HD), dtype=np.float32)
        tables = _tables(rng, 2)
        lengths = np.array([50, 9], np.int32)
        ref = _jax_call(jpa.paged_decode_attention, q, pages, (tables, lengths),
                        kind, layer=0, window=20)
        tk, tv, tks, tvs = _torch_pages(pages, kind)
        ours = tpa.paged_decode_attention(
            torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(lengths), tks, tvs, window=20, layer=0).numpy()
        np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
        assert dispatch.launches() == dict.fromkeys(dispatch.KERNELS, 0)


class TestPagedVerify:
    @pytest.mark.parametrize("kind", KINDS)
    def test_plain_matches_jax_kernel_and_oracle(self, kind):
        """Windows of 8 queries: one full, one inactive (count 0), one
        with padding rows past its count (zeros, like the oracle's)."""
        rng = np.random.default_rng(3)
        pages = _pages(rng, kind)
        B, C = 3, 8
        q = rng.standard_normal((B, C, KV * G, HD), dtype=np.float32)
        tables = _tables(rng, B)
        starts = np.array([20, 5, 40], np.int32)
        counts = np.array([8, 0, 3], np.int32)
        ref = _jax_call(jpa.paged_verify_attention, q, pages,
                        (tables, starts, counts), kind, layer=0)
        kd, vd = _dequant(pages, 0)
        oracle = np.asarray(jpa.reference_paged_verify_attention(
            *(jnp.asarray(a) for a in (q, kd, vd, tables, starts, counts))))
        tk, tv, tks, tvs = _torch_pages(pages, kind)
        tq = torch.from_numpy(q).to(tk.dtype if kind == "bfloat16" else torch.float32)
        ours = tpa.reference_paged_verify_attention(
            tq, tk[0], tv[0], *(torch.from_numpy(a) for a in (tables, starts, counts)),
            None if tks is None else tks[0], None if tvs is None else tvs[0])
        ours = ours.float().numpy()
        live = np.arange(C)[None, :] < counts[:, None]
        np.testing.assert_allclose(ours[live], ref[live], atol=_tol(kind), rtol=0)
        np.testing.assert_allclose(ours, oracle, atol=_tol(kind), rtol=0)
        assert not ours[~live].any()

    @pytest.mark.parametrize("kind", ["float32", "int8"])
    def test_sliding_window_and_wrapper_match_jax(self, kind):
        rng = np.random.default_rng(4)
        pages = _pages(rng, kind, L=2)
        B, C = 2, 4
        q = rng.standard_normal((B, C, KV * G, HD), dtype=np.float32)
        tables = _tables(rng, B)
        starts = np.array([44, 2], np.int32)
        counts = np.array([4, 2], np.int32)
        ref = _jax_call(jpa.paged_verify_attention, q, pages,
                        (tables, starts, counts), kind, layer=1, window=24)
        tk, tv, tks, tvs = _torch_pages(pages, kind)
        ours = tpa.paged_verify_attention(
            torch.from_numpy(q), tk, tv,
            *(torch.from_numpy(a) for a in (tables, starts, counts)), tks, tvs,
            window=24, layer=1).numpy()
        live = np.arange(C)[None, :] < counts[:, None]
        np.testing.assert_allclose(ours[live], ref[live], atol=ATOL, rtol=0)
        assert not ours[~live].any()
        assert dispatch.launches() == dict.fromkeys(dispatch.KERNELS, 0)


class TestPagedPrefill:
    @pytest.mark.parametrize("kind", KINDS)
    def test_plain_matches_jax_kernel_and_oracle(self, kind):
        """A 16-query suffix at position 20 with 11 real rows."""
        rng = np.random.default_rng(5)
        pages = _pages(rng, kind)
        C, start, true_len = 16, 20, 11
        q = rng.standard_normal((C, KV * G, HD), dtype=np.float32)
        page_row = _tables(rng, 1)[0]
        ref = _jax_call(jpa.paged_prefill_attention, q, pages,
                        (page_row, start, true_len), kind, layer=0)
        kd, vd = _dequant(pages, 0)
        oracle = np.asarray(jpa.reference_paged_prefill_attention(
            jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd), jnp.asarray(page_row),
            start, true_len))
        tk, tv, tks, tvs = _torch_pages(pages, kind)
        tq = torch.from_numpy(q).to(tk.dtype if kind == "bfloat16" else torch.float32)
        ours = tpa.reference_paged_prefill_attention(
            tq, tk[0], tv[0], torch.from_numpy(page_row), start, true_len,
            None if tks is None else tks[0], None if tvs is None else tvs[0])
        ours = ours.float().numpy()
        np.testing.assert_allclose(ours[:true_len], ref[:true_len], atol=_tol(kind), rtol=0)
        np.testing.assert_allclose(ours, oracle, atol=_tol(kind), rtol=0)
        assert not ours[true_len:].any()

    @pytest.mark.parametrize("kind", ["float32", "int8"])
    def test_sliding_window_and_wrapper_match_jax(self, kind):
        rng = np.random.default_rng(6)
        pages = _pages(rng, kind, L=2)
        C, start, true_len = 8, 30, 8
        q = rng.standard_normal((C, KV * G, HD), dtype=np.float32)
        page_row = _tables(rng, 1)[0]
        ref = _jax_call(jpa.paged_prefill_attention, q, pages,
                        (page_row, start, true_len), kind, layer=1, window=12)
        tk, tv, tks, tvs = _torch_pages(pages, kind)
        ours = tpa.paged_prefill_attention(
            torch.from_numpy(q), tk, tv, torch.from_numpy(page_row),
            torch.tensor(start), true_len, tks, tvs, window=12, layer=1).numpy()
        np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
        assert dispatch.launches() == dict.fromkeys(dispatch.KERNELS, 0)


def test_prefill_is_verify_of_one_sequence():
    """The port serves suffix prefill with the verify kernel at a batch of
    one: the plain versions agree bit for bit, so the kernel's contract
    holds for both."""
    rng = np.random.default_rng(7)
    k, v, _, _ = (torch.from_numpy(a[0]) if a is not None else None
                  for a in _pages(rng, "float32"))
    q = torch.from_numpy(rng.standard_normal((8, KV * G, HD), dtype=np.float32))
    row = torch.from_numpy(_tables(rng, 1)[0])
    pre = tpa.reference_paged_prefill_attention(q, k, v, row, 10, 5, window=7)
    ver = tpa.reference_paged_verify_attention(
        q[None], k, v, row[None], torch.tensor([10]), torch.tensor([5]), window=7)
    torch.testing.assert_close(pre, ver[0], atol=0, rtol=0)
