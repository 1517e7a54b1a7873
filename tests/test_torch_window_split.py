"""The query-window kernel's key split against the JAX package.

The kernel behind ``paged_verify_attention`` and ``paged_prefill_attention``
cuts each window's keys into fixed chunks of ``WINDOW_CHUNK`` positions and
folds per-chunk f32 partials left to right with the split walk's combine.
Its plain version is ``reference_window_partials``; here those partials,
folded by ``combine_kvsplit_partials``, are held against the JAX
``paged_verify_attention`` (Pallas interpret mode, as the JAX package's own
tests run it on the CPU) and its gathered oracle, on float32 pages holding
bfloat16 values and on int8 pages with scales, for chunks that divide the
key range, that do not, and that are larger than it, with and without a
sliding window, and with an inactive slot and padding rows.  The
wrapper's scratch holds exactly the chunks the plain partials show a live
sequence seeing.  The CUDA
kernel's own partials and combine are held against the same plain version
on the card (``chip_smoke.py``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusioninfer_tpu.models import quantization as jquant
from fusioninfer_tpu.ops import paged_attention as jpa
from fusioninfer_tpu_torch.ops import _build
from fusioninfer_tpu_torch.ops import paged_attention as tpa

# f32 math on both sides; the two frameworks sum in different orders (the
# tolerance of tests/test_torch_paged_kernels.py)
ATOL = 2e-5

KV, G, HD, PS, MP = 2, 2, 64, 16, 6  # 96 key positions per sequence
N_PAGES = 3 * MP + 1
STARTS = np.array([60, 7, 30], np.int32)
COUNTS = np.array([8, 0, 5], np.int32)  # full, inactive, padding rows
C = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several test files per core: keep torch's intra-op
    pool to one thread for these small shapes, and restore it after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(kind: str, seed: int):
    """q, (k, v, k_scales, v_scales) and page tables as numpy: float32
    pages holding bfloat16 values, or int8 codes with f32 scales ``[KV,
    n_pages, 1, ps]`` from the JAX package's ``kv_quantize``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, C, KV * G, HD), dtype=np.float32)
    shape = (KV, N_PAGES, PS, HD)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    tables = rng.permutation(N_PAGES - 1)[:3 * MP].reshape(3, MP).astype(np.int32)
    if kind == "bfloat16":
        k, v = (np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
                for a in (k, v))
        return q, (k, v, None, None), tables
    k8, ks = jquant.kv_quantize(jnp.asarray(k))
    v8, vs = jquant.kv_quantize(jnp.asarray(v))
    return (q, (np.array(k8), np.array(v8), np.array(ks)[..., None, :],
                np.array(vs)[..., None, :]), tables)


def _split(q, pages, tables, window, chunk):
    """The port's plain partials, folded → ``[B, C, H·Hd]`` as numpy."""
    k, v, ks, vs = (None if a is None else torch.from_numpy(a) for a in pages)
    tq = torch.from_numpy(q)
    acc, m, l = tpa.reference_window_partials(
        tq, k, v, torch.from_numpy(tables), torch.from_numpy(STARTS),
        torch.from_numpy(COUNTS), ks, vs, window=window, chunk=chunk)
    out = tpa.combine_kvsplit_partials(acc, m, l, tq.dtype)
    return out.reshape(q.shape[0], C, -1).numpy(), (acc, m, l)


def _oracle(q, pages, tables, window):
    """The JAX gathered oracle over f32 (int8: dequantized) pages."""
    k, v, ks, vs = pages
    if ks is not None:
        k = k.astype(np.float32) * ks[:, :, 0, :, None]
        v = v.astype(np.float32) * vs[:, :, 0, :, None]
    return np.asarray(jpa.reference_paged_verify_attention(
        *(jnp.asarray(a) for a in (q, k, v, tables, STARTS, COUNTS)), window=window))


# 16 divides the 96 key positions, 40 does not, 4096 is larger than them
CHUNKS = [16, 40, 4096]


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_folded_partials_match_jax_oracle(kind, window, chunk):
    q, pages, tables = _case(kind, seed=chunk + (window or 0))
    ours, (acc, m, l) = _split(q, pages, tables, window, chunk)
    n = -(-(MP * PS) // chunk)
    assert acc.shape == (n, 3 * C, KV, G, HD) and m.shape == l.shape == (n, 3 * C, KV, G)
    np.testing.assert_allclose(ours, _oracle(q, pages, tables, window), atol=ATOL, rtol=0)
    live = (np.arange(C)[None, :] < COUNTS[:, None]).reshape(-1)
    assert not ours.reshape(3 * C, -1)[~live].any()
    # a padding row is (0, -inf, 0) in every chunk
    assert torch.isneginf(m[:, torch.from_numpy(~live)]).all()
    assert not l[:, torch.from_numpy(~live)].any() and not acc[:, torch.from_numpy(~live)].any()


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
@pytest.mark.parametrize("window", [None, 12])
def test_folded_partials_match_jax_kernel(kind, window):
    """The Pallas kernel itself (interpret mode) on the live rows, with
    a chunk that splits every window of the batch."""
    q, (k, v, ks, vs), tables = _case(kind, seed=99 + (window or 0))
    page_dtype = jnp.int8 if kind == "int8" else jnp.float32
    args = [jnp.asarray(q), jnp.asarray(k).astype(page_dtype),
            jnp.asarray(v).astype(page_dtype),
            *(jnp.asarray(a) for a in (tables, STARTS, COUNTS))]
    if ks is not None:
        args += [jnp.asarray(ks), jnp.asarray(vs)]
    ref = np.asarray(jpa.paged_verify_attention(*args, interpret=True, window=window))
    ours, _ = _split(q, (k, v, ks, vs), tables, window, chunk=24)
    live = np.arange(C)[None, :] < COUNTS[:, None]
    np.testing.assert_allclose(ours[live], ref[live], atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_result_does_not_depend_on_the_chunking(kind):
    q, pages, tables = _case(kind, seed=7)
    outs = [_split(q, pages, tables, 12, chunk)[0] for chunk in CHUNKS]
    for other in outs[1:]:
        np.testing.assert_allclose(other, outs[0], atol=ATOL, rtol=0)


def test_window_chunk_matches_the_kernel():
    """The wrapper sizes the partials' scratch by WINDOW_CHUNK; the kernel
    cuts keys by its CHUNK."""
    src = (_build.CSRC / "paged_window_attention.cu").read_text()
    m = re.search(r"constexpr int CHUNK = (\d+);", src)
    assert m and int(m.group(1)) == tpa.WINDOW_CHUNK


# (starts, counts, window) over 3072 keys of 1024-key chunks: ranges over
# one, two and three chunks in one batch; a window that lifts a range's
# first chunk; a window across one boundary; inactive slots only
SLOT_CASES = [([2990, 500, 1500], [8, 8, 5], None),
              ([2990, 500, 1500], [8, 8, 5], 1500),
              ([1020, 3000, 0], [8, 0, 1], 100),
              ([700, 40, 9], [0, 0, 0], None)]


@pytest.mark.parametrize("starts,counts,window", SLOT_CASES)
def test_split_scratch_holds_every_live_chunk(starts, counts, window):
    """The wrapper's scratch slots per sequence are exactly the most
    chunks that the plain partials show any live sequence seeing, from
    its first seen chunk to its last; ints (a suffix prefill's start and
    true_len) give the same count as tensors."""
    ps, mp, hd = 128, 24, 16
    rng = np.random.default_rng(len(starts) + (window or 0))
    B = len(starts)
    q = torch.from_numpy(rng.standard_normal((B, C, 2, hd), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, B * mp, ps, hd), dtype=np.float32))
            for _ in range(2))
    tables = torch.arange(B * mp, dtype=torch.int32).reshape(B, mp)
    st, ct = (torch.tensor(x, dtype=torch.int32) for x in (starts, counts))
    _, m, _ = tpa.reference_window_partials(q, k, v, tables, st, ct, window=window)
    seen = torch.isfinite(m).reshape(-1, B, C * 2).any(dim=-1)  # [n chunks, B]
    need = [1] * B  # a sequence that sees nothing needs no more than one slot
    for b in range(B):
        ix = seen[:, b].nonzero()[:, 0]
        if ix.numel():
            need[b] = int(ix[-1] - ix[0]) + 1
    n = tpa._window_chunks(st, ct, C, mp * ps, window)
    assert n == max(need)
    assert n <= -(-(mp * ps) // tpa.WINDOW_CHUNK)
    if window:
        assert n <= -(-(window + C) // tpa.WINDOW_CHUNK) + 1
    for b in range(B):
        assert tpa._window_chunks(starts[b], counts[b], C, mp * ps, window) == need[b]
