"""The split walk's cluster ranks against the JAX package.

On the card, the split walk (``ragged_paged_attention_kvsplit``) runs one
thread-block cluster of ``KV_SPLIT_CHUNKS`` = 8 blocks per (token, KV
head): rank ``c`` walks virtual chunk ``c``, the ``ceil(mp / 8)`` pages
from page ``c·ceil(mp / 8)`` of the row's table cut to the keys the token
sees (``cluster_key_ranges`` with ``chunk_pages``, the host mirror of the
kernel's arithmetic), and the ranks' f32 ``(acc, m, l)`` are folded left
to right from rank 0.  Here the mirror's ranges are held against the
chunks of ``reference_kvsplit_partials`` (tables of 5, 13 and 32 pages:
ranks past the table, an empty last rank; windows that start mid-page and
mid-chunk), the per-rank plain partials over those ranges against
``reference_kvsplit_partials`` (the statistics bit for bit), and the partials folded by
``combine_kvsplit_partials`` against the JAX ``ragged_paged_attention_
kvsplit`` (Pallas interpret mode, as the JAX package's own tests run it on
the CPU) at every ``kv_splits`` it takes, on float32 pages holding
bfloat16 values and on int8 pages with scales, at G 1, 2, 4, 8 and Hd 64,
128, with an inert row and padding tokens.  A faked launch pins what the
wrapper hands the C entry.  The CUDA kernel itself is held against the
plain version on the card (``chip_smoke.py``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusioninfer_tpu.models import quantization as jquant
from fusioninfer_tpu.ops import paged_attention as jpa
from fusioninfer_tpu_torch.ops import _build, dispatch
from fusioninfer_tpu_torch.ops import paged_attention as tpa

# f32 math on both sides; the two frameworks sum in different orders (the
# tolerance of tests/test_torch_paged_kernels.py)
ATOL = 2e-5
C = tpa.KV_SPLIT_CHUNKS
KINDS = ["bfloat16", "int8"]
PAD = 2  # padding tokens after the last row


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several test files per core: keep torch's intra-op
    pool to one thread for these small shapes, and restore it after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(mp: int, ps: int):
    """(row_starts, q_lens) of the mixed batch over a table of ``mp``
    pages: decode rows at the last and middle positions and near the
    start, an inert row (q_len 0), a three-token and a ten-token row."""
    cap = mp * ps
    starts = np.array([cap - 1, 0, cap // 3, 5, cap // 2, 2], np.int32)
    q_lens = np.array([1, 0, 3, 10, 1, 1], np.int32)
    return starts, q_lens


def _windows(mp: int, ps: int):
    """None; one that starts mid-page on the last row's first visible
    page; one that starts mid-chunk past the first chunks."""
    cp = -(-mp // C)
    return [None, ps + 5, 2 * cp * ps + ps // 2 + 3]


def _case(kind, mp, ps, KV=2, G=2, hd=64, seed=0):
    """q, numpy pools ``(k, v, k_scales, v_scales)`` ``[KV, n_pages, ps,
    Hd]`` (float32 holding bfloat16 values, or int8 codes with f32 scales
    ``[KV, n_pages, 1, ps]`` from the JAX ``kv_quantize``), the
    descriptors ``(tables, row_starts, q_begins, q_lens)`` with each row
    on its own permuted pages, and token liveness."""
    rng = np.random.default_rng(seed)
    starts, q_lens = _rows(mp, ps)
    q_begins = np.concatenate([[0], np.cumsum(q_lens)[:-1]]).astype(np.int32)
    T = int(q_lens.sum()) + PAD
    n_pages = len(q_lens) * mp + 1
    tables = rng.permutation(n_pages - 1)[:len(q_lens) * mp].reshape(-1, mp).astype(np.int32)
    q = rng.standard_normal((T, KV * G, hd), dtype=np.float32)
    shape = (KV, n_pages, ps, hd)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    if kind == "bfloat16":
        pages = (*(np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
                   for a in (k, v)), None, None)
    else:
        (k8, ks), (v8, vs) = jquant.kv_quantize(jnp.asarray(k)), jquant.kv_quantize(jnp.asarray(v))
        pages = (np.array(k8), np.array(v8), np.array(ks)[..., None, :],
                 np.array(vs)[..., None, :])
    live = np.zeros(T, bool)
    for b, n in zip(q_begins, q_lens):
        live[b:b + n] = True
    return q, pages, (tables, starts, q_begins, q_lens), live


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _visible(desc, T, ps, mp, window):
    """Each token's visible keys ``[k_lo, k_hi)`` as the kernel computes
    them (none for a token in no row)."""
    _, starts, q_begins, q_lens = _torch(*desc)
    row_of, off, live = tpa.ragged_token_rows(q_begins, q_lens, T)
    pos = (starts[row_of] + off).long()
    k_hi = torch.where(live, torch.clamp(pos + 1, max=mp * ps), 0)
    k_lo = torch.clamp(pos - window + 1, min=0) if window else torch.zeros_like(pos)
    return torch.where(live, k_lo, 0), k_hi


def _jax_split(q, pages, desc, window, kv_splits):
    k, v, ks, vs = pages
    page_dtype = jnp.int8 if ks is not None else jnp.float32
    args = [jnp.asarray(q), jnp.asarray(k).astype(page_dtype),
            jnp.asarray(v).astype(page_dtype), *(jnp.asarray(a) for a in desc)]
    if ks is not None:
        args += [jnp.asarray(ks), jnp.asarray(vs)]
    return np.asarray(jpa.ragged_paged_attention_kvsplit(
        *args, kv_splits=kv_splits, interpret=True, window=window))


@pytest.mark.parametrize("window_kind", [0, 1, 2])
@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("mp", [5, 13, 32])
def test_rank_ranges_are_the_chunks(mp, ps, window_kind):
    """The mirror's rank ranges partition each token's visible keys, in
    rank order, and rank ``c`` holds exactly the visible keys of chunk
    ``c`` (``key // (cp·ps) == c``); a rank holds keys exactly where
    ``reference_kvsplit_partials`` finds chunk ``c`` live.  mp 5: ranks
    5-7 lie past the table; mp 13 (cp 2): rank 7 covers pages 14-15."""
    window = _windows(mp, ps)[window_kind]
    q, pages, desc, live = _case("bfloat16", mp, ps, seed=mp + ps)
    T, cp = q.shape[0], -(-mp // C)
    k_lo, k_hi = _visible(desc, T, ps, mp, window)
    lo, hi = tpa.cluster_key_ranges(k_lo, k_hi, ps, C, chunk_pages=cp)
    assert lo.shape == hi.shape == (C, T) and (hi >= lo).all()
    key = torch.arange(mp * ps)
    seen = (key >= k_lo[:, None]) & (key < k_hi[:, None])  # [T, S]
    ranks = (key >= lo[..., None]) & (key < hi[..., None])  # [C, T, S]
    chunk = (key // (cp * ps)) == torch.arange(C)[:, None, None]
    assert torch.equal(ranks, seen[None] & chunk)
    assert torch.equal(ranks.sum(0), seen.long())  # disjoint, covering
    _, m, _ = tpa.reference_kvsplit_partials(*_torch(q, pages[0], pages[1], *desc),
                                             window=window)
    assert torch.equal(torch.isfinite(m).all(dim=(2, 3)), hi > lo)
    if mp < C:
        assert (hi[mp:] == lo[mp:]).all()
    if mp % C:
        assert (hi[-1] == lo[-1]).all() and (hi[-1] >= mp * ps).all()
    assert (hi[:, ~torch.from_numpy(live)] == lo[:, ~torch.from_numpy(live)]).all()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("window_kind", [0, 1, 2])
@pytest.mark.parametrize("ps,mp", [(16, 5), (16, 13), (128, 13), (16, 32)])
def test_rank_partials_equal_the_chunk_partials(kind, ps, mp, window_kind):
    """The plain per-rank partials over the mirror's ranges are the split
    walk's chunk partials: ``m`` and ``l`` bit for bit, ``acc`` within
    ``ATOL`` (the two plain versions sum P·V over different lengths)."""
    window = _windows(mp, ps)[window_kind]
    q, pages, desc, _ = _case(kind, mp, ps, seed=3 * mp + ps)
    tq, k, v, ks, vs = _torch(q, *pages)
    td = _torch(*desc)
    ranks = tpa.reference_cluster_partials(tq, k, v, *td, ks, vs, window=window,
                                           cluster=C, chunk_pages=-(-mp // C))
    chunks = tpa.reference_kvsplit_partials(tq, k, v, *td, ks, vs, window=window)
    assert all(a.shape == b.shape for a, b in zip(ranks, chunks))
    assert torch.equal(ranks[1], chunks[1]) and torch.equal(ranks[2], chunks[2])
    torch.testing.assert_close(ranks[0], chunks[0], atol=ATOL, rtol=0)


def _check_folded(kind, mp, ps, G, hd, window, kv_splits, seed):
    q, pages, desc, live = _case(kind, mp, ps, G=G, hd=hd, seed=seed)
    tq, k, v, ks, vs = _torch(q, *pages)
    acc, m, l = tpa.reference_cluster_partials(tq, k, v, *_torch(*desc), ks, vs,
                                               window=window, cluster=C,
                                               chunk_pages=-(-mp // C))
    ours = tpa.combine_kvsplit_partials(acc, m, l, tq.dtype).numpy()
    ref = _jax_split(q, pages, desc, window, kv_splits)
    np.testing.assert_allclose(ours[live], ref[live], atol=ATOL, rtol=0)
    assert not ours[~live].any()  # the inert row's tokens and the padding
    plain = tpa.reference_ragged_paged_attention_kvsplit(tq, k, v, *_torch(*desc), ks, vs,
                                                         window=window).numpy()
    np.testing.assert_allclose(ours, plain, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kv_splits", [1, 2, 4, 8])
def test_folded_ranks_match_jax_split_walk(kind, kv_splits):
    """Every ``kv_splits`` of the JAX kernel (its chunks are the same
    eight whatever the count) on a 13-page table under a mid-chunk
    window."""
    _check_folded(kind, 13, 16, 2, 64, _windows(13, 16)[2], kv_splits, seed=kv_splits)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("G,hd,ps,mp,window_kind", [
    (1, 64, 16, 5, 0), (2, 128, 128, 3, 1), (4, 128, 16, 32, 2), (8, 64, 16, 13, 1),
    (8, 128, 128, 13, 2)])
def test_folded_ranks_across_shapes(kind, G, hd, ps, mp, window_kind):
    """G 1, 2, 4 and 8, Hd 64 and 128, page sizes 16 and 128, against the
    JAX split walk at its full fan-out."""
    _check_folded(kind, mp, ps, G, hd, _windows(mp, ps)[window_kind], C, seed=G + hd + mp)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mp", [5, 32])
def test_wrapper_hands_the_chunk_pages_and_no_scratch(monkeypatch, kind, mp):
    """With the launch faked, the wrapper hands the C entry its ten
    pointers (q, pages, scales, descriptors, out: no scratch) and
    ``ceil(mp / 8)`` as the chunk pages, reads no tensor back (no
    ``.item()``, ``.cpu()`` or ``.tolist()``) and counts one launch under
    the page type's name."""
    calls = []

    def fake_entry(source, fn):
        def launch(*args):
            calls.append((source, fn, args))
            return 0
        return launch

    def forbidden(*_a, **_k):
        raise AssertionError("the wrapper read a tensor back to the host")

    monkeypatch.setattr(dispatch, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "entry", fake_entry)
    monkeypatch.setattr(tpa, "_stream", lambda t: 0)
    q, pages, desc, _ = _case(kind, mp, 16, seed=mp)
    k, v, ks, vs = (None if a is None else torch.from_numpy(a)[None] for a in pages)
    if kind == "bfloat16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    else:
        ks, vs = ks.contiguous(), vs.contiguous()
    tq = torch.from_numpy(q).to(torch.bfloat16)
    td = _torch(*desc)
    for name in ("item", "cpu", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, forbidden)
    dispatch.reset_launches()
    try:
        out = tpa.ragged_paged_attention_kvsplit(tq, k, v, *td, ks, vs, window=21, layer=0)
        ((source, fn, args),) = calls
        assert (source, fn) == ("paged_attention.cu", "ragged_paged_attention_kvsplit")
        assert len(args) == len(_build.SIGNATURES[source][fn])
        ptrs = [None if t is None else t.data_ptr() for t in (tq, k, v, ks, vs, *td, out)]
        assert list(args[:10]) == ptrs
        T, R, KV, G, Hd, n_pages, ps, mp_arg, layer = args[10:19]
        assert (T, R, KV, G, Hd, ps, mp_arg, layer) == (tq.shape[0], 6, 2, 2, 64, 16, mp, 0)
        assert args[-3] == 21 and args[-2] == -(-mp // C)
        assert out.shape == (tq.shape[0], tq.shape[1] * tq.shape[2])
        counts = dispatch.launches()
        name = "ragged_paged_attention_kvsplit" + ("_int8" if kind == "int8" else "")
        assert counts[name] == 1 and sum(counts.values()) == 1
    finally:
        dispatch.reset_launches()


def test_int8_pages_need_a_page_size_multiple_of_4(monkeypatch):
    monkeypatch.setattr(dispatch, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "entry", lambda source, fn: (lambda *a: 0))
    k = torch.zeros((1, 2, 5, 6, 64), dtype=torch.int8)
    s = torch.ones((1, 2, 5, 1, 6), dtype=torch.float32)
    q = torch.zeros((2, 4, 64), dtype=torch.bfloat16)
    tables = torch.zeros((2, 3), dtype=torch.int32)
    starts = torch.tensor([3, 8], dtype=torch.int32)
    ones = torch.ones(2, dtype=torch.int32)
    begins = torch.arange(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 4"):
        tpa.ragged_paged_attention_kvsplit(q, k, k, tables, starts, begins, ones, s, s,
                                           layer=0)


def test_cluster_is_the_chunk_count():
    """The kernel's cluster is ``KV_SPLIT_CHUNKS`` ranks, one per chunk,
    and its C entry takes no scratch."""
    src = (_build.CSRC / "paged_attention.cu").read_text()
    m = re.search(r"constexpr int KV_SPLIT_CHUNKS = (\d+);", src)
    assert m and int(m.group(1)) == C
    entry = re.search(r'extern "C" int ragged_paged_attention_kvsplit\((.*?)\)\s*\{', src, re.S)
    params = [p.split()[-1].lstrip("*") for p in entry.group(1).split(",")]
    assert "chunk_pages" in params and not {"acc_p", "m_p", "l_p"} & set(params)
    for gone in ("split_kernel", "kvsplit_combine_kernel", "attend_row"):
        assert gone not in src
