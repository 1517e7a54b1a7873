"""The single walk's and paged decode's cluster split against the JAX package.

On the card, the single walk and paged decode run one thread-block
cluster of ``CL`` blocks per (token or sequence, KV head): rank ``r``
walks the ``r``-th share of the pages the query sees
(``cluster_key_ranges``) and the ranks' f32 ``(acc, m, l)`` are folded
left to right from rank 0.  The plain version of those partials is
``reference_cluster_partials``; here they, folded by
``combine_kvsplit_partials``, are held against the JAX
``ragged_paged_attention`` and ``paged_decode_attention`` (Pallas interpret
mode, as the JAX package's own tests run them on the CPU) and their
gathered oracles, on float32 pages holding bfloat16 values and on int8
pages with scales: every cluster size, rows with fewer pages than ranks,
windows that start mid-page and past the first pages, page sizes 16 and
128, head dims 64 and 128, query groups 1, 2, 4 and 8, an inactive slot,
padding tokens and a multi-token row.  The host-side rule that picks
``CL`` reads shapes only.  The CUDA kernel itself is held against the
plain version on the card (``chip_smoke.py``).
"""

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

# the mixed ragged batch: decode rows, an inert row (q_len 0), a
# three-token window and a ten-token chunk; two padding tokens at the end
Q_LENS = [1, 0, 3, 10, 1, 1]
STARTS = [37, 0, 20, 5, 118, 2]
PAD = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several test files per core: keep torch's intra-op
    pool to one thread for these small shapes, and restore it after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pages(rng, kind, KV, n_pages, ps, hd):
    """(k, v, k_scales, v_scales) numpy pools ``[KV, n_pages, ps, Hd]``:
    float32 holding bfloat16 values, or int8 codes with f32 scales
    ``[KV, n_pages, 1, ps]`` from the JAX package's ``kv_quantize``."""
    shape = (KV, n_pages, ps, hd)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    if kind == "bfloat16":
        return (*(np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
                  for a in (k, v)), None, None)
    k8, ks = jquant.kv_quantize(jnp.asarray(k))
    v8, vs = jquant.kv_quantize(jnp.asarray(v))
    return (np.array(k8), np.array(v8), np.array(ks)[..., None, :],
            np.array(vs)[..., None, :])


def _ragged_case(kind, KV=2, G=2, hd=64, ps=16, mp=8, seed=0):
    """q, pages, (tables, row_starts, q_begins, q_lens) and token liveness
    for the mixed batch, each row on its own permuted pages."""
    rng = np.random.default_rng(seed)
    q_lens = np.array(Q_LENS, np.int32)
    starts = np.array(STARTS, np.int32)
    q_begins = np.concatenate([[0], np.cumsum(q_lens)[:-1]]).astype(np.int32)
    T = int(q_lens.sum()) + PAD
    n_pages = len(Q_LENS) * mp + 1
    tables = rng.permutation(n_pages - 1)[:len(Q_LENS) * mp].reshape(-1, mp).astype(np.int32)
    q = rng.standard_normal((T, KV * G, hd), dtype=np.float32)
    live = np.zeros(T, bool)
    for b, n in zip(q_begins, q_lens):
        live[b:b + n] = True
    return q, _pages(rng, kind, KV, n_pages, ps, hd), (tables, starts, q_begins, q_lens), live


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _folded(q, pages, desc, window, cluster):
    """The port's plain rank partials, folded in rank order → numpy."""
    tq, k, v, ks, vs = _torch(q, *pages)
    acc, m, l = tpa.reference_cluster_partials(tq, k, v, *_torch(*desc), ks, vs,
                                               window=window, cluster=cluster)
    return tpa.combine_kvsplit_partials(acc, m, l, tq.dtype).numpy(), (acc, m, l)


def _dequant(pages):
    k, v, ks, vs = pages
    if ks is None:
        return k, v
    return (k.astype(np.float32) * ks[:, :, 0, :, None],
            v.astype(np.float32) * vs[:, :, 0, :, None])


def _jax_args(q, pages, rest):
    k, v, ks, vs = pages
    page_dtype = jnp.int8 if ks is not None else jnp.float32
    args = [jnp.asarray(q), jnp.asarray(k).astype(page_dtype),
            jnp.asarray(v).astype(page_dtype), *(jnp.asarray(a) for a in rest)]
    if ks is not None:
        args += [jnp.asarray(ks), jnp.asarray(vs)]
    return args


KINDS = ["bfloat16", "int8"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("window", [None, 21])
@pytest.mark.parametrize("cluster", tpa.CLUSTER_SIZES)
def test_folded_partials_match_jax_walk(kind, window, cluster):
    """Every cluster size on the mixed batch (mp 8: at CL 8 the short rows
    have fewer pages than ranks; window 21 starts mid-page, past the first
    pages of the long rows), against the Pallas walk on the live tokens
    and the gathered oracle on every token (inert ones are zeros)."""
    q, pages, desc, live = _ragged_case(kind, seed=cluster + (window or 0))
    ours, (acc, m, _) = _folded(q, pages, desc, window, cluster)
    assert acc.shape == (cluster, q.shape[0], 2, 2, 64) and m.shape == (cluster, q.shape[0], 2, 2)
    ref = np.asarray(jpa.ragged_paged_attention(*_jax_args(q, pages, desc),
                                                interpret=True, window=window))
    np.testing.assert_allclose(ours[live], ref[live], atol=ATOL, rtol=0)
    kd, vd = _dequant(pages)
    oracle = np.asarray(jpa.reference_ragged_paged_attention(
        *(jnp.asarray(a) for a in (q, kd, vd, *desc)), window=window))
    np.testing.assert_allclose(ours, oracle, atol=ATOL, rtol=0)
    assert not ours[~live].any()
    # an inert token's ranks are all (0, -inf, 0)
    assert torch.isneginf(m[:, torch.from_numpy(~live)]).all()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ps,hd,G,cluster,window", [
    (16, 64, 1, 8, None), (16, 128, 8, 2, 40), (128, 64, 4, 4, 150),
    (128, 128, 2, 8, None), (128, 128, 8, 1, 200)])
def test_folded_partials_across_shapes(kind, ps, hd, G, cluster, window):
    """Page sizes 16 and 128, head dims 64 and 128, groups 1-8, against the
    Pallas walk on the live tokens and the gathered oracle."""
    mp = 3 if ps == 128 else 10
    q, pages, desc, live = _ragged_case(kind, KV=2, G=G, hd=hd, ps=ps, mp=mp, seed=ps + G)
    ours, _ = _folded(q, pages, desc, window, cluster)
    ref = np.asarray(jpa.ragged_paged_attention(*_jax_args(q, pages, desc),
                                                interpret=True, window=window))
    np.testing.assert_allclose(ours[live], ref[live], atol=ATOL, rtol=0)
    kd, vd = _dequant(pages)
    oracle = np.asarray(jpa.reference_ragged_paged_attention(
        *(jnp.asarray(a) for a in (q, kd, vd, *desc)), window=window))
    np.testing.assert_allclose(ours, oracle, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("window", [None, 30])
@pytest.mark.parametrize("cluster", [2, 8])
def test_decode_partials_match_jax_decode(kind, window, cluster):
    """Paged decode as the same walk (sequence b's one query at lengths[b]
    - 1, none for an inactive slot, whose row is zeros); against the
    Pallas decode kernel and its oracle."""
    rng = np.random.default_rng(11 + cluster)
    KV, G, hd, ps, mp = 2, 4, 64, 16, 8
    B = 4
    pages = _pages(rng, kind, KV, B * mp + 1, ps, hd)
    tables = rng.permutation(B * mp)[:B * mp].reshape(B, mp).astype(np.int32)
    lengths = np.array([37, 0, 128, 5], np.int32)
    q = rng.standard_normal((B, KV * G, hd), dtype=np.float32)
    tl = torch.from_numpy(lengths)
    desc = (tl - 1, torch.arange(B, dtype=torch.int32), (tl > 0).to(torch.int32))
    tq, k, v, ks, vs = _torch(q, *pages)
    acc, m, l = tpa.reference_cluster_partials(tq, k, v, torch.from_numpy(tables), *desc,
                                               ks, vs, window=window, cluster=cluster)
    ours = tpa.combine_kvsplit_partials(acc, m, l, tq.dtype).numpy()
    ref = np.asarray(jpa.paged_decode_attention(*_jax_args(q, pages, (tables, lengths)),
                                                interpret=True, window=window))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    kd, vd = _dequant(pages)
    oracle = np.asarray(jpa.reference_paged_attention(
        *(jnp.asarray(a) for a in (q, kd, vd, tables, lengths)), window=window))
    np.testing.assert_allclose(ours, oracle, atol=ATOL, rtol=0)
    assert not ours[1].any()
    plain = tpa.reference_paged_attention(tq, k, v, torch.from_numpy(tables),
                                          torch.from_numpy(lengths), ks, vs, window=window)
    np.testing.assert_allclose(ours, plain.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("cluster", tpa.CLUSTER_SIZES)
@pytest.mark.parametrize("ps", [16, 128])
def test_rank_ranges_partition_the_visible_keys(cluster, ps):
    """The ranks' key ranges are disjoint, in rank order, cover exactly
    ``[k_lo, k_hi)``, start on page boundaries (except the first), and
    each spans at most ``ceil(n / CL)`` of the ``n`` visible pages; the
    ranks past the last page are empty."""
    rng = np.random.default_rng(cluster * ps)
    k_hi = torch.from_numpy(rng.integers(1, 40 * ps, 200))
    k_lo = torch.clamp(k_hi - torch.from_numpy(rng.integers(1, 12 * ps, 200)), min=0)
    k_lo[:5] = k_hi[:5]  # no visible keys: every rank empty
    lo, hi = tpa.cluster_key_ranges(k_lo, k_hi, ps, cluster)
    assert lo.shape == hi.shape == (cluster, 200)
    assert (hi >= lo).all()
    n = torch.where(k_hi > k_lo, (k_hi + ps - 1) // ps - k_lo // ps, 0)
    share = (n + cluster - 1) // cluster
    for i in range(200):
        edge = int(k_lo[i])
        for r in range(cluster):
            a, b = int(lo[r, i]), int(hi[r, i])
            if a == b:
                continue
            assert a == edge and (r == 0 or a % ps == 0)
            assert -(-b // ps) - a // ps <= int(share[i])
            edge = b
        assert edge == max(int(k_hi[i]), int(k_lo[i]))
    empty = (hi == lo).all(dim=0)
    assert empty[:5].all()


def test_rows_with_fewer_pages_than_ranks_leave_dead_ranks():
    """At CL 8 a 37-key row (3 pages of 16) fills ranks 0-2 and leaves 3-7
    as (0, -inf, 0); a window of 21 keys ending at 119 starts mid-page on
    page 6 and spans 2 pages."""
    q, pages, desc, _ = _ragged_case("bfloat16", seed=3)
    _, (acc, m, l) = _folded(q, pages, desc, None, 8)
    assert torch.isfinite(m[:3, 0]).all() and torch.isneginf(m[3:, 0]).all()
    assert not acc[3:, 0].any() and not l[3:, 0].any()
    _, (_, m, _) = _folded(q, pages, desc, 21, 8)
    t = int(np.sum(Q_LENS[:4]))  # the decode row at 118
    assert torch.isfinite(m[:2, t]).all() and torch.isneginf(m[2:, t]).all()


@pytest.mark.parametrize("n_items,kv,mp,sms,expected", [
    (8, 8, 32, 132, 8),    # a decode step of 8 rows, qwen3-8b: 512 blocks
    (8, 8, 16, 132, 8),    # the same at max-model-len 2048
    (12, 8, 32, 132, 4),
    (20, 8, 32, 132, 2),
    (72, 8, 32, 132, 1),   # a 64-token chunk beside 8 decode rows
    (8, 8, 3, 132, 2),     # capped at the table's 3 pages
    (1, 1, 1, 132, 1),
    (4, 2, 64, 16, 4),
])
def test_cluster_rule(n_items, kv, mp, sms, expected):
    cl = tpa.pick_cluster_size(n_items, kv, mp, sms)
    assert cl == expected
    assert cl in tpa.CLUSTER_SIZES and cl <= max(mp, 1)
    smaller = [c for c in tpa.CLUSTER_SIZES if c < cl]
    assert all(n_items * kv * c < 2 * sms for c in smaller)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("decode", [False, True])
def test_wrapper_passes_the_shape_rule_without_reading_tensors(monkeypatch, kind, decode):
    """With the launch faked, the wrapper hands the C entry the cluster
    size of the shape rule and reads no tensor back (no ``.item()``,
    ``.cpu()`` or ``.tolist()``): the launch is capturable."""
    calls = []

    def fake_entry(source, fn):
        def launch(*args):
            calls.append((fn, args))
            return 0
        return launch

    def forbidden(*_a, **_k):
        raise AssertionError("the wrapper read a tensor back to the host")

    monkeypatch.setattr(dispatch, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "entry", fake_entry)
    monkeypatch.setattr(tpa, "_stream", lambda t: 0)
    monkeypatch.setattr(tpa, "_sm_count", lambda device: 132)
    q, pages, desc, _ = _ragged_case(kind, seed=5)
    k, v, ks, vs = _torch(*pages)
    if kind == "bfloat16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    else:
        ks, vs = ks.contiguous(), vs.contiguous()
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tables, starts, q_begins, q_lens = _torch(*desc)
    for name in ("item", "cpu", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, forbidden)
    dispatch.reset_launches()
    try:
        if decode:
            B = tables.shape[0]
            out = tpa.paged_decode_attention(tq[:B], k, v, tables, starts + 1, ks, vs)
            n_items = B
        else:
            out = tpa.ragged_paged_attention(tq, k, v, tables, starts, q_begins, q_lens,
                                             ks, vs, window=21)
            n_items = tq.shape[0]
        assert out.shape == (n_items, tq.shape[1] * tq.shape[2])
        name = "paged_decode_attention" if decode else "ragged_paged_attention"
        ((fn, args),) = calls
        assert fn == name
        assert args[-2] == tpa.pick_cluster_size(n_items, 2, tables.shape[1], 132)
        assert dispatch.launches()[name + ("_int8" if kind == "int8" else "")] == 1
    finally:
        dispatch.reset_launches()


def test_int8_pages_need_a_page_size_multiple_of_4(monkeypatch):
    monkeypatch.setattr(dispatch, "use_kernel", lambda *t: True)
    monkeypatch.setattr(tpa, "_sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "entry", lambda source, fn: (lambda *a: 0))
    k = torch.zeros((1, 2, 5, 6, 64), dtype=torch.int8)
    s = torch.ones((1, 2, 5, 1, 6), dtype=torch.float32)
    q = torch.zeros((2, 4, 64), dtype=torch.bfloat16)
    tables = torch.zeros((2, 3), dtype=torch.int32)
    lengths = torch.tensor([4, 9], dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 4"):
        tpa.paged_decode_attention(q, k, k, tables, lengths, s, s, layer=0)
