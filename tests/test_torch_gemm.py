"""The row-invariant GEMM and RMSNorm of the PyTorch port.

* On the CPU the entry points (``ops.gemm.matmul``, ``ops.rms_norm``) are
  their plain versions: ``x @ w`` and the JAX package's ``rms_norm``, at
  qwen3-tiny's projection and norm widths, held against the JAX
  functions on the same numpy inputs.
* ``split_k``, the kernel's split of K (also its cluster size), is a
  function of the weight's shape alone: every range holds a K block, the
  count stays within the kernel's cluster cap, and qwen3-8b's
  projections get the splits and tiles the kernel was measured with; the
  K ranges and their fold order do not move with the row count.
* With the launch faked, the wrappers hand the C entries the pointers,
  the row count, the split and the tile, count one launch each (in
  total and by shape), and refuse what the kernels do not take.
* The transformer routes every projection and norm through them: a
  forward of qwen3-tiny counts one GEMM per projection and one norm per
  norm when the launches are faked.

The kernels themselves run only on the card: ``chip_smoke.py`` holds them
against these plain versions and checks that every row's bits are the
same at every row count.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fusioninfer_tpu.models import config as jcfg
from fusioninfer_tpu.models import transformer as jtr
from fusioninfer_tpu_torch.convert import params_from_jax
from fusioninfer_tpu_torch.models import config as tcfg
from fusioninfer_tpu_torch.models import transformer as ttr
from fusioninfer_tpu_torch.ops import _build, dispatch, gemm
from fusioninfer_tpu_torch.ops import rms_norm as trn

TINY = tcfg.get_preset("qwen3-tiny")
# qwen3-tiny's projections (K, N) and norm widths
TINY_GEMMS = {"wq": (TINY.d_model, TINY.n_heads * TINY.head_dim),
              "wk": (TINY.d_model, TINY.n_kv_heads * TINY.head_dim),
              "wo": (TINY.n_heads * TINY.head_dim, TINY.d_model),
              "gate": (TINY.d_model, TINY.d_ff), "down": (TINY.d_ff, TINY.d_model),
              "lm_head": (TINY.d_model, TINY.vocab_size)}
TINY_NORMS = (TINY.d_model, TINY.head_dim)
ROWS = (1, 2, 8, 40, 65)
# qwen3-8b's projections (K, N) and the splits (the clusters' K ranks) its
# kernel timings were taken at
QWEN3_8B_SPLITS = {(4096, 4096): 2, (4096, 1024): 8, (4096, 12288): 1,
                   (12288, 4096): 2, (4096, 151936): 1}
# the tile (rows, columns, pair) each qwen3-8b shape gets at the row counts
# the serve path gives it: decode rows, a spec window, one past a 64-row
# tile, a fused step and a long prefill
QWEN3_8B_TILES = {
    (4096, 4096): {8: (64, 64, 1), 40: (64, 64, 1), 65: (128, 64, 1),
                   520: (128, 256, 2), 3000: (128, 256, 1)},
    (4096, 1024): {8: (64, 128, 1), 40: (64, 128, 1), 65: (128, 128, 1),
                   520: (128, 256, 1), 3000: (128, 256, 1)},
    (4096, 12288): {8: (64, 64, 1), 40: (64, 64, 1), 65: (128, 128, 1),
                    520: (128, 256, 1), 3000: (128, 256, 2)},
    (12288, 4096): {8: (64, 64, 1), 40: (64, 64, 1), 65: (128, 64, 1),
                    520: (128, 256, 2), 3000: (128, 256, 1)},
    (4096, 151936): {8: (64, 128, 1), 40: (64, 128, 1), 65: (128, 256, 1),
                     520: (128, 256, 1), 3000: (128, 256, 2)},
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several test files per core: keep torch's intra-op
    pool to one thread for these small shapes, and restore it after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(TINY_GEMMS))
@pytest.mark.parametrize("M", ROWS)
def test_cpu_matmul_is_x_at_w_and_matches_jax(name, M):
    K, N = TINY_GEMMS[name]
    rng = np.random.default_rng(M * 7 + K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / K ** 0.5).astype(np.float32)
    y = gemm.matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(y, torch.from_numpy(x) @ torch.from_numpy(w))
    ref = np.asarray(jnp.asarray(x) @ jnp.asarray(w))
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", TINY_NORMS)
@pytest.mark.parametrize("M", ROWS)
def test_cpu_rms_norm_matches_jax(D, M):
    rng = np.random.default_rng(M + D)
    x = (3 * rng.standard_normal((M, 2, D))).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    y = trn.rms_norm(torch.from_numpy(x), torch.from_numpy(w), TINY.rms_eps)
    ref = np.asarray(jtr.rms_norm(jnp.asarray(x), jnp.asarray(w), TINY.rms_eps))
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert y.dtype == torch.float32 and y.shape == x.shape


def test_cpu_rms_norm_keeps_bfloat16():
    x = torch.randn((5, 64), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    w = torch.ones(64, dtype=torch.bfloat16)
    y = trn.rms_norm(x, w, 1e-6)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, trn.reference_rms_norm(x, w, 1e-6))


@pytest.mark.parametrize("kn", sorted(QWEN3_8B_SPLITS))
def test_split_k_of_the_qwen3_8b_projections(kn):
    K, N = kn
    assert gemm.split_k(N, K) == QWEN3_8B_SPLITS[kn]


@pytest.mark.parametrize("n", [8, 64, 128, 1024, 4096, 12288, 151936])
def test_split_k_ranges_are_whole_and_nonempty(n):
    for k in (8, 64, 200, 256, 1000, 4096, 12288, 40000):
        s = gemm.split_k(n, k)
        kb = -(-k // gemm.TILE_K)
        per = -(-kb // s)
        assert 1 <= s <= gemm.MAX_SPLITS
        assert (s - 1) * per < kb, (n, k, s)  # the last range holds a block
        if s > 1:
            assert per >= gemm.MIN_SPLIT_BLOCKS


def test_split_cap_matches_the_kernel():
    src = (_build.CSRC / "gemm.cu").read_text()
    assert f"constexpr int MAX_SPLITS = {gemm.MAX_SPLITS};" in src
    assert f"constexpr int BK = {gemm.TILE_K};" in src
    assert "static constexpr int BM = 64 * NC;" in src
    assert "BLOCKS_PER_SM = NC == 1 ? 2 : 1;" in src
    for rows, cols in gemm.TILES:  # every tile the wrapper picks has a launch
        assert re.search(rf"if \(tile_rows == {rows} && tile_cols == {cols}\)[^;]*"
                         rf"launch<{rows // 64}, {cols}, [12]>", src)
    assert min(c for _, c in gemm.TILES) == gemm.TILE_N
    assert gemm.tile_shape(gemm.SMALL_M, 4096, 4096)[0] == 64
    assert gemm.tile_shape(gemm.SMALL_M + 1, 4096, 4096)[0] == 128
    # the fold's column slices: every tile splits evenly at the cap
    assert all(c % (4 * gemm.MAX_SPLITS) == 0 for _, c in gemm.TILES)


@pytest.fixture
def faked(monkeypatch):
    """Route CPU tensors to the kernels' wrappers with the C entries faked
    → the list of ``(source, fn, args)`` calls."""
    calls = []

    def fake_entry(source, fn):
        def launch(*args):
            calls.append((source, fn, args))
            return 0
        return launch

    monkeypatch.setattr(dispatch, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "entry", fake_entry)
    monkeypatch.setattr(gemm, "_stream", lambda t: 0)
    monkeypatch.setattr(trn, "_stream", lambda t: 0)
    dispatch.reset_launches()
    yield calls
    dispatch.reset_launches()


@pytest.mark.parametrize("K,N,M", [(4096, 1024, 8), (4096, 12288, 3), (12288, 4096, 130),
                                   (4096, 4096, 520), (4096, 1024, 3000), (64, 256, 1)])
def test_gemm_wrapper_hands_the_entry_its_operands(faked, K, N, M):
    x = torch.zeros((M, 1, K), dtype=torch.bfloat16)
    w = torch.zeros((K, N), dtype=torch.bfloat16)
    y = gemm.matmul(x, w)
    ((source, fn, args),) = faked
    assert (source, fn) == ("gemm.cu", "gemm_bf16")
    assert len(args) == len(_build.SIGNATURES[source][fn])
    xp, wp, yp, m, n, k, splits, rows, cols, pair, stream = args
    assert (xp, wp, yp) == (x.data_ptr(), w.data_ptr(), y.data_ptr())
    assert (m, n, k, splits, stream) == (M, N, K, gemm.split_k(N, K), 0)
    assert (rows, cols, pair) == gemm.tile_shape(M, N, K) and (rows, cols) in gemm.TILES
    assert pair in (1, 2) and splits * pair <= gemm.MAX_SPLITS
    assert y.shape == (M, 1, N) and y.dtype == torch.bfloat16
    assert dispatch.launches()["gemm"] == 1 and sum(dispatch.launches().values()) == 1
    assert dispatch.launches(by_shape=True)[f"gemm[{K}x{N}]"] == 1


@pytest.mark.parametrize("kn", sorted(QWEN3_8B_TILES))
@pytest.mark.parametrize("M", [8, 40, 65, 520, 3000])
def test_tile_and_cluster_of_the_qwen3_8b_projections(kn, M):
    """Each projection's tile and pairing at the serve path's row counts,
    and a cluster of ``split_k`` K ranks (times the pair) that the card's
    clusters hold and the tile's columns fold evenly."""
    K, N = kn
    rows, cols, pair = gemm.tile_shape(M, N, K)
    assert (rows, cols, pair) == QWEN3_8B_TILES[kn][M]
    s = gemm.split_k(N, K)
    assert 1 <= s * pair <= gemm.MAX_SPLITS and cols % (4 * s) == 0
    assert pair == 1 or (rows == 128 and M > 128)


def k_ranges(n, k):
    """The K ranges ``[lo, hi)`` of a ``[k, n]`` weight in the order the
    kernel adds their partials (rank order): ``split_k(n, k)`` ranges of
    ``ceil(kb / splits)`` blocks of ``TILE_K`` (csrc/gemm.cu's ``per``),
    the last one shorter."""
    s, kb = gemm.split_k(n, k), -(-k // gemm.TILE_K)
    per = -(-kb // s)
    return [(r * per * gemm.TILE_K, min(k, (r + 1) * per * gemm.TILE_K)) for r in range(s)]


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 512).map(lambda v: 8 * v), k=st.integers(1, 1024).map(lambda v: 8 * v),
       ms=st.lists(st.integers(1, 700), min_size=2, max_size=4),
       big_ms=st.lists(st.integers(701, 6000), max_size=3))
def test_k_ranges_and_fold_order_do_not_move_with_m(n, k, ms, big_ms):
    """At a given (N, K), every row count hands the kernel the same split,
    so the same contiguous, non-empty K ranges of whole 64-deep blocks,
    folded in rank order, each at least MIN_SPLIT_BLOCKS deep when split;
    only the tile and pairing (which move no bits) follow M."""
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dispatch, "use_kernel", lambda *t: True)
        mp.setattr(_build, "entry", lambda source, fn: (lambda *a: calls.append(a) or 0))
        mp.setattr(gemm, "_stream", lambda t: 0)
        w = torch.zeros((k, n), dtype=torch.bfloat16)
        for m in ms:
            gemm.matmul(torch.zeros((m, k), dtype=torch.bfloat16), w)
    dispatch.reset_launches()
    assert {a[6] for a in calls} == {gemm.split_k(n, k)}
    ranges = k_ranges(n, k)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo < hi and lo % gemm.TILE_K == 0 for lo, hi in ranges)
    if len(ranges) > 1:
        assert all(hi - lo >= gemm.MIN_SPLIT_BLOCKS * gemm.TILE_K for lo, hi in ranges[:-1])
    tiles = [a[7:10] for a in calls] + [gemm.tile_shape(m, n, k) for m in big_ms]
    for rows, cols, pair in tiles:
        assert (rows, cols) in gemm.TILES and cols % (4 * len(ranges)) == 0
        assert len(ranges) * pair <= gemm.MAX_SPLITS and (pair == 1 or rows == 128)


@pytest.mark.parametrize("splits", [16, 3, 0])
def test_gemm_wrapper_refuses_a_split_the_cluster_cannot_hold(faked, monkeypatch, splits):
    """More ranks than the kernel's cluster cap, or ranks that do not
    divide the tile's columns into whole quads, never reach the entry."""
    monkeypatch.setattr(gemm, "split_k", lambda n, k: splits)
    with pytest.raises(ValueError, match="K ranges do not fit"):
        gemm.matmul(torch.zeros((8, 4096), dtype=torch.bfloat16),
                    torch.zeros((4096, 1024), dtype=torch.bfloat16))
    assert not faked and dispatch.launches()["gemm"] == 0


def test_launches_are_counted_by_shape_beside_the_totals(faked):
    """The wrappers count each launch in total and under its shape, in
    the one dict that graph replays add to; a reset drops the shapes."""
    for m, (k, n) in ((8, (64, 128)), (3, (64, 128)), (5, (128, 64))):
        gemm.matmul(torch.zeros((m, k), dtype=torch.bfloat16),
                    torch.zeros((k, n), dtype=torch.bfloat16))
    for shape in ((2, 64), (4, 32, 128)):
        trn.rms_norm(torch.zeros(shape, dtype=torch.bfloat16),
                     torch.ones(shape[-1], dtype=torch.bfloat16), 1e-6)
    counts = dispatch.launches(by_shape=True)
    assert dispatch.by_shape(counts, "gemm") == {"64x128": 2, "128x64": 1}
    assert dispatch.by_shape(counts, "rms_norm") == {"64": 1, "128": 1}
    assert dispatch.launches()["gemm"] == 3 and dispatch.launches()["rms_norm"] == 2
    assert set(dispatch.launches()) == set(dispatch.KERNELS)
    before = dispatch.launches(by_shape=True)
    dispatch.count_launches({"gemm": 1, "gemm[64x128]": 1, "gemm[8x8]": 1})  # a replay
    assert dispatch.launches(by_shape=True)["gemm[64x128]"] == 3
    dispatch.restore_launches(before)
    assert dispatch.launches(by_shape=True) == before
    dispatch.reset_launches()
    assert dispatch.launches(by_shape=True) == dict.fromkeys(dispatch.KERNELS, 0)


def test_gemm_wrapper_refuses_what_the_kernel_does_not_take(faked):
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        gemm.matmul(x.float(), torch.zeros((64, 64)))
    with pytest.raises(ValueError, match="contiguous"):
        gemm.matmul(x, torch.zeros((64, 64), dtype=torch.bfloat16).t())
    with pytest.raises(ValueError, match="multiples of 8"):
        gemm.matmul(torch.zeros((4, 60), dtype=torch.bfloat16),
                    torch.zeros((60, 64), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="does not take"):
        gemm.matmul(x, torch.zeros((32, 64), dtype=torch.bfloat16))
    assert not faked


def test_gemm_wrapper_launches_nothing_for_no_rows(faked):
    y = gemm.matmul(torch.zeros((0, 64), dtype=torch.bfloat16),
                    torch.zeros((64, 128), dtype=torch.bfloat16))
    assert y.shape == (0, 128) and not faked


def test_a_failed_launch_raises(monkeypatch):
    monkeypatch.setattr(dispatch, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "entry", lambda source, fn: (lambda *a: 1))
    monkeypatch.setattr(gemm, "_stream", lambda t: 0)
    monkeypatch.setattr(trn, "_stream", lambda t: 0)
    dispatch.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        gemm.matmul(torch.zeros((2, 64), dtype=torch.bfloat16),
                    torch.zeros((64, 64), dtype=torch.bfloat16))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        trn.rms_norm(torch.zeros((2, 64), dtype=torch.bfloat16),
                     torch.ones(64, dtype=torch.bfloat16), 1e-6)
    assert sum(dispatch.launches().values()) == 0


@pytest.mark.parametrize("shape", [(3, 4096), (7, 32, 128), (1, 8, 128)])
def test_norm_wrapper_hands_the_entry_its_rows(faked, shape):
    D = shape[-1]
    x = torch.zeros(shape, dtype=torch.bfloat16)
    w = torch.ones(D, dtype=torch.bfloat16)
    y = trn.rms_norm(x, w, 1e-6)
    ((source, fn, args),) = faked
    assert (source, fn) == ("rms_norm.cu", "rms_norm_bf16")
    assert len(args) == len(_build.SIGNATURES[source][fn])
    xp, wp, yp, rows, d, eps, stream = args
    assert (xp, wp, yp) == (x.data_ptr(), w.data_ptr(), y.data_ptr())
    assert (rows, d, stream) == (x.numel() // D, D, 0) and eps == pytest.approx(1e-6)
    assert y.shape == x.shape
    assert dispatch.launches()["rms_norm"] == 1


def test_norm_wrapper_refuses_what_the_kernel_does_not_take(faked):
    with pytest.raises(TypeError):
        trn.rms_norm(torch.zeros((2, 64)), torch.ones(64), 1e-6)
    with pytest.raises(ValueError, match="does not match"):
        trn.rms_norm(torch.zeros((2, 64), dtype=torch.bfloat16),
                     torch.ones(32, dtype=torch.bfloat16), 1e-6)
    with pytest.raises(ValueError, match="multiple of 8"):
        trn.rms_norm(torch.zeros((2, 60), dtype=torch.bfloat16),
                     torch.ones(60, dtype=torch.bfloat16), 1e-6)
    assert not faked


def _norm_launches_of_forwards(L: int, forwards: int = 1) -> dict:
    """What ``forwards`` forwards of L layers launch besides the GEMM and
    the walks: the first attention norm alone, every other norm fused
    with the residual add before it (the MLP norm and the next layer's
    attention norm, the last layer's being the final norm), and one q/k
    norm + RoPE (+ page write) launch a layer."""
    return {"rms_norm": forwards, "add_rms_norm": 2 * L * forwards,
            "qk_norm_rope_kv": L * forwards}


def test_every_projection_and_norm_of_a_forward_goes_through_the_kernels(faked):
    """A bf16 qwen3-tiny forward with the launches faked: one GEMM per
    projection (q, k, v, o, gate, up, down a layer, and the head), the
    first layer's attention norm alone, two add + norm launches a layer,
    one q/k norm + RoPE launch a layer, and nothing else: no norm of its
    own for q, k or the MLP; the tied head reads a contiguous copy."""
    cfg = TINY
    params = ttr.tied_head(ttr.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert params["lm_head"].is_contiguous()
    assert torch.equal(params["lm_head"], params["embed"].T)
    tokens = torch.zeros((1, 8), dtype=torch.int64)

    def fake_flash(q, k, v, **kw):
        B, S, H, Hd = q.shape
        return torch.zeros((B, S, H * Hd), dtype=q.dtype)

    import fusioninfer_tpu_torch.models.transformer as tr
    orig = tr.flash_attention
    tr.flash_attention = fake_flash
    try:
        ttr.forward(cfg, params, tokens)
    finally:
        tr.flash_attention = orig
    L = cfg.n_layers
    launches = {k: n for k, n in dispatch.launches().items() if n}
    assert launches == {"gemm": 7 * L + 1, **_norm_launches_of_forwards(L)}
    shapes = dispatch.launches(by_shape=True)
    D, H, KV, Hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert dispatch.by_shape(shapes, "rms_norm") == {str(D): 1}
    assert dispatch.by_shape(shapes, "add_rms_norm") == {str(D): 2 * L}
    assert dispatch.by_shape(shapes, "qk_norm_rope_kv") == {f"{H}x{KV}x{Hd} none": L}


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_every_projection_and_norm_of_a_fused_step_goes_through_the_kernels(
        faked, monkeypatch, kv_dtype):
    """One decode-only ``fused_step`` of bf16 qwen3-tiny over bf16 and int8
    pools with the launches faked: the same GEMMs and norms as a forward
    (the K/V page write inside the q/k launch, none of its own), one walk
    a layer, and nothing else."""
    from fusioninfer_tpu_torch.engine import kv_cache as tkv
    from fusioninfer_tpu_torch.engine import model_runner as tmr
    from fusioninfer_tpu_torch.ops import paged_attention as tpa

    monkeypatch.setattr(tpa, "_stream", lambda t: 0)
    monkeypatch.setattr(tpa, "_sm_count", lambda device: 132)
    cfg = TINY
    cc = tkv.CacheConfig(n_pages=9, page_size=16, max_pages_per_seq=4, kv_dtype=kv_dtype)
    cache = tkv.init_kv_cache(cfg, cc, "cpu")
    params = ttr.tied_head(ttr.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    B = 4
    rows = torch.arange(B, dtype=torch.int32)
    tables = torch.arange(B * 2, dtype=torch.int32).reshape(B, 2)
    tokens = torch.tensor([5, 6, 7, 8])
    positions = torch.tensor([3, 17, 0, 30], dtype=torch.int32)
    dispatch.reset_launches()
    tmr.fused_step(cfg, cc, params, cache, tokens, positions, rows,
                   torch.ones(B, dtype=torch.int32), tables, rows[:, None], rows[:0],
                   cluster=1, n_tokens=B)
    L = cfg.n_layers
    walk = "ragged_paged_attention" + ("_int8" if kv_dtype == "int8" else "")
    launches = {k: n for k, n in dispatch.launches().items() if n}
    assert launches == {"gemm": 7 * L + 1, walk: L, **_norm_launches_of_forwards(L)}
    kind = "int8" if kv_dtype == "int8" else "bf16"
    shapes = dispatch.launches(by_shape=True)
    assert dispatch.by_shape(shapes, "qk_norm_rope_kv") == {
        f"{cfg.n_heads}x{cfg.n_kv_heads}x{cfg.head_dim} {kind}": L}
    qk = [args for source, fn, args in faked if fn == "qk_norm_rope_kv_bf16"]
    assert len(qk) == L
    for l, args in enumerate(qk):
        # the pools and, on int8 pools, the scales; no k out for the walk
        assert args[8] == 0 and args[9] == cache["k"].data_ptr()
        assert (args[11] != 0) == (kv_dtype == "int8")
        assert args[15:23] == (B, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, B,
                               cc.n_pages, cc.page_size, l)


def test_tied_head_leaves_an_untied_model_alone():
    params = {"embed": torch.zeros((8, 4)), "lm_head": torch.ones((4, 8))}
    assert ttr.tied_head(params) is params


def test_plain_forward_matches_jax_at_tiny_widths():
    """The routed transformer on the CPU is the JAX forward (float32
    qwen3-tiny, the same weights)."""
    cj = dataclasses.replace(jcfg.get_preset("qwen3-tiny"), dtype="float32", n_layers=1)
    ct = dataclasses.replace(TINY, dtype="float32", n_layers=1)
    pj = jtr.init_params(cj, jax.random.key(1))
    pt = params_from_jax(jax.tree.map(np.asarray, pj), ct, "cpu")
    tokens = np.arange(12, dtype=np.int32)[None] % ct.vocab_size
    ref = np.asarray(jtr.forward(cj, pj, jnp.asarray(tokens)))
    out = ttr.forward(ct, pt, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-4)
