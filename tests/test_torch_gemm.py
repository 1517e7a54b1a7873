"""The row-invariant GEMM and RMSNorm of the PyTorch port.

* On the CPU the entry points (``ops.gemm.matmul``, ``ops.rms_norm``) are
  their plain versions: ``x @ w`` and the JAX package's ``rms_norm``, at
  qwen3-tiny's projection and norm widths, held against the JAX
  functions on the same numpy inputs.
* ``split_k``, the kernel's split of K, is a function of the weight's
  shape alone: every range holds a K block, the count stays within the
  kernel's cap, and qwen3-8b's projections get the splits the kernel was
  measured with.
* With the launch faked, the wrappers hand the C entries the pointers,
  the row count, the split and (for a split) a workspace of
  ``splits · M · N`` floats and the tile counters, count one launch each,
  and refuse what the kernels do not take.
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
# qwen3-8b's projections (K, N) and the splits its kernel timings were taken at
QWEN3_8B_SPLITS = {(4096, 4096): 4, (4096, 1024): 16, (4096, 12288): 1,
                   (12288, 4096): 4, (4096, 151936): 1}


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
    assert "static constexpr int BM = 64 * NC;" in src
    assert "BLOCKS_PER_SM = NC == 1 ? 2 : 1;" in src
    assert re.search(r"if \(M <= 64\) return launch<1>", src)
    assert gemm.tile_rows(64) == (64, 2) and gemm.tile_rows(65) == (128, 1)
    assert (f"constexpr int BN = {gemm.TILE_N};" in src
            and f"constexpr int BK = {gemm.TILE_K};" in src)


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
    monkeypatch.setattr(gemm, "_COUNTS", {})
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
    xp, wp, yp, ws, counts, m, n, k, splits, stream = args
    assert (xp, wp, yp) == (x.data_ptr(), w.data_ptr(), y.data_ptr())
    assert (m, n, k, splits, stream) == (M, N, K, gemm.split_k(N, K), 0)
    assert y.shape == (M, 1, N) and y.dtype == torch.bfloat16
    tiles = -(-M // gemm.tile_rows(M)[0]) * -(-N // 128)
    if gemm.block_per_range(M, N, K):  # a block per range, folded in memory
        buf = gemm._COUNTS[x.device]
        assert splits > 1 and counts == buf.data_ptr() and ws != 0
        assert buf.numel() >= tiles and not buf.any()
    else:  # one range, or every range of a tile in one block
        assert ws == 0 and counts == 0
    assert dispatch.launches()["gemm"] == 1 and sum(dispatch.launches().values()) == 1


@pytest.mark.parametrize("K,N,M,per_range", [
    (4096, 4096, 8, True), (4096, 1024, 40, True), (12288, 4096, 520, True),
    (4096, 1024, 520, False), (4096, 4096, 3000, False), (4096, 1024, 3000, False),
    (4096, 12288, 8, False)])
def test_block_per_range_by_waves(K, N, M, per_range):
    """Decode rows spread a tile's K ranges over blocks; enough tiles to
    fill the card keep them in one block; one range never splits."""
    assert gemm.block_per_range(M, N, K) == per_range


def test_gemm_wrapper_sizes_the_workspace(faked, monkeypatch):
    sizes = []
    real_empty = torch.empty

    def spy(shape, **kw):
        sizes.append((tuple(shape), kw.get("dtype")))
        return real_empty(shape, **kw)

    monkeypatch.setattr(torch, "empty", spy)
    gemm.matmul(torch.zeros((40, 4096), dtype=torch.bfloat16),
                torch.zeros((4096, 1024), dtype=torch.bfloat16))
    assert ((16, 40, 1024), torch.float32) in sizes


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


def test_every_projection_and_norm_of_a_forward_goes_through_the_kernels(faked):
    """A bf16 qwen3-tiny forward with the launches faked: one GEMM per
    projection (q, k, v, o, gate, up, down a layer, and the head) and one
    norm per norm (attention, q, k and MLP norms a layer, and the final
    norm), and nothing else; the tied head reads a contiguous copy."""
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
    launches = dispatch.launches()
    assert launches["gemm"] == 7 * L + 1
    assert launches["rms_norm"] == 4 * L + 1
    assert sum(launches.values()) == launches["gemm"] + launches["rms_norm"]


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
