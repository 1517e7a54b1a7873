"""The port's RMSNorm fused into its neighbours, held against the JAX
package and against the unfused chain it replaces.

* ``add_rms_norm`` (the residual add, then the norm) and
  ``qk_norm_rope_kv`` (the per-head q and k norms, RoPE and the K/V page
  write) on the CPU are their plain versions: held against the JAX
  composition (``jtr.rms_norm(x + d)``, ``jtr.apply_rope(jtr.rms_norm(q))``,
  ``jmr._scatter_kv`` into pools that already hold data, bf16 and int8)
  on numpy inputs from a seed, at qwen3-tiny's widths and at qwen3-8b's
  (D 4096, 32 / 8 heads of 128) for a few rows; q/k norms on and off; the
  flat ``[T]`` token axis of a fused step and the ``[B, S]`` axes of a
  prefill, whose rope tables cover one row of S; padding tokens on the
  trash page.
* The restructured layer loops (``transformer.hidden_states``,
  ``model_runner.prefill``, ``model_runner.fused_step``), which carry each
  norm's output into the next block, give the unfused loop's logits and
  pools bit for bit in bf16 (``torch.equal``): every norm alone, the
  residual adds, ``rotate`` and the page write as separate steps.
* With the C entries faked, the wrappers hand the kernels their pointers
  and sizes (the prefill's rope tables as they are, no broadcast copy),
  count one launch by shape, raise on a failed launch, and refuse what
  the kernels do not take.

The kernels run only on the card: ``chip_smoke.py`` holds them bit for
bit against the unfused chain there.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusioninfer_tpu.engine import model_runner as jmr
from fusioninfer_tpu.models import transformer as jtr
from fusioninfer_tpu_torch.engine import kv_cache as tkv
from fusioninfer_tpu_torch.engine import model_runner as tmr
from fusioninfer_tpu_torch.models import config as tcfg
from fusioninfer_tpu_torch.models import transformer as ttr
from fusioninfer_tpu_torch.ops import _build, dispatch, gemm
from fusioninfer_tpu_torch.ops import rms_norm as trn
from fusioninfer_tpu_torch.ops.flash_attention import flash_attention

TINY = tcfg.get_preset("qwen3-tiny")
# (D, H, KV, Hd): qwen3-tiny's widths and qwen3-8b's
WIDTHS = {"tiny": (256, 4, 2, 64), "qwen3-8b": (4096, 32, 8, 128)}
THETA = 1e6
EPS = 1e-6
# f32 on both sides: the norm a few ulps apart (the bound of
# tests/test_torch_model.py for values up to ~8), and RoPE's 2e-5 there
# plus the norm's ulps carried through the rotation
NORM_ATOL = 4e-6
ROPE_ATOL = 3e-5


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
    """An array's bits as integers (bf16 and f32 compared exactly)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.int32)
    if a.dtype.itemsize == 2 and a.dtype.kind not in "iu":
        return a.view(np.int16)
    return a


def _tokens(layout: str, rng):
    """``(lead, positions)``: the token axes and every token's position:
    a fused step's flat tokens at scattered positions, or a prefill's [B,
    S] at positions 0..S-1."""
    if layout == "flat":
        return (7,), rng.integers(0, 4000, 7)
    S = 6
    return (3, S), np.broadcast_to(np.arange(S), (3, S))


def _rope(layout: str, pos, Hd: int):
    """The forward's rope tables: a row a token for flat tokens, a row a
    column (S rows) for a prefill's [B, S]."""
    if layout == "flat":
        return ttr.rope_tables(torch.from_numpy(pos), Hd, THETA)
    return ttr.rope_tables(torch.arange(pos.shape[-1]), Hd, THETA)


def _qkv(rng, lead, H, KV, Hd, dtype=np.float32):
    q = rng.standard_normal((*lead, H, Hd), dtype=np.float32)
    k = rng.standard_normal((*lead, KV, Hd), dtype=np.float32)
    v = rng.standard_normal((*lead, KV, Hd), dtype=np.float32)
    qn = (1 + 0.1 * rng.standard_normal(Hd)).astype(np.float32)
    kn = (1 + 0.1 * rng.standard_normal(Hd)).astype(np.float32)
    return q, k, v, qn, kn


# -- the plain versions against the JAX composition --------------------------


@pytest.mark.parametrize("width,M", [("tiny", 1), ("tiny", 5), ("tiny", 40),
                                     ("qwen3-8b", 1), ("qwen3-8b", 3)])
def test_add_rms_norm_matches_jax(width, M):
    D = WIDTHS[width][0]
    rng = np.random.default_rng(M * 31 + D)
    x = rng.standard_normal((M, 2, D), dtype=np.float32)
    d = rng.standard_normal((M, 2, D), dtype=np.float32)
    w = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    s, h = trn.add_rms_norm(torch.from_numpy(x), torch.from_numpy(d), torch.from_numpy(w),
                            EPS)
    js = jnp.asarray(x) + jnp.asarray(d)
    np.testing.assert_array_equal(_bits(s), _bits(js))  # one IEEE add each side
    np.testing.assert_allclose(h.numpy(), np.asarray(jtr.rms_norm(js, jnp.asarray(w), EPS)),
                               atol=NORM_ATOL, rtol=0)
    assert s.shape == h.shape == x.shape


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("layout", ["flat", "prefill"])
@pytest.mark.parametrize("qk_norm", [True, False])
def test_qk_norm_rope_matches_jax(width, layout, qk_norm):
    _, H, KV, Hd = WIDTHS[width]
    rng = np.random.default_rng([Hd, layout == "flat", qk_norm])
    lead, pos = _tokens(layout, rng)
    q, k, v, qn, kn = _qkv(rng, lead, H, KV, Hd)
    norms = (torch.from_numpy(qn), torch.from_numpy(kn)) if qk_norm else (None, None)
    tq, tk = trn.qk_norm_rope_kv(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), *norms, _rope(layout, pos, Hd), EPS)
    jpos = jnp.asarray(pos)
    for ours, x, w in ((tq, q, qn), (tk, k, kn)):
        jx = jtr.rms_norm(jnp.asarray(x), jnp.asarray(w), EPS) if qk_norm else jnp.asarray(x)
        ref = np.asarray(jtr.apply_rope(jx, jpos, THETA))
        assert ours.shape == x.shape
        np.testing.assert_allclose(ours.numpy(), ref, atol=ROPE_ATOL if qk_norm else 2e-5,
                                   rtol=0)


def _pools(rng, L, KV, n_pages, ps, Hd, int8: bool) -> dict:
    """Pools that already hold data: random codes and scales, or bf16."""
    shape = (L, KV, n_pages, ps, Hd)
    if int8:
        return {"k": rng.integers(-127, 128, shape, dtype=np.int8),
                "v": rng.integers(-127, 128, shape, dtype=np.int8),
                "k_scale": rng.random((L, KV, n_pages, 1, ps), dtype=np.float32),
                "v_scale": rng.random((L, KV, n_pages, 1, ps), dtype=np.float32)}
    return {"k": rng.standard_normal(shape, dtype=np.float32),
            "v": rng.standard_normal(shape, dtype=np.float32)}


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("layout", ["flat", "prefill"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_page_write_matches_jax(width, layout, int8):
    """bf16 q/k/v into pools that already hold data, padding tokens on the
    trash page: the plain version's pools are what the JAX ``_scatter_kv``
    writes for the same rotated k and the same v (codes and scales, or the
    bf16 values, bit for bit), every page but the trash page's colliding
    writes; its rotated q and k are the JAX composition's in bf16."""
    _, H, KV, Hd = WIDTHS[width]
    rng = np.random.default_rng([Hd, layout == "flat", int8, 7])
    lead, pos = _tokens(layout, rng)
    q, k, v, qn, kn = _qkv(rng, lead, H, KV, Hd)
    L, n_pages, ps, layer = 2, 7, 16, 1
    trash = n_pages - 1
    n = int(np.prod(lead))
    flat = rng.choice(trash * ps, size=n, replace=False)
    page, slot = (flat // ps).reshape(lead), (flat % ps).reshape(lead)
    page.reshape(-1)[::3] = trash  # padding tokens
    pools = _pools(rng, L, KV, n_pages, ps, Hd, int8)
    ours = {name: torch.from_numpy(a.copy()) for name, a in pools.items()}
    if not int8:
        ours = {name: t.to(torch.bfloat16) for name, t in ours.items()}
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, qn, kn)]
    tq, tk = trn.qk_norm_rope_kv(*bf, _rope(layout, pos, Hd), EPS, cache=ours, layer=layer,
                                 write_page=torch.from_numpy(page).long(),
                                 write_slot=torch.from_numpy(slot).long())
    jpools = {name: jnp.asarray(a) if int8 else jnp.asarray(a, jnp.bfloat16)
              for name, a in pools.items()}
    ref = jmr._scatter_kv(jpools, layer, jnp.asarray(tk.float().numpy(), jnp.bfloat16),
                          jnp.asarray(bf[2].float().numpy(), jnp.bfloat16),
                          jnp.asarray(page), jnp.asarray(slot), head_axis=len(lead))
    for name in pools:
        np.testing.assert_array_equal(_bits(ours[name])[:, :, :trash],
                                      _bits(ref[name])[:, :, :trash])
    jpos = jnp.asarray(pos)
    for out, x, w in ((tq, bf[0], bf[3]), (tk, bf[1], bf[4])):
        jx = jtr.rms_norm(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                          jnp.asarray(w.float().numpy(), jnp.bfloat16), EPS)
        want = np.asarray(jtr.apply_rope(jx, jpos, THETA).astype(jnp.float32))
        # bf16 outputs below 8: where the two f32 norms round to
        # neighbouring bf16 values, one bf16 ulp (2^-5 at 4-8) carried
        # through the rotation
        assert np.abs(want).max() < 8
        np.testing.assert_allclose(out.float().numpy(), want, rtol=0, atol=2 ** -5)


# -- the restructured loops against the unfused chain ------------------------


def _unfused(cfg, params, x, rope, attend, write=None):
    """The unfused layer loop the fused kernels replace: each norm alone,
    the residual adds, ``rotate`` and the page write as separate steps →
    the final-normed hidden states."""
    eps, lead = cfg.rms_eps, x.shape[:-1]
    H, KV, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for l in range(cfg.n_layers):
        layer = ttr.layer_params(params, l)
        h = trn.rms_norm(x, layer["attn_norm"], eps)
        q = gemm.matmul(h, layer["wq"]).reshape(*lead, H, Hd)
        k = gemm.matmul(h, layer["wk"]).reshape(*lead, KV, Hd)
        v = gemm.matmul(h, layer["wv"]).reshape(*lead, KV, Hd)
        if cfg.qk_norm:
            q = trn.rms_norm(q, layer["q_norm"], eps)
            k = trn.rms_norm(k, layer["k_norm"], eps)
        q, k = trn.rotate(q, rope), trn.rotate(k, rope)
        if write is not None:
            write(l, k, v)
        x = x + gemm.matmul(attend(l, q, k, v), layer["wo"])
        h = trn.rms_norm(x, layer["mlp_norm"], eps)
        x = x + ttr.swiglu(h, layer["w_gate"], layer["w_up"], layer["w_down"])
    return trn.rms_norm(x, params["final_norm"], eps)


def _model(qk_norm: bool):
    cfg = dataclasses.replace(TINY, qk_norm=qk_norm)
    return cfg, ttr.init_params(cfg, torch.Generator().manual_seed(int(qk_norm)), "cpu")


def _flash(l, q, k, v):
    return flash_attention(q, k, v, causal=True)


@pytest.mark.parametrize("qk_norm", [True, False])
def test_forward_equals_the_unfused_chain(qk_norm):
    cfg, params = _model(qk_norm)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(3, cfg.vocab_size, (2, 9)))
    rope = ttr.rope_tables(torch.arange(9), cfg.head_dim, cfg.rope_theta)
    want = _unfused(cfg, params, ttr.embed_lookup(params["embed"], tokens), rope, _flash)
    assert torch.equal(ttr.hidden_states(cfg, params, tokens), want)
    assert torch.equal(ttr.forward(cfg, params, tokens), ttr.lm_head(cfg, params, want))


def _cache(cfg, kv_dtype: str):
    cc = tkv.CacheConfig(n_pages=12, page_size=16, max_pages_per_seq=4, kv_dtype=kv_dtype)
    return cc, tkv.init_kv_cache(cfg, cc, "cpu"), tkv.init_kv_cache(cfg, cc, "cpu")


def _equal_pools(a: dict, b: dict, trash: int) -> None:
    for name in a:  # the trash page takes colliding padding writes
        assert torch.equal(a[name][:, :, :trash], b[name][:, :, :trash]), name


@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_prefill_equals_the_unfused_chain(qk_norm, kv_dtype):
    """Two padded prompts, their pads on the trash page."""
    cfg, params = _model(qk_norm)
    cc, cache, chain = _cache(cfg, kv_dtype)
    B, S, ps = 2, 24, cc.page_size
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, (B, S)))
    lens = torch.tensor([24, 13])
    rows = torch.tensor([[3, 0, 8, 11], [5, 9, 11, 11]])
    logits = tmr.prefill(cfg, cc, params, cache, tokens, lens, rows)
    s = torch.arange(S)
    page = torch.where(s[None] < lens[:, None], rows[:, s // ps], cc.trash_page)
    slot = (s % ps).repeat(B, 1)
    h = _unfused(cfg, params, ttr.embed_lookup(params["embed"], tokens),
                 ttr.rope_tables(s, cfg.head_dim, cfg.rope_theta), _flash,
                 lambda l, k, v: trn.scatter_kv(chain, l, k, v, page, slot, head_axis=2))
    want = ttr.lm_head(cfg, params, h[torch.arange(B), lens - 1])
    assert torch.equal(logits, want)
    _equal_pools(cache, chain, cc.trash_page)


@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_fused_step_equals_the_unfused_chain(qk_norm, kv_dtype):
    """A decode-only step over pools that already hold the rows' context:
    three live rows and an inactive one (the trash page), flat tokens."""
    cfg, params = _model(qk_norm)
    cc, cache, chain = _cache(cfg, kv_dtype)
    g = torch.Generator().manual_seed(5)
    for name, t in cache.items():
        fill = (torch.randint(-127, 128, t.shape, generator=g) if t.dtype == torch.int8
                else torch.rand(t.shape, generator=g)).to(t.dtype)
        t.copy_(fill)
        chain[name].copy_(fill)
    B, ps = 4, cc.page_size
    tables = torch.tensor([[3, 0, 8, 11], [5, 9, 11, 11], [1, 2, 4, 6], [7, 11, 11, 11]],
                          dtype=torch.int32)
    positions = torch.tensor([40, 20, 63, 0], dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    tokens = torch.tensor([7, 8, 9, 10])
    logits = tmr.decode_step(cfg, cc, params, cache, tokens, positions, tables, active)
    rows = torch.arange(B)
    page = torch.where(active, tables[rows, positions.long() // ps],
                       cc.trash_page).long()
    slot = (positions % ps).long()
    lens = active.to(torch.int32)

    def walk(l, q, k, v):
        return tmr._ragged_attn(q, chain, tables, positions, rows.to(torch.int32), lens,
                                layer=l, window=cfg.sliding_window, kv_splits=0)

    h = _unfused(cfg, params, ttr.embed_lookup(params["embed"], tokens),
                 ttr.rope_tables(positions, cfg.head_dim, cfg.rope_theta), walk,
                 lambda l, k, v: trn.scatter_kv(chain, l, k, v, page, slot, head_axis=1))
    assert torch.equal(logits, ttr.lm_head(cfg, params, h))
    _equal_pools(cache, chain, cc.trash_page)


def test_plain_versions_are_the_unfused_pieces():
    """bf16 at qwen3-8b's widths: the plain fused versions equal their
    pieces run one after the other."""
    D, H, KV, Hd = WIDTHS["qwen3-8b"]
    g = torch.Generator().manual_seed(8)
    x, d = (torch.randn((3, D), generator=g).to(torch.bfloat16) for _ in range(2))
    w = (1 + 0.1 * torch.randn(D, generator=g)).to(torch.bfloat16)
    s, h = trn.reference_add_rms_norm(x, d, w, EPS)
    assert torch.equal(s, x + d) and torch.equal(h, trn.rms_norm(x + d, w, EPS))
    q, k, v = (torch.randn((3, n, Hd), generator=g).to(torch.bfloat16) for n in (H, KV, KV))
    qn, kn = ((1 + 0.1 * torch.randn(Hd, generator=g)).to(torch.bfloat16) for _ in range(2))
    rope = ttr.rope_tables(torch.tensor([5, 900, 3001]), Hd, THETA)
    tq, tk = trn.qk_norm_rope_kv(q, k, v, qn, kn, rope, EPS)
    assert torch.equal(tq, trn.rotate(trn.rms_norm(q, qn, EPS), rope))
    assert torch.equal(tk, trn.rotate(trn.rms_norm(k, kn, EPS), rope))
    assert trn.qk_norm_rope_kv(q, k, v, qn, kn, rope, EPS, k_out=False)[1] is None


# -- the wrappers with the C entries faked ----------------------------------


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
    monkeypatch.setattr(trn, "_stream", lambda t: 0)
    return calls


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("shape", [(8, 4096), (3, 5, 256), (1, 1, 128)])
def test_add_norm_wrapper_hands_the_entry_its_rows(faked, shape):
    D = shape[-1]
    x, d, w = _bf16(*shape), _bf16(*shape), torch.ones(D, dtype=torch.bfloat16)
    s, h = trn.add_rms_norm(x, d, w, EPS)
    ((source, fn, args),) = faked
    assert (source, fn) == ("rms_norm.cu", "add_rms_norm_bf16")
    assert len(args) == len(_build.SIGNATURES[source][fn])
    xp, dp, wp, sp, hp, rows, dd, eps, stream = args
    assert (xp, dp, wp, sp, hp) == tuple(t.data_ptr() for t in (x, d, w, s, h))
    assert (rows, dd, stream) == (x.numel() // D, D, 0) and eps == pytest.approx(EPS)
    assert s.shape == h.shape == x.shape and sp != xp
    assert dispatch.launches(by_shape=True)[f"add_rms_norm[{D}]"] == 1


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_qk_wrapper_hands_a_prefill_its_tables_and_pages(faked, int8):
    """[B, S] tokens with rope tables of S rows: the entry gets the tables
    as they are (no broadcast copy) and S as their row count, the pools,
    the index maps and a k out for flash."""
    cfg = dataclasses.replace(TINY, n_layers=3)
    cc = tkv.CacheConfig(n_pages=9, page_size=16, max_pages_per_seq=4,
                         kv_dtype="int8" if int8 else "model")
    cache = tkv.init_kv_cache(cfg, cc, "cpu")
    B, S, H, KV, Hd = 2, 5, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _bf16(B, S, H, Hd), _bf16(B, S, KV, Hd), _bf16(B, S, KV, Hd)
    qn, kn = _bf16(Hd), _bf16(Hd)
    cos, sin = ttr.rope_tables(torch.arange(S), Hd, THETA)
    page = torch.zeros((B, S), dtype=torch.int64)
    slot = torch.arange(S).repeat(B, 1)
    tq, tk = trn.qk_norm_rope_kv(q, k, v, qn, kn, (cos, sin), EPS, cache=cache, layer=2,
                                 write_page=page, write_slot=slot)
    ((source, fn, args),) = faked
    assert (source, fn) == ("rms_norm.cu", "qk_norm_rope_kv_bf16")
    assert len(args) == len(_build.SIGNATURES[source][fn])
    ptrs = (q, k, v, qn, kn, cos, sin, tq, tk, cache["k"], cache["v"])
    assert args[:11] == tuple(t.data_ptr() for t in ptrs)
    scales = (cache["k_scale"].data_ptr(), cache["v_scale"].data_ptr()) if int8 else (0, 0)
    assert args[11:15] == (*scales, page.data_ptr(), slot.data_ptr())
    assert args[15:23] == (B * S, H, KV, Hd, S, cc.n_pages, cc.page_size, 2)
    assert args[23] == pytest.approx(EPS) and args[24] == 0
    assert tq.shape == q.shape and tk.shape == k.shape
    kind = "int8" if int8 else "bf16"
    assert dispatch.launches(by_shape=True) == {
        **dict.fromkeys(dispatch.KERNELS, 0), "qk_norm_rope_kv": 1,
        f"qk_norm_rope_kv[{H}x{KV}x{Hd} {kind}]": 1}


def test_qk_wrapper_without_norms_pages_or_k_out(faked):
    """A fused step's flat tokens (a table row each) with qk_norm off and
    no pool: NULL norms, pages, scales, index maps and k out."""
    T, H, KV, Hd = 6, 4, 2, 64
    rope = ttr.rope_tables(torch.arange(T), Hd, THETA)
    tq, tk = trn.qk_norm_rope_kv(_bf16(T, H, Hd), _bf16(T, KV, Hd), _bf16(T, KV, Hd),
                                 None, None, rope, EPS, k_out=False)
    ((_, _, args),) = faked
    assert args[3:5] == (0, 0) and args[8:15] == (0,) * 7
    assert args[15:20] == (T, H, KV, Hd, T) and tk is None and tq.shape == (T, H, Hd)
    assert dispatch.by_shape(dispatch.launches(by_shape=True), "qk_norm_rope_kv") == {
        f"{H}x{KV}x{Hd} none": 1}


def _qk_call(**over):
    T, H, KV, Hd = 4, 4, 2, 64
    args = dict(q=_bf16(T, H, Hd), k=_bf16(T, KV, Hd), v=_bf16(T, KV, Hd),
                q_norm=_bf16(Hd), k_norm=_bf16(Hd),
                rope=ttr.rope_tables(torch.arange(T), Hd, THETA), eps=EPS)
    args.update(over)
    pos = {name: args.pop(name) for name in ("q", "k", "v", "q_norm", "k_norm", "rope", "eps")}
    return trn.qk_norm_rope_kv(*pos.values(), **args)


def _int8_pool(scales: bool = True, dtype=torch.int8):
    pool = {"k": torch.zeros((2, 2, 5, 16, 64), dtype=dtype),
            "v": torch.zeros((2, 2, 5, 16, 64), dtype=dtype)}
    if scales:
        pool.update(k_scale=torch.zeros((2, 2, 5, 1, 16)), v_scale=torch.zeros((2, 2, 5, 1, 16)))
    return pool


IDX = torch.zeros(4, dtype=torch.int64)


@pytest.mark.parametrize("over,error,match", [
    (dict(q=torch.zeros((4, 4, 64))), TypeError, "bfloat16"),
    (dict(v=_bf16(4, 2, 32)), ValueError, "same tokens"),
    (dict(q=_bf16(4, 4, 72), k=_bf16(4, 2, 72), v=_bf16(4, 2, 72), q_norm=_bf16(72),
          k_norm=_bf16(72), rope=ttr.rope_tables(torch.arange(4), 72, THETA)),
     ValueError, "multiple of 16"),
    (dict(k_norm=None), ValueError, "both"),
    (dict(k_norm=_bf16(32)), ValueError, "both"),
    (dict(rope=ttr.rope_tables(torch.arange(3), 64, THETA)), ValueError, "divides"),
    (dict(cache=_int8_pool(scales=False)), TypeError, "bfloat16"),
    (dict(cache=_int8_pool(dtype=torch.bfloat16)), TypeError, "int8"),
    (dict(cache=_int8_pool(), write_page=IDX, write_slot=IDX.int()), ValueError, "int64"),
    (dict(cache=_int8_pool(), write_page=IDX, write_slot=IDX, layer=2), ValueError, "layer"),
    (dict(cache=_int8_pool(), write_page=IDX), ValueError, "write_slot"),
])
def test_qk_wrapper_refuses_what_the_kernel_does_not_take(faked, over, error, match):
    with pytest.raises(error, match=match):
        _qk_call(**over)
    assert not faked and dispatch.launches()["qk_norm_rope_kv"] == 0


def test_add_norm_wrapper_refuses_what_the_kernel_does_not_take(faked):
    w = torch.ones(64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not match x"):
        trn.add_rms_norm(_bf16(2, 64), _bf16(3, 64), w, EPS)
    with pytest.raises(TypeError, match="bfloat16"):
        trn.add_rms_norm(_bf16(2, 64), torch.zeros((2, 64)), w, EPS)
    with pytest.raises(ValueError, match="multiple of 8"):
        trn.add_rms_norm(_bf16(2, 60), _bf16(2, 60), torch.ones(60, dtype=torch.bfloat16), EPS)
    D = trn.MAX_ADD_NORM_D + 8
    with pytest.raises(ValueError, match="above"):
        trn.add_rms_norm(_bf16(1, D), _bf16(1, D), torch.ones(D, dtype=torch.bfloat16), EPS)
    assert not faked


def test_a_failed_fused_launch_raises(monkeypatch):
    monkeypatch.setattr(dispatch, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "entry", lambda source, fn: (lambda *a: 1))
    monkeypatch.setattr(trn, "_stream", lambda t: 0)
    with pytest.raises(RuntimeError, match="add_rms_norm_bf16: CUDA error 1"):
        trn.add_rms_norm(_bf16(2, 64), _bf16(2, 64), torch.ones(64, dtype=torch.bfloat16), EPS)
    with pytest.raises(RuntimeError, match="qk_norm_rope_kv_bf16: CUDA error 1"):
        _qk_call()
    assert sum(dispatch.launches().values()) == 0


def test_the_kernels_are_bound_and_documented():
    """Both fused entries are in the build's signatures and the source,
    and share the norm's reduction with rms_norm_bf16."""
    src = (_build.CSRC / "rms_norm.cu").read_text()
    for fn in ("rms_norm_bf16", "add_rms_norm_bf16", "qk_norm_rope_kv_bf16"):
        assert fn in _build.SIGNATURES["rms_norm.cu"]
        assert f'extern "C" int {fn}(' in src
    # each of the three kernels sums, folds and scales through the helpers
    assert src.count("add_squares(f") + src.count("add_squares(a") == 3
    assert src.count("inv_rms(ss") == 3 and src.count("lane_sum<") == 2  # row_sum, q/k
    assert "-fmad" not in " ".join(_build.NVCC_FLAGS)  # RoPE is written with _rn intrinsics
