"""RMSNorm, alone and fused into its neighbours: CUDA kernel wrappers +
plain versions.

* ``rms_norm(x, weight, eps)`` normalises the last axis of ``x`` by its
  root mean square (statistics in f32) and scales by ``weight``.
* ``add_rms_norm(x, delta, weight, eps)`` → ``(s, h)``: the residual
  stream ``s = x + delta`` and ``h = rms_norm(s)``.
* ``qk_norm_rope_kv(q, k, v, ...)``: Qwen3's per-head q and k norms,
  RoPE and, given a pool, the K/V page write of one layer.

They replace no TPU kernel (the JAX package leaves norms, residual adds,
RoPE and the page write to XLA); the norm exists so that a row's bits on
the card do not depend on how many rows share the call, and the fused
pair so that a decode layer launches two kernels around its norms
instead of some thirty.

Kernels (``csrc/rms_norm.cu``): a fixed reduction tree per row that
depends on D alone (G threads a row, each adding its 16-byte chunks in
order, a butterfly of warp shuffles, warp sums added in order), shared by
all three, so the fused kernels' outputs are the unfused chain's bit for
bit (:func:`rms_norm`, torch's bf16 add, :func:`rotate`, :func:`scatter_kv`);
bf16 in and out.  Bound by bytes, and at decode row counts by launches.

The rule is the device: a CUDA tensor goes to the kernel (bf16 only), a
CPU tensor to the plain version (``reference_*``), which is the unfused
chain itself.
"""

from __future__ import annotations

import torch

from fusioninfer_tpu_torch.models.quantization import kv_quantize
from fusioninfer_tpu_torch.ops import dispatch

# the widest row add_rms_norm_bf16 keeps in registers (256 threads x 8
# chunks of 8), and the widest head the fused q/k kernel takes (a chunk
# of 8 values a lane of one warp)
MAX_ADD_NORM_D = 256 * 8 * 8
MAX_HEAD_DIM = 256


def _stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the C entry takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def _entry(fn: str):
    from fusioninfer_tpu_torch.ops import _build

    return _build.entry("rms_norm.cu", fn)


def _check(err: int, fn: str) -> None:
    from fusioninfer_tpu_torch.ops import _build

    _build.check(err, fn)


def _aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _rows(x: torch.Tensor, D: int) -> torch.Tensor:
    x2 = x.reshape(-1, D)
    return x2 if x2.is_contiguous() else x2.contiguous()


def _check_norm_operands(what: str, D: int, weight: torch.Tensor, *xs: torch.Tensor) -> None:
    if weight.shape != (D,):
        raise ValueError(f"weight {tuple(weight.shape)} does not match D {D}")
    if any(t.dtype != torch.bfloat16 for t in (*xs, weight)):
        raise TypeError(f"{what} takes bfloat16, got "
                        f"{[str(t.dtype) for t in (*xs, weight)]}")
    if D % 8:
        raise ValueError(f"D {D} must be a multiple of 8")


def reference_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain version (the JAX ``rms_norm``'s arithmetic)."""
    orig = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(orig)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis → ``x``'s shape and type: the CUDA kernel
    for CUDA tensors, :func:`reference_rms_norm` for CPU tensors."""
    if not dispatch.use_kernel(x, weight):
        return reference_rms_norm(x, weight, eps)
    D = x.shape[-1]
    _check_norm_operands("rms_norm", D, weight, x)
    x2 = _rows(x, D)
    weight = weight.contiguous()
    _aligned(x=x2, weight=weight)
    y = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    err = _entry("rms_norm_bf16")(x2.data_ptr(), weight.data_ptr(), y.data_ptr(),
                                  x2.shape[0], D, float(eps), _stream(x))
    _check(err, "rms_norm_bf16")
    dispatch.count_launch("rms_norm", str(D))
    return y.reshape(x.shape)


def reference_add_rms_norm(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                           eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the residual add, then :func:`reference_rms_norm`."""
    s = x + delta
    return s, reference_rms_norm(s, weight, eps)


def add_rms_norm(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                 eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, h)``: the new residual stream ``s = x + delta`` (rounded to
    ``x``'s type) and ``h = rms_norm(s, weight, eps)``, both of ``x``'s
    shape, in one launch of the CUDA kernel for CUDA tensors,
    :func:`reference_add_rms_norm` for CPU tensors."""
    if not dispatch.use_kernel(x, delta, weight):
        return reference_add_rms_norm(x, delta, weight, eps)
    D = x.shape[-1]
    if delta.shape != x.shape:
        raise ValueError(f"delta {tuple(delta.shape)} does not match x {tuple(x.shape)}")
    _check_norm_operands("add_rms_norm", D, weight, x, delta)
    if D > MAX_ADD_NORM_D:
        raise ValueError(f"D {D} above the kernel's {MAX_ADD_NORM_D}")
    x2, d2 = _rows(x, D), _rows(delta, D)
    weight = weight.contiguous()
    _aligned(x=x2, delta=d2, weight=weight)
    s, h = torch.empty_like(x2), torch.empty_like(x2)
    if x2.shape[0]:
        err = _entry("add_rms_norm_bf16")(x2.data_ptr(), d2.data_ptr(), weight.data_ptr(),
                                          s.data_ptr(), h.data_ptr(), x2.shape[0], D,
                                          float(eps), _stream(x))
        _check(err, "add_rms_norm_bf16")
        dispatch.count_launch("add_rms_norm", str(D))
    return s.reshape(x.shape), h.reshape(x.shape)


def rotate(x: torch.Tensor, rope) -> torch.Tensor:
    """Rotary embedding, NeoX half-rotation layout, from the ``(cos, sin)``
    tables of ``models.transformer.rope_tables`` (broadcast against x's
    leading axes).  x: [..., seq, heads, head_dim]."""
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def scatter_kv(cache: dict, l: int, k: torch.Tensor, v: torch.Tensor,
               write_page: torch.Tensor, write_slot: torch.Tensor,
               head_axis: int) -> None:
    """Write fresh K/V (``[..., KV, Hd]``, head axis at ``head_axis``) into
    layer ``l`` of the head-major pools ``[L, KV, n_pages, ps, Hd]`` in
    place, at ``(write_page, write_slot)`` (int64 index tensors of the
    leading shape).  An int8 pool quantizes on the way; the per-token
    scales land in the squeezed ``[KV, n_pages, ps]`` view of layer
    ``l``'s ``[KV, n_pages, 1, ps]`` scale pool."""
    if "k_scale" in cache:
        (k, k_s), (v, v_s) = kv_quantize(k), kv_quantize(v)
        cache["k_scale"][l, :, :, 0][:, write_page, write_slot] = torch.movedim(
            k_s, head_axis, 0)
        cache["v_scale"][l, :, :, 0][:, write_page, write_slot] = torch.movedim(
            v_s, head_axis, 0)
    cache["k"][l][:, write_page, write_slot] = torch.movedim(k, head_axis, 0).to(
        cache["k"].dtype)
    cache["v"][l][:, write_page, write_slot] = torch.movedim(v, head_axis, 0).to(
        cache["v"].dtype)


def reference_qk_norm_rope_kv(q, k, v, q_norm, k_norm, rope, eps, *, cache=None,
                              layer=0, write_page=None, write_slot=None, k_out=True):
    """Plain version of :func:`qk_norm_rope_kv`: :func:`reference_rms_norm`
    on q and k (with the norms), :func:`rotate`, :func:`scatter_kv`."""
    if q_norm is not None:
        q, k = reference_rms_norm(q, q_norm, eps), reference_rms_norm(k, k_norm, eps)
    q, k = rotate(q, rope), rotate(k, rope)
    if cache is not None:
        scatter_kv(cache, layer, k, v, write_page, write_slot, head_axis=k.dim() - 2)
    return q, (k if k_out else None)


def qk_norm_rope_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_norm: torch.Tensor | None, k_norm: torch.Tensor | None, rope,
                    eps: float, *, cache: dict | None = None, layer: int = 0,
                    write_page: torch.Tensor | None = None,
                    write_slot: torch.Tensor | None = None, k_out: bool = True):
    """Per token of q ``[..., H, Hd]`` and k, v ``[..., KV, Hd]`` (the same
    leading token axes): q and k through their per-head norms ``q_norm``,
    ``k_norm`` ``[Hd]`` (both None: no norm), then RoPE from ``rope``, the
    ``(cos, sin)`` f32 tables of ``models.transformer.rope_tables`` over the
    trailing token axes (``[S, 1, Hd/2]`` for ``[B, S]`` tokens, ``[T, 1,
    Hd/2]`` for ``[T]``); with ``cache``, the rotated k and v into layer
    ``layer``'s pages at ``(write_page, write_slot)`` (int64, the tokens'
    leading shape; int8 pools quantize) → ``(q', k')``, q' in q's shape
    (contiguous, the walks' layout) and k' in k's, or None without
    ``k_out``.  One launch of the CUDA kernel for CUDA tensors,
    :func:`reference_qk_norm_rope_kv` for CPU tensors."""
    if (q_norm is None) != (k_norm is None):
        raise ValueError("q_norm and k_norm must both be given or both be None")
    kw = dict(cache=cache, layer=layer, write_page=write_page, write_slot=write_slot,
              k_out=k_out)
    cos, sin = rope
    pools = () if cache is None else (cache["k"], cache["v"], write_page, write_slot)
    norms = () if q_norm is None else (q_norm, k_norm)
    if not dispatch.use_kernel(q, k, v, cos, sin, *norms, *pools):
        return reference_qk_norm_rope_kv(q, k, v, q_norm, k_norm, rope, eps, **kw)
    H, Hd = q.shape[-2:]
    KV = k.shape[-2]
    N = q.numel() // max(H * Hd, 1)
    if k.shape != v.shape or k.shape[-1] != Hd or k.shape[:-2] != q.shape[:-2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "expected [..., H, Hd] and [..., KV, Hd] over the same tokens")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, *norms)):
        raise TypeError("qk_norm_rope_kv takes bfloat16 q, k, v and norms")
    if Hd % 16 or Hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {Hd} must be a multiple of 16 up to {MAX_HEAD_DIM}")
    if any(w.shape != (Hd,) for w in norms):
        raise ValueError(f"q_norm and k_norm must both be [{Hd}]")
    cos2, sin2 = cos.reshape(-1, Hd // 2), sin.reshape(-1, Hd // 2)
    P = cos2.shape[0]
    if (cos.dtype != torch.float32 or sin.shape != cos.shape or not cos2.is_contiguous()
            or not sin2.is_contiguous() or P == 0 or N % P):
        raise ValueError(f"rope tables {tuple(cos.shape)} must be contiguous f32 rows of "
                         f"head_dim/2 whose count divides the {N} tokens")
    q3, k3, v3 = (_rows(t, Hd) for t in (q, k, v))
    norms = tuple(w.contiguous() for w in norms)
    q_o = torch.empty_like(q3)
    k_o = torch.empty_like(k3) if k_out else None
    ptrs = dict(k_pages=0, v_pages=0, k_scales=0, v_scales=0, write_page=0, write_slot=0)
    n_pages = ps = 0
    kind = "none"
    if cache is not None:
        kp, vp = cache["k"], cache["v"]
        ks, vs = cache.get("k_scale"), cache.get("v_scale")
        if kp.dim() != 5 or kp.shape != vp.shape or kp.shape[1] != KV or kp.shape[4] != Hd:
            raise ValueError(f"pools {tuple(kp.shape)}: expected [L, {KV}, n_pages, ps, {Hd}]")
        if not 0 <= layer < kp.shape[0]:
            raise ValueError(f"layer {layer} outside the pools' {kp.shape[0]}")
        if not (kp.is_contiguous() and vp.is_contiguous()):
            raise ValueError("the pools must be contiguous")
        n_pages, ps = kp.shape[2], kp.shape[3]
        if ks is None:
            if kp.dtype != torch.bfloat16 or vp.dtype != torch.bfloat16:
                raise TypeError("pools without scales must be bfloat16")
            kind = "bf16"
        else:
            if kp.dtype != torch.int8 or vp.dtype != torch.int8:
                raise TypeError("pools with scales must be int8")
            if (ks.shape != (*kp.shape[:3], 1, ps) or vs is None or vs.shape != ks.shape
                    or ks.dtype != torch.float32 or vs.dtype != torch.float32
                    or not ks.is_contiguous() or not vs.is_contiguous()):
                raise ValueError("scale pools must be contiguous f32 [L, KV, n_pages, 1, ps]")
            ptrs.update(k_scales=ks.data_ptr(), v_scales=vs.data_ptr())
            kind = "int8"
        if (write_page is None or write_slot is None or write_page.numel() != N
                or write_slot.numel() != N or write_page.dtype != torch.int64
                or write_slot.dtype != torch.int64 or not write_page.is_contiguous()
                or not write_slot.is_contiguous()):
            raise ValueError(f"write_page and write_slot must be contiguous int64 of the "
                             f"{N} tokens")
        ptrs.update(k_pages=kp.data_ptr(), v_pages=vp.data_ptr(),
                    write_page=write_page.data_ptr(), write_slot=write_slot.data_ptr())
    _aligned(q=q3, k=k3, v=v3, cos=cos2, sin=sin2, q_out=q_o, k_out=k_o,
             **{f"norm{i}": w for i, w in enumerate(norms)})
    if N:
        norm_ptrs = tuple(w.data_ptr() for w in norms) or (0, 0)
        err = _entry("qk_norm_rope_kv_bf16")(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), *norm_ptrs, cos2.data_ptr(), sin2.data_ptr(), q_o.data_ptr(),
            0 if k_o is None else k_o.data_ptr(),
            ptrs["k_pages"], ptrs["v_pages"], ptrs["k_scales"], ptrs["v_scales"],
            ptrs["write_page"], ptrs["write_slot"], N, H, KV, Hd, P, n_pages, ps, layer,
            float(eps), _stream(q))
        _check(err, "qk_norm_rope_kv_bf16")
        dispatch.count_launch("qk_norm_rope_kv", f"{H}x{KV}x{Hd} {kind}")
    return q_o.reshape(q.shape), (None if k_o is None else k_o.reshape(k.shape))
