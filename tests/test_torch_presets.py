"""The port's model presets against the JAX package's.

* Every dense preset of the port equals its JAX preset field by field
  (every field the port's config has), and the port registers every
  dense JAX preset but ``llama3-70b``, which needs tensor parallelism;
  the MoE presets and ``llama3-70b`` raise ``NotImplementedError``.
* A tied narrow model of ``qwen3-1.7b``'s layout (16 query heads on 8 KV
  heads, GQA group 2, at 2 layers and d_model 128) carried over by
  ``convert.params_from_jax`` without an ``lm_head`` gives the JAX
  forward's float32 logits within ``atol 1e-5, rtol 1e-5``; so does
  ``mistral-7b``'s layout (no QK-norm, untied, θ 1e6) at the same width
  under a window shorter than the sequence.
"""

import dataclasses

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

DENSE = ("qwen3-tiny", "mistral-tiny", "qwen3-8b", "qwen3-1.7b", "mistral-7b")
NOT_PORTED = ("moe-tiny", "qwen3-30b-a3b", "llama3-70b")
ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several test files per core: keep torch's intra-op
    pool to one thread for these small shapes, and restore it after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", DENSE)
def test_dense_preset_equals_jax(name):
    ours = dataclasses.asdict(tcfg.get_preset(name))
    ref = dataclasses.asdict(jcfg.get_preset(name))
    assert {k: ref[k] for k in ours} == ours
    assert ref["quantization"] == "none" and ref["n_experts"] == 0


def test_every_dense_jax_preset_is_registered():
    dense = {n for n in jcfg.list_presets() if not jcfg.get_preset(n).is_moe}
    assert set(tcfg.list_presets()) == dense - {"llama3-70b"} == set(DENSE)


@pytest.mark.parametrize("name", NOT_PORTED)
def test_unported_presets_raise(name):
    with pytest.raises(NotImplementedError, match="queue 1 item"):
        tcfg.get_preset(name)


@pytest.mark.parametrize("layout,window", [("qwen3-1.7b", None), ("mistral-7b", 6)])
def test_narrow_model_logits_match_jax(layout, window):
    narrow = dict(d_model=128, n_layers=2, dtype="float32")
    if window is not None:
        narrow["sliding_window"] = window
    cj = dataclasses.replace(jcfg.get_preset(layout), attn_impl="reference", **narrow)
    ct = dataclasses.replace(tcfg.get_preset(layout), **narrow)
    assert ct.n_heads // ct.n_kv_heads == (2 if layout == "qwen3-1.7b" else 4)
    pj = jtr.init_params(cj, jax.random.key(0))
    assert ("lm_head" in pj) == (layout == "mistral-7b")
    pt = params_from_jax(jax.tree.map(np.asarray, pj), ct, "cpu")
    assert ("lm_head" in pt) == ("lm_head" in pj)
    tokens = np.random.default_rng(0).integers(0, ct.vocab_size, (2, 16))
    ref = np.asarray(jtr.forward(cj, pj, jnp.asarray(tokens)))
    got = ttr.forward(ct, pt, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    if window is not None:  # the window bites: full attention differs
        full = ttr.forward(dataclasses.replace(ct, sliding_window=None), pt,
                           torch.from_numpy(tokens)).numpy()
        assert not np.allclose(full, ref, atol=1e-3)
