"""The port's HuggingFace checkpoint loader against the JAX package's.

* Checkpoints the JAX ``save_hf_checkpoint`` writes (``qwen3-tiny``, tied,
  and an untied variant; ``mistral-tiny``, windowed, and a tied variant)
  load in the port with parameters equal to the JAX
  ``load_hf_checkpoint``'s, exactly, in bfloat16 and float32, and
  ``config_from_hf`` agrees field by field.
* The port's ``save_hf_checkpoint`` writes what the JAX loader reads back
  with equal parameters and config, and what the port reads back in
  F32, BF16 and F16.
* A missing layer tensor raises; the loader needs no ``safetensors``
  package; MoE and quantized configs raise ``NotImplementedError``.
* ``engine serve --load-hf DIR --device cpu`` answers ``/v1/completions``
  under the checkpoint's model name, and refuses a preset beside it.
"""

import dataclasses
import json
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch

from fusioninfer_tpu.models import config as jcfg
from fusioninfer_tpu.models import loader as jld
from fusioninfer_tpu.models import transformer as jtr
from fusioninfer_tpu_torch import cli
from fusioninfer_tpu_torch.convert import params_from_jax
from fusioninfer_tpu_torch.engine.server import EngineServer, engine_from_args
from fusioninfer_tpu_torch.models import config as tcfg
from fusioninfer_tpu_torch.models import loader as tld

VARIANTS = [("qwen3-tiny", True), ("qwen3-tiny", False), ("mistral-tiny", False),
            ("mistral-tiny", True)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several test files per core: keep torch's intra-op
    pool to one thread for these small shapes, and restore it after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(name: str, tied: bool):
    cfg = dataclasses.replace(jcfg.get_preset(name), tie_embeddings=tied, dtype="float32")
    return cfg, jtr.init_params(cfg, jax.random.key(0))


def _flat(params: dict) -> dict:
    """``{key: f32 numpy}`` of a parameter tree of either package."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out.update({f"layers.{k}": v for k, v in params["layers"].items()})
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v).astype(np.float32)) for k, v in out.items()}


def _assert_same_params(a: dict, b: dict) -> None:
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _jax_fields_equal(ours: tcfg.ModelConfig, ref) -> None:
    mine = dataclasses.asdict(ours)
    assert {k: getattr(ref, k) for k in mine} == mine


@pytest.mark.parametrize("dtype", [None, "float32"])
@pytest.mark.parametrize("name,tied", VARIANTS)
def test_loads_jax_checkpoints_exactly(tmp_path, name, tied, dtype):
    cfg, params = _jax_model(name, tied)
    jld.save_hf_checkpoint(str(tmp_path), cfg, params)
    ref_cfg, ref = jld.load_hf_checkpoint(str(tmp_path), dtype=dtype)
    ours_cfg, ours = tld.load_hf_checkpoint(str(tmp_path), dtype=dtype, device="cpu")
    _jax_fields_equal(ours_cfg, ref_cfg)
    assert ours_cfg.dtype == (dtype or "bfloat16")
    assert ("lm_head" in ours) == (not tied)
    _assert_same_params(ours, ref)


@pytest.mark.parametrize("name,tied", VARIANTS)
def test_config_from_hf_matches_jax(tmp_path, name, tied):
    cfg, params = _jax_model(name, tied)
    jld.save_hf_checkpoint(str(tmp_path), cfg, params)
    ours = tcfg.config_from_hf(str(tmp_path))
    _jax_fields_equal(ours, jld.config_from_hf(str(tmp_path)))
    assert ours.sliding_window == cfg.sliding_window and ours.name == name
    with open(tmp_path / "config.json") as f:
        raw = json.load(f)
    raw["use_sliding_window"] = False
    with open(tmp_path / "config.json", "w") as f:
        json.dump(raw, f)
    assert tcfg.config_from_hf(str(tmp_path)).sliding_window is None
    _jax_fields_equal(tcfg.config_from_hf(str(tmp_path), name="x"),
                      jld.config_from_hf(str(tmp_path), name="x"))


@pytest.mark.parametrize("name,tied", VARIANTS)
def test_jax_reads_the_ports_checkpoints(tmp_path, name, tied):
    cfg, params = _jax_model(name, tied)
    ct = dataclasses.replace(tcfg.get_preset(name), tie_embeddings=tied, dtype="float32")
    pt = params_from_jax(jax.tree.map(np.asarray, params), ct, "cpu")
    tld.save_hf_checkpoint(str(tmp_path), ct, pt)
    with open(tmp_path / "config.json") as f:
        ours_json = json.load(f)
    ref_dir = tmp_path / "jax"
    jld.save_hf_checkpoint(str(ref_dir), cfg, params)
    with open(ref_dir / "config.json") as f:
        assert json.load(f) == ours_json
    ref_cfg, ref = jld.load_hf_checkpoint(str(tmp_path), dtype="float32")
    _jax_fields_equal(ct, ref_cfg)
    _assert_same_params(pt, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_port_round_trip_keeps_dtype(tmp_path, dtype):
    cfg = dataclasses.replace(tcfg.get_preset("mistral-tiny"), dtype=dtype)
    from fusioninfer_tpu_torch.models.transformer import init_params

    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tld.save_hf_checkpoint(str(tmp_path), cfg, params)
    got_cfg, got = tld.load_hf_checkpoint(str(tmp_path), dtype=dtype, device="cpu")
    assert got_cfg == cfg
    for key in ("embed", "lm_head", "final_norm"):
        assert got[key].dtype == cfg.torch_dtype and torch.equal(got[key], params[key])
    for key, w in params["layers"].items():
        assert torch.equal(got["layers"][key], w), key


def test_missing_layer_tensor_raises(tmp_path):
    import safetensors.numpy as st

    cfg, params = _jax_model("qwen3-tiny", False)
    jld.save_hf_checkpoint(str(tmp_path), cfg, params)
    f = tmp_path / "model.safetensors"
    tensors = dict(st.load_file(str(f)))
    tensors.pop("model.layers.1.mlp.up_proj.weight")
    st.save_file(tensors, str(f))
    with pytest.raises(ValueError, match="missing layer tensors"):
        tld.load_hf_checkpoint(str(tmp_path), device="cpu")


def test_loads_without_the_safetensors_package(tmp_path, monkeypatch):
    cfg, params = _jax_model("mistral-tiny", False)
    jld.save_hf_checkpoint(str(tmp_path), cfg, params)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    with pytest.raises(ImportError):
        import safetensors  # noqa: F401
    ours_cfg, ours = tld.load_hf_checkpoint(str(tmp_path), dtype="float32", device="cpu")
    _assert_same_params(ours, params)
    tld.save_hf_checkpoint(str(tmp_path / "again"), ours_cfg, ours)


@pytest.mark.parametrize("extra,what", [({"num_experts": 8}, "item 9"),
                                        ({"num_local_experts": 8}, "item 9"),
                                        ({"quantization_config": {"bits": 8}}, "item 7")])
def test_moe_and_quantized_configs_refused(tmp_path, extra, what):
    cfg, params = _jax_model("qwen3-tiny", True)
    jld.save_hf_checkpoint(str(tmp_path), cfg, params)
    with open(tmp_path / "config.json") as f:
        raw = json.load(f)
    raw.update(extra)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(raw, f)
    with pytest.raises(NotImplementedError, match=what):
        tcfg.config_from_hf(str(tmp_path))


def test_serve_load_hf_answers_completions(tmp_path):
    cfg, params = _jax_model("mistral-tiny", False)
    jld.save_hf_checkpoint(str(tmp_path), cfg, params)
    parser = cli.build_parser()
    with pytest.raises(SystemExit):
        engine_from_args(parser.parse_args(
            ["engine", "serve", "qwen3-8b", "--load-hf", str(tmp_path), "--device", "cpu"]))
    args = parser.parse_args(["engine", "serve", "--load-hf", str(tmp_path), "--device",
                              "cpu", "--max-model-len", "256", "--page-size", "16",
                              "--no-token-budget", "--decode-burst", "4"])
    engine = engine_from_args(args)
    assert engine.cfg.name == "mistral-tiny" and engine.cfg.sliding_window == 24
    server = EngineServer(engine, host="127.0.0.1", port=0)
    server.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/completions",
            data=json.dumps({"prompt": "windowed " * 6, "max_tokens": 40,
                             "temperature": 0.0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = json.loads(resp.read())
    finally:
        server.stop()
    assert body["model"] == "mistral-tiny"
    assert body["usage"]["completion_tokens"] == 40
    assert body["choices"][0]["finish_reason"] == "length"
    assert engine.window_pages_trimmed_total > 0
