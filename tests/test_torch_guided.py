"""Guided decoding of the PyTorch port against the JAX package (the cases
of ``tests/test_guided.py`` and ``tests/test_token_mask.py``).

* The machines: the port's ``JsonByteMachine`` and ``SchemaByteMachine``
  accept and reject the JAX tests' documents as the JAX machines do, over
  their schemas (unions, nesting, enums, ``$ref`` / ``$defs``, ``allOf``,
  ordered objects); the schemas the JAX compiler refuses are refused; and
  seeded random masked walks see the same ``allowed_bytes`` from both
  packages at every byte.
* The masker: ``GrammarTokenMasker.token_mask`` equals the JAX masker's
  at random reachable states, for the byte tokenizer and for a
  ``TrieTokenizer`` with multi-byte merges; ``TrieTokenizer`` encodes,
  decodes and exposes ``token_bytes`` as the JAX one does.
* The engine (float32 ``qwen3-tiny``, weights through
  ``convert.params_from_jax``; the JAX engine with ``fused_sampling=False``):
  guided greedy streams, json_object and json_schema, beside unguided
  ones, are token-identical to the JAX ``NativeEngine`` on a burst
  engine, a per-token engine, a speculative engine (where the unguided
  rows' streams also equal those without speculation), with chunked
  prefill and after a preemption; the scheduler ledger is equal too.
  Seeded guided streams parse and conform (their draws differ from
  JAX's by design).
* The server: ``response_format`` end to end, and its 400s.
"""

import dataclasses
import json
import random
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from fusioninfer_tpu.engine import engine as jeng
from fusioninfer_tpu.engine import guided as jg
from fusioninfer_tpu.engine import kv_cache as jkv
from fusioninfer_tpu.engine import sampler as jsamp
from fusioninfer_tpu.engine import token_mask as jtm
from fusioninfer_tpu.engine import tokenizer as jtok
from fusioninfer_tpu.models import config as jcfg
from fusioninfer_tpu.models import transformer as jtr
from fusioninfer_tpu_torch.convert import params_from_jax
from fusioninfer_tpu_torch.engine import engine as teng
from fusioninfer_tpu_torch.engine import guided as tg
from fusioninfer_tpu_torch.engine import kv_cache as tkv
from fusioninfer_tpu_torch.engine import sampler as tsamp
from fusioninfer_tpu_torch.engine import token_mask as ttm
from fusioninfer_tpu_torch.engine import tokenizer as ttok
from fusioninfer_tpu_torch.engine.server import EngineServer
from fusioninfer_tpu_torch.models import config as tcfg

# -- documents and schemas (tests/test_guided.py, tests/test_token_mask.py) --

JSON_ACCEPT = [
    '{}', '{"a": 1}', '{"a": [1, 2.5, -3e4, 0.1e-2]}', '{"k": {"nested": {"deep": []}}}',
    '{"s": "with \\"escape\\" and \\u00e9"}', '{ "ws" :\t[ true , false , null ] }',
    '{"mixed": [{"a": "b"}, [], {}, "x", 0]}', '{"zero": 0, "neg": -0.5}',
]
JSON_REJECT = [
    '[]', '42', '"str"', '{,}', '{"a" 1}', '{"a": 1,}', '{"a": 01}', '{"a": +1}',
    '{"a": .5}', '{"a": tru}', '{"a": "unterminated', '{"a": "bad \\x escape"}',
    '{} extra', '{"a": 1} {"b": 2}',
]

PET = {
    "type": "object",
    "properties": {
        "name": {"type": "string"},
        "age": {"type": "integer"},
        "tags": {"type": "array", "items": {"type": "string"}, "minItems": 1, "maxItems": 3},
        "kind": {"enum": ["cat", "dog", 3]},
        "ok": {"type": "boolean"},
    },
    "required": ["name", "age", "kind"],
    "additionalProperties": False,
}
CELL = {"type": "object",
        "properties": {"val": {"type": "integer"},
                       "next": {"anyOf": [{"$ref": "#/$defs/N"}, {"type": "null"}]}},
        "required": ["val", "next"], "additionalProperties": False}
PETS = {"type": "object",
        "properties": {"pets": {"type": "array", "items": {"$ref": "#/$defs/Pet"},
                                "minItems": 1, "maxItems": 2}},
        "required": ["pets"], "additionalProperties": False,
        "$defs": {"Pet": {"type": "object", "properties": {"kind": {"enum": ["cat", "dog"]}},
                          "required": ["kind"], "additionalProperties": False}}}
ORDERED = {"type": "object",
           "properties": {"arguments": {"type": "object"}, "name": {"enum": ["f", "g"]}},
           "required": ["name", "arguments"], "additionalProperties": False,
           "x-ordered": ["name", "arguments"]}
# (schema, documents it accepts, documents it rejects)
SCHEMA_CASES = {
    "pet": (PET,
            ['{"name":"bob","age":3,"kind":"cat"}', '{"age":0,"kind":3,"name":""}',
             '{"name":"a","age":-12,"kind":"dog","tags":["x"]}',
             '{"name":"a","age":7,"kind":"dog","tags":["x","y","z"],"ok":true}',
             '{"name":"s p a c e","age":42,"kind":"cat"}'],
            ['{"name":"bob","age":3}', '{"name":"bob","age":3.5,"kind":"cat"}',
             '{"name":1,"age":3,"kind":"cat"}', '{"name":"b","age":3,"kind":"fox"}',
             '{"name":"b","age":3,"kind":"cat","extra":1}',
             '{"name":"b","age":3,"kind":"cat","tags":[]}',
             '{"name":"b","age":3,"kind":"cat","tags":["a","b","c","d"]}',
             '{"name":"b","name":"c","age":3,"kind":"cat"}', '[1,2]',
             '{"name": "b", "age": 3, "kind": "cat"}']),
    "additional": ({"type": "object", "properties": {"a": {"type": "integer"}},
                    "additionalProperties": {"type": "boolean"}},
                   ['{"a":1,"b":true,"zz":false}', '{"ab":true}'], ['{"b":1}', '{"ab":2}']),
    "union_nested": ({"type": "object",
                      "properties": {"v": {"type": ["string", "null"]},
                                     "inner": {"type": "object",
                                               "properties": {"x": {"type": "number"}},
                                               "required": ["x"]}},
                      "required": ["inner"]},
                     ['{"v":null,"inner":{"x":1.5e3}}', '{"inner":{"x":2,"free":[1,{}]}}'],
                     ['{"v":3,"inner":{"x":1}}', '{"inner":{}}']),
    "enum_prefix": ({"type": "object", "properties": {"n": {"enum": [1, 12, 123]}},
                     "required": ["n"], "additionalProperties": False},
                    ['{"n":1}', '{"n":12}', '{"n":123}'], ['{"n":2}', '{"n":124}']),
    "duplicate_key": ({"type": "object", "properties": {"name": {"type": "string"}},
                       "required": ["name"]},
                      ['{"name":"x","name2":123}', '{"\\u006eame":"x"}'],
                      ['{"name":"x","name":123}', '{"name":"x","name":"y"}',
                       '{"name":"x","\\u006eame":"y"}', '{"\\u006eame":1}']),
    "surrogate_key": ({"type": "object", "properties": {"a": {"type": "integer"}}},
                      ['{"\\ud83d\\ude00":1}'], []),
    "defs": ({"type": "object", "properties": {"pet": {"$ref": "#/$defs/Pet"}},
              "required": ["pet"], "additionalProperties": False,
              "$defs": {"Pet": {"type": "object", "properties": {"kind": {"enum": ["cat"]}},
                                "required": ["kind"], "additionalProperties": False}}},
             ['{"pet":{"kind":"cat"}}'], ['{"pet":{"kind":"dog"}}', '{"pet":7}']),
    "definitions": ({"type": "object", "properties": {"n": {"$ref": "#/definitions/num"}},
                     "required": ["n"], "definitions": {"num": {"type": "integer"}}},
                    ['{"n":42}'], ['{"n":4.5}']),
    "allof_objects": ({"allOf": [
        {"type": "object", "properties": {"a": {"type": "integer"}}, "required": ["a"]},
        {"type": "object", "properties": {"b": {"type": "string"}}, "required": ["b"],
         "additionalProperties": False}]},
        ['{"a":1,"b":"x"}'], ['{"a":1}', '{"a":1,"b":"x","c":1}']),
    "allof_property": ({"allOf": [
        {"type": "object", "properties": {"v": {"type": ["integer", "string"]}}},
        {"type": "object", "properties": {"v": {"type": "integer"}}, "required": ["v"]}]},
        ['{"v":3}'], ['{"v":"x"}']),
    "allof_ref_siblings": ({"type": "object",
                            "properties": {"cfg": {"allOf": [{"$ref": "#/$defs/Cfg"}],
                                                   "description": "nested"},
                                           "alt": {"$ref": "#/$defs/Cfg", "title": "x"}},
                            "required": ["cfg"],
                            "$defs": {"Cfg": {"type": "object",
                                              "properties": {"on": {"type": "boolean"}},
                                              "additionalProperties": False}}},
                           ['{"cfg":{"on":true}}'], ['{"cfg":{"off":1}}']),
    "allof_enum": ({"type": "object",
                    "properties": {"k": {"allOf": [{"enum": ["a", "b", "c"]},
                                                   {"enum": ["b", "c", "d"]}]}},
                    "required": ["k"]},
                   ['{"k":"b"}'], ['{"k":"a"}']),
    "recursive": ({"$ref": "#/$defs/N", "$defs": {"N": CELL}},
                  ['{"val":1,"next":{"val":2,"next":null}}'], ['{"val":1,"next":3}']),
    "refs_array": (PETS, ['{"pets":[{"kind":"cat"}]}', '{"pets":[{"kind":"dog"},{"kind":"cat"}]}'],
                   ['{"pets":[]}', '{"pets":[{"kind":"cow"}]}']),
    "ordered": (ORDERED, ['{"name":"f","arguments":{}}'],
                ['{"arguments":{},"name":"f"}', '{"\\u006eame":"g","arguments":{}}']),
}
BAD_SCHEMAS = [
    {"type": "object", "required": ["ghost"]}, {"type": "martian"},
    {"$ref": "#/$defs/Pet"}, {"not": {"type": "string"}},
    {"type": "object", "properties": {"p": {"$ref": "#/$defs/X"}}},
    {"type": "array", "minItems": 2, "maxItems": 1},
    {"type": ["integer", "number"]}, {"anyOf": [{"const": "ab"}, {"type": "string"}]},
    {"allOf": [{"type": "string"}, {"type": "integer"}]},
    {"allOf": [{"enum": ["a"]}, {"enum": ["z"]}]},
    {"$ref": "#/$defs/X", "$defs": {"X": {"anyOf": [{"$ref": "#/$defs/X"}, {"type": "null"}]}}},
    {"$ref": "https://example.com/s.json"},
    {"type": "object", "properties": {"a": {"type": "integer"}}, "x-ordered": ["a", "b"]},
    {"type": "object", "properties": {"a": {"type": "integer"}}, "x-ordered": ["a"]},
]

# a BPE-shaped vocab: structural merges that cross grammar boundaries
MERGES = [b'{"', b'":', b'",', b'"}', b'", "', b'": "', b'true', b'false',
          b'null', b'name', b'age', b'kind', b'cat', b'dog', b'12', b'345',
          b'":"', b'}}', b'{{', b'::', b'1e5', b'-0.5', b'ing', b' th',
          b'er', b'on', b'\\u00', b'[]', b'[{', b'}]']


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several test files per core: keep torch's intra-op
    pool to one thread for these small shapes, and restore it after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(machine, text: str) -> bool:
    try:
        for b in text.encode():
            machine.advance(b)
    except ValueError:
        return False
    return machine.done


def _schema_machines(schema):
    return (tg.SchemaByteMachine(tg.compile_schema(schema)),
            jg.SchemaByteMachine(jg.compile_schema(schema)))


# -- the machines ------------------------------------------------------------------


@pytest.mark.parametrize("doc", JSON_ACCEPT + JSON_REJECT)
def test_json_machine_accepts_as_jax(doc):
    ours = _walk(tg.JsonByteMachine(), doc)
    assert ours == _walk(jg.JsonByteMachine(), doc)
    assert ours == (doc in JSON_ACCEPT)


@pytest.mark.parametrize("case", sorted(SCHEMA_CASES))
def test_schema_machine_accepts_as_jax(case):
    schema, good, bad = SCHEMA_CASES[case]
    for doc in good + bad:
        ours = _walk(tg.SchemaByteMachine(tg.compile_schema(schema)), doc)
        assert ours == _walk(jg.SchemaByteMachine(jg.compile_schema(schema)), doc), doc
        assert ours == (doc in good), doc


@pytest.mark.parametrize("i", range(len(BAD_SCHEMAS)))
def test_schemas_jax_refuses_are_refused(i):
    schema = BAD_SCHEMAS[i]

    def refused(mod):
        try:
            mod.SchemaByteMachine(mod.compile_schema(schema))
        except ValueError as e:
            return str(e)
        return None

    ours, ref = refused(tg), refused(jg)
    assert ours is not None and ours == ref


def test_root_must_be_an_object():
    with pytest.raises(ValueError, match="top-level object"):
        tg.SchemaByteMachine(tg.compile_schema({"type": "array"}))


def _twin_walk(ours, ref, rng, max_bytes: int, bias: float):
    """Advance both machines by the same seeded picks among the allowed
    bytes, checking every byte that both allow the same set and agree on
    ``done`` and ``str_run_invariant`` → the bytes walked."""
    out = bytearray()
    while len(out) < max_bytes:
        assert ours.done == ref.done
        a, b = ours.allowed_bytes(), ref.allowed_bytes()
        np.testing.assert_array_equal(a, b, err_msg=repr(bytes(out)))
        assert ours.str_run_invariant() == ref.str_run_invariant()
        if ours.done:
            break
        allowed = np.flatnonzero(a)
        assert allowed.size, f"dead end after {bytes(out)!r}"
        term = [c for c in (0x22, 0x7D, 0x5D, 0x2C) if a[c]]
        if term and rng.random() < bias:
            pick = int(rng.choice(term))
        else:
            printable = [c for c in allowed if 0x20 < c < 0x7F]
            pick = int(rng.choice(printable or list(allowed)))
        ours.advance(pick)
        ref.advance(pick)
        out.append(pick)
    return bytes(out)


@pytest.mark.parametrize("seed", range(6))
def test_masked_json_walks_allow_what_jax_allows(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        doc = _twin_walk(tg.JsonByteMachine(), jg.JsonByteMachine(), rng, 400, 0.5)
        if doc and doc[-1:] == b"}" and _walk(tg.JsonByteMachine(), doc.decode()):
            assert isinstance(json.loads(doc), dict)


@pytest.mark.parametrize("case", ["pet", "refs_array", "recursive", "union_nested",
                                  "ordered", "additional"])
def test_masked_schema_walks_allow_what_jax_allows(case):
    """Closed schemas' walks end in conforming documents; an open one
    (free nested values) may wander to the byte cap, its bytes still
    checked against JAX all the way."""
    schema = SCHEMA_CASES[case][0]
    rng = np.random.default_rng(len(case))
    finished = 0
    for _ in range(8):
        ours, ref = _schema_machines(schema)
        doc = _twin_walk(ours, ref, rng, 1500, 0.35)
        if ours.done:
            finished += 1
            json.loads(doc)
            assert _walk(jg.SchemaByteMachine(jg.compile_schema(schema)), doc.decode())
    assert finished >= (0 if case == "union_nested" else 1)


def test_machine_for_follows_the_params():
    sch = json.dumps(PET, sort_keys=True, separators=(",", ":"))
    assert tg.machine_for(tsamp.SamplingParams()) is None
    assert isinstance(tg.machine_for(tsamp.SamplingParams(guided_json=True)),
                      tg.JsonByteMachine)
    assert isinstance(tg.machine_for(tsamp.SamplingParams(guided_schema=sch)),
                      tg.SchemaByteMachine)
    assert tg.compile_schema_str(sch) is tg.compile_schema_str(sch)


def test_build_token_byte_table_matches_jax():
    tok = ttok.ByteTokenizer()
    for V in (200, 259, 4096):
        ours = tg.build_token_byte_table(tok, V)
        ref = jg.build_token_byte_table(jtok.ByteTokenizer(), V)
        np.testing.assert_array_equal(ours, ref)
    assert tg.build_token_byte_table(ttok.TrieTokenizer(MERGES), 300) is None


# -- tokenizers and the masker -----------------------------------------------------


TEXTS = ["", "hello", '{"name": "cat", "age": 12345}', "ümlaut and \\u00e9 escapes",
         "the thing on er ing", '[{"k":true},{"k":false,"v":null}]', "1e5 -0.5 345 12"]


@pytest.mark.parametrize("text", TEXTS)
def test_trie_tokenizer_matches_jax(text):
    ours, ref = ttok.TrieTokenizer(MERGES), jtok.TrieTokenizer(MERGES)
    for bos in (True, False):
        ids = ours.encode(text, add_bos=bos)
        assert ids == ref.encode(text, add_bos=bos)
        assert ours.decode(ids) == ref.decode(ids) == text
    assert ours.token_bytes() == ref.token_bytes()
    assert ours.vocab_size == ref.vocab_size and ours.eos_token_id == ref.eos_token_id


def test_trie_tokenizer_refuses_single_byte_merges():
    with pytest.raises(ValueError):
        ttok.TrieTokenizer([b"a"])


@pytest.mark.parametrize("V", [200, 259, 300, 4096])
def test_token_byte_strings_match_jax(V):
    for ours, ref in ((ttok.ByteTokenizer(), jtok.ByteTokenizer()),
                      (ttok.TrieTokenizer(MERGES), jtok.TrieTokenizer(MERGES))):
        assert ttm.token_byte_strings(ours, V) == jtm.token_byte_strings(ref, V)

    class Opaque:
        pass

    assert ttm.token_byte_strings(Opaque(), V) is None


def _maskers(tokenizer_kind: str, V: int):
    if tokenizer_kind == "byte":
        ours, ref = ttok.ByteTokenizer(), jtok.ByteTokenizer()
    else:
        ours, ref = ttok.TrieTokenizer(MERGES), jtok.TrieTokenizer(MERGES)
    return (ttm.GrammarTokenMasker(ttm.token_byte_strings(ours, V)),
            jtm.GrammarTokenMasker(jtm.token_byte_strings(ref, V)))


@pytest.mark.parametrize("tokenizer_kind", ["byte", "trie"])
@pytest.mark.parametrize("machine", ["json", "pet", "refs_array"])
def test_token_mask_matches_jax(tokenizer_kind, machine):
    """At random reachable states (seeded legal token walks), the port's
    mask equals the JAX masker's, and advancing by a sampled token moves
    both machines alike."""
    V = 4096 if tokenizer_kind == "byte" else 300
    ours_m, ref_m = _maskers(tokenizer_kind, V)
    rng = random.Random(len(machine) + len(tokenizer_kind))
    checked = 0
    for _ in range(10):
        if machine == "json":
            ours, ref = tg.JsonByteMachine(), jg.JsonByteMachine()
        else:
            ours, ref = _schema_machines(SCHEMA_CASES[machine][0])
        for _ in range(rng.randint(0, 30)):
            if ours.done:
                break
            mask = ours_m.token_mask(ours)
            np.testing.assert_array_equal(mask, ref_m.token_mask(ref))
            checked += 1
            legal = np.flatnonzero(mask)
            assert legal.size
            t = int(rng.choice(legal))
            ours_m.advance_token(ours, t)
            ref_m.advance_token(ref, t)
            assert ours.done == ref.done
    assert checked > 20


def test_masker_caches_by_signature():
    masker, _ = _maskers("trie", 300)
    a = masker.token_mask(tg.JsonByteMachine())
    assert masker.token_mask(tg.JsonByteMachine()) is a


# -- the engine ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    cj = dataclasses.replace(jcfg.get_preset("qwen3-tiny"), dtype="float32")
    ct = dataclasses.replace(tcfg.get_preset("qwen3-tiny"), dtype="float32")
    pj = jtr.init_params(cj, jax.random.key(0))
    pt = params_from_jax(jax.tree.map(np.asarray, pj), ct, "cpu")
    return cj, ct, pj, pt


BYTE = ttok.ByteTokenizer()
CACHE = dict(n_pages=64, page_size=16, max_pages_per_seq=16)
PET_STR = json.dumps(PET, sort_keys=True, separators=(",", ":"))
# whitespace is always legal between JSON tokens, and a random model's
# greedy choice under the mask is often a space: bias the four whitespace
# bytes away in some requests so their walks reach keys, strings and values
NO_WS = tuple((BYTE.OFFSET + b, -100.0) for b in b" \t\n\r")


def _engines(weights, cache=CACHE, tokenizer="byte", **kw):
    cj, ct, pj, pt = weights
    je = jeng.NativeEngine(cj, jkv.CacheConfig(**cache), params=pj, fused_sampling=False,
                           max_batch_size=4, **kw)
    te = teng.NativeEngine(ct, tkv.CacheConfig(**cache), params=pt, device="cpu",
                           max_batch_size=4, **kw)
    if tokenizer == "byte":
        jt, tt = jtok.ByteTokenizer(), ttok.ByteTokenizer()
    else:
        jt, tt = jtok.TrieTokenizer(MERGES), ttok.TrieTokenizer(MERGES)
    je.set_guided_vocab(jtm.token_byte_strings(jt, cj.vocab_size))
    te.set_guided_vocab(ttm.token_byte_strings(tt, ct.vocab_size))
    return je, te


def _drive(engine, make_request, make_params, waves, max_steps=600):
    """Add each wave ``(step, [(id, prompt tokens, params kwargs)])`` at its
    step and step until the engine drains → streams of (token,
    finish_reason)."""
    streams: dict[str, list] = {}
    last = max(at for at, _ in waves)
    for step in range(max_steps):
        for at, wave in waves:
            if at == step:
                for rid, prompt, kw in wave:
                    engine.add_request(make_request(rid, list(prompt), make_params(**kw)))
        if step > last and not engine.has_work():
            return streams
        for out in engine.step():
            streams.setdefault(out.request_id, []).append((out.token, out.finish_reason))
    raise AssertionError("engine did not drain")


def _pair(weights, waves, cache=CACHE, tokenizer="byte", **kw):
    je, te = _engines(weights, cache, tokenizer, **kw)
    ref = _drive(je, jeng.Request, jsamp.SamplingParams, waves)
    ours = _drive(te, teng.Request, tsamp.SamplingParams, waves)
    assert ours == ref
    assert te.sched.snapshot() == je.sched.snapshot()
    assert te.preemptions_total == je.preemptions_total
    return ours, te


def _mixed(n: int = 40, tail: int = 0):
    """Guided greedy requests of both kinds beside unguided greedy ones."""
    g = dict(temperature=0.0, max_tokens=n)
    return [
        ("obj", BYTE.encode("give me json" + "x" * tail), dict(g, guided_json=True)),
        ("obj_nows", BYTE.encode("an object please"),
         dict(g, guided_json=True, logit_bias=NO_WS)),
        ("pet", BYTE.encode("a pet:" + "y" * tail), dict(g, guided_schema=PET_STR)),
        ("plain", BYTE.encode("plain text"), dict(g, max_tokens=24)),
    ]


def _finished_docs_conform(streams, tokenizer=BYTE):
    for rid, toks in streams.items():
        if toks[-1][1] == "stop" and rid.startswith(("obj", "pet", "g")):
            doc = json.loads(tokenizer.decode([t for t, _ in toks]))
            assert isinstance(doc, dict)
            if rid.startswith("pet"):
                assert _walk(tg.SchemaByteMachine(tg.compile_schema(PET)),
                             tokenizer.decode([t for t, _ in toks]))


@pytest.mark.parametrize("burst", [1, 4])
def test_guided_greedy_streams_equal_jax(weights, burst):
    """A per-token and a burst engine: the guided rows step once a pass
    beside the bursting unguided row, and every stream equals JAX's."""
    streams, te = _pair(weights, [(0, _mixed()), (3, [
        ("late", BYTE.encode("later"), dict(temperature=0.0, max_tokens=20)),
        ("obj_late", BYTE.encode("late json"),
         dict(temperature=0.0, max_tokens=30, guided_json=True, logit_bias=NO_WS))])],
        decode_burst_steps=burst)
    _finished_docs_conform(streams)
    # whitespace-free rows open their object at once
    assert streams["obj_nows"][0][0] == BYTE.OFFSET + ord("{")
    if burst > 1:
        assert te.sched.burst_span_steps[burst] > 0  # the unguided rows did burst


def test_guided_rows_take_no_drafts_and_unguided_streams_stay(weights):
    """On a speculative engine the guided rows step without drafts and the
    streams equal JAX's; the unguided rows' streams are those of the
    engine without speculation."""
    periodic = BYTE.encode("abcabcabcabcabcabc")
    waves = [(0, _mixed() + [("rep", periodic, dict(temperature=0.0, max_tokens=30))])]
    streams, te = _pair(weights, waves, speculative_k=4)
    assert te.spec_proposed_total > 0
    _, plain = _engines(weights)
    off = _drive(plain, teng.Request, tsamp.SamplingParams, waves)
    assert streams == off
    _finished_docs_conform(streams)


def test_guided_chunked_prefill_equals_jax(weights):
    """Long guided prompts prefill in budgeted chunks, fused with the
    decode rows, and then decode under their grammar, as in JAX."""
    streams, te = _pair(weights, [(0, _mixed(30, tail=90))], token_budget=32)
    assert te.sched.snapshot()["chunks"] > 0 and te.sched.fused_steps_total > 0
    _finished_docs_conform(streams)


def test_guided_survives_preemption_as_jax(weights):
    """A fat newcomer preempts a guided row mid-object; its resume replays
    the generated tokens through a fresh machine, and the streams are
    JAX's."""
    waves = [(0, [("g", BYTE.encode("0123456789abc"),
                   dict(temperature=0.0, max_tokens=60, guided_json=True,
                        logit_bias=NO_WS))]),
             (1, [("fat", BYTE.encode("z" * 100), dict(temperature=0.0, max_tokens=20))])]
    cache = dict(n_pages=9, page_size=16, max_pages_per_seq=8)
    streams, te = _pair(weights, waves, cache, enable_prefix_caching=False)
    assert te.preemptions_total > 0
    _finished_docs_conform(streams)


def test_multibyte_guided_greedy_streams_equal_jax(weights):
    """The same on a ``TrieTokenizer`` vocab whose merges cross grammar
    boundaries."""
    tok = ttok.TrieTokenizer(MERGES)
    g = dict(temperature=0.0, max_tokens=40, guided_json=True)
    waves = [(0, [("obj", tok.encode("json"), g),
                  ("pet", tok.encode("pet"), dict(g, guided_json=False, guided_schema=PET_STR)),
                  ("plain", tok.encode("text"), dict(temperature=0.0, max_tokens=16))])]
    streams, _ = _pair(weights, waves, tokenizer="trie", decode_burst_steps=4)
    _finished_docs_conform(streams, tok)


@pytest.mark.parametrize("tokenizer", ["byte", "trie"])
def test_seeded_guided_streams_parse_and_conform(weights, tokenizer):
    _, te = _engines(weights, tokenizer=tokenizer, decode_burst_steps=4)
    tok = BYTE if tokenizer == "byte" else ttok.TrieTokenizer(MERGES)
    waves = [(0, [(f"g{i}", tok.encode(f"gen {i}"),
                   dict(temperature=1.0, seed=i, max_tokens=120, guided_json=True))
                  for i in range(2)]
              + [(f"pet{i}", tok.encode("x"),
                  dict(temperature=0.9, top_k=20, seed=40 + i, max_tokens=150,
                       guided_schema=PET_STR)) for i in range(2)])]
    streams = _drive(te, teng.Request, tsamp.SamplingParams, waves)
    _finished_docs_conform(streams, tok)
    assert any(toks[-1][1] == "stop" for toks in streams.values())


def test_guided_request_without_a_vocab_is_refused(weights):
    _, ct, _, pt = weights
    te = teng.NativeEngine(ct, tkv.CacheConfig(**CACHE), params=pt, device="cpu")
    assert not te.guided_enabled
    with pytest.raises(ValueError, match="token→byte"):
        te.add_request(teng.Request("g", [5, 6], tsamp.SamplingParams(guided_json=True)))
    te.set_guided_vocab(ttm.token_byte_strings(BYTE, ct.vocab_size))
    with pytest.raises(ValueError, match="required"):
        te.add_request(teng.Request("s", [5], tsamp.SamplingParams(
            guided_schema=json.dumps({"type": "object", "required": ["ghost"]}))))


# -- the server ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def server():
    cfg = tcfg.get_preset("qwen3-tiny")
    eng = teng.NativeEngine(cfg, tkv.CacheConfig(**CACHE), device="cpu", seed=3,
                            decode_burst_steps=4)
    srv = EngineServer(eng, host="127.0.0.1", port=0)
    srv.start()
    yield srv
    srv.stop(timeout=10)


def _post(srv, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/completions",
        data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def test_server_installs_the_vocab(server):
    assert server.engine.guided_enabled


@pytest.mark.parametrize("stream", [False, True])
def test_server_serves_response_format(server, stream):
    """json_object and json_schema through ``/v1/completions``: a stop
    finish parses (and conforms); the unguided neighbour is unaffected."""
    bodies = {
        "obj": {"prompt": "give me json", "max_tokens": 120, "temperature": 0.9, "seed": 17,
                "response_format": {"type": "json_object"}},
        "pet": {"prompt": "structured please", "max_tokens": 160, "temperature": 0.9,
                "seed": 23, "response_format": {"type": "json_schema",
                                                "json_schema": {"name": "pet", "schema": PET}}},
        "text": {"prompt": "hi", "max_tokens": 5, "temperature": 0.0,
                 "response_format": {"type": "text"}},
    }
    for name, body in bodies.items():
        with _post(server, {**body, "stream": stream}) as resp:
            if stream:
                chunks = [json.loads(raw.decode()[6:]) for raw in resp
                          if raw.startswith(b"data: {")]
                text = "".join(c["choices"][0].get("text", "") for c in chunks)
                finish = [c["choices"][0].get("finish_reason") for c in chunks][-1]
            else:
                choice = json.loads(resp.read())["choices"][0]
                text, finish = choice["text"], choice["finish_reason"]
        if name != "text" and finish == "stop":
            doc = json.loads(text)
            assert isinstance(doc, dict)
            if name == "pet":
                assert _walk(tg.SchemaByteMachine(tg.compile_schema(PET)), text)


@pytest.mark.parametrize("rf", [
    {"type": "json_schema"},
    {"type": "json_schema", "json_schema": {"name": "x", "schema": 3}},
    {"type": "json_schema", "json_schema": {"name": "bad",
                                            "schema": {"type": "object",
                                                       "required": ["ghost"]}}},
    {"type": "yaml"},
])
def test_server_refuses_bad_response_formats(server, rf):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, {"prompt": "x", "max_tokens": 2, "response_format": rf})
    assert ei.value.code == 400


def test_server_parses_response_format_like_jax(server):
    P = server._sampling_params
    assert P({}).guided_json is False and P({}).guided_schema == ""
    assert P({"response_format": {"type": "json_object"}}).guided_json
    got = P({"response_format": {"type": "json_schema",
                                 "json_schema": {"name": "p", "schema": PET}}})
    assert got.guided_schema == PET_STR and not got.guided_json
    assert P({"response_format": "json_object"}).guided_json
