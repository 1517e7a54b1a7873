"""Guided decoding: byte-level JSON grammar masking (own copy of
``fusioninfer_tpu/engine/guided.py``, plain Python and numpy).

OpenAI ``response_format: {"type": "json_object"}`` realized the
engine-native way: a pushdown automaton over BYTES tracks the JSON state
of each guided sequence, and at every sampling step the logits of all
tokens whose byte is not grammatically legal are masked to -inf — the
model can only emit syntactically valid JSON, and generation force-stops
the moment the top-level object closes.  The automata are exact at the
BYTE level, and multi-byte vocabs are lifted to token-level masks by
``engine/token_mask.py`` (a token is sampleable iff its whole byte walk
is legal).  Tokenizers with no recoverable token→byte mapping reject
guided requests up front rather than serving unconstrained output.

The automaton accepts RFC 8259 JSON with a top-level OBJECT (what
``json_object`` promises): strings with escapes and ``\\uXXXX``, numbers
with frac/exp, literals, nested arrays/objects, and inter-token
whitespace.  Output under ``finish_reason: "stop"`` always parses;
hitting ``max_tokens`` mid-object returns a prefix (``finish_reason:
"length"``), same as OpenAI.  ``response_format: {"type":
"json_schema"}`` compiles the schema (:func:`compile_schema`) into a
:class:`SchemaByteMachine` that accepts only conforming documents.
"""

from __future__ import annotations

import functools as _functools
import itertools as _itertools

import numpy as np

_WS = frozenset(b" \t\n\r")
_DIGITS = frozenset(b"0123456789")
_HEX = frozenset(b"0123456789abcdefABCDEF")
_ESCAPABLE = frozenset(b'"\\/bfnrtu')
# string content: any byte except the quote, backslash and C0 controls
_STR_BYTES = frozenset(range(0x20, 0x100)) - {0x22, 0x5C}

_LITERALS = {b"t"[0]: b"rue", b"f"[0]: b"alse", b"n"[0]: b"ull"}


def _mask(*byte_sets) -> np.ndarray:
    m = np.zeros(256, bool)
    for s in byte_sets:
        m[list(s)] = True
    return m


class JsonByteMachine:
    """Incremental byte-level JSON validator with ``allowed_bytes()``.

    States: ``top`` (before '{'), ``value`` (a value must follow),
    ``arr_first`` (value or ']' — empty array), ``string`` / ``escape`` /
    ``hex`` (pending unicode-escape digits), number states (``int_neg``,
    ``int_zero``, ``int``, ``frac_start``, ``frac``, ``exp_start``,
    ``exp_sign``, ``exp``), ``literal`` (rest of true/false/null),
    ``after`` (expect ',' or the closer), ``key`` (expect '"' or '}'),
    ``key_required`` (after ',' — '}' illegal), ``colon``, ``done``.
    """

    def __init__(self):
        self.stack: list[str] = []  # 'obj' | 'arr'
        self.state = "top"
        self._literal_rest = b""
        self._hex_left = 0
        self._in_key = False

    @property
    def done(self) -> bool:
        return self.state == "done"

    # -- token-mask support (token_mask.py) ----------------------------------

    def fork(self) -> "JsonByteMachine":
        """Cheap copy for speculative byte walks (token-trie DFS)."""
        m = JsonByteMachine.__new__(JsonByteMachine)
        m.stack = self.stack.copy()
        m.state = self.state
        m._literal_rest = self._literal_rest
        m._hex_left = self._hex_left
        m._in_key = self._in_key
        return m

    def signature(self) -> tuple:
        """Hashable EXACT state — equal signatures ⇒ identical legal
        continuations (token-mask cache key)."""
        return ("json", self.state, tuple(self.stack), self._literal_rest,
                self._hex_left, self._in_key)

    def str_run_invariant(self) -> bool:
        """True when every byte in ``_STR_BYTES`` is legal now AND
        consuming any of them preserves this property — lets the token
        masker accept whole all-string trie subtrees without walking
        them (string content is where real vocabs are fat)."""
        return self.state == "string"

    # -- allowed sets --------------------------------------------------------

    def allowed_bytes(self) -> np.ndarray:
        """[256] bool — bytes legal in the current state."""
        s = self.state
        if s == "top":
            return _mask(_WS, b"{")
        if s == "value":
            return _mask(_WS, b'{["-tfn', _DIGITS)
        if s == "arr_first":
            return _mask(_WS, b'{["-tfn]', _DIGITS)
        if s == "string":
            return _mask(_STR_BYTES, b'"\\')
        if s == "escape":
            return _mask(_ESCAPABLE)
        if s == "hex":
            return _mask(_HEX)
        if s == "literal":
            return _mask(self._literal_rest[:1])
        if s == "int_neg":
            return _mask(_DIGITS)
        if s == "int_zero":  # leading 0: no further integer digits
            return self._number_end_mask(b".eE", digits=False)
        if s == "int":
            return self._number_end_mask(b".eE")
        if s == "frac_start":
            return _mask(_DIGITS)
        if s == "frac":
            return self._number_end_mask(b"eE")
        if s == "exp_start":
            return _mask(_DIGITS, b"+-")
        if s == "exp_sign":
            return _mask(_DIGITS)
        if s == "exp":
            return self._number_end_mask(b"")
        if s == "after":
            closer = b"}" if self.stack[-1] == "obj" else b"]"
            return _mask(_WS, b",", closer)
        if s == "key":
            return _mask(_WS, b'"}')
        if s == "key_required":
            return _mask(_WS, b'"')
        if s == "colon":
            return _mask(_WS, b":")
        if s == "done":
            return np.zeros(256, bool)
        raise AssertionError(f"unknown state {s}")

    def _number_end_mask(self, extra: bytes, digits: bool = True) -> np.ndarray:
        """A number may continue (digits/``extra``) or terminate on
        whitespace, ',' or the enclosing closer."""
        closer = b"}" if self.stack[-1] == "obj" else b"]"
        sets = [_WS, b",", closer, extra]
        if digits:
            sets.append(_DIGITS)
        return _mask(*sets)

    # -- transitions ---------------------------------------------------------

    def advance(self, byte: int) -> None:
        """Consume one byte; raises ValueError on a byte the current
        ``allowed_bytes`` would have masked (engine bug or direct misuse)."""
        if not self.allowed_bytes()[byte]:
            raise ValueError(f"byte {byte!r} illegal in state {self.state}")
        s, b = self.state, byte
        if b in _WS:
            if s in ("int_zero", "int", "frac", "exp"):
                self.state = "after"  # whitespace terminates a number
            return
        if s in ("int_zero", "int", "frac", "exp") and b in b",}]":
            # number terminated by a structural byte: close the value,
            # re-dispatch the byte in the 'after' state
            self.state = "after"
            self.advance(b)
            return

        if s == "top":
            self.stack.append("obj")
            self.state = "key"
        elif s in ("value", "arr_first"):
            if s == "arr_first" and b == b"]"[0]:
                self.stack.pop()
                self.state = "done" if not self.stack else "after"
            else:
                self._start_value(b)
        elif s == "string":
            if b == 0x22:
                if self._in_key:
                    self._in_key = False
                    self.state = "colon"
                else:
                    self.state = "after"
            elif b == 0x5C:
                self.state = "escape"
        elif s == "escape":
            if b == b"u"[0]:
                self._hex_left = 4
                self.state = "hex"
            else:
                self.state = "string"
        elif s == "hex":
            self._hex_left -= 1
            if self._hex_left == 0:
                self.state = "string"
        elif s == "literal":
            self._literal_rest = self._literal_rest[1:]
            if not self._literal_rest:
                self.state = "after"
        elif s == "int_neg":
            self.state = "int_zero" if b == b"0"[0] else "int"
        elif s in ("int_zero", "int"):
            if b == b"."[0]:
                self.state = "frac_start"
            elif b in b"eE":
                self.state = "exp_start"
            # else: a digit continuing 'int'
        elif s == "frac_start":
            self.state = "frac"
        elif s == "frac":
            if b in b"eE":
                self.state = "exp_start"
        elif s == "exp_start":
            self.state = "exp_sign" if b in b"+-" else "exp"
        elif s == "exp_sign":
            self.state = "exp"
        elif s == "exp":
            pass  # a digit extending the exponent
        elif s == "after":
            if b == b","[0]:
                self.state = ("key_required" if self.stack[-1] == "obj"
                              else "value")
            else:
                self.stack.pop()
                self.state = "done" if not self.stack else "after"
        elif s in ("key", "key_required"):
            if b == 0x22:
                self._in_key = True
                self.state = "string"
            else:  # '}' closing an empty object (state 'key' only)
                self.stack.pop()
                self.state = "done" if not self.stack else "after"
        elif s == "colon":
            self.state = "value"
        else:  # pragma: no cover
            raise AssertionError(f"advance from {s}")

    def _start_value(self, b: int) -> None:
        if b == b"{"[0]:
            self.stack.append("obj")
            self.state = "key"
        elif b == b"["[0]:
            self.stack.append("arr")
            self.state = "arr_first"
        elif b == 0x22:
            self._in_key = False
            self.state = "string"
        elif b == b"-"[0]:
            self.state = "int_neg"
        elif b == b"0"[0]:
            self.state = "int_zero"
        elif b in _DIGITS:
            self.state = "int"
        else:  # t / f / n
            self._literal_rest = _LITERALS[b]
            self.state = "literal"


# -- schema-constrained decoding (response_format: json_schema) --------------
#
# OpenAI's ``json_schema`` response format guarantees output CONFORMING
# to a user schema, not merely valid JSON.  vLLM gives the reference's
# users this via xgrammar/outlines backends (engine-flag passthrough);
# here the schema compiles to a node tree and a frame-stack interpreter
# walks it byte by byte with the same ``allowed_bytes()``/``advance()``
# interface the engine already masks through.
#
# Enforced subset (the structural core): ``type`` (incl. lists),
# ``properties`` / ``required`` / ``additionalProperties``, ``items`` /
# ``minItems`` / ``maxItems``, ``enum`` / ``const``, ``anyOf``/``oneOf``.
# Value-range keywords (pattern/format/minimum/...) are not byte-wise
# enforceable and are ignored; the root must be an object (OpenAI strict
# mode requires this too — a bare root number has no byte at which the
# machine could *know* it is finished).


def _dump(v) -> bytes:
    import json

    return json.dumps(v, separators=(",", ":"), ensure_ascii=True).encode()


_NODE_UIDS = _itertools.count(1)


def _node(d: dict) -> dict:
    """Stamp a compiled node with a process-unique ``uid``.  Machine
    signatures (used as token-mask cache keys, ``token_mask.py``) refer
    to nodes by uid rather than ``id()`` — ids get recycled after gc,
    which could alias two different schemas' cache entries."""
    d["uid"] = next(_NODE_UIDS)
    return d


_ANY: dict = _node({"kind": "any"})


# structural keywords the byte machine cannot enforce: compiling them to
# "anything" would return finish_reason "stop" output that silently
# violates the user's contract — reject at admission instead.  $ref and
# allOf ARE supported (local refs resolve, allOf merges at compile time
# — pydantic/zod-exported schemas are made of them); what remains here
# is genuinely un-byte-enforceable.
_UNSUPPORTED_KEYWORDS = ("not", "if", "then", "else",
                         "patternProperties", "propertyNames",
                         "unevaluatedProperties", "prefixItems", "contains")

# keys that carry no byte-wise constraint: ignored by the compiler and
# excluded when deciding whether a $ref has constraint siblings
_METADATA_KEYS = frozenset((
    "$defs", "definitions", "$schema", "$id", "$comment", "title",
    "description", "default", "examples", "deprecated", "readOnly",
    "writeOnly", "format", "pattern", "minimum", "maximum",
    "exclusiveMinimum", "exclusiveMaximum", "multipleOf", "minLength",
    "maxLength", "minProperties", "maxProperties", "uniqueItems"))


def compile_schema(schema) -> dict:
    """JSON schema (dict) → node tree; raises ValueError on schemas the
    byte machine cannot enforce (so the server 400s instead of serving
    output that silently violates the contract).

    Local ``$ref`` (``#/$defs/...`` / ``#/definitions/...``) resolve
    against the document root — including RECURSIVE references, which
    compile to a cyclic node graph the frame-stack machine interprets
    lazily.  ``allOf`` merges its members' structural constraints at
    compile time (pydantic's exporter wraps nearly every nested model in
    one).  Union first-byte disjointness is validated in a post-pass
    over the finished graph (cycle-safe), since a union alternative may
    reference a node still being built."""
    try:
        node = _compile(schema, schema, {})
        _validate_graph(node)
    except RecursionError:
        raise ValueError("schema nesting too deep to compile") from None
    return node


def _compile(schema, root, memo: dict) -> dict:
    if schema is True or schema == {}:
        return _ANY
    if not isinstance(schema, dict):
        raise ValueError(f"unsupported schema: {schema!r}")
    for kw in _UNSUPPORTED_KEYWORDS:
        if kw in schema:
            raise ValueError(
                f"unsupported schema keyword {kw!r} — guided generation "
                "enforces the structural subset (type/properties/required/"
                "additionalProperties/items/minItems/maxItems/enum/const/"
                "anyOf/oneOf/allOf/$ref)")
    if "$ref" in schema or "allOf" in schema:
        siblings = [k for k in schema
                    if k not in _METADATA_KEYS and k != "$ref"]
        if "$ref" in schema and not siblings:
            # pure reference: memoize by pointer so recursive schemas
            # (linked lists, trees) compile to a finite cyclic graph
            ptr = schema["$ref"]
            hit = memo.get(ptr)
            if hit is not None:
                return hit
            memo[ptr] = placeholder = _node({})
            built = _compile(_deref(root, ptr), root, memo)
            placeholder.update(built)  # fill in place: cycles resolve
            if "kind" not in placeholder:
                raise ValueError(
                    f"$ref {ptr!r} resolves only through other $refs — "
                    "no concrete schema to enforce")
            return placeholder
        # allOf (or $ref with constraint siblings): expand every
        # fragment and merge the structural constraints
        return _compile(_merge_fragments(_expand(schema, root, 0)),
                        root, memo)
    if "enum" in schema or "const" in schema:
        values = schema["enum"] if "enum" in schema else [schema["const"]]
        if not values:
            raise ValueError("enum must be non-empty")
        return _node({"kind": "enum", "opts": tuple(_dump(v) for v in values)})
    for key in ("anyOf", "oneOf"):
        if key in schema:
            if any(k not in _METADATA_KEYS and k != key for k in schema):
                # sibling constraints apply IN ADDITION to the union per
                # JSON Schema; compiling the union alone would silently
                # drop them
                raise ValueError(
                    f"{key} with sibling constraint keywords is not "
                    "byte-wise enforceable")
            return _union(tuple(_compile(s, root, memo)
                                for s in schema[key]))
    t = schema.get("type")
    if isinstance(t, list):
        return _union(tuple(_compile(dict(schema, type=tt), root, memo)
                            for tt in t))
    if t == "object":
        props = {
            name.encode(): _compile(sub, root, memo)
            for name, sub in (schema.get("properties") or {}).items()
        }
        required = []
        for name in schema.get("required", ()):
            nb = name.encode()
            if nb not in props:
                raise ValueError(
                    f"required property {name!r} must be declared in "
                    "properties for guided generation")
            required.append(nb)
        addl = schema.get("additionalProperties", True)
        addl_node = None if addl is False else _compile(
            _coerce_bool_schema(addl), root, memo)
        # "x-ordered" (in-repo extension): keys must be emitted in the
        # given order — streaming tool calls rely on the function name
        # being decided before the arguments open.  MUST be a list: the
        # canonical schema string sorts dict keys, so declaration order
        # would not survive the wire (server.py:_sampling_params).
        ordered = schema.get("x-ordered", False)
        order = None
        if ordered:
            if ordered is True:
                # dict declaration order does NOT survive the canonical
                # (key-sorted) schema string, so a bare true would
                # silently enforce ALPHABETICAL order — reject instead
                raise ValueError(
                    "x-ordered must be an explicit list of property "
                    "names (declaration order does not survive schema "
                    "canonicalization)")
            order = tuple(str(n).encode() for n in ordered)
            if set(order) != set(props) or len(order) != len(props):
                raise ValueError(
                    "x-ordered must list every declared property "
                    "exactly once")
            if addl_node is not None:
                raise ValueError(
                    "x-ordered requires additionalProperties: false")
        return _node({"kind": "object", "props": props,
                      "required": frozenset(required), "addl": addl_node,
                      "order": order})
    if t == "array":
        lo = int(schema.get("minItems", 0))
        hi = int(schema["maxItems"]) if "maxItems" in schema else None
        if hi is not None and lo > hi:
            # contradictory bounds would deadlock generation into
            # whitespace-only output (neither ',' nor ']' ever legal)
            raise ValueError(f"minItems {lo} > maxItems {hi}")
        return _node({"kind": "array",
                      "items": _compile(
                          _coerce_bool_schema(schema.get("items", True)),
                          root, memo),
                      "min": lo, "max": hi})
    if t == "string":
        return _node({"kind": "string"})
    if t == "number":
        return _node({"kind": "number"})
    if t == "integer":
        return _node({"kind": "integer"})
    if t == "boolean":
        return _node({"kind": "enum", "opts": (b"true", b"false")})
    if t == "null":
        return _node({"kind": "enum", "opts": (b"null",)})
    if t is None:
        return _ANY
    raise ValueError(f"unsupported schema type {t!r}")


def _deref(root, ptr: str):
    """Resolve a LOCAL JSON pointer (``#/...``) against the document
    root.  Remote/URL refs cannot be fetched from a serving engine."""
    if not isinstance(ptr, str) or not ptr.startswith("#"):
        raise ValueError(
            f"only local $ref pointers (#/...) are supported, got {ptr!r}")
    target = root
    for part in ptr[1:].split("/"):
        if not part:
            continue
        part = part.replace("~1", "/").replace("~0", "~")
        if isinstance(target, dict) and part in target:
            target = target[part]
        elif isinstance(target, list) and part.isdigit() \
                and int(part) < len(target):
            target = target[int(part)]
        else:
            raise ValueError(f"$ref {ptr!r} does not resolve")
    return target


def _expand(s, root, depth: int) -> list:
    """A schema with ``$ref``/``allOf`` → flat list of plain constraint
    fragments.  Depth-bounded: a $ref cycle reachable through allOf has
    no finite merged form (unlike pure refs, which stay lazy)."""
    if depth > 64:
        raise ValueError(
            "$ref/allOf nesting too deep — recursive references cannot "
            "be merged under allOf")
    if not isinstance(s, dict):
        s = _coerce_bool_schema(s)
    base = {k: v for k, v in s.items() if k not in ("$ref", "allOf")}
    frags = [base] if any(k not in _METADATA_KEYS for k in base) else []
    if "$ref" in s:
        frags += _expand(_deref(root, s["$ref"]), root, depth + 1)
    for sub in s.get("allOf", ()):
        frags += _expand(sub, root, depth + 1)
    return frags


def _merge_fragments(frags: list) -> dict:
    """Merge constraint fragments under allOf-intersection semantics.
    Structural keywords compose (properties merge per-key via nested
    allOf, required unions, bounds tighten, enums intersect); a
    combination whose intersection the byte machine cannot express
    (e.g. anyOf in more than one fragment) is rejected loudly."""
    out: dict = {}
    for f in frags:
        for k, v in f.items():
            if k in _METADATA_KEYS:
                continue
            if k not in out:
                out[k] = v
                continue
            cur = out[k]
            if k == "type":
                cur_set = set(cur) if isinstance(cur, list) else {cur}
                new_set = set(v) if isinstance(v, list) else {v}
                both = cur_set & new_set
                # integer is a subtype of number: their meet is integer —
                # but only ACROSS the two fragments (one side must say
                # number, the other integer; both names on the same side
                # prove nothing about the intersection)
                if not both and (
                        ("integer" in cur_set and "number" in new_set)
                        or ("number" in cur_set and "integer" in new_set)):
                    both = {"integer"}
                if not both:
                    raise ValueError(
                        f"allOf: no type satisfies both {sorted(cur_set)} "
                        f"and {sorted(new_set)}")
                out[k] = sorted(both) if len(both) > 1 else both.pop()
            elif k == "properties":
                merged = dict(cur)
                for name, sub in v.items():
                    merged[name] = ({"allOf": [merged[name], sub]}
                                    if name in merged else sub)
                out[k] = merged
            elif k == "required":
                out[k] = sorted(set(cur) | set(v))
            elif k == "additionalProperties":
                if cur is False or v is False:
                    out[k] = False
                elif cur is True:
                    out[k] = v
                elif v is not True:
                    out[k] = {"allOf": [cur, v]}
            elif k == "items":
                if cur is not v:
                    out[k] = {"allOf": [cur, v]}
            elif k == "minItems":
                out[k] = max(int(cur), int(v))
            elif k == "maxItems":
                out[k] = min(int(cur), int(v))
            elif k in ("enum", "const"):
                cur_vals = cur if k == "enum" else [cur]
                new_vals = v if k == "enum" else [v]
                keep = [x for x in cur_vals
                        if any(_dump(x) == _dump(y) for y in new_vals)]
                if not keep:
                    raise ValueError("allOf: enum/const intersection is empty")
                out[k] = keep if k == "enum" else keep[0]
            elif k in ("anyOf", "oneOf"):
                raise ValueError(
                    "allOf combining multiple anyOf/oneOf branches is not "
                    "byte-wise enforceable")
            elif cur != v:
                raise ValueError(
                    f"allOf: conflicting values for {k!r}: {cur!r} vs {v!r}")
    if "enum" in out and "const" in out:
        keep = [x for x in out["enum"] if _dump(x) == _dump(out["const"])]
        if not keep:
            raise ValueError("allOf: enum/const intersection is empty")
        del out["enum"]
        out["const"] = keep[0]
    if ("anyOf" in out or "oneOf" in out) and any(
            k not in _METADATA_KEYS and k not in ("anyOf", "oneOf")
            for k in out):
        # _compile's anyOf branch would silently drop the sibling
        # constraints — the union's alternatives would need the other
        # fragments distributed into them, which is beyond byte-wise
        # enforcement; reject loudly per the module contract
        raise ValueError(
            "allOf combining anyOf/oneOf with other constraints is not "
            "byte-wise enforceable")
    return out


def _coerce_bool_schema(s):
    if s is True:
        return {}
    if s is False:
        raise ValueError("'false' subschemas cannot guide generation")
    return s


def _union(alts: tuple) -> dict:
    """Union node.  Valid only when the first byte DECIDES the
    alternative — validated in :func:`_validate_graph` once the whole
    graph is built (an alternative may be a $ref placeholder here)."""
    if len(alts) == 1:
        return alts[0]
    return _node({"kind": "union", "alts": alts})


def _validate_graph(node: dict) -> None:
    """Post-compile pass over the (possibly cyclic) node graph: every
    union's alternatives must be first-byte disjoint — otherwise
    generation would silently commit to whichever alternative matched
    first, making the others unreachable.  Per this module's contract
    that is a loud admission-time rejection, not a silent narrowing."""
    seen: set = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        kind = n.get("kind")
        if kind is None:
            raise ValueError("schema compiled to an empty node")  # pragma: no cover
        if kind == "union":
            alts = n["alts"]
            for i, a in enumerate(alts):
                for b in alts[i + 1:]:
                    if (_first_byte_mask(a) & _first_byte_mask(b)).any():
                        raise ValueError(
                            "anyOf/oneOf/type-list alternatives must be "
                            "distinguishable by their first byte (e.g. "
                            '["string", "null"]); overlapping alternatives '
                            "cannot be byte-wise enforced")
            stack.extend(alts)
        elif kind == "object":
            stack.extend(n["props"].values())
            if n["addl"] is not None:
                stack.append(n["addl"])
        elif kind == "array":
            stack.append(n["items"])


@_functools.lru_cache(maxsize=256)
def compile_schema_str(canonical: str) -> dict:
    """Memoized compile keyed on the canonical schema string — the
    server's 400 check, engine admission, and sequence start all share
    ONE compile per distinct schema (nodes are read-only at runtime)."""
    import json

    return compile_schema(json.loads(canonical))


# first byte → which value alternative it starts
def _first_byte_mask(node, _seen=None) -> np.ndarray:
    kind = node["kind"]
    if kind == "object":
        return _mask(b"{")
    if kind == "array":
        return _mask(b"[")
    if kind == "string":
        return _mask(b'"')
    if kind in ("number", "integer"):
        return _mask(_DIGITS, b"-")
    if kind == "enum":
        return _mask(bytes(o[0] for o in node["opts"]))
    if kind == "union":
        # a $ref cycle threading ONLY unions (X = anyOf[$ref X, ...])
        # makes no byte progress — reject instead of recursing forever
        _seen = set() if _seen is None else _seen
        if id(node) in _seen:
            raise ValueError(
                "$ref cycle through anyOf/oneOf alternatives — the "
                "alternative never reaches a concrete first byte")
        _seen.add(id(node))
        m = np.zeros(256, bool)
        for alt in node["alts"]:
            m |= _first_byte_mask(alt, _seen)
        return m
    if kind == "any":
        return _mask(b'{["-tfn', _DIGITS)
    raise AssertionError(kind)


_ANY_OBJECT = _node({"kind": "object", "props": {}, "required": frozenset(),
                     "addl": _ANY})
_ANY_ARRAY = _node({"kind": "array", "items": _ANY, "min": 0, "max": None})
# the concrete values an "any" resolves to — module constants so their
# uids are stable for the life of the process (token-mask cache keys)
_ANY_STRING = _node({"kind": "string"})
_ANY_NUMBER = _node({"kind": "number"})
_ANY_TRUE = _node({"kind": "enum", "opts": (b"true",)})
_ANY_FALSE = _node({"kind": "enum", "opts": (b"false",)})
_ANY_NULL = _node({"kind": "enum", "opts": (b"null",)})


def _resolve_alt(node, b: int):
    """The concrete alternative of ``node`` that byte ``b`` starts."""
    if node["kind"] == "union":
        for alt in node["alts"]:
            if _first_byte_mask(alt)[b]:
                return _resolve_alt(alt, b)
        raise AssertionError(f"byte {b!r} matched no union alternative")
    if node["kind"] == "any":
        c = bytes([b])
        if c == b"{":
            return _ANY_OBJECT
        if c == b"[":
            return _ANY_ARRAY
        if c == b'"':
            return _ANY_STRING
        if c == b"-" or b in _DIGITS:
            return _ANY_NUMBER
        if c == b"t":
            return _ANY_TRUE
        if c == b"f":
            return _ANY_FALSE
        if c == b"n":
            return _ANY_NULL
        raise AssertionError(f"byte {b!r} starts no JSON value")
    return node


class SchemaByteMachine:
    """Schema-constrained sibling of :class:`JsonByteMachine`: same
    ``allowed_bytes()`` / ``advance()`` / ``done`` surface, but the
    legal-byte sets come from a compiled schema node tree — object keys
    walk a byte-trie of the declared properties, '}' requires every
    ``required`` key seen, arrays enforce min/maxItems, enums emit one
    of their serialized options byte-for-byte.

    Output is COMPACT: inter-token whitespace is masked (unlike the
    ``json_object`` machine, which allows it).  Every emitted byte then
    makes progress toward completion — optional whitespace both wastes
    tokens on a real model and lets a weak model meander to max_tokens
    without ever closing the object (xgrammar's default is compact for
    the same reason).
    """

    def __init__(self, node: dict):
        if node["kind"] != "object":
            raise ValueError(
                "json_schema guided decoding requires a top-level object "
                "schema (OpenAI strict mode does too)")
        self._stack: list[dict] = [{"t": "value", "node": node}]

    @property
    def done(self) -> bool:
        return not self._stack

    # -- token-mask support (token_mask.py) ----------------------------------

    def fork(self) -> "SchemaByteMachine":
        m = SchemaByteMachine.__new__(SchemaByteMachine)
        m._stack = [self._copy_frame(f) for f in self._stack]
        return m

    @staticmethod
    def _copy_frame(f: dict) -> dict:
        g = dict(f)
        if f["t"] == "obj":
            g["seen"] = set(f["seen"])
            key = f.get("key")
            if key is not None:
                k = dict(key)
                k["cands"] = list(key["cands"])
                k["dec"] = bytearray(key["dec"])
                g["key"] = k
        return g

    def signature(self) -> tuple:
        """Hashable EXACT state (token-mask cache key).  Compiled nodes
        are referenced by their ``uid`` — process-unique, never recycled
        (unlike ``id()``), so entries from different schemas can't
        alias."""
        sig = []
        for f in self._stack:
            t = f["t"]
            if t == "value":
                sig.append((t, f["node"]["uid"]))
            elif t == "obj":
                key = f.get("key")
                ksig = None
                if key is not None:
                    ksig = (tuple(nb for nb, _ in key["cands"]), key["pos"],
                            key["free"], key["esc"], bytes(key["dec"]),
                            key.get("hexbuf", ""))
                vnode = f.get("vnode")
                sig.append((t, f["node"]["uid"], frozenset(f["seen"]),
                            f["phase"], ksig,
                            vnode["uid"] if vnode is not None else None))
            elif t == "arr":
                sig.append((t, f["node"]["uid"], f["count"], f["phase"]))
            elif t == "str":
                sig.append((t, f["sub"], f["hex_left"]))
            elif t == "num":
                sig.append((t, f["integer"], f["state"]))
            else:  # enum
                sig.append((t, f["opts"], f["pos"]))
        return ("schema", tuple(sig))

    def str_run_invariant(self) -> bool:
        """See :meth:`JsonByteMachine.str_run_invariant`.  True in value
        string content, and in key states where arbitrary content bytes
        are legal (free mode, or any state under additionalProperties —
        trie-follow with ``addl=None`` constrains bytes, so it is NOT
        invariant)."""
        if not self._stack:
            return False
        f = self._stack[-1]
        if f["t"] == "str":
            return f["sub"] == "content"
        if f["t"] == "obj":
            key = f.get("key")
            if key is not None:
                return key["esc"] is None and (
                    key["free"] or f["node"]["addl"] is not None)
        return False

    # -- allowed sets --------------------------------------------------------

    def allowed_bytes(self) -> np.ndarray:
        if not self._stack:
            return np.zeros(256, bool)
        return self._frame_allowed(len(self._stack) - 1)

    def _frame_allowed(self, idx: int) -> np.ndarray:
        f = self._stack[idx]
        t = f["t"]
        if t == "value":
            return _first_byte_mask(f["node"])
        if t == "obj":
            return self._obj_allowed(f)
        if t == "arr":
            node, phase = f["node"], f["phase"]
            m = np.zeros(256, bool)
            if phase == "first":
                if node["max"] is None or node["max"] > 0:
                    m |= _first_byte_mask(node["items"])
                if node["min"] == 0:
                    m |= _mask(b"]")
            else:  # after a value
                if node["max"] is None or f["count"] < node["max"]:
                    m |= _mask(b",")
                if f["count"] >= node["min"]:
                    m |= _mask(b"]")
            return m
        if t == "str":
            if f["sub"] == "escape":
                return _mask(_ESCAPABLE)
            if f["sub"] == "hex":
                return _mask(_HEX)
            return _mask(_STR_BYTES, b'"\\')
        if t == "num":
            return self._num_allowed(f, idx)
        if t == "enum":
            conts = bytes({o[f["pos"]] for o in f["opts"]
                           if len(o) > f["pos"]})
            m = _mask(conts)
            if any(len(o) == f["pos"] for o in f["opts"]):
                m |= self._after_pop_allowed(idx)
            return m
        raise AssertionError(t)

    @staticmethod
    def _unseen_candidates(node: dict, seen: set) -> list:
        """Declared names still emittable as the NEXT key: all unseen
        props, or — under the x-ordered extension — only the first
        unseen name in declaration order."""
        order = node.get("order")
        if order is not None:
            nxt = next((nb for nb in order if nb not in seen), None)
            return [nxt] if nxt is not None else []
        return [nb for nb in node["props"] if nb not in seen]

    def _obj_allowed(self, f: dict) -> np.ndarray:
        node, phase = f["node"], f["phase"]
        key = f.get("key")
        if key is not None:
            return self._key_allowed(f, key)
        m = np.zeros(256, bool)
        if phase in ("first", "key_required"):
            unseen = self._unseen_candidates(node, f["seen"])
            if unseen or node["addl"] is not None:
                m |= _mask(b'"')
            if phase == "first" and node["required"] <= f["seen"]:
                m |= _mask(b"}")
        elif phase == "colon":
            m |= _mask(b":")
        elif phase == "after":
            unseen = self._unseen_candidates(node, f["seen"])
            if unseen or node["addl"] is not None:
                m |= _mask(b",")
            if node["required"] <= f["seen"]:
                m |= _mask(b"}")
        return m

    def _key_allowed(self, f: dict, key: dict) -> np.ndarray:
        if key["esc"] == "escape":
            return _mask(_ESCAPABLE)
        if key["esc"] == "hex":
            return _mask(_HEX)
        node = f["node"]
        if key["free"] or node["addl"] is not None:
            m = _mask(_STR_BYTES, b"\\")
            # closing here names bytes(dec): a declared name binds its
            # property schema — but a SEEN one would be a duplicate key
            # whose last-wins value could violate the schema, so the
            # quote is only legal when the decoded name is bindable
            # (declared-and-unseen, or addl-typed).  Set, don't just
            # clear: with addl=None a free key (entered via an escape in
            # a declared name) must still be able to close on a match.
            m[0x22] = self._key_close_ok(f, key)
            return m
        pos = key["pos"]
        conts = bytes({nb[pos] for nb, _ in key["cands"] if len(nb) > pos})
        m = _mask(conts)
        if self._key_close_ok(f, key):
            m |= _mask(b'"')
        return m

    def _key_close_ok(self, f: dict, key: dict) -> bool:
        name = bytes(key["dec"])
        if name in f["node"]["props"]:
            if name in f["seen"]:
                return False
            # x-ordered: an escape-spelled declared name must still be
            # the NEXT name in declaration order to bind
            return name in self._unseen_candidates(f["node"], f["seen"])
        return f["node"]["addl"] is not None

    def _num_allowed(self, f: dict, idx: int) -> np.ndarray:
        s = f["state"]
        if s == "neg":
            return _mask(_DIGITS)
        if s == "frac_start":
            return _mask(_DIGITS)
        if s == "exp_start":
            return _mask(_DIGITS, b"+-")
        if s == "exp_sign":
            return _mask(_DIGITS)
        cont = {
            "zero": b"." + (b"" if f["integer"] else b"eE"),
            "int": bytes(_DIGITS) + b"." + (b"" if f["integer"] else b"eE"),
            "frac": bytes(_DIGITS) + b"eE",
            "exp": bytes(_DIGITS),
        }[s]
        if f["integer"] and s in ("zero", "int"):
            cont = cont.replace(b".", b"")
        return _mask(cont) | self._after_pop_allowed(idx)

    def _after_pop_allowed(self, idx: int) -> np.ndarray:
        """What the parent would allow right after this frame completes
        — the termination set for self-delimiting values (numbers, bare
        enums like ``true``) whose end only a structural byte reveals.
        Computed from the parent's REAL post-value state: '}' only once
        every required key is seen, ']' only at/above minItems — the
        redispatched byte never gets a second mask check, so this set
        must already be exact."""
        if idx == 0:
            return np.zeros(256, bool)  # root value ends → machine done
        parent = self._stack[idx - 1]
        if parent["t"] == "obj":
            node, seen = parent["node"], parent["seen"]
            m = np.zeros(256, bool)
            unseen = any(nb not in seen for nb in node["props"])
            if unseen or node["addl"] is not None:
                m |= _mask(b",")
            if node["required"] <= seen:
                m |= _mask(b"}")
            return m
        if parent["t"] == "arr":
            node = parent["node"]
            count_after = parent["count"] + 1  # incl. the completing value
            m = np.zeros(256, bool)
            if node["max"] is None or count_after < node["max"]:
                m |= _mask(b",")
            if count_after >= node["min"]:
                m |= _mask(b"]")
            return m
        return np.zeros(256, bool)

    # -- transitions ---------------------------------------------------------

    def advance(self, byte: int) -> None:
        if not self.allowed_bytes()[byte]:
            raise ValueError(
                f"byte {byte!r} illegal for frame {self._stack[-1]['t'] if self._stack else 'done'}")
        self._dispatch(byte)

    def _dispatch(self, b: int) -> None:
        f = self._stack[-1]
        t = f["t"]
        if t == "value":
            self._stack.pop()
            self._start_value(_resolve_alt(f["node"], b), b)
        elif t == "obj":
            self._obj_advance(f, b)
        elif t == "arr":
            self._arr_advance(f, b)
        elif t == "str":
            self._str_advance(f, b)
        elif t == "num":
            self._num_advance(f, b)
        elif t == "enum":
            self._enum_advance(f, b)
        else:  # pragma: no cover
            raise AssertionError(t)

    def _start_value(self, node: dict, b: int) -> None:
        kind = node["kind"]
        if kind == "object":
            self._stack.append({"t": "obj", "node": node, "seen": set(),
                                "phase": "first", "key": None})
        elif kind == "array":
            self._stack.append({"t": "arr", "node": node, "count": 0,
                                "phase": "first"})
        elif kind == "string":
            self._stack.append({"t": "str", "sub": "content", "hex_left": 0})
        elif kind in ("number", "integer"):
            state = {45: "neg", 48: "zero"}.get(b, "int")
            self._stack.append({"t": "num", "integer": kind == "integer",
                                "state": state})
        elif kind == "enum":
            opts = tuple(o for o in node["opts"] if o[0] == b)
            self._stack.append({"t": "enum", "opts": opts, "pos": 1})
            self._enum_maybe_finish()
        else:  # pragma: no cover
            raise AssertionError(kind)

    def _value_done(self) -> None:
        """Top frame's value completed (its closing byte consumed)."""
        self._stack.pop()
        if not self._stack:
            return  # root object closed — machine done
        parent = self._stack[-1]
        if parent["t"] == "obj":
            parent["phase"] = "after"
        elif parent["t"] == "arr":
            parent["count"] += 1
            parent["phase"] = "after"

    def _obj_advance(self, f: dict, b: int) -> None:
        key = f.get("key")
        if key is not None:
            return self._key_advance(f, key, b)
        node, phase = f["node"], f["phase"]
        c = bytes([b])
        if phase in ("first", "key_required") and c == b'"':
            nxt = self._unseen_candidates(node, f["seen"])
            f["key"] = {
                "cands": [(nb, node["props"][nb]) for nb in nxt],
                "pos": 0, "free": False, "esc": None, "dec": bytearray(),
            }
        elif phase == "first" and c == b"}":
            self._value_done()
        elif phase == "colon":  # ':'
            f["phase"] = "value"
            self._stack.append({"t": "value", "node": f.pop("vnode")})
        elif phase == "after":
            if c == b",":
                f["phase"] = "key_required"
            else:  # '}'
                self._value_done()
        else:  # pragma: no cover
            raise AssertionError((phase, c))

    _KEY_ESCAPES = {0x22: 0x22, 0x5C: 0x5C, 0x2F: 0x2F, 0x62: 0x08,
                    0x66: 0x0C, 0x6E: 0x0A, 0x72: 0x0D, 0x74: 0x09}

    def _key_advance(self, f: dict, key: dict, b: int) -> None:
        # key["dec"] accumulates the DECODED key bytes (escapes resolved)
        # so the close gate compares real names — "name" is "name"
        if key["esc"] == "escape":
            if b == b"u"[0]:
                key["esc"] = "hex"
                key["hexbuf"] = ""
            else:
                key["dec"].append(self._KEY_ESCAPES[b])
                key["esc"] = None
            return
        if key["esc"] == "hex":
            key["hexbuf"] += chr(b)
            if len(key["hexbuf"]) == 4:
                # surrogatepass: lone surrogates (\uD800-\uDFFF halves of
                # a pair) are legal JSON escapes; plain utf-8 encoding
                # raises on them, and the mask already admitted the hex
                # digits — dec is only compared against declared names
                # (real UTF-8), which WTF-8 surrogate bytes never equal
                key["dec"] += chr(int(key["hexbuf"], 16)).encode(
                    "utf-8", "surrogatepass")
                key["esc"] = None
            return
        if b == 0x22:  # closing quote: bind the key (mask vetted it)
            name = bytes(key["dec"])
            props = f["node"]["props"]
            if name in props:
                f["seen"].add(name)
                f["vnode"] = props[name]
            else:
                f["vnode"] = f["node"]["addl"]
            f["key"] = None
            f["phase"] = "colon"
            return
        if b == 0x5C:
            key["free"] = True  # escapes only make sense off-trie
            key["esc"] = "escape"
            return
        key["dec"].append(b)
        if not key["free"]:
            nxt = [(nb, pn) for nb, pn in key["cands"]
                   if len(nb) > key["pos"] and nb[key["pos"]] == b]
            if nxt:
                key["cands"] = nxt
                key["pos"] += 1
                return
            key["free"] = True  # diverged → additionalProperties key
        # free-mode content byte: tracked in dec above

    def _arr_advance(self, f: dict, b: int) -> None:
        c = bytes([b])
        if c == b"]":
            self._value_done()
        elif c == b",":
            self._stack.append({"t": "value", "node": f["node"]["items"]})
        else:  # first element's first byte
            self._start_value(_resolve_alt(f["node"]["items"], b), b)

    def _str_advance(self, f: dict, b: int) -> None:
        if f["sub"] == "escape":
            if b == b"u"[0]:
                f["sub"], f["hex_left"] = "hex", 4
            else:
                f["sub"] = "content"
        elif f["sub"] == "hex":
            f["hex_left"] -= 1
            if f["hex_left"] == 0:
                f["sub"] = "content"
        elif b == 0x22:
            self._value_done()
        elif b == 0x5C:
            f["sub"] = "escape"

    def _num_advance(self, f: dict, b: int) -> None:
        s = f["state"]
        can_end = s in ("zero", "int", "frac", "exp")
        if can_end and bytes([b]) in (b",", b"}", b"]"):
            self._value_done()
            self._dispatch(b)  # structural byte belongs to the parent
            return
        if s == "neg":
            f["state"] = "zero" if b == 48 else "int"
        elif s in ("zero", "int"):
            if b == 46:  # '.'
                f["state"] = "frac_start"
            elif b in b"eE":
                f["state"] = "exp_start"
        elif s == "frac_start":
            f["state"] = "frac"
        elif s == "frac":
            if b in b"eE":
                f["state"] = "exp_start"
        elif s == "exp_start":
            f["state"] = "exp_sign" if b in b"+-" else "exp"
        elif s == "exp_sign":
            f["state"] = "exp"

    def _enum_advance(self, f: dict, b: int) -> None:
        conts = tuple(o for o in f["opts"]
                      if len(o) > f["pos"] and o[f["pos"]] == b)
        if conts:
            f["opts"] = conts
            f["pos"] += 1
            self._enum_maybe_finish()
            return
        # termination byte of a completed option: belongs to the parent
        self._value_done()
        self._dispatch(b)

    def _enum_maybe_finish(self) -> None:
        """Pop an enum frame the moment completion is unambiguous — no
        surviving option continues past the consumed prefix.  (Ambiguous
        prefixes, e.g. enum [1, 12], stay open until a terminator.)"""
        f = self._stack[-1]
        if all(len(o) == f["pos"] for o in f["opts"]):
            self._value_done()


def machine_for(params):
    """The guided machine a request's sampling params ask for, or None."""
    if getattr(params, "guided_schema", ""):
        return SchemaByteMachine(compile_schema_str(params.guided_schema))
    if params.guided_json:
        return JsonByteMachine()
    return None


def build_token_byte_table(tokenizer, vocab_size: int) -> np.ndarray | None:
    """[vocab_size] int32: token id → byte value, -1 where the token has
    no single-byte form.  None when the tokenizer exposes no such mapping
    (guided requests are then rejected instead of silently unguided)."""
    offset = getattr(tokenizer, "OFFSET", None)
    if offset is None:
        return None
    table = np.full(vocab_size, -1, np.int32)
    hi = min(vocab_size, offset + 256)
    if hi <= offset:
        return None
    table[offset:hi] = np.arange(hi - offset)
    return table
