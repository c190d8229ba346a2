"""The port's copy of ``llama_kotlin_tpu/sampling/json_schema.py``.

JSON schema -> GBNF grammar conversion.

Parity target: common/json-schema-to-grammar.cpp (1,045 LoC): constrains
generation to JSON documents matching a schema.  Supports the commonly
used subset: types (object/array/string/number/integer/boolean/null),
properties + required + additionalProperties:false, items / prefixItems,
enum / const, anyOf / oneOf, minItems / maxItems, $ref (local #/defs).
"""

from __future__ import annotations

import json
import re
from typing import Any

SPACE_RULE = '| " " | "\\n" [ \\t]{0,20}'

PRIMITIVES = {
    "boolean": '("true" | "false") ws',
    "null": '"null" ws',
    "number": '("-"? ([0-9] | [1-9] [0-9]{0,15})) ("." [0-9]+)? ([eE] [-+]? [0-9] [1-9]{0,15})? ws',
    "integer": '("-"? ([0-9] | [1-9] [0-9]{0,15})) ws',
    "string": (
        r'"\"" ( [^"\\\x7F\x00-\x1F] | "\\" (["\\bfnrt] | "u" [0-9a-fA-F]{4}) )* "\"" ws'
    ),
    "value": "object | array | string | number | boolean | null",
    "object": '"{" ws ( string ":" ws value ("," ws string ":" ws value)* )? "}" ws',
    "array": '"[" ws ( value ("," ws value)* )? "]" ws',
}


def _escape_literal(s: str) -> str:
    out = s.replace("\\", "\\\\").replace('"', '\\"')
    out = out.replace("\n", "\\n").replace("\r", "\\r").replace("\t", "\\t")
    return f'"{out}"'


class _Converter:
    def __init__(self, schema: dict):
        self.schema = schema
        self.rules: dict[str, str] = {"space": SPACE_RULE.lstrip("| ")}
        self.rules["ws"] = SPACE_RULE
        self._names: dict[str, int] = {}

    def _add_rule(self, base: str, body: str) -> str:
        base = re.sub(r"[^a-zA-Z0-9-]+", "-", base) or "rule"
        for name, existing in self.rules.items():
            if existing == body and name.startswith(base):
                return name
        if base in self.rules and self.rules[base] != body:
            self._names[base] = self._names.get(base, 0) + 1
            base = f"{base}{self._names[base]}"
        self.rules[base] = body
        return base

    def _ensure_primitive(self, t: str) -> str:
        if t in self.rules:
            return t
        self.rules[t] = PRIMITIVES[t]  # register first: value/object/array are mutually recursive
        if t == "value":
            for dep in ("object", "array", "string", "number", "boolean", "null"):
                self._ensure_primitive(dep)
        if t in ("object", "array"):
            self._ensure_primitive("value")
            self._ensure_primitive("string")
        return t

    def _resolve_ref(self, ref: str) -> dict:
        if not ref.startswith("#/"):
            raise ValueError(f"only local refs supported: {ref}")
        node: Any = self.schema
        for part in ref[2:].split("/"):
            node = node[part]
        return node

    def visit(self, schema: dict | bool, name: str) -> str:
        if schema is True or schema == {}:
            return self._ensure_primitive("value")
        if schema is False:
            raise ValueError("unsatisfiable schema: false")
        if "$ref" in schema:
            return self.visit(self._resolve_ref(schema["$ref"]), name)
        if "const" in schema:
            return self._add_rule(name, _escape_literal(json.dumps(schema["const"])) + " ws")
        if "enum" in schema:
            alts = " | ".join(_escape_literal(json.dumps(v)) for v in schema["enum"])
            return self._add_rule(name, f"({alts}) ws")
        for key in ("anyOf", "oneOf"):
            if key in schema:
                alts = [self.visit(sub, f"{name}-{i}") for i, sub in enumerate(schema[key])]
                return self._add_rule(name, " | ".join(alts))

        t = schema.get("type")
        if isinstance(t, list):
            alts = [self.visit({**schema, "type": ti}, f"{name}-{ti}") for ti in t]
            return self._add_rule(name, " | ".join(alts))
        if t == "object" and "properties" in schema:
            return self._object_rule(schema, name)
        if t == "object" and schema.get("additionalProperties") not in (None, True):
            sub = self.visit(schema["additionalProperties"], f"{name}-kv")
            body = (f'"{{" ws ( string ":" ws {sub} ("," ws string ":" ws {sub})* )? "}}" ws')
            self._ensure_primitive("string")
            return self._add_rule(name, body)
        if t == "array":
            return self._array_rule(schema, name)
        if t == "string" and "pattern" in schema:
            # patterns are not compiled to GBNF (reference does a partial
            # job too); fall back to free string
            return self._ensure_primitive("string")
        if t in PRIMITIVES:
            return self._ensure_primitive(t)
        return self._ensure_primitive("value")

    def _object_rule(self, schema: dict, name: str) -> str:
        props = schema.get("properties", {})
        required = set(schema.get("required", []))
        self._ensure_primitive("string")
        parts_req = []
        parts_opt = []
        for key, sub in props.items():
            sub_rule = self.visit(sub, f"{name}-{key}")
            kv = f'{_escape_literal(json.dumps(key))} ":" ws {sub_rule}'
            (parts_req if key in required else parts_opt).append(kv)
        # required props in declaration order; optional each independently
        body = '"{" ws '
        segments = []
        for i, kv in enumerate(parts_req):
            segments.append(kv if i == 0 else f'"," ws {kv}')
        seq = " ".join(segments)
        if parts_opt:
            if parts_req:
                opts = " ".join(f'("," ws {kv})?' for kv in parts_opt)
                seq = f"{seq} {opts}"
            else:
                # all optional: allow any subset in order
                alts = []
                for i, kv in enumerate(parts_opt):
                    rest = " ".join(f'("," ws {k2})?' for k2 in parts_opt[i + 1:])
                    alts.append(f"{kv} {rest}".strip())
                seq = f'( {" | ".join(alts)} )?'
        body += seq + ' "}" ws'
        return self._add_rule(name, body)

    def _array_rule(self, schema: dict, name: str) -> str:
        items = schema.get("items", {})
        if isinstance(items, list):  # tuple validation
            subs = [self.visit(s, f"{name}-{i}") for i, s in enumerate(items)]
            inner = ' "," ws '.join(subs)
            return self._add_rule(name, f'"[" ws {inner} "]" ws')
        sub = self.visit(items, f"{name}-item")
        min_items = int(schema.get("minItems", 0))
        max_items = schema.get("maxItems")
        if min_items == 0 and max_items is None:
            body = f'"[" ws ( {sub} ("," ws {sub})* )? "]" ws'
        else:
            lo = max(min_items - 1, 0)
            if max_items is None:
                # open upper bound: {lo,} (fix: lo=0 previously dropped the
                # repetition entirely, forcing exactly one element)
                rep = f'("," ws {sub}){{{lo},}}'
            else:
                hi = int(max_items) - 1
                rep = f'("," ws {sub}){{{lo},{hi}}}' if hi > 0 else ""
            if min_items > 0:
                body = f'"[" ws {sub} {rep} "]" ws'
            else:
                body = f'"[" ws ( {sub} {rep} )? "]" ws'
        return self._add_rule(name, body)


def json_schema_to_gbnf(schema) -> str:
    if isinstance(schema, str):
        schema = json.loads(schema)
    conv = _Converter(schema)
    root = conv.visit(schema, "root")
    if root != "root":
        conv.rules["root"] = root
    lines = [f"{name} ::= {body}" for name, body in conv.rules.items() if name != "space"]
    return "\n".join(lines)
