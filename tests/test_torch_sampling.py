"""Port parity for the host sampling stack: every sampler function of
``sampling/samplers.py`` on seeded candidates, the SamplerChain over 64
steps at one seed (equal ids), GBNF grammars written inline on the
pattern of the reference's json, arithmetic, list, chess, c and japanese
grammars (equal parse tables, accept/reject sets and allowed-token masks),
and json_schema_to_gbnf (equal strings); all with no tolerance."""

from __future__ import annotations

import numpy as np
import pytest

from llama_kotlin_tpu.sampling import grammar as jax_grammar
from llama_kotlin_tpu.sampling import json_schema as jax_schema
from llama_kotlin_tpu.sampling import samplers as jax_samplers
from llama_kotlin_tpu.tokenizer import build_tokenizer as jax_build

from llama_kotlin_tpu_torch.models.synthetic import synthetic_spm_vocab
from llama_kotlin_tpu_torch.sampling import grammar, json_schema, samplers
from llama_kotlin_tpu_torch.tokenizer import build_tokenizer

V = 2000

GRAMMARS = {
    "json": r'''
root   ::= object
value  ::= object | array | string | number | ("true" | "false" | "null") ws

object ::=
  "{" ws (
            string ":" ws value
    ("," ws string ":" ws value)*
  )? "}" ws

array  ::=
  "[" ws (
            value
    ("," ws value)*
  )? "]" ws

string ::=
  "\"" (
    [^"\\\x7F\x00-\x1F] |
    "\\" (["\\bfnrt] | "u" [0-9a-fA-F]{4}) # escapes
  )* "\"" ws

number ::= ("-"? ([0-9] | [1-9] [0-9]{0,15})) ("." [0-9]+)? ([eE] [-+]? [0-9] [1-9]{0,15})? ws

# Optional space: by convention, applied in this grammar after literal chars when allowed
ws ::= | " " | "\n" [ \t]{0,20}
''',
    "arithmetic": r'''
root  ::= (expr "=" ws term "\n")+
expr  ::= term ([-+*/] term)*
term  ::= ident | num | "(" ws expr ")" ws
ident ::= [a-z] [a-z0-9_]* ws
num   ::= [0-9]+ ws
ws    ::= [ \t\n]*
''',
    "list": r'''
root ::= item+

# Excludes various line break characters
item ::= "- " [^\r\n\x0b\x0c\x85\u2028\u2029]+ "\n"
''',
    "chess": r'''
# Specifies chess moves as a list in algebraic notation, using PGN conventions
root    ::= "1. " move " " move "\n" ([1-9] [0-9]? ". " move " " move "\n")+
move    ::= (pawn | nonpawn | castle) [+#]?

# piece type, optional file/rank, optional capture, dest file & rank
nonpawn ::= [NBKQR] [a-h]? [1-8]? "x"? [a-h] [1-8]

# optional file & capture, dest file & rank, optional promotion
pawn    ::= ([a-h] "x")? [a-h] [1-8] ("=" [NBKQR])?

castle  ::= "O-O" "-O"?
''',
    "c": r'''
root ::= (declaration)*

declaration ::= dataType identifier "(" parameter? ")" "{" statement* "}"

dataType  ::= "int" ws | "float" ws | "char" ws
identifier ::= [a-zA-Z_] [a-zA-Z_0-9]*

parameter ::= dataType identifier

statement ::=
    ( dataType identifier ws "=" ws expression ";" ) |
    ( identifier ws "=" ws expression ";" ) |
    ( identifier ws "(" argList? ")" ";" ) |
    ( "return" ws expression ";" ) |
    ( "while" "(" condition ")" "{" statement* "}" ) |
    ( "for" "(" forInit ";" ws condition ";" ws forUpdate ")" "{" statement* "}" ) |
    ( "if" "(" condition ")" "{" statement* "}" ("else" "{" statement* "}")? ) |
    ( singleLineComment ) |
    ( multiLineComment )

forInit ::= dataType identifier ws "=" ws expression | identifier ws "=" ws expression
forUpdate ::= identifier ws "=" ws expression

condition ::= expression relationOperator expression
relationOperator ::= ("<=" | "<" | "==" | "!=" | ">=" | ">")

expression ::= term (("+" | "-") term)*
term ::= factor(("*" | "/") factor)*

factor ::= identifier | number | unaryTerm | funcCall | parenExpression
unaryTerm ::= "-" factor
funcCall ::= identifier "(" argList? ")"
parenExpression ::= "(" ws expression ws ")"

argList ::= expression ("," ws expression)*

number ::= [0-9]+

singleLineComment ::= "//" [^\n]* "\n"
multiLineComment ::= "/*" ( [^*] | ("*" [^/]) )* "*/"

ws ::= ([ \t\n]+)
''',
    "japanese": r'''
# A probably incorrect grammar for Japanese
root        ::= jp-char+ ([ \t\n] jp-char+)*
jp-char     ::= hiragana | katakana | punctuation | cjk
hiragana    ::= [ぁ-ゟ]
katakana    ::= [ァ-ヿ]
punctuation ::= [、-〾]
cjk         ::= [一-鿿]
''',
}

# (accepted, rejected) whole texts per grammar
TEXTS = {
    "json": (['{"a": 1}', '{ "k" : [1, 2.5e3, "x\\n", true, null, {}] }', "{}",
              '{"u": "\\u00e9"}'],
             ['{"a": }', "[1, 2]", '{"a" 1}', '{"a": tru}', '{"a": "\x01"}']),
    "arithmetic": (["1+2=3\n", "(a*b)-c = x_1\n2/3=y\n"], ["1+=2\n", "a=b", "1+2=3"]),
    "list": (["- one\n- two\n"], ["- \n", "* one\n", "- one"]),
    "chess": (["1. e4 e5\n2. Nf3 Nc6\n", "1. d4 Nf6\n10. O-O O-O-O+\n"],
              ["1. e9 e5\n2. a a\n", "2. e4 e5\n", "1. e4 e5\n"]),
    "c": (["int main(){return 0;}", "float f(int x){x = x*2;if(x<3){x = 1;}}"],
          ["int main(", "main(){}", "int f(){x = ;}"]),
    "japanese": (["こんにちは 世界", "カタカナ、テスト"], ["hello", "こんにちは  世界", ""]),
}


def _tables(mod, text):
    rules, root = mod.parse_gbnf(text)
    return root, {rid: [(e.type, e.value) for e in rule] for rid, rule in rules.items()}


@pytest.mark.parametrize("name", list(GRAMMARS))
def test_grammar_tables_and_acceptance_match_jax(name):
    """The parse tables (rule ids, elements, root) are equal, and each text
    is accepted or rejected alike (and as expected) from the start state."""
    text = GRAMMARS[name]
    assert _tables(grammar, text) == _tables(jax_grammar, text)
    for accepted, texts in ((True, TEXTS[name][0]), (False, TEXTS[name][1])):
        for t in texts:
            got = []
            for mod in (grammar, jax_grammar):
                rules, root = mod.parse_gbnf(text)
                g = mod.Grammar(rules, root)
                ok = all(g.accept_cp(ord(ch)) for ch in t) and g.can_end
                got.append(ok)
            assert got == [accepted, accepted], (name, t, got)


def _no_bytes(kv: dict) -> dict:
    """The same vocab without its byte-fallback pieces (every piece then
    decodes whole, so no partial UTF-8 sequence arises)."""
    keep = [i for i, t in enumerate(kv["tokenizer.ggml.token_type"]) if t != 6]
    out = dict(kv)
    out["tokenizer.ggml.tokens"] = [kv["tokenizer.ggml.tokens"][i] for i in keep]
    out["tokenizer.ggml.token_type"] = kv["tokenizer.ggml.token_type"][keep]
    out["tokenizer.ggml.scores"] = kv["tokenizer.ggml.scores"][keep]
    return out


@pytest.fixture(scope="module")
def tokenizers():
    """(the port's, JAX's) SPM tokenizer over the same 2000-piece vocab
    with its byte-fallback pieces."""
    kv = synthetic_spm_vocab(V, chat_template=None)
    return build_tokenizer(kv), jax_build(kv)


@pytest.fixture(scope="module")
def whole_tokenizers():
    """(the port's, JAX's) SPM tokenizer over 2000 pieces that all decode
    whole (no byte-fallback pieces)."""
    kv = _no_bytes(synthetic_spm_vocab(V + 256, chat_template=None))
    assert len(kv["tokenizer.ggml.tokens"]) == V
    return build_tokenizer(kv), jax_build(kv)


def _lead_bytes(tok, m) -> set:
    """The multi-byte lead bytes whose fallback pieces the mask allows."""
    return {b for b in range(0xC0, 0x100) if m[tok.vocab.byte_token(b)]}


@pytest.mark.parametrize("name", ["json", "arithmetic", "chess", "japanese"])
def test_grammar_masks_match_jax(name, tokenizers):
    """GrammarSampler.allowed_mask over the 2000-piece vocab in every state
    along an accepted text (fed one piece a character, multi-byte ones as
    byte-fallback pieces): equal to JAX's on every piece that decodes whole
    after the pending bytes; on pieces that leave an incomplete UTF-8
    sequence the port's mask is JAX's narrowed to sequences that can
    complete to a character the grammar takes (the reference's partial-char
    rule, which JAX lacks); token_allowed agrees with the mask; accepting
    the pieces one by one gives equal states."""
    pt, jt = tokenizers
    ours, ref = grammar.GrammarSampler(GRAMMARS[name]), jax_grammar.GrammarSampler(GRAMMARS[name])
    ids = []
    for ch in TEXTS[name][0][0]:
        tid = pt.vocab.token_to_id.get("\u2581" if ch == " " else ch)
        ids += [tid] if tid is not None else [pt.vocab.byte_token(b) for b in ch.encode()]
    for step, tid in enumerate(ids + [None]):
        m, j = ours.allowed_mask(pt, V, eos_id=2), ref.allowed_mask(jt, V, eos_id=2)
        whole = np.array([not ours._split_partial(ours.partial + pt.id_to_piece(t))[1]
                          for t in range(V)])
        np.testing.assert_array_equal(m[whole], j[whole])
        assert not (m & ~j).any()
        assert 0 < m.sum() < V
        for t in list(np.random.default_rng(step).integers(0, V, 16)) + [2, 0xE3 + 3]:
            assert ours.token_allowed(int(t), pt, eos_id=2) == bool(m[t])
        if step == 0:  # the partial-char rule at the start state
            assert len(_lead_bytes(pt, j)) == 64  # JAX: every lead byte
            want = {"json": set(), "arithmetic": set(), "chess": set(),
                    "japanese": {0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9}}[name]
            assert _lead_bytes(pt, m) == want
        if tid is None:
            assert m[2]  # the whole text accepted: EOS allowed
            break
        assert m[tid]
        ours.accept_token(tid, pt, eos_id=2)
        ref.accept_token(tid, jt, eos_id=2)
        assert ours.partial == ref.partial and ours.state_key() == ref.state_key()


def test_grammar_partial_sequences_inside_a_string(tokenizers):
    """Inside a JSON string any character goes: every lead byte but the
    overlong C0 and C1 is legal (F5-FF too: the reference's rule bounds no
    code point above U+10FFFF), and a 3-byte sequence stays legal until it
    completes."""
    pt, _ = tokenizers
    g = grammar.GrammarSampler(GRAMMARS["json"])
    for ch in '{"k": "':
        g.accept_token(pt.vocab.token_to_id.get("\u2581" if ch == " " else ch), pt, eos_id=2)
    assert _lead_bytes(pt, g.allowed_mask(pt, V, eos_id=2)) == set(range(0xC2, 0x100))
    for b in "語".encode():
        assert g.allowed_mask(pt, V, eos_id=2)[pt.vocab.byte_token(b)]
        g.accept_token(pt.vocab.byte_token(b), pt, eos_id=2)
    assert g.partial == b"" and g.allowed_mask(pt, V, eos_id=2)[pt.vocab.token_to_id['"']]


@pytest.mark.parametrize("name", ["json", "arithmetic"])
def test_grammar_chain_never_dead_ends(name, tokenizers):
    """The port's chain with a grammar over the byte-fallback vocab samples
    64 random-logit steps (EOS held down) without a dead end, and the text
    is one the grammar accepts (JAX's chain dead-ends on this vocab, so
    test_sampler_chain_matches_jax's grammar cases use whole pieces)."""
    pt, _ = tokenizers
    chain = samplers.SamplerChain(samplers.SamplingParams(seed=3, grammar=GRAMMARS[name]), V)
    rng = np.random.default_rng(3)
    ids = []
    for _ in range(64):
        logits = (rng.standard_normal(V) * 2).astype(np.float32)
        logits[2] = -30.0
        ids.append(chain.sample(logits, tokenizer=pt))
        chain.accept(ids[-1], tokenizer=pt)
        if ids[-1] == 2:
            break
    data = b"".join(pt.id_to_piece(t) for t in ids if t != 2)
    text, rest = grammar.GrammarSampler._split_partial(data)
    rules, root = grammar.parse_gbnf(GRAMMARS[name])
    assert len(ids) > (16 if name == "arithmetic" else 3)
    assert grammar.Grammar(rules, root).accepts_text(text)
    assert any(pt.vocab.type_of(t) == 6 for t in ids)  # byte pieces were drawn


def _cands(seed: int, n: int = 300):
    logits = np.random.default_rng(seed).standard_normal(n).astype(np.float32) * 3
    return samplers.Candidates.from_logits(logits), jax_samplers.Candidates.from_logits(logits)


def _same(a, b):
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.logits, b.logits)
    assert a.sorted == b.sorted


SAMPLER_CASES = [
    ("top_k", (40,)), ("top_k", (0,)), ("top_k", (5, 9)),
    ("top_p", (0.9,)), ("top_p", (1.0,)), ("top_p", (0.3, 20)),
    ("min_p", (0.05,)), ("min_p", (0.5, 3)),
    ("tail_free", (0.95,)), ("tail_free", (0.5, 4)),
    ("typical", (0.9,)), ("typical", (0.2, 2)),
    ("temperature", (0.7,)), ("temperature", (1.0, 0.5, 1.5)),
]


@pytest.mark.parametrize("fn,args", SAMPLER_CASES)
def test_sampler_functions_match_jax(fn, args):
    """Each sampler on the same candidates leaves equal ids, logits and
    sort state, on fresh and on already filtered candidates."""
    for seed in range(3):
        a, b = _cands(seed)
        if seed == 2:  # a chain: filtered first
            samplers.top_k(a, 100)
            jax_samplers.top_k(b, 100)
        getattr(samplers, fn)(a, *args)
        getattr(jax_samplers, fn)(b, *args)
        _same(a, b)
        np.testing.assert_array_equal(a.probs(), b.probs())


def test_penalties_and_guidance_match_jax():
    rng = np.random.default_rng(4)
    for repeat, freq, present, nl in ((1.3, 0.0, 0.0, -1), (0.8, 0.1, 0.5, 7),
                                      (1.1, 0.2, 0.0, 7)):
        a, b = _cands(5)
        prev = rng.integers(0, 50, 40).tolist() + [7, 7]
        samplers.penalties(a, prev, repeat, freq, present, nl_id=nl, penalize_nl=False)
        jax_samplers.penalties(b, prev, repeat, freq, present, nl_id=nl, penalize_nl=False)
        _same(a, b)
    x, g = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    np.testing.assert_array_equal(samplers.apply_guidance(x, g, 1.5),
                                  jax_samplers.apply_guidance(x, g, 1.5))


CHAIN_PARAMS = {
    "default": dict(seed=7),
    "penalties": dict(seed=8, penalty_repeat=1.2, penalty_freq=0.1, penalty_present=0.2,
                      penalty_last_n=16),
    "order": dict(seed=9, samplers=("min_p", "temperature", "top_p"), top_p=0.8, min_p=0.1,
                  tfs_z=0.9, typical_p=0.9),
    "all": dict(seed=10, samplers=("top_k", "tfs_z", "typical_p", "top_p", "min_p",
                                   "temperature"), tfs_z=0.9, typical_p=0.8,
                dynatemp_range=0.3, logit_bias={3: 2.0, 11: -5.0}),
    "mirostat1": dict(seed=11, mirostat=1),
    "mirostat2": dict(seed=12, mirostat=2),
    "greedy": dict(seed=13, temp=0.0),
    "probs-greedy": dict(seed=14, temp=-1.0),
    "grammar": dict(seed=15, grammar=GRAMMARS["json"], temp=1.5, top_k=0, min_p=0.0),
    "grammar-arithmetic": dict(seed=16, grammar=GRAMMARS["arithmetic"]),
}


@pytest.mark.parametrize("case", list(CHAIN_PARAMS))
def test_sampler_chain_matches_jax(case, whole_tokenizers):
    """64 steps of SamplerChain.sample/accept on the same seeded logits (a
    cfg guidance row too): the same ids at every step, with the chain's
    np.random.default_rng(seed) on both sides (grammar cases over pieces
    that decode whole, where the two grammar filters agree)."""
    pt, jt = whole_tokenizers
    kw = CHAIN_PARAMS[case]
    ours = samplers.SamplerChain(samplers.SamplingParams(**kw, cfg_scale=1.5), V, nl_id=7)
    ref = jax_samplers.SamplerChain(jax_samplers.SamplingParams(**kw, cfg_scale=1.5), V, nl_id=7)
    rng = np.random.default_rng(kw["seed"])
    got, want = [], []
    for _ in range(64):
        logits = (rng.standard_normal(V) * 2).astype(np.float32)
        guide = (rng.standard_normal(V) * 2).astype(np.float32)
        got.append(ours.sample(logits, tokenizer=pt, guidance_logits=guide))
        want.append(ref.sample(logits, tokenizer=jt, guidance_logits=guide))
        errs = []
        for chain, tok in ((ours, pt), (ref, jt)):
            try:
                chain.accept(got[-1], tokenizer=tok)
                errs.append(None)
            except ValueError as e:  # a grammar dead end: JAX's raises there too
                errs.append(str(e))
        assert errs[0] == errs[1]
        if errs[0] is not None or case == "grammar" and got[-1] == 2:
            break
    assert got == want
    assert ours.mirostat_mu == ref.mirostat_mu and ours.prev == ref.prev
    assert len(set(got)) > (2 if case.startswith("grammar") else 5)


SCHEMAS = [
    {"type": "object", "properties": {"name": {"type": "string"}, "age": {"type": "integer"},
                                      "tags": {"type": "array", "items": {"type": "string"}}},
     "required": ["name", "age"]},
    {"type": "object", "properties": {"a": {"type": "number"}, "b": {"type": "boolean"}}},
    {"type": "array", "items": {"type": "integer"}, "minItems": 1, "maxItems": 3},
    {"type": "array", "items": {"type": "number"}, "minItems": 2},
    {"type": "array", "items": [{"type": "string"}, {"type": "null"}]},
    {"enum": ["red", "green", 3, None]},
    {"const": {"k": [1, 2]}},
    {"anyOf": [{"type": "string"}, {"type": "integer"}]},
    {"oneOf": [{"$ref": "#/$defs/pt"}, {"type": "null"}],
     "$defs": {"pt": {"type": "object", "properties": {"x": {"type": "number"}},
                      "required": ["x"]}}},
    {"type": ["string", "null"]},
    {"type": "object", "additionalProperties": {"type": "integer"}},
    {"type": "string", "pattern": "^[a-z]+$"},
    {},
    '{"type": "object", "properties": {"q": {"enum": ["a\\"b", "c\\\\d"]}}}',
]


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_json_schema_to_gbnf_matches_jax(i):
    """The same GBNF text, which both parsers accept with equal tables."""
    got = json_schema.json_schema_to_gbnf(SCHEMAS[i])
    assert got == jax_schema.json_schema_to_gbnf(SCHEMAS[i])
    assert _tables(grammar, got) == _tables(jax_grammar, got)
