"""Port parity for the tokenizers: SPM, BPE (the llama-bpe and gpt-2
pre-tokenizers), WPM and UGM vocabularies, each written to a GGUF file
by the port's writer and read back by both packages' readers, encode the
same texts (unicode, whitespace runs, digits, special-token literals; with
parse_special on and off) to the same ids and decode them to the same
text, with no tolerance; and the tokenize tool prints what JAX's prints."""

from __future__ import annotations

import struct
from collections import Counter

import numpy as np
import pytest

from llama_kotlin_tpu.gguf import GGUFFile as JaxGGUF
from llama_kotlin_tpu.tokenizer import build_tokenizer as jax_build
from llama_kotlin_tpu.tools import tokenize as jax_tokenize

from llama_kotlin_tpu_torch.gguf.reader import GGUFFile
from llama_kotlin_tpu_torch.gguf.writer import GGUFWriter
from llama_kotlin_tpu_torch.models.synthetic import synthetic_spm_vocab
from llama_kotlin_tpu_torch.tokenizer import build_tokenizer
from llama_kotlin_tpu_torch.tokenizer import bpe as port_bpe
from llama_kotlin_tpu_torch.tools import tokenize as port_tokenize

TEXTS = [
    "Hello world",
    "the quick brown fox jumps over the lazy dog",
    "  leading,  double  spaces\n\nnew lines\ttabs   ",
    "digits 1234567 and 3.14159, 2024-10-17",
    "unicode: café naïve Ünïcödé 日本語 😀 ñ",
    "specials <s> inside </s> text<|tool|>here <|eot|>",
    "",
    " ",
    "mixed123abc!!! ??? ... don't they'll I'M",
]
PARSE = [False, True]

SPECIALS = [("<|tool|>", 4), ("<|eot|>", 3)]  # USER_DEFINED, CONTROL


def _spm_kvs() -> dict:
    kv = synthetic_spm_vocab(2000, chat_template=None)
    toks = kv["tokenizer.ggml.tokens"] + [s for s, _ in SPECIALS]
    kv["tokenizer.ggml.tokens"] = toks
    kv["tokenizer.ggml.scores"] = -np.arange(len(toks), dtype=np.float32)
    kv["tokenizer.ggml.token_type"] = np.concatenate(
        [kv["tokenizer.ggml.token_type"], np.array([t for _, t in SPECIALS], np.int32)])
    return kv


def _train_merges(corpus: str, n_merges: int, b2u: dict) -> list[str]:
    """Greedy byte-level BPE training on the corpus's words: the most
    frequent adjacent pair merges first (ties to the first seen)."""
    words = [[b2u[b] for b in w.encode("utf-8")] for w in corpus.split(" ") if w]
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w in words:
            pairs.update(zip(w, w[1:]))
        if not pairs:
            break
        (a, b), _ = pairs.most_common(1)[0]
        merges.append(f"{a} {b}")
        for w in words:
            i = 0
            while i < len(w) - 1:
                if w[i] == a and w[i + 1] == b:
                    w[i:i + 2] = [a + b]
                i += 1
    return merges


CORPUS = ("the quick brown fox jumps over the lazy dog and the dog sleeps while "
          "the fox runs Hello world hello there 123 456 don't they'll inside text "
          "spaces new lines digits unicode") * 3


def _bpe_kvs(pre: str) -> dict:
    b2u = port_bpe.bytes_to_unicode()
    byte_toks = [b2u[b] for b in range(256)]
    merges = _train_merges(CORPUS, 120, b2u)
    toks = ["<|begin_of_text|>", "<|end_of_text|>"] + byte_toks
    for m in merges:
        a, _, b = m.partition(" ")
        if a + b not in toks:
            toks.append(a + b)
    toks += [s for s, _ in SPECIALS]
    types = [3, 3] + [1] * (len(toks) - 2 - len(SPECIALS)) + [t for _, t in SPECIALS]
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": pre,
            "tokenizer.ggml.tokens": toks,
            "tokenizer.ggml.token_type": np.asarray(types, np.int32),
            "tokenizer.ggml.merges": merges,
            "tokenizer.ggml.bos_token_id": np.uint32(0),
            "tokenizer.ggml.eos_token_id": np.uint32(1)}


def _wpm_kvs() -> dict:
    import string

    words = ("the quick brown fox jumps over lazy dog hello world digits and "
             "spaces new lines tabs unicode cafe naive text inside here").split()
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    toks += ["▁" + w for w in words] + ["▁" + c for c in string.ascii_lowercase + string.digits]
    toks += list(string.ascii_lowercase + string.digits) + ["▁" + c for c in ".,!?'-:<>|"]
    toks += ["ing", "ed", "er", "s", "un", "ic", "ode", "▁日", "本", "語"]
    types = [3, 2, 3, 3, 3] + [1] * (len(toks) - 5)
    return {"tokenizer.ggml.model": "bert", "tokenizer.ggml.tokens": toks,
            "tokenizer.ggml.token_type": np.asarray(types, np.int32),
            "tokenizer.ggml.scores": np.zeros(len(toks), np.float32),
            "tokenizer.ggml.unknown_token_id": np.uint32(1),
            "tokenizer.ggml.cls_token_id": np.uint32(2),
            "tokenizer.ggml.seperator_token_id": np.uint32(3),
            "tokenizer.ggml.padding_token_id": np.uint32(0)}


def _charsmap() -> bytes:
    """A hand-made XCDA with one rule, 'É' (0xC3 0x89) -> 'E' (the pattern
    of tests/test_ugm_tokenizer.py)."""
    nodes = np.full(256, 0xFFFFFFFF, np.uint32)
    nodes[0] = 1 << 10
    nodes[0xC2] = 0xC3 | (0x82 << 10)
    nodes[0xC9] = 0x89 | (1 << 8) | (0x99 << 10)
    nodes[0x50] = np.uint32(1 << 31)
    return struct.pack("<I", nodes.nbytes) + nodes.tobytes() + b"E\x00"


def _ugm_kvs() -> dict:
    rng = np.random.default_rng(3)
    pieces = ["<pad>", "</s>", "<unk>", "▁"] + list("abcdefghijklmnopqrstuvwxyzE")
    pieces += ["▁the", "▁qu", "ick", "▁br", "own", "▁fox", "▁do", "g", "th", "he", "▁a",
               "▁ab", "ab", "bc", "▁he", "llo", "▁wor", "ld", "12", "3", "▁1", "▁É"]
    pieces += [s for s, _ in SPECIALS]
    types = [3, 3, 2] + [1] * (len(pieces) - 3 - len(SPECIALS)) + [t for _, t in SPECIALS]
    scores = -rng.uniform(1.0, 6.0, len(pieces)).astype(np.float32)
    return {"tokenizer.ggml.model": "t5", "tokenizer.ggml.tokens": pieces,
            "tokenizer.ggml.token_type": np.asarray(types, np.int32),
            "tokenizer.ggml.scores": scores,
            "tokenizer.ggml.padding_token_id": np.uint32(0),
            "tokenizer.ggml.eos_token_id": np.uint32(1),
            "tokenizer.ggml.unknown_token_id": np.uint32(2),
            "tokenizer.ggml.precompiled_charsmap": np.frombuffer(_charsmap(), np.uint8)}


VOCABS = {"spm": _spm_kvs, "bpe-llama": lambda: _bpe_kvs("llama-bpe"),
          "bpe-gpt2": lambda: _bpe_kvs("gpt-2"), "wpm": _wpm_kvs, "ugm": _ugm_kvs}


@pytest.fixture(scope="module")
def vocab_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocabs")
    out = {}
    for name, kvs in VOCABS.items():
        w = GGUFWriter()
        w.add_kv("general.architecture", "llama")
        for k, v in kvs().items():
            w.add_kv(k, v)
        w.write(d / f"{name}.gguf")
        out[name] = d / f"{name}.gguf"
    return out


@pytest.fixture(scope="module")
def tokenizers(vocab_files):
    """name -> (JAX tokenizer, the port's), each from its own reader."""
    out = {}
    for name, path in vocab_files.items():
        jf, pf = JaxGGUF(path), GGUFFile(path)
        out[name] = (jax_build(jf.metadata), build_tokenizer(pf.metadata))
        jf.close()
        pf.close()
    return out


@pytest.mark.parametrize("parse_special", PARSE)
@pytest.mark.parametrize("name", list(VOCABS))
def test_encode_decode_match_jax(tokenizers, name, parse_special):
    """Every text: equal ids (with and without the BOS/EOS specials), equal
    decoded text (skipping specials and not), equal pieces."""
    jt, pt = tokenizers[name]
    assert type(pt).__name__ == type(jt).__name__
    for text in TEXTS:
        for add_special in (True, False):
            ids = pt.encode(text, add_special=add_special, parse_special=parse_special)
            want = jt.encode(text, add_special=add_special, parse_special=parse_special)
            assert list(ids) == list(want), (name, text)
        for skip in (True, False):
            assert pt.decode(ids, skip_special=skip) == jt.decode(want, skip_special=skip)
        assert [pt.id_to_piece(i) for i in ids] == [jt.id_to_piece(i) for i in want]


def test_vocabs_carry_signal(tokenizers):
    """The texts reach merged pieces, byte fallback, unknowns and the
    special partition (so the equalities above test something)."""
    _, spm = tokenizers["spm"]
    ids = spm.encode(TEXTS[4], add_special=False)
    assert any(spm.vocab.type_of(i) == 6 for i in ids)  # byte fallback
    assert any(len(spm.vocab.tokens[i]) >= 3 for i in spm.encode(TEXTS[1]))
    sp_ids = spm.encode(TEXTS[5], parse_special=True)
    assert spm.vocab.token_to_id["<|eot|>"] in sp_ids
    assert spm.vocab.token_to_id["<|eot|>"] not in spm.encode(TEXTS[5], parse_special=False)
    assert spm.vocab.token_to_id["<|tool|>"] in spm.encode(TEXTS[5], parse_special=False)
    _, bpe = tokenizers["bpe-llama"]
    assert bpe.vocab.ignore_merges and len(bpe.encode(TEXTS[1])) < len(TEXTS[1]) // 2
    _, wpm = tokenizers["wpm"]
    assert wpm.vocab.unk_id in wpm.encode(TEXTS[4])
    _, ugm = tokenizers["ugm"]
    assert ugm.encode("É", add_special=False) == ugm.encode("E", add_special=False)


def test_tokenize_tool_matches_jax(vocab_files, capsys):
    """tools/tokenize.py: the same ids returned and the same lines printed
    (id -> piece, and --ids), for every vocab."""
    text = TEXTS[4] + " " + TEXTS[5]
    for name, path in vocab_files.items():
        for kw in (dict(), dict(ids_only=True), dict(add_special=False, parse_special=True)):
            got = port_tokenize.tokenize(str(path), text, **kw)
            out = capsys.readouterr().out
            want = jax_tokenize.tokenize(str(path), text, **kw)
            assert got == want and out == capsys.readouterr().out, (name, kw)
    port_tokenize.main(["-m", str(vocab_files["spm"]), "-p", text, "--parse-special"])
    out = capsys.readouterr().out
    jax_tokenize.main(["-m", str(vocab_files["spm"]), "-p", text, "--parse-special"])
    assert out == capsys.readouterr().out and out


def test_bpe_without_regex_raises(monkeypatch, tokenizers):
    """A BPE tokenizer needs the regex package: without it, building one
    raises an ImportError that names it (no fallback to re)."""
    import builtins

    real = builtins.__import__

    def no_regex(name, *a, **kw):
        if name == "regex":
            raise ImportError("No module named 'regex'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_regex)
    vocab = tokenizers["bpe-gpt2"][1].vocab
    with pytest.raises(ImportError, match="regex"):
        port_bpe.BPETokenizer(vocab)
