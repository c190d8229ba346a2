"""The port's copy of ``llama_kotlin_tpu/tokenizer/bpe.py`` (Python route only).

GPT-2-style byte-level BPE (the "gpt2" vocab model).

Parity target: llm_tokenizer_bpe (reference llama-vocab.cpp:355-520) +
unicode_regex_split (unicode.cpp): text is split by a per-model sequence of
pretokenizer regexes (matches and gaps both become fragments), each
fragment's UTF-8 bytes are mapped through the GPT-2 byte->unicode table,
and merges are applied by rank.  `ignore_merges` (Llama-3) short-circuits
fragments that exist whole in the vocab.
"""

from __future__ import annotations

from functools import lru_cache

from llama_kotlin_tpu_torch.tokenizer.vocab import Vocab, partition_specials

# per-model pretokenizer regex sequences, keyed by tokenizer.ggml.pre
# (same split specs as the reference's LLAMA_VOCAB_PRE_TYPE_* table; the
# patterns themselves originate in the models' tokenizer.json files)
_LLAMA3 = r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
_GPT2 = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)"

PRE_REGEXES: dict[str, list[str]] = {
    "llama3": [_LLAMA3],
    "llama-bpe": [_LLAMA3],
    "dbrx": [_LLAMA3],
    "smaug-bpe": [_LLAMA3],
    "chatglm-bpe": [_LLAMA3],
    "falcon": [
        r"[\p{P}\$\+<=>\^~\|`]+",
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)",
        r"[0-9][0-9][0-9]",
    ],
    "deepseek-llm": [
        r"[\r\n]",
        "\\s?[A-Za-z\xb5\xc0-\xd6\xd8-\xf6\xf8-\u01ba\u01bc-\u01bf\u01c4-\u0293\u0295-\u02af\u0370-\u0373\u0376\u0377\u037b-\u037d\u037f\u0386\u0388-\u038a\u038c\u038e-\u03a1\u03a3-\u03f5\u03f7-\u0481\u048a-\u052f\u0531-\u0556\u10a0-\u10c5\u13a0-\u13f5\u13f8-\u13fd\u1c90-\u1cba\u1cbd-\u1cbf\u1d00-\u1d2b\u1d6b-\u1d77\u1d79-\u1d9a\u1e00-\u1f15\u1f18-\u1f1d\u1f20-\u1f45\u1f48-\u1f4d\u1f50-\u1f57\u1f59\u1f5b\u1f5d\u1f5f-\u1f7d\u1f80-\u1fb4\u1fb6-\u1fbc\u1fbe\u1fc2-\u1fc4\u1fc6-\u1fcc\u1fd0-\u1fd3\u1fd6-\u1fdb\u1fe0-\u1fec\u1ff2-\u1ff4\u1ff6-\u1ffc\u2102\u2107\u210a-\u2113\u2115\u2119-\u211d\u2124\u2126\u2128\u212a-\u212d\u212f-\u2134\u2139\u213c-\u213f\u2145-\u2149\u214e\u2183\u2184\u2c00-\u2c7b\u2c7e-\u2ce4\u2ceb-\u2cee\u2cf2\u2cf3\ua640-\ua66d\ua680-\ua69b\ua722-\ua76f\ua771-\ua787\ua78b-\ua78e\uab70-\uabbf\ufb00-\ufb06\ufb13-\ufb17\uff21-\uff3a\uff41-\uff5a\U00010400-\U0001044f\U000104b0-\U000104d3\U000104d8-\U000104fb\U00010c80-\U00010cb2\U00010cc0-\U00010cf2\U000118a0-\U000118df\U0001e900-\U0001e943]+",
        r"\s?[!-/:-~！-／：-～‘-‟　-。]+",
        r"\s+$",
        r"[一-龥ࠀ-一가-퟿]+",
        r"\p{N}+",
    ],
    "deepseek-coder": [
        r"[\r\n]",
        r"\s?\p{L}+",
        r"\s?\p{P}+",
        r"[一-龥ࠀ-一가-퟿]+",
        r"\p{N}",
    ],
    "starcoder": [r"\p{N}", _GPT2],
    "refact": [r"\p{N}", _GPT2],
    "command-r": [r"\p{N}", _GPT2],
    "smollm": [r"\p{N}", _GPT2],
    "codeshell": [r"\p{N}", _GPT2],
    "exaone": [r"\p{N}", _GPT2],
    "gpt-2": [_GPT2],
    "mpt": [_GPT2],
    "olmo": [_GPT2],
    "jais": [_GPT2],
    "qwen2": [
        r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
    ],
    "stablelm2": [
        r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
    ],
    "poro-chat": [r" ?[^(\s|.,!?…。，、।۔،)]+"],
    "bloom": [r" ?[^(\s|.,!?…。，、।۔،)]+"],
    "gpt3-finnish": [r" ?[^(\s|.,!?…。，、।۔،)]+"],
    "viking": [r" ?[^(\s|.,!?…。，、।۔،)]+", r"\p{N}"],
    "default": [
        r"[\p{P}\$\+<=>\^~\|]+",
        _GPT2,
        r"\p{N}+",
        r"[0-9][0-9][0-9]",
    ],
}


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's printable byte<->unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


@lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


def _regex():
    """The ``regex`` package, imported when a BPE tokenizer is built: the
    pre-tokenizer patterns use Unicode classes (``\\p{L}``, ``\\p{N}``) that
    the standard ``re`` module does not have, so there is no stand-in."""
    try:
        import regex
    except ImportError as e:
        raise ImportError(
            "BPE tokenizers need the 'regex' package (its \\p{L}/\\p{N} classes), "
            "which is not installed; the standard 're' module cannot replace it") from e
    return regex


def regex_split(text: str, patterns: list[str]) -> list[str]:
    """Sequentially split text by each pattern's matches; both matches and
    gaps survive as fragments (cf. unicode_regex_split)."""
    re = _regex()
    frags = [text]
    for pat in patterns:
        rx = re.compile(pat)
        out = []
        for frag in frags:
            last = 0
            for m in rx.finditer(frag):
                if m.start() > last:
                    out.append(frag[last : m.start()])
                if m.group():
                    out.append(m.group())
                last = m.end()
            if last < len(frag):
                out.append(frag[last:])
        frags = out
    return frags


class BPETokenizer:
    def __init__(self, vocab: Vocab):
        _regex()  # fail at construction, not at the first encode
        self.vocab = vocab
        self.ranks: dict[tuple[str, str], int] = {}
        for i, merge in enumerate(vocab.merges):
            a, _, b = merge.partition(" ")
            self.ranks[(a, b)] = i
        self.patterns = PRE_REGEXES.get(vocab.pre, PRE_REGEXES["default"])
        self.b2u = bytes_to_unicode()
        self.u2b = unicode_to_bytes()

    # -- encode --------------------------------------------------------------

    def encode(self, text: str, add_special: bool = True,
               parse_special: bool = False) -> list[int]:
        v = self.vocab
        out: list[int] = []
        if add_special and v.add_bos:
            out.append(v.bos_id)
        frags = partition_specials(text, v, parse_special)
        for is_sp, frag in frags:
            if is_sp:
                out.append(frag)
                continue
            for word in regex_split(frag, self.patterns):
                self._bpe_word(word, out)
        if add_special and v.add_eos:
            out.append(v.eos_id)
        return out

    def _bpe_word(self, word: str, out: list[int]) -> None:
        v = self.vocab
        u = "".join(self.b2u[b] for b in word.encode("utf-8"))
        if v.ignore_merges:
            tid = v.token_to_id.get(u)
            if tid is not None:
                out.append(tid)
                return
        syms = [c for c in u]
        while len(syms) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(syms) - 1):
                r = self.ranks.get((syms[i], syms[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_rank is None:
                break
            syms[best_i : best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        for s in syms:
            tid = v.token_to_id.get(s)
            if tid is not None:
                out.append(tid)
                continue
            for ch in s:  # per-char byte fallback (cf. reference's loop)
                tid = v.token_to_id.get(ch)
                if tid is not None:
                    out.append(tid)

    # -- decode --------------------------------------------------------------

    def id_to_piece(self, tid: int) -> bytes:
        v = self.vocab
        if v.type_of(tid) == 3:  # CONTROL
            return b""
        text = v.tokens[tid]
        if v.type_of(tid) == 4:  # USER_DEFINED: literal text
            return text.encode("utf-8")
        return bytes(self.u2b[c] for c in text if c in self.u2b)

    def decode(self, ids, skip_special: bool = True) -> str:
        v = self.vocab
        parts = []
        for tid in ids:
            if skip_special and v.is_control(tid):
                continue
            parts.append(self.id_to_piece(tid))
        return b"".join(parts).decode("utf-8", errors="replace")
