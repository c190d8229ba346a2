"""The port's copy of ``llama_kotlin_tpu/tokenizer/wpm.py``.

WordPiece tokenizer (the "bert" vocab model).

Parity target: llm_tokenizer_wpm (reference llama-vocab.cpp:649-760).
GGUF-converted WPM vocabs use the U+2581 word-start convention (not
"##"): each word is matched longest-first with a phantom "▁" prefix.
Preprocessing: NFD normalise (keeping combining marks), lowercase, skip
control chars, split punctuation / ASCII symbols / CJK chars into
single-char words.
"""

from __future__ import annotations

import unicodedata

from llama_kotlin_tpu_torch.tokenizer.vocab import Vocab

WORD_PREFIX = "▁"


def _is_chinese_char(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
        or 0x2B920 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class WPMTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.max_len = max((len(t) for t in vocab.tokens), default=1)

    def _preprocess(self, text: str) -> list[str]:
        words: list[str] = []
        cur = ""
        for ch in unicodedata.normalize("NFD", text):
            cp = ord(ch)
            if ch.isspace():
                if cur:
                    words.append(cur)
                cur = ""
                continue
            cat = unicodedata.category(ch)
            if cp == 0 or cp == 0xFFFD or cat in ("Cc", "Cf", "Cn") or cat.startswith("M"):
                continue  # control chars and combining marks (accents) dropped
            low = ch.lower()
            if cat.startswith("P") or (cp < 0x7F and cat.startswith("S")) or _is_chinese_char(cp):
                if cur:
                    words.append(cur)
                words.append(low)
                cur = ""
            else:
                cur += low
        if cur:
            words.append(cur)
        return words

    def encode(self, text: str, add_special: bool = True,
               parse_special: bool = False) -> list[int]:
        v = self.vocab
        out: list[int] = []
        cls = v.cls_id if v.cls_id >= 0 else v.bos_id
        sep = v.sep_id if v.sep_id >= 0 else v.eos_id
        if add_special:
            out.append(cls)
        for word in self._preprocess(text):
            if not word:
                continue
            w = WORD_PREFIX + word
            start = len(out)
            i = 0
            n = len(w)
            while i < n:
                found = None
                for j in range(min(n, i + self.max_len + 1), i, -1):
                    tid = v.token_to_id.get(w[i:j])
                    if tid is not None:
                        found = tid
                        i = j
                        break
                if found is None:
                    del out[start:]
                    break
                out.append(found)
            if len(out) == start:
                out.append(v.unk_id)
        if add_special:
            out.append(sep)
        return out

    def id_to_piece(self, tid: int) -> bytes:
        """Raw token text (grammar/tokenize-tool surface; WPM pieces are
        plain subwords, '##' continuation prefix stripped)."""
        v = self.vocab
        if v.is_control(tid):
            return b""
        t = v.tokens[tid]
        if t.startswith(WORD_PREFIX):
            return (" " + t[len(WORD_PREFIX):]).encode("utf-8")
        return t.encode("utf-8")

    def decode(self, ids, skip_special: bool = True) -> str:
        v = self.vocab
        parts: list[str] = []
        for tid in ids:
            if skip_special and v.is_control(tid):
                continue
            t = v.tokens[tid]
            if t.startswith(WORD_PREFIX):
                parts.append((" " if parts else "") + t[1:])
            else:
                parts.append(t)
        return "".join(parts)
