"""The port's copy of ``llama_kotlin_tpu/tokenizer/ugm.py``.

UGM (unigram / T5) tokenizer.

Parity target: llm_tokenizer_ugm (reference src/llama-vocab.cpp:761-1100):
SentencePiece Viterbi over a byte trie with log-prob scores, preceded by
normalization through the precompiled charsmap (an XOR-compressed compact
double array of prefix -> replacement rules) with space escaping to U+2581
and optional extra-whitespace removal.  Consecutive unknowns merge;
user-defined tokens score 0 and bypass normalization.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from llama_kotlin_tpu_torch.tokenizer.vocab import (
    TOKEN_TYPE_NORMAL,
    TOKEN_TYPE_UNUSED,
    TOKEN_TYPE_USER_DEFINED,
    Vocab,
    partition_specials,
)

SPACE_ESCAPE = "▁"
_SPACE_ESCAPE_B = SPACE_ESCAPE.encode("utf-8")
_UNKNOWN_PENALTY = 10.0
_REPLACEMENT = "\xef\xbf\xbd".encode("latin-1")  # U+FFFD utf-8 bytes


def _utf8_len(b: int) -> int:
    if b < 0x80:
        return 1
    if b >> 5 == 0b110:
        return 2
    if b >> 4 == 0b1110:
        return 3
    if b >> 3 == 0b11110:
        return 4
    return 1  # invalid lead byte: treat as single unit


class _Charsmap:
    """XCDA prefix->replacement view (cf. xcda_array_view)."""

    def __init__(self, blob: bytes):
        (xcda_size,) = struct.unpack_from("<I", blob, 0)
        self.nodes = np.frombuffer(blob, "<u4", count=xcda_size // 4, offset=4)
        self.repl = blob[4 + xcda_size:]

    def _node(self, i: int) -> int:
        if i >= len(self.nodes):
            raise IndexError
        return int(self.nodes[i])

    def longest_match(self, data: bytes, start: int) -> tuple[int, int]:
        """(matched_len, replacement_offset) or (0, 0)."""
        best_len = 0
        best_off = 0
        try:
            p = self._node(0)
            node = (p >> 10) << ((p & (1 << 9)) >> 6)  # BASE of root
            for i in range(start, len(data)):
                c = data[i]
                if c == 0:
                    break
                node ^= c
                p = self._node(node)
                if (p & ((1 << 31) | 0xFF)) != c:  # LCHECK mismatch
                    break
                is_leaf = (p >> 8) & 1
                node ^= (p >> 10) << ((p & (1 << 9)) >> 6)  # advance by BASE
                if is_leaf:
                    best_len = i - start + 1
                    best_off = self._node(node) & ((1 << 31) - 1)
        except IndexError:
            pass
        return best_len, best_off

    def replacement(self, off: int) -> bytes:
        end = self.repl.index(b"\x00", off)
        return self.repl[off:end]


class UGMTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.token_map: dict[bytes, int] = {}
        self.user_defined: list[bytes] = []
        self.max_len = 1
        min_score = float("inf")
        for tid, text in enumerate(vocab.tokens):
            t = vocab.type_of(tid)
            if t in (TOKEN_TYPE_NORMAL, TOKEN_TYPE_USER_DEFINED, TOKEN_TYPE_UNUSED):
                bs = text.encode("utf-8")
                self.token_map[bs] = tid
                self.max_len = max(self.max_len, len(bs))
            if t == TOKEN_TYPE_NORMAL and vocab.scores is not None:
                min_score = min(min_score, float(vocab.scores[tid]))
            if t == TOKEN_TYPE_USER_DEFINED:
                self.user_defined.append(text.encode("utf-8"))
        self.unknown_score = (min_score if min_score != float("inf") else 0.0) - _UNKNOWN_PENALTY
        self.charsmap: Optional[_Charsmap] = None
        if vocab.precompiled_charsmap:
            self.charsmap = _Charsmap(bytes(vocab.precompiled_charsmap))

    # -- normalization (cf. llm_tokenizer_ugm::normalize) --------------------

    def _normalize_prefix(self, data: bytes, off: int) -> tuple[bytes, int]:
        """(normalized_bytes, consumed_input_bytes)."""
        for ud in self.user_defined:
            if data.startswith(ud, off):
                return data[off : off + len(ud)], len(ud)
        if self.charsmap is not None:
            mlen, moff = self.charsmap.longest_match(data, off)
            if mlen > 0:
                return self.charsmap.replacement(moff), mlen
        n = min(_utf8_len(data[off]), len(data) - off)
        chunk = data[off : off + n]
        try:
            chunk.decode("utf-8")
            return chunk, n
        except UnicodeDecodeError:
            return _REPLACEMENT, 1

    def _normalize(self, text: str) -> bytes:
        v = self.vocab
        data = text.encode("utf-8")
        space = _SPACE_ESCAPE_B if v.escape_whitespaces else b" "
        out = bytearray()
        prepended = False
        in_word = False
        off = 0
        while off < len(data):
            norm, consumed = self._normalize_prefix(data, off)
            for c in norm:
                if c != 0x20:
                    if not in_word:
                        in_word = True
                        if (v.add_space_prefix and not prepended) or v.remove_extra_whitespaces:
                            out += space
                            prepended = True
                    out.append(c)
                else:
                    in_word = False
                    if not v.remove_extra_whitespaces:
                        out += space
            off += consumed
        return bytes(out)

    # -- Viterbi (cf. llm_tokenizer_ugm::tokenize) ---------------------------

    def _tokenize_fragment(self, text: str, out: list[int]) -> None:
        v = self.vocab
        data = self._normalize(text)
        n = len(data)
        if n == 0:
            return
        NEG = float("-inf")
        best = [(v.unk_id, 0, NEG)] * (n + 1)  # (token, start, score)
        best[0] = (v.unk_id, 0, 0.0)
        off = 0
        while off < n:
            cur = best[off]
            n_units = min(_utf8_len(data[off]), n - off)
            single_cp_found = False
            if cur[2] != NEG:
                for ln in range(1, min(self.max_len, n - off) + 1):
                    tid = self.token_map.get(data[off : off + ln])
                    if tid is None:
                        continue
                    if ln == n_units:
                        single_cp_found = True
                    score = (0.0 if v.type_of(tid) == TOKEN_TYPE_USER_DEFINED
                             else float(v.scores[tid]) if v.scores is not None else 0.0)
                    cand = cur[2] + score
                    if cand > best[off + ln][2]:
                        best[off + ln] = (tid, off, cand)
            if not single_cp_found:
                cand = cur[2] + self.unknown_score
                if cand > best[off + n_units][2]:
                    best[off + n_units] = (v.unk_id, off, cand)
            off += n_units
        # backtrack, merging consecutive unknowns
        rev: list[int] = []
        pos = n
        prev_unk = False
        while True:
            tid, start, _ = best[pos]
            is_unk = tid == v.unk_id
            if not (prev_unk and is_unk):
                rev.append(tid)
            if start == 0:
                break
            prev_unk = is_unk
            pos = start
        out.extend(reversed(rev))

    # -- public interface ----------------------------------------------------

    def encode(self, text: str, add_special: bool = True,
               parse_special: bool = False) -> list[int]:
        v = self.vocab
        out: list[int] = []
        if add_special and v.add_bos and v.bos_id >= 0:
            out.append(v.bos_id)
        for is_sp, frag in partition_specials(text, v, parse_special):
            if is_sp:
                out.append(frag)
            else:
                self._tokenize_fragment(frag, out)
        if add_special and v.add_eos and v.eos_id >= 0:
            out.append(v.eos_id)
        return out

    def id_to_piece(self, tid: int) -> bytes:
        v = self.vocab
        return v.tokens[tid].replace(SPACE_ESCAPE, " ").encode("utf-8")

    def decode(self, ids, skip_special: bool = True) -> str:
        v = self.vocab
        parts: list[str] = []
        for tid in ids:
            if skip_special and v.is_control(tid):
                continue
            parts.append(v.tokens[tid].replace(SPACE_ESCAPE, " "))
        text = "".join(parts)
        if v.add_space_prefix and text.startswith(" "):
            text = text[1:]
        return text
