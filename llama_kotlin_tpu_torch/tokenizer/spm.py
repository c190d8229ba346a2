"""The port's copy of ``llama_kotlin_tpu/tokenizer/spm.py`` (Python route only).

SentencePiece-style tokenizer (the "llama" vocab model).

Score-greedy bigram merging over UTF-8 characters with byte fallback,
matching llm_tokenizer_spm (reference llama-vocab.cpp:190-354) behavior:

- whitespace is escaped to U+2581 before matching
- a leading space is prepended to the first fragment and after every
  special token when add_space_prefix is set
- merges are chosen by highest vocab score (ties -> leftmost)
- unmatched symbols are recursively re-segmented via recorded merges, and
  finally emitted as byte tokens <0xXX>
"""

from __future__ import annotations

import heapq

from llama_kotlin_tpu_torch.tokenizer.vocab import Vocab, partition_specials

SPACE_ESCAPE = "▁"


class SPMTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    # -- encode --------------------------------------------------------------

    def encode(self, text: str, add_special: bool = True,
               parse_special: bool = False) -> list[int]:
        v = self.vocab
        out: list[int] = []
        if add_special and v.add_bos:
            out.append(v.bos_id)
        frags = partition_specials(text, v, parse_special)
        prev_special = True
        for is_sp, frag in frags:
            if is_sp:
                out.append(frag)
                prev_special = True
                continue
            raw = frag
            if v.add_space_prefix and prev_special and raw:
                raw = " " + raw
            self._tokenize_fragment(raw, out)
            prev_special = False
        if add_special and v.add_eos:
            out.append(v.eos_id)
        return out

    def _tokenize_fragment(self, text: str, out: list[int]) -> None:
        v = self.vocab
        text = text.replace(" ", SPACE_ESCAPE)
        if not text:
            return
        # symbols start as single unicode chars
        syms: list[str] = list(text)
        prev = list(range(-1, len(syms) - 1))
        nxt = list(range(1, len(syms) + 1))
        alive = [True] * len(syms)
        rev_merge: dict[str, tuple[str, str]] = {}

        heap: list[tuple[float, int, int, int, int]] = []  # (-score, left, right, llen, rlen)

        def try_add(li: int, ri: int):
            if li < 0 or ri >= len(syms):
                return
            cat = syms[li] + syms[ri]
            tid = v.token_to_id.get(cat)
            if tid is None or v.scores is None or tid >= len(v.scores):
                return
            heapq.heappush(heap, (-float(v.scores[tid]), li, ri, len(syms[li]), len(syms[ri])))

        for i in range(len(syms) - 1):
            try_add(i, i + 1)

        while heap:
            _, li, ri, llen, rlen = heapq.heappop(heap)
            if not alive[li] or not alive[ri]:
                continue
            if len(syms[li]) != llen or len(syms[ri]) != rlen:
                continue  # stale entry
            merged = syms[li] + syms[ri]
            rev_merge[merged] = (syms[li], syms[ri])
            syms[li] = merged
            alive[ri] = False
            nxt[li] = nxt[ri]
            if nxt[ri] < len(syms):
                prev[nxt[ri]] = li
            try_add(prev[li], li)
            if nxt[li] < len(syms):
                try_add(li, nxt[li])

        i = 0
        while i < len(syms):
            if alive[i]:
                self._resegment(syms[i], rev_merge, out)
            i += 1

    def _resegment(self, sym: str, rev_merge, out: list[int]) -> None:
        v = self.vocab
        tid = v.token_to_id.get(sym)
        if tid is not None:
            out.append(tid)
            return
        halves = rev_merge.get(sym)
        if halves is None:
            for b in sym.encode("utf-8"):
                out.append(v.byte_token(b))
            return
        self._resegment(halves[0], rev_merge, out)
        self._resegment(halves[1], rev_merge, out)

    # -- decode --------------------------------------------------------------

    def id_to_piece(self, tid: int) -> bytes:
        v = self.vocab
        t = v.type_of(tid)
        text = v.tokens[tid]
        if t == 6:  # BYTE
            try:
                return bytes([int(text[3:5], 16)])
            except (ValueError, IndexError):
                return text.encode("utf-8")
        if t == 3:  # CONTROL renders empty
            return b""
        return text.replace(SPACE_ESCAPE, " ").encode("utf-8")

    def decode(self, ids, skip_special: bool = True) -> str:
        v = self.vocab
        parts: list[bytes] = []
        first = True
        for tid in ids:
            if skip_special and v.is_control(tid):
                continue
            piece = self.id_to_piece(tid)
            if first and piece.startswith(b" "):
                piece = piece[1:]  # SPM drops the dummy leading space
            first = False
            parts.append(piece)
        return b"".join(parts).decode("utf-8", errors="replace")
