"""The port's copy of ``llama_kotlin_tpu/sampling/grammar.py``.

GBNF grammar engine: parser + pushdown constraint sampler.

Parity targets: common/grammar-parser.cpp (GBNF text -> binary rules) and
src/llama-grammar.cpp (stack-based acceptance, UTF-8 partial sequences,
llama_grammar_sample / accept_token).

Rule representation mirrors llama_grammar_element: a rule is a flat list of
elements; alternates are separated by ALT and terminated by END; char
matchers may chain CHAR_ALT / CHAR_RNG_UPPER continuations.

Sampling strategy (same as common/sampling.cpp): sample WITHOUT the
grammar first, validate the one sampled token, and only on rejection filter
the full candidate set and resample — keeps the hot path fast.

One rule differs from the JAX package's: a piece that ends in an
incomplete UTF-8 sequence is legal only if that sequence can complete to a
character the grammar takes next (``Grammar.partial_ok``, the reference's
llama_grammar_match_partial_char).  The JAX package admits every such
piece, so over a vocab with byte-fallback pieces its mask holds every
multi-byte lead byte wherever the grammar wants, say, a "{"; once one is
drawn no token can follow and accept_token raises.  Pieces that decode
whole are judged alike by both.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Optional

import numpy as np

# element types (cf. llama_gretype)
END = 0
ALT = 1
RULE_REF = 2
CHAR = 3
CHAR_NOT = 4
CHAR_RNG_UPPER = 5
CHAR_ALT = 6


@dataclass(frozen=True)
class El:
    type: int
    value: int = 0


_MISSING = object()  # transition-memo sentinel


class GrammarParseError(ValueError):
    pass


class _Parser:
    """GBNF text -> {rule_name: rule_id}, rules list."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.symbol_ids: dict[str, int] = {}
        self.rules: dict[int, list[El]] = {}

    # -- low-level lexing ----------------------------------------------------

    def _ws(self, newlines: bool = True) -> None:
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            if ch == "#":  # comment to end of line
                while self.pos < len(self.text) and self.text[self.pos] not in "\r\n":
                    self.pos += 1
            elif ch in " \t" or (newlines and ch in "\r\n"):
                self.pos += 1
            else:
                break

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _name(self) -> str:
        start = self.pos
        while True:
            ch = self._peek()
            if not ch or not (ch.isalnum() or ch in "-_"):
                break
            self.pos += 1
        if self.pos == start:
            raise GrammarParseError(f"expected name at {start}")
        return self.text[start : self.pos]

    def _char(self) -> int:
        """Parse one character (handling escapes), returning the code point."""
        ch = self._peek()
        if ch == "\\":
            self.pos += 1
            esc = self._peek()
            self.pos += 1
            if esc == "x":
                v = int(self.text[self.pos : self.pos + 2], 16)
                self.pos += 2
                return v
            if esc == "u":
                v = int(self.text[self.pos : self.pos + 4], 16)
                self.pos += 4
                return v
            if esc == "U":
                v = int(self.text[self.pos : self.pos + 8], 16)
                self.pos += 8
                return v
            return {"t": 9, "r": 13, "n": 10}.get(esc, ord(esc))
        if not ch:
            raise GrammarParseError("unexpected end of input")
        self.pos += 1
        return ord(ch)

    # -- grammar rules -------------------------------------------------------

    def _sym_id(self, name: str) -> int:
        if name not in self.symbol_ids:
            self.symbol_ids[name] = len(self.symbol_ids)
        return self.symbol_ids[name]

    def _gen_id(self, base: str) -> int:
        name = f"{base}_{len(self.symbol_ids)}"
        return self._sym_id(name)

    def parse(self) -> tuple[dict[int, list[El]], int]:
        self._ws()
        while self.pos < len(self.text):
            self._parse_rule()
            self._ws()
        if "root" not in self.symbol_ids:
            raise GrammarParseError("grammar has no 'root' rule")
        # validate refs
        for rid, rule in self.rules.items():
            for el in rule:
                if el.type == RULE_REF and el.value not in self.rules:
                    raise GrammarParseError(f"undefined rule reference {el.value}")
        return self.rules, self.symbol_ids["root"]

    def _parse_rule(self) -> None:
        name = self._name()
        self._ws(newlines=False)
        if self.text[self.pos : self.pos + 3] != "::=":
            raise GrammarParseError(f"expected ::= at {self.pos}")
        self.pos += 3
        self._ws(newlines=True)  # newline allowed right after ::=
        rule_id = self._sym_id(name)
        out = self._parse_alternates(name, nested=False)
        self.rules[rule_id] = out
        # consume newline(s)
        self._ws()

    def _parse_alternates(self, base: str, nested: bool) -> list[El]:
        out: list[El] = []
        out += self._parse_sequence(base, nested)
        while self._peek() == "|":
            self.pos += 1
            self._ws(newlines=True)  # alternates may continue on next line
            out.append(El(ALT))
            out += self._parse_sequence(base, nested)
        out.append(El(END))
        return out

    def _parse_sequence(self, base: str, nested: bool) -> list[El]:
        seq: list[El] = []
        last_start = 0
        while True:
            self._ws(newlines=nested)
            ch = self._peek()
            if ch == '"':  # literal
                self.pos += 1
                last_start = len(seq)
                while self._peek() != '"':
                    seq.append(El(CHAR, self._char()))
                self.pos += 1
            elif ch == "[":  # char class
                self.pos += 1
                last_start = len(seq)
                neg = self._peek() == "^"
                if neg:
                    self.pos += 1
                first = True
                while self._peek() != "]":
                    cp = self._char()
                    t = (CHAR_NOT if neg else CHAR) if first else CHAR_ALT
                    seq.append(El(t, cp))
                    first = False
                    if self._peek() == "-" and self.text[self.pos + 1 : self.pos + 2] != "]":
                        self.pos += 1
                        seq.append(El(CHAR_RNG_UPPER, self._char()))
                self.pos += 1
            elif ch == "(":  # group -> nested rule
                self.pos += 1
                self._ws(newlines=True)
                sub_id = self._gen_id(base)
                self.rules[sub_id] = self._parse_alternates(base, nested=True)
                if self._peek() != ")":
                    raise GrammarParseError(f"expected ) at {self.pos}")
                self.pos += 1
                last_start = len(seq)
                seq.append(El(RULE_REF, sub_id))
            elif ch and (ch.isalnum() or ch in "-_"):
                name = self._name()
                last_start = len(seq)
                seq.append(El(RULE_REF, self._sym_id(name)))
            elif ch in ("*", "+", "?", "{"):
                if not seq:
                    raise GrammarParseError(f"modifier without content at {self.pos}")
                prev = seq[last_start:]
                if ch == "{":
                    self.pos += 1
                    lo_s = ""
                    while self._peek().isdigit():
                        lo_s += self._peek()
                        self.pos += 1
                    hi_s = lo_s
                    if self._peek() == ",":
                        self.pos += 1
                        hi_s = ""
                        while self._peek().isdigit():
                            hi_s += self._peek()
                            self.pos += 1
                    if self._peek() != "}":
                        raise GrammarParseError(f"expected }} at {self.pos}")
                    self.pos += 1
                    lo = int(lo_s or 0)
                    hi = int(hi_s) if hi_s else -1
                    rep: list[El] = []
                    for _ in range(lo):
                        rep += prev
                    if hi < 0:
                        star_id = self._gen_id(base)
                        self.rules[star_id] = prev + [El(RULE_REF, star_id), El(ALT), El(END)]
                        rep.append(El(RULE_REF, star_id))
                    else:
                        opt: list[El] = []
                        for _ in range(hi - lo):
                            oid = self._gen_id(base)
                            self.rules[oid] = prev + opt + [El(ALT), El(END)]
                            opt = [El(RULE_REF, oid)]
                        rep += opt
                    seq[last_start:] = rep
                else:
                    self.pos += 1
                    sub_id = self._gen_id(base)
                    if ch == "*":
                        self.rules[sub_id] = prev + [El(RULE_REF, sub_id), El(ALT), El(END)]
                        seq[last_start:] = [El(RULE_REF, sub_id)]
                    elif ch == "+":
                        self.rules[sub_id] = prev + [El(RULE_REF, sub_id), El(ALT)] + prev + [El(END)]
                        seq[last_start:] = [El(RULE_REF, sub_id)]
                    else:  # ?
                        self.rules[sub_id] = prev + [El(ALT), El(END)]
                        seq[last_start:] = [El(RULE_REF, sub_id)]
                last_start = len(seq)
            else:
                break
        return seq


def parse_gbnf(text: str) -> tuple[dict[int, list[El]], int]:
    return _Parser(text).parse()


# -- cross-request shared tables ---------------------------------------------
# The interned pushdown states, (state, cp) transition memo, and per-tokenizer
# piece/mask caches are pure functions of (grammar text, tokenizer) — nothing
# in them is request state.  Keying them by the grammar TEXT makes a server
# serving one JSON schema pay novel-state mask construction once per process,
# not once per request (the reference rebuilds llama_grammar per request,
# llama-grammar.cpp llama_grammar_init, and re-pays its per-candidate sweeps;
# here the sweeps memoize globally).  Frame ids (rule_id, pos) are
# deterministic from the text, so interned states are portable across
# instances parsed from the same text.


class _SharedTables:
    def __init__(self, text: str):
        self.rules, self.root = parse_gbnf(text)
        self.intern: dict[tuple, int] = {}
        self.states: list[tuple] = []
        self.tmemo: dict = {}
        # tokenizer -> (piece_cache, piece_text, mask_memo); weak-keyed so a
        # dropped tokenizer doesn't pin its vocab decode tables
        self.by_tok: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def tok_tables(self, tokenizer) -> tuple[dict, dict, dict]:
        try:
            t = self.by_tok.get(tokenizer)
            if t is None:
                t = ({}, {}, {})
                self.by_tok[tokenizer] = t
            return t
        except TypeError:  # non-weakref-able tokenizer: per-call tables
            return ({}, {}, {})


_SHARED: dict[str, _SharedTables] = {}
_SHARED_CAP = 64


def shared_tables(text: str) -> _SharedTables:
    # LRU keyed by insertion order: a hit re-inserts (most-recently-used at
    # the end); at capacity only the LRU entry is evicted, so the 65th
    # distinct grammar on a busy server no longer dumps every warm memo
    t = _SHARED.pop(text, None)
    if t is None:
        while len(_SHARED) >= _SHARED_CAP:
            _SHARED.pop(next(iter(_SHARED)))
        t = _SharedTables(text)
    _SHARED[text] = t
    return t


# -- pushdown acceptance -----------------------------------------------------


class Grammar:
    """Stack machine over parsed rules (cf. llama_grammar)."""

    def __init__(self, rules: dict[int, list[El]], root: int,
                 shared: Optional[_SharedTables] = None):
        self.rules = rules
        self.root = root
        self.stacks: list[tuple] = []
        self._intern = shared.intern if shared is not None else {}
        self._states = shared.states if shared is not None else []
        self._tmemo = shared.tmemo if shared is not None else {}
        self.reset()

    def reset(self) -> None:
        self.stacks = []
        # push each alternate of root
        for pos in self._alternate_starts(self.root):
            self._advance_into(((self.root, pos),), self.stacks)
        self.partial = b""

    def _alternate_starts(self, rule_id: int):
        rule = self.rules[rule_id]
        starts = [0]
        for i, el in enumerate(rule):
            if el.type == ALT:
                starts.append(i + 1)
        return starts

    def _el(self, frame) -> El:
        rid, pos = frame
        return self.rules[rid][pos]

    def _advance_into(self, stack: tuple, out: list) -> None:
        """Expand RULE_REFs/ENDs until top is a char matcher (advance_stack)."""
        if not stack:
            if stack not in out:
                out.append(stack)
            return
        top = self._el(stack[-1])
        if top.type in (CHAR, CHAR_NOT):
            if stack not in out:
                out.append(stack)
            return
        if top.type == RULE_REF:
            rid = top.value
            next_frame = (stack[-1][0], self._next_pos(stack[-1]))
            base = stack[:-1]
            # only keep the return frame if the alternate continues: a
            # frame parked on END *or ALT* is complete — pushing it leaks
            # one dead frame per loop iteration of x+/x* (stacks then grow
            # forever, every state is distinct, and the allowed-mask memo
            # never hits: an O(vocab) pushdown sweep EVERY token)
            if self._el(next_frame).type not in (END, ALT):
                base = base + (next_frame,)
            for pos in self._alternate_starts(rid):
                self._advance_into(base + ((rid, pos),), out)
            return
        if top.type in (END, ALT):
            # end of this alternate: pop
            self._advance_into(stack[:-1], out)
            return
        raise AssertionError(f"unexpected element {top}")

    def _next_pos(self, frame) -> int:
        """Position after the current element incl. its char-chain."""
        rid, pos = frame
        rule = self.rules[rid]
        pos += 1
        while pos < len(rule) and rule[pos].type in (CHAR_ALT, CHAR_RNG_UPPER):
            pos += 1
        return pos

    def _match_char(self, frame, cp: int) -> bool:
        rid, pos = frame
        rule = self.rules[rid]
        el = rule[pos]
        if el.type == CHAR:
            found = False
            i = pos
            while True:
                if i + 1 < len(rule) and rule[i + 1].type == CHAR_RNG_UPPER:
                    if rule[i].value <= cp <= rule[i + 1].value:
                        found = True
                    i += 2
                else:
                    if cp == rule[i].value:
                        found = True
                    i += 1
                if i >= len(rule) or rule[i].type != CHAR_ALT:
                    break
            return found
        if el.type == CHAR_NOT:
            found = False
            i = pos
            while True:
                if i + 1 < len(rule) and rule[i + 1].type == CHAR_RNG_UPPER:
                    if rule[i].value <= cp <= rule[i + 1].value:
                        found = True
                    i += 2
                else:
                    if cp == rule[i].value:
                        found = True
                    i += 1
                if i >= len(rule) or rule[i].type != CHAR_ALT:
                    break
            return not found
        return False

    def advance_cp_pure(self, stacks, cp: int):
        """accept_cp without mutation: stacks tuple -> new stacks list, or
        None if nothing accepts.  The allowed-mask prefix sweep shares
        advanced states across every token with a common prefix."""
        new_stacks: list[tuple] = []
        for stack in stacks:
            if not stack:
                continue
            if self._match_char(stack[-1], cp):
                frame = stack[-1]
                nxt = (frame[0], self._next_pos(frame))
                base = stack[:-1]
                if self._el(nxt).type not in (END, ALT):  # see _advance_into
                    base = base + (nxt,)
                self._advance_into(base, new_stacks)
        return new_stacks or None

    # -- interned transition memo (allowed-mask sweeps) ----------------------
    # The reachable pushdown state space of a grammar is small (states
    # repeat heavily once x+/x* return frames pop correctly), so (state,
    # codepoint) -> state transitions memoize globally: a vocab sweep then
    # costs one dict lookup per (token, char) instead of a stack walk.

    _TMEMO_CAP = 1 << 20

    def intern_state(self, stacks) -> int:
        key = tuple(stacks)
        sid = self._intern.get(key)
        if sid is None:
            sid = len(self._states)
            self._intern[key] = sid
            self._states.append(key)
        return sid

    def advance_interned(self, sid: int, cp: int):
        """interned state id + codepoint -> interned next id, or None."""
        key = (sid, cp)
        nxt = self._tmemo.get(key, _MISSING)
        if nxt is _MISSING:
            st = self.advance_cp_pure(self._states[sid], cp)
            nxt = None if st is None else self.intern_state(st)
            if len(self._tmemo) >= self._TMEMO_CAP:
                self._tmemo.clear()
            self._tmemo[key] = nxt
        return nxt

    def accept_cp(self, cp: int) -> bool:
        """Advance all stacks over one code point; False if nothing accepts."""
        new_stacks = self.advance_cp_pure(self.stacks, cp)
        if new_stacks is None:
            return False
        self.stacks = new_stacks
        return True

    def accepts_text(self, text: str) -> bool:
        """Would this text be accepted from the current state (no commit)?"""
        saved = self.stacks
        ok = True
        for ch in text:
            if not self.accept_cp(ord(ch)):
                ok = False
                break
        self.stacks = saved
        return ok

    @property
    def can_end(self) -> bool:
        return any(not s for s in self.stacks)

    def partial_ok(self, stacks, rest: bytes) -> bool:
        """Can the incomplete UTF-8 sequence `rest` complete to a code point
        that some stack's next char matcher takes?  The reference's
        llama_grammar_match_partial_char: the partial bytes bound the code
        points they can complete to, [low, high], and a positive class must
        meet that range; a negated class is taken unless one of its ranges
        meets it (the reference's approximation)."""
        n = (1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 2, 2, 3, 4)[rest[0] >> 4]
        if n == 0:
            return False  # a continuation byte cannot start a character
        value = rest[0] & ((1 << (7 - n)) - 1)
        for b in rest[1:]:
            value = (value << 6) | (b & 0x3F)
        n_remain = n - len(rest)
        if n_remain <= 0 or (n_remain == 1 and value < 2):
            return False  # complete, or an overlong 7-bit character
        low = value << (6 * n_remain)
        high = low | ((1 << (6 * n_remain)) - 1)
        if low == 0:
            low = {2: 1 << 11, 3: 1 << 16}.get(n_remain, low)
        for stack in stacks:
            if not stack:
                continue
            rid, pos = stack[-1]
            rule = self.rules[rid]
            positive = rule[pos].type == CHAR
            hit = False
            i = pos
            while True:
                if i + 1 < len(rule) and rule[i + 1].type == CHAR_RNG_UPPER:
                    hit = rule[i].value <= high and low <= rule[i + 1].value
                    i += 2
                else:
                    hit = low <= rule[i].value <= high
                    i += 1
                if hit or i >= len(rule) or rule[i].type != CHAR_ALT:
                    break
            if hit == positive:
                return True
        return False


class GrammarSampler:
    """Grammar-constrained sampling hook used by SamplerChain."""

    _MASK_MEMO_CAP = 256

    def __init__(self, gbnf_text: str):
        self._shared = shared_tables(gbnf_text)
        self.grammar = Grammar(self._shared.rules, self._shared.root,
                               shared=self._shared)
        # tokenizer-dependent caches bind lazily on first use (shared across
        # requests via _SharedTables.tok_tables); these placeholders serve
        # callers that never pass a tokenizer
        self._piece_cache: dict[int, bytes] = {}
        self._piece_text: dict[int, tuple] = {}  # tid -> (text, rest), partial==b""
        self.partial = b""
        # full-vocab allowed masks memoized by grammar state: states repeat
        # heavily during generation (e.g. "inside a JSON string"), and the
        # mask depends only on the state — so the O(vocab) pushdown sweep
        # runs once per distinct state, can be precomputed while the device
        # computes the next logits (the one-token-lookahead overlap), and persists
        # ACROSS requests (same grammar text + tokenizer = same masks)
        self._mask_memo: dict = {}
        self._bound_tok = None

    def _bind_tokenizer(self, tokenizer) -> None:
        """Point the piece/mask caches at the process-global tables for
        (grammar text, tokenizer) so repeat requests skip every novel-state
        sweep already paid by an earlier request."""
        if tokenizer is self._bound_tok:
            return
        pc, pt, mm = self._shared.tok_tables(tokenizer)
        self._piece_cache, self._piece_text, self._mask_memo = pc, pt, mm
        self._bound_tok = tokenizer

    def reset(self) -> None:
        self.grammar.reset()
        self.partial = b""

    def state_key(self):
        return (tuple(self.grammar.stacks), self.partial)

    def allowed_mask(self, tokenizer, vocab_size: int,
                     eos_id: int = -1) -> np.ndarray:
        """bool [vocab_size] of grammar-legal next tokens from the CURRENT
        state.  Memoized by state; logits-independent, so callers can
        compute it concurrently with the next decode step."""
        self._bind_tokenizer(tokenizer)
        key = (self.state_key(), eos_id)
        m = self._mask_memo.get(key)
        if m is None or m.size < vocab_size:
            m = self._sweep_mask(tokenizer, vocab_size, eos_id)
            if len(self._mask_memo) >= self._MASK_MEMO_CAP:
                self._mask_memo.clear()
            self._mask_memo[key] = m
        return m

    def _sweep_mask(self, tokenizer, vocab_size: int, eos_id: int) -> np.ndarray:
        """One O(distinct-prefixes) pushdown sweep: tokens sharing a text
        prefix share its advanced stacks via a sweep-local cache, and a
        rejected prefix prunes every token extending it — the trie-pruned
        form of the reference's per-candidate loop (llama_grammar_
        accept_token's candidate filter).  For restrictive grammars the
        cost collapses to (accepted prefixes x depth) PDA advances instead
        of vocab x piece-length."""
        advance = self.grammar.advance_interned
        root_sid = self.grammar.intern_state(self.grammar.stacks)
        states = self.grammar._states
        partial_memo: dict = {}

        def piece_ok(text: str, rest: bytes) -> bool:
            sid = root_sid
            for ch in text:
                sid = advance(sid, ord(ch))
                if sid is None:
                    return False
            if not rest:
                return bool(text)
            key = (sid, rest)
            ok = partial_memo.get(key)
            if ok is None:
                ok = partial_memo[key] = self.grammar.partial_ok(states[sid], rest)
            return ok

        m = np.zeros(vocab_size, bool)
        no_partial = not self.partial
        tcache = self._piece_text
        for t in range(vocab_size):
            if t == eos_id:
                m[t] = not self.partial and self.grammar.can_end
                continue
            if no_partial:  # common case: decoded (text, rest) per id caches
                tr = tcache.get(t)
                if tr is None:
                    piece = self._piece(t, tokenizer)
                    tr = self._split_partial(piece) if piece else ("", b"")
                    tcache[t] = tr
                text, rest = tr
                if not text and not rest:
                    continue  # empty piece
            else:
                piece = self._piece(t, tokenizer)
                if not piece:
                    continue
                text, rest = self._split_partial(self.partial + piece)
            m[t] = piece_ok(text, rest)
        return m

    def _piece(self, tid: int, tokenizer) -> bytes:
        s = self._piece_cache.get(tid)
        if s is None:
            raw = tokenizer.id_to_piece(tid)
            s = raw if isinstance(raw, bytes) else raw.encode("utf-8")
            self._piece_cache[tid] = s
        return s

    @staticmethod
    def _split_partial(data: bytes) -> tuple[str, bytes]:
        """Decode complete UTF-8 chars, returning (text, trailing
        incomplete sequence) — the reference's decode_utf8 partial-
        sequence handling (llama-grammar.cpp): byte-level BPE splits
        multi-byte characters across tokens, so the tail carries over."""
        for i in range(1, min(4, len(data)) + 1):
            b = data[-i]
            if b < 0x80:
                break  # ascii tail: everything complete
            if b >= 0xC0:  # lead byte at position -i
                need = 2 if b < 0xE0 else 3 if b < 0xF0 else 4
                if need > i:
                    return (data[:-i].decode("utf-8", errors="replace"),
                            data[-i:])
                break
        return data.decode("utf-8", errors="replace"), b""

    def token_allowed(self, tid: int, tokenizer, eos_id: int = -1) -> bool:
        self._bind_tokenizer(tokenizer)
        if tid == eos_id:
            return not self.partial and self.grammar.can_end
        piece = self._piece(tid, tokenizer)
        if not piece:
            return False
        text, rest = self._split_partial(self.partial + piece)
        stacks = self.grammar.stacks
        for ch in text:
            stacks = self.grammar.advance_cp_pure(stacks, ord(ch))
            if stacks is None:
                return False
        if rest:  # only if it can complete to a character the grammar takes
            return self.grammar.partial_ok(stacks, rest)
        return bool(text)

    def filter_candidates(self, c, tokenizer, eos_id: int = -1,
                          vocab_size: int = 0) -> None:
        ids = np.asarray(c.ids)
        if vocab_size and ids.size and int(ids.max()) < vocab_size:
            keep = self.allowed_mask(tokenizer, vocab_size, eos_id=eos_id)[ids]
        else:
            keep = np.ones(len(c.ids), bool)
            for i, tid in enumerate(c.ids):
                if not self.token_allowed(int(tid), tokenizer, eos_id=eos_id):
                    keep[i] = False
        if keep.any():
            c.keep(keep)
        c.sorted = False

    def accept_token(self, tid: int, tokenizer, eos_id: int = -1) -> None:
        self._bind_tokenizer(tokenizer)
        if tid == eos_id:
            return  # EOS carries no text; allowed iff can_end (filter)
        piece = self._piece(tid, tokenizer)
        text, self.partial = self._split_partial(self.partial + piece)
        for ch in text:
            if not self.grammar.accept_cp(ord(ch)):
                raise ValueError(f"token {tid} ({piece!r}) rejected by grammar")
