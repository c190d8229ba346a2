"""The port's copy of ``llama_kotlin_tpu/tokenizer/vocab.py``.

Vocabulary tables from GGUF metadata + the tokenizer facade.

Token attribute semantics follow the reference (llama_token_attr,
llama.h:107-120 / token_data.attr): NORMAL, UNKNOWN, CONTROL, USER_DEFINED,
UNUSED, BYTE.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

TOKEN_TYPE_NORMAL = 1
TOKEN_TYPE_UNKNOWN = 2
TOKEN_TYPE_CONTROL = 3
TOKEN_TYPE_USER_DEFINED = 4
TOKEN_TYPE_UNUSED = 5
TOKEN_TYPE_BYTE = 6


@dataclass
class Vocab:
    model: str = "llama"  # llama=SPM, gpt2=BPE, bert=WPM, t5=UGM
    pre: str = "default"
    tokens: list[str] = field(default_factory=list)
    scores: Optional[np.ndarray] = None
    token_type: Optional[np.ndarray] = None
    merges: list[str] = field(default_factory=list)
    bos_id: int = 1
    eos_id: int = 2
    unk_id: int = 0
    pad_id: int = -1
    cls_id: int = -1
    sep_id: int = -1
    # infill / fill-in-the-middle special ids (cf. llama_token_prefix/
    # middle/suffix/eot, reference include/llama.h:915-922)
    prefix_id: int = -1
    suffix_id: int = -1
    middle_id: int = -1
    eot_id: int = -1
    add_bos: bool = True
    add_eos: bool = False
    add_space_prefix: bool = True
    ignore_merges: bool = False
    # UGM (t5) extras
    escape_whitespaces: bool = True
    remove_extra_whitespaces: bool = False
    precompiled_charsmap: Optional[bytes] = None

    token_to_id: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.token_to_id and self.tokens:
            self.token_to_id = {t: i for i, t in enumerate(self.tokens)}

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def type_of(self, tid: int) -> int:
        if self.token_type is None:
            return TOKEN_TYPE_NORMAL
        return int(self.token_type[tid])

    def is_special(self, tid: int) -> bool:
        return self.type_of(tid) in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED,
                                     TOKEN_TYPE_UNKNOWN)

    def is_control(self, tid: int) -> bool:
        """Tokens the detokenizer hides when skip_special=True: CONTROL/
        UNKNOWN only — USER_DEFINED tokens are real text (multi-space
        indents etc.) and always render (cf. llama_detokenize)."""
        return self.type_of(tid) in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_UNKNOWN)

    def special_tokens(self) -> list[int]:
        """Token ids eligible for special-token partitioning during encode
        (cf. tokenizer_st_partition, llama-vocab.cpp)."""
        out = []
        for i in range(self.n_tokens):
            if self.type_of(i) in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED):
                out.append(i)
        return out

    def byte_token(self, b: int) -> int:
        """Byte fallback token (SPM '<0xXX>' convention)."""
        s = f"<0x{b:02X}>"
        tid = self.token_to_id.get(s)
        if tid is not None:
            return tid
        # fall back to the raw char (cf. llama_byte_to_token falling through)
        return self.token_to_id.get(chr(b), self.unk_id)


def vocab_from_metadata(md: dict) -> Vocab:
    def get(key, default=None):
        v = md.get(key, default)
        if hasattr(v, "item") and not isinstance(v, (list, np.ndarray)):
            v = v.item()
        return v

    tokens = get("tokenizer.ggml.tokens", []) or []
    scores = md.get("tokenizer.ggml.scores")
    ttype = md.get("tokenizer.ggml.token_type")
    model = get("tokenizer.ggml.model", "llama")
    v = Vocab(
        model=model,
        pre=get("tokenizer.ggml.pre", "default") or "default",
        tokens=list(tokens),
        scores=None if scores is None else np.asarray(scores, np.float32),
        token_type=None if ttype is None else np.asarray(ttype, np.int32),
        merges=list(get("tokenizer.ggml.merges", []) or []),
        bos_id=int(get("tokenizer.ggml.bos_token_id", 1)),
        eos_id=int(get("tokenizer.ggml.eos_token_id", 2)),
        unk_id=int(get("tokenizer.ggml.unknown_token_id", 0)),
        pad_id=int(get("tokenizer.ggml.padding_token_id", -1)),
        cls_id=int(get("tokenizer.ggml.cls_token_id", -1)),
        sep_id=int(get("tokenizer.ggml.seperator_token_id", -1)),
        prefix_id=int(get("tokenizer.ggml.prefix_token_id", -1)),
        suffix_id=int(get("tokenizer.ggml.suffix_token_id", -1)),
        middle_id=int(get("tokenizer.ggml.middle_token_id", -1)),
        eot_id=int(get("tokenizer.ggml.eot_token_id", -1)),
        add_bos=bool(get("tokenizer.ggml.add_bos_token", model == "llama")),
        add_eos=bool(get("tokenizer.ggml.add_eos_token", model == "t5")),
        add_space_prefix=bool(get("tokenizer.ggml.add_space_prefix",
                                  model in ("llama", "t5"))),
        remove_extra_whitespaces=bool(
            get("tokenizer.ggml.remove_extra_whitespaces", False)
        ),
    )
    pc = md.get("tokenizer.ggml.precompiled_charsmap")
    if pc is not None:
        v.precompiled_charsmap = bytes(np.asarray(pc, np.uint8))
    if model == "gpt2" and v.pre in ("llama3", "llama-bpe"):
        v.ignore_merges = True
    return v


def build_tokenizer(md_or_vocab) -> "object":
    """Create the right tokenizer for a GGUF metadata dict or Vocab."""
    vocab = md_or_vocab if isinstance(md_or_vocab, Vocab) else vocab_from_metadata(md_or_vocab)
    if vocab.model in ("llama", "spm"):
        from llama_kotlin_tpu_torch.tokenizer.spm import SPMTokenizer

        return SPMTokenizer(vocab)
    if vocab.model == "gpt2":
        from llama_kotlin_tpu_torch.tokenizer.bpe import BPETokenizer

        return BPETokenizer(vocab)
    if vocab.model == "bert":
        from llama_kotlin_tpu_torch.tokenizer.wpm import WPMTokenizer

        return WPMTokenizer(vocab)
    if vocab.model == "t5":
        from llama_kotlin_tpu_torch.tokenizer.ugm import UGMTokenizer

        return UGMTokenizer(vocab)
    raise NotImplementedError(f"tokenizer model {vocab.model!r}")


def partition_specials(text: str, vocab: Vocab, parse_special: bool = True) -> list:
    """Split text into (is_special, fragment) pieces on special-token
    literals, longest-first (cf. tokenizer_st_partition).

    USER_DEFINED tokens are always partitioned (they are pre-tokenizer
    added-tokens, e.g. mpt's multi-space tokens); CONTROL/UNKNOWN only when
    parse_special is set — same rule as the reference.
    """
    eligible = []
    for t in vocab.special_tokens():
        if not vocab.tokens[t]:
            continue
        if not parse_special and vocab.type_of(t) != TOKEN_TYPE_USER_DEFINED:
            continue
        eligible.append(t)
    specials = sorted(((vocab.tokens[t], t) for t in eligible), key=lambda kv: -len(kv[0]))
    frags: list = [(False, text)]
    for s_text, s_id in specials:
        out = []
        for is_sp, frag in frags:
            if is_sp:
                out.append((is_sp, frag))
                continue
            while True:
                idx = frag.find(s_text)
                if idx < 0:
                    break
                if idx > 0:
                    out.append((False, frag[:idx]))
                out.append((True, s_id))
                frag = frag[idx + len(s_text):]
            if frag:
                out.append((False, frag))
        frags = out
    return frags
