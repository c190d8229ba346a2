"""The port's copy of ``llama_kotlin_tpu/sampling/samplers.py``: the host sampler chain.

Parity targets: llama-sampling.cpp (softmax/top-k/top-p/min-p/tail-free/
typical/entropy-temp/penalties/mirostat, reference src/llama-sampling.cpp)
and the configurable chain order of common/sampling.cpp:230-264
(sampler_queue: top_k -> tfs -> typical -> top_p -> min_p -> temperature by
default, then dist/greedy/mirostat).

Operates on float32 numpy logits.  Candidate arrays carry (ids, logits)
and are filtered in place like the reference's llama_token_data_array.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


@dataclass
class SamplingParams:
    """Mirror of llama_sampling_params (common/sampling.h)."""

    n_prev: int = 64  # penalty window
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    tfs_z: float = 1.0
    typical_p: float = 1.0
    temp: float = 0.8
    dynatemp_range: float = 0.0
    dynatemp_exponent: float = 1.0
    penalty_last_n: int = 64
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    mirostat: int = 0  # 0 off, 1 v1, 2 v2
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    penalize_nl: bool = False
    seed: int = 0xFFFFFFFF
    samplers: tuple[str, ...] = ("top_k", "tfs_z", "typical_p", "top_p", "min_p", "temperature")
    grammar: Optional[str] = None
    logit_bias: dict[int, float] = field(default_factory=dict)
    cfg_scale: float = 1.0
    min_keep: int = 1


@dataclass
class Candidates:
    ids: np.ndarray  # int32
    logits: np.ndarray  # float32
    sorted: bool = False

    @staticmethod
    def from_logits(logits: np.ndarray) -> "Candidates":
        logits = np.asarray(logits, np.float32)
        return Candidates(np.arange(logits.shape[-1], dtype=np.int32), logits.copy())

    def sort(self) -> None:
        if not self.sorted:
            order = np.argsort(-self.logits, kind="stable")
            self.ids = self.ids[order]
            self.logits = self.logits[order]
            self.sorted = True

    def probs(self) -> np.ndarray:
        self.sort()
        x = self.logits - self.logits[0]
        e = np.exp(x)
        return e / e.sum()

    def keep(self, mask_or_count) -> None:
        if isinstance(mask_or_count, (int, np.integer)):
            self.ids = self.ids[:mask_or_count]
            self.logits = self.logits[:mask_or_count]
        else:
            self.ids = self.ids[mask_or_count]
            self.logits = self.logits[mask_or_count]


# -- individual samplers (cf. llama_sample_* impls) --------------------------


def top_k(c: Candidates, k: int, min_keep: int = 1) -> None:
    if k <= 0:
        return
    k = max(k, min_keep)
    c.sort()
    c.keep(min(k, len(c.ids)))


def top_p(c: Candidates, p: float, min_keep: int = 1) -> None:
    if p >= 1.0:
        return
    probs = c.probs()
    cum = np.cumsum(probs)
    n = int(np.searchsorted(cum, p) + 1)
    c.keep(max(n, min_keep))


def min_p(c: Candidates, p: float, min_keep: int = 1) -> None:
    if p <= 0.0 or len(c.ids) == 0:
        return
    c.sort()
    # filter tokens with prob < p * max_prob (done on logits directly)
    thresh = c.logits[0] + np.log(p)
    n = max(int((c.logits >= thresh).sum()), min_keep)
    c.keep(n)


def tail_free(c: Candidates, z: float, min_keep: int = 1) -> None:
    if z >= 1.0 or len(c.ids) <= 2:
        return
    probs = c.probs()
    d1 = np.diff(probs)
    d2 = np.abs(np.diff(d1))
    s = d2.sum()
    if s < 1e-12:
        norm2 = np.full_like(d2, 1.0 / max(len(d2), 1))
    else:
        norm2 = d2 / s
    cum = np.cumsum(norm2)
    n = len(c.ids)
    idx = np.nonzero(cum > z)[0]
    if idx.size:
        n = int(idx[0]) + 1
    c.keep(max(n, min_keep))


def typical(c: Candidates, p: float, min_keep: int = 1) -> None:
    if p >= 1.0:
        return
    probs = c.probs()
    ent = -np.sum(probs * np.log(probs + 1e-12))
    shifted = np.abs(-np.log(probs + 1e-12) - ent)
    order = np.argsort(shifted, kind="stable")
    sp = probs[order]
    cum = np.cumsum(sp)
    n = int(np.searchsorted(cum, p) + 1)
    n = max(n, min_keep)
    sel = order[:n]
    c.ids = c.ids[sel]
    c.logits = c.logits[sel]
    c.sorted = False


def temperature(c: Candidates, temp: float, dynatemp_range: float = 0.0,
                dynatemp_exponent: float = 1.0) -> None:
    if dynatemp_range > 0.0:
        # entropy-scaled dynamic temperature (llama_sample_entropy)
        dyn_min = max(0.0, temp - dynatemp_range)
        dyn_max = temp + dynatemp_range
        probs = c.probs()
        ent = -np.sum(probs * np.log(probs + 1e-12))
        max_ent = np.log(max(len(c.ids), 2))
        norm = ent / max_ent if max_ent > 0 else 0.0
        t = dyn_min + (dyn_max - dyn_min) * (norm**dynatemp_exponent)
        c.logits = c.logits / max(t, 1e-3)
    elif temp > 0.0:
        c.logits = c.logits / temp


def penalties(c: Candidates, prev: Sequence[int], repeat: float, freq: float,
              present: float, nl_id: int = -1, penalize_nl: bool = True) -> None:
    """Repetition/frequency/presence penalties (llama_sample_repetition_penalties)."""
    if not len(prev) or (repeat == 1.0 and freq == 0.0 and present == 0.0):
        return
    prev_arr = np.asarray(prev, np.int64)
    uniq, counts = np.unique(prev_arr, return_counts=True)
    nl_logit = None
    # operate via a map over the candidate array
    id_index = np.full(int(c.ids.max()) + 1 if len(c.ids) else 1, -1, np.int64)
    id_index[c.ids] = np.arange(len(c.ids))
    for t, cnt in zip(uniq, counts):
        if t >= len(id_index) or id_index[t] < 0:
            continue
        i = id_index[t]
        if t == nl_id and not penalize_nl:
            nl_logit = c.logits[i]
        l = c.logits[i]
        if repeat != 1.0:
            l = l * repeat if l <= 0 else l / repeat
        l -= cnt * freq + float(present)
        c.logits[i] = l
    if nl_logit is not None:
        c.logits[id_index[nl_id]] = nl_logit
    c.sorted = False


def apply_guidance(logits: np.ndarray, guidance_logits: np.ndarray, scale: float) -> np.ndarray:
    """Classifier-free guidance (llama_sample_apply_guidance)."""
    return scale * (logits - guidance_logits) + guidance_logits


# -- chain -------------------------------------------------------------------


class SamplerChain:
    """Stateful sampler: penalties history + mirostat mu + grammar hook.

    Parity: llama_sampling_context (common/sampling.cpp)."""

    def __init__(self, params: SamplingParams, vocab_size: int, nl_id: int = -1):
        self.p = params
        self.vocab_size = vocab_size
        self.nl_id = nl_id
        self.prev: list[int] = []
        self.mirostat_mu = 2.0 * params.mirostat_tau
        seed = params.seed
        if seed == 0xFFFFFFFF:
            seed = None
        self.rng = np.random.default_rng(seed)
        self.grammar = None
        if params.grammar:
            from llama_kotlin_tpu_torch.sampling.grammar import GrammarSampler

            self.grammar = GrammarSampler(params.grammar)
        self.n_sampled = 0

    def reset(self) -> None:
        self.prev.clear()
        self.mirostat_mu = 2.0 * self.p.mirostat_tau
        if self.grammar is not None:
            self.grammar.reset()

    # -- main entry (cf. llama_sampling_sample) ------------------------------

    def sample(self, logits: np.ndarray, tokenizer=None,
               guidance_logits: Optional[np.ndarray] = None) -> int:
        p = self.p
        logits = np.asarray(logits, np.float32).copy()
        if guidance_logits is not None and p.cfg_scale != 1.0:
            logits = apply_guidance(logits, np.asarray(guidance_logits, np.float32), p.cfg_scale)
        for tid, bias in p.logit_bias.items():
            logits[tid] += bias

        c = Candidates.from_logits(logits)
        last = self.prev[-p.penalty_last_n:] if p.penalty_last_n else []
        penalties(c, last, p.penalty_repeat, p.penalty_freq, p.penalty_present,
                  nl_id=self.nl_id, penalize_nl=p.penalize_nl)

        if self.grammar is not None and tokenizer is not None:
            eos = getattr(getattr(tokenizer, "vocab", None), "eos_id", -1)
            self.grammar.filter_candidates(c, tokenizer, eos_id=eos,
                                           vocab_size=self.vocab_size)

        if p.temp < 0.0:
            # "sample with probs but greedy" mode
            c.sort()
            tok = int(c.ids[0])
        elif p.temp == 0.0:
            tok = int(c.ids[np.argmax(c.logits)])
        elif p.mirostat == 1:
            tok = self._mirostat_v1(c)
        elif p.mirostat == 2:
            tok = self._mirostat_v2(c)
        else:
            for name in p.samplers:
                if name == "top_k":
                    top_k(c, p.top_k, p.min_keep)
                elif name == "tfs_z":
                    tail_free(c, p.tfs_z, p.min_keep)
                elif name == "typical_p":
                    typical(c, p.typical_p, p.min_keep)
                elif name == "top_p":
                    top_p(c, p.top_p, p.min_keep)
                elif name == "min_p":
                    min_p(c, p.min_p, p.min_keep)
                elif name == "temperature":
                    temperature(c, p.temp, p.dynatemp_range, p.dynatemp_exponent)
            tok = self._dist(c)
        return tok

    def precompute_grammar(self, tokenizer) -> None:
        """Warm the grammar's allowed-mask memo for the CURRENT state —
        called while the device computes the next logits (the one-token-
        lookahead overlap): sample()'s grammar filter then
        hits the memo instead of paying the O(vocab) pushdown sweep on the
        critical path."""
        if self.grammar is not None and tokenizer is not None:
            eos = getattr(getattr(tokenizer, "vocab", None), "eos_id", -1)
            self.grammar.allowed_mask(tokenizer, self.vocab_size, eos_id=eos)

    def accept(self, token: int, tokenizer=None, apply_grammar: bool = True) -> None:
        self.prev.append(int(token))
        if len(self.prev) > max(self.p.n_prev, self.p.penalty_last_n):
            self.prev.pop(0)
        if self.grammar is not None and apply_grammar and tokenizer is not None:
            eos = getattr(getattr(tokenizer, "vocab", None), "eos_id", -1)
            self.grammar.accept_token(int(token), tokenizer, eos_id=eos)
        self.n_sampled += 1

    # -- helpers -------------------------------------------------------------

    def _dist(self, c: Candidates) -> int:
        probs = c.probs()
        idx = self.rng.choice(len(probs), p=probs)
        return int(c.ids[idx])

    def _mirostat_v1(self, c: Candidates) -> int:
        p = self.p
        temperature(c, p.temp)
        probs = c.probs()
        n = len(probs)
        # estimate s_hat from top-100 Zipf fit (llama_sample_token_mirostat)
        m = min(100, n - 1)
        if m > 0:
            t_i = np.log(np.arange(2, m + 2) / np.arange(1, m + 1))
            b_i = np.log(probs[:m] / probs[1 : m + 1])
            s_hat = float((t_i * b_i).sum() / (t_i * t_i).sum()) if (t_i * t_i).sum() else 1.0
        else:
            s_hat = 1.0
        eps = s_hat - 1
        k = ((eps * (2**self.mirostat_mu)) / (1 - float(self.vocab_size) ** (-eps))) ** (1 / s_hat)
        k = int(max(1, min(np.floor(k) if np.isfinite(k) else 1, n)))
        c.keep(k)
        tok_idx = self.rng.choice(len(c.ids), p=c.probs())
        tok = int(c.ids[tok_idx])
        surprise = -np.log2(c.probs()[tok_idx] + 1e-12)
        self.mirostat_mu -= self.p.mirostat_eta * (surprise - self.p.mirostat_tau)
        return tok

    def _mirostat_v2(self, c: Candidates) -> int:
        p = self.p
        temperature(c, p.temp)
        probs = c.probs()
        surprises = -np.log2(probs + 1e-12)
        mask = surprises <= self.mirostat_mu
        if not mask.any():
            mask[0] = True
        c.keep(mask)
        probs = c.probs()
        idx = self.rng.choice(len(probs), p=probs)
        tok = int(c.ids[idx])
        surprise = -np.log2(probs[idx] + 1e-12)
        self.mirostat_mu -= p.mirostat_eta * (surprise - p.mirostat_tau)
        return tok
