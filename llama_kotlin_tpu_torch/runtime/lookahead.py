"""Lookahead (Jacobi) decoding (port of ``llama_kotlin_tpu/runtime/lookahead.py``).

Parity target: examples/lookahead/lookahead.cpp (reference, 486 LoC),
after https://lmsys.org/blog/2023-11-21-lookahead-decoding/ — one decode
step carries, besides the current token:

- W x (N-1) lookahead tokens from the past Jacobi iterations, arranged as
  diagonal branches (seq ids 1..W) so level-j window-i tokens attend to
  levels <j of windows <=i,
- up to G verification n-grams from the observed pool (seq ids W+1..W+G),
  each a candidate continuation of the current token.

Accepted verification tokens advance the output several positions per
decode; the lookahead levels feed an n-gram pool keyed by first token.
Multi-seq cell membership rides Batch.seq_mask; branch bookkeeping uses
the same seq_rm/cp/keep cache ops the reference uses.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from llama_kotlin_tpu_torch.runtime.batch import Batch


class NgramPool:
    """Per-first-token ring buffer of (N-1)-grams, capacity G
    (cf. ngram_container, lookahead.cpp:20-35)."""

    def __init__(self, N: int, G: int):
        self.N, self.G = N, G
        self.grams: dict[int, list[tuple[int, ...]]] = {}

    def get(self, first: int) -> list[tuple[int, ...]]:
        return self.grams.get(first, [])

    def add(self, first: int, gram: tuple[int, ...]) -> None:
        cur = self.grams.setdefault(first, [])
        if gram in cur:
            return
        cur.append(gram)
        if len(cur) > self.G:
            cur.pop(0)


def lookahead_generate(
    ctx,
    prompt_tokens: np.ndarray,
    n_predict: int,
    *,
    W: int = 15,
    N: int = 5,
    G: int = 15,
    eos_id: int = -1,
    sample: Optional[Callable[[np.ndarray], int]] = None,
) -> tuple[list[int], dict]:
    """Generate up to n_predict tokens; returns (tokens, stats).

    Requires ctx.n_seq_max > W + G (seq 0 + W lookahead + G verification).
    """
    assert ctx.n_seq_max > W + G, "raise n_seq_max for this W/G"
    sample = sample or (lambda logits: int(np.argmax(logits)))
    prompt = np.asarray(prompt_tokens, np.int32)

    rc = ctx.decode(Batch.single(prompt))
    assert rc == 0
    for s in range(1, W + G + 1):
        ctx.seq_cp(0, s)
    n_past = len(prompt)

    tok_id = sample(ctx.get_logits_ith(-1))
    out = [tok_id]
    n_accept = 0
    n_decodes = 0

    # Jacobi window init (reference uses 100 + i; keep in-vocab)
    tokens_j = [[(100 + i) % ctx.cfg.vocab_size for i in range(W)]
                for _ in range(N - 1)]
    pool = NgramPool(N, G)
    n_seqs = W + G + 1
    all_seq_mask = (np.int32((1 << n_seqs) - 1) if n_seqs <= 31
                    else np.int32(-1))  # all 32 bits

    done = tok_id == eos_id
    while len(out) < n_predict and not done:
        toks, pos, seq, mask, outf = [], [], [], [], []

        def add(t, p, s_primary, s_mask, want):
            toks.append(t)
            pos.append(p)
            seq.append(s_primary)
            mask.append(s_mask)
            outf.append(want)

        # current token, member of every branch (lookahead.cpp:213)
        add(tok_id, n_past, 0, all_seq_mask, True)

        # verification n-grams for this first token (rows recorded per gram)
        ngrams_cur = [list(g) for g in pool.get(tok_id)]
        ng_active = [True] * len(ngrams_cur)
        ng_batch_idx = [[0] * N for _ in ngrams_cur]  # index into batch rows
        for j in range(N - 1):
            for g, gram in enumerate(ngrams_cur):
                ng_batch_idx[g][j + 1] = len(toks)
                add(gram[j], n_past + j + 1, W + 1 + g,
                    np.int32(1) << (W + 1 + g), True)

        # first lookahead level, windows 1..W-1: member of branches i+1..W
        for i in range(1, W):
            bits = 0
            for s in range(i + 1, W + 1):
                bits |= 1 << s
            add(tokens_j[0][i], n_past + i, i + 1, np.int32(bits), False)

        # remaining levels
        last_level_idx = [0] * W
        for j in range(1, N - 1):
            for i in range(W):
                if j == N - 2:
                    last_level_idx[i] = len(toks)
                add(tokens_j[j][i], n_past + j + i, i + 1,
                    np.int32(1) << (i + 1), j == N - 2)

        batch = Batch(np.asarray(toks, np.int32), np.asarray(pos, np.int32),
                      np.asarray(seq, np.int32), np.asarray(outf, bool),
                      np.asarray(mask, np.int32))
        rc = ctx.decode(batch)
        if rc != 0:
            raise RuntimeError("KV cache full during lookahead — raise n_cells")
        n_decodes += 1
        logits = ctx.get_logits()
        # batch row -> logits row for output-flagged rows
        row_of = {}
        r = 0
        for i, want in enumerate(outf):
            if want:
                row_of[i] = r
                r += 1

        n_past0 = n_past
        seq_id_best = 0
        for v in range(N):
            if v > 0:
                i_batch = 0
                for g in range(len(ngrams_cur)):
                    if ng_active[g]:
                        i_batch = ng_batch_idx[g][v]
                        seq_id_best = W + 1 + g
                        n_accept += 1
                        break
                if i_batch == 0:
                    break
            else:
                i_batch = 0

            tok_id = sample(logits[row_of[i_batch]])
            out.append(tok_id)
            n_past += 1
            if tok_id == eos_id or len(out) >= n_predict:
                done = tok_id == eos_id or len(out) >= n_predict
                break

            # verification bookkeeping (lookahead.cpp:318-328)
            for g in range(len(ngrams_cur)):
                if ng_active[g]:
                    if v == N - 1 or tok_id != ngrams_cur[g][v]:
                        ng_active[g] = False

            # Jacobi update: shift levels up, refill the last level
            tokens_j_prev = list(tokens_j[0])
            for j in range(N - 2):
                tokens_j[j] = tokens_j[j + 1]
            if v == 0:
                tokens_j[N - 2] = [sample(logits[row_of[last_level_idx[i]]])
                                   for i in range(W)]
            else:
                tokens_j[N - 2] = list(tokens_j[0])

            # harvest observed n-grams (columns of the window stack)
            if v == 0:
                for f in range(W):
                    pool.add(tokens_j_prev[f],
                             tuple(tokens_j[j][f] for j in range(N - 1)))

        # KV management (lookahead.cpp:440-453): drop unaccepted batch cells
        ctx.seq_rm(-1, n_past, -1)
        if seq_id_best != 0:
            ctx.seq_keep(seq_id_best)
            ctx.seq_cp(seq_id_best, 0)
            ctx.seq_rm(seq_id_best)
            for s in range(1, W + G + 1):
                ctx.seq_cp(0, s)

    stats = {"n_predict": len(out), "n_accept": n_accept,
             "n_decodes": n_decodes, "W": W, "N": N, "G": G}
    return out, stats
