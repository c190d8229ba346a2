"""Speculative decoding and prompt-lookup drafting (port of
``llama_kotlin_tpu/runtime/speculative.py``).

Parity targets:
- examples/speculative/speculative.cpp: a draft model proposes n_draft
  tokens, the target verifies them in one batched decode, the longest
  agreeing prefix is accepted, and both caches are rolled back (seq_rm)
  past the first mismatch; ``speculative_generate_tree`` adds the p_split
  branches.
- examples/lookup + common/ngram-cache.cpp: prompt-lookup decoding drafts
  from n-gram continuations already seen in the sequence, verified the
  same way, with no draft model.

The verification step fits the unified cell cache: the draft chunk is one
flat ubatch with logits at every position.  ``speculative_generate_device``
keeps draft, verify, acceptance and rollback on the device; where JAX
compiles it into one ``lax.while_loop``, the port runs a Python loop of
device work that reads back one flag a round.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from llama_kotlin_tpu_torch.runtime.batch import Batch, bucket_size
from llama_kotlin_tpu_torch.runtime.context import LlamaContext


@dataclass
class SpecStats:
    n_drafted: int = 0
    n_accepted: int = 0
    n_target_calls: int = 0

    @property
    def accept_rate(self) -> float:
        return self.n_accepted / self.n_drafted if self.n_drafted else 0.0


def _greedy(logits: np.ndarray) -> int:
    return int(np.argmax(logits))


def _n_vis(ctx: LlamaContext, span: int) -> int:
    return next((b for b in ctx.vis_buckets if b >= span), ctx.n_cells)


def _draft_chain_device(draft: LlamaContext, last: int, n_past: int,
                        k: int) -> Optional[list[int]]:
    """Greedy K-step draft chain as one on-device generate_loop: the K
    proposals come back in one copy (the draft cache is updated exactly
    like K single decodes), or None when the cache can't seat K cells
    (the caller falls back)."""
    from llama_kotlin_tpu_torch.runtime.generate import SampleParams, generate_loop

    meta = draft.meta
    slots = meta.find_slots(k)
    if slots is None:
        return None
    pos = np.arange(n_past, n_past + k, dtype=np.int32)
    meta.commit(slots, pos, np.zeros(k, np.int32))
    dev = draft.device
    col = lambda v: torch.full((1,), v, dtype=torch.int32, device=dev)  # noqa: E731
    out, _ = generate_loop(
        draft.params, draft.cfg, draft.cache,
        *meta.device_view(_n_vis(draft, meta.used_span()), dev),
        col(last), col(n_past), col(0), torch.from_numpy(slots.reshape(k, 1)).to(dev),
        k, SampleParams())
    return [int(t) for t in out[:, 0].cpu().numpy()]


def _top1(ctx: LlamaContext) -> np.ndarray:
    return ctx.get_topk(1)[1][:, 0]


def speculative_generate(
    target: LlamaContext,
    draft: LlamaContext,
    prompt_tokens,
    n_predict: int,
    n_draft: int = 5,
    eos_id: int = -1,
    sample_fn: Optional[Callable[[np.ndarray], int]] = None,
) -> tuple[list[int], SpecStats]:
    """Greedy speculative decoding with a draft model.

    Returns (generated tokens, stats).  Output is identical to plain greedy
    decoding of the target (same argmax decisions).
    """
    sample = sample_fn or _greedy
    greedy = sample_fn is None  # device top-k path (no full-vocab copy)
    prompt_tokens = np.asarray(prompt_tokens, np.int32)
    for c in (target, draft):
        c.clear()
        rc = c.decode(Batch.single(prompt_tokens))
        if rc != 0:
            raise RuntimeError("prefill failed")
    stats = SpecStats()
    out: list[int] = []
    last = int(_top1(target)[0]) if greedy else sample(target.get_logits()[0])
    stats.n_target_calls += 1
    out.append(last)
    n_past = len(prompt_tokens)  # same for target and draft

    while len(out) < n_predict and last != eos_id:
        # 1. draft proposes a chain greedily: one device loop when greedy
        # (K steps), per-step decodes otherwise
        proposals: list[int] = []
        if greedy:
            proposals = _draft_chain_device(draft, last, n_past, n_draft) or []
        if not proposals:
            d_tok = last
            for i in range(n_draft):
                rc = draft.decode(Batch(tokens=[d_tok], pos=[n_past + i],
                                        seq_id=[0], output=[True]))
                if rc != 0:
                    break
                d_tok = int(_top1(draft)[0])
                proposals.append(d_tok)
        if not proposals:
            # cache exhausted: fall back to plain decode of `last`
            rc = target.decode(Batch(tokens=[last], pos=[n_past], seq_id=[0],
                                     output=[True]))
            if rc != 0:
                break
            last = int(_top1(target)[0]) if greedy else sample(target.get_logits()[0])
            stats.n_target_calls += 1
            out.append(last)
            n_past += 1
            continue

        # 2. target verifies the whole chain in one batch; row i predicts
        # the token after chain[i], so row len(proposals) is the correction
        # when everything is accepted
        chain = [last] + proposals
        pos = np.arange(n_past, n_past + len(chain), dtype=np.int32)
        rc = target.decode(Batch(np.array(chain, np.int32), pos,
                                 np.zeros(len(chain), np.int32),
                                 np.ones(len(chain), bool)))
        stats.n_target_calls += 1
        if rc != 0:
            break
        if greedy:  # one [n, 1] copy for the whole verify batch
            t_choices = _top1(target)
        else:
            t_logits = target.get_logits()  # [len(chain), vocab]
            t_choices = [sample(t_logits[i]) for i in range(len(chain))]
        stats.n_drafted += len(proposals)

        n_accept = 0
        for i, p in enumerate(proposals):
            if (int(t_choices[i]) == p and p != eos_id
                    and len(out) + n_accept + 1 < n_predict):
                n_accept += 1
            else:
                break
        stats.n_accepted += n_accept
        # the correction token comes from the target at the first mismatch
        correction = int(t_choices[n_accept])
        out.extend(proposals[:n_accept])
        out.append(correction)
        new_past = n_past + n_accept + 1

        # 3. roll back both caches past the accepted region
        target.seq_rm(0, new_past, -1)
        draft.seq_rm(0, new_past, -1)
        n_past = new_past
        last = correction
    return out[:n_predict], stats


def speculative_generate_tree(
    target: LlamaContext,
    draft: LlamaContext,
    prompt_tokens,
    n_predict: int,
    n_draft: int = 5,
    n_branches: int = 4,
    p_split: float = 0.1,
    eos_id: int = -1,
) -> tuple[list[int], SpecStats]:
    """Tree-draft speculative decoding (parity: speculative.cpp seq_draft
    branches with p_split forking).

    When the draft's second-best token has probability > p_split * best, the
    draft forks a new branch (seq_cp) and both continuations are verified by
    the target in ONE batch: tree nodes share cache cells across branches
    through seq bitmasks.  Greedy target verification keeps the output
    identical to plain greedy decoding.
    """
    assert target.n_seq_max > n_branches and draft.n_seq_max > n_branches
    prompt_tokens = np.asarray(prompt_tokens, np.int32)
    for c in (target, draft):
        c.clear()
        rc = c.decode(Batch.single(prompt_tokens))
        if rc != 0:
            raise RuntimeError("prefill failed")
    stats = SpecStats()
    out: list[int] = []
    last = int(_top1(target)[0])
    stats.n_target_calls += 1
    out.append(last)
    n_past = len(prompt_tokens)
    all_branch_mask = np.int32(sum(1 << b for b in range(1, n_branches + 1)))

    while len(out) < n_predict and last != eos_id:
        for c in (target, draft):
            for b in range(1, n_branches + 1):
                c.seq_cp(0, b)

        # -- draft phase: grow a token tree ---------------------------------
        # paths[b] = tokens decoded into the draft cache along branch b
        paths: dict[int, list[int]] = {1: []}
        next_tok: dict[int, int] = {1: int(last)}
        n_free = n_branches - 1
        ok = True
        for _depth in range(n_draft):
            active = [b for b in paths if len(paths[b]) == _depth]
            if not active:
                break
            toks = np.array([next_tok[b] for b in active], np.int32)
            pos = np.array([n_past + _depth] * len(active), np.int32)
            seqs = np.array(active, np.int32)
            mask = (np.int32(1) << seqs) if _depth > 0 else \
                np.full(len(active), all_branch_mask, np.int32)
            rc = draft.decode(Batch(toks, pos, seqs, np.ones(len(active), bool), mask))
            if rc != 0:
                ok = False
                break
            # device top-2: p2/p1 = exp(l2 - l1), so the p_split fork
            # test needs only [n, 2] values and ids, not the vocab row
            tv, ti = draft.get_topk(2)
            for i, b in enumerate(active):
                paths[b].append(next_tok[b])
                next_tok[b] = int(ti[i, 0])
                ratio = float(np.exp(np.float64(tv[i, 1]) - np.float64(tv[i, 0])))
                if n_free > 0 and ratio > p_split:
                    nb = next(x for x in range(1, n_branches + 1) if x not in paths)
                    draft.seq_cp(b, nb)
                    paths[nb] = list(paths[b])
                    next_tok[nb] = int(ti[i, 1])
                    n_free -= 1
        if not ok or not any(paths.values()):
            # cache exhausted or nothing drafted: plain decode of `last`
            target.seq_rm(-1, n_past, -1)
            draft.seq_rm(-1, n_past, -1)
            rc = target.decode(Batch(tokens=[last], pos=[n_past], seq_id=[0],
                                     output=[True]))
            if rc != 0:
                break
            last = int(_top1(target)[0])
            stats.n_target_calls += 1
            out.append(last)
            n_past += 1
            continue

        # -- build the node tree (keyed by root-relative token prefix) ------
        nodes: dict[tuple, dict] = {(): {"token": int(last), "branches": set(paths)}}
        for b, path in paths.items():
            for i in range(len(path) - 1):
                # path[0] == last == root; node i+1 holds path[i + 1]
                key = tuple(path[1 : i + 2])
                nd = nodes.setdefault(key, {"token": path[i + 1], "branches": set()})
                nd["branches"].add(b)
        for b, path in paths.items():
            # each branch's FINAL prediction becomes a leaf node too
            key = tuple(path[1:]) + (next_tok[b],)
            nd = nodes.setdefault(key, {"token": int(next_tok[b]),
                                        "branches": set(), "leaf": True})
            nd["branches"].add(b)
        stats.n_drafted += len(nodes) - 1

        # -- target verifies the whole tree in one batch --------------------
        keys = sorted(nodes, key=len)
        toks = np.array([nodes[k]["token"] for k in keys], np.int32)
        pos = np.array([n_past + len(k) for k in keys], np.int32)
        seqs = np.array([min(nodes[k]["branches"]) for k in keys], np.int32)
        mask = np.array([sum(1 << b for b in nodes[k]["branches"]) for k in keys],
                        np.int32)
        rc = target.decode(Batch(toks, pos, seqs, np.ones(len(keys), bool), mask))
        stats.n_target_calls += 1
        if rc != 0:
            break
        t_choices = _top1(target)  # [n_nodes] device argmax
        row_of = {k: i for i, k in enumerate(keys)}

        cur: tuple = ()
        while True:
            t = int(t_choices[row_of[cur]])
            out.append(t)
            child = cur + (t,)
            if child in nodes and t != eos_id and len(out) < n_predict:
                stats.n_accepted += 1
                cur = child
            else:
                break
        best = min(nodes[cur]["branches"])
        n_past = n_past + len(cur) + 1
        last = out[-1]

        # -- keep the accepted branch, drop the rest (lookahead epilogue) ---
        for c in (target, draft):
            c.seq_rm(-1, n_past, -1)
            c.seq_keep(best)
            c.seq_cp(best, 0)
            c.seq_rm(best)
        if nodes[cur].get("leaf"):
            # an accepted leaf never entered the DRAFT cache (only paths
            # were draft-decoded): sync its row so the next round's draft
            # attends contiguously
            draft.decode(Batch(tokens=[nodes[cur]["token"]],
                               pos=[n_past - 1], seq_id=[0], output=[False]))
    return out[:n_predict], stats


# -- prompt-lookup (ngram) drafting ------------------------------------------


@dataclass
class NgramCache:
    """min..max-order n-gram continuation cache (cf. common/ngram-cache.h)."""

    n_min: int = 2
    n_max: int = 4
    table: dict[tuple, dict[int, int]] = field(default_factory=dict)

    def update(self, tokens: list[int]) -> None:
        for n in range(self.n_min, self.n_max + 1):
            for i in range(len(tokens) - n):
                key = tuple(tokens[i : i + n])
                nxt = tokens[i + n]
                self.table.setdefault(key, {}).setdefault(nxt, 0)
                self.table[key][nxt] += 1

    def update_tail(self, tokens: list[int], n_new: int) -> None:
        """Incremental update: count only the n-grams whose continuation
        token is one of the last `n_new` tokens (re-running update over a
        sliding window would re-count the overlap and bias future drafts)."""
        total = len(tokens)
        for n in range(self.n_min, self.n_max + 1):
            for i in range(max(0, total - n_new - n), total - n):
                key = tuple(tokens[i : i + n])
                nxt = tokens[i + n]
                self.table.setdefault(key, {}).setdefault(nxt, 0)
                self.table[key][nxt] += 1

    def draft(self, tokens: list[int], n_draft: int) -> list[int]:
        out: list[int] = []
        cur = list(tokens)
        for _ in range(n_draft):
            best = None
            for n in range(self.n_max, self.n_min - 1, -1):
                key = tuple(cur[-n:])
                cands = self.table.get(key)
                if cands:
                    best = max(cands.items(), key=lambda kv: kv[1])[0]
                    break
            if best is None:
                break
            out.append(best)
            cur.append(best)
        return out


def lookup_generate(
    target: LlamaContext,
    prompt_tokens,
    n_predict: int,
    n_draft: int = 4,
    eos_id: int = -1,
) -> tuple[list[int], SpecStats]:
    """Prompt-lookup decoding: n-gram drafts verified by the target.

    Output equals plain greedy decoding of the target.
    """
    prompt_tokens = np.asarray(prompt_tokens, np.int32)
    target.clear()
    rc = target.decode(Batch.single(prompt_tokens))
    if rc != 0:
        raise RuntimeError("prefill failed")
    cache = NgramCache()
    history = [int(t) for t in prompt_tokens]
    cache.update(history)
    stats = SpecStats()
    out: list[int] = []
    last = int(_top1(target)[0])
    stats.n_target_calls += 1
    out.append(last)
    history.append(last)
    n_past = len(prompt_tokens)

    while len(out) < n_predict and last != eos_id:
        proposals = cache.draft(history, n_draft)
        chain = [last] + proposals
        pos = np.arange(n_past, n_past + len(chain), dtype=np.int32)
        rc = target.decode(Batch(np.array(chain, np.int32), pos,
                                 np.zeros(len(chain), np.int32),
                                 np.ones(len(chain), bool)))
        stats.n_target_calls += 1
        if rc != 0:
            break
        t_choices = _top1(target)
        stats.n_drafted += len(proposals)
        n_accept = 0
        for i, p in enumerate(proposals):
            if int(t_choices[i]) == p and p != eos_id \
                    and len(out) + n_accept + 1 < n_predict:
                n_accept += 1
            else:
                break
        stats.n_accepted += n_accept
        correction = int(t_choices[n_accept])
        accepted = proposals[:n_accept]
        out.extend(accepted)
        out.append(correction)
        history.extend(accepted + [correction])
        cache.update_tail(history, n_accept + 1)
        n_past += n_accept + 1
        target.seq_rm(0, n_past, -1)
        last = correction
    return out[:n_predict], stats


# -- on-device speculative loop ----------------------------------------------


def speculative_generate_device(
    target: LlamaContext,
    draft: LlamaContext,
    prompt_tokens,
    n_predict: int,
    n_draft: int = 5,
    eos_id: int = -1,
) -> tuple[list[int], SpecStats]:
    """Greedy speculative decoding with draft, verify, acceptance and cache
    rollback on the device.

    Each round runs K one-row draft forwards and one K+1-row verify
    forward of the target, all on the device: acceptance is a cumulative
    product over the matches, the emitted tokens go into an output buffer
    by index writes whose out-of-range positions land in a spare cell, and
    rollback writes -1 into the rejected cells' positions.  A round reads
    back one flag (done) to the host; the output, the statistics and the
    cell metadata come back once, after the last round.  Same accept rules
    as speculative_generate: output identical to plain greedy decoding of
    the target.

    Per round the loop consumes K draft cells and K+1 target cells from
    grids allocated up front for n_predict rounds (the worst case: one
    token a round).  When either cache cannot seat them, the host-driven
    speculative_generate runs instead (JAX's rule).
    """
    from llama_kotlin_tpu_torch.models import llama as llama_model

    prompt_tokens = np.asarray(prompt_tokens, np.int32)
    for c in (target, draft):
        c.clear()
        if c.decode(Batch.single(prompt_tokens)) != 0:
            raise RuntimeError("prefill failed")
    stats = SpecStats()
    dev = target.device
    last0 = target.get_topk(1)[1][0, :1]
    n_past0 = len(prompt_tokens)
    K = n_draft
    R = n_predict  # worst-case rounds (>= 1 token per round)

    slots_t = target.meta.find_slots(R * (K + 1))
    slots_d = draft.meta.find_slots(R * K)
    if slots_t is None or slots_d is None:
        return speculative_generate(target, draft, prompt_tokens, n_predict,
                                    n_draft=n_draft, eos_id=eos_id)
    # commit with pos=-1 (invalid): the loop stamps the real positions
    target.meta.commit(slots_t, np.full(R * (K + 1), -1, np.int32),
                       np.zeros(R * (K + 1), np.int32))
    draft.meta.commit(slots_d, np.full(R * K, -1, np.int32), np.zeros(R * K, np.int32))
    nv_t = _n_vis(target, max(int(slots_t.max()), n_past0) + 1)
    nv_d = _n_vis(draft, max(int(slots_d.max()), n_past0) + 1)
    cpos_t, cseq_t = target.meta.device_view(nv_t, dev)
    cpos_d, cseq_d = draft.meta.device_view(nv_d, dev)
    st = torch.from_numpy(slots_t.reshape(R, K + 1).astype(np.int64)).to(dev)
    sd = torch.from_numpy(slots_d.reshape(R, K).astype(np.int64)).to(dev)

    i32 = dict(dtype=torch.int32, device=dev)
    zero1 = torch.zeros(1, **i32)
    ar_k = torch.arange(K, **i32)
    ar_k1 = torch.arange(K + 1, **i32)
    # one spare cell at n_predict takes the writes that fall outside
    out_buf = torch.full((n_predict + 1,), -1, **i32)
    out_buf[0] = last0[0]
    n_out = torch.ones((), **i32)
    last = torch.as_tensor(last0, **i32).reshape(1)
    base = torch.full((), n_past0, **i32)
    n_acc_total = torch.zeros((), **i32)
    rounds = 0
    # the verify batch is padded to the context's bucket, as decode() pads
    # it, so that both loops run the same row counts; padded rows write
    # the scratch cell and are never read
    nb = bucket_size(K + 1, target.buckets)
    pad = nb - (K + 1)
    pad_tok = torch.zeros(pad, **i32)
    pad_pos = torch.full((pad,), -1, **i32)
    seq_v = torch.cat([torch.zeros(K + 1, **i32),
                       torch.full((pad,), target.n_seq_max - 1, **i32)])
    pad_slot = torch.full((pad,), target.n_cells, dtype=torch.int64, device=dev)
    done = False  # as JAX's while_loop, at least one round runs
    while not done:
        # ---- draft chain: K one-row forwards -----------------------------
        tok, props = last, []
        for i in range(K):
            pos = (base + i).reshape(1)
            slot = sd[rounds, i:i + 1]
            cpos_d[slot] = pos
            cseq_d[slot] = 1
            logits, _ = llama_model.forward(draft.params, draft.cfg, tok, pos, zero1, slot,
                                            draft.cache, cpos_d, cseq_d, zero1)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            props.append(tok)
        proposals = torch.cat(props)

        # ---- target verifies [last] + proposals in one batch -------------
        chain = torch.cat([last, proposals])
        pos_v = base + ar_k1
        st_r = st[rounds]
        cpos_t[st_r] = pos_v
        cseq_t[st_r] = 1
        logits, _ = llama_model.forward(target.params, target.cfg,
                                        torch.cat([chain, pad_tok]),
                                        torch.cat([pos_v, pad_pos]), seq_v,
                                        torch.cat([st_r, pad_slot]), target.cache,
                                        cpos_t, cseq_t, ar_k1)
        t_choices = torch.argmax(logits, dim=-1).to(torch.int32)  # [K+1]

        # ---- acceptance (the host path's rules) ---------------------------
        ok = (t_choices[:K] == proposals) & (proposals != eos_id) \
            & (n_out + ar_k + 1 < n_predict)
        n_acc = torch.cumprod(ok.to(torch.int32), 0).sum().to(torch.int32)
        correction = t_choices[n_acc].reshape(1)

        # ---- emit proposals[:n_acc] + correction --------------------------
        emit_tok = torch.where(ar_k1 < n_acc, torch.cat([proposals, proposals[-1:]]),
                               correction)
        at = n_out + ar_k1
        write_at = torch.where((ar_k1 <= n_acc) & (at < n_predict), at,
                               torch.full_like(at, n_predict))
        out_buf[write_at.to(torch.int64)] = emit_tok

        # ---- roll back the rejected cells (metadata) ----------------------
        cpos_t[st_r] = torch.where(ar_k1 <= n_acc, pos_v, torch.full_like(pos_v, -1))
        cpos_d[sd[rounds]] = torch.where(ar_k <= n_acc, base + ar_k,
                                         torch.full_like(ar_k, -1))

        n_out = torch.clamp_max(n_out + n_acc + 1, n_predict)
        n_acc_total = n_acc_total + n_acc
        last = correction
        base = base + n_acc + 1
        rounds += 1
        done = bool(((correction[0] == eos_id) | (n_out >= n_predict)).item())

    # sync the host metadata from the loop's final device state
    target.meta.pos[:nv_t] = cpos_t.cpu().numpy()
    target.meta.seq[:nv_t] = cseq_t.cpu().numpy()
    draft.meta.pos[:nv_d] = cpos_d.cpu().numpy()
    draft.meta.seq[:nv_d] = cseq_d.cpu().numpy()
    stats.n_drafted = rounds * K
    stats.n_accepted = int(n_acc_total)
    stats.n_target_calls = rounds + 1
    toks = [int(t) for t in out_buf[: int(n_out)].cpu().numpy()]
    if eos_id >= 0 and eos_id in toks:
        toks = toks[: toks.index(eos_id) + 1]
    return toks, stats
