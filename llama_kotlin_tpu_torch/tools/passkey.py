"""The port's copy of ``llama_kotlin_tpu/tools/passkey.py``.

Passkey retrieval test (parity: examples/passkey/passkey.cpp): hide a
number in a long junk context, process it with self-extend group attention
(seq_add/seq_div), and ask the model to recall it — exercises long-context
cache manipulation beyond the training window."""

from __future__ import annotations

import argparse
import sys

import numpy as np


JUNK = ("The grass is green. The sky is blue. The sun is yellow. "
        "Here we go. There and back again. ")
PREFIX = ("There is an important info hidden inside a lot of irrelevant "
          "text. Find it and memorize them. I will quiz you about the "
          "important information there. ")
SECRET = "The pass key is {key}. Remember it. {key} is the pass key. "
QUERY = " What is the pass key? The pass key is"


def build_prompt(n_junk: int, key: int, i_pos: int) -> str:
    parts = [PREFIX]
    for i in range(n_junk):
        if i == i_pos:
            parts.append(SECRET.format(key=key))
        parts.append(JUNK)
    return "".join(parts)


def run_passkey(ctx, tok, *, n_junk: int = 250, key: int = 42,
                i_pos: int | None = None, ga_n: int = 4, ga_w: int = 512,
                n_batch: int = 512, n_predict: int = 16,
                log=print) -> str:
    """Self-extended decode over the junk prompt, then greedy answer."""
    from llama_kotlin_tpu_torch.runtime.batch import Batch

    rng = np.random.default_rng(key)
    if i_pos is None:
        i_pos = int(rng.integers(0, n_junk))
    prompt = build_prompt(n_junk, key, i_pos) + QUERY
    ids = np.asarray(tok.encode(prompt), np.int32)
    log(f"prompt tokens: {len(ids)}, ga_n={ga_n}, ga_w={ga_w}")

    n_past = 0
    ga_i = 0
    for start in range(0, len(ids), n_batch):
        chunk = ids[start : start + n_batch]
        # self-extend: compress the cache by ga_n within ga_w windows
        # (cf. passkey.cpp / main.cpp:468-580)
        if ga_n > 1:
            while n_past >= ga_i + ga_w:
                ib = (ga_n * ga_i) // ga_w
                bd = (ga_w // ga_n) * (ga_n - 1)
                dd = (ga_w // ga_n) - ib * bd - ga_w
                ctx.seq_add(0, ga_i, n_past, ib * bd)
                ctx.seq_div(0, ga_i + ib * bd, ga_i + ib * bd + ga_w, ga_n)
                ctx.seq_add(0, ga_i + ib * bd + ga_w, n_past + ib * bd, dd)
                n_past = n_past + ib * bd + dd
                ga_i += ga_w // ga_n
        out = np.zeros(len(chunk), bool)
        out[-1] = True
        rc = ctx.decode(Batch(chunk, np.arange(n_past, n_past + len(chunk),
                                               dtype=np.int32),
                              np.zeros(len(chunk), np.int32), out))
        if rc != 0:
            raise RuntimeError("KV cache full — raise n_cells or ga_n")
        n_past += len(chunk)

    answer = []
    for _ in range(n_predict):
        tid = int(np.argmax(ctx.get_logits()[-1]))
        if tid == tok.vocab.eos_id:
            break
        answer.append(tid)
        rc = ctx.decode(Batch(np.array([tid], np.int32),
                              np.array([n_past], np.int32),
                              np.array([0], np.int32), np.array([1], np.int8)))
        assert rc == 0
        n_past += 1
    text = tok.decode(answer)
    log(f"expected: {key}  answer:{text}")
    return text


def main(argv=None):
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.tokenizer import build_tokenizer

    ap = argparse.ArgumentParser(description="passkey retrieval w/ self-extend")
    ap.add_argument("--model", "-m", required=True)
    ap.add_argument("--junk", type=int, default=250)
    ap.add_argument("--keep", type=int, default=42, help="the passkey")
    ap.add_argument("--pos", type=int, default=-1)
    ap.add_argument("--grp-attn-n", type=int, default=4)
    ap.add_argument("--grp-attn-w", type=int, default=512)
    ap.add_argument("--n-ctx", "-c", type=int, default=4096)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg, params, f = load_gguf_model(args.model, device=args.device)
    tok = build_tokenizer(f.metadata)
    f.close()
    ctx = LlamaContext(cfg, params, n_cells=args.n_ctx, device=args.device)
    run_passkey(ctx, tok, n_junk=args.junk, key=args.keep,
                i_pos=None if args.pos < 0 else args.pos,
                ga_n=args.grp_attn_n, ga_w=args.grp_attn_w,
                log=lambda *a: print(*a, file=sys.stderr))


if __name__ == "__main__":
    main()
