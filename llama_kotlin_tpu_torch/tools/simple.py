"""The port's copy of ``llama_kotlin_tpu/tools/simple.py``.

Minimal API demo (parity: reference examples/simple/simple.cpp): load a
GGUF, tokenize a prompt, greedy-decode N tokens with the lowest-level
decode/logits calls.

Usage:
    python -m llama_kotlin_tpu_torch.tools.simple model.gguf "Hello my name is" 32 \
        [--fast-mode w4|w4x|int8] [--device cuda|cpu]

(without --fast-mode the weights keep the exact-dequant repack, JAX's default)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="greedy generation with the lowest-level calls")
    ap.add_argument("model")
    ap.add_argument("prompt", nargs="?", default="Hello my name is")
    ap.add_argument("n_predict", nargs="?", type=int, default=32)
    ap.add_argument("--fast-mode", default=None, choices=["int8", "w4", "w4x"],
                    help="serving weight layout; default = the exact-dequant repack")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])

    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.runtime.batch import Batch
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.tokenizer import build_tokenizer

    cfg, params, f = load_gguf_model(args.model, fast_mode=args.fast_mode, device=args.device)
    tok = build_tokenizer(f.metadata)
    f.close()
    ids = list(tok.encode(args.prompt, add_special=True))
    ctx = LlamaContext(cfg, params, n_cells=max(256, len(ids) + args.n_predict + 8),
                       device=args.device)

    if ctx.decode(Batch.single(np.asarray(ids, np.int32))) != 0:
        print("decode failed (context too small?)", file=sys.stderr)
        return 1
    sys.stdout.write(args.prompt)
    n_past = len(ids)
    eos = tok.vocab.eos_id
    for _ in range(args.n_predict):
        tok_id = int(np.argmax(ctx.get_logits()[-1]))
        if tok_id == eos:
            break
        sys.stdout.write(tok.decode([tok_id], skip_special=False))
        sys.stdout.flush()
        if ctx.decode(Batch.single(np.array([tok_id], np.int32), pos0=n_past)) != 0:
            break
        n_past += 1
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
