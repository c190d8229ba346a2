"""The port's copy of ``llama_kotlin_tpu/tools/lookahead.py``.

Lookahead decoding CLI (parity: examples/lookahead)."""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.runtime.lookahead import lookahead_generate
    from llama_kotlin_tpu_torch.tokenizer import build_tokenizer

    ap = argparse.ArgumentParser(description="lookahead (Jacobi) decoding")
    ap.add_argument("--model", "-m", required=True)
    ap.add_argument("--prompt", "-p", default="")
    ap.add_argument("--n-predict", "-n", type=int, default=64)
    ap.add_argument("--n-ctx", "-c", type=int, default=4096)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("-W", type=int, default=15, help="lookahead window")
    ap.add_argument("-N", type=int, default=5, help="n-gram size")
    ap.add_argument("-G", type=int, default=15, help="max verification n-grams")
    args = ap.parse_args(argv)

    cfg, params, f = load_gguf_model(args.model, device=args.device)
    tok = build_tokenizer(f.metadata)
    f.close()
    ctx = LlamaContext(cfg, params, n_cells=args.n_ctx, device=args.device,
                       n_seq_max=args.W + args.G + 1)
    ids = np.asarray(tok.encode(args.prompt), np.int32)
    t0 = time.time()
    out, stats = lookahead_generate(ctx, ids, args.n_predict,
                                    W=args.W, N=args.N, G=args.G,
                                    eos_id=tok.vocab.eos_id)
    dt = time.time() - t0
    sys.stdout.write(args.prompt + tok.decode(out) + "\n")
    print(f"n_predict={stats['n_predict']} n_accept={stats['n_accept']} "
          f"decodes={stats['n_decodes']} ({stats['n_predict'] / dt:.2f} t/s)",
          file=sys.stderr)


if __name__ == "__main__":
    main()
