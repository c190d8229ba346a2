"""The port's copy of ``llama_kotlin_tpu/tools/infill.py``.

Fill-in-the-middle infill (parity: examples/infill/infill.cpp):
build the FIM prompt <PRE>prefix<SUF>suffix<MID> from the model's special
token ids (tokenizer.ggml.{prefix,suffix,middle,eot}_token_id) and
generate until EOT/EOS."""

from __future__ import annotations

import argparse
import sys

import numpy as np


def infill_tokens(tok, prefix: str, suffix: str, spm_fill: bool = False) -> list[int]:
    """FIM token sequence (cf. infill.cpp prompt assembly).  spm_fill
    flips to suffix-prefix-middle ordering (codellama SPM mode)."""
    v = tok.vocab
    if v.prefix_id < 0 or v.suffix_id < 0 or v.middle_id < 0:
        raise ValueError("model has no infill special tokens")
    pre = [v.prefix_id] + list(tok.encode(prefix, add_special=False))
    suf = [v.suffix_id] + list(tok.encode(suffix, add_special=False))
    parts = suf + pre if spm_fill else pre + suf
    ids = ([v.bos_id] if v.add_bos and v.bos_id >= 0 else []) + parts + [v.middle_id]
    return ids


def run_infill(ctx, tok, prefix: str, suffix: str, n_predict: int,
               sampler=None, spm_fill: bool = False) -> str:
    from llama_kotlin_tpu_torch.runtime.batch import Batch
    from llama_kotlin_tpu_torch.sampling.samplers import SamplerChain, SamplingParams

    ids = infill_tokens(tok, prefix, suffix, spm_fill)
    sampler = sampler or SamplerChain(SamplingParams(temp=0.0), ctx.cfg.vocab_size)
    rc = ctx.decode(Batch.single(np.asarray(ids, np.int32)))
    assert rc == 0
    v = tok.vocab
    stops = {v.eos_id, v.eot_id, v.middle_id}
    out: list[int] = []
    n_past = len(ids)
    for _ in range(n_predict):
        tid = sampler.sample(ctx.get_logits()[-1], tokenizer=tok)
        sampler.accept(tid, tokenizer=tok)
        if tid in stops:
            break
        out.append(tid)
        rc = ctx.decode(Batch(np.array([tid], np.int32),
                              np.array([n_past], np.int32),
                              np.array([0], np.int32),
                              np.array([1], np.int8)))
        assert rc == 0
        n_past += 1
    return tok.decode(out)


def main(argv=None):
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.sampling.samplers import SamplerChain, SamplingParams
    from llama_kotlin_tpu_torch.tokenizer import build_tokenizer

    ap = argparse.ArgumentParser(description="fill-in-the-middle completion")
    ap.add_argument("--model", "-m", required=True)
    ap.add_argument("--in-prefix", required=True)
    ap.add_argument("--in-suffix", required=True)
    ap.add_argument("--n-predict", "-n", type=int, default=64)
    ap.add_argument("--n-ctx", "-c", type=int, default=4096)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--temp", type=float, default=0.0)
    ap.add_argument("--spm-infill", action="store_true",
                    help="suffix-prefix-middle ordering")
    args = ap.parse_args(argv)

    cfg, params, f = load_gguf_model(args.model, device=args.device)
    tok = build_tokenizer(f.metadata)
    f.close()
    ctx = LlamaContext(cfg, params, n_cells=args.n_ctx, device=args.device)
    sampler = SamplerChain(SamplingParams(temp=args.temp), cfg.vocab_size)
    text = run_infill(ctx, tok, args.in_prefix, args.in_suffix,
                      args.n_predict, sampler, args.spm_infill)
    sys.stdout.write(args.in_prefix + text + args.in_suffix + "\n")


if __name__ == "__main__":
    main()
