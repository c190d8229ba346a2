"""The port's copy of ``llama_kotlin_tpu/tools/main.py``.

Interactive CLI (parity target: examples/main/main.cpp): streaming
generation, interactive chat mode with reverse prompts, session
prompt-cache files, self-extend group attention, grammar constraints.  The
flags and their defaults are JAX's, plus ``--device`` (cuda unless the
caller asks for the CPU).

Usage:
    python -m llama_kotlin_tpu_torch.tools.main --model m.gguf -p "Hello" -n 64
    python -m llama_kotlin_tpu_torch.tools.main --model m.gguf --interactive
    python -m llama_kotlin_tpu_torch.tools.main --model m.gguf --device cpu -p "Hello" -n 8

(``--fast-mode w4|w4x|int8`` picks a fast layout; the default is the
exact-dequant repack, as in JAX.)

``main`` returns what it measured on the host clock: each generation's
prompt tokens, time to first token (prompt evaluation, the logits' copy
to the host and the first sample) and ms a later token, with its ids and
text, and the session reuse of a prompt-cache run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="llama_kotlin_tpu_torch text generation")
    ap.add_argument("--model", "-m", required=True)
    ap.add_argument("--prompt", "-p", default="")
    ap.add_argument("--file", "-f", help="read prompt from file")
    ap.add_argument("--n-predict", "-n", type=int, default=128)
    ap.add_argument("--n-ctx", "-c", type=int, default=4096)
    ap.add_argument("--temp", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--min-p", type=float, default=0.05)
    ap.add_argument("--repeat-penalty", type=float, default=1.0)
    ap.add_argument("--seed", "-s", type=int, default=-1)
    ap.add_argument("--grammar-file", help="GBNF grammar constraint")
    ap.add_argument("--json-schema", help="JSON schema constraint")
    ap.add_argument("--interactive", "-i", action="store_true")
    ap.add_argument("--reverse-prompt", "-r", action="append", default=[])
    ap.add_argument("--chat-template", default=None)
    ap.add_argument("--prompt-cache", help="session file for prompt caching")
    ap.add_argument("--grp-attn-n", type=int, default=1, help="self-extend factor")
    ap.add_argument("--grp-attn-w", type=int, default=512, help="self-extend width")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--cache-type-k", "-ctk", default="f16",
                    choices=["f16", "bf16", "q8_0", "q4_0"],
                    help="KV cache type (f16/bf16 = a bf16 cache, q8_0 = int8 K/V, "
                         "q4_0 = packed int4 K/V)")
    ap.add_argument("--fast-mode", default=None, choices=["int8", "w4", "w4x"],
                    help="serving weight layout: int8 = W8A8 flat, w4 = "
                         "4-bit-resident W4A8, w4x = W4 with exact f32 "
                         "scales + dual-plane activations (high fidelity); "
                         "default = exact dequant repack")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable the fused q|k|v / gate|up serving fold")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace of the generation "
                         "into this directory; also honours LKTPU_TRACE_DIR")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def env_trace_dir():
    """LKTPU_TRACE_DIR env toggle (empty/unset -> None)."""
    d = os.environ.get("LKTPU_TRACE_DIR", "").strip()
    return d or None


@contextlib.contextmanager
def maybe_trace(log_dir, device: str):
    """A torch.profiler Chrome trace of the block into log_dir (host
    events, and the card's kernels on a CUDA device); no-op without a
    directory."""
    if not log_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}.json"))


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.runtime import state as state_io
    from llama_kotlin_tpu_torch.runtime.batch import Batch
    from llama_kotlin_tpu_torch.runtime.chat import apply_chat_template, resolve_template
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.sampling.samplers import SamplerChain, SamplingParams
    from llama_kotlin_tpu_torch.tokenizer import build_tokenizer

    if not os.path.exists(args.model):
        print(f"error: model file not found: {args.model}", file=sys.stderr)
        sys.exit(1)
    print(f"loading {args.model} ...", file=sys.stderr)
    t_load = time.perf_counter()
    cfg, params, f = load_gguf_model(args.model, fast_mode=args.fast_mode,
                                     fuse=not args.no_fuse, device=args.device)
    tok = build_tokenizer(f.metadata)
    template = args.chat_template or resolve_template(
        f.metadata.get("tokenizer.chat_template"), cfg.arch)
    f.close()
    kv_quant = args.cache_type_k if args.cache_type_k in ("q8_0", "q4_0") else False
    ctx = LlamaContext(cfg, params, n_cells=args.n_ctx, kv_quant=kv_quant, device=args.device)
    ctx.timings.t_load_ms = (time.perf_counter() - t_load) * 1e3
    print(f"model: {cfg.name or cfg.arch} | layers={cfg.n_layer} "
          f"embd={cfg.n_embd} vocab={cfg.vocab_size}", file=sys.stderr)

    grammar = None
    if args.grammar_file:
        with open(args.grammar_file) as gf:
            grammar = gf.read()
    elif args.json_schema:
        from llama_kotlin_tpu_torch.sampling.json_schema import json_schema_to_gbnf

        grammar = json_schema_to_gbnf(args.json_schema)

    sp = SamplingParams(
        temp=args.temp, top_k=args.top_k, top_p=args.top_p, min_p=args.min_p,
        penalty_repeat=args.repeat_penalty,
        seed=args.seed if args.seed >= 0 else 0xFFFFFFFF,
        grammar=grammar,
    )
    sampler = SamplerChain(sp, cfg.vocab_size)

    prompt = args.prompt
    if args.file:
        with open(args.file, encoding="utf-8") as pf:
            prompt = pf.read()

    n_past = 0
    ga_i = 0  # self-extend bookkeeping (cf. main.cpp:468-580)
    runs: list[dict] = []
    stats: dict = {"runs": runs}

    def self_extend_maybe():
        nonlocal n_past, ga_i
        if args.grp_attn_n <= 1:
            return
        ga_n, ga_w = args.grp_attn_n, args.grp_attn_w
        while n_past >= ga_i + ga_w:
            ib = (ga_n * ga_i) // ga_w
            bd = (ga_w // ga_n) * (ga_n - 1)
            dd = (ga_w // ga_n) - ib * bd - ga_w
            ctx.seq_add(0, ga_i, n_past, ib * bd)
            ctx.seq_div(0, ga_i + ib * bd, ga_i + ib * bd + ga_w, ga_n)
            ctx.seq_add(0, ga_i + ib * bd + ga_w, n_past + ib * bd, dd)
            n_past = n_past + ib * bd + dd
            ga_i += ga_w // ga_n

    def feed(tokens: list[int], want_logits: bool) -> None:
        nonlocal n_past
        if not tokens:
            return
        arr = np.asarray(tokens, np.int32)
        out = np.zeros(len(arr), bool)
        if want_logits:
            out[-1] = True
        rc = ctx.decode(Batch(arr, np.arange(n_past, n_past + len(arr), dtype=np.int32),
                              np.zeros(len(arr), np.int32), out))
        if rc != 0:
            # context shift: drop oldest half (cf. main.cpp context shift)
            n_discard = n_past // 2
            ctx.seq_rm(0, 0, n_discard)
            ctx.seq_add(0, n_discard, -1, -n_discard)
            n_past -= n_discard
            return feed(tokens, want_logits)
        n_past += len(arr)
        self_extend_maybe()

    def generate(n: int, t0: float, n_prompt: int) -> str:
        text = ""
        ids: list[int] = []
        t_first = None
        for _ in range(n):
            logits = ctx.get_logits()[-1]
            tok_id = sampler.sample(logits, tokenizer=tok)
            sampler.accept(tok_id, tokenizer=tok)
            ids.append(tok_id)
            if t_first is None:
                t_first = time.perf_counter()
            if tok_id == tok.vocab.eos_id:
                break
            piece = tok.decode([tok_id], skip_special=False)
            text += piece
            sys.stdout.write(piece)
            sys.stdout.flush()
            stop = False
            for rp in args.reverse_prompt:
                if text.endswith(rp):
                    stop = True
            if stop:
                break
            feed([tok_id], want_logits=True)
        t_end = time.perf_counter()
        runs.append({
            "prompt_tokens": n_prompt, "tokens": ids, "text": text,
            "ttft_ms": None if t_first is None else (t_first - t0) * 1e3,
            "ms_per_token": (t_end - t_first) * 1e3 / (len(ids) - 1) if len(ids) > 1 else None})
        return text

    if args.interactive:
        print("== interactive mode; /exit to quit ==", file=sys.stderr)
        messages = []
        while True:
            try:
                user = input("\n> ")
            except EOFError:
                break
            if user.strip() in ("/exit", "/quit"):
                break
            messages.append({"role": "user", "content": user})
            text = apply_chat_template(messages, template)
            ids = tok.encode(text, add_special=True, parse_special=True)
            t0 = time.perf_counter()
            ctx.clear()
            sampler.reset()
            n_past = 0
            feed(list(ids), want_logits=True)
            reply = generate(args.n_predict, t0, len(ids))
            messages.append({"role": "assistant", "content": reply})
            print()
    else:
        ids = tok.encode(prompt, add_special=True, parse_special=True)
        t0 = time.perf_counter()
        if args.prompt_cache and os.path.exists(args.prompt_cache):
            cached = state_io.load_session_file(ctx, args.prompt_cache)
            common = 0
            while common < min(len(cached), len(ids)) and cached[common] == ids[common]:
                common += 1
            if common == len(ids):
                # full match: roll back one token so re-feeding it yields
                # logits without duplicating it in the cache (main.cpp does
                # the same n_past-- trick)
                common -= 1
            ctx.seq_rm(0, common, -1)
            n_past = common
            stats["session_reuse"] = common
            print(f"(session reuse: {common}/{len(ids)} tokens)", file=sys.stderr)
            feed(list(ids[common:]) or [ids[-1]], want_logits=True)
        else:
            feed(list(ids), want_logits=True)
        if args.prompt_cache:
            state_io.save_session_file(ctx, args.prompt_cache, ids)
        sys.stdout.write(prompt)
        with maybe_trace(args.profile_dir or env_trace_dir(), args.device):
            generate(args.n_predict, t0, len(ids))
        print()
        print(json.dumps(ctx.timings.summary()) if args.verbose else "", file=sys.stderr)
    return stats


if __name__ == "__main__":
    main()
