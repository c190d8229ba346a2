"""The port's copy of ``llama_kotlin_tpu/tools/batched_bench.py``.

Batched throughput benchmark (parity: examples/batched-bench): for each
(n_pp, n_tg, n_pl) combo, time prompt processing of pp tokens (shared
across sequences) and pl-way parallel decode of tg steps, reporting
speeds like the reference's PP/TG/T table.  Times are host-clock times
that end with a copy of the results to the host, so they include the
device's work.

Usage:
    python -m llama_kotlin_tpu_torch.tools.batched_bench -m model.gguf -npl 1 2 4
    python -m llama_kotlin_tpu_torch.tools.batched_bench --synthetic llama3-8b --warm
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# JAX's --mode names for synthetic weights -> synthetic_params_device's modes
# (Q4_K draws: the W4 fold, the precise W4X fold, Q8F, exact Q4_K repacks)
SYNTHETIC_MODES = {"w4a8": "w4", "exact": "w4x", "int8": "int8", "dequant": "dequant"}


def bench_combo(ctx, n_pp: int, n_tg: int, n_pl: int,
                shared_prompt: bool = True) -> dict:
    import torch

    from llama_kotlin_tpu_torch.runtime.batch import Batch
    from llama_kotlin_tpu_torch.runtime.generate import SampleParams, generate_loop

    rng = np.random.default_rng(0)
    ctx.clear()
    prompt = rng.integers(0, ctx.cfg.vocab_size, n_pp).astype(np.int32)
    dev = ctx.device

    t0 = time.time()
    rc = ctx.decode(Batch.single(prompt))
    assert rc == 0, "cache full during prefill"
    tok = int(np.argmax(ctx.get_logits()[-1]))
    t_pp = time.time() - t0
    if shared_prompt:
        for s in range(1, n_pl):
            ctx.seq_cp(0, s)

    slots = ctx.meta.find_slots(n_tg * n_pl)
    assert slots is not None, "cache full for decode"
    pos = np.repeat(np.arange(n_pp, n_pp + n_tg, dtype=np.int32), n_pl)
    seqs = np.tile(np.arange(n_pl, dtype=np.int32), n_tg)
    ctx.meta.commit(slots, pos, seqs)
    # visibility: the slots are pre-allocated, so the final span is known:
    # attend over it rounded up to 256 cells instead of all n_cells
    span = int(slots.max()) + 1
    n_vis = span + (-span) % 256
    i32 = dict(dtype=torch.int32, device=dev)
    t0 = time.time()
    out, _ = generate_loop(
        ctx.params, ctx.cfg, ctx.cache,
        *ctx.meta.device_view(min(n_vis, ctx.n_cells), dev),
        torch.full((n_pl,), tok, **i32), torch.full((n_pl,), n_pp, **i32),
        torch.arange(n_pl, **i32), torch.from_numpy(slots.reshape(n_tg, n_pl)).to(dev),
        n_tg, SampleParams())
    out.cpu()
    t_tg = time.time() - t0

    return {
        "pp": n_pp, "tg": n_tg, "pl": n_pl,
        "t_pp_s": round(t_pp, 3),
        "s_pp": round(n_pp / t_pp, 2) if t_pp else 0.0,
        "t_tg_s": round(t_tg, 3),
        "s_tg": round(n_tg * n_pl / t_tg, 2) if t_tg else 0.0,
    }


def main(argv=None):
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext

    ap = argparse.ArgumentParser(description="batched pp/tg benchmark")
    ap.add_argument("--model", "-m",
                    help="GGUF path (or use --synthetic PRESET)")
    ap.add_argument("--synthetic",
                    help="synthetic preset (e.g. llama3-8b) with random W4 weights "
                         "drawn on the device, no model file needed")
    ap.add_argument("--mode", default="w4a8", choices=sorted(SYNTHETIC_MODES),
                    help="serving mode for --synthetic weights (w4a8: the W4 fold; "
                         "exact: the precise W4X fold; int8: Q8F; dequant: exact "
                         "Q4_K repacks)")
    ap.add_argument("-npp", type=int, nargs="+", default=[128, 256])
    ap.add_argument("-ntg", type=int, nargs="+", default=[32])
    ap.add_argument("-npl", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--n-ctx", "-c", type=int, default=4096)
    ap.add_argument("--warm", action="store_true",
                    help="run each combo twice and report the warm pass")
    ap.add_argument("-o", "--output", default="md", choices=["md", "json"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.synthetic:
        from llama_kotlin_tpu_torch.models.synthetic import (preset_config,
                                                             synthetic_params_device)

        cfg = preset_config(args.synthetic)
        params = synthetic_params_device(cfg, device=args.device,
                                         mode=SYNTHETIC_MODES[args.mode])
    else:
        if not args.model:
            ap.error("one of --model / --synthetic is required")
        cfg, params, f = load_gguf_model(args.model, device=args.device)
        f.close()
    ctx = LlamaContext(cfg, params, n_cells=args.n_ctx,
                       n_seq_max=max(32, max(args.npl)), device=args.device)
    rows = []
    for pp in args.npp:
        for tg in args.ntg:
            for pl in args.npl:
                if args.warm:
                    bench_combo(ctx, pp, tg, pl)  # warm-up pass
                rows.append(bench_combo(ctx, pp, tg, pl))
                print(f"done pp={pp} tg={tg} pl={pl}", file=sys.stderr)
    if args.output == "json":
        print(json.dumps(rows))
    else:
        print("| pp | tg | pl | t_pp(s) | pp t/s | t_tg(s) | tg t/s |")
        print("|----|----|----|---------|--------|---------|--------|")
        for r in rows:
            print(f"| {r['pp']} | {r['tg']} | {r['pl']} | {r['t_pp_s']} "
                  f"| {r['s_pp']} | {r['t_tg_s']} | {r['s_tg']} |")
    return rows


if __name__ == "__main__":
    main()
