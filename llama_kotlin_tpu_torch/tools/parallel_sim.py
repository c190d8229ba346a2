"""The port's copy of ``llama_kotlin_tpu/tools/parallel_sim.py``.

Multi-client continuous-batching simulation (parity:
examples/parallel/parallel.cpp): N clients submit prompts against an
Engine with fewer slots; reports per-client latency and aggregate
throughput, exercising slot reuse and mixed prefill+decode batches."""

from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np


QUESTIONS = [
    "What is the meaning of life?",
    "Tell me an interesting fact about llamas.",
    "What is the best way to cook a steak?",
    "Are you familiar with the Special Theory of Relativity?",
    "Recommend some interesting books to read.",
    "What is the best way to learn a new language?",
    "How to get a job at Google?",
    "If you could have any superpower, what would it be?",
]


def run_parallel(engine, tokenizer, n_clients: int, n_seq: int,
                 n_predict: int = 32, log=print) -> dict:
    from llama_kotlin_tpu_torch.runtime.engine import Request
    from llama_kotlin_tpu_torch.sampling.samplers import SamplingParams

    results = []
    lock = threading.Lock()

    def client(cid: int):
        for s in range(n_seq):
            prompt = QUESTIONS[(cid + s) % len(QUESTIONS)]
            ids = np.asarray(tokenizer.encode(prompt), np.int32)
            t0 = time.time()
            req = Request(prompt_tokens=ids, params=SamplingParams(temp=0.0),
                          n_predict=n_predict)
            engine.submit(req)
            ok = req.done.wait(timeout=600)
            dt = time.time() - t0
            with lock:
                results.append({
                    "client": cid, "seq": s, "ok": ok, "latency_s": round(dt, 3),
                    "prompt_tokens": len(ids),
                    "gen_tokens": len(req.output_tokens) if ok else 0,
                })
    t0 = time.time()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0
    total_gen = sum(r["gen_tokens"] for r in results)
    summary = {
        "clients": n_clients, "sequences": len(results),
        "all_ok": all(r["ok"] for r in results),
        "total_gen_tokens": total_gen, "wall_s": round(wall, 2),
        "gen_tps": round(total_gen / wall, 2) if wall else 0.0,
    }
    log(f"parallel: {summary}")
    return summary


def main(argv=None):
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.runtime.engine import Engine
    from llama_kotlin_tpu_torch.tokenizer import build_tokenizer

    ap = argparse.ArgumentParser(description="multi-client batching simulation")
    ap.add_argument("--model", "-m", required=True)
    ap.add_argument("--n-clients", type=int, default=4)
    ap.add_argument("--n-sequences", type=int, default=2, help="per client")
    ap.add_argument("--n-predict", "-n", type=int, default=32)
    ap.add_argument("--n-slots", "-np", type=int, default=2, dest="n_slots")
    ap.add_argument("--n-ctx", "-c", type=int, default=2048)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg, params, f = load_gguf_model(args.model, device=args.device)
    tok = build_tokenizer(f.metadata)
    f.close()
    ctx = LlamaContext(cfg, params, n_cells=args.n_ctx, device=args.device, n_seq_max=max(32, args.n_slots))
    engine = Engine(ctx, tok, n_slots=args.n_slots)
    stop = threading.Event()
    t = threading.Thread(target=engine.run_loop, args=(stop,), daemon=True)
    t.start()
    try:
        run_parallel(engine, tok, args.n_clients, args.n_sequences,
                     args.n_predict, log=lambda *a: print(*a, file=sys.stderr))
    finally:
        stop.set()
        t.join(timeout=30)


if __name__ == "__main__":
    main()
