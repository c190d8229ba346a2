#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (llama_kotlin_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device  — the card's name and power limit;
  2. build   — compile csrc/*.cu for sm_90a and load the library;
  3. kernels — every kernel of the serving path at the llama3-8B shapes it
               gets there, held against its plain PyTorch version on the
               same inputs, timed with CUDA events (median of 20, L2
               flushed before each call), beside its bound on this card and
               one PyTorch library call where one computes the same
               function;
  4. serving — the full llama3-8B W4A8 model (32 layers, random weights
               from a seed) serves 3 requests through LlamaContext: prefill
               64 tokens, then 32 greedy tokens; every kernel's launch count
               must rise during this phase;
  5. parity  — full width, 2 layers: the port on the card against the port
               on the CPU (plain versions), prefill plus 4 greedy steps.

The last line of standard output is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

# the card's data-sheet peaks (H100 SXM, dense): bytes/s and ops/s
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12}
REPS = 20
FLUSH_BYTES = 256 << 20  # > the 50 MB L2: decode streams cold weights
SPIN_CYCLES = 10_000_000  # ~5 ms of device spin ahead of each timed call


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float, kind: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, flush) -> float:
    """Median device time of fn over REPS calls, each after an L2 flush.
    The flush reads a buffer larger than L2: a read leaves clean lines, where
    a write (zero_) would leave dirty ones for the timed call to write back.
    A spin kernel queued ahead of each call keeps the card busy while the
    host enqueues it, so the events bracket the call's kernels back to back
    (device time, without the wrapper's host overhead)."""
    fn()
    fn()
    pairs = []
    for _ in range(REPS):
        flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def w4_bytes(w, streamed: bool = True) -> int:
    """Bytes of a W4 fold that a kernel reads: the decode kernels stream
    codes + compact planes; the prefill kernel codes + g_scale/g_min."""
    names = ("codes", "aux.q6", "aux.dd") if streamed else ("codes", "g_scale", "g_min")
    ts = w.tensors()
    return sum(ts[n].numel() * ts[n].element_size() for n in names if n in ts)


def kernel_phase(torch, results: dict) -> None:
    import numpy as np

    from llama_kotlin_tpu_torch.models.synthetic import synthetic_w4, synthetic_w4_device
    from llama_kotlin_tpu_torch.ops.cuda import flash, qmm, qmm_w4, qmm_w4_ffn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    E, F, V, H, KV, D = 4096, 14336, 128256, 32, 8, 128
    # independent scale and min planes: a kernel that read one for the
    # other would still pass on zero-mean weights
    w = {name: synthetic_w4_device(gen, n, k, zero_mean=False, device=dev)
         for name, (n, k) in {
        "qkv": (6144, E), "o": (E, E), "lm_head": (V, E),
        "gate_up": (2 * F, E), "down": (E, F)}.items()}

    def report(kernel, shape, err, tol, ms, plain_ms, nbytes, ops, kind, library_ms):
        bms, by = bound(nbytes, ops, kind)
        row = {"kernel": kernel, "shape": shape, "max_abs_err": err["abs"],
               "max_rel_err": err["rel"], "tol_rel": tol, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bms, "bound_by": by, "library_ms": library_ms}
        log(json.dumps(row))
        if not err["rel"] <= tol:
            raise AssertionError(f"{kernel} {shape}: rel err {err['rel']} > {tol}")
        results.setdefault(kernel, []).append(row)

    def check(kernel, shape, got, ref, tol):
        """An untimed comparison: the instantiations the serving run may not
        reach (fold flavors, batch-row buckets, activations)."""
        err = err_of(got, ref)
        row = {"kernel": kernel, "shape": shape, "max_abs_err": err["abs"],
               "max_rel_err": err["rel"], "tol_rel": tol, "timed": False}
        log(json.dumps(row))
        if not err["rel"] <= tol:
            raise AssertionError(f"{kernel} {shape}: rel err {err['rel']} > {tol}")
        results.setdefault(kernel, []).append(row)

    def err_of(got, ref):
        got, ref = got.float(), ref.float()
        a = (got - ref).abs().max().item()
        return {"abs": a, "rel": a / max(ref.abs().max().item(), 1e-30)}

    # kernel 1: W4A8 decode matmul — qkv, o, lm_head at b = 1 and 32.
    # tol: both sides take exact integer partials; f32 order of the scale
    # products and the 128-group sum differs
    for name in ("qkv", "o", "lm_head"):
        wt = w[name]
        n, k = wt.shape
        for b in (1, 32):
            x = torch.randn((b, k), generator=gen, device=dev) * 0.7
            got = qmm_w4.qmm_w4_matmul(x, wt)
            ref = qmm_w4.qmm_w4_plain(x, wt)
            k8, ksx, ksum = qmm_w4.quantize_q8_cuda(x)
            p8, psx, psum = qmm_w4.quantize_q8(x)
            if not (torch.equal(k8, p8) and torch.equal(ksx, psx) and torch.equal(ksum, psum)):
                raise AssertionError("activation codes differ from the plain quantizer")
            report("qmm_w4", f"{name} n={n} k={k} b={b}", err_of(got, ref), 1e-4,
                   time_ms(torch, lambda: qmm_w4.qmm_w4_matmul(x, wt), flush),
                   time_ms(torch, lambda: qmm_w4.qmm_w4_plain(x, wt), flush),
                   b * k * 4 + w4_bytes(wt) + b * n * 4, 2 * b * n * k, "int8", None)

    # kernel 1, every flavor (legacy and sym read g_scale/g_min and undo the
    # hi nibble's bias) at every batch-row bucket (b = 3, 5, 9, 17 run the
    # NB = 4, 8, 16, 32 instantiations with rows masked off)
    rng = np.random.default_rng(4321)
    folds = {"compact": w["o"], "legacy": synthetic_w4(rng, E, E, compact=False, device=dev),
             "sym": synthetic_w4(rng, E, E, sym=True, device=dev)}
    for flavor, wt in folds.items():
        for b in (1, 2, 3, 5, 9, 17, 32):
            x = torch.randn((b, E), generator=gen, device=dev) * 0.7
            check("qmm_w4", f"{flavor} o b={b}", qmm_w4.qmm_w4_matmul(x, wt),
                  qmm_w4.qmm_w4_plain(x, wt), 1e-4)

    # kernel 2: the fused FFN at b = 1.  tol: h is rounded to bf16 and
    # re-quantized, so an f32 last-bit difference can move one h code
    x = torch.randn((1, E), generator=gen, device=dev) * 0.7
    got = qmm_w4_ffn.qmm_w4_ffn_matmul(x, w["gate_up"], w["down"])
    ref = qmm_w4_ffn.qmm_w4_ffn_plain(x, w["gate_up"], w["down"], "silu")
    report("qmm_w4_ffn", f"E={E} F={F} b=1", err_of(got, ref), 5e-3,
           time_ms(torch, lambda: qmm_w4_ffn.qmm_w4_ffn_matmul(x, w["gate_up"], w["down"]),
                   flush),
           time_ms(torch, lambda: qmm_w4_ffn.qmm_w4_ffn_plain(x, w["gate_up"], w["down"],
                                                            "silu"), flush),
           E * 4 + w4_bytes(w["gate_up"]) + w4_bytes(w["down"]) + E * 4,
           2 * (2 * F * E + E * F), "int8", None)

    # kernel 2 at the other batch-row buckets, with gelu, and on legacy and
    # sym folds (the non-compact branch)
    ffn = {"compact": (w["gate_up"], w["down"])}
    for flavor, kw in (("legacy", dict(compact=False)), ("sym", dict(sym=True))):
        ffn[flavor] = (synthetic_w4(rng, 2 * F, E, device=dev, **kw),
                       synthetic_w4(rng, E, F, device=dev, **kw))
    cases = [("compact", "silu", b) for b in (2, 3, 5, 9, 17, 32)]
    cases += [("compact", "gelu", 1), ("compact", "gelu", 3), ("legacy", "silu", 1),
              ("legacy", "gelu", 3), ("sym", "silu", 2), ("sym", "gelu", 1)]
    for flavor, act, b in cases:
        gu, dn = ffn[flavor]
        x = torch.randn((b, E), generator=gen, device=dev) * 0.7
        check("qmm_w4_ffn", f"{flavor} {act} b={b}",
              qmm_w4_ffn.qmm_w4_ffn_matmul(x, gu, dn, act=act),
              qmm_w4_ffn.qmm_w4_ffn_plain(x, gu, dn, act), 5e-3)
    del ffn, folds

    # kernel 3: flash attention, decode (nt=1 over 1024 cells, 65 live) and
    # prefill (nt=64 over 512 cells, causal) on a 2-layer cache of 1025 cells.
    # tol: bf16 outputs, f32 online-softmax reassociation (~2 bf16 ulps)
    cells = 1025
    kc = torch.randn((2, KV, cells, D), generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn((2, KV, cells, D), generator=gen, device=dev).to(torch.bfloat16)
    for nt, n_vis, live in ((1, 1024, 65), (64, 512, 64)):
        q = torch.randn((nt, H, D), generator=gen, device=dev).to(torch.bfloat16)
        cpos = torch.arange(n_vis, device=dev)
        tpos = torch.arange(live - nt, live, device=dev)
        mask = ((cpos[None, :] <= tpos[:, None]) & (cpos[None, :] < live)).to(torch.int8)
        scale = D ** -0.5
        got = flash.flash_attention(q, kc, vc, mask, scale=scale, layer=1)
        ref = flash.flash_attention_plain(q, kc, vc, mask, scale=scale, layer=1)
        qs = q.transpose(0, 1)[None]
        ks, vs = kc[1, :, :n_vis][None], vc[1, :, :n_vis][None]
        bmask = mask.bool()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        try:  # enable_gqa needs torch >= 2.5; else expand the kv heads once
            sdpa(qs, ks, vs, attn_mask=bmask, scale=scale, enable_gqa=True)
            lib = lambda: sdpa(qs, ks, vs, attn_mask=bmask, scale=scale, enable_gqa=True)
        except TypeError:
            ke, ve = (t.repeat_interleave(H // KV, dim=1) for t in (ks, vs))
            lib = lambda: sdpa(qs, ke, ve, attn_mask=bmask, scale=scale)
        vis_cells = int(mask.any(dim=0).sum().item())
        n_pairs = int(mask.sum().item()) * H
        report("flash", f"nt={nt} n_vis={n_vis} live={live}", err_of(got, ref), 1e-2,
               time_ms(torch, lambda: flash.flash_attention(q, kc, vc, mask, scale=scale,
                                                            layer=1), flush),
               time_ms(torch, lambda: flash.flash_attention_plain(q, kc, vc, mask,
                                                                  scale=scale, layer=1),
                       flush),
               2 * nt * H * D * 2 + 2 * KV * vis_cells * D * 2 + nt * n_vis,
               4 * D * n_pairs, "bf16", time_ms(torch, lib, flush))

    # kernel 4: prefill dequant matmul at 64 rows — qkv, gate|up, down.
    # tol: identical bf16 operands, f32 accumulation order only
    for name in ("qkv", "gate_up", "down"):
        wt = w[name]
        n, k = wt.shape
        xb = (torch.randn((64, k), generator=gen, device=dev) * 0.7).to(torch.bfloat16)
        got = qmm.qmm(xb, wt)
        ref = qmm.qmm_plain(xb, wt)
        wb = qmm.dequantize_bf16(wt)
        report("qmm", f"{name} n={n} k={k} m=64", err_of(got, ref), 1e-3,
               time_ms(torch, lambda: qmm.qmm(xb, wt), flush),
               time_ms(torch, lambda: qmm.qmm_plain(xb, wt), flush),
               64 * k * 2 + w4_bytes(wt, streamed=False) + 64 * n * 4, 2 * 64 * n * k,
               "bf16", time_ms(torch, lambda: torch.matmul(xb, wb.T), flush))
        del wb
    del w, flush
    torch.cuda.empty_cache()


def serving_phase(torch, n_layer: int = 32) -> dict:
    """3 requests on the full llama3-8B W4A8 model; returns launch counts."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.synthetic import preset_config, synthetic_params_device
    from llama_kotlin_tpu_torch.ops.cuda import flash, qmm, qmm_w4, qmm_w4_ffn
    from llama_kotlin_tpu_torch.runtime.batch import Batch
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.runtime.generate import generate_loop

    cfg = preset_config("llama3-8b", n_layer=n_layer)
    t0 = time.perf_counter()
    params = synthetic_params_device(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    w_bytes = sum(w4_bytes(v) for k, v in params.items() if k in ("output",))
    w_bytes += sum(w4_bytes(v) for lp in params["layers"] for v in lp.values()
                   if hasattr(v, "codes"))
    log(json.dumps({"phase": "serving", "model": "llama3-8b", "n_layer": n_layer,
                    "weights_build_s": build_s, "w_bytes_per_tok": w_bytes,
                    "w_floor_ms_per_tok": w_bytes / HBM_BYTES_S * 1e3}))
    ctx = LlamaContext(cfg, params, n_cells=1024, buckets=(8, 16, 32, 64, 128, 256, 512),
                       device="cuda")
    n_prompt, n_new = 64, 32
    mods = (qmm_w4, qmm_w4_ffn, flash, qmm)
    for m in mods:
        m.LAUNCHES = 0
    outs = []
    for r in range(3):
        # request 2 replays request 0's prompt: greedy tokens must repeat
        seed = 0 if r == 2 else r
        prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, n_prompt).astype(np.int32)
        ctx.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        assert ctx.decode(Batch.single(prompt)) == 0
        logits = ctx.logits_device()
        first = torch.argmax(logits[:1], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        ttft_ms = (time.perf_counter() - t0) * 1e3
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite prefill logits")
        # decode as the JAX bench does: slots reserved, every cell visible
        slots = ctx.meta.find_slots(n_new - 1)
        pos = np.arange(n_prompt, n_prompt + n_new - 1, dtype=np.int32)
        ctx.meta.commit(slots, pos, np.zeros(n_new - 1, np.int32))
        cell_pos, cell_seq = ctx.meta.device_view(ctx.n_cells, "cuda")
        t1 = time.perf_counter()
        out, last = generate_loop(
            ctx.params, cfg, ctx.cache, cell_pos, cell_seq, first,
            torch.tensor([n_prompt], dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"),
            torch.from_numpy(slots.reshape(-1, 1)).to("cuda"), n_new - 1)
        toks = [int(first[0])] + [int(t) for t in out[:, 0].cpu().numpy()]
        dt = time.perf_counter() - t1
        if not bool(torch.isfinite(last).all()) or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError("bad decode output")
        outs.append(toks)
        log(json.dumps({"request": r, "prompt_tokens": n_prompt, "ttft_ms": ttft_ms,
                        "decode_tokens": n_new - 1, "decode_tok_s": (n_new - 1) / dt,
                        "decode_ms_per_tok": dt / (n_new - 1) * 1e3, "tokens": toks}))
    if outs[2] != outs[0]:
        raise AssertionError("greedy tokens differ between identical requests")
    if outs[1] == outs[0]:
        raise AssertionError("two different prompts gave the same greedy tokens: "
                             "the token checks would carry no signal")
    counts = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in mods}
    log(json.dumps({"phase": "serving", "launches": counts}))
    if not all(counts.values()):
        raise AssertionError(f"a kernel of the path was never launched: {counts}")
    profile_decode(torch, ctx, cfg)
    del ctx, params
    torch.cuda.empty_cache()
    return counts


def profile_decode(torch, ctx, cfg, n_steps: int = 8) -> None:
    """Where a decode step's time goes: a torch.profiler trace of n_steps
    greedy steps after a 64-token prefill.  Device busy time is the sum of
    the kernels' device times (one stream, so they do not overlap); the
    idle share is the rest of the wall time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from llama_kotlin_tpu_torch.runtime.batch import Batch
    from llama_kotlin_tpu_torch.runtime.generate import generate_loop

    ctx.clear()
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, 64).astype(np.int32)
    assert ctx.decode(Batch.single(prompt)) == 0
    first = torch.argmax(ctx.logits_device()[:1], dim=-1).to(torch.int32)
    slots = ctx.meta.find_slots(n_steps)
    ctx.meta.commit(slots, np.arange(64, 64 + n_steps, dtype=np.int32),
                    np.zeros(n_steps, np.int32))
    cell_pos, cell_seq = ctx.meta.device_view(ctx.n_cells, "cuda")
    args = (torch.tensor([64], dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"),
            torch.from_numpy(slots.reshape(-1, 1)).to("cuda"), n_steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate_loop(ctx.params, cfg, ctx.cache, cell_pos, cell_seq, first, *args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []  # device-side events only (operator rows repeat their kernels)
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    log(json.dumps({
        "phase": "profile", "decode_steps": n_steps,
        "wall_ms_per_step": wall_ms / n_steps,
        "device_busy_ms_per_step": busy / n_steps if rows else "not measured",
        "device_idle_share": 1.0 - busy / wall_ms if rows else "not measured",
        "device_launches_per_step": sum(r[1] for r in rows) / n_steps,
        "top": [{"kernel": k[:60], "ms_per_step": t / n_steps, "calls_per_step": c / n_steps}
                for t, c, k in rows[:10]]}))


def parity_phase(torch) -> None:
    """Full width, 2 layers: card vs CPU, prefill + 4 greedy steps.  The CPU
    also runs with one thread: its other reduction order gives the spread
    of two correct runs, the yardstick for the card's error."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.synthetic import (params_to, preset_config,
                                                         synthetic_params_device)
    from llama_kotlin_tpu_torch.runtime.batch import Batch
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext

    cfg = preset_config("llama3-8b", n_layer=2)
    params = synthetic_params_device(cfg, seed=1, device="cuda")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 64).astype(np.int32)
    res = {}
    cpu_params = params_to(params, "cpu")
    n_threads = torch.get_num_threads()
    for run in ("cuda", "cpu", "cpu_1thread"):
        dev = "cuda" if run == "cuda" else "cpu"
        torch.set_num_threads(1 if run == "cpu_1thread" else n_threads)
        p = params if dev == "cuda" else cpu_params
        ctx = LlamaContext(cfg, p, n_cells=1024, buckets=(8, 16, 32, 64), device=dev)
        assert ctx.decode(Batch.single(prompt)) == 0
        logits = [ctx.get_logits()[-1]]
        toks = [int(np.argmax(logits[-1]))]
        for i in range(4):
            assert ctx.decode(Batch.single([toks[-1]], pos0=64 + i)) == 0
            logits.append(ctx.get_logits()[-1])
            toks.append(int(np.argmax(logits[-1])))
        res[run] = (toks, logits)
    torch.set_num_threads(n_threads)
    (gt, gl), (ct, cl), (_, c1) = res["cuda"], res["cpu"], res["cpu_1thread"]

    def rel_errs(xs):
        return [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(xs, cl)]

    errs = rel_errs(gl)
    # the CPU's top-2 logit gap per step, in the same unit: where it exceeds
    # the error, equal greedy tokens are expected and carry signal
    gaps = [float((np.sort(b)[-1] - np.sort(b)[-2]) / np.abs(b).max()) for b in cl]
    # tol: f32 reduction order differs between the kernels and the plain
    # versions, and the bf16 residual stream, the bf16 FFN intermediate and
    # the int8 re-quantizations turn such last-bit differences into whole
    # rounding steps (cpu_thread_spread shows how far).  On zero-mean
    # weights max|logits| is ~5 logit std (logit_std_rel), so 3e-2 is ~0.15
    # std, where a wiring fault moves logits by about one std
    tol = 3e-2
    log(json.dumps({"phase": "parity", "n_layer": 2, "tokens_cuda": gt, "tokens_cpu": ct,
                    "tokens_cpu_1thread": res["cpu_1thread"][0], "rel_logit_err": errs,
                    "cpu_thread_spread_rel": rel_errs(c1), "top2_gap_rel": gaps,
                    "logit_std_rel": [float(b.std() / np.abs(b).max()) for b in cl],
                    "tol_rel": tol}))
    if gt != ct or not max(errs) <= tol:
        raise AssertionError("card and CPU disagree")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import llama_kotlin_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    from llama_kotlin_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    log(json.dumps({"phase": "device", "name": name, "count": torch.cuda.device_count(),
                    "torch": torch.__version__, "cuda": torch.version.cuda}))
    log(smi)
    try:
        t0 = time.perf_counter()
        so = _build.build()
        _build.lib()
        ptxas = [ln.strip() for ln in (_build.BUILD_DIR / "ptxas.log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln] if (_build.BUILD_DIR / "ptxas.log").exists() else []
        log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                        "library": so.name}))
        for ln in ptxas:
            print(ln, file=sys.stderr)
        results: dict = {}
        kernel_phase(torch, results)
        counts = serving_phase(torch)
        parity_phase(torch)
    except Exception:
        traceback.print_exc()
        return 1
    meta = {
        "qmm_w4": ("csrc/qmm_w4.cu", "llama_kotlin_tpu/ops/pallas/qmm_w4.py:290", 0),
        "qmm_w4_ffn": ("csrc/qmm_w4_ffn.cu", "llama_kotlin_tpu/ops/pallas/qmm_w4_ffn.py:155", 0),
        "flash": ("csrc/flash.cu", "llama_kotlin_tpu/ops/pallas/flash.py:160", 0),
        "qmm": ("csrc/qmm.cu", "llama_kotlin_tpu/ops/pallas/qmm.py:192", 1),
    }
    kernels = []
    for kname, (src, replaces, pick) in meta.items():
        row = results[kname][pick]
        kernels.append({"name": kname, "route": "cuda",
                        "source": "llama_kotlin_tpu_torch/" + src, "replaces": replaces,
                        "launches": counts[kname], "max_abs_err": max(
                            r["max_abs_err"] for r in results[kname]),
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "shape": row["shape"]})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
