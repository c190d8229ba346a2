#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (llama_kotlin_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device  — the card's name and power limit;
  2. build   — compile csrc/*.cu for sm_90a (one nvcc per source, all
               started together) and load the library;
  3. kernels — every kernel of the serving paths at the llama3-8B shapes
               they get there (kernels 3 and 9 also on an int8 cache),
               held against its plain PyTorch version on the same inputs,
               timed with CUDA events (median of 20, L2 flushed before each
               call), beside its bound on this card and one PyTorch library
               call where one computes the same function; and the
               load-time repack and the KV row quantizer on the card
               against the CPU's, bit for bit;
  4. serving — the full llama3-8B W4A8 model (32 layers, random weights
               from a seed) serves 3 requests through LlamaContext: prefill
               64 tokens, then 32 greedy tokens; on the unrolled path with
               a bf16 cache, then stacked with a bf16 and a q8_0 cache and
               unrolled with a q8_0 cache (these at the model's first 4
               layers); every kernel of each path must launch (kernel 9
               once a layer and step, kernel 3 never, on the stacked path);
  5. gguf    — a full-width 32-layer llama3-8B GGUF file with the Q4_K_M
               type mix (random wire blocks from a seed) is written to a
               temporary directory, loaded with load_gguf_model in the w4
               and in the int8 mode, and each serves 3 requests as in 4
               (unrolled, bf16 cache), the int8 mode also stacked with a
               q8_0 cache; every kernel of the path must be launched;
  6. parity  — full width, 2 layers: the port on the card against the port
               on the CPU (plain versions), prefill plus 4 greedy steps, for
               the synthetic W4A8 model (unrolled bf16 cache, stacked and
               unrolled q8_0 cache), the synthetic W4X model (stacked, bf16
               cache) and for a GGUF file in both modes.

The W4X high-fidelity mode (precise folds, dual-plane activations) adds to
3 kernel 7 and kernel 5's dual-plane branch against their plain versions,
the card's dual-plane activation codes against the CPU's and a fidelity
check (kernel 7 at least 20 times closer than kernel 1 to an exact matmul
on the same weights); to 4 the full llama3-8B W4X model on the default
(stacked) context; to 5 the same GGUF file loaded with fast_mode="w4x"
(unrolled, as in JAX); each with its launch counts, kernels 1 and 2 never.

The packed int4 (q4_0) KV cache adds to 3 kernel 3's int4 branch against
its plain version (decode and a 64-token prefill over 1024 cells), the
card's quantize_rows_q4 against the CPU's and kernel 9's refusal of the
packed cache; to 4 the W4A8 model unrolled (kernel 3's int4 branch, 96
launches a layer over the 3 requests) and stacked (the plain route,
models/llama.py::attend_stacked_q4, and neither kernel 3 nor 9); to 5 the
w4-mode file unrolled with it; to 6 the q4_0 cache on both paths, a
seq_div/seq_add K shift on each cache type and a file with a dense (F16)
output matrix.

Kernels 8 and 10, behind the JAX package's opt-in knobs (set per run by
knobs(), which restores the environment), add to 3 kernel 8 on sym and
legacy W4 folds at the four decode projections (b = 1, 9, 16 and 32,
beside kernel 1 on the same inputs) and kernel 10 on compact, sym and legacy folds
(b = 1 and 8, beside the unfused route it replaces); to 4 the W4A8 model
(its first 4 layers) with LKTPU_LAYER_FUSED=1, stacked and unrolled
(kernel 10: n_layer launches a decode step, none at the prefill); to 5 a
full-width 4-layer Q4_0 file (sym folds, Q6_K output) by default, with
LKTPU_W4_FX=1 and with both knobs; to 6 the fused W4A8 model and 2-layer
Q4_0 and Q4_1 files under each knob against the CPU.

Kernel 4's split-K GEMM and kernel 7's tensor-core path add to 3 kernel 4
at 64 and 512 rows (both branches, timed), at 17, 33, 100 and 1024 rows
(the other row tiles) and kernel 7 at 9, 16 and 32 rows, each checked for
two bit-equal launches; to 4 a 32-token W4X prompt (kernel 7
takes every prefill projection, kernel 4 none); and a torch.profiler trace
of one prefill beside each decode trace.

Kernels 5 (both branches) and 8 above their row thresholds take int8
tensor cores: 3 times kernel 5 at b = 1, 9, 16, 32 on lm_head, ffn_down and
attn_v (W8 and W8X folds of the same q6_K blocks) and kernel 8 at b = 1, 9,
16, 32 on qkv, o, gate|up and down (sym and legacy), each at every
batch-row bucket on one shape and repeated bit-equal, kernel 8's in-launch
activation codes against kernel 1's prologue's; 5 a 32-token prompt on the
Q4_K_M file in w4 and w4x (kernel 5 at 32 rows: 32 launches a prefill)
and on the Q4_0 file under LKTPU_W4_FX=1 (kernel 8 at 32 rows: 2 a layer
a prefill), each with exact launch counts and a profiled prefill.

Kernel 1 above its row threshold T1 takes kernel 7's int8 tensor-core
tile with one plane (compact folds through their 6-bit codes), and kernel
3 a bf16 tensor-core tile that skips dead cell tiles, at every row count:
3 times kernel 1 on compact, sym and legacy folds at b = 1, 9, 16, 32 on
qkv, o, gate|up and the lm_head (above T1 repeated bit-equal), and checks
kernel 3 on the three caches at 4-256 rows a kv head, with a fully masked
row (exactly 0), a softcap and a dead tile between live ones; serve()
counts kernel 1's tensor-core launches ("qmm_w4_mma") and holds them,
request by request, to the rows each prefill and decode step gives it.

Kernel 9 runs on kernel 3's tile, and both take head dims 64 and 128 and
any visible-cell count; kernel 6 above its row threshold T6 takes int8
tensor cores: 3 times kernel 6 at b = 1, 2, 4, 8, 9, 16, 32, 64 and 512 on
qkv, o, gate|up, down and the lm_head (above T6 repeated bit-equal), and
kernels 3 and 9 at head dim 64 and over 1000 and 1001 visible cells; 4
serves the tinyllama-1.1b preset (22 layers, head dim 64: unrolled bf16,
stacked bf16 and q8_0, unrolled q4_0, and stacked and unrolled contexts of
1000 cells) with exact launch counts; 5 counts kernel 6's tensor-core
launches at the int8-mode file's 64-token prefill and serves it a 32-token
prompt (kernel 6's tile at 32 rows: 128 launches a prefill); 6 holds
tinyllama at 2 layers on each of those paths against the CPU.

Kernels 2 and 10 run one staged FFN (csrc/w4_coop.cuh): kernel 2 up to its
threshold T2 and kernel 10 as one cooperative launch (the walk at one
row, int8 tensor cores above), kernel 2 above T2 on kernel 1's tile; 3
times kernel 2 on compact, sym and legacy folds at b = 1, 2, 4, 8, 9, 16,
32 and its up= branch (gate and up apart) at b = 1 and 32, each beside the
unfused route (unfused_ms), kernel 10 at b = 1, 2, 4, 8 on each flavor,
all repeated bit-equal; serve() counts kernel 2's tile launches
("qmm_w4_ffn_mma") as kernel 1's; 5 serves the Q4_0 file loaded with
fuse=False (kernel 2's up= branch at every decode step) with exact launch
counts.

The last line of standard output is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

# the card's data-sheet peaks (H100 SXM, dense): bytes/s and ops/s
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12}
REPS = 20
FLUSH_BYTES = 256 << 20  # > the 50 MB L2: decode streams cold weights
SPIN_CYCLES = 10_000_000  # ~5 ms of device spin ahead of each timed call
# depth of the paths earlier slices added (the quantized caches, the fused
# layer half, the Q4_0 file): cut from 32 layers to keep the whole script
# well inside its time limit on a slow host (8 layers until the
# tinyllama-1.1b phase and kernel 6's and the repaired attention's rows
# came); the main path, the W4X model, the Q4_K_M file and tinyllama-1.1b
# keep their full depth
EARLIER_LAYERS = 4
# greedy tokens of each request of the 32-token prompts (serve_32)
N_NEW_32 = 8
# kernel 6's timed row counts: both sides of its threshold T6, each m16
# count of its tile, a 64-token and a 512-token prefill
Q8F_ROWS = (1, 2, 4, 8, 9, 16, 32, 64, 512)


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


def err_of(got, ref) -> dict:
    got, ref = got.float(), ref.float()
    a = (got - ref).abs().max().item()
    return {"abs": a, "rel": a / max(ref.abs().max().item(), 1e-30)}


def report_row(results, kernel, shape, err, tol, ms, plain_ms, nbytes, ops, kind,
               library_ms) -> None:
    """A timed comparison of a kernel with its plain version."""
    bms, by = bound(nbytes, ops, kind)
    row = {"kernel": kernel, "shape": shape, "max_abs_err": err["abs"],
           "max_rel_err": err["rel"], "tol_rel": tol, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": library_ms}
    log(json.dumps(row))
    if not err["rel"] <= tol:
        raise AssertionError(f"{kernel} {shape}: rel err {err['rel']} > {tol}")
    results.setdefault(kernel, []).append(row)


def check_row(results, kernel, shape, got, ref, tol) -> None:
    """An untimed comparison: the instantiations the serving runs may not
    reach (fold flavors, batch-row buckets, activations)."""
    err = err_of(got, ref)
    row = {"kernel": kernel, "shape": shape, "max_abs_err": err["abs"],
           "max_rel_err": err["rel"], "tol_rel": tol, "timed": False}
    log(json.dumps(row))
    if not err["rel"] <= tol:
        raise AssertionError(f"{kernel} {shape}: rel err {err['rel']} > {tol}")
    results.setdefault(kernel, []).append(row)


def repeats(torch, kernel, shape, first, fn) -> None:
    """A second launch on the same inputs gives the first output bit for
    bit (split partials are summed in a fixed order, no float atomics)."""
    again = fn()
    same = torch.equal(first, again)
    log(json.dumps({"phase": "determinism", "kernel": kernel, "shape": shape,
                    "bit_equal": same}))
    if not same:
        raise AssertionError(f"{kernel} {shape}: two launches differ")


def codes_equal(torch, x, planes: int = 1) -> None:
    """The prologue's int8 activation codes, scales and sums (q8.cu; with
    planes=2 the W4X mode's dual-plane quantizer) are bit-equal to the
    plain quantizer's on the CPU."""
    from llama_kotlin_tpu_torch.ops.cuda import qmm_w4

    card, plain = ((qmm_w4.quantize_q8_cuda, qmm_w4.quantize_q8) if planes == 1 else
                   (qmm_w4.quantize_q8_2p_cuda, qmm_w4.quantize_q8_2p))
    a, b = card(x), plain(x.cpu())
    if not all(torch.equal(p.cpu(), q) for p, q in zip(a, b)):
        raise AssertionError(f"{planes}-plane activation codes differ from the CPU quantizer")


def fx_codes_equal(torch, x, w, y) -> None:
    """Kernel 8's tensor-core launch quantizes x inside its blocks: the
    codes, scales and group sums it writes when asked are kernel 1's
    prologue's (q8.cu) bit for bit, and asking leaves y as it was."""
    from llama_kotlin_tpu_torch.ops.cuda import qmm_w4, qmm_w4_fx

    y2, codes = qmm_w4_fx.qmm_w4_fx_matmul(x, w, codes_out=True)
    xp = torch.nn.functional.pad(x, (0, w.k_pad - x.shape[-1]))
    same = all(torch.equal(a, b) for a, b in zip(codes, qmm_w4.quantize_q8_cuda(xp)))
    log(json.dumps({"phase": "qmm_w4_fx_codes", "rows": x.shape[0], "n": w.n,
                    "bit_equal_to_prologue": same, "y_bit_equal": torch.equal(y, y2)}))
    if not same or not torch.equal(y, y2):
        raise AssertionError("kernel 8's in-launch codes differ from kernel 1's prologue")


def matmul_ms(torch, x, w, flush) -> float:
    """library_ms of a quantized matmul (kernel 4's convention): one
    torch.matmul of the bf16 activations with the pre-dequantized bf16
    weight, on the same shapes."""
    from llama_kotlin_tpu_torch.ops.cuda.qmm import dequantize_bf16

    wb = dequantize_bf16(w)
    xb = x.to(torch.bfloat16)
    ms = time_ms(torch, lambda: torch.matmul(xb, wb.T), flush)
    del wb
    return ms


class BranchCounter:
    """A launch count kept beside a module's LAUNCHES (kernel 5's
    dual-plane branch counts in qmm_w8.LAUNCHES_2P), usable where serve()
    takes a kernel module."""

    def __init__(self, mod, attr: str, name: str):
        self.__name__, self._mod, self._attr = name, mod, attr

    @property
    def LAUNCHES(self) -> int:
        return getattr(self._mod, self._attr)

    @LAUNCHES.setter
    def LAUNCHES(self, value: int) -> None:
        setattr(self._mod, self._attr, value)


class CallCounter:
    """Counts the calls of a module's function while installed: a plain
    torch route of the forward pass (not a kernel), held by serve() as it
    holds a kernel module's LAUNCHES.  close() puts the function back."""

    def __init__(self, mod, attr: str):
        self.__name__, self.LAUNCHES = f"{mod.__name__}.{attr}", 0
        self._mod, self._attr, self._fn = mod, attr, getattr(mod, attr)

        def counted(*args, **kw):
            self.LAUNCHES += 1
            return self._fn(*args, **kw)

        setattr(mod, attr, counted)

    def close(self) -> None:
        setattr(self._mod, self._attr, self._fn)


def w8_precise():
    from llama_kotlin_tpu_torch.ops.cuda import qmm_w8

    return BranchCounter(qmm_w8, "LAUNCHES_2P", "qmm_w8.qmm_w8_precise")


def mma_counter(mod):
    """A kernel's launches on its tensor-core path (kernels 1, 8 and kernel
    5's single-plane branch), counted apart as "<kernel>_mma"."""
    name = mod_name(mod)
    return BranchCounter(mod, "LAUNCHES_MMA", f"{mod.__name__}.{name}_mma")


def w8_precise_mma():
    from llama_kotlin_tpu_torch.ops.cuda import qmm_w8

    return BranchCounter(qmm_w8, "LAUNCHES_2P_MMA", "qmm_w8.qmm_w8_precise_mma")


def sdpa_call(torch, q, k, v, mask, scale):
    """The library yardstick for attention: one scaled_dot_product_attention
    call on q [nt, H, D] and prebuilt bf16 K/V [KV, cells, D] under a
    boolean mask [nt, cells]; returns it as a callable."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs, bmask = q.transpose(0, 1)[None], k[None], v[None], mask.bool()
    try:  # enable_gqa needs torch >= 2.5; else expand the kv heads once
        sdpa(qs, ks, vs, attn_mask=bmask, scale=scale, enable_gqa=True)
        return lambda: sdpa(qs, ks, vs, attn_mask=bmask, scale=scale, enable_gqa=True)
    except TypeError:
        rep = q.shape[1] // k.shape[0]
        ke, ve = (t.repeat_interleave(rep, dim=1) for t in (ks, vs))
        return lambda: sdpa(qs, ke, ve, attn_mask=bmask, scale=scale)


W4_STREAMED = ("codes", "aux.q6", "aux.dd")
FOLD_PLANES = ("codes", "g_scale", "g_min")
SYM_PLANES = ("codes", "g_scale")  # a sym fold's min is 8 s: no plane of its own


def w4_planes(w) -> tuple:
    """The planes that a W4A8 product with fold w must read: the compact
    planes, a sym fold's codes and scales, or codes, scales and mins."""
    return {"compact": W4_STREAMED, "sym": SYM_PLANES}.get(w.flavor, FOLD_PLANES)


def nbytes(w, names=FOLD_PLANES) -> int:
    """Bytes of a weight that a kernel reads: the W4 decode kernels stream
    codes + compact planes (W4_STREAMED); kernel 4 and the int8-code
    kernels read codes + g_scale (+ g_min)."""
    ts = w.tensors()
    return sum(ts[n].numel() * ts[n].element_size() for n in names if n in ts)


def w4_on_card(torch, gen, n: int, k: int, flavor: str):
    """A random W4 fold of a flavor, drawn on the card: compact with
    independent scale and min planes (synthetic_w4_device), or legacy or sym
    f32 scale (and min) planes rounded to bf16 as those folds keep them; a
    sym fold's min plane is 8 s on lo groups and 0 on hi ones."""
    from llama_kotlin_tpu_torch.models.synthetic import synthetic_w4_device
    from llama_kotlin_tpu_torch.quant.fold import w4_from_parts

    dev = torch.device("cuda")
    if flavor == "compact":
        return synthetic_w4_device(gen, n, k, zero_mean=False, device=dev)
    G = k // 32
    packed = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, generator=gen, device=dev)
    s = torch.rand((n, G), generator=gen, device=dev) * (0.02 / 8)
    if flavor == "sym":
        m = torch.where(torch.arange(G, device=dev) % 8 < 4, 8.0 * s, torch.zeros_like(s))
    else:
        m = torch.rand((n, G), generator=gen, device=dev) * 0.01
    w = w4_from_parts(packed, s, m, (n, k), sym=flavor == "sym")
    assert w.flavor == flavor
    return w


# kernel 2's timed rows: its cooperative launch (the walk, its tensor
# cores) up to T2 = 8, kernel 1's tile above
FFN_ROWS = (1, 2, 4, 8, 9, 16, 32)


def ffn_unfused(torch, x, gu, dn, up=None):
    """Kernel 2's yardstick: the route models/llama.py::_ffn takes with
    LKTPU_FFN_FUSED=0, on the port's own kernels (kernel 1 for gate|up or
    gate and up, the glue, kernel 1 for down)."""
    from llama_kotlin_tpu_torch.ops.cuda import qmm_w4

    F = dn.k
    if up is None:
        y = qmm_w4.qmm_w4_matmul(x, gu)
        g, u = y[:, :F], y[:, F:]
    else:
        g, u = qmm_w4.qmm_w4_matmul(x, gu), qmm_w4.qmm_w4_matmul(x, up)
    h = (torch.nn.functional.silu(g) * u).to(torch.bfloat16)
    return qmm_w4.qmm_w4_matmul(h, dn)


def ffn_row(torch, results, shape, got, x, gu, dn, up, flush) -> None:
    """A timed row of kernel 2 against its plain version, with the unfused
    route's time (unfused_ms) beside it: bytes bound by the three weights
    in the planes the kernel reads (a sym fold's codes and scales)."""
    from llama_kotlin_tpu_torch.ops.cuda import qmm_w4_ffn

    b, E = x.shape
    F = dn.k
    folds = (gu, dn) if up is None else (gu, up, dn)
    report_row(results, "qmm_w4_ffn", shape,
               err_of(got, qmm_w4_ffn.qmm_w4_ffn_plain(x, gu, dn, "silu", up)), 5e-3,
               time_ms(torch, lambda: qmm_w4_ffn.qmm_w4_ffn_matmul(x, gu, dn, up=up), flush),
               time_ms(torch, lambda: qmm_w4_ffn.qmm_w4_ffn_plain(x, gu, dn, "silu", up), flush),
               2 * b * E * 4 + sum(nbytes(w, w4_planes(w)) for w in folds),
               2 * b * 3 * F * E, "int8", None)
    unfused_ms = time_ms(torch, lambda: ffn_unfused(torch, x, gu, dn, up), flush)
    results["qmm_w4_ffn"][-1]["unfused_ms"] = unfused_ms
    log(json.dumps({"phase": "qmm_w4_ffn_vs_unfused", "shape": shape, "unfused_ms": unfused_ms}))


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

    report = functools.partial(report_row, results)
    check = functools.partial(check_row, results)

    # kernel 1: W4A8 decode matmul on every flavor (compact, sym, legacy) at
    # the decode projections, a gate|up-shaped matrix and the lm_head, b = 1
    # (the walk) and 9, 16, 32 (the tensor cores above T1: two launches
    # bit-equal).  tol: both sides take exact integer partials; f32 order of
    # the scale products and the group sums differs
    for flavor in ("compact", "sym", "legacy"):
        for name in ("qkv", "o", "gate_up", "lm_head"):
            n, k = w[name].shape
            wt = w[name] if flavor == "compact" else w4_on_card(torch, gen, n, k, flavor)
            for b in (1, 9, 16, 32):
                x = torch.randn((b, k), generator=gen, device=dev) * 0.7
                got = qmm_w4.qmm_w4_matmul(x, wt)
                shape = f"{flavor} {name} n={n} k={k} b={b}"
                if flavor == "compact":
                    codes_equal(torch, x)
                if qmm_w4.use_mma(b):
                    repeats(torch, "qmm_w4", shape, got, lambda: qmm_w4.qmm_w4_matmul(x, wt))
                report("qmm_w4", shape, err_of(got, qmm_w4.qmm_w4_plain(x, wt)), 1e-4,
                       time_ms(torch, lambda: qmm_w4.qmm_w4_matmul(x, wt), flush),
                       time_ms(torch, lambda: qmm_w4.qmm_w4_plain(x, wt), flush),
                       b * k * 4 + nbytes(wt, w4_planes(wt)) + b * n * 4, 2 * b * n * k, "int8",
                       matmul_ms(torch, x, wt, flush))
            del wt

    # kernel 1, every flavor at every batch-row bucket of both designs (the
    # walk's NB = 1, 2; the tensor cores' m16 tile counts, 3-16 and 17-32
    # rows, with rows masked off)
    rng = np.random.default_rng(4321)
    folds = {"compact": w["o"], "legacy": synthetic_w4(rng, E, E, compact=False, device=dev),
             "sym": synthetic_w4(rng, E, E, sym=True, device=dev)}
    for flavor, wt in folds.items():
        for b in (1, 2, 3, 5, 9, 17, 32):
            x = torch.randn((b, E), generator=gen, device=dev) * 0.7
            got = qmm_w4.qmm_w4_matmul(x, wt)
            if qmm_w4.use_mma(b):
                repeats(torch, "qmm_w4", f"{flavor} o b={b}", got,
                        lambda: qmm_w4.qmm_w4_matmul(x, wt))
            check("qmm_w4", f"{flavor} o b={b}", got, qmm_w4.qmm_w4_plain(x, wt), 1e-4)

    # kernel 2: the FFN on compact, sym and legacy folds at b = 1, 2, 4, 8 (the
    # cooperative launch up to T2; b = 1 walks, more rows take its tensor
    # cores) and 9, 16, 32 (kernel 1's tile), two launches bit-equal, beside
    # the unfused route (LKTPU_FFN_FUSED=0: kernel 1's gate|up, the glue,
    # kernel 1's down); then the up= layout (gate and up apart) at b = 1 and
    # 32.  tol: h is rounded to bf16 and re-quantized, so an f32 last-bit
    # difference can move one h code
    ffn = {"compact": (w["gate_up"], w["down"])}
    for flavor in ("sym", "legacy"):
        ffn[flavor] = tuple(w4_on_card(torch, gen, n, k, flavor) for n, k in ((2 * F, E), (E, F)))
    for flavor, (gu, dn) in ffn.items():
        for b in FFN_ROWS:
            x = torch.randn((b, E), generator=gen, device=dev) * 0.7
            shape = f"{flavor} E={E} F={F} b={b}"
            got = qmm_w4_ffn.qmm_w4_ffn_matmul(x, gu, dn)
            repeats(torch, "qmm_w4_ffn", shape, got,
                    lambda: qmm_w4_ffn.qmm_w4_ffn_matmul(x, gu, dn))
            ffn_row(torch, results, shape, got, x, gu, dn, None, flush)
    gu, dn = ffn["compact"]
    gate, up = gu.row_slice(0, F), gu.row_slice(F, 2 * F)
    for b in (1, 32):
        x = torch.randn((b, E), generator=gen, device=dev) * 0.7
        got = qmm_w4_ffn.qmm_w4_ffn_matmul(x, gate, dn, up=up)
        repeats(torch, "qmm_w4_ffn", f"up= b={b}", got,
                lambda: qmm_w4_ffn.qmm_w4_ffn_matmul(x, gate, dn, up=up))
        ffn_row(torch, results, f"up= compact E={E} F={F} b={b}", got, x, gate, dn, up, flush)

    # kernel 2 at the other batch-row buckets and with gelu (every route's
    # instances)
    cases = [("compact", "silu", b) for b in (3, 5, 17)]
    cases += [("compact", "gelu", 1), ("compact", "gelu", 3), ("compact", "gelu", 9),
              ("legacy", "gelu", 3), ("sym", "gelu", 1), ("sym", "silu", 24)]
    for flavor, act, b in cases:
        gu, dn = ffn[flavor]
        x = torch.randn((b, E), generator=gen, device=dev) * 0.7
        check("qmm_w4_ffn", f"{flavor} {act} b={b}",
              qmm_w4_ffn.qmm_w4_ffn_matmul(x, gu, dn, act=act),
              qmm_w4_ffn.qmm_w4_ffn_plain(x, gu, dn, act), 5e-3)
    del ffn, folds, gate, up

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
        lib = sdpa_call(torch, q, kc[1, :, :n_vis], vc[1, :, :n_vis], mask, scale)
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

    # kernel 4: prefill dequant matmul — qkv, gate|up, down, o at 64 and 512
    # rows (timed), 33 and 100 (ragged row tiles) and 17 (the 32-row tile,
    # as LKTPU_W4_FX sends a compact fold's decode rows); two launches
    # bit-equal.  tol: identical bf16 operands, f32 accumulation order only
    for m in (64, 512, 33, 100, 17):
        for name in ("qkv", "gate_up", "down", "o"):
            wt = w[name]
            n, k = wt.shape
            xb = (torch.randn((m, k), generator=gen, device=dev) * 0.7).to(torch.bfloat16)
            got = qmm.qmm(xb, wt)
            ref = qmm.qmm_plain(xb, wt)
            shape = f"{name} n={n} k={k} m={m}"
            repeats(torch, "qmm", shape, got, lambda: qmm.qmm(xb, wt))
            if m not in (64, 512):
                check("qmm", shape, got, ref, 1e-3)
                continue
            report("qmm", shape, err_of(got, ref), 1e-3,
                   time_ms(torch, lambda: qmm.qmm(xb, wt), flush),
                   time_ms(torch, lambda: qmm.qmm_plain(xb, wt), flush),
                   m * k * 2 + nbytes(wt) + m * n * 4, 2 * m * n * k,
                   "bf16", matmul_ms(torch, xb, wt, flush))
    del w, flush
    torch.cuda.empty_cache()


def w8_kernel_phase(torch, results: dict) -> None:
    """Kernels 5 (both branches: W8 and, as the w4x mode loads them, W8X
    folds) and 6 and kernel 4's 8-bit branch at the llama3-8B shapes the
    Q4_K_M file gives them, on layouts repacked on the card from random wire
    blocks; and the card's repack against the CPU's, bit for bit."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.synthetic import wire_blocks
    from llama_kotlin_tpu_torch.ops.cuda import qmm, qmm_int8, qmm_w8
    from llama_kotlin_tpu_torch.quant import fold, repack
    from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    report = functools.partial(report_row, results)
    check = functools.partial(check_row, results)
    rng = np.random.default_rng(99)
    E, F, V, KVD = 4096, 14336, 128256, 1024

    def wire(qtype, n, k):
        return torch.from_numpy(wire_blocks(rng, qtype, n, k))

    # the load-time conversions on the card against the CPU's: one Q4_K and
    # one Q6_K tensor through their fold (W4, W8) and through Q8F
    for qtype, (n, k), fold_fn in ((Q.Q4_K, (E, E), fold.fold_to_w4),
                                   (Q.Q6_K, (E, F), fold.fold_to_w8)):
        data = wire(qtype, n, k)
        for what, fn in (("fold", lambda d: fold_fn(repack.repack(d, qtype, n, k))),
                         ("q8f", lambda d: repack.repack_q8flat(d, qtype, n, k))):
            g, c = fn(data.to(dev)), fn(data)
            same = (g.tensors().keys() == c.tensors().keys() and all(
                t.dtype == c.tensors()[name].dtype and torch.equal(t.cpu(), c.tensors()[name])
                for name, t in g.tensors().items()))
            log(json.dumps({"phase": "repack", "qtype": qtype.name, "shape": [n, k],
                            "layout": g.flavor, "tensors": sorted(g.tensors()),
                            "bit_equal_to_cpu": same}))
            if not same:
                raise AssertionError(f"card repack of {qtype.name} ({what}) differs from the CPU's")
        del data, g, c

    def w8(qtype, n, k, precise=False):
        return fold.fold_to_w8(repack.repack(wire(qtype, n, k).to(dev), qtype, n, k),
                               precise=precise)

    # kernel 5, both branches (a W8X fold of the same q6_K blocks, group 16,
    # takes the dual-plane one): lm_head, ffn_down and attn_v at b = 1 (the
    # walk) and 9, 16, 32 (the tensor cores above T5; two launches
    # bit-equal).  tol: exact integer partials on both sides; the f32 order of
    # the group sum differs
    rp = {name: repack.repack(wire(Q.Q6_K, n, k).to(dev), Q.Q6_K, n, k)
          for name, (n, k) in {"lm_head": (V, E), "down": (E, F), "attn_v": (KVD, E)}.items()}
    w = {name: fold.fold_to_w8(r) for name, r in rp.items()}
    wx = {name: fold.fold_to_w8(r, precise=True) for name, r in rp.items()}
    del rp
    for label, folds in (("qmm_w8", w), ("qmm_w8_precise", wx)):
        precise = folds is wx
        for name, wt in folds.items():
            n, k = wt.shape
            for b in (1, 9, 16, 32):
                x = torch.randn((b, k), generator=gen, device=dev) * 0.7
                codes_equal(torch, x, planes=2 if precise else 1)
                got = qmm_w8.qmm_w8_matmul(x, wt)
                shape = f"{name} n={n} k={k} b={b} group=16"
                if qmm_w8.use_mma(b):
                    repeats(torch, label, shape, got, lambda: qmm_w8.qmm_w8_matmul(x, wt))
                report(label, shape, err_of(got, qmm_w8.qmm_w8_plain(x, wt)), 1e-4,
                       time_ms(torch, lambda: qmm_w8.qmm_w8_matmul(x, wt), flush),
                       time_ms(torch, lambda: qmm_w8.qmm_w8_plain(x, wt), flush),
                       b * k * 4 + nbytes(wt) + b * n * 4, (1 + precise) * 2 * b * n * k,
                       "int8", matmul_ms(torch, x, wt, flush))
    del wx

    # kernel 4's 8-bit branch: prefill rows over the W8 fold, m = 64 and
    # 512; two launches bit-equal.
    # tol: identical bf16 operands (w = code * s_eff), f32 accumulation order
    for m in (64, 512):
        for name in ("down", "attn_v"):
            wt = w[name]
            n, k = wt.shape
            xb = (torch.randn((m, k), generator=gen, device=dev) * 0.7).to(torch.bfloat16)
            got = qmm.qmm(xb, wt)
            shape = f"8-bit {name} n={n} k={k} m={m} group=16"
            repeats(torch, "qmm", shape, got, lambda: qmm.qmm(xb, wt))
            report("qmm", shape, err_of(got, qmm.qmm_plain(xb, wt)), 1e-3,
                   time_ms(torch, lambda: qmm.qmm(xb, wt), flush),
                   time_ms(torch, lambda: qmm.qmm_plain(xb, wt), flush),
                   m * k * 2 + nbytes(wt) + m * n * 4, 2 * m * n * k, "bf16",
                   matmul_ms(torch, xb, wt, flush))
    # the 128-row tile of the 8-bit branch (a 1024-row prompt)
    xb = (torch.randn((1024, F), generator=gen, device=dev) * 0.7).to(torch.bfloat16)
    got = qmm.qmm(xb, w["down"])
    repeats(torch, "qmm", "8-bit down m=1024", got, lambda: qmm.qmm(xb, w["down"]))
    check("qmm", "8-bit down m=1024", got, qmm.qmm_plain(xb, w["down"]), 1e-3)
    del xb, got
    del w

    # kernel 5, both branches, at every batch-row bucket (both designs: the
    # walk up to T5, the tensor cores' m16 tile counts above it, split K) on
    # a q8_0-sourced fold (group 32), on a fold with mins (Q4_K folded to W8:
    # the min term's matmul) and on q6_K attn_v (group 16, K split in every
    # superblock); kernel 4's 8-bit branch on the W8 ones (its group-32 and
    # with-mins instances)
    extra = {"q8_0": (Q.Q8_0, E, E), "q4_K-mins": (Q.Q4_K, E, E), "q6_K": (Q.Q6_K, KVD, E)}
    for src, (qt, n, k) in extra.items():
        for label, precise in (("qmm_w8", False), ("qmm_w8_precise", True)):
            wt = w8(qt, n, k, precise)
            for b in (1, 2, 3, 5, 8, 9, 12, 16, 17, 24, 32):
                x = torch.randn((b, k), generator=gen, device=dev) * 0.7
                got = qmm_w8.qmm_w8_matmul(x, wt)
                shape = f"{src} group={wt.group_size} n={n} b={b}"
                if qmm_w8.use_mma(b):
                    repeats(torch, label, shape, got, lambda: qmm_w8.qmm_w8_matmul(x, wt))
                check(label, shape, got, qmm_w8.qmm_w8_plain(x, wt), 1e-4)
            if precise or src == "q6_K":
                continue
            for m in (8, 33, 100):
                xb = (torch.randn((m, k), generator=gen, device=dev) * 0.7).to(torch.bfloat16)
                got = qmm.qmm(xb, wt)
                shape = f"8-bit {src} group={wt.group_size} m={m}"
                repeats(torch, "qmm", shape, got, lambda: qmm.qmm(xb, wt))
                check("qmm", shape, got, qmm.qmm_plain(xb, wt), 1e-3)
    del wt

    # kernel 6: the Q8F matmul — qkv, o, gate|up, down, lm_head at b = 1, 2,
    # 4, 8, 9, 16, 32, 64 and 512 (the walk up to T6, the tensor-core tile
    # above it: 1, 2 and 4 m16 tiles, 64-row tiles, split K; two launches
    # bit-equal).  tol: exact superblock partials on both sides; the f32
    # order of the superblock sum differs
    w = {"qkv": (Q.Q4_K, 6144, E), "o": (Q.Q4_K, E, E), "gate_up": (Q.Q4_K, 2 * F, E),
         "down": (Q.Q6_K, E, F), "lm_head": (Q.Q6_K, V, E)}
    w = {name: repack.repack_q8flat(wire(qt, n, k).to(dev), qt, n, k)
         for name, (qt, n, k) in w.items()}
    for name, wt in w.items():
        n, k = wt.shape
        for b in Q8F_ROWS:
            x = torch.randn((b, k), generator=gen, device=dev) * 0.7
            if b <= 64:
                codes_equal(torch, x)
            got = qmm_int8.qmm_int8(x, wt)
            shape = f"{name} n={n} k={k} b={b}"
            if qmm_int8.use_mma(b):
                repeats(torch, "qmm_int8", shape, got, lambda: qmm_int8.qmm_int8(x, wt))
            report("qmm_int8", shape, err_of(got, qmm_int8.qmm_int8_plain(x, wt)), 1e-4,
                   time_ms(torch, lambda: qmm_int8.qmm_int8(x, wt), flush),
                   time_ms(torch, lambda: qmm_int8.qmm_int8_plain(x, wt), flush),
                   b * k * 4 + nbytes(wt) + b * n * 4, 2 * b * n * k, "int8",
                   matmul_ms(torch, x, wt, flush))
    # kernel 6 at 300 rows (a partial last row tile), at the other row
    # counts (each m16 count, partial row tiles), and at k = 768 (three
    # superblocks: the walk's half-live last step, an odd split)
    x = torch.randn((300, E), generator=gen, device=dev) * 0.7
    got = qmm_int8.qmm_int8(x, w["qkv"])
    repeats(torch, "qmm_int8", "qkv b=300", got, lambda: qmm_int8.qmm_int8(x, w["qkv"]))
    check("qmm_int8", "qkv b=300", got, qmm_int8.qmm_int8_plain(x, w["qkv"]), 1e-4)
    w768 = repack.repack_q8flat(wire(Q.Q8_0, 1024, 768).to(dev), Q.Q8_0, 1024, 768)
    for b in (1, 2, 3, 17, 33, 70, 129):
        x = torch.randn((b, 768), generator=gen, device=dev) * 0.7
        check("qmm_int8", f"n=1024 k=768 b={b}", qmm_int8.qmm_int8(x, w768),
              qmm_int8.qmm_int8_plain(x, w768), 1e-4)
    del w, w768, flush
    torch.cuda.empty_cache()


def w4x_kernel_phase(torch, results: dict) -> None:
    """The W4X mode's kernel 7 at the llama3-8B shapes, on precise W4 folds
    drawn on the card, against its plain version (kernel 5's dual-plane
    branch: w8_kernel_phase); the card's dual-plane activation codes
    against the CPU's, bit for bit; and the fidelity check on one Q4_K
    tensor folded both ways."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.synthetic import (synthetic_w4, synthetic_w4_device,
                                                         wire_blocks)
    from llama_kotlin_tpu_torch.ops.cuda import qmm_w4, qmm_w4x
    from llama_kotlin_tpu_torch.quant import fold, repack
    from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q
    from llama_kotlin_tpu_torch.quant.qtensor import dequantize

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5678)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    report = functools.partial(report_row, results)
    check = functools.partial(check_row, results)
    rng = np.random.default_rng(5678)
    E, F, V = 4096, 14336, 128256

    # the dual-plane prologue: random rows, a zero row, .5 ties (amax 127,
    # so s1 = 1), integer rows (a zero residual), against the CPU
    x = torch.randn((6, E), generator=gen, device=dev) * 0.7
    x[1] = 0.0
    x[2] = torch.randint(-254, 255, (E,), generator=gen, device=dev) / 2.0
    x[3] = torch.randint(-127, 128, (E,), generator=gen, device=dev).float()
    x[2:4, ::256] = 127.0
    codes_equal(torch, x, planes=2)
    log(json.dumps({"phase": "quantize_q8_2p", "rows": 6, "k": E, "bit_equal_to_cpu": True}))

    # kernel 7 at the decode projections, b = 1; gate|up at b = 8, 9, 16, 32
    # and down at b = 9, 16, 32 (above the threshold: the tensor-core GEMM;
    # two launches bit-equal).
    # tol: exact integer partials of both planes on both sides; the f32
    # order of the scale products and of the group and plane sums differs
    w = {name: synthetic_w4_device(gen, n, k, zero_mean=False, precise=True, device=dev)
         for name, (n, k) in {"qkv": (6144, E), "o": (E, E), "gate_up": (2 * F, E),
                              "down": (E, F), "lm_head": (V, E)}.items()}
    for name, b in (("qkv", 1), ("o", 1), ("gate_up", 1), ("down", 1), ("lm_head", 1),
                    ("gate_up", 8), ("gate_up", 32), ("gate_up", 9), ("gate_up", 16),
                    ("down", 9), ("down", 16), ("down", 32)):
        wt = w[name]
        n, k = wt.shape
        x = torch.randn((b, k), generator=gen, device=dev) * 0.7
        codes_equal(torch, x, planes=2)
        got = qmm_w4x.qmm_w4x_matmul(x, wt)
        shape = f"{name} n={n} k={k} b={b}"
        if qmm_w4x.use_mma(b):
            repeats(torch, "qmm_w4x", shape, got, lambda: qmm_w4x.qmm_w4x_matmul(x, wt))
        report("qmm_w4x", shape, err_of(got, qmm_w4x.qmm_w4x_plain(x, wt)), 1e-4,
               time_ms(torch, lambda: qmm_w4x.qmm_w4x_matmul(x, wt), flush),
               time_ms(torch, lambda: qmm_w4x.qmm_w4x_plain(x, wt), flush),
               b * k * 4 + nbytes(wt) + b * n * 4, 2 * 2 * b * n * k, "int8",
               matmul_ms(torch, x, wt, flush))
    del w
    # kernel 7 on legacy and sym precise folds at every batch-row bucket,
    # both designs (rows up to the threshold walk, more rows the GEMM)
    for flavor, kw in (("w4x", {}), ("w4x_sym", dict(sym=True))):
        wt = synthetic_w4(rng, E, E, precise=True, device=dev, **kw)
        assert wt.flavor == flavor
        for b in (1, 2, 3, 5, 8, 9, 12, 16, 17, 24, 32):
            x = torch.randn((b, E), generator=gen, device=dev) * 0.7
            got = qmm_w4x.qmm_w4x_matmul(x, wt)
            if qmm_w4x.use_mma(b):
                repeats(torch, "qmm_w4x", f"{flavor} o b={b}", got,
                        lambda: qmm_w4x.qmm_w4x_matmul(x, wt))
            check("qmm_w4x", f"{flavor} o b={b}", got, qmm_w4x.qmm_w4x_plain(x, wt), 1e-4)

    # fidelity: one Q4_K tensor folded to compact W4 and to W4X (the same
    # exact weights); kernel 7's error against the float64 product must be
    # at most a twentieth of kernel 1's
    data = torch.from_numpy(wire_blocks(rng, Q.Q4_K, E, E)).to(dev)
    rp = repack.repack(data, Q.Q4_K, E, E)
    w4, w4x = fold.fold_to_w4(rp), fold.fold_to_w4(rp, precise=True)
    wd = dequantize(w4x).double()
    if (w4.flavor, w4x.flavor) != ("compact", "w4x") or not torch.equal(dequantize(w4).double(), wd):
        raise AssertionError("the W4 and W4X folds of one tensor hold different weights")
    for b in (1, 8):
        x = torch.randn((b, E), generator=gen, device=dev) * 0.7
        ref = x.double() @ wd.T
        e1 = (qmm_w4.qmm_w4_matmul(x, w4).double() - ref).abs().max().item()
        e7 = (qmm_w4x.qmm_w4x_matmul(x, w4x).double() - ref).abs().max().item()
        log(json.dumps({"phase": "w4x_fidelity", "b": b, "max_abs_err_w4": e1,
                        "max_abs_err_w4x": e7, "ratio": e1 / e7,
                        "max_abs_ref": ref.abs().max().item()}))
        if not e7 * 20 <= e1:
            raise AssertionError(f"W4X is not 20x closer than W4: {e7} vs {e1}")
    del data, rp, w4, w4x, wd, flush
    torch.cuda.empty_cache()


def kv_kernel_phase(torch, results: dict) -> None:
    """The quantized KV caches' kernels at the llama3-8B shapes: kernel 3's
    int8 and int4 branches and kernel 9 (bf16 and int8 cache) on layer 31 of
    a [32, 8, 1025, 128] cache ([.., 64] packed for int4), decode (nt = 1)
    and a 64-token prefill chunk, 1024 visible cells; kernel 9's refusal of
    the packed cache; and the card's quantize_rows and quantize_rows_q4
    against the CPU's, bit for bit."""
    from llama_kotlin_tpu_torch.ops.cuda import flash, flash_stacked
    from llama_kotlin_tpu_torch.runtime.kv_cache import (dequantize_cache_layer, quantize_rows,
                                                         quantize_rows_q4)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(777)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    report = functools.partial(report_row, results)
    check = functools.partial(check_row, results)
    L, H, KV, D, cells, n_vis, li = 32, 32, 8, 128, 1025, 1024, 31
    scale = D ** -0.5

    # quantize_rows and quantize_rows_q4: random rows (f32 and bf16), a zero
    # row, and rows whose amax is the largest code (scale exactly 1) full of
    # .5 ties
    for qr, top in ((quantize_rows, 127), (quantize_rows_q4, 7)):
        x = torch.randn((8, 64, D), generator=gen, device=dev) * 3.0
        x[0, 0] = 0.0
        x[1, :, :] = torch.randint(-2 * top, 2 * top + 1, (64, D), generator=gen,
                                   device=dev) / 2.0
        x[1, :, 0] = float(top)
        for xx in (x, x.to(torch.bfloat16)):
            (gc, gs), (cc, cs) = qr(xx), qr(xx.cpu())
            same = torch.equal(gc.cpu(), cc) and torch.equal(gs.cpu().view(torch.int32),
                                                             cs.view(torch.int32))
            log(json.dumps({"phase": qr.__name__, "dtype": str(xx.dtype), "rows": gs.numel(),
                            "bit_equal_to_cpu": same}))
            if not same:
                raise AssertionError(f"the card's {qr.__name__} differs from the CPU's")

    kb = torch.randn((L, KV, cells, D), generator=gen, device=dev).to(torch.bfloat16)
    vb = torch.randn((L, KV, cells, D), generator=gen, device=dev).to(torch.bfloat16)
    k8, ks = quantize_rows(kb)
    v8, vs = quantize_rows(vb)
    k4, ks4 = quantize_rows_q4(kb)
    v4, vs4 = quantize_rows_q4(vb)
    caches = {"bf16": (kb, vb, None, None), "int8": (k8, v8, ks, vs),
              "int4": (k4, v4, ks4, vs4)}
    # decode: one token at position 1000 over cells 0..1000; prefill: 64
    # tokens at positions 960..1023, causal, cells 0..1023 (cell c holds
    # position c; the step's own tokens sit in the last cells)
    for nt, p0 in ((1, 1000), (64, 960)):
        q = torch.randn((nt, H, D), generator=gen, device=dev).to(torch.bfloat16)
        tpos = torch.arange(p0, p0 + nt, device=dev)
        cpos = torch.arange(n_vis, device=dev)
        mask = (cpos[None, :] <= tpos[:, None]).to(torch.int8)
        mask_cells = (cpos[None, :] < p0).to(torch.int8).expand(nt, n_vis).contiguous()
        mask_new = (tpos[None, :] <= tpos[:, None]).to(torch.int8)
        new_k = torch.randn((nt, KV, D), generator=gen, device=dev).to(torch.bfloat16)
        new_v = torch.randn((nt, KV, D), generator=gen, device=dev).to(torch.bfloat16)
        for kind, (k, v, ksc, vsc) in caches.items():
            bits = 4 if kind == "int4" else 8
            # a row + its scale
            elem = k.element_size() * k.shape[-1] + (4 if ksc is not None else 0)
            kf, vf = (k[li, :, :n_vis], v[li, :, :n_vis]) if ksc is None else (
                dequantize_cache_layer(c[li, :, :n_vis], sc[li, :, :n_vis], torch.bfloat16,
                                       bits=bits) for c, sc in ((k, ksc), (v, vsc)))
            kw = dict(scale=scale, k_scale=ksc, v_scale=vsc)
            # kernel 3 on this cache.  tol: bf16 outputs, f32 online-softmax
            # reassociation (~2 bf16 ulps), as for the bf16 rows above
            args = (q, k, v, mask)
            kw3 = dict(kw, layer=li, kv_bits=bits)
            vis = int(mask.any(dim=0).sum().item())
            report("flash", f"{kind} cache nt={nt} n_vis={n_vis} layer={li}",
                   err_of(flash.flash_attention(*args, **kw3),
                          flash.flash_attention_plain(*args, **kw3)), 1e-2,
                   time_ms(torch, lambda: flash.flash_attention(*args, **kw3), flush),
                   time_ms(torch, lambda: flash.flash_attention_plain(*args, **kw3), flush),
                   2 * nt * H * D * 2 + 2 * KV * vis * elem + nt * n_vis,
                   4 * D * int(mask.sum().item()) * H, "bf16",
                   time_ms(torch, sdpa_call(torch, q, kf, vf, mask, scale), flush))
            # kernel 9: the same step on the stacked path (the step's own
            # cells masked out of the cache, its rows merged fresh); it takes
            # no packed cache, as in JAX, and must refuse one
            sargs = (q, k, v, li, new_k, new_v, mask_cells, mask_new)
            if kind == "int4":
                try:
                    flash_stacked.flash_attention_stacked(*sargs, **kw)
                except ValueError as e:
                    log(json.dumps({"phase": "flash_stacked_refuses_int4", "nt": nt,
                                    "error": str(e)}))
                    continue
                raise AssertionError("kernel 9 took a packed int4 cache")
            vis = int(mask_cells.any(dim=0).sum().item())
            lib = sdpa_call(torch, q, torch.cat([kf, new_k.transpose(0, 1)], dim=1),
                            torch.cat([vf, new_v.transpose(0, 1)], dim=1),
                            torch.cat([mask_cells, mask_new], dim=1), scale)
            report("flash_stacked", f"{kind} cache nt={nt} n_vis={n_vis} layer={li}",
                   err_of(flash_stacked.flash_attention_stacked(*sargs, **kw),
                          flash_stacked.flash_attention_stacked_plain(*sargs, **kw)), 1e-2,
                   time_ms(torch, lambda: flash_stacked.flash_attention_stacked(*sargs, **kw),
                           flush),
                   time_ms(torch, lambda: flash_stacked.flash_attention_stacked_plain(*sargs,
                                                                                      **kw),
                           flush),
                   2 * nt * H * D * 2 + 2 * KV * vis * elem + 2 * nt * KV * D * 2
                   + nt * (n_vis + nt),
                   4 * D * int(mask_cells.sum().item() + mask_new.sum().item()) * H, "bf16",
                   time_ms(torch, lib, flush))
    # kernel 3 on each cache at 4, 8, 16, 32 and 256 rows a kv head (nt =
    # 1, 2, 4, 8, 64) over 512 cells with the first 96 visible
    # (the tokens last, causal), from nt = 2 with a row that sees nothing
    # (exactly 0) and a logit softcap; and two sequences of 32 tokens whose
    # live tiles (cells 0..63, 128..191) sit either side of a dead one.
    # tol as above
    cpos = torch.arange(512, device=dev)
    two = torch.zeros((64, 256), dtype=torch.int8, device=dev)
    for i in range(32):
        two[i, :32 + i + 1] = 1
        two[32 + i, 128:128 + 32 + i + 1] = 1
    for kind, (k, v, ksc, vsc) in caches.items():
        bits = 4 if kind == "int4" else 8
        for nt in (1, 2, 4, 8, 64, "two"):
            mask, cap = two, 0.0
            if nt != "two":
                tpos = torch.arange(96 - nt, 96, device=dev)
                mask = (cpos[None, :] <= tpos[:, None]).to(torch.int8)
                if nt >= 2:
                    mask[1], cap = 0, 30.0
            q = torch.randn((mask.shape[0], H, D), generator=gen, device=dev).to(torch.bfloat16)
            kw3 = dict(scale=scale, logit_softcap=cap, layer=li, k_scale=ksc, v_scale=vsc,
                       kv_bits=bits)
            got = flash.flash_attention(q, k, v, mask, **kw3)
            check("flash", f"{kind} cache nt={nt} n_vis={mask.shape[1]} softcap={cap}", got,
                  flash.flash_attention_plain(q, k, v, mask, **kw3), 1e-2)
            if nt != "two" and nt >= 2 and bool(got[1].any()):
                raise AssertionError(f"kernel 3 ({kind}, nt={nt}): a row that sees nothing "
                                     "gave nonzero output")
    # kernel 3 over 1024 cells where the wrapper gives each split several
    # tiles (nt = 64: 8 splits of 2 tiles; nt = 256: 2 splits of 8), under
    # sequences whose live tiles (token i sees the first 33 + i % 31 cells
    # of each) leave dead tiles first, last and between live ones inside a
    # split, and whole splits dead; nt = 256's last 8 tokens see nothing
    # (exactly 0).  tol as above
    for nt, seqs, want in ((64, ((1, 2, 5, 6), (0, 3, 8, 11, 15)), 8),
                           (256, ((0, 2, 5), (1, 3, 9, 12), (15,), (7, 8)), 2)):
        nsplit = flash.n_splits(KV, H // KV * nt, n_vis, flash.ROW_TILE)
        if nsplit != want:
            raise AssertionError(f"kernel 3 at nt={nt}: {nsplit} splits, expected {want}")
        gaps = torch.zeros((nt, n_vis), dtype=torch.int8)
        for i in range(nt):
            for tile in seqs[i * len(seqs) // nt]:
                gaps[i, 64 * tile:64 * tile + 33 + i % 31] = 1
        gaps[nt - 8 * (nt == 256):] = 0
        gaps = gaps.to(dev)
        q = torch.randn((nt, H, D), generator=gen, device=dev).to(torch.bfloat16)
        for kind, (k, v, ksc, vsc) in caches.items():
            kw3 = dict(scale=scale, layer=li, k_scale=ksc, v_scale=vsc,
                       kv_bits=4 if kind == "int4" else 8)
            got = flash.flash_attention(q, k, v, gaps, **kw3)
            check("flash", f"{kind} cache nt={nt} n_vis={n_vis} gaps, {nsplit} splits", got,
                  flash.flash_attention_plain(q, k, v, gaps, **kw3), 1e-2)
            if nt == 256 and bool(got[-8:].any()):
                raise AssertionError(f"kernel 3 ({kind}, nt=256): a row that sees nothing "
                                     "gave nonzero output")
    del caches, kb, vb, k8, v8, ks, vs, k4, v4, ks4, vs4
    repaired_flash_rows(torch, results, gen, flush)
    del flush
    torch.cuda.empty_cache()


def repaired_flash_rows(torch, results: dict, gen, flush) -> None:
    """Kernels 3 (three caches) and 9 (bf16, int8) where the tile's repairs
    reach: head dim 64 (tinyllama-1.1b's 32 query heads on 4 kv heads) over
    1024 visible cells, and head dim 128 over a ragged 1000 and 1001 (the
    cache one row longer, as a context's scratch cell makes it); decode (a
    token at the last visible position) and a 64-token prefill (the last
    64 cells, causal; kernel 9 with those cells masked out of the cache and
    its rows fresh), a row that sees nothing (exactly 0) in the prefill;
    timed beside SDPA.  tol as in kv_kernel_phase."""
    from llama_kotlin_tpu_torch.ops.cuda import flash, flash_stacked
    from llama_kotlin_tpu_torch.runtime.kv_cache import (dequantize_cache_layer, quantize_rows,
                                                         quantize_rows_q4)

    dev = torch.device("cuda")
    report = functools.partial(report_row, results)
    H, li = 32, 1
    for d, KV, n_vis in ((64, 4, 1024), (128, 8, 1000), (128, 8, 1001)):
        cells = n_vis + 1
        kb, vb = (torch.randn((2, KV, cells, d), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        (k8, ks), (v8, vs) = quantize_rows(kb), quantize_rows(vb)
        (k4, ks4), (v4, vs4) = quantize_rows_q4(kb), quantize_rows_q4(vb)
        caches = {"bf16": (kb, vb, None, None, 8), "int8": (k8, v8, ks, vs, 8),
                  "int4": (k4, v4, ks4, vs4, 4)}
        scale = d ** -0.5
        for nt in (1, 64):
            q = torch.randn((nt, H, d), generator=gen, device=dev).to(torch.bfloat16)
            tpos = torch.arange(n_vis - nt, n_vis, device=dev)
            cpos = torch.arange(n_vis, device=dev)
            mask = (cpos[None, :] <= tpos[:, None]).to(torch.int8)
            mask_cells = (cpos[None, :] < n_vis - nt).to(torch.int8).expand(nt, n_vis).clone()
            mask_new = (tpos[None, :] <= tpos[:, None]).to(torch.int8)
            if nt > 1:
                mask[1], mask_cells[1], mask_new[1] = 0, 0, 0
            new_k, new_v = (torch.randn((nt, KV, d), generator=gen, device=dev)
                            .to(torch.bfloat16) for _ in range(2))
            for kind, (k, v, ksc, vsc, bits) in caches.items():
                elem = k.element_size() * k.shape[-1] + (4 if ksc is not None else 0)
                kf, vf = (k[li], v[li]) if ksc is None else (
                    dequantize_cache_layer(c[li], sc[li], torch.bfloat16, bits=bits)
                    for c, sc in ((k, ksc), (v, vsc)))
                kw3 = dict(scale=scale, layer=li, k_scale=ksc, v_scale=vsc, kv_bits=bits)
                args = (q, k, v, mask)
                got = flash.flash_attention(*args, **kw3)
                vis = int(mask.any(dim=0).sum().item())
                report("flash", f"{kind} cache D={d} nt={nt} n_vis={n_vis}",
                       err_of(got, flash.flash_attention_plain(*args, **kw3)), 1e-2,
                       time_ms(torch, lambda: flash.flash_attention(*args, **kw3), flush),
                       time_ms(torch, lambda: flash.flash_attention_plain(*args, **kw3), flush),
                       2 * nt * H * d * 2 + 2 * KV * vis * elem + nt * n_vis,
                       4 * d * int(mask.sum().item()) * H, "bf16",
                       time_ms(torch, sdpa_call(torch, q, kf[:, :n_vis], vf[:, :n_vis], mask,
                                                scale), flush))
                if nt > 1 and bool(got[1].any()):
                    raise AssertionError(f"kernel 3 ({kind}, D={d}, n_vis={n_vis}): a row "
                                         "that sees nothing gave nonzero output")
                if kind == "int4":
                    continue
                kw = dict(scale=scale, k_scale=ksc, v_scale=vsc)
                sargs = (q, k, v, li, new_k, new_v, mask_cells, mask_new)
                got = flash_stacked.flash_attention_stacked(*sargs, **kw)
                vis = int(mask_cells.any(dim=0).sum().item())
                lib = sdpa_call(torch, q, torch.cat([kf[:, :n_vis], new_k.transpose(0, 1)], 1),
                                torch.cat([vf[:, :n_vis], new_v.transpose(0, 1)], 1),
                                torch.cat([mask_cells, mask_new], dim=1), scale)
                report("flash_stacked", f"{kind} cache D={d} nt={nt} n_vis={n_vis}",
                       err_of(got, flash_stacked.flash_attention_stacked_plain(*sargs, **kw)),
                       1e-2,
                       time_ms(torch, lambda: flash_stacked.flash_attention_stacked(*sargs,
                                                                                    **kw), flush),
                       time_ms(torch, lambda: flash_stacked.flash_attention_stacked_plain(
                           *sargs, **kw), flush),
                       2 * nt * H * d * 2 + 2 * KV * vis * elem + 2 * nt * KV * d * 2
                       + nt * (n_vis + nt),
                       4 * d * int(mask_cells.sum().item() + mask_new.sum().item()) * H, "bf16",
                       time_ms(torch, lib, flush))
                if nt > 1 and bool(got[1].any()):
                    raise AssertionError(f"kernel 9 ({kind}, D={d}, n_vis={n_vis}): a row "
                                         "that sees nothing gave nonzero output")
        del kb, vb, k8, v8, ks, vs, k4, v4, ks4, vs4, caches


@contextlib.contextmanager
def knobs(**env):
    """Set the JAX package's environment knobs (LKTPU_W4_FX,
    LKTPU_LAYER_FUSED) for a block, then restore the environment."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fx_layer_kernel_phase(torch, results: dict) -> None:
    """Kernel 8 (LKTPU_W4_FX=1) on sym and legacy W4 folds at the llama3-8B
    decode projections, b = 1, 9, 16 and 32 (o at every batch-row bucket),
    beside kernel 1 (prologue + GEMV) on the same inputs; kernel 10
    (LKTPU_LAYER_FUSED=1) on compact, sym and legacy folds at E = 4096,
    F = 14336, b = 1, 2, 4 and 8 (two launches bit-equal), beside the
    unfused route it replaces (kernel 1's o, the residual and norm glue,
    kernel 2) on the same inputs.  Each against its plain version."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.synthetic import synthetic_w4, synthetic_w4_device
    from llama_kotlin_tpu_torch.ops.cuda import qmm_w4, qmm_w4_ffn, qmm_w4_fx, qmm_w4_layer
    from llama_kotlin_tpu_torch.ops.norms import rms_norm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    report = functools.partial(report_row, results)
    check = functools.partial(check_row, results)
    rng = np.random.default_rng(2468)
    E, F = 4096, 14336
    shapes = {"qkv": (6144, E), "o": (E, E), "gate_up": (2 * F, E), "down": (E, F)}

    # kernel 8's in-launch quantizer against the prologue on rows that reach
    # its range guard and its rounding ties: random, zero, .5 ties at d = 1,
    # integers, tiny (1e-30) and huge (1e33, past the guard) scales,
    # subnormals (a subnormal d: the true division), spikes among small values
    wt = synthetic_w4(rng, E, E, device=dev, sym=True)
    x = torch.randn((8, E), generator=gen, device=dev) * 0.7
    x[1] = 0.0
    x[2] = torch.randint(-254, 255, (E,), generator=gen, device=dev) / 2.0
    x[2, ::256] = 127.0
    x[3] = torch.randint(-127, 128, (E,), generator=gen, device=dev).float()
    x[4] *= 1e-30
    x[5] *= 1e33
    x[6] *= 1e-40
    x[7] *= 1e-3
    x[7, ::64] = 50.0
    fx_codes_equal(torch, x, wt, qmm_w4_fx.qmm_w4_fx_matmul(x, wt))
    del wt

    # kernel 8 at b = 1 (the walk) and 9, 16, 32 (the tensor cores above T8:
    # two launches bit-equal, and the launch's own activation codes equal to
    # kernel 1's prologue's, bit for bit), beside kernel 1 (prologue + GEMV)
    # on the same inputs.  tol as kernel 1's: exact integer partials on both
    # sides, the f32 order of the scale products, the tile sums and the group
    # sum differ
    for flavor, kw in (("sym", dict(sym=True)), ("legacy", dict(compact=False))):
        for name, (n, k) in shapes.items():
            wt = synthetic_w4(rng, n, k, device=dev, **kw)
            assert wt.flavor == flavor
            bs = (1, 9, 16, 32) if name != "o" else (1, 2, 3, 5, 8, 9, 12, 16, 17, 24, 32)
            for b in bs:
                x = torch.randn((b, k), generator=gen, device=dev) * 0.7
                got = qmm_w4_fx.qmm_w4_fx_matmul(x, wt)
                shape = f"{flavor} {name} n={n} k={k} b={b}"
                if qmm_w4_fx.use_mma(b):
                    repeats(torch, "qmm_w4_fx", shape, got,
                            lambda: qmm_w4_fx.qmm_w4_fx_matmul(x, wt))
                    fx_codes_equal(torch, x, wt, got)
                if b not in (1, 9, 16, 32):  # the o projection at every batch-row bucket
                    check("qmm_w4_fx", shape, got, qmm_w4_fx.qmm_w4_fx_plain(x, wt), 1e-4)
                    continue
                report("qmm_w4_fx", shape, err_of(got, qmm_w4_fx.qmm_w4_fx_plain(x, wt)), 1e-4,
                       time_ms(torch, lambda: qmm_w4_fx.qmm_w4_fx_matmul(x, wt), flush),
                       time_ms(torch, lambda: qmm_w4_fx.qmm_w4_fx_plain(x, wt), flush),
                       b * k * 4 + nbytes(wt, w4_planes(wt)) + b * n * 4, 2 * b * n * k,
                       "int8", matmul_ms(torch, x, wt, flush))
                log(json.dumps({"phase": "qmm_w4_fx_vs_kernel1", "shape": f"{flavor} {name} b={b}",
                                "kernel1_ms": time_ms(torch, lambda: qmm_w4.qmm_w4_matmul(x, wt),
                                                      flush),
                                "kernel1_vs_fx_max_abs": (qmm_w4.qmm_w4_matmul(x, wt) - got)
                                .abs().max().item()}))
            del wt

    # kernel 10.  tol as kernel 2's (5e-3 of max|h3|): h3 is bf16 and the
    # norm's f32 sum runs in another order than the plain version's, so a
    # last-bit difference of r can move one activation code of the FFN
    eps = 1e-5
    for flavor in ("compact", "sym", "legacy"):
        if flavor == "compact":
            ws = [synthetic_w4_device(gen, n, k, zero_mean=False, device=dev)
                  for n, k in ((E, E), (2 * F, E), (E, F))]
        else:
            kw = dict(sym=True) if flavor == "sym" else dict(compact=False)
            ws = [synthetic_w4(rng, n, k, device=dev, **kw)
                  for n, k in ((E, E), (2 * F, E), (E, F))]
        wo, gu, dn = ws
        assert {w.flavor for w in ws} == {flavor}
        nw = 1.0 + 0.1 * torch.randn(E, generator=gen, device=dev)
        for b in (1, 2, 4, 8):
            attn = (torch.randn((b, E), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
            h = (torch.randn((b, E), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
            args = (attn, h, wo, gu, dn, nw)
            if not qmm_w4_layer.layer_eligible(*args[:5]):
                raise AssertionError(f"kernel 10 refuses the {flavor} layer")
            fused = lambda: qmm_w4_layer.qmm_w4_layer_matmul(*args, eps=eps)
            repeats(torch, "qmm_w4_layer", f"{flavor} b={b}", fused(), fused)

            def unfused():  # models/llama.py's route with the knob off
                h2 = h + qmm_w4.qmm_w4_matmul(attn, wo).to(h.dtype)
                x = rms_norm(h2, nw, eps)
                return h2 + qmm_w4_ffn.qmm_w4_ffn_matmul(x, gu, dn).to(h.dtype)

            got = fused()
            unfused_ms = time_ms(torch, unfused, flush)
            report("qmm_w4_layer", f"{flavor} E={E} F={F} b={b}",
                   err_of(got, qmm_w4_layer.qmm_w4_layer_plain(*args, eps, "silu")), 5e-3,
                   time_ms(torch, fused, flush),
                   time_ms(torch, lambda: qmm_w4_layer.qmm_w4_layer_plain(*args, eps, "silu"),
                           flush),
                   4 * b * E * 2 + E * 4 + sum(nbytes(w, w4_planes(w)) for w in ws),
                   2 * b * (E * E + 3 * F * E), "int8", None)
            results["qmm_w4_layer"][-1]["unfused_ms"] = unfused_ms
            log(json.dumps({"phase": "qmm_w4_layer_vs_unfused", "shape": f"{flavor} b={b}",
                            "unfused_ms": unfused_ms,
                            "unfused_vs_fused_rel": err_of(got, unfused())["rel"]}))
        del ws, wo, gu, dn
    del flush
    torch.cuda.empty_cache()


def streamed_bytes(params) -> int:
    """Weight bytes a decode step streams on the default route: every
    matrix but the embedding (kept on the host path only through its
    gathered rows), in the port's layout as its decode kernel reads it —
    compact W4: codes + compact planes; sym W4: codes + f32 s_eff (kernels
    1, 2, 8 and 10 form m_adj = 8 s_eff); other W4 and W4X: codes + f32
    s_eff and m_adj; W8: codes + s_eff (+ m_eff); Q8F: codes + scales."""
    out = params.get("output") if params.get("output") is not None else params["tok_embd"]
    return nbytes(out, w4_planes(out)) + sum(
        nbytes(v, w4_planes(v)) for lp in params["layers"] for v in lp.values()
        if hasattr(v, "codes"))


def mod_name(m) -> str:
    return m.__name__.rsplit(".", 1)[1]


def serve(torch, cfg, params, mods, phase: str, n_prompt: int = 64, n_new: int = 32,
          never=(), n_cells: int = 1024, **ctx_kw):
    """3 requests through LlamaContext(n_cells, **ctx_kw), every cell
    visible at the decode steps: prefill n_prompt tokens,
    then n_new greedy tokens (the first from the prefill).  The launch
    counts of `mods` (which must all launch) and `never` (which must not)
    are set to 0 first; returns (the counts of `mods` just after the run,
    the context), and logs each request's launches per prefill and per
    decode token.  Where kernel 1 or 2 is among `mods`, its tensor-core
    launches are counted too ("qmm_w4_mma", "qmm_w4_ffn_mma": kernel 2's
    calls on kernel 1's tile): in each request's prefill and decode steps
    they must be all of its launches where the rows there are above its
    threshold (T1, T2), and none where they are not."""
    import numpy as np

    from llama_kotlin_tpu_torch.ops.cuda import qmm_w4, qmm_w4_ffn
    from llama_kotlin_tpu_torch.runtime.batch import Batch
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.runtime.generate import generate_loop

    ctx = LlamaContext(cfg, params, n_cells=n_cells, buckets=(8, 16, 32, 64, 128, 256, 512),
                       device="cuda", **ctx_kw)
    # (kernel, its tensor-core counter, rows a prefill launch takes, rows a
    # decode launch takes): kernel 1 is reached by a prompt above its rows
    # only with its last row (the lm_head), kernel 2 not at all
    branches = [(qmm_w4, mma_counter(qmm_w4),
                 n_prompt if n_prompt <= qmm_w4.MAX_ROWS else 1, 1)] if qmm_w4 in mods else []
    if qmm_w4_ffn in mods:
        branches.append((qmm_w4_ffn, mma_counter(qmm_w4_ffn), n_prompt, 1))
    counted = mods + tuple(c for _, c, _, _ in branches) + never
    for m in counted:
        m.LAUNCHES = 0
    snap = lambda: {mod_name(m): m.LAUNCHES for m in counted}
    outs = []
    for r in range(3):
        # request 2 replays request 0's prompt: greedy tokens must repeat
        seed = 0 if r == 2 else r
        prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, n_prompt).astype(np.int32)
        ctx.clear()
        torch.cuda.synchronize()
        c0 = snap()
        t0 = time.perf_counter()
        assert ctx.decode(Batch.single(prompt)) == 0
        logits = ctx.logits_device()
        first = torch.argmax(logits[:1], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        ttft_ms = (time.perf_counter() - t0) * 1e3
        c1 = snap()
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
        c2 = snap()
        if not bool(torch.isfinite(last).all()) or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError("bad decode output")
        outs.append(toks)
        for m, c, rp, rd in branches:
            k, kc = mod_name(m), mod_name(c)
            got = (c1[kc] - c0[kc], c2[kc] - c1[kc])
            want = ((c1[k] - c0[k]) * m.use_mma(rp), (c2[k] - c1[k]) * m.use_mma(rd))
            if got != want:
                raise AssertionError(f"{phase}: {kc} launches {got} (prefill, decode), "
                                     f"expected {want}")
        log(json.dumps({"phase": phase, "context": dict(ctx_kw, n_cells=n_cells), "request": r,
                        "prompt_tokens": n_prompt,
                        "ttft_ms": ttft_ms, "decode_tokens": n_new - 1,
                        "decode_tok_s": (n_new - 1) / dt,
                        "decode_ms_per_tok": dt / (n_new - 1) * 1e3,
                        "launches_per_prefill": {k: c1[k] - c0[k] for k in c0},
                        "launches_per_decode_token": {k: (c2[k] - c1[k]) / (n_new - 1)
                                                      for k in c0},
                        "tokens": toks}))
    if outs[2] != outs[0]:
        raise AssertionError("greedy tokens differ between identical requests")
    if outs[1] == outs[0]:
        raise AssertionError("two different prompts gave the same greedy tokens: "
                             "the token checks would carry no signal")
    counts = snap()
    log(json.dumps({"phase": phase, "launches": counts}))
    if not all(counts[mod_name(m)] for m in mods):
        raise AssertionError(f"a kernel of the path was never launched: {counts}")
    if any(counts.pop(mod_name(m)) for m in never):
        raise AssertionError(f"a kernel off the path was launched: {counts}")
    return counts, ctx


def serve_32(torch, cfg, params, label: str, mods, never, per_token: dict, mma,
             mma_per_prefill: int, **ctx_kw) -> dict:
    """3 requests of a 32-token prompt and N_NEW_32 greedy tokens through
    serve(): the prefill's 32 rows take the decode kernels, so every kernel
    of `mods` launches per_token[name] times in each prefill and each
    decode step, and the tensor-core branch counter `mma` mma_per_prefill
    times in each prefill (its rows above the threshold) and never at a
    decode step (one row walks).  A profiled 32-token prefill follows.
    Returns the counts."""
    counts, ctx = serve(torch, cfg, params, mods + (mma,), label, n_prompt=32, n_new=N_NEW_32,
                        never=never, **ctx_kw)
    want = {name: 3 * N_NEW_32 * c for name, c in per_token.items()}
    want[mod_name(mma)] = 3 * mma_per_prefill
    for k in ("qmm_w4", "qmm_w4_ffn"):  # 32-row prefills take kernel 1's tile
        if k in per_token:
            want[f"{k}_mma"] = 3 * per_token[k]
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    profile_decode(torch, ctx, cfg, label, n_prompt=32)
    del ctx
    torch.cuda.empty_cache()
    return counts


def serving_phase(torch, n_layer: int = 32) -> dict:
    """3 requests on the full llama3-8B W4A8 model in each configuration;
    returns {path: launch counts}."""
    from llama_kotlin_tpu_torch.models.synthetic import preset_config, synthetic_params_device
    from llama_kotlin_tpu_torch.ops.cuda import flash, qmm, qmm_w4, qmm_w4_ffn

    cfg = preset_config("llama3-8b", n_layer=n_layer)
    t0 = time.perf_counter()
    params = synthetic_params_device(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    w_bytes = streamed_bytes(params)
    log(json.dumps({"phase": "serving", "model": "llama3-8b", "n_layer": n_layer,
                    "weights_build_s": build_s, "w_bytes_per_tok": w_bytes,
                    "w_floor_ms_per_tok": w_bytes / HBM_BYTES_S * 1e3}))
    counts, ctx = serve(torch, cfg, params, (qmm_w4, qmm_w4_ffn, flash, qmm), "serving",
                        prefer_unrolled=True)
    profile_decode(torch, ctx, cfg, "serving")
    del ctx
    by_path = {"serving": counts}
    cut = preset_config("llama3-8b", n_layer=min(n_layer, EARLIER_LAYERS))
    first = dict(params, layers=params["layers"][:cut.n_layer])  # the same tensors
    by_path.update(kv_serving(torch, cut, first, "serving", (qmm_w4, qmm_w4_ffn, qmm)))
    by_path.update(fused_serving(torch, cut, first))
    del params, first
    torch.cuda.empty_cache()
    return by_path


def fused_serving(torch, cfg, params) -> dict:
    """The W4A8 model with LKTPU_LAYER_FUSED=1, stacked (the default) and
    unrolled, bf16 cache: kernel 10 takes the post-attention half of every
    layer at every decode step (n_layer launches a step) and never at the
    64-row prefill; kernel 1 the decode qkv and lm_head rows and the
    prefill's lm_head row; kernel 4 the prefill's projections; kernels 2
    and 8 never.  Returns {path: launch counts}."""
    from llama_kotlin_tpu_torch.ops.cuda import (flash, flash_stacked, qmm, qmm_w4, qmm_w4_ffn,
                                                 qmm_w4_fx, qmm_w4_layer)

    t0 = time.perf_counter()
    L, by_path = cfg.n_layer, {}
    want = {"qmm_w4_layer": 3 * 31 * L, "qmm_w4": 3 * (1 + 31 * (L + 1)), "qmm_w4_mma": 0,
            "qmm": 3 * 4 * L}
    for path, attn, kw in (("serving_fused_stacked_bf16", flash_stacked, {}),
                           ("serving_fused_unrolled_bf16", flash, dict(prefer_unrolled=True))):
        other = flash if attn is flash_stacked else flash_stacked
        with knobs(LKTPU_LAYER_FUSED="1"):
            counts, ctx = serve(torch, cfg, params, (qmm_w4_layer, qmm_w4, qmm, attn), path,
                                never=(qmm_w4_ffn, qmm_w4_fx, other), **kw)
            expect = dict(want, **{mod_name(attn): 3 * 32 * L})
            if counts != expect or ("layers_stacked" in ctx.params) != (attn is flash_stacked):
                raise AssertionError(f"{path}: launches {counts}, expected {expect}")
            profile_decode(torch, ctx, cfg, path)
        by_path[path] = counts
        del ctx
        torch.cuda.empty_cache()
    log(json.dumps({"phase": "timing", "function": "fused_serving",
                    "seconds": time.perf_counter() - t0}))
    return by_path


def tinyllama_phase(torch) -> dict:
    """The JAX package's tinyllama-1.1b preset at full width and depth (22
    layers; head dim 64: 32 query heads on 4 kv heads; F = 5632, whose down
    fold pads K to 6144, so kernel 2 declines the FFN as JAX's does and
    kernel 1 takes gate|up and down at decode), synthetic W4A8 weights (seed
    2), 3 requests each: unrolled bf16 (kernel 3), stacked bf16 and q8_0
    (kernel 9), unrolled q4_0 (kernel 3's int4 branch), then stacked and
    unrolled contexts of 1000 cells (n_vis = 1000 at every step: a ragged
    last tile on kernels 9 and 3), each with exact launch counts: per
    request kernel 4 4 a layer at the 64-token prefill, kernel 1 its
    lm_head row and 4 a layer + 1 a decode step, the attention kernel once
    a layer and step; kernel 2 and the other attention kernel never.
    Returns {path: launch counts}."""
    from llama_kotlin_tpu_torch.models.synthetic import preset_config, synthetic_params_device
    from llama_kotlin_tpu_torch.ops.cuda import flash, flash_stacked, qmm, qmm_w4, qmm_w4_ffn

    t0 = time.perf_counter()
    cfg = preset_config("tinyllama-1.1b")
    params = synthetic_params_device(cfg, seed=2, device="cuda")
    L, by_path = cfg.n_layer, {}
    log(json.dumps({"phase": "tinyllama", "n_layer": L, "head_dim": cfg.head_dim,
                    "ffn_down_k_pad": params["layers"][0]["ffn_down"].k_pad,
                    "w_bytes_per_tok": streamed_bytes(params)}))
    steps = 3 * 32 * L  # a prefill and 31 decode steps a request, one launch a layer
    want = {"qmm_w4": 3 * (1 + 31 * (4 * L + 1)), "qmm_w4_mma": 0, "qmm": 3 * 4 * L}
    for path, attn, kw in (
            ("tinyllama_unrolled_bf16", flash, dict(prefer_unrolled=True)),
            ("tinyllama_stacked_bf16", flash_stacked, {}),
            ("tinyllama_stacked_q8_0", flash_stacked, dict(kv_quant="q8_0")),
            ("tinyllama_unrolled_q4_0", flash, dict(kv_quant="q4_0", prefer_unrolled=True)),
            ("tinyllama_stacked_bf16_1000", flash_stacked, dict(n_cells=1000)),
            ("tinyllama_unrolled_bf16_1000", flash, dict(n_cells=1000, prefer_unrolled=True))):
        other = flash if attn is flash_stacked else flash_stacked
        flash.LAUNCHES_INT4 = 0
        counts, ctx = serve(torch, cfg, params, (qmm_w4, qmm, attn), path,
                            never=(qmm_w4_ffn, other), **kw)
        expect = dict(want, **{mod_name(attn): steps})
        int4 = flash.LAUNCHES_INT4 if kw.get("kv_quant") == "q4_0" else steps
        if (counts != expect or int4 != steps
                or ("layers_stacked" in ctx.params) != (attn is flash_stacked)):
            raise AssertionError(f"{path}: launches {counts} (int4 {int4}), expected {expect}")
        if path in ("tinyllama_unrolled_bf16", "tinyllama_stacked_bf16"):
            profile_decode(torch, ctx, cfg, path)
        by_path[path] = counts
        del ctx
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "timing", "function": "tinyllama_serving",
                    "seconds": time.perf_counter() - t0}))
    return by_path


def q4_0_gguf_phase(torch, tmpdir: Path) -> dict:
    """A full-width llama3-8B Q4_0 file of EARLIER_LAYERS layers (every
    layer matrix and token_embd Q4_0, output Q6_K; random wire blocks, seed
    9) in the w4 mode on the default (stacked) context, bf16 cache, 3
    requests each:
    by default (kernel 1 on the sym folds' qkv and o, kernel 2 the FFN; then
    the file loaded with fuse=False, q4_0_unfused_serving);
    with LKTPU_W4_FX=1 (kernel 8 in kernel 1's place: 2 n_layer launches
    a decode step); with LKTPU_W4_FX=1 and LKTPU_LAYER_FUSED=1 (kernel 8
    on qkv, kernel 10 on the rest of the layer: n_layer each a step).  The
    lm_head is kernel 5's (Q6_K -> W8).  Returns {path: launch counts}."""
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.models.synthetic import preset_config, synthetic_gguf
    from llama_kotlin_tpu_torch.ops.cuda import (flash, flash_stacked, qmm, qmm_w4, qmm_w4_ffn,
                                                 qmm_w4_fx, qmm_w4_layer, qmm_w8)
    from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType

    path = tmpdir / "llama3-8b-q4_0.gguf"
    t0 = time.perf_counter()
    size = synthetic_gguf(path, preset_config("llama3-8b", n_layer=EARLIER_LAYERS), seed=9,
                          matrix_type=GGMLQuantType.Q4_0)
    log(json.dumps({"phase": "gguf_q4_0", "file_bytes": size,
                    "write_s": time.perf_counter() - t0}))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, params, f = load_gguf_model(path, fast_mode="w4", fuse=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    f.close()
    w_bytes = streamed_bytes(params)
    layouts = sorted({(key, getattr(v, "flavor", None)) for lp in params["layers"]
                      for key, v in lp.items() if hasattr(v, "codes")})
    log(json.dumps({"phase": "gguf_q4_0_w4", "n_layer": cfg.n_layer, "load_s": load_s,
                    "w_bytes_per_tok": w_bytes, "w_floor_ms_per_tok": w_bytes / HBM_BYTES_S * 1e3,
                    "device_bytes": torch.cuda.memory_allocated(), "layouts": layouts,
                    "output": params["output"].flavor}))
    L, steps = cfg.n_layer, 3 * 31
    base = {"qmm_w8": 3 * 32, "qmm": 3 * 4 * L, "flash_stacked": 3 * 32 * L}
    runs = (("gguf_q4_0_w4", {}, dict(qmm_w4=steps * 2 * L, qmm_w4_mma=0,
                                      qmm_w4_ffn=steps * L, qmm_w4_ffn_mma=0)),
            ("gguf_q4_0_w4_fx", dict(LKTPU_W4_FX="1"),
             dict(qmm_w4_fx=steps * 2 * L, qmm_w4_ffn=steps * L, qmm_w4_ffn_mma=0)),
            ("gguf_q4_0_w4_fx_fused", dict(LKTPU_W4_FX="1", LKTPU_LAYER_FUSED="1"),
             dict(qmm_w4_fx=steps * L, qmm_w4_layer=steps * L)))
    all_mods = (qmm_w4, qmm_w4_ffn, qmm_w4_fx, qmm_w4_layer)
    by_path = {}
    for label, env, launched in runs:
        mods = tuple(m for m in all_mods if launched.get(mod_name(m))) + (qmm_w8, qmm,
                                                                            flash_stacked)
        never = tuple(m for m in all_mods if mod_name(m) not in launched) + (flash,)
        with knobs(**env):
            counts, ctx = serve(torch, cfg, params, mods, label, never=never)
            expect = dict(base, **launched)
            if counts != expect or "layers_stacked" not in ctx.params:
                raise AssertionError(f"{label}: launches {counts}, expected {expect}, stacked")
            profile_decode(torch, ctx, cfg, label)
            by_path[label] = counts
            del ctx
            torch.cuda.empty_cache()
            if label == "gguf_q4_0_w4_fx":
                # a 32-token prompt: kernel 8 takes qkv and o at 32 rows on its
                # tensor cores (2 a layer a prefill), kernel 2 the FFN, kernel 5
                # the lm_head's last row; no kernel 4
                by_path[f"{label}_32"] = serve_32(
                    torch, cfg, params, f"{label}_32", (qmm_w4_fx, qmm_w4_ffn, qmm_w8,
                                                        flash_stacked), never + (qmm,),
                    dict(qmm_w4_fx=2 * L, qmm_w4_ffn=L, qmm_w8=1, flash_stacked=L),
                    mma_counter(qmm_w4_fx), 2 * L)
    del params
    torch.cuda.empty_cache()
    by_path["gguf_q4_0_w4_unfused"] = q4_0_unfused_serving(torch, path)
    path.unlink()
    return by_path


def q4_0_unfused_serving(torch, path: Path) -> dict:
    """The same Q4_0 file loaded with fuse=False (both loaders' default):
    every layer keeps wq, wk, wv and ffn_gate, ffn_up apart, and stacks.
    Per request kernel 2 takes every decode step's FFN on its up= branch
    (gate and up read from their own folds; n_layer launches a step, the
    cooperative route), kernel 1 q, k, v and o (4 n_layer a step), kernel 4
    the 64-token prefill's 7 projections a layer, kernel 5 the lm_head
    (the prefill's last row and every step), kernel 9 the attention."""
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.ops.cuda import (flash, flash_stacked, qmm, qmm_w4, qmm_w4_ffn,
                                                 qmm_w4_fx, qmm_w4_layer, qmm_w8)

    cfg, params, f = load_gguf_model(path, fast_mode="w4", fuse=False)
    f.close()
    lp = params["layers"][0]
    if "ffn_gateup_fused" in lp or "wqkv_fused" in lp:
        raise AssertionError("fuse=False fused a layer's projections")
    L, steps = cfg.n_layer, 3 * 31
    counts, ctx = serve(torch, cfg, params, (qmm_w4, qmm_w4_ffn, qmm, qmm_w8, flash_stacked),
                        "gguf_q4_0_w4_unfused", never=(qmm_w4_fx, qmm_w4_layer, flash))
    expect = dict(qmm_w4=steps * 4 * L, qmm_w4_mma=0, qmm_w4_ffn=steps * L, qmm_w4_ffn_mma=0,
                  qmm=3 * 7 * L, qmm_w8=3 * 32, flash_stacked=3 * 32 * L)
    if counts != expect or "layers_stacked" not in ctx.params:
        raise AssertionError(f"gguf_q4_0_w4_unfused: launches {counts}, expected {expect}, "
                             "stacked")
    profile_decode(torch, ctx, cfg, "gguf_q4_0_w4_unfused")
    del ctx, params
    torch.cuda.empty_cache()
    return counts


def w4x_serving_phase(torch, n_layer: int = 32) -> dict:
    """3 requests on the full llama3-8B W4X model (every matrix a precise
    fold of the serving phase's draws) on the default context, which
    stacks it, with a bf16 cache.  Kernel 7 takes every decode projection
    (4 a layer and the lm_head: 4 n_layer + 1 launches per decode token)
    and the prefill's lm_head row, kernel 4 the prefill's projections,
    kernel 9 the attention; kernels 1, 2 and 3 never launch.  Then 3
    requests of a 32-token prompt: kernel 7 takes the prefill's
    projections as well, and kernel 4 never launches."""
    from llama_kotlin_tpu_torch.models.synthetic import preset_config, synthetic_params_device
    from llama_kotlin_tpu_torch.ops.cuda import (flash, flash_stacked, qmm, qmm_w4, qmm_w4_ffn,
                                                 qmm_w4x)

    cfg = preset_config("llama3-8b", n_layer=n_layer)
    t0 = time.perf_counter()
    params = synthetic_params_device(cfg, seed=0, device="cuda", mode="w4x")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    w_bytes = streamed_bytes(params)
    log(json.dumps({"phase": "serving_w4x", "model": "llama3-8b", "n_layer": n_layer,
                    "weights_build_s": build_s, "w_bytes_per_tok": w_bytes,
                    "w_floor_ms_per_tok": w_bytes / HBM_BYTES_S * 1e3}))
    counts, ctx = serve(torch, cfg, params, (qmm_w4x, qmm, flash_stacked), "serving_w4x",
                        never=(qmm_w4, qmm_w4_ffn, flash))
    if "layers_stacked" not in ctx.params:
        raise AssertionError("the W4X model did not stack")
    # 3 requests of one 64-row prefill and 31 decode steps
    want = {"qmm_w4x": 3 * (1 + 31 * (4 * n_layer + 1)), "qmm": 3 * 4 * n_layer,
            "flash_stacked": 3 * 32 * n_layer}
    if counts != want:
        raise AssertionError(f"serving_w4x: launches {counts}, expected {want}")
    profile_decode(torch, ctx, cfg, "serving_w4x")
    del ctx
    # a 32-token prompt: kernel 7 takes every prefill projection too (its
    # tensor-core GEMM above the row threshold) and kernel 4 never launches
    counts32, ctx = serve(torch, cfg, params, (qmm_w4x, flash_stacked), "serving_w4x_32",
                          n_prompt=32, never=(qmm, qmm_w4, qmm_w4_ffn, flash))
    want32 = {"qmm_w4x": 3 * 32 * (4 * n_layer + 1), "flash_stacked": 3 * 32 * n_layer}
    if counts32 != want32:
        raise AssertionError(f"serving_w4x_32: launches {counts32}, expected {want32}")
    profile_decode(torch, ctx, cfg, "serving_w4x_32", n_prompt=32)
    del ctx, params
    torch.cuda.empty_cache()
    return {"serving_w4x": counts, "serving_w4x_32": counts32}


def kv_serving(torch, cfg, params, label: str, mods) -> dict:
    """The same params served in the configurations the int8 KV cache and
    the stacked path add: the default (stacked) context with a bf16 and
    with a q8_0 cache, and the unrolled one with a q8_0 cache.  A stacked
    run must launch kernel 9 once per layer and step and kernel 3 never;
    the unrolled q8_0 run must launch kernel 3's int8 branch.  Then the
    q4_0 cache (q4_kv_serving).  Returns {path: launch counts}."""
    from llama_kotlin_tpu_torch.ops.cuda import flash, flash_stacked

    t0 = time.perf_counter()
    by_path = {}
    for path, kw in ((f"{label}_stacked_bf16", {}),
                     (f"{label}_stacked_q8_0", dict(kv_quant="q8_0")),
                     (f"{label}_unrolled_q8_0", dict(kv_quant="q8_0", prefer_unrolled=True))):
        stacked = not kw.get("prefer_unrolled")
        flash.LAUNCHES_INT8 = 0
        counts, ctx = serve(torch, cfg, params, mods + ((flash_stacked,) if stacked else (flash,)),
                            path, never=(flash,) if stacked else (flash_stacked,), **kw)
        if stacked != ("layers_stacked" in ctx.params):
            raise AssertionError(f"{path}: the context did not take the expected path")
        # 3 requests of one prefill and 31 decode steps, each step one launch a layer
        if stacked and counts["flash_stacked"] != 3 * 32 * cfg.n_layer:
            raise AssertionError(f"{path}: kernel 9 launched {counts['flash_stacked']} times")
        if not stacked and not flash.LAUNCHES_INT8:
            raise AssertionError(f"{path}: kernel 3's int8 branch was never launched")
        log(json.dumps({"phase": path, "flash_int8_launches": flash.LAUNCHES_INT8}))
        profile_decode(torch, ctx, cfg, path)
        by_path[path] = counts
        del ctx
        torch.cuda.empty_cache()
    log(json.dumps({"phase": "timing", "function": "kv_serving",
                    "seconds": time.perf_counter() - t0}))
    by_path.update(q4_kv_serving(torch, cfg, params, label, mods))
    return by_path


def q4_kv_serving(torch, cfg, params, label: str, mods, profile: bool = True) -> dict:
    """The same params with the packed int4 (q4_0) cache: unrolled, kernel
    3's int4 branch once a layer and step (3 requests of a prefill and 31
    decode steps: 96 n_layer launches) and kernel 9 never; stacked (the
    default context), the plain route JAX takes there
    (models/llama.py::attend_stacked_q4, counted as often) and neither
    kernel 3 nor kernel 9.  Returns {path: launch counts}."""
    from llama_kotlin_tpu_torch.models import llama
    from llama_kotlin_tpu_torch.ops.cuda import flash, flash_stacked

    t0 = time.perf_counter()
    by_path, steps = {}, 3 * 32 * cfg.n_layer
    flash.LAUNCHES_INT4 = 0
    path = f"{label}_unrolled_q4_0"
    counts, ctx = serve(torch, cfg, params, mods + (flash,), path, never=(flash_stacked,),
                        kv_quant="q4_0", prefer_unrolled=True)
    log(json.dumps({"phase": path, "flash_int4_launches": flash.LAUNCHES_INT4}))
    if flash.LAUNCHES_INT4 != steps or counts["flash"] != steps or "layers" not in ctx.params:
        raise AssertionError(f"{path}: kernel 3's int4 branch launched {flash.LAUNCHES_INT4} "
                             f"times of {counts['flash']}, expected {steps}, unrolled")
    if profile:
        profile_decode(torch, ctx, cfg, path)
    by_path[path] = counts
    del ctx
    if "layers" in params and llama.can_stack(params, cfg):
        path = f"{label}_stacked_q4_0"
        route = CallCounter(llama, "attend_stacked_q4")
        try:
            counts, ctx = serve(torch, cfg, params, mods + (route,), path,
                                never=(flash, flash_stacked), kv_quant="q4_0")
        finally:
            route.close()
        log(json.dumps({"phase": path, "attention_route": route.__name__,
                        "route_calls": counts["attend_stacked_q4"]}))
        if counts["attend_stacked_q4"] != steps or "layers_stacked" not in ctx.params:
            raise AssertionError(f"{path}: {counts}, expected {steps} stacked route calls")
        if profile:
            profile_decode(torch, ctx, cfg, path)
        by_path[path] = counts
        del ctx
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "timing", "function": "q4_kv_serving",
                    "seconds": time.perf_counter() - t0}))
    return by_path


def gguf_phase(torch, tmpdir: Path) -> dict:
    """A full-width 32-layer llama3-8B file with the Q4_K_M type mix, loaded
    by load_gguf_model in each fast mode on the card, serves 3 requests on
    the unrolled path (in the w4x mode the default context, which keeps its
    mixed layers unrolled as in JAX); the int8-mode params again on the
    default (stacked) context with a q8_0 cache.  Returns {path: launch
    counts}."""
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.models.synthetic import preset_config, synthetic_gguf
    from llama_kotlin_tpu_torch.ops.cuda import (flash, flash_stacked, qmm, qmm_int8, qmm_w4,
                                                 qmm_w4_ffn, qmm_w4x, qmm_w8)

    path = tmpdir / "llama3-8b-q4_k_m.gguf"
    t0 = time.perf_counter()
    size = synthetic_gguf(path, preset_config("llama3-8b"), seed=7)
    log(json.dumps({"phase": "gguf", "file_bytes": size,
                    "write_s": time.perf_counter() - t0}))
    precise = w8_precise()
    # mode: (kernels that must launch, kernels that must not, context options)
    mode_mods = {"w4": ((qmm_w4, qmm_w4_ffn, flash, qmm, qmm_w8), (precise, qmm_w4x),
                        dict(prefer_unrolled=True)),
                 "w4x": ((qmm_w4x, precise, flash, qmm), (qmm_w4, qmm_w4_ffn, qmm_w8), {}),
                 "int8": ((flash, qmm_int8, mma_counter(qmm_int8)), (),
                          dict(prefer_unrolled=True))}
    counts = {}
    for mode, (mods, never, ctx_kw) in mode_mods.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        f.close()
        w_bytes = streamed_bytes(params)
        layouts = sorted({(key, getattr(v, "flavor", None)) for lp in params["layers"]
                          for key, v in lp.items() if hasattr(v, "codes")})
        log(json.dumps({"phase": f"gguf_{mode}", "n_layer": cfg.n_layer, "load_s": load_s,
                        "w_bytes_per_tok": w_bytes,
                        "w_floor_ms_per_tok": w_bytes / HBM_BYTES_S * 1e3,
                        "device_bytes": torch.cuda.memory_allocated(),
                        "layouts": layouts}))
        qmm.LAUNCHES_W8 = 0
        counts[mode], ctx = serve(torch, cfg, params, mods, f"gguf_{mode}", never=never,
                                  **ctx_kw)
        if mode in ("w4", "w4x"):
            log(json.dumps({"phase": f"gguf_{mode}",
                            "qmm_8bit_branch_launches": qmm.LAUNCHES_W8}))
            if not qmm.LAUNCHES_W8:
                raise AssertionError("kernel 4's 8-bit branch was never launched")
        if mode == "w4":
            # the CLI's -ctk q4_0 on this file: its mixed layers stay unrolled
            for q4_path, c in q4_kv_serving(torch, cfg, params, "gguf_w4", mods,
                                            profile=False).items():
                counts[q4_path.removeprefix("gguf_")] = c
        if mode == "w4x":
            # per request: the prefill's 64 rows take kernel 4 in every
            # layer (4 projections in the 16 uniform layers, 6 in the 16
            # with split q/k/v), its lm_head row kernel 5's dual-plane
            # branch; a decode token kernel 7 4 times a layer and kernel 5
            # (attn_v, ffn_down, lm_head) 2 times in each mixed layer + 1
            want = {"qmm_w4x": 3 * 31 * 128, "qmm_w8_precise": 3 * (1 + 31 * 33),
                    "flash": 3 * 32 * 32, "qmm": 3 * 160}
            if "layers" not in ctx.params or counts[mode] != want or qmm.LAUNCHES_W8 != 96:
                raise AssertionError(f"gguf_w4x: launches {counts[mode]} (kernel 4 8-bit "
                                     f"{qmm.LAUNCHES_W8}), expected {want} (96) unrolled")
        profile_decode(torch, ctx, cfg, f"gguf_{mode}")
        del ctx
        torch.cuda.empty_cache()
        if mode in ("w4", "w4x"):
            # a 32-token prompt: kernel 5 takes the 16 mixed layers' attn_v and
            # ffn_down at 32 rows on its tensor cores (32 launches a prefill)
            # and the lm_head's last row (its walk); no kernel 4.  A token
            # (the prefill's too): w4 kernel 1 96 times, kernel 2 16 (uniform
            # layers), kernel 5 33; w4x kernel 7 128, kernel 5's precise
            # branch 33
            per = ({"qmm_w4": 96, "qmm_w4_ffn": 16, "qmm_w8": 33} if mode == "w4"
                   else {"qmm_w4x": 128, "qmm_w8_precise": 33})
            counts[f"{mode}_32"] = serve_32(
                torch, cfg, params, f"gguf_{mode}_32",
                tuple(m for m in mods if m is not qmm), (qmm,) + never,
                dict(per, flash=32), mma_counter(qmm_w8) if mode == "w4" else w8_precise_mma(),
                32, **ctx_kw)
        if mode == "int8":
            # kernel 6's tensor-core tile takes the 64-row prefill's 128
            # projections; the prefill's lm_head row and every decode row walk
            if counts[mode]["qmm_int8_mma"] != 3 * 128:
                raise AssertionError(f"gguf_int8: {counts[mode]['qmm_int8_mma']} tensor-core "
                                     "launches of kernel 6, expected 384")
            # a 32-token prompt: kernel 6 on its tile at 32 rows, 128 launches
            # a prefill; a token (the prefill's too) 129 launches of kernel 6
            counts["int8_32"] = serve_32(
                torch, cfg, params, "gguf_int8_32", (flash, qmm_int8), (qmm,),
                {"qmm_int8": 129, "flash": 32}, mma_counter(qmm_int8), 128, **ctx_kw)
            # the default context with the int8 cache: the uniform Q8F layers
            # stack, so kernels 6 and 9 serve it and kernel 3 never launches
            counts["int8_stacked_q8_0"], ctx = serve(
                torch, cfg, params, (qmm_int8, flash_stacked), "gguf_int8_stacked_q8_0",
                never=(flash,), kv_quant="q8_0")
            if "layers_stacked" not in ctx.params:
                raise AssertionError("the int8-mode file did not stack")
            del ctx
        del params
        torch.cuda.empty_cache()
    path.unlink()
    return counts


def device_rows(prof) -> list:
    """(device ms, calls, name) of each kernel in a torch.profiler trace
    (device-side events only: operator rows repeat their kernels)."""
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    return sorted(rows, reverse=True)


def profile_decode(torch, ctx, cfg, label: str, n_steps: int = 8, n_prompt: int = 64) -> None:
    """Where the time goes: torch.profiler traces of an n_prompt-token
    prefill and of n_steps greedy steps after it.  Device busy time is the
    sum of the kernels' device times (one stream, so they do not overlap);
    the idle share is the rest of the wall time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from llama_kotlin_tpu_torch.runtime.batch import Batch
    from llama_kotlin_tpu_torch.runtime.generate import generate_loop

    ctx.clear()
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, n_prompt).astype(np.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        assert ctx.decode(Batch.single(prompt)) == 0
        first = torch.argmax(ctx.logits_device()[:1], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    log(json.dumps({
        "phase": "profile_prefill", "path": label, "prompt_tokens": n_prompt,
        "wall_ms": wall_ms, "device_busy_ms": busy if rows else "not measured",
        "device_idle_share": 1.0 - busy / wall_ms if rows else "not measured",
        "device_launches": sum(r[1] for r in rows),
        "top": [{"kernel": k[:60], "ms": t, "calls": c} for t, c, k in rows[:8]]}))
    slots = ctx.meta.find_slots(n_steps)
    ctx.meta.commit(slots, np.arange(n_prompt, n_prompt + n_steps, dtype=np.int32),
                    np.zeros(n_steps, np.int32))
    cell_pos, cell_seq = ctx.meta.device_view(ctx.n_cells, "cuda")
    args = (torch.tensor([n_prompt], dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"),
            torch.from_numpy(slots.reshape(-1, 1)).to("cuda"), n_steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate_loop(ctx.params, cfg, ctx.cache, cell_pos, cell_seq, first, *args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    log(json.dumps({
        "phase": "profile", "path": label, "decode_steps": n_steps,
        "wall_ms_per_step": wall_ms / n_steps,
        "device_busy_ms_per_step": busy / n_steps if rows else "not measured",
        "device_idle_share": 1.0 - busy / wall_ms if rows else "not measured",
        "device_launches_per_step": sum(r[1] for r in rows) / n_steps,
        "top": [{"kernel": k[:60], "ms_per_step": t / n_steps, "calls_per_step": c / n_steps}
                for t, c, k in rows[:10]]}))


def parity_phase(torch) -> None:
    """Full width, 2 layers: card vs CPU, prefill + 4 greedy steps, on the
    unrolled path with a bf16 cache; then the int8 cache on the stacked and
    on the unrolled path, the q4_0 cache on both and a K shift on each cache
    type (2 steps), and the W4X model on the stacked one (card_vs_cpu)."""
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
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else cpu_params
        ctx = LlamaContext(cfg, p, n_cells=1024, buckets=(8, 16, 32, 64), prefer_unrolled=True,
                           device=dev)
        assert ctx.decode(Batch.single(prompt)) == 0
        logits = [ctx.get_logits()[-1]]
        toks = [int(np.argmax(logits[-1]))]
        for i in range(4):
            assert ctx.decode(Batch.single([toks[-1]], pos0=64 + i)) == 0
            logits.append(ctx.get_logits()[-1])
            toks.append(int(np.argmax(logits[-1])))
        res[dev] = (toks, logits)
    (gt, gl), (ct, cl) = res["cuda"], res["cpu"]
    errs = [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(gl, cl)]
    # the CPU's top-2 logit gap per step, in the same unit: where it exceeds
    # the error, equal greedy tokens are expected and carry signal
    gaps = [float((np.sort(b)[-1] - np.sort(b)[-2]) / np.abs(b).max()) for b in cl]
    # tol: f32 reduction order differs between the kernels and the plain
    # versions, and the bf16 residual stream, the bf16 FFN intermediate and
    # the int8 re-quantizations turn such last-bit differences into whole
    # rounding steps: the CPU at one thread differs from itself at eight by
    # ~1.3e-2 of max|logits| on this model (PERF.md).  On zero-mean weights
    # max|logits| is ~5 logit std (logit_std_rel), so 3e-2 is ~0.15 std,
    # where a wiring fault moves logits by about one std
    tol = 3e-2
    log(json.dumps({"phase": "parity", "n_layer": 2, "tokens_cuda": gt, "tokens_cpu": ct,
                    "rel_logit_err": errs, "top2_gap_rel": gaps,
                    "logit_std_rel": [float(b.std() / np.abs(b).max()) for b in cl],
                    "tol_rel": tol}))
    if gt != ct or not max(errs) <= tol:
        raise AssertionError("card and CPU disagree")
    # kernel 10 on the card (LKTPU_LAYER_FUSED=1) against the same CPU run:
    # the CPU's plain version equals its unfused route bit for bit
    card_vs_cpu(torch, "parity_unrolled_bf16_fused", lambda dev: LlamaContext(
        cfg, params if dev == "cuda" else cpu_params, n_cells=1024, buckets=(8, 16, 32, 64),
        prefer_unrolled=True, device=dev), prompt, tol,
        knob_sets=[dict(LKTPU_LAYER_FUSED="1")], cpu=(ct, cl))
    for label, kw in (("parity_stacked_q8_0", {}), ("parity_unrolled_q8_0",
                                                     dict(prefer_unrolled=True))):
        card_vs_cpu(torch, label, lambda dev: LlamaContext(
            cfg, params if dev == "cuda" else cpu_params, n_cells=1024, buckets=(8, 16, 32, 64),
            kv_quant="q8_0", device=dev, **kw), prompt, tol)
    # the q4_0 cache (kernel 3's int4 branch unrolled, the plain route
    # stacked), and a seq_div/seq_add shift on each cache type, 2 steps each.
    # tol as above: on this model the CPU tests' port-vs-JAX spread is no
    # larger with the q4_0 cache than with q8_0 (1.7e-4 against 1e-4 of
    # max|logits|, tests/test_torch_kv_q4.py)
    for label, kw, shift in (
            ("parity_unrolled_q4_0", dict(kv_quant="q4_0", prefer_unrolled=True), None),
            ("parity_stacked_q4_0_shift", dict(kv_quant="q4_0"), shift_positions),
            ("parity_unrolled_bf16_shift", dict(prefer_unrolled=True), shift_positions),
            ("parity_stacked_q8_0_shift", dict(kv_quant="q8_0"), shift_positions)):
        card_vs_cpu(torch, label, lambda dev: LlamaContext(
            cfg, params if dev == "cuda" else cpu_params, n_cells=1024, buckets=(8, 16, 32, 64),
            device=dev, **kw), prompt, tol, steps=2, shift=shift)
    del params, cpu_params
    # tinyllama-1.1b at 2 layers (head dim 64; kernel 1 on the padded FFN)
    # on each cache and path of tinyllama_phase, and with 1000 cells (n_vis
    # = 1000 at every step).  tol as above
    tcfg = preset_config("tinyllama-1.1b", n_layer=2)
    tiny = synthetic_params_device(tcfg, seed=3, device="cuda")
    tiny_cpu = params_to(tiny, "cpu")
    tprompt = np.random.default_rng(5).integers(0, tcfg.vocab_size, 64).astype(np.int32)
    for label, kw in (("parity_tinyllama_unrolled_bf16", dict(prefer_unrolled=True)),
                      ("parity_tinyllama_stacked_bf16", {}),
                      ("parity_tinyllama_stacked_q8_0", dict(kv_quant="q8_0")),
                      ("parity_tinyllama_unrolled_q4_0", dict(kv_quant="q4_0",
                                                              prefer_unrolled=True)),
                      ("parity_tinyllama_stacked_1000", dict(n_cells=1000)),
                      ("parity_tinyllama_unrolled_1000", dict(n_cells=1000,
                                                              prefer_unrolled=True))):
        kw = dict(dict(n_cells=1024), **kw)
        card_vs_cpu(torch, label, lambda dev: LlamaContext(
            tcfg, tiny if dev == "cuda" else tiny_cpu, buckets=(8, 16, 32, 64), device=dev,
            **kw), tprompt, tol)
    del tiny, tiny_cpu
    # the W4X model of the same seed on the default (stacked) context, bf16
    # cache.  tol: the W4X activations carry ~16 bits, so a flipped plane-1
    # code is mostly caught by plane 2; on the CPU the port and the JAX
    # package differ by ~1e-3 of max|logits| on such a model (the W4A8 one
    # by ~1e-2), and 1e-2 is ten times that
    w4x = synthetic_params_device(cfg, seed=1, device="cuda", mode="w4x")
    w4x_cpu = params_to(w4x, "cpu")
    card_vs_cpu(torch, "parity_w4x_stacked", lambda dev: LlamaContext(
        cfg, w4x if dev == "cuda" else w4x_cpu, n_cells=1024, buckets=(8, 16, 32, 64),
        device=dev), prompt, 1e-2)


def shift_positions(ctx, n_past: int) -> int:
    """A self-extend-style shift after the prefill: positions 0..n/2-1 are
    halved (seq_div) and the rest moved down to follow them (seq_add), so
    both rotate cached K rows.  Returns the next position."""
    half = n_past // 2
    ctx.seq_div(0, 0, half, 2)
    ctx.seq_add(0, half, -1, -(half // 2))
    return n_past - half // 2


def card_vs_cpu(torch, label: str, build, prompt, tol: float, steps: int = 4,
                shift=None, knob_sets=({},), cpu=None) -> None:
    """One context on the CPU (the plain versions, which no knob changes)
    against the same on the card under each set of environment knobs, full
    width: build(device) gives the context.  The CPU decodes greedily
    (prefill + `steps` steps, after shift(ctx, n) -> next position when
    given; or cpu=(tokens, logits) of such a run) and each card run takes
    the CPU's tokens, so one near-tie cannot send the two down different
    paths; logits within tol of max|logits| at every step, and the card's
    greedy token equal to the CPU's wherever the CPU's top-2 gap exceeds
    twice the tolerance."""
    import numpy as np

    from llama_kotlin_tpu_torch.runtime.batch import Batch

    def run(dev, toks):
        ctx = build(dev)
        assert ctx.decode(Batch.single(prompt)) == 0
        n = len(prompt) if shift is None else shift(ctx, len(prompt))
        logits = [ctx.get_logits()[-1]]
        for i in range(steps):
            tok = int(np.argmax(logits[-1])) if toks is None else toks[i]
            assert ctx.decode(Batch.single([tok], pos0=n + i)) == 0
            logits.append(ctx.get_logits()[-1])
        del ctx
        return logits

    cl = run("cpu", None) if cpu is None else cpu[1]
    ct = [int(np.argmax(b)) for b in cl]
    gaps = [float((np.sort(b)[-1] - np.sort(b)[-2]) / np.abs(b).max()) for b in cl]
    for env in knob_sets:
        with knobs(**env):
            gl = run("cuda", ct)
        errs = [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(gl, cl)]
        gt = [int(np.argmax(a)) for a in gl]
        log(json.dumps({"phase": label, "knobs": env, "n_layer": 2, "shift": shift is not None,
                        "tokens_cpu": ct, "tokens_cuda_forced": gt, "rel_logit_err": errs,
                        "top2_gap_rel": gaps,
                        "logit_std_rel": [float(b.std() / np.abs(b).max()) for b in cl],
                        "tol_rel": tol}))
        if not max(errs) <= tol or any(g > 2 * tol and a != b for g, a, b in zip(gaps, gt, ct)):
            raise AssertionError(f"card and CPU disagree ({label}, {env})")


def gguf_parity_phase(torch, tmpdir: Path) -> None:
    """Full width, 2 layers of the Q4_K_M profile (layer 0 all Q4_K, layer 1
    with Q6_K attn_v and ffn_down, Q6_K output), each fast mode on the
    unrolled path: the file loaded on the card against the same file loaded
    on the CPU (the CPU repack and the plain versions), by card_vs_cpu; and
    the same file with a dense F16 output in the w4 mode."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.models.synthetic import preset_config, synthetic_gguf
    from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext

    path = tmpdir / "llama3-8b-2layer-q4_k_m.gguf"
    synthetic_gguf(path, preset_config("llama3-8b", n_layer=2), seed=8)
    prompt = np.random.default_rng(4).integers(0, 128256, 64).astype(np.int32)
    # tol: as in parity_phase, the int8 re-quantization of every matmul
    # input and the bf16 residual stream amplify f32 last-bit differences:
    # on these zero-mean Q4_K_M weights the CPU at one thread differs from
    # itself at eight by up to 2.6e-2 of max|logits| in the w4 mode
    # (PERF.md); 5e-2 is twice that, ~0.25 logit std (logit_std_rel ~0.2),
    # where a wiring fault moves logits by about one std
    tol = 5e-2
    for mode in ("w4", "int8"):
        def build(dev, mode=mode):
            cfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True, device=dev)
            f.close()
            return LlamaContext(cfg, params, n_cells=1024, buckets=(8, 16, 32, 64),
                                prefer_unrolled=True, device=dev)

        card_vs_cpu(torch, f"gguf_parity_{mode}", build, prompt, tol)
    path.unlink()
    # a file whose output matrix is dense (F16, a bf16 tensor once loaded):
    # the lm_head is a plain bf16 matmul with an f32 result on both sides
    path = tmpdir / "llama3-8b-2layer-f16-output.gguf"
    synthetic_gguf(path, preset_config("llama3-8b", n_layer=2), seed=8,
                   output_type=GGMLQuantType.F16)

    def build_dense(dev):
        cfg, params, f = load_gguf_model(path, fast_mode="w4", fuse=True, device=dev)
        f.close()
        if not isinstance(params["output"], torch.Tensor):
            raise AssertionError("the F16 output did not load as a dense tensor")
        return LlamaContext(cfg, params, n_cells=1024, buckets=(8, 16, 32, 64),
                            prefer_unrolled=True, device=dev)

    card_vs_cpu(torch, "gguf_parity_w4_f16_output", build_dense, prompt, tol, steps=2)
    path.unlink()
    # all-Q4_0 and all-Q4_1 files (sym and legacy W4 folds) in the w4 mode
    # on the default (stacked) context, the card by default, with kernel 8
    # (LKTPU_W4_FX=1) and with kernels 8 and 10 (both knobs), each against
    # one CPU run.  tol: the w4 file's, as above
    knob_sets = [{}, dict(LKTPU_W4_FX="1"), dict(LKTPU_W4_FX="1", LKTPU_LAYER_FUSED="1")]
    for qtype in (GGMLQuantType.Q4_0, GGMLQuantType.Q4_1):
        path = tmpdir / f"llama3-8b-2layer-{qtype.name.lower()}.gguf"
        synthetic_gguf(path, preset_config("llama3-8b", n_layer=2), seed=10, matrix_type=qtype)

        def build_q4(dev):
            cfg, params, f = load_gguf_model(path, fast_mode="w4", fuse=True, device=dev)
            f.close()
            return LlamaContext(cfg, params, n_cells=1024, buckets=(8, 16, 32, 64), device=dev)

        card_vs_cpu(torch, f"gguf_parity_w4_{qtype.name.lower()}", build_q4, prompt, tol,
                    knob_sets=knob_sets)
        path.unlink()


def pick_row(rows: list, i):
    """A kernel's timed row by its index or its shape."""
    return rows[i] if isinstance(i, int) else next(r for r in rows if r["shape"] == i)


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

        def timed(fn, *args):
            t = time.perf_counter()
            out = fn(*args)
            log(json.dumps({"phase": "timing", "function": fn.__name__,
                            "seconds": time.perf_counter() - t}))
            return out

        timed(kernel_phase, torch, results)
        timed(w8_kernel_phase, torch, results)
        timed(w4x_kernel_phase, torch, results)
        timed(kv_kernel_phase, torch, results)
        timed(fx_layer_kernel_phase, torch, results)
        by_path = timed(serving_phase, torch)
        by_path.update(timed(w4x_serving_phase, torch))
        by_path.update(timed(tinyllama_phase, torch))
        tmpdir = Path(tempfile.mkdtemp(prefix="lk_gguf_"))
        try:
            for mode, c in timed(gguf_phase, torch, tmpdir).items():
                by_path[f"gguf_{mode}"] = c
            by_path.update(timed(q4_0_gguf_phase, torch, tmpdir))
            timed(parity_phase, torch)
            timed(gguf_parity_phase, torch, tmpdir)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
    except Exception:
        traceback.print_exc()
        return 1
    # kernel: (source, replaced Pallas kernel, index of the reported timed
    # row, {branch: index or shape of its timed row})
    meta = {
        "qmm_w4": ("csrc/qmm_w4.cu", "llama_kotlin_tpu/ops/pallas/qmm_w4.py:290", 0,
                   {"b32": "compact qkv n=6144 k=4096 b=32",
                    "lm_head_b32": "compact lm_head n=128256 k=4096 b=32"}),
        "qmm_w4_ffn": ("csrc/qmm_w4_ffn.cu", "llama_kotlin_tpu/ops/pallas/qmm_w4_ffn.py:155",
                       0, {"b8": "compact E=4096 F=14336 b=8",
                           "b32": "compact E=4096 F=14336 b=32",
                           "up_b1": "up= compact E=4096 F=14336 b=1"}),
        "flash": ("csrc/flash.cu", "llama_kotlin_tpu/ops/pallas/flash.py:160", 0,
                  {"prefill": 1, "int8": 3, "int4": 4,
                   "d64": "bf16 cache D=64 nt=64 n_vis=1024",
                   "ragged": "bf16 cache D=128 nt=64 n_vis=1001"}),
        "qmm": ("csrc/qmm.cu", "llama_kotlin_tpu/ops/pallas/qmm.py:192", 1,
                {"m512": 5, "w8": 8}),
        "qmm_w8": ("csrc/qmm_w8.cu", "llama_kotlin_tpu/ops/pallas/qmm_w8.py:144", 0,
                   {"b32": "lm_head n=128256 k=4096 b=32 group=16"}),
        "qmm_int8": ("csrc/qmm_int8.cu", "llama_kotlin_tpu/ops/pallas/qmm_int8.py:41",
                     "down n=4096 k=14336 b=64",
                     {"b1": "qkv n=6144 k=4096 b=1", "qkv_m64": "qkv n=6144 k=4096 b=64",
                      "b32": "lm_head n=128256 k=4096 b=32",
                      "m512": "qkv n=6144 k=4096 b=512"}),
        "flash_stacked": ("csrc/flash_stacked.cu",
                          "llama_kotlin_tpu/ops/pallas/flash_stacked.py:94", 0,
                          {"int8": 1, "prefill": "bf16 cache nt=64 n_vis=1024 layer=31",
                           "d64": "bf16 cache D=64 nt=64 n_vis=1024",
                           "ragged": "bf16 cache D=128 nt=64 n_vis=1001"}),
        "qmm_w4x": ("csrc/qmm_w4x.cu", "llama_kotlin_tpu/ops/pallas/qmm_w4.py:691", 0,
                    {"b32": 6}),
        "qmm_w8_precise": ("csrc/qmm_w8.cu", "llama_kotlin_tpu/ops/pallas/qmm_w8.py:144", 0,
                           {"b32": "lm_head n=128256 k=4096 b=32 group=16"}),
        "qmm_w4_fx": ("csrc/qmm_w4_fx.cu", "llama_kotlin_tpu/ops/pallas/qmm_w4.py:551", 0,
                      {"b32": "sym down n=4096 k=14336 b=32"}),
        "qmm_w4_layer": ("csrc/qmm_w4_layer.cu",
                         "llama_kotlin_tpu/ops/pallas/qmm_w4_ffn.py:662", 0,
                         {"b8": "compact E=4096 F=14336 b=8"}),
    }
    timing = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    # every kernel-3 launch of a q4_0 path is on the int4 branch (checked there)
    int4_launches = sum(c["flash"] for p, c in by_path.items()
                        if p.endswith("_q4_0") and "flash" in c)
    kernels = []
    for kname, (src, replaces, pick, branches) in meta.items():
        rows = [r for r in results[kname] if "ms" in r]
        launches = {p: c[kname] for p, c in by_path.items() if kname in c}
        entry = {"name": kname, "route": "cuda", "source": "llama_kotlin_tpu_torch/" + src,
                 "replaces": replaces, "launches": sum(launches.values()),
                 "launches_by_path": launches,
                 "max_abs_err": max(r["max_abs_err"] for r in results[kname]),
                 **{k: pick_row(rows, pick)[k] for k in timing}}
        # tensor-core launches, on the paths that count them apart (kernels
        # 1, 5 and 8: LAUNCHES_MMA); every launch of kernels 3 and 4 is one
        mma = {p: c[f"{kname}_mma"] for p, c in by_path.items() if f"{kname}_mma" in c}
        if mma:
            entry["launches_mma_by_path"] = mma
        for branch, i in branches.items():
            entry[branch] = {k: pick_row(rows, i)[k] for k in timing + ("max_abs_err",)}
            if "unfused_ms" in pick_row(rows, i):  # kernels 2 and 10: the route they replace
                entry[branch]["unfused_ms"] = pick_row(rows, i)["unfused_ms"]
        if kname == "flash":  # the int4 branch's launches, counted apart
            entry["int4"]["launches"] = int4_launches
        if kname in ("qmm_w4_ffn", "qmm_w4_layer"):  # no library call; the route replaced
            entry["library"] = ("none: no one call computes a gated FFN" if kname == "qmm_w4_ffn"
                                else "none: no one call computes a layer half")
            entry["unfused_ms"] = pick_row(rows, pick)["unfused_ms"]
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
