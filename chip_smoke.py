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
               timed with CUDA events (median of 10, L2 flushed before each
               call), beside its bound on this card and one PyTorch library
               call where one computes the same function; and the
               load-time repack and the KV row quantizer on the card
               against the CPU's, bit for bit;
  4. serving — the full llama3-8B W4A8 model (32 layers, random weights
               from a seed) serves 3 requests through LlamaContext: prefill
               64 tokens, then 32 greedy tokens; on the unrolled path with
               a bf16 cache, then stacked with a bf16 and a q8_0 cache and
               unrolled with a q8_0 cache (these at the model's first 2
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
models/llama.py::attend_stacked_plain, and neither kernel 3 nor 9); to 5 the
w4-mode file unrolled with it; to 6 the q4_0 cache on both paths, a
seq_div/seq_add K shift on each cache type and a file with a dense (F16)
output matrix.

Kernels 8 and 10, behind the JAX package's opt-in knobs (set per run by
knobs(), which restores the environment), add to 3 kernel 8 on sym and
legacy W4 folds at the four decode projections (b = 1, 9, 16 and 32,
beside kernel 1 on the same inputs) and kernel 10 on compact, sym and legacy folds
(b = 1 and 8, beside the unfused route it replaces); to 4 the W4A8 model
(its first 2 layers) with LKTPU_LAYER_FUSED=1, stacked and unrolled
(kernel 10: n_layer launches a decode step, none at the prefill); to 5 a
full-width 2-layer Q4_0 file (sym folds, Q6_K output) by default, with
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

The text path (tokenizers, the sampler chain with grammars, on-device
sampling, chat templates, session files and the CLIs) adds a phase after 5,
cli_phase: the Q4_K_M file of 5 carries an SPM vocab of its 128256 pieces
and a Llama-2 chat template, and tools/tokenize.py, tools/main.py (at a
seed twice, under a JSON schema, with a prompt cache, interactive on
stdin), tools/simple.py and generate() run on it in process (their stdout
captured), with sample_rows_device under grammar masks and _sample's
stages on the card against the CPU's; kernels 1-5 must launch there
(launches_by_path["cli_w4"]).  Its cli line gives each run's TTFT and
ms/token, generate()'s, and the host sampler chain's and the grammar
filter's cost a token at vocab 128256.

The exact-dequant mode (fast_mode=None, the loader's and the CLIs'
default: every matrix keeps its exact repack) and the Q5_0, Q5_1, Q2_K,
Q3_K, Q5_K and Q8_K wire formats add to 3 kernel 4's exact branches
(csrc/qmm_exact.cu) against their plain version, timed at b = 1, 64 and
512 on the llama3-8B Q4_K (qkv, o, gate|up, down) and Q6_K (lm_head, attn_v,
ffn_down) shapes and repeated bit-equal, the other layouts untimed at 1, 9
and 64 rows, a Q8_K repack through kernel 6, and the card's repack, W8
fold and Q8F of each new format against the CPU's; to 5 the 32-layer
Q4_K_M file loaded with fast_mode=None serving 3 requests (kernel 4's exact
branch on every projection at every step, kernel 3 attends, kernels 1, 2,
5, 6 and 7 never; exact_serving_phase, which also runs tools/main.py
without --fast-mode), a 2-layer file of every format in all four modes
and a 2-layer Q8_0 file in the exact mode on the stacked path (kernel 9 and
kernel 4's exact branch; new_formats_phase); to 6 the 2-layer Q4_K_M file
and a 2-layer every-format file in the exact mode against the CPU.

The serving runtime (the continuous-batching engine, speculative, lookup
and lookahead decoding, the OpenAI server) adds to 3 kernel 3 under the
masks serving gives it (serving_mask_phase: four sequences interleaved
beside a prompt chunk, a prefix shared through seq_cp, a speculative tree
with branch bitmasks; three caches, blind rows exactly 0, beside SDPA); to
4 speculative_phase on the W4A8 model's first layers (host and device loops
identical; every emitted token of every method within twice the measured
route noise of the target's best, teacher-forced); to 5
server_phase on the Q4_K_M file in the w4 and the exact mode (one slot
bit-equal to generate(), 8 concurrent HTTP requests on 4 slots, tokens/s
at 1, 4 and 8 slots, one engine step profiled); to 6 engine_parity_phase
(4 slots, 6 requests, 6 steps, card against CPU at 2 layers).

DeepSeek-V2-Lite and llama-architecture MoE (deepseek2's multi-head latent
attention on kernel 3's MLA branch, routed and shared experts) add to 3
kernel 3's MLA branch (K 192, V 128; 16 heads on 16 kv heads) on the three
caches at decode and a 64-token chunk over 1024 and 4096 cells
(mla_kernel_phase); to 5 DeepSeek-V2-Lite at its published widths (its
first EARLIER_LAYERS layers since the gemma phases came) in the exact and
w4 modes, 3 requests each with exact MLA launch counts (one a layer and
step) and no plain attention, profiled, and 4 concurrent requests on the
engine at 4 slots (deepseek2_phase); to 6 its first 2 layers in both modes
and a 2-layer Mixtral-8x7B-shaped file in w4 against the CPU, the card on
the CPU's routing (moe_parity_phase).  The W4X model, tinyllama-1.1b and
speculative decoding are cut to EARLIER_LAYERS layers since then.

gemma and gemma2 (kernel 3's D = 256 branch, logit softcaps, alternating
sliding-window attention, (1 + w) norms, gemma2's post norms, a tied Q6_K
head) add to 3 kernel 3's D = 256 branch (16 heads on 8 kv heads,
softcap 50) on the three caches at decode and a 64-token chunk over 1024
and 4096 cells and under a 1024-cell window over 4096, whose dead tiles
are poisoned and must not move the output, with the ptxas report of its
three instances (no spill; d256_kernel_phase); to 5 gemma-2-9b at its
published widths (all 42 layers until llama3-70b came, EARLIER_LAYERS since)
in the exact and w4 modes, 3 requests
each with exact launch counts on every kernel (42 D = 256 launches a
decode step and a prefill) and no plain attention, profiled (gemma2_phase);
to 6 gemma-2-9b at 2 layers with a window under the prompt in both modes
and gemma-7b at 2 layers on the stacked path (attend_stacked_plain) in the
exact mode, card against CPU (gemma_parity_phase).

Every weight layout of the JAX package (the nine IQ wire formats, the Q8F
high-batch shadow of LKTPU_DUAL_FOLD=1, the rest of models/synthetic.py,
llama3-70b) adds to 3 kernel 4's exact branch on the nine IQ repacks at
llama3-8B's qkv and gate|up widths, m = 1, 64 and 512, held against the
plain version and an f32 product with the weight decoded on the card
from the wire, and the card's IQ repacks, W8 folds and Q8F against the
CPU's (iq_kernel_phase); to 4 the dual fold on the W4A8 model of
EARLIER_LAYERS layers (every shadowed projection on kernel 6 at 9-256
rows, bit-equal W4 routes at 8 and 257, batched_bench rows at 1-32 slots
and 64-300-token prompts with and without the shadow, exact launch
counts; dual_fold_phase) and the synthetic int8, dequant, sym w4, dense
and unfused draws (synthetic_modes_phase); to 5 a 2-layer llama3-8B file
of every IQ format in the four modes (iq_formats_phase) and llama3-70b
at full width and all 80 layers in w4 (kernel 2's routes at F = 28672,
kernels 1 and 2 timed at its widths, 3 requests, a profiled prefill and
decode; llama70b_phase); to 6 a 2-layer every-IQ file in the exact and
w4 modes and llama3-70b at 2 layers against the CPU (iq_parity_phase,
llama70b_parity_phase).

The llama-shaped architectures (Qwen2-7B's 7 query heads a kv head, qkv
biases, Qwen1.5-MoE-A2.7B's sigmoid-gated shared expert, ALiBi, LayerNorm,
the parallel block) add to 3 kernels 3 and 9 at Qwen2-7B's 28/4 heads on
the three caches (decode and 64 rows over 1001, 1024 and 4096 cells, blind
rows exactly 0), kernel 1 at its widths (b = 1 and 8) and kernel 4's exact
qkv, kernel 2 declining its FFN (qwen2_kernel_phase); to 5 Qwen2-7B at full
width and all 28 layers and Qwen1.5-MoE-A2.7B at EARLIER_LAYERS, exact and
w4, 3 requests each with every kernel's launches exact (route_counts),
profiled (qwen2_phase, qwen2moe_phase; llama3-70b's serving phase went to
EARLIER_LAYERS for them); to 6 both at 2 layers (Qwen2-7B exact and w4,
the MoE in w4; qwen_parity_phase) and 16 other family members at 2 layers (baichuan-13B
at 40) and a narrow width, exact, kernel 3 never launched where JAX's
predicate declines its kernel (ALiBi, head dim 96; arch_sweep_phase).

The learned-position and LayerNorm-gelu family (gpt2, starcoder, gptneox,
falcon, mpt, phi2, bloom, jais, nemotron, chatglm: learned positions, the
embedding LayerNorm, falcon-40b's attn_norm_2, packed swiglu, relu^2, an
output bias) adds to 3 kernel 3 at Falcon-7B's 71 query heads on one kv
head (head dim 64) on the three caches, decode and 64 rows over 1001, 1024
and 2048 cells, and at StarCoder-15.5B's 48 on one (head dim 128), kernel
9 at both, kernel 4's exact, W8 and W4 branches at Falcon-7B's qkv, o and
down (K = 4544 on the Q5_0 / Q8_0 fallback) at m = 1 and 64, kernel 5 at
its up and lm_head and StarCoder's head, kernel 1 at StarCoder's widths
(gpt_kernel_phase); to 5 Falcon-7B at full width and all 32 layers and
StarCoder-15.5B at EARLIER_LAYERS, exact and w4, 3 requests each with
every kernel's launches exact (route_counts: in w4 Falcon-7B's qkv, o and
down take kernel 4 at decode, as JAX's _plan declines their rows;
kernel 1 never), profiled (falcon_phase, starcoder_phase; Qwen2-7B's
serving phase went to EARLIER_LAYERS for them); to 6 both at 2 layers
(Falcon-7B exact and w4, StarCoder w4; gpt_parity_phase) and the ten archs
and a falcon-40b-shaped member in the sweep, kernel 3 never launched where
JAX's predicate declines (ALiBi: mpt, bloom, jais; phi2's head dim 80).

The large MoEs and the per-layer architectures (dbrx, arctic, grok,
openelm, bitnet: DBRX's clamped fused qkv and 16 experts of which 4 route,
grok's softcap 30 and gelu experts, arctic's MoE branch beside its dense
FFN, bitnet's scales and sub-norms, OpenELM's per-layer head, kv-head and
FFN counts) add to 3 kernel 3 at 48 query heads on 8 kv heads without and
with softcap 30 on the three caches, decode and 64 rows over 1001, 1024
and 4096 cells, and on OpenELM-3B's per-layer views (12/3 and 24/6 heads of
a 6-kv-head cache), kernel 4's exact branch at DBRX's, Grok-1's and
Arctic's expert widths, kernel 1 at DBRX's and OpenELM-3B's and kernel 2 at
OpenELM-3B's FFNs (large_moe_kernel_phase); to 5 DBRX at full width
(EARLIER_LAYERS layers) and OpenELM-3B at full width and all 36 layers,
exact and w4, 3 requests each with every kernel's launches exact
(route_counts, layer by layer: the MoE route by its rows, kernel 2 where
it takes a layer), profiled, and DBRX's exact load on the engine at 4
slots, whose decode steps sweep the experts (dbrx_phase, openelm_phase;
Falcon-7B's serving phase went to EARLIER_LAYERS for them); to 6 DBRX at
2 layers (exact and w4, on the CPU's routing) and a 2-layer OpenELM file
of OpenELM-3B's first and last layers' shapes (large_moe_parity_phase),
and grok, arctic (128 experts), bitnet (head dim 100), dbrx and openelm
in the sweep, kernel 3 never where JAX declines it.

The parity phases' CPU references are computed by child processes of this
script (--cpu-refs, started at once, CPU_REF_GROUPS: each a share of the
parity phases and of the host's threads), which run beside the card's
phases; the parent reads each reference when its card run needs it.
Another child (--write-files) writes the 4.9 GB llama3-8B Q4_K_M file, the
every-IQ files, the DeepSeek-V2-Lite, gemma-2-9b, Qwen2-7B,
Qwen1.5-MoE-A2.7B, Falcon-7B, StarCoder-15.5B, DBRX (about 9 GB) and
OpenELM-3B files meanwhile.

The last line of standard output is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import replace
from pathlib import Path

# the card's data-sheet peaks (H100 SXM, dense): bytes/s and ops/s
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12}
REPS = 10  # timed calls a row (their median is the row's time)
FLUSH_BYTES = 256 << 20  # > the 50 MB L2: decode streams cold weights
SPIN_CYCLES = 10_000_000  # ~5 ms of device spin ahead of each timed call
# depth of the paths earlier slices added (the quantized caches, the fused
# layer half, the Q4_0 file, and since the DeepSeek-V2-Lite phases came
# the W4X model, tinyllama-1.1b and speculative decoding): cut to keep the
# whole script well inside its time limit on a slow host (8 layers until
# the tinyllama-1.1b phase and kernel 6's and the repaired attention's rows
# came, 4 until DBRX's and OpenELM-3B's phases came: the files the script
# writes then passed the 45 GiB of disk writes the card's machine allows a
# run); the main path, the Q4_K_M file and OpenELM-3B keep their full depth
# (DeepSeek-V2-Lite, gemma-2-9b, llama3-70b, Qwen2-7B and Falcon-7B went to
# it as later slices came)
EARLIER_LAYERS = 2
# greedy tokens of each request of the 32-token prompts (serve_32)
N_NEW_32 = 8
# kernel 6's timed row counts: both sides of its threshold T6, each m16
# count of its tile, a 64-token and a 512-token prefill
Q8F_ROWS = (1, 2, 4, 8, 9, 16, 32, 64, 512)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_call(fn, *args):
    """fn(*args), with its wall seconds logged as a timing line."""
    t = time.perf_counter()
    out = fn(*args)
    log(json.dumps({"phase": "timing", "function": fn.__name__,
                    "seconds": time.perf_counter() - t}))
    return out


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
# an exact repack: codes, group scales and mins, superblock scales and mins
EXACT_PLANES = ("codes", "g_scale", "g_min", "sb_scale", "sb_min")


def w4_planes(w) -> tuple:
    """The planes that a product with weight w must read: the compact
    planes, a sym fold's codes and scales, an exact repack's every plane,
    or codes, scales and mins."""
    return {"compact": W4_STREAMED, "sym": SYM_PLANES, None: EXACT_PLANES}.get(
        w.flavor, FOLD_PLANES)


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
        repack_equal(torch, data, qtype, n, k,
                     lambda d, q, n, k: fold_fn(repack.repack(d, q, n, k)), "fold")
        repack_equal(torch, data, qtype, n, k, repack.repack_q8flat, "q8f")
        del data

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


def exact_counter():
    """Kernel 4's launches on its exact branches (qmm.LAUNCHES_EXACT), counted
    apart as "qmm_exact" (each also counts in qmm.LAUNCHES)."""
    from llama_kotlin_tpu_torch.ops.cuda import qmm

    return BranchCounter(qmm, "LAUNCHES_EXACT", "qmm.qmm_exact")


def repack_equal(torch, data, qtype, n: int, k: int, fn, what: str) -> None:
    """A load-time conversion of wire bytes on the card equals the CPU's, bit
    for bit: every tensor of the QTensor, and its dtype."""
    g, c = fn(data.to("cuda"), qtype, n, k), fn(data, qtype, n, k)
    same = (g.tensors().keys() == c.tensors().keys() and all(
        t.dtype == c.tensors()[name].dtype and torch.equal(t.cpu(), c.tensors()[name])
        for name, t in g.tensors().items()))
    log(json.dumps({"phase": "repack", "qtype": qtype.name, "shape": [n, k], "what": what,
                    "layout": g.flavor, "tensors": sorted(g.tensors()),
                    "bit_equal_to_cpu": same}))
    if not same:
        raise AssertionError(f"card {what} of {qtype.name} differs from the CPU's")


# kernel 4's exact branches: the timed rows' row counts (a decode step, a
# 64-token and a 512-token prefill) and the untimed checks'
EXACT_ROWS = (1, 64, 512)
EXACT_CHECK_ROWS = (1, 9, 64)


def exact_kernel_phase(torch, results: dict) -> None:
    """Kernel 4's exact branches (csrc/qmm_exact.cu) against their plain
    version (ops/cuda/qmm.py::qmm_plain, the Pallas order of the weight),
    on exact repacks made on the card from random wire blocks: timed at b =
    1, 64 and 512 on the llama3-8B Q4_K shapes (qkv, o, gate|up, down) and
    Q6_K shapes (lm_head, attn_v, ffn_down), each repeated bit-equal; the
    other layouts (Q4_0, Q4_1, Q2_K, Q5_0, Q5_1, Q5_K, Q3_K, Q8_0) untimed at
    1, 9 and 64 rows; a Q8_K repack through qmatmul (kernel 6) against
    kernel 6's plain version; and the card's repack of each new format
    (Q5_0, Q5_1, Q2_K, Q3_K, Q5_K, Q8_K) and its W8 fold and Q8F against the
    CPU's, bit for bit.  tol: identical bf16 operands, f32 order only."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.synthetic import wire_blocks
    from llama_kotlin_tpu_torch.ops import qmatmul as qmatmul_mod
    from llama_kotlin_tpu_torch.ops.cuda import qmm, qmm_int8
    from llama_kotlin_tpu_torch.quant import fold, repack
    from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5678)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    report = functools.partial(report_row, results)
    check = functools.partial(check_row, results)
    rng = np.random.default_rng(77)
    E, F, V, KVD = 4096, 14336, 128256, 1024

    def wire(qtype, n, k):
        return torch.from_numpy(wire_blocks(rng, qtype, n, k))

    for qtype in (Q.Q5_0, Q.Q5_1, Q.Q2_K, Q.Q3_K, Q.Q5_K, Q.Q8_K):
        data = wire(qtype, 1024, E)
        repack_equal(torch, data, qtype, 1024, E, repack.repack, "repack")
        repack_equal(torch, data, qtype, 1024, E, repack.repack_q8flat, "q8f")
        if qtype != Q.Q8_K:
            repack_equal(torch, data, qtype, 1024, E,
                         lambda d, q, n, k: fold.fold_to_w8(repack.repack(d, q, n, k)), "w8 fold")

    def timed_rows(qtype, shapes):
        for name, (n, k) in shapes.items():
            wt = repack.repack(wire(qtype, n, k).to(dev), qtype, n, k)
            assert fold.is_exact(wt)
            for m in EXACT_ROWS:
                xb = (torch.randn((m, k), generator=gen, device=dev) * 0.7).to(torch.bfloat16)
                got = qmm.qmm(xb, wt)
                shape = f"exact {qtype.name} {name} n={n} k={k} m={m}"
                repeats(torch, "qmm", shape, got, lambda: qmm.qmm(xb, wt))
                report("qmm", shape, err_of(got, qmm.qmm_plain(xb, wt)), 1e-3,
                       time_ms(torch, lambda: qmm.qmm(xb, wt), flush),
                       time_ms(torch, lambda: qmm.qmm_plain(xb, wt), flush),
                       m * k * 2 + nbytes(wt, EXACT_PLANES) + m * n * 4, 2 * m * n * k,
                       "bf16", matmul_ms(torch, xb, wt, flush))
            del wt

    timed_rows(Q.Q4_K, {"qkv": (6144, E), "o": (E, E), "gate_up": (2 * F, E), "down": (E, F)})
    timed_rows(Q.Q6_K, {"lm_head": (V, E), "attn_v": (KVD, E), "ffn_down": (E, F)})
    torch.cuda.empty_cache()
    for qtype in (Q.Q4_0, Q.Q4_1, Q.Q2_K, Q.Q5_0, Q.Q5_1, Q.Q5_K, Q.Q3_K, Q.Q8_0):
        wt = repack.repack(wire(qtype, E, E).to(dev), qtype, E, E)
        assert fold.is_exact(wt)
        for m in EXACT_CHECK_ROWS:
            xb = (torch.randn((m, E), generator=gen, device=dev) * 0.7).to(torch.bfloat16)
            got = qmm.qmm(xb, wt)
            shape = f"exact {qtype.name} n={E} k={E} m={m}"
            repeats(torch, "qmm", shape, got, lambda: qmm.qmm(xb, wt))
            check("qmm", shape, got, qmm.qmm_plain(xb, wt), 1e-3)
    # a Q8_K repack routes to kernel 6 (its layout is Q8F's); tol as kernel
    # 6's own rows (exact integer partials, f32 order of the scale sum)
    wt = repack.repack(wire(Q.Q8_K, E, E).to(dev), Q.Q8_K, E, E)
    assert fold.is_q8_sb(wt) and not fold.is_exact(wt)
    for m in EXACT_CHECK_ROWS:
        x = torch.randn((m, E), generator=gen, device=dev) * 0.7
        n0, e0 = qmm_int8.LAUNCHES, qmm.LAUNCHES
        got = qmatmul_mod.qmatmul(x, wt)
        if qmm_int8.LAUNCHES != n0 + 1 or qmm.LAUNCHES != e0:
            raise AssertionError("a Q8_K repack did not take kernel 6")
        check("qmm_int8", f"exact Q8_K n={E} k={E} b={m}", got,
              qmm_int8.qmm_int8_plain(x, wt), 1e-3)
    del wt, flush
    torch.cuda.empty_cache()


def exact_serving_phase(torch, path: Path) -> dict:
    """The exact-dequant mode (fast_mode=None, the loader's and the CLI's
    default) on the 32-layer Q4_K_M file of gguf_phase: 3 requests (64-token
    prefill, 32 greedy tokens) on the default context, which keeps the
    mixed layers unrolled as JAX does.  Kernel 4's exact branch takes every
    projection at every step: per forward 4 in each of the 16 uniform
    layers (fused q|k|v and gate|up), 6 in each of the 16 with a Q6_K attn_v
    (q, k and v apart) and the lm_head, 161; kernel 3 attends; kernels 1, 2,
    5, 6 and 7 never launch.  Then tools/main.py without --fast-mode.
    Returns {path: launch counts}."""
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.ops.cuda import (flash, qmm, qmm_int8, qmm_w4, qmm_w4_ffn,
                                                 qmm_w4x, qmm_w8)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, params, f = load_gguf_model(path, fuse=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    f.close()
    w_bytes = streamed_bytes(params)
    log(json.dumps({"phase": "gguf_exact", "n_layer": cfg.n_layer, "load_s": load_s,
                    "w_bytes_per_tok": w_bytes, "w_floor_ms_per_tok": w_bytes / HBM_BYTES_S * 1e3,
                    "device_bytes": torch.cuda.memory_allocated(),
                    "layouts": sorted({(key, v.qtype.name, v.bits, v.group_size)
                                       for lp in params["layers"] for key, v in lp.items()
                                       if hasattr(v, "codes")})}))
    never = (qmm_w4, qmm_w4_ffn, qmm_w8, qmm_int8, qmm_w4x)
    counts, ctx = serve(torch, cfg, params, (qmm, exact_counter(), flash), "gguf_exact",
                        never=never)
    want = {"qmm": 3 * 32 * 161, "qmm_exact": 3 * 32 * 161, "flash": 3 * 32 * 32}
    if "layers" not in ctx.params or counts != want:
        raise AssertionError(f"gguf_exact: launches {counts}, expected {want} unrolled")
    profile_decode(torch, ctx, cfg, "gguf_exact")
    del ctx, params
    torch.cuda.empty_cache()
    # the CLI with JAX's default flags: no --fast-mode
    for m in (qmm, exact_counter()) + never:
        m.LAUNCHES = 0
    stats, out, seconds = cli_run("exact", ["-m", str(path), "-p", CLI_PROMPT, "-n", "16",
                                            "--temp", "0", "-c", "512"])
    cli_counts = {mod_name(m): m.LAUNCHES for m in (qmm, exact_counter()) + never}
    log(json.dumps({"phase": "cli_exact", "seconds": seconds, "runs": run_times(stats),
                    "launches": cli_counts}))
    if not out.startswith(CLI_PROMPT) or not cli_counts["qmm_exact"] or any(
            cli_counts[mod_name(m)] for m in never):
        raise AssertionError(f"cli_exact: output or launches {cli_counts}")
    return {"gguf_exact": counts, "cli_exact": {k: cli_counts[k] for k in ("qmm", "qmm_exact")}}


def new_formats_phase(torch, tmpdir: Path) -> dict:
    """A full-width EARLIER_LAYERS-layer llama3-8B file of the every-format mix
    (every_format_layer_types: Q5_0, Q5_1, Q2_K, Q3_K, Q5_K, Q4_0, Q4_1,
    Q8_0, Q6_K and Q4_K on its 7 matrices a layer, none fused; Q5_K token_embd, Q6_K
    output) loaded in all four modes, each serving 3 requests (64-token
    prefill, 8 greedy tokens) on the default context with its launch
    counts: the W8 folds of the new formats on kernel 5 (w4; its dual-plane
    branch in w4x), the 4-bit formats on kernels 1 (w4) and 7 (w4x),
    prefill rows on kernel 4; Q8F on kernel 6 (int8, whose uniform layers
    stack: kernel 9 attends); exact repacks on kernel 4's exact branch, 29
    launches a forward (exact).  The mixed modes stay unrolled (kernel 3).
    Then an EARLIER_LAYERS-layer all-Q8_0 file in the exact mode: its uniform layers
    stack, so kernel 9 attends and kernel 4's exact branch takes 17
    launches a forward.
    Returns {path: launch counts}."""
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.ops.cuda import (flash, flash_stacked, qmm, qmm_int8, qmm_w4,
                                                 qmm_w4_ffn, qmm_w4x, qmm_w8)

    L, n_new = EARLIER_LAYERS, 8
    path, wrote = child_file(tmpdir, "llama3-8b-every-format.gguf")  # file_specs' seeds
    size = wrote["bytes"]
    ex, precise = exact_counter(), w8_precise()
    every = (flash, flash_stacked, qmm, ex, qmm_w4, qmm_w4_ffn, qmm_w8, precise, qmm_int8,
             qmm_w4x)
    # mode: the kernels that must launch (the rest of `every` must not); in
    # the int8 mode every matrix is Q8F, so the layers are uniform and stack
    modes = {None: (flash, qmm, ex), "w4": (flash, qmm, qmm_w4, qmm_w8),
             "w4x": (flash, qmm, qmm_w4x, precise), "int8": (flash_stacked, qmm_int8)}
    counts = {}
    for mode, mods in modes.items():
        label = f"every_format_{mode or 'exact'}"
        cfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True)
        f.close()
        log(json.dumps({"phase": label, "file_bytes": size, "w_bytes_per_tok":
                        streamed_bytes(params), "layouts": sorted(
                            {(v.qtype.name, v.flavor or "exact") for lp in params["layers"]
                             for v in lp.values() if hasattr(v, "codes")})}))
        counts[label], ctx = serve(torch, cfg, params, mods, label, n_new=n_new,
                                   never=tuple(m for m in every if m not in mods))
        if mode is None and counts[label] != {"flash": 3 * n_new * L,
                                              "qmm": 3 * n_new * (7 * L + 1),
                                              "qmm_exact": 3 * n_new * (7 * L + 1)}:
            raise AssertionError(f"{label}: launches {counts[label]}")
        del ctx, params
        torch.cuda.empty_cache()
    path.unlink()
    path, _ = child_file(tmpdir, "llama3-8b-q8_0.gguf")
    cfg, params, f = load_gguf_model(path, fuse=True)
    f.close()
    counts["q8_0_exact_stacked"], ctx = serve(
        torch, cfg, params, (flash_stacked, qmm, ex), "q8_0_exact_stacked", n_new=n_new,
        never=tuple(m for m in every if m not in (flash_stacked, qmm, ex)))
    want = {"flash_stacked": 3 * n_new * L, "qmm": 3 * n_new * (4 * L + 1),
            "qmm_exact": 3 * n_new * (4 * L + 1)}
    if "layers_stacked" not in ctx.params or counts["q8_0_exact_stacked"] != want:
        raise AssertionError(f"q8_0_exact_stacked: {counts['q8_0_exact_stacked']}, want {want}")
    del ctx, params
    path.unlink()
    torch.cuda.empty_cache()
    return counts


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


def routed_bytes(cfg, params) -> tuple:
    """(every weight byte, the bytes a one-token step must read):
    streamed_bytes with each MoE layer's experts (a stacked repack, or a
    list of per-expert folds, which streamed_bytes leaves out) counted
    whole, and at the share a decode token routes to, n_expert_used of
    n_expert."""
    stacked = experts = 0
    for lp in params["layers"]:
        for key, v in lp.items():
            if key.endswith("_exps"):
                stacked += 0 if isinstance(v, list) else nbytes(v, w4_planes(v))
                experts += sum(nbytes(w, w4_planes(w))
                               for w in (v if isinstance(v, list) else [v]))
    dense = streamed_bytes(params) - stacked
    return dense + experts, dense + experts * cfg.n_expert_used // max(cfg.n_expert, 1)


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


def serving_phase(torch, n_layer: int = 32) -> tuple:
    """3 requests on the full llama3-8B W4A8 model in each configuration;
    returns ({path: launch counts}, cfg, params): the model goes on to
    speculative_phase."""
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
    return by_path, cfg, params


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


def tinyllama_phase(torch, n_layer: int = 22) -> dict:
    """The JAX package's tinyllama-1.1b preset at full width, n_layer of its
    22 layers (head dim 64: 32 query heads on 4 kv heads; F = 5632, whose down
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
    cfg = preset_config("tinyllama-1.1b", n_layer=n_layer)
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
    from llama_kotlin_tpu_torch.ops.cuda import (flash, flash_stacked, qmm, qmm_w4, qmm_w4_ffn,
                                                 qmm_w4_fx, qmm_w4_layer, qmm_w8)

    path, wrote = child_file(tmpdir, "llama3-8b-q4_0.gguf")
    log(json.dumps({"phase": "gguf_q4_0", "file_bytes": wrote["bytes"], **wrote}))
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
    """3 requests on the full-width llama3-8B W4X model, n_layer of its 32
    layers (every matrix a precise
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
    (models/llama.py::attend_stacked_plain, counted as often) and neither
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
        route = CallCounter(llama, "attend_stacked_plain")
        try:
            counts, ctx = serve(torch, cfg, params, mods + (route,), path,
                                never=(flash, flash_stacked), kv_quant="q4_0")
        finally:
            route.close()
        log(json.dumps({"phase": path, "attention_route": route.__name__,
                        "route_calls": counts["attend_stacked_plain"]}))
        if counts["attend_stacked_plain"] != steps or "layers_stacked" not in ctx.params:
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
    default (stacked) context with a q8_0 cache.  The file stays in tmpdir
    for cli_phase.  Returns {path: launch counts}."""
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.ops.cuda import (flash, flash_stacked, qmm, qmm_int8, qmm_w4,
                                                 qmm_w4_ffn, qmm_w4x, qmm_w8)

    path, written = child_file(tmpdir, LLAMA_FILE)
    log(json.dumps({"phase": "gguf", "file_bytes": written.pop("bytes"), **written}))
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
    return counts


# cli_phase's prompt: 90 pieces of the synthetic vocab, so the prefill's
# rows take kernel 4 (more than qmm_w4.MAX_ROWS)
CLI_PROMPT = ("The quick brown fox jumps over the lazy dog while the cat sleeps by the "
              "warm fire, and a small bird sings a song about rain, rivers, hills and "
              "the long road home in 1984.")
CLI_SCHEMA = json.dumps({"type": "object", "properties": {"name": {"type": "string"},
                                                          "age": {"type": "integer"}},
                         "required": ["name", "age"]})


def cli_run(label: str, argv: list, stdin: str = None) -> tuple:
    """tools/main.py in process with its stdout captured (so that this
    script's own last line stays its result): (the CLI's stats, its
    stdout, seconds)."""
    import gc
    import io

    import torch

    from llama_kotlin_tpu_torch.tools import main as cli

    old_stdin = sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            stats = cli.main(argv)
    finally:
        sys.stdin = old_stdin
    seconds = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    for r in stats["runs"]:
        if not r["tokens"]:
            raise AssertionError(f"cli {label}: a generation drew no token")
    return stats, buf.getvalue(), seconds


def run_times(stats: dict) -> list:
    return [{k: r[k] for k in ("prompt_tokens", "ttft_ms", "ms_per_token")}
            | {"tokens": len(r["tokens"])} for r in stats["runs"]]


def cli_phase(torch, path: Path) -> dict:
    """The text path on the 32-layer Q4_K_M file of gguf_phase (seed 7, w4,
    fused), through the port's entry points: (a) tools/tokenize.py and a
    decode round trip; (b) tools/main.py at a seed, twice: equal texts;
    (c) --json-schema: every token accepted in turn by a fresh
    GrammarSampler; (d) --prompt-cache: a first run writes the session, a
    second run restored from it reports full reuse, and the logits a
    restored run samples from lie within 3e-2 of max|logits| of a fresh
    one-row step's (restore_gap); (e)
    --interactive, two turns and /exit on stdin; (f) tools/simple.py at
    greedy: its text is generate()'s greedy ids; (g) generate() with a
    sampling SampleParams three times (equal ids), at temp 0 the greedy
    ids, its decode loop run with every host sync an error; (h)
    sample_rows_device under grammar and random masks: every id inside its
    row's mask; (i) the card's _sample stages before the draw against the
    CPU's on the same logits rows.  Logs the cli line (each run's TTFT and
    ms/token, generate()'s, the host sampler chain's and the grammar
    filter's ms a token at vocab 128256).  Returns the launch counts of
    kernels 1-5 over the phase, all of which must launch."""
    import io
    import shutil as sh

    import numpy as np

    from llama_kotlin_tpu_torch.gguf.reader import GGUFFile
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.ops.cuda import flash, qmm, qmm_w4, qmm_w4_ffn, qmm_w8
    from llama_kotlin_tpu_torch.runtime import generate as gen
    from llama_kotlin_tpu_torch.runtime.batch import Batch
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.sampling.grammar import GrammarSampler
    from llama_kotlin_tpu_torch.sampling.json_schema import json_schema_to_gbnf
    from llama_kotlin_tpu_torch.sampling.samplers import Candidates, SamplerChain, SamplingParams
    from llama_kotlin_tpu_torch.tokenizer import build_tokenizer
    from llama_kotlin_tpu_torch.tools import simple
    from llama_kotlin_tpu_torch.tools import tokenize as tok_tool

    mods = (qmm_w4, qmm_w4_ffn, flash, qmm, qmm_w8)
    for m in mods:
        m.LAUNCHES = 0
    t_phase = time.perf_counter()
    line: dict = {"phase": "cli", "file": path.name}
    f = GGUFFile(path)
    tok = build_tokenizer(f.metadata)
    f.close()
    V = tok.vocab.n_tokens
    # (a) the tokenize tool prints one line a token; decode gives the text back
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ids = tok_tool.tokenize(str(path), CLI_PROMPT)
    if len(buf.getvalue().splitlines()) != len(ids) or tok.decode(ids) != CLI_PROMPT \
            or ids != tok.encode(CLI_PROMPT) or len(ids) <= qmm_w4.MAX_ROWS:
        raise AssertionError("cli: tokenize tool or decode round trip")
    line["prompt_tokens"] = len(ids)
    base = ["-m", str(path), "--fast-mode", "w4", "--device", "cuda"]
    sampled = ["--temp", "0.8", "--top-k", "40", "--top-p", "0.95", "--min-p", "0.05"]
    # (b) the CLI at a seed, twice
    argv = base + ["-p", CLI_PROMPT, "-n", "32", "--seed", "42"] + sampled
    b1, out1, s1 = cli_run("seed", argv)
    b2, out2, s2 = cli_run("seed", argv)
    if out1 != out2 or b1["runs"][0]["tokens"] != b2["runs"][0]["tokens"]:
        raise AssertionError("cli: two runs at one seed differ")
    line["main"] = run_times(b1) + run_times(b2)
    line["main_s"] = [s1, s2]
    # (c) a JSON schema: every token legal in turn
    c, _, _ = cli_run("json", base + ["-p", "Reply in JSON:", "-n", "16", "--seed", "3",
                                      "--json-schema", CLI_SCHEMA] + sampled)
    g = GrammarSampler(json_schema_to_gbnf(CLI_SCHEMA))
    for t in c["runs"][0]["tokens"]:
        if t != tok.vocab.eos_id and not g.token_allowed(t, tok, eos_id=tok.vocab.eos_id):
            raise AssertionError(f"cli: token {t} outside the grammar")
        g.accept_token(t, tok, eos_id=tok.vocab.eos_id)
    line["json"] = run_times(c) + [{"text": c["runs"][0]["text"]}]
    # (d) the prompt cache: a run restored from the first run's session
    # (restore_gap measures its logits once the fused weights are loaded)
    cache, first_session = path.parent / "prompt.session", path.parent / "first.session"
    argv = base + ["-p", CLI_PROMPT, "-n", "8", "--seed", "5", "--prompt-cache", str(cache)]
    d0, _, _ = cli_run("cache", argv)
    sh.copy(cache, first_session)
    d1, _, _ = cli_run("cache", argv)
    cache.unlink()
    if d1.get("session_reuse") != len(ids) - 1:
        raise AssertionError("cli: the restored run did not reuse the whole prompt")
    line["prompt_cache"] = {"reuse": d1["session_reuse"], "of": len(ids),
                            "first_run_text_equal": d0["runs"][0]["tokens"] == d1["runs"][0][
                                "tokens"], "runs": run_times(d0) + run_times(d1)}
    # (e) interactive: two turns on stdin
    e, out_e, _ = cli_run("interactive", base + ["--interactive", "-n", "8", "--seed", "9"],
                          stdin="Tell me about the fox.\nAnd the dog?\n/exit\n")
    if len(e["runs"]) != 2 or e["runs"][1]["prompt_tokens"] <= e["runs"][0]["prompt_tokens"]:
        raise AssertionError("cli: interactive turns")
    line["interactive"] = run_times(e)
    # (f) tools/simple.py at greedy against generate() on the same (unfused) load
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if simple.main([str(path), CLI_PROMPT, "16", "--fast-mode", "w4", "--device", "cuda"]) != 0:
            raise AssertionError("cli: simple failed")
    cfg, params, f = load_gguf_model(path, fast_mode="w4", device="cuda")
    f.close()
    ctx = LlamaContext(cfg, params, n_cells=max(256, len(ids) + 24), device="cuda")
    greedy = gen.generate(ctx, ids, 16)
    upto = greedy[:greedy.index(tok.vocab.eos_id)] if tok.vocab.eos_id in greedy else greedy
    if buf.getvalue() != CLI_PROMPT + "".join(tok.decode([t], skip_special=False)
                                              for t in upto) + "\n":
        raise AssertionError("cli: simple's greedy text is not generate()'s")
    del ctx, params
    torch.cuda.empty_cache()
    # (g) generate() on the fused load (the CLI's): a sampling SampleParams
    # three times, temp 0; TTFT (prefill and first sample) and the decode
    # loop timed inside each run, the loop with every host sync an error
    cfg, params, f = load_gguf_model(path, fast_mode="w4", fuse=True, device="cuda")
    f.close()
    line["prompt_cache"]["logits_gap"] = restore_gap(torch, cfg, params, ids, first_session)
    first_session.unlink()
    new_ctx = lambda: LlamaContext(cfg, params, n_cells=1024, device="cuda")  # noqa: E731
    sp = gen.SampleParams(temp=0.8, top_k=40, top_p=0.95, penalty_last_n=64,
                          penalty_repeat=1.1, seed=1)
    marks: list = []
    loop = gen.generate_loop

    def checked_loop(*args, **kw):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = loop(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return res

    def timed_generate(n: int, params_: gen.SampleParams) -> tuple:
        ctx = new_ctx()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen.generate(ctx, ids, n, params_)
        return out, {"ttft_ms": (marks[-2] - t0) * 1e3,
                     "ms_per_token": (marks[-1] - marks[-2]) * 1e3 / n}

    gen.generate_loop = checked_loop
    try:
        runs = [timed_generate(32, sp) for _ in range(3)]  # the first warms up
        at_t0, _ = timed_generate(32, sp._replace(temp=0.0))
        greedy32, _ = timed_generate(32, gen.SampleParams())
    finally:
        gen.generate_loop = loop
    if any(out != runs[0][0] for out, _ in runs) or at_t0 != greedy32:
        raise AssertionError("cli: generate() does not repeat itself, or temp 0 is not greedy")
    line["generate"] = {"runs": [t for _, t in runs], "steps": 32}
    # (h) sample_rows_device under masks; (i) the card's stages vs the CPU's
    ctx = new_ctx()
    out_rows = np.zeros(len(ids), bool)
    out_rows[-4:] = True
    if ctx.decode(Batch(np.asarray(ids), np.arange(len(ids)), np.zeros(len(ids), np.int32),
                        out_rows)) != 0:
        raise AssertionError("cli: prefill")
    rng = np.random.default_rng(13)
    masks = rng.random((4, V)) < 0.05
    masks[0] = masks[1] = GrammarSampler(json_schema_to_gbnf(CLI_SCHEMA)).allowed_mask(
        tok, V, eos_id=tok.vocab.eos_id)
    spv = {"temp": np.array([0.0, 0.8, 0.0, 1.2], np.float32),
           "top_k": np.array([0, 40, 0, 0]), "top_p": np.array([1.0, 0.95, 1.0, 0.9], np.float32),
           "min_p": np.array([0.0, 0.05, 0.0, 0.0], np.float32), "seed": np.array([1, 2, 3, 4])}
    pos = np.full(4, len(ids))
    picked = ctx.sample_rows_device(np.arange(4), gen.SampleParams(top_k=64), spv, pos,
                                    masks=masks)
    host = ctx.get_logits()
    for r in range(4):
        if not masks[r, picked[r]]:
            raise AssertionError(f"cli: sample_rows_device drew {picked[r]} outside row {r}'s mask")
        if spv["temp"][r] == 0 and picked[r] != int(np.argmax(np.where(masks[r], host[r],
                                                                        -np.inf))):
            raise AssertionError("cli: sample_rows_device's greedy row is not the masked argmax")
    line["sample_rows_device"] = {"ids": picked.tolist(), "mask_sizes": masks.sum(1).tolist()}
    line["stages"] = stage_parity(torch, gen, ctx.logits_device(), V, rng)
    # host costs a token at vocab V: the logits' copy and the sampler chain,
    # and the grammar filter's sweep (a fresh grammar text: cold tables)
    chain = SamplerChain(SamplingParams(seed=1), V)
    costs = {"copy": [], "chain": []}
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = ctx.get_logits()[-1]
        t1 = time.perf_counter()
        chain.accept(chain.sample(lg, tokenizer=tok), tokenizer=tok)
        costs["copy"].append((t1 - t0) * 1e3)
        costs["chain"].append((time.perf_counter() - t1) * 1e3)
    g = GrammarSampler(json_schema_to_gbnf(CLI_SCHEMA) + "\n# cold tables\n")
    sweeps = []
    for ch in '{"name": "':
        t0 = time.perf_counter()
        m = g.allowed_mask(tok, V, eos_id=tok.vocab.eos_id)
        sweeps.append((time.perf_counter() - t0) * 1e3)
        g.accept_token(tok.vocab.token_to_id["▁" if ch == " " else ch], tok)
    g.allowed_mask(tok, V, eos_id=tok.vocab.eos_id)  # this state's sweep, then memo hits
    memo = []
    for _ in range(8):
        t0 = time.perf_counter()
        g.filter_candidates(Candidates.from_logits(lg), tok, eos_id=tok.vocab.eos_id,
                            vocab_size=V)
        memo.append((time.perf_counter() - t0) * 1e3)
    line["host_ms_per_token"] = {
        "logits_copy": statistics.median(costs["copy"]),
        "sampler_chain": statistics.median(costs["chain"]),
        "grammar_sweep_cold": sweeps, "grammar_filter_memo": statistics.median(memo)}
    del ctx, params
    torch.cuda.empty_cache()
    counts = {mod_name(m): m.LAUNCHES for m in mods}
    line["launches"] = counts
    line["seconds"] = time.perf_counter() - t_phase
    log(json.dumps(line))
    if not all(counts.values()):
        raise AssertionError(f"cli: a kernel of the w4 path was never launched: {counts}")
    return counts


def restore_gap(torch, cfg, params, ids: list, session: Path) -> dict:
    """(d)'s restore, measured: the logits the restored run samples its
    first token from (the last prompt token re-fed as a one-row step over
    the session's cells) against a one-row step after a fresh prefill of
    the prompt less its last token, and both against the first run's (the
    last row of the whole prompt's prefill), each gap a share of
    max|logits|.  The restored step must lie within 3e-2 of the fresh one,
    the card-vs-CPU tolerance of parity_phase: a wrong restore (cells,
    scales, the ring pointer) moves it further.  The one-row step against
    the prefill's row is also taken on the first 2 and 8 layers, to show
    how that gap grows with depth."""
    import dataclasses

    import numpy as np

    from llama_kotlin_tpu_torch.runtime import state as state_io
    from llama_kotlin_tpu_torch.runtime.batch import Batch
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.tools.main import build_argparser

    n, n_ctx = len(ids), build_argparser().get_default("n_ctx")  # the CLI's context

    def last_logits(ctx, toks: list, start: int):
        out = np.zeros(len(toks), bool)
        out[-1] = True
        if ctx.decode(Batch(np.asarray(toks, np.int32),
                            np.arange(start, start + len(toks), dtype=np.int32),
                            np.zeros(len(toks), np.int32), out)) != 0:
            raise AssertionError("cli: a decode of the restore check failed")
        return ctx.logits_device()[-1].float().clone()

    def first_and_step(n_layer: int) -> tuple:
        c = dataclasses.replace(cfg, n_layer=n_layer)
        p = dict(params, layers=params["layers"][:n_layer])
        first = last_logits(LlamaContext(c, p, n_cells=n_ctx, device="cuda"), ids, 0)
        ctx = LlamaContext(c, p, n_cells=n_ctx, device="cuda")
        last_logits(ctx, ids[:-1], 0)
        return first, last_logits(ctx, ids[-1:], n - 1)

    def gap(a, b, first) -> float:
        return float((a - b).abs().max()) / float(first.abs().max())

    first, stepped = first_and_step(cfg.n_layer)
    ctx = LlamaContext(cfg, params, n_cells=n_ctx, device="cuda")
    if list(state_io.load_session_file(ctx, session)) != list(ids):
        raise AssertionError("cli: the session file holds other tokens")
    ctx.seq_rm(0, n - 1, -1)  # what tools/main.py does on a full match
    restored = last_logits(ctx, ids[-1:], n - 1)
    del ctx
    gaps = {"restored_vs_fresh_step": gap(restored, stepped, first),
            "restored_vs_first": gap(restored, first, first),
            "fresh_step_vs_first_by_layers": {cfg.n_layer: gap(stepped, first, first)}}
    for k in (2, 8):
        f_k, s_k = first_and_step(k)
        gaps["fresh_step_vs_first_by_layers"][k] = gap(s_k, f_k, f_k)
    if not gaps["restored_vs_fresh_step"] <= 3e-2:
        raise AssertionError(f"cli: the restored logits are off a fresh step's: {gaps}")
    return gaps


def stage_parity(torch, gen, logits, V: int, rng) -> dict:
    """(i) _sample's stages before the draw on the card against the CPU's on
    the same logits rows, with penalties (a token window's counts), top-k,
    top-p, min-p and on the per-row path: window ids and keep masks equal
    (but for keep entries whose cumulative probability lies within 1e-5 of
    top_p, where f32 rounding may decide either way; counted), scaled
    logits within 1e-6 relative; the draws equal given the same noise."""
    import numpy as np

    cpu = logits.float().cpu()
    window = torch.from_numpy(rng.integers(-1, V, (logits.shape[0], 64)))
    counts = gen._window_counts(window, V)
    cases = {"chain": (gen.SampleParams(temp=0.8, top_k=40, top_p=0.95, min_p=0.05,
                                        penalty_last_n=64, penalty_repeat=1.1,
                                        penalty_present=0.2), None),
             "spv": (gen.SampleParams(top_k=64), {
                 "temp": torch.tensor([0.7, 0.0, 1.0, 1.3]), "top_k": torch.tensor([40, 0, 64, 8]),
                 "top_p": torch.tensor([0.9, 1.0, 0.95, 1.0]),
                 "min_p": torch.tensor([0.0, 0.0, 0.05, 0.1])})}
    out = {}
    for name, (sp, spv) in cases.items():
        dev = logits.device
        dev_spv = None if spv is None else {k: v.to(dev) for k, v in spv.items()}
        a = gen.sample_stages(logits, sp, counts.to(dev) if spv is None else None, dev_spv)
        b = gen.sample_stages(cpu, sp, counts if spv is None else None, spv)
        if not torch.equal(a.ids.cpu(), b.ids):
            raise AssertionError(f"cli stages {name}: window ids differ")
        top_p = (torch.full((cpu.shape[0],), sp.top_p) if spv is None else spv["top_p"]).double()
        vals = torch.gather(gen.penalize(cpu, sp, counts if spv is None else None), 1,
                            b.ids).double()
        if spv is not None:  # the per-row top-k cut comes before the softmax
            kcap = torch.where(spv["top_k"] > 0, spv["top_k"], vals.shape[1])[:, None]
            vals = torch.where(torch.arange(vals.shape[1])[None] < kcap, vals, -np.inf)
        pv = torch.softmax(vals, -1)
        near = ((torch.cumsum(pv, -1) - pv - top_p[:, None]).abs() <= 1e-5) & (top_p[:, None] < 1)
        differ = (a.keep.cpu() != b.keep) & ~near
        if differ.any():
            raise AssertionError(f"cli stages {name}: keep masks differ")
        fin = torch.isfinite(b.scaled) & (a.keep.cpu() == b.keep)
        rel = ((a.scaled.cpu() - b.scaled).abs() / b.scaled.abs().clamp_min(1e-30))[fin]
        if float(rel.max()) > 1e-6:
            raise AssertionError(f"cli stages {name}: scaled logits {float(rel.max())} apart")
        noise = gen.gumbel_noise(gen.shared_key(7, 100, cpu.shape[0], "cpu"), b.scaled.shape[1])
        dev_noise = gen.gumbel_noise(gen.shared_key(7, 100, cpu.shape[0], dev),
                                     b.scaled.shape[1])
        same = torch.equal(gen.draw(a, noise.to(dev)).cpu(), gen.draw(b, noise))
        out[name] = {"max_rel_scaled": float(rel.max()), "kept": int(b.keep.sum()),
                     "near_top_p": int(near.sum()), "draws_equal": same,
                     "noise_max_abs_diff": float((dev_noise.cpu() - noise).abs().max())}
        if not same and not near.any():
            raise AssertionError(f"cli stages {name}: draws differ given the same noise")
    return out


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


def profile_decode(torch, ctx, cfg, label: str, n_steps: int = 8, n_prompt: int = 64,
                   prefill: bool = True) -> None:
    """Where the time goes: torch.profiler traces of an n_prompt-token
    prefill (unless prefill=False: the prefill runs untraced) and of n_steps
    greedy steps after it.  Device busy time is the sum of the kernels'
    device times (one stream, so they do not overlap); the idle share is
    the rest of the wall time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from llama_kotlin_tpu_torch.runtime.batch import Batch
    from llama_kotlin_tpu_torch.runtime.generate import generate_loop

    ctx.clear()
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, n_prompt).astype(np.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if prefill \
            else contextlib.nullcontext() as prof:
        t0 = time.perf_counter()
        assert ctx.decode(Batch.single(prompt)) == 0
        first = torch.argmax(ctx.logits_device()[:1], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if prefill:
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
    cpu_params = params_to(params, "cpu")

    def greedy(dev):
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
        return logits

    # the CPU's greedy run (its tokens are the argmax of its logits)
    cl = cpu_ref("parity", lambda: greedy("cpu"))
    ct = [int(np.argmax(b)) for b in cl]
    gl = None if REFS["writer"] else greedy("cuda")
    gt = None if gl is None else [int(np.argmax(a)) for a in gl]
    errs = [] if gl is None else [float(np.abs(a - b).max() / np.abs(b).max())
                                  for a, b in zip(gl, cl)]
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
    if not REFS["writer"]:
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


# The card-vs-CPU parity phases' CPU references run in child processes of
# this script (``--cpu-refs DIR FILES_DIR GROUP``), started at the
# beginning, so that they overlap the card's phases: a child runs its
# group's parity phases with REFS["writer"] set, computes each CPU
# reference (cpu_ref) into DIR and skips the card runs; the parent reads
# each reference there when its card run needs it, waiting for the
# children.  CPU_REF_GROUPS: (intra-op threads, the parity phases whose
# references the child computes, in the order the parent asks for them).
# Two children at 4 and 3 threads computed the Qwen, Falcon/StarCoder and
# sweep references in 128 s where one at 7 took 220 s (the H100 machine's
# 8-core host; these references are many small ops that scale poorly with
# threads), so the phases are split in two halves of about equal time
CPU_REF_GROUPS = ((4, ("qwen_parity_phase", "parity_phase", "gguf_parity_phase",
                        "large_moe_parity_phase")),
                  (3, ("gpt_parity_phase", "arch_sweep_phase", "engine_parity_phase",
                       "moe_parity_phase", "gemma_parity_phase", "iq_parity_phase",
                       "llama70b_parity_phase")))
REFS: dict = {"dir": None, "writer": False, "children": [], "logs": []}


def cpu_ref(label: str, compute) -> list:
    """The CPU reference `label` of a parity check: compute() (a list of
    logits rows) where no child computes it, written to the reference
    directory in the child, read from there in the parent."""
    import numpy as np

    if REFS["dir"] is None:
        return compute()
    path = Path(REFS["dir"]) / f"{label}.npy"
    if REFS["writer"]:
        t0 = time.perf_counter()
        rows = compute()
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as fh:
            np.save(fh, np.stack([np.asarray(r, np.float32) for r in rows]))
        os.replace(tmp, path)
        log(json.dumps({"phase": "cpu_ref", "label": label,
                        "seconds": time.perf_counter() - t0}))
        return rows
    t0 = time.perf_counter()
    while not path.exists():
        for child, log_path in zip(REFS["children"], REFS["logs"]):
            if child.poll() not in (None, 0) or all(
                    c.poll() is not None for c in REFS["children"]):
                if path.exists():
                    break
                tail = Path(log_path).read_text()[-4000:]
                raise AssertionError(f"a CPU reference process ended (rc {child.returncode}) "
                                     f"without {label}:\n{tail}")
        time.sleep(0.2)
    log(json.dumps({"phase": "cpu_ref_wait", "label": label,
                    "seconds": time.perf_counter() - t0}))
    return list(np.load(path))


# The largest files (the 32-layer llama3-8B Q4_K_M file of gguf_phase, 4.9
# GB, the every-IQ files, the DeepSeek-V2-Lite file of its first
# EARLIER_LAYERS layers and the gemma-2-9b file) are
# written by another child of this script
# (``--write-files DIR``), started with the CPU references, so that they
# overlap the card's earlier phases; each phase that reads one waits for it
# (logging the wait) and moves it into its own directory.  A phase called
# alone writes its file itself.
FILES: dict = {"dir": None, "child": None, "log": None}
LLAMA_FILE = "llama3-8b-q4_k_m.gguf"
DS2_FILE = "deepseek-v2-lite-q4_k_m.gguf"
GEMMA2_FILE = "gemma-2-9b-q4_k_m.gguf"
DBRX_FILE = "dbrx-q4_k_m.gguf"
GEMMA_SEED = 17
IQ_FILE = "llama3-8b-every-iq.gguf"
IQ_PARITY_FILE = "llama3-8b-2layer-every-iq.gguf"
IQ_SEED = 21


def _written(path: Path, cfg, **kw) -> dict:
    """synthetic_gguf(path, cfg, **kw) through a temporary name and a
    rename, so that the name appears only once the file is whole."""
    from llama_kotlin_tpu_torch.models.synthetic import synthetic_gguf

    t0 = time.perf_counter()
    tmp = path.with_suffix(".part")
    size = synthetic_gguf(tmp, cfg, **kw)
    os.replace(tmp, path)
    return {"bytes": size, "write_s": time.perf_counter() - t0}


def write_llama_file(path: Path) -> dict:
    """gguf_phase's file: the 32-layer llama3-8B Q4_K_M mix from seed 7 with
    an SPM vocab of its 128256 pieces and a Llama-2 chat template, which
    cli_phase reads (the loader ignores these keys)."""
    from llama_kotlin_tpu_torch.models.synthetic import preset_config, synthetic_spm_vocab

    return _written(path, preset_config("llama3-8b"), seed=7,
                    extra_kvs=synthetic_spm_vocab(128256))


def write_ds2_file(path: Path) -> dict:
    """deepseek2_phase's file: DeepSeek-V2-Lite (deepseek_v2_lite(), its
    first EARLIER_LAYERS layers) from DS2_SEED with an SPM vocab of its
    102400 pieces."""
    from llama_kotlin_tpu_torch.models.synthetic import deepseek_v2_lite, synthetic_spm_vocab

    cfg, moe_shape = deepseek_v2_lite(n_layer=EARLIER_LAYERS)
    return _written(path, cfg, seed=DS2_SEED, moe=moe_shape,
                    extra_kvs=synthetic_spm_vocab(cfg.vocab_size))


def write_gemma2_file(path: Path) -> dict:
    """gemma2_phase's file: gemma-2-9b (gemma2_9b(), its first
    EARLIER_LAYERS layers since llama3-70b's phase came) from GEMMA_SEED
    with an SPM vocab of its 256000 pieces (no chat template: the gemma
    template is the arch's default)."""
    from llama_kotlin_tpu_torch.models.synthetic import gemma2_9b, synthetic_spm_vocab

    cfg = gemma2_9b(n_layer=EARLIER_LAYERS)
    return _written(path, cfg, seed=GEMMA_SEED,
                    extra_kvs=synthetic_spm_vocab(cfg.vocab_size, chat_template=None))


def gemma_parity_files() -> dict:
    """gemma_parity_cases' 2-layer files: {name: (config, synthetic_gguf's
    keywords)}.  gemma-2-9b's widths with the file's window at 32 cells,
    under the 64-token prompt (so it bites on layer 0); gemma-7b's widths
    with both layers all Q4_K (uniform, so the context stacks)."""
    from llama_kotlin_tpu_torch.models.synthetic import gemma2_9b, gemma_7b

    return {"gemma2-2layer.gguf": (replace(gemma2_9b(n_layer=2), swa_window=32), {}),
            "gemma7b-2layer.gguf": (gemma_7b(n_layer=2), dict(layer_types=[{}, {}]))}


def write_gemma_parity_file(path: Path) -> dict:
    cfg, kw = gemma_parity_files()[path.name]
    return _written(path, cfg, seed=GEMMA_SEED + 1, **kw)


def file_specs() -> dict:
    """{name: (config, synthetic_gguf's keywords)} of the smaller files the
    writer child writes: gguf_parity_phase's and moe_parity_phase's 2-layer
    files (which the CPU reference process reads too) and the EARLIER_LAYERS-layer files
    of new_formats_phase and q4_0_gguf_phase."""
    from llama_kotlin_tpu_torch.models.synthetic import (deepseek_v2_lite,
                                                         every_format_layer_types, mixtral_8x7b,
                                                         preset_config)
    from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q

    cfg2 = preset_config("llama3-8b", n_layer=2)
    cfg4 = preset_config("llama3-8b", n_layer=EARLIER_LAYERS)
    (ds2, ds2_moe), (mix, mix_moe) = deepseek_v2_lite(n_layer=2), mixtral_8x7b(n_layer=2)
    return {
        "llama3-8b-2layer-q4_k_m.gguf": (cfg2, dict(seed=8)),
        "llama3-8b-2layer-every-format.gguf": (cfg2, dict(
            seed=9, layer_types=every_format_layer_types(2), embd_type=Q.Q5_K)),
        "llama3-8b-2layer-f16-output.gguf": (cfg2, dict(seed=8, output_type=Q.F16)),
        "llama3-8b-2layer-q4_0.gguf": (cfg2, dict(seed=10, matrix_type=Q.Q4_0)),
        "llama3-8b-2layer-q4_1.gguf": (cfg2, dict(seed=10, matrix_type=Q.Q4_1)),
        "deepseek2-2layer.gguf": (ds2, dict(seed=DS2_SEED + 1, moe=ds2_moe)),
        "mixtral-2layer.gguf": (mix, dict(seed=DS2_SEED + 2, moe=mix_moe)),
        "llama3-8b-q4_0.gguf": (cfg4, dict(seed=9, matrix_type=Q.Q4_0)),
        "llama3-8b-every-format.gguf": (cfg4, dict(
            seed=12, layer_types=every_format_layer_types(EARLIER_LAYERS), embd_type=Q.Q5_K)),
        "llama3-8b-q8_0.gguf": (cfg4, dict(seed=13, matrix_type=Q.Q8_0)),
    }


def write_spec_file(path: Path) -> dict:
    cfg, kw = file_specs()[path.name]
    return _written(path, cfg, **kw)


PARITY_FILES = ("llama3-8b-2layer-q4_k_m.gguf", "llama3-8b-2layer-every-format.gguf",
                "llama3-8b-2layer-f16-output.gguf", "llama3-8b-2layer-q4_0.gguf",
                "llama3-8b-2layer-q4_1.gguf")
MOE_PARITY_FILES = ("deepseek2-2layer.gguf", "mixtral-2layer.gguf")
# in writing order: the CPU reference process's first files first (its
# parity_phase needs none), then the parent's in the order its phases read
# them (the IQ files' writers are defined with their phases, further down)
WRITERS = {**{name: lambda p: write_qwen_parity_file(p)
              for name in ("qwen2-2layer.gguf", "qwen2moe-2layer.gguf")},
           **{name: lambda p: write_gpt_parity_file(p)
              for name in ("falcon-2layer.gguf", "starcoder-2layer.gguf")},
           **{name: write_spec_file for name in PARITY_FILES},
           LLAMA_FILE: write_llama_file,
           **{name: write_spec_file for name in MOE_PARITY_FILES},
           "openelm-2layer.gguf": lambda p: write_openelm_parity_file(p),
           "llama3-8b-q4_0.gguf": write_spec_file, "llama3-8b-every-format.gguf": write_spec_file,
           "llama3-8b-q8_0.gguf": write_spec_file, IQ_FILE: lambda p: write_iq_file(p),
           DS2_FILE: write_ds2_file, GEMMA2_FILE: write_gemma2_file,
           **{name: write_gemma_parity_file for name in gemma_parity_files()},
           IQ_PARITY_FILE: lambda p: write_iq_parity_file(p),
           "qwen2-7b-q4_k_m.gguf": lambda p: write_qwen2_file(p),
           "qwen1.5-moe-a2.7b-q4_k_m.gguf": lambda p: write_qwen2moe_file(p),
           "falcon-7b-q4_k_m.gguf": lambda p: write_falcon_file(p),
           "starcoder-15.5b-q4_k_m.gguf": lambda p: write_starcoder_file(p),
           DBRX_FILE: lambda p: write_dbrx_file(p),
           "openelm-3b-q4_k_m.gguf": lambda p: write_openelm_file(p)}
# files both the parent and the CPU reference process read: each takes a
# hard link, and the writer's directory keeps the file to the end
SHARED_FILES = frozenset(PARITY_FILES + MOE_PARITY_FILES + tuple(gemma_parity_files())
                         + (IQ_PARITY_FILE, "qwen2-2layer.gguf", "qwen2moe-2layer.gguf",
                            "falcon-2layer.gguf", "starcoder-2layer.gguf", DBRX_FILE,
                            "openelm-2layer.gguf"))
FILE_WAIT_S = 900  # how long the CPU reference process waits for a file


def write_files_main(out_dir: str) -> int:
    """The file-writer child."""
    try:
        for name, write in WRITERS.items():
            log(json.dumps({"phase": "write_files", "file": name,
                            **write(Path(out_dir) / name)}))
    except Exception:
        traceback.print_exc()
        return 1
    return 0


def start_file_writer(tmp: Path) -> None:
    FILES.update(dir=str(tmp), log=str(tmp / "write_files.log"))
    with open(FILES["log"], "w") as out:
        FILES["child"] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--write-files", str(tmp)],
            stdout=out, stderr=subprocess.STDOUT, cwd=str(Path.cwd()))


def stop_file_writer() -> None:
    """End the writer if it still runs."""
    child = FILES["child"]
    if child is not None and child.poll() is None:
        child.kill()
        child.wait()


def child_file(tmpdir: Path, name: str) -> tuple:
    """(tmpdir / name, its write line): the writer child's file, waited for
    (the file and its line in the writer's log) and moved into tmpdir, or
    hard-linked there for a file of SHARED_FILES; written there now when no
    writer runs.  The CPU reference process has the parent's writer, not
    its process, and waits up to FILE_WAIT_S."""
    path = tmpdir / name
    if FILES["dir"] is None:
        return path, WRITERS[name](path)
    src = Path(FILES["dir"]) / name
    t0 = time.perf_counter()
    child = FILES["child"]

    def line():
        text = Path(FILES["log"]).read_text() if Path(FILES["log"]).exists() else ""
        return next((json.loads(ln) for ln in text.splitlines()
                     if ln.startswith('{"phase": "write_files"') and f'"file": "{name}"' in ln),
                    None)

    while not src.exists() or line() is None:
        if child is not None and child.poll() is not None and line() is None:
            raise AssertionError(f"the file writer ended (rc {child.returncode}) without "
                                 f"{name}:\n{Path(FILES['log']).read_text()[-4000:]}")
        if child is None and time.perf_counter() - t0 > FILE_WAIT_S:
            raise AssertionError(f"no {name} from the file writer in {FILE_WAIT_S} s")
        time.sleep(0.2)
    if name in SHARED_FILES:
        os.link(src, path)
    else:
        os.replace(src, path)
    return path, {k: line()[k] for k in ("bytes", "write_s")} | {
        "wait_s": time.perf_counter() - t0}


def start_cpu_refs(tmp: Path, files_dir: Path):
    """Start the children that compute the CPU references into tmp/refs
    (one a group of CPU_REF_GROUPS), reading the shared files from the
    writer's files_dir."""
    ref_dir = tmp / "refs"
    ref_dir.mkdir()
    REFS.update(dir=str(ref_dir), children=[], logs=[])
    for i, (threads, _) in enumerate(CPU_REF_GROUPS):
        REFS["logs"].append(str(tmp / f"cpu_refs_{i}.log"))
        env = dict(os.environ, OMP_NUM_THREADS=str(threads))
        with open(REFS["logs"][-1], "w") as out:
            REFS["children"].append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--cpu-refs", str(ref_dir),
                 str(files_dir), str(i)], stdout=out, stderr=subprocess.STDOUT, env=env,
                cwd=str(Path.cwd())))


def stop_cpu_refs(check: bool) -> None:
    """Wait for the children (check: each must have ended well) or end
    them."""
    for i, (child, log_path) in enumerate(zip(REFS["children"], REFS["logs"])):
        if not check:
            if child.poll() is None:
                child.kill()
                child.wait()
            continue
        rc = child.wait(timeout=900)
        text = Path(log_path).read_text()
        log(json.dumps({"phase": "cpu_refs", "group": i, "rc": rc,
                        "threads": CPU_REF_GROUPS[i][0],
                        "timings": [json.loads(ln) for ln in text.splitlines()
                                    if ln.startswith('{"phase": "cpu_refs_timing"')]}))
        if rc != 0:
            raise AssertionError("a CPU reference process failed:\n" + text[-4000:])
    if check and REFS["dir"] is not None:
        log(json.dumps({"phase": "cpu_refs", "refs": sorted(
            p.stem for p in Path(REFS["dir"]).glob("*.npy"))}))


def cpu_refs_main(torch, ref_dir: str, files_dir: str = None, group: str = "0") -> int:
    """A child: the CPU references of the parity phases of CPU_REF_GROUPS
    [group], into ref_dir, from the files the parent's writer child writes
    into files_dir (the files are written here when no files_dir is
    given)."""
    REFS.update(dir=ref_dir, writer=True)
    if files_dir is not None:
        FILES.update(dir=files_dir, log=str(Path(files_dir) / "write_files.log"), child=None)
    threads, phases = CPU_REF_GROUPS[int(group)]
    torch.set_num_threads(threads)
    tmp = Path(ref_dir) / f"files_{group}"
    tmp.mkdir()
    try:
        for name in phases:
            fn = globals()[name]
            t0 = time.perf_counter()
            fn(torch, *[tmp][:len(inspect.signature(fn).parameters) - 1])
            log(json.dumps({"phase": "cpu_refs_timing", "function": name,
                            "seconds": time.perf_counter() - t0}))
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def greedy_logits(build, dev, prompt, steps: int, toks=None, shift=None) -> list:
    """build(dev)'s context: a prefill of prompt (then shift(ctx, n) -> the
    next position, when given), then `steps` one-token steps on its greedy
    tokens, or on toks; the last logits row of each."""
    import numpy as np

    from llama_kotlin_tpu_torch.runtime.batch import Batch

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

    def run(dev, toks):
        return greedy_logits(build, dev, prompt, steps, toks, shift)

    cl = cpu_ref(label, lambda: run("cpu", None)) if cpu is None else cpu[1]
    if REFS["writer"]:
        return  # the CPU reference process stops here; the card runs are the parent's
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
    with Q6_K attn_v and ffn_down, Q6_K output), in the w4, int8 and exact
    modes on the unrolled path: the file loaded on the card against the same
    file loaded on the CPU (the CPU repack and the plain versions), by
    card_vs_cpu; a 2-layer file of the every-format mix in the exact mode;
    and the Q4_K_M file with a dense F16 output in the w4 mode."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext

    path, _ = child_file(tmpdir, "llama3-8b-2layer-q4_k_m.gguf")
    prompt = np.random.default_rng(4).integers(0, 128256, 64).astype(np.int32)
    # tol: as in parity_phase, the int8 re-quantization of every matmul
    # input and the bf16 residual stream amplify f32 last-bit differences:
    # on these zero-mean Q4_K_M weights the CPU at one thread differs from
    # itself at eight by up to 2.6e-2 of max|logits| in the w4 mode
    # (PERF.md); 5e-2 is twice that, ~0.25 logit std (logit_std_rel ~0.2),
    # where a wiring fault moves logits by about one std
    tol = 5e-2
    # the exact-dequant mode (None) as well, at the w4 file's tolerance: its
    # bf16 operands carry no int8 re-quantization, so its spread is smaller
    for mode in ("w4", "int8", None):
        def build(dev, mode=mode):
            cfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True, device=dev)
            f.close()
            return LlamaContext(cfg, params, n_cells=1024, buckets=(8, 16, 32, 64),
                                prefer_unrolled=True, device=dev)

        card_vs_cpu(torch, f"gguf_parity_{mode or 'exact'}", build, prompt, tol)
    path.unlink()
    # the every-format mix (each wire format on some matrix) in the exact
    # mode, on the default (unrolled: its layers differ) context
    path, _ = child_file(tmpdir, "llama3-8b-2layer-every-format.gguf")

    def build_every(dev):
        cfg, params, f = load_gguf_model(path, fuse=True, device=dev)
        f.close()
        return LlamaContext(cfg, params, n_cells=1024, buckets=(8, 16, 32, 64), device=dev)

    card_vs_cpu(torch, "gguf_parity_exact_every_format", build_every, prompt, tol)
    path.unlink()
    # a file whose output matrix is dense (F16, a bf16 tensor once loaded):
    # the lm_head is a plain bf16 matmul with an f32 result on both sides
    path, _ = child_file(tmpdir, "llama3-8b-2layer-f16-output.gguf")

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
        path, _ = child_file(tmpdir, f"llama3-8b-2layer-{qtype.name.lower()}.gguf")

        def build_q4(dev):
            cfg, params, f = load_gguf_model(path, fast_mode="w4", fuse=True, device=dev)
            f.close()
            return LlamaContext(cfg, params, n_cells=1024, buckets=(8, 16, 32, 64), device=dev)

        card_vs_cpu(torch, f"gguf_parity_w4_{qtype.name.lower()}", build_q4, prompt, tol,
                    knob_sets=knob_sets)
        path.unlink()


# -- the serving runtime: kernel 3 on serving masks, the engine, the server,
# -- speculative, lookup and lookahead decoding

SERVE_CELLS = 4096  # the server's context: 8 slots of 512 cells
SERVE_PROMPTS = (16, 64, 180, 400)  # tokens of the greedy /completion requests
SERVE_SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}},
                "required": ["ok"]}
SPEC_PROMPT, SPEC_NEW, SPEC_DRAFT = 64, 32, 5
SPEC_TOL = 3e-2  # of max|logits|: plain greedy's near-tie bound (the w4 parity tolerance)


def _mask_of(torch, meta, tpos, tseq, seq_mask=None):
    """Commit a ubatch of (pos, seq) rows to the cell metadata as a context
    does and return kernel 3's int8 mask [rows, n_cells] over all cells;
    rows with pos -1 are padding (no cell, nothing visible)."""
    import numpy as np

    from llama_kotlin_tpu_torch.ops.attention import visibility_mask

    tpos, tseq = np.asarray(tpos, np.int32), np.asarray(tseq, np.int32)
    live = tpos >= 0
    slots = meta.find_slots(int(live.sum()))
    meta.commit(slots, tpos[live], tseq[live],
                None if seq_mask is None else np.asarray(seq_mask, np.int32)[live])
    dev = torch.device("cuda")
    cpos, cseq = meta.device_view(meta.n_cells, dev)
    vis = visibility_mask(torch.from_numpy(tpos).to(dev), torch.from_numpy(tseq).to(dev),
                          cpos, cseq)
    return vis.to(torch.int8).contiguous()


def serving_masks(torch) -> dict:
    """The three serving masks over 1024 cells, built with CellMetadata as
    the engine and the speculative tree leave them: (a) four sequences
    whose prompts and decode steps interleave their cells, decoding one row
    each beside a 60-row prompt chunk of a fifth; (b) a 200-cell prefix
    shared by four sequences (seq_cp), each with a private tail, decoding a
    row each, padded to 8 rows; (c) a speculative tree of 3 branches and
    depth 4 after a 300-cell prompt (root and shared nodes in several
    branches by their bitmasks), padded to 16 rows."""
    from llama_kotlin_tpu_torch.runtime.kv_cache import CellMetadata

    n, pad = 1024, 31
    masks = {}
    # (a) prompts of 150, 90, 200, 60 in one ubatch, 40 decode steps of the
    # four, then 4 decode rows and a 60-token chunk of sequence 4
    m = CellMetadata(n)
    lens = (150, 90, 200, 60)
    _mask_of(torch, m, [p for ln in lens for p in range(ln)],
             [s for s, ln in enumerate(lens) for _ in range(ln)])
    for i in range(40):
        _mask_of(torch, m, [ln + i for ln in lens], range(4))
    masks["a"] = _mask_of(torch, m, [ln + 40 for ln in lens] + list(range(60)),
                          [0, 1, 2, 3] + [4] * 60)
    # (b) a 200-token prefix of sequence 0 copied to 1-3, tails of 30, 45,
    # 10 and 60 tokens decoded in turns
    m = CellMetadata(n)
    _mask_of(torch, m, range(200), [0] * 200)
    for s in (1, 2, 3):
        m.seq_cp(0, s)
    tails = (30, 45, 10, 60)
    for i in range(max(tails)):
        rows = [s for s in range(4) if i < tails[s]]
        _mask_of(torch, m, [200 + i] * len(rows), rows)
    masks["b"] = _mask_of(torch, m, [200 + t for t in tails] + [-1] * 4,
                          [0, 1, 2, 3] + [pad] * 4)
    # (c) the tree: the root in branches 1-3, a1 in 1 and 2, then a2-a4 in
    # 1, b2-b4 in 2, c1-c4 in 3 (primary sequence: the lowest branch)
    m = CellMetadata(n)
    _mask_of(torch, m, range(300), [0] * 300)
    for b in (1, 2, 3):
        m.seq_cp(0, b)
    nodes = [(0, (1, 2, 3)), (1, (1, 2))] + [(d, (1,)) for d in (2, 3, 4)] \
        + [(d, (2,)) for d in (2, 3, 4)] + [(d, (3,)) for d in (1, 2, 3, 4)]
    masks["c"] = _mask_of(torch, m, [300 + d for d, _ in nodes] + [-1] * 4,
                          [min(bs) for _, bs in nodes] + [pad] * 4,
                          [sum(1 << b for b in bs) for _, bs in nodes] + [0] * 4)
    return masks


def serving_mask_phase(torch, results: dict) -> None:
    """Kernel 3 under the serving masks (serving_masks) on the bf16, int8 and
    packed int4 caches, D = 128, 32 query heads on 8 kv heads: held against
    its plain version (tol as kv_kernel_phase's), rows that see nothing
    exactly 0, and timed beside SDPA on the same mask."""
    from llama_kotlin_tpu_torch.ops.cuda import flash
    from llama_kotlin_tpu_torch.runtime.kv_cache import (dequantize_cache_layer, quantize_rows,
                                                         quantize_rows_q4)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1515)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    H, KV, D, cells, n_vis = 32, 8, 128, 1025, 1024
    scale = D ** -0.5
    kb = torch.randn((1, KV, cells, D), generator=gen, device=dev).to(torch.bfloat16)
    vb = torch.randn((1, KV, cells, D), generator=gen, device=dev).to(torch.bfloat16)
    caches = {"bf16": (kb, vb, None, None), "int8": quantize_rows(kb) + quantize_rows(vb),
              "int4": quantize_rows_q4(kb) + quantize_rows_q4(vb)}
    for name, mask in serving_masks(torch).items():
        nt = mask.shape[0]
        blind = ~mask.bool().any(dim=1)
        q = torch.randn((nt, H, D), generator=gen, device=dev).to(torch.bfloat16)
        vis = int(mask.any(dim=0).sum().item())
        for kind, cache in caches.items():
            k, v, ksc, vsc = (cache if kind == "bf16" else (cache[0], cache[2], cache[1],
                                                            cache[3]))
            bits = 4 if kind == "int4" else 8
            kw = dict(scale=scale, layer=0, k_scale=ksc, v_scale=vsc, kv_bits=bits)
            got = flash.flash_attention(q, k, v, mask, **kw)
            if bool(got[blind].any()):
                raise AssertionError(f"kernel 3 ({kind}, mask {name}): a row that sees "
                                     "nothing gave nonzero output")
            kf, vf = (k[0, :, :n_vis], v[0, :, :n_vis]) if ksc is None else (
                dequantize_cache_layer(c[0, :, :n_vis], sc[0, :, :n_vis], torch.bfloat16,
                                       bits=bits) for c, sc in ((k, ksc), (v, vsc)))
            elem = k.element_size() * k.shape[-1] + (4 if ksc is not None else 0)
            report_row(results, "flash", f"{kind} cache serving mask {name} nt={nt} "
                       f"n_vis={n_vis}", err_of(got, flash.flash_attention_plain(q, k, v, mask,
                                                                                **kw)),
                       1e-2, time_ms(torch, lambda: flash.flash_attention(q, k, v, mask, **kw),
                                     flush),
                       time_ms(torch, lambda: flash.flash_attention_plain(q, k, v, mask, **kw),
                               flush),
                       2 * nt * H * D * 2 + 2 * KV * vis * elem + nt * n_vis,
                       4 * D * int(mask.sum().item()) * H, "bf16",
                       time_ms(torch, sdpa_call(torch, q, kf, vf, mask, scale), flush))
        log(json.dumps({"phase": "serving_mask", "mask": name, "rows": nt,
                        "blind_rows": int(blind.sum()), "visible_cells": vis,
                        "mask_ones": int(mask.sum().item())}))
    del caches, kb, vb, flush
    torch.cuda.empty_cache()


def _engine_class():
    """The port's Engine, with the greedy choices it makes recorded and,
    given `forced`, replaced by those tokens (so that a card run follows the
    CPU's tokens and one near-tie cannot part the two schedules)."""
    import numpy as np

    from llama_kotlin_tpu_torch.runtime.engine import Engine

    class Forced(Engine):
        def __init__(self, *a, forced=None, **kw):
            super().__init__(*a, **kw)
            self.forced, self.chosen = forced, []

        def _pick(self, tok: int) -> int:
            self.chosen.append(int(tok))
            return int(tok) if self.forced is None else int(self.forced[len(self.chosen) - 1])

        def _sample(self, slot, logits):
            own = slot.sampler.sample
            slot.sampler.sample = lambda lg, **kw: self._pick(own(lg, **kw))
            try:
                return super()._sample(slot, logits)
            finally:
                del slot.sampler.sample

        def _sample_rows_masked_device(self, emits):
            toks = super()._sample_rows_masked_device(emits)
            return None if toks is None else np.array([self._pick(t) for t in toks])

    return Forced


def engine_parity_phase(torch) -> None:
    """Full width, 2 layers: the port's Engine on the card against the same
    on the CPU.  4 slots, n_batch 256, chunked decode off (every step
    gives logits), driven by step() in this thread for 6 steps: greedy
    prompts of 9, 40, 130 and 300 tokens (the 300 split over two ubatches
    beside decode rows), then a greedy request under a JSON schema (sampled
    on the device under its grammar mask) and one with n_probs = 5 (the
    host path) as slots free up.  The card run takes the CPU's tokens;
    every logits row within 3e-2 of max|logits| of the CPU's, and where the
    card's own choice differs from the CPU's, the CPU's logits of the two
    tokens lie within twice that (a near-tie)."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.synthetic import (params_to, preset_config,
                                                         synthetic_params_device,
                                                         synthetic_spm_vocab)
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.runtime.engine import Request
    from llama_kotlin_tpu_torch.sampling.json_schema import json_schema_to_gbnf
    from llama_kotlin_tpu_torch.sampling.samplers import SamplingParams
    from llama_kotlin_tpu_torch.tokenizer import build_tokenizer

    tol = 3e-2
    cfg = preset_config("llama3-8b", n_layer=2)
    params = synthetic_params_device(cfg, seed=1, device="cuda")
    cpu_params = params_to(params, "cpu")
    tok = build_tokenizer(synthetic_spm_vocab(cfg.vocab_size))
    rng = np.random.default_rng(15)
    prompts = [rng.integers(300, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 40, 130, 300, 12, 20)]
    n_predict = (3, 4, 6, 6, 4, 3)
    grammar = json_schema_to_gbnf(SERVE_SCHEMA)
    Forced = _engine_class()

    def run(dev, forced):
        ctx = LlamaContext(cfg, params if dev == "cuda" else cpu_params, n_cells=2048,
                           prefer_unrolled=True, device=dev)
        rows = []
        decode = ctx.decode

        def keep(batch):
            rc = decode(batch)
            if rc == 0 and batch.output.any():
                rows.extend(ctx.logits_device().float().cpu().numpy())
            return rc
        ctx.decode = keep
        eng = Forced(ctx, tok, n_slots=4, n_batch=256, chunk_steps=0, forced=forced)
        for i, (p, n) in enumerate(zip(prompts, n_predict)):
            eng.submit(Request(prompt_tokens=p, n_predict=n, n_probs=5 if i == 5 else 0,
                               params=SamplingParams(temp=0.0,
                                                     grammar=grammar if i == 4 else None)))
        for _ in range(6):
            eng.step()
        used = {"decode_steps": eng.metrics["n_decode_steps"],
                "prompt_tokens": eng.metrics["prompt_tokens_processed"]}
        return rows, eng.chosen, used

    def cpu_run():
        rows, chosen, _ = run("cpu", None)
        record = np.full(cfg.vocab_size, -1.0, np.float32)
        record[:len(chosen)] = chosen
        return rows + [record]

    cl = cpu_ref("engine", cpu_run)
    if REFS["writer"]:
        return
    *cl, record = cl
    ct = [int(t) for t in record if t >= 0]
    gl, gt, used = run("cuda", ct)
    if len(gl) != len(cl) or len(gt) != len(ct) or len(ct) != len(cl):
        raise AssertionError(f"engine parity: {len(gl)} card rows, {len(cl)} CPU rows, "
                             f"{len(gt)} and {len(ct)} choices")
    errs = [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(gl, cl)]
    ties = [i for i, (a, b) in enumerate(zip(gt, ct)) if a != b]
    near = all(cl[i][ct[i]] - cl[i][gt[i]] <= 2 * tol * np.abs(cl[i]).max() for i in ties)
    log(json.dumps({"phase": "engine_parity", "n_layer": 2, "rows": len(cl), **used,
                    "tokens_cpu": ct, "tokens_cuda_own": gt, "rel_logit_err": errs,
                    "max_rel_logit_err": max(errs), "near_ties": ties, "tol_rel": tol}))
    if max(errs) > tol or not near:
        raise AssertionError("engine parity: card and CPU disagree")


def _server_prompts(tok) -> list:
    """Prompt texts of about SERVE_PROMPTS tokens: CLI_PROMPT repeated, cut."""
    ids = tok.encode(" ".join([CLI_PROMPT] * 40), add_special=False)
    return [tok.decode(ids[:n]) for n in SERVE_PROMPTS]


def _http(url, path, body=None):
    import urllib.request

    req = urllib.request.Request(url + path, None if body is None else json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=600)


def _drive(eng, reqs, threaded: bool = True) -> float:
    """Submit reqs to eng and wait for all (the engine's own thread, or
    step() here); returns the wall seconds."""
    import threading

    t0 = time.perf_counter()
    stop = threading.Event()
    th = threading.Thread(target=eng.run_loop, args=(stop,), daemon=True) if threaded else None
    for r in reqs:
        eng.submit(r)
    if th is not None:
        th.start()
    try:
        while not all(r.done.is_set() for r in reqs):
            if th is None:
                eng.step()
            else:  # block on a pending request: a spin here would starve the engine
                next(r for r in reqs if not r.done.is_set()).done.wait(0.05)
                eng.check()
    finally:
        stop.set()
        if th is not None:
            th.join(60)
    eng.check()
    if any(r.error for r in reqs):
        raise AssertionError([r.error for r in reqs if r.error])
    return time.perf_counter() - t0


def server_phase(torch, path: Path, mode) -> dict:
    """The OpenAI server on the 32-layer Q4_K_M file of gguf_phase (SPM vocab
    of 128256 pieces), loaded as tools/server.py loads it (fast_mode=mode:
    "w4" or None, the exact-dequant default; fused; the default context of
    SERVE_CELLS cells):
    (a) one slot, greedy: the engine's tokens (a prefill through
        ctx.decode, then generate_loop chunks at B = 1) equal generate()'s
        bit for bit;
    (b) serve() on 127.0.0.1:0 with 4 slots, 8 concurrent requests: 4
        greedy /completion (n_predict 32, prompts of SERVE_PROMPTS tokens),
        2 streaming /v1/chat/completions at temperature 0.8 with seeds, one
        under a JSON schema, one with n_probs; /tokenize, /health, /slots,
        /metrics.  Every response 200; each request ends at n_predict or a
        stop; streamed text equals the engine's final text; /metrics counts
        the tokens returned; the JSON output parses;
    (c) tokens/s of the 4 greedy and 2 sampled requests at 1, 4 and 8
        slots, and one engine step at 4 slots profiled.
    Logs TTFT per request and how often the chunked decode engaged.
    Returns {path: launch counts}."""
    import threading

    import numpy as np

    from llama_kotlin_tpu_torch.gguf.reader import GGUFFile
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.ops.cuda import (flash, qmm, qmm_int8, qmm_w4, qmm_w4_ffn,
                                                 qmm_w4x, qmm_w8)
    from llama_kotlin_tpu_torch.runtime.chat import resolve_template
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.runtime.engine import Engine, Request
    from llama_kotlin_tpu_torch.runtime.generate import generate
    from llama_kotlin_tpu_torch.sampling.samplers import SamplingParams
    from llama_kotlin_tpu_torch.tokenizer import build_tokenizer
    from llama_kotlin_tpu_torch.tools import server

    label = f"server_{mode or 'exact'}"
    if mode == "w4":
        mods, never = (qmm_w4, qmm_w4_ffn, flash, qmm, qmm_w8), (qmm_w4x, qmm_int8)
    else:
        mods, never = (qmm, exact_counter(), flash), (qmm_w4, qmm_w4_ffn, qmm_w8, qmm_int8,
                                                      qmm_w4x)
    t0 = time.perf_counter()
    cfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True, device="cuda")
    tok = build_tokenizer(f.metadata)
    template = resolve_template(f.metadata.get("tokenizer.chat_template"), cfg.arch)
    f.close()
    ctx = LlamaContext(cfg, params, n_cells=SERVE_CELLS, device="cuda")
    torch.cuda.synchronize()
    line: dict = {"phase": label, "load_s": time.perf_counter() - t0,
                  "unrolled": "layers" in ctx.params}
    for m in mods + never:
        m.LAUNCHES = 0
    texts = _server_prompts(tok)
    # (a) one slot, greedy, against generate()
    ids = np.asarray(tok.encode(texts[1], add_special=True), np.int32)
    req = Request(prompt_tokens=ids, params=SamplingParams(temp=0.0), n_predict=32)
    eng = Engine(ctx, tok, n_slots=1)
    _drive(eng, [req], threaded=False)
    ctx.clear()
    ref = generate(ctx, ids, 32)
    line["exact_vs_generate"] = {"engine": req.output_tokens, "generate": ref,
                                 "chunked_steps": eng.n_chunked}
    if req.output_tokens != ref or not eng.n_chunked:
        raise AssertionError(f"{label}: the engine's greedy tokens differ from generate()'s")
    # (b) the HTTP server, 4 slots, 8 concurrent requests
    ctx.clear()
    state = server.serve(ctx, tok, model_name=cfg.name, template=template, host="127.0.0.1",
                         port=0, n_slots=4, n_batch=256)
    url = f"http://127.0.0.1:{state.httpd.server_address[1]}"
    threading.Thread(target=state.httpd.serve_forever, daemon=True).start()
    submitted = []
    submit = state.engine.submit
    state.engine.submit = lambda r: submitted.append(r) or submit(r)
    bodies = [("/completion", {"prompt": t, "n_predict": 32, "temperature": 0})
              for t in texts]
    bodies += [("/v1/chat/completions", {"messages": [{"role": "user", "content": texts[i]}],
                                         "max_tokens": 32, "temperature": 0.8, "seed": s,
                                         "stream": True}) for i, s in ((0, 1), (2, 2))]
    bodies += [("/completion", {"prompt": "Reply in JSON: " + texts[0], "n_predict": 128,
                                "temperature": 0, "json_schema": SERVE_SCHEMA}),
               ("/completion", {"prompt": texts[1], "n_predict": 32, "temperature": 0,
                                "n_probs": 5})]
    out: dict = {}

    def client(i, route, body):
        t = time.perf_counter()
        with _http(url, route, body) as r:
            if r.status != 200:
                raise AssertionError(f"{label}: {route} answered {r.status}")
            if not body.get("stream"):
                out[i] = {"json": json.loads(r.read()), "s": time.perf_counter() - t}
                return
            deltas, first = [], None
            for raw in r:
                raw = raw.strip()
                if raw.startswith(b"data: ") and raw != b"data: [DONE]":
                    ev = json.loads(raw[6:])
                    d = ev["choices"][0]["delta"].get("content", "")
                    if d and first is None:
                        first = time.perf_counter() - t
                    deltas.append(d)
                    fin = ev["choices"][0]["finish_reason"]
            out[i] = {"text": "".join(deltas), "finish": fin, "ttft_s": first,
                      "s": time.perf_counter() - t}

    errors = []

    def guarded(*a):
        try:
            client(*a)
        except Exception as e:  # noqa: BLE001 (raised below)
            errors.append(repr(e))

    t_http = time.perf_counter()
    threads = [threading.Thread(target=guarded, args=(i, r, b)) for i, (r, b) in
               enumerate(bodies)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    wall = time.perf_counter() - t_http
    state.engine.check()
    if errors or len(out) != len(bodies):
        raise AssertionError(f"{label}: requests failed: {errors}")
    with _http(url, "/tokenize", {"content": texts[0]}) as r:
        n_tok = json.loads(r.read())["tokens"]
    with _http(url, "/health") as r:
        health = json.loads(r.read())
    with _http(url, "/slots") as r:
        slots = json.loads(r.read())
    with _http(url, "/metrics") as r:
        metrics = dict(ln.split() for ln in r.read().decode().splitlines()
                       if not ln.startswith("#"))
    n_returned = sum(len(r.output_tokens) for r in submitted)
    for i, (route, body) in enumerate(bodies):
        n_want = body.get("n_predict", body.get("max_tokens"))
        if route == "/completion":
            j = out[i]["json"]
            ended = j["tokens_predicted"] == n_want or j["stopped_eos"] or j["stopping_word"]
        else:
            ended = out[i]["finish"] in ("length", "eos", "stop")
        if not ended:
            raise AssertionError(f"{label}: request {i} ended early: {out[i]}")
    streamed = [r for r in submitted if r.stream is not None]
    texts_ok = len(streamed) == 2 and sorted(o["text"] for o in out.values() if "text" in o) \
        == sorted(r.output_text for r in streamed)
    schema_text = out[6]["json"]["content"]
    parsed = json.loads(schema_text)
    want_tok = tok.encode(texts[0], add_special=False, parse_special=True)
    if not texts_ok or health != {"status": "ok"} or len(slots) != 4 or n_tok != want_tok \
            or int(metrics["llamacpp:tokens_predicted_total"]) != n_returned \
            or not isinstance(parsed.get("ok"), bool) or len(submitted) != len(bodies):
        raise AssertionError(f"{label}: streamed texts {texts_ok}, health {health}, slots "
                             f"{len(slots)}, metrics {metrics}, returned {n_returned}, "
                             f"json {schema_text!r}")
    line.update({
        "http": {"requests": len(bodies), "wall_s": wall, "tokens": n_returned,
                 "tok_s": n_returned / wall, "chunked_steps": state.engine.n_chunked,
                 "decode_steps": state.engine.metrics["n_decode_steps"],
                 "prompt_tokens": state.engine.metrics["prompt_tokens_processed"],
                 "json": schema_text},
        "ttft_ms": [{"prompt_tokens": len(r.prompt_tokens), "stream": r.stream is not None,
                     "n_probs": r.n_probs, "grammar": r.params.grammar is not None,
                     "n_out": len(r.output_tokens), "stop": r.stop_reason,
                     "ttft_ms": (r.t_first_token - r.t_start) * 1e3} for r in submitted]})
    state.shutdown()
    del state
    # (c) tokens/s of 6 requests (4 greedy, 2 sampled) at 1, 4 and 8 slots
    sweep = {}
    for n_slots in (1, 4, 8):
        ctx.clear()
        eng = Engine(ctx, tok, n_slots=n_slots, n_batch=256)
        reqs6 = [Request(prompt_tokens=np.asarray(tok.encode(t), np.int32),
                         params=SamplingParams(temp=0.0), n_predict=32) for t in texts]
        reqs6 += [Request(prompt_tokens=np.asarray(tok.encode(texts[i]), np.int32),
                          params=SamplingParams(temp=0.8, seed=s), n_predict=32)
                  for i, s in ((0, 1), (2, 2))]
        dt = _drive(eng, reqs6)
        n = sum(len(r.output_tokens) for r in reqs6)
        sweep[n_slots] = {"tok_s": n / dt, "wall_s": dt, "tokens": n,
                          "decode_steps": eng.metrics["n_decode_steps"],
                          "chunked_steps": eng.n_chunked,
                          "ttft_ms": [(r.t_first_token - r.t_start) * 1e3 for r in reqs6]}
    line["slots_sweep"] = sweep
    line["profile_step_4_slots"] = profile_engine_step(torch, ctx, tok, texts)
    counts = {mod_name(m): m.LAUNCHES for m in mods}
    line["launches"] = counts
    log(json.dumps(line))
    if not all(counts.values()) or any(m.LAUNCHES for m in never):
        raise AssertionError(f"{label}: launches {counts}, never "
                             f"{ {mod_name(m): m.LAUNCHES for m in never} }")
    del ctx, params
    torch.cuda.empty_cache()
    return {label: counts}


def profile_engine_step(torch, ctx, tok, texts) -> dict:
    """One engine step of 4 greedy slots, all generating (the chunked
    on-device loop: K decode steps of 4 rows), under torch.profiler: its
    wall time, launches, device busy time and idle share (as
    profile_decode)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from llama_kotlin_tpu_torch.runtime.engine import Engine, Request, SlotState
    from llama_kotlin_tpu_torch.sampling.samplers import SamplingParams

    ctx.clear()
    eng = Engine(ctx, tok, n_slots=4, n_batch=256)
    for t in texts:
        eng.submit(Request(prompt_tokens=np.asarray(tok.encode(t), np.int32),
                           params=SamplingParams(temp=0.0), n_predict=64))
    while not all(s.state == SlotState.GENERATING for s in eng.slots):
        eng.step()
    chunked = eng.n_chunked
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    k = eng.chunk_steps if eng.n_chunked > chunked else 1
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    return {"decode_steps_in_step": k, "rows": 4, "wall_ms": wall_ms,
            "wall_ms_per_decode_step": wall_ms / k,
            "device_busy_ms": busy if rows else "not measured",
            "device_idle_share": 1.0 - busy / wall_ms if rows else "not measured",
            "device_launches": sum(r[1] for r in rows),
            "top": [{"kernel": n[:60], "ms": t, "calls": c} for t, c, n in rows[:6]]}


def speculative_phase(torch, cfg, params) -> dict:
    """Speculative, lookup and lookahead decoding on the llama3-8B W4A8
    model of cfg (the target, unrolled, 1024 cells): a SPEC_PROMPT-token prompt,
    SPEC_NEW tokens, n_draft SPEC_DRAFT; drafts (i) the target itself and
    (ii) a 2-layer llama3-8b of another seed (same vocab).
    speculative_generate and speculative_generate_device give identical
    tokens and stats.  Every token each method emits (and
    speculative_generate_tree's with 3 branches, and generate()'s) is held
    to the target: its token list is teacher-forced through the target one
    token a decode (plain greedy's route), and at every position the
    emitted token's logit must lie within 2 * noise * max|logits| of its
    row's maximum.  noise is this model's route noise, measured here: the
    largest max|logits difference| / max|logits| between plain greedy's
    one-row rows and the same rows made as K+1-row verify batches, or as
    one batch of the prompt and the tokens (above 32 rows: kernel 4's
    route, which lookahead's batches take).  A method's row differs from
    the one-row row by at most noise, so its argmax is within 2 * noise of
    the one-row maximum.  Logs the noise, each method's worst margin,
    where it parts from plain greedy, the near-ties (plain greedy's top-2
    gap under SPEC_TOL of max|logits|), acceptance and tokens/s beside
    plain generate().  Returns {"speculative": launch counts}."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.synthetic import preset_config, synthetic_params_device
    from llama_kotlin_tpu_torch.ops.cuda import flash, qmm, qmm_w4, qmm_w4_ffn
    from llama_kotlin_tpu_torch.runtime import lookahead as la
    from llama_kotlin_tpu_torch.runtime import speculative as spec
    from llama_kotlin_tpu_torch.runtime.batch import Batch
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.runtime.generate import generate

    mods = (qmm_w4, qmm_w4_ffn, flash, qmm)
    dcfg = preset_config("llama3-8b", n_layer=2)
    dparams = synthetic_params_device(dcfg, seed=5, device="cuda")

    def ctx_of(c, p):
        return LlamaContext(c, p, n_cells=1024, prefer_unrolled=True, device="cuda")

    target, self_draft, small = ctx_of(cfg, params), ctx_of(cfg, params), ctx_of(dcfg, dparams)
    prompt = np.random.default_rng(16).integers(0, cfg.vocab_size, SPEC_PROMPT).astype(np.int32)

    def forced(toks) -> np.ndarray:
        """The target's one-row rows along toks: row i predicts toks[i]."""
        target.clear()
        assert target.decode(Batch.single(prompt)) == 0
        rows = [target.get_logits()[-1]]
        for i, t in enumerate(toks[:-1]):
            assert target.decode(Batch.single([t], pos0=SPEC_PROMPT + i)) == 0
            rows.append(target.get_logits()[-1])
        return np.stack(rows).astype(np.float32)

    def rel_diff(a, b) -> float:
        return float((np.abs(a - b).max(-1) / np.abs(a).max(-1)).max())

    for m in mods:
        m.LAUNCHES = 0
    # plain greedy, one token a decode, and its rows' top-2 gaps
    target.clear()
    assert target.decode(Batch.single(prompt)) == 0
    plain, rows = [], []
    for i in range(SPEC_NEW):
        rows.append(target.get_logits()[-1].astype(np.float32))
        plain.append(int(np.argmax(rows[-1])))
        if i + 1 < SPEC_NEW:
            assert target.decode(Batch.single([plain[-1]], pos0=SPEC_PROMPT + i)) == 0
    rows = np.stack(rows)
    top2 = np.sort(rows, axis=-1)[:, -2:]
    gaps = ((top2[:, 1] - top2[:, 0]) / np.abs(rows).max(-1)).tolist()
    # route noise: the same rows as K+1-row verify batches, and as one batch
    # of the prompt and the tokens
    target.clear()
    assert target.decode(Batch.single(prompt)) == 0
    chunked = [None]
    for c in range(0, SPEC_NEW - 1, SPEC_DRAFT + 1):
        part = plain[c:min(c + SPEC_DRAFT + 1, SPEC_NEW - 1)]
        assert target.decode(Batch.single(part, pos0=SPEC_PROMPT + c,
                                          logits_last_only=False)) == 0
        chunked += list(target.get_logits().astype(np.float32))
    noise_verify = rel_diff(rows[1:], np.stack(chunked[1:]))
    target.clear()
    assert target.decode(Batch.single(np.concatenate([prompt, plain[:-1]]),
                                      logits_last_only=False)) == 0
    noise_batch = rel_diff(rows, target.get_logits()[SPEC_PROMPT - 1:].astype(np.float32))
    noise = max(noise_verify, noise_batch)
    target.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_toks = generate(target, prompt, SPEC_NEW)
    gen_s = time.perf_counter() - t0
    line = {"phase": "speculative", "n_layer": cfg.n_layer, "prompt_tokens": SPEC_PROMPT,
            "n_predict": SPEC_NEW, "n_draft": SPEC_DRAFT,
            "route_noise_verify": noise_verify, "route_noise_batch": noise_batch,
            "margin_bound": 2 * noise, "near_ties": sum(g < SPEC_TOL for g in gaps),
            "top2_gap_rel": gaps, "plain_generate_tok_s": SPEC_NEW / gen_s, "runs": {}}
    runs = [(f"{fn}_{dname}", getattr(spec, fn), (target, d), {"n_draft": SPEC_DRAFT, **kw})
            for dname, d in (("self", self_draft), ("2layer", small))
            for fn, kw in (("speculative_generate", {}), ("speculative_generate_device", {}),
                           ("speculative_generate_tree", {"n_branches": 3}))]
    runs += [("lookup_generate", spec.lookup_generate, (target,), {"n_draft": SPEC_DRAFT}),
             ("lookahead_generate", la.lookahead_generate, (target,), {})]
    got = {"generate": (list(gen_toks), {})}
    for name, fn, ctxs, kw in runs:
        for c in ctxs:
            c.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, st = fn(*ctxs, prompt, SPEC_NEW, **kw)
        dt = time.perf_counter() - t0
        st = st if isinstance(st, dict) else {"n_drafted": st.n_drafted, "n_accepted": st.n_accepted,
                                              "n_target_calls": st.n_target_calls,
                                              "accept_rate": st.accept_rate}
        got[name] = (list(toks), st)
        line["runs"][name] = {"tok_s": len(toks) / dt, "stats": st, "tokens": list(toks)}
    line["launches"] = counts = {mod_name(m): m.LAUNCHES for m in mods}
    # every emitted token against the target's teacher-forced rows
    forced_rows = {tuple(plain): rows}
    bad = []
    for name, (toks, _) in got.items():
        if len(toks) != SPEC_NEW:
            bad.append(f"{name} emitted {len(toks)} tokens")
            continue
        key = tuple(toks)
        if key not in forced_rows:
            forced_rows[key] = forced(toks)
        r = forced_rows[key]
        margins = (r.max(-1) - r[np.arange(SPEC_NEW), toks]) / np.abs(r).max(-1)
        part = next((i for i, (a, b) in enumerate(zip(toks, plain)) if a != b), None)
        run = line["runs"].setdefault(name, {"tokens": toks})
        run.update({"parts_at": part, "gap_at_part": None if part is None else gaps[part],
                    "worst_margin": float(margins.max()),
                    "worst_at": int(margins.argmax())})
        if margins.max() > 2 * noise:
            bad.append(f"{name} emits token {toks[int(margins.argmax())]} at "
                       f"{int(margins.argmax())}, {float(margins.max()):.3e} of max|logits| "
                       f"below the target's best (bound {2 * noise:.3e})")
    log(json.dumps(line))
    if bad:
        raise AssertionError("speculative: " + "; ".join(bad))
    for d in ("self", "2layer"):
        if got[f"speculative_generate_{d}"] != got[f"speculative_generate_device_{d}"]:
            raise AssertionError(f"speculative: host and device loops differ ({d})")
    if not all(counts.values()):
        raise AssertionError(f"speculative: a kernel of the path never launched: {counts}")
    del target, self_draft, small, dparams
    torch.cuda.empty_cache()
    return {"speculative": counts}


# -- deepseek2 (multi-head latent attention on kernel 3's MLA branch, routed
# -- and shared experts) and llama-architecture MoE (Mixtral)

MLA_DIMS = (192, 128)  # DeepSeek-V2-Lite's q/k and v head widths
DS2_SEED = 13


def mla_kernel_phase(torch, results: dict) -> None:
    """Kernel 3's MLA branch at DeepSeek-V2-Lite's attention shapes (16
    heads on 16 kv heads: rep = 1, K rows 192 wide, V rows 128) on the bf16,
    int8 and packed int4 caches: layer 1 of a [2, 16, 4097, ..] cache,
    decode (nt = 1) and a 64-token prefill chunk (the step's tokens in the
    last cells, causal; the chunk with a row that sees nothing, exactly 0),
    over 1024 and 4096 visible cells, against the plain version, beside one
    SDPA call (Ev != E) on the dequantized prefix.  tol: bf16 outputs, f32
    online-softmax reassociation (~2 bf16 ulps), as for the other kernel 3
    rows.  bound_ms: one read of the visible K/V prefix ((192 + 128) x 2
    bytes a cell and head in bf16; 192 + 128 and 96 + 64 bytes, each with
    two f32 scales, in int8 and int4), q, the output and the mask."""
    from llama_kotlin_tpu_torch.ops.cuda import flash
    from llama_kotlin_tpu_torch.runtime.kv_cache import (dequantize_cache_layer, quantize_rows,
                                                         quantize_rows_q4)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(778)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    L, H, KV, cells, li = 2, 16, 16, 4097, 1
    dk, dv = MLA_DIMS
    # DeepSeek-V2-Lite's softmax scale: YaRN mscale^2 / sqrt(192)
    mscale = 1.0 + 0.0707 * math.log(40.0)
    scale = mscale * mscale / dk ** 0.5
    kb = torch.randn((L, KV, cells, dk), generator=gen, device=dev).to(torch.bfloat16)
    vb = torch.randn((L, KV, cells, dv), generator=gen, device=dev).to(torch.bfloat16)
    (k8, ks), (v8, vs) = quantize_rows(kb), quantize_rows(vb)
    (k4, ks4), (v4, vs4) = quantize_rows_q4(kb), quantize_rows_q4(vb)
    caches = {"bf16": (kb, vb, None, None, 8, 2 * (dk + dv)),
              "int8": (k8, v8, ks, vs, 8, dk + dv + 8),
              "int4": (k4, v4, ks4, vs4, 4, (dk + dv) // 2 + 8)}
    for n_vis in (1024, 4096):
        for nt in (1, 64):
            q = torch.randn((nt, H, dk), generator=gen, device=dev).to(torch.bfloat16)
            tpos = torch.arange(n_vis - nt, n_vis, device=dev)
            cpos = torch.arange(n_vis, device=dev)
            mask = (cpos[None, :] <= tpos[:, None]).to(torch.int8)
            if nt > 1:
                mask[5] = 0  # a row that sees no cell
            for kind, (k, v, ksc, vsc, bits, elem) in caches.items():
                kw = dict(scale=scale, layer=li, k_scale=ksc, v_scale=vsc, kv_bits=bits)
                args = (q, k, v, mask)
                got = flash.flash_attention(*args, **kw)
                if nt > 1 and bool(got[5].any()):
                    raise AssertionError("kernel 3's MLA branch: a blind row is not 0")
                kf, vf = (k[li, :, :n_vis], v[li, :, :n_vis]) if ksc is None else (
                    dequantize_cache_layer(c[li, :, :n_vis], sc[li, :, :n_vis], torch.bfloat16,
                                           bits=bits) for c, sc in ((k, ksc), (v, vsc)))
                vis = int(mask.any(dim=0).sum().item())
                report_row(results, "flash_mla", f"{kind} cache nt={nt} n_vis={n_vis} layer={li}",
                           err_of(got, flash.flash_attention_plain(*args, **kw)), 1e-2,
                           time_ms(torch, lambda: flash.flash_attention(*args, **kw), flush),
                           time_ms(torch, lambda: flash.flash_attention_plain(*args, **kw),
                                   flush),
                           nt * H * (dk + dv) * 2 + KV * vis * elem + nt * n_vis,
                           2 * (dk + dv) * int(mask.sum().item()) * H, "bf16",
                           time_ms(torch, sdpa_call(torch, q, kf, vf, mask, scale), flush))


GEMMA2_HEADS = (16, 8)  # gemma-2-9b's query and kv heads (head dim 256)
D256_WINDOW = 1024  # the sliding window of d256_kernel_phase's windowed rows


def ptxas_entries(name: str) -> list:
    """[{entry, registers, spill_stores, spill_loads}] of every kernel
    function in the build's ptxas report whose name holds `name`."""
    import re

    from llama_kotlin_tpu_torch.ops.cuda import _build

    out, cur = [], None
    for ln in (_build.BUILD_DIR / "ptxas.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"entry": m.group(1)} if name in m.group(1) else None
            if cur is not None:
                out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def d256_kernel_phase(torch, results: dict) -> None:
    """Kernel 3's D = 256 branch at gemma-2-9b's attention shapes (16 heads
    on 8 kv heads: rep = 2, head dim 256, softcap 50, scale 1/16) on the
    bf16, int8 and packed int4 caches: layer 1 of a [2, 8, 4097, 256]
    cache, decode (nt = 1) and a 64-token prefill chunk (the step's tokens
    in the last cells, causal; the chunk with a row that sees nothing,
    exactly 0), over 1024 and 4096 visible cells, and over 4096 cells under
    a sliding window of D256_WINDOW (gemma2's masks on its windowed layers),
    against the plain version, beside one SDPA call on the dequantized
    prefix (the yardstick; SDPA takes no softcap, so its call is the
    same work without the tanh).  On the windowed rows the cells of the
    tiles no row sees are then poisoned (NaN K/V, or NaN scales on a
    quantized cache): the output must stay bit-equal, so those tiles are
    skipped, never read.  tol: bf16 outputs, f32 online-softmax
    reassociation (~2 bf16 ulps), as for the other kernel 3 rows.
    bound_ms: one read of the visible K/V prefix (2 x 256 x 2 bytes a cell
    and kv head in bf16; 2 x (256 + 4) in int8 and 2 x (128 + 4) in int4),
    q, the output and the mask.  The build's ptxas lines of the three
    instances must show no spill."""
    from llama_kotlin_tpu_torch.ops.cuda import flash
    from llama_kotlin_tpu_torch.runtime.kv_cache import (dequantize_cache_layer, quantize_rows,
                                                         quantize_rows_q4)

    entries = ptxas_entries("flash_d256_kernel")
    log(json.dumps({"phase": "d256_ptxas", "entries": entries}))
    if len(entries) != 3 or any(e.get("spill_stores", 1) or e.get("spill_loads", 1)
                                for e in entries):
        raise AssertionError(f"kernel 3's D = 256 instances: {entries}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(779)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    (H, KV), D, L, cells, li = GEMMA2_HEADS, 256, 2, 4097, 1
    scale, softcap = D ** -0.5, 50.0
    kb = torch.randn((L, KV, cells, D), generator=gen, device=dev).to(torch.bfloat16)
    vb = torch.randn((L, KV, cells, D), generator=gen, device=dev).to(torch.bfloat16)
    (k8, ks), (v8, vs) = quantize_rows(kb), quantize_rows(vb)
    (k4, ks4), (v4, vs4) = quantize_rows_q4(kb), quantize_rows_q4(vb)
    caches = {"bf16": (kb, vb, None, None, 8, 4 * D),
              "int8": (k8, v8, ks, vs, 8, 2 * (D + 4)),
              "int4": (k4, v4, ks4, vs4, 4, 2 * (D // 2 + 4))}
    for n_vis, window in ((1024, 0), (4096, 0), (4096, D256_WINDOW)):
        for nt in (1, 64):
            q = torch.randn((nt, H, D), generator=gen, device=dev).to(torch.bfloat16)
            tpos = torch.arange(n_vis - nt, n_vis, device=dev)
            cpos = torch.arange(n_vis, device=dev)
            seen = cpos[None, :] <= tpos[:, None]
            if window:
                seen &= tpos[:, None] - cpos[None, :] < window
            mask = seen.to(torch.int8)
            if nt > 1:
                mask[5] = 0  # a row that sees no cell
            live = mask.any(dim=0)
            dead = ~live.reshape(-1, flash.CELL_TILE).any(dim=1).repeat_interleave(flash.CELL_TILE)
            for kind, (k, v, ksc, vsc, bits, elem) in caches.items():
                kw = dict(scale=scale, logit_softcap=softcap, layer=li, k_scale=ksc,
                          v_scale=vsc, kv_bits=bits)
                args = (q, k, v, mask)
                got = flash.flash_attention(*args, **kw)
                if nt > 1 and bool(got[5].any()):
                    raise AssertionError("kernel 3's D = 256 branch: a blind row is not 0")
                kf, vf = (k[li, :, :n_vis], v[li, :, :n_vis]) if ksc is None else (
                    dequantize_cache_layer(c[li, :, :n_vis], sc[li, :, :n_vis], torch.bfloat16,
                                           bits=bits) for c, sc in ((k, ksc), (v, vsc)))
                vis = int(live.sum().item())
                shape = f"{kind} cache nt={nt} n_vis={n_vis} window={window} layer={li}"
                report_row(results, "flash_d256", shape,
                           err_of(got, flash.flash_attention_plain(*args, **kw)), 1e-2,
                           time_ms(torch, lambda: flash.flash_attention(*args, **kw), flush),
                           time_ms(torch, lambda: flash.flash_attention_plain(*args, **kw),
                                   flush),
                           nt * H * D * 2 * 2 + KV * vis * elem + nt * n_vis,
                           4 * D * int(mask.sum().item()) * H, "bf16",
                           time_ms(torch, sdpa_call(torch, q, kf, vf, mask, scale), flush))
                if not window:
                    continue
                # poison every cell of the dead tiles: the output must not move
                pk, pv = k.clone(), v.clone()
                pks = None if ksc is None else ksc.clone()
                pvs = None if vsc is None else vsc.clone()
                if ksc is None:
                    pk[li, :, :n_vis][:, dead] = float("nan")
                    pv[li, :, :n_vis][:, dead] = float("nan")
                else:
                    pks[li, :, :n_vis][:, dead] = float("nan")
                    pvs[li, :, :n_vis][:, dead] = float("nan")
                again = flash.flash_attention(q, pk, pv, mask, **dict(kw, k_scale=pks,
                                                                      v_scale=pvs))
                same = torch.equal(got, again)
                log(json.dumps({"phase": "d256_dead_tiles", "shape": shape,
                                "dead_cells": int(dead.sum().item()), "bit_equal": same}))
                if not same or not int(dead.sum().item()):
                    raise AssertionError(f"kernel 3's D = 256 branch read a dead tile ({shape})")
                del pk, pv, pks, pvs


def d256_counter():
    """Kernel 3's launches on its D = 256 branch (flash.LAUNCHES_D256),
    counted apart as "flash_d256" (each also counts in flash.LAUNCHES)."""
    from llama_kotlin_tpu_torch.ops.cuda import flash

    return BranchCounter(flash, "LAUNCHES_D256", "flash.flash_d256")


def mla_counter():
    """Kernel 3's launches on its MLA branch (flash.LAUNCHES_MLA), counted
    apart as "flash_mla" (each also counts in flash.LAUNCHES)."""
    from llama_kotlin_tpu_torch.ops.cuda import flash

    return BranchCounter(flash, "LAUNCHES_MLA", "flash.flash_mla")


def plain_attention_counters() -> tuple:
    """Call counters of the plain attention routes (the reference softmax
    under kernel 3's plain version, and the stacked path's plain route):
    the card's MLA path must take neither."""
    from llama_kotlin_tpu_torch.models import llama
    from llama_kotlin_tpu_torch.ops import attention

    return CallCounter(attention, "attention_reference"), CallCounter(llama, "attend_stacked_plain")


def type_mix(path: Path) -> dict:
    """{tensor name with the layer index dropped: sorted types} of a GGUF file."""
    from llama_kotlin_tpu_torch.gguf.reader import GGUFFile

    f = GGUFFile(path)
    mix: dict = {}
    for name, info in f.tensors.items():
        key = name.split(".", 2)[2] if name.startswith("blk.") else name
        mix.setdefault(key, set()).add(info.ggml_type.name)
    f.close()
    return {k: sorted(v) for k, v in mix.items()}


def deepseek2_phase(torch, tmpdir: Path) -> dict:
    """DeepSeek-V2-Lite at its published widths, its first EARLIER_LAYERS
    layers of 27 (models/synthetic.py::deepseek_v2_lite: 1 dense layer,
    then MoE layers of 64 routed experts, 6 used, and 2 shared; MLA 16
    heads, q/k 192, v 128;
    YaRN 40 on 4096; vocab 102400), random wire blocks from DS2_SEED in
    Q4_K_M's type mix by tensor name (moe_tensor_types, output Q6_K) with an
    SPM vocab of 102400 pieces, loaded in the exact mode (the default) and
    in w4 (its wkv_a_mqa on kernel 4 at a decode row, checked); each serves
    3 requests (64-token prompt, 32 greedy tokens)
    through LlamaContext and generate_loop by serve(), unrolled (the dense
    lead layer), kernel 3's MLA branch once a layer at every forward
    (n_layer a decode step) and never the plain attention; then 4 profiled decode steps
    (after a profiled prefill in the exact mode); the exact mode also serves
    4 concurrent requests on the engine at 4 slots.  Returns {path: launch
    counts}."""
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.ops.cuda import (flash, flash_stacked, qmm, qmm_int8, qmm_w4,
                                                 qmm_w4_ffn, qmm_w4x, qmm_w8)
    from llama_kotlin_tpu_torch.ops.qmatmul import qmatmul
    from llama_kotlin_tpu_torch.tokenizer import build_tokenizer

    path, written = child_file(tmpdir, DS2_FILE)
    log(json.dumps({"phase": "deepseek2_file", **written, "type_mix": type_mix(path)}))
    out = {}
    for mode in (None, "w4"):
        label = f"deepseek2_{mode or 'exact'}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lcfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        tok = build_tokenizer(f.metadata)
        f.close()
        log(json.dumps({"phase": label, "n_layer": lcfg.n_layer, "load_s": load_s,
                        "device_bytes": torch.cuda.memory_allocated(),
                        "layouts": sorted({(key, type(v).__name__ if not hasattr(v, "codes")
                                            else f"{v.qtype.name} {v.flavor or 'exact'}"
                                            + (" stacked" if v.is_stacked else ""))
                                           for lp in params["layers"] for key, v in lp.items()
                                           if hasattr(v, "codes") or isinstance(v, list)})}))
        if mode is None:  # every projection kernel 4's exact branch; experts gathered at decode
            mods = (qmm, exact_counter(), flash, mla_counter())
            never = (qmm_w4, qmm_w4_ffn, qmm_w8, qmm_int8, qmm_w4x, flash_stacked)
        else:  # W4 projections on kernel 1, W8 (the Q6_K lm_head, Q8_0 downs) on 5
            mods = (qmm_w4, qmm_w8, qmm, flash, mla_counter())
            never = (qmm_w4_ffn, qmm_int8, qmm_w4x, flash_stacked)
            # but wkv_a_mqa's 576 rows, which JAX's kernel 1 cannot block (no
            # 512, 256 or 128 divides them): kernel 4 at a decode row, as in JAX
            n0, w40 = qmm.LAUNCHES, qmm_w4.LAUNCHES
            qmatmul(torch.zeros((1, lcfg.n_embd), device="cuda"), params["layers"][0]["wkv_a_mqa"])
            if (qmm.LAUNCHES - n0, qmm_w4.LAUNCHES - w40) != (1, 0):
                raise AssertionError(f"{label}: wkv_a_mqa at a decode row took kernel 1")
        plain = plain_attention_counters()
        try:
            counts, ctx = serve(torch, lcfg, params, mods, label, never=never + plain)
        finally:
            for c in plain:
                c.close()
        # one attention a layer at every forward: a prefill and 31 steps
        want = 3 * 32 * lcfg.n_layer
        if "layers" not in ctx.params or counts["flash"] != want or counts["flash_mla"] != want:
            raise AssertionError(f"{label}: launches {counts}, kernel 3 (MLA) {want} unrolled")
        # 34 000 launches a prefill and 4 100-4 500 a decode step: the traces
        # are kept short (a w4 prefill runs the exact mode's sweep)
        profile_decode(torch, ctx, lcfg, label, n_steps=4, prefill=mode is None)
        out[label] = counts
        del ctx
        torch.cuda.empty_cache()
        if mode is None:
            out.update(deepseek2_engine(torch, lcfg, params, tok))
        del params
        torch.cuda.empty_cache()
    path.unlink()
    return out


def deepseek2_engine(torch, cfg, params, tok) -> dict:
    """The engine (runtime/engine.py) serving 4 concurrent greedy requests
    (64-token prompts, 32 tokens) at 4 slots on the loaded DeepSeek-V2-Lite:
    tokens/s, TTFT per request, decode and chunked steps, and kernel 3's MLA
    launches; every request ends at its 32 tokens."""
    import numpy as np

    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.runtime.engine import Engine, Request
    from llama_kotlin_tpu_torch.sampling.samplers import SamplingParams

    ctx = LlamaContext(cfg, params, n_cells=SERVE_CELLS, device="cuda")
    mla = mla_counter()
    mla.LAUNCHES = 0
    reqs = [Request(prompt_tokens=np.random.default_rng(50 + i).integers(
        259, cfg.vocab_size, 64).astype(np.int32), params=SamplingParams(temp=0.0),
        n_predict=32) for i in range(4)]
    eng = Engine(ctx, tok, n_slots=4, n_batch=256)
    dt = _drive(eng, reqs)
    n = sum(len(r.output_tokens) for r in reqs)
    line = {"phase": "deepseek2_engine", "slots": 4, "requests": len(reqs), "wall_s": dt,
            "tokens": n, "tok_s": n / dt, "decode_steps": eng.metrics["n_decode_steps"],
            "chunked_steps": eng.n_chunked, "flash_mla": mla.LAUNCHES,
            "ttft_ms": [(r.t_first_token - r.t_start) * 1e3 for r in reqs]}
    log(json.dumps(line))
    if n != 4 * 32 or not mla.LAUNCHES:
        raise AssertionError(f"deepseek2_engine: {line}")
    del ctx
    return {"deepseek2_engine": {"flash_mla": mla.LAUNCHES}}


def replayed_route(torch, router, ids, norm_topk: bool, scale: float):
    """ops/moe.py::route's (top_w, top_i) for the given experts ids [nt, k]
    in place of its own top k (a run that replays another's routing)."""
    w = torch.softmax(router.to(torch.float32), dim=-1).gather(-1, ids)
    if norm_topk:
        w = w / w.sum(dim=-1, keepdim=True)
    return (w * scale if scale != 1.0 else w), ids


def moe_card_vs_cpu(torch, label: str, build, prompt, tol: float, steps: int = 4) -> None:
    """card_vs_cpu on a MoE model, the card on the CPU's routing.  Top-k of
    many experts parts at near-ties between two devices (the router's
    inputs differ by the f32 order of every product before it), and one
    expert moves the logits far past any tolerance; so the CPU run records
    every routing call's experts and probabilities (ops/moe.py::route, in
    order), and the card run takes the CPU's experts with its own
    probabilities' weights.  The card's own choice is kept: every row where
    it parts from the CPU's must be a near-tie, the CPU's k-th minus
    (k+1)-th probability at most twice the measured noise (the largest
    difference between the two devices' probabilities over all rows); they
    are counted."""
    import numpy as np

    from llama_kotlin_tpu_torch.ops import moe

    real = moe.route
    rec = {"i": [], "p": []}

    def recording(router, n_used, norm_topk, scale):
        rec["p"].append(torch.softmax(router.to(torch.float32), dim=-1).numpy())
        w, i = real(router, n_used, norm_topk, scale)
        rec["i"].append(i.numpy())
        return w, i

    def cpu_run():
        moe.route = recording
        try:
            return greedy_logits(build, "cpu", prompt, steps)
        finally:
            moe.route = real

    cl = cpu_ref(label, cpu_run)
    top_i = cpu_ref(f"{label}_top_i", lambda: [np.concatenate(rec["i"])])[0].astype(np.int64)
    probs = cpu_ref(f"{label}_probs", lambda: [np.concatenate(rec["p"])])[0]
    if REFS["writer"]:
        return
    st = {"row": 0, "noise": 0.0, "gaps": []}

    def replay(router, n_used, norm_topk, scale):
        nt = router.shape[0]
        r0 = st["row"]
        st["row"] += nt
        p = torch.softmax(router.to(torch.float32), dim=-1).cpu().numpy()
        st["noise"] = max(st["noise"], float(np.abs(p - probs[r0:r0 + nt]).max()))
        _, own = real(router, n_used, norm_topk, scale)
        own = own.cpu().numpy()
        for r in range(nt):
            if set(own[r].tolist()) != set(top_i[r0 + r].tolist()):
                srt = np.sort(probs[r0 + r])[::-1]
                st["gaps"].append(float(srt[n_used - 1] - srt[n_used]))
        ids = torch.from_numpy(top_i[r0:r0 + nt]).to(router.device)
        return replayed_route(torch, router, ids, norm_topk, scale)

    moe.route = replay
    try:
        card_vs_cpu(torch, label, build, prompt, tol, steps=steps, cpu=(None, cl))
    finally:
        moe.route = real
    line = {"phase": f"{label}_routing", "rows": int(top_i.shape[0]),
            "parted_rows": len(st["gaps"]), "noise": st["noise"], "gaps": st["gaps"]}
    log(json.dumps(line))
    if st["row"] != top_i.shape[0] or any(g > 2 * st["noise"] for g in st["gaps"]):
        raise AssertionError(f"{label}: the card's routing parts from the CPU's off a "
                             f"near-tie: {line}")


def moe_parity_phase(torch, tmpdir: Path) -> None:
    """Full width, 2 layers, card against CPU by moe_card_vs_cpu (prefill of
    64 tokens plus 4 greedy steps): DeepSeek-V2-Lite's dense lead and first
    MoE layer (deepseek_v2_lite(n_layer=2), Q4_K_M's mix) in the exact and
    w4 modes, and a Mixtral-8x7B-shaped file (mixtral_8x7b(n_layer=2): E
    4096, 8 experts of 14336, top-2) in w4, whose per-expert W4 fold lists
    run through _moe_sweep.  tol: the exact mode 3e-2 of max|logits|,
    parity_phase's (bf16 operands: the W4A8 model's one-thread vs
    eight-thread CPU spread, 1.33e-2, with room); w4 5e-2,
    gguf_parity_phase's for a w4 GGUF file (every matmul re-quantizes its
    input to int8: that file's CPU spread is 2.6e-2), twice the spread of
    these files' own (scripts/moe_cpu_spread.py on the 8-core host of an
    H100: Mixtral-shaped w4 2.4e-2, DeepSeek-V2-Lite w4 1.3e-2 and exact
    3.4e-3)."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.models.synthetic import deepseek_v2_lite, mixtral_8x7b
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext

    tols = {None: 3e-2, "w4": 5e-2}
    for name, (cfg, moe_shape), modes, seed in (
            ("deepseek2", deepseek_v2_lite(n_layer=2), (None, "w4"), DS2_SEED + 1),
            ("mixtral", mixtral_8x7b(n_layer=2), ("w4",), DS2_SEED + 2)):
        path, _ = child_file(tmpdir, f"{name}-2layer.gguf")
        prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, 64).astype(np.int32)
        for mode in modes:
            def build(dev, mode=mode, path=path):
                lcfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True, device=dev)
                f.close()
                return LlamaContext(lcfg, params, n_cells=1024, buckets=(8, 16, 32, 64),
                                    device=dev)

            moe_card_vs_cpu(torch, f"{name}_parity_{mode or 'exact'}", build, prompt,
                            tols[mode])
        path.unlink()


def gemma2_phase(torch, tmpdir: Path) -> dict:
    """gemma-2-9b at its published widths and its first EARLIER_LAYERS
    layers (all 42 until llama3-70b's phase came; models/synthetic.py::
    gemma2_9b: E 3584, 16 heads on 8 kv heads of 256,
    F 14336, vocab 256000, a 4096-cell window on every other layer, softcaps
    50 and 30), random wire blocks from GEMMA_SEED in Q4_K_M's mix (Q6_K
    attn_v and ffn_down on use_more_bits layers, the tied token_embd Q6_K,
    no output) with an SPM vocab of its 256000 pieces, loaded in the exact
    mode (the default) and in w4; each serves 3 requests (64-token prompt,
    32 greedy tokens) through LlamaContext and generate_loop by serve(),
    unrolled (the windows), kernel 3's D = 256 branch once a layer at every
    forward (one a layer at a decode step and a prefill), never the plain
    attention,
    and every kernel's launches exactly route_counts'; then a
    profiled prefill and 4 profiled decode steps.  Returns {path: launch
    counts}."""
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.ops.cuda import (flash, flash_stacked, qmm, qmm_int8, qmm_w4,
                                                 qmm_w4_ffn, qmm_w4x, qmm_w8)

    path, written = child_file(tmpdir, GEMMA2_FILE)
    log(json.dumps({"phase": "gemma2_file", **written, "type_mix": type_mix(path)}))
    out = {}
    for mode in (None, "w4"):
        label = f"gemma2_{mode or 'exact'}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lcfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        f.close()
        log(json.dumps({"phase": label, "n_layer": lcfg.n_layer, "load_s": load_s,
                        "device_bytes": torch.cuda.memory_allocated(),
                        "swa_window": lcfg.swa_window, "softcaps": [lcfg.attn_logit_softcap,
                                                                    lcfg.final_logit_softcap],
                        "tied_head": "output" not in params}))
        if mode is None:  # every projection and the head on kernel 4's exact branch
            mods = (qmm, exact_counter(), flash, d256_counter())
            never = (qmm_w4, qmm_w4_ffn, qmm_w8, qmm_int8, qmm_w4x, flash_stacked)
        else:  # W4 on kernel 1, W8 (Q6_K attn_v, ffn_down, the tied head) on 5
            mods = (qmm_w4, qmm_w8, qmm, flash, d256_counter())
            never = (qmm_w4_ffn, qmm_int8, qmm_w4x, flash_stacked)
        plain = plain_attention_counters()
        try:
            counts, ctx = serve(torch, lcfg, params, mods, label, never=never + plain)
        finally:
            for c in plain:
                c.close()
        # a prefill and 31 decode steps a request; every kernel-3 launch on
        # its D = 256 branch
        want = route_counts(lcfg, params, 3 * 32, 3 * 31, mode)
        want["flash_d256"] = want["flash"]
        got = {k: counts[k] for k in want}
        log(json.dumps({"phase": f"{label}_routes", "launches": got, "expected": want}))
        if "layers" not in ctx.params or got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        profile_decode(torch, ctx, lcfg, label, n_steps=4)
        out[label] = counts
        del ctx, params
        torch.cuda.empty_cache()
    path.unlink()
    return out


def gemma_parity_cases(tmpdir: Path) -> list:
    """gemma_parity_phase's checks, (label, build, prompt, tol), on their
    2-layer files (gemma_parity_files, taken from the writer child or
    written into tmpdir): gemma-2-9b's widths with the file's window under
    the prompt, in the exact and w4 modes; gemma-7b's widths (MHA 16/16, F
    24576) on the stacked path (attend_stacked_plain), in the exact mode.
    (In w4 kernel 2
    would decline gemma-7b's FFN as JAX's does: E = 3072 folds gate and up
    in the legacy layout, no multiple of 2048, and down compact.)  tol, of
    max|logits|: gguf_parity_phase's rule, twice the CPU's own
    8-thread-against-1 spread on these files, rounded up
    (scripts/gemma_cpu_spread.py on the H100 machine's host, PERF.md, PR
    17 run C: gemma-2-9b exact 1.34e-3, w4 4.78e-3, gemma-7b 6.5e-4)."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext

    tols = {("gemma2", None): 3e-3, ("gemma2", "w4"): 1e-2, ("gemma", None): 1.5e-3}
    cases = []
    for name, (cfg, _kw) in gemma_parity_files().items():
        path = tmpdir / name
        if not path.exists():
            child_file(tmpdir, name)
        prompt = np.random.default_rng(GEMMA_SEED).integers(0, cfg.vocab_size, 64).astype(
            np.int32)
        for mode in ((None, "w4") if cfg.arch == "gemma2" else (None,)):
            def build(dev, mode=mode, path=path):
                lcfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True, device=dev)
                f.close()
                return LlamaContext(lcfg, params, n_cells=1024, buckets=(8, 16, 32, 64),
                                    device=dev)

            label = name.split("-")[0]
            cases.append((f"{label}_parity_{mode or 'exact'}", build, prompt,
                          tols[cfg.arch, mode]))
    return cases


def gemma_parity_phase(torch, tmpdir: Path) -> None:
    """Full width, 2 layers, card against CPU by card_vs_cpu (prefill of 64
    tokens plus 4 greedy steps) on gemma_parity_cases; on the card run the
    gemma2 files must take kernel 3's D = 256 branch once a layer and step
    and the gemma-7b file the stacked path's plain attention (kernel 3 and
    kernel 9 never), kernel 2 never."""
    from llama_kotlin_tpu_torch.ops.cuda import flash, flash_stacked, qmm_w4_ffn

    d256 = d256_counter()
    for label, build, prompt, tol in gemma_parity_cases(tmpdir):
        cl = cpu_ref(label, lambda: greedy_logits(build, "cpu", prompt, 4))
        if REFS["writer"]:
            continue
        plain = plain_attention_counters()
        counters = (flash, d256, flash_stacked, qmm_w4_ffn) + plain
        for c in counters:
            c.LAUNCHES = 0
        try:
            card_vs_cpu(torch, label, build, prompt, tol, cpu=(None, cl))
        finally:
            for c in plain:
                c.close()
        got = {mod_name(c): c.LAUNCHES for c in counters}
        log(json.dumps({"phase": f"{label}_routes", "launches": got}))
        if label.startswith("gemma2"):
            ok = got["flash_d256"] == got["flash"] == 2 * 5 and not got["attend_stacked_plain"]
        else:
            ok = not got["flash"] and got["attend_stacked_plain"] == 2 * 5
        if not ok or got["flash_stacked"] or got["qmm_w4_ffn"]:
            raise AssertionError(f"{label}: launches {got}")
    for p in tmpdir.glob("gemma*-2layer.gguf"):
        p.unlink()


# -- the IQ wire formats, the Q8F high-batch shadow, the synthetic modes and
# -- llama3-70b

# kernel 4's IQ rows: llama3-8B's fused qkv and gate|up
IQ_SHAPES = {"qkv": (6144, 4096), "gate_up": (28672, 4096)}
# kernel 5's IQ rows (the W8 and W8X folds of the w4 and w4x modes): one
# format of each group size
IQ_W8_TIMED = ("IQ2_XS", "IQ4_XS")


def write_iq_file(path: Path, n_layer: int = EARLIER_LAYERS, seed: int = IQ_SEED) -> dict:
    """iq_formats_phase's file: llama3-8B at full width, n_layer layers of
    the every-IQ mix (every_iq_layer_types: the nine IQ formats on its
    matrices, no two of a layer alike, so none fuses), an IQ4_XS token_embd
    and an IQ3_S output."""
    from llama_kotlin_tpu_torch.models.synthetic import every_iq_layer_types, preset_config
    from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q

    return _written(path, preset_config("llama3-8b", n_layer=n_layer), seed=seed,
                    layer_types=every_iq_layer_types(n_layer), embd_type=Q.IQ4_XS,
                    output_type=Q.IQ3_S, matrix_type=Q.IQ4_XS)


def write_iq_parity_file(path: Path) -> dict:
    """iq_parity_cases' file: the every-IQ mix at 2 layers (14 matrices,
    each of the nine formats on one at least)."""
    return write_iq_file(path, n_layer=2, seed=IQ_SEED + 1)


def iq_kernel_phase(torch, results: dict) -> None:
    """Kernel 4's exact branch (csrc/qmm_exact.cu) on the nine IQ repacks:
    each format's repack, W8 fold and Q8F made on the card from random wire
    blocks equal the CPU's bit for bit; then at llama3-8B's qkv and gate|up
    widths (IQ_SHAPES) and m = 1, 64 and 512 (EXACT_ROWS), repeated
    bit-equal, held against the plain version and against an f32 product
    with the weight dequantized on the card from the wire bytes and rounded
    to bf16, timed beside torch.matmul on that weight (library_ms).  tol:
    identical bf16 operands (the IQ factors are exact in f32), f32 order
    only.  Kernel 5 on the W8 and W8X folds of IQ_W8_TIMED's formats
    (group 16 and 32) at b = 1 and 32, timed against its plain version
    (tol: exact integer partials, f32 order of the scale products)."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.synthetic import EVERY_IQ, wire_blocks
    from llama_kotlin_tpu_torch.ops.cuda import qmm, qmm_w8
    from llama_kotlin_tpu_torch.quant import fold, repack

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(8765)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(88)
    for qtype in EVERY_IQ:
        data = torch.from_numpy(wire_blocks(rng, qtype, 512, 4096))
        repack_equal(torch, data, qtype, 512, 4096, repack.repack, "repack")
        repack_equal(torch, data, qtype, 512, 4096, repack.repack_q8flat, "q8f")
        repack_equal(torch, data, qtype, 512, 4096,
                     lambda d, q, n, k: fold.fold_to_w8(repack.repack(d, q, n, k)), "w8 fold")
        for name, (n, k) in IQ_SHAPES.items():
            wire = torch.from_numpy(wire_blocks(rng, qtype, n, k)).to(dev)
            wt = repack.repack(wire, qtype, n, k)
            if not fold.is_exact(wt):
                raise AssertionError(f"{qtype.name}: the repack is no exact layout")
            wdq = repack.dequantize_wire(wire, qtype, (n, k)).to(torch.bfloat16)
            del wire
            for m in EXACT_ROWS:
                xb = (torch.randn((m, k), generator=gen, device=dev) * 0.7).to(torch.bfloat16)
                got = qmm.qmm(xb, wt)
                shape = f"exact {qtype.name} {name} n={n} k={k} m={m}"
                repeats(torch, "qmm", shape, got, lambda: qmm.qmm(xb, wt))
                wire_err = err_of(got, xb.float() @ wdq.float().T)
                log(json.dumps({"phase": "iq_vs_wire", "shape": shape, **wire_err}))
                if not wire_err["rel"] <= 1e-3:
                    raise AssertionError(f"{shape}: {wire_err} off the wire's product")
                report_row(results, "qmm", shape, err_of(got, qmm.qmm_plain(xb, wt)), 1e-3,
                           time_ms(torch, lambda: qmm.qmm(xb, wt), flush),
                           time_ms(torch, lambda: qmm.qmm_plain(xb, wt), flush),
                           m * k * 2 + nbytes(wt, EXACT_PLANES) + m * n * 4, 2 * m * n * k,
                           "bf16", time_ms(torch, lambda: torch.matmul(xb, wdq.T), flush))
            for label, precise in (("qmm_w8", False), ("qmm_w8_precise", True)):
                if qtype.name not in IQ_W8_TIMED:
                    break
                w8 = fold.fold_to_w8(wt, precise=precise)
                for b in (1, 32):
                    x = torch.randn((b, k), generator=gen, device=dev) * 0.7
                    got = qmm_w8.qmm_w8_matmul(x, w8)
                    shape = f"{qtype.name} {name} n={n} k={k} b={b} group={w8.group_size}"
                    if qmm_w8.use_mma(b):
                        repeats(torch, label, shape, got, lambda: qmm_w8.qmm_w8_matmul(x, w8))
                    report_row(results, label, shape, err_of(got, qmm_w8.qmm_w8_plain(x, w8)),
                               1e-4, time_ms(torch, lambda: qmm_w8.qmm_w8_matmul(x, w8), flush),
                               time_ms(torch, lambda: qmm_w8.qmm_w8_plain(x, w8), flush),
                               b * k * 4 + nbytes(w8) + b * n * 4, (1 + precise) * 2 * b * n * k,
                               "int8", matmul_ms(torch, x, w8, flush))
                del w8
            del wt, wdq
    del flush
    torch.cuda.empty_cache()


def iq_formats_phase(torch, tmpdir: Path) -> dict:
    """A full-width llama3-8B file of EARLIER_LAYERS layers of the every-IQ
    mix (write_iq_file; the writer child's) loaded in all four modes, each
    serving 3 requests (64-token prefill, 8 greedy tokens) on the default
    context with exact launch counts: exact, every projection on kernel 4's
    exact branch at every row count (29 a forward); w4, the W8 folds on
    kernel 5 at decode rows and kernel 4's 8-bit branch at the prefill's;
    w4x, the W8X folds on kernel 5's dual-plane branch, kernel 4 at the
    prefill; int8, Q8F on kernel 6 (uniform layers: stacked, kernel 9).
    The mixed modes stay unrolled (kernel 3); kernels 1, 2 and 7 never
    launch.  Returns {path: launch counts}."""
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.ops.cuda import (flash, flash_stacked, qmm, qmm_int8, qmm_w4,
                                                 qmm_w4_ffn, qmm_w4x, qmm_w8)

    path, wrote = child_file(tmpdir, IQ_FILE)
    L, n_new = EARLIER_LAYERS, 8
    per = 7 * L + 1  # a forward's projections: 7 a layer, none fused, and the lm_head
    ex, precise = exact_counter(), w8_precise()
    every = (flash, flash_stacked, qmm, ex, qmm_w4, qmm_w4_ffn, qmm_w8, precise, qmm_int8,
             qmm_w4x)
    fwd, steps = 3 * n_new, 3 * (n_new - 1)  # forwards and decode steps over the 3 requests
    w8 = 3 + steps * per  # the prefill's lm_head row, every projection of a step
    modes = {None: ((flash, qmm, ex), {"flash": fwd * L, "qmm": fwd * per,
                                       "qmm_exact": fwd * per}),
             "w4": ((flash, qmm, qmm_w8), {"flash": fwd * L, "qmm": 3 * (per - 1),
                                           "qmm_w8": w8}),
             "w4x": ((flash, qmm, precise),  # kernel 5's dual-plane branch counts apart
                     {"flash": fwd * L, "qmm": 3 * (per - 1), "qmm_w8_precise": w8}),
             "int8": ((flash_stacked, qmm_int8), {"flash_stacked": fwd * L,
                                                  "qmm_int8": fwd * (4 * L + 1)})}
    counts = {}
    for mode, (mods, want) in modes.items():
        label = f"every_iq_{mode or 'exact'}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        f.close()
        log(json.dumps({"phase": label, "file": wrote, "load_s": load_s,
                        "w_bytes_per_tok": streamed_bytes(params), "layouts": sorted(
                            {(v.qtype.name, v.flavor or "exact") for lp in params["layers"]
                             for v in lp.values() if hasattr(v, "codes")})}))
        counts[label], ctx = serve(torch, cfg, params, mods, label, n_new=n_new,
                                   never=tuple(m for m in every if m not in mods))
        if counts[label] != want or ("layers_stacked" in ctx.params) != (mode == "int8"):
            raise AssertionError(f"{label}: launches {counts[label]}, expected {want}")
        del ctx, params
        torch.cuda.empty_cache()
    path.unlink()
    return counts


def iq_parity_cases(tmpdir: Path) -> list:
    """iq_parity_phase's checks, (label, build, prompt, tol), on the 2-layer
    every-IQ file (the writer child's, or written into tmpdir) in the exact
    and w4 modes, unrolled (its layers differ).  tol, of max|logits|:
    twice the CPU's own 8-thread-against-1 spread on this file, rounded up
    (scripts/iq_70b_cpu_spread.py on the H100 machine's host; PERF.md)."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext

    path = tmpdir / IQ_PARITY_FILE
    if not path.exists():
        child_file(tmpdir, IQ_PARITY_FILE)
    prompt = np.random.default_rng(IQ_SEED).integers(0, 128256, 64).astype(np.int32)
    tols = {None: 2e-2, "w4": 4e-2}  # spreads 7.98e-3 and 1.83e-2
    cases = []
    for mode in (None, "w4"):
        def build(dev, mode=mode):
            cfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True, device=dev)
            f.close()
            return LlamaContext(cfg, params, n_cells=1024, buckets=(8, 16, 32, 64), device=dev)

        cases.append((f"iq_parity_{mode or 'exact'}", build, prompt, tols[mode]))
    return cases


def iq_parity_phase(torch, tmpdir: Path) -> None:
    """Full width, 2 layers of the every-IQ mix, card against CPU by
    card_vs_cpu (a 64-token prefill and 4 greedy steps) in the exact mode
    (kernel 4's exact branch only) and in w4 (kernels 5 and 4); kernels 1,
    2 and 7 never."""
    from llama_kotlin_tpu_torch.ops.cuda import qmm, qmm_w4, qmm_w4_ffn, qmm_w4x, qmm_w8

    ex = exact_counter()
    counters = (qmm, ex, qmm_w8, qmm_w4, qmm_w4_ffn, qmm_w4x)
    for label, build, prompt, tol in iq_parity_cases(tmpdir):
        cl = cpu_ref(label, lambda: greedy_logits(build, "cpu", prompt, 4))
        if REFS["writer"]:
            continue
        for c in counters:
            c.LAUNCHES = 0
        card_vs_cpu(torch, label, build, prompt, tol, cpu=(None, cl))
        got = {mod_name(c): c.LAUNCHES for c in counters}
        log(json.dumps({"phase": f"{label}_routes", "launches": got}))
        exact = label.endswith("exact")
        if (got["qmm_exact"] == 0) != (not exact) or (got["qmm_w8"] == 0) != exact or any(
                got[k] for k in ("qmm_w4", "qmm_w4_ffn", "qmm_w4x")):
            raise AssertionError(f"{label}: launches {got}")
    (tmpdir / IQ_PARITY_FILE).unlink(missing_ok=True)


def without_shadows(params):
    """A copy of a params tree whose W4 folds carry no Q8F shadow (views of
    the same tensors)."""
    from llama_kotlin_tpu_torch.quant.qtensor import QTensor

    if isinstance(params, QTensor):
        if params.aux is None or "q8_codes" not in params.aux:
            return params
        return replace(params, aux={k: v for k, v in params.aux.items()
                                    if k not in ("q8_codes", "q8_scale")})
    if isinstance(params, dict):
        return {k: without_shadows(v) for k, v in params.items()}
    if isinstance(params, list):
        return [without_shadows(v) for v in params]
    return params


# the dual fold's batched_bench rows, (prompt tokens, slots,
# LKTPU_LAYER_FUSED): decode rows at 1 and 8 slots (at and below
# LKTPU_W4_BMAX: kernels 1 and 2, or 10), 16 and 32 (the shadow; 32
# sequences are the most the cell metadata holds, as JAX's), each after a
# 300-token prompt (the 512-row bucket: kernel 4 with a shadow or not);
# prompts of 64 and 256 tokens, whose rows take the shadow
DUAL_COMBOS = ((300, 1, False), (300, 8, False), (300, 16, False), (300, 32, False),
               (300, 8, True), (300, 16, True), (64, 1, False), (256, 1, False))
DUAL_STEPS = 8


def dual_counts(L: int, T: int, pp_rows: int, P: int, dual: bool, fused: bool) -> dict:
    """The launches of one bench_combo on a W4 model of L layers: a prompt
    of pp_rows rows (its q|k|v, o, gate|up and down; its lm_head one row on
    kernel 1), then T decode steps of P rows; with the shadow (dual) rows
    above LKTPU_W4_BMAX (8) and up to 256 take kernel 6."""
    want = dict.fromkeys(("qmm", "qmm_w4", "qmm_w4_ffn", "qmm_int8", "qmm_w4_layer"), 0)
    want["qmm_w4"] = 1
    want["qmm_int8" if dual and 8 < pp_rows <= 256 else "qmm"] += 4 * L
    if dual and P > 8:
        want["qmm_int8"] += T * (4 * L + 1)
    elif P > 32:
        want["qmm"] += T * (4 * L + 1)
    elif fused and P <= 8:
        want["qmm_w4"] += T * (L + 1)
        want["qmm_w4_layer"] += T * L
    else:
        want["qmm_w4"] += T * (2 * L + 1)
        want["qmm_w4_ffn"] += T * L
    want["flash_stacked"] = L * (1 + T)
    return want


def dual_fold_phase(torch, results: dict) -> dict:
    """The Q8F high-batch shadow (LKTPU_DUAL_FOLD=1) on the synthetic
    llama3-8B W4A8 model of EARLIER_LAYERS layers, drawn with the switch on
    (synthetic_params_device attaches a shadow to every W4 fold):
    - the shadow's extra bytes a weight, logged;
    - each shadowed projection (qkv, o, gate|up, down, lm_head) at 9, 16, 64
      and 256 rows through qmatmul: kernel 6 alone launches, held against
      kernel 6's plain version on the shadow; timed at 16 and 256 rows; at
      8 rows (kernel 1) and 257 (kernel 4) bit-equal to the fold without a
      shadow;
    - a 16-token prefill's logits (every projection on the shadow) against
      the same prefill without shadows, within the W4-vs-Q8F rounding the
      CPU tests allow (tests/test_torch_dual_fold.py, FAST_TOL 4e-2);
    - tools/batched_bench.py's bench_combo at DUAL_COMBOS with and without
      the shadows, warm, with exact launch counts (dual_counts): kernels 1
      and 2 up to 8 slots, kernel 6 and never kernels 1 and 2 at 16 and 32
      slots and at 64- and 256-token prompts, kernel 4 at the 300-token
      prompt (512 rows); under LKTPU_LAYER_FUSED=1 kernel 10 takes 8 slots
      and declines 16; prompt and decode tokens/s of each.
    Returns {path: launch counts}."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.synthetic import preset_config, synthetic_params_device
    from llama_kotlin_tpu_torch.ops import qmatmul as qm
    from llama_kotlin_tpu_torch.ops.cuda import (flash_stacked, qmm, qmm_int8, qmm_w4,
                                                 qmm_w4_ffn, qmm_w4_layer)
    from llama_kotlin_tpu_torch.quant import fold
    from llama_kotlin_tpu_torch.runtime.batch import Batch
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.tools.batched_bench import bench_combo

    dev = torch.device("cuda")
    L = EARLIER_LAYERS
    cfg = preset_config("llama3-8b", n_layer=L)
    t0 = time.perf_counter()
    with knobs(LKTPU_DUAL_FOLD="1"):
        params = synthetic_params_device(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    plain = without_shadows(params)
    lp = params["layers"][0]
    mats = {"qkv": lp["wqkv_fused"], "o": lp["wo"], "gate_up": lp["ffn_gateup_fused"],
            "down": lp["ffn_down"], "lm_head": params["output"]}
    folds = [params["tok_embd"], params["output"]] + [
        w for layer in params["layers"] for w in layer.values() if hasattr(w, "codes")]
    if not all(fold.has_shadow(w) for w in folds):
        raise AssertionError("a W4 fold of the dual-fold draw has no shadow")
    weights = sum(w.n * w.k for w in folds)
    shadow_bytes = sum(w.aux["q8_codes"].numel() + 4 * w.aux["q8_scale"].numel()
                       for w in folds)
    fold_bytes = sum(nbytes(without_shadows(w), w4_planes(w)) for w in folds)
    log(json.dumps({"phase": "dual_fold", "n_layer": L, "build_s": build_s,
                    "weights": weights, "fold_bits_per_weight": 8 * fold_bytes / weights,
                    "shadow_bits_per_weight": 8 * shadow_bytes / weights,
                    "device_bytes": torch.cuda.memory_allocated()}))
    gen = torch.Generator(device=dev)
    gen.manual_seed(4242)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows_kernel = {8: qmm_w4, 9: qmm_int8, 16: qmm_int8, 64: qmm_int8, 256: qmm_int8, 257: qmm}
    for name, w in mats.items():
        q8 = fold.q8_shadow(w)
        for b, kern in rows_kernel.items():
            x = torch.randn((b, w.k), generator=gen, device=dev) * 0.7
            c0 = {m: m.LAUNCHES for m in (qmm, qmm_int8, qmm_w4)}
            got = qm.qmatmul(x, w)
            hit = [mod_name(m) for m in c0 if m.LAUNCHES != c0[m]]
            if hit != [mod_name(kern)]:
                raise AssertionError(f"shadow {name} b={b}: launched {hit}, not {mod_name(kern)}")
            shape = f"shadow {name} n={w.n} k={w.k} b={b}"
            if kern is not qmm_int8:
                if not torch.equal(got, qm.qmatmul(x, without_shadows(w))):
                    raise AssertionError(f"{shape}: not the fold's own route bit for bit")
                continue
            ref = qmm_int8.qmm_int8_plain(x, q8)
            if b in (16, 256):
                report_row(results, "qmm_int8", shape, err_of(got, ref), 1e-3,
                           time_ms(torch, lambda: qmm_int8.qmm_int8(x, q8), flush),
                           time_ms(torch, lambda: qmm_int8.qmm_int8_plain(x, q8), flush),
                           b * w.k * 4 + nbytes(q8) + b * w.n * 4, 2 * b * w.n * w.k, "int8",
                           matmul_ms(torch, x, q8, flush))
            else:
                check_row(results, "qmm_int8", shape, got, ref, 1e-3)
    del flush
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, 16).astype(np.int32)
    logits = []
    for p in (params, plain):
        ctx = LlamaContext(cfg, p, n_cells=256, device="cuda")
        assert ctx.decode(Batch.single(prompt)) == 0
        logits.append(ctx.logits_device()[-1].float())
        del ctx
    err = err_of(logits[0], logits[1])
    log(json.dumps({"phase": "dual_fold_prefill_logits", "rows": 16, **err, "tol_rel": 4e-2}))
    if not err["rel"] <= 4e-2:
        raise AssertionError(f"dual fold: the shadow's prefill logits are {err} off the W4 route's")
    counted = (qmm, qmm_w4, qmm_w4_ffn, qmm_int8, qmm_w4_layer, flash_stacked)
    by_path = {}
    for label, p in (("dual", params), ("plain", plain)):
        ctx = LlamaContext(cfg, p, n_cells=4096, device="cuda")
        for n_pp, P, fused in DUAL_COMBOS:
            if fused and label == "plain":
                continue
            with knobs(LKTPU_LAYER_FUSED="1" if fused else "0"):
                bench_combo(ctx, n_pp, DUAL_STEPS, P)  # warm
                for m in counted:
                    m.LAUNCHES = 0
                row = bench_combo(ctx, n_pp, DUAL_STEPS, P)
            got = {mod_name(m): m.LAUNCHES for m in counted}
            pp_rows = next(b for b in ctx.buckets if b >= n_pp)
            want = dual_counts(L, DUAL_STEPS, pp_rows, P, label == "dual", fused)
            log(json.dumps({"phase": "dual_fold_batched", "path": label, "prompt_rows": pp_rows,
                            "slots": P, "layer_fused": fused, **row, "launches": got}))
            if got != want:
                raise AssertionError(f"dual fold {label} pp={n_pp} {P} slots: launches {got}, "
                                     f"expected {want}")
            by_path[f"dual_fold_{label}_pp{n_pp}_{P}{'_fused' if fused else ''}"] = got
        del ctx
        torch.cuda.empty_cache()
    del params, plain
    torch.cuda.empty_cache()
    return by_path


# synthetic_params_device's other modes at EARLIER_LAYERS: (path, mode,
# qtype, fuse); the synthetic W4A8 and W4X models have phases of their own
SYNTHETIC_CASES = (("synthetic_int8", "int8", "Q4_K", True),
                   ("synthetic_dequant", "dequant", "Q4_K", True),
                   ("synthetic_w4_sym", "w4", "Q4_0", True),
                   ("synthetic_dense", "dense", None, True),
                   ("synthetic_w4_unfused", "w4", "Q4_K", False))


def synthetic_modes_phase(torch) -> dict:
    """The llama3-8B draws of synthetic_params_device's other modes at
    EARLIER_LAYERS layers (SYNTHETIC_CASES: Q8F, exact Q4_K repacks, the sym
    W4 fold of a Q4_0 profile, dense bf16, and the W4 fold unfused), each
    serving 3 requests (64-token prefill, 8 greedy tokens) on the default
    context (uniform layers: stacked, kernel 9 attends) with exact launch
    counts: Q8F on kernel 6 and the exact repacks on kernel 4's exact
    branch at every row count (17 a forward); the sym fold on kernels 1
    and 2 at decode and 4 at the prefill; dense matrices on no matmul
    kernel; unfused, kernel 1 on q, k, v and o apart and kernel 2's up=
    branch.  Returns {path: launch counts}."""
    from llama_kotlin_tpu_torch.models.synthetic import preset_config, synthetic_params_device
    from llama_kotlin_tpu_torch.ops.cuda import (flash, flash_stacked, qmm, qmm_int8, qmm_w4,
                                                 qmm_w4_ffn, qmm_w4x, qmm_w8)
    from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q

    L, n_new = EARLIER_LAYERS, 8
    cfg = preset_config("llama3-8b", n_layer=L)
    ex = exact_counter()
    every = (flash, flash_stacked, qmm, ex, qmm_w4, qmm_w4_ffn, qmm_w8, qmm_int8, qmm_w4x)
    fwd, steps = 3 * n_new, 3 * (n_new - 1)
    attn = {"flash_stacked": fwd * L}
    wants = {
        "synthetic_int8": ((flash_stacked, qmm_int8), dict(attn, qmm_int8=fwd * (4 * L + 1))),
        "synthetic_dequant": ((flash_stacked, qmm, ex), dict(attn, qmm=fwd * (4 * L + 1),
                                                            qmm_exact=fwd * (4 * L + 1))),
        "synthetic_w4_sym": ((flash_stacked, qmm, qmm_w4, qmm_w4_ffn),
                             dict(attn, qmm=3 * 4 * L, qmm_w4=3 + steps * (2 * L + 1),
                                  qmm_w4_ffn=steps * L, qmm_w4_mma=0, qmm_w4_ffn_mma=0)),
        "synthetic_dense": ((flash_stacked,), attn),
        "synthetic_w4_unfused": ((flash_stacked, qmm, qmm_w4, qmm_w4_ffn),
                                 dict(attn, qmm=3 * 7 * L, qmm_w4=3 + steps * (4 * L + 1),
                                      qmm_w4_ffn=steps * L, qmm_w4_mma=0, qmm_w4_ffn_mma=0))}
    by_path = {}
    for path, mode, qtype, fuse in SYNTHETIC_CASES:
        t0 = time.perf_counter()
        params = synthetic_params_device(cfg, seed=3, device="cuda", mode=mode,
                                         qtype=None if qtype is None else Q[qtype], fuse=fuse)
        torch.cuda.synchronize()
        log(json.dumps({"phase": path, "mode": mode, "qtype": qtype, "fuse": fuse,
                        "build_s": time.perf_counter() - t0,
                        "device_bytes": torch.cuda.memory_allocated()}))
        mods, want = wants[path]
        counts, ctx = serve(torch, cfg, params, mods, path, n_new=n_new,
                            never=tuple(m for m in every if m not in mods))
        if counts != want or "layers_stacked" not in ctx.params:
            raise AssertionError(f"{path}: launches {counts}, expected {want} stacked")
        by_path[path] = counts
        del ctx, params
        torch.cuda.empty_cache()
    return by_path


def llama70b_phase(torch, results: dict) -> dict:
    """The llama3-70b preset at full width (E 8192, 64/8 heads, F 28672,
    vocab 128256) and its first EARLIER_LAYERS layers of 80 (all 80 until
    the llama-shaped family's phases came; PERF.md keeps those numbers),
    synthetic W4A8 weights drawn on the card (seed 0):
    - kernel 2's routes at F = 28672 for each row count of FFN_ROWS on layer
      0's FFN: the cooperative launch where coop_fits (1 row: h of 28672
      fits a block's shared memory; from 2 rows its tensor-core stage does
      not), kernel 1's tile elsewhere, each held against the plain version
      and logged; timed at 1 and 8 rows beside the unfused route;
    - kernel 1 at the 70B qkv, o and lm_head at 1 and 8 rows, timed;
    - 3 requests (64-token prefill, 8 greedy tokens) unrolled, with exact
      launch counts (kernel 4 4 a layer at the prefill, kernel 1 2 a layer
      and the lm_head a step, kernel 2 once a layer and step at one row, on
      its cooperative launch), then a profiled prefill and 8 decode steps
      (device busy, idle share, launches a step).
    Returns {path: launch counts}."""
    from llama_kotlin_tpu_torch.models.synthetic import preset_config, synthetic_params_device
    from llama_kotlin_tpu_torch.ops.cuda import flash, qmm, qmm_w4, qmm_w4_ffn

    cfg = preset_config("llama3-70b", n_layer=EARLIER_LAYERS)
    L, E, F = cfg.n_layer, cfg.n_embd, cfg.n_ff
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = synthetic_params_device(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    w_bytes = streamed_bytes(params)
    log(json.dumps({"phase": "llama3_70b", "n_layer": L, "build_s": build_s,
                    "w_bytes_per_tok": w_bytes, "w_floor_ms_per_tok": w_bytes / HBM_BYTES_S * 1e3,
                    "device_bytes": torch.cuda.memory_allocated()}))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7070)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    lp = params["layers"][0]
    gu, dn = lp["ffn_gateup_fused"], lp["ffn_down"]
    routes = {}
    for b in FFN_ROWS:
        x = torch.randn((b, E), generator=gen, device=dev) * 0.7
        n0 = qmm_w4_ffn.LAUNCHES_MMA
        got = qmm_w4_ffn.qmm_w4_ffn_matmul(x, gu, dn)
        tile = qmm_w4_ffn.LAUNCHES_MMA - n0
        want = int(qmm_w4_ffn.use_mma(b) or not qmm_w4_ffn.coop_fits(b, E, F))
        routes[b] = "tile" if tile else "cooperative"
        if tile != want:
            raise AssertionError(f"70b kernel 2 at {b} rows: tile {tile}, expected {want}")
        shape = f"70b compact E={E} F={F} b={b}"
        if b in (1, 8):
            ffn_row(torch, results, shape, got, x, gu, dn, None, flush)
        else:
            check_row(results, "qmm_w4_ffn", shape, got,
                      qmm_w4_ffn.qmm_w4_ffn_plain(x, gu, dn, "silu"), 5e-3)
    log(json.dumps({"phase": "llama3_70b_ffn_routes", "E": E, "F": F, "routes": routes,
                    "coop_smem": {b: qmm_w4_ffn.coop_smem(b, E, F) for b in FFN_ROWS}}))
    for name, wt in (("qkv", lp["wqkv_fused"]), ("o", lp["wo"]), ("lm_head", params["output"])):
        n, k = wt.shape
        for b in (1, 8):
            x = torch.randn((b, k), generator=gen, device=dev) * 0.7
            got = qmm_w4.qmm_w4_matmul(x, wt)
            report_row(results, "qmm_w4", f"70b compact {name} n={n} k={k} b={b}",
                       err_of(got, qmm_w4.qmm_w4_plain(x, wt)), 1e-4,
                       time_ms(torch, lambda: qmm_w4.qmm_w4_matmul(x, wt), flush),
                       time_ms(torch, lambda: qmm_w4.qmm_w4_plain(x, wt), flush),
                       b * k * 4 + nbytes(wt, w4_planes(wt)) + b * n * 4, 2 * b * n * k,
                       "int8", matmul_ms(torch, x, wt, flush))
    del flush, gu, dn, lp
    torch.cuda.empty_cache()
    n_new = 8
    counts, ctx = serve(torch, cfg, params, (qmm_w4, qmm_w4_ffn, flash, qmm), "llama3_70b",
                        n_new=n_new, prefer_unrolled=True)
    steps = 3 * (n_new - 1)
    want = {"qmm": 3 * 4 * L, "qmm_w4": 3 + steps * (2 * L + 1), "qmm_w4_ffn": steps * L,
            "flash": 3 * n_new * L, "qmm_w4_mma": 0, "qmm_w4_ffn_mma": 0}
    if counts != want:
        raise AssertionError(f"llama3_70b: launches {counts}, expected {want}")
    profile_decode(torch, ctx, cfg, "llama3_70b")
    del ctx, params
    torch.cuda.empty_cache()
    return {"llama3_70b": counts}


# of max|logits|: twice the CPU's own 8-thread-against-4 spread on the
# 2-layer llama3-70b (1.56e-2), rounded up (scripts/iq_70b_cpu_spread.py on
# the H100 machine's host; PERF.md)
LLAMA70B_PARITY_TOL = 3.5e-2


def llama70b_parity_case(torch) -> tuple:
    """(label, build, prompt, tol) of llama70b_parity_phase: llama3-70b at
    full width, 2 layers of synthetic W4A8 weights drawn on the card (seed
    1) and copied to the CPU, unrolled."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.synthetic import (params_to, preset_config,
                                                         synthetic_params_device)
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext

    cfg = preset_config("llama3-70b", n_layer=2)
    params = synthetic_params_device(cfg, seed=1, device="cuda")
    cpu_params = params_to(params, "cpu")
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, 64).astype(np.int32)

    def build(dev):
        return LlamaContext(cfg, params if dev == "cuda" else cpu_params, n_cells=1024,
                            buckets=(8, 16, 32, 64), prefer_unrolled=True, device=dev)

    return "parity_llama3_70b", build, prompt, LLAMA70B_PARITY_TOL


def llama70b_parity_phase(torch) -> None:
    """llama70b_parity_case, card against CPU by card_vs_cpu (a 64-token
    prefill and 4 greedy steps)."""
    label, build, prompt, tol = llama70b_parity_case(torch)
    card_vs_cpu(torch, label, build, prompt, tol)
    del build
    torch.cuda.empty_cache()


# -- the llama-shaped family: Qwen2-7B (7 query heads a kv head), Qwen1.5-
# -- MoE-A2.7B (a sigmoid-gated shared expert) and the other architectures
# -- JAX serves through its llama decoder

QWEN2_HEADS = (28, 4, 128)  # Qwen2-7B's query heads, kv heads (7 a group), head dim
QWEN2_FILE = "qwen2-7b-q4_k_m.gguf"
QWEN2MOE_FILE = "qwen1.5-moe-a2.7b-q4_k_m.gguf"
QWEN_SEED = 23
# Qwen2-7B's projections at full width, folded from Q4_K wire blocks as the
# w4 mode loads them: K = 3584 pads to 4096 and folds compact (qkv, o,
# gate|up, a Q4_K lm_head), K = 18944 pads to 19456 and folds legacy (down:
# its 9728 code columns are no multiple of 1024, JAX's quant/fold.py:178-185)
QWEN2_SHAPES = {"qkv": (4608, 3584), "o": (3584, 3584), "gate_up": (37888, 3584),
                "down": (3584, 18944), "lm_head": (152064, 3584)}


def head_group_flash_rows(torch, results: dict, gen, flush, tag: str, heads: tuple,
                          cells: int, cases, softcap: float = 0.0, view: int = 0) -> None:
    """Kernel 3 (and kernel 9 where a case asks) at `heads` = (H, KV, D)
    on layer 1 of a [2, KV, cells, D] cache: for each (n_vis, nt, kinds,
    stacked) of `cases`, nt query tokens (the step's tokens last, causal;
    at nt > 1 row 5 blind: exactly 0) over n_vis visible cells on each cache
    of `kinds` (bf16, int8, int4), and with stacked=True kernel 9 on the
    bf16 and int8 caches (the step's cells masked out, its rows merged
    fresh); each against its plain version, timed beside SDPA (which takes
    no softcap) and its bound (tol as the kernels' other rows).  softcap:
    the attention's logit softcap (grok's 30).  view > 0: the cache holds
    `view` kv heads a layer and kernel 3 attends over layer 1's 3-D view
    of its first KV (openelm's per-layer view, models/llama.py::
    _layer_cache; no kernel 9)."""
    from llama_kotlin_tpu_torch.ops.cuda import flash, flash_stacked
    from llama_kotlin_tpu_torch.runtime.kv_cache import (dequantize_cache_layer, quantize_rows,
                                                         quantize_rows_q4)

    report = functools.partial(report_row, results)
    dev = torch.device("cuda")
    (H, KV, D), L, li = heads, 2, 1
    scale = D ** -0.5
    kb = torch.randn((L, view or KV, cells, D), generator=gen, device=dev).to(torch.bfloat16)
    vb = torch.randn((L, view or KV, cells, D), generator=gen, device=dev).to(torch.bfloat16)
    (k8, ks), (v8, vs) = quantize_rows(kb), quantize_rows(vb)
    (k4, ks4), (v4, vs4) = quantize_rows_q4(kb), quantize_rows_q4(vb)
    caches = {"bf16": (kb, vb, None, None, 8, 4 * D),
              "int8": (k8, v8, ks, vs, 8, 2 * (D + 4)),
              "int4": (k4, v4, ks4, vs4, 4, 2 * (D // 2 + 4))}
    for n_vis, nt, kinds, stacked in cases:
        q = torch.randn((nt, H, D), generator=gen, device=dev).to(torch.bfloat16)
        tpos = torch.arange(n_vis - nt, n_vis, device=dev)
        cpos = torch.arange(n_vis, device=dev)
        mask = (cpos[None, :] <= tpos[:, None]).to(torch.int8)
        mask_cells = (cpos[None, :] < n_vis - nt).to(torch.int8).expand(nt, n_vis).contiguous()
        mask_new = (tpos[None, :] <= tpos[:, None]).to(torch.int8)
        if nt > 1:
            mask[5] = mask_cells[5] = mask_new[5] = 0  # a row that sees nothing
        new_k = torch.randn((nt, KV, D), generator=gen, device=dev).to(torch.bfloat16)
        new_v = torch.randn((nt, KV, D), generator=gen, device=dev).to(torch.bfloat16)
        for kind in kinds:
            k, v, ksc, vsc, bits, elem = caches[kind]
            kw = dict(scale=scale, k_scale=ksc, v_scale=vsc)
            kw3 = dict(kw, layer=li, kv_bits=bits, logit_softcap=softcap)
            lay = lambda t: t[li]  # noqa: E731
            if view:  # layer 1's first KV kv heads, a contiguous 3-D view
                k, v = k[li, :KV], v[li, :KV]
                ksc, vsc = (None, None) if ksc is None else (ksc[li, :KV], vsc[li, :KV])
                kw3 = dict(kw3, layer=None, k_scale=ksc, v_scale=vsc)
                lay = lambda t: t  # noqa: E731
            args = (q, k, v, mask)
            got = flash.flash_attention(*args, **kw3)
            if nt > 1 and bool(got[5].any()):
                raise AssertionError(f"kernel 3 at {tag} ({kind}): a blind row is not 0")
            kf, vf = (lay(k)[:, :n_vis], lay(v)[:, :n_vis]) if ksc is None else (
                dequantize_cache_layer(lay(c)[:, :n_vis], lay(sc)[:, :n_vis], torch.bfloat16,
                                       bits=bits) for c, sc in ((k, ksc), (v, vsc)))
            vis = int(mask.any(dim=0).sum().item())
            report("flash", f"{tag} {kind} cache nt={nt} n_vis={n_vis}",
                   err_of(got, flash.flash_attention_plain(*args, **kw3)), 1e-2,
                   time_ms(torch, lambda: flash.flash_attention(*args, **kw3), flush),
                   time_ms(torch, lambda: flash.flash_attention_plain(*args, **kw3), flush),
                   2 * nt * H * D * 2 + KV * vis * elem + nt * n_vis,
                   4 * D * int(mask.sum().item()) * H, "bf16",
                   time_ms(torch, sdpa_call(torch, q, kf, vf, mask, scale), flush))
            if not stacked or kind == "int4":
                continue  # kernel 9 takes no packed cache, as in JAX
            sargs = (q, k, v, li, new_k, new_v, mask_cells, mask_new)
            got = flash_stacked.flash_attention_stacked(*sargs, **kw)
            if nt > 1 and bool(got[5].any()):
                raise AssertionError(f"kernel 9 at {tag} ({kind}): a blind row is not 0")
            vis = int(mask_cells.any(dim=0).sum().item())
            lib = sdpa_call(torch, q, torch.cat([kf, new_k.transpose(0, 1)], dim=1),
                            torch.cat([vf, new_v.transpose(0, 1)], dim=1),
                            torch.cat([mask_cells, mask_new], dim=1), scale)
            report("flash_stacked", f"{tag} {kind} cache nt={nt} n_vis={n_vis}",
                   err_of(got, flash_stacked.flash_attention_stacked_plain(*sargs, **kw)),
                   1e-2,
                   time_ms(torch, lambda: flash_stacked.flash_attention_stacked(*sargs, **kw),
                           flush),
                   time_ms(torch, lambda: flash_stacked.flash_attention_stacked_plain(
                       *sargs, **kw), flush),
                   2 * nt * H * D * 2 + KV * vis * elem + 2 * nt * KV * D * 2
                   + nt * (n_vis + nt),
                   4 * D * int(mask_cells.sum().item() + mask_new.sum().item()) * H,
                   "bf16", time_ms(torch, lib, flush))
    del caches, kb, vb, k8, v8, ks, vs, k4, v4, ks4, vs4
    torch.cuda.empty_cache()


def qwen2_kernel_phase(torch, results: dict) -> None:
    """The kernels at Qwen2-7B's shapes:
    - kernel 3 at 28 heads on 4 kv heads (7 query heads a group: a token's
      seven rows straddle the tile's 64-row edges, csrc/flash_mma.cuh's
      tok0/ntok) on the bf16, int8 and packed int4 caches, layer 1 of a
      [2, 4, 4097, 128] cache: decode and a 64-token chunk (the step's
      tokens last, causal, row 5 blind: exactly 0) over 1024, 4096 and a
      ragged 1001 visible cells;
    - kernel 9 at 28/4 on the bf16 and int8 caches, the same steps on the
      stacked path (the step's cells masked out, its rows merged fresh);
    - kernel 1 on W4 folds of Q4_K wire blocks at the qkv, o, gate|up,
      down and lm_head widths (QWEN2_SHAPES: compact, legacy at K = 18944)
      at b = 1 and 8, and kernel 2's refusal of the FFN at E = 3584
      (ops/qmatmul.py::qmm_ffn gives None, as JAX's megakernel declines E %
      1024);
    - kernel 4's exact branch on a Q4_K qkv repack at m = 1 and 64.
    Each row against its plain version, timed beside its library call
    (SDPA; torch.matmul on the dequantized weight) and its bound.  tol as
    the kernels' other rows."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.synthetic import wire_blocks
    from llama_kotlin_tpu_torch.ops import qmatmul as qmatmul_mod
    from llama_kotlin_tpu_torch.ops.cuda import qmm, qmm_w4
    from llama_kotlin_tpu_torch.quant import fold, repack
    from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(780)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    report = functools.partial(report_row, results)
    head_group_flash_rows(torch, results, gen, flush, "qwen2 28/4", QWEN2_HEADS, 4097,
                          [(n_vis, nt, ("bf16", "int8", "int4"), True)
                           for n_vis in (1024, 4096, 1001) for nt in (1, 64)])

    rng = np.random.default_rng(78)

    def q4_k(n, k):  # the exact repack of random Q4_K wire blocks, on the card
        return repack.repack(torch.from_numpy(wire_blocks(rng, Q.Q4_K, n, k)).to(dev), Q.Q4_K,
                             n, k)

    w = {name: fold.fold_to_w4(q4_k(n, k)) for name, (n, k) in QWEN2_SHAPES.items()}
    for name, wt in w.items():
        n, k = wt.shape
        for b in (1, 8):
            x = torch.randn((b, k), generator=gen, device=dev) * 0.7
            xp = torch.nn.functional.pad(x, (0, wt.k_pad - k))  # the plain version's K
            got = qmm_w4.qmm_w4_matmul(x, wt)
            shape = f"qwen2 {wt.flavor} {name} n={n} k={k} b={b}"
            if qmm_w4.use_mma(b):
                repeats(torch, "qmm_w4", shape, got, lambda: qmm_w4.qmm_w4_matmul(x, wt))
            report("qmm_w4", shape, err_of(got, qmm_w4.qmm_w4_plain(xp, wt)), 1e-4,
                   time_ms(torch, lambda: qmm_w4.qmm_w4_matmul(x, wt), flush),
                   time_ms(torch, lambda: qmm_w4.qmm_w4_plain(xp, wt), flush),
                   b * k * 4 + nbytes(wt, w4_planes(wt)) + b * n * 4, 2 * b * n * k, "int8",
                   matmul_ms(torch, x, wt, flush))
    x = torch.randn((1, 3584), generator=gen, device=dev) * 0.7
    declined = qmatmul_mod.qmm_ffn(x, w["gate_up"], w["down"]) is None
    log(json.dumps({"phase": "qwen2_ffn_route", "E": 3584, "F": 18944,
                    "kernel_2_declines": declined}))
    if not declined:
        raise AssertionError("kernel 2 took Qwen2-7B's FFN, which JAX's megakernel declines")
    del w
    torch.cuda.empty_cache()

    n, k = QWEN2_SHAPES["qkv"]
    wt = q4_k(n, k)
    assert fold.is_exact(wt)
    for m in (1, 64):
        xb = (torch.randn((m, k), generator=gen, device=dev) * 0.7).to(torch.bfloat16)
        got = qmm.qmm(xb, wt)
        shape = f"qwen2 exact Q4_K qkv n={n} k={k} m={m}"
        repeats(torch, "qmm", shape, got, lambda: qmm.qmm(xb, wt))
        report("qmm", shape, err_of(got, qmm.qmm_plain(xb, wt)), 1e-3,
               time_ms(torch, lambda: qmm.qmm(xb, wt), flush),
               time_ms(torch, lambda: qmm.qmm_plain(xb, wt), flush),
               m * k * 2 + nbytes(wt, EXACT_PLANES) + m * n * 4, 2 * m * n * k, "bf16",
               matmul_ms(torch, xb, wt, flush))
    del wt, flush
    torch.cuda.empty_cache()


def write_qwen2_file(path: Path) -> dict:
    """qwen2_phase's file: Qwen2-7B (qwen2_7b(), its first EARLIER_LAYERS
    layers since Falcon-7B's phase came; all 28 before) from QWEN_SEED in
    Q4_K_M's mix (F32 q/k/v biases) with an SPM vocab of its 152064
    pieces."""
    from llama_kotlin_tpu_torch.models.synthetic import qwen2_7b, synthetic_spm_vocab

    cfg = qwen2_7b(n_layer=EARLIER_LAYERS)
    return _written(path, cfg, seed=QWEN_SEED, extra_kvs=synthetic_spm_vocab(cfg.vocab_size))


def write_qwen2moe_file(path: Path) -> dict:
    """qwen2moe_phase's file: Qwen1.5-MoE-A2.7B (qwen1_5_moe_a2_7b(), its
    first EARLIER_LAYERS layers) from QWEN_SEED + 1 in Q4_K_M's mix by
    tensor name (the 1408-wide expert downs on llama.cpp's Q5_0/Q8_0
    fallback)."""
    from llama_kotlin_tpu_torch.models.synthetic import qwen1_5_moe_a2_7b

    cfg, moe_shape = qwen1_5_moe_a2_7b(n_layer=EARLIER_LAYERS)
    return _written(path, cfg, seed=QWEN_SEED + 1, moe=moe_shape)


def route_counts(cfg, params, n_forward: int, n_decode: int, mode, decode_rows: int = 1,
                 prefill_rows: int = 64) -> dict:
    """The launches serve() must count on a loaded file whose layers attend
    on kernel 3 once each at every forward (n_forward forwards, n_decode of
    them decode steps of decode_rows rows, the rest prefills of
    prefill_rows), layer by layer, each matrix by the rule ops/qmatmul.py
    holds JAX's to:
    - the exact mode: every matrix and the head on kernel 4's exact branch
      at every forward ("qmm", "qmm_exact");
    - w4: at a decode step each W4 projection on kernel 1 and each W8 one
      (a Q6_K attn_v or ffn_down, the Q6_K head, tied or not) on kernel 5,
      but a matrix whose output rows no block of 128 divides on kernel 4
      (JAX's _plan declines it: Falcon-7B's fused qkv, o and down); a
      gated FFN that kernel 2 takes (ops/cuda/qmm_w4_ffn.py::ffn_eligible,
      held against JAX's entry by the CPU tests: the fused gate|up or gate
      and up apart, no bias, scale or sub-norm between the products) one
      kernel-2 launch in place of its matrices' (OpenELM-3B's all-legacy
      layers; JAX's entry declines E = 3584, gemma's widths and mixed
      flavors); at a prefill every layer matrix on kernel 4 and the head's
      one row on kernel 5;
    - experts: a list of per-expert folds (a fast mode, E <= 16: DBRX and
      Mixtral in w4) runs every expert's gate, up and down through those
      rules at every forward (the sweep); a stacked exact repack gathers
      the routed experts (no kernel) where a forward's slots (rows times
      experts a token) are at most 64 and fewer than the experts (JAX's
      rule), else sweeps every expert through kernel 4's exact branch.
    tests/test_torch_{gemma,qwen2,falcon,openelm_bitnet}.py hold these
    routes against JAX's at gemma-2-9b's, Qwen2-7B's, Falcon-7B's and
    OpenELM-3B's widths."""
    from llama_kotlin_tpu_torch.models.llama import _FFN_BETWEEN
    from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import MAX_ROWS
    from llama_kotlin_tpu_torch.ops.cuda.qmm_w4_ffn import ffn_eligible
    from llama_kotlin_tpu_torch.ops.qmatmul import ROW_BLOCK
    from llama_kotlin_tpu_torch.quant.fold import is_exact, is_w4, is_w8

    n_prefill = n_forward - n_decode
    got = {"qmm_w4": 0, "qmm_w8": 0, "qmm": 0, "qmm_exact": 0, "qmm_w4_ffn": 0}
    passes = ((decode_rows, n_decode), (prefill_rows, n_prefill))

    def add(w, rows: int, times: int) -> None:
        if is_exact(w):
            got["qmm"] += times
            got["qmm_exact"] += times
        elif not (is_w4(w) or is_w8(w)):
            raise AssertionError("a Q4_K_M file loads W4 and W8 folds or exact repacks only")
        elif rows <= MAX_ROWS and w.shape[0] % ROW_BLOCK == 0:
            got["qmm_w4" if is_w4(w) else "qmm_w8"] += times
        else:
            got["qmm"] += times

    for lp in params["layers"]:
        gu = lp.get("ffn_gateup_fused", lp.get("ffn_gate"))
        up = None if "ffn_gateup_fused" in lp else lp.get("ffn_up")
        k2 = (mode is not None and cfg.ffn_gated and gu is not None and decode_rows <= MAX_ROWS
              and not any(key in lp for key in _FFN_BETWEEN)
              and ffn_eligible(gu, lp["ffn_down"], cfg.act, up))
        got["qmm_w4_ffn"] += n_decode * k2
        for key, w in lp.items():
            experts = w if isinstance(w, list) else [w] if getattr(w, "is_stacked", False) \
                else None
            if experts is None and not hasattr(w, "codes"):
                continue  # norms, biases, the dense router
            for rows, times in passes:
                if experts is None:
                    if not (k2 and rows == decode_rows and times == n_decode
                            and key in ("ffn_gateup_fused", "ffn_gate", "ffn_up", "ffn_down")):
                        add(w, rows, times)
                elif isinstance(w, list):
                    for e in experts:
                        add(e, rows, times)
                elif not (rows * cfg.n_expert_used <= 64
                          and rows * cfg.n_expert_used < cfg.n_expert):
                    got["qmm"] += times * cfg.n_expert
                    got["qmm_exact"] += times * cfg.n_expert
    head = params.get("output") if params.get("output") is not None else params["tok_embd"]
    add(head, 1, n_forward)  # every forward's one output row
    want = {"flash": n_forward * cfg.n_layer}
    if mode is None:
        if got["qmm_w4"] or got["qmm_w8"] or got["qmm"] != got["qmm_exact"]:
            raise AssertionError("the exact mode loads exact repacks only")
        return dict(want, qmm=got["qmm"], qmm_exact=got["qmm_exact"])
    want.update({k: got[k] for k in ("qmm_w4", "qmm_w8", "qmm")})
    if got["qmm_w4_ffn"]:
        want["qmm_w4_ffn"] = got["qmm_w4_ffn"]
    return want


def family_phase(torch, tmpdir: Path, name: str, fname: str, engine: bool = False) -> dict:
    """A full-width family file from the writer child, loaded in the exact
    mode (the default) and in w4 (fuse=True); each serves 3 requests
    (64-token prompt, 32 greedy tokens) through LlamaContext and
    generate_loop by serve(), unrolled (Q4_K_M's Q6_K attn_v or ffn_down
    leaves the layers' layouts unequal), kernel 3 once a layer at every
    forward, kernel 2 and the plain attention never, every kernel's
    launches exactly route_counts' (a kernel it expects none of must not
    launch); then a profiled prefill and 4 profiled decode steps (TTFT,
    ms/token, device busy, idle share, launches a step); with engine=True
    the exact load also serves 4 concurrent requests on the engine
    (moe_engine).  Each load logs its layers' routes: the layers whose q|k|v
    and gate|up fuse and the fold flavor of each layer's down.  Returns
    {path: launch counts}."""
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.ops.cuda import (flash, flash_stacked, qmm, qmm_int8, qmm_w4,
                                                 qmm_w4_ffn, qmm_w4x, qmm_w8)
    from llama_kotlin_tpu_torch.tokenizer import build_tokenizer

    path, written = child_file(tmpdir, fname)
    log(json.dumps({"phase": f"{name}_file", **written, "type_mix": type_mix(path)}))
    out = {}
    for mode in (None, "w4"):
        label = f"{name}_{mode or 'exact'}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lcfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        tok = build_tokenizer(f.metadata) if engine and mode is None else None
        f.close()
        w_all, w_bytes = routed_bytes(lcfg, params)
        layers = params["layers"]
        log(json.dumps({"phase": label, "n_layer": lcfg.n_layer, "load_s": load_s,
                        "device_bytes": torch.cuda.memory_allocated(),
                        "heads": [lcfg.n_head, lcfg.n_head_kv], "n_expert": lcfg.n_expert,
                        "w_bytes_all": w_all, "w_bytes_per_tok": w_bytes,
                        "w_floor_ms_per_tok": w_bytes / HBM_BYTES_S * 1e3,
                        "qkv_fused_layers": [i for i, lp in enumerate(layers)
                                             if "wqkv_fused" in lp],
                        "gate_up_fused_layers": [i for i, lp in enumerate(layers)
                                                 if "ffn_gateup_fused" in lp],
                        "down_layouts": [getattr(lp["ffn_down"], "flavor", None) or "exact"
                                         for lp in layers if "ffn_down" in lp]}))
        # a prefill and 31 decode steps a request
        want = route_counts(lcfg, params, 3 * 32, 3 * 31, mode)
        if mode is None:  # every projection and the head on kernel 4's exact branch
            mods = (qmm, exact_counter(), flash)
            never = (qmm_w4, qmm_w4_ffn, qmm_w8, qmm_int8, qmm_w4x, flash_stacked)
        else:  # W4 on kernel 1 (or kernel 2's FFN), W8 (Q6_K attn_v, ffn_down, the head) on 5
            routed = (qmm_w4, qmm_w4_ffn, qmm_w8, qmm, flash)
            mods = tuple(m for m in routed if want.get(mod_name(m)))
            never = (qmm_int8, qmm_w4x, flash_stacked) + tuple(
                m for m in routed if m not in mods)
        plain = plain_attention_counters()
        try:
            counts, ctx = serve(torch, lcfg, params, mods, label, never=never + plain)
        finally:
            for c in plain:
                c.close()
        got = {k: counts.get(k, 0) for k in want}  # serve() held `never` at 0
        log(json.dumps({"phase": f"{label}_routes", "launches": got, "expected": want}))
        if "layers" not in ctx.params or got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        profile_decode(torch, ctx, lcfg, label, n_steps=4)
        out[label] = counts
        del ctx
        torch.cuda.empty_cache()
        if tok is not None:
            out.update(moe_engine(torch, lcfg, params, tok, name))
        del params
        torch.cuda.empty_cache()
    path.unlink()
    return out


def moe_engine(torch, cfg, params, tok, name: str) -> dict:
    """The engine (runtime/engine.py) serving 4 concurrent greedy requests
    (64-token prompts, 32 tokens) at 4 slots on a loaded MoE file: tokens/s,
    TTFT per request, decode and chunked steps, and the MoE route each
    forward took by its rows (ops/moe.py's gathered FFN or the sweep,
    models/llama.py::_moe_sweep).  A chunked decode step of the 4 slots
    is 4 rows (generate_loop does not pad them), 16 routed slots: not fewer
    than DBRX's 16 experts, so JAX's rule sweeps it where one slot's 4
    gather: the sweep must be seen at decode rows (2 to 8).  Every request
    ends at its 32 tokens."""
    import numpy as np

    from llama_kotlin_tpu_torch.models import llama
    from llama_kotlin_tpu_torch.ops import moe
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.runtime.engine import Engine, Request
    from llama_kotlin_tpu_torch.sampling.samplers import SamplingParams

    rows: dict = {}
    real = {"sweep": llama._moe_sweep, "gathered": moe.moe_gathered_quant}

    def sweep(lp, x, *a, **kw):
        key = f"sweep_rows_{x.shape[0]}"
        rows[key] = rows.get(key, 0) + 1
        return real["sweep"](lp, x, *a, **kw)

    def gathered(x, *a, **kw):
        key = f"gathered_rows_{x.shape[0]}"
        rows[key] = rows.get(key, 0) + 1
        return real["gathered"](x, *a, **kw)

    llama._moe_sweep, moe.moe_gathered_quant = sweep, gathered
    try:
        ctx = LlamaContext(cfg, params, n_cells=SERVE_CELLS, device="cuda")
        reqs = [Request(prompt_tokens=np.random.default_rng(50 + i).integers(
            259, cfg.vocab_size, 64).astype(np.int32), params=SamplingParams(temp=0.0),
            n_predict=32) for i in range(4)]
        eng = Engine(ctx, tok, n_slots=4, n_batch=256)
        dt = _drive(eng, reqs)
    finally:
        llama._moe_sweep, moe.moe_gathered_quant = real["sweep"], real["gathered"]
    n = sum(len(r.output_tokens) for r in reqs)
    line = {"phase": f"{name}_engine", "slots": 4, "requests": len(reqs), "wall_s": dt,
            "tokens": n, "tok_s": n / dt, "decode_steps": eng.metrics["n_decode_steps"],
            "chunked_steps": eng.n_chunked, "moe_routes_by_rows": rows,
            "ttft_ms": [(r.t_first_token - r.t_start) * 1e3 for r in reqs]}
    log(json.dumps(line))
    decode_sweeps = sum(c for k, c in rows.items()
                        if k.startswith("sweep_") and 2 <= int(k.rsplit("_", 1)[1]) <= 8)
    if n != 4 * 32 or not decode_sweeps:
        raise AssertionError(f"{name}_engine: {line}")
    del ctx
    return {f"{name}_engine": {"moe_decode_sweeps": decode_sweeps}}


def qwen2_phase(torch, tmpdir: Path) -> dict:
    """Qwen2-7B at its published widths, its first EARLIER_LAYERS layers
    of 28 (qwen2_7b(): E
    3584, 28 heads on 4 kv heads, F 18944, vocab 152064, qkv biases), random
    wire blocks from QWEN_SEED in Q4_K_M's mix, by family_phase: kernel 3
    at 7 query heads a group once a layer at every forward, kernel 2 never
    (legacy folds at E = 3584, as JAX)."""
    return family_phase(torch, tmpdir, "qwen2_7b", QWEN2_FILE)


def qwen2moe_phase(torch, tmpdir: Path) -> dict:
    """Qwen1.5-MoE-A2.7B at its published widths, its first EARLIER_LAYERS
    layers of 24 (qwen1_5_moe_a2_7b(): E 2048, 16/16 heads with qkv biases,
    60 routed experts of 1408, 4 used with raw weights, a sigmoid-gated
    shared expert of 5632, vocab 151936), random wire blocks from
    QWEN_SEED + 1 in Q4_K_M's mix by tensor name, by family_phase: the
    experts one stacked exact repack in both modes (60 > 16, JAX's
    policy), gathered at a decode step (no kernel) and swept through kernel
    4's exact branch at a prefill."""
    return family_phase(torch, tmpdir, "qwen1_5_moe", QWEN2MOE_FILE)


# the 2-layer files of qwen_parity_cases: {name: (config, MoEShape or None)}
def qwen_parity_files() -> dict:
    from llama_kotlin_tpu_torch.models.synthetic import qwen1_5_moe_a2_7b, qwen2_7b

    return {"qwen2-2layer.gguf": (qwen2_7b(n_layer=2), None),
            "qwen2moe-2layer.gguf": qwen1_5_moe_a2_7b(n_layer=2)}


def write_qwen_parity_file(path: Path) -> dict:
    cfg, moe_shape = qwen_parity_files()[path.name]
    return _written(path, cfg, seed=QWEN_SEED + 2, moe=moe_shape)


# of max|logits|, card against CPU: twice the CPU's own 8-thread-against-1
# spread on these files, rounded up (scripts/qwen_cpu_spread.py on the H100
# machine's host, PERF.md: Qwen2-7B exact 7.6e-3, w4 2.06e-2; Qwen1.5-MoE w4
# 1.17e-2).  The MoE file runs in w4 only: its experts are the same stacked
# exact repacks in both modes, and its CPU reference is the script's
# critical path
QWEN_PARITY_TOL = {("qwen2", None): 2e-2, ("qwen2", "w4"): 5e-2, ("qwen2moe", "w4"): 3e-2}


def qwen_parity_cases(tmpdir: Path) -> list:
    """(label, build, prompt, tol, moe) of qwen_parity_phase on the 2-layer
    Qwen2-7B and Qwen1.5-MoE-A2.7B files (full width; taken from the writer
    child or written into tmpdir), each in the modes QWEN_PARITY_TOL names,
    unrolled."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext

    cases = []
    for name, (cfg, moe_shape) in qwen_parity_files().items():
        path = tmpdir / name
        if not path.exists():
            child_file(tmpdir, name)
        prompt = np.random.default_rng(QWEN_SEED).integers(0, cfg.vocab_size, 64).astype(
            np.int32)
        label = name.split("-")[0]
        for (arch, mode), tol in QWEN_PARITY_TOL.items():
            if arch != label:
                continue

            def build(dev, mode=mode, path=path):
                lcfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True, device=dev)
                f.close()
                return LlamaContext(lcfg, params, n_cells=1024, buckets=(8, 16, 32, 64),
                                    device=dev)

            cases.append((f"{label}_parity_{mode or 'exact'}", build, prompt, tol,
                          moe_shape is not None))
    return cases


def qwen_parity_phase(torch, tmpdir: Path) -> None:
    """Full width, 2 layers, card against CPU (a 64-token prefill and 4
    greedy steps) on qwen_parity_cases: Qwen2-7B by card_vs_cpu, kernel 3
    once a layer and step and kernel 2 never on the card; Qwen1.5-MoE by
    moe_card_vs_cpu (the card on the CPU's routing)."""
    from llama_kotlin_tpu_torch.ops.cuda import flash, qmm_w4_ffn

    for label, build, prompt, tol, moe in qwen_parity_cases(tmpdir):
        if moe:
            moe_card_vs_cpu(torch, label, build, prompt, tol)
            continue
        cl = cpu_ref(label, lambda: greedy_logits(build, "cpu", prompt, 4))
        if REFS["writer"]:
            continue
        flash.LAUNCHES = qmm_w4_ffn.LAUNCHES = 0
        card_vs_cpu(torch, label, build, prompt, tol, cpu=(None, cl))
        got = {"flash": flash.LAUNCHES, "qmm_w4_ffn": qmm_w4_ffn.LAUNCHES}
        log(json.dumps({"phase": f"{label}_routes", "launches": got}))
        if got != {"flash": 2 * 5, "qmm_w4_ffn": 0}:
            raise AssertionError(f"{label}: launches {got}")
    for p in tmpdir.glob("qwen2*-2layer.gguf"):
        p.unlink()


# the architecture sweep: every other llama-shaped family member at 2
# layers and a narrow width (E 1024, 8 heads of 128 on 2 kv heads, F 2816,
# vocab 8192; phi3 8 heads of 96 on 8), and baichuan at 40 layers (its
# ALiBi rule is by depth: baichuan-13B); the arch's own keys as its
# published configs set them (phi3's window under the prompt, so it bites;
# stablelm's quarter rope; olmo's clamp_kqv 8; command-r's logit_scale
# 0.0625); and the learned-position and LayerNorm-gelu family at the same
# width with its published head grouping (gpt2, gptneox, mpt, bloom, jais
# MHA; starcoder and falcon-7b one kv head, falcon at head dim 64;
# falcon-40b two kv heads and attn_norm_2; phi2 16 heads of 80, 32 dims
# rotated; gptneox's quarter rope, nemotron's and chatglm's half rope)
SWEEP_ARCHES = {
    "qwen": {}, "stablelm": dict(rope_dim=32), "phi3": dict(n_embd=768, n_head_kv=8,
                                                           swa_window=32),
    "internlm2": {}, "minicpm": {}, "xverse": {}, "exaone": {}, "baichuan": {},
    "baichuan-13b": dict(n_layer=40), "starcoder2": {}, "refact": {}, "plamo": {},
    "orion": {}, "command-r": dict(logit_scale=0.0625), "olmo": dict(clamp_kqv=8.0),
    "codeshell": {}, "gpt2": dict(n_head_kv=8), "starcoder": dict(n_head_kv=1),
    "gptneox": dict(n_head_kv=8, rope_dim=32), "falcon": dict(n_head=16, n_head_kv=1),
    "falcon-40b": dict(n_head=16, n_head_kv=2), "mpt": dict(n_head_kv=8),
    "phi2": dict(n_embd=1280, n_head=16, n_head_kv=16, rope_dim=32),
    "bloom": dict(n_head_kv=8), "jais": dict(n_head_kv=8), "nemotron": dict(rope_dim=64),
    "chatglm": dict(rope_dim=64),
    "openelm": dict(head_dim=128, n_head_arr=(4, 8), n_head_kv_arr=(1, 2), n_ff_arr=(1024, 2816)),
    "bitnet": dict(n_embd=800, n_head_kv=8)}
# the large MoEs at the sweep's width: {label: (ModelConfig keys, MoEShape
# keys)}: dbrx's 16 experts (4 a token, clip 8, LayerNorm), grok's 8 (2 a
# token, softcap 30), arctic's 128 (2 a token) beside its dense FFN; the
# experts 1024 wide (arctic's 512), so that the CPU references stay short
SWEEP_MOE = {
    "dbrx": (dict(n_expert=16, n_expert_used=4, clamp_kqv=8.0, use_rms_norm=False,
                  rope_type=2), dict(expert_ff=1024)),
    "grok": (dict(n_expert=8, n_expert_used=2, rope_type=2), dict(expert_ff=1024)),
    "arctic": (dict(n_expert=128, n_expert_used=2), dict(expert_ff=512))}
SWEEP_SEED = 29
# of max|logits|, card against CPU in the exact mode: twice the largest
# 8-thread-against-1 CPU spread over the sweep's 2-layer files (6.5e-3; the
# learned-position and LayerNorm-gelu members' at most 4.9e-3), and over
# baichuan-13B's 40 layers (1.8e-2), rounded up (scripts/
# qwen_cpu_spread.py on the H100 machine's host; PERF.md); the MoE members
# moe_parity_phase's exact-mode bound, 3e-2
SWEEP_TOL = {2: 1.5e-2, 40: 4e-2}
SWEEP_MOE_TOL = 3e-2


def sweep_cases(tmpdir: Path) -> list:
    """(label, arch config, build, prompt, tol) of arch_sweep_phase: each
    SWEEP_ARCHES and SWEEP_MOE file (family_config's widths, or a MoE
    file's at the same widths, Q4_K_M's mix, written into tmpdir from
    SWEEP_SEED: the same bytes in every process), loaded in the exact mode
    with fuse=True, its context's default path."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.config import ModelConfig
    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.models.synthetic import MoEShape, family_config, synthetic_gguf
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext

    widths = dict(n_embd=1024, n_head=8, n_head_kv=2, n_ff=2816, vocab_size=8192)
    cases = []
    for i, label in enumerate(list(SWEEP_ARCHES) + list(SWEEP_MOE)):
        arch = label.removesuffix("-13b").removesuffix("-40b")
        moe_shape = None
        if label in SWEEP_MOE:
            keys, shape_keys = SWEEP_MOE[label]
            cfg = ModelConfig(arch=arch, name=f"sweep-{arch}", n_layer=2, n_ctx_train=4096,
                              **widths, **keys)
            moe_shape = MoEShape(**shape_keys)
        else:
            cfg = family_config(arch, **dict(widths, **SWEEP_ARCHES[label]))
        path = tmpdir / f"sweep-{label}.gguf"
        if not path.exists():
            synthetic_gguf(path, cfg, seed=SWEEP_SEED + i, moe=moe_shape)

        def build(dev, path=path):
            lcfg, params, f = load_gguf_model(path, fuse=True, device=dev)
            f.close()
            return LlamaContext(lcfg, params, n_cells=1024, buckets=(8, 16, 32, 64),
                                device=dev)

        prompt = np.random.default_rng(SWEEP_SEED + i).integers(
            0, cfg.vocab_size, 64).astype(np.int32)
        cases.append((f"sweep_{label}", cfg, build, prompt,
                      SWEEP_MOE_TOL if moe_shape else SWEEP_TOL[cfg.n_layer]))
    return cases


def arch_sweep_phase(torch, tmpdir: Path) -> dict:
    """Each sweep_cases file, card against CPU by card_vs_cpu (a 64-token
    prefill and 4 greedy steps, exact mode, its SWEEP_TOL; a MoE member by
    moe_card_vs_cpu, on the CPU's routing).  On the card run
    kernel 3 attends once a layer at every forward, or, where JAX's
    predicate declines its flash kernel (ALiBi: refact, baichuan-13B, mpt,
    bloom, jais; head dims 96, 80 and 100: phi3, phi2, bitnet;
    ops/attention.py::flash_declines), never: the plain
    route (cache_attention_reference) attends there instead.  Returns
    {path: launch counts}."""
    from llama_kotlin_tpu_torch.models import llama
    from llama_kotlin_tpu_torch.ops import attention
    from llama_kotlin_tpu_torch.ops.cuda import flash, flash_stacked, qmm

    out = {}
    for label, cfg, build, prompt, tol in sweep_cases(tmpdir):
        if cfg.n_expert:
            if REFS["writer"]:
                moe_card_vs_cpu(torch, label, build, prompt, tol)
                continue
        else:
            cl = cpu_ref(label, lambda: greedy_logits(build, "cpu", prompt, 4))
            if REFS["writer"]:
                continue
        plain = CallCounter(llama, "cache_attention_reference")
        flash.LAUNCHES = flash_stacked.LAUNCHES = qmm.LAUNCHES = 0
        try:
            if cfg.n_expert:
                moe_card_vs_cpu(torch, label, build, prompt, tol)
            else:
                card_vs_cpu(torch, label, build, prompt, tol, cpu=(None, cl))
        finally:
            plain.close()
        got = {"flash": flash.LAUNCHES, "flash_stacked": flash_stacked.LAUNCHES,
               "qmm": qmm.LAUNCHES, "cache_attention_reference": plain.LAUNCHES}
        declines = attention.flash_declines(cfg.head_dim, cfg.v_head_dim, cfg.max_alibi_bias)
        attended = cfg.n_layer * 5
        want = {"flash": 0 if declines else attended,
                "cache_attention_reference": attended if declines else 0}
        log(json.dumps({"phase": f"{label}_routes", "arch": cfg.arch, "declines": declines,
                        "launches": got, "expected": want}))
        if {k: got[k] for k in want} != want or got["flash_stacked"] or not got["qmm"]:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        out[label] = {k: v for k, v in got.items() if k != "cache_attention_reference"}
    for p in tmpdir.glob("sweep-*.gguf"):
        p.unlink()
    return out


# the learned-position and LayerNorm-gelu family (gpt2, starcoder, gptneox,
# falcon, mpt, phi2, bloom, jais, nemotron, chatglm): Falcon-7B at full
# width and depth, StarCoder-15.5B at full width
GPT_SEED = 31
FALCON_FILE = "falcon-7b-q4_k_m.gguf"
STARCODER_FILE = "starcoder-15.5b-q4_k_m.gguf"
FALCON_HEADS = (71, 1, 64)  # Falcon-7B's query heads, kv heads and head dim
STARCODER_HEADS = (48, 1, 128)
# Falcon-7B's matrices as its Q4_K_M file carries them: K = 4544 is no
# multiple of 256, so every matrix that reads E takes llama.cpp's fallback
# (Q4_K -> Q5_0, Q6_K -> Q8_0); the down projections (K = 18176) keep
# Q4_K and Q6_K.  {name: (type, n, k)}
FALCON_SHAPES = {"qkv": ("Q5_0", 4672, 4544), "o": ("Q5_0", 4544, 4544),
                 "up": ("Q5_0", 18176, 4544), "down": ("Q4_K", 4544, 18176),
                 "down_q6_K": ("Q6_K", 4544, 18176), "lm_head": ("Q8_0", 65024, 4544)}
# StarCoder-15.5B's Q4_K matrices (compact W4 folds in w4) and its tied Q6_K
# head (a W8 fold)
STARCODER_SHAPES = {"qkv": (6400, 6144), "o": (6144, 6144), "up": (24576, 6144),
                    "down": (6144, 24576)}


def gpt_kernel_phase(torch, results: dict) -> None:
    """The kernels at Falcon-7B's and StarCoder-15.5B's shapes:
    - kernel 3 at Falcon-7B's 71 query heads on one kv head (head dim 64:
      a decode token's 71 rows fill one 64-row block and 7 rows of a second,
      csrc/flash_mma.cuh's tok0/ntok) on the three caches, decode and a
      64-token chunk (row 5 blind) over 1001, 1024 and 2048 (its context)
      cells, and at StarCoder's 48 on one (head dim 128) over 1024 cells on
      the three caches and 4096 on bf16; kernel 9 at both on the bf16 and
      int8 caches over 1024 cells;
    - kernel 4 at Falcon-7B's qkv, o and down (FALCON_SHAPES), m = 1 and 64:
      the exact branch on each repack (the exact mode's route), and the W8
      (Q5_0, Q6_K) and W4 (Q4_K down) folds of the same blocks (the w4
      mode's route: no block of 128 divides 4672 or 4544, so kernel 4 takes
      them at decode too, JAX's _plan declining; ops/qmatmul.py::_decode
      must say so); the exact Q8_0 lm_head at m = 1;
    - kernel 5 at Falcon-7B's up (Q5_0, 18176 rows) and lm_head (Q8_0, 65024
      rows) W8 folds, b = 1 and 8, and StarCoder's tied Q6_K head at b = 1;
    - kernel 1 at StarCoder's compact Q4_K folds (STARCODER_SHAPES), b = 1
      and 8 (above T1 repeated bit-equal).
    Each row against its plain version, timed beside its library call
    (SDPA; torch.matmul on the dequantized weight) and its bound."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.synthetic import wire_blocks
    from llama_kotlin_tpu_torch.ops import qmatmul as qmatmul_mod
    from llama_kotlin_tpu_torch.ops.cuda import qmm, qmm_w4, qmm_w8
    from llama_kotlin_tpu_torch.quant import fold, repack
    from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(910)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    report = functools.partial(report_row, results)
    every = ("bf16", "int8", "int4")
    head_group_flash_rows(
        torch, results, gen, flush, "falcon 71/1", FALCON_HEADS, 2049,
        [(n_vis, nt, every, n_vis == 1024) for n_vis in (1024, 2048, 1001) for nt in (1, 64)])
    head_group_flash_rows(
        torch, results, gen, flush, "starcoder 48/1", STARCODER_HEADS, 4097,
        [(1024, nt, every, True) for nt in (1, 64)]
        + [(4096, nt, ("bf16",), False) for nt in (1, 64)])

    rng = np.random.default_rng(91)

    def exact(name, n, k):  # the exact repack of random wire blocks, on the card
        qtype = Q[name]
        return repack.repack(torch.from_numpy(wire_blocks(rng, qtype, n, k)).to(dev), qtype,
                             n, k)

    def k4_row(shape, xb, wt, planes):
        m, k = xb.shape
        n = wt.shape[0]
        got = qmm.qmm(xb, wt)
        repeats(torch, "qmm", shape, got, lambda: qmm.qmm(xb, wt))
        report("qmm", shape, err_of(got, qmm.qmm_plain(xb, wt)), 1e-3,
               time_ms(torch, lambda: qmm.qmm(xb, wt), flush),
               time_ms(torch, lambda: qmm.qmm_plain(xb, wt), flush),
               m * k * 2 + nbytes(wt, planes) + m * n * 4, 2 * m * n * k, "bf16",
               matmul_ms(torch, xb, wt, flush))

    for name in ("qkv", "o", "down", "down_q6_K"):
        qname, n, k = FALCON_SHAPES[name]
        wt = exact(qname, n, k)
        folded = fold.fold_to_w4(wt) if qname == "Q4_K" else fold.fold_to_w8(wt)
        assert fold.is_exact(wt) and folded.flavor in ("compact", "w8")
        for m in (1, 64):
            xb = (torch.randn((m, k), generator=gen, device=dev) * 0.7).to(torch.bfloat16)
            k4_row(f"falcon exact {qname} {name} n={n} k={k} m={m}", xb, wt, EXACT_PLANES)
            if m == 1 and qmatmul_mod._decode(xb, folded):
                raise AssertionError(f"Falcon-7B's {name} ({n} rows) would take a decode "
                                     "kernel, where JAX's _plan declines it")
            k4_row(f"falcon {folded.flavor} {qname} {name} n={n} k={k} m={m}", xb, folded,
                   w4_planes(folded))
        del wt, folded
    qname, n, k = FALCON_SHAPES["lm_head"]
    wt = exact(qname, n, k)
    xb = (torch.randn((1, k), generator=gen, device=dev) * 0.7).to(torch.bfloat16)
    k4_row(f"falcon exact {qname} lm_head n={n} k={k} m=1", xb, wt, EXACT_PLANES)
    torch.cuda.empty_cache()

    def k5_rows(tag, name, wt, rows):
        n, k = wt.shape
        for b in rows:
            x = torch.randn((b, k), generator=gen, device=dev) * 0.7
            xp = torch.nn.functional.pad(x, (0, wt.k_pad - k))  # the plain version's K
            if not qmatmul_mod._decode(x, wt):
                raise AssertionError(f"{tag} {name} ({n} rows) did not plan on kernel 5")
            got = qmm_w8.qmm_w8_matmul(x, wt)
            shape = f"{tag} w8 {name} n={n} k={k} b={b} group={wt.group_size}"
            if qmm_w8.use_mma(b):
                repeats(torch, "qmm_w8", shape, got, lambda: qmm_w8.qmm_w8_matmul(x, wt))
            report("qmm_w8", shape, err_of(got, qmm_w8.qmm_w8_plain(xp, wt)), 1e-4,
                   time_ms(torch, lambda: qmm_w8.qmm_w8_matmul(x, wt), flush),
                   time_ms(torch, lambda: qmm_w8.qmm_w8_plain(xp, wt), flush),
                   b * k * 4 + nbytes(wt) + b * n * 4, 2 * b * n * k, "int8",
                   matmul_ms(torch, x, wt, flush))

    k5_rows("falcon", "lm_head", fold.fold_to_w8(wt), (1, 8))
    del wt
    qname, n, k = FALCON_SHAPES["up"]
    k5_rows("falcon", "up", fold.fold_to_w8(exact(qname, n, k)), (1, 8))
    E, V = 6144, 49152
    k5_rows("starcoder", "lm_head", fold.fold_to_w8(exact("Q6_K", V, E)), (1,))
    torch.cuda.empty_cache()

    for name, (n, k) in STARCODER_SHAPES.items():
        wt = fold.fold_to_w4(exact("Q4_K", n, k))
        assert wt.flavor == "compact"
        for b in (1, 8):
            x = torch.randn((b, k), generator=gen, device=dev) * 0.7
            xp = torch.nn.functional.pad(x, (0, wt.k_pad - k))
            got = qmm_w4.qmm_w4_matmul(x, wt)
            shape = f"starcoder {wt.flavor} {name} n={n} k={k} b={b}"
            if qmm_w4.use_mma(b):
                repeats(torch, "qmm_w4", shape, got, lambda: qmm_w4.qmm_w4_matmul(x, wt))
            report("qmm_w4", shape, err_of(got, qmm_w4.qmm_w4_plain(xp, wt)), 1e-4,
                   time_ms(torch, lambda: qmm_w4.qmm_w4_matmul(x, wt), flush),
                   time_ms(torch, lambda: qmm_w4.qmm_w4_plain(xp, wt), flush),
                   b * k * 4 + nbytes(wt, w4_planes(wt)) + b * n * 4, 2 * b * n * k, "int8",
                   matmul_ms(torch, x, wt, flush))
        del wt
    del flush
    torch.cuda.empty_cache()


def write_falcon_file(path: Path) -> dict:
    """falcon_phase's file: Falcon-7B (falcon_7b(), its first
    EARLIER_LAYERS layers since DBRX's and OpenELM-3B's phases came; all 32
    before) from GPT_SEED in Q4_K_M's mix (llama.cpp's Q5_0 / Q8_0 fallback
    at K = 4544; Q4_K and Q6_K downs, use_more_bits)."""
    from llama_kotlin_tpu_torch.models.synthetic import falcon_7b

    return _written(path, falcon_7b(n_layer=EARLIER_LAYERS), seed=GPT_SEED)


def write_starcoder_file(path: Path) -> dict:
    """starcoder_phase's file: StarCoder-15.5B (starcoder_15b(), its first
    EARLIER_LAYERS layers) from GPT_SEED + 1 in Q4_K_M's mix, its 8192-row
    position table F32, its tied head Q6_K."""
    from llama_kotlin_tpu_torch.models.synthetic import starcoder_15b

    return _written(path, starcoder_15b(n_layer=EARLIER_LAYERS), seed=GPT_SEED + 1)


def falcon_phase(torch, tmpdir: Path) -> dict:
    """Falcon-7B at its published widths, its first EARLIER_LAYERS layers
    of 32 (falcon_7b(): E 4544, 71 heads on one kv head, F 18176, vocab
    65024, the parallel block), by family_phase: kernel 3 at 71 query heads a group once a
    layer at every forward; in w4 kernel 4 takes the fused qkv, o and down
    at decode (rows no 128 divides, as JAX's _plan declines), kernel 5 up
    and the lm_head, kernel 1 and kernel 2 never."""
    return family_phase(torch, tmpdir, "falcon_7b", FALCON_FILE)


def starcoder_phase(torch, tmpdir: Path) -> dict:
    """StarCoder-15.5B at its published widths, its first EARLIER_LAYERS
    layers of 40 (starcoder_15b(): E 6144, 48 heads on one kv head, F
    24576, vocab 49152, learned positions, biases, a tied Q6_K head), by
    family_phase: kernel 3 at head dim 128, 48 rows a token; in w4 kernel
    1 on the compact Q4_K folds, kernel 5 on the Q6_K downs and head."""
    return family_phase(torch, tmpdir, "starcoder_15b", STARCODER_FILE)


# the 2-layer files of gpt_parity_cases: {name: config}
def gpt_parity_files() -> dict:
    from llama_kotlin_tpu_torch.models.synthetic import falcon_7b, starcoder_15b

    return {"falcon-2layer.gguf": falcon_7b(n_layer=2),
            "starcoder-2layer.gguf": starcoder_15b(n_layer=2)}


def write_gpt_parity_file(path: Path) -> dict:
    return _written(path, gpt_parity_files()[path.name], seed=GPT_SEED + 2)


# of max|logits|, card against CPU: twice the CPU's own 8-thread-against-1
# spread on these files, rounded up (scripts/qwen_cpu_spread.py --only gpt
# on the H100 machine's host, PERF.md: Falcon-7B exact 2.9e-3, w4 6.2e-3;
# StarCoder w4 1.6e-2).  StarCoder in w4 only (its exact route is kernel
# 4's exact branch at widths the sweep and the kernel rows hold), so that
# the CPU reference process stays off the critical path
GPT_PARITY_TOL = {("falcon", None): 6e-3, ("falcon", "w4"): 1.5e-2, ("starcoder", "w4"): 4e-2}


def gpt_parity_cases(tmpdir: Path) -> list:
    """(label, build, prompt, tol) of gpt_parity_phase on the 2-layer
    Falcon-7B and StarCoder-15.5B files (full width; from the writer child
    or written into tmpdir), each in the modes GPT_PARITY_TOL names,
    unrolled."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext

    cases = []
    for name, cfg in gpt_parity_files().items():
        path = tmpdir / name
        if not path.exists():
            child_file(tmpdir, name)
        prompt = np.random.default_rng(GPT_SEED).integers(0, cfg.vocab_size, 64).astype(
            np.int32)
        label = name.split("-")[0]
        for (arch, mode), tol in GPT_PARITY_TOL.items():
            if arch != label:
                continue

            def build(dev, mode=mode, path=path):
                lcfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True, device=dev)
                f.close()
                return LlamaContext(lcfg, params, n_cells=1024, buckets=(8, 16, 32, 64),
                                    device=dev)

            cases.append((f"{label}_parity_{mode or 'exact'}", build, prompt, tol))
    return cases


def gpt_parity_phase(torch, tmpdir: Path) -> None:
    """Full width, 2 layers, card against CPU (a 64-token prefill and 4
    greedy steps) on gpt_parity_cases by card_vs_cpu, kernel 3 once a layer
    and step on the card (71 and 48 query heads on one kv head), kernel 1
    and 2 never on Falcon-7B (no W4 matrix of it plans on kernel 1)."""
    from llama_kotlin_tpu_torch.ops.cuda import flash, qmm_w4, qmm_w4_ffn

    for label, build, prompt, tol in gpt_parity_cases(tmpdir):
        cl = cpu_ref(label, lambda: greedy_logits(build, "cpu", prompt, 4))
        if REFS["writer"]:
            continue
        flash.LAUNCHES = qmm_w4_ffn.LAUNCHES = qmm_w4.LAUNCHES = 0
        card_vs_cpu(torch, label, build, prompt, tol, cpu=(None, cl))
        got = {"flash": flash.LAUNCHES, "qmm_w4_ffn": qmm_w4_ffn.LAUNCHES,
               "qmm_w4": qmm_w4.LAUNCHES}
        want = {"flash": 2 * 5, "qmm_w4_ffn": 0}
        if label.startswith("falcon"):
            want["qmm_w4"] = 0
        log(json.dumps({"phase": f"{label}_routes", "launches": got, "expected": want}))
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
    for name in gpt_parity_files():
        (tmpdir / name).unlink(missing_ok=True)


# the large MoEs and the per-layer architectures (dbrx, arctic, grok,
# openelm, bitnet): DBRX at full width, OpenELM-3B at full width and depth
LARGE_SEED = 37
DBRX_LAYERS = 4  # DBRX's served depth; its card-vs-CPU check takes the first 2
OPENELM_FILE = "openelm-3b-q4_k_m.gguf"
DBRX_HEADS = (48, 8, 128)  # DBRX's (and Grok-1's) query heads, kv heads (6 a group), head dim
# the routed experts' matrices [n, k] at their published widths: DBRX
# (d_model 6144, ffn_hidden_size 10752), Grok-1 (6144, 32768), Arctic
# (7168, 4864); gate and up share a shape
EXPERT_SHAPES = {"dbrx gate": (10752, 6144), "dbrx down": (6144, 10752),
                 "grok-1 gate": (32768, 6144), "grok-1 down": (6144, 32768),
                 "arctic gate": (4864, 7168), "arctic down": (7168, 4864)}
# DBRX's attention and experts as its w4 load folds them (Q4_K: K = 6144
# compact, K = 10752 legacy), and OpenELM-3B's widest layer's q and o (K =
# 3072 legacy) and the FFN of its layers 5 and 25, which kernel 2 takes (E
# 3072, F 3072 and 9216, every fold legacy, gate and up apart)
DBRX_W4_SHAPES = {"qkv": (8192, 6144), "o": (6144, 6144), "expert gate": (10752, 6144),
                  "expert down": (6144, 10752)}
OPENELM_W4_SHAPES = {"q": (3072, 3072), "o": (3072, 3072)}
OPENELM_FFN_WIDTHS = (3072, 9216)


def large_moe_kernel_phase(torch, results: dict) -> None:
    """The kernels at DBRX's, Grok-1's, Arctic's and OpenELM-3B's shapes:
    - kernel 3 at 48 query heads on 8 kv heads (6 a group: a token's rows
      straddle the 64-row tile's edges), head dim 128, without and with
      grok's softcap 30, on the three caches, decode and a 64-token chunk
      (row 5 blind: exactly 0) over 1024, 4096 and a ragged 1001 visible
      cells;
    - kernel 3 on OpenELM-3B's per-layer views: 12 query heads on the
      first 3 kv heads and 24 on all 6 of a cache sized at 6, a 3-D view of
      the layer (models/llama.py::_layer_cache), decode and 64 rows over
      1024 cells, the three caches;
    - kernel 4's exact branch on Q4_K repacks of the routed experts' gate
      (up is the same shape) and down at DBRX's widths (m = 1 and 64: a
      decode step on the sweep and a prefill) and Grok-1's and Arctic's (m
      = 64), repeated bit-equal;
    - kernel 1 on the W4 folds of DBRX's qkv, o and experts (b = 1 and 4:
      one slot, and four on the sweep) and OpenELM-3B's q and o (b = 1);
      kernel 2 (gate and up apart, up=) at OpenELM-3B's layers 5 and 25 (b
      = 1), beside the unfused route.
    Each row against its plain version, timed beside its library call
    (SDPA without the softcap; torch.matmul on the dequantized weight;
    kernel 2: the unfused route) and its bound."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.synthetic import wire_blocks
    from llama_kotlin_tpu_torch.ops import qmatmul as qmatmul_mod
    from llama_kotlin_tpu_torch.ops.cuda import qmm, qmm_w4, qmm_w4_ffn
    from llama_kotlin_tpu_torch.quant import fold, repack
    from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1210)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    report = functools.partial(report_row, results)
    every = ("bf16", "int8", "int4")
    cases = [(n_vis, nt, every, False) for n_vis in (1024, 4096, 1001) for nt in (1, 64)]
    head_group_flash_rows(torch, results, gen, flush, "dbrx 48/8", DBRX_HEADS, 4097, cases)
    head_group_flash_rows(torch, results, gen, flush, "grok 48/8 softcap 30", DBRX_HEADS, 4097,
                          cases, softcap=30.0)
    for heads in ((12, 3, 128), (24, 6, 128)):
        head_group_flash_rows(torch, results, gen, flush,
                              f"openelm {heads[0]}/{heads[1]} view of 6", heads, 1025,
                              [(1024, nt, every, False) for nt in (1, 64)], view=6)

    rng = np.random.default_rng(121)

    def q4_k(n, k):  # the exact repack of random Q4_K wire blocks, on the card
        return repack.repack(torch.from_numpy(wire_blocks(rng, Q.Q4_K, n, k)).to(dev), Q.Q4_K,
                             n, k)

    for name, (n, k) in EXPERT_SHAPES.items():
        wt = q4_k(n, k)
        for m in ((1, 64) if name.startswith("dbrx") else (64,)):
            xb = (torch.randn((m, k), generator=gen, device=dev) * 0.7).to(torch.bfloat16)
            got = qmm.qmm(xb, wt)
            shape = f"exact Q4_K {name} n={n} k={k} m={m}"
            repeats(torch, "qmm", shape, got, lambda: qmm.qmm(xb, wt))
            report("qmm", shape, err_of(got, qmm.qmm_plain(xb, wt)), 1e-3,
                   time_ms(torch, lambda: qmm.qmm(xb, wt), flush),
                   time_ms(torch, lambda: qmm.qmm_plain(xb, wt), flush),
                   m * k * 2 + nbytes(wt, EXACT_PLANES) + m * n * 4, 2 * m * n * k, "bf16",
                   matmul_ms(torch, xb, wt, flush))
        del wt
        torch.cuda.empty_cache()

    for tag, shapes, rows in (("dbrx", DBRX_W4_SHAPES, (1, 4)),
                              ("openelm", OPENELM_W4_SHAPES, (1,))):
        for name, (n, k) in shapes.items():
            wt = fold.fold_to_w4(q4_k(n, k))
            for b in rows:
                x = torch.randn((b, k), generator=gen, device=dev) * 0.7
                xp = torch.nn.functional.pad(x, (0, wt.k_pad - k))  # the plain version's K
                if not qmatmul_mod._decode(x, wt):
                    raise AssertionError(f"{tag} {name} ({n} rows) did not plan on kernel 1")
                got = qmm_w4.qmm_w4_matmul(x, wt)
                shape = f"{tag} {wt.flavor} {name} n={n} k={k} b={b}"
                if qmm_w4.use_mma(b):
                    repeats(torch, "qmm_w4", shape, got, lambda: qmm_w4.qmm_w4_matmul(x, wt))
                report("qmm_w4", shape, err_of(got, qmm_w4.qmm_w4_plain(xp, wt)), 1e-4,
                       time_ms(torch, lambda: qmm_w4.qmm_w4_matmul(x, wt), flush),
                       time_ms(torch, lambda: qmm_w4.qmm_w4_plain(xp, wt), flush),
                       b * k * 4 + nbytes(wt, w4_planes(wt)) + b * n * 4, 2 * b * n * k,
                       "int8", matmul_ms(torch, x, wt, flush))
            del wt
    E = 3072
    for F in OPENELM_FFN_WIDTHS:
        gate, up, dn = (fold.fold_to_w4(q4_k(*shape)) for shape in ((F, E), (F, E), (E, F)))
        if not qmm_w4_ffn.ffn_eligible(gate, dn, "silu", up):
            raise AssertionError(f"kernel 2 declines OpenELM-3B's FFN at F = {F}")
        x = torch.randn((1, E), generator=gen, device=dev) * 0.7
        got = qmm_w4_ffn.qmm_w4_ffn_matmul(x, gate, dn, up=up)
        ffn_row(torch, results, f"up= openelm {gate.flavor} E={E} F={F} b=1", got, x, gate, dn,
                up, flush)
        del gate, up, dn
    del flush
    torch.cuda.empty_cache()


def write_dbrx_file(path: Path) -> dict:
    """dbrx_phase's file, whose first 2 layers large_moe_parity_phase also
    reads: DBRX (dbrx_base(), its first DBRX_LAYERS layers of 40) from
    LARGE_SEED in Q4_K_M's mix by tensor name (a Q4_K fused qkv, Q4_K
    experts with Q6_K downs on use_more_bits layers, a Q6_K head) with an
    SPM vocab of its 100352 pieces (the engine run's tokenizer)."""
    from llama_kotlin_tpu_torch.models.synthetic import dbrx_base, synthetic_spm_vocab

    cfg, moe_shape = dbrx_base(n_layer=DBRX_LAYERS)
    return _written(path, cfg, seed=LARGE_SEED, moe=moe_shape,
                    extra_kvs=synthetic_spm_vocab(cfg.vocab_size))


def write_openelm_file(path: Path) -> dict:
    """openelm_phase's file: OpenELM-3B (openelm_3b(), all 36 layers) from
    LARGE_SEED + 1 in Q4_K_M's mix, its head the tied Q6_K token_embd."""
    from llama_kotlin_tpu_torch.models.synthetic import openelm_3b

    return _written(path, openelm_3b(), seed=LARGE_SEED + 1)


def dbrx_phase(torch, tmpdir: Path) -> dict:
    """DBRX at its published widths, its first DBRX_LAYERS layers of 40
    (dbrx_base(): d_model 6144, 48 heads on 8 kv heads, a fused q|k|v
    clipped at 8, biasless LayerNorms, 16 experts of 10752, 4 a token,
    vocab 100352), by family_phase: kernel 3 at 6 query heads a group once
    a layer at every forward; in the exact mode the experts are one stacked
    exact repack, gathered at a decode step (4 routed slots, fewer than 16:
    no kernel) and swept through kernel 4's exact branch at a prefill; in
    w4 (16 experts: a list of per-expert W4 folds) the sweep at every
    forward, kernel 1 (Q4_K) and kernel 5 (Q6_K downs) at a decode step;
    the exact load also serves 4 requests on the engine at 4 slots, whose
    decode steps sweep (moe_engine)."""
    return family_phase(torch, tmpdir, "dbrx", DBRX_FILE, engine=True)


def openelm_phase(torch, tmpdir: Path) -> dict:
    """OpenELM-3B at its published widths and all 36 layers (openelm_3b():
    model_dim 3072, 12 to 24 query heads on 3 to 6 kv heads of 128, FFN
    1536 to 12288, a tied Q6_K head), by family_phase: every layer attends
    on kernel 3 over its view of its first kv heads; q|k|v fuse only on
    the 24/6 layers and gate|up only on the widest FFN; in w4 kernel 1
    takes the projections (legacy at K = 3072, compact o at 12 and 16
    heads) and kernel 2 the FFNs of layers 5 and 25 (all legacy, F a
    multiple of 1024), layer by layer as route_counts predicts."""
    return family_phase(torch, tmpdir, "openelm_3b", OPENELM_FILE)


# the files of large_moe_parity_cases: {name: (config, MoEShape or None)}:
# DBRX's (its first 2 layers served: a file of its own would add 4.5 GB to
# the script's writes), and a 2-layer file of OpenELM-3B's first and last
# layers' shapes
def large_moe_parity_files() -> dict:
    from llama_kotlin_tpu_torch.models.synthetic import dbrx_base, openelm_3b

    o = openelm_3b()
    pick = lambda a: (a[0], a[-1])  # noqa: E731
    return {DBRX_FILE: dbrx_base(n_layer=2),
            "openelm-2layer.gguf": (replace(o, n_layer=2, n_head_arr=pick(o.n_head_arr),
                                            n_head_kv_arr=pick(o.n_head_kv_arr),
                                            n_ff_arr=pick(o.n_ff_arr)), None)}


def write_openelm_parity_file(path: Path) -> dict:
    cfg, moe_shape = large_moe_parity_files()[path.name]
    return _written(path, cfg, seed=LARGE_SEED + 2, moe=moe_shape)


# of max|logits|, card against CPU: DBRX by moe_parity_phase's bounds
# (exact 3e-2: the W4A8 model's CPU thread spread with room; w4 5e-2, a w4
# GGUF file's), OpenELM by Qwen2-7B's (QWEN_PARITY_TOL); each at least
# twice the CPU's own 8-against-1-thread spread on these files
# (scripts/qwen_cpu_spread.py --only large on the H100 machine's host,
# PERF.md)
LARGE_PARITY_TOL = {("dbrx", None): 3e-2, ("dbrx", "w4"): 5e-2, ("openelm", None): 2e-2,
                    ("openelm", "w4"): 5e-2}


def large_moe_parity_cases(tmpdir: Path) -> list:
    """(label, build, prompt, tol, moe) of large_moe_parity_phase on DBRX's
    first 2 layers and the 2-layer OpenELM file (full width; from the
    writer child or written into tmpdir), in the exact mode and w4,
    unrolled."""
    import numpy as np

    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext

    cases = []
    for name, (cfg, moe_shape) in large_moe_parity_files().items():
        path = tmpdir / name
        if not path.exists():
            child_file(tmpdir, name)
        prompt = np.random.default_rng(LARGE_SEED).integers(0, cfg.vocab_size, 64).astype(
            np.int32)
        label = name.split("-")[0]
        for (arch, mode), tol in LARGE_PARITY_TOL.items():
            if arch != label:
                continue

            def build(dev, mode=mode, path=path, n_layer=cfg.n_layer):
                lcfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True, device=dev)
                f.close()
                lcfg = replace(lcfg, n_layer=n_layer)  # the file's first n_layer layers
                params["layers"] = params["layers"][:n_layer]
                return LlamaContext(lcfg, params, n_cells=1024, buckets=(8, 16, 32, 64),
                                    device=dev)

            cases.append((f"{label}_parity_{mode or 'exact'}", build, prompt, tol,
                          moe_shape is not None))
    return cases


def large_moe_parity_phase(torch, tmpdir: Path) -> None:
    """Full width, 2 layers, card against CPU (a 64-token prefill and 4
    greedy steps) on large_moe_parity_cases: DBRX by moe_card_vs_cpu (the
    card on the CPU's routing: top 4 of 16 has more near-ties than top 2);
    the OpenELM file by card_vs_cpu, kernel 3 once a layer and step on the
    card, each layer over its own view."""
    from llama_kotlin_tpu_torch.ops.cuda import flash

    for label, build, prompt, tol, moe in large_moe_parity_cases(tmpdir):
        if moe:
            moe_card_vs_cpu(torch, label, build, prompt, tol)
            continue
        cl = cpu_ref(label, lambda: greedy_logits(build, "cpu", prompt, 4))
        if REFS["writer"]:
            continue
        flash.LAUNCHES = 0
        card_vs_cpu(torch, label, build, prompt, tol, cpu=(None, cl))
        log(json.dumps({"phase": f"{label}_routes", "launches": {"flash": flash.LAUNCHES}}))
        if flash.LAUNCHES != 2 * 5:
            raise AssertionError(f"{label}: kernel 3 launched {flash.LAUNCHES} times")
    for name in large_moe_parity_files():
        (tmpdir / name).unlink(missing_ok=True)


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
    if sys.argv[1:2] == ["--cpu-refs"]:
        return cpu_refs_main(torch, *sys.argv[2:5])
    if sys.argv[1:2] == ["--write-files"]:
        return write_files_main(sys.argv[2])
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
    files_tmp = Path(tempfile.mkdtemp(prefix="lk_files_"))
    start_file_writer(files_tmp)
    ref_tmp = Path(tempfile.mkdtemp(prefix="lk_cpu_refs_"))
    start_cpu_refs(ref_tmp, files_tmp)
    ok = False
    try:
        t0 = time.perf_counter()
        so = _build.build()
        _build.lib()
        ptxas = [ln.strip() for ln in (_build.BUILD_DIR / "ptxas.log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln or "entry function" in ln] \
            if (_build.BUILD_DIR / "ptxas.log").exists() else []
        log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                        "library": so.name}))
        for ln in ptxas:
            print(ln, file=sys.stderr)
        results: dict = {}

        timed = timed_call
        timed(kernel_phase, torch, results)
        timed(w8_kernel_phase, torch, results)
        timed(w4x_kernel_phase, torch, results)
        timed(kv_kernel_phase, torch, results)
        timed(mla_kernel_phase, torch, results)
        timed(d256_kernel_phase, torch, results)
        timed(serving_mask_phase, torch, results)
        timed(fx_layer_kernel_phase, torch, results)
        timed(exact_kernel_phase, torch, results)
        timed(iq_kernel_phase, torch, results)
        timed(qwen2_kernel_phase, torch, results)
        timed(gpt_kernel_phase, torch, results)
        timed(large_moe_kernel_phase, torch, results)
        by_path, cfg, params = timed(serving_phase, torch)
        # speculative decoding on the model's first EARLIER_LAYERS layers
        by_path.update(timed(speculative_phase, torch, replace(cfg, n_layer=EARLIER_LAYERS),
                             dict(params, layers=params["layers"][:EARLIER_LAYERS])))
        del params
        torch.cuda.empty_cache()
        by_path.update(timed(w4x_serving_phase, torch, EARLIER_LAYERS))
        by_path.update(timed(tinyllama_phase, torch, EARLIER_LAYERS))
        by_path.update(timed(dual_fold_phase, torch, results))
        by_path.update(timed(synthetic_modes_phase, torch))
        tmpdir = Path(tempfile.mkdtemp(prefix="lk_gguf_"))
        try:
            for mode, c in timed(gguf_phase, torch, tmpdir).items():
                by_path[f"gguf_{mode}"] = c
            by_path["cli_w4"] = timed(cli_phase, torch, tmpdir / LLAMA_FILE)
            by_path.update(timed(exact_serving_phase, torch, tmpdir / LLAMA_FILE))
            for mode in ("w4", None):  # the server's fast mode and its default
                by_path.update(timed(server_phase, torch, tmpdir / LLAMA_FILE,
                                     mode))
            (tmpdir / LLAMA_FILE).unlink()
            by_path.update(timed(q4_0_gguf_phase, torch, tmpdir))
            by_path.update(timed(new_formats_phase, torch, tmpdir))
            by_path.update(timed(iq_formats_phase, torch, tmpdir))
            by_path.update(timed(deepseek2_phase, torch, tmpdir))
            by_path.update(timed(gemma2_phase, torch, tmpdir))
            by_path.update(timed(llama70b_phase, torch, results))
            by_path.update(timed(qwen2_phase, torch, tmpdir))
            by_path.update(timed(qwen2moe_phase, torch, tmpdir))
            by_path.update(timed(falcon_phase, torch, tmpdir))
            by_path.update(timed(starcoder_phase, torch, tmpdir))
            by_path.update(timed(dbrx_phase, torch, tmpdir))
            by_path.update(timed(openelm_phase, torch, tmpdir))
            timed(qwen_parity_phase, torch, tmpdir)
            timed(gpt_parity_phase, torch, tmpdir)
            by_path.update(timed(arch_sweep_phase, torch, tmpdir))
            timed(parity_phase, torch)
            timed(gguf_parity_phase, torch, tmpdir)
            timed(engine_parity_phase, torch)
            timed(moe_parity_phase, torch, tmpdir)
            timed(gemma_parity_phase, torch, tmpdir)
            timed(iq_parity_phase, torch, tmpdir)
            timed(llama70b_parity_phase, torch)
            timed(large_moe_parity_phase, torch, tmpdir)
            timed(stop_cpu_refs, True)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
        ok = True
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        if not ok:
            stop_cpu_refs(False)
        stop_file_writer()
        shutil.rmtree(ref_tmp, ignore_errors=True)
        shutil.rmtree(files_tmp, ignore_errors=True)
    # kernel: (source, replaced Pallas kernel, index of the reported timed
    # row, {branch: index or shape of its timed row})
    meta = {
        "qmm_w4": ("csrc/qmm_w4.cu", "llama_kotlin_tpu/ops/pallas/qmm_w4.py:290", 0,
                   {"b32": "compact qkv n=6144 k=4096 b=32",
                    "lm_head_b32": "compact lm_head n=128256 k=4096 b=32",
                    "llama3_70b_qkv_b1": "70b compact qkv n=10240 k=8192 b=1",
                    "llama3_70b_lm_head_b1": "70b compact lm_head n=128256 k=8192 b=1",
                    "qwen2_qkv_b1": "qwen2 compact qkv n=4608 k=3584 b=1",
                    "qwen2_o_b1": "qwen2 compact o n=3584 k=3584 b=1",
                    "qwen2_gate_up_b1": "qwen2 compact gate_up n=37888 k=3584 b=1",
                    "qwen2_gate_up_b8": "qwen2 compact gate_up n=37888 k=3584 b=8",
                    "qwen2_down_b1": "qwen2 legacy down n=3584 k=18944 b=1",
                    "qwen2_lm_head_b1": "qwen2 compact lm_head n=152064 k=3584 b=1",
                    "starcoder_qkv_b1": "starcoder compact qkv n=6400 k=6144 b=1",
                    "starcoder_qkv_b8": "starcoder compact qkv n=6400 k=6144 b=8",
                    "starcoder_o_b1": "starcoder compact o n=6144 k=6144 b=1",
                    "starcoder_up_b1": "starcoder compact up n=24576 k=6144 b=1",
                    "starcoder_down_b1": "starcoder compact down n=6144 k=24576 b=1",
                    "dbrx_qkv_b1": "dbrx compact qkv n=8192 k=6144 b=1",
                    "dbrx_expert_gate_b1": "dbrx compact expert gate n=10752 k=6144 b=1",
                    "dbrx_expert_gate_b4": "dbrx compact expert gate n=10752 k=6144 b=4",
                    "dbrx_expert_down_b1": "dbrx legacy expert down n=6144 k=10752 b=1",
                    "openelm_q_b1": "openelm legacy q n=3072 k=3072 b=1"}),
        "qmm_w4_ffn": ("csrc/qmm_w4_ffn.cu", "llama_kotlin_tpu/ops/pallas/qmm_w4_ffn.py:155",
                       0, {"b8": "compact E=4096 F=14336 b=8",
                           "b32": "compact E=4096 F=14336 b=32",
                           "up_b1": "up= compact E=4096 F=14336 b=1",
                           "llama3_70b_b1": "70b compact E=8192 F=28672 b=1",
                           "llama3_70b_b8": "70b compact E=8192 F=28672 b=8",
                           "openelm_f3072_b1": "up= openelm legacy E=3072 F=3072 b=1",
                           "openelm_f9216_b1": "up= openelm legacy E=3072 F=9216 b=1"}),
        "flash_mla": ("csrc/flash.cu", "llama_kotlin_tpu/ops/pallas/flash.py:160", 0,
                      {"prefill": "bf16 cache nt=64 n_vis=1024 layer=1",
                       "n4096": "bf16 cache nt=1 n_vis=4096 layer=1",
                       "int8": "int8 cache nt=1 n_vis=1024 layer=1",
                       "int4": "int4 cache nt=1 n_vis=1024 layer=1"}),
        "flash_d256": ("csrc/flash.cu", "llama_kotlin_tpu/ops/pallas/flash.py:160", 0,
                       {"prefill": "bf16 cache nt=64 n_vis=1024 window=0 layer=1",
                        "n4096": "bf16 cache nt=1 n_vis=4096 window=0 layer=1",
                        "window": "bf16 cache nt=1 n_vis=4096 window=1024 layer=1",
                        "int8": "int8 cache nt=1 n_vis=1024 window=0 layer=1",
                        "int4": "int4 cache nt=1 n_vis=1024 window=0 layer=1"}),
        "flash": ("csrc/flash.cu", "llama_kotlin_tpu/ops/pallas/flash.py:160", 0,
                  {"prefill": 1, "int8": 3, "int4": 4,
                   "d64": "bf16 cache D=64 nt=64 n_vis=1024",
                   "ragged": "bf16 cache D=128 nt=64 n_vis=1001",
                   "serving_a": "bf16 cache serving mask a nt=64 n_vis=1024",
                   "serving_b": "bf16 cache serving mask b nt=8 n_vis=1024",
                   "serving_c": "bf16 cache serving mask c nt=16 n_vis=1024",
                   "qwen2_decode": "qwen2 28/4 bf16 cache nt=1 n_vis=1024",
                   "qwen2_prefill": "qwen2 28/4 bf16 cache nt=64 n_vis=1024",
                   "qwen2_int8": "qwen2 28/4 int8 cache nt=1 n_vis=1024",
                   "qwen2_int4": "qwen2 28/4 int4 cache nt=1 n_vis=1024",
                   "qwen2_n4096": "qwen2 28/4 bf16 cache nt=1 n_vis=4096",
                   "qwen2_ragged": "qwen2 28/4 bf16 cache nt=64 n_vis=1001",
                   "falcon_decode": "falcon 71/1 bf16 cache nt=1 n_vis=1024",
                   "falcon_prefill": "falcon 71/1 bf16 cache nt=64 n_vis=1024",
                   "falcon_int8": "falcon 71/1 int8 cache nt=1 n_vis=1024",
                   "falcon_int4": "falcon 71/1 int4 cache nt=1 n_vis=1024",
                   "falcon_n2048": "falcon 71/1 bf16 cache nt=1 n_vis=2048",
                   "falcon_ragged": "falcon 71/1 bf16 cache nt=64 n_vis=1001",
                   "starcoder_decode": "starcoder 48/1 bf16 cache nt=1 n_vis=1024",
                   "starcoder_prefill": "starcoder 48/1 bf16 cache nt=64 n_vis=1024",
                   "starcoder_int4": "starcoder 48/1 int4 cache nt=1 n_vis=1024",
                   "starcoder_n4096": "starcoder 48/1 bf16 cache nt=1 n_vis=4096",
                   "dbrx_decode": "dbrx 48/8 bf16 cache nt=1 n_vis=1024",
                   "dbrx_prefill": "dbrx 48/8 bf16 cache nt=64 n_vis=1024",
                   "dbrx_int8": "dbrx 48/8 int8 cache nt=1 n_vis=1024",
                   "dbrx_n4096": "dbrx 48/8 bf16 cache nt=1 n_vis=4096",
                   "grok_softcap_decode": "grok 48/8 softcap 30 bf16 cache nt=1 n_vis=1024",
                   "grok_softcap_prefill": "grok 48/8 softcap 30 bf16 cache nt=64 n_vis=1024",
                   "openelm_view_decode": "openelm 12/3 view of 6 bf16 cache nt=1 n_vis=1024",
                   "openelm_view_prefill": "openelm 12/3 view of 6 bf16 cache nt=64 n_vis=1024"}),
        "qmm": ("csrc/qmm.cu", "llama_kotlin_tpu/ops/pallas/qmm.py:192", 1,
                {"m512": 5, "w8": 8,
                 "falcon_w8_qkv_m1": "falcon w8 Q5_0 qkv n=4672 k=4544 m=1",
                 "falcon_w8_o_m1": "falcon w8 Q5_0 o n=4544 k=4544 m=1",
                 "falcon_w4_down_m1": "falcon compact Q4_K down n=4544 k=18176 m=1",
                 "falcon_w8_qkv_m64": "falcon w8 Q5_0 qkv n=4672 k=4544 m=64"}),
        "qmm_w8": ("csrc/qmm_w8.cu", "llama_kotlin_tpu/ops/pallas/qmm_w8.py:144", 0,
                   {"b32": "lm_head n=128256 k=4096 b=32 group=16",
                    "falcon_up_b1": "falcon w8 up n=18176 k=4544 b=1 group=32",
                    "falcon_lm_head_b1": "falcon w8 lm_head n=65024 k=4544 b=1 group=32",
                    "starcoder_lm_head_b1": "starcoder w8 lm_head n=49152 k=6144 b=1 group=16"}),
        "qmm_int8": ("csrc/qmm_int8.cu", "llama_kotlin_tpu/ops/pallas/qmm_int8.py:41",
                     "down n=4096 k=14336 b=64",
                     {"b1": "qkv n=6144 k=4096 b=1", "qkv_m64": "qkv n=6144 k=4096 b=64",
                      "b32": "lm_head n=128256 k=4096 b=32",
                      "m512": "qkv n=6144 k=4096 b=512",
                      "shadow_qkv_b16": "shadow qkv n=6144 k=4096 b=16",
                      "shadow_gate_up_b256": "shadow gate_up n=28672 k=4096 b=256",
                      "shadow_lm_head_b16": "shadow lm_head n=128256 k=4096 b=16"}),
        "flash_stacked": ("csrc/flash_stacked.cu",
                          "llama_kotlin_tpu/ops/pallas/flash_stacked.py:94", 0,
                          {"int8": 1, "prefill": "bf16 cache nt=64 n_vis=1024 layer=31",
                           "d64": "bf16 cache D=64 nt=64 n_vis=1024",
                           "ragged": "bf16 cache D=128 nt=64 n_vis=1001",
                           "qwen2_decode": "qwen2 28/4 bf16 cache nt=1 n_vis=1024",
                           "qwen2_prefill": "qwen2 28/4 bf16 cache nt=64 n_vis=1024",
                           "qwen2_int8": "qwen2 28/4 int8 cache nt=1 n_vis=1024",
                           "falcon_decode": "falcon 71/1 bf16 cache nt=1 n_vis=1024",
                           "starcoder_decode": "starcoder 48/1 bf16 cache nt=1 n_vis=1024"}),
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
        if kname == "qmm":  # the exact branches (csrc/qmm_exact.cu), counted apart
            exact = {"source": "llama_kotlin_tpu_torch/csrc/qmm_exact.cu",
                     **{k: pick_row(rows, "exact Q4_K qkv n=6144 k=4096 m=64")[k]
                        for k in timing + ("max_abs_err",)},
                     "launches_by_path": {p: c["qmm_exact"] for p, c in by_path.items()
                                          if "qmm_exact" in c}}
            exact["launches"] = sum(exact["launches_by_path"].values())
            for branch, shape in (("b1", "exact Q4_K qkv n=6144 k=4096 m=1"),
                                  ("m512", "exact Q4_K qkv n=6144 k=4096 m=512"),
                                  ("lm_head_b1", "exact Q6_K lm_head n=128256 k=4096 m=1"),
                                  ("qwen2_qkv_m1", "qwen2 exact Q4_K qkv n=4608 k=3584 m=1"),
                                  ("qwen2_qkv_m64", "qwen2 exact Q4_K qkv n=4608 k=3584 m=64"),
                                  ("falcon_qkv_m1", "falcon exact Q5_0 qkv n=4672 k=4544 m=1"),
                                  ("falcon_qkv_m64", "falcon exact Q5_0 qkv n=4672 k=4544 m=64"),
                                  ("falcon_down_m1",
                                   "falcon exact Q4_K down n=4544 k=18176 m=1"),
                                  ("falcon_lm_head_m1",
                                   "falcon exact Q8_0 lm_head n=65024 k=4544 m=1"),
                                  ("dbrx_expert_gate_m1",
                                   "exact Q4_K dbrx gate n=10752 k=6144 m=1"),
                                  ("dbrx_expert_gate_m64",
                                   "exact Q4_K dbrx gate n=10752 k=6144 m=64"),
                                  ("dbrx_expert_down_m64",
                                   "exact Q4_K dbrx down n=6144 k=10752 m=64"),
                                  ("grok1_expert_gate_m64",
                                   "exact Q4_K grok-1 gate n=32768 k=6144 m=64"),
                                  ("arctic_expert_gate_m64",
                                   "exact Q4_K arctic gate n=4864 k=7168 m=64")):
                exact[branch] = {k: pick_row(rows, shape)[k] for k in timing + ("max_abs_err",)}
            # the IQ repacks on the same branch (iq_kernel_phase): qkv at one row
            exact["iq_qkv_b1"] = {
                r["shape"].split()[1]: {k: r[k] for k in timing + ("max_abs_err",)}
                for r in rows if r["shape"].startswith("exact IQ") and " qkv " in r["shape"]
                and r["shape"].endswith(" m=1")}
            entry["exact"] = exact
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
