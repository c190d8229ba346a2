#!/usr/bin/env python3
"""Kernels 1 (the W4A8 decode matmul), 4 (the prefill dequant matmul, both
branches), 5 (the W8 decode matmul, both branches), 6 (the Q8F matmul of
the int8 mode), 7 (the W4X matmul) and 8 (the W4A8 matmul with the
quantization inside the launch) of two or more checkouts of the port,
timed on one card in turns.

    python3 scripts/qmm_ab.py ROOT_A ROOT_B [ROOT ...] [--rounds N] [--kernels 1,4,5,6,7,8]

Each turn is its own process that builds ROOT's kernels
(``llama_kotlin_tpu_torch/_build/`` under ROOT) and times them through
their wrappers (``qmm_w4.qmm_w4_matmul``, ``qmm.qmm``,
``qmm_w8.qmm_w8_matmul``, ``qmm_w4x.qmm_w4x_matmul``,
``qmm_w4_fx.qmm_w4_fx_matmul``) with
chip_smoke.py's timer (median of 20 CUDA-event timings, L2 flushed before
each) at the llama3-8B shapes of PERF.md's kernel table: kernel 4 on W4
folds (qkv, o, gate|up, down) at 64 and 512 rows and on q6_K W8 folds
(ffn_down, attn_v) at 64 rows; kernel 7 on precise folds (gate|up at b = 1,
2, 4, 8, 9, 16, 32; qkv, o and down at b = 1, 2, 4, 32); kernel 5 on q6_K
W8 folds (lm_head, ffn_down, attn_v) and on W8X folds of the same blocks at
b = 1, 2, 4, 8, 9, 16, 32; kernel 8 on sym folds (qkv, o, gate|up, down) at
the same row counts and on legacy folds at b = 1, 2, 4, 9, 32; kernel 1 on
compact, sym and legacy folds (qkv, o, gate|up, lm_head) at the same row
counts as kernel 5; kernel 6 on Q8F conversions of Q4_K (qkv, o, gate|up)
and Q6_K (down, lm_head) blocks at b = 1, 2, 4, 8, 9, 16, 32, 64 and 512,
each beside its library call (``library ...`` keys: one torch.matmul of
the bf16 rows and the pre-dequantized bf16 weight).  A root
whose kernel walks every row count against one that takes more rows on
tensor cores gives that kernel's row threshold's crossover; where a root
has a threshold (``MMA_MIN_ROWS``), its rows up to it are also timed on
the tensor cores (keys ending in ``mma``), so one root shows both sides.
Where a root has the split plan (``qmm.plan``), its kernels 4 (64 rows) and
1, 5, 7 and 8 (32 rows) are also timed at other split counts than the plan's:
the least that gives every SM a block, and twice that (keys ending in
``splits=S``).  Weights and inputs come from fixed seeds, so every root
sees the same numbers.  Turns run in root order, then in reverse, each
round, so no root always runs first.  Prints one JSON line per turn, then
the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

E, F, KVD, V = 4096, 14336, 1024, 128256
W4_SHAPES = {"qkv": (6144, E), "o": (E, E), "gate_up": (2 * F, E), "down": (E, F)}
W8_SHAPES = {"ffn_down": (E, F), "attn_v": (KVD, E)}
W4X_CASES = tuple([("gate_up", b) for b in (1, 2, 4, 8, 9, 16, 32)]
                  + [(name, b) for name in ("qkv", "o", "down") for b in (1, 2, 4, 32)])
ROWS = (1, 2, 4, 8, 9, 16, 32)  # kernels 5 and 8: both sides of the crossovers
W8_DECODE = {"lm_head": (V, E), **W8_SHAPES}
FX_LEGACY_ROWS = (1, 2, 4, 9, 32)
W4_DECODE = {"qkv": (6144, E), "o": (E, E), "gate_up": (2 * F, E), "lm_head": (V, E)}
Q8F_SHAPES = {"qkv": ("Q4_K", 6144, E), "o": ("Q4_K", E, E), "gate_up": ("Q4_K", 2 * F, E),
              "down": ("Q6_K", E, F), "lm_head": ("Q6_K", V, E)}
Q8F_ROWS = (1, 2, 4, 8, 9, 16, 32, 64, 512)
KERNELS = ("1", "4", "5", "6", "7", "8")


def split_counts(qmm, m: int, n: int, k: int, unit: int, bms) -> list[int]:
    """The plan's split count, the least that gives every SM a block, and
    twice that, within the K units; [] for a root without the plan or
    where all three are one."""
    if not hasattr(qmm, "plan"):
        return []
    p = qmm.plan(m, n, k, unit, qmm.sm_count(0), bms=bms)
    need = -(-qmm.sm_count(0) // p.tiles)
    counts = sorted({p.splits, min(need, p.units), min(2 * need, p.units)})
    return [] if counts == [1] else counts


@contextlib.contextmanager
def forced_splits(modules, splits: int):
    """Every plan the modules ask for within the block takes `splits`."""
    real = modules[0].plan
    for mod in modules:
        mod.plan = lambda *a, **kw: dataclasses.replace(real(*a, **kw), splits=splits)
    try:
        yield
    finally:
        for mod in modules:
            mod.plan = real


@contextlib.contextmanager
def all_mma(mod):
    """The module's wrapper takes the tensor-core path at every row count."""
    real = mod.MMA_MIN_ROWS
    mod.MMA_MIN_ROWS = 0
    try:
        yield
    finally:
        mod.MMA_MIN_ROWS = real


def decode_rows(out, smoke, torch, key, mod, fn, x, wt, flush, n, k, unit) -> None:
    """Times fn(x, wt) at x's row count; below a root's row threshold also
    on the tensor cores; at 32 rows also at the sweep's split counts."""
    b = x.shape[0]
    out[key] = smoke.time_ms(torch, lambda: fn(x, wt), flush)
    if hasattr(mod, "MMA_MIN_ROWS") and not mod.use_mma(b):
        with all_mma(mod):
            out[f"{key} mma"] = smoke.time_ms(torch, lambda: fn(x, wt), flush)
    if b == 32 and hasattr(mod, "plan"):
        from llama_kotlin_tpu_torch.ops.cuda import qmm

        bms = getattr(mod, "MMA_BMS", None) or (mod.MMA_BM,)
        for z in split_counts(qmm, 1, n, k, unit, bms):
            with forced_splits([qmm, mod], z):
                out[f"{key} splits={z}"] = smoke.time_ms(torch, lambda: fn(x, wt), flush)


def one(root: str, kernels) -> None:
    """Build ROOT's kernels and time the chosen ones."""
    import numpy as np
    import torch

    sys.path.insert(0, root)
    from llama_kotlin_tpu_torch.models.synthetic import (synthetic_w4, synthetic_w4_device,
                                                         wire_blocks)
    from llama_kotlin_tpu_torch.ops.cuda import (_build, qmm, qmm_int8, qmm_w4, qmm_w4_fx, qmm_w4x,
                                                 qmm_w8)
    from llama_kotlin_tpu_torch.quant import fold, repack
    from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    flush = torch.zeros(smoke.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    out = {"root": root, "library": _build.build().name}
    if "1" in kernels:
        for flavor in ("compact", "sym", "legacy"):
            for name, (n, k) in W4_DECODE.items():
                wt = smoke.w4_on_card(torch, gen, n, k, flavor)
                for b in ROWS:
                    x = torch.randn((b, k), generator=gen, device=dev) * 0.7
                    decode_rows(out, smoke, torch, f"qmm_w4 {flavor} {name} b={b}", qmm_w4,
                                qmm_w4.qmm_w4_matmul, x, wt, flush, n, k, 256)
                del wt
    if "4" in kernels:
        for name, (n, k) in W4_SHAPES.items():
            wt = synthetic_w4_device(gen, n, k, zero_mean=False, device=dev)
            for m in (64, 512):
                xb = (torch.randn((m, k), generator=gen, device=dev) * 0.7).to(torch.bfloat16)
                out[f"qmm W4 {name} m={m}"] = smoke.time_ms(torch, lambda: qmm.qmm(xb, wt), flush)
                if m == 64:
                    for z in split_counts(qmm, m, n, k, 256, (32, 64, 128)):
                        with forced_splits([qmm], z):
                            out[f"qmm W4 {name} m={m} splits={z}"] = smoke.time_ms(
                                torch, lambda: qmm.qmm(xb, wt), flush)
            del wt
        rng = np.random.default_rng(99)
        for name, (n, k) in W8_SHAPES.items():
            blocks = torch.from_numpy(wire_blocks(rng, Q.Q6_K, n, k)).to(dev)
            wt = fold.fold_to_w8(repack.repack(blocks, Q.Q6_K, n, k))
            xb = (torch.randn((64, k), generator=gen, device=dev) * 0.7).to(torch.bfloat16)
            out[f"qmm 8-bit {name} m=64"] = smoke.time_ms(torch, lambda: qmm.qmm(xb, wt), flush)
            for z in split_counts(qmm, 64, n, k, 64, (32, 64, 128)):
                with forced_splits([qmm], z):
                    out[f"qmm 8-bit {name} m=64 splits={z}"] = smoke.time_ms(
                        torch, lambda: qmm.qmm(xb, wt), flush)
            del wt, blocks
    if "7" in kernels:
        w = {}
        for name, b in W4X_CASES:
            n, k = W4_SHAPES[name]
            if name not in w:
                w[name] = synthetic_w4_device(gen, n, k, zero_mean=False, precise=True,
                                              device=dev)
            x = torch.randn((b, k), generator=gen, device=dev) * 0.7
            out[f"qmm_w4x {name} b={b}"] = smoke.time_ms(
                torch, lambda: qmm_w4x.qmm_w4x_matmul(x, w[name]), flush)
            if b == 32:
                for z in split_counts(qmm, 1, n, k, 256, (64,)):
                    with forced_splits([qmm, qmm_w4x], z):
                        out[f"qmm_w4x {name} b={b} splits={z}"] = smoke.time_ms(
                            torch, lambda: qmm_w4x.qmm_w4x_matmul(x, w[name]), flush)
        del w
    if "5" in kernels:
        rng = np.random.default_rng(98)
        for name, (n, k) in W8_DECODE.items():
            blocks = torch.from_numpy(wire_blocks(rng, Q.Q6_K, n, k)).to(dev)
            rp = repack.repack(blocks, Q.Q6_K, n, k)
            for label, precise in (("qmm_w8", False), ("qmm_w8_precise", True)):
                wt = fold.fold_to_w8(rp, precise=precise)
                for b in ROWS:
                    x = torch.randn((b, k), generator=gen, device=dev) * 0.7
                    decode_rows(out, smoke, torch, f"{label} {name} b={b}", qmm_w8,
                                qmm_w8.qmm_w8_matmul, x, wt, flush, n, k, 256)
                del wt
            del blocks, rp
    if "6" in kernels:
        rng = np.random.default_rng(96)
        for name, (qt, n, k) in Q8F_SHAPES.items():
            blocks = torch.from_numpy(wire_blocks(rng, Q[qt], n, k)).to(dev)
            wt = repack.repack_q8flat(blocks, Q[qt], n, k)
            del blocks
            for b in Q8F_ROWS:
                x = torch.randn((b, k), generator=gen, device=dev) * 0.7
                decode_rows(out, smoke, torch, f"qmm_int8 {name} b={b}", qmm_int8,
                            qmm_int8.qmm_int8, x, wt, flush, n, k, 256)
                out[f"library {name} b={b}"] = smoke.matmul_ms(torch, x, wt, flush)
            del wt
    if "8" in kernels:
        rng = np.random.default_rng(97)
        for flavor, kw, rows in (("sym", dict(sym=True), ROWS),
                                 ("legacy", dict(compact=False), FX_LEGACY_ROWS)):
            for name, (n, k) in W4_SHAPES.items():
                wt = synthetic_w4(rng, n, k, device=dev, **kw)
                for b in rows:
                    x = torch.randn((b, k), generator=gen, device=dev) * 0.7
                    decode_rows(out, smoke, torch, f"qmm_w4_fx {flavor} {name} b={b}", qmm_w4_fx,
                                qmm_w4_fx.qmm_w4_fx_matmul, x, wt, flush, n, k, 256)
                del wt
    print(json.dumps(out), flush=True)


def main(argv: list[str]) -> int:
    kernels = KERNELS
    if "--kernels" in argv:
        i = argv.index("--kernels")
        kernels = tuple(argv[i + 1].split(","))
        del argv[i:i + 2]
    if argv[:1] == ["--one"]:
        one(argv[1], kernels)
        return 0
    rounds = 1
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        del argv[i:i + 2]
    roots = argv
    for _ in range(rounds):
        for root in roots + roots[::-1]:
            subprocess.run([sys.executable, __file__, "--one", root, "--kernels",
                            ",".join(kernels)], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
