#!/usr/bin/env python3
"""Kernel 3 (flash attention; bf16, int8 and packed int4 caches) and kernel
9 (stacked flash attention; bf16 and int8 caches) of two or more checkouts
of the port, timed on one card in turns.

    python3 scripts/flash_ab.py ROOT_A ROOT_B [ROOT ...] [--rounds N]

Each turn is its own process that builds ROOT's kernels
(``llama_kotlin_tpu_torch/_build/`` under ROOT) and times its
``flash_attention`` and ``flash_attention_stacked`` with chip_smoke.py's
timer (median of 20 CUDA-event timings, L2 flushed before each) on layer 1
of a [2, 8, 1025, 128] cache (32 query heads):
- kernel 3 at chip_smoke.py's shapes (decode: nt = 1 over 1024 cells, 65
  or 1001 visible; a 64-token prefill over 512 cells with 64 visible), at
  nt = 1, 2, 4, 8 and 64 (4, 8, 16, 32 and 256 rows a kv head) over 1024
  cells with the first 1001 visible and over 512 with 96 visible (the
  tokens last, causal), and at chip_smoke.py's prefill over 1024 cells (64
  tokens at positions 960..1023), each on the three caches;
- kernel 9 at decode and that prefill, bf16 and int8 caches (the step's
  cells masked out of the cache, its rows merged fresh);
- both at head dim 64 (tinyllama-1.1b's heads: 32 query heads on 4 kv
  heads, a [2, 4, 1025, 64] cache) at decode and that prefill, and at
  head dim 128 over a ragged 1000 or 1001 visible cells (decode and a
  64-token prefill); a root whose kernels refuse a shape records the
  refusal.
Turns run in root order, then in reverse, each round, so no root always
runs first.  Prints one JSON line per turn, then the card's name and power
limit.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

# (nt, n_vis, visible cells): tokens at positions live - nt .. live - 1,
# cell c holds position c (causal)
SHAPES = ((1, 1024, 65), (1, 1024, 1001), (64, 512, 64), (64, 1024, 1024)) + tuple(
    (nt, n_vis, live) for n_vis, live in ((1024, 1001), (512, 96)) for nt in (1, 2, 4, 8, 64))
STACKED = ((1, 1024, 1001), (64, 1024, 1024))
# (head dim, kv heads, nt, n_vis): the repairs' shapes (n_vis cells all
# visible up to the step's tokens, the last ones)
REPAIRED = ((64, 4, 1, 1024), (64, 4, 64, 1024), (128, 8, 1, 1000), (128, 8, 64, 1001))


def one(root: str) -> None:
    """Build ROOT's kernels and time its kernels 3 and 9."""
    import torch

    sys.path.insert(0, root)
    from llama_kotlin_tpu_torch.ops.cuda import _build, flash, flash_stacked
    from llama_kotlin_tpu_torch.runtime.kv_cache import quantize_rows, quantize_rows_q4

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    flush = torch.zeros(smoke.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    H, KV, D, cells = 32, 8, 128, 1025
    kb = torch.randn((2, KV, cells, D), generator=gen, device=dev).to(torch.bfloat16)
    vb = torch.randn((2, KV, cells, D), generator=gen, device=dev).to(torch.bfloat16)
    caches = {"bf16": dict(k=kb, v=vb)}
    for kind, qr in (("int8", quantize_rows), ("int4", quantize_rows_q4)):
        (k, ks), (v, vs) = qr(kb), qr(vb)
        caches[kind] = dict(k=k, v=v, k_scale=ks, v_scale=vs, kv_bits=4 if kind == "int4" else 8)
    out = {"root": root, "library": _build.build().name}
    for nt, n_vis, live in SHAPES:
        q = torch.randn((nt, H, D), generator=gen, device=dev).to(torch.bfloat16)
        cpos = torch.arange(n_vis, device=dev)
        tpos = torch.arange(live - nt, live, device=dev)
        mask = ((cpos[None, :] <= tpos[:, None]) & (cpos[None, :] < live)).to(torch.int8)
        for kind, c in caches.items():
            kw = dict(c, scale=D ** -0.5, layer=1)
            k, v = kw.pop("k"), kw.pop("v")
            call = lambda: flash.flash_attention(q, k, v, mask, **kw)
            out[f"flash {kind} nt={nt} n_vis={n_vis} live={live}"] = smoke.time_ms(
                torch, call, flush)
    for nt, n_vis, live in STACKED:
        q = torch.randn((nt, H, D), generator=gen, device=dev).to(torch.bfloat16)
        p0 = live - nt
        tpos = torch.arange(p0, live, device=dev)
        cpos = torch.arange(n_vis, device=dev)
        mask_cells = (cpos[None, :] < p0).to(torch.int8).expand(nt, n_vis).contiguous()
        mask_new = (tpos[None, :] <= tpos[:, None]).to(torch.int8)
        new_k = torch.randn((nt, KV, D), generator=gen, device=dev).to(torch.bfloat16)
        new_v = torch.randn((nt, KV, D), generator=gen, device=dev).to(torch.bfloat16)
        for kind in ("bf16", "int8"):
            kw = dict(caches[kind], scale=D ** -0.5)
            kw.pop("kv_bits", None)
            k, v = kw.pop("k"), kw.pop("v")
            call = lambda: flash_stacked.flash_attention_stacked(q, k, v, 1, new_k, new_v,
                                                                 mask_cells, mask_new, **kw)
            out[f"flash_stacked {kind} nt={nt} n_vis={n_vis} live={live}"] = smoke.time_ms(
                torch, call, flush)
    for d, kv, nt, n_vis in REPAIRED:
        kb, vb = (torch.randn((2, kv, 1025, d), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        (k8, ks), (v8, vs) = quantize_rows(kb), quantize_rows(vb)
        q = torch.randn((nt, H, d), generator=gen, device=dev).to(torch.bfloat16)
        tpos = torch.arange(n_vis - nt, n_vis, device=dev)
        cpos = torch.arange(n_vis, device=dev)
        mask = (cpos[None, :] <= tpos[:, None]).to(torch.int8)
        mask_cells = (cpos[None, :] < n_vis - nt).to(torch.int8).expand(nt, n_vis).contiguous()
        mask_new = (tpos[None, :] <= tpos[:, None]).to(torch.int8)
        new_k, new_v = (torch.randn((nt, kv, d), generator=gen, device=dev).to(torch.bfloat16)
                        for _ in range(2))
        for kind, kw in (("bf16", {}), ("int8", dict(k_scale=ks, v_scale=vs))):
            k, v = (kb, vb) if kind == "bf16" else (k8, v8)
            calls = {"flash": lambda: flash.flash_attention(q, k, v, mask, scale=d ** -0.5,
                                                            layer=1, **kw),
                     "flash_stacked": lambda: flash_stacked.flash_attention_stacked(
                         q, k, v, 1, new_k, new_v, mask_cells, mask_new, scale=d ** -0.5, **kw)}
            for name, call in calls.items():
                key = f"{name} {kind} D={d} nt={nt} n_vis={n_vis}"
                try:
                    call()
                except ValueError as e:  # this root's kernels do not take the shape
                    out[key] = f"refused: {e}"
                    continue
                out[key] = smoke.time_ms(torch, call, flush)
    print(json.dumps(out), flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        one(argv[1])
        return 0
    rounds = 1
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        del argv[i:i + 2]
    roots = argv
    for _ in range(rounds):
        for root in roots + roots[::-1]:
            subprocess.run([sys.executable, __file__, "--one", root], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
