#!/usr/bin/env python3
"""Kernel 3 (flash attention, bf16 cache) of two checkouts of the port,
timed on one card in turns.

    python3 scripts/flash_ab.py ROOT_A ROOT_B [--rounds N]

Each turn is its own process that builds ROOT's kernels
(``llama_kotlin_tpu_torch/_build/`` under ROOT) and times its
``flash_attention`` with chip_smoke.py's timer (median of 20 CUDA-event
timings, L2 flushed before each) at the shapes chip_smoke.py's kernel phase
uses: decode (nt = 1 over 1024 cells, 65 or 1001 visible) and a 64-token
prefill over 512 cells.  Turns run A, B, B, A per round, so neither side
always runs first.  Prints one JSON line per turn, then the card's name and
power limit.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

SHAPES = ((1, 1024, 65), (1, 1024, 1001), (64, 512, 64))  # (nt, n_vis, live cells)


def one(root: str) -> None:
    """Build ROOT's kernels and time its kernel 3 at SHAPES."""
    import torch

    sys.path.insert(0, root)
    from llama_kotlin_tpu_torch.ops.cuda import _build, flash

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
    kc = torch.randn((2, KV, cells, D), generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn((2, KV, cells, D), generator=gen, device=dev).to(torch.bfloat16)
    out = {"root": root, "library": _build.build().name}
    for nt, n_vis, live in SHAPES:
        q = torch.randn((nt, H, D), generator=gen, device=dev).to(torch.bfloat16)
        cpos = torch.arange(n_vis, device=dev)
        tpos = torch.arange(live - nt, live, device=dev)
        mask = ((cpos[None, :] <= tpos[:, None]) & (cpos[None, :] < live)).to(torch.int8)
        call = lambda: flash.flash_attention(q, kc, vc, mask, scale=D ** -0.5, layer=1)
        out[f"nt={nt} n_vis={n_vis} live={live}"] = smoke.time_ms(torch, call, flush)
    print(json.dumps(out), flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        one(argv[1])
        return 0
    a, b = argv[:2]
    rounds = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv else 2
    for _ in range(rounds):
        for root in (a, b, b, a):
            subprocess.run([sys.executable, __file__, "--one", root], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
