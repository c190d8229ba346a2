#!/usr/bin/env python3
"""The CPU's own spread on chip_smoke.py's MoE parity files: the 2-layer
DeepSeek-V2-Lite and Mixtral-8x7B-shaped GGUF files of
``moe_parity_phase`` (the same seeds, prompt and context), served on the
CPU at 8 intra-op threads and again at 1, in each of their modes.

    python3 scripts/moe_cpu_spread.py [--tmp DIR] [--files mixtral,deepseek2]

The thread counts change only the f32 order of the CPU's sums, so the
difference between the two runs, carried through the layers, is rounding
noise of the kind ``moe_card_vs_cpu``'s tolerance must hold beside the
card's, whose kernels sum in orders of their own.  The one-thread run
takes the eight-thread run's greedy tokens and replays its routing (the
experts; the weights from its own router, as the card replays the CPU's),
so a near-tie cannot part the runs; the rows whose own routing parts are
counted with their k-th minus (k+1)-th probability gaps.  Prints one JSON
line per file and mode: each step's max|logits difference| over
max|logits|, its largest (``spread``) and the parted rows.  Runs on the
CPU only; the files take about 3 GB (mixtral) and 2 GB (deepseek2) under
DIR, removed after use."""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from llama_kotlin_tpu_torch.models.loader import load_gguf_model  # noqa: E402
from llama_kotlin_tpu_torch.models.synthetic import (deepseek_v2_lite, mixtral_8x7b,  # noqa: E402
                                                     synthetic_gguf)
from llama_kotlin_tpu_torch.ops import moe  # noqa: E402
from llama_kotlin_tpu_torch.runtime.context import LlamaContext  # noqa: E402

# moe_parity_phase's files: (shape, modes, seed)
FILES = {
    "deepseek2": (deepseek_v2_lite, (None, "w4"), chip_smoke.DS2_SEED + 1),
    "mixtral": (mixtral_8x7b, ("w4",), chip_smoke.DS2_SEED + 2),
}


def spread(path: Path, mode, prompt) -> dict:
    """Logits at 8 threads against 1 thread on the 8-thread run's tokens
    and routing."""
    def build(dev):
        cfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True, device=dev)
        f.close()
        return LlamaContext(cfg, params, n_cells=1024, buckets=(8, 16, 32, 64), device=dev)

    real = moe.route
    rec = []

    def recording(router, n_used, norm_topk, scale):
        probs = torch.softmax(router.to(torch.float32), dim=-1)
        w, i = real(router, n_used, norm_topk, scale)
        rec.append((probs.numpy(), i))
        return w, i

    torch.set_num_threads(8)
    moe.route = recording
    try:
        ref = chip_smoke.greedy_logits(build, "cpu", prompt, 4)
    finally:
        moe.route = real
    toks = [int(np.argmax(r)) for r in ref[:-1]]
    gaps = []

    def replay(router, n_used, norm_topk, scale):
        probs8, ids = rec.pop(0)
        _, own = real(router, n_used, norm_topk, scale)
        for r in range(ids.shape[0]):
            if set(own[r].tolist()) != set(ids[r].tolist()):
                srt = np.sort(probs8[r])[::-1]
                gaps.append(float(srt[n_used - 1] - srt[n_used]))
        return chip_smoke.replayed_route(torch, router, ids, norm_topk, scale)

    torch.set_num_threads(1)
    moe.route = replay
    try:
        one = chip_smoke.greedy_logits(build, "cpu", prompt, 4, toks=toks)
    finally:
        moe.route = real
        torch.set_num_threads(8)
    assert not rec
    steps = [float(np.abs(a - b).max() / np.abs(a).max()) for a, b in zip(ref, one)]
    return {"steps": steps, "spread": max(steps), "parted_rows": len(gaps), "gaps": gaps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tmp", default=None, help="directory for the files (default: a temp dir)")
    ap.add_argument("--files", default="mixtral,deepseek2")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(dir=args.tmp) as tmp:
        for name in args.files.split(","):
            shape, modes, seed = FILES[name]
            cfg, moe_shape = shape(n_layer=2)
            path = Path(tmp) / f"{name}-2layer.gguf"
            synthetic_gguf(path, cfg, seed=seed, moe=moe_shape)
            prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, 64).astype(np.int32)
            for mode in modes:
                line = {"file": name, "mode": mode or "exact", "threads": [8, 1]}
                line.update(spread(path, mode, prompt))
                print(json.dumps(line), flush=True)
            path.unlink()
    return 0


if __name__ == "__main__":
    sys.exit(main())
