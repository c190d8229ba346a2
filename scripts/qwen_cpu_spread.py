#!/usr/bin/env python3
"""The CPU's own spread on chip_smoke.py's family checks: the 2-layer
Qwen2-7B and Qwen1.5-MoE-A2.7B files of ``qwen_parity_cases`` (in their
modes), the 2-layer Falcon-7B and StarCoder-15.5B files of
``gpt_parity_cases`` and the architecture sweep's files of ``sweep_cases``
(exact), the same seeds, prompts and contexts, served on the CPU at 8
intra-op threads and again at 1.

    python3 scripts/qwen_cpu_spread.py [--tmp DIR] [--only qwen|gpt|sweep|large]

``--only gpt`` runs the Falcon-7B and StarCoder files and the sweep's
learned-position and LayerNorm-gelu members (GPT_SWEEP); ``--only large``
the 2-layer DBRX and OpenELM files of ``large_moe_parity_cases`` (in
their modes) and the sweep's large-MoE and per-layer members
(LARGE_SWEEP); the sweep's MoE members on a replayed routing.

The thread counts change only the f32 order of the CPU's sums, so the
difference between the two runs, carried through the layers, is rounding
noise of the kind the card-vs-CPU tolerances must hold beside the card's,
whose kernels sum in orders of their own.  The one-thread run takes the
eight-thread run's greedy tokens, and on the MoE file its routing
(scripts/moe_cpu_spread.py's replay).  Prints one JSON line per check:
each step's max|logits difference| over max|logits|, the largest
(``spread``) and the check's tolerance.  Runs on the CPU only; the Qwen
files take about 2 GB under DIR, the Falcon and StarCoder files about 2
GB more, removed after use."""

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
from llama_kotlin_tpu_torch.ops import moe  # noqa: E402

# the sweep's members of the learned-position and LayerNorm-gelu family
GPT_SWEEP = ("gpt2", "starcoder", "gptneox", "falcon", "falcon-40b", "mpt", "phi2", "bloom",
             "jais", "nemotron", "chatglm")
# the sweep's large MoEs and per-layer architectures
LARGE_SWEEP = ("openelm", "bitnet", "dbrx", "grok", "arctic")


def spread(label: str, build, prompt, tol: float, is_moe: bool) -> None:
    """Logits at 8 threads against 1 thread on the 8-thread run's tokens
    (and routing)."""
    real, rec = moe.route, []

    def recording(router, n_used, norm_topk, scale):
        w, i = real(router, n_used, norm_topk, scale)
        rec.append(i)
        return w, i

    def replay(router, n_used, norm_topk, scale):
        return chip_smoke.replayed_route(torch, router, rec.pop(0), norm_topk, scale)

    torch.set_num_threads(8)
    moe.route = recording if is_moe else real
    try:
        ref = chip_smoke.greedy_logits(build, "cpu", prompt, 4)
        toks = [int(np.argmax(r)) for r in ref[:-1]]
        torch.set_num_threads(1)
        moe.route = replay if is_moe else real
        one = chip_smoke.greedy_logits(build, "cpu", prompt, 4, toks=toks)
    finally:
        moe.route = real
        torch.set_num_threads(8)
    steps = [float(np.abs(a - b).max() / np.abs(a).max()) for a, b in zip(ref, one)]
    print(json.dumps({"check": label, "threads": [8, 1], "steps": steps,
                      "spread": max(steps), "tol": tol}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tmp", default=None, help="directory for the files (default: a temp dir)")
    ap.add_argument("--only", choices=("qwen", "gpt", "sweep", "large"), default=None)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(dir=args.tmp) as tmp:
        if args.only in (None, "qwen"):
            for label, build, prompt, tol, is_moe in chip_smoke.qwen_parity_cases(Path(tmp)):
                spread(label, build, prompt, tol, is_moe)
        if args.only in (None, "gpt"):
            for label, build, prompt, tol in chip_smoke.gpt_parity_cases(Path(tmp)):
                spread(label, build, prompt, tol, False)
        if args.only in (None, "large"):
            for label, build, prompt, tol, is_moe in chip_smoke.large_moe_parity_cases(
                    Path(tmp)):
                spread(label, build, prompt, tol, is_moe)
        if args.only != "qwen":
            members = {"gpt": GPT_SWEEP, "large": LARGE_SWEEP}.get(args.only)
            for label, cfg, build, prompt, tol in chip_smoke.sweep_cases(Path(tmp)):
                if members is None or label.removeprefix("sweep_") in members:
                    spread(label, build, prompt, tol, cfg.n_expert > 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
