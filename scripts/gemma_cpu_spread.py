#!/usr/bin/env python3
"""The CPU's own spread on chip_smoke.py's gemma parity files: the 2-layer
gemma-2-9b-shaped (window under the prompt) and gemma-7b-shaped GGUF files
of ``gemma_parity_cases`` (the same seeds, prompt, modes and context),
served on the CPU at 8 intra-op threads and again at 1.

    python3 scripts/gemma_cpu_spread.py [--tmp DIR]

The thread counts change only the f32 order of the CPU's sums, so the
difference between the two runs, carried through the layers, is rounding
noise of the kind ``gemma_parity_phase``'s tolerances must hold beside the
card's, whose kernels sum in orders of their own.  The one-thread run
takes the eight-thread run's greedy tokens.  Prints one JSON line per
check: each step's max|logits difference| over max|logits| and the largest
(``spread``).  Runs on the CPU only; the files take about 2 GB under DIR,
removed after use."""

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tmp", default=None, help="directory for the files (default: a temp dir)")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(dir=args.tmp) as tmp:
        for label, build, prompt, tol in chip_smoke.gemma_parity_cases(Path(tmp)):
            torch.set_num_threads(8)
            ref = chip_smoke.greedy_logits(build, "cpu", prompt, 4)
            toks = [int(np.argmax(r)) for r in ref[:-1]]
            torch.set_num_threads(1)
            one = chip_smoke.greedy_logits(build, "cpu", prompt, 4, toks=toks)
            steps = [float(np.abs(a - b).max() / np.abs(a).max()) for a, b in zip(ref, one)]
            print(json.dumps({"check": label, "threads": [8, 1], "steps": steps,
                              "spread": max(steps), "tol": tol}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
