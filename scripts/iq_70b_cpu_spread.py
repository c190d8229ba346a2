#!/usr/bin/env python3
"""The CPU's own spread on chip_smoke.py's IQ and llama3-70b parity checks:
the 2-layer every-IQ GGUF file of ``iq_parity_cases`` (exact and w4) and
the 2-layer llama3-70b of ``llama70b_parity_case`` (the same seeds, prompt
and context), served on the CPU at 8 intra-op threads and again at fewer:
1 for the IQ file, 4 for llama3-70b (whose one-thread run would take ten
minutes).

    python3 scripts/iq_70b_cpu_spread.py [--tmp DIR] [--only iq|70b]

The thread counts change only the f32 order of the CPU's sums, so the
difference between the two runs, carried through the layers, is rounding
noise of the kind the parity checks' tolerances must hold beside the
card's, whose kernels sum in orders of their own.  The second run takes
the eight-thread run's greedy tokens.  Prints one JSON line per check:
each step's max|logits difference| over max|logits| and the largest
(``spread``).  Needs the card only to draw llama3-70b's weights (copied to
the CPU); the IQ file takes about 1.5 GB under DIR, removed after use."""

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


def spread(label: str, build, prompt, tol: float, low: int) -> None:
    torch.set_num_threads(8)
    ref = chip_smoke.greedy_logits(build, "cpu", prompt, 4)
    toks = [int(np.argmax(r)) for r in ref[:-1]]
    torch.set_num_threads(low)
    other = chip_smoke.greedy_logits(build, "cpu", prompt, 4, toks=toks)
    steps = [float(np.abs(a - b).max() / np.abs(a).max()) for a, b in zip(ref, other)]
    print(json.dumps({"check": label, "threads": [8, low], "steps": steps,
                      "spread": max(steps), "tol": tol}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tmp", default=None, help="directory for the files (default: a temp dir)")
    ap.add_argument("--only", choices=("iq", "70b"), default=None)
    args = ap.parse_args()
    if args.only != "70b":
        with tempfile.TemporaryDirectory(dir=args.tmp) as tmp:
            for case in chip_smoke.iq_parity_cases(Path(tmp)):
                spread(*case, low=1)
    if args.only != "iq":
        spread(*chip_smoke.llama70b_parity_case(torch), low=4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
