#!/usr/bin/env python3
"""Compare the machine code (SASS) of two checkouts' kernel libraries,
function by function.

    python3 scripts/sass_diff.py ROOT_A ROOT_B

Builds each root's kernels (``llama_kotlin_tpu_torch/_build/`` under the
root, in a process of its own), disassembles both libraries with the CUDA
toolkit's ``cuobjdump -sass`` and prints one JSON line: the functions whose
SASS is equal, those that differ (with their instruction counts in A and
B) and those only one root has.  A kernel whose SASS is equal runs the same
instructions, so its time can differ only by the card's noise.  Needs the
CUDA toolkit (the machine with the card).
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys


def library(root: str) -> str:
    """Build ROOT's kernels; the library's path."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from llama_kotlin_tpu_torch.ops.cuda import _build; print(_build.build())")
    out = subprocess.run([sys.executable, "-c", code, root], capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


def functions(so: str) -> dict:
    """{mangled name: SASS text} of every function in the library; the
    hash nvcc puts in an anonymous namespace's name (it depends on the
    source's path) is dropped, so the same kernel of two checkouts has one
    name."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name, _, body = chunk.partition("\n")
        name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", name.strip())
        out[name] = body.split("\n\t\t....")[0].strip()
    return out


def count(body: str) -> int:
    return len(re.findall(r"/\*[0-9a-f]{4}\*/", body))


def main(argv: list[str]) -> int:
    a, b = (functions(library(r)) for r in argv[:2])
    same = sorted(n for n in a.keys() & b.keys() if a[n] == b[n])
    differ = {n: [count(a[n]), count(b[n])] for n in sorted(a.keys() & b.keys())
              if a[n] != b[n]}
    print(json.dumps({"roots": argv[:2], "n_same": len(same), "same": same, "differ": differ,
                      "only_a": sorted(a.keys() - b.keys()),
                      "only_b": sorted(b.keys() - a.keys())}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
