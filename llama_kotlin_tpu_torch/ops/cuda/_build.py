"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (Hopper; no ``--use_fast_math``), then linked into
one shared library with a plain C interface and loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a full build takes seconds.  The
library lands in ``llama_kotlin_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the sources and flags: the first use
builds, later uses in the same checkout load it.  The ptxas report
(registers, shared memory, spills per kernel) is kept beside it as
``ptxas.log``.

Nothing here runs at import time; ``lib()`` builds on first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# exported C functions: name -> argument types (every one returns int)
SIGNATURES = {
    "lk_quantize_q8": [_P, _P, _P, _P, _I, _I, _P],
    "lk_quantize_q8_2p": [_P, _P, _P, _P, _I, _I, _P],
    "lk_w4_gemv": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P],
    "lk_w4x_gemv": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P],
    "lk_w4_fx_gemv": [_P, _I, _P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P],
    "lk_w4_layer": [_P, _P, _P, _I] + [_P] * 15 + [_I] * 5 + [_F, _F] + [_P] * 5,
    "lk_w4_ffn": [_P, _P, _P, _I] + [_P] * 10 + [_I, _I, _I, _I, _P, _P, _P],
    "lk_flash": [_P] * 9 + [_I] * 8 + [_F, _F, _I, _I, _P],
    "lk_flash_stacked": [_P] * 12 + [_I] * 8 + [_F, _F, _I, _P],
    "lk_w4_dequant_gemm": [_P] * 5 + [_I] * 5 + [_P, _P, _P],
    "lk_w8_dequant_gemm": [_P] * 5 + [_I] * 6 + [_P, _P, _P],
    "lk_w8_gemv": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P],
    "lk_q8f_matmul": [_P, _P, _I, _P, _P, _I, _I, _P, _I, _I, _P, _P, _P],
    "lk_error_string": [_I],
}

_lib = None
_counters: dict = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return found


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/ into the shared library (or reuse an identical build)."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = _digest(sorted(CSRC_DIR.glob("*.cu*")))
    out = BUILD_DIR / f"liblk_kernels_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{digest}.o"
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _obj, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{text}")
    (BUILD_DIR / "ptxas.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *(str(o) for _s, o, _p in procs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p if name == "lk_error_string" else ctypes.c_int
        _lib = so
    return _lib


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib().lk_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t) -> int | None:
    """Device pointer of a tensor (None passes through as NULL)."""
    return None if t is None else t.data_ptr()


def split_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least n zeroed int32 arrival counters on `device`, for the split-K
    kernels (kernels 4, 5, 7 and 8): the last block of each tile leaves its
    counter at 0 again, so one buffer serves every launch on the stream."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def stream() -> int:
    """PyTorch's current CUDA stream, where every kernel launches."""
    return torch.cuda.current_stream().cuda_stream
