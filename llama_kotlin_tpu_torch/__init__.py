"""llama_kotlin_tpu_torch — the PyTorch/CUDA port of llama_kotlin_tpu.

The serving path of the JAX package (llama-family decoder, W4A8 weights,
bf16 cell cache, prefill through ``LlamaContext.decode`` and greedy
decode) rebuilt on PyTorch, with every Pallas kernel on that path written
again by hand in CUDA C++ for Hopper (``csrc/``, bound with ctypes by
``ops/cuda/_build.py``).  Module names mirror the JAX package so each
counterpart is easy to find.

The package imports neither ``jax`` nor ``llama_kotlin_tpu``: what it
needs from the JAX package's framework-free modules it keeps as its own
copy.  Entry points run on the GPU unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper runs its plain PyTorch
version instead (see ``device.py``).
"""

__version__ = "0.1.0"
