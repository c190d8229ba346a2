"""The port's copy of ``llama_kotlin_tpu/sampling/``.

Sampling stack: the full llama.cpp-parity sampler chain (host-side
numpy; the latency-critical greedy/temp/top-k path also exists on-device in
runtime/generate.py), GBNF grammar constraints, and JSON-schema->grammar."""

from llama_kotlin_tpu_torch.sampling.samplers import SamplingParams, SamplerChain  # noqa: F401
