"""Architecture registry (port of ``llama_kotlin_tpu/models/registry.py``):
the JAX package's table of the reference's architectures, each with its
status there and whether the port loads it: the llama family that JAX
serves through ``models/llama.py`` (llama, gemma, gemma2, deepseek2, the
llama-shaped RMS and LayerNorm architectures, and the learned-position and
LayerNorm-gelu family: gpt2, starcoder, gptneox, falcon, mpt, phi2, bloom,
jais, nemotron, chatglm; the large MoEs dbrx, arctic and grok; the
per-layer openelm and bitnet).  ``models/config.py::
config_from_metadata`` raises for every architecture this table does not
mark ported (ROADMAP.md section 1, item 13).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ArchInfo:
    name: str
    status: str  # the JAX package's: "supported" | "planned" | "out-of-scope"
    ported: bool  # loaded and served by the port
    notes: str = ""


ARCHES = [
    ArchInfo("llama", "supported", True,
             "LLaMA 1/2/3, Mistral, TinyLlama; rope freq-factors; MoE (Mixtral)"),
    ArchInfo("gemma", "supported", True,
             "gelu, embd scale sqrt(E), (1+w) norms, tied head"),
    ArchInfo("gemma2", "supported", True,
             "logit softcaps, pre/post-ffn norms, alternating SWA"),
    ArchInfo("qwen2", "supported", True,
             "qkv bias, NEOX rope"),
    ArchInfo("qwen2moe", "supported", True,
             "shared expert + sigmoid gate, raw top-k probs"),
    ArchInfo("stablelm", "supported", True,
             "qkv bias, NEOX rope, partial rotary via rope_dim"),
    ArchInfo("phi3", "supported", True,
             "NEOX rope, SWA; fused qkv split at load"),
    ArchInfo("internlm2", "supported", True,
             "llama-shaped"),
    ArchInfo("minicpm", "supported", True,
             "llama-shaped + scale factors"),
    ArchInfo("command-r", "supported", True,
             "parallel block, per-head qk LayerNorm, logit scale"),
    ArchInfo("deepseek2", "supported", True,
             "MLA (q/kv LoRA latents, split k/v dims), yarn mscale, scaled MoE + shared expert"),
    ArchInfo("falcon", "supported", True,
             "LayerNorm, dual norms (40B), parallel residual, GQA"),
    ArchInfo("gpt2", "supported", True,
             "LayerNorm, learned positions, fused qkv split at load"),
    ArchInfo("gptneox", "supported", True,
             "LayerNorm, parallel residual, partial rope"),
    ArchInfo("mpt", "supported", True,
             "ALiBi attention, LayerNorm, fused qkv"),
    ArchInfo("starcoder", "supported", True,
             "MQA, LayerNorm, learned positions"),
    ArchInfo("phi2", "supported", True,
             "parallel residual w/ shared norm, partial rope, output bias"),
    ArchInfo("bloom", "supported", True,
             "embedding LayerNorm, ALiBi, per-head fused qkv"),
    ArchInfo("starcoder2", "supported", True,
             "llama-shaped with biases"),
    ArchInfo("olmo", "supported", True,
             "non-parametric LayerNorm, clamp_kqv"),
    ArchInfo("chatglm", "supported", True,
             "fused qkv+bias, packed swiglu, half-dim rope"),
    ArchInfo("nemotron", "supported", True,
             "LayerNorm1P (+1 folded at convert), relu^2 FFN, partial rope"),
    ArchInfo("exaone", "supported", True,
             "llama-shaped, own metadata namespace"),
    ArchInfo("jais", "supported", True,
             "LayerNorm + ALiBi + biased gated swiglu"),
    ArchInfo("xverse", "supported", True,
             "llama-shaped"),
    ArchInfo("orion", "supported", True,
             "biased LayerNorm, llama-shaped otherwise"),
    ArchInfo("plamo", "supported", True,
             "shared-norm parallel residual"),
    ArchInfo("baichuan", "supported", True,
             "7B llama-shaped; 13B ALiBi (by layer count)"),
    ArchInfo("qwen", "supported", True,
             "fused qkv+bias, NEOX rope, rms"),
    ArchInfo("refact", "supported", True,
             "RMS norms + ALiBi, no rope"),
    ArchInfo("dbrx", "supported", True,
             "biasless LayerNorm, clamped fused qkv, normalized-top-k MoE"),
    ArchInfo("arctic", "supported", True,
             "dense FFN + parallel MoE branch (ffn_norm_exps)"),
    ArchInfo("codeshell", "supported", True,
             "LayerNorm+bias, gelu FFN, NEOX partial rope"),
    ArchInfo("grok", "supported", True,
             "scaled embd/logits, 30-softcap attention, gelu MoE, pre-residual out-norms"),
    ArchInfo("bert", "supported", False,
             "encoder-only: bidirectional post-norm blocks, token types, WPM tokenizer"),
    ArchInfo("openelm", "supported", True,
             "per-layer head/kv/ff arrays, fused qkv, per-head qk RMS norm, tied output"),
    ArchInfo("nomic-bert", "supported", False,
             "rope encoder, gated silu FFN"),
    ArchInfo("jina-bert-v2", "supported", False,
             "bidirectional ALiBi, gated gelu, mid-block re-norm"),
    ArchInfo("t5", "supported", False,
             "enc-dec: relative-position buckets, unscaled attention, cross-attention "
             "(models/t5.py T5Context)"),
    ArchInfo("t5encoder", "supported", False,
             "encoder-only t5 via the same loader/encode path"),
    ArchInfo("mamba", "supported", False,
             "selective SSM via lax.scan, recurrent-state MambaContext (models/mamba.py)"),
    ArchInfo("bitnet", "supported", True,
             "per-projection scalar scales, attn/ffn sub-norms, tied head"),
]


def support_status(arch: str) -> str:
    """The JAX package's status of `arch` ("unknown" if absent)."""
    return next((a.status for a in ARCHES if a.name == arch), "unknown")


def is_ported(arch: str) -> bool:
    """Whether the port loads `arch`."""
    return any(a.name == arch and a.ported for a in ARCHES)
