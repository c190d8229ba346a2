"""Model hyper-parameters (port of ``llama_kotlin_tpu/models/config.py``):
the ModelConfig fields the port's forward reads, with the same defaults,
``attn_scale`` (with deepseek2's YaRN mscale correction) and
``rope_params``.  ``config_from_metadata`` maps the architectures
``models/registry.py`` marks ported, by JAX's branches: the llama
architecture and llama-architecture MoE files (Mixtral), gemma and gemma2
(gelu, the sqrt(n_embd) embedding scale, (1 + w) norms, a tied head, NEOX
rope; gemma2 also the logit softcaps and the sliding window on every other
layer), deepseek2 (MLA and scaled MoE), the llama-shaped family JAX
serves through the same decoder: qwen2 and qwen2moe (qkv biases, raw top-k
router weights), qwen, stablelm, phi3, internlm2, minicpm, xverse, exaone,
baichuan (ALiBi at 40 layers and more), starcoder2, refact (ALiBi), plamo
(shared-norm parallel residual), and the LayerNorm ones orion, command-r
(parallel block, logit scale), olmo (non-parametric, clamp_kqv) and
codeshell (non-gated gelu FFN); and the learned-position and LayerNorm-gelu
family: gpt2 and starcoder (learned positions, no rope), gptneox
(use_parallel_residual), falcon and phi2 (the parallel block; phi2's qkv
biases), mpt and bloom (ALiBi; bloom's embedding LayerNorm), jais (ALiBi,
a biased gated silu FFN), nemotron (relu^2) and chatglm (packed swiglu);
and the large MoEs and the per-layer architectures: dbrx (biasless
LayerNorm, q/k/v clamping, NEOX rope), grok (the embedding and logit
scales, the attention softcap 30, gelu experts, NEOX rope), arctic (its
MoE fields only), openelm (NEOX rope, a tied head, per-layer head, kv-head
and FFN counts: ``n_head_arr``, ``n_head_kv_arr``, ``n_ff_arr``, with the
maximum in the scalar fields, read through ``layer_n_head``,
``layer_n_head_kv`` and ``layer_n_ff``) and bitnet (NEOX rope).  Every
other architecture raises (ROADMAP.md section 1, item 13, lists them)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from llama_kotlin_tpu_torch.models import registry
from llama_kotlin_tpu_torch.ops.rope import (ROPE_TYPE_NEOX, ROPE_TYPE_NONE, ROPE_TYPE_NORM,
                                             RopeParams)


@dataclass(eq=False)
class ModelConfig:
    arch: str = "llama"
    name: str = ""
    vocab_size: int = 32000
    n_embd: int = 4096
    n_layer: int = 32
    n_head: int = 32
    n_head_kv: int = 32
    n_ff: int = 11008
    head_dim: int = 0  # 0 -> n_embd // n_head (the q/k head dim)
    v_head_dim: int = 0  # 0 -> head_dim (deepseek2 MLA: k 192, v 128)
    n_ctx_train: int = 2048
    rms_eps: float = 1e-5
    norm_eps: float = 1e-5  # LayerNorm's epsilon
    use_rms_norm: bool = True  # False: LayerNorm (orion, command-r, olmo, the gpt2 family...)
    norm_weight_offset: float = 0.0
    act: str = "silu"
    ffn_gated: bool = True  # False: up, act, down (codeshell, the gpt2 family)
    rope_type: int = ROPE_TYPE_NORM
    rope_freq_base: float = 10000.0
    rope_freq_scale: float = 1.0
    rope_dim: int = 0  # 0 -> head_dim
    rope_yarn_ext_factor: float = 0.0
    rope_yarn_attn_factor: float = 1.0
    rope_yarn_beta_fast: float = 32.0
    rope_yarn_beta_slow: float = 1.0
    rope_orig_ctx: int = 0
    n_expert: int = 0
    n_expert_used: int = 0
    causal_attn: bool = True
    embd_scale: float = 1.0  # gemma: sqrt(n_embd)
    attn_logit_softcap: float = 0.0  # gemma2
    final_logit_softcap: float = 0.0  # gemma2
    swa_window: int = 0  # sliding-window attention width (0 = off)
    swa_pattern: int = 1  # every Nth layer is full-attention (gemma2: 2)
    attn_qkv_bias: bool = False  # the file carries q/k/v biases (qwen2, qwen2moe, stablelm)
    tie_word_embeddings: bool = False
    parallel_residual: bool = False  # h + attn(x) + ffn(x') (plamo, command-r, falcon...)
    clamp_kqv: float = 0.0  # olmo: q, k and v clipped to +-clamp_kqv (0 = off)
    logit_scale: float = 1.0  # command-r's final logit multiplier
    moe_norm_topk: bool = True  # renormalize the top-k router weights (mixtral; not qwen2moe)
    moe_expert_scale: float = 1.0  # deepseek2 expert_weights_scale
    rope_yarn_log_mul: float = 0.0  # deepseek2 yarn mscale correction
    max_alibi_bias: float = 0.0  # ALiBi in place of rope (baichuan-13B, refact, mpt...); 0 = off
    learned_pos_embd: bool = False  # a position embedding table (gpt2, starcoder)
    token_embd_norm: bool = False  # a LayerNorm right after the embedding (bloom)
    swiglu_packed: bool = False  # chatglm: ffn_up packs [gate|up], silu-gated
    # openelm's per-layer counts (JAX config.py:75-80); None: uniform, the
    # scalars.  The scalar fields then hold the maximum, which sizes the cache
    n_head_arr: Optional[tuple[int, ...]] = None
    n_head_kv_arr: Optional[tuple[int, ...]] = None
    n_ff_arr: Optional[tuple[int, ...]] = None

    def __post_init__(self):
        if self.head_dim == 0:
            self.head_dim = self.n_embd // self.n_head
        if self.v_head_dim == 0:
            self.v_head_dim = self.head_dim
        if self.rope_dim == 0:
            self.rope_dim = self.head_dim

    @property
    def attn_scale(self) -> float:
        if self.rope_yarn_log_mul and self.rope_freq_scale != 1.0:
            # deepseek2's YaRN mscale squared (JAX config.py:91-100)
            mscale = 1.0 + self.rope_yarn_log_mul * math.log(1.0 / self.rope_freq_scale)
            return mscale * mscale / (self.head_dim ** 0.5)
        return 1.0 / (self.head_dim ** 0.5)

    def layer_n_head(self, layer: int) -> int:
        return self.n_head_arr[layer] if self.n_head_arr else self.n_head

    def layer_n_head_kv(self, layer: int) -> int:
        return self.n_head_kv_arr[layer] if self.n_head_kv_arr else self.n_head_kv

    def layer_n_ff(self, layer: int) -> int:
        return self.n_ff_arr[layer] if self.n_ff_arr else self.n_ff

    @property
    def per_layer_shapes(self) -> bool:
        """Whether any layer's head, kv-head or FFN count is its own (openelm)."""
        return bool(self.n_head_arr or self.n_head_kv_arr or self.n_ff_arr)

    def layer_swa_window(self, layer: int) -> int:
        """Layer `layer`'s sliding window (0: full attention)."""
        if self.swa_window <= 0:
            return 0
        if self.swa_pattern > 1 and (layer + 1) % self.swa_pattern == 0:
            return 0
        return self.swa_window

    def rope_params(self) -> RopeParams:
        return RopeParams(
            n_rot=self.rope_dim,
            rope_type=self.rope_type,
            freq_base=self.rope_freq_base,
            freq_scale=self.rope_freq_scale,
            ext_factor=self.rope_yarn_ext_factor,
            attn_factor=self.rope_yarn_attn_factor,
            beta_fast=self.rope_yarn_beta_fast,
            beta_slow=self.rope_yarn_beta_slow,
            n_ctx_orig=self.rope_orig_ctx or self.n_ctx_train,
        )


def _get(md: dict, arch: str, key: str, default=None):
    v = md.get(f"{arch}.{key}", default)
    return v.item() if hasattr(v, "item") else v


def _scalar_or_arr(v, default: int) -> tuple[int, Optional[tuple[int, ...]]]:
    """A head or FFN count that may be a per-layer array (openelm; JAX
    ``config.py:148-157``): (the maximum, the array or None)."""
    if v is None:
        return default, None
    if isinstance(v, (list, tuple)) or getattr(v, "ndim", 0) == 1:
        arr = tuple(int(x) for x in v)
        return max(arr), arr
    return int(v), None


# the architectures config_from_metadata maps: models/registry.py's ported rows
ARCHES = tuple(a.name for a in registry.ARCHES if a.ported)


def config_from_metadata(md: dict) -> ModelConfig:
    """ModelConfig from GGUF metadata KVs (port of the JAX package's
    config_from_metadata for the architectures in ARCHES, rope scaling
    included).  Other architectures raise until ROADMAP.md section 1, item
    13 ports them."""
    arch = md.get("general.architecture", "llama")
    if arch not in ARCHES:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported: the port loads {', '.join(ARCHES)}; the "
            "encoders, t5, mamba and vision come with ROADMAP.md section 1, item 13")
    n_embd = int(_get(md, arch, "embedding_length", 4096))
    n_head, n_head_arr = _scalar_or_arr(md.get(f"{arch}.attention.head_count"), 32)
    n_head = n_head or 1
    n_head_kv, n_head_kv_arr = _scalar_or_arr(md.get(f"{arch}.attention.head_count_kv"), n_head)
    n_ff, n_ff_arr = _scalar_or_arr(md.get(f"{arch}.feed_forward_length"), 4 * n_embd)
    cfg = ModelConfig(
        arch=arch,
        name=str(md.get("general.name", "")),
        n_embd=n_embd,
        n_layer=int(_get(md, arch, "block_count", 32)),
        n_head=n_head,
        n_head_kv=n_head_kv or n_head,
        n_ff=n_ff,
        n_head_arr=n_head_arr,
        n_head_kv_arr=n_head_kv_arr,
        n_ff_arr=n_ff_arr,
        head_dim=int(_get(md, arch, "attention.key_length", 0) or 0),
        v_head_dim=int(_get(md, arch, "attention.value_length", 0) or 0),
        n_ctx_train=int(_get(md, arch, "context_length", 2048)),
        rms_eps=float(_get(md, arch, "attention.layer_norm_rms_epsilon", 1e-5)),
        norm_eps=float(_get(md, arch, "attention.layer_norm_epsilon", 1e-5)),
        rope_freq_base=float(_get(md, arch, "rope.freq_base", 10000.0)),
        rope_dim=int(_get(md, arch, "rope.dimension_count", 0) or 0),
        n_expert=int(_get(md, arch, "expert_count", 0) or 0),
        n_expert_used=int(_get(md, arch, "expert_used_count", 0) or 0),
        swa_window=int(_get(md, arch, "attention.sliding_window", 0) or 0),
    )
    if arch == "llama" and cfg.v_head_dim != cfg.head_dim:
        raise NotImplementedError("a llama file whose value head width differs from the "
                                  "key's is not ported")
    vs = _get(md, arch, "vocab_size", None)
    if vs is None:
        toks = md.get("tokenizer.ggml.tokens")
        vs = len(toks) if toks is not None else 32000
    cfg.vocab_size = int(vs)
    # rope scaling (legacy files carry {arch}.rope.scale_linear)
    scaling = _get(md, arch, "rope.scaling.type", "") or ""
    factor = _get(md, arch, "rope.scaling.factor", None)
    legacy_linear = _get(md, arch, "rope.scale_linear", None)
    if not scaling and not factor and legacy_linear:
        scaling, factor = "linear", legacy_linear
    if scaling == "linear" and factor:
        cfg.rope_freq_scale = 1.0 / float(factor)
    elif scaling == "yarn" and factor:
        cfg.rope_freq_scale = 1.0 / float(factor)
        cfg.rope_yarn_ext_factor = 1.0
        cfg.rope_orig_ctx = int(
            _get(md, arch, "rope.scaling.original_context_length", cfg.n_ctx_train))
    # JAX config.py:219-223: the NEOX archs among the ported ones (the
    # others rotate adjacent pairs, or take no rope below)
    if arch in ("falcon", "gptneox", "qwen2", "qwen2moe", "phi2", "phi3", "stablelm", "gemma",
                "gemma2", "starcoder2", "nemotron", "exaone", "qwen", "codeshell", "dbrx",
                "grok", "openelm", "bitnet"):
        cfg.rope_type = ROPE_TYPE_NEOX
    if arch == "openelm":
        cfg.tie_word_embeddings = True  # JAX config.py:224-228: the head is token_embd
    if arch in ("gemma", "gemma2"):
        # JAX config.py:229-234: gelu, the embedding scale, (1 + w) norms,
        # a tied head
        cfg.act = "gelu"
        cfg.embd_scale = float(n_embd) ** 0.5
        cfg.norm_weight_offset = 1.0
        cfg.tie_word_embeddings = True
    if arch == "gemma2":
        cfg.attn_logit_softcap = float(_get(md, arch, "attn_logit_softcapping", 50.0))
        cfg.final_logit_softcap = float(_get(md, arch, "final_logit_softcapping", 30.0))
        cfg.swa_window = cfg.swa_window or 4096
        cfg.swa_pattern = 2
    if arch in ("qwen2", "qwen2moe", "stablelm", "phi2"):
        cfg.attn_qkv_bias = True  # JAX config.py:239-240
    # JAX config.py:242-261: the LayerNorm-gelu family (non-gated FFNs), no
    # rope where positions are learned or ALiBi biases the scores, the
    # embedding norm, the parallel blocks
    if arch in ("gpt2", "gptneox", "falcon", "mpt", "starcoder", "phi2", "bloom"):
        cfg.use_rms_norm = False
        cfg.act = "gelu"
        cfg.ffn_gated = False
    if arch in ("gpt2", "starcoder", "mpt", "bloom", "jais"):
        cfg.rope_type = ROPE_TYPE_NONE
    if arch in ("gpt2", "starcoder"):
        cfg.learned_pos_embd = True
    if arch in ("mpt", "bloom", "jais"):
        cfg.max_alibi_bias = float(_get(md, arch, "attention.max_alibi_bias", 8.0) or 8.0)
    if arch == "bloom":
        cfg.token_embd_norm = True
    if arch == "gptneox":
        cfg.parallel_residual = bool(_get(md, arch, "use_parallel_residual", True))
    if arch in ("falcon", "phi2"):
        cfg.parallel_residual = True
    if arch == "command-r":
        # JAX config.py:262-268: LayerNorm without bias, the shared-norm
        # parallel block, a tied head, scaled logits
        cfg.use_rms_norm = False
        cfg.parallel_residual = True
        cfg.tie_word_embeddings = True
        cfg.logit_scale = float(_get(md, arch, "logit_scale", 1.0) or 1.0)
    if arch == "qwen2moe":
        cfg.moe_norm_topk = False  # JAX config.py:269-270: raw top-k probabilities
    if arch == "olmo":
        # JAX config.py:311-314: non-parametric LayerNorm, q/k/v clipping
        cfg.use_rms_norm = False
        cfg.clamp_kqv = float(_get(md, arch, "attention.clamp_kqv", 0.0) or 0.0)
    if arch == "chatglm":
        # JAX config.py:315-317: ffn_up packs [gate|up], silu-gated
        cfg.ffn_gated = False
        cfg.swiglu_packed = True
    if arch == "nemotron":
        # JAX config.py:318-321: LayerNorm (the file stores 1 + w), relu^2
        cfg.use_rms_norm = False
        cfg.act = "relu2"
        cfg.ffn_gated = False
    if arch == "orion":
        cfg.use_rms_norm = False  # biased LayerNorm, llama-shaped otherwise
    if arch == "plamo":
        cfg.parallel_residual = True  # one attn_norm feeds attention and FFN
    if arch == "baichuan" and cfg.n_layer >= 40:
        # JAX config.py:326-329: baichuan-13B attends with ALiBi, no rope
        cfg.rope_type = ROPE_TYPE_NONE
        cfg.max_alibi_bias = 8.0
    if arch == "jais":
        cfg.use_rms_norm = False  # JAX config.py:330-334 (ALiBi above)
    if arch == "grok":
        # JAX config.py:335-341: scaled embedding and logits, the attention
        # softcap 30 (on scores already scaled by 1/sqrt(head_dim)), gelu
        cfg.embd_scale = 78.38367176906169
        cfg.logit_scale = 0.5773502691896257
        cfg.attn_logit_softcap = 30.0
        cfg.act = "gelu"
    if arch == "codeshell":
        # JAX config.py:342-345: LayerNorm, a non-gated gelu FFN
        cfg.use_rms_norm = False
        cfg.act = "gelu"
        cfg.ffn_gated = False
    if arch == "dbrx":
        # JAX config.py:346-348: LayerNorm without biases, q/k/v clipping
        cfg.use_rms_norm = False
        cfg.clamp_kqv = float(_get(md, arch, "attention.clamp_kqv", 0.0) or 0.0)
    if arch == "refact":
        # JAX config.py:349-351: ALiBi with RMS norms, no rope
        cfg.rope_type = ROPE_TYPE_NONE
        cfg.max_alibi_bias = 8.0
    if arch == "deepseek2":
        # MLA and scaled MoE (JAX config.py:352-369): raw top-k router
        # weights times expert_weights_scale, the YaRN mscale correction,
        # rope on the last rope_dim of each qk head
        cfg.moe_norm_topk = False
        cfg.moe_expert_scale = float(_get(md, arch, "expert_weights_scale", 1.0) or 1.0)
        cfg.rope_yarn_log_mul = float(
            _get(md, arch, "rope.scaling.yarn_log_multiplier", 0.0) or 0.0)
        if cfg.rope_freq_scale != 1.0:
            # the pre-scaled rope attn factor (build_deepseek2's attn_factor_scaled)
            cfg.rope_yarn_attn_factor = 1.0 / (1.0 + 0.1 * math.log(1.0 / cfg.rope_freq_scale))
        cfg.rope_dim = int(_get(md, arch, "rope.dimension_count", 64) or 64)
    return cfg
