"""Model hyper-parameters (port of ``llama_kotlin_tpu/models/config.py``):
the ModelConfig fields the llama family's unrolled path reads, with the
same defaults, ``attn_scale`` and ``rope_params``."""

from __future__ import annotations

from dataclasses import dataclass

from llama_kotlin_tpu_torch.ops.rope import ROPE_TYPE_NORM, RopeParams


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
    head_dim: int = 0  # 0 -> n_embd // n_head
    n_ctx_train: int = 2048
    rms_eps: float = 1e-5
    norm_weight_offset: float = 0.0
    act: str = "silu"
    rope_type: int = ROPE_TYPE_NORM
    rope_freq_base: float = 10000.0
    rope_freq_scale: float = 1.0
    rope_dim: int = 0  # 0 -> head_dim
    rope_yarn_ext_factor: float = 0.0
    rope_yarn_attn_factor: float = 1.0
    rope_yarn_beta_fast: float = 32.0
    rope_yarn_beta_slow: float = 1.0
    rope_orig_ctx: int = 0
    causal_attn: bool = True
    attn_logit_softcap: float = 0.0

    def __post_init__(self):
        if self.head_dim == 0:
            self.head_dim = self.n_embd // self.n_head
        if self.rope_dim == 0:
            self.rope_dim = self.head_dim

    @property
    def attn_scale(self) -> float:
        return 1.0 / (self.head_dim ** 0.5)

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


def _scalar(md: dict, key: str, default: int) -> int:
    v = md.get(key)
    if v is None:
        return default
    if isinstance(v, (list, tuple)) or getattr(v, "ndim", 0) == 1:
        raise NotImplementedError(f"{key}: per-layer values (openelm) come with slice 5")
    return int(v)


def config_from_metadata(md: dict) -> ModelConfig:
    """ModelConfig from GGUF metadata KVs (port of the JAX package's
    config_from_metadata for ``general.architecture == "llama"``, rope
    scaling included).  Other architectures, and llama-arch MoE files, raise
    until slice 5 ports them."""
    arch = md.get("general.architecture", "llama")
    if arch != "llama":
        raise NotImplementedError(f"architecture {arch!r} comes with slice 5; "
                                  "the port loads llama only")
    if int(_get(md, arch, "expert_count", 0) or 0):
        raise NotImplementedError("llama-architecture MoE files come with slice 5")
    n_embd = int(_get(md, arch, "embedding_length", 4096))
    n_head = _scalar(md, f"{arch}.attention.head_count", 32) or 1
    cfg = ModelConfig(
        arch=arch,
        name=str(md.get("general.name", "")),
        n_embd=n_embd,
        n_layer=int(_get(md, arch, "block_count", 32)),
        n_head=n_head,
        n_head_kv=_scalar(md, f"{arch}.attention.head_count_kv", n_head) or n_head,
        n_ff=_scalar(md, f"{arch}.feed_forward_length", 4 * n_embd),
        head_dim=int(_get(md, arch, "attention.key_length", 0) or 0),
        n_ctx_train=int(_get(md, arch, "context_length", 2048)),
        rms_eps=float(_get(md, arch, "attention.layer_norm_rms_epsilon", 1e-5)),
        rope_freq_base=float(_get(md, arch, "rope.freq_base", 10000.0)),
        rope_dim=int(_get(md, arch, "rope.dimension_count", 0) or 0),
    )
    v_dim = int(_get(md, arch, "attention.value_length", 0) or 0)
    if v_dim and v_dim != cfg.head_dim:
        raise NotImplementedError("a value head width other than the key's is not ported")
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
    return cfg
