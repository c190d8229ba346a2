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
