"""Llama-family decoder, unrolled path (port of
``llama_kotlin_tpu/models/llama.py::forward``).

One ubatch step over a flat token list: each token carries (pos, seq) and
a cache slot, attention visibility comes from the cell metadata
(``ops/attention.py``), and every layer writes its K/V rows into the cache
IN PLACE before attending over it.  Weights are W4 folds; the matmuls go
through ``ops/qmatmul.py`` and so through the port's kernels.  The
params are in the serving layout (``wqkv_fused``, ``ffn_gateup_fused``,
an untied ``output``); the unfused layouts of real checkpoints come with
the GGUF loader.

Padded rows of a bucket carry a slot past the real cells: the context gives
the cache one scratch cell there (the JAX forward drops those writes with
``mode="drop"``; a CUDA index out of range would fault instead).
"""

from __future__ import annotations

import torch

from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.ops.activations import ACTIVATIONS
from llama_kotlin_tpu_torch.ops.attention import visibility_mask
from llama_kotlin_tpu_torch.ops.cuda.flash import flash_attention
from llama_kotlin_tpu_torch.ops.norms import rms_norm
from llama_kotlin_tpu_torch.ops.qmatmul import qmatmul, qmm_ffn, take_rows
from llama_kotlin_tpu_torch.ops.rope import rope_cos_sin, rotate
from llama_kotlin_tpu_torch.runtime.kv_cache import KVCache

# Activations between the kernels and the KV cache are bf16: kernel 3 takes
# bf16 q/k/v only, so this is no setting until a kernel takes a second dtype.
COMPUTE_DTYPE = torch.bfloat16


def _qkv(lp: dict, x: torch.Tensor, cfg: ModelConfig):
    nt = x.shape[0]
    qd = cfg.n_head * cfg.head_dim
    kvd = cfg.n_head_kv * cfg.head_dim
    y = qmatmul(x, lp["wqkv_fused"])
    q, k, v = y[:, :qd], y[:, qd:qd + kvd], y[:, qd + kvd:]
    return (q.reshape(nt, cfg.n_head, cfg.head_dim),
            k.reshape(nt, cfg.n_head_kv, cfg.head_dim),
            v.reshape(nt, cfg.n_head_kv, cfg.head_dim))


def _ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated FFN: kernel 2 for decode rows, else gate|up and down matmuls."""
    down = qmm_ffn(x, lp["ffn_gateup_fused"], lp["ffn_down"], act=cfg.act)
    if down is not None:
        return down
    y = qmatmul(x, lp["ffn_gateup_fused"])
    gate, up = y[:, :cfg.n_ff], y[:, cfg.n_ff:]
    return qmatmul((ACTIVATIONS[cfg.act](gate) * up).to(COMPUTE_DTYPE), lp["ffn_down"])


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            token_pos: torch.Tensor, token_seq: torch.Tensor, slots: torch.Tensor,
            cache: KVCache, cell_pos: torch.Tensor, cell_seq: torch.Tensor,
            out_ids: torch.Tensor):
    """One ubatch step.  Returns (logits [n_out, vocab] f32, final-norm
    hidden states [n_out, n_embd] f32); the cache is updated in place.

    cell_pos/cell_seq [n_vis] must already hold the inserted tokens; their
    length is the attended cell prefix."""
    nt = tokens.shape[0]
    rope = cfg.rope_params()
    cos, sin = rope_cos_sin(token_pos, rope, params.get("rope_freqs"))
    h = take_rows(params["tok_embd"], tokens, dtype=COMPUTE_DTYPE)
    mask = visibility_mask(token_pos, token_seq, cell_pos, cell_seq,
                           causal=cfg.causal_attn).to(torch.int8)
    slots = slots.to(torch.long)
    for li, lp in enumerate(params["layers"]):
        x = rms_norm(h, lp["attn_norm"], cfg.rms_eps, cfg.norm_weight_offset)
        q, k, v = _qkv(lp, x, cfg)
        q = rotate(q, cos, sin, rope)
        k = rotate(k, cos, sin, rope)
        # in-place cache write: rows [KV, nt, D] into cells `slots` of layer li
        cache.k[li].index_copy_(1, slots, k.transpose(0, 1).to(cache.k.dtype))
        cache.v[li].index_copy_(1, slots, v.transpose(0, 1).to(cache.v.dtype))
        attn = flash_attention(q.to(COMPUTE_DTYPE), cache.k, cache.v, mask,
                               scale=cfg.attn_scale, logit_softcap=cfg.attn_logit_softcap,
                               layer=li)
        attn = attn.to(COMPUTE_DTYPE).reshape(nt, -1)
        h = h + qmatmul(attn, lp["wo"]).to(h.dtype)
        x = rms_norm(h, lp["ffn_norm"], cfg.rms_eps, cfg.norm_weight_offset)
        h = h + _ffn(lp, x, cfg).to(h.dtype)
    h_out = rms_norm(h[out_ids.to(torch.long)], params["output_norm"], cfg.rms_eps,
                     cfg.norm_weight_offset)
    logits = qmatmul(h_out, params["output"]).to(torch.float32)
    return logits, h_out.to(torch.float32)
