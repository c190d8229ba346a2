"""Llama-family decoder (port of ``llama_kotlin_tpu/models/llama.py::
forward``): the unrolled path and the stacked-layer path.

One ubatch step over a flat token list: each token carries (pos, seq) and
a cache slot, and attention visibility comes from the cell metadata
(``ops/attention.py``).  Weights are W4 or W8 folds, Q8F tensors or dense
bf16 matrices; the matmuls go through ``ops/qmatmul.py`` and so through
the port's kernels (a dense matrix through a plain matmul, as in JAX).
Projections come fused (``wqkv_fused``, ``ffn_gateup_fused``) or split
(``wq``/``wk``/``wv``, ``ffn_gate``/``ffn_up``), as ``models/loader.py``
leaves them; a missing ``output`` ties to ``tok_embd``.

deepseek2 (JAX ``:159-193``, ``_qkv_mla``): multi-head latent attention, q
through an optional LoRA bottleneck (``wq_a``, its norm, ``wq_b``; the
Lite model has one ``wq``), k and v decompressed from a shared latent
(``wkv_a_mqa``, its norm, ``wkv_b``), rope on the last rope_dim of each
192-wide qk head and on the one rope key all heads share; the cache holds K
192 and V 128 wide, and kernel 3 attends at (192, 128).  MoE layers
(``ffn_gate_inp``; JAX ``:306-387``, ``_moe_ffn``): the router's top-k, then
the routed FFN by one of three routes (``ops/moe.py``) and the shared
experts (``ffn_*_shexp``).

gemma and gemma2 (JAX ``:108-109``, ``:121-127``, ``:283-285``,
``:443-444``, ``:665-667``, ``:706-707``): the embedding rows times
sqrt(n_embd) (bf16 rows, an f32 product, bf16 again), (1 + w) norms, a tied
head, and for gemma2 the post-attention and post-FFN norms, the attention
softcap (inside kernel 3), the final softcap tanh(logits / c) c, and a
sliding-window mask on every other layer (``cfg.layer_swa_window``): the
window reaches kernel 3 only through the mask, whose out-of-window tiles
the kernel skips.  A model with a window stays unrolled, as in JAX.  At
head dim 256 kernel 3 takes its D = 256 branch; kernel 9 takes 64 and 128
only (JAX's declines 256), so a stacked gemma attends by
``attend_stacked_plain``.

The llama-shaped family (JAX ``:142-149``, ``:195-247``, ``:255-444``,
``:700-707``): a norm that is RMSNorm or LayerNorm (biased, or
non-parametric where the file has no weight: olmo; ``_norm``); q/k/v
biases (one add over a fused q|k|v) and o, up and down biases;
olmo's clamp of q, k and v; per-head q/k norms; the shared-norm parallel
block (plamo, command-r: the FFN reads the layer's input, normed by its
ffn_norm or by the attention's norm); a non-gated FFN (codeshell, or a file
with no ffn_gate); qwen2moe's raw top-k weights and sigmoid-gated shared
expert; command-r's logit scale.  Where JAX's flash
kernel declines by its static predicate (``ops/attention.py::
flash_declines``: ALiBi, or a head dim outside {64, 128, 192, 256}), the
unrolled path attends by ``cache_attention_reference`` on every device,
with ALiBi's bias there (refact, baichuan-13B); ALiBi keeps a model
unrolled, as in JAX.

The learned-position and LayerNorm-gelu family (JAX ``:110-118``,
``:150-157``, ``:292-295``, ``:403-438``, ``:702-703``): the position table's
rows added to the embedding at max(pos, 0) (gpt2, starcoder; a position
past the table takes its last row, as XLA's clamped gather does); bloom's
LayerNorm of the embedding; attention normed by ``attn_norm_2`` where a
layer has it (falcon-40b), ``attn_norm`` then feeding the parallel FFN;
jais's gate bias on the split gated route (kernel 2 declines it, as JAX's
megakernel); chatglm's packed ``[gate|up]`` up projection, silu(gate) *
up; nemotron's relu^2; phi2's output bias, added to the logits before any
logit scale.  mpt, bloom and jais attend with ALiBi by the plain route, as
refact does; learned positions stack.

The large MoEs and the per-layer architectures (JAX ``:39-50``,
``:194-245``, ``:246-300``, ``:385-388``, ``:403-453``, ``:659-672``): dbrx's
pre-FFN norm is its ``attn_out_norm`` (a biasless LayerNorm) and its q, k
and v are clipped as olmo's; grok's experts are gelu, its out-norms serve
as gemma2's post norms (the MoE output rounded to the residual's dtype
first, as in JAX); arctic runs a MoE branch beside its dense FFN, normed by
``ffn_norm_exps`` from the post-attention residual; bitnet multiplies each
projection by its scale and norms the attention output before ``wo`` and
the gated product before ``down`` (kernel 2 declines such a layer, as
JAX's megakernel); openelm's layers take their own head, kv-head and FFN
counts, so the model stays unrolled, a narrower layer's q, k and v stay
split (and its gate and up where its FFN is narrower than the widest),
and every layer writes and attends over its own first kv heads of a cache
sized at the widest, a contiguous 3-D view kernel 3 takes (JAX's per-layer
slice; the 4-D call with a layer index only where every layer holds the
cache's kv heads).

- Unrolled (``params["layers"]``): every layer writes its K/V rows into the
  cache IN PLACE, then attends over it through kernel 3.
- Stacked (``params["layers_stacked"]``, built once by ``stack_layers``;
  layer i is a view of the stacked tensors): every layer attends over the
  cache as it was before the step through kernel 9, with the step's fresh
  rows merged in by the kernel, then writes its rows.  The JAX package runs
  this path as a ``lax.scan`` and scatters all layers' rows after it; a
  write after each layer's attention leaves the same cache, since kernel 9
  masks out the cells the fresh rows go to.
- Stacked on a packed int4 (q4_0) cache: JAX declines kernel 9 there
  (``llama_kotlin_tpu/models/llama.py:569-573``) and attends by XLA over
  the dequantized prefix and the step's dequantized rows; the port's
  ``attend_stacked_plain`` is that route in plain torch ops, on the card
  too, and also serves a stacked model whose V is narrower than its K or
  whose head dim kernel 9 does not take (256).

The KV cache is bf16, int8 codes or packed int4 codes with per-row scales;
the quantized rows come from the same f32 K/V the JAX package quantizes.
Padded rows of a bucket carry a slot past the real cells: the context
gives the cache one scratch cell there (the JAX forward drops those writes
with ``mode="drop"``; a CUDA index out of range would fault instead).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.ops import moe
from llama_kotlin_tpu_torch.ops.activations import ACTIVATIONS
from llama_kotlin_tpu_torch.ops.attention import (alibi_slopes, attention_reference,
                                                  cache_attention_reference, flash_declines,
                                                  visibility_mask)
from llama_kotlin_tpu_torch.ops.cuda.flash import HEAD_DIMS, flash_attention
from llama_kotlin_tpu_torch.ops.cuda.flash_stacked import flash_attention_stacked
from llama_kotlin_tpu_torch.ops.norms import layer_norm, rms_norm
from llama_kotlin_tpu_torch.ops.qmatmul import qmatmul, qmm_ffn, qmm_layer, take_rows
from llama_kotlin_tpu_torch.ops.rope import rope_cos_sin, rotate
from llama_kotlin_tpu_torch.quant.qtensor import QTensor
from llama_kotlin_tpu_torch.runtime.kv_cache import (KVCache, dequantize_cache_layer,
                                                     quantize_rows, quantize_rows_q4)

# Activations between the kernels and the KV cache are bf16: kernels 3 and 9
# take bf16 q and fresh rows only, so this is no setting until a kernel
# takes a second dtype.
COMPUTE_DTYPE = torch.bfloat16
QT_TENSORS = ("codes", "g_scale", "g_min", "sb_scale", "sb_min")


def can_stack(params: dict, cfg: ModelConfig) -> bool:
    """Layers can share one loop body when uniform in structure: at least
    two layers with the same keys, no sliding window, no ALiBi and no
    per-layer head or FFN counts (the JAX package's rule,
    ``llama_kotlin_tpu/models/llama.py:39-51``).  deepseek2's dense lead
    layer has other keys than its MoE layers, gemma2's windows alternate,
    ALiBi attends by the plain route and openelm's layers differ in shape,
    so those models stay unrolled, as in JAX."""
    layers = params.get("layers")
    if (not layers or len(layers) < 2 or cfg.swa_window > 0
            or cfg.max_alibi_bias > 0 or cfg.per_layer_shapes):
        return False
    keys = set(layers[0])
    return all(set(lp) == keys for lp in layers)


def _stack(xs: list):
    """One leaf of every layer -> the stacked leaf (a list of per-expert
    matrices -> the list of their stacks).  Leaves that differ in anything
    but their values raise ValueError or TypeError, as jnp.stack under
    jax.tree.map does, so the context keeps the unrolled path."""
    x0 = xs[0]
    if any(type(x) is not type(x0) for x in xs):
        raise TypeError("stack_layers: leaves of different types")
    if isinstance(x0, list):
        if any(len(x) != len(x0) for x in xs):
            raise ValueError("stack_layers: expert lists of different lengths")
        return [_stack([x[e] for x in xs]) for e in range(len(x0))]
    if isinstance(x0, torch.Tensor):
        if any(x.shape != x0.shape or x.dtype != x0.dtype or x.device != x0.device for x in xs):
            raise ValueError("stack_layers: tensors of different shapes or types")
        return torch.stack(xs)
    if isinstance(x0, QTensor):
        meta = lambda q: (q.qtype, q.bits, q.group_size, q.code_offset, q.shape, q.hi_signed,
                          q.tp_axis, q.flavor, sorted(q.tensors()))
        if any(meta(x) != meta(x0) for x in xs):
            raise ValueError("stack_layers: QTensors of different layouts")
        fields = {f: _stack([getattr(x, f) for x in xs]) for f in QT_TENSORS
                  if getattr(x0, f) is not None}
        aux = None if x0.aux is None else {
            k: _stack([x.aux[k] for x in xs]) if isinstance(v, torch.Tensor) else v
            for k, v in x0.aux.items()}
        return replace(x0, aux=aux, **fields)
    raise TypeError(f"stack_layers: no rule stacks a {type(x0).__name__}")


def stack_layers(params: dict) -> dict:
    """Stack the per-layer weights along a leading L axis, once: the
    returned params hold ``layers_stacked`` and ``n_layer`` in place of
    ``layers`` and keep no per-layer copy; ``layer_views`` holds each layer
    as views of the stack, built here so that a step pays nothing for them.
    QTensors stack every plane and keep their per-layer ``shape``."""
    layers = params["layers"]
    out = {k: v for k, v in params.items() if k != "layers"}
    stacked = {k: _stack([lp[k] for lp in layers]) for k in layers[0]}
    out["layers_stacked"] = stacked
    out["n_layer"] = len(layers)
    out["layer_views"] = [{k: _layer(v, i) for k, v in stacked.items()}
                          for i in range(len(layers))]
    return out


def _layer(leaf, i: int):
    """Layer i of a stacked leaf (a tensor, a QTensor or a list of them),
    as a view."""
    if isinstance(leaf, list):
        return [_layer(x, i) for x in leaf]
    if isinstance(leaf, torch.Tensor):
        return leaf[i]
    aux = None if leaf.aux is None else {
        k: v[i] if isinstance(v, torch.Tensor) else v for k, v in leaf.aux.items()}
    return replace(leaf, aux=aux, **{f: getattr(leaf, f)[i] for f in QT_TENSORS
                                    if getattr(leaf, f) is not None})


def layer_views(params: dict) -> list[dict]:
    """Per-layer weight dicts: the unrolled list, or views of the stack."""
    return params["layers"] if "layers" in params else params["layer_views"]


def _norm(cfg: ModelConfig, lp: dict, key: str, x: torch.Tensor) -> torch.Tensor:
    """The architecture's norm of x under lp[key] (JAX ``lnorm``,
    ``llama_kotlin_tpu/models/llama.py:142-149``): RMSNorm, or LayerNorm
    with the weight and bias lp holds (no weight: OLMo's non-parametric
    one)."""
    if cfg.use_rms_norm:
        return rms_norm(x, lp[key], cfg.rms_eps, cfg.norm_weight_offset)
    return layer_norm(x, lp.get(key), lp.get(key + "_b"), cfg.norm_eps)


def _qkv(lp: dict, x: torch.Tensor, cfg: ModelConfig, cos: torch.Tensor, sin: torch.Tensor,
         rope, li: int = -1):
    """The attention inputs of layer li: q [nt, H, Dk] bf16 and k [nt, KV,
    Dk], v [nt, KV, Dv] f32, q and k roped (H and KV the layer's own; li
    -1, a stacked layer, the config's)."""
    if "wkv_a_mqa" in lp:
        q, k, v = _qkv_mla(lp, x, cfg, cos, sin, rope)
    else:
        q, k, v = _qkv_gqa(lp, x, cfg, li)
        q, k = rotate(q, cos, sin, rope), rotate(k, cos, sin, rope)
    return q.to(COMPUTE_DTYPE), k, v


def _qkv_mla(lp: dict, x: torch.Tensor, cfg: ModelConfig, cos: torch.Tensor,
             sin: torch.Tensor, rope):
    """deepseek2's multi-head latent attention inputs (JAX ``qkv_mla``):
    the rope tables are the config's (n_rot = rope_dim), turning the last
    rope_dim dims of each qk head and the shared rope key."""
    nt = x.shape[0]
    rope_d, v_dim = cfg.rope_dim, cfg.v_head_dim
    nope = cfg.head_dim - rope_d
    if "wq_a" in lp:  # q LoRA
        q = rms_norm(qmatmul(x, lp["wq_a"]), lp["attn_q_a_norm"], cfg.rms_eps)
        q = qmatmul(q, lp["wq_b"])
    else:  # DeepSeek-V2-Lite
        q = qmatmul(x, lp["wq"])
    q = q.reshape(nt, cfg.n_head, cfg.head_dim)
    kv_pe = qmatmul(x, lp["wkv_a_mqa"])
    kv_rank = kv_pe.shape[-1] - rope_d
    kv_c = rms_norm(kv_pe[:, :kv_rank], lp["attn_kv_a_norm"], cfg.rms_eps)
    k_pe = rotate(kv_pe[:, kv_rank:].reshape(nt, 1, rope_d), cos, sin, rope)
    kv = qmatmul(kv_c, lp["wkv_b"]).reshape(nt, cfg.n_head, nope + v_dim)
    q = torch.cat([q[..., :nope], rotate(q[..., nope:], cos, sin, rope)], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe.expand(nt, cfg.n_head, rope_d)], dim=-1)
    return q, k, kv[..., nope:]


def _qkv_gqa(lp: dict, x: torch.Tensor, cfg: ModelConfig, li: int = -1):
    """q, k, v of a GQA layer (JAX ``qkv``, ``:195-247``): the projections
    (fused or split), bitnet's per-projection scales, their biases (one add
    over a fused output), olmo's and dbrx's clip, then the per-head q/k
    norms (stablelm's and openelm's [head_dim] weights, command-r's
    [n_head, head_dim] LayerNorm ones), before rope; at layer li's own head
    counts (openelm)."""
    nt = x.shape[0]
    n_h = cfg.layer_n_head(li) if li >= 0 else cfg.n_head
    n_kv = cfg.layer_n_head_kv(li) if li >= 0 else cfg.n_head_kv
    qd, kvd = n_h * cfg.head_dim, n_kv * cfg.head_dim
    if "wqkv_fused" in lp:
        y = qmatmul(x, lp["wqkv_fused"])
        if "bqkv_fused" in lp:
            y = y + lp["bqkv_fused"]
        q, k, v = y[:, :qd], y[:, qd:qd + kvd], y[:, qd + kvd:]
    else:  # split projections (unfused load, or a layer whose layouts differ)
        q, k, v = (qmatmul(x, lp[name]) for name in ("wq", "wk", "wv"))
    if "wq_scale" in lp:  # bitnet
        q, k, v = q * lp["wq_scale"], k * lp["wk_scale"], v * lp["wv_scale"]
    if "bq" in lp:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    if cfg.clamp_kqv > 0.0:  # olmo, dbrx
        q, k, v = (t.clamp(-cfg.clamp_kqv, cfg.clamp_kqv) for t in (q, k, v))
    q = q.reshape(nt, n_h, cfg.head_dim)
    k = k.reshape(nt, n_kv, cfg.head_dim)
    v = v.reshape(nt, n_kv, cfg.head_dim)
    if "attn_q_norm" in lp:
        q, k = _norm(cfg, lp, "attn_q_norm", q), _norm(cfg, lp, "attn_k_norm", k)
    return q, k, v


def _ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The FFN of a layer, [nt, d] f32, by JAX's branches
    (``llama_kotlin_tpu/models/llama.py:386-444``): the MoE block where the
    layer has a router; a gated FFN, kernel 2 for decode rows where it
    takes the layouts and no gate or up bias sits between the products (the
    fused gate|up, or gate and up apart), else gate|up (fused or separate,
    each plus its bias: jais) and down; a non-gated one (codeshell, the
    gpt2 family, or a file without ffn_gate: starcoder2), act(up + its
    bias), or for chatglm's packed up silu(its first half) * its second,
    then down; then the down bias."""
    if "ffn_gate_inp" in lp and "ffn_norm_exps" not in lp:
        return _moe_ffn(lp, x, cfg)
    act = ACTIVATIONS[cfg.act]
    fused = "ffn_gateup_fused" in lp
    if cfg.ffn_gated and (fused or "ffn_gate" in lp):
        gate_w = lp["ffn_gateup_fused"] if fused else lp["ffn_gate"]
        plain = not any(k in lp for k in _FFN_BETWEEN)
        down = None if not plain else qmm_ffn(
            x, gate_w, lp["ffn_down"], act=cfg.act, up=None if fused else lp["ffn_up"])
        if down is None:
            if fused:
                y = qmatmul(x, gate_w)
                gate, up = y[:, :cfg.n_ff], y[:, cfg.n_ff:]
            else:
                gate, up = qmatmul(x, gate_w), qmatmul(x, lp["ffn_up"])
                if "ffn_gate_scale" in lp:  # bitnet
                    gate = gate * lp["ffn_gate_scale"]
                if "ffn_gate_b" in lp:
                    gate = gate + lp["ffn_gate_b"]
                if "ffn_up_scale" in lp:
                    up = up * lp["ffn_up_scale"]
                if "ffn_up_b" in lp:
                    up = up + lp["ffn_up_b"]
            ffn = act(gate) * up
            if "ffn_sub_norm" in lp:  # bitnet: a norm before down
                ffn = rms_norm(ffn, lp["ffn_sub_norm"], cfg.rms_eps)
            down = qmatmul(ffn.to(COMPUTE_DTYPE), lp["ffn_down"])
            if "ffn_down_scale" in lp:
                down = down * lp["ffn_down_scale"]
    else:
        up = qmatmul(x, lp["ffn_up"])
        if "ffn_up_b" in lp:
            up = up + lp["ffn_up_b"]
        if cfg.swiglu_packed:  # chatglm: [gate|up] in one projection
            gate, up = up.chunk(2, dim=-1)
            ffn = ACTIVATIONS["silu"](gate) * up
        else:
            ffn = act(up)
        down = qmatmul(ffn.to(COMPUTE_DTYPE), lp["ffn_down"])
    if "ffn_down_b" in lp:
        down = down + lp["ffn_down_b"]
    return down


# the tensors that sit between a gated FFN's products, under which kernel 2
# declines as JAX's megakernel does (``llama_kotlin_tpu/models/llama.py:
# 403-413``): jais's biases, bitnet's scales and sub-norm
_FFN_BETWEEN = ("ffn_gate_b", "ffn_up_b", "ffn_gate_scale", "ffn_up_scale", "ffn_sub_norm",
                "ffn_down_scale")


def _moe_ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A MoE layer's FFN (JAX ``moe_ffn``, ``:306-353``), [nt, d] f32: the
    router (a dense bf16 matrix) and its top-k (``ops/moe.py::route``),
    then the routed experts by JAX's rule: dense stacks (a float file) ->
    the grouped FFN; a quantized expert stack with at most 64 routed slots,
    fewer than the experts (decode) -> the gathered FFN; else (per-expert
    lists, prefill) -> the sweep; then the shared experts."""
    nt = x.shape[0]
    act = ACTIVATIONS[cfg.act]
    top_w, top_i = moe.route(qmatmul(x, lp["ffn_gate_inp"]), cfg.n_expert_used,
                             cfg.moe_norm_topk, cfg.moe_expert_scale)
    gate_w, up_w, down_w = lp["ffn_gate_exps"], lp["ffn_up_exps"], lp["ffn_down_exps"]
    slots = nt * cfg.n_expert_used
    if all(isinstance(w, torch.Tensor) and w.dim() == 3 for w in (gate_w, up_w, down_w)):
        down = moe.moe_grouped_ffn(x, gate_w, up_w, down_w, top_i, top_w, act)
    elif (isinstance(gate_w, QTensor) and gate_w.is_stacked and slots <= 64
          and slots < cfg.n_expert):
        down = moe.moe_gathered_quant(x, gate_w, up_w, down_w, top_i, top_w, act)
    else:
        down = _moe_sweep(lp, x, top_i, top_w, cfg)
    return _moe_shared(lp, x, down, cfg)


def _moe_sweep(lp: dict, x: torch.Tensor, top_i: torch.Tensor, top_w: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Every expert through the kernels (``qmatmul``), a token's output
    weighted by its routing weight for that expert (0 where unrouted): JAX's
    ``_moe_sweep``, ``:355-367``."""
    act = ACTIVATIONS[cfg.act]
    down = torch.zeros((x.shape[0], cfg.n_embd), dtype=torch.float32, device=x.device)
    for e in range(cfg.n_expert):
        w_tok = torch.where(top_i == e, top_w, torch.zeros_like(top_w)).sum(dim=-1)
        ffn_e = act(qmatmul(x, lp["ffn_gate_exps"][e])) * qmatmul(x, lp["ffn_up_exps"][e])
        down_e = qmatmul(ffn_e.to(COMPUTE_DTYPE), lp["ffn_down_exps"][e])
        down = down + w_tok[:, None] * down_e
    return down


def _moe_shared(lp: dict, x: torch.Tensor, down: torch.Tensor, cfg: ModelConfig):
    """The shared experts, a gated FFN every token takes, added to the routed
    output (JAX ``_moe_shared``, ``:369-384``): as deepseek2 does, or, with
    qwen2moe's ``ffn_gate_inp_shexp`` ([1, d], or llama.cpp's [d]), scaled
    by the sigmoid of its one-column product."""
    if "ffn_gate_shexp" not in lp:
        return down
    act = ACTIVATIONS[cfg.act]
    h = act(qmatmul(x, lp["ffn_gate_shexp"])) * qmatmul(x, lp["ffn_up_shexp"])
    sh = qmatmul(h.to(COMPUTE_DTYPE), lp["ffn_down_shexp"])
    if "ffn_gate_inp_shexp" in lp:
        gate = qmatmul(x, lp["ffn_gate_inp_shexp"].reshape(-1, x.shape[-1]))
        sh = torch.sigmoid(gate) * sh
    return down + sh


# the tensors of a layer with a fused gate|up under which JAX's fused
# layer-half hook declines (``llama_kotlin_tpu/models/llama.py:258-265``)
_LAYER_HALF_EXCLUDES = ("attn_sub_norm", "wo_scale", "bo", "post_attn_norm", "ffn_gate_inp",
                        "ffn_gate_b", "ffn_up_b", "ffn_gate_scale", "ffn_up_scale",
                        "ffn_sub_norm", "ffn_down_b", "ffn_down_scale", "post_ffn_norm",
                        "ffn_norm_exps")


def _fused_layer_half(lp: dict, h: torch.Tensor, attn: torch.Tensor, cfg: ModelConfig):
    """The JAX forward's fused layer-half hook (``llama_kotlin_tpu/models/
    llama.py:255-274``): o projection, residual, ffn_norm and gated FFN in
    one launch (ops/qmatmul.qmm_layer, kernel 10) where the layer has the
    fused gate|up and an ffn_norm, in a sequential gated RMS block; None
    when it declines, and the caller takes the unfused route."""
    if (cfg.parallel_residual or not cfg.use_rms_norm or not cfg.ffn_gated
            or "ffn_gateup_fused" not in lp or "ffn_norm" not in lp
            or any(key in lp for key in _LAYER_HALF_EXCLUDES)):
        return None
    return qmm_layer(attn, h, lp["wo"], lp["ffn_gateup_fused"], lp["ffn_down"], lp["ffn_norm"],
                     eps=cfg.rms_eps, act=cfg.act, offset=cfg.norm_weight_offset)


def _cache_rows(cache: KVCache, k: torch.Tensor, v: torch.Tensor):
    """The rows a layer writes for k/v [nt, KV, D] f32: (k, v, k_scale,
    v_scale) in the cache's [KV, nt, ...] order, bf16 rows with no scales,
    or int8 or packed int4 codes quantized from the same f32 K/V as in the
    JAX package."""
    kh, vh = k.transpose(0, 1), v.transpose(0, 1)
    if not cache.quantized:
        return kh.to(cache.k.dtype), vh.to(cache.v.dtype), None, None
    qr = quantize_rows_q4 if cache.kv_bits == 4 else quantize_rows
    (kc, ks), (vc, vs) = qr(kh), qr(vh)
    return kc, vc, ks, vs


def _write_rows(cache: KVCache, li: int, slots: torch.Tensor, rows) -> None:
    """In-place cache write of _cache_rows into cells `slots` of layer li,
    its first KV kv heads (the rows' own count: openelm's narrower layers
    fill the front of a cache sized at the widest)."""
    kc, vc, ks, vs = rows
    n_kv = kc.shape[0]
    cache.k[li, :n_kv].index_copy_(1, slots, kc)
    cache.v[li, :n_kv].index_copy_(1, slots, vc)
    if ks is not None:
        cache.k_scale[li, :n_kv].index_copy_(1, slots, ks)
        cache.v_scale[li, :n_kv].index_copy_(1, slots, vs)


def _layer_cache(cache: KVCache, li: int, n_kv: int) -> dict:
    """Layer li's first n_kv kv heads as a 3-D view ([n_kv, cells, D] K/V,
    [n_kv, cells] scales): contiguous, starting on a row of the cache, so
    16-byte aligned as kernel 3 requires (JAX's per-layer slice,
    ``llama_kotlin_tpu/models/llama.py:503-511``)."""
    return dict(k=cache.k[li, :n_kv], v=cache.v[li, :n_kv],
                k_scale=None if cache.k_scale is None else cache.k_scale[li, :n_kv],
                v_scale=None if cache.v_scale is None else cache.v_scale[li, :n_kv])


def _stacked_masks(cfg: ModelConfig, mask_full: torch.Tensor, token_pos: torch.Tensor,
                   token_seq: torch.Tensor, slots: torch.Tensor, cell_seq: torch.Tensor):
    """The stacked path's two masks (JAX models/llama.py:554-567):
    mask_cells [nt, n_vis], the visible cells less those this step writes,
    and mask_new [nt, nt], which fresh row each token sees, from the
    committed cell bitmasks.  Padded rows carry slots >= n_vis and mark
    nothing (the JAX scatter drops them)."""
    n_vis = cell_seq.shape[0]
    live = slots < n_vis
    taken = torch.zeros(n_vis + 1, dtype=torch.bool, device=slots.device)
    taken[torch.where(live, slots, n_vis)] = True
    mask_cells = mask_full & ~taken[None, :n_vis]
    token_mask = torch.where(live, cell_seq[slots.clamp(max=n_vis - 1)], 0)
    mask_new = ((((token_mask[None, :] >> token_seq[:, None]) & 1) != 0)
                & (token_pos[None, :] >= 0))
    if cfg.causal_attn:
        mask_new = mask_new & (token_pos[None, :] <= token_pos[:, None])
    return mask_cells.to(torch.int8), mask_new.to(torch.int8)


def attend_stacked_plain(q: torch.Tensor, cache: KVCache, li: int, new_k: torch.Tensor,
                         new_v: torch.Tensor, mask_cells: torch.Tensor, mask_new: torch.Tensor,
                         *, scale: float, logit_softcap: float = 0.0) -> torch.Tensor:
    """JAX's stacked attention where kernel 9 declines (``llama_kotlin_tpu/
    models/llama.py:569-606``: a packed int4 cache, or V narrower than K):
    layer li's visible prefix (dequantized where quantized) rounded to bf16,
    then the step's fresh rows new_k/new_v [nt, KV, D] (on a quantized cache
    dequantized from their own codes), under mask_cells and mask_new side
    by side, through attention_reference.  Plain torch ops on every device:
    no Pallas kernel runs there in JAX."""
    n_vis = mask_cells.shape[1]
    if cache.quantized:
        k_old, v_old = (dequantize_cache_layer(c[li, :, :n_vis], sc[li, :, :n_vis],
                                               COMPUTE_DTYPE, bits=cache.kv_bits)
                        for c, sc in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)))
    else:
        k_old, v_old = cache.k[li, :, :n_vis], cache.v[li, :, :n_vis]
    k_cat = torch.cat([k_old, new_k.to(COMPUTE_DTYPE).transpose(0, 1)], dim=1)
    v_cat = torch.cat([v_old, new_v.to(COMPUTE_DTYPE).transpose(0, 1)], dim=1)
    m_cat = torch.cat([mask_cells != 0, mask_new != 0], dim=1)
    return attention_reference(q, k_cat, v_cat, m_cat, scale=scale, logit_softcap=logit_softcap)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            token_pos: torch.Tensor, token_seq: torch.Tensor, slots: torch.Tensor,
            cache: KVCache, cell_pos: torch.Tensor, cell_seq: torch.Tensor,
            out_ids: torch.Tensor):
    """One ubatch step.  Returns (logits [n_out, vocab] f32, final-norm
    hidden states [n_out, n_embd] f32); the cache is updated in place.
    Takes the stacked path when ``params`` holds ``layers_stacked``.

    cell_pos/cell_seq [n_vis] must already hold the inserted tokens; their
    length is the attended cell prefix."""
    nt = tokens.shape[0]
    rope = cfg.rope_params()
    cos, sin = rope_cos_sin(token_pos, rope, params.get("rope_freqs"))
    h = take_rows(params["tok_embd"], tokens, dtype=COMPUTE_DTYPE)
    if cfg.embd_scale != 1.0:
        h = (h.to(torch.float32) * cfg.embd_scale).to(COMPUTE_DTYPE)
    if cfg.learned_pos_embd and params.get("pos_embd") is not None:
        # gpt2, starcoder: padded rows carry pos -1 (row 0); a position past
        # the table takes its last row, as JAX's clamped gather
        pos_w = params["pos_embd"]
        rows = token_pos.clamp(0, pos_w.shape[0] - 1)
        h = h + take_rows(pos_w, rows, dtype=COMPUTE_DTYPE)
    if cfg.token_embd_norm and params.get("tok_norm") is not None:  # bloom
        h = layer_norm(h, params["tok_norm"], params.get("tok_norm_b"), cfg.norm_eps)
    mask = visibility_mask(token_pos, token_seq, cell_pos, cell_seq, causal=cfg.causal_attn)
    slots = slots.to(torch.long)
    stacked = "layers_stacked" in params
    if stacked:
        mask_cells, mask_new = _stacked_masks(cfg, mask, token_pos, token_seq, slots, cell_seq)
    else:
        # the full mask and, with a sliding window, the windowed one (JAX
        # builds it causal whatever the config), each once a step
        mask = mask.to(torch.int8)
        mask_swa = (visibility_mask(token_pos, token_seq, cell_pos, cell_seq,
                                    window=cfg.swa_window).to(torch.int8)
                    if cfg.swa_window > 0 else None)
    softmax_kw = dict(scale=cfg.attn_scale, logit_softcap=cfg.attn_logit_softcap)
    attn_kw = dict(softmax_kw, k_scale=cache.k_scale, v_scale=cache.v_scale)
    # JAX's static refusal of its flash kernel: ALiBi or a head dim it does
    # not take attend by the plain route on every device (never stacked:
    # can_stack refuses ALiBi, and the stacked path has its own plain route)
    plain_attn = flash_declines(cfg.head_dim, cfg.v_head_dim, cfg.max_alibi_bias)
    if cfg.max_alibi_bias > 0:
        attn_kw.update(alibi=alibi_slopes(cfg.n_head, cfg.max_alibi_bias, h.device),
                       token_pos=token_pos, cell_pos=cell_pos)
    # JAX's whole-cache rule (:659-663): every layer attends over the 4-D
    # cache with its layer index where each holds the cache's kv heads, else
    # (openelm) over its own 3-D view of its first kv heads
    whole = all(cfg.layer_n_head_kv(i) == cache.k.shape[1] for i in range(cfg.n_layer))
    for li, lp in enumerate(layer_views(params)):
        # JAX attn_in (:150-157): falcon-40b's ln_attn (attn_norm_2) wins
        x = _norm(cfg, lp, "attn_norm_2" if "attn_norm_2" in lp else "attn_norm", h)
        q, k, v = _qkv(lp, x, cfg, cos, sin, rope, -1 if stacked else li)
        rows = _cache_rows(cache, k, v)
        if stacked:
            if cache.quantized:
                # attend over the dequantized rows, so this step's tokens see
                # what later steps will read
                k, v = (dequantize_cache_layer(c, s, bits=cache.kv_bits).transpose(0, 1)
                        for c, s in ((rows[0], rows[2]), (rows[1], rows[3])))
            if (cache.kv_bits == 4 or cfg.v_head_dim != cfg.head_dim
                    or cfg.head_dim not in HEAD_DIMS):  # kernel 9's head dims
                attn = attend_stacked_plain(q, cache, li, k, v, mask_cells, mask_new,
                                            **softmax_kw)
            else:
                attn = flash_attention_stacked(q, cache.k, cache.v, li, k.to(COMPUTE_DTYPE),
                                               v.to(COMPUTE_DTYPE), mask_cells, mask_new,
                                               **attn_kw)
            _write_rows(cache, li, slots, rows)
        else:
            _write_rows(cache, li, slots, rows)
            layer_mask = mask_swa if cfg.layer_swa_window(li) > 0 else mask
            attend = cache_attention_reference if plain_attn else flash_attention
            if whole:
                attn = attend(q, cache.k, cache.v, layer_mask, layer=li, kv_bits=cache.kv_bits,
                              **attn_kw)
            else:
                view = _layer_cache(cache, li, k.shape[1])
                attn = attend(q, view.pop("k"), view.pop("v"), layer_mask,
                              kv_bits=cache.kv_bits, **dict(attn_kw, **view))
        attn = attn.to(COMPUTE_DTYPE).reshape(nt, -1)
        h3 = _fused_layer_half(lp, h, attn, cfg)
        if h3 is not None:
            h = h3
            continue
        if "attn_sub_norm" in lp:  # bitnet: a norm before wo
            attn = rms_norm(attn, lp["attn_sub_norm"], cfg.rms_eps)
        attn_out = qmatmul(attn, lp["wo"])
        if "wo_scale" in lp:
            attn_out = attn_out * lp["wo_scale"]
        if "bo" in lp:
            attn_out = attn_out + lp["bo"]
        if "post_attn_norm" in lp:  # gemma2
            attn_out = rms_norm(attn_out, lp["post_attn_norm"], cfg.rms_eps,
                                cfg.norm_weight_offset)
        if cfg.parallel_residual:
            # JAX :292-295: the FFN reads the layer's input, normed by
            # ffn_norm where the layer has one (gptneox), else by attn_norm
            # (plamo, command-r, falcon, phi2): x as computed above unless
            # the attention took attn_norm_2 (falcon-40b)
            if "ffn_norm" in lp or "attn_norm_2" in lp:
                x = _norm(cfg, lp, "ffn_norm" if "ffn_norm" in lp else "attn_norm", h)
            h = h + attn_out.to(h.dtype)
        else:
            h = h + attn_out.to(h.dtype)
            # dbrx names its pre-FFN norm attn_output_norm (JAX :296-302)
            x = _norm(cfg, lp, "attn_out_norm" if "ffn_norm" not in lp
                      and "attn_out_norm" in lp else "ffn_norm", h)
        ffn_inp = h  # the post-attention residual, which arctic's MoE branch reads
        down = _ffn(lp, x, cfg)
        if "ffn_gate_inp" in lp and "ffn_norm_exps" not in lp:
            down = down.to(h.dtype)  # JAX rounds a MoE output to the residual's dtype (:388)
        if "post_ffn_norm" in lp:  # gemma2, grok
            down = rms_norm(down, lp["post_ffn_norm"], cfg.rms_eps, cfg.norm_weight_offset)
        h = h + down.to(h.dtype)
        if "ffn_norm_exps" in lp and "ffn_gate_inp" in lp:
            # arctic: the MoE branch beside the dense FFN, normed from the
            # post-attention residual (JAX :385-388, :449-453)
            x_moe = rms_norm(ffn_inp, lp["ffn_norm_exps"], cfg.rms_eps)
            h = h + _moe_ffn(lp, x_moe, cfg).to(h.dtype)
    h_out = _norm(cfg, params, "output_norm", h[out_ids.to(torch.long)])
    out_w = params.get("output")
    if out_w is None:
        out_w = params["tok_embd"]  # tied embeddings
    logits = qmatmul(h_out, out_w).to(torch.float32)
    if params.get("output_b") is not None:  # phi2
        logits = logits + params["output_b"]
    if cfg.logit_scale != 1.0:  # command-r
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap > 0.0:  # gemma2
        logits = torch.tanh(logits / cfg.final_logit_softcap) * cfg.final_logit_softcap
    return logits, h_out.to(torch.float32)
