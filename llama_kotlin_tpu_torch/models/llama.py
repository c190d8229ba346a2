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
  ``attend_stacked_q4`` is that route in plain torch ops, on the card too.

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
from llama_kotlin_tpu_torch.ops.activations import ACTIVATIONS
from llama_kotlin_tpu_torch.ops.attention import attention_reference, visibility_mask
from llama_kotlin_tpu_torch.ops.cuda.flash import flash_attention
from llama_kotlin_tpu_torch.ops.cuda.flash_stacked import flash_attention_stacked
from llama_kotlin_tpu_torch.ops.norms import rms_norm
from llama_kotlin_tpu_torch.ops.qmatmul import qmatmul, qmm_ffn, take_rows
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
    two layers with the same keys (the JAX package's rule; the port's
    config has no per-layer windows, ALiBi or per-layer shapes)."""
    layers = params.get("layers")
    if not layers or len(layers) < 2:
        return False
    keys = set(layers[0])
    return all(set(lp) == keys for lp in layers)


def _stack(xs: list):
    """One leaf of every layer -> the stacked leaf.  Leaves that differ in
    anything but their values raise ValueError or TypeError, as jnp.stack
    under jax.tree.map does, so the context keeps the unrolled path."""
    x0 = xs[0]
    if any(type(x) is not type(x0) for x in xs):
        raise TypeError("stack_layers: leaves of different types")
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
    """Layer i of a stacked leaf (a tensor or a QTensor), as a view."""
    if isinstance(leaf, torch.Tensor):
        return leaf[i]
    aux = None if leaf.aux is None else {
        k: v[i] if isinstance(v, torch.Tensor) else v for k, v in leaf.aux.items()}
    return replace(leaf, aux=aux, **{f: getattr(leaf, f)[i] for f in QT_TENSORS
                                    if getattr(leaf, f) is not None})


def layer_views(params: dict) -> list[dict]:
    """Per-layer weight dicts: the unrolled list, or views of the stack."""
    return params["layers"] if "layers" in params else params["layer_views"]


def _qkv(lp: dict, x: torch.Tensor, cfg: ModelConfig):
    nt = x.shape[0]
    qd = cfg.n_head * cfg.head_dim
    kvd = cfg.n_head_kv * cfg.head_dim
    if "wqkv_fused" in lp:
        y = qmatmul(x, lp["wqkv_fused"])
        q, k, v = y[:, :qd], y[:, qd:qd + kvd], y[:, qd + kvd:]
    else:  # split projections (unfused load, or a layer whose layouts differ)
        q, k, v = (qmatmul(x, lp[name]) for name in ("wq", "wk", "wv"))
    return (q.reshape(nt, cfg.n_head, cfg.head_dim),
            k.reshape(nt, cfg.n_head_kv, cfg.head_dim),
            v.reshape(nt, cfg.n_head_kv, cfg.head_dim))


def _ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated FFN: kernel 2 for decode rows when it takes the layouts, else
    gate|up (fused or separate) and down matmuls.  Plain gated FFN only:
    the port loads no FFN biases or scales."""
    act = ACTIVATIONS[cfg.act]
    if "ffn_gateup_fused" in lp:
        down = qmm_ffn(x, lp["ffn_gateup_fused"], lp["ffn_down"], act=cfg.act)
        if down is not None:
            return down
        y = qmatmul(x, lp["ffn_gateup_fused"])
        gate, up = y[:, :cfg.n_ff], y[:, cfg.n_ff:]
    else:
        gate, up = qmatmul(x, lp["ffn_gate"]), qmatmul(x, lp["ffn_up"])
    return qmatmul((act(gate) * up).to(COMPUTE_DTYPE), lp["ffn_down"])


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
    """In-place cache write of _cache_rows into cells `slots` of layer li."""
    kc, vc, ks, vs = rows
    cache.k[li].index_copy_(1, slots, kc)
    cache.v[li].index_copy_(1, slots, vc)
    if ks is not None:
        cache.k_scale[li].index_copy_(1, slots, ks)
        cache.v_scale[li].index_copy_(1, slots, vs)


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


def attend_stacked_q4(q: torch.Tensor, cache: KVCache, li: int, new_k: torch.Tensor,
                      new_v: torch.Tensor, mask_cells: torch.Tensor, mask_new: torch.Tensor,
                      *, scale: float, logit_softcap: float = 0.0) -> torch.Tensor:
    """The stacked path's attention on a packed int4 cache: JAX's own route
    there (``llama_kotlin_tpu/models/llama.py:569-573``: kernel 9 is int8
    only, so ``attend`` at :585-606 takes XLA): layer li's visible prefix
    dequantized and rounded to bf16, then the step's fresh rows new_k/new_v
    [nt, KV, D] (dequantized from their own int4 codes), under mask_cells
    and mask_new side by side, through attention_reference.  Plain torch
    ops on every device: no Pallas kernel runs there in JAX, and an int4
    instance of kernel 9 is later performance work (ROADMAP.md)."""
    n_vis = mask_cells.shape[1]
    k_old, v_old = (dequantize_cache_layer(c[li, :, :n_vis], sc[li, :, :n_vis],
                                           COMPUTE_DTYPE, bits=4)
                    for c, sc in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)))
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
    mask = visibility_mask(token_pos, token_seq, cell_pos, cell_seq, causal=cfg.causal_attn)
    slots = slots.to(torch.long)
    stacked = "layers_stacked" in params
    if stacked:
        mask_cells, mask_new = _stacked_masks(cfg, mask, token_pos, token_seq, slots, cell_seq)
    else:
        mask = mask.to(torch.int8)
    softmax_kw = dict(scale=cfg.attn_scale, logit_softcap=cfg.attn_logit_softcap)
    attn_kw = dict(softmax_kw, k_scale=cache.k_scale, v_scale=cache.v_scale)
    for li, lp in enumerate(layer_views(params)):
        x = rms_norm(h, lp["attn_norm"], cfg.rms_eps, cfg.norm_weight_offset)
        q, k, v = _qkv(lp, x, cfg)
        q = rotate(q, cos, sin, rope).to(COMPUTE_DTYPE)
        k = rotate(k, cos, sin, rope)
        rows = _cache_rows(cache, k, v)
        if stacked:
            if cache.quantized:
                # attend over the dequantized rows, so this step's tokens see
                # what later steps will read
                k, v = (dequantize_cache_layer(c, s, bits=cache.kv_bits).transpose(0, 1)
                        for c, s in ((rows[0], rows[2]), (rows[1], rows[3])))
            if cache.kv_bits == 4:
                attn = attend_stacked_q4(q, cache, li, k, v, mask_cells, mask_new, **softmax_kw)
            else:
                attn = flash_attention_stacked(q, cache.k, cache.v, li, k.to(COMPUTE_DTYPE),
                                               v.to(COMPUTE_DTYPE), mask_cells, mask_new,
                                               **attn_kw)
            _write_rows(cache, li, slots, rows)
        else:
            _write_rows(cache, li, slots, rows)
            attn = flash_attention(q, cache.k, cache.v, mask, layer=li, kv_bits=cache.kv_bits,
                                   **attn_kw)
        attn = attn.to(COMPUTE_DTYPE).reshape(nt, -1)
        h = h + qmatmul(attn, lp["wo"]).to(h.dtype)
        x = rms_norm(h, lp["ffn_norm"], cfg.rms_eps, cfg.norm_weight_offset)
        h = h + _ffn(lp, x, cfg).to(h.dtype)
    h_out = rms_norm(h[out_ids.to(torch.long)], params["output_norm"], cfg.rms_eps,
                     cfg.norm_weight_offset)
    out_w = params.get("output")
    if out_w is None:
        out_w = params["tok_embd"]  # tied embeddings
    logits = qmatmul(h_out, out_w).to(torch.float32)
    return logits, h_out.to(torch.float32)
