"""GGUF -> device params (port of ``llama_kotlin_tpu/models/loader.py`` for
the architectures ``models/registry.py`` marks ported: the llama
architecture, dense or MoE (Mixtral), gemma, gemma2, deepseek2 and the
llama-shaped family, in all four of its modes).

``load_gguf_model(path, fast_mode=None|"w4"|"w4x"|"int8", fuse=True)``
memory-maps the file, moves each tensor's wire bytes to the device and
repacks them there (``quant/repack.py``), in row chunks so that no f32 copy
of a whole lm_head sits in memory:

* ``None``, the default (JAX ``:334``), the exact-dequant mode: every
  quantized matrix keeps its exact repack (JAX ``:173-175``), served by
  kernel 4's exact branches at every row count, an int8 group-256 (Q8_K)
  repack by kernel 6;
* ``"w4"`` (JAX ``_repack_w4``, ``:127-148``): 4-bit group-32 formats
  (Q4_K, Q4_0, Q4_1) fold to W4 (kernels 1, 2, 4); every other group-16/32
  format (Q6_K, Q8_0, Q5_0, Q5_1, Q5_K, Q3_K, Q2_K) folds to W8 (kernels
  5, 4); any other group (Q8_K) converts to Q8F (kernel 6);
* ``"w4x"``, the high-fidelity mode: the same formats fold to the precise
  W4X and W8X folds (kernel 7, kernel 5's dual-plane branch, kernel 4);
  any other group keeps its exact repack (JAX ``:148``);
* ``"int8"``: every matrix converts to Q8F (kernel 6).

Norms stay f32, and an F32, F16 or BF16 matrix stays a dense bf16 tensor in
every mode, as in JAX (a plain matmul serves it).  The MoE router
(``ffn_gate_inp``) is always dense: JAX keeps it f32 and casts it to bf16
at its matmul, the port casts it once here.

MoE expert stacks (3-D ``ffn_{gate,up,down}_exps`` [E, n, k], JAX
``:181-206``): in a fast mode with E <= 16 (Mixtral), a list of E
per-expert matrices in the mode's layout, which ``_moe_sweep`` runs through
the kernels one expert at a time; otherwise one stacked exact repack
(``quant/qtensor.py::stack_qtensors``), whose routed experts a decode step
gathers; a float file's stacks stay dense bf16 [E, n, k].  deepseek2's MLA
projections (``attn_q_a``/``attn_q_b`` or ``attn_q``, ``attn_kv_a_mqa``,
``attn_kv_b``, and their norms) and shared experts (``ffn_*_shexp``) load
as any matrix.  gemma2's post-attention and post-FFN norms
(``post_attention_norm``, ``post_ffw_norm``) stay f32 as the other norms.
The llama-shaped family's tensors (JAX ``:30-52``, ``_ALWAYS_FLOAT``
``:110-124``): q/k/v/o and FFN biases (``bq``, ``bk``, ``bv``, ``bo``,
``ffn_{up,down}_b``), LayerNorm biases (``attn_norm_b``, ``ffn_norm_b``,
``output_norm_b``) and per-head q/k norms stay f32; qwen2moe's shared-expert gate
(``ffn_gate_inp_shexp``) is dense bf16 as the router is; a fused
``attn_qkv`` weight or bias (qwen, phi3, codeshell) splits by rows into
q, k and v at load, exactly (quantized rows are independent).  The
learned-position family's (JAX ``:31-32``, ``:48``, ``:97-107``): falcon-40b's
``attn_norm_2`` (and bias), jais's gate bias (``ffn_gate_b``), bloom's
embedding LayerNorm (``tok_norm``, ``tok_norm_b``) and phi2's output bias
(``output_b``) stay f32; gpt2's and starcoder's position table
(``pos_embd``; llama.cpp leaves it unquantized) loads as token_embd does,
a float one dense bf16.  A file with no ``output`` (gemma's tied head: llama.cpp gives the
embedding the output's type, Q6_K in a Q4_K_M file) loads ``token_embd``
once in the mode's layout, which serves both the embedding rows
(``take_rows``) and the lm_head.  The nine IQ formats route as the other
8-bit repacks (exact: kernel 4's exact branch; ``w4``: the W8 fold, kernel
5; ``w4x``: W8X; ``int8``: Q8F).  ``LKTPU_DUAL_FOLD=1`` (read at load, as
JAX's ``:140-144``) gives every W4 fold of the ``w4`` mode a Q8F shadow
(``quant/fold.py::attach_q8``) from the f32 decode of its wire bytes, for
the high-batch switch of ``ops/qmatmul.py``.  The large MoEs' and the
per-layer architectures' (JAX ``:56-60``, ``:77-91``, ``:109-124``,
``:261-264``): ``attn_output_norm`` (dbrx's pre-FFN norm; with grok's
``layer_output_norm`` read as the post norms ``post_attn_norm`` /
``post_ffn_norm``, JAX's ``_ARCH_KEY_ALIASES``), arctic's ``ffn_norm_exps``,
bitnet's seven ``.scale`` tensors and two sub-norms stay f32; a fused
``attn_qkv`` splits at its layer's own q and kv widths (openelm).  Still
refused: tensor names the port's forward does not read (SSM and encoder
tensors: the architectures ROADMAP.md section 1, item 13 lists).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from llama_kotlin_tpu_torch.device import DeviceLike, resolve_device
from llama_kotlin_tpu_torch.gguf.reader import GGUFFile
from llama_kotlin_tpu_torch.models.config import ModelConfig, config_from_metadata
from llama_kotlin_tpu_torch.quant.fold import (GROUP, attach_q8, dual_fold_enabled, fold_to_w4,
                                               fold_to_w8)
from llama_kotlin_tpu_torch.quant.formats import TYPE_TRAITS, GGMLQuantType, row_byte_size
from llama_kotlin_tpu_torch.quant.qtensor import QTensor, concat_qtensors, stack_qtensors
from llama_kotlin_tpu_torch.quant.repack import dequantize_wire, repack, repack_q8flat

FAST_MODES = (None, "w4", "w4x", "int8")
ROW_CHUNK = 16384  # matrix rows converted per step

# tensor-name suffix -> params key (the rows of the JAX tables for the
# architectures the port loads)
_LAYER_TENSORS = {
    "attn_norm.weight": "attn_norm",
    "attn_norm.bias": "attn_norm_b",
    "attn_norm_2.weight": "attn_norm_2",
    "attn_norm_2.bias": "attn_norm_2_b",
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "attn_q.bias": "bq",
    "attn_k.bias": "bk",
    "attn_v.bias": "bv",
    "attn_output.bias": "bo",
    "attn_q_norm.weight": "attn_q_norm",
    "attn_k_norm.weight": "attn_k_norm",
    "ffn_norm.weight": "ffn_norm",
    "ffn_norm.bias": "ffn_norm_b",
    "ffn_gate.weight": "ffn_gate",
    "ffn_gate.bias": "ffn_gate_b",
    "ffn_up.weight": "ffn_up",
    "ffn_up.bias": "ffn_up_b",
    "ffn_down.weight": "ffn_down",
    "ffn_down.bias": "ffn_down_b",
    "ffn_gate_inp.weight": "ffn_gate_inp",
    "ffn_gate_inp_shexp.weight": "ffn_gate_inp_shexp",
    "ffn_gate_exps.weight": "ffn_gate_exps",
    "ffn_up_exps.weight": "ffn_up_exps",
    "ffn_down_exps.weight": "ffn_down_exps",
    "ffn_gate_shexp.weight": "ffn_gate_shexp",
    "ffn_up_shexp.weight": "ffn_up_shexp",
    "ffn_down_shexp.weight": "ffn_down_shexp",
    "attn_q_a.weight": "wq_a",
    "attn_q_b.weight": "wq_b",
    "attn_kv_a_mqa.weight": "wkv_a_mqa",
    "attn_kv_b.weight": "wkv_b",
    "attn_q_a_norm.weight": "attn_q_a_norm",
    "attn_kv_a_norm.weight": "attn_kv_a_norm",
    "post_attention_norm.weight": "post_attn_norm",
    "post_ffw_norm.weight": "post_ffn_norm",
    # dbrx's pre-FFN norm, grok's out-norms (read as post norms below);
    # arctic's MoE-branch norm; bitnet's per-projection scales and sub-norms
    "attn_output_norm.weight": "attn_out_norm",
    "attn_output_norm.bias": "attn_out_norm_b",
    "layer_output_norm.weight": "layer_out_norm",
    "layer_output_norm.bias": "layer_out_norm_b",
    "ffn_norm_exps.weight": "ffn_norm_exps",
    "attn_sub_norm.weight": "attn_sub_norm",
    "ffn_sub_norm.weight": "ffn_sub_norm",
    "attn_q.scale": "wq_scale",
    "attn_k.scale": "wk_scale",
    "attn_v.scale": "wv_scale",
    "attn_output.scale": "wo_scale",
    "ffn_gate.scale": "ffn_gate_scale",
    "ffn_up.scale": "ffn_up_scale",
    "ffn_down.scale": "ffn_down_scale",
}
# per-architecture readings of shared names (JAX :261-264): grok's
# out-norms are pre-residual norms like gemma2's post norms
_ARCH_KEY_ALIASES = {
    "grok": {"attn_out_norm": "post_attn_norm", "layer_out_norm": "post_ffn_norm"},
}
_GLOBAL_TENSORS = {
    "token_embd.weight": "tok_embd",
    "token_embd_norm.weight": "tok_norm",
    "token_embd_norm.bias": "tok_norm_b",
    "position_embd.weight": "pos_embd",
    "output_norm.weight": "output_norm",
    "output_norm.bias": "output_norm_b",
    "output.weight": "output",
    "output.bias": "output_b",
    "rope_freqs.weight": "rope_freqs",
}
_ALWAYS_FLOAT = {"attn_norm", "ffn_norm", "output_norm", "rope_freqs", "attn_q_a_norm",
                 "attn_kv_a_norm", "post_attn_norm", "post_ffn_norm", "attn_norm_b",
                 "ffn_norm_b", "output_norm_b", "attn_q_norm", "attn_k_norm", "bq", "bk", "bv",
                 "bo", "ffn_gate_b", "ffn_up_b", "ffn_down_b", "attn_norm_2", "attn_norm_2_b",
                 "tok_norm", "tok_norm_b", "output_b", "attn_out_norm", "attn_out_norm_b",
                 "layer_out_norm", "layer_out_norm_b", "ffn_norm_exps", "attn_sub_norm",
                 "ffn_sub_norm", "wq_scale", "wk_scale", "wv_scale", "wo_scale",
                 "ffn_gate_scale", "ffn_up_scale", "ffn_down_scale"}
# dense bf16 in every mode, whatever the file's type: the routers (JAX keeps
# them f32 and casts them to bf16 at its matmul; the port casts once here)
ALWAYS_DENSE = {"ffn_gate_inp", "ffn_gate_inp_shexp"}

MAX_EXPERT_LIST = 16  # expert counts a fast mode loads as per-expert lists (JAX :196)


def _convert(data: torch.Tensor, qt: GGMLQuantType, n: int, k: int,
             fast_mode: Optional[str]) -> QTensor:
    """The mode's layout of one quantized matrix: the exact repack (None);
    Q8F (int8); in the W4 and W4X modes 4-bit group-32 formats fold to W4
    (precise in W4X), other group-16/32 formats to W8, and any other group
    converts to Q8F (w4) or keeps its exact repack (w4x), as JAX's
    ``_repack_w4``."""
    if fast_mode == "int8":
        return repack_q8flat(data, qt, n, k)
    rp = repack(data, qt, n, k)
    if fast_mode is None:
        return rp
    precise = fast_mode == "w4x"
    if rp.bits == 4 and rp.group_size == GROUP:
        w4 = fold_to_w4(rp, precise=precise)
        if not precise and dual_fold_enabled():  # JAX :140-144: from the f32 decode
            w4 = attach_q8(w4, dequantize_wire(data, qt, (n, k)))
        return w4
    if rp.group_size in (16, 32):
        return fold_to_w8(rp, precise=precise)
    return rp if precise else repack_q8flat(data, qt, n, k)


def _load_matrix(data: torch.Tensor, qt: GGMLQuantType, n: int, k: int,
                 fast_mode: Optional[str],
                 dev: torch.device) -> QTensor | torch.Tensor:
    """One [n, k] matrix, converted on `dev` in row chunks: a quantized one
    to the mode's QTensor, a float one (F32, F16, BF16) to a dense bf16
    tensor, as JAX keeps it (``llama_kotlin_tpu/models/loader.py:159-165``)."""
    flat = data.reshape(n, row_byte_size(k, qt))
    chunks = range(0, n, ROW_CHUNK)
    if not TYPE_TRAITS[qt].is_quantized:
        out = torch.empty((n, k), dtype=torch.bfloat16, device=dev)
        for r0 in chunks:
            rows = flat[r0:r0 + ROW_CHUNK]
            out[r0:r0 + rows.shape[0]] = dequantize_wire(rows.to(dev), qt, (rows.shape[0], k))
        return out
    parts = [_convert(flat[r0:r0 + ROW_CHUNK].to(dev), qt, min(ROW_CHUNK, n - r0), k,
                      fast_mode) for r0 in chunks]
    return parts[0] if len(parts) == 1 else concat_qtensors(parts)


def _load_experts(data: torch.Tensor, qt: GGMLQuantType, shape: tuple,
                  fast_mode: Optional[str], dev: torch.device):
    """A 3-D expert stack [E, n, k] (JAX ``:181-206``): a float one as one
    dense bf16 tensor; a quantized one, in a fast mode with E <= 16, as a
    list of the mode's per-expert layouts (the sweep runs each through the
    kernels), else as one stacked exact repack (decode gathers the routed
    experts' planes)."""
    n_exp, n, k = shape
    flat = data.reshape(n_exp, n * row_byte_size(k, qt))
    if not TYPE_TRAITS[qt].is_quantized:
        return torch.stack([_load_matrix(flat[e], qt, n, k, fast_mode, dev)
                            for e in range(n_exp)])
    if fast_mode is not None and n_exp <= MAX_EXPERT_LIST:
        return [_load_matrix(flat[e], qt, n, k, fast_mode, dev) for e in range(n_exp)]
    return stack_qtensors([_load_matrix(flat[e], qt, n, k, None, dev) for e in range(n_exp)])


def _load_tensor(f: GGUFFile, name: str, key: str, fast_mode: Optional[str],
                 dev: torch.device):
    """Norms -> f32 tensors; the router -> dense bf16; matrices -> the
    mode's QTensor or dense bf16; expert stacks -> _load_experts."""
    info = f.tensors[name]
    data = f.tensor_data(name)
    if key in _ALWAYS_FLOAT:
        return dequantize_wire(data.to(dev), info.ggml_type, info.np_shape)
    if key in ALWAYS_DENSE:
        return dequantize_wire(data.to(dev), info.ggml_type,
                               info.np_shape).to(torch.bfloat16)
    if len(info.np_shape) == 3:
        return _load_experts(data, info.ggml_type, info.np_shape, fast_mode, dev)
    if len(info.np_shape) != 2:
        raise NotImplementedError(f"{name}: {len(info.np_shape)}-D weights are not ported")
    n, k = info.np_shape
    return _load_matrix(data, info.ggml_type, n, k, fast_mode, dev)


def _load_fused_qkv(f: GGUFFile, name: str, cfg: ModelConfig, fast_mode: Optional[str],
                    dev: torch.device) -> dict:
    """Split a fused attn_qkv tensor into wq/wk/wv (a bias into bq/bk/bv,
    f32), JAX ``:210-259``: the rows are q|k|v and quantized rows are
    independent, so a row split is exact; the widths are the layer's own
    (openelm's per-layer head counts)."""
    info = f.tensors[name]
    li = int(name.split(".")[1])
    qdim = cfg.layer_n_head(li) * cfg.head_dim
    kvdim = cfg.layer_n_head_kv(li) * cfg.head_dim
    n = info.np_shape[0]
    if n != qdim + 2 * kvdim:
        raise ValueError(f"{name}: rows {n} != q+2kv {qdim + 2 * kvdim}")
    bounds = ((0, qdim), (qdim, qdim + kvdim), (qdim + kvdim, n))
    if name.endswith(".bias"):
        b = dequantize_wire(f.tensor_data(name).to(dev), info.ggml_type, info.np_shape)
        return {key: b[r0:r1] for key, (r0, r1) in zip(("bq", "bk", "bv"), bounds)}
    k = info.np_shape[1]
    flat = f.tensor_data(name).reshape(n, row_byte_size(k, info.ggml_type))
    return {key: _load_matrix(flat[r0:r1], info.ggml_type, r1 - r0, k, fast_mode, dev)
            for key, (r0, r1) in zip(("wq", "wk", "wv"), bounds)}


def fuse_layer_projections(cfg: ModelConfig, params: dict) -> int:
    """Serving fold: wq|wk|wv -> wqkv_fused and ffn_gate|up ->
    ffn_gateup_fused in every layer whose parts share one layout (one
    launch instead of two or three): all QTensors (folds or exact repacks),
    or all dense matrices, as in JAX (``:268``).  A layer of mixed layouts
    keeps its projections split: concat_qtensors refuses them (a Q4_K_M
    layer's Q4_K wq/wk and Q6_K wv, in every mode).  As in JAX (``:296-320``),
    q|k|v fuse only in a layer whose head counts are the config's (the
    maximum: openelm's narrower layers keep them split), and gate|up only
    in a gated FFN as wide as the config's n_ff without a gate or up bias,
    bitnet's gate or up scale or its FFN sub-norm (they apply to the split
    outputs: jais, bitnet).  A fused qkv's biases fuse too (bq|bk|bv ->
    bqkv_fused): one add over the fused output in place of three, the same
    function.  Returns the number of layers with at least one fusion."""
    n_fused = 0
    for li, lp in enumerate(params["layers"]):
        did = False
        uniform = (cfg.layer_n_head(li) == cfg.n_head
                   and cfg.layer_n_head_kv(li) == cfg.n_head_kv)
        gu_plain = (cfg.ffn_gated and cfg.layer_n_ff(li) == cfg.n_ff
                    and not any(k in lp for k in ("ffn_gate_b", "ffn_up_b", "ffn_gate_scale",
                                                  "ffn_up_scale", "ffn_sub_norm")))
        for parts, fused in ((("wq", "wk", "wv"), "wqkv_fused"),
                             (("ffn_gate", "ffn_up"), "ffn_gateup_fused")):
            if fused == "ffn_gateup_fused" and not gu_plain:
                continue
            if fused == "wqkv_fused" and not uniform:
                continue
            ws = [lp.get(p) for p in parts]
            if all(isinstance(w, torch.Tensor) for w in ws):
                lp[fused] = torch.cat(ws, dim=0)
            elif not all(isinstance(w, QTensor) for w in ws):
                continue
            else:
                try:
                    lp[fused] = concat_qtensors(ws)
                except ValueError:
                    continue  # mixed layouts: keep the split projections
            for p in parts:
                del lp[p]
            if fused == "wqkv_fused" and "bq" in lp:
                lp["bqkv_fused"] = torch.cat([lp.pop(b) for b in ("bq", "bk", "bv")])
            did = True
        n_fused += int(did)
    return n_fused


def load_gguf_model(path: str | Path, *, fast_mode: Optional[str] = None,
                    fuse: bool = False, device: DeviceLike = None):
    """Load a GGUF file of a ported architecture into (config, params, open GGUFFile) on
    `device` (None means cuda).  fast_mode is None (the exact-dequant mode,
    JAX's default), "w4", "w4x" or "int8"; fuse=True applies the
    single-device serving fold (fuse_layer_projections)."""
    if fast_mode not in FAST_MODES:
        raise NotImplementedError(f"fast_mode={fast_mode!r}: the port loads {FAST_MODES}, "
                                  "the JAX package's modes")
    dev = resolve_device(device)
    f = GGUFFile(path)
    cfg = config_from_metadata(f.metadata)
    params: dict = {"layers": [dict() for _ in range(cfg.n_layer)]}
    for name in f.tensors:
        if name in _GLOBAL_TENSORS:
            key = _GLOBAL_TENSORS[name]
            params[key] = _load_tensor(f, name, key, fast_mode, dev)
            continue
        parts = name.split(".", 2)
        if parts[0] == "blk" and len(parts) == 3:
            lp = params["layers"][int(parts[1])]
            if parts[2] in ("attn_qkv.weight", "attn_qkv.bias"):
                lp.update(_load_fused_qkv(f, name, cfg, fast_mode, dev))
                continue
            if parts[2] in _LAYER_TENSORS:
                key = _LAYER_TENSORS[parts[2]]
                key = _ARCH_KEY_ALIASES.get(cfg.arch, {}).get(key, key)
                lp[key] = _load_tensor(f, name, key, fast_mode, dev)
                continue
        raise NotImplementedError(f"tensor {name!r} is not read by the port's forward (the "
                                  "architectures that carry it come with ROADMAP.md section "
                                  "1, item 13)")
    params.setdefault("rope_freqs", None)  # no "output": tied, forward reads tok_embd
    if fuse:
        fuse_layer_projections(cfg, params)
    return cfg, params, f
