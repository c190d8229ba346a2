"""GGUF -> device params (port of ``llama_kotlin_tpu/models/loader.py`` for
the llama architecture in the two fast modes).

``load_gguf_model(path, fast_mode="w4"|"w4x"|"int8", fuse=True)``
memory-maps the file, moves each tensor's wire bytes to the device and
repacks them there (``quant/repack.py``), in row chunks so that no f32 copy
of a whole lm_head sits in memory:

* ``"w4"``: 4-bit group-32 formats (Q4_K) fold to W4 (kernels 1, 2, 4);
  every other group-16/32 format (Q6_K, Q8_0) folds to W8 (kernels 5, 4);
* ``"w4x"``, the high-fidelity mode: the same formats fold to the precise
  W4X and W8X folds (kernel 7, kernel 5's dual-plane branch, kernel 4);
  a format JAX's w4x mode keeps as its exact standard repack (group sizes
  other than 16/32) raises, naming the exact-dequant slice;
* ``"int8"``: every matrix converts to Q8F (kernel 6).

Norms stay f32, and an F32, F16 or BF16 matrix stays a dense bf16 tensor in
every mode, as in JAX (a plain matmul serves it).  The exact-dequant mode
(``fast_mode=None``) needs kernel 4 on every repacked format and comes with
a later slice (ROADMAP.md section 1, item 7); it raises here, as does a
tensor name the llama forward does not read.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from llama_kotlin_tpu_torch.device import DeviceLike, resolve_device
from llama_kotlin_tpu_torch.gguf.reader import GGUFFile
from llama_kotlin_tpu_torch.models.config import ModelConfig, config_from_metadata
from llama_kotlin_tpu_torch.quant.fold import GROUP, fold_to_w4, fold_to_w8
from llama_kotlin_tpu_torch.quant.formats import TYPE_TRAITS, GGMLQuantType, row_byte_size
from llama_kotlin_tpu_torch.quant.qtensor import QTensor, concat_qtensors
from llama_kotlin_tpu_torch.quant.repack import dequantize_wire, repack, repack_q8flat

FAST_MODES = ("w4", "w4x", "int8")
ROW_CHUNK = 16384  # matrix rows converted per step

# tensor-name suffix -> params key (the llama rows of the JAX tables)
_LAYER_TENSORS = {
    "attn_norm.weight": "attn_norm",
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "ffn_norm.weight": "ffn_norm",
    "ffn_gate.weight": "ffn_gate",
    "ffn_up.weight": "ffn_up",
    "ffn_down.weight": "ffn_down",
}
_GLOBAL_TENSORS = {
    "token_embd.weight": "tok_embd",
    "output_norm.weight": "output_norm",
    "output.weight": "output",
    "rope_freqs.weight": "rope_freqs",
}
_ALWAYS_FLOAT = {"attn_norm", "ffn_norm", "output_norm", "rope_freqs"}


def _convert(data: torch.Tensor, qt: GGMLQuantType, n: int, k: int,
             fast_mode: str) -> QTensor:
    """int8 mode: Q8F.  W4 and W4X modes: 4-bit group-32 formats fold to W4
    (precise in W4X), the other ported formats (group 16/32) to W8."""
    if fast_mode == "int8":
        return repack_q8flat(data, qt, n, k)
    rp = repack(data, qt, n, k)
    precise = fast_mode == "w4x"
    if rp.bits == 4 and rp.group_size == GROUP:
        return fold_to_w4(rp, precise=precise)
    if precise and rp.group_size not in (16, 32):
        raise NotImplementedError(
            f"{qt.name} in the w4x mode: JAX keeps it as its exact standard repack, "
            "which needs kernel 4 on every repacked format (the exact-dequant slice)")
    return fold_to_w8(rp, precise=precise)


def _load_matrix(data: torch.Tensor, qt: GGMLQuantType, n: int, k: int, fast_mode: str,
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


def _load_tensor(f: GGUFFile, name: str, key: str, fast_mode: str, dev: torch.device):
    """Norms -> f32 tensors; matrices -> the mode's QTensor or dense bf16."""
    info = f.tensors[name]
    data = f.tensor_data(name)
    if key in _ALWAYS_FLOAT:
        return dequantize_wire(data.to(dev), info.ggml_type, info.np_shape)
    if len(info.np_shape) != 2:
        raise NotImplementedError(f"{name}: {len(info.np_shape)}-D weights (MoE) come "
                                  "with slice 5")
    n, k = info.np_shape
    return _load_matrix(data, info.ggml_type, n, k, fast_mode, dev)


def _load_fused_qkv(f: GGUFFile, name: str, cfg: ModelConfig, fast_mode: str,
                    dev: torch.device) -> dict:
    """Split a fused attn_qkv tensor into wq/wk/wv: the rows are q|k|v and
    quantized rows are independent, so a row split is exact."""
    info = f.tensors[name]
    n, k = info.np_shape
    qdim = cfg.n_head * cfg.head_dim
    kvdim = cfg.n_head_kv * cfg.head_dim
    if n != qdim + 2 * kvdim:
        raise ValueError(f"{name}: rows {n} != q+2kv {qdim + 2 * kvdim}")
    flat = f.tensor_data(name).reshape(n, row_byte_size(k, info.ggml_type))
    bounds = {"wq": (0, qdim), "wk": (qdim, qdim + kvdim), "wv": (qdim + kvdim, n)}
    return {key: _load_matrix(flat[r0:r1], info.ggml_type, r1 - r0, k, fast_mode, dev)
            for key, (r0, r1) in bounds.items()}


def fuse_layer_projections(cfg: ModelConfig, params: dict) -> int:
    """Serving fold: wq|wk|wv -> wqkv_fused and ffn_gate|up ->
    ffn_gateup_fused in every layer whose parts share one layout (one
    launch instead of two or three): all QTensors, or all dense matrices,
    as in JAX.  A layer of mixed layouts keeps its projections split:
    concat_qtensors refuses them.  Returns the number of layers with at
    least one fusion."""
    n_fused = 0
    for lp in params["layers"]:
        did = False
        for parts, fused in ((("wq", "wk", "wv"), "wqkv_fused"),
                             (("ffn_gate", "ffn_up"), "ffn_gateup_fused")):
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
            did = True
        n_fused += int(did)
    return n_fused


def load_gguf_model(path: str | Path, *, fast_mode: Optional[str] = None,
                    fuse: bool = False, device: DeviceLike = None):
    """Load a llama GGUF file into (config, params, open GGUFFile) on
    `device` (None means cuda).  fast_mode is "w4", "w4x" or "int8"; fuse=True
    applies the single-device serving fold (fuse_layer_projections)."""
    if fast_mode not in FAST_MODES:
        raise NotImplementedError(
            f"fast_mode={fast_mode!r}: the port loads {FAST_MODES}; the exact-dequant "
            "mode (None) needs kernel 4 on every repacked format, the next slice")
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
            if parts[2] == "attn_qkv.weight":
                lp.update(_load_fused_qkv(f, name, cfg, fast_mode, dev))
                continue
            if parts[2] in _LAYER_TENSORS:
                key = _LAYER_TENSORS[parts[2]]
                lp[key] = _load_tensor(f, name, key, fast_mode, dev)
                continue
        raise NotImplementedError(f"tensor {name!r} is not read by the port's llama "
                                  "forward (biases, MoE and other archs come later)")
    params.setdefault("rope_freqs", None)  # no "output": tied, forward reads tok_embd
    if fuse:
        fuse_layer_projections(cfg, params)
    return cfg, params, f
