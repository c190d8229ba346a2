"""Synthetic models: random W4 or W4X weights at real checkpoint shapes (port of
``llama_kotlin_tpu/models/synthetic.py``, the presets and W4 generators).

``synthetic_w4`` draws from a numpy Generator in the same order as the JAX
package's generator, so the same seed gives the same weights on both sides.
``synthetic_params_device`` draws every large tensor on the device from a
seeded ``torch.Generator`` — no multi-GB host build.  ``synthetic_gguf``
writes a llama GGUF file of random wire blocks (the Q4_K_M type mix by
default) for the loader to read.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from llama_kotlin_tpu_torch.device import DeviceLike, resolve_device
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.quant.fold import (ALIGN_W4, GROUP, compact_planes,
                                               w4_from_parts)
from llama_kotlin_tpu_torch.quant.formats import TYPE_TRAITS, GGMLQuantType
from llama_kotlin_tpu_torch.quant.qtensor import SPAN, QTensor

PRESETS = {
    # name: (n_embd, n_layer, n_head, n_head_kv, n_ff, vocab), the JAX
    # package's rows.  tinyllama-1.1b has 64-wide heads, and its F = 5632
    # is not a multiple of 1024: its down projection's W4 fold is padded to
    # K = 6144, which kernel 2 declines as JAX's does, so its decode FFN
    # runs through kernel 1 (gate|up, then down on the padded K).
    "tinyllama-1.1b": (2048, 22, 32, 4, 5632, 32000),
    "llama3-8b": (4096, 32, 32, 8, 14336, 128256),
    "test-tiny": (1024, 2, 8, 4, 1024, 512),
}


def preset_config(name: str, **overrides) -> ModelConfig:
    e, l, h, kv, f, v = PRESETS[name]
    kw = dict(arch="llama", name=name, n_embd=e, n_layer=l, n_head=h,
              n_head_kv=kv, n_ff=f, vocab_size=v, n_ctx_train=4096)
    kw.update(overrides)
    return ModelConfig(**kw)


def _hi_groups(G: int, device=None) -> torch.Tensor:
    return (torch.arange(G, device=device) % 8) >= 4


def _compact_w4(packed, sc6, m6, d_sb, dmin_sb, shape, precise: bool = False) -> QTensor:
    """W4 compact fold from wire-style parts (torch tensors); precise=True
    re-lays the same weights as the W4X fold that fold_to_w4(precise=True)
    gives for such a Q4_K source: the exact f32 d*sc6 and m_adj planes."""
    s_eff = sc6.to(torch.float32) * d_sb.repeat_interleave(SPAN // GROUP, dim=1)
    m_eff = m6.to(torch.float32) * dmin_sb.repeat_interleave(SPAN // GROUP, dim=1)
    m_adj = torch.where(_hi_groups(s_eff.shape[1], s_eff.device), m_eff - 8.0 * s_eff, m_eff)
    if precise:
        return w4_from_parts(packed, s_eff, m_adj, shape, precise=True)
    return w4_from_parts(packed, s_eff, m_adj, shape,
                         compact_parts=compact_planes(sc6, m6, d_sb, dmin_sb))


def synthetic_w4(rng: np.random.Generator, n: int, k: int, scale: float = 0.02,
                 sym: bool = False, compact: Optional[bool] = None,
                 precise: bool = False, device: DeviceLike = None) -> QTensor:
    """Random W4 fold from a numpy Generator, drawn in the JAX package's
    order (its synthetic_w4), so equal seeds give equal weights.
    precise=True gives the W4X fold (f32 planes, never compact)."""
    dev = resolve_device(device)
    k_pad = (k + ALIGN_W4 - 1) // ALIGN_W4 * ALIGN_W4
    G = k_pad // GROUP
    packed = rng.integers(0, 256, (n, k_pad // 2), dtype=np.uint8)
    if compact is None:
        compact = not sym and not precise
    compact = compact and not sym and not precise and (k_pad // 2) % 1024 == 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if compact:
        S = k_pad // SPAN
        sc6 = rng.integers(0, 64, (n, G), dtype=np.int8)
        m6 = rng.integers(0, 64, (n, G), dtype=np.int8)
        d_sb = (rng.random((n, S), np.float32) * scale / 500.0).astype(
            np.float16).astype(np.float32)
        dmin_sb = (rng.random((n, S), np.float32) * scale / 500.0).astype(
            np.float16).astype(np.float32)
        return _compact_w4(t(packed), t(sc6.astype(np.uint8)), t(m6.astype(np.uint8)),
                           t(d_sb), t(dmin_sb), (n, k))
    s_eff = (rng.random((n, G), np.float32) * scale / 8.0).astype(np.float32)
    is_lo = (np.arange(G) % 8) < 4
    if sym:
        m_adj = np.where(is_lo, 8.0 * s_eff, 0.0).astype(np.float32)
    else:
        m_adj = (rng.random((n, G), np.float32) * scale * 0.5).astype(np.float32)
    return w4_from_parts(t(packed), t(s_eff), t(m_adj), (n, k), sym=sym, precise=precise)


def synthetic_w4_device(gen: torch.Generator, n: int, k: int, scale: float = 0.02,
                        zero_mean: bool = True, precise: bool = False,
                        device: DeviceLike = None) -> QTensor:
    """Random compact W4 fold drawn on the device (Q4_K profile: 6-bit
    scale/min codes under f16-valued superblock d); precise=True gives the
    same weights as a W4X fold (the same draws).

    With zero_mean each group's min is 7.5 times its scale (m6 = sc6,
    dmin = 7.5 d), so the uniform 4-bit codes give zero-mean weights, as a
    trained matrix's groups are.  Independent scale and min draws give
    every row a random mean: a model's outputs then line up along one
    direction and greedy decoding emits the same token whatever the
    prompt.  The kernel checks take zero_mean=False all the same, so that a
    kernel reading the scale plane for the min plane cannot pass."""
    dev = resolve_device(device)
    k_pad = (k + ALIGN_W4 - 1) // ALIGN_W4 * ALIGN_W4
    G, S = k_pad // GROUP, k_pad // SPAN
    kw = dict(generator=gen, device=dev)
    packed = torch.randint(0, 256, (n, k_pad // 2), dtype=torch.uint8, **kw)
    sc6 = torch.randint(0, 64, (n, G), dtype=torch.uint8, **kw)
    d_sb = (torch.rand((n, S), **kw) * (scale / 500.0)).half().float()
    if zero_mean:
        return _compact_w4(packed, sc6, sc6.clone(), d_sb, d_sb * 7.5, (n, k), precise)
    m6 = torch.randint(0, 64, (n, G), dtype=torch.uint8, **kw)
    dmin_sb = (torch.rand((n, S), **kw) * (scale / 500.0)).half().float()
    return _compact_w4(packed, sc6, m6, d_sb, dmin_sb, (n, k), precise)


SYNTHETIC_MODES = ("w4", "w4x")


def synthetic_params_device(cfg: ModelConfig, seed: int = 0,
                            device: DeviceLike = None, mode: str = "w4") -> dict:
    """Random params for `cfg` in the serving layout (wqkv_fused,
    ffn_gateup_fused), drawn on `device` from a seeded torch.Generator:
    every matrix, embedding and lm_head included, a compact W4 fold
    (mode "w4", W4A8) or the W4X fold of the same draws (mode "w4x")."""
    if mode not in SYNTHETIC_MODES:
        raise ValueError(f"mode {mode!r} not in {SYNTHETIC_MODES}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    E, F, V = cfg.n_embd, cfg.n_ff, cfg.vocab_size
    qdim = cfg.n_head * cfg.head_dim
    kvdim = cfg.n_head_kv * cfg.head_dim

    def norm_w():
        return 1.0 + 0.01 * torch.randn(E, generator=gen, device=dev)

    def w(n_, k_):
        return synthetic_w4_device(gen, n_, k_, precise=mode == "w4x", device=dev)

    params: dict = {"tok_embd": w(V, E), "output_norm": norm_w(), "rope_freqs": None,
                    "output": w(V, E), "layers": []}
    for _ in range(cfg.n_layer):
        params["layers"].append({
            "attn_norm": norm_w(), "ffn_norm": norm_w(),
            "wqkv_fused": w(qdim + 2 * kvdim, E), "wo": w(E, qdim),
            "ffn_gateup_fused": w(2 * F, E), "ffn_down": w(E, F)})
    return params


# -- GGUF files of random wire blocks -----------------------------------------

def _f16_bytes(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, "<f2").view(np.uint8).reshape(a.shape + (2,))


def _pack_scale_min_k4(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """(8 scales, 8 mins) of 6 bits -> the 12 packed bytes of a Q4_K block."""
    out = np.empty(sc.shape[:-1] + (12,), np.uint8)
    out[..., 0:4] = (sc[..., :4] & 63) | ((sc[..., 4:] >> 4) << 6)
    out[..., 4:8] = (mn[..., :4] & 63) | ((mn[..., 4:] >> 4) << 6)
    out[..., 8:12] = (sc[..., 4:] & 0x0F) | ((mn[..., 4:] & 0x0F) << 4)
    return out


def wire_blocks(rng: np.random.Generator, qtype: GGMLQuantType, n: int, k: int) -> np.ndarray:
    """Random wire bytes of an [n, k] tensor, flat uint8, with weights of
    std ~0.01-0.04 around zero:

    * Q4_K: zero-mean groups.  m6 = sc6 and dmin = 7.5 d, with d a power of
      two so 7.5 d is exact in f16; the uniform 4-bit codes then centre on
      7.5 (independent mins give every row a mean, and greedy decoding one
      token whatever the prompt);
    * Q4_0: (q - 8) d with codes uniform in 1..15 (zero-mean groups; over
      0..15 every group would have mean -d/2, and 32 such layers steer
      greedy decoding to one token whatever the prompt) and d in
      [2^-9, 2^-7];
    * Q4_1: q d + m with zero-mean groups, m = -7.5 d and d a power of two
      (2^-9 or 2^-8), so m is exact in f16, as in the Q4_K branch;
    * Q6_K: signed 6-bit-range group scales symmetric about 0;
    * Q8_0: uniform int8 codes under f16 scales;
    * F16 and F32: dense weights, normal with std 0.02."""
    if qtype in (GGMLQuantType.F16, GGMLQuantType.F32):
        dense = rng.standard_normal(n * k, dtype=np.float32) * np.float32(0.02)
        return dense.astype("<f2" if qtype == GGMLQuantType.F16 else "<f4").view(np.uint8)
    nb = n * k // TYPE_TRAITS[qtype].block_size
    u8 = lambda *shape: rng.integers(0, 256, shape, dtype=np.uint8)
    if qtype == GGMLQuantType.Q4_K:
        d = np.where(rng.random(nb) < 0.5, 2.0 ** -14, 2.0 ** -13)
        sc = rng.integers(0, 64, (nb, 8), dtype=np.uint8)
        blocks = [_f16_bytes(d), _f16_bytes(7.5 * d), _pack_scale_min_k4(sc, sc), u8(nb, 128)]
    elif qtype == GGMLQuantType.Q4_0:
        q = rng.integers(1, 16, (nb, 2, 16), dtype=np.uint8)
        blocks = [_f16_bytes(rng.uniform(2.0 ** -9, 2.0 ** -7, nb)), q[:, 0] | (q[:, 1] << 4)]
    elif qtype == GGMLQuantType.Q4_1:
        d = np.where(rng.random(nb) < 0.5, 2.0 ** -9, 2.0 ** -8)
        blocks = [_f16_bytes(d), _f16_bytes(-7.5 * d), u8(nb, 16)]
    elif qtype == GGMLQuantType.Q6_K:
        sc = rng.integers(-31, 32, (nb, 16), dtype=np.int8).view(np.uint8)
        d = rng.uniform(2.0 ** -14, 2.0 ** -13, nb)
        blocks = [u8(nb, 128), u8(nb, 64), sc, _f16_bytes(d)]
    elif qtype == GGMLQuantType.Q8_0:
        codes = rng.integers(-127, 128, (nb, 32), dtype=np.int8).view(np.uint8)
        blocks = [_f16_bytes(rng.uniform(2.0 ** -13, 2.0 ** -11, nb)), codes]
    else:
        raise NotImplementedError(f"random {GGMLQuantType(qtype).name} blocks")
    return np.concatenate([b.reshape(nb, -1) for b in blocks], axis=1).reshape(-1)


def q4_k_m_layer_types(n_layer: int) -> list[dict]:
    """llama.cpp's Q4_K_M choice per layer: attn_v and ffn_down take Q6_K
    where use_more_bits(i, n) holds (the first and last eighth of the
    layers and every third one between), Q4_K elsewhere."""
    def more(i):
        return i < n_layer // 8 or i >= 7 * n_layer // 8 or (i - n_layer // 8) % 3 == 2
    return [{"attn_v": GGMLQuantType.Q6_K if more(i) else GGMLQuantType.Q4_K,
             "ffn_down": GGMLQuantType.Q6_K if more(i) else GGMLQuantType.Q4_K}
            for i in range(n_layer)]


# general.file_type of a file whose matrices are all of one type (llama.cpp's
# llama_ftype); a Q4_K file takes the Q4_K_M mix and its code
FILE_TYPES = {GGMLQuantType.Q4_0: 2, GGMLQuantType.Q4_1: 3, GGMLQuantType.Q4_K: 15}


def synthetic_gguf(path, cfg: ModelConfig, seed: int = 0, layer_types: Optional[list] = None,
                   embd_type: Optional[GGMLQuantType] = None,
                   output_type: GGMLQuantType = GGMLQuantType.Q6_K,
                   matrix_type: GGMLQuantType = GGMLQuantType.Q4_K) -> int:
    """Write a llama GGUF of random wire blocks for `cfg`: every layer matrix
    of `matrix_type` but those `layer_types` names (default for Q4_K: the
    Q4_K_M profile, q4_k_m_layer_types; for Q4_0 or Q4_1 none, the
    LLAMA_FTYPE_MOSTLY_Q4_0/Q4_1 files), `token_embd` (embd_type, default
    matrix_type) and `output` (output_type: Q6_K, as llama.cpp quantizes
    it in these files; F16 or F32 make them dense); norms F32 near 1.  Each
    tensor is drawn from one numpy Generator as the writer streams it, so a
    full 8B file never sits whole in host memory.  Returns the file's size."""
    from llama_kotlin_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)
    if layer_types is None:
        layer_types = (q4_k_m_layer_types(cfg.n_layer) if matrix_type == GGMLQuantType.Q4_K
                       else [{}] * cfg.n_layer)
    embd_type = matrix_type if embd_type is None else embd_type
    E, F, V = cfg.n_embd, cfg.n_ff, cfg.vocab_size
    qd, kvd = cfg.n_head * cfg.head_dim, cfg.n_head_kv * cfg.head_dim
    w = GGUFWriter()
    for key, value in (
            ("general.architecture", "llama"), ("general.name", cfg.name or "synthetic"),
            ("general.file_type", np.uint32(FILE_TYPES[matrix_type])),
            ("llama.vocab_size", np.uint32(V)),
            ("llama.context_length", np.uint32(cfg.n_ctx_train)),
            ("llama.embedding_length", np.uint32(E)), ("llama.block_count", np.uint32(cfg.n_layer)),
            ("llama.feed_forward_length", np.uint32(F)),
            ("llama.attention.head_count", np.uint32(cfg.n_head)),
            ("llama.attention.head_count_kv", np.uint32(cfg.n_head_kv)),
            ("llama.rope.dimension_count", np.uint32(cfg.rope_dim)),
            ("llama.rope.freq_base", np.float32(cfg.rope_freq_base)),
            ("llama.attention.layer_norm_rms_epsilon", np.float32(cfg.rms_eps))):
        w.add_kv(key, value)

    def matrix(name, n, k, qtype):
        w.add_tensor_stream(name, (k, n), qtype, lambda: wire_blocks(rng, qtype, n, k))

    def norm(name):
        w.add_tensor_stream(name, (E,), GGMLQuantType.F32,
                            lambda: (1.0 + 0.01 * rng.standard_normal(E)).astype("<f4"))

    matrix("token_embd.weight", V, E, embd_type)
    for i, types in enumerate(layer_types):
        b = f"blk.{i}."
        norm(b + "attn_norm.weight")
        matrix(b + "attn_q.weight", qd, E, matrix_type)
        matrix(b + "attn_k.weight", kvd, E, matrix_type)
        matrix(b + "attn_v.weight", kvd, E, types.get("attn_v", matrix_type))
        matrix(b + "attn_output.weight", E, qd, matrix_type)
        norm(b + "ffn_norm.weight")
        matrix(b + "ffn_gate.weight", F, E, matrix_type)
        matrix(b + "ffn_up.weight", F, E, matrix_type)
        matrix(b + "ffn_down.weight", E, F, types.get("ffn_down", matrix_type))
    norm("output_norm.weight")
    matrix("output.weight", V, E, output_type)
    w.write(path)
    return os.path.getsize(path)


def params_to(params, device: DeviceLike):
    """A copy of a params tree on another device (QTensors and tensors)."""
    dev = resolve_device(device)
    if isinstance(params, QTensor):
        return params.to(dev)
    if isinstance(params, torch.Tensor):
        return params.to(dev)
    if isinstance(params, dict):
        return {k: params_to(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, dev) for v in params]
    return params
