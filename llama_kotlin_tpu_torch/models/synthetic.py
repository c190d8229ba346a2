"""Synthetic models: random weights in every layout the port serves, at
real checkpoint shapes (port of ``llama_kotlin_tpu/models/synthetic.py``).

The host builders (``synthetic_w4``, its sym and precise flavors,
``synthetic_q8flat``, ``synthetic_qtensor`` and ``synthetic_params``, with
its MoE branch) draw from a numpy Generator in the same order as the JAX
package's, so the same seed gives the same weights on both sides.
``synthetic_params_device`` draws every large tensor on the device from a
seeded ``torch.Generator`` — no multi-GB host build — in the modes of
JAX's ``synthetic_params_device``: the W4 fold (sym for a Q4_0 profile;
with a Q8F shadow under ``LKTPU_DUAL_FOLD=1``), W4X, Q8F, exact repacks
and dense bf16, fused or not, with or without a tied head.  ``synthetic_gguf``
writes a llama GGUF file of random wire blocks (the Q4_K_M type mix by
default; the Q5_K_M mix, single-type files and a mix of every format the
loader takes) for the loader to read, and gemma and gemma2 files (a tied
head, gemma2's post norms, window and softcap keys); with a ``MoEShape`` it
writes a llama-architecture MoE file (Mixtral) or a deepseek2 file (MLA, a
dense lead, routed and shared experts) or a qwen2moe file (qkv biases, a
sigmoid-gated shared expert) with the metadata keys the loader reads
(``deepseek_v2_lite``, ``mixtral_8x7b``, ``qwen1_5_moe_a2_7b``,
``gemma2_9b``, ``gemma_7b``, ``qwen2_7b``: their published shapes); and a
file of any llama-shaped, learned-position or LayerNorm-gelu architecture
the port serves, with the tensors its llama.cpp files carry
(``FAMILY_TENSORS``; ``family_config`` gives the config its metadata maps
to; ``falcon_7b`` and ``starcoder_15b`` their published shapes); openelm
files with per-layer head, kv-head and FFN counts written as GGUF arrays
(``openelm_3b``) and bitnet files with per-projection scales and
sub-norms; and the large MoEs' files: dbrx (a fused clamped qkv, its
pre-FFN ``attn_output_norm``), grok (its out-norms) and arctic (a dense
FFN beside the experts, ``ffn_norm_exps``; ``dbrx_base``).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from llama_kotlin_tpu_torch.device import DeviceLike, resolve_device
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.ops.rope import ROPE_TYPE_NEOX, ROPE_TYPE_NONE
from llama_kotlin_tpu_torch.quant.fold import (ALIGN_W4, GROUP, attach_q8_device,
                                               compact_planes, dual_fold_enabled, w4_from_parts)
from llama_kotlin_tpu_torch.quant.formats import TYPE_TRAITS, GGMLQuantType
from llama_kotlin_tpu_torch.quant.iq import IQ_TYPES
from llama_kotlin_tpu_torch.quant.qtensor import SPAN, QTensor

PRESETS = {
    # name: (n_embd, n_layer, n_head, n_head_kv, n_ff, vocab), the JAX
    # package's rows.  tinyllama-1.1b has 64-wide heads, and its F = 5632
    # is not a multiple of 1024: its down projection's W4 fold is padded to
    # K = 6144, which kernel 2 declines as JAX's does, so its decode FFN
    # runs through kernel 1 (gate|up, then down on the padded K).
    # llama2-7b's F = 11008 folds legacy (no multiple of 2048), and
    # llama3-70b's F = 28672 is wider than kernel 2's cooperative stages
    # hold above a few rows (ops/cuda/qmm_w4_ffn.py::coop_fits).
    "tinyllama-1.1b": (2048, 22, 32, 4, 5632, 32000),
    "llama2-7b": (4096, 32, 32, 32, 11008, 32000),
    "llama3-8b": (4096, 32, 32, 8, 14336, 128256),
    # BASELINE.json configs[3]: Mistral-7B long-context (32k) GQA
    "mistral-7b": (4096, 32, 32, 8, 14336, 32000),
    "llama3-70b": (8192, 80, 64, 8, 28672, 128256),
    "test-tiny": (256, 4, 8, 4, 512, 512),
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


def synthetic_q8flat(rng: np.random.Generator, n: int, k: int, scale: float = 0.02,
                     device: DeviceLike = None) -> QTensor:
    """Random Q8F weight (the int8 mode's layout) from a numpy Generator in
    JAX's order: int8 codes and one f32 scale a 256-superblock."""
    k_pad = (k + SPAN - 1) // SPAN * SPAN
    codes = rng.integers(-127, 128, (n, k_pad), dtype=np.int8)
    scales = (rng.random((n, k_pad // SPAN), np.float32) * scale / 127.0).astype(np.float32)
    return _q8f(torch.from_numpy(codes), torch.from_numpy(scales), (n, k)).to(
        resolve_device(device))


def _q8f(codes: torch.Tensor, scales: torch.Tensor, shape: tuple) -> QTensor:
    return QTensor(codes=codes, g_scale=scales, g_min=None, sb_scale=None, sb_min=None,
                   qtype=GGMLQuantType.Q8_0, bits=8, group_size=SPAN, code_offset=0,
                   shape=tuple(shape), aux={"flavor": "q8f"})


def _probe(qtype: GGMLQuantType) -> QTensor:
    """The repacked geometry of a format: its repack of one zero span (JAX
    probes with repack_float of zeros; the layouts are the same)."""
    from llama_kotlin_tpu_torch.quant.repack import repack

    tr = TYPE_TRAITS[qtype]
    return repack(torch.zeros(SPAN // tr.block_size * tr.type_size, dtype=torch.uint8),
                  qtype, 1, SPAN)


def synthetic_qtensor(rng: np.random.Generator, n: int, k: int, qtype: GGMLQuantType,
                      scale: float = 0.02, device: DeviceLike = None) -> QTensor:
    """An exact repack of `qtype` (the exact-dequant mode's layout) with
    random codes and scales, drawn in JAX's order: no float quantization
    pass, the decode cost profile of real weights."""
    probe = _probe(qtype)
    k_pad = (k + SPAN - 1) // SPAN * SPAN
    g = probe.group_size
    cols = k_pad // SPAN * probe.codes.shape[1]
    codes = rng.integers(0, 256, (n, cols), dtype=np.uint8)
    if probe.codes.dtype == torch.int8:
        codes = (codes.view(np.int8) // 4).astype(np.int8)  # keep magnitudes sane
    elif probe.bits == 8:
        codes &= 0x1F  # unsigned byte-stored formats (Q5_K) top out at 31
    npdt = lambda t: torch.empty(0, dtype=t.dtype).numpy().dtype
    if probe.g_scale.is_floating_point():
        g_scale = (rng.random((n, k_pad // g), np.float32) * scale).astype(np.float32)
    else:
        g_scale = rng.integers(0, 64, (n, k_pad // g)).astype(npdt(probe.g_scale))
    g_min = None
    if probe.g_min is not None:
        if probe.g_min.is_floating_point():
            g_min = (rng.random((n, k_pad // g), np.float32) * scale * 0.1).astype(np.float32)
        else:
            g_min = rng.integers(0, 16, (n, k_pad // g)).astype(npdt(probe.g_min))
    sb = lambda: (rng.random((n, k_pad // SPAN), np.float32) * scale / 32).astype(np.float32)
    sb_scale = sb() if probe.sb_scale is not None else None
    sb_min = sb() if probe.sb_min is not None else None
    t = lambda a: None if a is None else torch.from_numpy(a).to(resolve_device(device))
    return QTensor(codes=t(codes), g_scale=t(g_scale), g_min=t(g_min), sb_scale=t(sb_scale),
                   sb_min=t(sb_min), qtype=qtype, bits=probe.bits, group_size=g,
                   code_offset=probe.code_offset, shape=(n, k))


def _rand_weight(rng, n: int, k: int, qtype, fast_int8, fast_w4a8, device):
    """One matrix of synthetic_params, JAX's ``_rand_weight``: dense bf16
    (qtype None or a float type), a W4 fold (fast_w4a8; "w4x" the precise
    one; sym for Q4_0), Q8F (fast_int8) or an exact repack of qtype."""
    if qtype is None or not TYPE_TRAITS[qtype].is_quantized:
        x = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
        return torch.from_numpy(x).to(resolve_device(device), torch.bfloat16)
    if fast_w4a8:
        return synthetic_w4(rng, n, k, precise=fast_w4a8 == "w4x",
                            sym=qtype == GGMLQuantType.Q4_0, device=device)
    if fast_int8:
        return synthetic_q8flat(rng, n, k, device=device)
    return synthetic_qtensor(rng, n, k, qtype, device=device)


def synthetic_params(cfg: ModelConfig, qtype: Optional[GGMLQuantType] = None, seed: int = 0,
                     tie_output: bool = False, fast_int8: bool = False, fast_w4a8=False,
                     device: DeviceLike = None) -> dict:
    """Random params for `cfg` from a numpy Generator, drawn in JAX's order
    (its host ``synthetic_params``), every matmul weight in `qtype`'s layout
    by _rand_weight, unfused; norms f32 near 1.  A MoE cfg draws expert
    stacks by the loader's policy: more than 16 experts draw exact repacks
    and stack them (decode gathers the routed experts); up to 16, a fast
    layout (W4, W8, Q8F) stays a per-expert list, an exact repack stacks; a
    dense draw stacks into one [E, n, k] tensor.  The router is drawn f32
    and kept bf16, as the port's loader keeps it."""
    from llama_kotlin_tpu_torch.models.loader import MAX_EXPERT_LIST
    from llama_kotlin_tpu_torch.quant.qtensor import stack_qtensors

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    E, F, V = cfg.n_embd, cfg.n_ff, cfg.vocab_size
    qdim = cfg.n_head * cfg.head_dim
    kvdim = cfg.n_head_kv * cfg.head_dim

    def norm_w():
        return torch.from_numpy(1.0 + 0.01 * rng.standard_normal(E)).to(dev, torch.float32)

    def w(n_, k_, int8=fast_int8, w4a8=fast_w4a8):
        return _rand_weight(rng, n_, k_, qtype, int8, w4a8, dev)

    params: dict = {"tok_embd": w(V, E), "output_norm": norm_w(), "rope_freqs": None}
    if not tie_output:
        params["output"] = w(V, E)
    params["layers"] = []
    for _ in range(cfg.n_layer):
        lp = {"attn_norm": norm_w(), "wq": w(qdim, E), "wk": w(kvdim, E), "wv": w(kvdim, E),
              "wo": w(E, qdim), "ffn_norm": norm_w()}
        params["layers"].append(lp)
        if cfg.n_expert == 0:
            lp.update(ffn_gate=w(F, E), ffn_up=w(F, E), ffn_down=w(E, F))
            continue
        router = rng.standard_normal((cfg.n_expert, E)) * 0.02
        lp["ffn_gate_inp"] = torch.from_numpy(router).to(dev, torch.float32).to(torch.bfloat16)
        big_e = cfg.n_expert > MAX_EXPERT_LIST
        for key, (nn, kk) in (("ffn_gate_exps", (F, E)), ("ffn_up_exps", (F, E)),
                              ("ffn_down_exps", (E, F))):
            ws = [w(nn, kk, fast_int8 and not big_e, False if big_e else fast_w4a8)
                  for _ in range(cfg.n_expert)]
            if not isinstance(ws[0], QTensor):
                lp[key] = torch.stack(ws)
                continue
            fast = ws[0].aux is not None or (ws[0].bits == 8 and ws[0].group_size == SPAN
                                             and ws[0].g_min is None)
            lp[key] = ws if (fast and not big_e) or ws[0].aux is not None else stack_qtensors(ws)
    return params


def synthetic_w4_device(gen: torch.Generator, n: int, k: int, scale: float = 0.02,
                        zero_mean: bool = True, precise: bool = False, sym: bool = False,
                        device: DeviceLike = None) -> QTensor:
    """Random W4 fold drawn on the device (Q4_K profile: 6-bit scale/min
    codes under f16-valued superblock d): the compact flavor where JAX's
    fold takes it ((k_pad / 2) % 1024 == 0), else the legacy flavor of the
    same draws (their planes rounded to bf16, as that fold stores them);
    precise=True gives the same weights as a W4X fold.  sym=True draws a
    Q4_0 profile's sym fold (W4X sym when precise): group scales and no
    min plane, its codes drawn so that (q - 8) s is zero-mean.

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
    bf16 = lambda t: t.to(torch.bfloat16).to(torch.float32)  # a legacy/sym fold's planes
    if sym:
        # zero-mean groups, as wire_blocks' Q4_0: a low nibble holds the raw
        # code q (1..15, weight (q - 8) s), a high one q - 8 pre-signed (any
        # but -8)
        lo = torch.randint(1, 16, (n, k_pad // 2), dtype=torch.uint8, **kw)
        hi = torch.randint(0, 15, (n, k_pad // 2), dtype=torch.uint8, **kw)
        packed = lo | ((hi + (hi >= 8).to(torch.uint8)) << 4)
        s_eff = bf16(torch.rand((n, G), **kw) * (scale / 8.0))
        m_adj = torch.where(_hi_groups(G, dev), torch.zeros_like(s_eff), 8.0 * s_eff)
        return w4_from_parts(packed, s_eff, m_adj, (n, k), sym=True, precise=precise)
    sc6 = torch.randint(0, 64, (n, G), dtype=torch.uint8, **kw)
    d_sb = (torch.rand((n, S), **kw) * (scale / 500.0)).half().float()
    if zero_mean:
        m6, dmin_sb = sc6.clone(), d_sb * 7.5
    else:
        m6 = torch.randint(0, 64, (n, G), dtype=torch.uint8, **kw)
        dmin_sb = (torch.rand((n, S), **kw) * (scale / 500.0)).half().float()
    if (k_pad // 2) % 1024 == 0:
        return _compact_w4(packed, sc6, m6, d_sb, dmin_sb, (n, k), precise)
    s_eff = sc6.to(torch.float32) * d_sb.repeat_interleave(SPAN // GROUP, dim=1)
    m_eff = m6.to(torch.float32) * dmin_sb.repeat_interleave(SPAN // GROUP, dim=1)
    m_adj = torch.where(_hi_groups(G, dev), m_eff - 8.0 * s_eff, m_eff)
    return w4_from_parts(packed, bf16(s_eff), bf16(m_adj), (n, k), precise=precise)


def synthetic_q8flat_device(gen: torch.Generator, n: int, k: int, scale: float = 0.02,
                            device: DeviceLike = None) -> QTensor:
    """Random Q8F weight drawn on the device (JAX's draw: uniform codes in
    -127..127, scales uniform below scale / 127)."""
    dev = resolve_device(device)
    k_pad = (k + SPAN - 1) // SPAN * SPAN
    codes = torch.randint(-127, 128, (n, k_pad), dtype=torch.int8, generator=gen, device=dev)
    scales = torch.rand((n, k_pad // SPAN), generator=gen, device=dev) * (scale / 127.0)
    return _q8f(codes, scales, (n, k))


def synthetic_qtensor_device(gen: torch.Generator, n: int, k: int, qtype: GGMLQuantType,
                             scale: float = 0.02, device: DeviceLike = None) -> QTensor:
    """An exact repack of `qtype` with random codes and scales drawn on the
    device, JAX's device draw (int8 codes in -32..31, byte-stored 8-bit
    codes in 0..31, random 4- and 2-bit planes; integer group scales in
    0..63; f32 planes uniform below their scale) but for the mins: each
    group's min is its scale times the codes' mean (integer min codes equal
    to the scale codes, the superblock min that mean times the superblock
    scale), so that groups are zero-mean, as the W4 draw's (JAX's draws
    independent mins, and its rows' means steer greedy decoding to one
    token whatever the prompt)."""
    dev = resolve_device(device)
    probe = _probe(qtype)
    k_pad = (k + SPAN - 1) // SPAN * SPAN
    g = probe.group_size
    cols = k_pad // SPAN * probe.codes.shape[1]
    kw = dict(generator=gen, device=dev)

    def rint(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, dtype=torch.int32, **kw).to(dtype)

    def plane(ref, lo, hi, f_scale, shape):
        if ref is None:
            return None
        if ref.is_floating_point():
            return torch.rand(shape, **kw) * f_scale
        return rint(shape, lo, hi, ref.dtype)

    if probe.codes.dtype == torch.int8:
        codes, mean = rint((n, cols), -32, 32, torch.int8), -0.5
    elif probe.bits == 8:
        codes, mean = rint((n, cols), 0, 32, torch.uint8), 15.5
    else:
        codes, mean = rint((n, cols), 0, 256, torch.uint8), (2 ** probe.bits - 1) / 2
    g_scale = plane(probe.g_scale, 0, 64, scale, (n, k_pad // g))
    sb_scale = plane(probe.sb_scale, 0, 0, scale / 32, (n, k_pad // SPAN))
    g_min = sb_min = None
    if probe.g_min is not None:
        if probe.sb_min is not None:  # integer mins under a superblock min
            g_min, sb_min = g_scale.to(probe.g_min.dtype), sb_scale * mean
        else:
            g_min = g_scale.to(torch.float32) * mean
    return QTensor(codes=codes, g_scale=g_scale, g_min=g_min, sb_scale=sb_scale,
                   sb_min=sb_min, qtype=qtype, bits=probe.bits, group_size=g,
                   code_offset=probe.code_offset, shape=(n, k))


# the modes of synthetic_params_device: JAX's fast_w4a8 (True / "w4x"),
# fast_int8, an exact repack of qtype (bench.py's BENCH_MODE=dequant) and
# qtype=None (dense)
SYNTHETIC_MODES = ("w4", "w4x", "int8", "dequant", "dense")


def synthetic_params_device(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
                            mode: str = "w4", qtype: Optional[GGMLQuantType] = GGMLQuantType.Q4_K,
                            fuse: bool = True, tie_output: bool = False) -> dict:
    """Random params for `cfg` drawn on `device` from a seeded
    torch.Generator, every matrix (the embedding and the lm_head included)
    in the layout of `mode`:

    * "w4": the W4 fold (W4A8), compact where JAX's fold is (sym for
      qtype Q4_0), with a Q8F shadow under ``LKTPU_DUAL_FOLD=1``
      (``quant/fold.py::attach_q8_device``);
    * "w4x": the W4X fold of the same draws (W4X sym for Q4_0);
    * "int8": Q8F;
    * "dequant": exact repacks of qtype (Q4_K by default), kernel 4's exact
      branches (kernel 6 for Q8_K);
    * "dense": bf16 matrices (also any mode with qtype None or a float type).

    fuse=True (the serving layout) draws wqkv_fused and ffn_gateup_fused,
    fuse=False wq/wk/wv and ffn_gate/ffn_up apart; tie_output draws no
    "output" (the head is tok_embd).  MoE configs raise, as JAX's: the host
    synthetic_params draws them."""
    if mode not in SYNTHETIC_MODES:
        raise ValueError(f"mode {mode!r} not in {SYNTHETIC_MODES}")
    if cfg.n_expert > 0:
        raise NotImplementedError("synthetic_params_device: use synthetic_params for MoE cfgs")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    E, F, V = cfg.n_embd, cfg.n_ff, cfg.vocab_size
    qdim = cfg.n_head * cfg.head_dim
    kvdim = cfg.n_head_kv * cfg.head_dim
    dense = mode == "dense" or qtype is None or not TYPE_TRAITS[qtype].is_quantized
    sym = qtype == GGMLQuantType.Q4_0
    dual = mode == "w4" and dual_fold_enabled()

    def norm_w():
        return 1.0 + 0.01 * torch.randn(E, generator=gen, device=dev)

    def w(n_, k_):
        if dense:
            return (torch.randn((n_, k_), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        if mode == "int8":
            return synthetic_q8flat_device(gen, n_, k_, device=dev)
        if mode == "dequant":
            return synthetic_qtensor_device(gen, n_, k_, qtype, device=dev)
        w4 = synthetic_w4_device(gen, n_, k_, precise=mode == "w4x", sym=sym, device=dev)
        return attach_q8_device(w4) if dual else w4

    params: dict = {"tok_embd": w(V, E), "output_norm": norm_w(), "rope_freqs": None}
    if not tie_output:
        params["output"] = w(V, E)
    params["layers"] = []
    for _ in range(cfg.n_layer):
        lp = {"attn_norm": norm_w(), "ffn_norm": norm_w()}
        if fuse:
            lp["wqkv_fused"] = w(qdim + 2 * kvdim, E)
        else:
            lp.update(wq=w(qdim, E), wk=w(kvdim, E), wv=w(kvdim, E))
        lp["wo"] = w(E, qdim)
        if fuse:
            lp["ffn_gateup_fused"] = w(2 * F, E)
        else:
            lp.update(ffn_gate=w(F, E), ffn_up=w(F, E))
        lp["ffn_down"] = w(E, F)
        params["layers"].append(lp)
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


def _pack_q3k_scales(sc: np.ndarray) -> np.ndarray:
    """16 signed 6-bit scales -> the 12 packed bytes of a Q3_K block (the
    inverse of ``quant/repack.py::unpack_q3k_scales``)."""
    u = (sc.astype(np.int16) + 32).astype(np.uint8)
    out = np.empty(u.shape[:-1] + (12,), np.uint8)
    out[..., 0:4] = (u[..., 0:4] & 0x0F) | ((u[..., 8:12] & 0x0F) << 4)
    out[..., 4:8] = (u[..., 4:8] & 0x0F) | ((u[..., 12:16] & 0x0F) << 4)
    out[..., 8:12] = (((u[..., 0:4] >> 4) & 3) | (((u[..., 4:8] >> 4) & 3) << 2)
                      | (((u[..., 8:12] >> 4) & 3) << 4) | (((u[..., 12:16] >> 4) & 3) << 6))
    return out


def _q5_legacy(q: np.ndarray) -> list:
    """Five-bit codes [nb, 32] (element order) -> (qh as 4 little-endian
    bytes, qs 16 bytes): bit j of qh is code j's fifth bit, bit 16 + j code
    16 + j's; qs byte j holds code j's low nibble and code 16 + j's high."""
    qh = np.packbits(q >> 4, axis=1, bitorder="little")  # bit j: code j's fifth bit
    return [qh, (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)]


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
    * Q6_K: (q - 32) (d sc) with codes uniform in 1..63 (zero-mean groups:
      over 0..63 every group had mean -d sc / 2, and through gemma's tied
      Q6_K embedding one token won whatever the prompt) and signed 6-bit
      group scales symmetric about 0;
    * Q8_0: uniform int8 codes under f16 scales;
    * Q5_0: (q - 16) d with codes uniform in 1..31 (zero-mean groups, as
      Q4_0's);
    * Q5_1: q d + m with m = -15.5 d, d a power of two (zero-mean groups);
    * Q2_K: q (d sc) - (dmin mn) with mn = sc and dmin = 1.5 d, d a power of
      two (zero-mean groups of 16);
    * Q3_K: (d sc) q with codes uniform in -3..3 (the -4 the format could
      hold is never drawn, so groups are zero-mean) and signed scales;
    * Q5_K: Q4_K's rule with 5-bit codes: mn = sc and dmin = 15.5 d;
    * Q8_K: uniform int8 codes under an f32 scale, with their bsums;
    * the nine IQ formats (_iq_blocks): random grid index, sign and scale
      bytes as JAX's tests draw them (tests/test_iq_quants.py), under a
      pinned f16 d of one of two powers of two per format;
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
        q = rng.integers(1, 64, (nb, 2, 4, 32), dtype=np.uint8)  # element 128 h + 32 i + l
        ql = np.stack([(q[:, :, 0] & 0x0F) | ((q[:, :, 2] & 0x0F) << 4),
                       (q[:, :, 1] & 0x0F) | ((q[:, :, 3] & 0x0F) << 4)], axis=2)
        qh = ((q[:, :, 0] >> 4) | ((q[:, :, 1] >> 4) << 2) | ((q[:, :, 2] >> 4) << 4)
              | ((q[:, :, 3] >> 4) << 6))
        sc = rng.integers(-31, 32, (nb, 16), dtype=np.int8).view(np.uint8)
        d = rng.uniform(2.0 ** -14, 2.0 ** -13, nb)
        blocks = [ql.reshape(nb, 128), qh.reshape(nb, 64), sc, _f16_bytes(d)]
    elif qtype == GGMLQuantType.Q8_0:
        codes = rng.integers(-127, 128, (nb, 32), dtype=np.int8).view(np.uint8)
        blocks = [_f16_bytes(rng.uniform(2.0 ** -13, 2.0 ** -11, nb)), codes]
    elif qtype == GGMLQuantType.Q5_0:
        q = rng.integers(1, 32, (nb, 32), dtype=np.uint8)
        blocks = [_f16_bytes(rng.uniform(2.0 ** -10, 2.0 ** -8, nb)), *_q5_legacy(q)]
    elif qtype == GGMLQuantType.Q5_1:
        d = np.where(rng.random(nb) < 0.5, 2.0 ** -10, 2.0 ** -9)
        q = rng.integers(0, 32, (nb, 32), dtype=np.uint8)
        blocks = [_f16_bytes(d), _f16_bytes(-15.5 * d), *_q5_legacy(q)]
    elif qtype == GGMLQuantType.Q2_K:
        sc = rng.integers(1, 16, (nb, 16), dtype=np.uint8)
        d = np.where(rng.random(nb) < 0.5, 2.0 ** -10, 2.0 ** -9)
        blocks = [sc | (sc << 4), u8(nb, 64), _f16_bytes(d), _f16_bytes(1.5 * d)]
    elif qtype == GGMLQuantType.Q3_K:
        q = rng.integers(-3, 4, (nb, 2, 4, 32), dtype=np.int8)  # [half, shift/2, l]
        low = np.where(q >= 0, q, q + 4).astype(np.uint8)
        qs = (low[:, :, 0] | (low[:, :, 1] << 2) | (low[:, :, 2] << 4) | (low[:, :, 3] << 6))
        hset = (q >= 0).astype(np.uint8).reshape(nb, 8, 32)  # bit 4 half + shift/2
        hmask = (hset << np.arange(8, dtype=np.uint8)[:, None]).sum(axis=1, dtype=np.uint8)
        sc = rng.integers(-31, 32, (nb, 16), dtype=np.int8)
        blocks = [hmask, qs.reshape(nb, 64), _pack_q3k_scales(sc),
                  _f16_bytes(rng.uniform(2.0 ** -12, 2.0 ** -10, nb))]
    elif qtype == GGMLQuantType.Q5_K:
        d = np.where(rng.random(nb) < 0.5, 2.0 ** -15, 2.0 ** -14)
        sc = rng.integers(0, 64, (nb, 8), dtype=np.uint8)
        blocks = [_f16_bytes(d), _f16_bytes(15.5 * d), _pack_scale_min_k4(sc, sc),
                  u8(nb, 32), u8(nb, 128)]
    elif qtype == GGMLQuantType.Q8_K:
        codes = rng.integers(-127, 128, (nb, 256), dtype=np.int8)
        bsums = codes.reshape(nb, 16, 16).sum(axis=-1, dtype=np.int16).astype("<i2")
        d = rng.uniform(2.0 ** -13, 2.0 ** -11, nb).astype("<f4")
        blocks = [d.view(np.uint8), codes.view(np.uint8), bsums.view(np.uint8)]
    elif qtype in IQ_D:
        return _iq_blocks(rng, qtype, nb).reshape(-1)
    else:
        raise NotImplementedError(f"random {GGMLQuantType(qtype).name} blocks")
    return np.concatenate([b.reshape(nb, -1) for b in blocks], axis=1).reshape(-1)


# the smaller of the two f16 d a format's blocks draw: weights of std
# 0.013-0.035 over random grid, sign and scale bytes
IQ_D = {GGMLQuantType.IQ2_XXS: 2.0 ** -12, GGMLQuantType.IQ2_XS: 2.0 ** -12,
        GGMLQuantType.IQ2_S: 2.0 ** -12, GGMLQuantType.IQ3_XXS: 2.0 ** -13,
        GGMLQuantType.IQ3_S: 2.0 ** -13, GGMLQuantType.IQ1_S: 2.0 ** -9,
        GGMLQuantType.IQ1_M: 2.0 ** -9, GGMLQuantType.IQ4_NL: 2.0 ** -12,
        GGMLQuantType.IQ4_XS: 2.0 ** -16}
# IQ4's level indices drawn: all but -49, -35 and -10 (indices 4, 5, 7), the
# rest summing to 0, so groups are zero-mean (the 16 levels average -5.9)
IQ4_CENTRED = np.array([0, 1, 2, 3, 6, 8, 9, 10, 11, 12, 13, 14, 15], np.uint8)


def _iq_blocks(rng: np.random.Generator, qtype: GGMLQuantType, nb: int) -> np.ndarray:
    """nb random blocks of an IQ format [nb, type_size]: random bytes (grid
    indices, signs, scales), then d pinned to IQ_D or twice it.  IQ1_M's d
    is assembled from the top nibbles of its four scale words, which are
    set to d's f16 bits; IQ4_NL and IQ4_XS take level indices from
    IQ4_CENTRED."""
    b = rng.integers(0, 256, (nb, TYPE_TRAITS[qtype].type_size), dtype=np.uint8)
    d = np.where(rng.random(nb) < 0.5, IQ_D[qtype], 2 * IQ_D[qtype]).astype(np.float16)
    if qtype == GGMLQuantType.IQ1_M:
        bits = d.view(np.uint16).astype(np.uint16)
        sc = b[:, 48:56].copy().view("<u2").reshape(nb, 4)
        for i in range(4):
            sc[:, i] = (sc[:, i] & 0x0FFF) | (((bits >> (4 * i)) & 0xF) << 12)
        b[:, 48:56] = sc.view(np.uint8).reshape(nb, 8)
        return b
    b[:, 0:2] = d.astype("<f2").view(np.uint8).reshape(nb, 2)
    if qtype in (GGMLQuantType.IQ4_NL, GGMLQuantType.IQ4_XS):
        lo = 2 if qtype == GGMLQuantType.IQ4_NL else 8
        idx = IQ4_CENTRED[rng.integers(0, len(IQ4_CENTRED), (nb, b.shape[1] - lo, 2))]
        b[:, lo:] = idx[..., 0] | (idx[..., 1] << 4)
    return b


def q4_k_m_layer_types(n_layer: int) -> list[dict]:
    """llama.cpp's Q4_K_M choice per layer: attn_v and ffn_down take Q6_K
    where use_more_bits(i, n) holds (the first and last eighth of the
    layers and every third one between), Q4_K elsewhere."""
    def more(i):
        return i < n_layer // 8 or i >= 7 * n_layer // 8 or (i - n_layer // 8) % 3 == 2
    return [{"attn_v": GGMLQuantType.Q6_K if more(i) else GGMLQuantType.Q4_K,
             "ffn_down": GGMLQuantType.Q6_K if more(i) else GGMLQuantType.Q4_K}
            for i in range(n_layer)]


def q5_k_m_layer_types(n_layer: int) -> list[dict]:
    """llama.cpp's Q5_K_M choice per layer (llama_tensor_get_type for
    LLAMA_FTYPE_MOSTLY_Q5_K_M): Q6_K for attn_v and ffn_down where Q4_K_M
    takes Q6_K (use_more_bits), Q5_K elsewhere."""
    return [{name: GGMLQuantType.Q5_K if t == GGMLQuantType.Q4_K else t
             for name, t in types.items()} for types in q4_k_m_layer_types(n_layer)]


# the matrices of a layer, in the order synthetic_gguf writes them
LAYER_MATRICES = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up",
                  "ffn_down")
# every quantized wire format the loader takes, for every_format_layer_types
EVERY_FORMAT = (GGMLQuantType.Q5_0, GGMLQuantType.Q5_1, GGMLQuantType.Q2_K,
                GGMLQuantType.Q3_K, GGMLQuantType.Q5_K, GGMLQuantType.Q4_0,
                GGMLQuantType.Q4_1, GGMLQuantType.Q8_0, GGMLQuantType.Q6_K,
                GGMLQuantType.Q4_K)


EVERY_IQ = IQ_TYPES  # the nine IQ formats, for every_iq_layer_types


def every_iq_layer_types(n_layer: int) -> list[dict]:
    """A synthetic mix that puts each of the nine IQ formats on some matrix,
    as every_format_layer_types does the k-quant and legacy formats: the
    layers' matrices cycle through EVERY_IQ, so two layers (14 matrices)
    hold all nine, and no two projections of a layer share a type."""
    cyc = len(EVERY_IQ)
    return [{name: EVERY_IQ[(i * len(LAYER_MATRICES) + j) % cyc]
             for j, name in enumerate(LAYER_MATRICES)} for i in range(n_layer)]


def every_format_layer_types(n_layer: int) -> list[dict]:
    """A synthetic mix that puts each of EVERY_FORMAT on some matrix: the
    layers' matrices, in LAYER_MATRICES order, cycle through the formats,
    so two layers (14 matrices) hold all ten.  No two projections of a
    layer share a type, so none fuses."""
    cyc = len(EVERY_FORMAT)
    return [{name: EVERY_FORMAT[(i * len(LAYER_MATRICES) + j) % cyc]
             for j, name in enumerate(LAYER_MATRICES)} for i in range(n_layer)]


# general.file_type of a file whose matrices are mostly of one type (llama.cpp's
# llama_ftype); a Q4_K file takes the Q4_K_M mix and its code, a Q5_K file
# the Q5_K_M mix
FILE_TYPES = {GGMLQuantType.Q4_0: 2, GGMLQuantType.Q4_1: 3, GGMLQuantType.Q8_0: 7,
              GGMLQuantType.Q5_0: 8, GGMLQuantType.Q5_1: 9, GGMLQuantType.Q2_K: 10,
              GGMLQuantType.Q3_K: 12, GGMLQuantType.Q4_K: 15, GGMLQuantType.Q5_K: 17,
              GGMLQuantType.Q6_K: 18, GGMLQuantType.IQ2_XXS: 19, GGMLQuantType.IQ2_XS: 20,
              GGMLQuantType.IQ3_XXS: 23, GGMLQuantType.IQ1_S: 24, GGMLQuantType.IQ4_NL: 25,
              GGMLQuantType.IQ3_S: 26, GGMLQuantType.IQ2_S: 28, GGMLQuantType.IQ4_XS: 30,
              GGMLQuantType.IQ1_M: 31}
DEFAULT_MIX = {GGMLQuantType.Q4_K: q4_k_m_layer_types, GGMLQuantType.Q5_K: q5_k_m_layer_types}

# the quantize tool's file types (JAX llama_kotlin_tpu/tools/quantize.py::
# FTYPES): name -> the default matrix type
FTYPES = {
    "Q4_0": GGMLQuantType.Q4_0, "Q4_1": GGMLQuantType.Q4_1, "Q5_0": GGMLQuantType.Q5_0,
    "Q5_1": GGMLQuantType.Q5_1, "Q8_0": GGMLQuantType.Q8_0, "Q2_K": GGMLQuantType.Q2_K,
    "Q3_K_S": GGMLQuantType.Q3_K, "Q3_K_M": GGMLQuantType.Q3_K,
    "Q4_K_S": GGMLQuantType.Q4_K, "Q4_K_M": GGMLQuantType.Q4_K,
    "Q5_K_S": GGMLQuantType.Q5_K, "Q5_K_M": GGMLQuantType.Q5_K, "Q6_K": GGMLQuantType.Q6_K,
    "IQ2_XXS": GGMLQuantType.IQ2_XXS, "IQ2_XS": GGMLQuantType.IQ2_XS,
    "IQ3_XXS": GGMLQuantType.IQ3_XXS, "IQ3_S": GGMLQuantType.IQ3_S,
    "IQ4_NL": GGMLQuantType.IQ4_NL, "IQ4_XS": GGMLQuantType.IQ4_XS,
    "F16": GGMLQuantType.F16, "BF16": GGMLQuantType.BF16, "F32": GGMLQuantType.F32,
}


def tensor_get_type(name: str, default: GGMLQuantType, ftype: str,
                    n_expert: int = 0) -> GGMLQuantType:
    """The quantize tool's per-tensor type (JAX ``tools/quantize.py::
    tensor_get_type``, llama.cpp's llama_tensor_get_type): the lm_head at
    Q6_K under the 2-5-bit k-quants and legacy types, Q5_K under the low IQ
    types; token_embd Q4_K under IQ2_XXS, IQ2_XS, IQ3_XXS and Q2_K; the
    *_M mixes bump attn_v and ffn_down."""
    is_m = ftype.endswith("_M")
    if name == "output.weight" and TYPE_TRAITS[default].is_quantized:
        if default in (GGMLQuantType.Q2_K, GGMLQuantType.Q3_K, GGMLQuantType.Q4_K,
                       GGMLQuantType.Q5_K, GGMLQuantType.Q4_0, GGMLQuantType.Q4_1,
                       GGMLQuantType.Q5_0, GGMLQuantType.Q5_1):
            return GGMLQuantType.Q6_K
    iq_low = (GGMLQuantType.IQ2_XXS, GGMLQuantType.IQ2_XS, GGMLQuantType.IQ3_XXS)
    if name == "output.weight" and default in iq_low + (GGMLQuantType.IQ3_S,):
        return GGMLQuantType.Q5_K
    if name == "token_embd.weight" and default in iq_low:
        return GGMLQuantType.Q4_K
    if name == "token_embd.weight" and default == GGMLQuantType.Q2_K:
        return GGMLQuantType.Q4_K
    if ".attn_v.weight" in name and is_m:
        bump = {GGMLQuantType.Q2_K: GGMLQuantType.Q4_K, GGMLQuantType.Q3_K: GGMLQuantType.Q5_K,
                GGMLQuantType.Q4_K: GGMLQuantType.Q6_K, GGMLQuantType.Q5_K: GGMLQuantType.Q6_K}
        return bump.get(default, default)
    if ".ffn_down" in name and is_m:
        bump = {GGMLQuantType.Q3_K: GGMLQuantType.Q4_K, GGMLQuantType.Q4_K: GGMLQuantType.Q6_K}
        return bump.get(default, default)
    return default


def ftype_profile(n_layer: int, ftype: str) -> dict:
    """synthetic_gguf's type arguments (matrix_type, layer_types,
    embd_type, output_type) of a file the quantize tool makes at `ftype`,
    tensor by tensor through tensor_get_type: e.g. "IQ2_XXS" gives IQ2_XXS
    layers, a Q4_K token_embd and a Q5_K output."""
    default = FTYPES[ftype]
    layers = [{m: tensor_get_type(f"blk.{i}.{m}.weight", default, ftype)
               for m in LAYER_MATRICES} for i in range(n_layer)]
    return {"matrix_type": default, "layer_types": layers,
            "embd_type": tensor_get_type("token_embd.weight", default, ftype),
            "output_type": tensor_get_type("output.weight", default, ftype)}


# the public Llama-2 chat template (a jinja string, as HF ships it): the
# chat module detects it as "llama2" with a system prompt, BOS inside the
# history, stripped messages and spaces around a response
LLAMA2_CHAT_TEMPLATE = (
    "{% if messages[0]['role'] == 'system' %}{% set loop_messages = messages[1:] %}"
    "{% set system_message = messages[0]['content'] %}{% else %}"
    "{% set loop_messages = messages %}{% set system_message = false %}{% endif %}"
    "{% for message in loop_messages %}"
    "{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}"
    "{{ raise_exception('Conversation roles must alternate user/assistant/user/assistant/...') }}"
    "{% endif %}{% if loop.index0 == 0 and system_message != false %}"
    "{% set content = '<<SYS>>\\n' + system_message + '\\n<</SYS>>\\n\\n' + message['content'] %}"
    "{% else %}{% set content = message['content'] %}{% endif %}"
    "{% if message['role'] == 'user' %}{{ bos_token + '[INST] ' + content.strip() + ' [/INST]' }}"
    "{% elif message['role'] == 'assistant' %}{{ ' '  + content.strip() + ' ' + eos_token }}"
    "{% endif %}{% endfor %}")


def synthetic_spm_vocab(vocab_size: int, chat_template: Optional[str] = LLAMA2_CHAT_TEMPLATE
                        ) -> dict:
    """SPM tokenizer metadata of exactly `vocab_size` pieces for a synthetic
    GGUF (synthetic_gguf's extra_kvs): <unk>, <s>, </s>, the 256 byte-fallback
    tokens <0x00>-<0xFF>, then word pieces: U+2581 (the escaped space),
    letters, digits and punctuation, every 2- and 3-letter lowercase piece
    with and without a leading U+2581, then U+2581 + 4-letter pieces in
    order; each longer piece is one merge of shorter ones, so the SPM merge
    reaches it.  Scores fall with the id; `chat_template` (None: none) goes
    into tokenizer.chat_template."""
    import itertools
    import string

    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [2, 3, 3] + [6] * 256
    sp = "\u2581"
    low = string.ascii_lowercase
    singles = ([sp] + list(low) + list(string.ascii_uppercase) + list(string.digits)
               + list(".,!?;:'\"-()[]{}<>/\\@#$%&*+=_|~`^"))
    words = singles + [sp + c for c in low + string.ascii_uppercase + string.digits]
    for n in (2, 3):
        combos = ["".join(t) for t in itertools.product(low, repeat=n)]
        words += combos + [sp + c for c in combos]
    words = iter(words + [sp + "".join(t) for t in itertools.product(low, repeat=4)])
    while len(toks) < vocab_size:
        toks.append(next(words))
        types.append(1)
    if len(toks) > vocab_size:
        raise ValueError(f"vocab_size {vocab_size} is below the {len(toks)} fixed pieces")
    kv = {"tokenizer.ggml.model": "llama",
          "tokenizer.ggml.tokens": toks,
          "tokenizer.ggml.scores": -np.arange(len(toks), dtype=np.float32),
          "tokenizer.ggml.token_type": np.asarray(types, np.int32),
          "tokenizer.ggml.bos_token_id": np.uint32(1),
          "tokenizer.ggml.eos_token_id": np.uint32(2),
          "tokenizer.ggml.unknown_token_id": np.uint32(0)}
    if chat_template is not None:
        kv["tokenizer.chat_template"] = chat_template
    return kv


GEMMA_ARCHES = ("gemma", "gemma2")  # tied heads and (1 + w) norms
# the tensors a family file carries beside a llama layer's, as llama.cpp's
# converters write them and JAX's loader reads them: q/k/v biases
# ("qkv_bias"), a fused attn_qkv ("fused_qkv", with a fused bias where the
# biases are), the o and FFN biases ("out_bias"; "ffn_bias": up and down,
# "gate_bias": jais's gate too), LayerNorm biases on every norm
# ("norm_bias"), per-head q/k norms ("head": [head_dim], stablelm; "heads":
# [n_head, head_dim], command-r), no ffn_norm (a shared-norm parallel
# block), no norm weights at all (olmo's non-parametric LayerNorm), no
# output (a tied head) and no ffn_gate (a non-gated FFN; codeshell's config
# says so, starcoder2's file alone); the learned-position family's
# position table ("pos_embd": gpt2, starcoder; context_length rows, F32, as
# llama.cpp leaves it unquantized), the embedding LayerNorm ("tok_norm":
# bloom), the output bias ("output_bias": phi2), chatglm's packed
# [gate|up] ffn_up ("packed_up", 2 n_ff rows) and falcon's second norm
# ("attn_norm_2": its new decoder architecture, in files with several kv
# heads: falcon-40b and -180b; falcon-7b's one kv head has one norm); and
# bitnet's seven per-projection scales (F32 [1]) and two sub-norms
# ("bitnet"); openelm's layers take their own widths (the config's arrays)
FAMILY_TENSORS = {
    "qwen2": dict(qkv_bias=True),
    "qwen": dict(qkv_bias=True, fused_qkv=True),
    "stablelm": dict(qkv_bias=True, qk_norm="head", norm_bias=True),
    "phi3": dict(fused_qkv=True),
    "minicpm": dict(tied=True),
    "starcoder2": dict(qkv_bias=True, out_bias=True, ffn_bias=True, norm_bias=True,
                       gated=False),
    "plamo": dict(ffn_norm=False),
    "orion": dict(norm_bias=True),
    "command-r": dict(qk_norm="heads", ffn_norm=False),
    "olmo": dict(norms=False),
    "codeshell": dict(qkv_bias=True, fused_qkv=True, out_bias=True, ffn_bias=True,
                      norm_bias=True),
    "gpt2": dict(qkv_bias=True, fused_qkv=True, out_bias=True, ffn_bias=True, norm_bias=True,
                 pos_embd=True),
    "starcoder": dict(qkv_bias=True, fused_qkv=True, out_bias=True, ffn_bias=True,
                      norm_bias=True, pos_embd=True, tied=True),
    "gptneox": dict(qkv_bias=True, fused_qkv=True, out_bias=True, ffn_bias=True,
                    norm_bias=True),
    "falcon": dict(fused_qkv=True, norm_bias=True, ffn_norm=False, attn_norm_2=True),
    "mpt": dict(fused_qkv=True, tied=True),
    "phi2": dict(qkv_bias=True, out_bias=True, ffn_bias=True, norm_bias=True, ffn_norm=False,
                 output_bias=True),
    "bloom": dict(qkv_bias=True, fused_qkv=True, out_bias=True, ffn_bias=True, norm_bias=True,
                  tok_norm=True, tied=True),
    "jais": dict(qkv_bias=True, fused_qkv=True, out_bias=True, ffn_bias=True, gate_bias=True,
                 norm_bias=True, tied=True),
    "nemotron": dict(norm_bias=True),
    "chatglm": dict(qkv_bias=True, fused_qkv=True, packed_up=True),
    "openelm": dict(fused_qkv=True, qk_norm="head", tied=True),
    "bitnet": dict(bitnet=True, tied=True),
}
# the dense architectures synthetic_gguf writes: llama, gemma, the
# llama-shaped family and the learned-position and LayerNorm-gelu family
# (qwen2moe is a MoE file: moe=)
DENSE_ARCHES = ("llama", "gemma", "gemma2", "qwen2", "qwen", "stablelm", "phi3", "internlm2",
                "minicpm", "xverse", "exaone", "baichuan", "starcoder2", "refact", "plamo",
                "orion", "command-r", "olmo", "codeshell", "gpt2", "starcoder", "gptneox",
                "falcon", "mpt", "phi2", "bloom", "jais", "nemotron", "chatglm", "openelm",
                "bitnet")
# archs whose files carry attention.max_alibi_bias (llama.cpp's mpt and jais
# read it; bloom's default 8 stands)
ALIBI_KEY_ARCHES = ("mpt", "jais")


def family_config(arch: str, n_layer: int = 2, n_embd: int = 256, n_head: int = 4,
                  n_head_kv: int = 2, n_ff: int = 512, vocab_size: int = 512,
                  **keys) -> ModelConfig:
    """The ModelConfig config_from_metadata gives a file of `arch` (one of
    DENSE_ARCHES) at these widths, with the arch's own keys in `keys`
    (named as file_metadata writes them: swa_window, clamp_kqv,
    logit_scale, rope_dim, head_dim, rope_freq_base, rms_eps, norm_eps,
    n_ctx_train (a position table's rows), parallel_residual (gptneox),
    max_alibi_bias (mpt, jais), openelm's per-layer n_head_arr,
    n_head_kv_arr and n_ff_arr, whose maxima replace n_head, n_head_kv and
    n_ff); synthetic_gguf writes such a file.  baichuan attends with ALiBi
    from 40 layers (baichuan-13B), as config_from_metadata rules."""
    from llama_kotlin_tpu_torch.models.config import config_from_metadata

    n_head = max(keys.get("n_head_arr") or (n_head,))
    n_head_kv = max(keys.get("n_head_kv_arr") or (n_head_kv,))
    n_ff = max(keys.get("n_ff_arr") or (n_ff,))
    base = ModelConfig(arch=arch, name=f"synthetic-{arch}", vocab_size=vocab_size,
                       n_embd=n_embd, n_layer=n_layer, n_head=n_head, n_head_kv=n_head_kv,
                       n_ff=n_ff, **{k: v for k, v in keys.items()
                                     if k in ("head_dim", "rope_dim")})
    # the arch's defaults decide which keys the file has: the norm's epsilon
    # key, gptneox's use_parallel_residual, mpt's and jais's ALiBi bias
    bare = config_from_metadata({"general.architecture": arch})
    base.use_rms_norm = bare.use_rms_norm
    base.parallel_residual = bare.parallel_residual
    base.max_alibi_bias = bare.max_alibi_bias
    for k, v in keys.items():
        setattr(base, k, v)
    return config_from_metadata(dict(file_metadata(base)))


def _count(arr: Optional[tuple], value: int):
    """A head or FFN count as a GGUF value: its per-layer array, or the scalar."""
    return np.asarray(arr, np.uint32) if arr else np.uint32(value)


def file_metadata(cfg: ModelConfig, matrix_type: GGMLQuantType = GGMLQuantType.Q4_K) -> list:
    """The (key, value) metadata of synthetic_gguf's dense file, under
    cfg.arch (the keys llama.cpp's converter writes): a gemma or gemma2
    file, or any whose head width is not n_embd / n_head, adds its head
    widths; a sliding window, gemma2's logit softcaps, olmo's clamp_kqv and
    command-r's logit_scale where the config has them; gptneox's
    use_parallel_residual and mpt's and jais's max_alibi_bias; the norm
    epsilon under the key of the arch's norm; openelm's head widths and its
    per-layer head, kv-head and FFN counts as arrays."""
    a = cfg.arch
    if a not in DENSE_ARCHES:
        raise ValueError(f"synthetic_gguf writes {DENSE_ARCHES} dense files, not {a!r}")
    eps_key, eps = (("layer_norm_rms_epsilon", cfg.rms_eps) if cfg.use_rms_norm
                    else ("layer_norm_epsilon", cfg.norm_eps))
    kv = [("general.architecture", a), ("general.name", cfg.name or "synthetic"),
          ("general.file_type", np.uint32(FILE_TYPES[matrix_type])),
          (f"{a}.vocab_size", np.uint32(cfg.vocab_size)),
          (f"{a}.context_length", np.uint32(cfg.n_ctx_train)),
          (f"{a}.embedding_length", np.uint32(cfg.n_embd)),
          (f"{a}.block_count", np.uint32(cfg.n_layer)),
          (f"{a}.feed_forward_length", _count(cfg.n_ff_arr, cfg.n_ff)),
          (f"{a}.attention.head_count", _count(cfg.n_head_arr, cfg.n_head)),
          (f"{a}.attention.head_count_kv", _count(cfg.n_head_kv_arr, cfg.n_head_kv)),
          (f"{a}.rope.dimension_count", np.uint32(cfg.rope_dim)),
          (f"{a}.rope.freq_base", np.float32(cfg.rope_freq_base)),
          (f"{a}.attention.{eps_key}", np.float32(eps))]
    if a in GEMMA_ARCHES or a == "openelm" or cfg.head_dim * cfg.n_head != cfg.n_embd:
        kv += [(f"{a}.attention.key_length", np.uint32(cfg.head_dim)),
               (f"{a}.attention.value_length", np.uint32(cfg.v_head_dim))]
    if cfg.swa_window:
        kv.append((f"{a}.attention.sliding_window", np.uint32(cfg.swa_window)))
    if a == "gemma2":
        kv += [(f"{a}.attn_logit_softcapping", np.float32(cfg.attn_logit_softcap)),
               (f"{a}.final_logit_softcapping", np.float32(cfg.final_logit_softcap))]
    if cfg.clamp_kqv:
        kv.append((f"{a}.attention.clamp_kqv", np.float32(cfg.clamp_kqv)))
    if cfg.logit_scale != 1.0:
        kv.append((f"{a}.logit_scale", np.float32(cfg.logit_scale)))
    if a == "gptneox":
        kv.append((f"{a}.use_parallel_residual", bool(cfg.parallel_residual)))
    if a in ALIBI_KEY_ARCHES:
        kv.append((f"{a}.attention.max_alibi_bias", np.float32(cfg.max_alibi_bias)))
    return kv


def synthetic_gguf(path, cfg: ModelConfig, seed: int = 0, layer_types: Optional[list] = None,
                   embd_type: Optional[GGMLQuantType] = None,
                   output_type: GGMLQuantType = GGMLQuantType.Q6_K,
                   matrix_type: GGMLQuantType = GGMLQuantType.Q4_K,
                   extra_kvs: Optional[dict] = None, moe: Optional[MoEShape] = None) -> int:
    """Write a GGUF of random wire blocks for `cfg` (a dense file of any of
    DENSE_ARCHES, by cfg.arch; file_metadata gives its keys): every layer
    matrix of `matrix_type` but those `layer_types` names (a dict a layer
    from LAYER_MATRICES to types; default for Q4_K: the Q4_K_M profile,
    q4_k_m_layer_types; for Q5_K the Q5_K_M one; for other types none, the
    LLAMA_FTYPE_MOSTLY_* files; every_format_layer_types for a file that
    holds every format), `token_embd` (embd_type, default
    matrix_type) and `output` (output_type: Q6_K, as llama.cpp quantizes
    it in these files; F16 or F32 make them dense); a k-quant on rows no
    256 tiles takes llama.cpp's fallback (_fallback_type); norms F32 near
    1.  A gemma or gemma2 file has no `output` (a tied head): its
    `token_embd` defaults to output_type, as llama.cpp gives a tied
    embedding the output's type, and its norms are drawn near 0 (the model
    scales by 1 + w); gemma2's layers add `post_attention_norm` (after
    attn_output) and `post_ffw_norm` (after ffn_down).  A family file
    carries FAMILY_TENSORS' tensors (biases F32, normal with std 0.1; a
    fused attn_qkv of attn_q's type; a position table F32, normal with std
    0.02; chatglm's packed ffn_up of ffn_up's type; falcon's attn_norm_2
    where it has several kv heads; bitnet's scales F32 [1] near 1 and its
    sub-norms), and a tied one (command-r, minicpm, starcoder, mpt, bloom,
    jais, openelm, bitnet) no `output`; each layer at its own widths
    (openelm's arrays).  Each tensor is drawn from
    one numpy Generator as the writer streams it, so a full 8B file never
    sits whole in host
    memory.  extra_kvs (e.g. synthetic_spm_vocab's tokenizer keys) are
    written after the model's keys; the loader ignores them.  With `moe`
    the file is cfg.arch's MoE layout (llama: Mixtral; deepseek2: MLA with
    dense lead and shared experts; qwen2moe: qkv biases and a
    sigmoid-gated shared expert), its layers' types moe_tensor_types(cfg,
    moe, matrix_type) unless layer_types maps tensor names to types.
    Returns the file's size."""
    from llama_kotlin_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)
    if moe is not None:
        return _synthetic_moe_gguf(path, cfg, moe, rng, layer_types, embd_type, output_type,
                                   matrix_type, extra_kvs)
    if layer_types is None:
        mix = DEFAULT_MIX.get(matrix_type)
        layer_types = mix(cfg.n_layer) if mix else [{}] * cfg.n_layer
    fam = FAMILY_TENSORS.get(cfg.arch, {})
    gemma = cfg.arch in GEMMA_ARCHES
    tied = gemma or cfg.tie_word_embeddings or fam.get("tied", False)
    gated = cfg.ffn_gated and fam.get("gated", True)
    if embd_type is None:
        embd_type = output_type if tied else matrix_type
    E, V = cfg.n_embd, cfg.vocab_size
    w = GGUFWriter()
    for key, value in (*file_metadata(cfg, matrix_type), *(extra_kvs or {}).items()):
        w.add_kv(key, value)

    def matrix(name, n, k, qtype):
        qtype = _fallback_type(qtype, k)
        w.add_tensor_stream(name, (k, n), qtype, lambda: wire_blocks(rng, qtype, n, k))

    def vector(name, shape, centre, std):
        w.add_tensor_stream(name, tuple(reversed(shape)), GGMLQuantType.F32,
                            lambda: (centre + std * rng.standard_normal(shape)).astype("<f4"))

    centre = 0.0 if gemma else 1.0  # gemma's norms scale by 1 + w

    def norm(name):
        if fam.get("norms", True):
            vector(name + ".weight", (E,), centre, 0.01)
            if fam.get("norm_bias"):
                vector(name + ".bias", (E,), 0.0, 0.1)

    def bias(name, n):
        vector(name + ".bias", (n,), 0.0, 0.1)

    def qk_norms(b, n_h, n_kv):
        hd = cfg.head_dim
        for qk, nh in (("attn_q_norm", n_h), ("attn_k_norm", n_kv)):
            vector(f"{b}{qk}.weight", (hd,) if fam["qk_norm"] == "head" else (nh, hd), 1.0, 0.01)

    matrix("token_embd.weight", V, E, embd_type)
    if fam.get("pos_embd"):
        vector("position_embd.weight", (cfg.n_ctx_train, E), 0.0, 0.02)
    if fam.get("tok_norm"):
        norm("token_embd_norm")
    norm_2 = fam.get("attn_norm_2") and cfg.n_head_kv > 1
    for i, types in enumerate(layer_types):
        b = f"blk.{i}."
        F = cfg.layer_n_ff(i)
        n_h, n_kv = cfg.layer_n_head(i), cfg.layer_n_head_kv(i)
        qd, kvd = n_h * cfg.head_dim, n_kv * cfg.head_dim
        up_rows = 2 * F if fam.get("packed_up") else F
        norm(b + "attn_norm")
        if norm_2:
            norm(b + "attn_norm_2")
        shapes = {"attn_q": (qd, E), "attn_k": (kvd, E), "attn_v": (kvd, E),
                  "attn_output": (E, qd), "ffn_gate": (F, E), "ffn_up": (up_rows, E),
                  "ffn_down": (E, F)}
        for name in LAYER_MATRICES:
            qtype = types.get(name, matrix_type)
            if name in ("attn_k", "attn_v") and fam.get("fused_qkv"):
                continue
            if name == "attn_q" and fam.get("fused_qkv"):
                matrix(b + "attn_qkv.weight", qd + 2 * kvd, E, qtype)
                if fam.get("qkv_bias"):
                    bias(b + "attn_qkv", qd + 2 * kvd)
                if fam.get("qk_norm"):
                    qk_norms(b, n_h, n_kv)
                continue
            if name == "ffn_gate":
                if fam.get("ffn_norm", True):
                    norm(b + "ffn_norm")
                if not gated:
                    continue
            matrix(b + name + ".weight", *shapes[name], qtype)
            if fam.get("bitnet"):
                vector(b + name + ".scale", (1,), 1.0, 0.05)
                if name in ("attn_output", "ffn_down"):  # the norm before it
                    vector(b + ("attn_sub_norm" if name == "attn_output" else "ffn_sub_norm")
                           + ".weight", (shapes[name][1],), 1.0, 0.01)
            if fam.get("qkv_bias") and name in ("attn_q", "attn_k", "attn_v"):
                bias(b + name, shapes[name][0])
            if (fam.get("out_bias") and name == "attn_output"
                    or fam.get("ffn_bias") and name in ("ffn_up", "ffn_down")
                    or fam.get("gate_bias") and name == "ffn_gate"):
                bias(b + name, shapes[name][0])
            if name == "attn_v" and fam.get("qk_norm"):
                qk_norms(b, n_h, n_kv)
            if cfg.arch == "gemma2" and name in ("attn_output", "ffn_down"):
                vector(b + ("post_attention_norm.weight" if name == "attn_output"
                            else "post_ffw_norm.weight"), (E,), centre, 0.01)
    norm("output_norm")
    if not tied:
        matrix("output.weight", V, E, output_type)
    if fam.get("output_bias"):
        bias("output", V)
    w.write(path)
    return os.path.getsize(path)


@dataclass(frozen=True)
class MoEShape:
    """A MoE file's shapes beyond ModelConfig's (which gives n_expert,
    n_expert_used and the dense FFN width n_ff): the routed experts' width,
    the shared experts (deepseek2 and qwen2moe: n_shared of expert_ff,
    written as one FFN n_shared * expert_ff wide; qwen2moe's with its
    sigmoid gate), the leading dense layers, and deepseek2's q and kv LoRA
    ranks (q_lora_rank 0: one ``attn_q``, the Lite model)."""

    expert_ff: int
    n_shared: int = 0
    dense_lead: int = 0
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    shared_gate: bool = False  # qwen2moe: the shared expert's sigmoid gate [1, n_embd]


def deepseek_v2_lite(n_layer: int = 27) -> tuple:
    """(ModelConfig, MoEShape) of DeepSeek-V2-Lite at its published shapes
    (huggingface.co/deepseek-ai/DeepSeek-V2-Lite, config.json): 27 layers,
    the first dense (F 10944), then 64 routed experts of 1408 (6 a token,
    raw softmax weights, scale 1) and 2 shared; 16 heads of q/k 192 (128 +
    64 rope) and v 128 over a 512-wide kv latent, no q LoRA; YaRN factor 40
    on 4096 positions, mscale_all_dim 0.707 (yarn_log_multiplier 0.0707 as
    llama.cpp's converter writes it).  n_layer cuts depth."""
    cfg = ModelConfig(arch="deepseek2", name="deepseek-v2-lite", vocab_size=102400,
                      n_embd=2048, n_layer=n_layer, n_head=16, n_head_kv=16, n_ff=10944,
                      head_dim=192, v_head_dim=128, rope_dim=64, n_ctx_train=163840,
                      rms_eps=1e-6, rope_freq_scale=1.0 / 40.0, rope_yarn_ext_factor=1.0,
                      rope_orig_ctx=4096, rope_yarn_log_mul=0.1 * 0.707, n_expert=64,
                      n_expert_used=6, moe_norm_topk=False,
                      rope_yarn_attn_factor=1.0 / (1.0 + 0.1 * math.log(40.0)))
    return cfg, MoEShape(expert_ff=1408, n_shared=2, dense_lead=1, kv_lora_rank=512)


def mixtral_8x7b(n_layer: int = 32) -> tuple:
    """(ModelConfig, MoEShape) of Mixtral-8x7B's published shapes
    (huggingface.co/mistralai/Mixtral-8x7B-v0.1, config.json): E 4096, 32
    heads on 8 kv heads, 8 experts of 14336, 2 a token; n_layer cuts
    depth."""
    cfg = ModelConfig(arch="llama", name="mixtral-8x7b", vocab_size=32000, n_embd=4096,
                      n_layer=n_layer, n_head=32, n_head_kv=8, n_ff=14336,
                      n_ctx_train=32768, rope_freq_base=1e6, n_expert=8, n_expert_used=2)
    return cfg, MoEShape(expert_ff=14336)


def qwen1_5_moe_a2_7b(n_layer: int = 24) -> tuple:
    """(ModelConfig, MoEShape) of Qwen1.5-MoE-A2.7B at its published shapes
    (huggingface.co/Qwen/Qwen1.5-MoE-A2.7B, config.json): E 2048, 24
    layers, 16 heads on 16 kv heads with qkv biases, 60 routed experts of
    1408 (4 a token, raw softmax weights: norm_topk_prob false) and a
    shared expert of 5632 (4 x 1408) under a sigmoid gate, vocab 151936,
    rope base 1e6, rms_eps 1e-6; the fields config_from_metadata sets for
    such a file.  n_layer cuts depth."""
    cfg = ModelConfig(arch="qwen2moe", name="qwen1.5-moe-a2.7b", vocab_size=151936,
                      n_embd=2048, n_layer=n_layer, n_head=16, n_head_kv=16, n_ff=5632,
                      n_ctx_train=8192, rms_eps=1e-6, rope_type=ROPE_TYPE_NEOX,
                      rope_freq_base=1e6, n_expert=60, n_expert_used=4,
                      moe_norm_topk=False, attn_qkv_bias=True)
    return cfg, MoEShape(expert_ff=1408, n_shared=4, shared_gate=True)


def dbrx_base(n_layer: int = 40) -> tuple:
    """(ModelConfig, MoEShape) of DBRX at its published shapes
    (huggingface.co/databricks/dbrx-base, config.json): d_model 6144, 40
    layers, 48 heads of 128 on 8 kv heads, a fused q|k|v clipped at 8
    (clip_qkv), LayerNorm without biases, 16 experts of 10752 (4 a token,
    their weights renormalized), rope base 500000, vocab 100352, 32768
    positions; the fields config_from_metadata sets for such a file.
    n_layer cuts depth."""
    cfg = ModelConfig(arch="dbrx", name="dbrx-base", vocab_size=100352, n_embd=6144,
                      n_layer=n_layer, n_head=48, n_head_kv=8, n_ff=10752, n_ctx_train=32768,
                      use_rms_norm=False, rope_type=ROPE_TYPE_NEOX, rope_freq_base=500000.0,
                      n_expert=16, n_expert_used=4, clamp_kqv=8.0)
    return cfg, MoEShape(expert_ff=10752)


def make_divisible(v: float, divisor: int) -> int:
    """corenet's make_divisible, which OpenELM's configuration applies to
    its per-layer widths: v rounded to the nearest multiple of divisor (at
    least divisor), one more step where that lost more than a tenth."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def openelm_arrays(n_layer: int, model_dim: int, head_dim: int, n_groups: int,
                   qkv_mult: tuple, ffn_mult: tuple, ffn_divisor: int) -> tuple:
    """OpenELM's per-layer (query heads, kv heads, FFN widths) from its
    configuration (apple/corenet, OpenELMConfig.__post_init__): the
    multipliers spaced evenly over the layers and rounded to 2 places, each
    width made divisible by head_dim * n_groups (query) or ffn_divisor
    (FFN), kv heads a query head count over n_groups."""
    qm = [round(float(v), 2) for v in np.linspace(*qkv_mult, num=n_layer)]
    fm = [round(float(v), 2) for v in np.linspace(*ffn_mult, num=n_layer)]
    heads = tuple(make_divisible(model_dim * m, head_dim * n_groups) // head_dim for m in qm)
    return (heads, tuple(h // n_groups for h in heads),
            tuple(make_divisible(model_dim * m, ffn_divisor) for m in fm))


def openelm_3b(n_layer: int = 36) -> ModelConfig:
    """OpenELM-3B at its published shapes (huggingface.co/apple/OpenELM-3B,
    config.json): model_dim 3072, 36 layers, head dim 128, 4 query heads a
    kv head, qkv_multipliers (0.5, 1.0) and ffn_multipliers (0.5, 4.0) with
    ffn_dim_divisor 256 (openelm_arrays: 12 to 24 query heads, 3 to 6 kv
    heads, FFN 1536 to 12288), a gated silu FFN, per-head q/k RMS norms,
    the embedding as the head, vocab 32000, 2048 positions, rope base
    10000, rms_eps 1e-6; the fields config_from_metadata sets for such a
    file.  n_layer cuts depth (the first n_layer layers' shapes)."""
    heads, kv, ff = (a[:n_layer] for a in openelm_arrays(36, 3072, 128, 4, (0.5, 1.0),
                                                          (0.5, 4.0), 256))
    return ModelConfig(arch="openelm", name="openelm-3b", vocab_size=32000, n_embd=3072,
                       n_layer=n_layer, n_head=max(heads), n_head_kv=max(kv), n_ff=max(ff),
                       head_dim=128, n_ctx_train=2048, rms_eps=1e-6, rope_type=ROPE_TYPE_NEOX,
                       tie_word_embeddings=True, n_head_arr=heads, n_head_kv_arr=kv,
                       n_ff_arr=ff)


def qwen2_7b(n_layer: int = 28) -> ModelConfig:
    """Qwen2-7B at its published shapes (huggingface.co/Qwen/Qwen2-7B,
    config.json): E 3584, 28 layers, 28 heads on 4 kv heads (7 a group) of
    128 with qkv biases, F 18944, vocab 152064, rope base 1e6, rms_eps
    1e-6, 131072 positions; the fields config_from_metadata sets for such a
    file.  n_layer cuts depth."""
    return ModelConfig(arch="qwen2", name="qwen2-7b", vocab_size=152064, n_embd=3584,
                       n_layer=n_layer, n_head=28, n_head_kv=4, n_ff=18944,
                       n_ctx_train=131072, rms_eps=1e-6, rope_type=ROPE_TYPE_NEOX,
                       rope_freq_base=1e6, attn_qkv_bias=True)


def gemma2_9b(n_layer: int = 42) -> ModelConfig:
    """gemma-2-9b at its published shapes (huggingface.co/google/gemma-2-9b,
    config.json): 42 layers, E 3584, 16 heads on 8 kv heads of 256
    (query_pre_attn_scalar 256 = head_dim, so 1/sqrt(256) is its scale),
    F 14336 (gelu), vocab 256000, rms_eps 1e-6, rope base 10000, a
    4096-cell sliding window on every other layer, attention and final
    logit softcaps 50 and 30; the fields config_from_metadata sets for
    such a file.  n_layer cuts depth."""
    return ModelConfig(arch="gemma2", name="gemma-2-9b", vocab_size=256000, n_embd=3584,
                       n_layer=n_layer, n_head=16, n_head_kv=8, n_ff=14336, head_dim=256,
                       n_ctx_train=8192, rms_eps=1e-6, norm_weight_offset=1.0, act="gelu",
                       rope_type=ROPE_TYPE_NEOX, embd_scale=3584 ** 0.5,
                       attn_logit_softcap=50.0, final_logit_softcap=30.0, swa_window=4096,
                       swa_pattern=2, tie_word_embeddings=True)


def gemma_7b(n_layer: int = 28) -> ModelConfig:
    """gemma-7b at its published shapes (huggingface.co/google/gemma-7b,
    config.json): 28 layers, E 3072, 16 heads on 16 kv heads of 256, F
    24576 (gelu), vocab 256000, rms_eps 1e-6, rope base 10000; the fields
    config_from_metadata sets for such a file.  n_layer cuts depth."""
    return ModelConfig(arch="gemma", name="gemma-7b", vocab_size=256000, n_embd=3072,
                       n_layer=n_layer, n_head=16, n_head_kv=16, n_ff=24576, head_dim=256,
                       n_ctx_train=8192, rms_eps=1e-6, norm_weight_offset=1.0, act="gelu",
                       rope_type=ROPE_TYPE_NEOX, embd_scale=3072 ** 0.5,
                       tie_word_embeddings=True)


def falcon_7b(n_layer: int = 32) -> ModelConfig:
    """Falcon-7B at its published shapes (huggingface.co/tiiuae/falcon-7b,
    config.json): E 4544, 32 layers, 71 query heads of 64 on one kv head
    (multi-query), F 18176 (4 E, gelu, no biases), vocab 65024, 2048
    positions, parallel attention and FFN on one LayerNorm, NEOX rope base
    10000; the fields config_from_metadata sets for such a file.  K = 4544
    is no multiple of 256, so a Q4_K_M file takes llama.cpp's Q5_0 / Q8_0
    fallback on every matrix that reads E.  n_layer cuts depth."""
    return ModelConfig(arch="falcon", name="falcon-7b", vocab_size=65024, n_embd=4544,
                       n_layer=n_layer, n_head=71, n_head_kv=1, n_ff=18176, n_ctx_train=2048,
                       use_rms_norm=False, act="gelu", ffn_gated=False, rope_type=ROPE_TYPE_NEOX,
                       parallel_residual=True)


def starcoder_15b(n_layer: int = 40) -> ModelConfig:
    """StarCoder-15.5B at its published shapes (huggingface.co/bigcode/
    starcoder, config.json): E 6144, 40 layers, 48 query heads of 128 on one
    kv head (multi-query), F 24576 (gelu), biases on every projection and
    norm, vocab 49152, 8192 learned positions (no rope), a tied head; the
    fields config_from_metadata sets for such a file.  n_layer cuts
    depth."""
    return ModelConfig(arch="starcoder", name="starcoder-15.5b", vocab_size=49152, n_embd=6144,
                       n_layer=n_layer, n_head=48, n_head_kv=1, n_ff=24576, n_ctx_train=8192,
                       use_rms_norm=False, act="gelu", ffn_gated=False,
                       rope_type=ROPE_TYPE_NONE, learned_pos_embd=True)


def _fallback_type(qtype: GGMLQuantType, k: int) -> GGMLQuantType:
    """llama.cpp's quantize fallback for rows a k-quant block cannot tile
    (k % 256): Q4_K -> Q5_0, Q5_K -> Q5_1, Q6_K -> Q8_0."""
    if k % SPAN == 0 or TYPE_TRAITS[qtype].block_size != SPAN:
        return qtype
    return {GGMLQuantType.Q4_K: GGMLQuantType.Q5_0, GGMLQuantType.Q5_K: GGMLQuantType.Q5_1,
            GGMLQuantType.Q6_K: GGMLQuantType.Q8_0}[qtype]


def moe_layer_tensors(cfg: ModelConfig, moe: MoEShape, i: int) -> list:
    """Layer i of a MoE, deepseek2, qwen2moe, dbrx, grok or arctic file:
    (name suffix, numpy shape, role) in the order synthetic_gguf writes
    them; role "norm" (F32), "bias" (F32: qwen2moe's q/k/v biases),
    "router" (F32, as llama.cpp's quantize leaves ffn_gate_inp and
    qwen2moe's shared-expert gate ffn_gate_inp_shexp), "attn_v" and
    "ffn_down" (Q4_K_M's use_more_bits choice) or "matrix".  dbrx's layer
    has a fused attn_qkv (of attn_q's type, as the dense family files) and
    its pre-FFN norm attn_output_norm in place of ffn_norm; grok's has
    attn_output_norm after the attention and layer_output_norm after the
    experts; arctic's a dense FFN of n_ff (ffn_gate, ffn_up, ffn_down)
    before ffn_norm_exps and the experts."""
    E, H = cfg.n_embd, cfg.n_head
    out = [("attn_norm.weight", (E,), "norm")]
    if cfg.arch == "dbrx":
        qd, kvd = H * cfg.head_dim, cfg.n_head_kv * cfg.head_dim
        out += [("attn_qkv.weight", (qd + 2 * kvd, E), "matrix"),
                ("attn_output.weight", (E, qd), "matrix"),
                ("attn_output_norm.weight", (E,), "norm")]
        return out + _expert_tensors(cfg, moe)
    if cfg.arch == "deepseek2":
        nope, rope = cfg.head_dim - cfg.rope_dim, cfg.rope_dim
        if moe.q_lora_rank:
            out += [("attn_q_a.weight", (moe.q_lora_rank, E), "matrix"),
                    ("attn_q_a_norm.weight", (moe.q_lora_rank,), "norm"),
                    ("attn_q_b.weight", (H * cfg.head_dim, moe.q_lora_rank), "matrix")]
        else:
            out.append(("attn_q.weight", (H * cfg.head_dim, E), "matrix"))
        out += [("attn_kv_a_mqa.weight", (moe.kv_lora_rank + rope, E), "matrix"),
                ("attn_kv_a_norm.weight", (moe.kv_lora_rank,), "norm"),
                ("attn_kv_b.weight", (H * (nope + cfg.v_head_dim), moe.kv_lora_rank), "matrix"),
                ("attn_output.weight", (E, H * cfg.v_head_dim), "matrix")]
    else:
        qd, kvd = H * cfg.head_dim, cfg.n_head_kv * cfg.head_dim
        out += [("attn_q.weight", (qd, E), "matrix"), ("attn_k.weight", (kvd, E), "matrix"),
                ("attn_v.weight", (kvd, E), "attn_v"), ("attn_output.weight", (E, qd), "matrix")]
        if cfg.attn_qkv_bias:
            out[-1:-1] = [("attn_q.bias", (qd,), "bias"), ("attn_k.bias", (kvd,), "bias"),
                          ("attn_v.bias", (kvd,), "bias")]
    if cfg.arch == "grok":
        out.append(("attn_output_norm.weight", (E,), "norm"))
    out.append(("ffn_norm.weight", (E,), "norm"))
    F = cfg.n_ff
    dense = [("ffn_gate.weight", (F, E), "matrix"), ("ffn_up.weight", (F, E), "matrix"),
             ("ffn_down.weight", (E, F), "ffn_down")]
    if i < moe.dense_lead:
        return out + dense
    if cfg.arch == "arctic":
        out += dense + [("ffn_norm_exps.weight", (E,), "norm")]
    out += _expert_tensors(cfg, moe)
    if cfg.arch == "grok":
        out.append(("layer_output_norm.weight", (E,), "norm"))
    if moe.n_shared:
        Fs = moe.n_shared * moe.expert_ff
        if moe.shared_gate:
            out.append(("ffn_gate_inp_shexp.weight", (1, E), "router"))
        out += [("ffn_gate_shexp.weight", (Fs, E), "matrix"),
                ("ffn_up_shexp.weight", (Fs, E), "matrix"),
                ("ffn_down_shexp.weight", (E, Fs), "ffn_down")]
    return out


def _expert_tensors(cfg: ModelConfig, moe: MoEShape) -> list:
    """The router and the routed experts' stacks of a MoE layer."""
    E, Ne, Fe = cfg.n_embd, cfg.n_expert, moe.expert_ff
    return [("ffn_gate_inp.weight", (Ne, E), "router"),
            ("ffn_gate_exps.weight", (Ne, Fe, E), "matrix"),
            ("ffn_up_exps.weight", (Ne, Fe, E), "matrix"),
            ("ffn_down_exps.weight", (Ne, E, Fe), "ffn_down")]


def moe_tensor_types(cfg: ModelConfig, moe: MoEShape,
                     matrix_type: GGMLQuantType = GGMLQuantType.Q4_K) -> dict:
    """{tensor name: type} of a MoE file's layers under Q4_K_M's rule by
    tensor name (Q4_K when matrix_type is Q4_K, else every matrix
    matrix_type): attn_v and every ffn_down (dense, routed and shared) Q6_K
    on use_more_bits layers (q4_k_m_layer_types, the layer read from the
    name as llama.cpp does for MoE models), attn_v Q8_0 in an 8-expert
    model (llama.cpp's bump for Mixtral), the router F32; then llama.cpp's
    fallback where k is no multiple of 256 (q4_K -> Q5_0, q6_K -> Q8_0)."""
    mix = q4_k_m_layer_types(cfg.n_layer) if matrix_type == GGMLQuantType.Q4_K else None
    out = {}
    for i in range(cfg.n_layer):
        for suffix, shape, role in moe_layer_tensors(cfg, moe, i):
            if role in ("norm", "bias", "router"):
                t = GGMLQuantType.F32
            elif role == "attn_v" and cfg.n_expert == 8 and mix:
                t = GGMLQuantType.Q8_0
            elif mix and role in ("attn_v", "ffn_down"):
                t = mix[i][role]
            else:
                t = matrix_type
            out[f"blk.{i}.{suffix}"] = _fallback_type(t, shape[-1])
    return out


def moe_metadata(cfg: ModelConfig, moe: MoEShape,
                 matrix_type: GGMLQuantType = GGMLQuantType.Q4_K) -> list:
    """The (key, value) metadata of synthetic_gguf's MoE, deepseek2 or
    qwen2moe file: a llama file's keys under cfg.arch, the expert counts,
    qwen2moe's expert widths, and deepseek2's head widths, LoRA ranks,
    dense lead, expert widths, expert weight scale and YaRN keys (the keys
    llama.cpp's converter writes); dbrx's LayerNorm epsilon and clamp_kqv."""
    a = cfg.arch
    eps_key, eps = (("layer_norm_rms_epsilon", cfg.rms_eps) if cfg.use_rms_norm
                    else ("layer_norm_epsilon", cfg.norm_eps))
    kv = [("general.architecture", a), ("general.name", cfg.name or "synthetic"),
          ("general.file_type", np.uint32(FILE_TYPES[matrix_type])),
          (f"{a}.vocab_size", np.uint32(cfg.vocab_size)),
          (f"{a}.context_length", np.uint32(cfg.n_ctx_train)),
          (f"{a}.embedding_length", np.uint32(cfg.n_embd)),
          (f"{a}.block_count", np.uint32(cfg.n_layer)),
          (f"{a}.feed_forward_length", np.uint32(cfg.n_ff)),
          (f"{a}.attention.head_count", np.uint32(cfg.n_head)),
          (f"{a}.attention.head_count_kv", np.uint32(cfg.n_head_kv)),
          (f"{a}.rope.dimension_count", np.uint32(cfg.rope_dim)),
          (f"{a}.rope.freq_base", np.float32(cfg.rope_freq_base)),
          (f"{a}.attention.{eps_key}", np.float32(eps)),
          (f"{a}.expert_count", np.uint32(cfg.n_expert)),
          (f"{a}.expert_used_count", np.uint32(cfg.n_expert_used))]
    if cfg.clamp_kqv:
        kv.append((f"{a}.attention.clamp_kqv", np.float32(cfg.clamp_kqv)))
    if a == "qwen2moe":
        kv += [(f"{a}.expert_feed_forward_length", np.uint32(moe.expert_ff)),
               (f"{a}.expert_shared_feed_forward_length",
                np.uint32(moe.n_shared * moe.expert_ff))]
    if a != "deepseek2":
        return kv
    kv += [(f"{a}.attention.key_length", np.uint32(cfg.head_dim)),
           (f"{a}.attention.value_length", np.uint32(cfg.v_head_dim)),
           (f"{a}.attention.q_lora_rank", np.uint32(moe.q_lora_rank)),
           (f"{a}.attention.kv_lora_rank", np.uint32(moe.kv_lora_rank)),
           (f"{a}.leading_dense_block_count", np.uint32(moe.dense_lead)),
           (f"{a}.expert_feed_forward_length", np.uint32(moe.expert_ff)),
           (f"{a}.expert_shared_count", np.uint32(moe.n_shared)),
           (f"{a}.expert_weights_scale", np.float32(cfg.moe_expert_scale))]
    if cfg.rope_freq_scale != 1.0:
        kv += [(f"{a}.rope.scaling.type", "yarn"),
               (f"{a}.rope.scaling.factor", np.float32(1.0 / cfg.rope_freq_scale)),
               (f"{a}.rope.scaling.original_context_length", np.uint32(cfg.rope_orig_ctx)),
               (f"{a}.rope.scaling.yarn_log_multiplier", np.float32(cfg.rope_yarn_log_mul))]
    return kv


def _synthetic_moe_gguf(path, cfg: ModelConfig, moe: MoEShape, rng, types: Optional[dict],
                        embd_type, output_type, matrix_type, extra_kvs) -> int:
    """synthetic_gguf's MoE, deepseek2, qwen2moe, dbrx, grok and arctic
    files: wire_blocks' draws, tensor by tensor in the writer's order (an
    expert stack as E * n rows of one draw; a router F32, normal with std
    0.02; a norm near 1, a bias normal with std 0.1)."""
    from llama_kotlin_tpu_torch.gguf.writer import GGUFWriter

    E, V = cfg.n_embd, cfg.vocab_size
    types = moe_tensor_types(cfg, moe, matrix_type) if types is None else types
    embd_type = matrix_type if embd_type is None else embd_type
    w = GGUFWriter()
    for key, value in (*moe_metadata(cfg, moe, matrix_type), *(extra_kvs or {}).items()):
        w.add_kv(key, value)

    def tensor(name, shape, qtype, role="matrix"):
        n, k = math.prod(shape[:-1]), shape[-1]
        if role == "norm":
            draw = lambda: (1.0 + 0.01 * rng.standard_normal(k)).astype("<f4")
        elif role == "bias":
            draw = lambda: (0.1 * rng.standard_normal(k)).astype("<f4")
        else:
            draw = lambda: wire_blocks(rng, qtype, n, k)
        w.add_tensor_stream(name, tuple(reversed(shape)), qtype, draw)

    tensor("token_embd.weight", (V, E), embd_type)
    for i in range(cfg.n_layer):
        for suffix, shape, role in moe_layer_tensors(cfg, moe, i):
            name = f"blk.{i}.{suffix}"
            tensor(name, shape, types[name], role)
    tensor("output_norm.weight", (E,), GGMLQuantType.F32, "norm")
    tensor("output.weight", (V, E), output_type)
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
