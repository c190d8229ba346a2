"""dbrx, grok and arctic on the port against the JAX package: the config
(the metadata synthetic_gguf writes for DBRX at its published widths, and
for narrow grok and arctic files, field for field), the same seeded narrow
GGUF files through both loaders and contexts in the exact mode and ``w4``,
prefill then token by token (tests/test_torch_moe.py::served_parity) on
JAX's routing (``JaxRouting``), the MoE route each step takes (JAX's
gather-or-sweep rule on the port's rows, on both sides of it), the
tensors ``convert.py`` carries across, and kernel 3's plain version at
DBRX's 48 query heads on 8 kv heads (6 a group), with and without grok's
softcap 30, against JAX's kernel in interpret mode.

Each file has 2 layers, E 256, 4 heads on 2 kv heads and experts of 256:
dbrx 8 experts, 4 a token (its fused clamped qkv, its pre-FFN
``attn_output_norm``, a biasless LayerNorm); grok 8 experts, 2 a token
(the scaled embedding and logits, the attention softcap 30, gelu experts,
its out-norms read as post norms); arctic 20 experts, 2 a token (a dense
FFN beside the MoE branch normed by ``ffn_norm_exps``; more than 16
experts, so one stacked exact repack in ``w4`` too).  The exact mode's
JAX contexts run jitted on JAX's CPU routes; in ``w4`` they run in
interpret mode (tests/test_torch_qwen2.py says why)."""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.models.config import config_from_metadata as jax_config
from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.ops.pallas.flash import flash_attention as jax_flash
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.convert import params_from_numpy
from llama_kotlin_tpu_torch.models.config import ModelConfig, config_from_metadata
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import (MoEShape, dbrx_base, moe_metadata,
                                                     moe_tensor_types, synthetic_gguf)
from llama_kotlin_tpu_torch.ops.cuda import flash
from llama_kotlin_tpu_torch.ops.rope import ROPE_TYPE_NEOX
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from test_torch_flash_mma import _flash_mma_emulation
from test_torch_moe import JaxRouting, route_calls, served_parity
from test_torch_qmm_plan import _rel_err
from test_torch_qwen2 import CFG_FIELDS, _jax

N_CELLS = 256
N_STEPS = 3
FIELDS = CFG_FIELDS + ("act", "embd_scale", "attn_logit_softcap")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tests' many small CPU ops: more only
    multiplies their CPU time when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrow(arch: str) -> tuple:
    """(config, MoEShape) of the narrow 2-layer file of `arch`."""
    if arch == "dbrx":
        cfg, moe_shape = dbrx_base(n_layer=2)
        return (replace(cfg, n_embd=256, n_head=4, n_head_kv=2, head_dim=0, v_head_dim=0,
                        rope_dim=0, n_ff=256, vocab_size=512, n_expert=8),
                replace(moe_shape, expert_ff=256))
    n_expert = {"grok": 8, "arctic": 20}[arch]
    cfg = ModelConfig(arch=arch, name=f"synthetic-{arch}", vocab_size=512, n_embd=256,
                      n_layer=2, n_head=4, n_head_kv=2, n_ff=256, n_ctx_train=4096,
                      rope_type=ROPE_TYPE_NEOX if arch == "grok" else 0, n_expert=n_expert,
                      n_expert_used=2)
    return cfg, MoEShape(expert_ff=256)


@pytest.mark.parametrize("arch", ["dbrx", "grok", "arctic"])
def test_config_matches_jax(arch):
    """config_from_metadata on the metadata synthetic_gguf writes gives
    JAX's config field for field, rope parameters included: DBRX at its
    published widths (dbrx_base: 48 heads on 8, 16 experts, 4 used, clip 8,
    LayerNorm, NEOX rope base 500000) and the narrow grok (its embedding
    and logit scales, softcap 30, gelu) and arctic files."""
    cfg, moe_shape = dbrx_base() if arch == "dbrx" else _narrow(arch)
    meta = dict(moe_metadata(cfg, moe_shape))
    ours, ref = config_from_metadata(meta), jax_config(meta)
    for f in FIELDS:
        assert getattr(ours, f) == pytest.approx(getattr(ref, f), rel=1e-7), f
        if arch == "dbrx":
            assert getattr(cfg, f) == pytest.approx(getattr(ref, f), rel=1e-7), f
    assert vars(ours.rope_params()) == vars(ref.rope_params())
    if arch == "dbrx":
        assert (ours.n_layer, ours.n_head // ours.n_head_kv, ours.n_expert, ours.n_expert_used,
                ours.clamp_kqv, ours.use_rms_norm) == (40, 6, 16, 4, 8.0, False)
    if arch == "grok":
        assert ours.attn_logit_softcap == 30.0 and ours.act == "gelu" and ours.embd_scale > 78


def _file(tmp_path, arch: str, seed: int):
    cfg, moe_shape = _narrow(arch)
    path = tmp_path / f"{arch}.gguf"
    synthetic_gguf(path, cfg, seed=seed, moe=moe_shape)
    return path


# (arch, mode, prompt tokens, decode steps, tol of max|logits|, the routes
# of the prefill and of each decode step: JAX's rule on the port's rows).
# dbrx in the exact mode: one stacked exact repack of 8 experts, 4 used: a
# decode step's 4 slots gather, a 12-token prefill's 64 sweep; in w4 (E <=
# 16) a list of per-expert W4 folds, which every step sweeps (JAX in
# interpret mode, whose compile of the 48 expert launches costs ~16 s;
# grok's w4 route is this one, the sweep over per-expert folds).  grok (8
# experts, 2 used) the same in the exact mode.  arctic's 20 experts stay
# one stacked exact repack in w4 too: a 6-token prefill's 16 slots gather (fewer than 20), a
# 12-token one's 32 sweep.  tol: 1e-2 in the exact mode (bf16 operands:
# XLA's excess precision, ROADMAP hazards), 5e-2 in w4 (every matmul
# re-quantizes its input to int8; tests/test_torch_qwen2.py's bound)
CASES = [("dbrx", None, 12, N_STEPS, 1e-2, ("sweep", "gathered")),
         ("dbrx", "w4", 6, N_STEPS, 5e-2, ("sweep", "sweep")),
         ("grok", None, 12, N_STEPS, 1e-2, ("sweep", "gathered")),
         ("arctic", None, 12, N_STEPS, 1e-2, ("sweep", "gathered")),
         ("arctic", "w4", 6, N_STEPS, 5e-2, ("gathered", "gathered"))]


@pytest.mark.parametrize("arch,mode,n_prompt,n_steps,tol,routes", CASES)
def test_serves_like_jax(tmp_path, monkeypatch, arch, mode, n_prompt, n_steps, tol, routes):
    """The narrow file in both packages' default contexts (fuse=True; both
    unrolled: attn_v's Q6_K layer keeps the layers' keys apart, as can_stack
    rules in both), a prefill and n_steps steps by served_parity within tol
    on JAX's routing (the rows whose own routing parts are near-ties, at
    most a tenth); the MoE routes each forward takes (CASES); dbrx's
    attn_output_norm as its pre-FFN norm, grok's out-norms as post norms,
    arctic's dense FFN and ffn_norm_exps."""
    seed = 40 + [c[:2] for c in CASES].index((arch, mode))
    path = _file(tmp_path, arch, seed)
    if mode == "w4":
        monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    jcfg, jp, jf = jax_load(path, fast_mode=mode, fuse=True)
    cfg, pp, f = load_gguf_model(path, fast_mode=mode, fuse=True, device="cpu")
    jf.close()
    f.close()
    calls = route_calls(monkeypatch)
    routing = JaxRouting(monkeypatch)
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu")
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS)
    assert ("layers_stacked" in pctx.params) == ("layers_stacked" in jctx.params)
    lp = pp["layers"][0]
    want_keys = {"dbrx": {"attn_out_norm", "wqkv_fused"}, "grok": {"post_attn_norm",
                                                                   "post_ffn_norm"},
                 "arctic": {"ffn_norm_exps", "ffn_down", "ffn_norm"}}[arch]
    assert want_keys <= set(lp) and set(lp) == set(jp["layers"][0])
    assert isinstance(lp["ffn_gate_exps"], list) == (mode == "w4" and cfg.n_expert <= 16)
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, n_prompt).astype(np.int32)
    served_parity(jctx, pctx, prompt, n_steps, tol, min_decided=1 if tol < 2e-2 else 0)
    assert routing.check() <= routing.rows // 10
    want = {r: 0 for r in calls}
    want[routes[0]] += cfg.n_layer
    want[routes[1]] += n_steps * cfg.n_layer
    assert calls == want


def test_uniform_moe_file_stacks_as_jax(tmp_path, monkeypatch):
    """A grok file whose layers share one layout (every matrix Q4_K, no
    Q6_K layer) stacks in both packages' default contexts, and the stacked
    port serves JAX's logits (the exact mode, 1e-2 of max|logits|)."""
    cfg, moe_shape = _narrow("grok")
    path = tmp_path / "grok-uniform.gguf"
    types = {k: (Q.Q4_K if t == Q.Q6_K or t == Q.Q8_0 else t)
             for k, t in moe_tensor_types(cfg, moe_shape).items()}
    synthetic_gguf(path, cfg, seed=47, moe=moe_shape, layer_types=types)
    jcfg, jp, jf = jax_load(path, fuse=True)
    cfg, pp, f = load_gguf_model(path, fuse=True, device="cpu")
    jf.close()
    f.close()
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu")
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS)
    assert "layers_stacked" in pctx.params and "layers_stacked" in jctx.params
    routing = JaxRouting(monkeypatch)
    prompt = np.random.default_rng(47).integers(0, cfg.vocab_size, 8).astype(np.int32)
    served_parity(jctx, pctx, prompt, 2, 1e-2, min_decided=0)
    assert routing.check() <= routing.rows // 10


@pytest.mark.parametrize("arch,keys", [
    ("dbrx", {"attn_out_norm"}), ("grok", {"post_attn_norm", "post_ffn_norm"}),
    ("arctic", {"ffn_norm_exps"})])
def test_convert_carries_new_tensors(tmp_path, arch, keys):
    """params_from_numpy of JAX's loaded params carries the new norms
    across as the port's loader gives them (f32, equal): dbrx's
    attn_output_norm, grok's out-norms under their post-norm names, arctic's
    ffn_norm_exps; and every QTensor of a layer (the experts' stacked
    exact repacks, the fused qkv) plane for plane."""
    path = _file(tmp_path, arch, 60)
    jcfg, jp, jf = jax_load(path, fuse=True)
    cfg, pp, f = load_gguf_model(path, fuse=True, device="cpu")
    jf.close()
    f.close()
    conv = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for jl, pl in zip(conv["layers"], pp["layers"]):
        assert set(jl) == set(pl)
        for key in keys:
            assert jl[key].dtype == pl[key].dtype == torch.float32
            assert torch.equal(jl[key], pl[key]), key
        for key in ("ffn_gate_exps", "ffn_down_exps", "wo"):
            a, b = jl[key].tensors(), pl[key].tensors()
            assert a.keys() == b.keys()
            for name in a:
                assert torch.equal(a[name], b[name].to(a[name].dtype)), (key, name)


@pytest.mark.parametrize("kind,softcap", [("bf16", 0.0), ("bf16", 30.0), ("int8", 30.0),
                                          ("int4", 0.0)])
def test_flash_at_dbrx_heads_matches_jax(kind, softcap):
    """Kernel 3's plain version at DBRX's and Grok-1's 48 query heads on 8
    kv heads (6 a group; head dim 128) over 256 cells, with and without
    grok's softcap 30, on each cache, 20 tokens in two causal sequences
    with one blind row, against JAX's flash_attention in interpret mode
    within 5e-3 of max|out| (tests/test_torch_qwen2.py's bound), and the
    tile's emulation (a token's six rows straddle the 64-row tiles' edges)
    within 2e-5 of JAX's at the wrapper's split count and at one split.
    The blind row is exactly 0."""
    H, KV, D, nt, n_vis = 48, 8, 128, 20, 256
    rng = np.random.default_rng(120 + ["bf16", "int8", "int4"].index(kind) + int(softcap))
    if kind == "bf16":
        k, v = (torch.from_numpy(rng.standard_normal((KV, n_vis, D)).astype(np.float32))
                .to(torch.bfloat16) for _ in range(2))
        ks = vs = None
    else:
        shape, lo, hi, dt = (((KV, n_vis, D), -127, 128, np.int8) if kind == "int8"
                             else ((KV, n_vis, D // 2), 0, 256, np.uint8))
        k, v = (torch.from_numpy(rng.integers(lo, hi, shape).astype(dt)) for _ in range(2))
        ks, vs = (torch.from_numpy((rng.random((KV, n_vis)) * 0.05 + 0.01).astype(np.float32))
                  for _ in range(2))
    bits = 4 if kind == "int4" else 8
    q = (torch.from_numpy(rng.standard_normal((nt, H, D)).astype(np.float32)) * 3.0
         ).to(torch.bfloat16)  # scores past the softcap's knee
    mask = np.zeros((nt, n_vis), np.int8)
    for i in range(10):
        mask[i, :60 + i] = 1
        mask[10 + i, 128:128 + 90 + i] = 1
    mask[3] = 0
    plain = flash.flash_attention(q, k, v, torch.from_numpy(mask), scale=D ** -0.5,
                                  logit_softcap=softcap, k_scale=ks, v_scale=vs,
                                  kv_bits=bits).to(torch.float32)
    assert plain.shape == (nt, H, D) and not plain[3].any()
    ref = np.asarray(jax_flash(_jax(q), _jax(k), _jax(v), jnp.asarray(mask), scale=D ** -0.5,
                               logit_softcap=softcap, k_scale=_jax(ks), v_scale=_jax(vs),
                               kv_bits=bits, interpret=True))
    assert _rel_err(plain, ref) <= 5e-3
    kw = dict(scale=D ** -0.5, softcap=softcap, k_scale=ks, v_scale=vs, kv_bits=bits)
    nsplit = flash.n_splits(KV, nt * H // KV, n_vis, flash.ROW_TILE)
    for splits in sorted({nsplit, 1}):
        got = _flash_mma_emulation(q, k, v, mask, nsplit=splits, **kw)
        assert not got[3].any() and _rel_err(got, ref) <= 2e-5
