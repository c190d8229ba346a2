"""qwen2 and qwen2moe on the port against the JAX package: the config (the
metadata synthetic_gguf writes for Qwen2-7B and Qwen1.5-MoE-A2.7B, field
for field), the registry, and the same seeded GGUF files (a tiny qwen2 with
7 query heads a kv head and F32 q/k/v biases; a tiny qwen2moe with qkv
biases, more than 16 experts, raw top-k weights and a sigmoid-gated shared
expert) through both loaders and contexts in the exact and ``w4`` modes on
the bf16, int8 and packed int4 caches, prefill then token by token
(tests/test_torch_moe.py::served_parity, the MoE on JAX's routing); kernel
3's plain version (and the tile's emulation) at Qwen2-7B's 28 heads on 4
against JAX's kernel in interpret mode; and the routes of Qwen2-7B's
full-width matrices at a decode row against JAX's dispatch.

In the exact mode the JAX contexts run jitted on JAX's CPU routes, which
compute the function of its kernels (a bf16 dequantize-then-dot, the masked
softmax); XLA's excess precision moves their logits by a few 1e-3 (ROADMAP
hazards), and op by op (jax.disable_jit) would take 3-5 times as long; in
``w4`` they run in interpret mode, so that JAX takes its kernel 1
(int8-quantized activations) where it plans the matrix, as the port does
(tests/test_torch_deepseek2.py says more)."""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.models.config import config_from_metadata as jax_config
from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.ops.pallas import qmm_w4_ffn as jax_ffn_mod
from llama_kotlin_tpu.ops.pallas.flash import flash_attention as jax_flash
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.models import registry
from llama_kotlin_tpu_torch.models.config import ARCHES, config_from_metadata
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import (file_metadata, moe_metadata,
                                                     qwen1_5_moe_a2_7b, qwen2_7b,
                                                     synthetic_gguf)
from llama_kotlin_tpu_torch.ops import qmatmul as port_qmatmul
from llama_kotlin_tpu_torch.ops.cuda import flash, qmm_w4_ffn
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from test_torch_flash_mma import _flash_mma_emulation
from test_torch_gemma import JAX_SITE_KERNEL, _both, _jax_site, _port_kernel
from test_torch_moe import JaxRouting, route_calls, served_parity
from test_torch_qmm_plan import _rel_err

N_CELLS = 256
N_STEPS = 4

# the architectures the port serves (JAX's llama decoder family)
PORTED = ("llama", "gemma", "gemma2", "deepseek2", "qwen2", "qwen2moe", "qwen", "stablelm",
          "phi3", "internlm2", "minicpm", "xverse", "exaone", "baichuan", "starcoder2",
          "refact", "plamo", "orion", "command-r", "olmo", "codeshell", "gpt2", "starcoder",
          "gptneox", "falcon", "mpt", "phi2", "bloom", "jais", "nemotron", "chatglm", "dbrx",
          "arctic", "grok", "openelm", "bitnet")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tests' many small CPU ops: more only
    multiplies their CPU time when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG_FIELDS = ("arch", "n_embd", "n_layer", "n_head", "n_head_kv", "n_ff", "head_dim",
              "v_head_dim", "rope_dim", "rope_type", "rope_freq_base", "rms_eps", "norm_eps",
              "use_rms_norm", "ffn_gated", "attn_qkv_bias", "tie_word_embeddings",
              "parallel_residual", "clamp_kqv", "logit_scale", "max_alibi_bias", "n_expert",
              "n_expert_used", "moe_norm_topk", "moe_expert_scale", "vocab_size",
              "n_ctx_train", "attn_scale")


def test_config_matches_jax():
    """config_from_metadata on the metadata synthetic_gguf writes for
    Qwen2-7B (qwen2_7b) and Qwen1.5-MoE-A2.7B (qwen1_5_moe_a2_7b) gives
    JAX's config field for field, rope parameters included, and the
    builders' own configs (NEOX rope, qkv biases, raw top-k weights)."""
    moe_cfg, moe_shape = qwen1_5_moe_a2_7b(n_layer=2)
    for built, meta in ((qwen2_7b(n_layer=2), dict(file_metadata(qwen2_7b(n_layer=2)))),
                        (moe_cfg, dict(moe_metadata(moe_cfg, moe_shape)))):
        ours, ref = config_from_metadata(meta), jax_config(meta)
        for f in CFG_FIELDS:
            assert getattr(ours, f) == pytest.approx(getattr(ref, f), rel=1e-7), f
            assert getattr(built, f) == pytest.approx(getattr(ref, f), rel=1e-7), f
        assert vars(ours.rope_params()) == vars(ref.rope_params())
    assert (ours.n_expert, ours.n_expert_used, ours.moe_norm_topk) == (60, 4, False)
    q2 = config_from_metadata(dict(file_metadata(qwen2_7b())))
    assert (q2.n_head // q2.n_head_kv, q2.head_dim, q2.n_layer) == (7, 128, 28)


def test_registry_marks_the_family_ported():
    """models/registry.py marks exactly the architectures the port serves
    ported (config_from_metadata's ARCHES), each one JAX supports; every
    other architecture raises, naming ROADMAP item 13."""
    assert set(ARCHES) == set(PORTED)
    for a in registry.ARCHES:
        assert registry.is_ported(a.name) == (a.name in PORTED), a.name
        if a.ported:
            assert registry.support_status(a.name) == "supported"
    for arch in ("mamba", "bert", "t5"):
        with pytest.raises(NotImplementedError, match="item 13"):
            config_from_metadata({"general.architecture": arch})


def _qwen2_file(path, seed: int = 21):
    """A 2-layer qwen2 at Qwen2-7B's head grouping (14 query heads of 64 on
    2 kv heads: 7 a group), E 256, F 512, vocab 512, in Q4_K_M's mix with
    F32 q/k/v biases; the o projection's K = 896 takes llama.cpp's Q5_0
    fallback."""
    cfg = replace(qwen2_7b(n_layer=2), n_embd=256, n_head=14, n_head_kv=2, head_dim=64,
                  v_head_dim=0, rope_dim=0, n_ff=512, vocab_size=512)
    synthetic_gguf(path, cfg, seed=seed)
    return path


def _qwen2moe_file(path, seed: int = 22):
    """A 2-layer qwen2moe at Qwen1.5-MoE-A2.7B's layout, E 256, 4 heads on
    4 kv heads with qkv biases, 20 experts of 384 (more than 16: one
    stacked exact repack in every mode; the expert downs' K = 384 on the
    Q5_0/Q8_0 fallback), 2 used, a shared expert of 768 under its sigmoid
    gate, vocab 512."""
    cfg, moe_shape = qwen1_5_moe_a2_7b(n_layer=2)
    cfg = replace(cfg, n_embd=256, n_head=4, n_head_kv=4, head_dim=0, v_head_dim=0,
                  rope_dim=0, n_ff=512, vocab_size=512, n_expert=20, n_expert_used=2)
    synthetic_gguf(path, cfg, seed=seed, moe=replace(moe_shape, expert_ff=384, n_shared=2))
    return path


def _contexts(path, mode, kv, monkeypatch):
    """Both loaders' (fuse=True) contexts on the file; JAX in interpret mode
    in w4."""
    if mode == "w4":
        monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    jcfg, jp, jf = jax_load(path, fast_mode=mode, fuse=True)
    cfg, pp, f = load_gguf_model(path, fast_mode=mode, fuse=True, device="cpu")
    jf.close()
    f.close()
    return (cfg, pp, LlamaContext(cfg, pp, n_cells=N_CELLS, kv_quant=kv, device="cpu"),
            JaxContext(jcfg, jp, n_cells=N_CELLS, kv_quant=kv))


# (mode, cache, tol of max|logits|): each mode and each cache.  The exact
# mode on a bf16 cache 1e-2 (test_torch_moe.py's bound for jitted JAX on
# bf16 operands; measured 4.3e-3 here, 4.6e-3 on the MoE file); a packed
# int4 cache 5e-2 (test_torch_kv_q4.py's hazard: rows that differ by the
# above re-quantize to 4-bit codes that part at rounding boundaries;
# measured 1.1e-2 on the MoE file); w4 on an int8 cache 5e-2
# (tests/test_torch_deepseek2.py's bound: every matmul input re-quantizes
# to int8)
QWEN2_CASES = [(None, False, 1e-2), (None, "q4_0", 5e-2), ("w4", "q8_0", 5e-2)]


@pytest.mark.parametrize("mode,kv,tol", QWEN2_CASES)
def test_qwen2_serves_like_jax(tmp_path, monkeypatch, mode, kv, tol):
    """The tiny qwen2 in both packages' default contexts (unrolled in both:
    layer 1's Q6_K attn_v keeps its q|k|v split, so the layers' keys
    differ), a 12-token prefill and N_STEPS steps by served_parity within
    tol (QWEN2_CASES).  Where the loader fuses q|k|v it fuses the biases
    too (one add over the fused output), and keeps them apart where it
    keeps the projections apart; they are JAX's bq|bk|bv."""
    path = _qwen2_file(tmp_path / "qwen2.gguf")
    cfg, pp, pctx, jctx = _contexts(path, mode, kv, monkeypatch)
    assert cfg.n_head // cfg.n_head_kv == 7 and cfg.attn_qkv_bias
    l0, l1 = pp["layers"]
    assert "bqkv_fused" in l0 and "bq" not in l0 and {"bq", "bk", "bv"} <= set(l1)
    jl0 = jctx.params["layers"][0]
    ref = np.concatenate([np.asarray(jl0[b]) for b in ("bq", "bk", "bv")])
    np.testing.assert_array_equal(l0["bqkv_fused"].numpy(), ref)
    assert "layers" in pctx.params and "layers" in jctx.params
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, 12).astype(np.int32)
    served_parity(jctx, pctx, prompt, N_STEPS, tol, min_decided=2 if tol < 2e-2 else 0)


# (mode, cache, prompt tokens, tol): each mode (the packed int4 cache is
# QWEN2_CASES'); the exact mode's 12-token prefill sweeps the experts (32
# slots, more than 20); w4's 6-token prefill and every decode step gather
# them (12 and 2 slots, fewer than 20), as JAX's rule gives; tol as
# QWEN2_CASES
QWEN2MOE_CASES = [(None, False, 12, 1e-2), ("w4", "q8_0", 6, 5e-2)]


@pytest.mark.parametrize("mode,kv,n_prompt,tol", QWEN2MOE_CASES)
def test_qwen2moe_serves_like_jax(tmp_path, monkeypatch, mode, kv, n_prompt, tol):
    """The tiny qwen2moe in both packages' default contexts, prefill and
    N_STEPS steps by served_parity on JAX's routing (JaxRouting: the rows
    whose own routing parts are near-ties, at most a tenth): the raw top-k
    weights (moe_norm_topk False), the shared expert scaled by the sigmoid
    of ffn_gate_inp_shexp (dense bf16, as the router), the experts one
    stacked exact repack in both modes (E > 16, JAX's policy), on JAX's
    routes: the sweep where a step's slots reach the expert count, the
    gathered FFN below it."""
    path = _qwen2moe_file(tmp_path / "qwen2moe.gguf")
    calls = route_calls(monkeypatch)
    routing = JaxRouting(monkeypatch)
    cfg, pp, pctx, jctx = _contexts(path, mode, kv, monkeypatch)
    lp = pp["layers"][0]
    assert not cfg.moe_norm_topk and lp["ffn_gate_exps"].is_stacked
    assert lp["ffn_gate_inp_shexp"].dtype == torch.bfloat16
    assert lp["ffn_gate_inp_shexp"].shape == (1, cfg.n_embd)
    assert lp["ffn_down_exps"].qtype in (Q.Q5_0, Q.Q8_0)
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, n_prompt).astype(np.int32)
    served_parity(jctx, pctx, prompt, N_STEPS, tol, min_decided=2 if tol < 2e-2 else 0)
    assert routing.check() <= routing.rows // 10
    sweep = n_prompt > 8  # a prefill of 16 rows: 32 slots; of 8 rows: 16 slots
    assert calls == {"grouped": 0, "sweep": cfg.n_layer * sweep,
                     "gathered": cfg.n_layer * (N_STEPS + (not sweep))}


def _jax(t):
    if t is None:
        return None
    return jnp.asarray(t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 else t.numpy())


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_flash_at_seven_heads_a_group_matches_jax(kind):
    """Kernel 3's plain version at Qwen2-7B's 28 query heads on 4 kv heads
    (head dim 128) over 256 cells (JAX's kernel runs: 128 divides them) on
    each cache, 20 tokens in two causal sequences with one blind row,
    against JAX's flash_attention in interpret mode within 5e-3 of
    max|out| (both f32 masked softmaxes; one bf16 rounding is up to 2^-9 of
    max|out|, tests/test_torch_flash_d256.py's bound); the tile's
    emulation (rows r = token * 7 + head, so a token's seven rows straddle
    the 64-row tiles' edges) within 2e-5 of JAX's (f32 order only) at the
    wrapper's split count and at one split.  The blind row is exactly 0."""
    H, KV, D, nt, n_vis = 28, 4, 128, 20, 256
    rng = np.random.default_rng(90 + ["bf16", "int8", "int4"].index(kind))
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
    q = torch.from_numpy(rng.standard_normal((nt, H, D)).astype(np.float32)).to(torch.bfloat16)
    mask = np.zeros((nt, n_vis), np.int8)
    for i in range(10):
        mask[i, :60 + i] = 1
        mask[10 + i, 128:128 + 90 + i] = 1
    mask[3] = 0
    plain = flash.flash_attention(q, k, v, torch.from_numpy(mask), scale=D ** -0.5,
                                  k_scale=ks, v_scale=vs, kv_bits=bits).to(torch.float32)
    assert plain.shape == (nt, H, D) and not plain[3].any()
    ref = np.asarray(jax_flash(_jax(q), _jax(k), _jax(v), jnp.asarray(mask), scale=D ** -0.5,
                               k_scale=_jax(ks), v_scale=_jax(vs), kv_bits=bits,
                               interpret=True))
    assert _rel_err(plain, ref) <= 5e-3
    kw = dict(scale=D ** -0.5, softcap=0.0, k_scale=ks, v_scale=vs, kv_bits=bits)
    nsplit = flash.n_splits(KV, nt * H // KV, n_vis, flash.ROW_TILE)
    for splits in sorted({nsplit, 1}):
        got = _flash_mma_emulation(q, k, v, mask, nsplit=splits, **kw)
        assert not got[3].any() and _rel_err(got, ref) <= 2e-5


def test_w4_decode_routes_as_jax(monkeypatch):
    """Qwen2-7B's matrices at full width in the w4 mode at one decode row
    and a 64-row prefill: the fused qkv [4608, 3584], o [3584, 3584] and
    gate|up [37888, 3584] (Q4_K: compact W4 folds, K padded to 4096), down
    [3584, 18944] (Q4_K: legacy, its padded K's 9728 code columns are no
    multiple of 1024, JAX's fold.py:178-185) and attn_v [512, 3584] as
    Q6_K (a W8 fold, Q4_K_M's use_more_bits layers)
    take in the port the kernel that serves the site JAX's dispatch reaches
    in interpret mode (every site a recorder, so nothing runs): kernels 1
    and 5 at a decode row, kernel 4 at 64.  The lm_head (Q6_K [152064,
    3584]) by the rule both apply: JAX's kernel-5 plan takes its rows at a
    decode row and the port's qmatmul sends it to kernel 5.  Kernel 2 at E
    = 3584: JAX's entry declines the fused gate|up and down (E % 1024), and
    so does the port's qmm_ffn."""
    from llama_kotlin_tpu.ops.pallas import qmm_w8 as jax_w8_mod
    from types import SimpleNamespace

    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("LKTPU_W4_FX", raising=False)
    E, F = 3584, 18944
    mats = {"qkv": (Q.Q4_K, 4608, E), "o": (Q.Q4_K, E, E), "gate|up": (Q.Q4_K, 2 * F, E),
            "down": (Q.Q4_K, E, F), "attn_v q6_K": (Q.Q6_K, 512, E)}
    folds = {name: _both(*shape, seed=60 + i) for i, (name, shape) in enumerate(mats.items())}
    assert [folds[n][1].flavor for n in ("qkv", "o", "gate|up", "down")] == [
        "compact", "compact", "compact", "legacy"]
    for name, (jw, pw) in folds.items():
        k = pw.shape[1]
        for rows, want in ((1, "kernel 5" if "q6_K" in name else "kernel 1"), (64, "kernel 4")):
            x = np.zeros((rows, k), np.float32)
            with monkeypatch.context() as m:
                site = _jax_site(m, x, jw)
            with monkeypatch.context() as m:
                got = _port_kernel(m, x, pw)
            assert JAX_SITE_KERNEL[site] == got == want, (name, rows, site, got)
    nb = -(-32 // (jax_w8_mod.CHUNK // 16))
    assert jax_w8_mod._plan(152064, E, jax_w8_mod.CHUNK // 16, nb) is not None
    assert port_qmatmul._decode(torch.zeros((1, E)), SimpleNamespace(shape=(152064, E)))
    (jgu, pgu), (jdn, pdn) = folds["gate|up"], folds["down"]
    assert jax_ffn_mod.qmm_w4_ffn_matmul(jnp.zeros((1, E)), jgu, jdn, interpret=True) is None
    assert not qmm_w4_ffn.ffn_eligible(pgu, pdn)
    assert port_qmatmul.qmm_ffn(torch.zeros((1, E)), pgu, pdn) is None
