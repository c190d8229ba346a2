"""gemma and gemma2 on the port against the JAX package: the config (the
metadata synthetic_gguf writes for gemma-2-9b and gemma-7b, and gemma2's
defaults), the registry, and the same seeded GGUF file (a tiny gemma2 and a
tiny gemma at head dim 256: the sliding window shorter than the prompt, so
that it bites; the softcaps, the post norms, the tied Q6_K embedding)
through both loaders and contexts in the exact and ``w4`` modes on the
bf16, int8 and packed int4 caches, prefill then token by token
(tests/test_torch_moe.py::served_parity); the stacked gemma's plain route;
the K shift on NEOX rope at head dim 256; the unchanged engine and server
on a tiny gemma2 file; and the routes of gemma-2-9b's full-width matrices
at a decode row against JAX's dispatch.

In the exact mode the JAX contexts run on JAX's CPU routes, which compute
the function of its kernels (a bf16 dequantize-then-dot, the masked
softmax); in ``w4`` JAX runs in interpret mode, so that it takes its kernel
1 (int8-quantized activations) where it plans the matrix, as the port does.
Kernel 3's D = 256 branch is held against JAX's kernel in interpret mode by
tests/test_torch_flash_d256.py."""

from __future__ import annotations

from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import llama_kotlin_tpu.ops.pallas.qmm_w4 as jax_w4_mod
import llama_kotlin_tpu.ops.pallas.qmm_w8 as jax_w8_mod
import llama_kotlin_tpu.ops.pallas.qmm as jax_qmm_mod
from llama_kotlin_tpu.models.config import config_from_metadata as jax_config
from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.ops.pallas import qmm_w4_ffn as jax_ffn_mod
from llama_kotlin_tpu.ops.qmatmul import qmatmul as jax_qmatmul
from llama_kotlin_tpu.quant import fold as jax_fold, repack as jax_repack
from llama_kotlin_tpu.quant.formats import GGMLQuantType as JQ
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.models import llama as llama_model
from llama_kotlin_tpu_torch.models import registry
from llama_kotlin_tpu_torch.models.config import config_from_metadata
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import (file_metadata, gemma2_9b, gemma_7b,
                                                     synthetic_gguf, synthetic_spm_vocab,
                                                     wire_blocks)
from llama_kotlin_tpu_torch.ops import qmatmul as port_qmatmul
from llama_kotlin_tpu_torch.ops.cuda import qmm_w4_ffn
from llama_kotlin_tpu_torch.ops.rope import ROPE_TYPE_NEOX, RopeParams
from llama_kotlin_tpu_torch.quant import fold, repack
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q
from llama_kotlin_tpu_torch.quant.qtensor import QTensor
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

import test_torch_kshift as kshift
from test_torch_moe import served_parity


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tests' many small CPU ops: more only
    multiplies their CPU time when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG_FIELDS = ("arch", "n_embd", "n_layer", "n_head", "n_head_kv", "n_ff", "head_dim",
              "v_head_dim", "rope_dim", "rope_type", "rope_freq_base", "rms_eps", "vocab_size",
              "act", "embd_scale", "norm_weight_offset", "attn_logit_softcap",
              "final_logit_softcap", "swa_window", "swa_pattern", "attn_scale", "n_ctx_train")


@pytest.mark.parametrize("build", [gemma2_9b, gemma_7b], ids=["gemma2", "gemma"])
def test_config_matches_jax(build):
    """config_from_metadata on the metadata synthetic_gguf writes for
    gemma-2-9b and gemma-7b (2 layers) gives JAX's config field for field,
    the rope parameters and each layer's window included, and the config
    gemma2_9b or gemma_7b returns; on gemma2 metadata without the window and softcap keys,
    JAX's defaults (4096, 50, 30).  The registry marks gemma, gemma2,
    deepseek2 and llama ported; another architecture still raises."""
    want = build(n_layer=4)
    md = dict(file_metadata(want))
    ours, ref = config_from_metadata(md), jax_config(md)
    for f in CFG_FIELDS:
        assert getattr(ours, f) == pytest.approx(getattr(ref, f), rel=1e-7), f
        assert getattr(ours, f) == pytest.approx(getattr(want, f), rel=1e-7), f
    assert ours.rope_params() == RopeParams(**vars(ref.rope_params()))
    assert [ours.layer_swa_window(i) for i in range(4)] == [ref.layer_swa_window(i)
                                                           for i in range(4)]
    assert ours.head_dim == 256 and ours.rope_type == ROPE_TYPE_NEOX and ours.act == "gelu"
    if want.arch == "gemma2":
        assert [ours.layer_swa_window(i) for i in range(4)] == [4096, 0, 4096, 0]
        bare = {k: v for k, v in md.items()
                if not k.endswith(("sliding_window", "softcapping"))}
        ours, ref = config_from_metadata(bare), jax_config(bare)
        for f in ("attn_logit_softcap", "final_logit_softcap", "swa_window", "swa_pattern"):
            assert getattr(ours, f) == getattr(ref, f), f
        assert (ours.attn_logit_softcap, ours.final_logit_softcap, ours.swa_window) == (
            50.0, 30.0, 4096)
    for arch in ("gemma", "gemma2", "deepseek2", "llama"):
        assert registry.is_ported(arch)
    with pytest.raises(NotImplementedError, match="item 13"):
        config_from_metadata({"general.architecture": "mamba"})


# tiny gemma2 and gemma at head dim 256: E 256 (Q4_K's 256-element rows), 2
# heads of 256 on 1 kv head (gemma2, GQA rep 2) or on 2 (gemma, MHA), F 512,
# 2 layers (gemma2: layer 0 windowed, layer 1 full), vocab 512.  gemma2's
# window (4 cells under a 12-token prompt) and softcaps are set so that each
# bites at these widths, where scores are ~0.1 and logits ~2 (gemma-2-9b's
# 4096, 50 and 30 would move nothing here: test_window_and_softcaps_bite)
WINDOW, ATTN_CAP, FINAL_CAP = 4, 0.05, 2.0
PROMPT, N_STEPS, N_CELLS = 12, 4, 256


def _tiny(arch: str):
    if arch == "gemma":
        return replace(gemma_7b(n_layer=2), n_embd=256, n_ff=512, vocab_size=512, n_head=2,
                       n_head_kv=2)
    return replace(gemma2_9b(n_layer=2), n_embd=256, n_ff=512, vocab_size=512, n_head=2,
                   n_head_kv=1, swa_window=WINDOW, attn_logit_softcap=ATTN_CAP,
                   final_logit_softcap=FINAL_CAP)


def _file(tmp_path, arch: str, seed: int, **kw):
    path = tmp_path / f"{arch}.gguf"
    synthetic_gguf(path, _tiny(arch), seed=seed, **kw)
    return path


# (arch, mode, cache, tol): both archs in both modes, every cache on each
# arch, at most two cases in w4 (JAX's interpret mode takes ~12 s a case).
# tol, of max|logits|.  gemma: the exact mode 1e-2 (bf16 operands:
# the ~7e-3 by which XLA's excess precision moves JAX's jitted logits,
# ROADMAP hazards; measured 5.8e-4-8.1e-4), w4 2.5e-2 (every matmul
# re-quantizes its input to int8, which carries a rounding difference
# further: test_torch_moe.py's bound; measured 1.9e-3-3.5e-3).  gemma2
# renormalizes each attention and FFN output (its post norms), so a
# rounding difference in a small output returns at the size of a whole one,
# and its final softcap here squeezes max|logits| to under 2: the exact
# mode 1.5e-2 (test_torch_deepseek2.py's exact bound; measured 6.5e-3-9.5e-3),
# w4 4e-2 (measured 1.8e-2-2.8e-2), and on the packed int4 cache 5e-2 (its
# rows re-quantize to 4-bit codes that part at rounding boundaries,
# test_torch_kv_q4.py's hazard; measured 1.3e-2-2.3e-2).
GEMMA2_EXACT_TOL = 1.5e-2
CASES = [
    ("gemma2", None, False, GEMMA2_EXACT_TOL),
    ("gemma2", "w4", "q8_0", 4e-2),
    ("gemma2", None, "q4_0", 5e-2),
    ("gemma", None, "q8_0", 1e-2),
    ("gemma", "w4", "q4_0", 2.5e-2),
]


@pytest.mark.parametrize("arch,mode,kv,tol", CASES)
def test_contexts_match_jax(tmp_path, monkeypatch, arch, mode, kv, tol):
    """The file in both packages' contexts (unrolled in both: gemma2 has a
    window, and Q4_K_M's Q6_K attn_v keeps the gemma layers' keys apart),
    a 12-token prefill and N_STEPS decode steps by served_parity (JAX
    decodes greedily, the port takes its tokens; the greedy ids equal
    wherever the top-2 gap exceeds twice tol), within tol (CASES).  The
    tied Q6_K embedding serves the rows and the head (no ``output``); the
    gemma2 layers carry their post norms; kernel 3 attends at D = 256 once
    a layer and step."""
    if mode == "w4":
        monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    path = _file(tmp_path, arch, seed=21 + CASES.index((arch, mode, kv, tol)))
    jcfg, jp, jf = jax_load(path, fast_mode=mode, fuse=True)
    cfg, pp, f = load_gguf_model(path, fast_mode=mode, fuse=True, device="cpu")
    assert f.tensors["token_embd.weight"].ggml_type == Q.Q6_K and "output.weight" not in f.tensors
    jf.close()
    f.close()
    assert "output" not in pp and isinstance(pp["tok_embd"], QTensor)
    assert ("post_attn_norm" in pp["layers"][0]) == (arch == "gemma2")
    assert cfg.swa_window == (WINDOW if arch == "gemma2" else 0)
    calls = {"n": 0}
    real = llama_model.flash_attention

    def counted(q, *a, **kw):
        assert q.shape[-1] == 256
        calls["n"] += 1
        return real(q, *a, **kw)

    monkeypatch.setattr(llama_model, "flash_attention", counted)
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, kv_quant=kv, device="cpu")
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS, kv_quant=kv)
    assert "layers" in pctx.params and "layers" in jctx.params  # unrolled
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, PROMPT).astype(np.int32)
    served_parity(jctx, pctx, prompt, N_STEPS, tol, min_decided=0 if kv == "q4_0" else 2)
    assert calls["n"] == cfg.n_layer * (1 + N_STEPS)


def test_window_and_softcaps_bite(tmp_path):
    """The tiny gemma2's prefill logits move by more than the exact mode's
    tolerance of max|logits| (GEMMA2_EXACT_TOL) when the window, either
    softcap or the post norms are taken away (measured 1.05, 2.9e-2, 0.43
    and 1.25), so the exact parity above holds each of them; with the
    final softcap they stay within +-FINAL_CAP."""
    path = _file(tmp_path, "gemma2", seed=29)
    cfg, pp, f = load_gguf_model(path, fuse=True, device="cpu")
    f.close()
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, PROMPT).astype(np.int32)

    def last_logits(c, params=pp):
        from llama_kotlin_tpu_torch.runtime.batch import Batch

        ctx = LlamaContext(c, params, n_cells=N_CELLS, device="cpu")
        assert ctx.decode(Batch.single(prompt)) == 0
        return ctx.get_logits()[-1]

    base = last_logits(cfg)
    top = np.abs(base).max()
    assert top <= FINAL_CAP
    no_post = dict(pp, layers=[{k: v for k, v in lp.items() if not k.startswith("post_")}
                               for lp in pp["layers"]])
    for other in (last_logits(replace(cfg, swa_window=0)),
                  last_logits(replace(cfg, attn_logit_softcap=0.0)),
                  last_logits(replace(cfg, final_logit_softcap=0.0)),
                  last_logits(cfg, no_post)):
        assert np.abs(other - base).max() > GEMMA2_EXACT_TOL * top


def test_stacked_gemma_takes_the_plain_route(tmp_path, monkeypatch):
    """A gemma file whose layers are uniform (every matrix Q8_0, the tied
    embedding Q6_K) stacks, as in JAX, and attends on the stacked path by
    attend_stacked_plain (kernel 9 takes head dims 64 and 128 only, as
    JAX's, which then attends by XLA) once a layer and step; its logits
    JAX's within 1e-2 (the exact mode's bound)."""
    path = _file(tmp_path, "gemma", seed=31, matrix_type=Q.Q8_0, embd_type=Q.Q6_K)
    jcfg, jp, jf = jax_load(path, fuse=True)
    cfg, pp, f = load_gguf_model(path, fuse=True, device="cpu")
    jf.close()
    f.close()
    n = {"plain": 0}
    real = llama_model.attend_stacked_plain

    def counted(*a, **kw):
        n["plain"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(llama_model, "attend_stacked_plain", counted)
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu")
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS)
    assert "layers_stacked" in pctx.params and "layers_stacked" in jctx.params
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, PROMPT).astype(np.int32)
    served_parity(jctx, pctx, prompt, 2, 1e-2)
    assert n["plain"] == cfg.n_layer * 3


@pytest.mark.parametrize("cache", kshift.CACHES, ids=kshift.CACHE_IDS)
def test_k_shift_neox_at_256(cache, monkeypatch):
    """apply_k_shift on NEOX rope at rope_dim = head_dim = 256 (gemma's:
    pairs j and j + 128), on the bf16, int8 and packed int4 caches (int4
    rows pair dims j and j + 128 in a byte), against JAX's apply_k_shift,
    under tests/test_torch_kshift.py's bounds (its test at D = 256)."""
    monkeypatch.setattr(kshift, "D", 256)
    kshift.test_apply_k_shift_matches_jax(cache, ROPE_TYPE_NEOX)


def test_server_serves_gemma2(tmp_path):
    """The port's engine and OpenAI server, unchanged, serve a tiny gemma2
    file with an SPM vocab (the gemma chat template is the arch's default):
    two concurrent greedy /completion requests over a socket at 2 slots
    each answer 200 with their 8 tokens, and each text renders the tokens
    generate() gives for that prompt alone."""
    import json
    import threading
    import urllib.request

    from llama_kotlin_tpu_torch.runtime import chat
    from llama_kotlin_tpu_torch.runtime.generate import generate
    from llama_kotlin_tpu_torch.tokenizer import build_tokenizer
    from llama_kotlin_tpu_torch.tools import server

    path = tmp_path / "g2.gguf"
    synthetic_gguf(path, _tiny("gemma2"), seed=5,
                   extra_kvs=synthetic_spm_vocab(512, chat_template=None))
    lcfg, params, f = load_gguf_model(path, fuse=True, device="cpu")
    tok = build_tokenizer(f.metadata)
    f.close()
    assert chat.resolve_template(None, lcfg.arch) == "gemma"
    prompts = ["hello world", "the quick brown fox"]
    want = []
    for p in prompts:
        ctx = LlamaContext(lcfg, params, n_cells=256, device="cpu")
        ids = np.asarray(tok.encode(p, add_special=True), np.int32)
        # the engine renders a token at a time (tokenizer.decode([tok]), as
        # JAX's: a piece's leading space is dropped)
        want.append("".join(tok.decode([t], skip_special=False) for t in generate(ctx, ids, 8)))
    ctx = LlamaContext(lcfg, params, n_cells=256, device="cpu")
    state = server.serve(ctx, tok, model_name="tiny-gemma2", port=0, n_slots=2, n_batch=64)
    threading.Thread(target=state.httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{state.httpd.server_address[1]}/completion"
    out = [None, None]

    def post(i):
        body = json.dumps({"prompt": prompts[i], "n_predict": 8, "temperature": 0}).encode()
        req = urllib.request.Request(url, body, {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out[i] = (r.status, json.loads(r.read()))

    threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
    finally:
        state.httpd.shutdown()
        state.shutdown()
    for (status, j), text in zip(out, want):
        assert status == 200 and j["tokens_predicted"] == 8
        assert j["content"] == text


# -- routes at gemma-2-9b's full width ---------------------------------------

# the Pallas site JAX's dispatch reaches -> the port kernel that serves it
JAX_SITE_KERNEL = {"qmm_w4_fx2": "kernel 1", "qmm_w8": "kernel 5",
                   "qmm_pallas_or_none": "kernel 4"}


def _both(qtype: Q, n: int, k: int, seed: int):
    """One [n, k] matrix of random wire blocks folded as the w4 mode loads
    it (Q4_K -> W4, Q6_K -> W8), as a JAX QTensor and as the port's."""
    data = wire_blocks(np.random.default_rng(seed), qtype, n, k)
    jr = jax_repack.repack(data, JQ(int(qtype)), n, k)
    pr = repack.repack(torch.from_numpy(data), qtype, n, k)
    if qtype == Q.Q4_K:
        jw, pw = jax_fold.fold_to_w4(jr), fold.fold_to_w4(pr)
    else:
        jw, pw = jax_fold.fold_to_w8(jr), fold.fold_to_w8(pr)
    return jax.tree.map(jnp.asarray, jw), pw


def _jax_site(monkeypatch, x, jw) -> str:
    """Which Pallas site JAX's qmatmul reaches for x @ jw^T: the sites are
    replaced by recorders that return zeros, so nothing runs."""
    hit = []

    def recorder(name, rows_of):
        def rec(*args, **kw):
            hit.append(name)
            return jnp.zeros(rows_of(args[0]) + (jw.shape[0],), jnp.float32)
        return rec

    monkeypatch.setattr(jax_w4_mod, "qmm_w4_fx2", recorder("qmm_w4_fx2", lambda a: a.shape[:-1]))
    # kernel 5's block-diagonal rows: 512 / group a row of x
    monkeypatch.setattr(jax_w8_mod, "qmm_w8", recorder(
        "qmm_w8", lambda a: (a.shape[0] // (jax_w8_mod.CHUNK // jw.group_size),)))
    monkeypatch.setattr(jax_qmm_mod, "qmm_pallas_or_none",
                        recorder("qmm_pallas_or_none", lambda a: a.shape[:-1]))
    jax_qmatmul(jnp.asarray(x), jw)
    assert len(hit) == 1, hit
    return hit[0]


def _port_kernel(monkeypatch, x, pw) -> str:
    """Which port kernel qmatmul launches (the wrappers replaced by
    recorders)."""
    hit = []
    for attr, name in (("qmm_w4_matmul", "kernel 1"), ("qmm_w8_matmul", "kernel 5"),
                       ("qmm", "kernel 4")):
        monkeypatch.setattr(port_qmatmul, attr,
                            lambda *a, _n=name, **k: hit.append(_n) or torch.zeros(1))
    port_qmatmul.qmatmul(torch.from_numpy(x), pw)
    assert len(hit) == 1, hit
    return hit[0]


def test_w4_decode_routes_as_jax(monkeypatch):
    """gemma-2-9b's matrices at full width in the w4 mode, at one decode
    row and at a 64-row prefill: the fused qkv [8192, 3584] and gate|up
    [28672, 3584] (Q4_K: W4 folds), o [3584, 4096], down [3584, 14336] as
    Q4_K and as Q6_K (a W8 fold, Q4_K_M's use_more_bits layers) and
    attn_v [2048, 3584] as Q6_K take in the port the kernel that serves the
    site JAX's dispatch reaches in interpret mode (every site a recorder,
    so nothing runs): kernels 1 and 5 at a decode row, kernel 4 at 64.  The
    tied lm_head (Q6_K [256000, 3584], a W8 fold too large to build here)
    by the rule both apply: JAX's kernel-5 plan takes its 256000 rows at a
    decode row and the port's qmatmul sends it to kernel 5.  Kernel 2 at E
    = 3584: JAX's entry declines the fused gate|up and down (its codes'
    1792 columns are no multiple of its 512-column chunk) and so does the
    port's ffn_eligible; with a Q6_K down both decline too (mixed
    layouts)."""
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("LKTPU_W4_FX", raising=False)
    E, qkv, F = 3584, 8192, 14336
    mats = {"qkv": (Q.Q4_K, qkv, E), "o": (Q.Q4_K, E, 4096), "gate|up": (Q.Q4_K, 2 * F, E),
            "down": (Q.Q4_K, E, F), "down q6_K": (Q.Q6_K, E, F), "attn_v q6_K": (Q.Q6_K, 2048, E)}
    folds = {name: _both(*shape, seed=40 + i) for i, (name, shape) in enumerate(mats.items())}
    for name, (jw, pw) in folds.items():
        k = pw.shape[1]
        for rows, decode in ((1, "kernel 5" if "q6_K" in name else "kernel 1"),
                             (64, "kernel 4")):
            x = np.zeros((rows, k), np.float32)
            with monkeypatch.context() as m:
                site = _jax_site(m, x, jw)
            with monkeypatch.context() as m:
                got = _port_kernel(m, x, pw)
            assert JAX_SITE_KERNEL[site] == got == decode, (name, rows, site, got)
    nb = -(-32 // (jax_w8_mod.CHUNK // 16))  # kernel 5's padded rows at one decode row
    assert jax_w8_mod._plan(256000, E, jax_w8_mod.CHUNK // 16, nb) is not None
    assert port_qmatmul._decode(torch.zeros((1, E)), SimpleNamespace(shape=(256000, E)))
    x = jnp.zeros((1, E), jnp.float32)
    for dn in ("down", "down q6_K"):
        (jgu, pgu), (jdn, pdn) = folds["gate|up"], folds[dn]
        assert jax_ffn_mod.qmm_w4_ffn_matmul(x, jgu, jdn, act="gelu", interpret=True) is None
        assert not qmm_w4_ffn.ffn_eligible(pgu, pdn, "gelu")
        assert port_qmatmul.qmm_ffn(torch.zeros((1, E)), pgu, pdn, act="gelu") is None
