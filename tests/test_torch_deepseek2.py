"""deepseek2 (DeepSeek-V2: multi-head latent attention, a dense lead layer,
routed and shared experts, YaRN) on the port against the JAX package: the
config (the metadata tests/arch_fixtures.py::make_deepseek2_weights writes,
plus YaRN keys, and synthetic_gguf's DeepSeek-V2-Lite keys), the registry,
and the same seeded GGUF file through both loaders and contexts, with q
LoRA and without it (the Lite model's one ``attn_q``), in the exact and
``w4`` modes at widths the W4 fold takes, on the bf16, int8 and packed int4
caches, prefill then token by token (tests/test_torch_moe.py::
served_parity, the port on JAX's routing); the MLA cache's K shift against
JAX's; and the stacked path's plain MLA route.

In the exact mode the JAX contexts run op by op (jax.disable_jit) on
JAX's CPU routes: there JAX
computes every projection as a bf16 dequantize-then-dot, the function of
its kernel 4's exact branches, and its kernel 3 the masked softmax its XLA
route computes, so interpret mode (4-5 times as long) would compute the
same function.  In ``w4`` they run in interpret mode, so that JAX
takes its kernel 1 (int8-quantized activations) where it plans the matrix
and kernel 4 (bf16) where it declines it, as the port does
(test_w4_decode_routes_as_jax holds that rule at DeepSeek-V2-Lite's
widths).  Kernel 3's MLA branch is held against JAX's kernel in interpret
mode by tests/test_torch_flash_mla.py."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.gguf import GGUFWriter
from llama_kotlin_tpu.models.config import config_from_metadata as jax_config
from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.ops.rope import RopeParams as JaxRope
from llama_kotlin_tpu.quant.formats import GGMLQuantType as JQ
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext
from llama_kotlin_tpu.runtime.kv_cache import KVCache as JaxCache
from llama_kotlin_tpu.runtime.kv_cache import _rotate_k as jax_rotate_k

from llama_kotlin_tpu_torch.models import llama as llama_model
from llama_kotlin_tpu_torch.models import registry
from llama_kotlin_tpu_torch.models.config import config_from_metadata
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import deepseek_v2_lite, moe_metadata
from llama_kotlin_tpu_torch.ops.rope import RopeParams
from llama_kotlin_tpu_torch.runtime.context import LlamaContext
from llama_kotlin_tpu_torch.runtime.kv_cache import KVCache, _rotate_k, apply_k_shift

from tests.arch_fixtures import make_deepseek2_weights
from test_torch_moe import JaxRouting, route_calls, served_parity


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tests' many small CPU ops: more only
    multiplies their CPU time when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a deepseek2 at widths the W4 fold takes: E 256, 4 heads of q/k 64 (32
# nope + 32 rope) and v 32, kv latent 256, q LoRA rank 256, experts and
# shared expert 256 wide, top-2; every contraction a multiple of 256 (Q4_K,
# a W4 fold) but the o projection's 128 (Q8_0, a W8 fold)
DIMS = dict(E=256, L=2, H=4, V=160, n_ctx=128, nope=32, rope=32, v_dim=32, q_rank=256,
            kv_rank=256, n_used=2, moe_F=256, shared_F=256)
YARN = {"deepseek2.rope.scaling.type": "yarn", "deepseek2.rope.scaling.factor": np.float32(4.0),
        "deepseek2.rope.scaling.original_context_length": np.uint32(32)}
N_CELLS = 256
N_STEPS = 4


def _md_ws(seed: int, lite: bool, n_expert: int, dense_lead: int = 1):
    """make_deepseek2_weights at DIMS with YaRN; lite: one attn_q [H*hd, E]
    in place of the q LoRA (attn_q_a, its norm, attn_q_b)."""
    rng = np.random.default_rng(seed)
    md, ws = make_deepseek2_weights(rng, n_expert=n_expert, dense_lead=dense_lead, **DIMS)
    md.update(YARN)
    if lite:
        hd = DIMS["nope"] + DIMS["rope"]
        for i in range(DIMS["L"]):
            for suffix in ("attn_q_a.weight", "attn_q_a_norm.weight", "attn_q_b.weight"):
                del ws[f"blk.{i}.{suffix}"]
            ws[f"blk.{i}.attn_q.weight"] = (rng.standard_normal((DIMS["H"] * hd, DIMS["E"]))
                                            * 0.05).astype(np.float32)
        md["deepseek2.attention.q_lora_rank"] = np.uint32(0)
    return md, ws


def _write(path, md: dict, ws: dict):
    """The weights as a GGUF file: norms and the router F32, matrices Q4_K
    where their contraction is a multiple of 256, else Q8_0."""
    w = GGUFWriter()
    w.add_kv("general.architecture", "deepseek2")
    w.add_kv("general.name", "tiny-deepseek2")
    for k, v in md.items():
        w.add_kv(k, v)
    for name, arr in ws.items():
        dense = arr.ndim == 1 or "ffn_gate_inp" in name
        qt = JQ.F32 if dense else JQ.Q4_K if arr.shape[-1] % 256 == 0 else JQ.Q8_0
        w.add_tensor(name, arr.astype(np.float32), qt)
    w.write(path)
    return path


CFG_FIELDS = ("arch", "n_embd", "n_layer", "n_head", "n_head_kv", "n_ff", "head_dim",
              "v_head_dim", "rope_dim", "n_expert", "n_expert_used", "moe_norm_topk",
              "moe_expert_scale", "rope_yarn_log_mul", "rope_freq_scale", "rope_yarn_ext_factor",
              "rope_yarn_attn_factor", "rope_orig_ctx", "rms_eps", "vocab_size", "attn_scale")


@pytest.mark.parametrize("lite", [False, True])
def test_config_matches_jax(lite):
    """config_from_metadata on deepseek2 metadata (the fixture's with YaRN
    keys; synthetic_gguf's DeepSeek-V2-Lite at 2 layers) gives JAX's
    config field for field, attn_scale's YaRN mscale squared and the rope
    parameters included; the registry marks deepseek2 and llama ported, and
    an architecture it does not (mamba and t5, still to come) raises."""
    md, _ = _md_ws(0, lite, 4)
    md["general.architecture"] = "deepseek2"
    lite_cfg, lite_moe = deepseek_v2_lite(n_layer=2)
    for meta in (md, dict(moe_metadata(lite_cfg, lite_moe))):
        ours, ref = config_from_metadata(meta), jax_config(meta)
        for f in CFG_FIELDS:
            assert getattr(ours, f) == pytest.approx(getattr(ref, f), rel=1e-7), f
        assert ours.rope_params() == RopeParams(**vars(ref.rope_params()))
    assert ours.head_dim == 192 and ours.v_head_dim == 128 and ours.rope_dim == 64
    assert registry.is_ported("deepseek2") and registry.is_ported("llama")
    assert registry.support_status("deepseek2") == "supported" and not registry.is_ported("mamba")
    with pytest.raises(NotImplementedError, match="item 13"):
        config_from_metadata({"general.architecture": "t5"})


# (q LoRA or Lite, experts, mode, cache, tol): every value of each axis, and
# both modes on each variant and on E <= 16 (a per-expert W4 list) and E > 16
# (a stacked exact repack, gathered at decode, in w4 as DeepSeek-V2-Lite's
# 64).  tol, of max|logits| (the logits' std is 0.34-0.37 of it, and a
# wiring fault moves them by about one std): the exact mode on bf16 operands
# 1.5e-2 (measured 1.1-1.5e-2: XLA's excess precision, ROADMAP hazards,
# through the MLA norms); a packed int4 cache 5e-2 (measured 2.6e-2: K and V
# rows differing by the above re-quantize to 4-bit codes that part at
# rounding boundaries, test_torch_kv_q4.py's hazard).  w4, both sides on
# the same kernels' functions: 3.5e-2 on a bf16 cache (measured 1.3-2.8e-2)
# and 5e-2 on an int8 one (measured 2.6-4.2e-2).  Every matmul input
# re-quantizes to int8 there, which carries a rounding difference further:
# moving 1.5% of the port's own embedding values by one bf16 step moved
# its logits by 0.7-2.3e-2 in the exact mode and 1.8-8.2e-2 in w4 on these
# files.  Routing parted from JAX's on at most 1 row of 20, a near-tie.
# In the exact mode JAX runs op by op (jax.disable_jit): jitted, XLA's
# excess precision put the bf16-cache case at 0.8-1.2e-2, at the top of its
# bound, and a run of the whole suite in parallel workers crossed it; op by
# op it measured 3.1-4.6e-3 (the same file, steps and threads).
CASES = [
    ("lora", 4, None, False, 1.5e-2),
    ("lora", 4, "w4", "q8_0", 5e-2),
    ("lite", 20, "w4", False, 3.5e-2),
    ("lite", 20, None, "q4_0", 5e-2),
]


@pytest.mark.parametrize("variant,n_expert,mode,kv,tol", CASES)
def test_contexts_match_jax(tmp_path, monkeypatch, variant, n_expert, mode, kv, tol):
    """The file in both packages' contexts (unrolled in both: the dense lead
    layer's keys differ from the MoE layer's; JAX in interpret mode in w4),
    a 12-token prefill and N_STEPS decode steps by served_parity on JAX's
    routing, within tol (CASES).  The port's MoE routes are JAX's rule on its rows; the rows
    whose own routing parts from JAX's are near-ties, at most a tenth."""
    if mode == "w4":
        monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    md, ws = _md_ws(41, variant == "lite", n_expert)
    path = _write(tmp_path / "ds2.gguf", md, ws)
    jcfg, jp, jf = jax_load(path, fast_mode=mode, fuse=True)
    cfg, pp, f = load_gguf_model(path, fast_mode=mode, fuse=True, device="cpu")
    jf.close()
    f.close()
    assert ("wq_a" in pp["layers"][0]) == (variant == "lora")
    assert ("wq" in pp["layers"][0]) == (variant == "lite")
    calls = route_calls(monkeypatch)
    routing = JaxRouting(monkeypatch)
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, kv_quant=kv, device="cpu")
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS, kv_quant=kv)
    assert "layers" in pctx.params and "layers" in jctx.params  # unrolled
    assert pctx.cache.v.shape[-1] * (2 if kv == "q4_0" else 1) == cfg.v_head_dim == 32
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, 12).astype(np.int32)
    with jax.disable_jit(mode is None):
        served_parity(jctx, pctx, prompt, N_STEPS, tol, min_decided=2 if tol < 2e-2 else 0)
    assert routing.check() <= routing.rows // 10
    stacked = mode is None or n_expert > 16
    moe_layers = cfg.n_layer - 1
    assert calls == {"grouped": 0, "sweep": moe_layers * (1 + (0 if stacked else N_STEPS)),
                     "gathered": moe_layers * (N_STEPS if stacked else 0)}


@pytest.mark.parametrize("n,kernel", [(576, "qmm"), (512, "qmm_w4_matmul")])
def test_w4_decode_routes_as_jax(monkeypatch, n, kernel):
    """DeepSeek-V2-Lite's attn_kv_a_mqa at full width ([576, 2048] Q4_K, a
    compact W4 fold) at one decode row: JAX's kernel 1 plans no block of
    576 output rows and declines, so JAX's dispatch computes it on kernel 4
    with bf16 activations; the port's qmatmul sends it to kernel 4 too,
    and 512 rows to kernel 1 in both.  Each within 1e-3 of max|y| of JAX's
    dispatch in interpret mode (test_torch_kernels.py::
    test_qmm_matches_jax's bound for kernel 4; kernel 1's is tighter)."""
    from llama_kotlin_tpu.ops.qmatmul import qmatmul as jax_qmatmul
    from llama_kotlin_tpu.ops.pallas.qmm_w4 import qmm_w4_matmul as jax_qmm_w4
    from llama_kotlin_tpu_torch.ops import qmatmul as port_qmatmul
    from test_torch_qmm_w4 import both_w4

    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    jw, pw = both_w4(11, n, 2048, "compact")
    x = (np.random.default_rng(12).standard_normal((1, 2048)) * 0.7).astype(np.float32)
    assert (jax_qmm_w4(jnp.asarray(x), jw, interpret=True) is None) == (kernel == "qmm")
    ref = np.asarray(jax_qmatmul(jnp.asarray(x), jw), np.float32)
    calls = []
    for name in ("qmm", "qmm_w4_matmul"):
        real = getattr(port_qmatmul, name)
        monkeypatch.setattr(port_qmatmul, name,
                            lambda *a, _r=real, _n=name, **kw: calls.append(_n) or _r(*a, **kw))
    got = port_qmatmul.qmatmul(torch.from_numpy(x), pw).numpy()
    assert calls == [kernel]
    assert got.shape == (1, n)
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


def test_stacked_mla_takes_the_plain_route(tmp_path, monkeypatch):
    """A deepseek2 file with no dense lead stacks (its layers are uniform),
    as in JAX, and attends on the stacked path by JAX's XLA route
    (attend_stacked_plain: kernel 9 takes one K/V width only) once a layer
    and step, its logits JAX's within 1.5e-2 (the exact mode's bound)."""
    md, ws = _md_ws(43, True, 4, dense_lead=0)
    path = _write(tmp_path / "ds2.gguf", md, ws)
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
    routing = JaxRouting(monkeypatch)
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu")
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS)
    assert "layers_stacked" in pctx.params and "layers_stacked" in jctx.params
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, 12).astype(np.int32)
    served_parity(jctx, pctx, prompt, 2, 1.5e-2)
    routing.check()
    assert n["plain"] == cfg.n_layer * 3


@pytest.mark.parametrize("quantized", [False, "q8_0"])
def test_k_shift_turns_jax_dims(quantized):
    """apply_k_shift on an MLA cache (K 64 wide, V 48) turns the dims JAX's
    _rotate_k turns with n_rot = rope_dim = 32: the FIRST 32 of each K row
    (on deepseek2's K those are nope dims: its rope dims are the last),
    leaving the rest of K and all of V as they were; the rotated bf16 rows
    equal JAX's bit for bit, an int8 cache's codes and scales JAX's
    rotation requantized, within test_torch_kshift.py's bounds."""
    rng = np.random.default_rng(9)
    L, KV, cells = 2, 4, 20
    cache = KVCache.create(L, cells, KV, 64, device="cpu", quantized=quantized, v_head_dim=48)
    kf = torch.from_numpy(rng.standard_normal((L, KV, cells, 64)).astype(np.float32))
    vf = torch.from_numpy(rng.standard_normal((L, KV, cells, 48)).astype(np.float32))
    if quantized:
        from llama_kotlin_tpu_torch.runtime.kv_cache import quantize_rows

        (kc, ks), (vc, vs) = quantize_rows(kf), quantize_rows(vf)
        cache.k.copy_(kc), cache.k_scale.copy_(ks), cache.v.copy_(vc), cache.v_scale.copy_(vs)
    else:
        cache.k.copy_(kf.to(torch.bfloat16)), cache.v.copy_(vf.to(torch.bfloat16))
    k0, v0 = cache.k.clone(), cache.v.clone()
    deltas = np.zeros(cells, np.int32)
    deltas[3:11] = -4
    rope = dict(n_rot=32, freq_base=10000.0, freq_scale=0.25, ext_factor=1.0,
                attn_factor=0.8782, n_ctx_orig=32)
    apply_k_shift(cache, deltas, RopeParams(**rope))
    assert torch.equal(cache.v, v0)
    moved = deltas != 0
    if not quantized:
        assert torch.equal(cache.k[..., 32:], k0[..., 32:])
        assert not torch.equal(cache.k[:, :, 3:11, :32], k0[:, :, 3:11, :32])
        ref = jax_rotate_k(jnp.asarray(k0.to(torch.float32).numpy()).astype(jnp.bfloat16),
                           jnp.asarray(deltas), JaxRope(**rope), False)
        np.testing.assert_array_equal(cache.k.to(torch.float32).numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
    else:
        from llama_kotlin_tpu.runtime.kv_cache import CellMetadata as JaxMeta
        from llama_kotlin_tpu.runtime.kv_cache import apply_k_shift as jax_shift

        jc = JaxCache(k=jnp.asarray(k0.numpy()), v=jnp.asarray(v0.numpy()),
                      k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()))
        out = jax_shift(jc, JaxMeta(cells), deltas, JaxRope(**rope))
        a, b = np.asarray(out.k, np.int32), cache.k.numpy().astype(np.int32)
        sa, sb = np.asarray(out.k_scale), cache.k_scale.numpy()
        # test_torch_kshift.py's bounds: cells with delta 0 bit for bit;
        # shifted ones' scales within a few f32 ulps (XLA's and torch's
        # cos/sin and amax / 127 differ in the last bit) and codes within
        # one step on at most 1e-3 of them
        np.testing.assert_array_equal(a[:, :, ~moved], b[:, :, ~moved])
        np.testing.assert_array_equal(sa[:, :, ~moved], sb[:, :, ~moved])
        np.testing.assert_allclose(sb, sa, rtol=5e-7, atol=0)
        assert np.abs(a - b).max() <= 1 and (a != b).mean() <= 1e-3
        assert (b[:, :, moved, :32] != k0.numpy()[:, :, moved, :32]).mean() > 0.2
        assert out.v.shape[-1] == 48


def test_server_serves_deepseek2(tmp_path):
    """The port's engine and OpenAI server, unchanged, serve a deepseek2
    file (synthetic_gguf's DeepSeek-V2-Lite layout at CPU widths, with an
    SPM vocab): two concurrent greedy /completion requests over a socket at
    2 slots each answer 200 with their 8 tokens, and each text is the one
    generate()'s tokens give for that prompt alone, a token's decode at a
    time as the engine appends them."""
    import json
    import threading
    import urllib.request
    from dataclasses import replace

    from llama_kotlin_tpu_torch.models.synthetic import synthetic_gguf, synthetic_spm_vocab
    from llama_kotlin_tpu_torch.runtime.generate import generate
    from llama_kotlin_tpu_torch.tokenizer import build_tokenizer
    from llama_kotlin_tpu_torch.tools import server

    cfg, moe_shape = deepseek_v2_lite(n_layer=2)
    cfg = replace(cfg, n_embd=256, n_ff=512, vocab_size=512, n_expert=8, n_expert_used=2)
    path = tmp_path / "ds2.gguf"
    synthetic_gguf(path, cfg, seed=12, moe=replace(moe_shape, expert_ff=256, kv_lora_rank=256),
                   extra_kvs=synthetic_spm_vocab(512))
    lcfg, params, f = load_gguf_model(path, fuse=True, device="cpu")
    tok = build_tokenizer(f.metadata)
    f.close()
    prompts = ["hello world", "the quick brown fox"]
    want = []
    for p in prompts:
        ctx = LlamaContext(lcfg, params, n_cells=256, device="cpu")
        ids = np.asarray(tok.encode(p, add_special=True), np.int32)
        # the engine appends each token's own decode (JAX's engine.py:606):
        # a lone SPM piece drops its leading space, so the text is built so
        want.append("".join(tok.decode([t], skip_special=False)
                            for t in generate(ctx, ids, 8)))
    ctx = LlamaContext(lcfg, params, n_cells=256, device="cpu")
    state = server.serve(ctx, tok, model_name="tiny-ds2", port=0, n_slots=2, n_batch=64)
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
