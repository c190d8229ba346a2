"""Port parity for the stacked-layer path and the int8 KV cache end to end:
which models stack (``can_stack``/``stack_layers``), and the port's
LlamaContext against the JAX package's with the same ``prefer_unrolled``
and ``kv_quant`` on identical weights."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import torch

from llama_kotlin_tpu.models.config import ModelConfig as JaxConfig
from llama_kotlin_tpu.models.llama import can_stack as jax_can_stack
from llama_kotlin_tpu.models.llama import stack_layers as jax_stack_layers
from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.models.synthetic import synthetic_params_device as jax_params
from llama_kotlin_tpu.quant.formats import GGMLQuantType
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.convert import params_from_numpy
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.models import llama as llama_model
from llama_kotlin_tpu_torch.models.llama import can_stack, layer_views, stack_layers
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import synthetic_gguf
from llama_kotlin_tpu_torch.ops.cuda.flash_stacked import flash_attention_stacked
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext
from llama_kotlin_tpu_torch.runtime.generate import generate

from test_torch_loader import CFG as GGUF_CFG, _forced_steps
from test_torch_model import CFG, N_CELLS, N_PROMPT, N_STEPS, _steps

# (prefer_unrolled, kv_quant): the stacked default with both caches, and the
# unrolled path with the int8 cache
CASES = [(False, False), (False, "q8_0"), (True, "q8_0")]
CASE_IDS = ["stacked-bf16", "stacked-q8_0", "unrolled-q8_0"]
# logit tolerance per model, relative to max|logits|: the synthetic model's
# is tests/test_torch_model.py's, the zero-mean int8-mode file's is
# tests/test_torch_loader.py's (its logits carry f32 last-bit differences
# further: there a 2-ulp change of a norm weight moves them by ~2e-2)
LOGIT_TOL = {"synthetic": 1e-2, "gguf-int8": 4e-2}


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**CFG)
    jp = jax_params(jcfg, GGMLQuantType.Q4_K, fast_w4a8=True, fuse=True)
    return jcfg, jp, ModelConfig(**CFG), params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def gguf_models(tmp_path_factory):
    """mode -> (JAX cfg, JAX params, port cfg, port params) of one Q4_K_M-
    profile file (layer 1 with split q/k/v in the w4 mode)."""
    path = tmp_path_factory.mktemp("gguf") / "tiny-q4km.gguf"
    synthetic_gguf(path, GGUF_CFG, seed=11)  # tests/test_torch_loader.py's file
    out = {}
    for mode in ("w4", "int8"):
        jcfg, jp, jf = jax_load(path, fast_mode=mode, fuse=True)
        cfg, pp, f = load_gguf_model(path, fast_mode=mode, fuse=True, device="cpu")
        jf.close()
        f.close()
        out[mode] = (jcfg, jp, cfg, pp)
    return out


def _jax_stacks(jp, jcfg) -> bool:
    if not jax_can_stack(jp, jcfg):
        return False
    try:
        jax_stack_layers(jp)
    except (ValueError, TypeError):
        return False
    return True


def test_synthetic_model_stacks(models):
    """The synthetic W4A8 model stacks on both sides; the port's stacked
    leaves hold every layer's planes, and a layer is a view of the stack
    (no copy per step)."""
    jcfg, jp, cfg, pp = models
    assert can_stack(pp, cfg) and _jax_stacks(jp, jcfg)
    st = stack_layers(pp)
    assert "layers" not in st and st["n_layer"] == 2
    views = layer_views(st)
    for i, lp in enumerate(pp["layers"]):
        for key, w in lp.items():
            view = views[i][key]
            if isinstance(w, torch.Tensor):
                assert torch.equal(view, w)
                continue
            assert (view.flavor, view.shape) == (w.flavor, w.shape)
            for name, t in w.tensors().items():
                got, whole = view.tensors()[name], st["layers_stacked"][key].tensors()[name]
                assert torch.equal(got, t), (key, name)
                assert got.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr()


@pytest.mark.parametrize("mode", ["w4", "int8"])
def test_gguf_stacking_matches_jax(gguf_models, mode):
    """On a Q4_K_M-profile file the port decides as JAX does: the w4 mode's
    mixed layers (split q/k/v beside fused) stay unrolled, the int8 mode's
    uniform Q8F layers stack; both default contexts take the same path."""
    jcfg, jp, cfg, pp = gguf_models[mode]
    stacks = mode == "int8"
    assert can_stack(pp, cfg) == jax_can_stack(jp, jcfg) == stacks
    assert _jax_stacks(jp, jcfg) == stacks
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS)
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu")
    assert ("layers_stacked" in pctx.params) == ("layers_stacked" in jctx.params) == stacks


def test_mixed_layouts_fall_back_to_unrolled(gguf_models):
    """Layers with the same keys but different layouts (layer 1's ffn_down
    a W8 fold where layer 0's is Q8F) pass can_stack, make stack_layers
    raise ValueError on both sides, and so leave both default contexts
    unrolled; the port's still serves them."""
    jcfg, jp8, cfg, pp8 = gguf_models["int8"]
    jp4, pp4 = gguf_models["w4"][1], gguf_models["w4"][3]

    def mixed(p8, p4):
        w8_down = dict(p8["layers"][1], ffn_down=p4["layers"][1]["ffn_down"])
        return {**p8, "layers": [p8["layers"][0], w8_down]}

    jm, pm = mixed(jp8, jp4), mixed(pp8, pp4)
    assert jax_can_stack(jm, jcfg) and can_stack(pm, cfg)
    with pytest.raises(ValueError):
        jax_stack_layers(jm)
    with pytest.raises(ValueError):
        stack_layers(pm)
    assert "layers" in JaxContext(jcfg, jm, n_cells=N_CELLS).params
    ctx = LlamaContext(cfg, pm, n_cells=N_CELLS, device="cpu")
    assert "layers" in ctx.params
    assert ctx.decode(Batch.single(np.arange(4, dtype=np.int32))) == 0


@pytest.mark.parametrize("model", list(LOGIT_TOL))
@pytest.mark.parametrize("prefer_unrolled,kv_quant", CASES, ids=CASE_IDS)
def test_slice_matches_jax(models, gguf_models, model, prefer_unrolled, kv_quant, monkeypatch):
    """A 12-token prefill and 8 greedy steps through the JAX LlamaContext and
    the port's, both with the same prefer_unrolled and kv_quant.  The JAX
    context decodes greedily; the port's takes the same tokens.

    Two models: the synthetic W4A8 one (params carried across by
    params_from_numpy) and the int8-mode Q4_K_M-profile file, loaded by
    both loaders.  Logits: within LOGIT_TOL of max|logits| at every step
    (bf16 residual stream and int8 activation re-quantization carry f32
    last-bit differences on); the greedy token equals JAX's wherever the
    top-2 gap exceeds twice that, which the file's zero-mean weights give
    at some steps.

    int8 cache after the prefill, every layer of the synthetic model and
    layer 0 of the file (whose layer 1 inherits the logits' larger
    spread): codes differ by at most 1 and scales by at most 1e-3 relative
    (an eighth of one code step, 1/127).  The K/V rows differ before
    quantization because the JAX W4 kernel's output is itself ~1e-4 of
    max|y| off the exact product (the port's plain version is within 2e-7
    of a float64 reference on these layers), so a value near a rounding
    boundary may take the neighbouring code."""
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    pair = models if model == "synthetic" else gguf_models["int8"]
    slice_vs_jax(pair, model, prefer_unrolled, kv_quant, LOGIT_TOL[model])


def _cache_codes(x, bits: int) -> np.ndarray:
    """A cache plane's codes as int32: int8 codes, or packed int4 unpacked."""
    if bits == 4:
        x = np.asarray(x)
        lo = (x & 0x0F).astype(np.int32) - 8
        hi = (x >> 4).astype(np.int32)
        return np.concatenate([lo, np.where(hi > 7, hi - 16, hi)], axis=-1)
    return np.asarray(x).astype(np.int32)


def slice_vs_jax(pair, model: str, prefer_unrolled: bool, kv_quant, tol: float,
                 min_decided: int = 2) -> list:
    """test_slice_matches_jax's comparison for one model pair (JAX cfg, JAX
    params, port cfg, port params) and context options; the quantized
    cache's codes (int8, or int4 unpacked) differ by at most 1 and its
    scales by 1e-3 relative; on the file, at least min_decided steps have a
    top-2 gap above twice tol.  Returns the relative logit error per step."""
    jcfg, jp, cfg, pp = pair
    seed = 7 if model == "synthetic" else 17  # the prompts of the two source tests
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, N_PROMPT).astype(np.int32)
    kw = dict(n_cells=N_CELLS, prefer_unrolled=prefer_unrolled, kv_quant=kv_quant)
    jctx = JaxContext(jcfg, jp, **kw)
    pctx = LlamaContext(cfg, pp, device="cpu", **kw)
    assert ("layers_stacked" in pctx.params) == ("layers_stacked" in jctx.params) \
        == (not prefer_unrolled)
    assert pctx.cache.quantized == jctx.cache.quantized == bool(kv_quant)

    assert jctx.decode(JaxBatch.single(prompt)) == 0
    assert pctx.decode(Batch.single(prompt)) == 0
    if kv_quant:
        # the prompt's cells, the first free ones on both sides
        at = (slice(None) if model == "synthetic" else slice(0, 1), slice(None),
              slice(0, N_PROMPT))
        bits = pctx.cache.kv_bits
        assert bits == jctx.cache.kv_bits
        for name in ("k", "v"):
            jc = _cache_codes(np.asarray(getattr(jctx.cache, name))[at], bits)
            pc = _cache_codes(getattr(pctx.cache, name)[at].numpy(), bits)
            assert pc.any() and np.abs(pc - jc).max() <= 1, name
            js = np.asarray(getattr(jctx.cache, name + "_scale"))[at]
            ps = getattr(pctx.cache, name + "_scale")[at].numpy()
            assert (ps > 0).all()
            assert np.abs(ps - js).max() <= 1e-3 * np.abs(js).max(), name
    jl = [np.asarray(jctx.get_logits()[-1], np.float32)]
    pl = [pctx.get_logits()[-1]]
    toks = [int(np.argmax(jl[-1]))]
    for i in range(N_STEPS - 1):
        assert jctx.decode(JaxBatch.single([toks[-1]], pos0=N_PROMPT + i)) == 0
        assert pctx.decode(Batch.single([toks[-1]], pos0=N_PROMPT + i)) == 0
        jl.append(np.asarray(jctx.get_logits()[-1], np.float32))
        pl.append(pctx.get_logits()[-1])
        toks.append(int(np.argmax(jl[-1])))
    decided, errs = 0, [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(pl, jl)]
    for tok, a, b in zip(toks, pl, jl):
        top = np.abs(b).max()
        assert np.abs(a - b).max() <= tol * top, errs
        s = np.sort(b)
        if s[-1] - s[-2] > 2 * tol * top:
            assert int(np.argmax(a)) == tok
            decided += 1
    if model != "synthetic":  # its random row means give one token throughout
        assert len(set(toks)) > 1 and decided >= min_decided
    return errs


@pytest.mark.parametrize("kv_quant", [False, "q8_0"])
def test_stacked_generate_matches_steps(gguf_models, kv_quant):
    """On the int8-mode file (zero-mean weights, tokens that vary), the
    stacked context's device-loop generate (unpadded single rows through
    kernel 9's plain version) gives the tokens of its own step-wise greedy
    decode, and those logits stay within the file's LOGIT_TOL of the
    unrolled context's: the two paths attend over the same rows (the fresh
    ones rounded to bf16 on the stacked path, as in the JAX package) in
    another summation order."""
    _, _, cfg, pp = gguf_models["int8"]
    prompt = np.random.default_rng(17).integers(0, GGUF_CFG.vocab_size, N_PROMPT).astype(np.int32)
    stacked = LlamaContext(cfg, pp, n_cells=N_CELLS, kv_quant=kv_quant, device="cpu")
    assert "layers_stacked" in stacked.params
    toks, sl = _steps(stacked, Batch, prompt)
    assert len(set(toks)) > 1
    ul = _forced_steps(LlamaContext(cfg, pp, n_cells=N_CELLS, kv_quant=kv_quant,
                                    prefer_unrolled=True, device="cpu"), prompt, toks)
    for a, b in zip(sl, ul):
        assert np.abs(a - b).max() <= LOGIT_TOL["gguf-int8"] * np.abs(b).max()
    stacked.clear()
    assert generate(stacked, prompt, N_STEPS) == toks


def test_q4_0_cache_raises(models, monkeypatch):
    """A q4_0 context stacks the synthetic model, as JAX's does, and its
    stacked steps attend by the plain route (attend_stacked_q4, once a layer
    and step), never through kernel 9, which raises if handed the packed
    cache."""
    _, _, cfg, pp = models
    ctx = LlamaContext(cfg, pp, n_cells=N_CELLS, kv_quant="q4_0", device="cpu")
    assert "layers_stacked" in ctx.params
    assert ctx.cache.kv_bits == 4 and ctx.cache.k.dtype == torch.uint8
    calls = []
    plain = llama_model.attend_stacked_q4
    monkeypatch.setattr(llama_model, "attend_stacked_q4",
                        lambda *a, **kw: calls.append(a[2]) or plain(*a, **kw))
    assert ctx.decode(Batch.single(np.arange(N_PROMPT, dtype=np.int32))) == 0
    assert ctx.decode(Batch.single([3], pos0=N_PROMPT)) == 0
    assert calls == [0, 1, 0, 1] and np.isfinite(ctx.get_logits()).all()
    q = torch.zeros((1, cfg.n_head, cfg.head_dim), dtype=torch.bfloat16)
    new = torch.zeros((1, cfg.n_head_kv, cfg.head_dim), dtype=torch.bfloat16)
    mask = torch.ones((1, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="q4_0"):
        flash_attention_stacked(q, ctx.cache.k, ctx.cache.v, 0, new, new, mask, mask[:, :1],
                                scale=1.0, k_scale=ctx.cache.k_scale, v_scale=ctx.cache.v_scale)
