"""Port parity for the GGUF loader and the served slice: one llama file with
the Q4_K_M type mix (E=2048, two layers, head_dim 128, vocab 512; layer 0
all Q4_K, layer 1 with Q6_K attn_v and ffn_down, output Q6_K), written by
the port's writer from a seed and loaded by both loaders in the W4 and
int8 fast modes."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import torch

from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.convert import params_from_numpy
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import q4_k_m_layer_types, synthetic_gguf
from llama_kotlin_tpu_torch.ops.qmatmul import qmm_ffn
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q
from llama_kotlin_tpu_torch.quant.qtensor import QTensor
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from test_torch_model import N_CELLS, N_PROMPT, _steps

CFG = ModelConfig(arch="llama", name="tiny-q4km", vocab_size=512, n_embd=2048, n_layer=2,
                  n_head=16, n_head_kv=8, n_ff=2048, n_ctx_train=4096)
MODES = ["w4", "int8"]


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("gguf") / "tiny-q4km.gguf"
    synthetic_gguf(path, CFG, seed=11)
    return path


@pytest.fixture(scope="module")
def loaded(gguf_path):
    """mode -> (JAX cfg, JAX params, port cfg, port params), both fused."""
    out = {}
    for mode in MODES:
        jcfg, jp, jf = jax_load(gguf_path, fast_mode=mode, fuse=True)
        cfg, pp, f = load_gguf_model(gguf_path, fast_mode=mode, fuse=True, device="cpu")
        jf.close()
        f.close()
        out[mode] = (jcfg, jp, cfg, pp)
    return out


def test_q4_k_m_profile():
    """The default type mix is llama.cpp's use_more_bits rule: at 32 layers
    layers 0-3, 6, 9, ..., 24 and 27-31 take Q6_K; at 2 layers layer 1."""
    more = [i for i, t in enumerate(q4_k_m_layer_types(32)) if t["ffn_down"] == Q.Q6_K]
    assert more == [0, 1, 2, 3, 6, 9, 12, 15, 18, 21, 24, 27, 28, 29, 30, 31]
    assert [t["attn_v"] for t in q4_k_m_layer_types(2)] == [Q.Q4_K, Q.Q6_K]


def _same_tree(ours, ref, path="params"):
    """Port params equal a converted JAX tree: same keys, QTensors of the
    same layout with equal tensors, f32 tensors equal."""
    if isinstance(ref, dict):
        assert set(ours) == set(ref), path
        for k in ref:
            _same_tree(ours[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _same_tree(a, b, f"{path}[{i}]")
    elif isinstance(ref, QTensor):
        assert (ours.flavor, ours.shape, ours.group_size, int(ours.qtype)) == (
            ref.flavor, ref.shape, ref.group_size, int(ref.qtype)), path
        assert ours.tensors().keys() == ref.tensors().keys(), path
        for name, t in ref.tensors().items():
            assert torch.equal(ours.tensors()[name], t), f"{path}.{name}"
    elif ref is None:
        assert ours is None, path
    else:
        assert ours.dtype == torch.float32 and torch.equal(ours, ref), path


@pytest.mark.parametrize("mode", MODES)
def test_loaders_give_equal_folds(loaded, mode):
    """Both loaders give the same config and, field by field, the same
    folded tensors: codes, scales and mins against the JAX arrays
    directly, and every plane through params_from_numpy(JAX params).
    Layer 0 fuses q|k|v; layer 1's W4 wq/wk and W8 wv stay split in the
    W4 mode and fuse in the int8 mode (all Q8F)."""
    jcfg, jp, cfg, pp = loaded[mode]
    for f in ("n_embd", "n_layer", "n_head", "n_head_kv", "n_ff", "head_dim", "vocab_size",
              "rope_freq_base", "rope_freq_scale", "rms_eps", "rope_dim", "n_ctx_train"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    split = {"wq", "wk", "wv"} <= set(pp["layers"][1])
    assert split == (mode == "w4") and "wqkv_fused" in pp["layers"][0]
    assert "ffn_gateup_fused" in pp["layers"][1]
    flavors = {"w4": ("compact", "w8"), "int8": ("q8f", "q8f")}[mode]
    assert (pp["tok_embd"].flavor, pp["output"].flavor) == flavors
    for key in ("output", "tok_embd"):
        j, p = jp[key], pp[key]
        np.testing.assert_array_equal(p.codes.numpy(), np.asarray(j.codes))
        np.testing.assert_array_equal(p.g_scale.numpy(), np.asarray(j.g_scale, np.float32))
        if j.g_min is not None:
            np.testing.assert_array_equal(p.g_min.numpy(), np.asarray(j.g_min, np.float32))
    _same_tree(pp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))


def test_ffn_kernel_declines_w8_down(loaded):
    """qmm_ffn takes layer 0 (all W4) and declines layer 1, whose ffn_down
    is a W8 fold, and every Q8F layer: kernel 2 would read int8 codes as
    nibbles."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 2048)).astype(np.float32))
    w4 = loaded["w4"][3]["layers"]
    assert qmm_ffn(x, w4[0]["ffn_gateup_fused"], w4[0]["ffn_down"]) is not None
    assert w4[1]["ffn_down"].flavor == "w8"
    assert qmm_ffn(x, w4[1]["ffn_gateup_fused"], w4[1]["ffn_down"]) is None
    q8 = loaded["int8"][3]["layers"]
    assert qmm_ffn(x, q8[0]["ffn_gateup_fused"], q8[0]["ffn_down"]) is None


def _forced_steps(ctx, prompt, tokens):
    """Prefill, then one decode step per given token (teacher forcing):
    the logits of every step."""
    assert ctx.decode(Batch.single(prompt)) == 0
    logits = [ctx.get_logits()[-1]]
    for i, tok in enumerate(tokens[:-1]):
        assert ctx.decode(Batch.single([tok], pos0=N_PROMPT + i)) == 0
        logits.append(ctx.get_logits()[-1])
    return logits


@pytest.mark.parametrize("mode", MODES)
def test_gguf_serving_matches_jax(loaded, mode, monkeypatch):
    """A 12-token prefill and 8 greedy steps on the loaded file: the JAX
    context decodes greedily; the port's context takes the same tokens
    (so one near-tie cannot send the two down different paths) and its
    logits must stay within 4e-2 of max|logits| at every step, its greedy
    token equal JAX's at every step decided by more than twice that.

    Why 4e-2: the kernels agree with the Pallas ones to ~1e-5 of max|y|,
    but every matmul re-quantizes its input to int8 and the residual stream
    is bf16, so an f32 last-bit difference crosses a rounding boundary now
    and then and the next layers carry it on.  On this model a 2-ulp change
    of the attention norm weights moves the port's own logits by 1.4e-2 to
    2.4e-2 of max|logits| and flips greedy tokens where the top-2 gap is
    ~1e-3; the port-vs-JAX error measured 1.7e-2 to 2.5e-2.  Logits spread
    ~0.3 of max|logits| (std), so 4e-2 is ~0.15 std, where a wiring fault
    moves them by about one std."""
    jcfg, jp, cfg, pp = loaded[mode]
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    prompt = np.random.default_rng(17).integers(0, CFG.vocab_size, N_PROMPT).astype(np.int32)
    jt, jl = _steps(JaxContext(jcfg, jp, n_cells=N_CELLS, prefer_unrolled=True), JaxBatch, prompt)
    pl = _forced_steps(LlamaContext(cfg, pp, n_cells=N_CELLS, prefer_unrolled=True, device="cpu"),
                       prompt, jt)
    assert len(set(jt)) > 1  # the zero-mean weights give tokens that vary
    tol, decided = 4e-2, 0
    for tok, a, b in zip(jt, pl, jl):
        top = np.abs(b).max()
        assert np.abs(a - b).max() <= tol * top
        s = np.sort(b)
        if s[-1] - s[-2] > 2 * tol * top:
            assert int(np.argmax(a)) == tok
            decided += 1
    assert decided >= 2  # the token check carries signal


def test_fast_mode_none_raises(gguf_path):
    """The exact-dequant mode waits for a later slice; it never falls back,
    and neither does a mode the port does not know."""
    with pytest.raises(NotImplementedError, match="exact-dequant"):
        load_gguf_model(gguf_path, fast_mode=None, device="cpu")
    with pytest.raises(NotImplementedError):
        load_gguf_model(gguf_path, fast_mode="w8", device="cpu")
