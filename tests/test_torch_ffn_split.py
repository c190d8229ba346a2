"""Port parity for kernel 2's separate gate/up branch (JAX's ``up=``): the
wrapper against JAX's qmm_w4_ffn_matmul(..., up=...) in interpret mode on
compact, legacy and sym folds, and a 2-layer model loaded unfused (gate and
up apart, as both loaders load by default) served through the port's and
JAX's LlamaContext, with recorders showing that kernel 2 takes each layer's
decode FFN on that branch where JAX's does.

The port side runs the plain PyTorch versions of its CUDA kernels (CPU
tensors take them)."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import llama_kotlin_tpu.ops.pallas.qmm_w4_ffn as jax_ffn_mod
from llama_kotlin_tpu.models.config import ModelConfig as JaxConfig
from llama_kotlin_tpu.models.synthetic import synthetic_params_device as jax_params
from llama_kotlin_tpu.quant.formats import GGMLQuantType as JaxType
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.convert import params_from_numpy
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.ops.cuda import qmm_w4_ffn
from llama_kotlin_tpu_torch.quant.qtensor import concat_qtensors
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from test_torch_loader import _forced_steps
from test_torch_model import CFG, N_CELLS, N_PROMPT, _steps
from test_torch_qmm_plan import _rel_err
from test_torch_qmm_w4 import FLAVORS, both_w4

E = F = 2048


@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_up_branch_matches_jax(flavor):
    """Separate gate [F, E] and up [F, E] folds, 3 rows: the port's kernel
    2 (its plain version) within 5e-3 of max|y| of JAX's megakernel on its
    up= branch (kernel 2's tolerance: h is rounded to bf16 and re-quantized,
    so an f32 last-bit difference can move one h code), and bit-equal to
    the fused layout on the concatenated [gate; up] fold."""
    jg, pg = both_w4(91, F, E, flavor)
    ju, pu = both_w4(92, F, E, flavor)
    jd, pd = both_w4(93, E, F, flavor)
    x = (np.random.default_rng(94).standard_normal((3, E)) * 0.7).astype(np.float32)
    ref = jax_ffn_mod.qmm_w4_ffn_matmul(jnp.asarray(x), jg, jd, act="silu", up=ju,
                                        interpret=True)
    assert ref is not None
    assert qmm_w4_ffn.ffn_eligible(pg, pd, "silu", pu)
    got = qmm_w4_ffn.qmm_w4_ffn_matmul(torch.from_numpy(x), pg, pd, up=pu)
    assert got.shape == (3, E)
    assert _rel_err(got, ref) < 5e-3
    fused = qmm_w4_ffn.qmm_w4_ffn_matmul(torch.from_numpy(x), concat_qtensors([pg, pu]), pd)
    assert torch.equal(got, fused)


@pytest.fixture(scope="module")
def unfused_models():
    """tests/test_torch_model.py's model (E = F = 2048, 2 layers, compact
    W4A8 folds) with gate and up (and q, k, v) kept apart."""
    jcfg = JaxConfig(**CFG)
    jp = jax_params(jcfg, JaxType.Q4_K, fast_w4a8=True, fuse=False)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, ModelConfig(**CFG), pp


def test_unfused_model_matches_jax(unfused_models, monkeypatch):
    """A 12-token prefill and 8 greedy steps through both default contexts
    (which stack the uniform layers), the port fed JAX's tokens.  Kernel 2 takes every layer's FFN on its up=
    branch at the prefill (12 tokens in a 16-row bucket, under its 32) and
    at every decode step (one row: the port's contexts do not pad a
    one-token step), on the port once a
    layer and step, as on JAX (whose jitted forward calls the megakernel
    while it traces, so its count only shows that it took that branch);
    the port's logits stay within 1e-2 of max|logits| and its greedy
    tokens equal JAX's (tests/test_torch_model.py's bounds)."""
    jcfg, jp, cfg, pp = unfused_models
    assert "ffn_gate" in pp["layers"][0] and "ffn_gateup_fused" not in pp["layers"][0]
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    jcalls, pcalls = [], []
    jorig, porig = jax_ffn_mod.qmm_w4_ffn_matmul, qmm_w4_ffn.qmm_w4_ffn_plain

    def jcount(*a, **kw):
        y = jorig(*a, **kw)
        if y is not None:
            jcalls.append(kw.get("up") is not None)
        return y

    def pcount(x, gu, dn, act, up=None):
        pcalls.append((x.shape[0], up is not None))
        return porig(x, gu, dn, act, up)

    monkeypatch.setattr(jax_ffn_mod, "qmm_w4_ffn_matmul", jcount)
    monkeypatch.setattr(qmm_w4_ffn, "qmm_w4_ffn_plain", pcount)
    prompt = np.random.default_rng(7).integers(0, CFG["vocab_size"], N_PROMPT).astype(np.int32)
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS)
    pctx = LlamaContext(cfg, pp, device="cpu", n_cells=N_CELLS)
    assert "layers_stacked" in pctx.params and "layers_stacked" in jctx.params
    jt, jl = _steps(jctx, JaxBatch, prompt)
    pl = _forced_steps(pctx, prompt, jt)
    L = cfg.n_layer
    assert pcalls == [(16, True)] * L + [(1, True)] * (L * (len(jt) - 1))
    assert jcalls and all(jcalls)
    assert [int(np.argmax(a)) for a in pl] == jt
    for a, b in zip(pl, jl):
        assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max()
