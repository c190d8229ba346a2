"""Port parity for kernel 10 (the post-attention half of a layer in one
launch, reached under LKTPU_LAYER_FUSED=1): its plain version against the
JAX Pallas kernel on compact, sym and legacy folds, its eligibility
against the JAX entry's refusals, and the fused-layer hook of the forward
on stacked and unrolled contexts against the JAX contexts.

The JAX side runs its Pallas kernels in interpret mode; the port side runs
the plain PyTorch versions of its CUDA kernels (CPU tensors take them)."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import llama_kotlin_tpu.ops.pallas.qmm_w4 as jax_w4_mod
import llama_kotlin_tpu.ops.pallas.qmm_w4_ffn as jax_ffn_mod
from llama_kotlin_tpu.models.config import ModelConfig as JaxConfig
from llama_kotlin_tpu.models.synthetic import synthetic_params_device as jax_params
from llama_kotlin_tpu.ops.norms import rms_norm as jax_rms_norm
from llama_kotlin_tpu.quant.fold import fold_to_w4
from llama_kotlin_tpu.quant.formats import GGMLQuantType as JaxType
from llama_kotlin_tpu.quant.repack import repack_float
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.convert import params_from_numpy, qtensor_from_numpy
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.ops import qmatmul as port_qmatmul
from llama_kotlin_tpu_torch.ops.cuda import qmm_w4_layer
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4_layer import layer_eligible, qmm_w4_layer_matmul
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from test_torch_loader import _forced_steps
from test_torch_model import CFG, N_CELLS, N_PROMPT, _steps

E = F = 2048
# (qtype, compact) per fold family, as tests/test_layer_fused.py draws them
FAMILIES = {"compact": (JaxType.Q4_K, None), "sym": (JaxType.Q4_0, None),
            "legacy": (JaxType.Q4_K, False)}


def _w4(rng, n, k, family, precise=False):
    qtype, compact = FAMILIES[family]
    wf = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    kw = dict(precise=True) if precise else dict(compact=compact)
    return jax.tree.map(np.asarray, fold_to_w4(repack_float(wf, qtype), **kw))


def _layer(family, seed=19, b=2, precise=False):
    """(JAX operands, port operands) of one layer half: attn, h [b, E] bf16,
    Wo, the fused gate|up and down folds of `family`, norm weights."""
    rng = np.random.default_rng(seed)
    ws = [_w4(rng, n, k, family, precise) for n, k in ((E, E), (2 * F, E), (E, F))]
    nw = (1.0 + 0.1 * rng.standard_normal(E)).astype(np.float32)
    attn = (rng.standard_normal((b, E)) * 0.5).astype(np.float32)
    h = (rng.standard_normal((b, E)) * 0.5).astype(np.float32)
    jops = ([jnp.asarray(attn, jnp.bfloat16), jnp.asarray(h, jnp.bfloat16)]
            + [jax.tree.map(jnp.asarray, w) for w in ws] + [jnp.asarray(nw)])
    pops = ([torch.from_numpy(attn).to(torch.bfloat16), torch.from_numpy(h).to(torch.bfloat16)]
            + [qtensor_from_numpy(w, "cpu") for w in ws] + [torch.from_numpy(nw)])
    return jops, pops


@pytest.mark.parametrize("family", list(FAMILIES))
def test_layer_plain_matches_jax(family):
    """Kernel 10's plain version against the JAX layer kernel
    (qmm_w4_layer_matmul in interpret mode) on compact, sym and legacy
    folds, E = F = 2048, b = 2: h3 in bf16 within 2e-2 of max|h3|, the
    bound of the JAX package's own fused-against-composed test
    (tests/test_layer_fused.py::_assert_bf16_close; one bf16 ulp of h2
    moves the FFN's activation codes).  Measured: 1.75e-2 (compact),
    1.62e-2 (sym), 1.50e-2 (legacy): the JAX kernel's own distance from
    JAX's composed route (o, residual, rms_norm, FFN as separate calls),
    which the port's plain version follows: against that route it is
    within 2e-3 (measured 0, 0 and 5.3e-4: the legacy fold's scale order)."""
    jops, pops = _layer(family)
    ref = jax_ffn_mod.qmm_w4_layer_matmul(*jops, eps=1e-5, act="silu", interpret=True)
    assert ref is not None
    assert layer_eligible(*pops[:5])
    got = qmm_w4_layer_matmul(*pops, eps=1e-5, act="silu")
    assert got.shape == (2, E) and got.dtype == torch.bfloat16
    got = got.float().numpy()
    r32 = np.asarray(ref, np.float32)
    assert np.abs(got - r32).max() / np.abs(r32).max() < 2e-2
    attn, h, o, gu, dn, nw = jops
    h2 = h + jax_w4_mod.qmm_w4_matmul(attn.astype(jnp.float32), o, interpret=True).astype(h.dtype)
    ffn = jax_ffn_mod.qmm_w4_ffn_matmul(jax_rms_norm(h2, nw, 1e-5), gu, dn, act="silu",
                                        interpret=True)
    comp = np.asarray(h2 + ffn.astype(h.dtype), np.float32)
    assert np.abs(got - comp).max() / np.abs(comp).max() < 2e-3


def _refused_by_jax(jops, **kw) -> bool:
    return jax_ffn_mod.qmm_w4_layer_matmul(*jops, eps=1e-5, interpret=True, **kw) is None


def test_layer_eligibility_matches_jax(monkeypatch):
    """layer_eligible refuses what the JAX entry refuses (it returns None
    before any kernel runs): precise (W4X) folds, a compact o with
    non-compact gate|up and down, an o whose sym flavor differs from
    gate|up's, more than 8 rows, gate|up that is not the fused [gate; up]
    of down's width, an activation other than silu and gelu, and
    LKTPU_W4_BCAST=1; and takes the eligible layer (which JAX runs in
    test_layer_plain_matches_jax)."""
    jops, pops = _layer("legacy")
    assert layer_eligible(*pops[:5]) and layer_eligible(*pops[:5], act="gelu")
    cases = {}
    jx, px = _layer("legacy", precise=True)
    cases["precise"] = (jx, px)
    jc, pc = _layer("compact")
    cases["mixed compact"] = (jops[:2] + [jc[2]] + jops[3:], pops[:2] + [pc[2]] + pops[3:])
    js, ps = _layer("sym")
    cases["o sym, gate|up not"] = (jops[:2] + [js[2]] + jops[3:], pops[:2] + [ps[2]] + pops[3:])
    jb, pb = _layer("legacy", b=9)
    cases["9 rows"] = (jb[:2] + jops[2:], pb[:2] + pops[2:])
    rng = np.random.default_rng(7)
    gate = _w4(rng, F, E, "legacy")  # gate alone: not [gate; up]
    cases["unfused gate|up"] = (jops[:3] + [jax.tree.map(jnp.asarray, gate)] + jops[4:],
                                pops[:3] + [qtensor_from_numpy(gate, "cpu")] + pops[4:])
    for name, (j, p) in cases.items():
        assert _refused_by_jax(j), name
        assert not layer_eligible(*p[:5]), name
        with pytest.raises(ValueError):
            qmm_w4_layer_matmul(*p, eps=1e-5)
    assert _refused_by_jax(jops, act="relu") and not layer_eligible(*pops[:5], act="relu")
    monkeypatch.setenv("LKTPU_W4_BCAST", "1")
    assert _refused_by_jax(jops) and not layer_eligible(*pops[:5])


# -- the forward's hook ------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """tests/test_layer_fused.py's model: E = F = 2048, 2 layers, compact
    W4A8 folds, fused projections."""
    jcfg = JaxConfig(**CFG)
    jp = jax_params(jcfg, JaxType.Q4_K, fast_w4a8=True, fuse=True)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, ModelConfig(**CFG), pp


@pytest.mark.parametrize("prefer_unrolled", [False, True], ids=["stacked", "unrolled"])
def test_layer_fused_path_matches_jax(models, prefer_unrolled, monkeypatch):
    """LKTPU_LAYER_FUSED=1 on both sides, stacked (the default) and
    unrolled: a 12-token prefill and 8 greedy steps through the JAX and the
    port's LlamaContext, the port fed the JAX tokens.  Both dispatch the
    fused layer at every decode step of every layer and never at the
    12-row prefill (more than 8 rows) — JAX's stacked scan slices its
    weights per layer, so it reaches the kernel too — and the port's
    logits stay within 1e-2 of max|logits| (the port-vs-JAX model bound,
    tests/test_torch_model.py::test_serving_path_matches_jax) and its
    greedy tokens equal JAX's, as there."""
    jcfg, jp, cfg, pp = models
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("LKTPU_LAYER_FUSED", "1")
    jcalls, pcalls = [], []
    jorig, porig = jax_ffn_mod.qmm_w4_layer_matmul, qmm_w4_layer.qmm_w4_layer_plain

    def jcount(*a, **kw):
        y = jorig(*a, **kw)
        if y is not None:
            jcalls.append(1)
        return y

    monkeypatch.setattr(jax_ffn_mod, "qmm_w4_layer_matmul", jcount)
    monkeypatch.setattr(qmm_w4_layer, "qmm_w4_layer_plain",
                        lambda *a: pcalls.append(1) or porig(*a))
    prompt = np.random.default_rng(7).integers(0, CFG["vocab_size"], N_PROMPT).astype(np.int32)
    kw = dict(n_cells=N_CELLS, prefer_unrolled=prefer_unrolled)
    jctx, pctx = JaxContext(jcfg, jp, **kw), LlamaContext(cfg, pp, device="cpu", **kw)
    assert ("layers_stacked" in pctx.params) == ("layers_stacked" in jctx.params) \
        == (not prefer_unrolled)
    jt, jl = _steps(jctx, JaxBatch, prompt)
    n_jax = len(jcalls)
    pl = _forced_steps(pctx, prompt, jt)
    # the port dispatches once a layer and decode step; JAX's jitted forward
    # calls the hook while it traces (once per shape, and its stacked scan
    # body once), so its count only shows that it dispatched
    assert len(pcalls) == cfg.n_layer * (len(jt) - 1)
    assert n_jax >= 1
    assert [int(np.argmax(a)) for a in pl] == jt
    for a, b in zip(pl, jl):
        assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max()


def test_layer_fused_off_by_default(models, monkeypatch):
    """Without LKTPU_LAYER_FUSED (or with any value but "1") qmm_layer
    declines, as JAX's does, and the forward takes the unfused route;
    with it, the hook's result on the CPU equals the unfused route's bit
    for bit (the plain version composes the same plain o, norm and FFN)."""
    _, _, cfg, pp = models
    lp = pp["layers"][0]
    rng = np.random.default_rng(3)
    attn = torch.from_numpy(rng.standard_normal((1, E)).astype(np.float32)).to(torch.bfloat16)
    h = torch.from_numpy(rng.standard_normal((1, E)).astype(np.float32)).to(torch.bfloat16)
    args = (attn, h, lp["wo"], lp["ffn_gateup_fused"], lp["ffn_down"], lp["ffn_norm"])
    for value in (None, "0", "true"):
        if value is None:
            monkeypatch.delenv("LKTPU_LAYER_FUSED", raising=False)
        else:
            monkeypatch.setenv("LKTPU_LAYER_FUSED", value)
        assert port_qmatmul.qmm_layer(*args, eps=cfg.rms_eps) is None
    monkeypatch.setenv("LKTPU_LAYER_FUSED", "1")
    got = port_qmatmul.qmm_layer(*args, eps=cfg.rms_eps)
    from llama_kotlin_tpu_torch.models.llama import _ffn
    from llama_kotlin_tpu_torch.ops.norms import rms_norm

    h2 = h + port_qmatmul.qmatmul(attn, lp["wo"]).to(h.dtype)
    ref = h2 + _ffn(lp, rms_norm(h2, lp["ffn_norm"], cfg.rms_eps), cfg).to(h.dtype)
    assert torch.equal(got, ref)
