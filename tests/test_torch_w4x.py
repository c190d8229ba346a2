"""Port parity for the W4X high-fidelity mode: the precise W4 and W8 folds,
the dual-plane activation quantizer, kernel 7 (the W4X decode matmul) and
kernel 5's dual-plane branch, the routing that keeps precise folds off
kernels 1 and 2, and the whole W4X serving path (a synthetic model and a
Q4_K_M-profile GGUF loaded in the w4x mode) against the JAX package.

The JAX side runs its Pallas kernels in interpret mode; the port side runs
the plain PyTorch versions of its CUDA kernels (CPU tensors take them)."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.models.config import ModelConfig as JaxConfig
from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.models.synthetic import synthetic_params_device as jax_params
from llama_kotlin_tpu.models.synthetic import synthetic_w4 as jax_synthetic_w4
from llama_kotlin_tpu.ops.pallas.qmm_w4 import qmm_w4_matmul as jax_qmm_w4
from llama_kotlin_tpu.ops.pallas.qmm_w4 import quantize_activations_2p
from llama_kotlin_tpu.ops.pallas.qmm_w8 import qmm_w8_matmul as jax_qmm_w8
from llama_kotlin_tpu.quant import fold as jax_fold, repack as jax_repack
from llama_kotlin_tpu.quant.formats import GGMLQuantType as JaxType
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.convert import params_from_numpy, qtensor_from_numpy
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.models.llama import stack_layers
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import (synthetic_gguf, synthetic_params_device,
                                                     synthetic_w4, wire_blocks)
from llama_kotlin_tpu_torch.ops import qmatmul as port_qmatmul
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import qmm_w4_matmul, qmm_w4_plain, quantize_q8_2p
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4x import qmm_w4x_matmul, qmm_w4x_plain
from llama_kotlin_tpu_torch.ops.cuda.qmm_w8 import qmm_w8_matmul
from llama_kotlin_tpu_torch.quant import fold, repack
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q
from llama_kotlin_tpu_torch.quant.qtensor import QTensor, concat_qtensors, dequantize
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from test_torch_loader import CFG as GGUF_CFG, _forced_steps, _same_tree
from test_torch_model import CFG, N_CELLS, N_PROMPT, N_STEPS

PREDICATES = (fold.is_w4, fold.is_w4x, fold.is_w8, fold.is_w8x, fold.is_q8f)


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _x(b: int, k: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((b, k)) * 0.7).astype(np.float32)


# -- folds ---------------------------------------------------------------------

def _port_source(rp) -> QTensor:
    """A JAX repack (4-bit codes, float group scales, no superblock planes:
    Q4_0) as the port's repacked QTensor; the JAX side quantizes float
    weights to Q4_0 here, which the port has no quantizer for."""
    assert rp.sb_scale is None and rp.g_min is None
    return QTensor(codes=torch.from_numpy(np.array(rp.codes)),
                   g_scale=torch.from_numpy(np.asarray(rp.g_scale, np.float32).copy()),
                   g_min=None, sb_scale=None, sb_min=None, qtype=Q(int(rp.qtype)),
                   bits=rp.bits, group_size=rp.group_size, code_offset=rp.code_offset,
                   shape=tuple(rp.shape))


def both_precise(source: str, n: int = 48, k: int = 2048, seed: int = 0):
    """(JAX precise fold, port precise fold, the port's repacked source) of
    the same source."""
    if source == "q4_0-sym":
        wf = (np.random.default_rng(seed).standard_normal((n, k)) * 0.05).astype(np.float32)
        jrp = jax_repack.repack_float(wf, JaxType.Q4_0)
        prp = _port_source(jrp)
    else:
        qtype = {"q4_K": Q.Q4_K, "q6_K": Q.Q6_K, "q8_0": Q.Q8_0}[source]
        data = wire_blocks(np.random.default_rng(seed), qtype, n, k)
        jrp = jax_repack.repack(data, JaxType(int(qtype)), n, k)
        prp = repack.repack(torch.from_numpy(data), qtype, n, k)
    if prp.bits == 4:
        return (jax_fold.fold_to_w4(jrp, precise=True), fold.fold_to_w4(prp, precise=True),
                prp)
    return jax_fold.fold_to_w8(jrp, precise=True), fold.fold_to_w8(prp, precise=True), prp


@pytest.mark.parametrize("source,k,flavor", [
    ("q4_K", 2048, "w4x"), ("q4_K", 768, "w4x"), ("q4_0-sym", 2048, "w4x_sym"),
    ("q6_K", 2048, "w8x"), ("q8_0", 800, "w8x")])
def test_precise_folds_equal_jax(source, k, flavor):
    """fold_to_w4/fold_to_w8(precise=True) equal the JAX folds bit for bit:
    codes and the f32 g_scale/g_min (never bf16-rounded: a Q4_K s_eff keeps
    its full d*sc6 product), directly and through params_from_numpy, which
    must give the same planes and the same flavor; and they dequantize to
    the source's values exactly."""
    jw, pw, src = both_precise(source, k=k)
    jw = jax.tree.map(np.asarray, jw)
    assert "precise" in jw.aux and pw.flavor == flavor
    assert sum(p(pw) for p in PREDICATES) == 1 and (fold.is_w4x(pw) or fold.is_w8x(pw))
    np.testing.assert_array_equal(pw.codes.numpy(), jw.codes)
    for name in ("g_scale", "g_min"):
        ref = getattr(jw, name)
        if ref is None:
            assert getattr(pw, name) is None
            continue
        assert ref.dtype == np.float32
        np.testing.assert_array_equal(getattr(pw, name).numpy(), ref)
    conv = qtensor_from_numpy(jw, "cpu")
    assert conv.flavor == flavor and conv.tensors().keys() == pw.tensors().keys()
    for name, t in pw.tensors().items():
        assert torch.equal(conv.tensors()[name], t), name
    np.testing.assert_array_equal(dequantize(pw).numpy(), dequantize(src).numpy())


@pytest.mark.parametrize("sym", [False, True])
def test_synthetic_w4x_same_draws(sym):
    """The port's numpy generator draws the JAX package's W4X weights."""
    jw = jax_synthetic_w4(np.random.default_rng(6), 128, 2048, precise=True, sym=sym)
    pw = synthetic_w4(np.random.default_rng(6), 128, 2048, sym=sym, precise=True, device="cpu")
    conv = qtensor_from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    assert pw.flavor == conv.flavor == ("w4x_sym" if sym else "w4x")
    for name, t in conv.tensors().items():
        assert torch.equal(pw.tensors()[name], t), name


def test_device_w4x_is_the_precise_fold_of_its_compact_draws():
    """synthetic_w4_device(precise=True) holds the same weights as the
    compact fold of the same draws, with f32 s_eff = d * sc6 and m_adj, as
    fold_to_w4(precise=True) gives for a Q4_K source."""
    from llama_kotlin_tpu_torch.models.synthetic import synthetic_w4_device

    draws = {}
    for precise in (False, True):
        gen = torch.Generator()
        gen.manual_seed(3)
        draws[precise] = synthetic_w4_device(gen, 64, 2048, zero_mean=False, precise=precise,
                                             device="cpu")
    c, x = draws[False], draws[True]
    assert (c.flavor, x.flavor) == ("compact", "w4x")
    assert torch.equal(c.codes, x.codes)
    assert torch.equal(c.g_scale, x.g_scale) and torch.equal(c.g_min, x.g_min)
    assert torch.equal(dequantize(c), dequantize(x))


# -- the dual-plane activations ---------------------------------------------------

def test_dual_plane_codes_equal_jax():
    """quantize_q8_2p equals JAX's quantize_activations_2p bit for bit:
    int8 codes and f32 scales of both planes.  The residual is a separate
    multiply and subtract on both sides (JAX's CPU run does not contract
    them into an FMA: with one, most plane-2 codes of random rows differ).
    Rows: random; all zero (both planes take the safe divisor); .5 ties
    (amax 127, so s1 = 1 and x/s1 lands on k + .5); integers (the residual
    is exactly zero, plane 2 a zero superblock)."""
    rng = np.random.default_rng(21)
    x = _x(8, 1024, 22)
    x[1] = 0.0
    x[2] = rng.integers(-254, 255, 1024) / 2.0
    x[2, ::256] = 127.0
    x[3] = rng.integers(-127, 128, 1024)
    x[3, ::256] = 127.0
    x[4, :256] = 1e-30  # tiny values: plane 2 scales near the bottom of the normal range
    j8, jsx = (np.asarray(a) for a in quantize_activations_2p(jnp.asarray(x)))
    p8, psx, psum = quantize_q8_2p(torch.from_numpy(x))
    np.testing.assert_array_equal(p8.numpy(), j8)
    np.testing.assert_array_equal(psx.numpy().view(np.int32), jsx.view(np.int32))
    np.testing.assert_array_equal(psum.numpy(), j8.reshape(16, -1, 32).astype(np.int32).sum(-1))
    assert not p8[8 + 3].any() and (psx[8 + 3] == 0).all()  # zero residual
    assert p8[8 + 2].abs().max() == 127  # the ties' residual is +-s1/2


# -- kernel 7 and kernel 5's dual-plane branch ----------------------------------

@pytest.mark.parametrize("k", [2048, 4096])
@pytest.mark.parametrize("b", [1, 3, 8, 32])
@pytest.mark.parametrize("sym", [False, True], ids=["legacy", "sym"])
def test_qmm_w4x_matches_jax(sym, b, k):
    """Kernel 7's function vs the JAX W4X dispatch (qmm_w4_matmul on a
    precise fold: quantize_activations_2p, qmm_w4 in interpret mode, the
    halves summed).  Both take exact integer group partials on identical
    int8 codes of both planes; they differ in the f32 order of the scale
    products, the group and plane sums and the min term (the Pallas kernel
    scales the hi plane as 16(q-8) against s/16).  Bound: 1e-5 of max|y|,
    f32 reduction-order noise over k."""
    n = 512
    qtype = JaxType.Q4_0 if sym else JaxType.Q4_K
    wf = (np.random.default_rng(30 + k).standard_normal((n, k)) * 0.05).astype(np.float32)
    jw = jax_fold.fold_to_w4(jax_repack.repack_float(wf, qtype), precise=True)
    pw = qtensor_from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    assert pw.flavor == ("w4x_sym" if sym else "w4x")
    x = _x(b, k, 40 + b)
    ref = np.asarray(jax_qmm_w4(jnp.asarray(x), jax.tree.map(jnp.asarray, jw), interpret=True))
    got = qmm_w4x_matmul(torch.from_numpy(x), pw).numpy()
    assert got.shape == (b, n)
    assert _rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("b", [1, 5, 32])
@pytest.mark.parametrize("source", ["q6_K", "q4_K-mins"])
def test_qmm_w8x_matches_jax(source, b):
    """Kernel 5's dual-plane branch vs the JAX W8 dispatch on a precise fold
    (both planes through qmm_w8 in interpret mode, the min term per plane,
    the halves summed): q6_K (group 16, no mins) and Q4_K folded to W8X
    (group 32 with mins, the min term outside the kernel).  Bound: 1e-5 of
    max|y|, the f32 order of the group and plane sums."""
    qtype = Q.Q6_K if source == "q6_K" else Q.Q4_K
    n, k = 256, 2048
    data = wire_blocks(np.random.default_rng(50), qtype, n, k)
    jw = jax_fold.fold_to_w8(jax_repack.repack(data, JaxType(int(qtype)), n, k), precise=True)
    pw = fold.fold_to_w8(repack.repack(torch.from_numpy(data), qtype, n, k), precise=True)
    assert fold.is_w8x(pw) and (pw.g_min is not None) == (source == "q4_K-mins")
    x = _x(b, k, 60 + b)
    ref = np.asarray(jax_qmm_w8(jnp.asarray(x), jax.tree.map(jnp.asarray, jw), interpret=True))
    got = qmm_w8_matmul(torch.from_numpy(x), pw).numpy()
    assert got.shape == (b, n)
    assert _rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("b", [1, 8])
def test_w4x_fidelity(b):
    """Same weights, same x: kernel 7's plain version is at least 20 times
    closer to x @ dequantize(W)^T (float64) than kernel 1's plain version is
    on the compact W4 fold of the same Q4_K source (both folds dequantize to
    the same exact values: the difference is the activations' 8 against
    ~15.8 bits).  A precise fold served with single-plane activations fails
    this."""
    n, k = 512, 4096
    data = torch.from_numpy(wire_blocks(np.random.default_rng(70), Q.Q4_K, n, k))
    rp = repack.repack(data, Q.Q4_K, n, k)
    w4, w4x = fold.fold_to_w4(rp), fold.fold_to_w4(rp, precise=True)
    assert (w4.flavor, w4x.flavor) == ("compact", "w4x")
    wd = dequantize(w4x).double()
    assert torch.equal(dequantize(w4).double(), wd)
    x = torch.from_numpy(_x(b, k, 71))
    ref = x.double() @ wd.T
    err1 = (qmm_w4_plain(x, w4).double() - ref).abs().max().item()
    err7 = (qmm_w4x_plain(x, w4x).double() - ref).abs().max().item()
    assert err7 * 20 <= err1, (err7, err1)
    # the single-plane path on the precise weights is as coarse as kernel 1
    assert (qmm_w4_plain(x, w4x).double() - ref).abs().max().item() > 20 * err7


def test_precise_folds_never_reach_kernels_1_and_2(monkeypatch):
    """qmatmul sends a W4X fold to kernel 7 (decode rows) or kernel 4
    (prefill rows) and a W8X fold to kernel 5's dual-plane branch;
    qmm_ffn declines precise folds; kernel 1's and kernel 2's wrappers
    refuse them outright."""
    def forbidden(*_a, **_k):
        raise AssertionError("a precise fold reached kernel 1 or 2")

    monkeypatch.setattr(port_qmatmul, "qmm_w4_matmul", forbidden)
    monkeypatch.setattr(port_qmatmul, "qmm_w4_ffn_matmul", forbidden)
    rng = np.random.default_rng(80)
    E, F = 1024, 1024
    gu = synthetic_w4(rng, 2 * F, E, precise=True, device="cpu")
    dn = synthetic_w4(rng, E, F, precise=True, device="cpu")
    x = torch.from_numpy(_x(2, E, 81))
    assert torch.equal(port_qmatmul.qmatmul(x, gu), qmm_w4x_plain(x, gu))
    xp = torch.from_numpy(_x(40, E, 82))  # prefill rows: kernel 4
    from llama_kotlin_tpu_torch.ops.cuda.qmm import qmm_plain

    assert torch.equal(port_qmatmul.qmatmul(xp, gu), qmm_plain(xp, gu))
    assert port_qmatmul.qmm_ffn(x, gu, dn) is None
    with pytest.raises(ValueError):
        qmm_w4_matmul(x, gu)
    from llama_kotlin_tpu_torch.ops.cuda.qmm_w4_ffn import ffn_eligible, qmm_w4_ffn_matmul

    assert not ffn_eligible(gu, dn, "silu")
    with pytest.raises(ValueError):
        qmm_w4_ffn_matmul(x, gu, dn)
    data = torch.from_numpy(wire_blocks(rng, Q.Q6_K, 256, E))
    w8x = fold.fold_to_w8(repack.repack(data, Q.Q6_K, 256, E), precise=True)
    w8 = fold.fold_to_w8(repack.repack(data, Q.Q6_K, 256, E))
    assert torch.equal(port_qmatmul.qmatmul(x, w8x), qmm_w8_matmul(x, w8x))
    assert not torch.equal(qmm_w8_matmul(x, w8x), qmm_w8_matmul(x, w8))


def test_precise_marker_survives_fusion_and_stacking():
    """concat_qtensors fuses precise folds into a precise fold and refuses to
    fuse a precise with a plain one; stack_layers keeps the flavor on the
    stack and on every layer view, and refuses layers that mix them."""
    rng = np.random.default_rng(90)
    a, b = (synthetic_w4(rng, 256, 1024, precise=True, device="cpu") for _ in range(2))
    plain = synthetic_w4(rng, 256, 1024, compact=False, device="cpu")
    assert concat_qtensors([a, b]).flavor == "w4x"
    assert fold.is_w4x(concat_qtensors([a, b]))
    with pytest.raises(ValueError):
        concat_qtensors([a, plain])
    st = stack_layers({"layers": [{"w": a}, {"w": b}]})
    assert st["layers_stacked"]["w"].flavor == "w4x"
    assert all(fold.is_w4x(v["w"]) for v in st["layer_views"])
    with pytest.raises(ValueError):
        stack_layers({"layers": [{"w": a}, {"w": plain}]})


def test_synthetic_w4x_params():
    """synthetic_params_device(mode="w4x") gives every matrix as a W4X fold
    with the weights of mode "w4" drawn from the same seed."""
    from llama_kotlin_tpu_torch.models.synthetic import preset_config

    cfg = preset_config("test-tiny", n_layer=1)
    p4 = synthetic_params_device(cfg, seed=4, device="cpu")
    px = synthetic_params_device(cfg, seed=4, device="cpu", mode="w4x")
    for key in ("tok_embd", "output"):
        assert fold.is_w4x(px[key]) and torch.equal(dequantize(px[key]), dequantize(p4[key]))
    for key, w in px["layers"][0].items():
        if isinstance(w, QTensor):
            assert fold.is_w4x(w), key
    with pytest.raises(ValueError):
        synthetic_params_device(cfg, device="cpu", mode="w8")


# -- the whole path -----------------------------------------------------------------

# logits within this share of max|logits|.  The bf16 residual stream, the
# bf16 FFN intermediate and the re-quantization of every matmul input carry
# f32 last-bit differences on, as on test_torch_model.py's W4A8 path, but a
# flipped code of plane 1 is mostly caught by plane 2, so W4X paths differ
# far less: 8e-4 to 1.1e-3 on the synthetic model, 4e-3 to 8.5e-3 on the
# Q4_K_M file (whose W8X layers and zero-mean weights carry more); the
# tolerances are about five and two and a half times those
LOGIT_TOL = {"synthetic": 5e-3, "gguf": 2e-2}


@pytest.fixture(scope="module")
def w4x_models():
    jcfg = JaxConfig(**CFG)
    jp = jax_params(jcfg, JaxType.Q4_K, fast_w4a8="w4x", fuse=True)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, ModelConfig(**CFG), pp


def _compare(jctx, pctx, prompt, tol):
    """Prefill + N_STEPS - 1 steps on both contexts, the JAX one greedy and
    the port's taking its tokens; logits within tol of max|logits| at every
    step and the greedy token equal wherever the top-2 gap exceeds twice
    that.  Returns (JAX tokens, steps decided by the gap)."""
    assert jctx.decode(JaxBatch.single(prompt)) == 0
    jl = [np.asarray(jctx.get_logits()[-1], np.float32)]
    toks = [int(np.argmax(jl[-1]))]
    for i in range(N_STEPS - 1):
        assert jctx.decode(JaxBatch.single([toks[-1]], pos0=N_PROMPT + i)) == 0
        jl.append(np.asarray(jctx.get_logits()[-1], np.float32))
        toks.append(int(np.argmax(jl[-1])))
    pl = _forced_steps(pctx, prompt, toks)
    decided = 0
    for tok, a, b in zip(toks, pl, jl):
        top = np.abs(b).max()
        assert np.abs(a - b).max() <= tol * top
        s = np.sort(b)
        if s[-1] - s[-2] > 2 * tol * top:
            assert int(np.argmax(a)) == tok
            decided += 1
    return toks, decided


@pytest.mark.parametrize("prefer_unrolled", [False, True], ids=["stacked", "unrolled"])
def test_w4x_path_matches_jax(w4x_models, prefer_unrolled, monkeypatch):
    """A synthetic W4X model (E=2048, 2 layers, fused projections, every
    matrix a precise legacy fold): a 12-token prefill and 8 greedy steps
    through the JAX LlamaContext and the port's, stacked (the default) and
    unrolled, the port fed the JAX tokens.  Both take the same path (the
    uniform W4X layers stack on both sides)."""
    jcfg, jp, cfg, pp = w4x_models
    assert all(fold.is_w4x(w) for w in pp["layers"][0].values() if isinstance(w, QTensor))
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    prompt = np.random.default_rng(7).integers(0, CFG["vocab_size"], N_PROMPT).astype(np.int32)
    kw = dict(n_cells=N_CELLS, prefer_unrolled=prefer_unrolled)
    jctx, pctx = JaxContext(jcfg, jp, **kw), LlamaContext(cfg, pp, device="cpu", **kw)
    assert ("layers_stacked" in pctx.params) == ("layers_stacked" in jctx.params) \
        == (not prefer_unrolled)
    _, decided = _compare(jctx, pctx, prompt, LOGIT_TOL["synthetic"])
    assert decided >= 2  # its random row means give one token, by clear gaps


@pytest.fixture(scope="module")
def gguf_w4x(tmp_path_factory):
    path = tmp_path_factory.mktemp("gguf") / "tiny-q4km.gguf"
    synthetic_gguf(path, GGUF_CFG, seed=11)  # tests/test_torch_loader.py's file
    jcfg, jp, jf = jax_load(path, fast_mode="w4x", fuse=True)
    cfg, pp, f = load_gguf_model(path, fast_mode="w4x", fuse=True, device="cpu")
    jf.close()
    f.close()
    return jcfg, jp, cfg, pp


def test_gguf_w4x_folds_equal_jax(gguf_w4x):
    """Both loaders give the same w4x-mode params: Q4_K tensors as W4X folds,
    Q6_K ones (output, layer 1's attn_v and ffn_down) as W8X folds, every
    plane equal to params_from_numpy(JAX params); layer 1's W4X wq/wk and
    W8X wv stay split."""
    jcfg, jp, cfg, pp = gguf_w4x
    assert (pp["tok_embd"].flavor, pp["output"].flavor) == ("w4x", "w8x")
    assert {"wq", "wk", "wv"} <= set(pp["layers"][1]) and "wqkv_fused" in pp["layers"][0]
    assert pp["layers"][1]["ffn_down"].flavor == "w8x"
    _same_tree(pp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))


def test_gguf_w4x_serving_matches_jax(gguf_w4x, monkeypatch):
    """The w4x-mode file on both default contexts (its mixed layers stay
    unrolled on both, as in the w4 mode): the JAX context decodes greedily
    and the port's takes its tokens; logits within LOGIT_TOL["gguf"] of
    max|logits| and the greedy token equal at every step the top-2 gap
    decides."""
    jcfg, jp, cfg, pp = gguf_w4x
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    prompt = np.random.default_rng(17).integers(0, GGUF_CFG.vocab_size, N_PROMPT).astype(np.int32)
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS)
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu")
    assert "layers" in pctx.params and "layers" in jctx.params
    toks, decided = _compare(jctx, pctx, prompt, LOGIT_TOL["gguf"])
    assert len(set(toks)) > 1 and decided >= 2
