"""Port parity for kernel 8 (the W4A8 decode matmul with the activation
quantization inside the launch, reached under LKTPU_W4_FX=1), the
LKTPU_W4_FX routing of W4 decode rows, and the Q4_0 and Q4_1 files that
reach kernel 8's sym and legacy folds: the repacks bit-equal to JAX's and
2-layer fixture files, written by the port's writer, loaded by both loaders
in the w4, w4x and int8 modes.

The JAX side runs its Pallas kernels in interpret mode; the port side runs
the plain PyTorch versions of its CUDA kernels (CPU tensors take them)."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import llama_kotlin_tpu.ops.pallas.qmm as jax_qmm_mod
import llama_kotlin_tpu.ops.pallas.qmm_w4 as jax_w4_mod
from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.ops.qmatmul import qmatmul as jax_qmatmul
from llama_kotlin_tpu.quant import numpy_ref
from llama_kotlin_tpu.quant.fold import fold_to_w4 as jax_fold_to_w4
from llama_kotlin_tpu.quant import repack as jax_repack
from llama_kotlin_tpu.quant.formats import GGMLQuantType as JaxType
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.convert import params_from_numpy, qtensor_from_numpy
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import synthetic_gguf, synthetic_w4, wire_blocks
from llama_kotlin_tpu_torch.ops import qmatmul as port_qmatmul
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import qmm_w4_plain
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4_fx import (fx_eligible, qmm_w4_fx_matmul,
                                                       qmm_w4_fx_plain)
from llama_kotlin_tpu_torch.quant import fold, repack
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q
from llama_kotlin_tpu_torch.quant.qtensor import dequantize
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from test_torch_loader import CFG as GGUF_CFG, _forced_steps, _same_tree
from test_torch_model import N_CELLS, N_PROMPT, _steps
from test_torch_qmm_w4 import both_w4

Q4_TYPES = {"q4_0": Q.Q4_0, "q4_1": Q.Q4_1}


def _x(b: int, k: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((b, k)) * 0.7).astype(np.float32)


# -- the Q4_0 and Q4_1 repacks ---------------------------------------------------

@pytest.mark.parametrize("name", list(Q4_TYPES))
def test_repack_q4_equals_jax(name):
    """repack_q4_0 / repack_q4_1 equal JAX's bit for bit (codes, f32
    scales, Q4_1's negated mins, the code offset 8 of Q4_0) on random wire
    blocks with a k that pads (k = 800), dequantize to numpy_ref's values,
    and fold (W4, W4X) to JAX's folds: sym for Q4_0, legacy for Q4_1."""
    qtype = Q4_TYPES[name]
    n, k = 48, 800
    data = wire_blocks(np.random.default_rng(3), qtype, n, k)
    jrp = jax_repack.repack(data, JaxType(int(qtype)), n, k)
    prp = repack.repack(torch.from_numpy(data), qtype, n, k)
    assert (prp.bits, prp.group_size, prp.code_offset) == (4, 32, jrp.code_offset)
    assert prp.code_offset == (8 if qtype == Q.Q4_0 else 0)
    np.testing.assert_array_equal(prp.codes.numpy(), np.asarray(jrp.codes))
    np.testing.assert_array_equal(prp.g_scale.numpy(), np.asarray(jrp.g_scale, np.float32))
    if jrp.g_min is None:
        assert prp.g_min is None
    else:
        np.testing.assert_array_equal(prp.g_min.numpy(), np.asarray(jrp.g_min, np.float32))
    ref = numpy_ref.dequantize(data, JaxType(int(qtype)), shape=(n, k))
    np.testing.assert_array_equal(dequantize(prp).numpy(), ref)
    flavor = "sym" if qtype == Q.Q4_0 else "legacy"
    for precise in (False, True):
        jw = jax.tree.map(np.asarray, jax_fold_to_w4(jrp, precise=precise))
        pw = fold.fold_to_w4(prp, precise=precise)
        assert pw.flavor == ({"sym": "w4x_sym", "legacy": "w4x"}[flavor] if precise else flavor)
        conv = qtensor_from_numpy(jw, "cpu")
        assert conv.flavor == pw.flavor
        for key, t in conv.tensors().items():
            assert torch.equal(pw.tensors()[key], t), key


# -- kernel 8 ------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 2, 5])
@pytest.mark.parametrize("flavor", ["sym", "legacy"])
def test_qmm_w4_fx_matches_jax(flavor, b, monkeypatch):
    """Kernel 8's plain version against the JAX LKTPU_W4_FX=1 dispatch
    (quantize inside qmm_w4_fx, in interpret mode; the min term from the
    sym fold's scw_lo or the legacy fold's madj_t) on a Q4_0 (sym) and a
    Q4_K compact=False (legacy) fold, n = 256, k = 2048.  Both take exact
    integer group partials on the same int8 codes; the f32 order of the
    scale products and sums differs.  Bound: rtol = atol = 1e-5, the JAX
    package's own bound between its fx and standard kernels
    (tests/test_w4.py::test_qmm_w4_fx_matches_standard).  The port's
    qmatmul under the same knob takes kernel 8 and gives the same y."""
    monkeypatch.setenv("LKTPU_W4_FX", "1")
    jw, pw = both_w4(11, 256, 2048, flavor)
    assert fx_eligible(pw)
    x = _x(b, 2048, 20 + b)
    ref = np.asarray(jax_w4_mod.qmm_w4_matmul(jnp.asarray(x), jw, interpret=True))
    got = qmm_w4_fx_matmul(torch.from_numpy(x), pw)
    assert got.shape == (b, 256)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(port_qmatmul.qmatmul(torch.from_numpy(x), pw), got)
    # the same function as kernel 1's plain version
    assert torch.equal(qmm_w4_fx_plain(torch.from_numpy(x), pw),
                       qmm_w4_plain(torch.from_numpy(x), pw))


def test_qmm_w4_fx_refuses():
    """Kernel 8's wrapper raises on what it does not take: a compact fold,
    a precise (W4X) fold and more than 32 rows."""
    rng = np.random.default_rng(5)
    compact = synthetic_w4(rng, 256, 2048, device="cpu")
    precise = synthetic_w4(rng, 256, 2048, precise=True, device="cpu")
    sym = synthetic_w4(rng, 256, 2048, sym=True, device="cpu")
    assert (compact.flavor, precise.flavor, sym.flavor) == ("compact", "w4x", "sym")
    x = torch.from_numpy(_x(2, 2048, 6))
    for w in (compact, precise):
        assert not fx_eligible(w)
        with pytest.raises(ValueError):
            qmm_w4_fx_matmul(x, w)
    assert fx_eligible(sym)
    with pytest.raises(ValueError):
        qmm_w4_fx_matmul(torch.from_numpy(_x(33, 2048, 7)), sym)


# -- the LKTPU_W4_FX routing, the port's against JAX's -------------------------

# the site JAX reaches -> the port kernel that serves it
JAX_SITE_KERNEL = {"qmm_w4_fx2": "kernel 1", "qmm_w4": "kernel 1", "qmm_w4_fx": "kernel 8",
                   "qmm_pallas_or_none": "kernel 4", "precise": "kernel 7"}


def _jax_site(monkeypatch, x, jw) -> str:
    """Which Pallas site JAX's qmatmul reaches for x @ jw^T: the sites are
    replaced by recorders that return zeros, so nothing runs."""
    hit = []

    def recorder(name, lead_of):
        def rec(*args, **kw):
            hit.append(name)
            return jnp.zeros(lead_of(args[0]) + (jw.shape[0],), jnp.float32)
        return rec

    rows = lambda a: a.shape[:-1]
    for name in ("qmm_w4_fx2", "qmm_w4_fx"):
        monkeypatch.setattr(jax_w4_mod, name, recorder(name, rows))
    # qmm_w4 takes the block-diagonal rows, NG per activation row
    monkeypatch.setattr(jax_w4_mod, "qmm_w4",
                        recorder("qmm_w4", lambda a: (a.shape[0] // jax_w4_mod.NG,)))
    monkeypatch.setattr(jax_qmm_mod, "qmm_pallas_or_none", recorder("qmm_pallas_or_none", rows))
    jax_qmatmul(jnp.asarray(x), jw)
    assert len(hit) == 1, hit
    site = hit[0]
    if site == "qmm_w4" and "precise" in jw.aux:
        site = "precise"
    return site


def _port_kernel(monkeypatch, x, pw) -> str:
    """Which port kernel qmatmul launches (the wrappers replaced by
    recorders)."""
    hit = []
    for attr, name in (("qmm_w4_matmul", "kernel 1"), ("qmm_w4_fx_matmul", "kernel 8"),
                       ("qmm", "kernel 4"), ("qmm_w4x_matmul", "kernel 7")):
        monkeypatch.setattr(port_qmatmul, attr,
                            lambda *a, _n=name, **k: hit.append(_n) or torch.zeros(1))
    port_qmatmul.qmatmul(torch.from_numpy(x), pw)
    assert len(hit) == 1, hit
    return hit[0]


@pytest.mark.parametrize("fx", [None, "2", "1", "0", "3"])
def test_fx_routing_equals_jax(fx, monkeypatch):
    """Under each value of LKTPU_W4_FX (unset, "2", "1", "0" and another)
    the port's qmatmul sends 2 decode rows of each W4 flavor (compact,
    legacy, sym) and of a precise W4X fold to the kernel that serves the
    site JAX's dispatch reaches (JAX_SITE_KERNEL): unset/"2" kernel 1 on
    every flavor; "1" kernel 8 on legacy and sym, kernel 4 on compact;
    other values kernel 1 on legacy and sym, kernel 4 on compact; the W4X
    fold kernel 7 whatever the knob."""
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    if fx is None:
        monkeypatch.delenv("LKTPU_W4_FX", raising=False)
    else:
        monkeypatch.setenv("LKTPU_W4_FX", fx)
    x = _x(2, 2048, 8)
    wf = (np.random.default_rng(9).standard_normal((128, 2048)) * 0.05).astype(np.float32)
    folds = {flavor: both_w4(9, 128, 2048, flavor) for flavor in ("compact", "legacy", "sym")}
    jx = jax.tree.map(jnp.asarray, jax_fold_to_w4(jax_repack.repack_float(wf, JaxType.Q4_K),
                                                  precise=True))
    folds["w4x"] = (jx, qtensor_from_numpy(jax.tree.map(np.asarray, jx), "cpu"))
    want = {"compact": "kernel 1" if fx in (None, "2") else "kernel 4",
            "legacy": "kernel 8" if fx == "1" else "kernel 1",
            "w4x": "kernel 7"}
    want["sym"] = want["legacy"]
    for flavor, (jw, pw) in folds.items():
        with monkeypatch.context() as m:
            site = _jax_site(m, x, jw)
        with monkeypatch.context() as m:
            got = _port_kernel(m, x, pw)
        assert JAX_SITE_KERNEL[site] == got == want[flavor], (flavor, site, got)


# -- Q4_0 and Q4_1 files ---------------------------------------------------------

FILE_MODES = ["w4", "w4x", "int8"]


@pytest.fixture(scope="module")
def q4_files(tmp_path_factory):
    """2-layer fixture files (tests/test_torch_loader.py's config): every
    matrix and token_embd Q4_0 (Q4_1), output Q6_K, as llama.cpp writes its
    MOSTLY_Q4_0 (Q4_1) files."""
    d = tmp_path_factory.mktemp("q4")
    out = {}
    for name, qtype in Q4_TYPES.items():
        out[name] = d / f"tiny-{name}.gguf"
        synthetic_gguf(out[name], GGUF_CFG, seed=13, matrix_type=qtype)
    return out


@pytest.mark.parametrize("mode", FILE_MODES)
@pytest.mark.parametrize("name", list(Q4_TYPES))
def test_q4_files_load_as_jax(q4_files, name, mode):
    """Both loaders give the same params for the Q4_0 and Q4_1 files in
    each mode, bit for bit (every plane through params_from_numpy): in w4
    sym (Q4_0) or legacy (Q4_1) W4 folds with a W8 output, in w4x their
    precise folds with a W8X output, in int8 Q8F; q|k|v and gate|up fuse
    in every layer, and the uniform layers stack on both sides."""
    jcfg, jp, jf = jax_load(q4_files[name], fast_mode=mode, fuse=True)
    cfg, pp, f = load_gguf_model(q4_files[name], fast_mode=mode, fuse=True, device="cpu")
    jf.close()
    f.close()
    assert f.metadata["general.file_type"] == (2 if name == "q4_0" else 3)
    w4 = {"w4": "sym", "w4x": "w4x_sym", "int8": "q8f"}[mode] if name == "q4_0" else \
        {"w4": "legacy", "w4x": "w4x", "int8": "q8f"}[mode]
    out = {"w4": "w8", "w4x": "w8x", "int8": "q8f"}[mode]
    assert (pp["tok_embd"].flavor, pp["output"].flavor) == (w4, out)
    for lp in pp["layers"]:
        assert {"wqkv_fused", "ffn_gateup_fused"} <= set(lp)
        assert {lp[k].flavor for k in ("wqkv_fused", "wo", "ffn_gateup_fused", "ffn_down")} == {w4}
    _same_tree(pp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))


@pytest.mark.parametrize("knobs", [{}, {"LKTPU_W4_FX": "1"},
                                   {"LKTPU_W4_FX": "1", "LKTPU_LAYER_FUSED": "1"}],
                         ids=["default", "fx", "fx+fused"])
def test_q4_0_file_serving_matches_jax(q4_files, knobs, monkeypatch):
    """The Q4_0 file in the w4 mode on both default (stacked) contexts, with
    the knobs on both sides: by default kernel 1 serves the sym folds;
    with LKTPU_W4_FX=1 kernel 8 (qkv, o: the FFN is kernel 2's); with
    both knobs kernel 10 takes o and the FFN and kernel 8 qkv.  A 12-token
    prefill and 8 steps, the JAX context greedy and the port's fed its
    tokens: logits within 4e-2 of max|logits| (the loader test's bound for
    files, tests/test_torch_loader.py::test_gguf_serving_matches_jax) and
    the greedy token equal wherever the top-2 gap exceeds twice that."""
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    for key, value in knobs.items():
        monkeypatch.setenv(key, value)
    jcfg, jp, jf = jax_load(q4_files["q4_0"], fast_mode="w4", fuse=True)
    cfg, pp, f = load_gguf_model(q4_files["q4_0"], fast_mode="w4", fuse=True, device="cpu")
    jf.close()
    f.close()
    from llama_kotlin_tpu_torch.ops.cuda import qmm_w4_fx as fx_mod

    calls = []
    orig = fx_mod.qmm_w4_fx_plain
    monkeypatch.setattr(fx_mod, "qmm_w4_fx_plain", lambda *a: calls.append(1) or orig(*a))
    prompt = np.random.default_rng(19).integers(0, GGUF_CFG.vocab_size, N_PROMPT).astype(np.int32)
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS)
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu")
    assert "layers_stacked" in pctx.params and "layers_stacked" in jctx.params
    jt, jl = _steps(jctx, JaxBatch, prompt)
    pl = _forced_steps(pctx, prompt, jt)
    # kernel 8 takes the sym layers' projections of up to 32 rows under the
    # knob: qkv and o, 2 a layer, in the 12-row prefill and in every step;
    # with kernel 10 on, qkv alone in a step (kernel 10 takes at most 8 rows)
    fx = knobs.get("LKTPU_W4_FX") == "1"
    per_step = 0 if not fx else 1 if knobs.get("LKTPU_LAYER_FUSED") == "1" else 2
    assert len(calls) == (2 * fx + per_step * (len(jt) - 1)) * GGUF_CFG.n_layer
    tol, decided = 4e-2, 0
    for tok, a, b in zip(jt, pl, jl):
        top = np.abs(b).max()
        assert np.abs(a - b).max() <= tol * top
        s = np.sort(b)
        if s[-1] - s[-2] > 2 * tol * top:
            assert int(np.argmax(a)) == tok
            decided += 1
    assert decided >= 2
