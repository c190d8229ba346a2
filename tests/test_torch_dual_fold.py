"""The Q8F high-batch shadow (``LKTPU_DUAL_FOLD=1``) on the port against the
JAX package, on the CPU: ``quant/fold.py::attach_q8`` (from the loader's
f32 decode of the wire, and from the fold itself, row-chunked as JAX's
``attach_q8_device``) bit for bit against JAX's; the converter carrying
JAX's shadow across; the switch in ``ops/qmatmul.py`` (rows above
``LKTPU_W4_BMAX`` and up to 256 on kernel 6, the W4 route at or below the
threshold bit for bit as without a shadow, kernel 4 above 256) against the
site JAX's dispatch reaches at BMAX, BMAX + 1, 256 and 257 rows; kernels 2
and 10 declining above the threshold; and a Q4_K_M file loaded with the
switch on in both packages, equal plane for plane, and served by the
port (rows at or below the threshold bit for bit as without the switch, a
12-row prefill on kernel 6 within tests/test_torch_exact_mode.py's
FAST_TOL of the W4 route).  JAX's Pallas kernels run in interpret mode."""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.ops.pallas import qmm as jax_qmm_mod, qmm_int8 as jax_int8_mod
from llama_kotlin_tpu.ops.pallas import qmm_w4 as jax_w4_mod
from llama_kotlin_tpu.quant import fold as jax_fold, numpy_ref, repack as jax_repack
from llama_kotlin_tpu.quant.formats import GGMLQuantType as JaxType

from llama_kotlin_tpu_torch.convert import params_from_numpy, qtensor_from_numpy
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.models.loader import fuse_layer_projections, load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import synthetic_gguf, wire_blocks
from llama_kotlin_tpu_torch.ops import qmatmul as port_qmatmul
from llama_kotlin_tpu_torch.ops.cuda.qmm_int8 import qmm_int8
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4_layer import layer_eligible
from llama_kotlin_tpu_torch.quant import fold, repack
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from test_torch_exact_mode import FAST_TOL, N_CELLS, N_PROMPT
from test_torch_loader import _same_tree

jax_qmatmul_mod = importlib.import_module("llama_kotlin_tpu.ops.qmatmul")  # not ops' function
N, K = 256, 1024


def _both_folds(seed: int, n: int = N, k: int = K):
    """A random Q4_K matrix's wire bytes, folded to W4 by both packages."""
    data = wire_blocks(np.random.default_rng(seed), Q.Q4_K, n, k)
    jw = jax_fold.fold_to_w4(jax_repack.repack(data, JaxType.Q4_K, n, k))
    pw = fold.fold_to_w4(repack.repack(torch.from_numpy(data), Q.Q4_K, n, k))
    return data, jw, pw


def _shadow_equal(pw, jw) -> None:
    for name in ("q8_codes", "q8_scale"):
        np.testing.assert_array_equal(pw.aux[name].numpy(), np.asarray(jw.aux[name]),
                                      err_msg=name)


def test_attach_q8_matches_jax():
    """attach_q8 from the f32 wire decode (the loader's) and from the fold
    (JAX's attach_q8 without a source, and attach_q8_device), chunked at 100
    rows: the shadow's int8 codes [n, k_pad] and f32 scales [n, k_pad/256]
    equal JAX's bit for bit; the converter carries JAX's shadow across; a
    W4X fold takes none."""
    data, jw, pw = _both_folds(1)
    wf = numpy_ref.dequantize(data, JaxType.Q4_K, shape=(N, K))
    from_wire = fold.attach_q8(pw, repack.dequantize_wire(torch.from_numpy(data), Q.Q4_K,
                                                          (N, K)), row_chunk=100)
    assert fold.has_shadow(from_wire) and fold.is_w4(from_wire)
    assert from_wire.aux["q8_codes"].shape == (N, K) and from_wire.aux["q8_codes"].dtype == torch.int8
    _shadow_equal(from_wire, jax_fold.attach_q8(jw, wf))
    own = fold.attach_q8_device(pw, row_chunk=100)
    _shadow_equal(own, jax_fold.attach_q8(jw))
    _shadow_equal(own, jax.tree.map(np.asarray, jax_fold.attach_q8_device(
        jax.tree.map(jnp.asarray, jw), row_chunk=100)))
    conv = qtensor_from_numpy(jax.tree.map(np.asarray, jax_fold.attach_q8(jw, wf)), "cpu")
    assert conv.flavor == pw.flavor and conv.tensors().keys() == from_wire.tensors().keys()
    for name, t in from_wire.tensors().items():
        assert torch.equal(conv.tensors()[name], t), name
    with pytest.raises(ValueError):
        fold.attach_q8(fold.fold_to_w4(repack.repack(torch.from_numpy(data), Q.Q4_K, N, K),
                                       precise=True))


# the site JAX's dispatch reaches -> the port kernel that serves it
JAX_SITE = {"qmm_int8_or_none": "kernel 6", "qmm_w4_fx2": "kernel 1",
            "qmm_pallas_or_none": "kernel 4"}


def _jax_site(monkeypatch, x, jw) -> str:
    """Which kernel JAX's qmatmul reaches for x @ jw^T: its kernel 6 and 4
    entries and kernel 1's fx2 site (behind qmm_w4_or_none's own row
    check) replaced by recorders that return zeros (nothing runs)."""
    hit = []

    def rec(name):
        return lambda a, *r, **kw: hit.append(name) or jnp.zeros(a.shape[:-1] + (jw.shape[0],))

    for mod, name in ((jax_int8_mod, "qmm_int8_or_none"), (jax_w4_mod, "qmm_w4_fx2"),
                      (jax_qmm_mod, "qmm_pallas_or_none")):
        monkeypatch.setattr(mod, name, rec(name))
    jax_qmatmul_mod.qmatmul(jnp.asarray(x), jw)
    assert len(hit) == 1, hit
    return JAX_SITE[hit[0]]


def _port_kernel(monkeypatch, x, pw) -> str:
    hit = []
    for attr, name in (("qmm_int8", "kernel 6"), ("qmm_w4_matmul", "kernel 1"),
                       ("qmm", "kernel 4")):
        monkeypatch.setattr(port_qmatmul, attr,
                            lambda *a, _n=name, **k: hit.append(_n) or torch.zeros(1))
    port_qmatmul.qmatmul(torch.from_numpy(x), pw)
    assert len(hit) == 1, hit
    return hit[0]


@pytest.mark.parametrize("bmax", [None, "4"], ids=["bmax8", "bmax4"])
def test_switch_routes_as_jax(monkeypatch, bmax):
    """At BMAX, BMAX + 1, 32, 256 and 257 rows (LKTPU_W4_BMAX unset, 8, and
    4), with and without a shadow, the port's qmatmul takes the kernel that
    serves the site JAX's dispatch reaches: the W4 route at or below BMAX
    (kernel 1 to 32 rows, kernel 4 above), kernel 6 on the shadow from BMAX
    + 1 to 256 rows, kernel 4 at 257."""
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    if bmax is None:
        monkeypatch.delenv("LKTPU_W4_BMAX", raising=False)
    else:
        monkeypatch.setenv("LKTPU_W4_BMAX", bmax)
    b = port_qmatmul.w4_bmax()
    assert b == int(bmax or 8)
    data, jw, pw = _both_folds(2)
    wf = numpy_ref.dequantize(data, JaxType.Q4_K, shape=(N, K))
    jd = jax.tree.map(jnp.asarray, jax_fold.attach_q8(jw, wf))
    pd = fold.attach_q8(pw, torch.from_numpy(wf))
    jw = jax.tree.map(jnp.asarray, jw)
    for rows in (b, b + 1, 32, 256, 257):
        x = np.zeros((rows, K), np.float32)
        for j, p in ((jw, pw), (jd, pd)):
            want = _jax_site(monkeypatch, x, j)
            assert _port_kernel(monkeypatch, x, p) == want, (rows, "q8_codes" in j.aux)
        shadow = "kernel 6" if b < rows <= 256 else None
        assert _port_kernel(monkeypatch, x, pd) == (shadow or _port_kernel(monkeypatch, x, pw))


def test_switch_outputs(monkeypatch):
    """The dual fold's outputs: at BMAX rows and one row bit-identical to the
    fold without a shadow; at BMAX + 1 and 64 rows kernel 6's plain version
    on the shadow, within 1e-5 of max|y| of JAX's dispatch (its kernel 6 in
    interpret mode), and within the W8A8 rounding of the W4 route (3e-2 of
    max|y|, JAX's test_w4_high_batch_q8_switch bound)."""
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("LKTPU_W4_BMAX", raising=False)
    data, jw, pw = _both_folds(3)
    pd = fold.attach_q8_device(pw)
    jd = jax.tree.map(jnp.asarray, jax_fold.attach_q8(jw))
    rng = np.random.default_rng(4)
    for rows in (1, 8):
        x = torch.from_numpy((rng.standard_normal((rows, K)) * 0.5).astype(np.float32))
        assert torch.equal(port_qmatmul.qmatmul(x, pd), port_qmatmul.qmatmul(x, pw))
    for rows in (9, 64):
        x = (rng.standard_normal((rows, K)) * 0.5).astype(np.float32)
        got = port_qmatmul.qmatmul(torch.from_numpy(x), pd)
        assert torch.equal(got, qmm_int8(torch.from_numpy(x), fold.q8_shadow(pd)))
        ref = np.asarray(jax_qmatmul_mod.qmatmul(jnp.asarray(x), jd))
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
        w4 = port_qmatmul.qmatmul(torch.from_numpy(x), pw).numpy()
        assert np.abs(got.numpy() - w4).max() <= 3e-2 * np.abs(w4).max()


def test_kernels_2_and_10_decline_above_bmax(monkeypatch):
    """Under LKTPU_W4_BMAX=4, qmm_ffn (kernel 2) and qmm_layer (kernel 10,
    LKTPU_LAYER_FUSED=1) take 4 rows of shadowed folds and decline 5 (which
    both take without a shadow), so the caller's two-launch path sends o,
    gate|up and down to kernel 6; JAX's qmm_ffn declines the same rows
    (JAX's tests/test_w4.py::test_w4_ffn_declines_at_high_batch_with_q8)."""
    monkeypatch.setenv("LKTPU_W4_BMAX", "4")
    monkeypatch.setenv("LKTPU_LAYER_FUSED", "1")
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    E, F = 2048, 2048  # compact folds throughout, as kernel 10 asks
    _, jgu, gu = _both_folds(5, 2 * F, E)
    _, jdn, dn = _both_folds(6, E, F)
    _, _, wo = _both_folds(7, E, E)
    sgu, sdn, swo = (fold.attach_q8_device(w) for w in (gu, dn, wo))
    rng = np.random.default_rng(8)
    norm = torch.ones(E)
    for rows in (4, 5):
        x = torch.from_numpy((rng.standard_normal((rows, E)) * 0.5).astype(np.float32))
        assert layer_eligible(x, x, wo, gu, dn, "silu")
        for g, d, o in ((gu, dn, wo), (sgu, sdn, swo)):
            takes = rows <= 4 or not fold.has_shadow(g)
            assert (port_qmatmul.qmm_ffn(x, g, d) is not None) == takes
            assert (port_qmatmul.qmm_layer(x, x, o, g, d, norm, eps=1e-5) is not None) == takes
    jx = jnp.asarray(rng.standard_normal((5, E)), jnp.float32)
    jgu, jdn = (jax.tree.map(jnp.asarray, jax_fold.attach_q8(w)) for w in (jgu, jdn))
    assert jax_qmatmul_mod.qmm_ffn(jx, jgu, jdn) is None


# one layer: Q4_K_M's rule gives it Q6_K attn_v and ffn_down (W8 folds) beside
# its Q4_K matrices (W4 folds)
CFG = ModelConfig(arch="llama", name="tiny-dual", vocab_size=512, n_embd=512, n_layer=1,
                  n_head=4, n_head_kv=2, n_ff=1024, n_ctx_train=4096)


def test_dual_fold_file_matches_jax(tmp_path, monkeypatch):
    """A Q4_K_M file loaded with LKTPU_DUAL_FOLD=1, unfused (JAX's loader
    cannot fuse shadowed folds: its concat_qtensors joins aux planes on
    their last axis, and the shadow's rows are its first): in w4 both
    loaders give every W4 fold (token_embd, the Q4_K matrices) its shadow
    from the f32 wire decode, equal plane for plane; W8 folds (Q6_K) and
    the w4x mode take none (int8 and the exact mode fold no W4).  The
    port's fuse joins the shadows with their folds.  Served on the
    port (test_switch_outputs holds each route against JAX's): an 8-token
    prefill and 2 one-row steps give the logits of the same file loaded
    without the switch bit for bit (every row count at or below BMAX takes
    the W4 route); a 12-token prefill runs every shadowed matrix on kernel
    6 and its logits stay within FAST_TOL of the W4 route's."""
    path = tmp_path / "dual.gguf"
    synthetic_gguf(path, CFG, seed=61)
    monkeypatch.delenv("LKTPU_W4_BMAX", raising=False)
    plain_cfg, plain, f = load_gguf_model(path, fast_mode="w4", device="cpu")
    f.close()
    monkeypatch.setenv("LKTPU_DUAL_FOLD", "1")
    loaded = {}
    for mode in ("w4", "w4x"):
        jcfg, jp, jf = jax_load(path, fast_mode=mode)
        cfg, pp, f = load_gguf_model(path, fast_mode=mode, device="cpu")
        jf.close()
        f.close()
        _same_tree(pp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
        mats = [pp["tok_embd"], pp["output"]] + [w for lp in pp["layers"] for w in lp.values()
                                                 if hasattr(w, "codes")]
        assert all(fold.has_shadow(w) == (mode == "w4" and fold.is_w4(w)) for w in mats)
        loaded[mode] = pp
    pp = loaded["w4"]
    assert fold.has_shadow(pp["tok_embd"])
    assert fold.is_w8(pp["output"]) and not fold.has_shadow(pp["output"])
    fused = {"layers": [dict(lp) for lp in pp["layers"]]}
    assert fuse_layer_projections(cfg, fused) == 1  # the loader's fuse=True
    lp0 = pp["layers"][0]
    for name in ("q8_codes", "q8_scale"):
        assert torch.equal(fused["layers"][0]["ffn_gateup_fused"].aux[name],
                           torch.cat([lp0[k].aux[name] for k in ("ffn_gate", "ffn_up")]))
    calls = []
    real = port_qmatmul.qmm_int8
    monkeypatch.setattr(port_qmatmul, "qmm_int8", lambda x, w: calls.append(x.shape) or real(x, w))
    rng = np.random.default_rng(5)
    short = rng.integers(0, CFG.vocab_size, 8).astype(np.int32)
    toks = list(rng.integers(0, CFG.vocab_size, 2))
    ctx = lambda p: LlamaContext(cfg, p, n_cells=N_CELLS, buckets=(8, 16), device="cpu")
    for a, b in zip(_steps(ctx(pp), short, toks), _steps(ctx(plain), short, toks)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert not calls
    prompt = rng.integers(0, CFG.vocab_size, N_PROMPT).astype(np.int32)
    a, b = _steps(ctx(pp), prompt, [])[0], _steps(ctx(plain), prompt, [])[0]
    # the prefill: the layer's wq, wk, o, gate and up on their shadows (its
    # Q6_K wv and down are W8)
    assert len(calls) == 5 and all(s[0] == 16 for s in calls)  # the 16-row bucket
    assert np.abs(a - b).max() <= FAST_TOL * np.abs(b).max()


def _steps(ctx, prompt, toks) -> list:
    """A prefill, then one step per token of toks: the last logits row of each."""
    assert ctx.decode(Batch.single(prompt)) == 0
    out = [ctx.get_logits()[-1]]
    for i, t in enumerate(toks):
        assert ctx.decode(Batch.single([int(t)], pos0=len(prompt) + i)) == 0
        out.append(ctx.get_logits()[-1])
    return out
