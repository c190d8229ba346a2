"""The nine IQ (codebook) wire formats on the port against the JAX package,
on the CPU: the repack (``quant/repack.py::repack_iq`` over the port's
``quant/iq.py``) and the wire decode bit for bit against JAX's
``repack_iq`` / ``numpy_ref.dequantize``; the W8, W8X and Q8F conversions
of every IQ repack bit for bit against JAX's; the embedding rows of an IQ
``token_embd``; the synthetic draws (``wire_blocks``, ``every_iq_layer_types``,
``ftype_profile``); and a 2-layer file that holds all nine formats through
both loaders in the four modes, plane for plane and served: a 12-token
prefill and 4 greedy steps, JAX's Pallas kernels in interpret mode.

Tolerances of the served logits, of max|logits|, are
tests/test_torch_exact_mode.py's on the same widths: 1e-2 in the exact
mode (both sides multiply the same bf16 weights by the same bf16
activations; only f32 summation order differs), 4e-2 in the fast modes
(every matmul input re-quantizes to int8, which carries a last-bit
difference further; tests/test_torch_loader.py measured 1.7-2.5e-2)."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import torch

from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.quant import fold as jax_fold, numpy_ref, repack as jax_repack
from llama_kotlin_tpu.quant.formats import GGMLQuantType as JaxType
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.convert import params_from_numpy, qtensor_from_numpy
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import (EVERY_IQ, IQ4_CENTRED, every_iq_layer_types,
                                                     ftype_profile, synthetic_gguf, wire_blocks)
from llama_kotlin_tpu_torch.ops.qmatmul import take_rows
from llama_kotlin_tpu_torch.quant import fold, iq, repack
from llama_kotlin_tpu_torch.quant.formats import TYPE_TRAITS, GGMLQuantType as Q
from llama_kotlin_tpu_torch.quant.qtensor import dequantize
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from test_torch_exact_mode import EXACT_TOL, FAST_TOL, N_CELLS, N_PROMPT, _greedy
from test_torch_loader import _forced_steps, _same_tree

IDS = [TYPE_TRAITS[q].name for q in EVERY_IQ]
CFG = ModelConfig(arch="llama", name="tiny-iq", vocab_size=512, n_embd=512, n_layer=2,
                  n_head=4, n_head_kv=2, n_ff=1024, n_ctx_train=4096)


def _jax_blocks(qtype, nb: int, rng) -> np.ndarray:
    """JAX's tests/test_iq_quants.py::_random_blocks: every byte random, d
    pinned to 1.5 (IQ1_M: its four scale nibbles)."""
    b = rng.integers(0, 256, (nb, TYPE_TRAITS[qtype].type_size)).astype(np.uint8)
    if qtype == Q.IQ1_M:
        sc = b[:, 48:56].copy().view("<u2").reshape(-1, 4)
        sc[:, 0] &= 0x0FFF
        sc[:, 1] &= 0x0FFF
        sc[:, 2] = (sc[:, 2] & 0x0FFF) | 0xE000
        sc[:, 3] = (sc[:, 3] & 0x0FFF) | 0x3000
        b[:, 48:56] = sc.view(np.uint8).reshape(-1, 8)
    else:
        b[:, 0:2] = np.frombuffer(np.float16(1.5).tobytes(), np.uint8)
    return b.reshape(-1)


def _np(t):
    return None if t is None else t.numpy()


@pytest.mark.parametrize("qtype", EVERY_IQ, ids=IDS)
def test_repack_iq_matches_jax(qtype):
    """JAX's random blocks and the port's synthetic ones: the split and the
    repack equal JAX's plane for plane (dtypes too), the wire decode equal
    numpy_ref's bit for bit, and the Q8F conversion equal JAX's."""
    n, k = 6, 512
    rng = np.random.default_rng(int(qtype))
    for data in (_jax_blocks(qtype, n * k // TYPE_TRAITS[qtype].block_size, rng),
                 wire_blocks(rng, qtype, n, k)):
        ref = jax_repack.repack_iq(data, JaxType(int(qtype)), n, k)
        got = repack.repack(torch.from_numpy(data.copy()), qtype, n, k)
        assert (got.bits, got.group_size, got.code_offset, got.shape) == (
            ref.bits, ref.group_size, ref.code_offset, ref.shape)
        for name in ("codes", "g_scale", "g_min", "sb_scale", "sb_min"):
            a, b = _np(getattr(got, name)), getattr(ref, name)
            assert (a is None) == (b is None), name
            if b is not None:
                assert a.dtype == np.asarray(b).dtype, name
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
        assert fold.is_exact(got)
        want = numpy_ref.dequantize(data, JaxType(int(qtype)), shape=(n, k))
        np.testing.assert_array_equal(
            repack.dequantize_wire(torch.from_numpy(data.copy()), qtype, (n, k)).numpy(), want)
        q8 = jax_repack.repack_q8flat(data, JaxType(int(qtype)), n, k)
        got8 = repack.repack_q8flat(torch.from_numpy(data.copy()), qtype, n, k)
        np.testing.assert_array_equal(got8.codes.numpy(), np.asarray(q8.codes))
        np.testing.assert_array_equal(got8.g_scale.numpy(), np.asarray(q8.g_scale))


@pytest.mark.parametrize("precise", [False, True], ids=["w8", "w8x"])
def test_fold_to_w8_of_iq_matches_jax(precise):
    """fold_to_w8 of each IQ repack (the w4 and w4x modes' layout): equal
    to JAX's fold converted by the port's converter (codes, f32 s_eff, no
    mins), dequantizing to the wire's values bit for bit."""
    n, k = 4, 1024
    rng = np.random.default_rng(3)
    for qtype in EVERY_IQ:
        data = wire_blocks(rng, qtype, n, k)
        ref = jax_fold.fold_to_w8(jax_repack.repack_iq(data, JaxType(int(qtype)), n, k),
                                  precise=precise)
        got = fold.fold_to_w8(repack.repack(torch.from_numpy(data), qtype, n, k),
                              precise=precise)
        assert (fold.is_w8x if precise else fold.is_w8)(got), qtype
        want = qtensor_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
        assert got.flavor == want.flavor and got.g_min is None
        assert got.tensors().keys() == want.tensors().keys()
        for name, t in want.tensors().items():
            assert torch.equal(got.tensors()[name], t), (qtype, name)
        np.testing.assert_array_equal(dequantize(got).numpy(), numpy_ref.dequantize(
            data, JaxType(int(qtype)), shape=(n, k)))


def test_take_rows_of_an_iq_embedding():
    """take_rows gathers an IQ token_embd in each mode's layout (the exact
    repack, the W8 fold, Q8F) and dequantizes only those rows."""
    n, k = 64, 512
    rng = np.random.default_rng(8)
    ids = torch.tensor([5, 0, 63, 5])
    for qtype in (Q.IQ4_XS, Q.IQ2_S, Q.IQ4_NL, Q.IQ1_M):
        data = torch.from_numpy(wire_blocks(rng, qtype, n, k))
        rp = repack.repack(data, qtype, n, k)
        full = repack.dequantize_wire(data, qtype, (n, k))
        for w in (rp, fold.fold_to_w8(rp), repack.repack_q8flat(data, qtype, n, k)):
            assert torch.equal(take_rows(w, ids), dequantize(w)[ids])
        assert torch.equal(take_rows(rp, ids), full[ids])


def test_iq_draws_and_profiles():
    """wire_blocks' IQ draws: finite, weights of std 0.01-0.04 and
    zero-mean (IQ4's levels drawn from a subset that sums to 0);
    every_iq_layer_types puts each of the nine on some matrix of two
    layers, no two projections of a layer alike; ftype_profile gives the
    quantize tool's types (JAX's tensor_get_type: an IQ2_XXS file's Q4_K
    token_embd and Q5_K output)."""
    assert sum(iq.KVALUES_IQ4NL[i] for i in IQ4_CENTRED) == 0
    rng = np.random.default_rng(4)
    for qtype in EVERY_IQ:
        x = repack.dequantize_wire(torch.from_numpy(wire_blocks(rng, qtype, 64, 1024)), qtype,
                                   (64, 1024))
        assert torch.isfinite(x).all()
        assert 0.01 < float(x.std()) < 0.04, qtype
        assert abs(float(x.mean())) < 0.02 * float(x.std()), qtype
    types = every_iq_layer_types(2)
    assert {t for layer in types for t in layer.values()} == set(EVERY_IQ)
    assert all(len(set(layer.values())) == len(layer) for layer in types)
    p = ftype_profile(2, "IQ2_XXS")
    assert (p["embd_type"], p["output_type"]) == (Q.Q4_K, Q.Q5_K)
    assert {t for layer in p["layer_types"] for t in layer.values()} == {Q.IQ2_XXS}
    assert ftype_profile(1, "IQ4_XS")["output_type"] == Q.IQ4_XS


@pytest.fixture(scope="module")
def iq_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("iq") / "iq_mix.gguf"
    synthetic_gguf(path, CFG, seed=51, layer_types=every_iq_layer_types(2),
                   embd_type=Q.IQ4_XS, output_type=Q.IQ3_S, matrix_type=Q.IQ4_XS)
    return path


ROUTE = {None: fold.is_exact, "w4": fold.is_w8, "w4x": fold.is_w8x, "int8": fold.is_q8f}


@pytest.mark.parametrize("mode", [None, "w4", "w4x", "int8"], ids=str)
def test_iq_file_matches_jax(iq_file, mode, monkeypatch):
    """The IQ-mix file through both loaders: equal params, plane for plane;
    every matrix in the mode's layout (exact: an exact repack, kernel 4's
    exact branch; w4: W8, kernel 5; w4x: W8X, kernel 5's dual-plane
    branch; int8: Q8F, kernel 6); then a prefill and 4 greedy steps.  In
    the exact mode identical greedy ids, logits within EXACT_TOL; in the
    fast modes the port on JAX's tokens within FAST_TOL, its greedy token
    JAX's wherever the top-2 gap exceeds twice that."""
    jcfg, jp, jf = jax_load(iq_file, fast_mode=mode, fuse=True)
    cfg, pp, f = load_gguf_model(iq_file, fast_mode=mode, fuse=True, device="cpu")
    jf.close()
    f.close()
    _same_tree(pp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    mats = [pp["tok_embd"], pp["output"]] + [w for lp in pp["layers"] for w in lp.values()
                                             if hasattr(w, "codes")]
    # the mixed layers keep their 7 matrices apart; in int8 all are Q8F and fuse
    assert len(mats) == (10 if mode == "int8" else 16) and all(ROUTE[mode](w) for w in mats)
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    prompt = np.random.default_rng(9).integers(0, CFG.vocab_size, N_PROMPT).astype(np.int32)
    jt, jl = _greedy(JaxContext(jcfg, jp, n_cells=N_CELLS), JaxBatch, prompt)
    assert len(set(jt)) > 1
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu")
    if mode is None:
        pt, pl = _greedy(pctx, Batch, prompt)
        assert pt == jt
        tol = EXACT_TOL
    else:
        pl, tol = _forced_steps(pctx, prompt, jt), FAST_TOL
    for tok, a, b in zip(jt, pl, jl):
        top = np.abs(b).max()
        assert np.abs(a - b).max() <= tol * top
        s = np.sort(b)
        if s[-1] - s[-2] > 2 * tol * top:
            assert int(np.argmax(a)) == tok
