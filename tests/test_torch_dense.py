"""Port parity for dense (F32, F16) matrices: the loaders keep them as bf16
tensors in every fast mode, ``qmatmul`` multiplies them as ``jnp.dot`` with
an f32 result does, ``take_rows`` gathers their rows, and served logits
match the JAX package's.

Two files: an all-F32 one written by ``tests/fixtures.py::
write_llama_gguf`` with tied embeddings (no ``output``), and a Q4_K one
with F16 ``token_embd`` and ``output`` written by the port's
``synthetic_gguf``.  Inputs come from numpy seeds."""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.ops.qmatmul import qmatmul as jax_qmatmul
from llama_kotlin_tpu.ops.qmatmul import take_rows as jax_take_rows
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import synthetic_gguf
from llama_kotlin_tpu_torch.ops import qmatmul as qm
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType
from llama_kotlin_tpu_torch.quant.qtensor import QTensor
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from fixtures import random_llama_weights, tiny_llama_dims, write_llama_gguf

MODES = ["w4", "w4x", "int8"]
FILES = ["f32-tied", "q4_k-f16"]
F16_CFG = ModelConfig(arch="llama", name="tiny-f16-out", vocab_size=256, n_embd=512,
                      n_layer=2, n_head=4, n_head_kv=2, n_ff=1024)
# logits relative to max|logits|.  The dense matmuls are f32 sums of the
# same bf16 products on both sides, so the F32 file differs by reduction
# order only, which its bf16 residual stream and FFN roundings amplify:
# measured 7.7e-3 to 1.0e-2 against JAX, where summing the port's own dense
# products in f64 in place of f32 moves its logits by 3.9e-3.  The Q4_K
# file's zero-mean wire weights and int8 activation codes amplify more
# (measured up to 1.9e-2): it is held at tests/test_torch_loader.py's 4e-2
# for such files.
LOGIT_TOL = {"f32-tied": 2e-2, "q4_k-f16": 4e-2}


@pytest.fixture(scope="module")
def gguf_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dense")
    dims = tiny_llama_dims(n_embd=256, n_layer=2, n_head=2, n_head_kv=1, n_ff=512, vocab=160)
    weights = random_llama_weights(dims, np.random.default_rng(3))
    del weights["output.weight"]  # tied: the forward reads token_embd
    write_llama_gguf(d / "f32.gguf", weights, dims)
    synthetic_gguf(d / "f16.gguf", F16_CFG, seed=5,
                   layer_types=[{"attn_v": GGMLQuantType.Q4_K,
                                 "ffn_down": GGMLQuantType.Q4_K}] * F16_CFG.n_layer,
                   embd_type=GGMLQuantType.F16, output_type=GGMLQuantType.F16)
    return {"f32-tied": d / "f32.gguf", "q4_k-f16": d / "f16.gguf"}


def _dense_leaves(params: dict, prefix: str = ""):
    """(path, leaf) of every 2-D matrix that is not a QTensor."""
    for key, v in params.items():
        if isinstance(v, dict):
            yield from _dense_leaves(v, f"{prefix}{key}.")
        elif isinstance(v, list):
            for i, lp in enumerate(v):
                yield from _dense_leaves(lp, f"{prefix}{key}.{i}.")
        elif v is not None and not isinstance(v, QTensor) and getattr(v, "ndim", 0) == 2:
            yield prefix + key, v


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("which", FILES)
def test_dense_file_matches_jax(gguf_files, which, mode, monkeypatch):
    """Each file loads in each fast mode on both sides.  Every F32/F16
    matrix is a bf16 tensor in the port, equal bit for bit to JAX's bf16
    array under the same key (fused q|k|v and gate|up included, as JAX
    fuses dense projections too); the F16 file's layers stay quantized.
    Then a 12-token prefill and 3 greedy steps on the default context: the
    JAX context decodes greedily and the port takes its tokens; logits
    within LOGIT_TOL of max|logits|."""
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    jcfg, jp, jf = jax_load(gguf_files[which], fast_mode=mode, fuse=True)
    cfg, pp, f = load_gguf_model(gguf_files[which], fast_mode=mode, fuse=True, device="cpu")
    jf.close()
    f.close()
    ours, ref = dict(_dense_leaves(pp)), dict(_dense_leaves(jp))
    want = {"tok_embd"} if which == "f32-tied" else {"tok_embd", "output"}
    if which == "f32-tied":
        want |= {f"layers.{i}.{k}" for i in range(cfg.n_layer)
                 for k in ("wqkv_fused", "wo", "ffn_gateup_fused", "ffn_down")}
    assert set(ours) == set(ref) == want
    assert ("output" in pp) == ("output" in jp) == (which != "f32-tied")
    for key, t in ours.items():
        assert t.dtype == torch.bfloat16, key
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(ref[key], np.float32),
                                      err_msg=key)
    jctx = JaxContext(jcfg, jp, n_cells=256)
    pctx = LlamaContext(cfg, pp, n_cells=256, device="cpu")
    assert ("layers_stacked" in pctx.params) == ("layers_stacked" in jctx.params)
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, 12).astype(np.int32)
    assert jctx.decode(JaxBatch.single(prompt)) == 0
    assert pctx.decode(Batch.single(prompt)) == 0
    jl, pl = [np.asarray(jctx.get_logits()[-1], np.float32)], [pctx.get_logits()[-1]]
    for i in range(3):
        tok = [int(np.argmax(jl[-1]))]
        assert jctx.decode(JaxBatch.single(tok, pos0=12 + i)) == 0
        assert pctx.decode(Batch.single(tok, pos0=12 + i)) == 0
        jl.append(np.asarray(jctx.get_logits()[-1], np.float32))
        pl.append(pctx.get_logits()[-1])
    errs = [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(pl, jl)]
    assert max(errs) <= LOGIT_TOL[which], errs


@pytest.mark.parametrize("rows", [1, 5, 64])
def test_dense_qmatmul_and_take_rows_match_jax(rows, monkeypatch):
    """qmatmul on a dense bf16 weight equals JAX's qmatmul (jnp.dot of bf16
    operands with an f32 result) within f32 reduction order, for f32 and
    bf16 activations, across the CPU product's row blocks (n = 5000 > 4096);
    take_rows equals JAX's w[ids] exactly, in f32 and bf16."""
    rng = np.random.default_rng(rows)
    n, k = 5000, 256
    w = jnp.asarray(rng.standard_normal((n, k)) * 0.05, jnp.bfloat16)
    tw = torch.from_numpy(np.array(w.astype(jnp.float32))).to(torch.bfloat16)
    monkeypatch.setattr(qm, "DENSE_CPU_ROWS", 4096)
    for dt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        x = jnp.asarray(rng.standard_normal((rows, k)), dt)
        ref = np.asarray(jax_qmatmul(x, w))
        got = qm.qmatmul(torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt), tw)
        assert got.dtype == torch.float32 and got.shape == (rows, n)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    ids = rng.integers(0, n, 7).astype(np.int32)
    for dt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(jax_take_rows(w, jnp.asarray(ids), dtype=dt).astype(jnp.float32))
        got = qm.take_rows(tw, torch.from_numpy(ids), dtype=tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), ref)
