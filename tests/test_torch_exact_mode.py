"""The exact-dequant mode (``fast_mode=None``, the loaders' and the CLIs'
default) as a whole, and the six new wire formats in every mode, on the CPU.

2-layer synthetic GGUF files (E = 512, head dim 128, vocab 512), written by
the port's writer from a seed: the Q4_K_M mix (layer 0 all Q4_K, layer 1
with Q6_K attn_v and ffn_down), a mix that puts every format the loader
takes on some matrix (``every_format_layer_types``) and an all-Q8_0 file.
Both packages load each with ``fast_mode=None``: the parameters are equal
plane for plane, and the JAX context (its Pallas kernels in interpret
mode, as it serves) and the port's give identical greedy ids over a
prefill plus 4 steps, with logits within 1e-2 of max|logits|: both
contexts multiply the same bf16 weights by the same bf16 activations
with f32 sums, so they differ only in the f32 summation order, carried on
by the bf16 residual stream.  Unrolled (the two mixed files) and stacked
(the Q8_0 file) are both covered.  The every-format file in ``w4``,
``w4x`` and ``int8`` gives JAX's tokens (teacher-forced, the fast modes'
4e-2 bound of tests/test_torch_loader.py).  The port's CLI runs without
``--fast-mode`` on an SPM-vocab file and prints JAX's CLI text.
"""

from __future__ import annotations

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import jax

from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext
from llama_kotlin_tpu.tools import main as jax_cli

from llama_kotlin_tpu_torch.convert import params_from_numpy
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import (EVERY_FORMAT, every_format_layer_types,
                                                     q5_k_m_layer_types, synthetic_gguf,
                                                     synthetic_spm_vocab)
from llama_kotlin_tpu_torch.quant import fold
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext
from llama_kotlin_tpu_torch.tools import main as cli

from test_torch_loader import _forced_steps, _same_tree

CFG = ModelConfig(arch="llama", name="tiny-exact", vocab_size=512, n_embd=512, n_layer=2,
                  n_head=4, n_head_kv=2, n_ff=1024, n_ctx_train=4096)
N_PROMPT, N_STEPS, N_CELLS = 12, 5, 256
EXACT_TOL = 1e-2
FAST_TOL = 4e-2
FILES = {
    "q4_k_m": dict(seed=36),
    "every_format": dict(seed=47, layer_types=every_format_layer_types(2), embd_type=Q.Q5_K),
    "q8_0": dict(seed=33, matrix_type=Q.Q8_0),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("exact")
    out = {}
    for name, kw in FILES.items():
        out[name] = d / f"{name}.gguf"
        synthetic_gguf(out[name], CFG, **kw)
    out["spm"] = d / "spm.gguf"
    synthetic_gguf(out["spm"], CFG, seed=34, layer_types=every_format_layer_types(2),
                   extra_kvs=synthetic_spm_vocab(CFG.vocab_size))
    return out


def _load_both(path, mode):
    jcfg, jp, jf = jax_load(path, fast_mode=mode, fuse=True)
    cfg, pp, f = load_gguf_model(path, fast_mode=mode, fuse=True, device="cpu")
    jf.close()
    f.close()
    return jcfg, jp, cfg, pp


def _greedy(ctx, batch_cls, prompt):
    """Prefill, then N_STEPS - 1 greedy single-token steps: the greedy ids
    and the logits of every step."""
    assert ctx.decode(batch_cls.single(prompt)) == 0
    logits = [np.asarray(ctx.get_logits()[-1], np.float32)]
    toks = [int(np.argmax(logits[-1]))]
    for i in range(N_STEPS - 1):
        assert ctx.decode(batch_cls.single([toks[-1]], pos0=len(prompt) + i)) == 0
        logits.append(np.asarray(ctx.get_logits()[-1], np.float32))
        toks.append(int(np.argmax(logits[-1])))
    return toks, logits


def test_mixes():
    """The every-format mix puts each of Q5_0, Q5_1, Q2_K, Q3_K, Q5_K, Q4_0,
    Q4_1, Q8_0, Q6_K and Q4_K on some matrix of a 2-layer file, no two
    projections of a layer alike; the Q5_K_M mix is Q4_K_M's with Q5_K."""
    types = every_format_layer_types(2)
    assert {t for layer in types for t in layer.values()} == set(EVERY_FORMAT)
    assert all(len(set(layer.values())) == len(layer) for layer in types)
    more = [i for i, t in enumerate(q5_k_m_layer_types(32)) if t["ffn_down"] == Q.Q6_K]
    assert more == [0, 1, 2, 3, 6, 9, 12, 15, 18, 21, 24, 27, 28, 29, 30, 31]
    assert {t["attn_v"] for t in q5_k_m_layer_types(32)} == {Q.Q5_K, Q.Q6_K}


@pytest.mark.parametrize("name", ["q4_k_m", "every_format", "q8_0"])
def test_exact_mode_matches_jax(files, name, monkeypatch):
    """Both loaders' exact repacks are equal plane for plane (dtypes kept);
    both contexts run their default path (the mixed files unrolled, the
    Q8_0 file stacked: kernel 9 attends) and give identical greedy ids,
    logits within EXACT_TOL of max|logits|."""
    jcfg, jp, cfg, pp = _load_both(files[name], None)
    _same_tree(pp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    mats = [w for lp in pp["layers"] for w in lp.values() if hasattr(w, "codes")]
    assert mats and all(fold.is_exact(w) for w in mats)
    if name == "q4_k_m":  # layer 0's q|k|v fuses, layer 1's Q6_K wv keeps it split
        assert "wqkv_fused" in pp["layers"][0] and "wv" in pp["layers"][1]
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    prompt = np.random.default_rng(5).integers(0, CFG.vocab_size, N_PROMPT).astype(np.int32)
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS)
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu")
    assert ("layers_stacked" in pctx.params) == (name == "q8_0")
    jt, jl = _greedy(jctx, JaxBatch, prompt)
    pt, pl = _greedy(pctx, Batch, prompt)
    assert pt == jt and len(set(jt)) > 1
    for a, b in zip(pl, jl):
        assert np.abs(a - b).max() <= EXACT_TOL * np.abs(b).max()


@pytest.mark.parametrize("mode", ["w4", "w4x", "int8"])
def test_new_formats_fast_modes_match_jax(files, mode, monkeypatch):
    """The every-format file in the fast modes: equal folds, and the port's
    context on JAX's greedy tokens (teacher-forced) within FAST_TOL, its
    greedy token JAX's wherever the top-2 gap exceeds twice that."""
    jcfg, jp, cfg, pp = _load_both(files["every_format"], mode)
    _same_tree(pp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    prompt = np.random.default_rng(6).integers(0, CFG.vocab_size, N_PROMPT).astype(np.int32)
    jt, jl = _greedy(JaxContext(jcfg, jp, n_cells=N_CELLS), JaxBatch, prompt)
    pl = _forced_steps(LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu"), prompt, jt)
    for tok, a, b in zip(jt, pl, jl):
        top = np.abs(b).max()
        assert np.abs(a - b).max() <= FAST_TOL * top
        s = np.sort(b)
        if s[-1] - s[-2] > 2 * FAST_TOL * top:
            assert int(np.argmax(a)) == tok
    assert len(set(jt)) > 1


def test_cli_default_mode_matches_jax(files):
    """tools/main.py with no --fast-mode (the exact-dequant mode) on the CPU
    prints the text JAX's CLI prints at --temp 0 on the same file."""
    argv = ["-m", str(files["spm"]), "-p", "the quick brown fox", "-n", "8", "--temp", "0",
            "-c", "256"]
    out = []
    for fn, extra in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            fn(argv + extra)
        out.append(buf.getvalue())
    assert out[1] == out[0] and out[0].startswith("the quick brown fox")
    assert len(out[0]) > len("the quick brown fox") + 4
