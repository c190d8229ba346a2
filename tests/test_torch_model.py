"""Port parity end to end: the llama W4A8 serving path (prefill through
LlamaContext.decode, then greedy decode) of the JAX package and of the
port on the CPU, on identical weights; plus the port's import and device
rules."""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.models.config import ModelConfig as JaxConfig
from llama_kotlin_tpu.models.synthetic import synthetic_params_device as jax_params
from llama_kotlin_tpu.ops.norms import rms_norm as jax_rms_norm
from llama_kotlin_tpu.ops.rope import RopeParams as JaxRope, apply_rope as jax_rope
from llama_kotlin_tpu.quant.formats import GGMLQuantType
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext
from llama_kotlin_tpu.runtime.kv_cache import CellMetadata as JaxCellMetadata

from llama_kotlin_tpu_torch.convert import params_from_numpy
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import (preset_config, synthetic_gguf,
                                                     synthetic_params_device)
from llama_kotlin_tpu_torch.ops.norms import rms_norm
from llama_kotlin_tpu_torch.ops.rope import RopeParams, apply_rope
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext
from llama_kotlin_tpu_torch.runtime.kv_cache import CellMetadata, KVCache
from llama_kotlin_tpu_torch.runtime.generate import generate

# the configuration of tests/test_layer_fused.py's model parity test
CFG = dict(arch="llama", vocab_size=512, n_embd=2048, n_layer=2, n_head=16,
           n_head_kv=8, n_ff=2048)
N_PROMPT, N_STEPS, N_CELLS = 12, 8, 512


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**CFG)
    jp = jax_params(jcfg, GGMLQuantType.Q4_K, fast_w4a8=True, fuse=True)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, ModelConfig(**CFG), pp


def _steps(ctx, batch_cls, prompt):
    """Prefill, then N_STEPS greedy single-token decodes; the logits of
    every step and the greedy tokens."""
    assert ctx.decode(batch_cls.single(prompt)) == 0
    logits = [np.asarray(ctx.get_logits()[-1], np.float32)]
    toks = [int(np.argmax(logits[-1]))]
    for i in range(N_STEPS - 1):
        assert ctx.decode(batch_cls.single([toks[-1]], pos0=N_PROMPT + i)) == 0
        logits.append(np.asarray(ctx.get_logits()[-1], np.float32))
        toks.append(int(np.argmax(logits[-1])))
    return toks, logits


def test_serving_path_matches_jax(models, monkeypatch):
    """Prefill of 12 tokens (kernel 1 rows, flash over 512 cells) and 8
    greedy steps (kernels 1-3) through both LlamaContexts.  Greedy tokens
    must be identical.  Logits: 1e-2 of max|logits|.  The bf16 residual
    stream and the bf16 h of the FFN round the same values on both sides,
    but f32 reduction order can flip a last bit before a rounding, and the
    int8 re-quantization of the next matmul carries that one step on;
    over 2 layers that stays at the bf16-resolution level the JAX
    package's own fused/unfused parity test allows (2e-2)."""
    jcfg, jp, cfg, pp = models
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    prompt = np.random.default_rng(7).integers(0, CFG["vocab_size"], N_PROMPT).astype(np.int32)
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS, prefer_unrolled=True)
    jt, jl = _steps(jctx, JaxBatch, prompt)
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, prefer_unrolled=True, device="cpu")
    pt, pl = _steps(pctx, Batch, prompt)
    assert pt == jt
    for a, b in zip(pl, jl):
        assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max()
    # the port's device-loop generate reproduces its step-wise tokens
    pctx.clear()
    assert generate(pctx, prompt, N_STEPS) == pt


@pytest.mark.parametrize("rope_type", [0, 2])  # NORM, NEOX
def test_rope_and_norm_match_jax(rope_type):
    """The glue ops around the kernels: rope (both rotation modes) and
    RMSNorm in f32 agree with the JAX ops to f32 rounding (1e-5 relative:
    the JAX side raises theta_scale to the pair index in its own pow)."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((6, 4, 128)).astype(np.float32)
    pos = np.array([0, 1, 5, 77, 300, 4095], np.int32)
    ref = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos),
                              JaxRope(n_rot=128, rope_type=rope_type)))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                     RopeParams(n_rot=128, rope_type=rope_type)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    w = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    ref = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_cell_metadata_matches_jax():
    """The host slot allocator and sequence ops (find_slots, commit,
    seq_cp, seq_rm, clear) leave the same cells, positions and sequence
    bitmasks as the JAX package's, exactly (both are integer numpy)."""
    ours, ref = CellMetadata(64, max_seqs=4), JaxCellMetadata(64, max_seqs=4)

    def same():
        np.testing.assert_array_equal(ours.pos, ref.pos)
        np.testing.assert_array_equal(ours.seq, ref.seq)
        assert ours.used_span() == ref.used_span()

    for n, pos0, sid in ((10, 0, 0), (5, 0, 1), (7, 10, 0)):
        a, b = ours.find_slots(n), ref.find_slots(n)
        np.testing.assert_array_equal(a, b)
        for m in (ours, ref):
            m.commit(a, np.arange(pos0, pos0 + n, dtype=np.int32), np.full(n, sid, np.int32))
        same()
    for op, args in (("seq_cp", (0, 2, 3, 12)), ("seq_rm", (0, 5, -1)), ("seq_rm", (1, 0, -1)),
                     ("seq_rm", (-1, 0, 2))):
        getattr(ours, op)(*args)
        getattr(ref, op)(*args)
        same()
    assert ours.seq_pos_max(2) == ref.seq_pos_max(2)
    np.testing.assert_array_equal(ours.find_slots(60) is None, ref.find_slots(60) is None)
    ours.clear()
    ref.clear()
    same()


def test_port_imports_no_jax():
    """Importing the port and running a CPU forward (also on a q4_0 cache,
    after a seq_add) leaves neither jax nor the JAX package in
    sys.modules."""
    code = textwrap.dedent("""
        import sys, tempfile, os
        import numpy as np
        from llama_kotlin_tpu_torch.models.synthetic import (preset_config, synthetic_gguf,
                                                             synthetic_params_device)
        from llama_kotlin_tpu_torch.models.loader import load_gguf_model
        from llama_kotlin_tpu_torch.runtime.context import LlamaContext
        from llama_kotlin_tpu_torch.runtime.batch import Batch
        cfg = preset_config("test-tiny", n_layer=1)
        params = synthetic_params_device(cfg, device="cpu")
        ctx = LlamaContext(cfg, params, n_cells=128, device="cpu")
        assert ctx.decode(Batch.single(np.arange(5, dtype=np.int32))) == 0
        assert np.isfinite(ctx.get_logits()).all()
        ctx = LlamaContext(cfg, params, n_cells=128, kv_quant="q4_0", device="cpu")
        assert ctx.decode(Batch.single(np.arange(5, dtype=np.int32))) == 0
        ctx.seq_add(0, 2, -1, 3)
        assert ctx.decode(Batch.single([7], pos0=8)) == 0
        assert np.isfinite(ctx.get_logits()).all()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "m.gguf")
            synthetic_gguf(path, cfg, seed=1)
            for mode in ("w4", "w4x", "int8"):
                gcfg, params, f = load_gguf_model(path, fast_mode=mode, fuse=True,
                                                  device="cpu")
                ctx = LlamaContext(gcfg, params, n_cells=128, device="cpu")
                assert ctx.decode(Batch.single(np.arange(5, dtype=np.int32))) == 0
                assert np.isfinite(ctx.get_logits()).all()
                del params, ctx
                f.close()
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "llama_kotlin_tpu."))
               or m == "llama_kotlin_tpu"]
        assert not bad, bad
    """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def test_port_sources_import_no_jax():
    """No module of the port, and not chip_smoke.py, names jax or the JAX
    package in an import statement (also imports inside functions, which
    the subprocess test above does not reach)."""
    root = Path(__file__).resolve().parents[1]
    pkg = root / "llama_kotlin_tpu_torch"
    # _build/ holds build outputs (gitignored), not the port's sources
    files = sorted(p for p in pkg.rglob("*.py")
                   if "_build" not in p.relative_to(pkg).parts) + [root / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "llama_kotlin_tpu"), (path, name)


def test_entry_points_need_cuda_or_cpu(monkeypatch, tmp_path):
    """Without CUDA an entry point called without device= raises; it never
    runs on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = preset_config("test-tiny", n_layer=1)
    synthetic_gguf(tmp_path / "m.gguf", cfg, seed=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_gguf_model(tmp_path / "m.gguf", fast_mode="w4")
    gcfg, gparams, f = load_gguf_model(tmp_path / "m.gguf", fast_mode="int8", device="cpu")
    assert gparams["output"].codes.device.type == "cpu"
    f.close()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic_params_device(cfg)
    params = synthetic_params_device(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaContext(cfg, params, n_cells=128)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KVCache.create(1, 128, cfg.n_head_kv, cfg.head_dim)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CellMetadata(128).device_view(128)
    assert KVCache.create(1, 128, cfg.n_head_kv, cfg.head_dim, device="cpu").k.device.type == "cpu"
    assert CellMetadata(128).device_view(128, "cpu")[0].device.type == "cpu"
