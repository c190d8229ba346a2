"""Falcon-7B and StarCoder-15.5B on the port against the JAX package: the
config of each preset (the metadata synthetic_gguf writes, field for
field), the kernel each of Falcon-7B's full-width projections routes to in
the w4 mode against JAX's dispatch (its fused qkv, o and down rows are no
multiple of 128, so both packages take kernel 4 at a decode row), kernel
4's exact branch and the W8 fold at K = 4544 (Q5_0 and Q8_0, llama.cpp's
fallback where K is no multiple of 256) against JAX's, and kernel 3's plain
version at Falcon-7B's 71 query heads on one kv head against JAX's kernel
in interpret mode, with the 64-row tile emulated (one token's 71 rows
straddle two row blocks)."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.models.config import config_from_metadata as jax_config
from llama_kotlin_tpu.ops.pallas import qmm_w8 as jax_w8_mod
from llama_kotlin_tpu.ops.pallas.flash import flash_attention as jax_flash
from llama_kotlin_tpu.ops.pallas.qmm import qmm as jax_qmm
from llama_kotlin_tpu.quant import fold as jax_fold

from llama_kotlin_tpu_torch.models.config import config_from_metadata
from llama_kotlin_tpu_torch.models.synthetic import (_fallback_type, falcon_7b, file_metadata,
                                                     starcoder_15b)
from llama_kotlin_tpu_torch.ops import qmatmul as port_qmatmul
from llama_kotlin_tpu_torch.ops.cuda import flash
from llama_kotlin_tpu_torch.quant import fold
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q

from test_torch_flash_mma import _flash_mma_emulation
from test_torch_gemma import JAX_SITE_KERNEL, _both, _jax_site, _port_kernel
from test_torch_qmm_exact import both as exact_both
from test_torch_qmm_plan import _rel_err
from test_torch_qwen2 import CFG_FIELDS, _jax


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests' torch ops are many and small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


E, F, V = 4544, 18176, 65024  # Falcon-7B's widths
FIELDS = CFG_FIELDS + ("learned_pos_embd", "act")


@pytest.mark.parametrize("build", [falcon_7b, starcoder_15b])
def test_presets_match_jax(build):
    """falcon_7b() and starcoder_15b() are the configs JAX's
    config_from_metadata gives the metadata synthetic_gguf writes for them,
    field for field (the f32 epsilons within an f32 ulp), rope parameters
    included: Falcon-7B NEOX-roped and parallel, 71 heads on one; StarCoder
    learned positions and no rope, 48 heads on one, 8192 positions."""
    built = build()
    meta = dict(file_metadata(built))
    ours, ref = config_from_metadata(meta), jax_config(meta)
    for f in FIELDS:
        assert getattr(ours, f) == pytest.approx(getattr(ref, f), rel=1e-7), f
        assert getattr(built, f) == pytest.approx(getattr(ref, f), rel=1e-7), f
    assert vars(ours.rope_params()) == vars(ref.rope_params())
    if built.arch == "falcon":
        assert (ours.n_head, ours.n_head_kv, ours.head_dim) == (71, 1, 64)
        assert ours.parallel_residual and not ours.use_rms_norm and not ours.ffn_gated
    else:
        assert (ours.n_head, ours.n_head_kv, ours.head_dim, ours.n_ctx_train) == (48, 1, 128,
                                                                                  8192)
        assert ours.learned_pos_embd and ours.max_alibi_bias == 0


def test_w4_decode_routes_as_jax(monkeypatch):
    """Falcon-7B's matrices at full width in the w4 mode, as a Q4_K_M file
    carries them: the fused qkv [4672, 4544], o [4544, 4544] and up [18176,
    4544] on llama.cpp's Q5_0 fallback (K = 4544, W8 folds), down [4544,
    18176] as Q4_K (a compact W4 fold) and as Q6_K (W8).  At one decode row
    and at a 64-row prefill the port launches the kernel that serves the
    site JAX's dispatch reaches in interpret mode (every site a recorder,
    so nothing runs): kernel 4 for qkv, o and both downs at one row (no
    block of 512, 256 or 128 divides 4672 or 4544: JAX's _plan declines
    them), kernel 5 for up, kernel 4 for all at 64 rows.  The lm_head (Q8_0
    at the fallback, [65024, 4544]) by the rule both apply: JAX's kernel-5
    plan takes its rows at a decode row, and so does the port's qmatmul."""
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("LKTPU_W4_FX", raising=False)
    q5 = _fallback_type(Q.Q4_K, E)
    assert (q5, _fallback_type(Q.Q6_K, E), _fallback_type(Q.Q4_K, F)) == (Q.Q5_0, Q.Q8_0,
                                                                           Q.Q4_K)
    mats = {"qkv": (q5, E + 2 * 64, E, "kernel 4"), "o": (q5, E, E, "kernel 4"),
            "up": (q5, F, E, "kernel 5"), "down": (Q.Q4_K, E, F, "kernel 4"),
            "down q6_K": (Q.Q6_K, E, F, "kernel 4")}
    for i, (name, (qtype, n, k, decode)) in enumerate(mats.items()):
        jw, pw = _both(qtype, n, k, seed=50 + i)
        assert pw.flavor == ("compact" if qtype == Q.Q4_K else "w8"), name
        for rows, want in ((1, decode), (64, "kernel 4")):
            x = np.zeros((rows, k), np.float32)
            with monkeypatch.context() as m:
                site = _jax_site(m, x, jw)
            with monkeypatch.context() as m:
                got = _port_kernel(m, x, pw)
            assert JAX_SITE_KERNEL[site] == got == want, (name, rows, site, got)
        del jw, pw
    k_pad, ng = 4608, jax_w8_mod.CHUNK // 32  # the W8 fold pads K to 512s
    assert jax_w8_mod._plan(V, k_pad, ng, 1) is not None
    assert port_qmatmul._decode(torch.zeros((1, E)), SimpleNamespace(shape=(V, E)))
    for n in (E + 128, E):
        assert jax_w8_mod._plan(n, k_pad, ng, 1) is None
        assert not port_qmatmul._decode(torch.zeros((1, E)), SimpleNamespace(shape=(n, E)))


@pytest.mark.parametrize("name", ["Q5_0", "Q8_0"])
def test_k4544_exact_branch_and_w8_fold_match_jax(name):
    """K = 4544 (142 groups of 32, 17.75 superblocks) on the two fallback
    formats: the exact repack pads K to 4608 in both packages, kernel 4's
    exact plain version matches JAX's Pallas qmm (interpret) at 1 and 9
    rows within 1e-5 of max|y| (f32 order only), and the W8 fold pads to
    4608 (a multiple of 512) with every plane bit for bit JAX's."""
    n = 128
    jw, pw = exact_both(name, seed=31, n=n, k=E)
    assert pw.k_pad == 4608 and fold.is_exact(pw)
    for b in (1, 9):
        x = (np.random.default_rng(b).standard_normal((b, E)) * 0.7).astype(np.float32)
        ref = np.asarray(jax_qmm(jnp.asarray(x), jw, interpret=True))
        got = port_qmatmul.qmatmul(torch.from_numpy(x), pw).numpy()
        assert got.shape == (b, n) and _rel_err(got, ref) <= 1e-5
    jf, pf = jax_fold.fold_to_w8(jw), fold.fold_to_w8(pw)
    assert pf.codes.shape == (n, 4608) and pf.flavor == "w8"
    np.testing.assert_array_equal(pf.codes.numpy(), np.asarray(jf.codes).view(np.int8))
    np.testing.assert_array_equal(pf.g_scale.numpy(), np.asarray(jf.g_scale))
    if pf.g_min is not None:
        np.testing.assert_array_equal(pf.g_min.numpy(), np.asarray(jf.g_min))


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_flash_at_71_heads_on_one_matches_jax(kind):
    """Kernel 3's plain version at Falcon-7B's 71 query heads on one kv
    head (head dim 64) over 256 cells (JAX's kernel runs: 128 divides them)
    on each cache, 6 tokens in two causal sequences with one blind row
    (426 rows: a token's 71 rows straddle the 64-row tiles' edges, block 1
    holding rows 64-70 of token 0 and 57 of token 1), against JAX's
    flash_attention in interpret mode within 5e-3 of max|out| (both f32
    masked softmaxes; one bf16 rounding is up to 2^-9 of max|out|); the
    tile's emulation within 2e-5 of JAX's (f32 order only) at the wrapper's
    split count (one token's decode plans 2 row tiles and 4 splits here,
    32 over Falcon's 2048 cells) and at one split.  The blind row is
    exactly 0."""
    H, KV, D, nt, n_vis = 71, 1, 64, 6, 256
    rng = np.random.default_rng(110 + ["bf16", "int8", "int4"].index(kind))
    if kind == "bf16":
        k, v = (torch.from_numpy(rng.standard_normal((KV, n_vis, D)).astype(np.float32))
                .to(torch.bfloat16) for _ in range(2))
        ks = vs = None
    else:
        shape, lo, hi, dt = (((KV, n_vis, D), -127, 128, np.int8) if kind == "int8"
                             else ((KV, n_vis, D // 2), 0, 256, np.uint8))
        k, v = (torch.from_numpy(rng.integers(lo, hi, shape).astype(dt)) for _ in range(2))
        ks, vs = (torch.from_numpy((rng.random((KV, n_vis)) * 0.05 + 0.01).astype(np.float32))
                  for _ in range(2))
    bits = 4 if kind == "int4" else 8
    q = torch.from_numpy(rng.standard_normal((nt, H, D)).astype(np.float32)).to(torch.bfloat16)
    mask = np.zeros((nt, n_vis), np.int8)
    for i in range(3):
        mask[i, :100 + i] = 1
        mask[3 + i, 128:128 + 70 + i] = 1
    mask[4] = 0
    plain = flash.flash_attention(q, k, v, torch.from_numpy(mask), scale=D ** -0.5,
                                  k_scale=ks, v_scale=vs, kv_bits=bits).to(torch.float32)
    assert plain.shape == (nt, H, D) and not plain[4].any()
    ref = np.asarray(jax_flash(_jax(q), _jax(k), _jax(v), jnp.asarray(mask), scale=D ** -0.5,
                               k_scale=_jax(ks), v_scale=_jax(vs), kv_bits=bits,
                               interpret=True))
    assert _rel_err(plain, ref) <= 5e-3
    assert flash.n_splits(KV, H, n_vis, flash.ROW_TILE) == 4
    assert flash.n_splits(KV, H, 2048, flash.ROW_TILE) == 32
    kw = dict(scale=D ** -0.5, softcap=0.0, k_scale=ks, v_scale=vs, kv_bits=bits)
    nsplit = flash.n_splits(KV, nt * H // KV, n_vis, flash.ROW_TILE)
    for splits in sorted({nsplit, 1}):
        got = _flash_mma_emulation(q, k, v, mask, nsplit=splits, **kw)
        assert not got[4].any() and _rel_err(got, ref) <= 2e-5
