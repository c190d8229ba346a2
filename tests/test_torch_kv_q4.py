"""Port parity for the packed int4 (q4_0) KV cache: the row quantizer and
its unpacking, kernel 3's int4 branch, kernel 9's refusal of a packed
cache, and the port's q4_0 context against the JAX package's on both
paths (unrolled: kernel 3; stacked: the plain route JAX takes there).

JAX side: ``runtime/kv_cache.py`` and the Pallas kernels in interpret mode.
Port side: the plain PyTorch versions of the CUDA kernels, which CPU
tensors take.  Inputs come from numpy seeds."""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.ops.pallas.flash import flash_attention as jax_flash
from llama_kotlin_tpu.runtime.kv_cache import dequantize_cache_layer as jax_dequant
from llama_kotlin_tpu.runtime.kv_cache import quantize_rows_q4 as jax_quantize_q4
from llama_kotlin_tpu.runtime.kv_cache import unpack_q4_rows as jax_unpack

from llama_kotlin_tpu_torch.ops.cuda import flash
from llama_kotlin_tpu_torch.ops.cuda.flash_stacked import flash_attention_stacked
from llama_kotlin_tpu_torch.runtime.kv_cache import (dequantize_cache_layer, quantize_rows_q4,
                                                     unpack_q4_rows)

from test_torch_stacked import gguf_models, models, slice_vs_jax  # noqa: F401 (fixtures)

# f32 reduction order only: both sides dequantize (or fold the scales) in
# f32 and sum in f32, as for the int8 branch (tests/test_torch_kv_quant.py)
TOL = 2e-5
KV, H, D = 2, 8, 128
# logit tolerance of the q4_0 contexts, relative to max|logits|, from the
# measured port-vs-JAX spread over 8 steps on both paths: the synthetic
# model's is 1.7e-4 (1e-2 is its tolerance for the other caches, in
# tests/test_torch_stacked.py); the int8-mode file's is 3.6e-2 to 5.3e-2,
# where its q8_0 cache reads 1.7e-2 to 2.8e-2 against a 4e-2 tolerance.
# That file's layer 1 already differs in 27% of its int8 cache codes (f32
# last-bit differences amplified by its zero-mean weights), and an int4 code
# flip moves a K or V element by amax/7 where an int8 one moves it by
# amax/127; 8e-2 is 1.5 times the measured spread.  The file's top-2 gaps
# on these steps reach 0.104 of max|logits|, never twice that spread, so no
# step there counts as decided (min_decided 0); its tokens still vary.
Q4_LOGIT_TOL = {"synthetic": 1e-2, "gguf-int8": 8e-2}


def _rows(rng, dtype) -> np.ndarray:
    """[3, 6, 128] rows: random, a zero row, rows whose amax is 7 (scale
    exactly 1) full of x.5 ties, and tiny rows."""
    x = rng.standard_normal((3, 6, D)).astype(np.float32) * 3.0
    x[0, 1] = 0.0
    ties = (np.arange(D) % 14 - 7 + 0.5).astype(np.float32)
    ties[0] = 7.0
    x[1, 2] = ties
    x[2, 3] = -ties
    x[2, 4, :] = np.float32(1e-30)  # tiny, not zero: a reciprocal near 1e31
    x[2, 5, ::3] = np.float32(-3e-38)
    if dtype == "bf16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_rows_q4_bit_equal(dtype):
    """Packed bytes and scales equal the JAX quantizer's bit for bit, on f32
    and bf16 rows, a zero row, exact .5 ties (half to even on both sides)
    and tiny rows; byte j holds dim j as code + 8 in the low nibble and dim
    j + 64 as a two's-complement code in the high one."""
    x = _rows(np.random.default_rng(6), dtype)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    jc, js = jax_quantize_q4(jx)
    tc, ts = quantize_rows_q4(tx)
    assert tc.dtype == torch.uint8 and tc.shape == (3, 6, D // 2)
    assert ts.dtype == torch.float32 and ts.shape == (3, 6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
    assert (tc[0, 1] == 0x08).all() and ts[0, 1] == 0  # code 0 in both nibbles
    codes = unpack_q4_rows(tc).numpy()
    assert np.abs(codes).max() <= 7
    # the ties: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -2.5 -> -2, -6.5 -> -6
    for val in (0.5, 1.5, 2.5, -2.5, -6.5):
        assert codes[1, 2][np.nonzero(x[1, 2] == val)[0][0]] == np.round(val)
    b = tc[1, 2].numpy().astype(np.int32)
    np.testing.assert_array_equal(b & 0x0F, codes[1, 2, :D // 2] + 8)
    np.testing.assert_array_equal(((b >> 4) ^ 8) - 8, codes[1, 2, D // 2:])


def test_unpack_and_dequantize_exact():
    """unpack_q4_rows and dequantize_cache_layer(bits=4) equal JAX's exactly
    on every byte value (low nibble 0 is code -8, which the quantizer never
    writes but the cache layout holds), in f32 and in bf16."""
    rng = np.random.default_rng(8)
    packed = rng.integers(0, 256, (KV, 300, D // 2)).astype(np.uint8)
    packed[0, :4] = np.arange(256, dtype=np.uint8).reshape(4, D // 2)
    scale = (rng.random((KV, 300)) * 0.1).astype(np.float32)
    got = unpack_q4_rows(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_unpack(jnp.asarray(packed))))
    assert got.min() == -8 and got.max() == 7
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        g = dequantize_cache_layer(torch.from_numpy(packed), torch.from_numpy(scale), tdt, bits=4)
        r = jax_dequant(jnp.asarray(packed), jnp.asarray(scale), jdt, bits=4)
        np.testing.assert_array_equal(g.to(torch.float32).numpy(),
                                      np.asarray(r.astype(jnp.float32)))


def _q4_cache(rng, lead: tuple, cells: int, n_vis: int):
    """Packed codes [*lead, cells, 64] (every byte value) and f32 scales
    [*lead, cells], the scales past n_vis NaN: the kernels must never read
    them."""
    codes = rng.integers(0, 256, (*lead, cells, D // 2)).astype(np.uint8)
    scales = (rng.random((*lead, cells)) * 0.1 + 0.02).astype(np.float32)
    scales[..., n_vis:] = np.nan
    return codes, scales


@pytest.mark.parametrize("layered", [False, True], ids=["3d", "4d-layer"])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_flash_int4_matches_jax(layered, softcap):
    """Kernel 3's int4 plain version vs flash_attention(kv_bits=4,
    interpret=True): GQA 8 heads on 2 kv heads, n_vis 256 of 384 cells, a
    fully masked row (0, not NaN); a [KV, cells, 64] cache, or layer 1 of
    a whole [2, KV, cells, 64] one; with and without a logit softcap."""
    rng = np.random.default_rng(51 + int(layered) + int(softcap))
    nt, cells, n_vis = 8, 384, 256
    lead = (2, KV) if layered else (KV,)
    q = rng.standard_normal((nt, H, D)).astype(np.float32) * (4.0 if softcap else 1.0)
    (kc, ks), (vc, vs) = _q4_cache(rng, lead, cells, n_vis), _q4_cache(rng, lead, cells, n_vis)
    mask = rng.random((nt, n_vis)) < 0.6
    mask[5] = False
    layer = 1 if layered else None
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(mask, jnp.int8), scale=D ** -0.5,
                               logit_softcap=softcap, k_scale=jnp.asarray(ks),
                               v_scale=jnp.asarray(vs), n_vis=n_vis, kv_bits=4, layer=layer,
                               interpret=True))
    t = torch.from_numpy
    got = flash.flash_attention(t(q), t(kc), t(vc), t(mask.astype(np.int8)), scale=D ** -0.5,
                                logit_softcap=softcap, layer=layer, k_scale=t(ks),
                                v_scale=t(vs), kv_bits=4).numpy()
    assert got.shape == (nt, H, D) and np.isfinite(got).all()
    assert not got[5].any()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_flash_int4_wrapper_rules():
    """The wrapper refuses a packed cache without scales, a packed cache
    given as 8-bit (wrong head dim) and an unknown bit width."""
    rng = np.random.default_rng(55)
    kc, ks = (torch.from_numpy(a) for a in _q4_cache(rng, (KV,), 128, 128))
    q = torch.zeros((1, H, D))
    mask = torch.ones((1, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="scales"):
        flash.flash_attention(q, kc, kc, mask, scale=1.0, kv_bits=4)
    with pytest.raises(ValueError, match="head dims"):
        flash.flash_attention(q, kc, kc, mask, scale=1.0, k_scale=ks, v_scale=ks)
    with pytest.raises(ValueError, match="kv_bits"):
        flash.flash_attention(q, kc, kc, mask, scale=1.0, k_scale=ks, v_scale=ks, kv_bits=2)


def test_flash_stacked_refuses_packed_cache():
    """Kernel 9 takes bf16 and int8 caches only, as in JAX (its stacked
    path declines the kernel for q4 caches): a packed cache raises, on the
    CPU too, naming the route that serves it."""
    rng = np.random.default_rng(56)
    (kc, ks), (vc, vs) = (tuple(torch.from_numpy(a) for a in _q4_cache(rng, (3, KV), 384, 256))
                          for _ in range(2))
    nt = 4
    q = torch.zeros((nt, H, D), dtype=torch.bfloat16)
    new = torch.zeros((nt, KV, D), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="attend_stacked_plain"):
        flash_attention_stacked(q, kc, vc, 1, new, new, torch.ones((nt, 256), dtype=torch.int8),
                                torch.ones((nt, nt), dtype=torch.int8), scale=D ** -0.5,
                                k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("model", list(Q4_LOGIT_TOL))
@pytest.mark.parametrize("prefer_unrolled", [True, False], ids=["unrolled", "stacked"])
def test_q4_context_matches_jax(models, gguf_models, model, prefer_unrolled,  # noqa: F811
                                monkeypatch):
    """A 12-token prefill and 8 greedy steps through the JAX LlamaContext and
    the port's, both with kv_quant="q4_0" (test_torch_stacked.py's
    comparison): unrolled, kernel 3's int4 route on each side; stacked
    (both contexts stack these models), the plain route JAX takes there.
    The packed cache's codes after the prefill differ by at most one code
    step (2.8e-4 to 2e-2 of them do: values near a rounding boundary) and
    its scales by 1e-3 relative; logits within Q4_LOGIT_TOL, with equal
    greedy tokens wherever the top-2 gap exceeds twice that."""
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    pair = models if model == "synthetic" else gguf_models["int8"]
    slice_vs_jax(pair, model, prefer_unrolled, "q4_0", Q4_LOGIT_TOL[model], min_decided=0)
