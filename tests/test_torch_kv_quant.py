"""Port parity for the int8 KV cache: the row quantizer, kernel 3's int8
branch and kernel 9 (stacked-layer attention with the fresh rows merged).

JAX side: ``runtime/kv_cache.py`` and the Pallas kernels in interpret mode.
Port side: the plain PyTorch versions of the CUDA kernels, which CPU
tensors take.  Inputs come from numpy seeds."""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.ops.pallas.flash import flash_attention as jax_flash
from llama_kotlin_tpu.ops.pallas.flash_stacked import flash_attention_stacked as jax_stacked
from llama_kotlin_tpu.runtime.kv_cache import dequantize_cache_layer as jax_dequant
from llama_kotlin_tpu.runtime.kv_cache import quantize_rows as jax_quantize

from llama_kotlin_tpu_torch.ops.cuda.flash import flash_attention
from llama_kotlin_tpu_torch.ops.cuda.flash_stacked import flash_attention_stacked
from llama_kotlin_tpu_torch.runtime.kv_cache import (KVCache, dequantize_cache_layer,
                                                     quantize_rows)

# f32 reduction order only: both sides dequantize (or fold the scales) in
# f32 and sum in f32, as tests/test_kv_quant.py allows the Pallas kernel
TOL = 2e-5
KV, H, D = 2, 8, 128


def _rows(rng, dtype) -> np.ndarray:
    """[3, 6, 128] rows: random, a zero row, and rows whose amax is 127 so
    the scale is exactly 1 and x.5 values are exact ties."""
    x = rng.standard_normal((3, 6, D)).astype(np.float32) * 3.0
    x[0, 1] = 0.0
    ties = (np.arange(D) % 40 - 20 + 0.5).astype(np.float32)
    ties[0] = 127.0
    x[1, 2] = ties
    x[2, 3] = -ties
    x[2, 4, :] = np.float32(1e-30)  # tiny, not zero: a reciprocal near 1e32
    if dtype == "bf16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_rows_bit_equal(dtype):
    """Codes and scales equal the JAX quantizer's bit for bit, on f32 and
    bf16 inputs, zero rows and exact .5 ties (round half to even on both
    sides); the dequantized rows are equal too."""
    x = _rows(np.random.default_rng(5), dtype)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    jc, js = jax_quantize(jx)
    tc, ts = quantize_rows(tx)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (3, 6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
    assert not tc[0, 1].any() and ts[0, 1] == 0
    # the ties: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -2.5 -> -2
    ties = x[1, 2]
    got = tc[1, 2].numpy()
    for val in (0.5, 1.5, 2.5, -2.5):
        assert got[np.nonzero(ties == val)[0][0]] == np.round(val)
    np.testing.assert_array_equal(dequantize_cache_layer(tc, ts).numpy(),
                                  np.asarray(jax_dequant(jc, js)))


def _int8_cache(rng, L, cells, n_vis):
    """int8 codes [L, KV, cells, D] and f32 scales [L, KV, cells], the
    scales past n_vis NaN: the kernels must never read them."""
    codes = rng.integers(-127, 128, (L, KV, cells, D)).astype(np.int8)
    scales = (rng.random((L, KV, cells)) * 0.05 + 0.01).astype(np.float32)
    scales[:, :, n_vis:] = np.nan
    return codes, scales


def test_flash_int8_matches_jax():
    """Kernel 3's int8 plain version vs flash_attention(k_scale, v_scale,
    layer=1, interpret=True): GQA 8 heads on 2 kv heads, the whole 4D cache,
    n_vis 256 of 384 cells, one fully masked row (0, not NaN)."""
    rng = np.random.default_rng(31)
    nt, L, cells, n_vis = 8, 2, 384, 256
    q = rng.standard_normal((nt, H, D)).astype(np.float32)
    (kc, ks), (vc, vs) = _int8_cache(rng, L, cells, n_vis), _int8_cache(rng, L, cells, n_vis)
    mask = rng.random((nt, n_vis)) < 0.6
    mask[5] = False
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(mask, jnp.int8), scale=D ** -0.5,
                               k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), n_vis=n_vis,
                               layer=1, interpret=True))
    t = torch.from_numpy
    got = flash_attention(t(q), t(kc), t(vc), t(mask.astype(np.int8)), scale=D ** -0.5, layer=1,
                          k_scale=t(ks), v_scale=t(vs)).numpy()
    assert got.shape == (nt, H, D) and np.isfinite(got).all()
    assert not got[5].any()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def _stacked_inputs(rng, quantized: bool):
    nt, L, cells, n_vis = 8, 3, 384, 256
    q = rng.standard_normal((nt, H, D)).astype(np.float32)
    if quantized:
        (k, ks), (v, vs) = _int8_cache(rng, L, cells, n_vis), _int8_cache(rng, L, cells, n_vis)
    else:
        k, v = (jnp.asarray(rng.standard_normal((L, KV, cells, D)), jnp.bfloat16)
                for _ in range(2))
        k, v = (np.asarray(a.at[:, :, n_vis:].set(jnp.nan)) for a in (k, v))
        ks = vs = None
    new_k, new_v = (np.asarray(jnp.asarray(rng.standard_normal((nt, KV, D)), jnp.bfloat16))
                    for _ in range(2))
    mask_cells = rng.random((nt, n_vis)) < 0.5
    mask_cells[2] = False  # this row sees only fresh rows
    mask_new = np.tril(np.ones((nt, nt), bool))  # causal
    return q, k, v, ks, vs, new_k, new_v, mask_cells, mask_new


def _torch(a):
    if a is None:
        return None
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_flash_stacked_matches_jax(cache):
    """Kernel 9's plain version vs flash_attention_stacked(interpret=True):
    layer 1 of a 3-layer cache, GQA rep 4, 256 visible cells of 384 (the
    rest NaN: never read), a causal mask_new over 8 fresh bf16 rows, for a
    bf16 and an int8 cache."""
    rng = np.random.default_rng(41 if cache == "bf16" else 42)
    q, k, v, ks, vs, nk, nv, mc, mn = _stacked_inputs(rng, cache == "int8")
    kw = {} if ks is None else dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    ref = np.asarray(jax_stacked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1,
                                 jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(mc, jnp.int8),
                                 jnp.asarray(mn, jnp.int8), scale=D ** -0.5, interpret=True,
                                 **kw))
    got = flash_attention_stacked(
        _torch(q), _torch(k), _torch(v), 1, _torch(nk), _torch(nv),
        torch.from_numpy(mc.astype(np.int8)), torch.from_numpy(mn.astype(np.int8)),
        scale=D ** -0.5, k_scale=_torch(ks), v_scale=_torch(vs)).numpy()
    assert got.shape == (8, H, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_flash_stacked_softcap_and_empty_rows():
    """The fresh rows go through the logit softcap as the cache cells do
    (against the JAX kernel), and a row that sees nothing gives 0."""
    rng = np.random.default_rng(43)
    q, k, v, ks, vs, nk, nv, mc, mn = _stacked_inputs(rng, True)
    q = q * 8.0  # scores large enough for the softcap to bend
    mc[6] = False
    mn[6] = False
    kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    ref = np.asarray(jax_stacked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                                 jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(mc, jnp.int8),
                                 jnp.asarray(mn, jnp.int8), scale=D ** -0.5, logit_softcap=5.0,
                                 interpret=True, **kw))
    got = flash_attention_stacked(
        _torch(q), _torch(k), _torch(v), 2, _torch(nk), _torch(nv),
        torch.from_numpy(mc.astype(np.int8)), torch.from_numpy(mn.astype(np.int8)),
        scale=D ** -0.5, logit_softcap=5.0, k_scale=_torch(ks), v_scale=_torch(vs)).numpy()
    assert not got[6].any() and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_kv_cache_create():
    """q8_0 (and True) give int8 codes with zeroed f32 scale planes
    [L, KV, cells]; q4_0 packed uint8 codes [L, KV, cells, D/2] with such
    planes, as in JAX; the bf16 cache has none; another type raises."""
    for kind in (True, "q8_0"):
        c = KVCache.create(2, 65, 4, D, device="cpu", quantized=kind)
        assert c.quantized and c.kv_bits == 8 and c.k.dtype == c.v.dtype == torch.int8
        assert c.k_scale.shape == c.v_scale.shape == (2, 4, 65)
        assert c.k_scale.dtype == torch.float32 and not c.k_scale.any()
    c = KVCache.create(2, 65, 4, D, device="cpu")
    assert not c.quantized and c.k.dtype == torch.bfloat16 and c.k_scale is None
    c = KVCache.create(2, 65, 4, D, device="cpu", quantized="q4_0")
    assert c.quantized and c.kv_bits == 4 and c.k.dtype == c.v.dtype == torch.uint8
    assert c.k.shape == c.v.shape == (2, 4, 65, D // 2) and c.n_cells == 65
    assert c.k_scale.shape == c.v_scale.shape == (2, 4, 65) and not c.v_scale.any()
    with pytest.raises(ValueError):
        KVCache.create(2, 65, 4, D, device="cpu", quantized="q5_1")
