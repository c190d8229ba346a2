"""Kernel 3's MLA branch (deepseek2's multi-head latent attention: K rows
192 wide, V rows 128) on the CPU: its plain version against JAX's
flash_attention in interpret mode on the bf16, int8 and packed int4
caches; the torch emulation of the tile's arithmetic (tests/
test_torch_flash_mma.py) at (192, 128) against both; the wrapper's launch
arguments (V's width, the DV-wide scratch) and its refusal of every other
(K, V) pair.  The CUDA kernel itself is held against the plain version on
the card by chip_smoke.py."""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.ops.pallas.flash import flash_attention as jax_flash

from llama_kotlin_tpu_torch.ops.cuda import flash

from test_torch_flash_mma import _flash_mma_emulation, _mask
from test_torch_qmm_plan import _rel_err

KV = H = 4  # MHA, as DeepSeek-V2-Lite (16 q and 16 kv heads): rep = 1
DK, DV = 192, 128
NT, CELLS, N_VIS = 24, 384, 256
SCALE = 0.1147  # DeepSeek-V2-Lite's mscale^2 / sqrt(192)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tests' small CPU ops: more only
    multiplies their CPU time when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cache(rng, kind: str):
    """(k, v, k_scale, v_scale, kv_bits): K [KV, CELLS, 192] and V [KV,
    CELLS, 128] as bf16 values, int8 codes or packed int4 codes (every byte
    value), with f32 row scales for the quantized ones."""
    if kind == "bf16":
        k, v = (torch.from_numpy(rng.standard_normal((KV, CELLS, d)).astype(np.float32))
                .to(torch.bfloat16) for d in (DK, DV))
        return k, v, None, None, 8
    if kind == "int8":
        k, v = (torch.from_numpy(rng.integers(-127, 128, (KV, CELLS, d)).astype(np.int8))
                for d in (DK, DV))
    else:
        k, v = (torch.from_numpy(rng.integers(0, 256, (KV, CELLS, d // 2)).astype(np.uint8))
                for d in (DK, DV))
    ks, vs = (torch.from_numpy((rng.random((KV, CELLS)) * 0.05 + 0.01).astype(np.float32))
              for _ in range(2))
    return k, v, ks, vs, 4 if kind == "int4" else 8


def _jax(t):
    if t is None:
        return None
    return jnp.asarray(t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 else t.numpy())


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_mla_plain_and_tile_match_jax(kind):
    """At (K, V) = (192, 128), on each cache: the plain version (the port's
    CPU route, bf16 output) within 5e-3 of max|out| of JAX's
    flash_attention (interpret: its MLA case, flash.py:185-193), since
    both are f32 masked softmaxes whose sums differ only in order and one
    bf16 rounding is up to 2^-9 of max|out|; the tile's emulation (f32,
    before that rounding) within 1e-4 of JAX's (exact products, P as p_hi
    + p_lo, f32 order only) and 5e-3 of the plain version, with the
    wrapper's split count and with one split.  A fully masked row is
    exactly 0."""
    k, v, ks, vs, bits = _cache(np.random.default_rng(60), kind)
    q = torch.from_numpy(np.random.default_rng(61).standard_normal((NT, H, DK))
                         .astype(np.float32)).to(torch.bfloat16)
    mask = _mask(NT, N_VIS)
    kw = dict(scale=SCALE, softcap=0.0, k_scale=ks, v_scale=vs, kv_bits=bits)
    plain = flash.flash_attention(q, k, v, torch.from_numpy(mask), scale=SCALE, k_scale=ks,
                                  v_scale=vs, kv_bits=bits)
    plain = plain.to(torch.float32)
    assert plain.shape == (NT, H, DV) and not plain[5].any()
    ref = np.asarray(jax_flash(_jax(q), _jax(k), _jax(v), jnp.asarray(mask), scale=SCALE,
                               k_scale=_jax(ks), v_scale=_jax(vs), kv_bits=bits,
                               interpret=True))
    assert ref.shape == (NT, H, DV)
    assert _rel_err(plain, ref) <= 5e-3
    nsplit = flash.n_splits(KV, NT, N_VIS, flash.ROW_TILE)
    for splits in (nsplit, 1):
        got = _flash_mma_emulation(q, k, v, mask, nsplit=splits, **kw)
        assert got.shape == (NT, H, DV) and not got[5].any()
        assert _rel_err(got, plain) <= 5e-3
        assert _rel_err(got, ref) <= 1e-4


def test_mla_launch_arguments(monkeypatch):
    """One lk_flash launch with K's width D = 192 and V's Dv = 128 (the last
    argument before the stream), a [nsplit, KV * rows, 128] scratch, an
    output 128 wide, and LAUNCHES_MLA counting it; every (K, V) pair kernel
    3 does not take raises on the card before the entry."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            assert name == "lk_flash", name
            return lambda *args: calls.append(args[:-1]) or 0

    monkeypatch.setattr(flash, "is_cuda", lambda t: True)
    monkeypatch.setattr(flash._build, "lib", Lib)
    monkeypatch.setattr(flash._build, "stream", lambda: 0)
    shapes = []
    real_empty = torch.empty

    def recording_empty(*a, **kw):
        t = real_empty(*a, **{k: v for k, v in kw.items() if k != "device"})
        shapes.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    cache_ok = flash.check_cache
    monkeypatch.setattr(flash, "check_cache", lambda *a, **kw: None)
    k, v, ks, vs, bits = _cache(np.random.default_rng(62), "bf16")
    q = torch.zeros((1, H, DK), dtype=torch.bfloat16)
    before = flash.LAUNCHES_MLA
    out = flash.flash_attention(q, k[None], v[None], torch.ones((1, N_VIS), dtype=torch.int8),
                                scale=SCALE, layer=0)
    assert out.shape == (1, H, DV) and flash.LAUNCHES_MLA == before + 1
    (c,) = calls
    assert (c[12], c[21]) == (DK, DV)
    nsplit = flash.n_splits(KV, 1, N_VIS, flash.ROW_TILE)
    assert (nsplit, KV, DV) in shapes
    monkeypatch.setattr(flash, "check_cache", cache_ok)
    for dk, dv in ((192, 192), (256, 128), (128, 64), (192, 64)):
        qq = torch.zeros((1, H, dk), dtype=torch.bfloat16)
        kk = torch.zeros((1, KV, 64, dk), dtype=torch.bfloat16)
        vv = torch.zeros((1, KV, 64, dv), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dims"):
            flash.check_cache(qq, kk, vv, 64, 0, None, None, pairs=flash.DIM_PAIRS)
    kk = torch.zeros((1, KV, 64, DK), dtype=torch.bfloat16)
    vv = torch.zeros((1, KV, 64, DV), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):  # kernel 9 takes one width only
        flash.check_cache(torch.zeros((1, H, DK), dtype=torch.bfloat16), kk, vv, 64, 0, None,
                          None)
