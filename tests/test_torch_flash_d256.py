"""Kernel 3's D = 256 branch (Gemma's head dim) on the CPU: its plain
version and the torch emulation of the tile's arithmetic (tests/
test_torch_flash_mma.py) against JAX's flash_attention in interpret mode on
the bf16, int8 and packed int4 caches, at GQA rep 2 (gemma-2-9b's 16 heads
on 8) and rep 1 (gemma-7b's MHA), with gemma2's softcap of 50 and a
sliding-window mask; a ragged n_vis against JAX's reference route (its
kernel declines n_vis that 128 does not divide); the wrapper's launch
arguments and its refusals of the other (K, V) pairs, and kernel 9's of
head dim 256 (JAX's declines it too).  The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py."""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.ops.attention import attention as jax_attention
from llama_kotlin_tpu.ops.pallas.flash import flash_attention as jax_flash

from llama_kotlin_tpu_torch.ops.cuda import flash, flash_stacked

from test_torch_flash_mma import _flash_mma_emulation, _mask
from test_torch_qmm_plan import _rel_err

KV, D = 2, 256
NT, CELLS = 24, 384
SCALE = D ** -0.5  # gemma-2-9b: query_pre_attn_scalar 256 = head_dim
WINDOW = 40  # cells: below the 53-64 a sequence of _mask sees, so it bites
# the tile's emulation against JAX, of max|out|: exact products, P as p_hi +
# p_lo, f32 order only, test_torch_kv_quant.py's bound (measured 1.8-3.9e-6)
TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tests' small CPU ops: more only
    multiplies their CPU time when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cache(rng, kind: str):
    """(k, v, k_scale, v_scale, kv_bits) of a [KV, CELLS, 256] cache: bf16
    values, int8 codes or packed int4 codes (every byte value), with f32
    row scales for the quantized ones."""
    if kind == "bf16":
        k, v = (torch.from_numpy(rng.standard_normal((KV, CELLS, D)).astype(np.float32))
                .to(torch.bfloat16) for _ in range(2))
        return k, v, None, None, 8
    if kind == "int8":
        k, v = (torch.from_numpy(rng.integers(-127, 128, (KV, CELLS, D)).astype(np.int8))
                for _ in range(2))
    else:
        k, v = (torch.from_numpy(rng.integers(0, 256, (KV, CELLS, D // 2)).astype(np.uint8))
                for _ in range(2))
    ks, vs = (torch.from_numpy((rng.random((KV, CELLS)) * 0.05 + 0.01).astype(np.float32))
              for _ in range(2))
    return k, v, ks, vs, 4 if kind == "int4" else 8


def _window_mask(n_vis: int) -> np.ndarray:
    """_mask's two causal sequences (token i of each at position 52 + i
    after its first cell, token 5 blind) under a sliding window of WINDOW
    cells: a token sees the cells fewer than WINDOW positions back, so the
    first tile of each sequence turns dead for its last tokens."""
    m = _mask(NT, n_vis)
    for i in range(12):
        for base, row in ((0, i), (128, 12 + i)):
            m[row, base:base + 52 + i - WINDOW + 1] = 0
    return m


def _jax(t):
    if t is None:
        return None
    return jnp.asarray(t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 else t.numpy())


# (cache, heads, softcap, window): every cache on both GQA ratios, gemma2's
# softcap and the window each on every cache
CASES = [("bf16", 4, 50.0, True), ("bf16", 2, 0.0, False), ("int8", 4, 0.0, False),
         ("int8", 2, 50.0, True), ("int4", 4, 50.0, True), ("int4", 2, 0.0, False)]


@pytest.mark.parametrize("kind,heads,softcap,window", CASES)
def test_d256_plain_and_tile_match_jax(kind, heads, softcap, window):
    """At D = 256 over n_vis = 256 (JAX's kernel runs: 128 divides it), on
    each cache: the plain version (the port's CPU route, bf16 output)
    within 5e-3 of max|out| of JAX's flash_attention (interpret), since
    both are f32 masked softmaxes whose sums differ only in order and one
    bf16 rounding is up to 2^-9 of max|out| (measured 2.0-3.0e-3); the
    tile's emulation (f32, before that rounding) within TOL of JAX's and
    5e-3 of the plain version, with the wrapper's split count and with one
    split.  A fully masked row is exactly 0."""
    n_vis = 256
    rng = np.random.default_rng(80 + CASES.index((kind, heads, softcap, window)))
    k, v, ks, vs, bits = _cache(rng, kind)
    q = torch.from_numpy(rng.standard_normal((NT, heads, D)).astype(np.float32)
                         ).to(torch.bfloat16)
    mask = _window_mask(n_vis) if window else _mask(NT, n_vis)
    plain = flash.flash_attention(q, k, v, torch.from_numpy(mask), scale=SCALE,
                                  logit_softcap=softcap, k_scale=ks, v_scale=vs,
                                  kv_bits=bits).to(torch.float32)
    assert plain.shape == (NT, heads, D) and not plain[5].any()
    ref = np.asarray(jax_flash(_jax(q), _jax(k), _jax(v), jnp.asarray(mask), scale=SCALE,
                               logit_softcap=softcap, k_scale=_jax(ks), v_scale=_jax(vs),
                               kv_bits=bits, interpret=True))
    assert ref.shape == (NT, heads, D)
    assert _rel_err(plain, ref) <= 5e-3
    kw = dict(scale=SCALE, softcap=softcap, k_scale=ks, v_scale=vs, kv_bits=bits)
    nsplit = flash.n_splits(KV, NT * heads // KV, n_vis, flash.ROW_TILE)
    for splits in sorted({nsplit, 1}):
        got = _flash_mma_emulation(q, k, v, mask, nsplit=splits, **kw)
        assert got.shape == (NT, heads, D) and not got[5].any()
        assert _rel_err(got, plain) <= 5e-3
        assert _rel_err(got, ref) <= TOL


@pytest.mark.parametrize("kind", ["bf16", "int4"])
def test_d256_ragged_matches_jax_reference(kind):
    """n_vis = 250: JAX's kernel declines it (no 512, 256 or 128 divides
    it) and JAX attends by its reference route over the dequantized prefix;
    the plain version within 5e-3 of it and the tile's emulation (one split
    and the wrapper's, whose last tile is ragged) within TOL, as above,
    under the windowed mask with softcap 50."""
    n_vis = 250
    k, v, ks, vs, bits = _cache(np.random.default_rng(90), kind)
    q = torch.from_numpy(np.random.default_rng(91).standard_normal((NT, 4, D))
                         .astype(np.float32)).to(torch.bfloat16)
    mask = _window_mask(n_vis)
    kw = dict(scale=SCALE, logit_softcap=50.0, k_scale=_jax(ks), v_scale=_jax(vs), kv_bits=bits)
    assert jax_flash(_jax(q), _jax(k), _jax(v), jnp.asarray(mask), interpret=True, **kw) is None
    ref = np.asarray(jax_attention(_jax(q), _jax(k), _jax(v), jnp.asarray(mask != 0), **kw))
    plain = flash.flash_attention(q, k, v, torch.from_numpy(mask), scale=SCALE,
                                  logit_softcap=50.0, k_scale=ks, v_scale=vs, kv_bits=bits)
    assert _rel_err(plain.to(torch.float32), ref) <= 5e-3
    nsplit = flash.n_splits(KV, NT * 2, n_vis, flash.ROW_TILE)
    for splits in sorted({nsplit, 1}):
        got = _flash_mma_emulation(q, k, v, mask, scale=SCALE, softcap=50.0, k_scale=ks,
                                   v_scale=vs, kv_bits=bits, nsplit=splits)
        assert not got[5].any()
        assert _rel_err(got, ref) <= TOL


def test_d256_launch_arguments(monkeypatch):
    """One lk_flash launch with D = Dv = 256 (arguments 12 and 21) and the
    softcap (18), a
    [nsplit, KV * rows, 256] scratch, an output 256 wide, LAUNCHES_D256
    counting it (and LAUNCHES_MLA not); every other pair with a 256-wide
    side, and (192, 192), raises on the card before the entry, and so does
    kernel 9 at head dim 256."""
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
    k, v, _, _, _ = _cache(np.random.default_rng(92), "bf16")
    q = torch.zeros((1, 4, D), dtype=torch.bfloat16)
    before, mla = flash.LAUNCHES_D256, flash.LAUNCHES_MLA
    out = flash.flash_attention(q, k[None], v[None], torch.ones((1, 256), dtype=torch.int8),
                                scale=SCALE, logit_softcap=50.0, layer=0)
    assert out.shape == (1, 4, D)
    assert (flash.LAUNCHES_D256, flash.LAUNCHES_MLA) == (before + 1, mla)
    (c,) = calls
    assert (c[12], c[21]) == (D, D) and c[18] == pytest.approx(50.0)
    nsplit = flash.n_splits(KV, 2, 256, flash.ROW_TILE)
    assert (nsplit, KV * 2, D) in shapes
    monkeypatch.setattr(flash, "check_cache", cache_ok)
    for dk, dv in ((192, 192), (256, 128), (128, 256), (256, 64), (256, 192)):
        qq = torch.zeros((1, 4, dk), dtype=torch.bfloat16)
        kk = torch.zeros((1, KV, 64, dk), dtype=torch.bfloat16)
        vv = torch.zeros((1, KV, 64, dv), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dims"):
            flash.check_cache(qq, kk, vv, 64, 0, None, None, pairs=flash.DIM_PAIRS)
    kk = torch.zeros((1, KV, 64, D), dtype=torch.bfloat16)
    monkeypatch.setattr(flash_stacked, "is_cuda", lambda t: True)
    new = torch.zeros((1, KV, D), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):  # kernel 9: 64 and 128 only
        flash_stacked.flash_attention_stacked(q, kk, kk, 0, new, new,
                                              torch.ones((1, 64), dtype=torch.int8),
                                              torch.ones((1, 1), dtype=torch.int8), scale=SCALE)
