"""The host side of kernel 3's bf16 tensor-core tile, which takes every
row count: a torch emulation of the tile's arithmetic (blocks of 64 rows of
a kv head's GQA row space, 64-cell tiles that no row of a block sees
skipped, the scores, K scale, softcap and mask of the walk it replaced, l
taking the unscaled p, the V scale folded into p, P fed to P V as bf16
p_hi + p_lo, the splits merged in order) against the plain version and
JAX's Pallas kernel in interpret mode on bf16, int8 and packed int4 caches;
the split plan; the routing and the wrapper's alignment refusal.

Everything here runs on the CPU: the CUDA kernel itself is held against the
plain version on the card by chip_smoke.py."""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.ops.pallas.flash import flash_attention as jax_flash

from llama_kotlin_tpu_torch.ops.cuda import flash
from llama_kotlin_tpu_torch.runtime.kv_cache import unpack_q4_rows

from test_torch_qmm_plan import _rel_err

KV, H, D = 2, 8, 128
NT, CELLS, N_VIS = 24, 384, 256  # 96 rows a kv head: two row blocks, the second partial
NEG_INF = -1e30


def _mask(nt: int, n_vis: int) -> np.ndarray:
    """Two sequences of 12 tokens each, causal over their own cells: the
    first sees cells 0..63 (token i the first 53 + i), the second cells
    128..191; token 5 sees nothing.  Tile 1 (cells 64..127), between live
    tiles, and tile 3 are dead for every row; the second row block (tokens
    16..23, the second sequence) sees no cell of tile 0 either."""
    m = np.zeros((nt, n_vis), np.int8)
    for i in range(12):
        m[i, :53 + i] = 1
        m[12 + i, 128:128 + 53 + i] = 1
    m[5] = 0
    return m


def _cache(rng, kind: str):
    """(k, v, k_scale, v_scale, kv_bits) of a [KV, CELLS, ..] cache: bf16
    values; int8 codes; packed int4 codes (every byte value); f32 row
    scales for the quantized ones."""
    if kind == "bf16":
        kv = [torch.from_numpy(rng.standard_normal((KV, CELLS, D)).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2)]
        return kv[0], kv[1], None, None, 8
    if kind == "int8":
        codes = [torch.from_numpy(rng.integers(-127, 128, (KV, CELLS, D)).astype(np.int8))
                 for _ in range(2)]
    else:
        codes = [torch.from_numpy(rng.integers(0, 256, (KV, CELLS, D // 2)).astype(np.uint8))
                 for _ in range(2)]
    scales = [torch.from_numpy((rng.random((KV, CELLS)) * 0.05 + 0.01).astype(np.float32))
              for _ in range(2)]
    return codes[0], codes[1], scales[0], scales[1], 4 if kind == "int4" else 8


def _widen(c: torch.Tensor, kv_bits: int) -> torch.Tensor:
    """A cache's rows as the tile holds them: bf16 values, or the codes
    (exact in bf16), as f32."""
    if c.dtype == torch.bfloat16:
        return c.to(torch.float32)
    return unpack_q4_rows(c) if kv_bits == 4 else c.to(torch.float32)


def _flash_mma_emulation(q, k, v, mask, *, scale, softcap, k_scale, v_scale, kv_bits, nsplit,
                         single_p=False):
    """The tile's arithmetic in f32: q [nt, H, D]; k/v [KV, cells, ..] ->
    [nt, H, D] f32 (before the output's bf16 rounding).  single_p feeds P
    V one bf16 P instead of p_hi + p_lo."""
    nt = q.shape[0]
    rep, n_vis = H // KV, mask.shape[1]
    R, split_cells = rep * nt, n_vis // nsplit
    kf, vf = _widen(k, kv_bits), _widen(v, kv_bits)
    out = torch.zeros((nt, H, D))
    for kvh in range(KV):
        r = torch.arange(R)
        tok, head = r // rep, kvh * rep + r % rep
        qr = q[tok, head].to(torch.float32)
        seen_all = torch.from_numpy(mask)[tok] != 0  # [R, n_vis]
        parts = []
        for z in range(nsplit):
            m = torch.full((R,), NEG_INF)
            l = torch.zeros(R)
            o = torch.zeros((R, D))
            for r0 in range(0, R, flash.ROW_TILE):
                rb = slice(r0, min(R, r0 + flash.ROW_TILE))
                for c0 in range(z * split_cells, (z + 1) * split_cells, flash.CELL_TILE):
                    cs = slice(c0, c0 + flash.CELL_TILE)
                    seen = seen_all[rb, cs]
                    if not seen.any():  # no row of the block sees the tile: skipped
                        continue
                    s = (qr[rb] @ kf[kvh, cs].T) * scale
                    if k_scale is not None:
                        s = s * k_scale[kvh, cs]
                    if softcap > 0.0:
                        s = torch.tanh(s / softcap) * softcap
                    s = torch.where(seen, s, torch.full_like(s, NEG_INF))
                    m_new = torch.maximum(m[rb], s.amax(dim=-1))
                    p = torch.where(seen, torch.exp(s - m_new[:, None]), torch.zeros_like(s))
                    alpha = torch.exp(m[rb] - m_new)
                    l[rb] = l[rb] * alpha + p.sum(dim=-1)
                    m[rb] = m_new
                    if v_scale is not None:  # after l has taken the unscaled p
                        p = p * v_scale[kvh, cs]
                    p_hi = p.to(torch.bfloat16).to(torch.float32)
                    pv = p_hi @ vf[kvh, cs]
                    if not single_p:
                        pv = pv + (p - p_hi).to(torch.bfloat16).to(torch.float32) @ vf[kvh, cs]
                    o[rb] = o[rb] * alpha[:, None] + pv
            parts.append((m, l, o))
        # the merge: each split weighted by exp(m_z - max m), in split order
        mx = parts[0][0]
        for m, _, _ in parts[1:]:
            mx = torch.maximum(mx, m)
        lt, ot = torch.zeros(R), torch.zeros((R, D))
        for m, l, o in parts:
            w = torch.exp(m - mx)
            lt = lt + l * w
            ot = ot + o * w[:, None]
        res = torch.where(lt[:, None] > 0, ot / lt.clamp_min(1e-30)[:, None], torch.zeros_like(ot))
        out[tok, head] = res
    return out


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_flash_mma_emulation_matches_plain_and_jax(kind, softcap):
    """The tile's arithmetic, with the wrapper's split count and with one
    split (a dead tile between live ones inside a split), equals
    flash_attention_plain and JAX's flash_attention (interpret) within 1e-4
    of max|out| on f32 q (bf16 values): exact products, P as p_hi + p_lo
    (within 2^-16 of p), f32 order only.  A fully masked row gives 0.  One
    bf16 P would cost more than the bound (checked on the same inputs)."""
    rng = np.random.default_rng(70 + 3 * ["bf16", "int8", "int4"].index(kind) + int(softcap))
    q = torch.from_numpy(rng.standard_normal((NT, H, D)).astype(np.float32) *
                         (4.0 if softcap else 1.0)).to(torch.bfloat16).to(torch.float32)
    k, v, ks, vs, bits = _cache(rng, kind)
    mask = _mask(NT, N_VIS)
    kw = dict(scale=D ** -0.5, softcap=softcap, k_scale=ks, v_scale=vs, kv_bits=bits)
    rows = (H // KV) * NT
    nsplit = flash.n_splits(KV, rows, N_VIS, flash.ROW_TILE)
    assert nsplit == N_VIS // flash.CELL_TILE  # every split one tile: two of four dead
    plain = flash.flash_attention(q, k, v, torch.from_numpy(mask), scale=D ** -0.5,
                                  logit_softcap=softcap, k_scale=ks, v_scale=vs, kv_bits=bits)
    to_j = lambda t: None if t is None else jnp.asarray(t.to(torch.float32).numpy()
                                                        if t.dtype == torch.bfloat16 else t.numpy())
    ref = np.asarray(jax_flash(to_j(q), to_j(k), to_j(v), jnp.asarray(mask), scale=D ** -0.5,
                               logit_softcap=softcap, k_scale=to_j(ks), v_scale=to_j(vs),
                               kv_bits=bits, interpret=True))
    for splits in (nsplit, 1):
        got = _flash_mma_emulation(q, k, v, mask, nsplit=splits, **kw)
        assert not got[5].any() and torch.isfinite(got).all()
        assert _rel_err(got, plain) <= 1e-4
        assert _rel_err(got, ref) <= 1e-4
    single = _flash_mma_emulation(q, k, v, mask, nsplit=nsplit, single_p=True, **kw)
    assert _rel_err(single, plain) > 1e-4


# (nt, n_vis) -> cell splits at the llama3-8B shapes (32 heads on 8 kv
# heads: 4 nt rows a kv head, in blocks of 64)
SERVED_SPLITS = {(1, 512): 8, (1, 1024): 16, (8, 512): 8, (64, 512): 8, (64, 1024): 8,
                 (256, 1024): 2}


@pytest.mark.parametrize("nt,n_vis", list(SERVED_SPLITS))
def test_flash_splits_at_served_shapes(nt, n_vis):
    """The split count at the served shapes: whole 64-cell tiles a split, as
    many splits as fill the card's 264 block slots where the tiles allow
    (decode: one tile a split; a 64-token prefill: 8 splits of its 32 row
    blocks; a 256-token one over 1024 cells: 2 splits of 8 tiles, where
    dead tiles fall between live ones inside a split)."""
    s = flash.n_splits(8, 4 * nt, n_vis, flash.ROW_TILE)
    assert (n_vis // flash.CELL_TILE) % s == 0
    assert s == SERVED_SPLITS[nt, n_vis]


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_flash_routes(kind, monkeypatch):
    """Every row count, decode's 4 rows a kv head included, is one lk_flash
    launch on the tile with its split count, on every cache; a cache or
    mask the tile cannot copy aligned raises before the entry."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            assert name == "lk_flash", name
            return lambda *args: calls.append(args[:-1]) or 0

    monkeypatch.setattr(flash, "is_cuda", lambda t: True)
    monkeypatch.setattr(flash, "check_cache", lambda *a, **kw: None)
    monkeypatch.setattr(flash._build, "lib", Lib)
    monkeypatch.setattr(flash._build, "stream", lambda: 0)
    k, v, ks, vs, bits = _cache(np.random.default_rng(80), kind)
    heads, n_vis = 32, 256
    kc, vc = (c.expand(4, *c.shape).reshape(8, CELLS, -1)[None].contiguous() for c in (k, v))
    if ks is not None:  # 8 kv heads
        ks, vs = (s.expand(4, *s.shape).reshape(8, CELLS)[None].contiguous() for s in (ks, vs))
    nts = (1, 2, 3, 8, 17, 64)
    for nt in nts:
        q = torch.zeros((nt, heads, D), dtype=torch.bfloat16)
        flash.flash_attention(q, kc, vc, torch.ones((nt, n_vis), dtype=torch.int8),
                              scale=1.0, layer=0, k_scale=ks, v_scale=vs, kv_bits=bits)
    assert [(c[9], c[19], c[20]) for c in calls] == [
        (nt, flash.n_splits(8, 4 * nt, n_vis, flash.ROW_TILE), bits) for nt in nts]
    bad = torch.zeros(kc.numel() + 8, dtype=kc.dtype)[1:1 + kc.numel()].view(kc.shape)
    with pytest.raises(ValueError):  # a cache view off the 16-byte grid
        flash.flash_attention(torch.zeros((1, heads, D), dtype=torch.bfloat16), bad, vc,
                              torch.ones((1, n_vis), dtype=torch.int8), scale=1.0, layer=0,
                              k_scale=ks, v_scale=vs, kv_bits=bits)
    assert len(calls) == len(nts)
