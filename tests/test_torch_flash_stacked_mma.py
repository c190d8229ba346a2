"""The host side of kernel 9 on kernel 3's bf16 tensor-core tile, and of the
two repairs that tile took with it: head dim 64 and a ragged visible-cell
count.

A torch emulation of the tile's arithmetic (csrc/flash_mma.cuh: blocks of
64 rows of a kv head's GQA row space, 64-cell tiles that no row of a block
sees skipped, cells at or past n_vis zero-filled and masked dead, the
widening of int8 and packed int4 codes, l taking the unscaled p, the V
scale folded into p, P fed to P V as bf16 p_hi + p_lo, the splits merged in
order; kernel 9's extra split over the fresh rows) against the plain
versions and the JAX package: kernel 9 against JAX's
``flash_attention_stacked`` in interpret mode at head dims 64 and 128 on
bf16 and int8 caches, kernel 3 at head dim 64 on all three caches against
JAX's ``flash_attention``, and both at n_vis = 1000 and 1001 against JAX's
XLA route (``ops/attention.py::attention``, where JAX's kernels decline).
Then the wrappers' arguments (split counts, padded masks, refusals), and
the served configurations the repairs open: a 2-layer ``tinyllama-1.1b``
(64-wide heads, F = 5632 folds that kernel 2 declines as JAX does) and a
context of 1000 cells, each against the JAX contexts on the CPU.

Everything here runs on the CPU: the CUDA kernels themselves are held
against the plain versions on the card by chip_smoke.py."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.models.config import ModelConfig as JaxConfig
from llama_kotlin_tpu.models.synthetic import PRESETS as JAX_PRESETS
from llama_kotlin_tpu.models.synthetic import synthetic_params_device as jax_params
from llama_kotlin_tpu.ops.attention import attention as jax_attention
from llama_kotlin_tpu.ops.pallas.flash import flash_attention as jax_flash
from llama_kotlin_tpu.ops.pallas.flash_stacked import flash_attention_stacked as jax_stacked
from llama_kotlin_tpu.ops.pallas.qmm_w4_ffn import qmm_w4_ffn_matmul as jax_ffn
from llama_kotlin_tpu.quant.formats import GGMLQuantType
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.convert import params_from_numpy
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.models.synthetic import PRESETS, preset_config
from llama_kotlin_tpu_torch.ops.cuda import flash, flash_stacked
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4_ffn import ffn_eligible
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from test_torch_qmm_plan import _rel_err

KV, H = 2, 8  # 4 query heads a kv head
NEG_INF = -1e30
KINDS = ("bf16", "int8", "int4")


def _cache(rng, kind: str, cells: int, d: int):
    """(k, v, k_scale, v_scale, kv_bits) of a [KV, cells, ..] cache."""
    if kind == "bf16":
        kv = [torch.from_numpy(rng.standard_normal((KV, cells, d)).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2)]
        return kv[0], kv[1], None, None, 8
    if kind == "int8":
        codes = [torch.from_numpy(rng.integers(-127, 128, (KV, cells, d)).astype(np.int8))
                 for _ in range(2)]
    else:
        codes = [torch.from_numpy(rng.integers(0, 256, (KV, cells, d // 2)).astype(np.uint8))
                 for _ in range(2)]
    scales = [torch.from_numpy((rng.random((KV, cells)) * 0.05 + 0.01).astype(np.float32))
              for _ in range(2)]
    return codes[0], codes[1], scales[0], scales[1], 4 if kind == "int4" else 8


def _widen(c: torch.Tensor) -> torch.Tensor:
    """A cache's rows as the tile widens them, in f32: bf16 values and int8
    codes as they are; a packed int4 byte j holds dim j in its low nibble
    (code + 8) and dim j + D/2 in its high nibble (two's complement)."""
    if c.dtype != torch.uint8:
        return c.to(torch.float32)
    lo = (c & 0x0F).to(torch.int16) - 8
    hi = (((c >> 4).to(torch.int16)) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1).to(torch.float32)


def _walk(qr, kf, vf, ks, vs, seen_all, c_begin, c_end, n_valid, *, scale, softcap):
    """One split of the tile for every row block of a kv head: qr [R, D];
    kf/vf [rows, D] (rows past n_valid never read: zero-filled); ks/vs
    [rows] or None; seen_all [R, >= c_end rounded up to 64] -> (m, l, o)."""
    R, D = qr.shape
    m, l, o = torch.full((R,), NEG_INF), torch.zeros(R), torch.zeros((R, D))
    for r0 in range(0, R, flash.ROW_TILE):
        rb = slice(r0, min(R, r0 + flash.ROW_TILE))
        for c0 in range(c_begin, c_end, flash.CELL_TILE):
            seen = seen_all[rb, c0:c0 + flash.CELL_TILE]
            if not seen.any():  # no row of the block sees the tile: skipped
                continue
            live = torch.arange(c0, c0 + flash.CELL_TILE) < n_valid
            idx = torch.arange(c0, c0 + flash.CELL_TILE).clamp(max=n_valid - 1)
            kt = torch.where(live[:, None], kf[idx], torch.zeros(()))
            vt = torch.where(live[:, None], vf[idx], torch.zeros(()))
            s = (qr[rb] @ kt.T) * scale
            if ks is not None:
                s = s * torch.where(live, ks[idx], torch.zeros(()))
            if softcap > 0.0:
                s = torch.tanh(s / softcap) * softcap
            s = torch.where(seen, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m[rb], s.amax(dim=-1))
            p = torch.where(seen, torch.exp(s - m_new[:, None]), torch.zeros_like(s))
            alpha = torch.exp(m[rb] - m_new)
            l[rb] = l[rb] * alpha + p.sum(dim=-1)
            m[rb] = m_new
            if vs is not None:  # after l has taken the unscaled p
                p = p * torch.where(live, vs[idx], torch.zeros(()))
            p_hi = p.to(torch.bfloat16).to(torch.float32)
            p_lo = (p - p_hi).to(torch.bfloat16).to(torch.float32)
            o[rb] = o[rb] * alpha[:, None] + p_hi @ vt + p_lo @ vt
    return m, l, o


def _padded(mask: np.ndarray) -> torch.Tensor:
    """The mask as the wrapper hands it to the tile: whole 64-cell tiles,
    zeros past its columns."""
    t = torch.from_numpy(mask != 0)
    return torch.nn.functional.pad(t, (0, -t.shape[1] % flash.CELL_TILE))


def _tile_emulation(q, k, v, mask, *, scale, softcap=0.0, k_scale=None, v_scale=None,
                    nsplit, fresh=None):
    """The tile's arithmetic in f32: q [nt, H, D]; k/v [KV, cells, ..];
    mask [nt, n_vis] -> [nt, H, D] f32 (before the output's bf16 rounding).
    fresh = (new_k, new_v, mask_new) adds kernel 9's split over the fresh
    rows [nt, KV, D] under mask_new [nt, nt], split 0 of the merge."""
    nt, _, D = q.shape
    rep, n_vis = H // KV, mask.shape[1]
    R = rep * nt
    tiles = -(-n_vis // flash.CELL_TILE)
    split_cells = tiles // nsplit * flash.CELL_TILE
    kf, vf = _widen(k), _widen(v)
    seen_cells = _padded(mask)
    out = torch.zeros((nt, H, D))
    for kvh in range(KV):
        r = torch.arange(R)
        tok, head = r // rep, kvh * rep + r % rep
        qr = q[tok, head].to(torch.float32)
        ks = None if k_scale is None else k_scale[kvh]
        vs = None if v_scale is None else v_scale[kvh]
        parts = []  # in split order: kernel 9's fresh split first
        if fresh is not None:
            new_k, new_v, mask_new = fresh
            parts.append(_walk(qr, new_k[:, kvh].to(torch.float32),
                               new_v[:, kvh].to(torch.float32), None, None,
                               _padded(mask_new)[tok], 0, nt, nt, scale=scale,
                               softcap=softcap))
        for z in range(nsplit):
            c0 = z * split_cells
            parts.append(_walk(qr, kf[kvh], vf[kvh], ks, vs, seen_cells[tok], c0,
                               min(n_vis, c0 + split_cells), n_vis, scale=scale,
                               softcap=softcap))
        mx = parts[0][0]
        for m, _, _ in parts[1:]:
            mx = torch.maximum(mx, m)
        lt, ot = torch.zeros(R), torch.zeros((R, D))
        for m, l, o in parts:
            w = torch.exp(m - mx)
            lt = lt + l * w
            ot = ot + o * w[:, None]
        out[tok, head] = torch.where(lt[:, None] > 0, ot / lt.clamp_min(1e-30)[:, None],
                                     torch.zeros_like(ot))
    return out


def _j(t):
    """A torch tensor (or None) as a JAX array; bf16 values as f32."""
    if t is None:
        return None
    return jnp.asarray(t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 else t.numpy())


def _q(rng, nt: int, d: int, amp: float = 1.0) -> torch.Tensor:
    """f32 q of bf16 values."""
    return torch.from_numpy(rng.standard_normal((nt, H, d)).astype(np.float32) * amp).to(
        torch.bfloat16).to(torch.float32)


def _stacked_masks(nt: int, n_vis: int):
    """mask_cells [nt, n_vis] and mask_new [nt, nt]: two sequences of nt/2
    tokens; the first sees cache cells 0..40 + i (tile 0), the second cells
    128..168 + i (tile 2), so tiles 1 and 3 are dead for every row and
    inside a split when the cells take one split; the fresh rows causal
    within each sequence; token 5 sees nothing at all (exactly 0)."""
    half = nt // 2
    mc = np.zeros((nt, n_vis), np.int8)
    mn = np.zeros((nt, nt), np.int8)
    for i in range(half):
        mc[i, :41 + i] = 1
        mc[half + i, 128:169 + i] = 1
        mn[i, :i + 1] = 1
        mn[half + i, half:half + i + 1] = 1
    mc[5] = 0
    mn[5] = 0
    return mc, mn


@pytest.mark.parametrize("nt", [8, 24])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("d", [64, 128])
def test_stacked_tile_emulation_matches_plain_and_jax(d, kind, nt):
    """Kernel 9's tile (the cache splits, with the wrapper's split count and
    with one split holding dead tiles between live ones, plus the fresh
    rows' split) equals flash_attention_stacked_plain and JAX's
    flash_attention_stacked (interpret) within 1e-4 of max|out| on f32 q
    of bf16 values: exact products, P as p_hi + p_lo, f32 order only.  A
    row that sees nothing gives exactly 0."""
    rng = np.random.default_rng(300 + d + 7 * nt + (kind == "int8"))
    cells, n_vis, layer = 320, 256, 1
    q = _q(rng, nt, d)
    k, v, ks, vs, _ = _cache(rng, kind, cells, d)
    # a 2-layer cache with this one as layer 1
    k2, v2 = (torch.stack([torch.zeros_like(c), c]) for c in (k, v))
    ks2 = vs2 = None
    if ks is not None:
        ks2, vs2 = (torch.stack([torch.ones_like(s), s]) for s in (ks, vs))
    new_k, new_v = (torch.from_numpy(rng.standard_normal((nt, KV, d)).astype(np.float32))
                    .to(torch.bfloat16) for _ in range(2))
    mc, mn = _stacked_masks(nt, n_vis)
    scale = d ** -0.5
    plain = flash_stacked.flash_attention_stacked(
        q, k2, v2, layer, new_k, new_v, torch.from_numpy(mc), torch.from_numpy(mn),
        scale=scale, k_scale=ks2, v_scale=vs2)
    ref = np.asarray(jax_stacked(_j(q), _j(k2), _j(v2), layer, _j(new_k), _j(new_v),
                                 jnp.asarray(mc), jnp.asarray(mn), scale=scale,
                                 k_scale=_j(ks2), v_scale=_j(vs2), interpret=True))
    nsplit = flash.n_splits(KV, (H // KV) * nt, n_vis, flash.ROW_TILE)
    assert nsplit == n_vis // flash.CELL_TILE
    for splits in (nsplit, 1):
        got = _tile_emulation(q, k, v, mc, scale=scale, k_scale=ks, v_scale=vs, nsplit=splits,
                              fresh=(new_k, new_v, mn))
        assert not got[5].any() and torch.isfinite(got).all()
        assert _rel_err(got, plain) <= 1e-4
        assert _rel_err(got, ref) <= 1e-4


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("kind", KINDS)
def test_flash_tile_head_dim_64_matches_jax(kind, softcap):
    """Kernel 3's tile at head dim 64 on each cache (the packed int4 one
    pairs dim j with dim j + 32, the JAX layout's j and j + D/2) equals
    flash_attention_plain and JAX's flash_attention (interpret) within 1e-4
    of max|out|; a row that sees nothing gives 0."""
    rng = np.random.default_rng(400 + KINDS.index(kind) + int(softcap))
    d, nt, cells, n_vis = 64, 24, 384, 256
    q = _q(rng, nt, d, 4.0 if softcap else 1.0)
    k, v, ks, vs, bits = _cache(rng, kind, cells, d)
    mask, _ = _stacked_masks(nt, n_vis)
    kw = dict(scale=d ** -0.5, logit_softcap=softcap, k_scale=ks, v_scale=vs, kv_bits=bits)
    plain = flash.flash_attention(q, k, v, torch.from_numpy(mask), **kw)
    ref = np.asarray(jax_flash(_j(q), _j(k), _j(v), jnp.asarray(mask), scale=d ** -0.5,
                               logit_softcap=softcap, k_scale=_j(ks), v_scale=_j(vs),
                               kv_bits=bits, interpret=True))
    nsplit = flash.n_splits(KV, (H // KV) * nt, n_vis, flash.ROW_TILE)
    for splits in (nsplit, 1):
        got = _tile_emulation(q, k, v, mask, scale=d ** -0.5, softcap=softcap, k_scale=ks,
                              v_scale=vs, nsplit=splits)
        assert not got[5].any() and torch.isfinite(got).all()
        assert _rel_err(got, plain) <= 1e-4
        assert _rel_err(got, ref) <= 1e-4


@pytest.mark.parametrize("n_vis", [1000, 1001])
@pytest.mark.parametrize("kind", KINDS)
def test_ragged_visibility_matches_jax_xla(kind, n_vis):
    """n_vis = 1000 and 1001 (a context of that many cells, whose cache
    holds one scratch row more): kernel 3's tile, its last tile ragged
    (cells past n_vis zero-filled and dead), equals the plain version and
    JAX's attention, which takes its XLA route there (its kernel declines
    n_vis % 128); kernel 9's (bf16, int8) equals its plain version and
    JAX's XLA route over the cache prefix and the fresh rows side by side.
    The split count works on ceil(n_vis / 64) = 16 tiles.  Tolerance 1e-4
    of max|out|, as above."""
    rng = np.random.default_rng(500 + n_vis + KINDS.index(kind))
    d, nt, cells = 128, 8, n_vis + 1
    q = _q(rng, nt, d)
    k, v, ks, vs, bits = _cache(rng, kind, cells, d)
    pos = np.arange(n_vis - nt, n_vis)
    mask = (np.arange(n_vis)[None, :] <= pos[:, None]).astype(np.int8)
    mask[:, 100:300] = 0  # dead tiles between live ones
    mask[3] = 0
    scale = d ** -0.5
    kw = dict(scale=scale, k_scale=ks, v_scale=vs, kv_bits=bits)
    jkw = dict(scale=scale, k_scale=_j(ks), v_scale=_j(vs), kv_bits=bits)
    assert jax_flash(_j(q), _j(k), _j(v), jnp.asarray(mask), interpret=True, **jkw) is None
    ref = np.asarray(jax_attention(_j(q), _j(k), _j(v), jnp.asarray(mask != 0), **jkw))
    plain = flash.flash_attention(q, k, v, torch.from_numpy(mask), **kw)
    nsplit = flash.n_splits(KV, (H // KV) * nt, n_vis, flash.ROW_TILE)
    assert nsplit == 16
    for splits in (nsplit, 2, 1):
        got = _tile_emulation(q, k, v, mask, scale=scale, k_scale=ks, v_scale=vs, nsplit=splits)
        assert not got[3].any() and torch.isfinite(got).all()
        assert _rel_err(got, plain) <= 1e-4
        assert _rel_err(got, ref) <= 1e-4
    if kind == "int4":
        return
    new_k, new_v = (torch.from_numpy(rng.standard_normal((nt, KV, d)).astype(np.float32))
                    .to(torch.bfloat16) for _ in range(2))
    mc = mask.copy()
    mc[:, n_vis - nt:] = 0  # the step's own cells: its rows come fresh
    mn = np.tril(np.ones((nt, nt), np.int8))
    mn[3] = 0
    plain = flash_stacked.flash_attention_stacked(
        q, k[None], v[None], 0, new_k, new_v, torch.from_numpy(mc), torch.from_numpy(mn),
        scale=scale, k_scale=None if ks is None else ks[None],
        v_scale=None if vs is None else vs[None])
    # JAX's route: the prefix (dequantized) and the fresh rows side by side
    kcat, vcat = (np.concatenate([(_widen(c) * (1.0 if sc is None else sc[..., None])).numpy(),
                                  f.transpose(0, 1).to(torch.float32).numpy()], axis=1)
                  for c, sc, f in ((k, ks, new_k), (v, vs, new_v)))
    mcat = np.concatenate([np.pad(mc, ((0, 0), (0, cells - n_vis))), mn], axis=1) != 0
    ref = np.asarray(jax_attention(_j(q), jnp.asarray(kcat), jnp.asarray(vcat),
                                   jnp.asarray(mcat), scale=scale, allow_pallas=False))
    got = _tile_emulation(q, k, v, mc, scale=scale, k_scale=ks, v_scale=vs, nsplit=nsplit,
                          fresh=(new_k, new_v, mn))
    assert not got[3].any()
    assert _rel_err(got, plain) <= 1e-4
    assert _rel_err(got, ref) <= 1e-4


def _lib_recorder(monkeypatch, mod, entry: str, calls: list) -> None:
    """The wrapper runs its CUDA branch on CPU tensors and records what it
    passes the C entry (and the padded mask it hands over)."""

    class Lib:
        def __getattr__(self, name):
            assert name == entry, name
            return lambda *args: calls.append(args[:-1]) or 0

    monkeypatch.setattr(mod, "is_cuda", lambda t: True)
    monkeypatch.setattr(mod, "check_cache", lambda *a, **kw: None)
    monkeypatch.setattr(mod._build, "lib", Lib)
    monkeypatch.setattr(mod._build, "stream", lambda: 0)


@pytest.mark.parametrize("d", [64, 128])
def test_stacked_routes(d, monkeypatch):
    """Every call of kernel 9 is one lk_flash_stacked launch with the head
    dim, the tile's split count (64-row blocks) and the padded mask's row
    length; a ragged n_vis (1000) pads mask_cells with zero columns to 1024
    and passes n_vis as it is."""
    calls, masks = [], []
    _lib_recorder(monkeypatch, flash_stacked, "lk_flash_stacked", calls)
    real = flash_stacked.tile_mask
    monkeypatch.setattr(flash_stacked, "tile_mask", lambda m: masks.append(real(m)) or masks[-1])
    cells = 1025
    k = torch.zeros((2, 8, cells, d), dtype=torch.bfloat16)
    for nt, n_vis in ((1, 1024), (64, 1024), (8, 1000), (3, 1001)):
        q = torch.zeros((nt, 32, d), dtype=torch.bfloat16)
        fresh = torch.zeros((nt, 8, d), dtype=torch.bfloat16)
        mc = torch.ones((nt, n_vis), dtype=torch.int8)
        flash_stacked.flash_attention_stacked(q, k, k, 1, fresh, fresh, mc,
                                              torch.ones((nt, nt), dtype=torch.int8), scale=1.0)
        c = calls[-1]
        assert (c[12], c[13], c[14], c[15], c[16], c[17], c[18]) == (
            nt, 32, 8, d, cells, n_vis, -(-n_vis // 64) * 64)
        assert c[22] == flash.n_splits(8, 4 * nt, n_vis, flash.ROW_TILE)
        assert masks[-1].shape == (nt, -(-n_vis // 64) * 64)
        assert masks[-1][:, :n_vis].all() and not masks[-1][:, n_vis:].any()
    assert len(calls) == 4


def test_check_cache_head_dims_and_ragged_n_vis():
    """On the card the kernels take head dims 64 and 128 and any 1 <= n_vis
    <= cells: 192 and 256 (the JAX kernel's other branches, ROADMAP) raise,
    as does an n_vis past the cache; no multiple-of-64 rule is left."""
    def cache(d, cells=1001):
        return torch.zeros((1, 2, cells, d), dtype=torch.bfloat16)

    for d in (64, 128):
        for n_vis in (1, 63, 1000, 1001):
            k = cache(d)
            q = torch.zeros((1, 8, d), dtype=torch.bfloat16)
            try:
                flash.check_cache(q, k, k, n_vis, 0, None, None)
            except ValueError as e:  # only the card rule may refuse a CPU tensor
                assert "card" in str(e), e
    for d in (192, 256):
        q = torch.zeros((1, 8, d), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dims"):
            flash.check_cache(q, cache(d), cache(d), 64, 0, None, None)
    q = torch.zeros((1, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="n_vis"):
        flash.check_cache(q, cache(64), cache(64), 1002, 0, None, None)


# -- the served configurations -------------------------------------------------

TINY = dict(arch="llama", n_embd=2048, n_layer=2, n_head=32, n_head_kv=4, n_ff=5632,
            vocab_size=512)  # tinyllama-1.1b at 2 layers; the vocabulary cut for the CPU
N_PROMPT, N_STEPS = 12, 4


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxConfig(**TINY)
    jp = jax_params(jcfg, GGMLQuantType.Q4_K, fast_w4a8=True, fuse=True)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, ModelConfig(**TINY), pp


def test_tinyllama_preset_is_jaxs():
    """The port's tinyllama-1.1b row is the JAX package's: 64-wide heads, 8
    query heads a kv head."""
    assert PRESETS["tinyllama-1.1b"] == JAX_PRESETS["tinyllama-1.1b"]
    cfg = preset_config("tinyllama-1.1b")
    assert cfg.head_dim == 64 and cfg.n_head // cfg.n_head_kv == 8


def test_tinyllama_ffn_declines_kernel_2_as_jax(tiny):
    """F = 5632 pads the down fold's K to 6144: kernel 2 declines the pair
    (ffn_eligible) exactly as JAX's qmm_w4_ffn_matmul does, so the decode
    FFN runs gate|up and down through kernel 1 on both sides."""
    _, jp, _, pp = tiny
    for jl, pl in zip(jp["layers"], pp["layers"]):
        assert pl["ffn_down"].k_pad == 6144 != pl["ffn_down"].shape[1]
        x = np.zeros((1, TINY["n_embd"]), np.float32)
        assert jax_ffn(jnp.asarray(x), jl["ffn_gateup_fused"], jl["ffn_down"],
                       interpret=True) is None
        assert not ffn_eligible(pl["ffn_gateup_fused"], pl["ffn_down"], "silu")


def _steps(ctx, batch_cls, prompt):
    """Prefill, then N_STEPS greedy single-token decodes."""
    assert ctx.decode(batch_cls.single(prompt)) == 0
    logits = [np.asarray(ctx.get_logits()[-1], np.float32)]
    toks = [int(np.argmax(logits[-1]))]
    for i in range(N_STEPS):
        assert ctx.decode(batch_cls.single([toks[-1]], pos0=N_PROMPT + i)) == 0
        logits.append(np.asarray(ctx.get_logits()[-1], np.float32))
        toks.append(int(np.argmax(logits[-1])))
    return toks, logits


@pytest.mark.parametrize("n_cells,prefer_unrolled", [(512, True), (512, False), (1000, True),
                                                     (1000, False)])
def test_served_contexts_match_jax(tiny, n_cells, prefer_unrolled, monkeypatch):
    """The 2-layer tinyllama-1.1b (head dim 64) through both LlamaContexts,
    unrolled (kernel 3) and stacked (kernel 9), with 512 cells and with
    1000 (not a multiple of 128: every cell visible, n_vis = 1000):
    prefill of 12 tokens and 4 greedy steps.  Greedy tokens identical;
    logits within 1e-2 of max|logits|, the bound of the llama3-8B-shaped
    parity test (tests/test_torch_model.py)."""
    jcfg, jp, cfg, pp = tiny
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    prompt = np.random.default_rng(11).integers(0, TINY["vocab_size"], N_PROMPT).astype(np.int32)
    jctx = JaxContext(jcfg, jp, n_cells=n_cells, prefer_unrolled=prefer_unrolled)
    pctx = LlamaContext(cfg, pp, n_cells=n_cells, prefer_unrolled=prefer_unrolled, device="cpu")
    assert ("layers_stacked" in pctx.params) == (not prefer_unrolled)
    assert pctx.n_vis_for_span() == (n_cells if n_cells == 1000 else 512)
    jt, jl = _steps(jctx, JaxBatch, prompt)
    pt, pl = _steps(pctx, Batch, prompt)
    assert pt == jt
    for a, b in zip(pl, jl):
        assert float(np.abs(a - b).max() / np.abs(b).max()) <= 1e-2
