"""Port parity for the cache-shift operations: CellMetadata's sequence ops
(seq_rm, seq_cp, seq_keep, seq_add, seq_div), the K rotation
``apply_k_shift`` on the bf16, int8 and packed int4 caches, and the CLI's
two shift sequences (context shift, self-extend) run on the port's
LlamaContext and the JAX package's, then decoded.  Inputs come from numpy
seeds."""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.ops.rope import RopeParams as JaxRope
from llama_kotlin_tpu.runtime import kv_cache as jax_kv
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.ops.rope import ROPE_TYPE_NEOX, ROPE_TYPE_NORM, RopeParams
from llama_kotlin_tpu_torch.runtime import kv_cache as kv
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from test_torch_stacked import _cache_codes, models  # noqa: F401 (fixture)
from test_torch_model import N_CELLS, N_PROMPT

L, KV, CELLS, D = 2, 2, 300, 128
CACHES = [False, "q8_0", "q4_0"]
CACHE_IDS = ["bf16", "q8_0", "q4_0"]
# the synthetic model's logit tolerance for every cache type
# (tests/test_torch_stacked.py), relative to max|logits|
LOGIT_TOL = 1e-2


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cell_metadata_ops_match_jax(seed):
    """A seeded random run of find_slots/commit (single- and multi-sequence
    cells), seq_rm (one sequence and all), seq_cp, seq_keep, seq_add and
    seq_div on the port's CellMetadata and on JAX's: the slots, the
    returned per-cell deltas, pos, seq, used, used_span and seq_pos_max
    stay equal after every operation."""
    rng = np.random.default_rng(seed)
    n_cells, n_seq = 64, 4
    ours, ref = kv.CellMetadata(n_cells, n_seq), jax_kv.CellMetadata(n_cells, n_seq)
    ops = ("alloc", "alloc", "rm", "cp", "keep", "add", "div")
    for _ in range(120):
        op = ops[rng.integers(len(ops))]
        s = int(rng.integers(n_seq))
        p0 = int(rng.integers(0, 40))
        p1 = -1 if rng.random() < 0.3 else p0 + int(rng.integers(0, 30))
        if op == "alloc":
            n = int(rng.integers(1, 9))
            a, b = ours.find_slots(n), ref.find_slots(n)
            assert (a is None) == (b is None)
            if a is None:
                continue
            np.testing.assert_array_equal(a, b)
            pos = rng.integers(0, 60, n).astype(np.int32)
            ids = np.full(n, s, np.int32)
            mask = rng.integers(1, 1 << n_seq, n).astype(np.int32) if rng.random() < 0.3 else None
            ours.commit(a, pos, ids, mask)
            ref.commit(b, pos, ids, mask)
        elif op == "rm":
            s = -1 if rng.random() < 0.2 else s
            ours.seq_rm(s, p0, p1)
            ref.seq_rm(s, p0, p1)
        elif op == "cp":
            dst = int(rng.integers(n_seq))
            ours.seq_cp(s, dst, p0, p1)
            ref.seq_cp(s, dst, p0, p1)
        elif op == "keep":
            if rng.random() < 0.5:
                continue  # keep is drastic: half as often
            ours.seq_keep(s)
            ref.seq_keep(s)
        elif op == "add":
            delta = int(rng.integers(-20, 21))
            np.testing.assert_array_equal(ours.seq_add(s, p0, p1, delta),
                                          ref.seq_add(s, p0, p1, delta))
        else:
            d = int(rng.integers(2, 5))
            np.testing.assert_array_equal(ours.seq_div(s, p0, p1, d), ref.seq_div(s, p0, p1, d))
        np.testing.assert_array_equal(ours.pos, ref.pos)
        np.testing.assert_array_equal(ours.seq, ref.seq)
        assert ours.used == ref.used and ours.used_span() == ref.used_span()
        assert [ours.seq_pos_max(i) for i in range(n_seq)] == \
            [ref.seq_pos_max(i) for i in range(n_seq)]


@pytest.mark.parametrize("rope_type", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
@pytest.mark.parametrize("cache", CACHES, ids=CACHE_IDS)
def test_apply_k_shift_matches_jax(cache, rope_type):
    """apply_k_shift on the same [2, 2, 300, 128] K (bf16 rows, or the JAX
    quantizer's int8 or int4 codes and scales) with the same deltas (half
    the cells shifted by -200..199, per-dimension frequency factors) as
    JAX's.  The port's cache carries one scratch cell more, over which the
    deltas are padded; V is never touched.

    Cells with delta 0 keep their rows and scales bit for bit on both sides.
    Shifted cells: torch's and XLA's f32 cos/sin differ in the last bit on
    1-3% of the table, so a rotated value can round to the neighbouring
    bf16 value or code; at most one bf16 ulp or one code step, on at most
    1e-4 of the elements (measured: 1.3e-5 and 6.5e-6), and scales within
    5e-7 relative (measured 1.0e-7, a few f32 ulps of amax/127 or /7)."""
    rng = np.random.default_rng(7 + rope_type + len(str(cache)))
    x = rng.standard_normal((L, KV, CELLS, D)).astype(np.float32) * 2.0
    deltas = np.where(rng.random(CELLS) < 0.5, rng.integers(-200, 200, CELLS), 0).astype(np.int32)
    ff = (1.0 + 3.0 * rng.random(D // 2)).astype(np.float32)
    rope_kw = dict(n_rot=D, rope_type=rope_type, freq_base=500000.0)
    t = torch.from_numpy
    pad = lambda a: torch.cat([a, a[:, :, :1]], dim=2)  # the context's scratch cell
    if not cache:
        kb = jnp.asarray(x, jnp.bfloat16)
        ref = jax_kv.KVCache(k=kb, v=kb)
        ours = kv.KVCache(k=pad(t(np.array(kb.astype(jnp.float32))).to(torch.bfloat16)),
                          v=torch.zeros(1))
    else:
        bits = 4 if cache == "q4_0" else 8
        qr = jax_kv.quantize_rows_q4 if bits == 4 else jax_kv.quantize_rows
        c, s = qr(jnp.asarray(x))
        ref = jax_kv.KVCache(k=c, v=c, k_scale=s, v_scale=s, kv_bits=bits)
        ours = kv.KVCache(k=pad(t(np.array(c))), v=torch.zeros(1), k_scale=pad(t(np.array(s))),
                          v_scale=torch.zeros(1), kv_bits=bits)

    def k_values(k) -> np.ndarray:
        k = np.asarray(k.astype(jnp.float32) if isinstance(k, jnp.ndarray) else k.float())
        return _cache_codes(k.astype(np.uint8), 4) if cache == "q4_0" else k

    before = k_values(ref.k)
    out = jax_kv.apply_k_shift(ref, None, deltas, JaxRope(**rope_kw), jnp.asarray(ff))
    assert kv.apply_k_shift(ours, deltas, RopeParams(**rope_kw), t(ff)) is ours
    assert ours.n_cells == CELLS + 1
    moved = deltas != 0
    a, b = k_values(out.k), k_values(ours.k[:, :, :CELLS])
    # one code step, or one bf16 ulp (at most max|x| / 128)
    step = np.maximum(np.abs(a), np.abs(b)) * 2.0 ** -7 if not cache else 1
    if cache:
        sa, sb = np.asarray(out.k_scale), ours.k_scale[:, :, :CELLS].numpy()
        np.testing.assert_array_equal(sa[:, :, ~moved], sb[:, :, ~moved])
        np.testing.assert_allclose(sb, sa, rtol=5e-7, atol=0)
    np.testing.assert_array_equal(a[:, :, ~moved], b[:, :, ~moved])
    np.testing.assert_array_equal(a[:, :, ~moved], before[:, :, ~moved])
    # the rows did rotate (the slow high dimensions keep most of their codes)
    assert (a[:, :, moved] != before[:, :, moved]).mean() > 0.2
    diff = a != b
    assert diff.mean() <= 1e-4
    assert (np.abs(a - b) <= step).all()


def _context_shift(ctx, n_past: int) -> int:
    """The CLI's context shift (tools/main.py:139-143): drop the oldest
    half of sequence 0 and shift the rest down.  Returns the new n_past."""
    n_discard = n_past // 2
    ctx.seq_rm(0, 0, n_discard)
    ctx.seq_add(0, n_discard, -1, -n_discard)
    return n_past - n_discard


def _self_extend(ctx, n_past: int, ga_i: int, ga_n: int = 2, ga_w: int = 8):
    """The CLI's self-extend step (tools/main.py:113-126): seq_add,
    seq_div, seq_add over each full window.  Returns (n_past, ga_i)."""
    while n_past >= ga_i + ga_w:
        ib = (ga_n * ga_i) // ga_w
        bd = (ga_w // ga_n) * (ga_n - 1)
        dd = (ga_w // ga_n) - ib * bd - ga_w
        ctx.seq_add(0, ga_i, n_past, ib * bd)
        ctx.seq_div(0, ga_i + ib * bd, ga_i + ib * bd + ga_w, ga_n)
        ctx.seq_add(0, ga_i + ib * bd + ga_w, n_past + ib * bd, dd)
        n_past = n_past + ib * bd + dd
        ga_i += ga_w // ga_n
    return n_past, ga_i


@pytest.mark.parametrize("sequence", ["context_shift", "self_extend"])
@pytest.mark.parametrize("kv_quant", CACHES, ids=CACHE_IDS)
def test_shift_sequences_match_jax(models, kv_quant, sequence, monkeypatch):  # noqa: F811
    """The CLI's two shift sequences on the synthetic W4A8 model, on each
    cache type, through the port's LlamaContext and the JAX package's:
    a 12-token prefill, then the context shift (seq_rm + seq_add) and 3
    decode steps, or self-extend after the prefill and after each of 5
    decode steps (seq_add, seq_div, seq_add, twice over), on the default
    context as the CLI makes it (stacked; the unrolled path's attention
    after a shift is kernel 3's, held to JAX in test_torch_kv_q4.py).  The
    JAX context decodes greedily and the port takes its tokens; the
    positions stay equal, and every step's logits are within LOGIT_TOL of
    max|logits|."""
    jcfg, jp, cfg, pp = models
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    kw = dict(n_cells=N_CELLS, kv_quant=kv_quant)
    jctx, pctx = JaxContext(jcfg, jp, **kw), LlamaContext(cfg, pp, device="cpu", **kw)
    prompt = np.random.default_rng(21).integers(0, cfg.vocab_size, N_PROMPT).astype(np.int32)
    assert jctx.decode(JaxBatch.single(prompt)) == 0
    assert pctx.decode(Batch.single(prompt)) == 0
    jl, pl = [np.asarray(jctx.get_logits()[-1], np.float32)], [pctx.get_logits()[-1]]
    n_past, ga_i, n_steps = N_PROMPT, 0, 3
    if sequence == "context_shift":
        n_past = _context_shift(jctx, n_past)
        assert _context_shift(pctx, N_PROMPT) == n_past
    else:
        n_steps = 5
    for i in range(n_steps + 1):
        if sequence == "self_extend":
            n_new, ga_new = _self_extend(jctx, n_past, ga_i)
            assert _self_extend(pctx, n_past, ga_i) == (n_new, ga_new)
            n_past, ga_i = n_new, ga_new
        np.testing.assert_array_equal(pctx.meta.pos, jctx.meta.pos)
        if i == n_steps:
            break
        tok = [int(np.argmax(jl[-1]))]
        assert jctx.decode(JaxBatch.single(tok, pos0=n_past)) == 0
        assert pctx.decode(Batch.single(tok, pos0=n_past)) == 0
        jl.append(np.asarray(jctx.get_logits()[-1], np.float32))
        pl.append(pctx.get_logits()[-1])
        n_past += 1
    assert ga_i == (8 if sequence == "self_extend" else 0)  # both windows ran
    errs = [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(pl, jl)]
    assert max(errs) <= LOGIT_TOL, errs
