"""The host side of kernel 5's and kernel 8's int8 tensor-core paths (above
their row thresholds T5 and T8): a torch emulation of each kernel's order
of sums (exact integer group partials, the per-superblock activation scale,
split ranges summed in split order, the plane sum) against the plain
versions and JAX's Pallas kernels in interpret mode; the split plan at the
shapes the served paths give them; the routing at the thresholds; and the
C entries' refusals against what the wrappers pass them.

Everything here runs on the CPU: the CUDA kernels themselves are held
against the plain versions on the card by chip_smoke.py."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import llama_kotlin_tpu.ops.pallas.qmm_w4 as jax_w4_mod
from llama_kotlin_tpu.ops.pallas.qmm_w8 import qmm_w8_matmul as jax_qmm_w8

from llama_kotlin_tpu_torch.models.synthetic import synthetic_w4
from llama_kotlin_tpu_torch.ops.cuda import qmm_w4_fx, qmm_w8
from llama_kotlin_tpu_torch.ops.cuda.qmm import UNIT_W4, plan, split_bounds
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import (group_scale_min, quantize_q8,
                                                    quantize_q8_2p, raw_codes)
from llama_kotlin_tpu_torch.ops.cuda.qmm_w8 import min_term
from llama_kotlin_tpu_torch.quant.fold import is_w8x

from test_torch_qmm_plan import SMS, _rel_err
from test_torch_qmm_w4 import both_w4
from test_torch_qmm_w8 import both_w8
from test_torch_w4x import both_precise

CSRC = Path(__file__).resolve().parents[1] / "llama_kotlin_tpu_torch" / "csrc"
E, F, V, KVD = 4096, 14336, 128256, 1024
N, K = 256, 2048  # the small widths of the parity cases: 8 superblocks, 8 splits
ROWS = (2, 9, 17, 32)
# the shapes each kernel serves at up to 32 rows (llama3-8B): kernel 5 the
# Q4_K_M file's q6_K tensors, kernel 8 the Q4_0 file's layer matrices
W8_SERVED = {"lm_head": (V, E), "ffn_down": (E, F), "attn_v": (KVD, E)}
FX_SERVED = {"qkv": (6144, E), "o": (E, E), "gate_up": (2 * F, E), "down": (E, F)}


def _x(b: int, k: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((b, k)) * 0.7).astype(np.float32)


def _split_sum(span: torch.Tensor, splits: int) -> torch.Tensor:
    """span [rows, n, S], each superblock's scaled partial: summed in order
    within each split's range, then the splits summed in split order (the
    last block's fixed-order sum)."""
    parts = []
    for s0, s1 in split_bounds(span.shape[-1], splits):
        acc = torch.zeros_like(span[..., 0])
        for si in range(s0, s1):
            acc = acc + span[..., si]
        parts.append(acc)
    y = parts[0]
    for part in parts[1:]:
        y = y + part
    return y


def _w8_mma_emulation(x: torch.Tensor, w, splits: int) -> torch.Tensor:
    """Kernel 5's tensor-core order: exact int32 partials per 16/32-group,
    each scaled by its s_eff and summed in group order within the
    superblock, that sum times the row's superblock scale, superblocks and
    splits in order, plane 0 + plane 1; the min term outside, as the
    wrapper subtracts it."""
    b = x.shape[0]
    precise = is_w8x(w)
    x8, sx, _ = quantize_q8_2p(x) if precise else quantize_q8(x)
    rows, k = x8.shape
    gs = w.group_size
    G, per = k // gs, 256 // gs
    p = torch.einsum("rgc,ngc->rng", x8.to(torch.float32).reshape(rows, G, gs),
                     w.codes.to(torch.float32).reshape(-1, G, gs))  # exact integers
    t = (p * w.g_scale[None]).reshape(rows, w.n, G // per, per)
    part = t[..., 0]
    for j in range(1, per):
        part = part + t[..., j]
    y = _split_sum(part * sx[:, None, :], splits)
    if precise:
        y = y[:b] + y[b:]
    if w.g_min is not None:
        mt = min_term(x8, sx, w)
        y = y - (mt[:b] + mt[b:] if precise else mt)
    return y


def _fx_mma_emulation(x: torch.Tensor, w, splits: int) -> torch.Tensor:
    """Kernel 8's tensor-core order: the prologue's codes, exact int32
    partials per 32-group, each span's sum_g (s_g P_g - m_g xsum_g) (a sym
    fold's m_g formed as 8 s_g) times the row's superblock scale, spans and
    splits in order."""
    x8, sx, xsum = quantize_q8(x)
    q = raw_codes(w, slice(None)).to(torch.float32)
    s, mn = group_scale_min(w, slice(None))
    if w.flavor == "sym":
        mn = 8.0 * s
    rows, k = x8.shape
    G = k // 32
    p = torch.einsum("rgc,ngc->rng", x8.to(torch.float32).reshape(rows, G, 32),
                     q.reshape(-1, G, 32))  # exact integers
    t = p * s[None] - xsum.to(torch.float32)[:, None, :] * mn[None]  # [rows, n, G]
    span = t.reshape(rows, w.n, G // 8, 8).sum(dim=-1) * sx[:, None, :]
    return _split_sum(span, splits)


@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("case", ["w8-q6_K", "w8-q8_0", "w8-q4_K-mins", "w8x-q6_K",
                                  "w8x-q8_0"])
def test_w8_mma_emulation_matches_plain_and_jax(case, b):
    """Kernel 5's tensor-core order of sums (groups 16 and 32, with mins,
    both branches) equals qmm_w8_plain within 1e-5 of max|y| (exact integer
    partials; f32 order only: the superblock scale applies to the sum of a
    superblock's scaled partials, where both JAX and the plain version
    scale each group's) and JAX's qmm_w8_matmul in interpret mode within
    1e-5, the bound of the walk's parity test (test_torch_qmm_w8.py)."""
    kind, source = case.split("-", 1)
    if kind == "w8x":
        jw, pw, _ = both_precise(source, n=N, k=K, seed=5)
        jw = jax.tree.map(jnp.asarray, jw)
    else:
        jw, pw = both_w8(source)
    p = plan(1, pw.n, pw.k_pad, qmm_w8.UNIT, SMS, bms=(qmm_w8.MMA_BM,))
    assert p.splits == p.units == K // 256  # small widths: K split in every superblock
    x = _x(b, K, 60 + b)
    got = _w8_mma_emulation(torch.from_numpy(x), pw, p.splits)
    assert _rel_err(got, qmm_w8.qmm_w8_plain(torch.from_numpy(x), pw)) <= 1e-5
    ref = jax_qmm_w8(jnp.asarray(x), jw, interpret=True)
    assert ref is not None
    assert _rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("flavor", ["sym", "legacy"])
def test_fx_mma_emulation_matches_plain_and_jax(flavor, b, monkeypatch):
    """Kernel 8's tensor-core order of sums equals qmm_w4_fx_plain within
    1e-5 of max|y| (exact integer partials; f32 order only) and JAX's
    LKTPU_W4_FX=1 dispatch (qmm_w4_fx in interpret mode) within 1e-5, the
    bound of the walk's parity test (test_torch_qmm_w4_fx.py)."""
    monkeypatch.setenv("LKTPU_W4_FX", "1")
    jw, pw = both_w4(13, N, K, flavor)
    p = plan(1, pw.n, pw.k_pad, UNIT_W4, SMS, bms=(qmm_w4_fx.MMA_BM,))
    assert p.splits == p.units == K // 256
    x = _x(b, K, 80 + b)
    got = _fx_mma_emulation(torch.from_numpy(x), pw, p.splits)
    assert _rel_err(got, qmm_w4_fx.qmm_w4_fx_plain(torch.from_numpy(x), pw)) <= 1e-5
    ref = jax_w4_mod.qmm_w4_matmul(jnp.asarray(x), jw, interpret=True)
    assert ref is not None
    assert _rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("name", list(W8_SERVED))
def test_w8_plan_at_served_shapes(name):
    """Kernel 5 splits K in whole superblocks where its column tiles leave
    SMs idle: attn_v (8 tiles) in every superblock, ffn_down (32 tiles)
    into at least 5 ranges; the lm_head's 1002 tiles fill the card unsplit."""
    n, k = W8_SERVED[name]
    p = plan(1, n, k, qmm_w8.UNIT, SMS, bms=(qmm_w8.MMA_BM,))
    assert p.units == k // 256 and p.tiles == -(-n // 128) and 1 <= p.splits <= p.units
    if name == "lm_head":
        assert p.splits == 1 and p.tiles >= SMS
    else:
        assert p.blocks >= min(SMS, p.tiles * p.units) and p.splits > 1


@pytest.mark.parametrize("name", list(FX_SERVED))
def test_fx_plan_at_served_shapes(name):
    """Kernel 8 takes kernel 7's plan: K split in whole spans until every SM
    has a block (qkv, o, down), none for gate|up's 224 tiles."""
    n, k = FX_SERVED[name]
    p = plan(1, n, k, UNIT_W4, SMS, bms=(qmm_w4_fx.MMA_BM,))
    assert p.units == k // 256 and p.tiles == -(-n // 128)
    assert p.blocks >= SMS
    assert (p.splits == 1) == (p.tiles >= SMS)


def _walk_rows(source: str, name: str) -> int:
    """A C entry's walk limit, as its source declares it."""
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


def _w8_entry_refuses(b, n, k, group, planes, splits, ws, cnt) -> bool:
    """csrc/qmm_w8.cu::lk_w8_gemv's argument check."""
    return (n <= 0 or k <= 0 or k % 512 != 0 or group not in (16, 32) or planes not in (1, 2)
            or not 1 <= b <= 32 or splits < 0 or splits > k // 256
            or (splits == 0 and b > _walk_rows("qmm_w8.cu", "W8_WALK_ROWS"))
            or (splits > 1 and (not ws or not cnt or n % 4 != 0)))


def _fx_entry_refuses(b, n, kc, sym, gm, splits, ws, cnt, x8_out, sx_out, xsum_out) -> bool:
    """csrc/qmm_w4_fx.cu::lk_w4_fx_gemv's argument check."""
    return (n <= 0 or kc <= 0 or kc % 512 != 0 or not 1 <= b <= 32 or (not sym and not gm)
            or splits < 0 or splits > kc // 128
            or (splits == 0 and (b > _walk_rows("qmm_w4_fx.cu", "FX_WALK_ROWS") or x8_out))
            or (splits > 1 and (not ws or not cnt or n % 4 != 0))
            or (not x8_out) != (not sx_out) or (not x8_out) != (not xsum_out))


def test_thresholds_match_the_c_entries():
    """The wrappers' row thresholds T5 and T8 are the walk limits the C
    entries enforce, and at least one row walks."""
    assert qmm_w8.MMA_MIN_ROWS == _walk_rows("qmm_w8.cu", "W8_WALK_ROWS") >= 1
    assert qmm_w4_fx.MMA_MIN_ROWS == _walk_rows("qmm_w4_fx.cu", "FX_WALK_ROWS") >= 1


def _stub_cuda(monkeypatch, mod, calls, entry):
    """The wrapper runs its CUDA branch on CPU tensors and records what it
    passes the C entry (pointers as None or not)."""

    class Lib:
        def __getattr__(self, name):
            assert name == entry, name

            def call(*args):
                calls.append(args[:-1])
                return 0
            return call

    monkeypatch.setattr(mod, "is_cuda", lambda t: True)
    monkeypatch.setattr(mod, "sm_count", lambda index: SMS)
    monkeypatch.setattr(mod._build, "lib", Lib)
    monkeypatch.setattr(mod._build, "stream", lambda: 0)


@pytest.mark.parametrize("case", ["w8-q6_K", "w8x-q8_0"])
def test_w8_threshold_routes(case, monkeypatch):
    """Rows up to T5 take the walk (splits 0), more rows the tensor-core
    GEMM with K split as plan() says for one 64-row tile, at every row
    count 1..32 of both branches; every call is one lk_w8_gemv accepts,
    and the walk above T5 is one it refuses."""
    calls = []
    _stub_cuda(monkeypatch, qmm_w8, calls, "lk_w8_gemv")
    monkeypatch.setattr(qmm_w8, "check_int8_on", lambda w, dev: None)
    monkeypatch.setattr(qmm_w8, "quantize_q8_cuda", quantize_q8)
    monkeypatch.setattr(qmm_w8, "quantize_q8_2p_cuda", quantize_q8_2p)
    kind, source = case.split("-", 1)
    w = both_precise(source, n=N, k=K, seed=5)[1] if kind == "w8x" else both_w8(source)[1]
    for b in range(1, 33):
        qmm_w8.qmm_w8_matmul(torch.zeros((b, K)), w)
    mma = plan(1, w.n, w.k_pad, qmm_w8.UNIT, SMS, bms=(qmm_w8.MMA_BM,)).splits
    assert mma > 1
    t5 = qmm_w8.MMA_MIN_ROWS
    planes = 2 if kind == "w8x" else 1
    assert [(c[2], c[7], c[8], c[10]) for c in calls] == [
        (b, w.group_size, planes, 0 if b <= t5 else mma) for b in range(1, 33)]
    for x8, sx, b, codes, gs, n, k, group, planes, y, splits, ws, cnt in calls:
        assert not _w8_entry_refuses(b, n, k, group, planes, splits, ws, cnt)
    assert _w8_entry_refuses(t5 + 1, N, K, w.group_size, planes, 0, None, None)
    with pytest.raises(ValueError):  # 33 rows: the wrapper raises before the entry
        qmm_w8.qmm_w8_matmul(torch.zeros((33, K)), w)
    assert len(calls) == 32


@pytest.mark.parametrize("flavor", ["sym", "legacy"])
def test_fx_threshold_routes(flavor, monkeypatch):
    """Rows up to T8 take the walk (splits 0), more rows the tensor-core
    GEMM with kernel 7's plan, at every row count 1..32, sym folds without
    their g_min; every call is one lk_w4_fx_gemv accepts; codes_out asks
    for the codes on the tensor-core path only and raises on the CPU's plain
    path and on the walk."""
    calls = []
    _stub_cuda(monkeypatch, qmm_w4_fx, calls, "lk_w4_fx_gemv")
    monkeypatch.setattr(qmm_w4_fx, "check_w4_on", lambda w, dev: None)
    kw = dict(sym=True) if flavor == "sym" else dict(compact=False)
    w = synthetic_w4(np.random.default_rng(0), N, K, device="cpu", **kw)
    assert w.flavor == flavor
    for b in range(1, 33):
        qmm_w4_fx.qmm_w4_fx_matmul(torch.zeros((b, K)), w)
    mma = plan(1, w.n, w.k_pad, UNIT_W4, SMS, bms=(qmm_w4_fx.MMA_BM,)).splits
    assert mma > 1
    t8 = qmm_w4_fx.MMA_MIN_ROWS
    assert [(c[1], c[5], c[9]) for c in calls] == [
        (b, int(flavor == "sym"), 0 if b <= t8 else mma) for b in range(1, 33)]
    assert all((c[4] is None) == (flavor == "sym") for c in calls)
    y, (x8, sx, xsum) = qmm_w4_fx.qmm_w4_fx_matmul(torch.zeros((t8 + 1, K)), w,
                                                   codes_out=True)
    assert calls[-1][12:15] == (x8.data_ptr(), sx.data_ptr(), xsum.data_ptr())
    for x, b, codes, gs, gm, sym, n, kc, y, splits, ws, cnt, x8o, sxo, xso in calls:
        assert not _fx_entry_refuses(b, n, kc, sym, gm, splits, ws, cnt, x8o, sxo, xso)
    assert _fx_entry_refuses(t8 + 1, N, K // 2, 1, None, 0, None, None, None, None, None)
    with pytest.raises(ValueError):  # the walk keeps its codes
        qmm_w4_fx.qmm_w4_fx_matmul(torch.zeros((t8, K)), w, codes_out=True)
    monkeypatch.setattr(qmm_w4_fx, "is_cuda", lambda t: False)
    with pytest.raises(ValueError):  # the plain version has no launch to ask
        qmm_w4_fx.qmm_w4_fx_matmul(torch.zeros((t8 + 1, K)), w, codes_out=True)
