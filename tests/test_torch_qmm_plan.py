"""The host side of kernel 4's split-K GEMM and of kernel 7's tensor-core
path: the tiling plan (ops/cuda/qmm.py::plan), its K splits, a torch
emulation of the kernels' split partials summed in their fixed order
against the plain versions and JAX's Pallas kernels (interpret mode), and
kernel 7's row threshold.

Everything here runs on the CPU: the CUDA kernels themselves are held
against the plain versions on the card by chip_smoke.py."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.ops.pallas.qmm import qmm as jax_qmm
from llama_kotlin_tpu.ops.pallas.qmm_w4 import qmm_w4_matmul as jax_qmm_w4

from llama_kotlin_tpu_torch.models.synthetic import synthetic_w4
from llama_kotlin_tpu_torch.ops.cuda import qmm_w4x
from llama_kotlin_tpu_torch.ops.cuda.qmm import (BMS, UNIT_W4, UNIT_W8, dequantize_bf16, plan,
                                                 qmm_plain, split_bounds)
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import (group_scale_min, quantize_q8_2p,
                                                    raw_codes)
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4x import qmm_w4x_plain

from test_torch_qmm_w4 import both_w4
from test_torch_qmm_w8 import both_w8
from test_torch_w4x import both_precise

SMS = 132  # the H100's SMs
E, F, V = 4096, 14336, 128256
# every projection kernel 4 serves at prefill on llama3-8B: (n, k, unit).
# W4: fused qkv, the split q and k|v of a Q4_K_M layer whose v is W8, o,
# fused gate|up and each of gate and up, down; W8 (q6_K): attn_v, ffn_down
PROJECTIONS = {
    "qkv": (6144, E, UNIT_W4), "q": (E, E, UNIT_W4), "k": (1024, E, UNIT_W4),
    "o": (E, E, UNIT_W4), "gate_up": (2 * F, E, UNIT_W4), "gate": (F, E, UNIT_W4),
    "down": (E, F, UNIT_W4), "lm_head": (V, E, UNIT_W4),
    "w8_attn_v": (1024, E, UNIT_W8), "w8_down": (E, F, UNIT_W8),
}


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("m", [33, 64, 100, 512])
@pytest.mark.parametrize("name", list(PROJECTIONS))
def test_plan_fills_the_card(name, m):
    """At 64 rows (and at every row count here) each projection gets at
    least one block an SM; the plan is one the kernel takes."""
    n, k, unit = PROJECTIONS[name]
    p = plan(m, n, k, unit, SMS)
    assert p.bm in BMS and 1 <= p.splits <= p.units == k // unit
    assert p.tiles == -(-m // p.bm) * -(-n // 128)
    assert p.blocks >= SMS, (name, m, p)
    if p.tiles >= SMS:  # no split where the tiles alone fill the card
        assert p.splits == 1


@pytest.mark.parametrize("n", [1026, 102, 7])
def test_plan_does_not_split_ragged_rows(n):
    """The last block's fixed-order sum reads float4 rows, so a weight
    whose row count is not a multiple of 4 is never split (the kernels
    refuse such a plan); the row tile still covers it."""
    p = plan(64, n, E, UNIT_W4, SMS)
    assert p.splits == 1 and p.tiles == -(-64 // p.bm) * -(-n // 128)


@pytest.mark.parametrize("units,splits", [(16, 1), (16, 5), (16, 16), (56, 5), (64, 17),
                                          (7, 3)])
def test_splits_cover_k(units, splits):
    """The splits tile [0, units) in order, without gap or overlap, each
    at least one unit: whole W4 spans (256) or W8 steps of whole groups
    (64, a multiple of the 16 and 32 groups)."""
    b = split_bounds(units, splits)
    assert b[0][0] == 0 and b[-1][1] == units
    assert all(u1 > u0 for u0, u1 in b)
    assert all(b[i][1] == b[i + 1][0] for i in range(len(b) - 1))
    assert UNIT_W4 % 256 == 0 and UNIT_W8 % 32 == 0 and UNIT_W8 % 16 == 0


@pytest.mark.parametrize("m,n,k,unit", [(64, 4096, 4000, UNIT_W4), (64, 4096, 100, UNIT_W8),
                                        (0, 4096, 4096, UNIT_W4), (64, 0, 4096, UNIT_W8),
                                        (64, 4096, 128, UNIT_W4)])
def test_plan_refuses_what_the_kernel_refuses(m, n, k, unit):
    """No rows, no columns, or a K that is not a whole number of units:
    the kernels' entries return an error, and the plan raises first."""
    with pytest.raises(ValueError):
        plan(m, n, k, unit, SMS)


def _split_emulation(x: torch.Tensor, w, p) -> torch.Tensor:
    """Kernel 4's arithmetic as the split plan orders it: each split's f32
    product over its K range of bf16 operands, then the splits summed in
    index order (the last block's fixed-order sum)."""
    unit = UNIT_W4 if w.bits == 4 else UNIT_W8
    xb = x.to(torch.bfloat16).to(torch.float32)
    wb = dequantize_bf16(w).to(torch.float32)
    parts = [xb[:, u0 * unit:u1 * unit] @ wb[:, u0 * unit:u1 * unit].T
             for u0, u1 in split_bounds(p.units, p.splits)]
    y = parts[0]
    for part in parts[1:]:
        y = y + part
    return y


@pytest.mark.parametrize("layout,m", [("compact", 40), ("sym", 64), ("w8-q6_K", 64),
                                      ("w8-q4_K-mins", 100)])
def test_split_partials_match_plain_and_jax(layout, m):
    """The split partials summed in split order equal qmm_plain within f32
    reassociation (1e-5 of max|y|: 8 splits of bf16 products, no other
    rounding) and JAX's qmm in interpret mode within 1e-3 (the bound of
    tests/test_torch_kernels.py::test_qmm_matches_jax: the Pallas kernel's
    hi/lo bf16 scale reconstruction can move a bf16 weight by one ulp)."""
    n, k = 256, 2048
    if layout.startswith("w8"):
        jw, pw = both_w8(layout[3:], seed=11)
    else:
        jw, pw = both_w4(41, n, k, layout)
    x = (np.random.default_rng(42).standard_normal((m, k)) * 0.7).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    p = plan(m, pw.n, pw.k_pad, UNIT_W4 if pw.bits == 4 else UNIT_W8, SMS)
    assert p.splits > 1  # small widths: K is split in every unit
    got = _split_emulation(xt, pw, p)
    assert _rel_err(got, qmm_plain(xt, pw)) <= 1e-5
    ref = jax_qmm(jnp.asarray(x, jnp.bfloat16), jw, interpret=True)
    assert ref is not None
    assert _rel_err(got, ref) <= 1e-3


def _w4x_mma_emulation(x: torch.Tensor, w, splits: int) -> torch.Tensor:
    """Kernel 7's tensor-core arithmetic: exact int32 partials per 32-group,
    each span's sum_g (s_g P_g - m_g xsum_g) scaled by the row's superblock
    scale, spans accumulated in order within a split, splits summed in
    order, then plane 0 + plane 1."""
    b = x.shape[0]
    x8, sx, xsum = quantize_q8_2p(x)
    q = raw_codes(w, slice(None)).to(torch.float32)
    s, mn = group_scale_min(w, slice(None))
    rows, k = x8.shape
    G = k // 32
    p = torch.einsum("rgc,ngc->rng", x8.to(torch.float32).reshape(rows, G, 32),
                     q.reshape(-1, G, 32))  # exact integers
    t = p * s[None] - xsum.to(torch.float32)[:, None, :] * mn[None]  # [rows, n, G]
    span = t.reshape(rows, w.n, G // 8, 8).sum(dim=-1) * sx[:, None, :]  # [rows, n, S]
    parts = []
    for s0, s1 in split_bounds(G // 8, splits):
        acc = torch.zeros_like(span[..., 0])
        for si in range(s0, s1):
            acc = acc + span[..., si]
        parts.append(acc)
    y = parts[0]
    for part in parts[1:]:
        y = y + part
    return y[:b] + y[b:]


@pytest.mark.parametrize("source,b", [("q4_K", 9), ("q4_K", 32), ("q4_0-sym", 17)])
def test_w4x_mma_emulation_matches_plain_and_jax(source, b):
    """Kernel 7's tensor-core order of sums equals qmm_w4x_plain within
    1e-5 of max|y| (exact integer partials; f32 order only) and JAX's
    qmm_w4_matmul on the precise fold (interpret) within 1e-5, the bound
    of the walk's own parity test."""
    jw, pw, _ = both_precise(source, n=256, k=2048, seed=3)
    x = (np.random.default_rng(b).standard_normal((b, 2048)) * 0.7).astype(np.float32)
    p = plan(1, pw.n, pw.k_pad, UNIT_W4, SMS, bms=(qmm_w4x.MMA_BM,))
    assert p.splits == p.units == 8
    got = _w4x_mma_emulation(torch.from_numpy(x), pw, p.splits)
    assert _rel_err(got, qmm_w4x_plain(torch.from_numpy(x), pw)) <= 1e-5
    ref = jax_qmm_w4(jnp.asarray(x), jax.tree.map(jnp.asarray, jw), interpret=True)
    assert ref is not None
    assert _rel_err(got, ref) <= 1e-5


def test_w4x_threshold_routes(monkeypatch):
    """Rows up to MMA_MIN_ROWS take the walk (splits 0), more rows the
    tensor-core GEMM with K split as plan() says for one 64-row tile, at
    every row count 1..32."""
    seen = []

    class Lib:
        def lk_w4x_gemv(self, x8, sx, xsum, b, codes, gs, gm, n, kc, y, splits, ws, cnt, st):
            seen.append((b, splits))
            return 0

    monkeypatch.setattr(qmm_w4x, "is_cuda", lambda t: True)
    monkeypatch.setattr(qmm_w4x, "check_w4_on", lambda w, dev: None)
    monkeypatch.setattr(qmm_w4x, "quantize_q8_2p_cuda", quantize_q8_2p)
    monkeypatch.setattr(qmm_w4x, "sm_count", lambda index: SMS)
    monkeypatch.setattr(qmm_w4x, "split_workspace", lambda p, rows, n, dev: (None, None))
    monkeypatch.setattr(qmm_w4x._build, "lib", Lib)
    monkeypatch.setattr(qmm_w4x._build, "stream", lambda: 0)
    w = synthetic_w4(np.random.default_rng(0), 64, 512, precise=True, device="cpu")
    for b in range(1, 33):
        qmm_w4x.qmm_w4x_matmul(torch.zeros((b, 512)), w)
    mma = plan(1, w.n, w.k_pad, UNIT_W4, SMS, bms=(qmm_w4x.MMA_BM,)).splits
    assert mma >= 1
    assert seen == [(b, 0 if b <= qmm_w4x.MMA_MIN_ROWS else mma) for b in range(1, 33)]
    assert 1 <= qmm_w4x.MMA_MIN_ROWS < 32
