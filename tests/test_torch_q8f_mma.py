"""The host side of kernel 6 (the int8 mode's Q8F matmul) above its row
threshold T6, where it takes int8 tensor cores (csrc/w8_mma.cuh's
q8f_mma_kernel): a torch emulation of the tile's arithmetic (one exact
int32 partial a superblock from eight chained k32 products into an
accumulator at 0x4B400000, one FADD to the f32 partial, scaled by sx sw in
one FMA, superblocks and splits summed in order) against the plain version
(its integer partials bit for bit) and JAX's ``qmm_int8`` in interpret mode;
the split plan at the served shapes; the routing at T6 through a stub
library; and the C entry's refusals against what the wrapper passes it.

Everything here runs on the CPU: the CUDA kernel itself is held against the
plain version on the card by chip_smoke.py."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.ops.pallas.qmm_int8 import qmm_int8 as jax_qmm_int8
from llama_kotlin_tpu.quant import repack as jax_repack
from llama_kotlin_tpu.quant.formats import GGMLQuantType as JaxType

from llama_kotlin_tpu_torch.models.synthetic import wire_blocks
from llama_kotlin_tpu_torch.ops.cuda import qmm_int8
from llama_kotlin_tpu_torch.ops.cuda.qmm import plan, split_bounds
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import quantize_q8
from llama_kotlin_tpu_torch.quant import repack
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q

from test_torch_qmm_plan import SMS, _rel_err

CSRC = Path(__file__).resolve().parents[1] / "llama_kotlin_tpu_torch" / "csrc"
E, F, V = 4096, 14336, 128256
N, K = 256, 2048  # the small widths of the parity cases: 8 superblocks
ROWS = (1, 9, 32, 64, 300)
MAGIC_I, MAGIC_F = 0x4B400000, 12582912.0  # the accumulator's start, 2^23 + 2^22
# kernel 6's shapes on the int8-mode llama3-8B file (Q8F everywhere)
SERVED = {"qkv": (6144, E), "o": (E, E), "gate_up": (2 * F, E), "down": (E, F),
          "lm_head": (V, E)}


def both_q8f(qtype=Q.Q6_K, seed: int = 5):
    """The same Q8F conversion on both sides: JAX (jnp leaves) and port."""
    data = wire_blocks(np.random.default_rng(seed), qtype, N, K)
    jw = jax.tree.map(jnp.asarray, jax_repack.repack_q8flat(data, JaxType(int(qtype)), N, K))
    return jw, repack.repack_q8flat(torch.from_numpy(data), qtype, N, K)


def _x(m: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((m, K)) * 0.7).astype(np.float32)


def _tile_partials(x8: torch.Tensor, w) -> torch.Tensor:
    """The tile's superblock partials [m, n, S]: the exact int32 sum of a
    superblock's eight k32 products added to 0x4B400000, its bits read as
    an f32, minus 2^23 + 2^22 (one FADD)."""
    m, k = x8.shape
    S = k // 256
    p = torch.einsum("msc,nsc->mns", x8.to(torch.float64).reshape(m, S, 256),
                     w.codes.to(torch.float64).reshape(-1, S, 256)).to(torch.int64)
    assert int(p.abs().max()) < 2 ** 22  # the magic accumulator's range
    bits = (p + MAGIC_I).to(torch.int32)
    return bits.view(torch.float32) - torch.tensor(MAGIC_F, dtype=torch.float32)


def _q8f_mma_emulation(x: torch.Tensor, w, splits: int) -> torch.Tensor:
    """Kernel 6's tensor-core order: each superblock's exact partial times
    (sx * sw) added by one FMA (one rounding) in superblock order within a
    split, the splits' partials summed in split order."""
    x8, sx, _ = quantize_q8(x)
    part = _tile_partials(x8, w).to(torch.float64)
    scale = (sx[:, None, :] * w.g_scale[None, :, :]).to(torch.float64)  # f32 product
    parts = []
    for s0, s1 in split_bounds(part.shape[-1], splits):
        acc = torch.zeros(part.shape[:2], dtype=torch.float32)
        for s in range(s0, s1):
            acc = (part[..., s] * scale[..., s] + acc.to(torch.float64)).to(torch.float32)
        parts.append(acc)
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y


@pytest.mark.parametrize("m", ROWS)
def test_q8f_tile_partials_equal_plain(m):
    """The tile's superblock partials (through the magic accumulator) equal
    the plain version's exact partials bit for bit: x codes are clipped to
    +-127 and Q8F weight codes lie in [-127, 127], so |P| <= 256 * 127 *
    127 < 2^22."""
    _, pw = both_q8f()
    assert int(pw.codes.abs().max()) <= 127
    x8, _, _ = quantize_q8(torch.from_numpy(_x(m, 10 + m)))
    assert int(x8.abs().max()) <= 127
    got = _tile_partials(x8, pw)
    ref = qmm_int8.q8f_partials(x8, pw).permute(1, 2, 0)  # [m, n, S]
    assert torch.equal(got, ref)


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q6_K])
def test_q8f_mma_emulation_matches_plain_and_jax(qtype, m):
    """Kernel 6's tensor-core order of sums, with the plan's split count and
    with one and three splits, equals qmm_int8_plain within 1e-5 of max|y|
    (exact partials; f32 order only) and JAX's qmm_int8 (interpret) within
    1e-5, the bound of the walk's parity test (test_torch_qmm_w8.py), at 1,
    9, 32, 64 and 300 rows (one row tile, and five with the last partial)."""
    jw, pw = both_q8f(qtype)
    x = torch.from_numpy(_x(m, 30 + m))
    p = plan(m, pw.n, pw.k_pad, qmm_int8.UNIT, SMS, bms=qmm_int8.MMA_BMS)
    assert p.splits == p.units == K // 256  # small widths: K split in every superblock
    plain = qmm_int8.qmm_int8_plain(x, pw)
    ref = np.asarray(jax_qmm_int8(jnp.asarray(x.numpy()), jw, interpret=True))
    for splits in (p.splits, 3, 1):
        got = _q8f_mma_emulation(x, pw, splits)
        assert _rel_err(got, plain) <= 1e-5
        assert _rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("name", list(SERVED))
def test_q8f_plan_at_served_shapes(name):
    """The tile's plan at the served shapes: a 64-row tile and 128 weight
    rows a block, K split in whole superblocks until every SM has a block
    where K allows; at 64 rows down (32 column tiles) takes at least 132
    blocks, and 512 rows fill the card with row tiles alone."""
    n, k = SERVED[name]
    for m in (3, 16, 32, 64, 512):
        p = plan(m, n, k, qmm_int8.UNIT, SMS, bms=qmm_int8.MMA_BMS)
        assert p.bm == 64 and p.units == k // 256
        assert p.tiles == -(-m // 64) * -(-n // 128)
        assert p.blocks >= min(SMS, p.tiles * p.units)
        assert (p.splits == 1) == (p.tiles >= SMS)
    assert plan(64, E, F, 256, SMS, bms=(64,)).blocks >= SMS
    assert plan(512, 6144, E, 256, SMS, bms=(64,)).splits == 1


def _walk_rows() -> int:
    m = re.search(r"constexpr int Q8F_WALK_ROWS = (\d+);", (CSRC / "qmm_int8.cu").read_text())
    assert m, "Q8F_WALK_ROWS not found in qmm_int8.cu"
    return int(m.group(1))


def _entry_refuses(m, n, k, bm, splits, ws, cnt) -> bool:
    """csrc/qmm_int8.cu::lk_q8f_matmul's argument check."""
    return (m <= 0 or n <= 0 or k <= 0 or k % 256 != 0 or splits < 0 or splits > k // 256
            or (splits == 0 and m > _walk_rows())
            or (splits > 0 and bm not in (16, 32, 64))
            or (splits > 1 and (not ws or not cnt or n % 4 != 0)))


def test_threshold_matches_the_c_entry():
    """The wrapper's T6 is the walk limit the C entry enforces, and at
    least one row walks."""
    assert qmm_int8.MMA_MIN_ROWS == _walk_rows() >= 1


def test_q8f_threshold_routes(monkeypatch):
    """Rows up to T6 take the walk (splits 0), more rows the tensor-core
    tile with the plan's row tile (16 or 32 rows where m is smaller) and K
    split as plan() says, at every row count 1..70 and 300; every call is
    one lk_q8f_matmul accepts, with a workspace of [splits, m, n] and
    counters exactly where K is split."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            assert name == "lk_q8f_matmul", name
            return lambda *args: calls.append(args[:-1]) or 0

    monkeypatch.setattr(qmm_int8, "is_cuda", lambda t: True)
    monkeypatch.setattr(qmm_int8, "sm_count", lambda index: SMS)
    monkeypatch.setattr(qmm_int8, "check_int8_on", lambda w, dev: None)
    monkeypatch.setattr(qmm_int8, "quantize_q8_cuda", quantize_q8)
    monkeypatch.setattr(qmm_int8._build, "lib", Lib)
    monkeypatch.setattr(qmm_int8._build, "stream", lambda: 0)
    _, w = both_q8f()
    rows = list(range(1, 71)) + [300]
    before = (qmm_int8.LAUNCHES, qmm_int8.LAUNCHES_MMA)
    for m in rows:
        qmm_int8.qmm_int8(torch.zeros((m, K)), w)
    t6 = qmm_int8.MMA_MIN_ROWS
    want = []
    for m in rows:
        p = plan(m, N, K, 256, SMS, bms=qmm_int8.MMA_BMS)
        want.append((m, 0, 0) if m <= t6 else
                    (m, 16 if m <= 16 else 32 if m <= 32 else p.bm, p.splits))
    assert [(c[2], c[8], c[9]) for c in calls] == want
    for x8, sx, m, codes, sw, n, k, y, bm, splits, ws, cnt in calls:
        assert not _entry_refuses(m, n, k, bm, splits, ws, cnt)
        assert (ws is None) == (cnt is None) == (splits <= 1)
    assert (qmm_int8.LAUNCHES - before[0], qmm_int8.LAUNCHES_MMA - before[1]) == (
        len(rows), sum(m > t6 for m in rows))


def test_q8f_entry_refusals():
    """lk_q8f_matmul refuses the walk above T6, a row tile other than 16,
    32 or 64, a K off the superblock grid, more splits than superblocks,
    and a split K without its workspace or with n off the float4 grid; it
    takes the walk at T6 and the tile at any row count."""
    t6 = _walk_rows()
    assert not _entry_refuses(t6, N, K, 0, 0, None, None)
    assert _entry_refuses(t6 + 1, N, K, 0, 0, None, None)
    assert not _entry_refuses(1, N, K, 16, 1, None, None)
    assert not _entry_refuses(300, N, K, 64, 8, 1, 1)
    assert _entry_refuses(40, N, K, 48, 1, None, None)
    assert _entry_refuses(8, N, K + 128, 16, 1, None, None)
    assert _entry_refuses(8, N, K, 16, K // 256 + 1, 1, 1)
    assert _entry_refuses(8, N, K, 16, 2, None, 1)
    assert _entry_refuses(8, N + 2, K, 16, 2, 1, 1)
    assert _entry_refuses(0, N, K, 16, 1, None, None)
