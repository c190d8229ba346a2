"""The host side of kernel 1's int8 tensor-core path (above its row
threshold T1: kernel 7's tile with one plane, the prologue's activation
codes, and a compact fold's 6-bit scale codes in place of f32 planes): the
compact scales as the tile decodes them from the stage, a torch emulation
of the kernel's order of sums (exact integer group partials, each span's
sum times its superblock scale, split ranges summed in split order) against
the plain version and JAX's Pallas kernel in interpret mode, the split plan
at the served shapes, the routing at T1 and the C entry's refusals.

Everything here runs on the CPU: the CUDA kernel itself is held against the
plain version on the card by chip_smoke.py."""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.ops.pallas.qmm_w4 import qmm_w4_matmul as jax_qmm_w4

from llama_kotlin_tpu_torch.models.synthetic import synthetic_w4, synthetic_w4_device
from llama_kotlin_tpu_torch.ops.cuda import qmm_w4
from llama_kotlin_tpu_torch.ops.cuda.qmm import UNIT_W4, plan
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import group_scale_min, quantize_q8, raw_codes

from test_torch_qmm_mma import K, N, ROWS, _split_sum, _stub_cuda, _walk_rows, _x
from test_torch_qmm_plan import SMS, _rel_err
from test_torch_qmm_w4 import FLAVORS, both_w4

E, F, V = 4096, 14336, 128256
# the shapes kernel 1 serves at up to 32 rows (llama3-8B): the decode
# projections, a gate|up-shaped matrix and the lm_head
SERVED = {"qkv": (6144, E), "o": (E, E), "gate_up": (2 * F, E), "lm_head": (V, E)}


def _stage_scales(w):
    """(s, m) [n, G] of a compact fold as span_step forms them: a row's 16
    q6 bytes of a span read as four little-endian 32-bit words (scale codes
    of groups 0..3, of 4..7, min codes of 0..3, of 4..7), group gi's code
    byte gi % 4 of word gi // 4 (min: word 2 + gi // 4), times d and dmin in
    f32."""
    q6, dd = w.aux["q6"], w.aux["dd"]  # [n, S, 16] u8, [n, S, 2] f32
    n, S, _ = q6.shape
    words = (q6.to(torch.int64).reshape(n, S, 4, 4) << (8 * torch.arange(4))).sum(-1)
    gi = torch.arange(8)
    sc = (words[..., gi // 4] >> (8 * (gi % 4))) & 0xFF
    mn = (words[..., 2 + gi // 4] >> (8 * (gi % 4))) & 0xFF
    s = (sc.to(torch.float32) * dd[..., 0:1]).reshape(n, S * 8)
    m = (mn.to(torch.float32) * dd[..., 1:2]).reshape(n, S * 8)
    return s, m


def _w4_mma_emulation(x: torch.Tensor, w, splits: int) -> torch.Tensor:
    """Kernel 1's tensor-core order: the prologue's codes, exact int32
    partials per 32-group, each span's sum_g (s_g P_g - m_g xsum_g) (compact
    scales decoded from the stage words; a sym fold's m_g formed as 8 s_g)
    times the row's superblock scale, spans and splits in order."""
    x8, sx, xsum = quantize_q8(x)
    q = raw_codes(w, slice(None)).to(torch.float32)
    if w.flavor == "compact":
        s, mn = _stage_scales(w)
    else:
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


@pytest.mark.parametrize("source", ["jax-fold", "synthetic", "synthetic-device"])
def test_compact_stage_scales_equal_the_plain_decode(source):
    """The compact scales the tile forms from its stage (byte gi % 4 of q6
    word gi // 4, times d; mins from words 2 and 3, times dmin) equal the
    plain group_scale_min's (and so the walk's) bit for bit."""
    if source == "jax-fold":
        w = both_w4(21, N, K, "compact")[1]
    elif source == "synthetic":
        w = synthetic_w4(np.random.default_rng(22), N, K, device="cpu")
    else:
        gen = torch.Generator().manual_seed(23)
        w = synthetic_w4_device(gen, N, K, zero_mean=False, device="cpu")
    assert w.flavor == "compact"
    s, m = _stage_scales(w)
    ps, pm = group_scale_min(w, slice(None))
    assert torch.equal(s, ps) and torch.equal(m, pm)


@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_w4_mma_emulation_matches_plain_and_jax(flavor, b):
    """Kernel 1's tensor-core order of sums on compact, legacy and sym folds
    equals qmm_w4_plain within 1e-5 of max|y| (exact integer partials; f32
    order only) and JAX's qmm_w4_matmul (qmm_w4_fx2, interpret) within 1e-5,
    the bound of the walk's parity test (test_torch_qmm_w4.py)."""
    jw, pw = both_w4(31, N, K, flavor)
    p = plan(1, pw.n, pw.k_pad, UNIT_W4, SMS, bms=(qmm_w4.MMA_BM,))
    assert p.splits == p.units == K // 256  # small widths: K split in every span
    x = _x(b, K, 90 + b)
    got = _w4_mma_emulation(torch.from_numpy(x), pw, p.splits)
    assert _rel_err(got, qmm_w4.qmm_w4_plain(torch.from_numpy(x), pw)) <= 1e-5
    ref = jax_qmm_w4(jnp.asarray(x), jw, interpret=True)
    assert ref is not None
    assert _rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("name", list(SERVED))
def test_w4_plan_at_served_shapes(name):
    """Kernel 1 takes kernel 7's plan: K split in whole spans until every SM
    has a block (qkv, o), none for gate|up's 224 tiles or the lm_head's
    1002."""
    n, k = SERVED[name]
    p = plan(1, n, k, UNIT_W4, SMS, bms=(qmm_w4.MMA_BM,))
    assert p.units == k // 256 and p.tiles == -(-n // 128)
    assert p.blocks >= SMS
    assert (p.splits == 1) == (p.tiles >= SMS)


def _entry_refuses(b, n, kc, compact, sym, q6, dd, gs, gm, splits, ws, cnt) -> bool:
    """csrc/qmm_w4.cu::lk_w4_gemv's argument check."""
    return (n <= 0 or kc <= 0 or kc % 512 != 0 or not 1 <= b <= 32 or (compact and sym)
            or (not q6 or not dd if compact else not gs or (not sym and not gm))
            or splits < 0 or splits > kc // 128
            or (splits == 0 and b > _walk_rows("qmm_w4.cu", "W4_WALK_ROWS"))
            or (splits > 1 and (not ws or not cnt or n % 4 != 0)))


def test_threshold_matches_the_c_entry():
    """The wrapper's row threshold T1 is the walk limit the C entry
    enforces, and at least one row walks."""
    assert qmm_w4.MMA_MIN_ROWS == _walk_rows("qmm_w4.cu", "W4_WALK_ROWS") >= 1


@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_w4_threshold_routes(flavor, monkeypatch):
    """Rows up to T1 take the walk (splits 0), more rows the tensor-core
    GEMM with kernel 7's plan, at every row count 1..32; a compact fold
    passes its q6/dd planes and no f32 planes, a sym fold its scales without
    g_min, a legacy fold both f32 planes; every call is one lk_w4_gemv
    accepts, and the walk above T1 is one it refuses."""
    calls = []
    _stub_cuda(monkeypatch, qmm_w4, calls, "lk_w4_gemv")
    monkeypatch.setattr(qmm_w4, "check_w4_on", lambda w, dev: None)
    monkeypatch.setattr(qmm_w4, "quantize_q8_cuda", quantize_q8)
    monkeypatch.setattr(qmm_w4, "LAUNCHES_MMA", 0)
    w = both_w4(41, N, K, flavor)[1]
    for b in range(1, 33):
        qmm_w4.qmm_w4_matmul(torch.zeros((b, K)), w)
    mma = plan(1, w.n, w.k_pad, UNIT_W4, SMS, bms=(qmm_w4.MMA_BM,)).splits
    assert mma > 1
    t1 = qmm_w4.MMA_MIN_ROWS
    compact, sym = int(flavor == "compact"), int(flavor == "sym")
    assert [(c[3], c[11], c[12], c[14]) for c in calls] == [
        (b, compact, sym, 0 if b <= t1 else mma) for b in range(1, 33)]
    for x8, sx, xsum, b, codes, q6, dd, gs, gm, n, kc, cp, sm, y, splits, ws, cnt in calls:
        assert (q6 is not None, dd is not None, gs is not None, gm is not None) == (
            bool(compact), bool(compact), not compact, flavor == "legacy")
        assert not _entry_refuses(b, n, kc, cp, sm, q6, dd, gs, gm, splits, ws, cnt)
    assert qmm_w4.LAUNCHES_MMA == 32 - t1
    assert _entry_refuses(t1 + 1, N, K // 2, compact, sym, 1, 1, 1, 1, 0, None, None)
    with pytest.raises(ValueError):  # 33 rows: the wrapper raises before the entry
        qmm_w4.qmm_w4_matmul(torch.zeros((33, K)), w)
    assert len(calls) == 32
