"""Port parity for kernel 4's exact branches (``csrc/qmm_exact.cu``): the
fused dequant matmul over the exact repacks of the exact-dequant mode.

The JAX side runs the Pallas ``qmm`` in interpret mode on its own repack of
random wire blocks; the port side runs the plain version of its CUDA kernel
(CPU tensors take it) on its repack of the same bytes.  The weight operand
is also held, bit for bit, against a numpy emulation of the order in which
the Pallas kernel forms its tile (``ops/pallas/qmm.py:82-109``)."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.ops.pallas.qmm import qmm as jax_qmm
from llama_kotlin_tpu.ops.pallas.qmm_int8 import qmm_int8 as jax_qmm_int8
from llama_kotlin_tpu.quant import repack as jax_repack
from llama_kotlin_tpu.quant.formats import GGMLQuantType as JaxType
from llama_kotlin_tpu.quant.qtensor import unpack_codes as jax_unpack_codes

import llama_kotlin_tpu_torch.ops.qmatmul as port_qmatmul
from llama_kotlin_tpu_torch.models.synthetic import wire_blocks
from llama_kotlin_tpu_torch.ops.cuda import qmm as qmm_mod
from llama_kotlin_tpu_torch.ops.cuda.qmm import UNIT_EXACT, dequantize_bf16, plan, qmm
from llama_kotlin_tpu_torch.quant import fold, repack
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q

N, K = 256, 512
# every layout of the exact branches: (bits, group, offset, g_scale dtype,
# mins, superblock planes) differ across these
LAYOUTS = ("Q4_0", "Q4_1", "Q4_K", "Q2_K", "Q5_0", "Q5_1", "Q5_K", "Q3_K", "Q6_K", "Q8_0")
ROWS = (1, 9, 64)


def both(name: str, seed: int = 5, n: int = N, k: int = K):
    """The same exact repack on both sides: JAX (jnp leaves) and port (CPU)."""
    qtype = Q[name]
    data = wire_blocks(np.random.default_rng(seed), qtype, n, k)
    jw = jax_repack.repack(data, JaxType(int(qtype)), n, k)
    pw = repack.repack(torch.from_numpy(data), qtype, n, k)
    return jax.tree.map(jnp.asarray, jw), pw


def _x(b: int, seed: int, k: int = K) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((b, k)) * 0.7).astype(np.float32)


def pallas_tile_order(jw) -> np.ndarray:
    """The Pallas kernel's weight tile, emulated in numpy f32: sc = g_scale
    * sb_scale; adj = sc * off, plus g_min * sb_min; w = plane * sc - adj,
    each term only where the layout has it; rounded to bf16 (as f32)."""
    gs = jw.group_size
    f32 = np.float32
    plane = np.asarray(jax_unpack_codes(jw)).astype(f32)
    if jw.bits == 8:  # _codes_i8: uint8 codes read as int8
        plane = np.asarray(jw.codes).view(np.int8).astype(f32)
    sc = np.asarray(jw.g_scale).astype(f32)
    if jw.sb_scale is not None:
        sc = sc * np.repeat(np.asarray(jw.sb_scale, f32), 256 // gs, axis=-1)
    adj = sc * f32(jw.code_offset) if jw.code_offset else None
    if jw.g_min is not None:
        mn = np.asarray(jw.g_min).astype(f32)
        if jw.sb_min is not None:
            mn = mn * np.repeat(np.asarray(jw.sb_min, f32), 256 // gs, axis=-1)
        adj = mn if adj is None else adj + mn
    w = plane * np.repeat(sc, gs, axis=-1)
    if adj is not None:
        w = w - np.repeat(adj, gs, axis=-1)
    return np.asarray(jnp.asarray(w[:, :jw.shape[1]]).astype(jnp.bfloat16), f32)


@pytest.mark.parametrize("name", LAYOUTS)
def test_exact_layouts_and_weight_operand(name):
    """Each format's repack is an exact layout of the kernel (bits, group,
    offset and scale dtypes as the exact branches' table has them), and the
    plain version's bf16 weight operand equals the Pallas tile order bit
    for bit."""
    jw, pw = both(name)
    assert fold.is_exact(pw) and not fold.is_q8_sb(pw)
    expect = {"Q4_0": (4, 32, 8, torch.float32), "Q4_1": (4, 32, 0, torch.float32),
              "Q4_K": (4, 32, 0, torch.uint8), "Q2_K": (2, 16, 0, torch.uint8),
              "Q5_0": (8, 32, 0, torch.float32), "Q5_1": (8, 32, 0, torch.float32),
              "Q5_K": (8, 32, 0, torch.uint8), "Q3_K": (8, 16, 0, torch.int8),
              "Q6_K": (8, 16, 0, torch.int8), "Q8_0": (8, 32, 0, torch.float32)}[name]
    assert (pw.bits, pw.group_size, pw.code_offset, pw.g_scale.dtype) == expect
    np.testing.assert_array_equal(dequantize_bf16(pw).to(torch.float32).numpy(),
                                  pallas_tile_order(jw))


@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("name", LAYOUTS)
def test_exact_branch_matches_pallas(name, b):
    """The plain version of kernel 4's exact branch vs the Pallas qmm
    (interpret) at 1, 9 and 64 rows: the same bf16 operands, so they
    differ only in the f32 summation order.  Bound: 1e-5 of max|y|."""
    jw, pw = both(name, seed=11)
    x = _x(b, 100 + b)
    ref = jax_qmm(jnp.asarray(x), jw, interpret=True)
    assert ref is not None
    got = port_qmatmul.qmatmul(torch.from_numpy(x), pw).numpy()
    ref = np.asarray(ref)
    assert got.shape == (b, N)
    assert float(np.abs(got - ref).max() / np.abs(ref).max()) <= 1e-5


def test_exact_routing(monkeypatch):
    """qmatmul sends an exact repack to kernel 4 at every row count (decode
    included) and a Q8_K repack to kernel 6, by layout: no flavor, no
    refold.  A Q8_K repack through kernel 6's plain version matches JAX's
    qmm_int8 (interpret) within 1e-5 of max|y|."""
    calls = []
    monkeypatch.setattr(port_qmatmul, "qmm", lambda x, w: calls.append("qmm") or "k4")
    monkeypatch.setattr(port_qmatmul, "qmm_int8", lambda x, w: calls.append("int8") or "k6")
    _, pw = both("Q6_K")
    _, q8k = both("Q8_K")
    assert fold.is_q8_sb(q8k) and not fold.is_q8f(q8k) and not fold.is_exact(q8k)
    for b in (1, 32, 64):
        assert port_qmatmul.qmatmul(torch.zeros(b, K), pw) == "k4"
        assert port_qmatmul.qmatmul(torch.zeros(b, K), q8k) == "k6"
    assert calls == ["qmm", "int8"] * 3
    monkeypatch.undo()
    jw8, pw8 = both("Q8_K", seed=3)
    x = _x(9, 21)
    ref = np.asarray(jax_qmm_int8(jnp.asarray(x), jw8, interpret=True))
    got = port_qmatmul.qmatmul(torch.from_numpy(x), pw8).numpy()
    assert float(np.abs(got - ref).max() / np.abs(ref).max()) <= 1e-5


def test_exact_refusals():
    """A layout neither kernel takes raises with a message (no library
    stand-in): an exact repack at group 64, or an exact 8-bit group-256
    layout with mins."""
    _, pw = both("Q8_0")
    g64 = type(pw)(**{**pw.__dict__, "g_scale": pw.g_scale[:, ::2].contiguous(),
                      "group_size": 64})
    assert not fold.is_exact(g64) and not fold.is_q8_sb(g64)
    with pytest.raises(TypeError, match="no kernel serves"):
        port_qmatmul.qmatmul(torch.zeros(1, K), g64)
    with pytest.raises(ValueError, match="exact repack"):
        qmm(torch.zeros(1, K), g64)
    _, q8k = both("Q8_K")
    with_min = type(q8k)(**{**q8k.__dict__, "g_min": q8k.g_scale.clone()})
    with pytest.raises(TypeError, match="no kernel serves"):
        port_qmatmul.qmatmul(torch.zeros(1, K), with_min)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_exact_plan_units(bits):
    """The exact branches' plan: row tiles of 32 and 64 only (the kernel
    instantiates no 128-row tile), K split in whole units (64 elements of
    8-bit codes, a whole span of 4- or 2-bit planes), so a split never cuts
    a span's planes apart, at every row count of the served shapes."""
    for m in (1, 9, 64, 512, 1024):
        for n, k in ((6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336),
                     (128256, 4096)):
            p = plan(m, n, k, UNIT_EXACT[bits], 132, bms=qmm_mod.EXACT_BMS)
            assert p.bm in (32, 64) and 1 <= p.splits <= p.units
            assert p.units * UNIT_EXACT[bits] == k
