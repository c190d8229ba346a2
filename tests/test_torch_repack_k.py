"""Port parity for the Q5_0, Q5_1, Q2_K, Q3_K, Q5_K and Q8_K repacks
(``llama_kotlin_tpu_torch/quant/repack.py``) and what is built on them: the
2-bit plane unpack, the wire decode, the W8 fold (W8X) and Q8F, the
QTensor operations on exact repacks, and the loader's routing of each
format in the four modes.

Wire bytes come from ``models/synthetic.py::wire_blocks`` (a numpy seed);
the JAX side is its own repack, ``quant/numpy_ref.dequantize``,
``quant/fold.fold_to_w8`` and ``repack_q8flat``.  Everything is bit-equal."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from llama_kotlin_tpu.quant import fold as jax_fold, numpy_ref, repack as jax_repack
from llama_kotlin_tpu.quant.formats import GGMLQuantType as JaxType
from llama_kotlin_tpu.quant.qtensor import unpack_codes as jax_unpack_codes

from llama_kotlin_tpu_torch.models.loader import _convert
from llama_kotlin_tpu_torch.models.synthetic import wire_blocks
from llama_kotlin_tpu_torch.quant import fold, repack
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q
from llama_kotlin_tpu_torch.quant.qtensor import concat_qtensors, dequantize, unpack_codes

NEW = ("Q5_0", "Q5_1", "Q2_K", "Q3_K", "Q5_K", "Q8_K")
N, K = 64, 768  # three spans: the padding-free k-quant case, 24 legacy blocks a row
PLANES = ("codes", "g_scale", "g_min", "sb_scale", "sb_min")


def _wire(name: str, seed: int = 2, n: int = N, k: int = K) -> np.ndarray:
    return wire_blocks(np.random.default_rng(seed), Q[name], n, k)


def _equal(ref, got, what: str) -> None:
    """Every plane of a JAX QTensor equals the port's: dtype, shape, bits."""
    for f in PLANES:
        a, b = getattr(ref, f), getattr(got, f)
        assert (a is None) == (b is None), f"{what}: {f} present on one side only"
        if a is not None:
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype, f"{what}: {f} {a.dtype} vs {b.dtype}"
            np.testing.assert_array_equal(b.numpy(), a, err_msg=f"{what}: {f}")
    assert (ref.bits, ref.group_size, ref.code_offset, tuple(ref.shape)) == (
        got.bits, got.group_size, got.code_offset, tuple(got.shape))


@pytest.mark.parametrize("name", NEW)
def test_new_repacks_equal_jax(name):
    """One case a format: the repack (codes, scale planes and their dtypes),
    the unpacked codes, dequantize_wire against numpy_ref, the W8 fold
    (plain and precise) where the group is 16 or 32, and Q8F, all bit-equal
    to the JAX package's."""
    data = _wire(name)
    jt = JaxType(int(Q[name]))
    ref = jax_repack.repack(data, jt, N, K)
    got = repack.repack(torch.from_numpy(data), Q[name], N, K)
    _equal(ref, got, name)
    np.testing.assert_array_equal(unpack_codes(got).numpy(), np.asarray(jax_unpack_codes(ref)))
    np.testing.assert_array_equal(
        repack.dequantize_wire(torch.from_numpy(data), Q[name], (N, K)).numpy(),
        numpy_ref.dequantize(data, jt, shape=(N, K)))
    if ref.group_size in (16, 32):
        for precise in (False, True):
            jw8 = jax_fold.fold_to_w8(ref, precise=precise)
            pw8 = fold.fold_to_w8(got, precise=precise)
            assert (fold.is_w8x if precise else fold.is_w8)(pw8)
            _equal(jw8, pw8, f"{name} W8 precise={precise}")
    q8 = jax_repack.repack_q8flat(data, jt, N, K)
    p8 = repack.repack_q8flat(torch.from_numpy(data), Q[name], N, K)
    assert fold.is_q8f(p8)
    np.testing.assert_array_equal(p8.codes.numpy(), np.asarray(q8.codes))
    np.testing.assert_array_equal(p8.g_scale.numpy(), np.asarray(q8.g_scale))


@pytest.mark.parametrize("name", NEW)
def test_wire_blocks_zero_mean_groups(name):
    """The synthetic blocks of each new format decode to weights with
    zero-mean groups (greedy decoding of a random model needs them) of a
    trained matrix's scale."""
    w = numpy_ref.dequantize(_wire(name, 7, 256, 4096), JaxType(int(Q[name])),
                             shape=(256, 4096))
    assert 0.005 < float(w.std()) < 0.05
    assert float(np.abs(w.mean(axis=1)).max()) < 0.1 * float(w.std())


def test_pack2_plane_layout():
    """_pack2 writes element 64p + j of a span into bits 2p..2p+1 of byte j,
    and unpack_codes reads it back; k is padded to whole spans."""
    codes = torch.from_numpy(np.random.default_rng(0).integers(0, 4, (3, 512), dtype=np.uint8))
    packed = repack._pack2(codes)
    assert packed.shape == (3, 128)
    for p in range(4):
        np.testing.assert_array_equal(((packed[:, :64] >> (2 * p)) & 3).numpy(),
                                      codes[:, 64 * p:64 * p + 64].numpy())
    qt = repack._make(Q.Q2_K, codes[:, :300], 2, 16, 3, 300,
                      g_scale=torch.ones(3, 19, dtype=torch.uint8))
    assert qt.k_pad == 512 and qt.g_scale.shape == (3, 32)
    np.testing.assert_array_equal(unpack_codes(qt)[:, :300].numpy(), codes[:, :300].numpy())
    assert not unpack_codes(qt)[:, 300:].any()


@pytest.mark.parametrize("mode", [None, "w4", "w4x", "int8"])
def test_loader_routes_each_format(mode):
    """The loader's layout of each wire format in each mode, as JAX's
    _repack_w4 and repack_q8flat route them: the exact repack (None);
    4-bit group-32 -> W4/W4X; other groups 16/32 -> W8/W8X; Q8_K -> Q8F
    (w4) or its exact repack (w4x); everything Q8F in int8."""
    for name in NEW + ("Q4_0", "Q4_1", "Q4_K", "Q6_K", "Q8_0"):
        w = _convert(torch.from_numpy(_wire(name, 4, 128, 512)), Q[name], 128, 512, mode)
        rp = repack.repack(torch.from_numpy(_wire(name, 4, 128, 512)), Q[name], 128, 512)
        if mode == "int8":
            assert fold.is_q8f(w), name
        elif mode is None:
            assert w.flavor is None and w.bits == rp.bits, name
            assert (fold.is_q8_sb if name == "Q8_K" else fold.is_exact)(w), name
        elif rp.bits == 4 and rp.group_size == 32:
            assert (fold.is_w4x if mode == "w4x" else fold.is_w4)(w), name
        elif rp.group_size in (16, 32):
            assert (fold.is_w8x if mode == "w4x" else fold.is_w8)(w), name
        else:
            assert (fold.is_q8_sb(w) and w.flavor is None) if mode == "w4x" else fold.is_q8f(w)


@pytest.mark.parametrize("name", ["Q2_K", "Q3_K", "Q5_K"])
def test_exact_planes_carry(name):
    """concat_qtensors, row_slice and rows carry an exact repack's integer
    group planes and its superblock planes unchanged (dtypes included): the
    loader's row chunks and the fused projections concatenate repacks, the
    embedding gathers rows."""
    data = _wire(name, 8)
    whole = repack.repack(torch.from_numpy(data), Q[name], N, K)
    half = data.reshape(N, -1)
    parts = [repack.repack(torch.from_numpy(half[r0:r0 + N // 2].copy()), Q[name], N // 2, K)
             for r0 in (0, N // 2)]
    for got in (concat_qtensors(parts), whole.row_slice(0, N)):
        assert got.tensors().keys() == whole.tensors().keys()
        for key, t in whole.tensors().items():
            assert got.tensors()[key].dtype == t.dtype and torch.equal(got.tensors()[key], t)
    ids = torch.tensor([5, 0, 63, 5])
    sub = whole.rows(ids)
    np.testing.assert_array_equal(dequantize(sub).numpy(), dequantize(whole)[ids].numpy())
    np.testing.assert_array_equal(dequantize(whole.row_slice(8, 24)).numpy(),
                                  dequantize(whole)[8:24].numpy())
