"""Port parity for the GGUF container and the load-time conversions: the
port's reader and writer against the JAX package's, and its torch repack,
W4 fold, W8 fold and Q8F conversion against the JAX package's numpy ones,
bit for bit.  Wire bytes come from the port's random block generator
(numpy seeds), so both sides read the same bytes."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import torch

from llama_kotlin_tpu.gguf.reader import GGUFFile as JaxGGUFFile
from llama_kotlin_tpu.gguf.writer import GGUFWriter as JaxGGUFWriter
from llama_kotlin_tpu.quant import fold as jax_fold, numpy_ref, repack as jax_repack
from llama_kotlin_tpu.quant.formats import GGMLQuantType as JaxType

from llama_kotlin_tpu_torch.convert import qtensor_from_numpy
from llama_kotlin_tpu_torch.gguf.reader import GGUFFile
from llama_kotlin_tpu_torch.gguf.writer import GGUFWriter
from llama_kotlin_tpu_torch.models.synthetic import wire_blocks
from llama_kotlin_tpu_torch.quant import fold, repack
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType, TYPE_TRAITS, row_byte_size

Q = GGMLQuantType
# (qtype, n, k): Q4_K at a compact and a legacy (k = 768, padded) width,
# Q6_K, and Q8_0 at a width that pads to 1024
CASES = [(Q.Q4_K, 48, 2048), (Q.Q4_K, 16, 768), (Q.Q6_K, 48, 2048), (Q.Q8_0, 48, 2048),
         (Q.Q8_0, 16, 800)]
IDS = [f"{q.name}-{k}" for q, _n, k in CASES]


def _wire(qtype, n, k, seed=0):
    return wire_blocks(np.random.default_rng(seed), qtype, n, k)


def _same_metadata(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for key in a:
        va, vb = a[key], b[key]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
        else:
            assert va == vb, key


def _fill(w, flt):
    """The same KVs and tensors through either writer's API."""
    w.add_kv("general.architecture", "llama")
    w.add_kv("llama.block_count", np.uint32(2))
    w.add_kv("llama.rope.freq_base", np.float32(500000.0))
    w.add_kv("tokenizer.ggml.tokens", ["a", "b", "<s>"])
    w.add_kv("tokenizer.ggml.scores", np.array([0.5, -1.0, 0.0], np.float32))
    w.add_kv("some.flag", True)
    w.add_tensor("norm.weight", flt)
    w.add_tensor("w.weight", _wire(Q.Q4_K, 8, 512), ggml_type=Q.Q4_K, raw_shape=(512, 8))
    w.add_tensor("v.weight", _wire(Q.Q6_K, 4, 256, 1), ggml_type=Q.Q6_K, raw_shape=(256, 4))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gguf_roundtrip_both_readers(tmp_path, writer):
    """A file written by either writer reads identically through both
    readers: metadata, tensor index and every tensor's bytes."""
    flt = np.random.default_rng(2).standard_normal((3, 64)).astype(np.float32)
    w = GGUFWriter() if writer == "port" else JaxGGUFWriter()
    _fill(w, flt)
    path = tmp_path / "t.gguf"
    w.write(path)
    ours, ref = GGUFFile(path), JaxGGUFFile(path)
    try:
        _same_metadata(ours.metadata, ref.metadata)
        assert list(ours.tensors) == list(ref.tensors) == ["norm.weight", "w.weight", "v.weight"]
        for name, info in ours.tensors.items():
            ri = ref.tensors[name]
            assert (info.shape, int(info.ggml_type), info.offset, info.n_bytes) == (
                ri.shape, int(ri.ggml_type), ri.offset, ri.n_bytes)
            np.testing.assert_array_equal(ours.tensor_data(name).numpy(), ref.tensor_data(name))
        np.testing.assert_array_equal(ours.tensor_data("norm.weight").view(torch.float32)
                                      .reshape(3, 64).numpy(), flt)
    finally:
        ours.close()
        ref.close()


def test_writer_streams_and_checks_sizes(tmp_path):
    """A streamed tensor is drawn at write time; a wrong byte count and a
    float array with a quantized type raise."""
    calls = []
    w = GGUFWriter()
    w.add_tensor_stream("a.weight", (256, 2), Q.Q8_0,
                        lambda: calls.append(1) or _wire(Q.Q8_0, 2, 256))
    assert not calls
    w.write(tmp_path / "a.gguf")
    assert calls == [1]
    with GGUFFile(tmp_path / "a.gguf") as f:
        assert f.tensors["a.weight"].n_bytes == 2 * row_byte_size(256, Q.Q8_0)
    bad = GGUFWriter()
    bad.add_tensor_stream("b.weight", (256, 2), Q.Q8_0, lambda: np.zeros(3, np.uint8))
    with pytest.raises(ValueError, match="wire bytes"):
        bad.write(tmp_path / "b.gguf")
    with pytest.raises(NotImplementedError, match="quantize"):
        GGUFWriter().add_tensor("c.weight", np.zeros((2, 256), np.float32), ggml_type=Q.Q4_K)


def test_type_traits_size_every_type():
    """Every ggml type the reader may meet has the JAX package's geometry."""
    from llama_kotlin_tpu.quant.formats import TYPE_TRAITS as JAX_TRAITS

    assert {int(t) for t in TYPE_TRAITS} == {int(t) for t in JAX_TRAITS}
    for t, tr in TYPE_TRAITS.items():
        jt = JAX_TRAITS[JaxType(int(t))]
        assert (tr.name, tr.block_size, tr.type_size, tr.is_quantized) == (
            jt.name, jt.block_size, jt.type_size, jt.is_quantized)


@pytest.mark.parametrize("qtype,n,k", CASES, ids=IDS)
def test_repack_and_folds_equal_jax(qtype, n, k):
    """The port's torch repack, its fold (W4 for Q4_K, W8 otherwise) and its
    Q8F conversion equal the JAX package's bit for bit, dtypes included."""
    data = _wire(qtype, n, k, seed=n + k)
    ref = jax_repack.repack(data, JaxType(int(qtype)), n, k)
    got = repack.repack(torch.from_numpy(data), qtype, n, k)
    for f in ("codes", "g_scale", "g_min", "sb_scale", "sb_min"):
        a, b = getattr(ref, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a = np.asarray(a)
            assert b.numpy().dtype == a.dtype and np.array_equal(b.numpy(), a), f
    folds = [(jax_fold.fold_to_w8, fold.fold_to_w8)]
    if qtype == Q.Q4_K:
        folds.insert(0, (jax_fold.fold_to_w4, fold.fold_to_w4))
    for jax_fn, port_fn in folds:
        conv = qtensor_from_numpy(jax.tree.map(np.asarray, jax_fn(ref)), "cpu")
        ours = port_fn(got)
        assert ours.flavor == conv.flavor and ours.shape == conv.shape
        assert ours.tensors().keys() == conv.tensors().keys()
        for name, t in conv.tensors().items():
            assert ours.tensors()[name].dtype == t.dtype and torch.equal(ours.tensors()[name], t), name
    q8 = jax_repack.repack_q8flat(data, JaxType(int(qtype)), n, k)
    ours = repack.repack_q8flat(torch.from_numpy(data), qtype, n, k)
    np.testing.assert_array_equal(ours.codes.numpy(), np.asarray(q8.codes))
    np.testing.assert_array_equal(ours.g_scale.numpy(), np.asarray(q8.g_scale))


@pytest.mark.parametrize("qtype", [Q.F32, Q.F16, Q.Q8_0, Q.Q4_K, Q.Q6_K])
def test_wire_decode_equals_numpy_ref(qtype):
    """dequantize_wire equals the JAX package's wire decoders bit for bit."""
    n, k = 6, 512
    rng = np.random.default_rng(9)
    if TYPE_TRAITS[qtype].is_quantized:
        data = wire_blocks(rng, qtype, n, k)
    else:
        x = rng.standard_normal((n, k)).astype(np.float32 if qtype == Q.F32 else np.float16)
        data = x.reshape(-1).view(np.uint8)
    ref = numpy_ref.dequantize(data, JaxType(int(qtype)), shape=(n, k))
    got = repack.dequantize_wire(torch.from_numpy(data.copy()), qtype, (n, k))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_unported_formats_raise():
    """Formats of a later slice raise rather than load wrong."""
    data = torch.zeros(row_byte_size(256, Q.Q5_K) * 2, dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="item 6"):
        repack.repack(data, Q.Q5_K, 2, 256)
    with pytest.raises(NotImplementedError, match="item 6"):
        repack.repack_q8flat(data, Q.Q5_K, 2, 256)
