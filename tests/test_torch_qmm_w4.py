"""Port parity: the W4 fold and kernel 1 (W4A8 decode matmul).

The JAX side runs the Pallas kernel in interpret mode; the port side runs
the plain PyTorch version of its CUDA kernel on the CPU (CPU tensors take
the plain path).  Inputs come from numpy seeds and reach both sides as the
same numbers."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.ops.pallas.qmm_int8 import quantize_activations
from llama_kotlin_tpu.ops.pallas.qmm_w4 import qmm_w4_matmul as jax_qmm_w4
from llama_kotlin_tpu.quant.fold import fold_to_w4
from llama_kotlin_tpu.models.synthetic import synthetic_w4 as jax_synthetic_w4
from llama_kotlin_tpu.quant.formats import GGMLQuantType
from llama_kotlin_tpu.quant.qtensor import dequantize as jax_dequantize
from llama_kotlin_tpu.quant.repack import repack_float

from llama_kotlin_tpu_torch.convert import qtensor_from_numpy
from llama_kotlin_tpu_torch.models.synthetic import synthetic_w4
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import qmm_w4_matmul, quantize_q8
from llama_kotlin_tpu_torch.quant.qtensor import dequantize

# (qtype, compact) per W4 flavor: Q4_K folds to the compact layout by
# default, or to the legacy bf16 planes; Q4_0 folds to the sym layout
FLAVORS = {
    "compact": (GGMLQuantType.Q4_K, True),
    "legacy": (GGMLQuantType.Q4_K, False),
    "sym": (GGMLQuantType.Q4_0, None),
}


def jax_w4(seed: int, n: int, k: int, flavor: str):
    qtype, compact = FLAVORS[flavor]
    wf = (np.random.default_rng(seed).standard_normal((n, k)) * 0.05).astype(np.float32)
    return jax.tree.map(np.asarray, fold_to_w4(repack_float(wf, qtype), compact=compact))


def both_w4(seed: int, n: int, k: int, flavor: str):
    """The same W4 fold as a JAX QTensor and as a port QTensor on the CPU."""
    w = jax_w4(seed, n, k, flavor)
    port = qtensor_from_numpy(w, "cpu")
    assert port.aux["flavor"] == flavor
    return jax.tree.map(jnp.asarray, w), port


@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_fold_dequant_equals_jax(flavor):
    """The port's fold dequantizes to the JAX values exactly: the same f32
    products and differences on the same codes and scales."""
    jw, pw = both_w4(1, 64, 2048, flavor)
    ref = np.asarray(jax_dequantize(jw, jnp.float32))
    np.testing.assert_array_equal(dequantize(pw).numpy(), ref)


@pytest.mark.parametrize("sym", [False, True])
def test_synthetic_w4_same_draws(sym):
    """The port's numpy generator draws the JAX package's weights."""
    jw = jax_synthetic_w4(np.random.default_rng(5), 128, 2048, sym=sym)
    pw = synthetic_w4(np.random.default_rng(5), 128, 2048, sym=sym, device="cpu")
    conv = qtensor_from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    assert pw.aux["flavor"] == conv.aux["flavor"]
    for name, t in conv.tensors().items():
        assert torch.equal(pw.tensors()[name], t), name


def test_activation_codes_exact():
    """int8 activation codes and scales equal the JAX quantizer bit for bit
    (true division, round-half-to-even)."""
    x = (np.random.default_rng(2).standard_normal((5, 2048)) * 0.7).astype(np.float32)
    x[1, :256] = 0.0  # an all-zero superblock takes the safe divisor
    x8, sx = (np.asarray(a) for a in quantize_activations(jnp.asarray(x)))
    p8, psx, psum = quantize_q8(torch.from_numpy(x))
    np.testing.assert_array_equal(p8.numpy(), x8)
    np.testing.assert_array_equal(psx.numpy(), sx)
    np.testing.assert_array_equal(psum.numpy(),
                                  x8.reshape(5, -1, 32).astype(np.int32).sum(-1))


@pytest.mark.parametrize("flavor", list(FLAVORS))
@pytest.mark.parametrize("b", [1, 3, 32])
def test_qmm_w4_matches_jax(flavor, b):
    """Kernel 1's function vs qmm_w4_matmul (interpret).  Both take exact
    integer group partials on identical int8 codes; they differ only in the
    f32 order of scale products and sums (the JAX kernel scales the hi
    plane as 16(q-8) against s/16 and folds the nibble bias into its min
    term).  Bound: 1e-5 of max|y|, f32 reduction-order noise over k=2048."""
    n, k = 256, 2048
    jw, pw = both_w4(3, n, k, flavor)
    x = (np.random.default_rng(4 + b).standard_normal((b, k)) * 0.7).astype(np.float32)
    ref = np.asarray(jax_qmm_w4(jnp.asarray(x), jw, interpret=True))
    got = qmm_w4_matmul(torch.from_numpy(x), pw).numpy()
    assert got.shape == (b, n)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
