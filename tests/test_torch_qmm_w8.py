"""Port parity for kernel 5 (W8A8 decode matmul), kernel 6 (the Q8F matmul
of the int8 mode) and kernel 4's 8-bit branch (W8 prefill).

The JAX side runs the Pallas kernels in interpret mode on folds of random
wire blocks; the port side runs the plain PyTorch versions of its CUDA
kernels (CPU tensors take them) on its own repack of the same bytes."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.ops.pallas.qmm import qmm as jax_qmm
from llama_kotlin_tpu.ops.pallas.qmm_int8 import qmm_int8 as jax_qmm_int8
from llama_kotlin_tpu.ops.pallas.qmm_int8 import quantize_activations
from llama_kotlin_tpu.ops.pallas.qmm_w8 import qmm_w8_matmul as jax_qmm_w8
from llama_kotlin_tpu.quant import fold as jax_fold, repack as jax_repack
from llama_kotlin_tpu.quant.formats import GGMLQuantType as JaxType
from llama_kotlin_tpu.quant.qtensor import dequantize as jax_dequantize

from llama_kotlin_tpu_torch.models.synthetic import wire_blocks
from llama_kotlin_tpu_torch.ops.cuda.qmm import dequantize_bf16, qmm
from llama_kotlin_tpu_torch.ops.cuda.qmm_int8 import qmm_int8
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import quantize_q8
from llama_kotlin_tpu_torch.ops.cuda.qmm_w8 import qmm_w8_matmul
from llama_kotlin_tpu_torch.quant import fold, repack
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q

N, K = 256, 2048
# W8 sources: Q6_K (group 16), Q8_0 (group 32), and Q4_K folded to W8
# (group 32 with mins: the one layout whose min term runs outside the kernel)
W8_SOURCES = {"q6_K": Q.Q6_K, "q8_0": Q.Q8_0, "q4_K-mins": Q.Q4_K}


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def both_w8(source: str, seed: int = 3):
    """The same W8 fold on both sides: JAX (jnp leaves) and port (CPU)."""
    qtype = W8_SOURCES[source]
    data = wire_blocks(np.random.default_rng(seed), qtype, N, K)
    jw = jax_fold.fold_to_w8(jax_repack.repack(data, JaxType(int(qtype)), N, K))
    pw = fold.fold_to_w8(repack.repack(torch.from_numpy(data), qtype, N, K))
    assert fold.is_w8(pw) and (pw.g_min is not None) == (source == "q4_K-mins")
    return jax.tree.map(jnp.asarray, jw), pw


def _x(b: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((b, K)) * 0.7).astype(np.float32)


@pytest.mark.parametrize("source", list(W8_SOURCES))
@pytest.mark.parametrize("b", [1, 3, 17, 32])
def test_qmm_w8_matches_jax(source, b):
    """Kernel 5's function vs qmm_w8_matmul (interpret).  Both take exact
    integer group partials on identical int8 codes and scale them as
    (p * s_eff) * sx; they differ only in the f32 order of the sum over
    groups (and of the min term's matmul).  Bound: 1e-5 of max|y|."""
    jw, pw = both_w8(source)
    x = _x(b, 40 + b)
    ref = np.asarray(jax_qmm_w8(jnp.asarray(x), jw, interpret=True))
    got = qmm_w8_matmul(torch.from_numpy(x), pw).numpy()
    assert got.shape == (b, N)
    assert _rel_err(got, ref) <= 1e-5


def test_int8_activation_codes_exact():
    """Kernels 5 and 6 take kernel 1's quantizer: codes and scales equal the
    JAX quantize_activations bit for bit at prefill row counts too."""
    x = _x(64, 77)
    x[5, 256:512] = 0.0  # an all-zero superblock takes the safe divisor
    x8, sx = (np.asarray(a) for a in quantize_activations(jnp.asarray(x)))
    p8, psx, _ = quantize_q8(torch.from_numpy(x))
    np.testing.assert_array_equal(p8.numpy(), x8)
    np.testing.assert_array_equal(psx.numpy(), sx)


@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q6_K])
@pytest.mark.parametrize("b", [1, 5, 64])
def test_qmm_int8_matches_jax(qtype, b):
    """Kernel 6's function vs qmm_int8 (interpret) on Q8F conversions of
    Q4_K and Q6_K blocks: exact per-superblock integer partials times
    (sx * sw) in both; the f32 sum over superblocks runs in another order.
    Bound: 1e-5 of max|y|."""
    data = wire_blocks(np.random.default_rng(5), qtype, N, K)
    jw = jax.tree.map(jnp.asarray, jax_repack.repack_q8flat(data, JaxType(int(qtype)), N, K))
    pw = repack.repack_q8flat(torch.from_numpy(data), qtype, N, K)
    x = _x(b, 60 + b)
    ref = np.asarray(jax_qmm_int8(jnp.asarray(x), jw, interpret=True))
    got = qmm_int8(torch.from_numpy(x), pw).numpy()
    assert got.shape == (b, N)
    assert _rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("source", list(W8_SOURCES))
def test_qmm_w8_prefill_matches_jax(source):
    """Kernel 4's 8-bit branch vs the Pallas qmm (interpret) on the W8 fold
    at 64 rows.  The port's weight operand is the JAX dequantization
    rounded to bf16, bit for bit.  Bound 1e-3 of max|y|: f32 summation
    order, plus the Pallas kernel's hi/lo bf16 scale reconstruction, which
    keeps 16 of a q6_K s_eff's up to 17 significant bits and so can move a
    bf16 weight by one ulp."""
    jw, pw = both_w8(source, seed=8)
    np.testing.assert_array_equal(
        dequantize_bf16(pw).to(torch.float32).numpy(),
        np.asarray(jax_dequantize(jw, jnp.float32).astype(jnp.bfloat16), np.float32))
    x = _x(64, 9)
    ref = jax_qmm(jnp.asarray(x, jnp.bfloat16), jw, interpret=True)
    assert ref is not None
    got = qmm(torch.from_numpy(x).to(torch.bfloat16), pw).numpy()
    assert got.shape == (64, N)
    assert _rel_err(got, ref) <= 1e-3
