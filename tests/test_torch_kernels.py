"""Port parity for kernels 2-4: the fused W4 FFN, flash attention over the
cell cache and the W4 dequant matmul for prefill rows.

JAX side: the Pallas kernels in interpret mode.  Port side: the plain
PyTorch versions of the CUDA kernels, which CPU tensors take."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.ops.pallas.flash import flash_attention as jax_flash
from llama_kotlin_tpu.ops.pallas.qmm import qmm as jax_qmm
from llama_kotlin_tpu.ops.pallas.qmm_w4_ffn import qmm_w4_ffn_matmul as jax_ffn

from llama_kotlin_tpu_torch.ops.cuda.flash import flash_attention
from llama_kotlin_tpu_torch.ops.cuda.qmm import qmm
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4_ffn import qmm_w4_ffn_matmul

from test_torch_qmm_w4 import both_w4


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("flavor", ["compact", "legacy"])
def test_ffn_matches_jax(act, flavor):
    """Kernel 2's function vs qmm_w4_ffn_matmul (interpret), E=F=2048,
    3 rows.  g and u agree to f32 order noise, but h is rounded to
    bf16 and re-quantized to int8: a last-bit difference can move an h
    element across a bf16 or int8 rounding boundary, which shifts the
    output by one code step of that element.  Bound: 2e-3 of max|y|."""
    E, F, b = 2048, 2048, 3
    jgu, pgu = both_w4(11, 2 * F, E, flavor)
    jdn, pdn = both_w4(12, E, F, flavor)
    x = (np.random.default_rng(13).standard_normal((b, E)) * 0.7).astype(np.float32)
    ref = jax_ffn(jnp.asarray(x), jgu, jdn, act=act, interpret=True)
    assert ref is not None
    got = qmm_w4_ffn_matmul(torch.from_numpy(x), pgu, pdn, act=act).numpy()
    assert got.shape == (b, E)
    assert _rel_err(got, ref) < 2e-3


def test_flash_matches_jax():
    """Kernel 3's function vs flash_attention (interpret): GQA 8 heads on
    2 kv heads, the whole 4D cache with a layer index, n_vis = 256 of 512
    cells, one fully masked row (must give 0, not NaN).  Outputs are bf16:
    bound 1e-2 of max|out|, about two bf16 ulps, for f32 online-softmax
    reassociation before the final rounding."""
    rng = np.random.default_rng(21)
    nt, H, KV, D, L, cells, n_vis = 5, 8, 2, 128, 2, 512, 256
    q = rng.standard_normal((nt, H, D)).astype(np.float32)
    k = rng.standard_normal((L, KV, cells, D)).astype(np.float32)
    v = rng.standard_normal((L, KV, cells, D)).astype(np.float32)
    mask = rng.random((nt, n_vis)) < 0.6
    mask[2] = False  # fully masked row
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jax_flash(jq, jk, jv, jnp.asarray(mask, jnp.int8), scale=D ** -0.5,
                               n_vis=n_vis, layer=1, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, torch.from_numpy(mask).to(torch.int8),
                          scale=D ** -0.5, layer=1)
    assert got.dtype == torch.bfloat16 and got.shape == (nt, H, D)
    got = got.to(torch.float32).numpy()
    assert np.all(got[2] == 0.0)
    assert np.all(np.isfinite(got))
    assert _rel_err(got, ref) < 1e-2


@pytest.mark.parametrize("flavor", ["compact", "sym"])
def test_qmm_matches_jax(flavor):
    """Kernel 4's function vs the Pallas qmm on the W4 fold at 40 rows:
    both feed bf16 weights (f32 plane*s - m, rounded) and bf16 x to an f32
    accumulation.  Bound 1e-3 of max|y|: f32 summation order, plus the
    Pallas kernel's hi/lo bf16 scale reconstruction, which keeps 16 of a
    compact scale's up to 17 significant bits and so can move a bf16
    weight by one ulp."""
    n, k, m = 256, 2048, 40
    jw, pw = both_w4(31, n, k, flavor)
    x = (np.random.default_rng(32).standard_normal((m, k)) * 0.7).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jax_qmm(xb, jw, interpret=True)
    assert ref is not None
    got = qmm(torch.from_numpy(x).to(torch.bfloat16), pw).numpy()
    assert got.shape == (m, n)
    assert _rel_err(got, ref) < 1e-3
