"""Port parity for kernel 2's two routes and kernel 10's stages on the CPU:
torch emulations of the cooperative stages (csrc/w4_coop.cuh: the walk at
one row, the int8 tensor-core stages above T10) and of the tile route
above T2 (kernel 1's tile for gate|up with h formed in the epilogue, h
re-quantized, kernel 1's tile for down), each in its order of sums,
against the plain versions and JAX's Pallas kernels (interpret mode); the
row thresholds T2 and T10 read from the sources against the wrappers; the
routing at T2 through a stub library; kernel 2's eligibility against the
JAX entry's refusals; and JAX's LKTPU_FFN_FUSED knob.

The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import llama_kotlin_tpu.ops.pallas.qmm_w4 as jax_w4_mod
import llama_kotlin_tpu.ops.pallas.qmm_w4_ffn as jax_ffn_mod
from llama_kotlin_tpu.ops.norms import rms_norm as jax_rms_norm

from llama_kotlin_tpu_torch.ops import qmatmul as port_qmatmul
from llama_kotlin_tpu_torch.ops.activations import ACTIVATIONS
from llama_kotlin_tpu_torch.ops.cuda import qmm_w4_ffn, qmm_w4_layer
from llama_kotlin_tpu_torch.ops.cuda.qmm import UNIT_W4, plan, split_bounds
from llama_kotlin_tpu_torch.ops.cuda.qmm_w4 import (MMA_BM, group_scale_min, quantize_q8,
                                                    raw_codes)
from llama_kotlin_tpu_torch.ops.norms import rms_norm

from test_torch_layer_fused import _layer
from test_torch_qmm_mma import _stub_cuda
from test_torch_qmm_plan import SMS, _rel_err
from test_torch_qmm_w4 import FLAVORS, both_w4
from test_torch_w4_mma import _w4_mma_emulation

E = F = 2048
CSRC = Path(qmm_w4_ffn.__file__).resolve().parents[2] / "csrc"
# the tensor-core stages' group order in a span (csrc/w4_coop.cuh::mma_rows:
# chunk gp's lo group, then its hi group)
MMA_GROUP_ORDER = [0, 4, 1, 5, 2, 6, 3, 7]
KSPLIT, GU_KSPLIT = 8, 1  # warps that split a 16-row group's spans (w4_coop.cuh)


def _terms(x8, sx, xsum, w, halves: bool = False):
    """The exact integer partials of every 32-group (or of each 16-element
    half of it) and the group scales and mins as the kernels form them (a
    sym fold's min as 8 s)."""
    b, K = x8.shape
    G = K // 32
    q = raw_codes(w, slice(None)).to(torch.float32)
    s, m = group_scale_min(w, slice(None))
    if w.flavor == "sym":
        m = 8.0 * s
    xs = x8.to(torch.float32)
    if halves:
        p = torch.einsum("bghc,nghc->bngh", xs.reshape(b, G, 2, 16), q.reshape(-1, G, 2, 16))
    else:
        p = torch.einsum("bgc,ngc->bng", xs.reshape(b, G, 32), q.reshape(-1, G, 32))
    return p, s, m, xsum.to(torch.float32)


def _mma_stage(x: torch.Tensor, w, quantized=None, ksplit: int = KSPLIT) -> torch.Tensor:
    """One tensor-core stage (B > T10): per span the 8 groups' s P - m xsum
    summed in mma_rows' group order, times the row's superblock scale; each
    of `ksplit` warps sums its span range in order; the block adds the
    warps' sums in warp order (gate|up: one warp takes all the spans)."""
    x8, sx, xsum = quantized if quantized is not None else quantize_q8(x)
    p, s, m, xs = _terms(x8, sx, xsum, w)
    t = p * s[None] - xs[:, None, :] * m[None]  # [b, n, G]
    b, n, G = t.shape
    t = t.reshape(b, n, G // 8, 8)[..., MMA_GROUP_ORDER]
    part = t[..., 0]
    for j in range(1, 8):
        part = part + t[..., j]
    span = part * sx[:, None, :]  # [b, n, S]
    out = torch.zeros_like(span[..., 0])
    for s0, s1 in split_bounds(span.shape[-1], ksplit):
        c = torch.zeros_like(out)
        for si in range(s0, s1):
            c = c + span[..., si]
        out = out + c
    return out


def _walk_stage(x: torch.Tensor, w, quantized=None) -> torch.Tensor:
    """One walked stage (B <= T10): w4_dot.cuh's warp-per-row dot.  Lane l
    takes 16 code bytes of each 512-byte window, half of lo group j and half
    of hi group j + 4 of span 4 window + l // 8 (j = l % 8 // 2); the even
    lane of each pair subtracts both groups' min terms; each lane sums its
    windows in order, then the warp's butterfly sum."""
    x8, sx, xsum = quantized if quantized is not None else quantize_q8(x)
    p, s, m, xs = _terms(x8, sx, xsum, w, halves=True)  # p [b, n, G, 2]
    b, n = p.shape[:2]
    lanes = torch.arange(32)
    acc = torch.zeros((b, n, 32))
    for win in range(x8.shape[1] // 1024):
        span = 4 * win + lanes // 8
        glo = span * 8 + (lanes % 8) // 2
        ghi = glo + 4
        half = lanes % 2
        t = s[:, glo] * p[:, :, glo, half] + s[:, ghi] * p[:, :, ghi, half]
        mins = m[:, glo] * xs[:, None, glo] + m[:, ghi] * xs[:, None, ghi]
        t = t - torch.where(half == 0, mins, torch.zeros_like(mins))
        acc = acc + sx[:, None, span] * t
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ off]
    return acc[..., 0]


def _h(g: torch.Tensor, u: torch.Tensor, act: str = "silu") -> torch.Tensor:
    return (ACTIVATIONS[act](g) * u).to(torch.bfloat16).to(torch.float32)


def _coop_emulation(x, gu, dn, up=None):
    """Kernel 2's cooperative launch: gate|up and down on the walk at one
    row, on the tensor cores above T10; h as the plain version forms it."""
    walk = x.shape[0] <= qmm_w4_ffn.COOP_WALK_ROWS
    stage = _walk_stage if walk else _mma_stage
    gu_kw = {} if walk else dict(ksplit=GU_KSPLIT)
    if up is None:
        y = stage(x, gu, **gu_kw)
        g, u = y[:, :F], y[:, F:]
    else:
        q = quantize_q8(x)
        g, u = stage(x, gu, q, **gu_kw), stage(x, up, q, **gu_kw)
    return stage(_h(g, u), dn)


def _tile_emulation(x, gu, dn):
    """Kernel 2 above T2: kernel 1's tile order for gate|up (the gated
    layout permutes columns only) with K split as plan() says for 2F
    columns, h re-quantized by the prologue, kernel 1's tile order for
    down with its own plan."""
    sg = plan(1, 2 * F, E, UNIT_W4, SMS, bms=(MMA_BM,)).splits
    sd = plan(1, E, F, UNIT_W4, SMS, bms=(MMA_BM,)).splits
    y = _w4_mma_emulation(x, gu, sg)
    return _w4_mma_emulation(_h(y[:, :F], y[:, F:]), dn, sd)


@pytest.fixture(scope="module", params=list(FLAVORS))
def ffn_case(request):
    """One flavor's folds and 17 rows of x, with JAX's result (interpret)."""
    flavor = request.param
    jgu, pgu = both_w4(41, 2 * F, E, flavor)
    jdn, pdn = both_w4(42, E, F, flavor)
    x = (np.random.default_rng(43).standard_normal((17, E)) * 0.7).astype(np.float32)
    ref = jax_ffn_mod.qmm_w4_ffn_matmul(jnp.asarray(x), jgu, jdn, act="silu", interpret=True)
    assert ref is not None
    return flavor, torch.from_numpy(x), pgu, pdn, np.asarray(ref)


@pytest.mark.parametrize("b", [1, 5])
def test_coop_emulation_matches_plain_and_jax(ffn_case, b):
    """The cooperative route's order of sums (the walk at b = 1 = T10, the
    tensor cores at 5 rows) on compact, legacy and sym folds: within 5e-3
    of max|y| of qmm_w4_ffn_plain and of JAX's qmm_w4_ffn_matmul (kernel
    2's card tolerance: h is rounded to bf16 and re-quantized, so an f32
    last-bit difference can move one h code)."""
    _, x, gu, dn, ref = ffn_case
    got = _coop_emulation(x[:b], gu, dn)
    assert _rel_err(got, qmm_w4_ffn.qmm_w4_ffn_plain(x[:b], gu, dn, "silu")) < 5e-3
    assert _rel_err(got, ref[:b]) < 5e-3


def test_tile_emulation_matches_plain_and_jax(ffn_case):
    """The tile route above T2 (17 rows: one m16 tile short of two) within
    5e-3 of the plain version and of JAX's kernel."""
    _, x, gu, dn, ref = ffn_case
    got = _tile_emulation(x, gu, dn)
    assert _rel_err(got, qmm_w4_ffn.qmm_w4_ffn_plain(x, gu, dn, "silu")) < 5e-3
    assert _rel_err(got, ref) < 5e-3


@pytest.mark.parametrize("family", ["compact", "sym", "legacy"])
def test_layer_mma_emulation_matches_jax(family):
    """Kernel 10 at 5 rows (above T10): o, gate|up and down on the tensor
    cores' order of sums, the norm op for op as rms_norm, against JAX's
    layer kernel (interpret) within its own 2e-2 of max|h3|
    (tests/test_torch_layer_fused.py) and against JAX's composed route (o,
    residual, rms_norm, FFN apart) within one bf16 ulp of max|h3| (2^-7 of
    it).  The plain version follows the composed route's order and stays
    within 2e-3 of it; this order is another, and h3 is bf16, so an f32
    last-bit difference before a rounding moves an element by one ulp:
    0.125 at |h3| ~ 20 (3.5e-3 of max|h3|, compact), 0.25 at |h3| > 32
    (6.9e-3, legacy)."""
    jops, pops = _layer(family, b=5)
    attn, h, wo, gu, dn, nw = pops
    h2 = h + _mma_stage(attn.to(torch.float32), wo).to(h.dtype)
    r = rms_norm(h2, nw, 1e-5).to(torch.float32)
    y = _mma_stage(r, gu, ksplit=GU_KSPLIT)
    got = (h2 + _mma_stage(_h(y[:, :F], y[:, F:]), dn).to(h.dtype)).to(torch.float32).numpy()
    ref = np.asarray(jax_ffn_mod.qmm_w4_layer_matmul(*jops, eps=1e-5, act="silu",
                                                    interpret=True), np.float32)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-2
    ja, jh, jo, jgu, jdn, jnw = jops
    jh2 = jh + jax_w4_mod.qmm_w4_matmul(ja.astype(jnp.float32), jo, interpret=True).astype(jh.dtype)
    ffn = jax_ffn_mod.qmm_w4_ffn_matmul(jax_rms_norm(jh2, jnw, 1e-5), jgu, jdn, act="silu",
                                        interpret=True)
    comp = np.asarray(jh2 + ffn.astype(jh.dtype), np.float32)
    assert np.abs(got - comp).max() / np.abs(comp).max() <= 2.0 ** -7


def _constant(path: Path, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", path.read_text()).group(1))


def test_thresholds_read_from_the_sources():
    """T2 (qmm_w4_ffn.cu's FFN_COOP_ROWS) is the wrapper's MMA_MIN_ROWS and
    T10 (w4_coop.cuh's WALK_ROWS) its COOP_WALK_ROWS; the cooperative
    stages take at most MAX_ROWS = 8 rows, kernel 10's own limit."""
    assert _constant(CSRC / "qmm_w4_ffn.cu", "FFN_COOP_ROWS") == qmm_w4_ffn.MMA_MIN_ROWS
    assert _constant(CSRC / "w4_coop.cuh", "WALK_ROWS") == qmm_w4_ffn.COOP_WALK_ROWS
    assert _constant(CSRC / "w4_coop.cuh", "MAX_ROWS") == qmm_w4_ffn.COOP_MAX_ROWS \
        == qmm_w4_layer.MAX_ROWS
    assert re.search(r"constexpr int KSPLIT = (\d+), GU_KSPLIT = (\d+);",
                     (CSRC / "w4_coop.cuh").read_text()).groups() == (str(KSPLIT), str(GU_KSPLIT))
    assert qmm_w4_ffn.COOP_WALK_ROWS < qmm_w4_ffn.MMA_MIN_ROWS <= qmm_w4_ffn.COOP_MAX_ROWS
    assert not qmm_w4_ffn.use_mma(qmm_w4_ffn.MMA_MIN_ROWS)
    assert qmm_w4_ffn.use_mma(qmm_w4_ffn.MMA_MIN_ROWS + 1)


@pytest.mark.parametrize("layout", ["fused", "up="])
def test_threshold_routes(layout, monkeypatch):
    """Rows up to T2 take the cooperative launch (no splits, one launch),
    more rows kernel 1's tile with the plan's splits for 2F gate|up columns
    and for down; the fused layout passes its two halves as gate and up;
    every launch counts once, the tile's in LAUNCHES_MMA too."""
    calls = []
    _stub_cuda(monkeypatch, qmm_w4_ffn, calls, "lk_w4_ffn")
    monkeypatch.setattr(qmm_w4_ffn, "check_w4_on", lambda w, dev: None)
    monkeypatch.setattr(qmm_w4_ffn, "workspace_bytes", lambda *a: 16)
    gu, dn = both_w4(51, 2 * F, E, "legacy")[1], both_w4(52, E, F, "legacy")[1]
    gate, up = (gu, None) if layout == "fused" else (gu.row_slice(0, F), gu.row_slice(F, 2 * F))
    l0, m0 = qmm_w4_ffn.LAUNCHES, qmm_w4_ffn.LAUNCHES_MMA
    for b in range(1, 33):
        qmm_w4_ffn.qmm_w4_ffn_matmul(torch.zeros((b, E)), gate, dn, up=up)
    sg = plan(1, 2 * F, E, UNIT_W4, SMS, bms=(MMA_BM,)).splits
    sd = plan(1, E, F, UNIT_W4, SMS, bms=(MMA_BM,)).splits
    t2 = qmm_w4_ffn.MMA_MIN_ROWS
    assert [(c[1], c[22], c[23]) for c in calls] == [
        (b, 0, 0) if b <= t2 else (b, sg, sd) for b in range(1, 33)]
    # gate rows 0..F-1 and up rows F..2F-1 of the fused fold: the halves' pointers
    assert calls[0][2] == gu.codes.data_ptr()
    assert calls[0][7] == gu.codes[F:].data_ptr()
    assert qmm_w4_ffn.LAUNCHES - l0 == 32 and qmm_w4_ffn.LAUNCHES_MMA - m0 == 32 - t2


def _refused_by_jax(x, gu, dn, **kw) -> bool:
    return jax_ffn_mod.qmm_w4_ffn_matmul(x, gu, dn, interpret=True, **kw) is None


def test_ffn_eligibility_matches_jax():
    """ffn_eligible refuses what the JAX entry refuses (it returns None
    before any kernel runs) and takes what it takes, on a grid: the fused
    and the up= layout (taken); F % 1024 != 0 unpadded (F = 1536: the
    port's kernels would take F % 256, JAX's _plan_bf does not, and the
    port takes JAX's answer); gate|up and down of mixed compact flavors;
    gate and up of mixed sym flavors; an up of another shape; a precise
    (W4X) fold; an activation other than silu and gelu.  A compact fold
    below E = 2048 (JAX's other refusal) cannot be drawn: JAX's fold keeps
    the compact layout only where K % 2048 == 0, so at E = 1024 both take
    the legacy fold it gives instead.  qmm_ffn also declines more than 32
    rows, as JAX's does."""
    x = jnp.zeros((2, E), jnp.float32)
    cases = {}
    jgu, pgu = both_w4(61, 2 * F, E, "legacy")
    jdn, pdn = both_w4(62, E, F, "legacy")
    jg, pg = both_w4(63, F, E, "legacy")
    ju, pu = both_w4(64, F, E, "legacy")
    cases["fused"] = ((jgu, jdn, {}), (pgu, pdn, {}), True)
    cases["up="] = ((jg, jdn, dict(up=ju)), (pg, pdn, dict(up=pu)), True)
    F2 = 1536
    jgu2, pgu2 = both_w4(65, 2 * F2, E, "legacy")
    jdn2, pdn2 = both_w4(66, E, F2, "legacy")
    cases["F=1536"] = ((jgu2, jdn2, {}), (pgu2, pdn2, {}), False)
    jdc, pdc = both_w4(67, E, F, "compact")
    cases["mixed compact"] = ((jgu, jdc, {}), (pgu, pdc, {}), False)
    js, ps = both_w4(68, F, E, "sym")
    cases["mixed sym"] = ((jg, jdn, dict(up=js)), (pg, pdn, dict(up=ps)), False)
    jh, ph = both_w4(69, F // 2, E, "legacy")
    cases["up shape"] = ((jg, jdn, dict(up=jh)), (pg, pdn, dict(up=ph)), False)
    E1 = 1024
    jc1, pc1 = both_w4(70, 2 * F, E1, "legacy")
    jd1, pd1 = both_w4(71, E1, F, "legacy")
    cases["E=1024"] = ((jc1, jd1, {}), (pc1, pd1, {}), True)
    from test_torch_layer_fused import _w4
    from llama_kotlin_tpu_torch.convert import qtensor_from_numpy
    wp = _w4(np.random.default_rng(72), 2 * F, E, "legacy", precise=True)
    cases["precise"] = ((jax.tree.map(jnp.asarray, wp), jdn, {}),
                        (qtensor_from_numpy(wp, "cpu"), pdn, {}), False)
    for name, ((jgw, jdw, jkw), (pgw, pdw, pkw), taken) in cases.items():
        xe = x if name != "E=1024" else jnp.zeros((2, E1), jnp.float32)
        assert _refused_by_jax(xe, jgw, jdw, **jkw) == (not taken), name
        assert qmm_w4_ffn.ffn_eligible(pgw, pdw, "silu", pkw.get("up")) == taken, name
    assert _refused_by_jax(x, jgu, jdn, act="relu") and not qmm_w4_ffn.ffn_eligible(pgu, pdn,
                                                                                    "relu")
    assert _refused_by_jax(jnp.zeros((33, E)), jgu, jdn)
    assert port_qmatmul.qmm_ffn(torch.zeros((33, E)), pgu, pdn) is None
    with pytest.raises(ValueError):
        qmm_w4_ffn.qmm_w4_ffn_matmul(torch.zeros((2, E)), pgu, pdc)


def test_ffn_fused_knob(monkeypatch):
    """JAX's LKTPU_FFN_FUSED=0 makes qmm_ffn decline, as JAX's does (the
    unfused route, kernel 2's yardstick); unset or "1" it runs kernel 2,
    whose plain result on the CPU equals qmm_w4_ffn_plain."""
    gu, dn = both_w4(81, 2 * F, E, "sym")[1], both_w4(82, E, F, "sym")[1]
    x = torch.from_numpy((np.random.default_rng(83).standard_normal((2, E)) * 0.7)
                         .astype(np.float32))
    monkeypatch.setenv("LKTPU_FFN_FUSED", "0")
    assert port_qmatmul.qmm_ffn(x, gu, dn) is None
    for value in ("1", None):
        if value is None:
            monkeypatch.delenv("LKTPU_FFN_FUSED")
        else:
            monkeypatch.setenv("LKTPU_FFN_FUSED", value)
        assert torch.equal(port_qmatmul.qmm_ffn(x, gu, dn),
                           qmm_w4_ffn.qmm_w4_ffn_plain(x, gu, dn, "silu"))
