"""The port's synthetic models (``models/synthetic.py``) against the JAX
package's, on the CPU: the presets letter for letter; the host builders
(``synthetic_q8flat``, ``synthetic_qtensor``, the W4 flavors of
``synthetic_w4`` and ``synthetic_params`` with its qtypes, tied head, int8
and W4/W4X fast flags and the MoE branch's expert policy) bit for bit
against JAX's from the same seed; ``synthetic_params_device`` in every mode
(``w4``, sym ``w4``, ``w4x``, ``int8``, ``dequant``, ``dense``), fused or
not, tied or not, with a Q8F shadow under ``LKTPU_DUAL_FOLD=1``, each
served a prefill and a step; ``tools/batched_bench.py`` with JAX's mode
names; and the quantize tool's per-tensor types (``tensor_get_type``)
against JAX's."""

from __future__ import annotations

import ast
import inspect

import numpy as np
import pytest
import jax
import torch

from llama_kotlin_tpu.models import synthetic as jax_syn
from llama_kotlin_tpu.quant.formats import GGMLQuantType as JaxType
from llama_kotlin_tpu.tools import batched_bench as jax_bb, quantize as jax_quantize

from llama_kotlin_tpu_torch.convert import qtensor_from_numpy
from llama_kotlin_tpu_torch.models import synthetic as syn
from llama_kotlin_tpu_torch.quant import fold
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q
from llama_kotlin_tpu_torch.quant.qtensor import QTensor
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext
from llama_kotlin_tpu_torch.tools import batched_bench


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests' CPU ops are small, and more threads
    only multiply their CPU time when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_presets_match_jax():
    """PRESETS holds JAX's rows, letter for letter (llama2-7b, mistral-7b,
    llama3-70b and JAX's test-tiny among them), and preset_config builds
    JAX's fields."""
    assert syn.PRESETS == jax_syn.PRESETS
    for name in syn.PRESETS:
        ours, ref = syn.preset_config(name), jax_syn.preset_config(name)
        for f in ("n_embd", "n_layer", "n_head", "n_head_kv", "n_ff", "vocab_size", "head_dim",
                  "n_ctx_train", "name"):
            assert getattr(ours, f) == getattr(ref, f), (name, f)


def _same_weight(ours, ref, path: str) -> None:
    """A port weight equals a JAX one: QTensors plane for plane (JAX's
    converted by the port's converter, stacks field by field), dense bf16
    matrices and f32 norms value for value."""
    if isinstance(ref, list):
        assert isinstance(ours, list) and len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _same_weight(a, b, f"{path}[{i}]")
        return
    if ref is None:
        assert ours is None, path
        return
    if hasattr(ref, "codes"):
        ref = jax.tree.map(np.asarray, ref)
        assert isinstance(ours, QTensor), path
        if ref.codes.ndim == 3:  # an expert stack: the exact planes as they are
            assert ours.is_stacked and ours.aux is None and ref.aux is None, path
            for f in ("codes", "g_scale", "g_min", "sb_scale", "sb_min"):
                a, b = getattr(ours, f), getattr(ref, f)
                assert (a is None) == (b is None), (path, f)
                if b is not None:
                    np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{path}.{f}")
            return
        want = qtensor_from_numpy(ref, "cpu")
        assert (ours.flavor, ours.shape, ours.bits, ours.group_size, ours.code_offset) == (
            want.flavor, want.shape, want.bits, want.group_size, want.code_offset), path
        assert ours.tensors().keys() == want.tensors().keys(), path
        for name, t in want.tensors().items():
            assert torch.equal(ours.tensors()[name], t), f"{path}.{name}"
        return
    b = torch.from_numpy(np.asarray(ref).astype(np.float32))
    if ours.dtype == torch.bfloat16:
        b = b.to(torch.bfloat16)  # dense matrices, and the router JAX keeps f32
    assert ours.shape == b.shape and torch.equal(ours, b), path


def _same_params(ours: dict, ref: dict) -> None:
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if k == "layers":
            assert len(ours[k]) == len(v)
            for i, (a, b) in enumerate(zip(ours[k], v)):
                assert set(a) == set(b), i
                for name in b:
                    _same_weight(a[name], b[name], f"layers[{i}].{name}")
        else:
            _same_weight(ours[k], v, k)


def test_host_weights_match_jax():
    """synthetic_q8flat, synthetic_qtensor of every k-quant, legacy and IQ4
    format JAX's probe takes, and synthetic_w4 in its compact, legacy, sym
    and precise flavors: equal to JAX's from the same numpy seed."""
    cases = [("q8f", None), ("w4", {}), ("w4", {"sym": True}), ("w4", {"precise": True}),
             ("w4", {"sym": True, "precise": True})]
    cases += [("qt", q) for q in (Q.Q4_0, Q.Q4_1, Q.Q5_0, Q.Q5_1, Q.Q8_0, Q.Q2_K, Q.Q3_K,
                                  Q.Q4_K, Q.Q5_K, Q.Q6_K, Q.Q8_K, Q.IQ4_NL, Q.IQ4_XS)]
    for i, (kind, arg) in enumerate(cases):
        for n, k in ((256, 2048), (128, 768)):  # compact and legacy widths for W4
            ra, rb = np.random.default_rng(i), np.random.default_rng(i)
            if kind == "q8f":
                ours, ref = syn.synthetic_q8flat(ra, n, k, device="cpu"), jax_syn.synthetic_q8flat(
                    rb, n, k)
            elif kind == "w4":
                ours = syn.synthetic_w4(ra, n, k, device="cpu", **arg)
                ref = jax_syn.synthetic_w4(rb, n, k, **arg)
            else:
                ours = syn.synthetic_qtensor(ra, n, k, arg, device="cpu")
                ref = jax_syn.synthetic_qtensor(rb, n, k, JaxType(int(arg)))
            _same_weight(ours, ref, f"{kind} {arg} [{n},{k}]")


# (qtype, tie_output, fast_int8, fast_w4a8, n_expert)
PARAM_CASES = [
    (None, False, False, False, 0),
    (Q.Q4_K, True, False, False, 0),
    (Q.Q6_K, False, False, False, 0),
    (Q.Q4_K, False, False, True, 0),
    (Q.Q4_0, True, False, True, 0),
    (Q.Q4_K, False, False, "w4x", 0),
    (Q.Q4_K, False, True, False, 0),
    (Q.Q4_K, False, False, True, 4),
    (Q.Q4_K, False, True, False, 4),
    (Q.Q4_K, False, False, False, 4),
    (Q.Q4_K, False, False, True, 20),
    (None, False, False, False, 4),
]


@pytest.mark.parametrize("qtype,tie,int8,w4a8,n_expert", PARAM_CASES)
def test_synthetic_params_match_jax(qtype, tie, int8, w4a8, n_expert):
    """synthetic_params at test-tiny (2 layers) equals JAX's host builder
    from the same seed, weight for weight: dense, exact repacks, W4 (sym for
    Q4_0, W4X), Q8F, a tied head; with experts, the loader's policy (a fast
    layout at E <= 16 a per-expert list, an exact repack a stack, E > 16
    exact stacks, dense a [E, n, k] tensor)."""
    kw = dict(n_layer=2, n_expert=n_expert, n_expert_used=2 if n_expert else 0)
    ours = syn.synthetic_params(syn.preset_config("test-tiny", **kw), qtype, seed=3,
                                tie_output=tie, fast_int8=int8, fast_w4a8=w4a8, device="cpu")
    ref = jax_syn.synthetic_params(jax_syn.preset_config("test-tiny", **kw),
                                   None if qtype is None else JaxType(int(qtype)), seed=3,
                                   tie_output=tie, fast_int8=int8, fast_w4a8=w4a8)
    _same_params(ours, ref)
    if n_expert:
        exps = ours["layers"][0]["ffn_gate_exps"]
        listed = n_expert <= 16 and (int8 or w4a8)
        assert isinstance(exps, list) == listed
        assert isinstance(exps, torch.Tensor) == (qtype is None)


# (mode, qtype, fuse, tie, dual): every mode, sym and the Q6_K/Q8_K exact
# branches, unfused and tied draws, and the dual fold
DEVICE_CASES = [
    ("w4", Q.Q4_K, True, False, False),
    ("w4", Q.Q4_K, False, True, True),
    ("w4", Q.Q4_0, True, False, True),
    ("w4x", Q.Q4_0, False, False, False),
    ("w4x", Q.Q4_K, True, True, True),
    ("int8", Q.Q4_K, True, False, False),
    ("dequant", Q.Q4_K, True, False, False),
    ("dequant", Q.Q6_K, False, True, False),
    ("dequant", Q.Q8_K, True, False, False),
    ("dense", Q.Q4_K, False, False, False),
]
LAYOUT = {"w4": fold.is_w4, "w4x": fold.is_w4x, "int8": fold.is_q8f,
          "dequant": lambda w: fold.is_exact(w) or fold.is_q8_sb(w),
          "dense": lambda w: isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16}


@pytest.mark.parametrize("mode,qtype,fuse,tie,dual", DEVICE_CASES)
def test_device_modes(mode, qtype, fuse, tie, dual, monkeypatch):
    """synthetic_params_device in each mode: every matrix in the mode's
    layout (sym folds for Q4_0; a Q8F shadow on every W4 fold under
    LKTPU_DUAL_FOLD=1 in w4 only), the unfused or fused keys, no output
    when tied; a prefill and a step give finite logits.  A mode JAX lacks
    and a MoE config raise, as JAX's."""
    if dual:
        monkeypatch.setenv("LKTPU_DUAL_FOLD", "1")
    else:
        monkeypatch.delenv("LKTPU_DUAL_FOLD", raising=False)
    cfg = syn.preset_config("test-tiny", n_layer=1)
    p = syn.synthetic_params_device(cfg, seed=2, device="cpu", mode=mode, qtype=qtype,
                                    fuse=fuse, tie_output=tie)
    lp = p["layers"][0]
    keys = {"wqkv_fused", "ffn_gateup_fused"} if fuse else {"wq", "wk", "wv", "ffn_gate",
                                                             "ffn_up"}
    assert keys <= set(lp) and ("output" in p) != tie
    mats = [p["tok_embd"]] + [w for k, w in lp.items() if "norm" not in k]
    for w in mats + ([] if tie else [p["output"]]):
        assert LAYOUT[mode](w), (mode, type(w))
        if mode == "w4":
            assert fold.has_shadow(w) == dual
            assert (w.flavor == "sym") == (qtype == Q.Q4_0)
        if mode == "w4x":
            assert (w.flavor == "w4x_sym") == (qtype == Q.Q4_0) and not fold.has_shadow(w)
    if mode == "w4" and dual:
        w = mats[0]
        assert torch.equal(w.aux["q8_codes"], fold.attach_q8(_no_shadow(w)).aux["q8_codes"])
    ctx = LlamaContext(cfg, p, n_cells=64, device="cpu")
    assert ctx.decode(Batch.single(np.arange(1, 10, dtype=np.int32))) == 0
    assert ctx.decode(Batch.single([3], pos0=9)) == 0
    assert np.isfinite(ctx.get_logits()).all()
    with pytest.raises(ValueError):
        syn.synthetic_params_device(cfg, device="cpu", mode="w8")
    with pytest.raises(NotImplementedError):
        syn.synthetic_params_device(syn.preset_config("test-tiny", n_expert=4,
                                                      n_expert_used=2), device="cpu")


def _no_shadow(w: QTensor) -> QTensor:
    from dataclasses import replace

    return replace(w, aux={k: v for k, v in w.aux.items() if not k.startswith("q8_")})


def _jax_mode_choices() -> list:
    """The --mode choices of JAX's tools/batched_bench.py, read from its
    source (its parser is built inside main)."""
    for node in ast.walk(ast.parse(inspect.getsource(jax_bb))):
        if isinstance(node, ast.Call) and node.args and getattr(node.args[0], "value", "") == \
                "--mode":
            return next(ast.literal_eval(k.value) for k in node.keywords if k.arg == "choices")
    raise AssertionError("no --mode argument in JAX's batched_bench")


@pytest.mark.parametrize("mode", ["int8", "dequant"])
def test_batched_bench_takes_jax_modes(mode, capsys):
    """tools/batched_bench.py takes JAX's --mode names (w4a8, exact, int8,
    dequant) and serves the synthetic model of each on the CPU."""
    assert sorted(batched_bench.SYNTHETIC_MODES) == sorted(_jax_mode_choices())
    rows = batched_bench.main(["--synthetic", "test-tiny", "--mode", mode, "-npp", "8", "-ntg",
                               "2", "-npl", "1", "2", "-c", "128", "--device", "cpu", "-o",
                               "json"])
    assert [r["pl"] for r in rows] == [1, 2] and all(r["s_tg"] > 0 for r in rows)


def test_tensor_get_type_matches_jax():
    """The quantize tool's per-tensor types, ported for ftype_profile: equal
    to JAX's for every file type and tensor kind."""
    assert {k: int(v) for k, v in syn.FTYPES.items()} == {
        k: int(v) for k, v in jax_quantize.FTYPES.items()}
    names = ["output.weight", "token_embd.weight", "blk.0.attn_v.weight",
             "blk.3.ffn_down.weight", "blk.1.attn_q.weight", "blk.2.ffn_gate.weight"]
    for ftype, t in syn.FTYPES.items():
        for name in names:
            assert int(syn.tensor_get_type(name, t, ftype)) == int(jax_quantize.tensor_get_type(
                name, JaxType(int(t)), ftype)), (ftype, name)
