"""The learned-position and LayerNorm-gelu architectures JAX serves through
its llama decoder, on the port against the JAX package: one seeded GGUF
file a member (2 layers, E 256; models/synthetic.py::family_config and
synthetic_gguf write each with the tensors its llama.cpp files carry)
through both loaders and contexts in the exact mode, prefill then token by
token (tests/test_torch_moe.py::served_parity): gpt2 (learned positions,
fused qkv, biases everywhere), starcoder (the same on one kv head, a tied
head), gptneox (its parallel block with ffn_norm, quarter rope), falcon
(7B's one kv head and one norm; 40B's several kv heads and attn_norm_2),
mpt (ALiBi, no biases), phi2 (head dim 80, partial rope, q/k/v and output
biases, the shared-norm parallel block), bloom (the embedding LayerNorm,
ALiBi), jais (ALiBi, a biased gated silu FFN), nemotron (relu^2) and
chatglm (packed swiglu, RMS norms, half rope); and one ``w4`` case, a
falcon whose fused qkv, o and down rows no 128 divides (Falcon-7B's
routing at a narrow width, K = 320 on llama.cpp's Q5_0 fallback), JAX in
interpret mode.  Also: the config field for field, kernel 3 declined by
JAX's own predicate (ALiBi, head dim 80), can_stack as JAX's, positions
past the table, relu^2 and the packed swiglu bit for bit, kernel 2
declining jais's biased gate, and convert.py carrying the new tensors.

The exact contexts run JAX op by op (jax.disable_jit) on JAX's CPU routes,
which compute the function of its kernels: JAX's logits equal the port's
to ~1e-7 of max|logits| but where a bf16 rounding parts by one ulp
(measured up to 4.1e-3 on mpt, 1.4e-3 on phi2; tests/test_torch_arch_family.py
says more)."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.models import llama as jax_llama
from llama_kotlin_tpu.models.config import config_from_metadata as jax_config
from llama_kotlin_tpu.models.llama import can_stack as jax_can_stack
from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.ops.activations import ACTIVATIONS as JAX_ACTIVATIONS
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.convert import params_from_numpy
from llama_kotlin_tpu_torch.models import llama as llama_model
from llama_kotlin_tpu_torch.models.config import config_from_metadata
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import family_config, file_metadata, synthetic_gguf
from llama_kotlin_tpu_torch.ops.activations import ACTIVATIONS
from llama_kotlin_tpu_torch.ops.attention import flash_declines
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from test_torch_moe import served_parity

N_CELLS = 256
N_STEPS = 3  # decode steps after the prefill (op by op, each costs JAX ~0.1 s a layer)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tests' many small CPU ops: more only
    multiplies their CPU time when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# each member's own keys, as family_config names them (the others at its
# defaults: 2 layers, E 256, 4 heads on 2 kv heads, F 512, vocab 512), the
# head grouping of its published models: gpt2, gptneox, mpt, phi2, bloom
# and jais MHA, starcoder and falcon-7b one kv head, falcon-40b grouped
# (its new decoder architecture: attn_norm_2); gptneox's quarter rope
# (pythia), phi2's 80-wide heads with 32 of them rotated (phi-2's E 2560 on
# 32 heads, partial_rotary_factor 0.4), nemotron's and chatglm's half rope
MEMBERS = {
    "gpt2": dict(n_head_kv=4), "starcoder": dict(n_head_kv=1),
    "gptneox": dict(n_head_kv=4, rope_dim=16), "falcon": dict(n_head_kv=1),
    "falcon-40b": dict(n_head_kv=2), "mpt": dict(n_head_kv=4),
    "phi2": dict(n_embd=320, n_head_kv=4, rope_dim=32), "bloom": dict(n_head_kv=4),
    "jais": dict(n_head_kv=4), "nemotron": dict(rope_dim=32), "chatglm": dict(rope_dim=32)}
DECLINED = ("mpt", "bloom", "jais", "phi2")  # ALiBi, or phi2's head dim 80


def _arch(label: str) -> str:
    return label.removesuffix("-40b")


def _family_file(path, label: str, seed: int, **keys):
    cfg = family_config(_arch(label), **dict(MEMBERS[label], **keys))
    synthetic_gguf(path, cfg, seed=seed)
    return path


CFG_FIELDS = ("arch", "n_embd", "n_layer", "n_head", "n_head_kv", "n_ff", "head_dim",
              "v_head_dim", "rope_dim", "rope_type", "rms_eps", "norm_eps", "use_rms_norm",
              "ffn_gated", "attn_qkv_bias", "tie_word_embeddings", "parallel_residual",
              "max_alibi_bias", "act", "vocab_size", "n_ctx_train", "attn_scale",
              "learned_pos_embd", "token_embd_norm", "swiglu_packed")


@pytest.mark.parametrize("label", sorted(MEMBERS))
def test_config_matches_jax(label):
    """config_from_metadata on the metadata synthetic_gguf writes for each
    member gives JAX's config field for field, rope parameters included:
    LayerNorm, gelu and a non-gated FFN for the gpt2 family; no rope for
    gpt2, starcoder, mpt, bloom and jais; learned positions for gpt2 and
    starcoder; ALiBi for mpt, bloom and jais; bloom's embedding norm; the
    parallel blocks of gptneox (its use_parallel_residual key), falcon and
    phi2; chatglm's packed swiglu; nemotron's relu^2."""
    cfg = family_config(_arch(label), **MEMBERS[label])
    meta = dict(file_metadata(cfg))
    ours, ref = config_from_metadata(meta), jax_config(meta)
    for f in CFG_FIELDS:
        assert getattr(ours, f) == pytest.approx(getattr(ref, f), rel=1e-7), f
        assert getattr(cfg, f) == pytest.approx(getattr(ref, f), rel=1e-7), f
    assert vars(ours.rope_params()) == vars(ref.rope_params())
    assert (ours.max_alibi_bias > 0) == (label in ("mpt", "bloom", "jais"))
    assert ours.learned_pos_embd == (label in ("gpt2", "starcoder"))
    assert ours.parallel_residual == (label in ("gptneox", "falcon", "falcon-40b", "phi2"))
    if label == "gptneox":  # the key decides: a sequential gptneox file
        seq = dict(meta, **{"gptneox.use_parallel_residual": False})
        assert not config_from_metadata(seq).parallel_residual
        assert not jax_config(seq).parallel_residual


def _count_routes(monkeypatch) -> dict:
    """Calls of kernel 3's wrapper and of the plain route in the forward."""
    calls = {"flash": 0, "plain": 0}
    for attr, key in (("flash_attention", "flash"), ("cache_attention_reference", "plain")):
        real = getattr(llama_model, attr)
        monkeypatch.setattr(llama_model, attr, lambda *a, _r=real, _k=key, **kw: (
            calls.__setitem__(_k, calls[_k] + 1), _r(*a, **kw))[1])
    return calls


# the members' served logits parted from JAX's op-by-op run by a bf16 ulp
# somewhere (measured 4.1e-3 of max|logits| on mpt, 1.4e-3 on phi2, 1.3e-3
# on jais, 6.9e-4 on falcon; the rest 2e-7): tol 1e-2 for every member, as
# tests/test_torch_arch_family.py's
TOL = 1e-2


@pytest.mark.parametrize("label", sorted(MEMBERS))
def test_member_serves_like_jax(tmp_path, monkeypatch, label):
    """Each member's file in both packages' default contexts, exact mode
    (fuse=True), a 12-token prefill and N_STEPS steps by served_parity
    within TOL; both contexts unrolled or both stacked; kernel 3's wrapper
    attends where JAX's flash kernel would, and the plain route
    (cache_attention_reference, as JAX's XLA) where its predicate declines:
    ALiBi (mpt, bloom, jais) and head dim 80 (phi2)."""
    seed = 80 + sorted(MEMBERS).index(label)
    path = _family_file(tmp_path / f"{label}.gguf", label, seed)
    jcfg, jp, jf = jax_load(path, fuse=True)
    cfg, pp, f = load_gguf_model(path, fuse=True, device="cpu")
    jf.close()
    f.close()
    calls = _count_routes(monkeypatch)
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu")
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS)
    assert ("layers_stacked" in pctx.params) == ("layers_stacked" in jctx.params)
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, 12).astype(np.int32)
    with jax.disable_jit(True):
        served_parity(jctx, pctx, prompt, N_STEPS, TOL, min_decided=1)
    declines = flash_declines(cfg.head_dim, cfg.v_head_dim, cfg.max_alibi_bias)
    assert declines == (label in DECLINED)
    if "layers" in pctx.params:
        n = cfg.n_layer * (1 + N_STEPS)
        assert calls == ({"flash": 0, "plain": n} if declines else {"flash": n, "plain": 0})
    lp = (pctx.params.get("layers") or pctx.params["layer_views"])[0]
    assert ("attn_norm_2" in lp) == (label == "falcon-40b")
    assert ("pos_embd" in pp) == (label in ("gpt2", "starcoder"))


def test_falcon_w4_serves_like_jax(tmp_path, monkeypatch):
    """A falcon at Falcon-7B's routing, narrow: E 320 (5 heads of 64 on one
    kv head, F 1280), so its fused qkv (448 rows), o and down (320) are rows
    no block of 128 divides and take kernel 4 at decode in both packages,
    while up (1280) takes kernel 5; K = 320 puts every matrix that reads E
    on llama.cpp's Q5_0 fallback (W8 folds) and the Q4_K downs fold W4.  The
    w4 contexts (JAX in interpret mode, so that it quantizes the matmul
    inputs to int8 where the port does), a 12-token prefill and N_STEPS
    steps within 3.5e-2 (tests/test_torch_deepseek2.py's w4 bound on a bf16
    cache; measured 1.3e-2)."""
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    cfg = family_config("falcon", n_embd=320, n_head=5, n_head_kv=1, n_ff=1280)
    path = tmp_path / "falcon-w4.gguf"
    synthetic_gguf(path, cfg, seed=91)
    jcfg, jp, jf = jax_load(path, fast_mode="w4", fuse=True)
    cfg, pp, f = load_gguf_model(path, fast_mode="w4", fuse=True, device="cpu")
    jf.close()
    f.close()
    lp = pp["layers"][0]
    assert lp["wqkv_fused"].shape == (448, 320) and lp["wqkv_fused"].qtype == Q.Q5_0
    assert {lp[k].flavor for k in ("wqkv_fused", "wo", "ffn_up")} == {"w8"}
    assert lp["ffn_down"].qtype == Q.Q4_K and lp["ffn_down"].flavor == "compact"
    hit = []
    from llama_kotlin_tpu_torch.ops import qmatmul as port_qmatmul

    for attr, name in (("qmm_w4_matmul", "kernel 1"), ("qmm_w8_matmul", "kernel 5"),
                       ("qmm", "kernel 4")):
        real = getattr(port_qmatmul, attr)
        monkeypatch.setattr(port_qmatmul, attr, lambda *a, _r=real, _n=name, **kw: (
            hit.append((_n, a[1].shape[0], a[0].shape[0])), _r(*a, **kw))[1])
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu")
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 12).astype(np.int32)
    served_parity(jctx, pctx, prompt, N_STEPS, 3.5e-2, min_decided=1)
    decode = {(name, n) for name, n, rows in hit if rows == 1}
    assert decode == {("kernel 4", 448), ("kernel 4", 320), ("kernel 5", 1280),
                      ("kernel 5", 512)}, decode


@pytest.mark.parametrize("label", sorted(MEMBERS))
def test_can_stack_matches_jax(tmp_path, label):
    """can_stack gives JAX's answer on each member's unfused load (every
    layer with the same keys): ALiBi keeps mpt, bloom and jais unrolled,
    learned positions, the parallel blocks, attn_norm_2 and the packed FFN
    stack, as JAX's rule (llama_kotlin_tpu/models/llama.py:39-51)."""
    path = _family_file(tmp_path / f"{label}.gguf", label, 70)
    jcfg, jp, jf = jax_load(path)
    cfg, pp, f = load_gguf_model(path, device="cpu")
    jf.close()
    f.close()
    assert len({frozenset(lp) for lp in pp["layers"]}) == 1
    assert [frozenset(lp) for lp in pp["layers"]] == [frozenset(lp) for lp in jp["layers"]]
    ours = llama_model.can_stack(pp, cfg)
    assert ours == jax_can_stack(jp, jcfg) == (label not in ("mpt", "bloom", "jais"))


def test_positions_past_the_table_clamp_as_jax(tmp_path):
    """A starcoder whose position table has 8 rows, served past it (a
    6-token prompt and 6 steps: positions 0-11): JAX's gather at max(pos,
    0) clamps a row past the table to the last (XLA's out-of-range rule),
    and so does the port (a torch index past the table would raise here
    and fault on the card).  Both op by op, within TOL; a step at position
    12 reads row 7."""
    path = _family_file(tmp_path / "starcoder8.gguf", "starcoder", 73, n_ctx_train=8)
    jcfg, jp, jf = jax_load(path, fuse=True)
    cfg, pp, f = load_gguf_model(path, fuse=True, device="cpu")
    jf.close()
    f.close()
    assert pp["pos_embd"].shape == (8, cfg.n_embd) and pp["pos_embd"].dtype == torch.bfloat16
    pctx = LlamaContext(cfg, pp, n_cells=64, device="cpu")
    jctx = JaxContext(jcfg, jp, n_cells=64)
    prompt = np.random.default_rng(73).integers(0, cfg.vocab_size, 6).astype(np.int32)
    with jax.disable_jit(True):
        served_parity(jctx, pctx, prompt, 6, TOL, min_decided=1)
    rows = []
    real = llama_model.take_rows

    def spy(w, ids, dtype=torch.float32):
        if w is pp["pos_embd"]:
            rows.append(ids.tolist())
        return real(w, ids, dtype=dtype)

    llama_model.take_rows = spy
    try:
        assert pctx.decode(Batch.single([5], pos0=12)) == 0
    finally:
        llama_model.take_rows = real
    assert rows == [[7]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relu2_and_packed_swiglu_match_jax(dtype):
    """relu and relu^2 (nemotron) bit for bit JAX's on the same inputs, in
    f32 and bf16; chatglm's packed swiglu on an f32 up projection (what
    both forwards give it): its halves are JAX's split bit for bit (the
    gate first), and silu(gate) * up within 3e-7 of JAX's (torch's and
    XLA's f32 exp may part by an ulp)."""
    x = np.random.default_rng(5).standard_normal((7, 64)).astype(np.float32) * 3
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    for name in ("relu", "relu2"):
        got = ACTIVATIONS[name](xt)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.to(torch.float32).numpy(), f32(JAX_ACTIVATIONS[name](xj)))
    g, u = torch.from_numpy(x).chunk(2, dim=-1)
    gj, uj = jnp.split(jnp.asarray(x), 2, axis=-1)
    np.testing.assert_array_equal(g.numpy(), f32(gj))
    np.testing.assert_array_equal(u.numpy(), f32(uj))
    np.testing.assert_allclose((ACTIVATIONS["silu"](g) * u).numpy(),
                               f32(JAX_ACTIVATIONS["silu"](gj) * uj), rtol=3e-7, atol=0)


def test_jais_gate_bias_declines_kernel_2(tmp_path, monkeypatch):
    """jais's gate and up carry biases, which apply to the split products:
    neither loader fuses gate|up (JAX loader.py:309-319), and neither
    forward asks the FFN megakernel (JAX's qmm_ffn is not reached where a
    gate bias is, llama.py:403-417; the port's _ffn does not call qmm_ffn):
    a 4-token prefill and a step in the w4 mode (JAX in interpret mode)."""
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    path = _family_file(tmp_path / "jais.gguf", "jais", 74)
    jcfg, jp, jf = jax_load(path, fast_mode="w4", fuse=True)
    cfg, pp, f = load_gguf_model(path, fast_mode="w4", fuse=True, device="cpu")
    jf.close()
    f.close()
    for layers in (jp["layers"], pp["layers"]):
        assert all("ffn_gateup_fused" not in lp and "ffn_gate_b" in lp for lp in layers)
    calls = {"jax": 0, "port": 0}
    real_j, real_p = jax_llama.qmm_ffn, llama_model.qmm_ffn
    monkeypatch.setattr(jax_llama, "qmm_ffn", lambda *a, **k: (
        calls.__setitem__("jax", calls["jax"] + 1), real_j(*a, **k))[1])
    monkeypatch.setattr(llama_model, "qmm_ffn", lambda *a, **k: (
        calls.__setitem__("port", calls["port"] + 1), real_p(*a, **k))[1])
    for ctx, batch in ((JaxContext(jcfg, jp, n_cells=64), JaxBatch),
                       (LlamaContext(cfg, pp, n_cells=64, device="cpu"), Batch)):
        assert ctx.decode(batch.single([3, 17, 42, 9])) == 0
        assert ctx.decode(batch.single([5], pos0=4)) == 0
    assert calls == {"jax": 0, "port": 0}


@pytest.mark.parametrize("label,keys", [
    ("gpt2", {"pos_embd"}), ("bloom", {"tok_norm", "tok_norm_b"}),
    ("falcon-40b", {"attn_norm_2", "attn_norm_2_b"}), ("jais", {"ffn_gate_b"}),
    ("phi2", {"output_b"})])
def test_convert_carries_new_tensors(tmp_path, label, keys):
    """params_from_numpy of JAX's loaded params carries the family's new
    tensors across with the values and dtypes the port's loader gives them:
    the position table (bf16, as both loaders keep it), bloom's embedding
    LayerNorm, falcon-40b's attn_norm_2, jais's gate bias and phi2's output
    bias (f32)."""
    path = _family_file(tmp_path / f"{label}.gguf", label, 75)
    jcfg, jp, jf = jax_load(path)
    cfg, pp, f = load_gguf_model(path, device="cpu")
    jf.close()
    f.close()
    conv = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    seen = set()
    for key in keys:
        pairs = ([(conv[key], pp[key])] if key in pp else
                 [(jl[key], pl[key]) for jl, pl in zip(conv["layers"], pp["layers"])])
        for got, want in pairs:
            assert got.dtype == want.dtype and torch.equal(got, want), key
            seen.add(key)
    assert seen == keys
