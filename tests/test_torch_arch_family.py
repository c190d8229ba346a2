"""The llama-shaped architectures JAX serves through its llama decoder, on
the port against the JAX package: one seeded GGUF file a member (2 layers,
E 256; models/synthetic.py::family_config and synthetic_gguf write each
with the tensors its llama.cpp files carry) through both loaders and
contexts in the exact mode, prefill then token by token
(tests/test_torch_moe.py::served_parity): qwen (fused qkv and bias),
stablelm (q/k/v biases, [head_dim] q/k norms, quarter rope), phi3 (fused
qkv, head dim 96, a sliding window), internlm2, minicpm (a tied head),
xverse, exaone, baichuan (7B; 13B's ALiBi at 40 layers), starcoder2
(biases, a non-gated FFN), refact (ALiBi), plamo (the shared-norm parallel
block), and the LayerNorm ones: orion (biased), command-r (parallel block,
[n_head, head_dim] q/k LayerNorms, logit scale, tied head), olmo
(non-parametric, clamp_kqv) and codeshell (fused qkv, biases, non-gated
gelu FFN).  Also: kernel 3 declined by JAX's own predicate (ALiBi, head
dim 96) for the plain route, ALiBi's slopes and bias against JAX's, such
models unrolled (can_stack False), the fused-qkv split bit-equal to JAX's,
and convert.py carrying the family's tensors across.

The JAX contexts run op by op (jax.disable_jit) on JAX's CPU routes, which
compute the function of its kernels: op by op, JAX's logits equal the
port's to ~1e-7 of max|logits| but where a bf16 rounding parts by one ulp
(jitted, XLA's excess precision moves them by a few 1e-3)."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.models.config import config_from_metadata as jax_config
from llama_kotlin_tpu.models.llama import can_stack as jax_can_stack
from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.ops.attention import alibi_slopes as jax_alibi_slopes
from llama_kotlin_tpu.ops.attention import attention_reference as jax_attention_reference
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.convert import params_from_numpy
from llama_kotlin_tpu_torch.models import llama as llama_model
from llama_kotlin_tpu_torch.models.config import config_from_metadata
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import (family_config, file_metadata,
                                                     qwen1_5_moe_a2_7b, synthetic_gguf)
from llama_kotlin_tpu_torch.ops.attention import (alibi_slopes, attention_reference,
                                                  flash_declines)
from llama_kotlin_tpu_torch.quant.qtensor import QTensor
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
# defaults: 2 layers, E 256, 4 heads on 2 kv heads, F 512, vocab 512):
# phi3's 4 heads of 96 on 4 under an 8-cell window (shorter than the
# prompt, so that it bites); stablelm's quarter rope; olmo's clip low enough
# to bite on these weights (|q| reaches ~1); command-r's published logit
# scale; baichuan-13B's 40 layers (its ALiBi rule is by depth)
MEMBERS = {
    "qwen": {}, "stablelm": dict(rope_dim=16),
    "phi3": dict(n_embd=384, n_head_kv=4, swa_window=8),
    "internlm2": {}, "minicpm": {}, "xverse": {}, "exaone": {}, "baichuan": {},
    "baichuan-13b": dict(n_layer=40), "starcoder2": {}, "refact": {}, "plamo": {},
    "orion": {}, "command-r": dict(logit_scale=0.0625), "olmo": dict(clamp_kqv=0.3),
    "codeshell": {}}


def _family_file(path, label: str, seed: int):
    cfg = family_config(label.removesuffix("-13b"), **MEMBERS[label])
    synthetic_gguf(path, cfg, seed=seed)
    return path


CFG_FIELDS = ("arch", "n_embd", "n_layer", "n_head", "n_head_kv", "n_ff", "head_dim",
              "v_head_dim", "rope_dim", "rope_type", "rms_eps", "norm_eps", "use_rms_norm",
              "ffn_gated", "attn_qkv_bias", "tie_word_embeddings", "parallel_residual",
              "clamp_kqv", "logit_scale", "max_alibi_bias", "swa_window", "swa_pattern",
              "act", "vocab_size", "attn_scale")


@pytest.mark.parametrize("label", sorted(MEMBERS))
def test_config_matches_jax(label):
    """config_from_metadata on the metadata synthetic_gguf writes for each
    member gives JAX's config field for field, rope parameters included;
    exaone reads its own namespace; baichuan takes ALiBi (no rope) from 40
    layers, refact always."""
    cfg = family_config(label.removesuffix("-13b"), **MEMBERS[label])
    meta = dict(file_metadata(cfg))
    ours, ref = config_from_metadata(meta), jax_config(meta)
    for f in CFG_FIELDS:
        assert getattr(ours, f) == pytest.approx(getattr(ref, f), rel=1e-7), f
        assert getattr(cfg, f) == pytest.approx(getattr(ref, f), rel=1e-7), f
    assert vars(ours.rope_params()) == vars(ref.rope_params())
    assert (ours.max_alibi_bias > 0) == (label in ("baichuan-13b", "refact"))
    if label == "exaone":
        assert all(k.startswith(("general.", "exaone.")) for k in meta)


# the members whose served logits parted from JAX's op-by-op run by a bf16
# ulp somewhere (measured 2.9e-3-4.1e-3 of max|logits| on qwen and orion,
# 1.5e-4 on refact; the rest 1e-7): tol 1e-2 for every member, bf16
# operands as test_torch_moe.py's bound
TOL = 1e-2


@pytest.mark.parametrize("label", sorted(MEMBERS))
def test_member_serves_like_jax(tmp_path, monkeypatch, label):
    """Each member's file in both packages' default contexts, exact mode
    (fuse=True), a 12-token prefill and N_STEPS steps by served_parity
    within TOL; both contexts unrolled or both stacked; kernel 3's wrapper
    attends where JAX's flash kernel would, and the plain route
    (cache_attention_reference, as JAX's XLA) where its predicate declines:
    ALiBi (baichuan-13B, refact) and head dim 96 (phi3)."""
    seed = 60 + sorted(MEMBERS).index(label)
    path = _family_file(tmp_path / f"{label}.gguf", label, seed)
    jcfg, jp, jf = jax_load(path, fuse=True)
    cfg, pp, f = load_gguf_model(path, fuse=True, device="cpu")
    jf.close()
    f.close()
    calls = {"flash": 0, "plain": 0}
    for attr, key in (("flash_attention", "flash"), ("cache_attention_reference", "plain")):
        real = getattr(llama_model, attr)
        monkeypatch.setattr(llama_model, attr, lambda *a, _r=real, _k=key, **kw: (
            calls.__setitem__(_k, calls[_k] + 1), _r(*a, **kw))[1])
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu")
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS)
    assert ("layers_stacked" in pctx.params) == ("layers_stacked" in jctx.params)
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, 12).astype(np.int32)
    with jax.disable_jit(True):
        served_parity(jctx, pctx, prompt, N_STEPS, TOL, min_decided=1)
    declines = flash_declines(cfg.head_dim, cfg.v_head_dim, cfg.max_alibi_bias)
    assert declines == (label in ("baichuan-13b", "refact", "phi3"))
    if "layers" in pctx.params:
        n = cfg.n_layer * (1 + N_STEPS)
        assert calls == ({"flash": 0, "plain": n} if declines else {"flash": n, "plain": 0})


@pytest.mark.parametrize("n_head,max_bias", [(8, 8.0), (40, 8.0)])
def test_alibi_matches_jax(n_head, max_bias):
    """alibi_slopes equals JAX's ggml schedule (a power-of-two head count,
    and baichuan-13B's 40, whose last 8 heads take the interleaved m1 slopes) within an
    f32 ulp, and attention_reference with its bias -slope |t - c| equals
    JAX's within 1e-6 of max|out| on the same bf16 inputs, rows masked and
    one blind (exactly 0)."""
    ours = alibi_slopes(n_head, max_bias)
    ref = np.asarray(jax_alibi_slopes(n_head, max_bias))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-7, atol=0)
    rng = np.random.default_rng(n_head)
    nt, kv, cells, d = 6, 2 if n_head % 2 == 0 else 1, 40, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((nt, n_head, d), (kv, cells, d), (kv, cells, d)))
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tpos = np.arange(30, 36, dtype=np.int32)
    cpos = np.arange(cells, dtype=np.int32)
    mask = cpos[None, :] <= tpos[:, None]
    mask[2] = False
    got = attention_reference(q, k, v, torch.from_numpy(mask), scale=d ** -0.5, alibi=ours,
                              token_pos=torch.from_numpy(tpos), cell_pos=torch.from_numpy(cpos))
    f32 = lambda t: jnp.asarray(t.to(torch.float32).numpy()).astype(jnp.bfloat16)
    want = np.asarray(jax_attention_reference(
        f32(q), f32(k), f32(v), jnp.asarray(mask), scale=d ** -0.5,
        alibi_slopes=jnp.asarray(ref), token_pos=jnp.asarray(tpos),
        cell_pos=jnp.asarray(cpos)).astype(jnp.float32))
    got = got.to(torch.float32).numpy()
    assert not got[2].any()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max() + 2 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("label", ["refact", "baichuan-13b", "phi3"])
def test_unstackable_members_stay_unrolled(tmp_path, label):
    """ALiBi and a sliding window keep the layers unrolled, as JAX's
    can_stack rules (llama_kotlin_tpu/models/llama.py:39-51): refact and
    baichuan-13B (ALiBi) and phi3 (its window) stay unrolled, where the
    same layers without them would stack (the fuse=False load's layers all
    share their keys here)."""
    path = _family_file(tmp_path / f"{label}.gguf", label, 70)
    jcfg, jp, jf = jax_load(path)
    cfg, pp, f = load_gguf_model(path, device="cpu")
    jf.close()
    f.close()
    assert len({frozenset(lp) for lp in pp["layers"]}) == 1
    assert not llama_model.can_stack(pp, cfg) and not jax_can_stack(jp, jcfg)
    plain = config_from_metadata(dict(file_metadata(family_config("llama"))))
    assert llama_model.can_stack(pp, plain)
    assert "layers" in LlamaContext(cfg, pp, n_cells=64, device="cpu").params


@pytest.mark.parametrize("label,mode", [("qwen", "w4"), ("phi3", None), ("codeshell", "int8")])
def test_fused_qkv_split_matches_jax(tmp_path, label, mode):
    """A fused attn_qkv weight (and bias) splits by rows into wq/wk/wv (and
    bq/bk/bv) at load, as JAX's _load_fused_qkv: every plane of each part
    (the mode's layout: a W4 fold, an exact repack, Q8F) and each bias bit
    for bit JAX's (fuse=False, so the parts stay apart)."""
    path = _family_file(tmp_path / f"{label}.gguf", label, 71)
    jcfg, jp, jf = jax_load(path, fast_mode=mode)
    cfg, pp, f = load_gguf_model(path, fast_mode=mode, device="cpu")
    assert any(n.endswith("attn_qkv.weight") for n in f.tensors)
    jf.close()
    f.close()
    for jl, pl in zip(jp["layers"], pp["layers"]):
        for key in ("wq", "wk", "wv") + (("bq", "bk", "bv") if "bq" in jl else ()):
            ref = params_from_numpy(jax.tree.map(np.asarray, jl[key]), "cpu")
            got = pl[key]
            if isinstance(ref, QTensor):
                assert got.flavor == ref.flavor and got.shape == ref.shape
                for name, t in ref.tensors().items():
                    assert torch.equal(got.tensors()[name], t.to(got.tensors()[name].dtype)), \
                        (key, name)
            else:
                assert torch.equal(got, ref), key
    assert "bq" in pp["layers"][0] or label == "phi3"


@pytest.mark.parametrize("label", ["orion", "command-r", "starcoder2", "stablelm", "qwen2moe"])
def test_convert_carries_family_tensors(tmp_path, label):
    """params_from_numpy of JAX's loaded params carries the family's
    tensors across with the values and dtypes the port's loader gives them:
    q/k/v/o and FFN biases, LayerNorm weights and biases, per-head q/k norms
    (f32) and qwen2moe's shared-expert gate (dense bf16, as the router)."""
    path = tmp_path / f"{label}.gguf"
    if label == "qwen2moe":
        from dataclasses import replace

        cfg, moe_shape = qwen1_5_moe_a2_7b(n_layer=2)
        cfg = replace(cfg, n_embd=256, n_head=4, n_head_kv=4, head_dim=0, v_head_dim=0,
                      rope_dim=0, n_ff=512, vocab_size=512, n_expert=4, n_expert_used=2)
        synthetic_gguf(path, cfg, seed=72, moe=replace(moe_shape, expert_ff=256, n_shared=1))
    else:
        _family_file(path, label, 72)
    jcfg, jp, jf = jax_load(path)
    cfg, pp, f = load_gguf_model(path, device="cpu")
    jf.close()
    f.close()
    conv = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    family = {"bq", "bk", "bv", "bo", "ffn_up_b", "ffn_down_b", "attn_norm", "attn_norm_b",
              "ffn_norm", "ffn_norm_b", "attn_q_norm", "attn_k_norm", "ffn_gate_inp_shexp"}
    seen = set()
    for jl, pl in zip(conv["layers"], pp["layers"]):
        for key in family & set(pl):
            seen.add(key)
            assert jl[key].dtype == pl[key].dtype and torch.equal(jl[key], pl[key]), key
    assert seen, label
    for key in ("output_norm", "output_norm_b"):
        if key in pp:
            assert torch.equal(conv[key], pp[key]), key
    want = {"orion": {"attn_norm_b", "ffn_norm_b"}, "command-r": {"attn_q_norm"},
            "starcoder2": {"bq", "bo", "ffn_up_b", "ffn_down_b"},
            "stablelm": {"bq", "attn_k_norm"}, "qwen2moe": {"ffn_gate_inp_shexp", "bv"}}
    assert want[label] <= seen
