"""openelm and bitnet on the port against the JAX package: OpenELM-3B's
per-layer arrays (openelm_arrays, from its published multipliers) and the
configs JAX gives their files' metadata (arrays as GGUF arrays), the
registry, the same seeded narrow files through both loaders and contexts
in the exact mode and ``w4`` (openelm on the bf16, packed int4 and int8
caches; bitnet at head dim 100 on the plain attention route, as JAX's
XLA), the per-layer fuse rule and routes (q|k|v fused only where a layer
holds the config's head counts, gate|up only at the widest FFN; kernel 2
and the fold flavors at OpenELM-3B's widths against JAX's entry), kernel
3's plain version on a layer's view of its first kv heads against JAX's
kernel on the sliced cache, and the tensors ``convert.py`` carries
across.  The exact mode's JAX contexts run jitted on JAX's CPU routes; in
``w4`` they run in interpret mode (tests/test_torch_qwen2.py says why)."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.models.config import config_from_metadata as jax_config
from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.models.registry import ARCHES as JAX_ARCHES
from llama_kotlin_tpu.ops.pallas import qmm_w4_ffn as jax_ffn_mod
from llama_kotlin_tpu.ops.pallas.flash import flash_attention as jax_flash
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.convert import params_from_numpy
from llama_kotlin_tpu_torch.models import llama as llama_model
from llama_kotlin_tpu_torch.models import registry
from llama_kotlin_tpu_torch.models.config import config_from_metadata
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import (family_config, file_metadata,
                                                     openelm_3b, q4_k_m_layer_types,
                                                     synthetic_gguf)
from llama_kotlin_tpu_torch.ops import qmatmul as port_qmatmul
from llama_kotlin_tpu_torch.ops.cuda import flash
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q
from llama_kotlin_tpu_torch.runtime.context import LlamaContext
from llama_kotlin_tpu_torch.runtime.kv_cache import KVCache, quantize_rows, quantize_rows_q4

from test_torch_gemma import JAX_SITE_KERNEL, _both, _jax_site, _port_kernel
from test_torch_moe import served_parity
from test_torch_qmm_plan import _rel_err
from test_torch_qwen2 import CFG_FIELDS, _jax

N_CELLS = 256
N_STEPS = 3
# OpenELM-3B's per-layer counts (huggingface.co/apple/OpenELM-3B: the
# num_query_heads, num_kv_heads and ffn widths its configuration derives)
OPENELM_3B_HEADS = (12,) * 4 + (16,) * 14 + (20,) * 12 + (24,) * 6
OPENELM_3B_FFN = (1536, 1792, 2048, 2560, 2816, 3072, 3328, 3584, 4096, 4352, 4608, 4864,
                  5120, 5632, 5888, 6144, 6400, 6656, 7168, 7424, 7680, 7936, 8192, 8704,
                  8960, 9216, 9472, 9728, 10240, 10496, 10752, 11008, 11264, 11776, 12032,
                  12288)
FIELDS = CFG_FIELDS + ("act", "n_head_arr", "n_head_kv_arr", "n_ff_arr")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tests' many small CPU ops: more only
    multiplies their CPU time when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _openelm(**keys):
    """A narrow 2-layer openelm: E 256, head dim 64, layer 0 2 query heads on
    1 kv head and FFN 512, layer 1 4 on 2 and 1024 (OpenELM-3B's first and
    last shapes over 6)."""
    return family_config("openelm", **dict(dict(head_dim=64, n_head_arr=(2, 4),
                                                n_head_kv_arr=(1, 2), n_ff_arr=(512, 1024)),
                                           **keys))


def _bitnet():
    """A narrow 2-layer bitnet at bitnet-3B's head dim 100: E 800, 8 heads
    on 4 kv heads, F 512 (K = 800 takes llama.cpp's Q5_0 / Q8_0 fallback)."""
    return family_config("bitnet", n_embd=800, n_head=8, n_head_kv=4, n_ff=512)


@pytest.mark.parametrize("build", [openelm_3b, _openelm, _bitnet])
def test_config_matches_jax(build):
    """config_from_metadata on the metadata synthetic_gguf writes gives
    JAX's config field for field (the per-layer arrays and their
    accessors), rope parameters included; openelm_3b() is that config and
    carries OpenELM-3B's published arrays (openelm_arrays over its
    multipliers: 12 to 24 query heads, 3 to 6 kv heads, FFN 1536 to
    12288)."""
    cfg = build()
    meta = dict(file_metadata(cfg))
    ours, ref = config_from_metadata(meta), jax_config(meta)
    for f in FIELDS:
        assert getattr(ours, f) == pytest.approx(getattr(ref, f), rel=1e-7), f
        assert getattr(cfg, f) == pytest.approx(getattr(ref, f), rel=1e-7), f
    assert vars(ours.rope_params()) == vars(ref.rope_params())
    for li in range(cfg.n_layer):
        assert (ours.layer_n_head(li), ours.layer_n_head_kv(li), ours.layer_n_ff(li)) == (
            ref.layer_n_head(li), ref.layer_n_head_kv(li), ref.layer_n_ff(li))
    if build is openelm_3b:
        assert ours.n_head_arr == OPENELM_3B_HEADS and ours.n_ff_arr == OPENELM_3B_FFN
        assert ours.n_head_kv_arr == tuple(h // 4 for h in OPENELM_3B_HEADS)
        assert (ours.n_head, ours.n_head_kv, ours.n_ff, ours.head_dim) == (24, 6, 12288, 128)
        assert ours.tie_word_embeddings and ours.per_layer_shapes


def test_registry_marks_36_archs_ported():
    """The registry mirrors JAX's table and marks 36 of its 42 archs
    ported, the large MoEs and the per-layer architectures among them."""
    assert [a.name for a in registry.ARCHES] == [a.name for a in JAX_ARCHES]
    assert sum(a.ported for a in registry.ARCHES) == 36 and len(registry.ARCHES) == 42
    for arch in ("dbrx", "arctic", "grok", "openelm", "bitnet"):
        assert registry.is_ported(arch)


def _count_attention(monkeypatch) -> dict:
    """Calls of kernel 3's wrapper by cache rank (4: the whole cache with a
    layer index; 3: a layer's view) and of the plain route."""
    calls = {"flash_4d": 0, "flash_3d": 0, "plain": 0}
    real_f, real_p = llama_model.flash_attention, llama_model.cache_attention_reference

    def counted_flash(q, k, *a, **kw):
        calls["flash_4d" if k.dim() == 4 else "flash_3d"] += 1
        return real_f(q, k, *a, **kw)

    def counted_plain(*a, **kw):
        calls["plain"] += 1
        return real_p(*a, **kw)

    monkeypatch.setattr(llama_model, "flash_attention", counted_flash)
    monkeypatch.setattr(llama_model, "cache_attention_reference", counted_plain)
    return calls


def _contexts(path, mode, kv, monkeypatch):
    if mode == "w4":
        monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    jcfg, jp, jf = jax_load(path, fast_mode=mode, fuse=True)
    cfg, pp, f = load_gguf_model(path, fast_mode=mode, fuse=True, device="cpu")
    jf.close()
    f.close()
    return (cfg, pp, jp, LlamaContext(cfg, pp, n_cells=N_CELLS, kv_quant=kv, device="cpu"),
            JaxContext(jcfg, jp, n_cells=N_CELLS, kv_quant=kv))


# (mode, cache, tol of max|logits|): the exact mode on a bf16 cache 1e-2
# and on a packed int4 cache 5e-2, w4 on an int8 cache 5e-2
# (tests/test_torch_qwen2.py's QWEN2_CASES and their reasons)
OPENELM_CASES = [(None, False, 1e-2), (None, "q4_0", 5e-2), ("w4", "q8_0", 5e-2)]


@pytest.mark.parametrize("mode,kv,tol", OPENELM_CASES)
def test_openelm_serves_like_jax(tmp_path, monkeypatch, mode, kv, tol):
    """The narrow openelm in both packages' default contexts (both
    unrolled: per-layer shapes), a 12-token prefill and N_STEPS steps by
    served_parity within tol; each layer's projections as JAX fuses them
    (layer 0, narrower than the config's maxima, keeps q, k, v and gate, up
    apart; layer 1 fuses both); the cache sized at the widest layer's kv
    heads, and every layer attending over its own view (kernel 3's wrapper
    on a 3-D cache), as JAX's per-layer slice."""
    path = tmp_path / "openelm.gguf"
    synthetic_gguf(path, _openelm(), seed=51)
    calls = _count_attention(monkeypatch)
    cfg, pp, jp, pctx, jctx = _contexts(path, mode, kv, monkeypatch)
    assert "layers" in pctx.params and "layers" in jctx.params
    for pl, jl in zip(pp["layers"], jp["layers"]):
        assert set(pl) == set(jl)
    assert {"wq", "ffn_gate"} <= set(pp["layers"][0])
    assert {"wqkv_fused", "ffn_gateup_fused"} <= set(pp["layers"][1])
    assert pctx.cache.k.shape[1] == jctx.cache.k.shape[1] == 2
    prompt = np.random.default_rng(51).integers(0, cfg.vocab_size, 12).astype(np.int32)
    served_parity(jctx, pctx, prompt, N_STEPS, tol, min_decided=1 if tol < 2e-2 else 0)
    assert calls == {"flash_4d": 0, "flash_3d": cfg.n_layer * (1 + N_STEPS), "plain": 0}


def test_layer_views_match_jax_slice():
    """Kernel 3's plain version on layer 1's view of its first 3 kv heads
    in a cache of 6 (OpenELM-3B's 12/3 layer in a cache sized for 24/6;
    head dim 128), on each cache, against JAX's flash_attention in
    interpret mode on the same layer sliced as JAX's forward slices it
    (``cache.k[li][:n_kv]``) within 5e-3 of max|out|; the views are
    contiguous and start on a cache row (16-byte aligned on the card)."""
    H, KV, D, cells, nt = 12, 3, 128, 128, 9
    rng = np.random.default_rng(130)
    kb = torch.from_numpy(rng.standard_normal((2, 6, cells, D)).astype(np.float32))
    vb = torch.from_numpy(rng.standard_normal((2, 6, cells, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((nt, H, D)).astype(np.float32)).to(torch.bfloat16)
    mask = np.tril(np.ones((nt, cells), np.int8), k=cells - nt)
    mask[4] = 0
    for kind in ("bf16", "int8", "int4"):
        cache = KVCache.create(2, cells, 6, D, device="cpu",
                               quantized={"bf16": False, "int8": "q8_0", "int4": "q4_0"}[kind])
        if kind == "bf16":
            cache.k.copy_(kb), cache.v.copy_(vb)
        else:
            qr = quantize_rows if kind == "int8" else quantize_rows_q4
            (kc, ks), (vc, vs) = qr(kb), qr(vb)
            cache.k.copy_(kc), cache.v.copy_(vc), cache.k_scale.copy_(ks), cache.v_scale.copy_(vs)
        view = llama_model._layer_cache(cache, 1, KV)
        for t in view.values():
            if t is not None:
                assert t.is_contiguous() and t.shape[0] == KV
        assert view["k"].data_ptr() - cache.k.data_ptr() == cache.k[1].numel() * \
            cache.k.element_size()
        bits = 4 if kind == "int4" else 8
        got = flash.flash_attention(q, view["k"], view["v"], torch.from_numpy(mask),
                                    scale=D ** -0.5, k_scale=view["k_scale"],
                                    v_scale=view["v_scale"], kv_bits=bits)
        assert not got[4].any()
        sl = lambda t: None if t is None else _jax(t[1][:KV])  # noqa: E731
        ref = np.asarray(jax_flash(_jax(q), sl(cache.k), sl(cache.v), jnp.asarray(mask),
                                   scale=D ** -0.5, k_scale=sl(cache.k_scale),
                                   v_scale=sl(cache.v_scale), kv_bits=bits, interpret=True))
        assert _rel_err(got.to(torch.float32), ref) <= 5e-3, kind


def test_openelm_3b_routes_as_jax(monkeypatch):
    """OpenELM-3B's matrices at full width in w4 at one decode row, for
    four of its layers in its Q4_K_M file's types (q4_k_m_layer_types over
    36 layers): layer 0 (12/3 heads, F 1536), layer 3 (F 2560, a Q6_K
    down: use_more_bits), layer 4 (16/4, F 2816) and layer 5 (F 3072).
    Each fold's flavor is JAX's (K = 3072 folds legacy; a down's K pads to
    1024 and folds compact where its code columns are a multiple of 1024: F
    1536, else legacy); at layers 0 and 5 q, k and o take kernel 1 at the
    site JAX's dispatch reaches (every site a recorder, so nothing runs);
    and kernel 2 takes gate and up apart (qmm_ffn's up=) exactly where
    JAX's entry takes them: layer 5 (all legacy, F a multiple of 1024), not
    layer 0 (a compact down beside legacy gate and up), layer 3 (a W8 down)
    nor layer 4 (gate rows 2816, short of the down's padded 3072)."""
    monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("LKTPU_W4_FX", raising=False)
    cfg = openelm_3b()
    types = q4_k_m_layer_types(cfg.n_layer)
    E, D = cfg.n_embd, cfg.head_dim
    taken = {}
    for li in (0, 3, 4, 5):
        n_h, n_kv, F = cfg.layer_n_head(li), cfg.layer_n_head_kv(li), cfg.layer_n_ff(li)
        mats = {"q": (Q.Q4_K, n_h * D, E), "k": (Q.Q4_K, n_kv * D, E), "o": (Q.Q4_K, E, n_h * D),
                "gate": (Q.Q4_K, F, E), "up": (Q.Q4_K, F, E),
                "down": (types[li]["ffn_down"], E, F)}
        folds = {name: _both(*shape, seed=140 + 10 * li + i)
                 for i, (name, shape) in enumerate(mats.items())}
        for name, (jw, pw) in folds.items():
            jflavor = ("w8" if pw.bits == 8 else "compact" if "q6_t" in jw.aux
                       else "legacy")
            assert pw.flavor == jflavor, (li, name)
            if name in ("q", "k", "o") and li in (0, 5):
                x = np.zeros((1, pw.shape[1]), np.float32)
                with monkeypatch.context() as m:
                    site = _jax_site(m, x, jw)
                with monkeypatch.context() as m:
                    got = _port_kernel(m, x, pw)
                assert JAX_SITE_KERNEL[site] == got == "kernel 1", (li, name, site, got)
        (jg, pg), (ju, pu), (jd, pd) = folds["gate"], folds["up"], folds["down"]
        hit = []
        with monkeypatch.context() as m:
            m.setattr(jax_ffn_mod, "qmm_w4_ffn", lambda x, *a, **k: hit.append(1) or x)
            jax_ffn_mod.qmm_w4_ffn_matmul(jnp.zeros((1, E)), jg, jd, up=ju, interpret=True)
        port_hit = []
        with monkeypatch.context() as m:
            m.setattr(port_qmatmul, "qmm_w4_ffn_matmul",
                      lambda x, *a, **k: port_hit.append(1) or x)
            port_qmatmul.qmm_ffn(torch.zeros((1, E)), pg, pd, up=pu)
        port_takes = bool(port_hit)
        assert bool(hit) == port_takes, li
        taken[li] = port_takes
    assert taken == {0: False, 3: False, 4: False, 5: True}


@pytest.mark.parametrize("mode", [None, "w4"])
def test_bitnet_serves_like_jax(tmp_path, monkeypatch, mode):
    """The narrow bitnet in both packages' default contexts, a 12-token
    prefill and N_STEPS steps by served_parity (1e-2 of max|logits| exact,
    5e-2 in w4, OPENELM_CASES' reasons): the per-projection scales, the
    attention sub-norm before wo and the FFN sub-norm before down; gate and
    up stay apart and kernel 2 never runs (JAX's rule: the scales and the
    sub-norm sit between the products); head dim 100 attends by the plain
    route on every forward, as JAX's XLA."""
    path = tmp_path / "bitnet.gguf"
    synthetic_gguf(path, _bitnet(), seed=52)
    calls = _count_attention(monkeypatch)
    ffn_calls = []
    real = llama_model.qmm_ffn
    monkeypatch.setattr(llama_model, "qmm_ffn",
                        lambda *a, **k: ffn_calls.append(1) or real(*a, **k))
    cfg, pp, jp, pctx, jctx = _contexts(path, mode, False, monkeypatch)
    for pl, jl in zip(pp["layers"], jp["layers"]):
        assert set(pl) == set(jl) and "ffn_gate" in pl and "ffn_sub_norm" in pl
        assert pl["wq_scale"].shape == (1,) and pl["wq_scale"].dtype == torch.float32
    prompt = np.random.default_rng(52).integers(0, cfg.vocab_size, 12).astype(np.int32)
    served_parity(jctx, pctx, prompt, N_STEPS, 1e-2 if mode is None else 5e-2,
                  min_decided=1 if mode is None else 0)
    assert calls == {"flash_4d": 0, "flash_3d": 0, "plain": cfg.n_layer * (1 + N_STEPS)}
    assert not ffn_calls


@pytest.mark.parametrize("label", ["openelm", "bitnet"])
def test_convert_carries_new_tensors(tmp_path, label):
    """params_from_numpy of JAX's loaded params gives the port loader's
    params layer by layer: openelm's per-layer splits and fusions and its
    q/k norms, bitnet's seven scales and two sub-norms (f32, equal), every
    QTensor plane for plane."""
    path = tmp_path / f"{label}.gguf"
    synthetic_gguf(path, _openelm() if label == "openelm" else _bitnet(), seed=53)
    jcfg, jp, jf = jax_load(path, fuse=True)
    cfg, pp, f = load_gguf_model(path, fuse=True, device="cpu")
    jf.close()
    f.close()
    conv = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for jl, pl in zip(conv["layers"], pp["layers"]):
        assert set(jl) == set(pl)
        for key, want in pl.items():
            got = jl[key]
            if isinstance(want, torch.Tensor):
                assert got.dtype == want.dtype and torch.equal(got, want), key
            else:
                a, b = got.tensors(), want.tensors()
                assert a.keys() == b.keys() and got.shape == want.shape, key
                for name in a:
                    assert torch.equal(a[name], b[name].to(a[name].dtype)), (key, name)
