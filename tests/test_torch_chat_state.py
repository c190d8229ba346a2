"""Port parity for the chat templates and the context state files.

- ``runtime/chat.py``: every template name the JAX package knows, and raw
  jinja strings it detects, format the same messages to equal strings.
- ``runtime/state.py``: full-state blobs, session files and per-sequence
  blobs cross both ways between the JAX package and the port (JAX saves,
  the port loads; the port saves, JAX loads) for the bf16, q8_0 and q4_0
  caches: equal payload layouts, restored caches equal to the saved planes
  bit for bit, and the next steps' logits after a restore within 4e-2 of
  max|logits| of the other side's (tests/test_torch_loader.py's tolerance
  for the same int8/bf16 rounding drift), on a 2-layer synthetic W4A8
  model drawn identically on both sides.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import jax
import torch

from llama_kotlin_tpu.models.config import ModelConfig as JaxConfig
from llama_kotlin_tpu.models.synthetic import synthetic_params_device as jax_params
from llama_kotlin_tpu.quant.formats import GGMLQuantType
from llama_kotlin_tpu.runtime import chat as jax_chat
from llama_kotlin_tpu.runtime import state as jax_state
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.convert import params_from_numpy
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.models.synthetic import LLAMA2_CHAT_TEMPLATE
from llama_kotlin_tpu_torch.runtime import chat, state
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from test_torch_cli import one_thread  # noqa: F401 (autouse fixture)

CFG = dict(arch="llama", vocab_size=512, n_embd=1024, n_layer=2, n_head=8, n_head_kv=4,
           n_ff=1024)
N_PROMPT, N_CELLS, N_FORCED = 10, 256, 3
LOGIT_TOL = 4e-2
CACHES = [False, "q8_0", "q4_0"]
CACHE_IDS = ["bf16", "q8_0", "q4_0"]

MESSAGES = [
    [{"role": "user", "content": "Hello"}],
    [{"role": "system", "content": "You are terse. "},
     {"role": "user", "content": " Hi there "},
     {"role": "assistant", "content": "Hello! "},
     {"role": "user", "content": "Who are you?"}],
    [{"role": "user", "content": "a"}, {"role": "assistant", "content": "b"},
     {"role": "user", "content": "日本語 😀\nline"}],
]
RAW_TEMPLATES = [
    LLAMA2_CHAT_TEMPLATE,
    "{{ '<|im_start|>' + message['role'] }}",
    "[INST] {{ message['content'] }} [/INST]",
    "{{ bos_token + '[INST] ' + content.strip() }}",
    "<|assistant|> ... <|end|>",
    "{% for m in messages %}<start_of_turn>{% endfor %}",
    "<|start_header_id|> <|end_header_id|>",
    "{{ 'USER: ' }} {{ 'ASSISTANT: ' }} {{ 'SYSTEM: ' }}",
]


@pytest.mark.parametrize("template", list(jax_chat.KNOWN_TEMPLATES) + [
    f"raw{i}" for i in range(len(RAW_TEMPLATES))])
def test_chat_templates_match_jax(template):
    """apply_chat_template: equal strings for every message list, with and
    without the assistant prefix; detect_template and resolve_template
    agree (raw strings, and the chatml fallback of an unknown one)."""
    tmpl = RAW_TEMPLATES[int(template[3:])] if template.startswith("raw") else template
    for msgs in MESSAGES:
        for add in (True, False):
            got = chat.apply_chat_template(msgs, tmpl, add_assistant=add)
            assert got == jax_chat.apply_chat_template(msgs, tmpl, add_assistant=add)
    assert chat.detect_template(tmpl) == jax_chat.detect_template(tmpl)
    for arch in ("llama", "gemma2"):
        assert chat.resolve_template(tmpl, arch) == jax_chat.resolve_template(tmpl, arch)
    assert chat.resolve_template("{{ unknown }}") == jax_chat.resolve_template("{{ unknown }}")
    assert chat.resolve_template(None, "gemma") == jax_chat.resolve_template(None, "gemma")
    with pytest.raises(ValueError):
        chat.apply_chat_template(MESSAGES[0], "no-such-template")


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**CFG)
    jp = jax_params(jcfg, GGMLQuantType.Q4_K, fast_w4a8=True, fuse=True)
    return jcfg, jp, ModelConfig(**CFG), params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _payload(blob: bytes) -> dict:
    return dict(np.load(io.BytesIO(blob[8:]), allow_pickle=False))


def _cache_arrays(cache, n_cells: int) -> dict:
    """The cache planes of the real cells as numpy (bf16 viewed as f32)."""
    out = {}
    for name in ("k", "v", "k_scale", "v_scale"):
        a = getattr(cache, name)
        if a is None:
            continue
        if isinstance(a, torch.Tensor):
            a = a[:, :, :n_cells]
            a = (a.float() if a.dtype == torch.bfloat16 else a).numpy()
        else:
            a = np.asarray(a)
            a = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
        out[name] = a.copy()  # the caches are updated in place (port) or donated (JAX)
    return out


def _forced(ctx, batch_cls, tokens, pos0: int, seq_id: int = 0) -> list:
    out = []
    for i, t in enumerate(tokens):
        assert ctx.decode(batch_cls.single([t], seq_id=seq_id, pos0=pos0 + i)) == 0
        out.append(np.asarray(ctx.get_logits()[-1], np.float32))
    return out


def _close(got: list, want: list) -> None:
    for a, b in zip(got, want):
        assert np.abs(a - b).max() <= LOGIT_TOL * np.abs(b).max()


@pytest.fixture(scope="module", params=CACHES, ids=CACHE_IDS)
def saved(request, models, tmp_path_factory):
    """One cache type: both sides prefill the same prompt and save a state
    blob, a session file and sequence 0's blob; then each side decodes the
    same forced tokens from its own state (the reference logits)."""
    jcfg, jp, cfg, pp = models
    kv = request.param
    d = tmp_path_factory.mktemp("state")
    prompt = np.random.default_rng(9).integers(0, CFG["vocab_size"], N_PROMPT).astype(np.int32)
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS, kv_quant=kv)
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, kv_quant=kv, device="cpu")
    assert jctx.decode(JaxBatch.single(prompt)) == 0
    assert pctx.decode(Batch.single(prompt)) == 0
    forced = [int(t) for t in np.random.default_rng(10).integers(0, CFG["vocab_size"], N_FORCED)]
    out = dict(kv=kv, prompt=prompt, forced=forced, jctx=jctx,
               j_blob=jax_state.get_state_data(jctx), p_blob=state.get_state_data(pctx),
               j_seq=jax_state.get_seq_data(jctx, 0), p_seq=state.get_seq_data(pctx, 0),
               j_sess=d / "jax.session", p_sess=d / "port.session",
               j_cache=_cache_arrays(jctx.cache, N_CELLS),
               p_cache=_cache_arrays(pctx.cache, N_CELLS))
    jax_state.save_session_file(jctx, out["j_sess"], prompt)
    state.save_session_file(pctx, out["p_sess"], prompt)
    out["j_logits"] = _forced(jctx, JaxBatch, forced, N_PROMPT)
    out["p_logits"] = _forced(pctx, Batch, forced, N_PROMPT)
    out["port"] = lambda: LlamaContext(cfg, pp, n_cells=N_CELLS, kv_quant=kv, device="cpu")
    return out


def test_state_payloads_have_jax_layout(saved):
    """The port's blobs hold the keys, shapes and dtypes of JAX's, and the
    saved planes are the caches' own (the real cells only)."""
    for a, b in ((saved["p_blob"], saved["j_blob"]), (saved["p_seq"], saved["j_seq"])):
        assert a[:8] == b[:8]  # magic and version
        pa, pb = _payload(a), _payload(b)
        assert sorted(pa) == sorted(pb)
        for k in pa:
            assert pa[k].shape == pb[k].shape and pa[k].dtype == pb[k].dtype, k
    p = _payload(saved["p_blob"])
    np.testing.assert_array_equal(p["cache_k"], saved["p_cache"]["k"])
    if saved["kv"]:
        np.testing.assert_array_equal(p["cache_v_scale"], saved["p_cache"]["v_scale"])


def test_jax_state_restores_in_port(saved):
    """set_state_data(port, JAX's blob): the port's cache equals JAX's planes
    bit for bit, the metadata, allocator and logits are JAX's, and the next
    forced steps stay within LOGIT_TOL of JAX's from its own state."""
    ctx = saved["port"]()
    state.set_state_data(ctx, saved["j_blob"])
    for k, a in _cache_arrays(ctx.cache, N_CELLS).items():
        np.testing.assert_array_equal(a, saved["j_cache"][k])
    jp = _payload(saved["j_blob"])
    np.testing.assert_array_equal(ctx.meta.pos, jp["cell_pos"])
    assert ctx.meta._next == N_PROMPT
    np.testing.assert_array_equal(ctx.get_logits(), jp["logits"])
    _close(_forced(ctx, Batch, saved["forced"], N_PROMPT), saved["j_logits"])


def test_port_state_restores_in_jax(saved):
    """set_state_data(JAX, the port's blob): JAX's cache equals the port's
    planes bit for bit and its next forced steps stay within LOGIT_TOL of
    the port's from its own state."""
    jctx = saved["jctx"]
    jax_state.set_state_data(jctx, saved["p_blob"])
    for k, a in _cache_arrays(jctx.cache, N_CELLS).items():
        np.testing.assert_array_equal(a, saved["p_cache"][k])
    _close(saved["p_logits"], _forced(jctx, JaxBatch, saved["forced"], N_PROMPT))


def test_session_files_cross(saved):
    """Session files both ways: the stored prompt tokens come back, and the
    restored cache equals the saver's; a port-saved session restored by
    JAX and a JAX-saved one by the port step alike."""
    ctx = saved["port"]()
    np.testing.assert_array_equal(state.load_session_file(ctx, saved["j_sess"]),
                                  saved["prompt"])
    for k, a in _cache_arrays(ctx.cache, N_CELLS).items():
        np.testing.assert_array_equal(a, saved["j_cache"][k])
    _close(_forced(ctx, Batch, saved["forced"], N_PROMPT), saved["j_logits"])
    jctx = saved["jctx"]
    np.testing.assert_array_equal(jax_state.load_session_file(jctx, saved["p_sess"]),
                                  saved["prompt"])
    for k, a in _cache_arrays(jctx.cache, N_CELLS).items():
        np.testing.assert_array_equal(a, saved["p_cache"][k])


def test_sequence_blobs_cross(saved):
    """Sequence 0's blob injected as sequence 1 on the other side: the
    planes land in the allocated cells bit for bit, and the next forced
    step on sequence 1 stays within LOGIT_TOL of the saver's own first
    step."""
    ctx = saved["port"]()
    assert ctx.decode(Batch.single([3, 4], seq_id=0)) == 0  # cells 0-1 taken
    assert state.set_seq_data(ctx, saved["j_seq"], 1) == 0
    cells = np.nonzero(((ctx.meta.seq >> 1) & 1) == 1)[0]
    assert len(cells) == N_PROMPT and cells.min() == 2
    got = _cache_arrays(ctx.cache, N_CELLS)
    for k in got:
        np.testing.assert_array_equal(got[k][:, :, cells], saved["j_cache"][k][:, :, :N_PROMPT])
    _close(_forced(ctx, Batch, saved["forced"][:1], N_PROMPT, seq_id=1), saved["j_logits"][:1])
    jctx = saved["jctx"]
    jctx.clear()
    assert jax_state.set_seq_data(jctx, saved["p_seq"], 1) == 0
    _close(saved["p_logits"][:1], _forced(jctx, JaxBatch, saved["forced"][:1], N_PROMPT,
                                          seq_id=1))
    small = LlamaContext(ModelConfig(**CFG), ctx.params, n_cells=8, device="cpu")
    assert state.set_seq_data(small, saved["j_seq"], 0) == 1  # not enough free cells


def test_cross_type_restore_matches_jax(saved, models):
    """A blob restored into a context of another cache type (a quantized
    blob into a bf16 cache through its dequantized rows; a bf16 blob into
    an int8 and an int4 cache through the row quantizers) leaves the port's
    cache equal to what JAX's own cross-type restore leaves, bit for bit."""
    jcfg, jp, cfg, pp = models
    for other in [k for k in CACHES if k != saved["kv"]]:
        ours = LlamaContext(cfg, pp, n_cells=N_CELLS, kv_quant=other, device="cpu")
        ref = JaxContext(jcfg, jp, n_cells=N_CELLS, kv_quant=other)
        state.set_state_data(ours, saved["j_blob"])
        jax_state.set_state_data(ref, saved["j_blob"])
        want = _cache_arrays(ref.cache, N_CELLS)
        for k, a in _cache_arrays(ours.cache, N_CELLS).items():
            np.testing.assert_array_equal(a, want[k])
