"""Port parity for the continuous-batching engine (``runtime/engine.py``).

One tiny 2-layer Q8_0 GGUF (E = 64, vocab 160, F32 output), written by
the port's writer from a seed, is loaded by both packages in the
exact-dequant mode (the default).  The port's ``Engine`` on the port's
context (CPU) and JAX's ``Engine`` on JAX's context (CPU, its own default
route) take the same requests on the same schedule, driven by ``step()``
in this thread, and give the same greedy tokens, the same metrics and
the same slot bookkeeping: requests submitted together and while others
generate (one queued behind full slots), the chunked on-device decode
against the per-token path, a context shift mid-generation, prompt-cache
reuse of a common prefix, a global system prompt, ``n_probs`` and
grammar-masked device sampling.  Run op by op, the JAX program gives the
port's logits within 1e-6 of max|logits| and the same bf16 cache; compiled,
XLA's CPU compiler keeps excess precision across the program's bf16
roundings and rewrites some ops, and the jitted logits differ from the
port's by up to about 7e-3 of max|logits| on this model
(``test_port_equals_the_jax_program_op_by_op``).  The ``n_probs``
log-probabilities are held to the difference measured on each row.

Sampled tokens cannot equal JAX's (the generators differ): for those the
port is held to its own contract, that a request's tokens depend on its
seed and not on which slot or batch row it takes.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext
from llama_kotlin_tpu.runtime.engine import Engine as JaxEngine
from llama_kotlin_tpu.runtime.engine import Request as JaxRequest
from llama_kotlin_tpu.sampling.samplers import SamplingParams as JaxSP

from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import synthetic_gguf
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext
from llama_kotlin_tpu_torch.runtime.engine import Engine, Request, _stop_holdback
from llama_kotlin_tpu_torch.sampling.samplers import SamplingParams

from test_server import ToyTokenizer
from test_torch_cli import one_thread  # noqa: F401 (autouse fixture)

CFG = ModelConfig(arch="llama", name="tiny-serve", vocab_size=160, n_embd=64, n_layer=2,
                  n_head=4, n_head_kv=2, n_ff=96, n_ctx_train=4096)
LOGIT_TOL = 1e-2  # of max|logits|: the exact mode's port-vs-JAX bound
N_CELLS = 256


def write_model(path, seed: int = 41):
    """The tiny serving model: all layer matrices Q8_0, an F32 output."""
    synthetic_gguf(path, CFG, seed=seed, matrix_type=Q.Q8_0, output_type=Q.F32)
    return path


def load_both(path):
    """(JAX cfg, JAX params, port cfg, port params) in the exact mode."""
    jcfg, jp, jf = jax_load(path)
    cfg, pp, f = load_gguf_model(path, device="cpu")
    jf.close()
    f.close()
    return jcfg, jp, cfg, pp


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Both models and one context a side, reused (cleared) by the tests:
    each JAX context compiles its own step."""
    jcfg, jp, cfg, pp = load_both(write_model(tmp_path_factory.mktemp("eng") / "m.gguf"))
    return dict(jcfg=jcfg, jp=jp, cfg=cfg, pp=pp,
                jctx=JaxContext(jcfg, jp, n_cells=N_CELLS),
                pctx=LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu"))


def engines(models, n_slots=2, n_batch=64, chunk_steps=8, jctx=None, pctx=None):
    """A JAX engine and a port engine, each on a cleared context."""
    jctx = jctx or models["jctx"]
    pctx = pctx or models["pctx"]
    jctx.clear()
    pctx.clear()
    tok = ToyTokenizer(CFG.vocab_size)
    return (JaxEngine(jctx, tok, n_slots=n_slots, n_batch=n_batch, chunk_steps=chunk_steps),
            Engine(pctx, tok, n_slots=n_slots, n_batch=n_batch, chunk_steps=chunk_steps))


def pair(prompt, n_predict=12, **kw):
    """The same request for both engines (sampling kwargs in `kw`;
    greedy by default)."""
    req_kw = {k: kw.pop(k) for k in ("stop_strings", "n_probs", "n_keep") if k in kw}
    kw.setdefault("temp", 0.0)  # greedy unless asked
    prompt = np.asarray(prompt, np.int32)
    return (JaxRequest(prompt_tokens=prompt, params=JaxSP(**kw), n_predict=n_predict, **req_kw),
            Request(prompt_tokens=prompt, params=SamplingParams(**kw), n_predict=n_predict,
                    **req_kw))


def drain(engine, reqs, max_steps=400):
    """step() until every request is done; returns the number of steps."""
    for n in range(max_steps):
        if all(r.done.is_set() for r in reqs):
            return n
        engine.step()
    raise AssertionError("requests did not finish")


def same_run(je, pe, jreqs, preqs):
    """Equal tokens, texts, stop reasons, metrics and slot states."""
    for j, p in zip(jreqs, preqs):
        assert p.output_tokens == j.output_tokens
        assert p.output_text == j.output_text and p.stop_reason == j.stop_reason
    assert pe.metrics == je.metrics
    assert [(s["id"], s["state"], s["n_past"]) for s in pe.slots_info()] == \
        [(s["id"], s["state"], s["n_past"]) for s in je.slots_info()]
    assert [s.tokens for s in pe.slots] == [s.tokens for s in je.slots]


PROMPTS = [[1, 5, 9], [1, 17, 33, 60, 2 + 5, 90, 121, 44], [1, 8], [1, 140, 3, 77, 50]]


def test_port_equals_the_jax_program_op_by_op(models, monkeypatch):
    """Where the two packages' logits part: run op by op
    (jax.disable_jit), the JAX program gives the port's logits within 1e-6
    of max|logits| over a prefill and 6 one-token steps, and the same bf16
    cache cell for cell.  Compiled, XLA's CPU compiler keeps excess
    precision across the program's bf16 roundings
    (xla_allow_excess_precision, on by default) and rewrites some ops, and
    there the jitted logits differ from the port's by up to about 7e-3 of
    max|logits| on this model.  Compiled with that excess precision off,
    JAX's prefill gives the port's logits too."""
    import jax

    from llama_kotlin_tpu.utils import profiling

    jctx, pctx = models["jctx"], models["pctx"]
    jctx.clear()
    pctx.clear()
    prompt = np.array([3, 17, 42, 9, 5, 11], np.int32)  # one bucket with the steps
    monkeypatch.setattr(profiling, "compiler_opts",
                        lambda: {"xla_allow_excess_precision": False})
    strict = JaxContext(models["jcfg"], models["jp"], n_cells=N_CELLS)
    strict.decode(JaxBatch.single(prompt))
    pctx.decode(Batch.single(prompt))
    a, b = np.asarray(strict.get_logits()), np.asarray(pctx.get_logits())
    assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max()
    pctx.clear()
    with jax.disable_jit():
        for i in range(7):
            toks = prompt if i == 0 else np.array([int(np.argmax(b[-1]))], np.int32)
            pos0 = 0 if i == 0 else len(prompt) + i - 1
            jctx.decode(JaxBatch.single(toks, pos0=pos0))
            pctx.decode(Batch.single(toks, pos0=pos0))
            a, b = np.asarray(jctx.get_logits()), np.asarray(pctx.get_logits())
            assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max()
        n = jctx.cache.k.shape[2]
        for jc, pc in ((jctx.cache.k, pctx.cache.k), (jctx.cache.v, pctx.cache.v)):
            assert np.array_equal(np.asarray(jc.astype(np.float32)),
                                  pc[:, :, :n].float().numpy())


def test_requests_together_and_while_generating(models):
    """Two requests submitted together on 3 slots; after a few steps two
    more arrive while they generate (the last one queues behind full
    slots).  Greedy, chunked decode on: the port gives JAX's tokens, step
    counts, metrics and slot states."""
    je, pe = engines(models, n_slots=3)
    reqs = [pair(p, n_predict=10 + 3 * i) for i, p in enumerate(PROMPTS)]
    for j, p in reqs[:2]:
        je.submit(j)
        pe.submit(p)
    for _ in range(3):
        je.step()
        pe.step()
    for j, p in reqs[2:]:
        je.submit(j)
        pe.submit(p)
    jr, pr = [r[0] for r in reqs], [r[1] for r in reqs]
    assert drain(pe, pr) == drain(je, jr)
    same_run(je, pe, jr, pr)
    assert pe.n_chunked > 0 and len(set(sum((r.output_tokens for r in pr), []))) > 4


def test_chunked_decode_matches_per_token(models):
    """chunk_steps=8 (the on-device generate_loop) and chunk_steps=0 (one
    decode a token) give the same greedy tokens, each equal to JAX's with
    the same setting; the chunked run takes fewer steps."""
    steps = {}
    toks = {}
    for chunk in (8, 0):
        je, pe = engines(models, chunk_steps=chunk)
        j, p = pair([1, 5, 9], n_predict=17)
        je.submit(j)
        pe.submit(p)
        steps[chunk] = drain(pe, [p])
        assert steps[chunk] == drain(je, [j])
        same_run(je, pe, [j], [p])
        assert (pe.n_chunked > 0) == (chunk > 1)
        toks[chunk] = p.output_tokens
    assert toks[8] == toks[0] and len(toks[8]) == 17
    assert steps[8] < steps[0]


@pytest.mark.parametrize("text,stops,want", [
    ("hello wor", ("world",), 3), ("hello", ("world",), 0), ("ab", ("abc", "bcd"), 2),
    ("xyb", ("abc", "bcd"), 1), ("", ("stop",), 0), ("stop", ("stop",), 0),
])
def test_stop_holdback(text, stops, want):
    """JAX's cases (tests/test_server.py): the longest suffix that is a
    proper prefix of a stop string, equal to JAX's helper."""
    from llama_kotlin_tpu.runtime.engine import _stop_holdback as jax_holdback

    assert _stop_holdback(text, stops) == jax_holdback(text, stops) == want


@pytest.mark.parametrize("chunk", [0, 8])
def test_context_shift_mid_generation(models, chunk):
    """A 32-cell context with one slot: the generation outgrows it, the
    slot shifts (keep n_keep, drop half; the cached K rows rotate) and
    goes on to n_predict, as JAX's does, token for token."""
    jctx = JaxContext(models["jcfg"], models["jp"], n_cells=32)
    pctx = LlamaContext(models["cfg"], models["pp"], n_cells=32, device="cpu")
    je, pe = engines(models, n_slots=1, n_batch=16, chunk_steps=chunk, jctx=jctx, pctx=pctx)
    j, p = pair([1, 5, 9], n_predict=48)
    je.submit(j)
    pe.submit(p)
    assert drain(pe, [p]) == drain(je, [j])
    same_run(je, pe, [j], [p])
    assert len(p.output_tokens) == 48 and p.stop_reason == "length"


def test_prompt_cache_reuse(models):
    """A second request that shares a prefix with what its slot holds
    evaluates only the new suffix (longest-common-prefix reuse):
    prompt_tokens_processed equals JAX's and counts the suffix only."""
    je, pe = engines(models, n_slots=1)
    first = [1, 17, 33, 60, 7, 90, 121, 44, 12, 13]
    for prompt in (first, first[:7] + [3, 99]):
        j, p = pair(prompt, n_predict=6)
        je.submit(j)
        pe.submit(p)
        assert drain(pe, [p]) == drain(je, [j])
        same_run(je, pe, [j], [p])
    assert pe.metrics["prompt_tokens_processed"] == len(first) + 2


def test_system_prompt(models):
    """A global system prompt prefixes every request and changes the
    greedy continuation; clearing it restores the old one.  Each step
    equal to JAX's."""
    je, pe = engines(models, n_slots=2)
    outs = []
    for sys_tokens in ([], [1, 44, 45, 46, 47], [1, 44, 45, 46, 47], []):
        je.set_system_prompt(sys_tokens)
        pe.set_system_prompt(sys_tokens)
        j, p = pair([23, 24, 25], n_predict=8)
        je.submit(j)
        pe.submit(p)
        assert drain(pe, [p]) == drain(je, [j])
        same_run(je, pe, [j], [p])
        outs.append(p.output_tokens)
    assert outs[1] == outs[2] and outs[0] == outs[3] and outs[0] != outs[1]


def recorded_rows(monkeypatch, ctx) -> list:
    """The logits rows of each of ctx's decodes, recorded as they come."""
    rows, decode = [], ctx.decode

    def rec(batch):
        rc = decode(batch)
        rows.append(np.asarray(ctx.get_logits(), np.float32))
        return rc
    monkeypatch.setattr(ctx, "decode", rec)
    return rows


def test_n_probs(models, monkeypatch):
    """n_probs = 5 (the per-token host path): the same tokens as JAX's, a
    greedy token its own top-1, the log-probability at each rank within
    2 * d + 1e-4 of JAX's, where d is the largest difference of the two
    engines' logits on that step's row (a log-probability is a logit less
    the row's log-sum-exp, which moves by at most d), and the same id at
    each rank that JAX's neighbours do not crowd within that bound."""
    je, pe = engines(models)
    jrows, prows = recorded_rows(monkeypatch, je.ctx), recorded_rows(monkeypatch, pe.ctx)
    j, p = pair([1, 5, 9, 11], n_predict=8, n_probs=5)
    je.submit(j)
    pe.submit(p)
    assert drain(pe, [p]) == drain(je, [j])
    same_run(je, pe, [j], [p])
    assert pe.n_chunked == 0 and len(p.probs_output) == 8
    assert [r.shape for r in prows] == [r.shape for r in jrows] == [(1, CFG.vocab_size)] * 8
    for a, b, pr, jr in zip(p.probs_output, j.probs_output, prows, jrows):
        assert a["tok"] == b["tok"] == a["top"][0][0]
        bound = 2 * float(np.abs(pr - jr).max()) + 1e-4
        assert abs(a["logprob"] - b["logprob"]) <= bound
        ys = [y for _, y in b["top"]]
        for k, ((ta, x), (tb, y)) in enumerate(zip(a["top"], b["top"])):
            assert abs(x - y) <= bound
            crowded = any(abs(y - ys[n]) <= 2 * bound for n in (k - 1, k + 1)
                          if 0 <= n < len(ys))
            assert ta == tb or crowded


def test_grammar_masked_device_sampling(models, monkeypatch):
    """A greedy request under a grammar samples on the device through
    LlamaContext.sample_rows_device (the grammar mask uploaded as bits),
    gives JAX's text, and the port's host chain's (device path turned
    off) token for token."""
    grammar = 'root ::= ("ab")+'
    je, pe = engines(models, n_slots=1, n_batch=16)
    calls = []
    orig = pe.ctx.sample_rows_device
    monkeypatch.setattr(pe.ctx, "sample_rows_device",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    j, p = pair([1, 5], n_predict=8, grammar=grammar)
    je.submit(j)
    pe.submit(p)
    assert drain(pe, [p]) == drain(je, [j])
    same_run(je, pe, [j], [p])
    assert calls and p.output_text.startswith("ab") and set(p.output_text) <= {"a", "b"}
    monkeypatch.undo()
    monkeypatch.setattr(Engine, "_device_maskable", lambda self, q: False)
    _, pe2 = engines(models, n_slots=1, n_batch=16)
    _, p2 = pair([1, 5], n_predict=8, grammar=grammar)
    pe2.submit(p2)
    drain(pe2, [p2])
    assert p2.output_tokens == p.output_tokens


def _sampled_run(models, order, partner_seed):
    """Two sampled requests (different seeds, so the chunk takes per-row
    seeds) submitted in `order`; each request's tokens by name."""
    _, pe = engines(models, n_slots=2)
    kw = dict(temp=0.9, top_k=30, top_p=0.9)
    reqs = {"a": Request(prompt_tokens=np.array([1, 5, 9], np.int32),
                         params=SamplingParams(seed=7, **kw), n_predict=16),
            "b": Request(prompt_tokens=np.array([1, 6, 2], np.int32),
                         params=SamplingParams(seed=partner_seed, **kw), n_predict=16)}
    for name in order:
        pe.submit(reqs[name])
    drain(pe, list(reqs.values()))
    assert pe.n_chunked > 0
    return {k: r.output_tokens for k, r in reqs.items()}


def test_sampled_tokens_follow_the_seed_not_the_slot(models):
    """Sampled requests: a request's tokens are a function of its seed,
    whichever slot and batch row it takes and whatever seed its partner
    has; another seed gives other tokens."""
    a = _sampled_run(models, "ab", 3)
    b = _sampled_run(models, "ba", 3)
    c = _sampled_run(models, "ab", 11)
    assert a == b and c["a"] == a["a"] and c["b"] != a["b"]


def test_greedy_in_a_mixed_chunk_matches_alone(models):
    """A greedy request batched with a sampled one into one chunked loop
    (per-row sampling arrays) gives the tokens it gives alone on the
    per-token path, and JAX's."""
    je, pe = engines(models, n_slots=1, chunk_steps=0)
    j, p = pair([1, 5, 9], n_predict=16)
    je.submit(j)
    pe.submit(p)
    drain(je, [j])
    drain(pe, [p])
    _, pe2 = engines(models, n_slots=2)
    g = Request(prompt_tokens=np.array([1, 5, 9], np.int32),
                params=SamplingParams(temp=0.0), n_predict=16)
    s = Request(prompt_tokens=np.array([2, 7], np.int32),
                params=SamplingParams(temp=0.9, top_k=30, top_p=0.9, seed=3), n_predict=16)
    pe2.submit(g)
    pe2.submit(s)
    drain(pe2, [g, s])
    assert pe2.metrics["n_decode_steps"] < 16
    assert g.output_tokens == p.output_tokens == j.output_tokens


def test_engine_thread_failure_is_kept_and_reraised(models, monkeypatch):
    """An exception in the engine thread ends run_loop, releases the
    waiting request with the error, and submit() and check() re-raise it
    (no silent timeout)."""
    import threading

    _, pe = engines(models)
    monkeypatch.setattr(pe.ctx, "decode", lambda batch: (_ for _ in ()).throw(
        ValueError("kernel refused the shape")))
    _, p = pair([1, 5, 9])
    pe.submit(p)
    stop = threading.Event()
    t = threading.Thread(target=lambda: pytest.raises(ValueError, pe.run_loop, stop))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and p.done.is_set() and "kernel refused" in p.error
    with pytest.raises(RuntimeError, match="engine thread failed"):
        pe.submit(pair([1, 2])[1])
    assert isinstance(pe.failure, ValueError)


def test_engine_call_never_waits_forever(models):
    """Engine.call without a loop runs in the caller's thread (step()
    driven by hand); a call waiting when run_loop ends cleanly is
    released with an error, and a call after the end raises at once."""
    import threading

    _, pe = engines(models)
    assert pe.call(lambda: 7) == 7
    stop = threading.Event()
    t = threading.Thread(target=pe.run_loop, args=(stop,))
    t.start()
    assert pe.call(lambda: threading.current_thread() is t)
    started, out = threading.Event(), {}

    def slow():  # holds the loop until a second call is queued behind it
        started.set()
        time.sleep(0.3)
        stop.set()

    def waiter():
        try:
            pe.call(lambda: 1)
        except RuntimeError as e:
            out["error"] = str(e)

    caller = threading.Thread(target=lambda: pe.call(slow))
    caller.start()
    assert started.wait(30)
    w = threading.Thread(target=waiter)
    w.start()
    for th in (caller, w, t):
        th.join(timeout=30)
        assert not th.is_alive()
    assert "stopped before the call ran" in out["error"]
    with pytest.raises(RuntimeError, match="engine loop has stopped"):
        pe.call(lambda: 1)


def test_slot_ids_below_padding_sequence(models):
    """Slot i decodes as sequence i; a context pads its ubatches with
    sequence n_seq_max - 1, so an engine needs no more slots than
    sequences (JAX's layout: the same ids)."""
    pctx = LlamaContext(models["cfg"], models["pp"], n_cells=64, n_seq_max=4, device="cpu")
    tok = ToyTokenizer(CFG.vocab_size)
    assert [s.seq_id for s in Engine(pctx, tok, n_slots=4).slots] == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="n_seq_max"):
        Engine(pctx, tok, n_slots=5)
