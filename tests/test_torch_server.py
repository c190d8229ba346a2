"""The port's OpenAI server (``tools/server.py``) over a real socket, beside
JAX's, with the cases of tests/test_server.py.

Both servers serve the tiny Q8_0 model of tests/test_torch_engine.py (the
exact-dequant mode, 2 slots, 256 cells) with tests/test_server.py's toy
tokenizer, each on 127.0.0.1 at a free port with its engine in a thread
of its own.  Each case sends the same requests to both: every response
is 200 where JAX's is, its JSON has JAX's keys at every level (ids,
times and timings aside, which differ run to run), and greedy outputs are
JAX's (the text is a function of the token ids under this tokenizer).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext
from llama_kotlin_tpu.runtime.engine import Engine as JaxEngine
from llama_kotlin_tpu.tools import server as jax_server

from llama_kotlin_tpu_torch.runtime.context import LlamaContext
from llama_kotlin_tpu_torch.runtime.engine import Engine, Request
from llama_kotlin_tpu_torch.sampling.samplers import SamplingParams
from llama_kotlin_tpu_torch.tools import server

from test_server import ToyTokenizer
from test_torch_cli import one_thread  # noqa: F401 (autouse fixture)
from test_torch_engine import CFG, LOGIT_TOL, load_both, write_model

VOLATILE = {"id", "created", "timings", "filename"}


def _start(mod, engine_cls, ctx, tok, slot_dir):
    engine = engine_cls(ctx, tok, n_slots=2, n_batch=64)
    state = mod.ServerState(engine, tok, "tiny", "chatml", slot_save_path=slot_dir)
    state.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", engine, state, httpd


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{"port": (url, engine), "jax": (url, engine)}."""
    jcfg, jp, cfg, pp = load_both(write_model(tmp_path_factory.mktemp("srv") / "m.gguf"))
    tok = ToyTokenizer(CFG.vocab_size)
    out, stops = {}, []
    for name, mod, eng, ctx in (
            ("port", server, Engine, LlamaContext(cfg, pp, n_cells=256, device="cpu")),
            ("jax", jax_server, JaxEngine, JaxContext(jcfg, jp, n_cells=256))):
        url, engine, state, httpd = _start(mod, eng, ctx, tok, tempfile.mkdtemp(prefix="slots"))
        out[name] = (url, engine)
        stops.append((state, httpd))
    out["model"] = (cfg, pp)
    yield out
    for state, httpd in stops:
        httpd.shutdown()
        state.shutdown()
    out["port"][1].check()


def _post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.headers, r.read()


def _both_post(served, path, payload):
    return _post(served["port"][0] + path, payload), _post(served["jax"][0] + path, payload)


def same_keys(a, b, path=""):
    """JAX's keys at every level (lists: element by element where both
    have the element)."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in b:
            if k not in VOLATILE:
                same_keys(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert isinstance(a, list), path
        for i, (x, y) in enumerate(zip(a, b)):
            same_keys(x, y, f"{path}[{i}]")


def _stream(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        for line in r:
            line = line.strip()
            if line.startswith(b"data: "):
                if line == b"data: [DONE]":
                    events.append("[DONE]")
                    break
                events.append(json.loads(line[6:]))
    return events


def test_engine_direct(served):
    _, engine = served["port"]
    req = Request(prompt_tokens=np.array([1, 5, 9], np.int32),
                  params=SamplingParams(temp=0.0), n_predict=8)
    engine.submit(req)
    assert req.done.wait(timeout=120) and req.error is None
    assert len(req.output_tokens) >= 1 and req.stop_reason in ("length", "eos")


def test_http_health_models_props_ui(served):
    """GET /health, /v1/models, /props and the web UI: JAX's bodies."""
    for path in ("/health", "/v1/models", "/models", "/props"):
        (sa, _, a), (sb, _, b) = _get(served["port"][0] + path), _get(served["jax"][0] + path)
        assert sa == sb == 200 and json.loads(a) == json.loads(b)
    (_, ha, a), (_, hb, b) = _get(served["port"][0] + "/"), _get(served["jax"][0] + "/")
    assert ha["Content-Type"] == hb["Content-Type"]
    assert ha["Content-Type"].startswith("text/html")
    assert b"/v1/chat/completions" in a and b"<textarea" in a
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(served["port"][0] + "/nope")
    assert e.value.code == 404


def test_http_completion(served):
    a, b = _both_post(served, "/completion", {"prompt": "hi", "n_predict": 4,
                                              "temperature": 0})
    same_keys(a, b)
    assert a["content"] == b["content"] and a["stop"] is True
    assert a["tokens_predicted"] == b["tokens_predicted"] >= 1


def test_http_openai_chat_and_completions(served):
    body = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 4,
            "temperature": 0}
    a, b = _both_post(served, "/v1/chat/completions", body)
    same_keys(a, b)
    assert a["object"] == "chat.completion" and a["choices"] == b["choices"]
    assert a["usage"] == b["usage"] and a["usage"]["completion_tokens"] >= 1
    a, b = _both_post(served, "/v1/completions", {"prompt": "abc", "max_tokens": 5,
                                                  "temperature": 0})
    same_keys(a, b)
    assert a["choices"] == b["choices"] and a["usage"] == b["usage"]


@pytest.mark.parametrize("path,kind", [("/v1/chat/completions", "chat"),
                                       ("/v1/completions", "text"), ("/completion", None)])
def test_http_streaming(served, path, kind):
    """SSE on the three routes: JAX's event keys, the same deltas, [DONE]
    after the OpenAI ones; the deltas add up to the non-streamed text."""
    body = {"max_tokens": 6, "n_predict": 6, "temperature": 0, "stream": True}
    body.update({"messages": [{"role": "user", "content": "hi"}]} if kind == "chat"
                else {"prompt": "hi"})
    a = _stream(served["port"][0] + path, body)
    b = _stream(served["jax"][0] + path, body)
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        same_keys(x, y)
    assert (a[-1] == "[DONE]") == (kind is not None)
    texts, jtexts = ([e["choices"][0].get("delta", {}).get("content", "") if kind == "chat"
                      else e["choices"][0]["text"] if kind == "text" else e["content"]
                      for e in evs if e != "[DONE]"] for evs in (a, b))
    assert texts == jtexts
    full = _post(served["port"][0] + path, dict(body, stream=False))
    want = (full["choices"][0]["message"]["content"] if kind == "chat"
            else full["choices"][0]["text"] if kind == "text" else full["content"])
    assert "".join(texts) == want
    if kind == "chat":
        assert a[0]["object"] == "chat.completion.chunk"


def test_http_parallel_requests(served):
    """Four greedy requests at once on 2 slots: each ends, each is the text
    the same request gets alone (and JAX's)."""
    url = served["port"][0]
    results = {}

    def worker(i):
        results[i] = _post(url + "/completion", {"prompt": f"req{i}", "n_predict": 6,
                                                 "temperature": 0})
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert len(results) == 4 and all(r["stop"] for r in results.values())
    for i, r in results.items():
        b = _post(served["jax"][0] + "/completion", {"prompt": f"req{i}", "n_predict": 6,
                                                     "temperature": 0})
        assert r["content"] == b["content"]


def test_http_tokenize_detokenize_metrics_slots(served):
    """/tokenize and /detokenize give JAX's bodies; /metrics has JAX's
    counters and counts the tokens returned so far; /slots lists 2."""
    for path, body in (("/tokenize", {"content": "abc"}), ("/detokenize", {"tokens": [5, 6]})):
        a, b = _both_post(served, path, body)
        assert a == b
    assert len(a["content"]) == 2 and len(_post(served["port"][0] + "/tokenize",
                                                {"content": "abc"})["tokens"]) == 3
    engine = served["port"][1]
    _, _, text = _get(served["port"][0] + "/metrics")
    _, _, jtext = _get(served["jax"][0] + "/metrics")
    names = lambda t: [ln.split()[0] for ln in t.decode().splitlines()]  # noqa: E731
    assert names(text) == names(jtext)
    counts = dict(ln.split() for ln in text.decode().splitlines() if not ln.startswith("#"))
    assert int(counts["llamacpp:tokens_predicted_total"]) == engine.metrics["tokens_predicted"]
    status, _, body = _get(served["port"][0] + "/slots")
    slots = json.loads(body)
    assert status == 200 and len(slots) == 2
    same_keys(slots, json.loads(_get(served["jax"][0] + "/slots")[2]))


def test_http_infill(served):
    a, b = _both_post(served, "/infill", {"input_prefix": "ab", "input_suffix": "yz",
                                          "n_predict": 4, "temperature": 0})
    same_keys(a, b)
    assert a["stop"] is True and a["content"] == b["content"]


def test_http_embeddings(served):
    """Mean-pooled final-norm hidden states on a sequence the slots never
    use, computed on the engine thread: JAX's keys, values within the
    logits bound of JAX's."""
    body = {"input": ["abc", "hello"]}
    a, b = _both_post(served, "/v1/embeddings", body)
    same_keys(a, b)
    for x, y in zip(a["data"], b["data"]):
        ex, ey = np.asarray(x["embedding"]), np.asarray(y["embedding"])
        assert ex.shape == (CFG.n_embd,)
        assert np.abs(ex - ey).max() <= LOGIT_TOL * np.abs(ey).max()


def test_slot_save_restore(served):
    """save/restore/erase through the port's state files; a path-traversal
    name is reduced to its basename in the slot directory; JAX's keys."""
    for name in ("port", "jax"):
        assert _post(served[name][0] + "/completion", {"prompt": "abc", "n_predict": 3,
                                                      "temperature": 0})["stop"]
    fn = "../../etc/slot0.bin"
    saved, jsaved = _both_post(served, "/slots/0?action=save", {"filename": fn})
    same_keys(saved, jsaved)
    assert saved["id_slot"] == 0 and saved["n_saved"] == jsaved["n_saved"]
    assert os.path.basename(saved["filename"]) == "slot0.bin"
    assert os.path.dirname(os.path.abspath(saved["filename"])) != "/etc"
    restored, jr = _both_post(served, "/slots/0?action=restore", {"filename": fn})
    assert restored == jr and restored["success"] is True
    erased, je = _both_post(served, "/slots/0?action=erase", {})
    assert erased == je and erased["erased"] is True


def test_stream_never_leaks_trimmed_stop_content(served):
    """Streamed deltas concatenate to exactly the final (stop-trimmed)
    output_text."""
    _, engine = served["port"]
    params = SamplingParams(temp=0.0)
    r0 = Request(prompt_tokens=np.array([1, 9, 25], np.int64), params=params, n_predict=24)
    engine.submit(r0)
    assert r0.done.wait(60) and len(r0.output_text) > 4
    stop = r0.output_text[len(r0.output_text) // 2:][:3]
    deltas = []
    r1 = Request(prompt_tokens=np.array([1, 9, 25], np.int64), params=params, n_predict=24,
                 stop_strings=(stop,), stream=lambda tok, text, done: deltas.append(text))
    engine.submit(r1)
    assert r1.done.wait(60)
    assert stop not in r1.output_text and "".join(deltas) == r1.output_text
    assert r1.stop_reason == "stop"


def test_http_completion_n_probs(served):
    """Native n_probs: JAX's probs_vector_to_json shape, the same pieces,
    probabilities sorted and within the logits bound of JAX's."""
    a, b = _both_post(served, "/completion", {"prompt": "hi", "n_predict": 3,
                                              "temperature": 0, "n_probs": 4})
    same_keys(a, b)
    assert a["content"] == b["content"]
    for x, y in zip(a["completion_probabilities"], b["completion_probabilities"]):
        assert x["content"] == y["content"] and len(x["probs"]) == 4
        ps = [p["prob"] for p in x["probs"]]
        assert all(0.0 <= p <= 1.0 for p in ps) and ps == sorted(ps, reverse=True)
        for p, q in zip(ps, [q["prob"] for q in y["probs"]]):
            assert abs(p - q) <= 2 * LOGIT_TOL


def test_http_openai_logprobs(served):
    """OpenAI spellings: completions logprobs=N; chat logprobs=true +
    top_logprobs=N; JAX's keys; a greedy token's logprob is its best."""
    a, b = _both_post(served, "/v1/completions", {"prompt": "hi", "max_tokens": 3,
                                                  "temperature": 0, "logprobs": 3})
    same_keys(a, b)
    lp = a["choices"][0]["logprobs"]
    assert lp["tokens"] == b["choices"][0]["logprobs"]["tokens"]
    assert len(lp["tokens"]) == len(lp["token_logprobs"]) >= 1
    assert all(v <= 0.0 for v in lp["token_logprobs"])
    for tl, v in zip(lp["top_logprobs"], lp["token_logprobs"]):
        assert abs(max(tl.values()) - v) < 1e-9
    a, b = _both_post(served, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hello"}], "max_tokens": 3,
        "temperature": 0, "logprobs": True, "top_logprobs": 2})
    same_keys(a, b)
    content = a["choices"][0]["logprobs"]["content"]
    assert len(content) >= 1
    for e in content:
        assert e["logprob"] <= 0.0 and len(e["top_logprobs"]) == 2


def test_http_system_prompt(served):
    """A global system prompt prefixes every request and changes the greedy
    output; it is sticky; clearing it restores the old output; JAX's texts
    at each step."""
    runs = [{}, {"system_prompt": "You are terse."}, {}, {"system_prompt": ""}]
    outs = []
    for extra in runs:
        a, b = _both_post(served, "/completion", dict({"prompt": "xyz", "n_predict": 6,
                                                       "temperature": 0}, **extra))
        assert a["content"] == b["content"]
        outs.append(a["content"])
    assert outs[1] != outs[0] and outs[2] == outs[1] and outs[3] == outs[0]
    assert not served["port"][1].system_tokens


def test_server_saturation_mixed_streaming(served):
    """Three times as many streaming requests as slots, mixed n_predict:
    every request completes with its requested count and no stall."""
    url, engine = served["port"]
    n_req = 3 * len(engine.slots)
    lens = [3 + (i % 4) * 2 for i in range(n_req)]
    results: dict[int, list] = {i: [] for i in range(n_req)}
    errors: list = []

    def run(i):
        try:
            results[i] = _stream(url + "/completion", {"prompt": f"req {i}",
                                                       "n_predict": lens[i],
                                                       "temperature": 0, "stream": True})
        except Exception as e:  # noqa: BLE001
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_req)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert all(not t.is_alive() for t in threads), "stalled request"
    for i in range(n_req):
        evs = results[i]
        assert evs and evs[-1]["stop"] is True
        assert 1 <= sum(1 for e in evs if e.get("content")) <= lens[i] + 1
    assert time.time() - t0 < 240


def test_failed_engine_answers_500_and_shutdown_reraises(served, monkeypatch):
    """An engine thread that dies releases its waiting request with the
    error (500 with its text), refuses the next, and shutdown() re-raises
    the exception."""
    ctx = LlamaContext(*served["model"], n_cells=64, device="cpu")
    url, eng, state, httpd = _start(server, Engine, ctx, ToyTokenizer(CFG.vocab_size), None)
    monkeypatch.setattr(eng.ctx, "decode", lambda batch: (_ for _ in ()).throw(
        ValueError("kernel refused the shape")))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/completion", {"prompt": "hi", "n_predict": 2, "temperature": 0})
    assert e.value.code == 500 and "kernel refused" in json.loads(e.value.read())["error"]
    httpd.shutdown()
    with pytest.raises(RuntimeError, match="engine thread failed"):
        state.shutdown()
