"""The port's copy of ``llama_kotlin_tpu/tools/server.py``.

OpenAI-compatible HTTP server.  Parity target: examples/server/server.cpp:
slots + continuous batching (runtime/engine.py), SSE streaming,
/completion, /v1/completions, /v1/chat/completions, /tokenize,
/detokenize, /infill, /embeddings, /health, /slots (save, restore, erase),
/metrics (Prometheus text format), /props and a web UI at /.
Stdlib-only HTTP (ThreadingHTTPServer).

Threads: the engine runs in a thread of its own (``ServerState.start``),
the only thread that touches device tensors; the HTTP handler threads
submit requests and read their host-side results, and take the engine's
lock for the endpoints that touch the context directly (/slots actions,
/embeddings).  If the engine thread dies, its exception is kept: the
waiting requests answer 500 with it, new ones are refused, and
``shutdown`` re-raises it.

Usage:
    python -m llama_kotlin_tpu_torch.tools.server --model model.gguf --port 8080
    python -m llama_kotlin_tpu_torch.tools.server --model model.gguf --device cpu
(the flags are JAX's, plus ``--device``: cuda unless the caller asks for
the CPU; without ``--fast-mode`` the weights keep the exact-dequant repack)
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import numpy as np

from llama_kotlin_tpu_torch.runtime.chat import apply_chat_template, resolve_template
from llama_kotlin_tpu_torch.runtime.engine import Engine, Request
from llama_kotlin_tpu_torch.sampling.samplers import SamplingParams


def sampling_params_from_json(d: dict) -> SamplingParams:
    p = SamplingParams()
    mapping = {
        "temperature": "temp", "temp": "temp", "top_k": "top_k", "top_p": "top_p",
        "min_p": "min_p", "tfs_z": "tfs_z", "typical_p": "typical_p",
        "repeat_penalty": "penalty_repeat", "frequency_penalty": "penalty_freq",
        "presence_penalty": "penalty_present", "repeat_last_n": "penalty_last_n",
        "mirostat": "mirostat", "mirostat_tau": "mirostat_tau",
        "mirostat_eta": "mirostat_eta", "seed": "seed", "grammar": "grammar",
    }
    kwargs: dict[str, Any] = {}
    for k, attr in mapping.items():
        if k in d and d[k] is not None:
            kwargs[attr] = d[k]
    if "logit_bias" in d and d["logit_bias"]:
        kwargs["logit_bias"] = {int(k): float(v) for k, v in d["logit_bias"].items()}
    if d.get("json_schema"):
        from llama_kotlin_tpu_torch.sampling.json_schema import json_schema_to_gbnf

        kwargs["grammar"] = json_schema_to_gbnf(d["json_schema"])
    return SamplingParams(**kwargs)


class ServerState:
    def __init__(self, engine: Engine, tokenizer, model_name: str, template: str,
                 slot_save_path: str | None = None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.template = template
        self.slot_save_path = slot_save_path
        self.stop = threading.Event()
        self.thread = threading.Thread(
            target=engine.run_loop, args=(self.stop,), daemon=True
        )
        self.t_start = time.time()

    def start(self):
        # a call() made before the loop's first step waits for the loop
        with self.engine.lock:
            self.engine.running = True
        self.thread.start()

    def shutdown(self, timeout: float = 60.0):
        """Stop the engine thread and the HTTP server (when serve() made
        one), wait for the thread, and re-raise the engine's exception if
        it died."""
        self.stop.set()
        httpd = getattr(self, "httpd", None)
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self.thread.is_alive():
            self.thread.join(timeout)
        self.engine.check()


def make_handler(state: ServerState):
    engine = state.engine
    tokenizer = state.tokenizer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        # -- helpers ---------------------------------------------------------

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def _sse_start(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            # SSE responses have no Content-Length, so end-of-stream is only
            # observable via connection close — keep-alive would leave
            # EOF-reading clients hanging after the final event
            self.send_header("Connection", "close")
            self.end_headers()
            self.close_connection = True

        def _sse(self, obj):
            self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            self.wfile.flush()

        # -- routes ----------------------------------------------------------

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                # bundled chat UI (reference examples/server/public parity)
                from llama_kotlin_tpu_torch.tools.server_ui import INDEX_HTML

                body = INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/health":
                self._json({"status": "ok"})
            elif self.path in ("/v1/models", "/models"):
                self._json({"object": "list", "data": [
                    {"id": state.model_name, "object": "model", "owned_by": "lktpu"}
                ]})
            elif self.path == "/slots":
                self._json(engine.slots_info())
            elif self.path == "/metrics":
                m = engine.metrics
                lines = [
                    "# TYPE llamacpp:prompt_tokens_total counter",
                    f"llamacpp:prompt_tokens_total {m['prompt_tokens_processed']}",
                    "# TYPE llamacpp:tokens_predicted_total counter",
                    f"llamacpp:tokens_predicted_total {m['tokens_predicted']}",
                    "# TYPE llamacpp:requests_processed_total counter",
                    f"llamacpp:requests_processed_total {m['requests_processed']}",
                    "# TYPE llamacpp:n_decode_total counter",
                    f"llamacpp:n_decode_total {m['n_decode_steps']}",
                ]
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/props":
                self._json({
                    "model": state.model_name,
                    "n_slots": len(engine.slots),
                    "chat_template": state.template,
                })
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            try:
                if self.path == "/tokenize":
                    d = self._read_json()
                    ids = tokenizer.encode(d.get("content", ""),
                                           add_special=bool(d.get("add_special", False)),
                                           parse_special=True)
                    self._json({"tokens": ids})
                elif self.path == "/detokenize":
                    d = self._read_json()
                    self._json({"content": tokenizer.decode(d.get("tokens", []))})
                elif self.path == "/completion" or self.path == "/v1/completions":
                    self._completion(openai=self.path.startswith("/v1"))
                elif self.path == "/v1/chat/completions":
                    self._chat()
                elif self.path in ("/embedding", "/embeddings", "/v1/embeddings"):
                    self._embeddings()
                elif self.path == "/infill":
                    self._infill()
                elif self.path.startswith("/slots/"):
                    self._slot_action()
                else:
                    self._json({"error": "not found"}, 404)
            except BrokenPipeError:
                pass
            except Exception as e:  # noqa: BLE001
                try:
                    self._json({"error": repr(e)}, 500)
                except Exception:
                    pass

        # -- completion logic -------------------------------------------------

        def _infill(self):
            """Fill-in-the-middle completion (parity: server /infill)."""
            from llama_kotlin_tpu_torch.tools.infill import infill_tokens

            d = self._read_json()
            ids = infill_tokens(tokenizer, d.get("input_prefix", ""),
                                d.get("input_suffix", ""),
                                spm_fill=bool(d.get("spm_infill", False)))
            self._submit_and_respond(None, d, None,
                                     tokens=np.asarray(ids, np.int32))

        def _submit_and_respond(self, prompt_text, d, openai_kind: Optional[str],
                                tokens: Optional[np.ndarray] = None):
            params = sampling_params_from_json(d)
            n_predict = int(d.get("n_predict", d.get("max_tokens", 128)) or 128)
            stops = d.get("stop", [])
            if isinstance(stops, str):
                stops = [stops]
            # per-token logprobs: native n_probs (server.cpp:931) or the
            # OpenAI spellings (completions: logprobs=N; chat:
            # logprobs=true + top_logprobs=N)
            n_probs = int(d.get("n_probs") or 0)
            if openai_kind == "text" and d.get("logprobs"):
                n_probs = max(n_probs, int(d["logprobs"]))
            elif openai_kind == "chat" and d.get("logprobs"):
                n_probs = max(n_probs, int(d.get("top_logprobs") or 1))
            if d.get("system_prompt") is not None:
                # global system prefix update (server.cpp:642,1130)
                sp = d["system_prompt"]
                sp_text = sp.get("prompt", "") if isinstance(sp, dict) else str(sp)
                engine.set_system_prompt(
                    tokenizer.encode(sp_text, add_special=False,
                                     parse_special=True))
            if tokens is None:
                tokens = np.asarray(
                    tokenizer.encode(prompt_text, add_special=True, parse_special=True),
                    np.int32,
                )
            stream = bool(d.get("stream", False))
            created = int(time.time())
            rid = "cmpl-" + time.strftime("%H%M%S")

            def probs_json(entries):
                # probs_vector_to_json shape (reference examples/server/
                # utils.hpp): [{content, probs: [{tok_str, prob}]}]
                return [{
                    "content": tokenizer.decode([e["tok"]], skip_special=False),
                    "probs": [{"tok_str": tokenizer.decode([t], skip_special=False),
                               "prob": float(np.exp(lp))} for t, lp in e["top"]],
                } for e in entries]

            if stream:
                q: queue.Queue = queue.Queue()
                req = Request(
                    prompt_tokens=tokens, params=params, n_predict=n_predict,
                    stop_strings=tuple(stops), n_probs=n_probs,
                    stream=lambda tok, text, done: q.put((tok, text, done)),
                )
                engine.submit(req)
                self._sse_start()
                n_sent_probs = 0
                while True:
                    tok, text, done = q.get()
                    if openai_kind == "chat":
                        payload = {
                            "id": rid, "object": "chat.completion.chunk",
                            "created": created, "model": state.model_name,
                            "choices": [{
                                "index": 0,
                                "delta": ({"content": text} if text else {}),
                                "finish_reason": req.stop_reason or None if done else None,
                            }],
                        }
                    elif openai_kind == "text":
                        payload = {
                            "id": rid, "object": "text_completion", "created": created,
                            "model": state.model_name,
                            "choices": [{"index": 0, "text": text,
                                         "finish_reason": req.stop_reason or None if done else None}],
                        }
                    else:  # llama.cpp native /completion
                        payload = {"content": text, "stop": done}
                        if n_probs > 0:
                            fresh = req.probs_output[n_sent_probs:]
                            n_sent_probs = len(req.probs_output)
                            payload["completion_probabilities"] = probs_json(fresh)
                    self._sse(payload)
                    if done:
                        if req.error is not None:
                            self._sse({"error": req.error})
                        if openai_kind:
                            self.wfile.write(b"data: [DONE]\n\n")
                            self.wfile.flush()
                        break
                return

            req = Request(prompt_tokens=tokens, params=params, n_predict=n_predict,
                          stop_strings=tuple(stops), n_probs=n_probs)
            engine.submit(req)
            req.done.wait()
            if req.error is not None:
                self._json({"error": req.error}, 500)
                return
            usage = {
                "prompt_tokens": int(tokens.size),
                "completion_tokens": len(req.output_tokens),
                "total_tokens": int(tokens.size) + len(req.output_tokens),
            }
            if openai_kind == "chat":
                choice = {
                    "index": 0,
                    "message": {"role": "assistant", "content": req.output_text},
                    "finish_reason": req.stop_reason,
                }
                if n_probs > 0:
                    choice["logprobs"] = {"content": [{
                        "token": tokenizer.decode([e["tok"]], skip_special=False),
                        "logprob": e["logprob"],
                        "top_logprobs": [
                            {"token": tokenizer.decode([t], skip_special=False),
                             "logprob": lp} for t, lp in e["top"]],
                    } for e in req.probs_output]}
                self._json({
                    "id": rid, "object": "chat.completion", "created": created,
                    "model": state.model_name,
                    "choices": [choice],
                    "usage": usage,
                })
            elif openai_kind == "text":
                choice = {"index": 0, "text": req.output_text,
                          "finish_reason": req.stop_reason}
                if n_probs > 0:
                    choice["logprobs"] = {
                        "tokens": [tokenizer.decode([e["tok"]], skip_special=False)
                                   for e in req.probs_output],
                        "token_logprobs": [e["logprob"] for e in req.probs_output],
                        "top_logprobs": [
                            {tokenizer.decode([t], skip_special=False): lp
                             for t, lp in e["top"]} for e in req.probs_output],
                    }
                self._json({
                    "id": rid, "object": "text_completion", "created": created,
                    "model": state.model_name,
                    "choices": [choice],
                    "usage": usage,
                })
            else:
                out = {
                    "content": req.output_text,
                    "stop": True,
                    "stopped_eos": req.stop_reason == "eos",
                    "stopped_limit": req.stop_reason == "length",
                    "stopping_word": req.stop_reason == "stop",
                    "tokens_predicted": len(req.output_tokens),
                    "timings": {
                        "prompt_n": int(tokens.size),
                        "predicted_n": len(req.output_tokens),
                        "ttft_ms": round((req.t_first_token - req.t_start) * 1e3, 2)
                        if req.t_first_token else None,
                    },
                }
                if n_probs > 0:
                    out["completion_probabilities"] = probs_json(req.probs_output)
                self._json(out)

        def _slot_action(self):
            """POST /slots/{id}?action=save|restore|erase (parity:
            server slot save/restore, slotsave.feature)."""
            import re as _re
            from urllib.parse import parse_qs, urlparse

            from llama_kotlin_tpu_torch.runtime import state as state_io

            u = urlparse(self.path)
            m = _re.match(r"^/slots/(\d+)$", u.path)
            if not m:
                self._json({"error": "bad slot path"}, 400)
                return
            slot_id = int(m.group(1))
            if slot_id >= len(engine.slots):
                self._json({"error": "no such slot"}, 404)
                return
            action = (parse_qs(u.query).get("action") or ["?"])[0]
            d = self._read_json()
            # confine client-supplied filenames to the slot-save directory
            # (reference: --slot-save-path; unset -> feature disabled)
            if state.slot_save_path is None and action in ("save", "restore"):
                self._json({"error": "slot save/restore disabled "
                            "(no --slot-save-path)"}, 400)
                return
            import os as _os

            fname = _os.path.basename(str(d.get("filename",
                                               f"slot{slot_id}.bin")))
            filename = (_os.path.join(state.slot_save_path, fname)
                        if state.slot_save_path else fname)
            slot = engine.slots[slot_id]
            if action == "save":
                # the cache is read on the engine thread, the file written here
                blob, n_saved = engine.call(lambda: (
                    state_io.get_seq_data(engine.ctx, slot.seq_id), len(slot.tokens)))
                with open(filename, "wb") as fh:
                    fh.write(blob)
                self._json({"id_slot": slot_id, "filename": filename,
                            "n_saved": n_saved})
            elif action == "restore":
                blob = open(filename, "rb").read()

                def restore():
                    engine.ctx.seq_rm(slot.seq_id)
                    return state_io.set_seq_data(engine.ctx, blob, slot.seq_id)
                rc = engine.call(restore)
                self._json({"id_slot": slot_id, "success": rc == 0})
            elif action == "erase":
                def erase():
                    engine.ctx.seq_rm(slot.seq_id)
                    slot.reset()
                engine.call(erase)
                self._json({"id_slot": slot_id, "erased": True})
            else:
                self._json({"error": f"unknown action {action}"}, 400)

        def _embeddings(self):
            """Pooled embeddings (uses a dedicated seq on the shared ctx)."""
            d = self._read_json()
            inputs = d.get("input", d.get("content", ""))
            if isinstance(inputs, str):
                inputs = [inputs]
            from llama_kotlin_tpu_torch.runtime.batch import Batch

            ctx = engine.ctx
            seq = len(engine.slots)  # a seq id the slots never use
            ids_all = [tokenizer.encode(text, add_special=True, parse_special=True)
                       for text in inputs]

            def embed():  # on the engine thread, between its steps
                embs = []
                for ids in ids_all:
                    ctx.seq_rm(seq)
                    rc = ctx.decode(Batch.single(np.asarray(ids, np.int32),
                                                 seq_id=seq, logits_last_only=False))
                    if rc != 0:
                        return None
                    embs.append(ctx.get_embeddings("mean"))
                    ctx.seq_rm(seq)
                return embs

            embs = engine.call(embed)
            if embs is None:
                self._json({"error": "kv cache full"}, 503)
                return
            data = [{"object": "embedding", "index": i,
                     "embedding": [float(v) for v in emb]} for i, emb in enumerate(embs)]
            self._json({"object": "list", "data": data, "model": state.model_name})

        def _completion(self, openai: bool):
            d = self._read_json()
            prompt = d.get("prompt", "")
            self._submit_and_respond(prompt, d, "text" if openai else None)

        def _chat(self):
            d = self._read_json()
            messages = d.get("messages", [])
            text = apply_chat_template(messages, state.template)
            self._submit_and_respond(text, d, "chat")

    return Handler


def serve(ctx, tokenizer, model_name="model", template: Optional[str] = None,
          host="127.0.0.1", port=8080, n_slots=4, n_batch=256,
          slot_save_path: Optional[str] = None) -> ServerState:
    engine = Engine(ctx, tokenizer, n_slots=n_slots, n_batch=n_batch)
    template = template or "chatml"
    state = ServerState(engine, tokenizer, model_name, template,
                        slot_save_path=slot_save_path)
    state.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    state.httpd = httpd  # type: ignore[attr-defined]
    return state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--n-ctx", type=int, default=4096)
    ap.add_argument("--n-batch", type=int, default=256)
    ap.add_argument("--cache-type-k", "-ctk", default="f16",
                    choices=["f16", "bf16", "q8_0", "q4_0"],
                    help="KV cache type (q8_0 = int8 K/V, q4_0 = packed "
                         "int4 K/V)")
    ap.add_argument("--fast-mode", default=None, choices=["int8", "w4", "w4x"],
                    help="serving weight layout (see tools/main.py --fast-mode)")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable the fused q|k|v / gate|up serving fold")
    ap.add_argument("--slot-save-path", default=None,
                    help="directory for /slots save/restore files "
                         "(unset = endpoint disabled, like the reference)")
    ap.add_argument("--system-prompt-file", default=None,
                    help="file whose contents prefix every request "
                         "(reference server.cpp --system-prompt-file)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from llama_kotlin_tpu_torch.models.loader import load_gguf_model
    from llama_kotlin_tpu_torch.runtime.context import LlamaContext
    from llama_kotlin_tpu_torch.tokenizer import build_tokenizer

    cfg, params, f = load_gguf_model(args.model, fast_mode=args.fast_mode,
                                     fuse=not args.no_fuse, device=args.device)
    tokenizer = build_tokenizer(f.metadata)
    template = resolve_template(f.metadata.get("tokenizer.chat_template"), cfg.arch)
    f.close()
    kv_quant = args.cache_type_k if args.cache_type_k in ("q8_0", "q4_0") else False
    ctx = LlamaContext(cfg, params, n_cells=args.n_ctx, kv_quant=kv_quant,
                       device=args.device)
    state = serve(ctx, tokenizer, model_name=cfg.name or "model", template=template,
                  slot_save_path=args.slot_save_path,
                  host=args.host, port=args.port, n_slots=args.n_slots,
                  n_batch=args.n_batch)
    if args.system_prompt_file:
        state.engine.set_system_prompt(tokenizer.encode(
            open(args.system_prompt_file).read(), add_special=False,
            parse_special=True))
    print(f"listening on http://{args.host}:{args.port}")
    try:
        state.httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.shutdown()


if __name__ == "__main__":
    main()
