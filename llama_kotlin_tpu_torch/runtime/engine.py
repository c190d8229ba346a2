"""Continuous-batching serving engine (port of
``llama_kotlin_tpu/runtime/engine.py``).

Parity target: the reference server's slot machinery (server_slot
server.cpp:128, server_queue :381, update_slots :1884): N slots share one
context; every engine step packs prompt chunks and one token per
generating slot into a single Batch, decodes once, then samples/streams
per slot.  The unified cell cache makes the packing trivial: any mix of
prompt and decode tokens is one flat ubatch.

Also implements: prompt-cache longest-common-prefix reuse (server.cpp:847),
context shift for full slots (:1947), stop strings, n_keep, per-request
sampling params and ``n_probs``.

How the port differs from JAX's engine: the cache is updated in place;
``_chunked_decode`` runs the port's ``generate_loop`` (a Python loop of
device work) with its per-slot sampling arrays as tensors on the
context's device; ``run_loop`` sets that device as the thread's current
CUDA device, since the kernels launch on the current thread's stream.
Only the engine thread touches device tensors: other threads submit
requests and read host-side results.  If the engine thread dies, its
exception is kept (``failure``), every waiting request is released with
the error, and ``check``/``submit`` re-raise it.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Optional

import numpy as np
import torch

from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext
from llama_kotlin_tpu_torch.sampling.samplers import SamplerChain, SamplingParams


def _stop_holdback(text: str, stops: tuple[str, ...]) -> int:
    """Longest suffix of `text` that is a proper prefix of any stop string."""
    hb = 0
    for s in stops:
        for ln in range(min(len(s) - 1, len(text)), hb, -1):
            if s.startswith(text[-ln:]):
                hb = ln
                break
    return hb


class SlotState(Enum):
    IDLE = 0
    PROMPT = 1
    GENERATING = 2


@dataclass
class Request:
    prompt_tokens: np.ndarray
    params: SamplingParams
    n_predict: int = 128
    stop_strings: tuple[str, ...] = ()
    stream: Optional[Callable[[int, str, bool], None]] = None  # (token, text, done)
    n_keep: int = 0
    # top-N per-token probabilities (reference n_probs, server.cpp:931):
    # > 0 routes the request through the per-token host path and fills
    # probs_output with one entry per generated token
    n_probs: int = 0
    id: str = field(default_factory=lambda: uuid.uuid4().hex[:12])
    # results
    done: threading.Event = field(default_factory=threading.Event)
    # [{"tok": id, "logprob": f, "top": [(id, logprob), ...]}] per token
    probs_output: list = field(default_factory=list)
    output_tokens: list[int] = field(default_factory=list)
    output_text: str = ""
    stop_reason: str = ""
    error: Optional[str] = None
    t_start: float = field(default_factory=time.time)
    t_first_token: float = 0.0
    t_done: float = 0.0
    streamed_len: int = 0  # chars of output_text already sent to the client


@dataclass
class Slot:
    id: int
    seq_id: int
    state: SlotState = SlotState.IDLE
    request: Optional[Request] = None
    tokens: list[int] = field(default_factory=list)  # full token history (prompt+gen)
    n_past: int = 0  # tokens already in cache
    n_prompt: int = 0
    sampler: Optional[SamplerChain] = None

    def reset(self):
        self.state = SlotState.IDLE
        self.request = None
        self.tokens = []
        self.n_past = 0
        self.n_prompt = 0
        self.sampler = None


class Engine:
    """Drives a LlamaContext with n_slots parallel sequences."""

    def __init__(self, ctx: LlamaContext, tokenizer, n_slots: int = 4,
                 n_batch: int = 256, chunk_steps: int = 8):
        # slot i decodes as sequence i: a bit of the cells' n_seq_max-bit
        # sequence masks
        if n_slots > ctx.n_seq_max:
            raise ValueError(f"{n_slots} slots need a context with n_seq_max >= {n_slots}")
        self.ctx = ctx
        # the CUDA device the engine thread makes current: the context's, or
        # the creating thread's current one for a bare "cuda"
        self.cuda_index = None if ctx.device.type != "cuda" else (
            ctx.device.index if ctx.device.index is not None else torch.cuda.current_device())
        self.tokenizer = tokenizer
        self.n_batch = n_batch
        # when all active slots are device-sampleable, decode up to this
        # many steps per slot in ONE on-device loop (generate_loop) instead
        # of one host round-trip per token; 0 disables.  Other sampling,
        # n_probs, and prompt phases use the per-token path.
        self.chunk_steps = chunk_steps
        self.slots = [Slot(id=i, seq_id=i) for i in range(n_slots)]
        self.queue: list[Request] = []
        # work other threads hand to the engine thread (call)
        self.tasks: list[tuple[Callable, dict, threading.Event]] = []
        self.lock = threading.Lock()
        self.running = False
        self.ended = False  # run_loop has returned: call() raises
        self.failure: Optional[BaseException] = None
        self.metrics = {
            "prompt_tokens_processed": 0,
            "tokens_predicted": 0,
            "requests_processed": 0,
            "n_decode_steps": 0,
        }
        # how many steps took the chunked on-device loop (not in JAX's
        # metrics dict, so /metrics stays JAX's)
        self.n_chunked = 0
        # per-slot context budget, like server's n_ctx / n_parallel
        self.slot_ctx = ctx.n_cells // n_slots
        # global system prompt prepended to every request's prompt
        # (reference --system-prompt-file / request "system_prompt",
        # server.cpp:642,1130); the per-slot prompt-cache LCP reuse keeps
        # the shared prefix cached across requests
        self.system_tokens: list[int] = []

    # -- public API ----------------------------------------------------------

    def submit(self, req: Request) -> Request:
        self.check()
        with self.lock:
            self.queue.append(req)
        return req

    def call(self, fn: Callable):
        """Run fn() on the engine thread between two steps and return its
        result (or raise its exception): how other threads reach the
        context, whose tensors only the engine thread touches.  Without a
        run_loop (step() driven by hand) fn runs in the caller's thread,
        as step() does; once run_loop has ended, call raises, and a call
        still waiting when it ends is released with an error."""
        self.check()
        box: dict = {}
        ev = threading.Event()
        with self.lock:
            if self.ended:
                raise RuntimeError("the engine loop has stopped")
            if not self.running:
                return fn()
            self.tasks.append((fn, box, ev))
        ev.wait()
        if "error" in box:
            raise box["error"]
        return box["value"]

    def _run_tasks(self) -> None:
        with self.lock:
            tasks, self.tasks = self.tasks, []
        for fn, box, ev in tasks:
            try:
                box["value"] = fn()
            except Exception as e:  # noqa: BLE001 (handed to the caller)
                box["error"] = e
            ev.set()

    def check(self) -> None:
        """Re-raise the engine thread's exception, if it died."""
        if self.failure is not None:
            raise RuntimeError("the engine thread failed") from self.failure

    def set_system_prompt(self, tokens) -> None:
        """Set/replace the global system prefix; idle slots' caches are
        cleared so stale prefixes never match via LCP reuse."""
        with self.lock:
            self.system_tokens = [int(t) for t in tokens]
            for slot in self.slots:
                if slot.state == SlotState.IDLE:
                    self.ctx.seq_rm(slot.seq_id, 0, -1)
                    slot.tokens = []
                    slot.n_past = 0

    def step(self) -> bool:
        """One update_slots iteration; returns True if any work was done."""
        if self.tasks:
            self._run_tasks()
        with self.lock:
            self._assign_requests()
            chunk = self._chunk_plan()
            batch = None if chunk else self._build_batch()
        if chunk:
            return self._chunked_decode(*chunk)
        if batch is None:
            return False
        rc = self.ctx.decode(batch)
        if rc != 0:
            self._handle_cache_full()
            return True
        # one-token-lookahead overlap: the decode runs asynchronously on
        # the device, so compute each grammar slot's next-token mask NOW (it
        # depends only on the grammar state, not the logits)
        for slot in self.slots:
            if (getattr(slot, "_batch_n", 0) > 0 and slot.sampler is not None
                    and slot.sampler.grammar is not None):
                slot.sampler.precompute_grammar(self.tokenizer)
        self._consume_results(batch)
        self.metrics["n_decode_steps"] += 1
        return True

    _DEFAULT_ORDER = ("top_k", "tfs_z", "typical_p", "top_p", "min_p",
                      "temperature")

    def _device_maskable(self, p) -> bool:
        """Params the on-device sampler reproduces exactly MODULO grammar
        (greedy, or the default chain order with top_k/top_p/min_p/temp +
        penalties).  Mirostat, logit bias, CFG, tfs/typical/dynatemp stay
        on the per-token host path."""
        if p.mirostat != 0 or p.logit_bias or p.cfg_scale != 1.0:
            return False
        if p.temp <= 0.0:
            return True
        if (p.tfs_z != 1.0 or p.typical_p != 1.0 or p.dynatemp_range != 0.0
                or tuple(p.samplers) != self._DEFAULT_ORDER):
            return False
        # device top_p/min_p run inside the top_k candidate window: exact
        # only when top_k prefilters (the default chain order), or trivially
        # when both are off (full-vocab categorical)
        return p.top_k > 0 or (p.top_p >= 1.0 and p.min_p <= 0.0)

    def _chunk_plan(self) -> Optional[tuple[list[Slot], int, bool]]:
        """(active_slots, K, mixed) when the on-device multi-step loop
        applies: every generating slot is device-eligible and all share one
        penalty config.  Sampling configs (temp/top_k/top_p/min_p) may
        differ: the loop then runs with per-slot arrays (mixed=True),
        provided every sampled slot has top_k > 0 (the candidate window is
        the max top_k, so per-slot masking stays exact)."""
        if self.chunk_steps <= 1:
            return None
        # a non-empty queue does NOT block chunking: _assign_requests just
        # ran, so queued requests mean every slot is busy
        active = [s for s in self.slots if s.state == SlotState.GENERATING]
        if not active or any(s.state == SlotState.PROMPT for s in self.slots):
            return None
        if any(s.request.n_probs > 0 for s in active):
            return None  # logprob capture needs the per-token host path
        K = self.chunk_steps
        skey0 = pen0 = None
        mixed = False
        for s in active:
            p = s.request.params
            if not self._device_maskable(p):
                return None
            if p.grammar is not None:
                # optimistic grammar chunking: decode the chunk
                # unconstrained, host-validate the tokens, roll the slot
                # back at the first grammar rejection; the per-slot chunk
                # size adapts
                K = min(K, max(1, getattr(s, "_gk", 2)))
            pen = (p.penalty_last_n, p.penalty_repeat, p.penalty_freq,
                   p.penalty_present)
            # seed is part of the per-slot config: differing seeds route
            # through the spv path so each request samples from its OWN
            # stream (reproducible regardless of batch composition)
            skey = (p.temp, p.top_k, p.top_p, p.min_p,
                    p.seed if p.temp > 0.0 else 0)
            if pen0 is None:
                pen0, skey0 = pen, skey
            elif pen != pen0:
                return None  # mixed penalty configs: per-token host sampling
            elif skey != skey0:
                mixed = True
            K = min(K,
                    s.request.n_predict - len(s.request.output_tokens),
                    self.slot_ctx - s.n_past - 1)
        if mixed and any(s.request.params.temp > 0.0
                         and s.request.params.top_k <= 0 for s in active):
            return None
        return (active, K, mixed) if K > 1 else None

    def _spv(self, ps: list) -> dict:
        """Per-slot sampling arrays (numpy) for the spv path."""
        V = self.ctx.cfg.vocab_size
        return {
            "temp": np.asarray([max(q.temp, 0.0) for q in ps], np.float32),
            "top_k": np.asarray([min(q.top_k, V) for q in ps], np.int64),
            "top_p": np.asarray([q.top_p for q in ps], np.float32),
            "min_p": np.asarray([q.min_p for q in ps], np.float32),
            "seed": np.asarray([q.seed & 0x7FFFFFFF for q in ps], np.int64),
        }

    def _chunked_decode(self, active: list[Slot], K: int,
                        mixed: bool = False) -> bool:
        """Run K decode steps for all active slots in one on-device loop
        (generate_loop); bookkeeping mirrors K per-token steps, so
        stop-string/eos/n_predict semantics are unchanged (tokens past a
        mid-chunk stop stay in the cache and the slot history, exactly like
        cached speculative overshoot)."""
        from llama_kotlin_tpu_torch.runtime.generate import SampleParams, generate_loop

        B = len(active)
        ctx = self.ctx
        dev = ctx.device
        slots_flat = ctx.meta.find_slots(K * B)
        if slots_flat is None:
            self._handle_cache_full()
            return True
        pos = np.array([s.n_past + k for k in range(K) for s in active], np.int32)
        seqs = np.array([s.seq_id for _ in range(K) for s in active], np.int32)
        ctx.meta.commit(slots_flat, pos, seqs)

        p = active[0].request.params
        # the host SamplerChain in this engine runs with nl_id=-1 (no
        # newline special-casing); the device sampler matches
        nl_tok = -1
        V = ctx.cfg.vocab_size
        pen_n = p.penalty_last_n if (p.penalty_repeat != 1.0 or p.penalty_freq != 0.0
                                     or p.penalty_present != 0.0) else 0
        spv = None
        if mixed:
            # window = max top_k over sampled slots (clamped to the vocab,
            # as the host chain clamps); per-slot arrays mask inside it
            # (greedy slots take argmax regardless), per-slot seeds keep
            # each request reproducible from its own seed
            ps = [s.request.params for s in active]
            w_cap = min(max([q.top_k for q in ps if q.temp > 0.0] or [1]), V)
            sp = SampleParams(
                temp=1.0, top_k=w_cap, seed=0, penalty_last_n=pen_n,
                penalty_repeat=p.penalty_repeat, penalty_freq=p.penalty_freq,
                penalty_present=p.penalty_present, nl_token=nl_tok)
            spv = {k: torch.from_numpy(v).to(dev) for k, v in self._spv(ps).items()}
        else:
            # identical configs incl. seed: scalar params; the seed is
            # passed to the loop apart (sp.seed stays 0, as in JAX)
            sp = SampleParams(
                temp=max(p.temp, 0.0), top_k=min(p.top_k, V), top_p=p.top_p,
                min_p=p.min_p, seed=0, penalty_last_n=pen_n,
                penalty_repeat=p.penalty_repeat, penalty_freq=p.penalty_freq,
                penalty_present=p.penalty_present, nl_token=nl_tok,
            ) if p.temp > 0.0 or pen_n else SampleParams()
        pen_window = None
        if sp.use_penalties:
            Ln = sp.penalty_last_n
            pw = np.full((B, Ln), -1, np.int64)
            for b, s in enumerate(active):
                hist = s.tokens[-Ln:]
                # ring eviction starts at column 0: empty (-1) columns are
                # consumed first, then the oldest real token, so history
                # goes at the END, oldest first
                pw[b, Ln - len(hist):] = hist
            pen_window = torch.from_numpy(pw).to(dev)

        col = lambda vals: torch.tensor(vals, dtype=torch.int32, device=dev)  # noqa: E731
        out_tokens, _ = generate_loop(
            ctx.params, ctx.cfg, ctx.cache,
            *ctx.meta.device_view(ctx.n_vis_for_span(), dev),
            col([s.tokens[-1] for s in active]), col([s.n_past for s in active]),
            col([s.seq_id for s in active]),
            torch.from_numpy(slots_flat.reshape(K, B)).to(dev),
            K, sp, pen_window=pen_window, spv=spv, seed=p.seed & 0x7FFFFFFF)
        out = out_tokens.cpu().numpy()  # [K, B]
        self.n_chunked += 1
        eos = getattr(getattr(self.tokenizer, "vocab", None), "eos_id", -1)
        rejected: set[int] = set()
        for k in range(K):
            for b, slot in enumerate(active):
                if slot.id in rejected:
                    continue
                tok = int(out[k, b])
                slot.n_past += 1
                slot.tokens.append(tok)
                if slot.request is None:
                    continue  # finished mid-chunk; overshoot tokens stay cached
                g = slot.sampler.grammar
                if g is not None and not g.token_allowed(
                        tok, self.tokenizer, eos_id=eos):
                    # optimistic-chunk rejection: restore the exact
                    # per-token state after the last ACCEPTED output (k
                    # tokens): drop this step's bookkeeping and every
                    # cache cell from the next input position on; the next
                    # per-token step re-decodes the last accepted token and
                    # resamples under the grammar mask
                    slot.tokens.pop()
                    slot.n_past -= 1
                    ctx.seq_rm(slot.seq_id, slot.n_past, -1)
                    # shrink optimism to the largest power of two that held
                    slot._gk = 1 << max(0, (k).bit_length() - 1) if k else 1
                    rejected.add(slot.id)
                    continue
                slot.sampler.accept(tok, tokenizer=self.tokenizer)
                self.metrics["tokens_predicted"] += 1
                self._emit(slot, tok)
        for slot in active:
            if (slot.request is not None and slot.sampler is not None
                    and slot.sampler.grammar is not None
                    and slot.id not in rejected):
                # clean chunk: grow the optimistic window
                slot._gk = min(self.chunk_steps,
                               max(2, getattr(slot, "_gk", 2) * 2))
        self.metrics["n_decode_steps"] += 1
        return True

    def run_loop(self, stop_event: threading.Event) -> None:
        """Step until stop_event is set.  On a CUDA context the thread's
        current device becomes the context's (cuda_index) first.  An exception ends the
        loop: it is kept in ``failure``, every queued and active request is
        released with it (``error`` set, ``done`` set), and it propagates.
        Calls still waiting when the loop ends are released with an error."""
        with self.lock:
            self.running = True
        try:
            if self.cuda_index is not None:
                torch.cuda.set_device(self.cuda_index)
            while not stop_event.is_set():
                if not self.step():
                    time.sleep(0.002)
        except BaseException as e:  # noqa: BLE001 (kept, released, re-raised)
            self.failure = e
            self._release_all(repr(e))
            raise
        finally:
            with self.lock:
                self.running, self.ended = False, True
                tasks, self.tasks = self.tasks, []
            for _, box, ev in tasks:
                box["error"] = RuntimeError("the engine loop stopped before the call ran")
                ev.set()

    def _release_all(self, error: str) -> None:
        with self.lock:
            reqs = self.queue + [s.request for s in self.slots if s.request is not None]
            self.queue = []
        for req in reqs:
            req.error = error
            if req.stream:
                req.stream(-1, "", True)
            req.done.set()

    def slots_info(self) -> list[dict]:
        return [
            {
                "id": s.id,
                "state": s.state.name,
                "n_past": s.n_past,
                "request": s.request.id if s.request else None,
            }
            for s in self.slots
        ]

    # -- internals -----------------------------------------------------------

    def _assign_requests(self) -> None:
        for slot in self.slots:
            if slot.state != SlotState.IDLE or not self.queue:
                continue
            req = self.queue.pop(0)
            prompt = self.system_tokens + list(map(int, req.prompt_tokens))
            if len(prompt) >= self.slot_ctx:
                # keep the tail (cf. server truncating long prompts); clamp
                # n_keep so the tail length stays positive.  The system
                # prefix always survives truncation
                keep = min(max(req.n_keep, len(self.system_tokens)),
                           self.slot_ctx - 5)
                tail = prompt[-(self.slot_ctx - keep - 4):]
                prompt = prompt[:keep] + tail
            # prompt-cache reuse: longest common prefix with what this
            # slot's sequence still holds (server.cpp common_part)
            common = 0
            if slot.tokens:
                limit = min(len(slot.tokens), len(prompt) - 1, slot.n_past)
                while common < limit and slot.tokens[common] == prompt[common]:
                    common += 1
            if common > 0:
                self.ctx.seq_rm(slot.seq_id, common, -1)
            else:
                self.ctx.seq_rm(slot.seq_id, 0, -1)
            slot.request = req
            slot.tokens = prompt
            slot.n_past = common
            slot.n_prompt = len(prompt)
            slot.state = SlotState.PROMPT
            slot.sampler = SamplerChain(req.params, self.ctx.cfg.vocab_size)
            for t in prompt[:common]:
                slot.sampler.accept(t, apply_grammar=False)

    def _build_batch(self) -> Optional[Batch]:
        tokens, pos, seqs, outs = [], [], [], []
        budget = self.n_batch
        for slot in self.slots:
            if slot.state == SlotState.PROMPT and budget > 0:
                chunk = slot.tokens[slot.n_past : slot.n_past + budget]
                for i, t in enumerate(chunk):
                    is_last = slot.n_past + i == slot.n_prompt - 1
                    tokens.append(t)
                    pos.append(slot.n_past + i)
                    seqs.append(slot.seq_id)
                    outs.append(is_last)
                budget -= len(chunk)
                slot._batch_n = len(chunk)  # type: ignore[attr-defined]
            elif slot.state == SlotState.GENERATING:
                t = slot.tokens[-1]
                tokens.append(t)
                pos.append(slot.n_past)
                seqs.append(slot.seq_id)
                outs.append(True)
                slot._batch_n = 1  # type: ignore[attr-defined]
            else:
                slot._batch_n = 0  # type: ignore[attr-defined]
        if not tokens:
            return None
        return Batch(np.array(tokens, np.int32), np.array(pos, np.int32),
                     np.array(seqs, np.int32), np.array(outs, bool))

    def _consume_results(self, batch: Batch) -> None:
        rows = self.ctx._logits_rows if batch.output.any() else None
        row_of = {int(r): i for i, r in enumerate(rows)} if rows is not None else {}
        row = 0
        emits: list[tuple[Slot, int]] = []  # (slot, logits row index)
        for slot in self.slots:
            n = getattr(slot, "_batch_n", 0)
            if n == 0:
                continue
            first = row
            row += n
            if slot.state == SlotState.PROMPT:
                slot.n_past += n
                self.metrics["prompt_tokens_processed"] += n
                if slot.n_past < slot.n_prompt:
                    continue
                slot.state = SlotState.GENERATING
            else:  # GENERATING: its one token entered the cache
                slot.n_past += 1
            # the slot's output row is its last token in this batch
            out_row = first + n - 1
            if out_row not in row_of:
                continue
            emits.append((slot, row_of[out_row]))
        if not emits:
            return
        toks = self._sample_rows_masked_device(emits)
        if toks is not None:
            for (slot, _), tok in zip(emits, toks):
                tok = int(tok)
                slot.sampler.accept(tok, tokenizer=self.tokenizer)
                slot.tokens.append(tok)
                if slot.sampler.grammar is not None:
                    # grammar token landed: regrow the optimistic chunk
                    slot._gk = min(self.chunk_steps,
                                   max(2, getattr(slot, "_gk", 1) * 2))
                self.metrics["tokens_predicted"] += 1
                self._emit(slot, tok)
            return
        logits = self.ctx.get_logits()
        for slot, li in emits:
            tok = self._sample(slot, logits[li])
            self._emit(slot, tok)

    def _sample_rows_masked_device(self, emits) -> Optional[np.ndarray]:
        """Constrained-decode fast path: when EVERY sampled slot this step
        is device-reproducible (modulo grammar) and at least one carries a
        grammar, sample ON THE DEVICE with the host grammar masks uploaded
        as vocab/8-byte bitsets: only the token ids come back, instead of
        the [n, vocab] f32 logits the host chain needs.  Returns None to
        take the host path."""
        sls = [s for s, _ in emits]
        if not any(s.sampler is not None and s.sampler.grammar is not None
                   for s in sls):
            return None  # no grammar in the batch: keep the host RNG path
        ps = [s.request.params for s in sls]
        if any(s.sampler is None or s.request.n_probs > 0 for s in sls) \
                or not all(self._device_maskable(p) for p in ps):
            return None
        pen0 = (ps[0].penalty_last_n, ps[0].penalty_repeat, ps[0].penalty_freq,
                ps[0].penalty_present)
        if any((p.penalty_last_n, p.penalty_repeat, p.penalty_freq,
                p.penalty_present) != pen0 for p in ps):
            return None  # mixed penalty configs: scalar sp can't express
        from llama_kotlin_tpu_torch.runtime.generate import SampleParams

        V = self.ctx.cfg.vocab_size
        p0 = ps[0]
        pen_on = p0.penalty_last_n > 0 and (
            p0.penalty_repeat != 1.0 or p0.penalty_freq != 0.0
            or p0.penalty_present != 0.0)
        w_cap = min(max([q.top_k for q in ps if q.temp > 0.0] or [1]), V)
        sp = SampleParams(
            temp=1.0, top_k=w_cap, seed=0,
            penalty_last_n=p0.penalty_last_n if pen_on else 0,
            penalty_repeat=p0.penalty_repeat, penalty_freq=p0.penalty_freq,
            penalty_present=p0.penalty_present, nl_token=-1)
        masks = np.ones((len(sls), V), bool)
        eos = getattr(getattr(self.tokenizer, "vocab", None), "eos_id", -1)
        for i, s in enumerate(sls):
            if s.sampler.grammar is not None:
                # memo-warm from the overlap precompute (step()); falls
                # through to the pushdown sweep on a cold state
                masks[i] = s.sampler.grammar.allowed_mask(
                    self.tokenizer, V, eos_id=eos)[:V]
        pen_window = None
        if sp.use_penalties:
            Ln = sp.penalty_last_n
            pen_window = np.full((len(sls), Ln), -1, np.int32)
            for i, s in enumerate(sls):
                hist = s.tokens[-Ln:]
                pen_window[i, Ln - len(hist):] = hist
        # sampling position of the token that produced these logits
        pos = [s.n_past - 1 for s in sls]
        return self.ctx.sample_rows_device(
            [li for _, li in emits], sp, self._spv(ps), pos, masks=masks,
            pen_window=pen_window)

    def _sample(self, slot: Slot, logits: np.ndarray) -> int:
        tok = slot.sampler.sample(logits, tokenizer=self.tokenizer)
        slot.sampler.accept(tok, tokenizer=self.tokenizer)
        slot.tokens.append(tok)
        if slot.sampler.grammar is not None:
            slot._gk = min(self.chunk_steps,
                           max(2, getattr(slot, "_gk", 1) * 2))
        self.metrics["tokens_predicted"] += 1
        req = slot.request
        if req is not None and req.n_probs > 0:
            # per-token top-N logprobs from the raw (pre-sampler) f32
            # distribution (server.cpp:931, completion_token_output :159);
            # raw rather than post-chain probabilities so greedy requests
            # still get finite values (OpenAI logprobs semantics)
            lf = logits.astype(np.float64)
            lse = np.logaddexp.reduce(lf)
            lp = lf - lse
            top_ids = np.argpartition(-lp, min(req.n_probs, lp.size - 1))[: req.n_probs]
            top_ids = top_ids[np.argsort(-lp[top_ids])]
            req.probs_output.append({
                "tok": tok,
                "logprob": float(lp[tok]),
                "top": [(int(i), float(lp[i])) for i in top_ids],
            })
        return tok

    def _emit(self, slot: Slot, tok: int) -> None:
        req = slot.request
        if req.t_first_token == 0.0:
            req.t_first_token = time.time()
        req.output_tokens.append(tok)
        piece = self.tokenizer.decode([tok], skip_special=False)
        eos = self._is_eos(tok)
        if not eos:
            req.output_text += piece
        stopped = None
        for s in req.stop_strings:
            idx = req.output_text.find(s)
            if idx >= 0:
                req.output_text = req.output_text[:idx]
                stopped = s
                break
        n_gen = len(req.output_tokens)
        if (not eos and stopped is None and n_gen < req.n_predict
                and slot.n_past >= self.slot_ctx - 1):
            # slot context full mid-generation: shift (keep n_keep, drop
            # half) and keep going, like the reference server
            # (server.cpp:1947): 'length' only means n_predict reached
            self._shift_slot(slot)
        done = eos or stopped is not None or n_gen >= req.n_predict
        if req.stream:
            # withhold text that could still be a prefix of a stop string so
            # clients never see content that is later trimmed
            if done:
                safe_len = len(req.output_text)
            else:
                safe_len = len(req.output_text) - _stop_holdback(
                    req.output_text, req.stop_strings)
            delta = ""
            if safe_len > req.streamed_len:
                delta = req.output_text[req.streamed_len:safe_len]
                req.streamed_len = safe_len
            req.stream(tok, delta, done)
        if done:
            req.stop_reason = ("eos" if eos else "stop" if stopped else "length")
            req.t_done = time.time()
            self.metrics["requests_processed"] += 1
            req.done.set()
            slot.state = SlotState.IDLE
            slot.request = None
            slot.sampler = None

    def _is_eos(self, tok: int) -> bool:
        v = getattr(self.tokenizer, "vocab", None)
        return v is not None and tok == v.eos_id

    def _shift_slot(self, slot: Slot) -> None:
        """Context-shift one slot: keep n_keep, discard half the rest
        (server.cpp:1947); the cached K rows rotate (apply_k_shift)."""
        n_keep = max(slot.request.n_keep, len(self.system_tokens))
        n_discard = max(1, (slot.n_past - n_keep) // 2)
        self.ctx.seq_rm(slot.seq_id, n_keep, n_keep + n_discard)
        self.ctx.seq_add(slot.seq_id, n_keep + n_discard, -1, -n_discard)
        slot.n_past -= n_discard
        del slot.tokens[n_keep : n_keep + n_discard]

    def _handle_cache_full(self) -> None:
        """Shift contexts of generating slots (server.cpp:1947)."""
        for slot in self.slots:
            if slot.state != SlotState.GENERATING or slot.request is None:
                continue
            self._shift_slot(slot)
