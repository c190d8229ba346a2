"""The text path as a whole, on the CPU: a tiny Q4_K GGUF with an SPM vocab
and a Llama-2 chat template, written by the port's writer from a seed.

- Teacher-forced against the JAX package: the chat-formatted prompt text
  goes through both tokenizers (equal ids) into both contexts (``w4``,
  fused); at each step both sampler chains take JAX's logits (equal ids),
  both contexts decode the drawn token, and the port's logits stay within
  4e-2 of max|logits| of JAX's (tests/test_torch_loader.py's tolerance);
  the decoded texts are equal.
- The port's CLIs end to end with ``--device cpu``: ``tools/main.py``
  repeats itself at a seed, keeps a JSON-schema grammar, restores a prompt
  cache, and chats on stdin; ``tools/simple.py`` gives generate()'s greedy
  ids; without CUDA and without ``--device cpu`` they raise.
"""

from __future__ import annotations

import io
import json
import shutil
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from llama_kotlin_tpu.gguf import GGUFFile as JaxGGUF
from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.chat import apply_chat_template as jax_apply
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext
from llama_kotlin_tpu.sampling.samplers import SamplerChain as JaxChain
from llama_kotlin_tpu.sampling.samplers import SamplingParams as JaxSP
from llama_kotlin_tpu.tokenizer import build_tokenizer as jax_build

from llama_kotlin_tpu_torch.gguf.reader import GGUFFile
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.models.synthetic import synthetic_gguf, synthetic_spm_vocab
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.chat import apply_chat_template, resolve_template
from llama_kotlin_tpu_torch.runtime.context import LlamaContext
from llama_kotlin_tpu_torch.runtime.generate import generate
from llama_kotlin_tpu_torch.sampling.grammar import GrammarSampler
from llama_kotlin_tpu_torch.sampling.json_schema import json_schema_to_gbnf
from llama_kotlin_tpu_torch.sampling.samplers import SamplerChain, SamplingParams
from llama_kotlin_tpu_torch.tokenizer import build_tokenizer
from llama_kotlin_tpu_torch.tools import main as cli
from llama_kotlin_tpu_torch.tools import simple

CFG = ModelConfig(arch="llama", name="tiny-cli", vocab_size=512, n_embd=512, n_layer=2,
                  n_head=4, n_head_kv=2, n_ff=1024, n_ctx_train=4096)
LOGIT_TOL = 4e-2
N_STEPS = 16
SCHEMA = json.dumps({"type": "object", "properties": {"n": {"type": "integer"}},
                     "required": ["n"]})
PROMPT = "the quick brown fox jumps over the lazy dog"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tests' many small CPU ops: more only
    multiplies their CPU time when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "tiny-cli.gguf"
    synthetic_gguf(path, CFG, seed=21, extra_kvs=synthetic_spm_vocab(CFG.vocab_size))
    return path


def test_slice_teacher_forced_matches_jax(gguf):
    """Text -> both tokenizers -> both contexts -> both chains on JAX's
    logits: equal prompt ids, equal drawn ids at every step, the port's
    logits within LOGIT_TOL of JAX's, equal decoded text."""
    jf, pf = JaxGGUF(gguf), GGUFFile(gguf)
    jtok, ptok = jax_build(jf.metadata), build_tokenizer(pf.metadata)
    tmpl = resolve_template(pf.metadata.get("tokenizer.chat_template"), "llama")
    jf.close()
    pf.close()
    assert tmpl.startswith("{% if messages[0]['role'] == 'system' %}")
    msgs = [{"role": "system", "content": "be brief"}, {"role": "user", "content": PROMPT}]
    text = apply_chat_template(msgs, tmpl)
    assert text == jax_apply(msgs, tmpl) and text.startswith("[INST] <<SYS>>")
    ids = ptok.encode(text, add_special=True, parse_special=True)
    assert ids == jtok.encode(text, add_special=True, parse_special=True) and len(ids) > 30
    jcfg, jp, jfile = jax_load(gguf, fast_mode="w4", fuse=True)
    cfg, pp, pfile = load_gguf_model(gguf, fast_mode="w4", fuse=True, device="cpu")
    jfile.close()
    pfile.close()
    jctx = JaxContext(jcfg, jp, n_cells=256)
    pctx = LlamaContext(cfg, pp, n_cells=256, device="cpu")
    kw = dict(temp=0.8, top_k=40, top_p=0.95, min_p=0.05, penalty_repeat=1.1, seed=42)
    jchain, pchain = JaxChain(JaxSP(**kw), cfg.vocab_size), SamplerChain(SamplingParams(**kw),
                                                                         cfg.vocab_size)
    assert jctx.decode(JaxBatch.single(ids)) == 0 and pctx.decode(Batch.single(ids)) == 0
    out = []
    for i in range(N_STEPS):
        jl, pl = np.asarray(jctx.get_logits()[-1], np.float32), pctx.get_logits()[-1]
        assert np.abs(pl - jl).max() <= LOGIT_TOL * np.abs(jl).max()
        tok = jchain.sample(jl, tokenizer=jtok)
        assert pchain.sample(jl, tokenizer=ptok) == tok
        jchain.accept(tok, tokenizer=jtok)
        pchain.accept(tok, tokenizer=ptok)
        out.append(tok)
        pos = len(ids) + i
        assert jctx.decode(JaxBatch.single([tok], pos0=pos)) == 0
        assert pctx.decode(Batch.single([tok], pos0=pos)) == 0
    assert len(set(out)) > 4
    assert ptok.decode(out) == jtok.decode(out)
    assert ptok.decode(out, skip_special=False) == jtok.decode(out, skip_special=False)


def _main(argv, stdin=None, monkeypatch=None):
    """Run the port's CLI in process; (its stats, its stdout)."""
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    buf = io.StringIO()
    with redirect_stdout(buf):
        stats = cli.main(argv)
    return stats, buf.getvalue()


def _base(gguf, *more):
    return ["-m", str(gguf), "--fast-mode", "w4", "--device", "cpu", "-c", "256", *more]


def test_cli_repeats_at_a_seed(gguf, tmp_path, capsys):
    """Two runs at --seed 42 print the same text and draw the same ids; a
    third at another seed differs; --verbose prints the timings and
    --profile-dir writes a Chrome trace."""
    argv = _base(gguf, "-p", PROMPT, "-n", "12", "--seed", "42", "--temp", "0.8")
    a, out_a = _main(argv)
    b, out_b = _main(argv + ["--verbose", "--profile-dir", str(tmp_path / "trace")])
    assert out_a == out_b and out_a.startswith(PROMPT)
    assert a["runs"][0]["tokens"] == b["runs"][0]["tokens"] and len(a["runs"][0]["tokens"]) == 12
    c, _ = _main(_base(gguf, "-p", PROMPT, "-n", "12", "--seed", "7"))
    assert c["runs"][0]["tokens"] != a["runs"][0]["tokens"]
    err = capsys.readouterr().err
    assert '"eval_tokens": 12' in err and '"prompt_tokens"' in err
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]


def test_cli_json_schema(gguf):
    """--json-schema: every drawn token is accepted in turn by a fresh
    GrammarSampler of the same grammar, and the text is a prefix the
    grammar takes."""
    stats, _ = _main(_base(gguf, "-p", "json:", "-n", "24", "--seed", "3",
                           "--json-schema", SCHEMA))
    toks = stats["runs"][0]["tokens"]
    assert len(toks) >= 3
    f = GGUFFile(gguf)
    tok = build_tokenizer(f.metadata)
    f.close()
    g = GrammarSampler(json_schema_to_gbnf(SCHEMA))
    for t in toks:
        assert t == tok.vocab.eos_id or g.token_allowed(t, tok, eos_id=tok.vocab.eos_id)
        g.accept_token(t, tok, eos_id=tok.vocab.eos_id)
    assert stats["runs"][0]["text"].startswith("{")


def test_cli_prompt_cache(gguf, tmp_path):
    """--prompt-cache: the first run writes the session; two runs restored
    from that same file both report full reuse (all but the last prompt
    token, which is evaluated again for its logits) and give the same text
    and ids.  (The first run's last prompt token is evaluated inside its
    prefill and the restored runs' alone, so their logits may differ in
    the last bits: the first run's text is not held to theirs.)"""
    cache = tmp_path / "prompt.session"
    argv = _base(gguf, "-p", PROMPT, "-n", "10", "--seed", "5", "--prompt-cache", str(cache))
    first, _ = _main(argv)
    assert cache.exists() and "session_reuse" not in first
    n_prompt = first["runs"][0]["prompt_tokens"]
    shutil.copy(cache, tmp_path / "first.session")
    b, out_b = _main(argv)
    shutil.copy(tmp_path / "first.session", cache)
    c, out_c = _main(argv)
    assert b["session_reuse"] == c["session_reuse"] == n_prompt - 1
    assert out_b == out_c and b["runs"][0]["tokens"] == c["runs"][0]["tokens"]


def test_cli_interactive(gguf, monkeypatch):
    """--interactive with two user turns and /exit on stdin: two replies;
    the second prompt carries the first turn (the chat history)."""
    stats, out = _main(_base(gguf, "--interactive", "-n", "6", "--seed", "9"),
                       stdin="hello there\nwhat now\n/exit\n", monkeypatch=monkeypatch)
    runs = stats["runs"]
    assert len(runs) == 2 and all(r["tokens"] for r in runs)
    assert runs[1]["prompt_tokens"] > runs[0]["prompt_tokens"] + 4
    assert out.count("> ") == 3


def test_simple_matches_generate(gguf):
    """tools/simple.py's greedy text equals the decoded ids of generate()
    with the default (greedy) SampleParams on the same (unfused) load."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert simple.main([str(gguf), PROMPT, "12", "--fast-mode", "w4", "--device", "cpu"]) == 0
    cfg, params, f = load_gguf_model(gguf, fast_mode="w4", device="cpu")
    tok = build_tokenizer(f.metadata)
    f.close()
    ids = tok.encode(PROMPT, add_special=True)
    ctx = LlamaContext(cfg, params, n_cells=max(256, len(ids) + 20), device="cpu")
    got = generate(ctx, ids, 12)
    if tok.vocab.eos_id in got:
        got = got[:got.index(tok.vocab.eos_id)]
    assert buf.getvalue() == PROMPT + "".join(tok.decode([t], skip_special=False)
                                              for t in got) + "\n"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-CUDA refusal")
def test_clis_refuse_without_cuda(gguf):
    """Without CUDA and without --device cpu the CLIs raise (no quiet CPU
    run), in a fast mode and in JAX's default (no --fast-mode: the
    exact-dequant mode, which tests/test_torch_exact_mode.py runs on the
    CPU)."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-m", str(gguf), "--fast-mode", "w4", "-p", "x", "-n", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simple.main([str(gguf), "x", "1", "--fast-mode", "w4"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-m", str(gguf), "-p", "x", "-n", "1"])
