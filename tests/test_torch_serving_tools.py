"""The port's serving tools against JAX's, on the CPU: ``parallel_sim``,
``batched_bench``, ``passkey``, ``infill``, ``gbnf_validator`` and the
``lookahead`` CLI.

The model is tests/test_torch_engine.py's tiny Q8_0 one, written with an
SPM vocab that has the infill specials (tests/fixtures.py::spm_vocab_kvs,
written by the port's writer).  Greedy outputs are compared with JAX's
where the tool's output is deterministic (passkey's answer, infill's
text, the lookahead CLI's text, the validator's verdicts); timing tools
are compared by their fields.
"""

from __future__ import annotations

import io
import json
import threading
from contextlib import redirect_stderr, redirect_stdout

import pytest

from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext
from llama_kotlin_tpu.runtime.engine import Engine as JaxEngine
from llama_kotlin_tpu.tokenizer import build_tokenizer as jax_build
from llama_kotlin_tpu.tools import batched_bench as jax_bb
from llama_kotlin_tpu.tools import gbnf_validator as jax_gv
from llama_kotlin_tpu.tools import infill as jax_infill
from llama_kotlin_tpu.tools import lookahead as jax_la_cli
from llama_kotlin_tpu.tools import parallel_sim as jax_ps
from llama_kotlin_tpu.tools import passkey as jax_pk
from llama_kotlin_tpu.gguf import GGUFFile as JaxGGUF

from llama_kotlin_tpu_torch.gguf.reader import GGUFFile
from llama_kotlin_tpu_torch.models.synthetic import synthetic_gguf
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType as Q
from llama_kotlin_tpu_torch.runtime.context import LlamaContext
from llama_kotlin_tpu_torch.runtime.engine import Engine
from llama_kotlin_tpu_torch.tokenizer import build_tokenizer
from llama_kotlin_tpu_torch.tools import (batched_bench, gbnf_validator, infill, lookahead,
                                          parallel_sim, passkey, server_ui)

from fixtures import spm_vocab_kvs
from test_torch_cli import one_thread  # noqa: F401 (autouse fixture)
from test_torch_engine import CFG, load_both


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = tmp_path_factory.mktemp("tools") / "m.gguf"
    synthetic_gguf(path, CFG, seed=43, matrix_type=Q.Q8_0, output_type=Q.F32,
                   extra_kvs=spm_vocab_kvs(CFG.vocab_size, fim=True))
    jcfg, jp, cfg, pp = load_both(path)
    jf, pf = JaxGGUF(path), GGUFFile(path)
    jtok, ptok = jax_build(jf.metadata), build_tokenizer(pf.metadata)
    jf.close()
    pf.close()
    return dict(path=path, jcfg=jcfg, jp=jp, cfg=cfg, pp=pp, jtok=jtok, ptok=ptok)


def _ctxs(model, n_cells=512, **kw):
    return (JaxContext(model["jcfg"], model["jp"], n_cells=n_cells, **kw),
            LlamaContext(model["cfg"], model["pp"], n_cells=n_cells, device="cpu", **kw))


def test_server_ui_is_jaxs_page():
    from llama_kotlin_tpu.tools.server_ui import INDEX_HTML

    assert server_ui.INDEX_HTML == INDEX_HTML


def test_parallel_sim(model):
    """4 clients x 2 sequences on 2 slots (the engine in its own thread):
    every request ends, and the summary has JAX's fields and, greedy,
    JAX's token count."""
    out = {}
    for name, eng_cls, mod, i in (("port", Engine, parallel_sim, 1), ("jax", JaxEngine, jax_ps, 0)):
        ctx = _ctxs(model)[i]
        engine = eng_cls(ctx, model["ptok" if i else "jtok"], n_slots=2)
        stop = threading.Event()
        t = threading.Thread(target=engine.run_loop, args=(stop,), daemon=True)
        t.start()
        try:
            out[name] = mod.run_parallel(engine, model["ptok" if i else "jtok"], 4, 2,
                                         n_predict=6, log=lambda *a: None)
        finally:
            stop.set()
            t.join(timeout=30)
    assert set(out["port"]) == set(out["jax"])
    assert out["port"]["all_ok"] and out["port"]["sequences"] == 8
    assert out["port"]["total_gen_tokens"] == out["jax"]["total_gen_tokens"]


def test_batched_bench(model):
    """The CLI with -o json on the CPU: one row a (pp, tg, pl) combo with
    bench_combo's fields, JAX's; positive speeds."""
    buf = io.StringIO()
    with redirect_stdout(buf), redirect_stderr(io.StringIO()):
        rows = batched_bench.main(["-m", str(model["path"]), "--device", "cpu", "-npp", "16",
                                   "-ntg", "4", "-npl", "1", "2", "-c", "256", "-o", "json"])
    assert json.loads(buf.getvalue()) == rows and len(rows) == 2
    jrow = jax_bb.bench_combo(_ctxs(model, 256, n_seq_max=32)[0], 16, 4, 2)
    for row, pl in zip(rows, (1, 2)):
        assert set(row) == set(jrow)
        assert (row["pp"], row["tg"], row["pl"]) == (16, 4, pl)
        assert row["s_pp"] > 0 and row["s_tg"] > 0


def test_passkey(model):
    """Self-extend group attention (seq_add, seq_div and their K rotations)
    over a junk prompt of several ubatches, then a greedy answer: JAX's
    answer text."""
    kw = dict(n_junk=4, key=42, i_pos=2, ga_n=2, ga_w=128, n_batch=128, n_predict=6,
              log=lambda *a: None)
    jctx, pctx = _ctxs(model, 1024)
    ans = passkey.run_passkey(pctx, model["ptok"], **kw)
    assert ans == jax_pk.run_passkey(jctx, model["jtok"], **kw)
    assert len(ans) > 0


def test_infill(model):
    """The FIM prompt equals JAX's token for token, in both orders; the
    greedy infill text is JAX's."""
    for spm in (False, True):
        ids = infill.infill_tokens(model["ptok"], "ab cd", "yz", spm_fill=spm)
        assert ids == jax_infill.infill_tokens(model["jtok"], "ab cd", "yz", spm_fill=spm)
    assert ids[-1] == model["ptok"].vocab.middle_id
    jctx, pctx = _ctxs(model, 256)
    text = infill.run_infill(pctx, model["ptok"], "ab cd", "yz", 8)
    assert text == jax_infill.run_infill(jctx, model["jtok"], "ab cd", "yz", 8)
    buf = io.StringIO()
    with redirect_stdout(buf):
        infill.main(["-m", str(model["path"]), "--in-prefix", "ab cd", "--in-suffix", "yz",
                     "-n", "8", "-c", "256", "--device", "cpu"])
    assert buf.getvalue() == "ab cd" + text + "yz\n"


@pytest.mark.parametrize("grammar,text", [
    ('root ::= ("ab")+', "ababab"), ('root ::= ("ab")+', "abba"), ('root ::= ("ab")+', "aba"),
    ('root ::= [0-9]+ "." [0-9]*', "3.14"), ('root ::= [0-9]+ "." [0-9]*', "3x14"),
    ('root ::= "{" ws "}"\nws ::= [ \\t\\n]*', "{  }"),
])
def test_gbnf_validator(grammar, text, tmp_path, capsys):
    """validate() and the CLI give JAX's verdict, error position and text."""
    assert gbnf_validator.validate(grammar, text) == jax_gv.validate(grammar, text)
    g, t = tmp_path / "g.gbnf", tmp_path / "in.txt"
    g.write_text(grammar)
    t.write_text(text)
    rcs, outs = [], []
    for mod in (gbnf_validator, jax_gv):
        rcs.append(mod.main([str(g), str(t)]))
        outs.append(capsys.readouterr().out)
    assert rcs[0] == rcs[1] and outs[0] == outs[1]


def test_lookahead_cli(model, capsys):
    """The lookahead CLI prints JAX's text (greedy, lossless) and its
    n-gram statistics."""
    argv = ["-m", str(model["path"]), "-p", "ab cd ef", "-n", "10", "-c", "256",
            "-W", "4", "-N", "3", "-G", "4"]
    outs = []
    for fn, extra in ((lookahead.main, ["--device", "cpu"]), (jax_la_cli.main, [])):
        fn(argv + extra)
        cap = capsys.readouterr()
        outs.append((cap.out, cap.err.split(" (")[0]))
    assert outs[0] == outs[1] and outs[0][0].startswith("ab cd ef")
