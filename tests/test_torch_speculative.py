"""Port parity for speculative, lookup and lookahead decoding
(``runtime/speculative.py``, ``runtime/lookahead.py``).

Every case of tests/test_speculative.py, on the tiny Q8_0 model of
tests/test_torch_engine.py (and a second one from another seed as the bad
draft), loaded by both packages in the exact-dequant mode: each port
function gives plain greedy decoding's tokens (the invariant of all of
them) and the tokens and ``SpecStats`` of the same JAX function on the
same file; the device loop gives the host loop's tokens and stats.

Both packages' logits differ by up to about 7e-3 of max|logits| on this
model (tests/test_torch_engine.py: XLA's CPU compiler keeps excess
precision across the JAX program's bf16 roundings; the JAX program run op
by op gives the port's logits), and a random model's top-2 gap is
sometimes narrower: there the two greedy choices may part.  ``compare``
therefore holds two token lists equal, or parting only where the
reference's top-2 gap, teacher-forced, is within twice LOGIT_TOL (a
near-tie); after a parting both sides resume from the prompt plus the
reference's tokens through the parting, so every position is compared,
and the statistics of every run that does not part.  Each test states
how many partings it has.  Within the port the same holds between a
method and plain greedy decoding, whose ubatches have other row counts.
"""

from __future__ import annotations

import numpy as np
import pytest

from llama_kotlin_tpu.runtime import lookahead as jax_la
from llama_kotlin_tpu.runtime import speculative as jax_spec
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.runtime import lookahead as la
from llama_kotlin_tpu_torch.runtime import speculative as spec
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from test_torch_cli import one_thread  # noqa: F401 (autouse fixture)
from test_torch_engine import LOGIT_TOL, load_both, write_model

N_CELLS = 128
# partings (port vs JAX) of the two cases that have any, each at a near-tie
PARTS_PLAIN = 2
PARTS_LOOKAHEAD = (0, 2)


@pytest.fixture(scope="module")
def ctxs(tmp_path_factory):
    """Target, a second context of the same model (the self-draft) and a
    model from another seed (the bad draft): a JAX and a port context of
    each, reused by the tests (every function clears its contexts)."""
    d = tmp_path_factory.mktemp("spec")
    out = {}
    for name, seed in (("target", 41), ("bad", 99)):
        jcfg, jp, cfg, pp = load_both(write_model(d / f"{name}.gguf", seed=seed))
        out[name] = (JaxContext(jcfg, jp, n_cells=N_CELLS),
                     LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu"))
        if name == "target":
            out["self"] = (JaxContext(jcfg, jp, n_cells=N_CELLS),
                           LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu"))
    return out


def _plain_greedy(ctx, batch_cls, prompt, n):
    ctx.clear()
    ctx.decode(batch_cls.single(np.asarray(prompt, np.int32)))
    out = [int(np.argmax(ctx.get_logits()[0]))]
    pos = len(prompt)
    while len(out) < n:
        ctx.decode(batch_cls(tokens=[out[-1]], pos=[pos], seq_id=[0], output=[True]))
        out.append(int(np.argmax(ctx.get_logits()[0])))
        pos += 1
    return out


def near_tie(ctx, batch_cls, prompt, prefix, what) -> None:
    """ctx's top-2 gap after prompt + prefix (one token a decode) is within
    2 * LOGIT_TOL of max|logits|."""
    ctx.clear()
    ctx.decode(batch_cls.single(np.asarray(prompt, np.int32)))
    for i, t in enumerate(prefix):
        ctx.decode(batch_cls(tokens=[t], pos=[len(prompt) + i], seq_id=[0], output=[True]))
    lg = np.asarray(ctx.get_logits()[-1], np.float32)
    top2 = np.sort(lg)[-2:]
    assert top2[1] - top2[0] <= 2 * LOGIT_TOL * np.abs(lg).max(), what


def compare(run, ref_run, ctx, batch_cls, prompt, n, stats=True) -> int:
    """run(prompt, n) and ref_run(prompt, n) give (tokens, stats).  Equal
    tokens, and equal stats when `stats`; a parting only at a near-tie of
    ctx's logits along the common prefix, after which both resume from the
    prompt plus ref's tokens through the parting.  Returns the number of
    partings."""
    parts, prompt = 0, list(prompt)
    while n > 0:
        out, st = run(prompt, n)
        ref, rst = ref_run(prompt, n)
        d = next((i for i, (a, b) in enumerate(zip(out, ref)) if a != b), None)
        if d is None:
            assert len(out) == len(ref) == n
            if stats:
                assert _stats(st) == _stats(rst)
            return parts
        near_tie(ctx, batch_cls, prompt, ref[:d], (prompt, d, out, ref))
        parts += 1
        prompt += [int(t) for t in ref[:d + 1]]
        n -= d + 1
    return parts


def _both(ctxs, fn_name, prompt, n, *args, draft="self", module=(spec, jax_spec),
          parts=(0, 0), **kw):
    """(port tokens, port stats) of fn_name on freshly cleared contexts,
    compared with the port's plain greedy decoding and with JAX's fn_name
    (tokens and stats); `parts` is the number of partings from each."""
    port_mod, jax_mod = module
    jt, pt = ctxs["target"]
    jd, pd = ctxs[draft] if draft else (None, None)
    pargs = (pt, pd) if draft else (pt,)
    jargs = (jt, jd) if draft else (jt,)

    def runner(mod, cs):
        def run(p, k):
            for c in cs:
                c.clear()
            return getattr(mod, fn_name)(*cs, p, k, *args, **kw)
        return run

    memo: dict = {}

    def port(p, k):  # the port's runs, each made once
        key = (tuple(p), k)
        if key not in memo:
            memo[key] = runner(port_mod, pargs)(p, k)
        return memo[key]

    greedy = compare(port, lambda p, k: (_plain_greedy(pt, Batch, p, k), None), pt, Batch,
                     prompt, n, stats=False)
    with_jax = compare(port, runner(jax_mod, jargs), jt, JaxBatch, prompt, n)
    assert (greedy, with_jax) == parts
    return port(prompt, n)


def _stats(st):
    return st if isinstance(st, dict) else (st.n_drafted, st.n_accepted, st.n_target_calls)


def test_plain_greedy_matches_jax(ctxs):
    """The reference every case below is held to: the port's per-token
    greedy decode gives JAX's at every position, up to the partings
    counted."""
    jt, pt = ctxs["target"]
    for prompt, parts in (([3, 17, 42, 9], 0), ([5, 9, 5, 9, 5, 9], PARTS_PLAIN)):
        assert compare(lambda p, k: (_plain_greedy(pt, Batch, p, k), None),
                       lambda p, k: (_plain_greedy(jt, JaxBatch, p, k), None),
                       jt, JaxBatch, prompt, 24, stats=False) == parts


def test_speculative_same_model_all_accepted(ctxs):
    """Draft == target: the output is plain greedy's and JAX's, with JAX's
    stats; acceptance is high and the target runs fewer times than the
    tokens."""
    out, st = _both(ctxs, "speculative_generate", [3, 17, 42, 9], 12, n_draft=4)
    assert st.accept_rate > 0.6 and st.n_target_calls < 12


def test_speculative_output_matches_greedy_even_with_bad_draft(ctxs):
    """A draft from another seed does not change the output."""
    _both(ctxs, "speculative_generate", [5, 9, 3], 10, draft="bad", n_draft=3)


def test_ngram_cache():
    """JAX's case, and the same drafts as JAX's NgramCache on a longer
    history."""
    c = spec.NgramCache(n_min=2, n_max=3)
    c.update([1, 2, 3, 1, 2, 3, 1, 2])
    assert c.draft([9, 1, 2], 2) == [3, 1]
    assert c.draft([7, 8], 3)[:0] == []
    hist = list(np.random.default_rng(3).integers(0, 6, 200))
    ours, ref = spec.NgramCache(), jax_spec.NgramCache()
    for m in (ours, ref):
        m.update(hist[:120])
        m.update_tail(hist, 80)
    assert ours.table == ref.table
    for i in range(0, 200, 17):
        assert ours.draft(hist[:i], 5) == ref.draft(hist[:i], 5)


def test_lookup_generate_matches_greedy(ctxs):
    _both(ctxs, "lookup_generate", [4, 8, 15, 16, 23, 42, 4, 8, 15], 10, draft=None,
          n_draft=3)


def test_lookahead_matches_greedy(ctxs):
    """Lookahead decoding is lossless: plain greedy's tokens, and JAX's
    tokens and stats."""
    out, st = _both(ctxs, "lookahead_generate", [3, 17, 42, 9], 14, draft=None,
                    module=(la, jax_la), W=4, N=3, G=4)
    assert st["n_decodes"] >= 1


def test_lookahead_accepts_repetition(ctxs):
    """On a prompt that induces loops the n-gram pool is used, and the
    output is still plain greedy's and JAX's."""
    out, st = _both(ctxs, "lookahead_generate", [5, 9, 5, 9, 5, 9], 24, draft=None,
                    module=(la, jax_la), parts=PARTS_LOOKAHEAD, W=4, N=3, G=4)
    assert st["n_accept"] > 0


def test_tree_speculative_matches_greedy(ctxs):
    """Tree drafts (p_split forking: branches share cells through sequence
    bitmasks) are lossless; JAX's tokens and stats; high acceptance with
    the self-draft."""
    out, st = _both(ctxs, "speculative_generate_tree", [3, 17, 42, 9], 14, n_draft=4,
                    n_branches=3, p_split=1.0)
    assert st.n_drafted > 0 and st.accept_rate > 0.4


def test_tree_speculative_single_branch_degenerates_to_chain(ctxs):
    _both(ctxs, "speculative_generate_tree", [5, 9, 3, 88], 10, n_draft=4, n_branches=1,
          p_split=0.0)


@pytest.mark.parametrize("draft", ["self", "bad"])
def test_speculative_device_loop_matches_host(ctxs, draft):
    """speculative_generate_device (K one-row draft forwards, a K+1-row
    verify, acceptance and rollback on the device; one flag read a round)
    gives the host loop's tokens and stats, and JAX's device loop's."""
    prompt = [3, 17, 42, 9]
    out_h, st_h = _both(ctxs, "speculative_generate", prompt, 24, draft=draft, n_draft=4)
    out_d, st_d = _both(ctxs, "speculative_generate_device", prompt, 24, draft=draft,
                        n_draft=4)
    assert out_d == out_h and _stats(st_d) == _stats(st_h)


def test_speculative_device_loop_falls_back_when_cells_run_out(ctxs):
    """When the cell grids for n_predict rounds do not fit, the host loop
    runs instead (JAX's rule): its tokens and stats."""
    prompt = [3, 17, 42, 9]
    out, st = _both(ctxs, "speculative_generate_device", prompt, 40, n_draft=4)
    h, sth = _both(ctxs, "speculative_generate", prompt, 40, n_draft=4)
    assert out == h and _stats(st) == _stats(sth)
