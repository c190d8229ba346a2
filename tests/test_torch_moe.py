"""The port's MoE block against the JAX package's: ``ops/moe.py`` (the
router's top-k, the grouped FFN over dense expert stacks, the gathered FFN
over quantized expert stacks) against JAX's ops; the loader's expert policy
(E <= 16 in a fast mode: a per-expert list; else one stacked exact repack;
a float file: dense stacks) against JAX's loader; and the tiny Mixtral of
``tests/fixtures.py`` (llama-architecture MoE) served by both packages'
contexts, prefill then token by token, on every route: the grouped FFN (an
F32 file), the sweep over per-expert W4 folds (Q4_K, E = 4, ``w4``), the
sweep and the gathered FFN over a stacked exact repack (the exact mode; a
stack in ``w4``, E > 16, is deepseek2's case, tests/test_torch_deepseek2.py).
The JAX contexts run on JAX's CPU routes (the same bf16 products as its
kernels, interpret mode only slower) but in ``w4``, where they run in
interpret mode, so that JAX's kernel 1 quantizes the activations to int8
as the port's does (tests/test_torch_deepseek2.py says more)."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.models.loader import load_gguf_model as jax_load
from llama_kotlin_tpu.ops import moe as jax_moe
from llama_kotlin_tpu.quant import qtensor as jax_qt
from llama_kotlin_tpu.quant.formats import GGMLQuantType as JQ
from llama_kotlin_tpu.quant.repack import repack_float
from llama_kotlin_tpu.runtime.batch import Batch as JaxBatch
from llama_kotlin_tpu.runtime.context import LlamaContext as JaxContext

from llama_kotlin_tpu_torch.convert import params_from_numpy, qtensor_from_numpy
from llama_kotlin_tpu_torch.models import llama as llama_model
from llama_kotlin_tpu_torch.models.loader import load_gguf_model
from llama_kotlin_tpu_torch.ops import moe
from llama_kotlin_tpu_torch.quant.qtensor import QTensor
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from tests.fixtures import random_mixtral_weights, tiny_mixtral_dims, write_mixtral_gguf

N_CELLS = 256
N_STEPS = 4  # decode steps after the prefill


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tests' many small CPU ops: more only
    multiplies their CPU time when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def replay_route(router: torch.Tensor, top_i: torch.Tensor, norm_topk: bool, scale: float):
    """moe.route's weights for the given experts top_i [nt, k] in place of
    its own top k (a run that replays JAX's routing)."""
    top_w = torch.softmax(router.to(torch.float32), dim=-1).gather(-1, top_i.to(torch.long))
    if norm_topk:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return (top_w * scale if scale != 1.0 else top_w), top_i


def test_route_matches_jax(rng):
    """route: softmax in f32, the top k, renormalized (Mixtral) or raw
    times the expert scale (deepseek2), as JAX's moe_ffn computes them:
    the same experts and weights within 1e-6."""
    router = rng.standard_normal((5, 16)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(router), axis=-1)
    for norm, scale in ((True, 1.0), (False, 2.0)):
        jw, ji = jax.lax.top_k(probs, 3)
        if norm:
            jw = jw / jnp.sum(jw, axis=-1, keepdims=True)
        jw = jw * scale if scale != 1.0 else jw
        w, i = moe.route(torch.from_numpy(router), 3, norm, scale)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=0)
        # JaxRouting's replay of these experts gives the same weights
        w2, _ = replay_route(torch.from_numpy(router), i, norm, scale)
        assert torch.equal(w2, w)


def test_grouped_ffn_matches_jax(rng):
    """moe_grouped_ffn over dense bf16 stacks against JAX's ragged grouped
    FFN on the same bf16 values, within 1e-5 of max|y|: exact products,
    f32 sums in another order."""
    nt, d, f, E, k = 7, 64, 96, 6, 2
    bf = lambda *s: (rng.standard_normal(s) * 0.1).astype(jnp.bfloat16)
    x, wg, wu, wd = bf(nt, d), bf(E, f, d), bf(E, f, d), bf(E, d, f)
    probs = jax.nn.softmax(jnp.asarray(rng.standard_normal((nt, E)).astype(np.float32)), -1)
    top_w, top_i = jax.lax.top_k(probs, k)
    ref = np.asarray(jax_moe.moe_grouped_ffn(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
                                             jnp.asarray(wd), top_i, top_w, jax.nn.silu))
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)
    got = moe.moe_grouped_ffn(t(x), t(wg), t(wu), t(wd), torch.from_numpy(np.array(top_i)),
                              torch.from_numpy(np.array(top_w)), torch.nn.functional.silu)
    assert _rel(got, ref) <= 1e-5


def test_gathered_quant_matches_jax(rng):
    """moe_gathered_quant over stacked exact Q4_K repacks (stack_qtensors of
    the same experts on both sides, then the port's stack from the JAX
    one) against JAX's, within 1e-5 of max|y|; an expert view qt[e] is the
    per-expert repack, plane for plane."""
    nt, d, f, E, k = 3, 256, 256, 8, 2
    mk = lambda n_, k_: [repack_float((rng.standard_normal((n_, k_)) * 0.1).astype(np.float32),
                                      JQ.Q4_K) for _ in range(E)]
    stacks = [jax_qt.stack_qtensors(mk(f, d)), jax_qt.stack_qtensors(mk(f, d)),
              jax_qt.stack_qtensors(mk(d, f))]
    ours = [qtensor_from_numpy(s, "cpu") for s in stacks]
    assert all(q.is_stacked and len(q) == E for q in ours)
    x = rng.standard_normal((nt, d)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(rng.standard_normal((nt, E)).astype(np.float32)), -1)
    top_w, top_i = jax.lax.top_k(probs, k)
    ref = np.asarray(jax_moe.moe_gathered_quant(
        jnp.asarray(x), *[jax.tree.map(jnp.asarray, s) for s in stacks], top_i, top_w,
        jax.nn.silu))
    got = moe.moe_gathered_quant(torch.from_numpy(x), *ours, torch.from_numpy(np.array(top_i)),
                                 torch.from_numpy(np.array(top_w)), torch.nn.functional.silu)
    assert _rel(got, ref) <= 1e-5
    view = ours[0][3]
    assert not view.is_stacked and view.shape == (f, d)
    np.testing.assert_array_equal(view.codes.numpy(), np.asarray(stacks[0].codes)[3])


def _mixtral_file(path, n_expert: int, qtype, seed: int = 31, n_embd: int = 256):
    dims = tiny_mixtral_dims(n_embd=n_embd, n_ff=256, n_expert=n_expert, n_expert_used=2,
                             vocab=160)
    write_mixtral_gguf(path, random_mixtral_weights(dims, np.random.default_rng(seed)), dims,
                       qtype=qtype)
    return path


@pytest.mark.parametrize("ne,mode,want", [(8, "w4", "w4 list"), (8, "int8", "q8f list"),
                                          (8, None, "stacked"), (32, "w4", "stacked"),
                                          (8, "float", "dense")])
def test_loader_expert_policy(tmp_path, ne, mode, want):
    """The loader's expert policy, JAX's (loader.py:181-206): in a fast
    mode with E <= 16 a list of per-expert folds in the mode's layout;
    the exact mode, or E > 16, one stacked exact repack; a float file dense
    [E, n, k] bf16 stacks; the router a dense bf16 matrix in every mode.
    The port's experts equal JAX's, converted (params_from_numpy)."""
    qt = JQ.F32 if mode == "float" else JQ.Q4_K
    path = _mixtral_file(tmp_path / "m.gguf", ne, qt, seed=5)
    fm = None if mode == "float" else mode
    jcfg, jp, jf = jax_load(path, fast_mode=fm)
    cfg, pp, f = load_gguf_model(path, fast_mode=fm, device="cpu")
    jf.close()
    f.close()
    assert (cfg.n_expert, cfg.n_expert_used, cfg.moe_norm_topk) == (jcfg.n_expert,
                                                                     jcfg.n_expert_used, True)
    lp = pp["layers"][0]
    g = lp["ffn_gate_exps"]
    router = lp["ffn_gate_inp"]
    assert isinstance(router, torch.Tensor) and router.dtype == torch.bfloat16
    assert router.shape == (ne, 256)
    if want == "dense":
        assert isinstance(g, torch.Tensor) and g.shape == (ne, 256, 256)
        assert g.dtype == torch.bfloat16
        return
    if want == "stacked":
        assert isinstance(g, QTensor) and g.is_stacked and len(g) == ne and g.flavor is None
    else:
        assert isinstance(g, list) and len(g) == ne
        assert g[0].flavor == {"w4 list": "legacy", "q8f list": "q8f"}[want]  # k 256: legacy W4
    ref = params_from_numpy(jax.tree.map(np.asarray, jp["layers"][0]["ffn_gate_exps"]), "cpu")
    for a, b in zip(g if isinstance(g, list) else [g], ref if isinstance(ref, list) else [ref]):
        assert a.tensors().keys() == b.tensors().keys()
        for name, t in b.tensors().items():
            assert torch.equal(a.tensors()[name], t.to(a.tensors()[name].dtype)), name


def _jax_steps(ctx, prompt, n):
    """JAX greedy: the prefill's last logits, then n decode steps."""
    assert ctx.decode(JaxBatch.single(prompt)) == 0
    logits, toks = [ctx.get_logits()[-1]], []
    for i in range(n):
        toks.append(int(np.argmax(logits[-1])))
        assert ctx.decode(JaxBatch.single([toks[-1]], pos0=len(prompt) + i)) == 0
        logits.append(ctx.get_logits()[-1])
    return toks, logits


def _forced(ctx, prompt, toks):
    """The port, teacher-forced with JAX's tokens: logits of each step."""
    assert ctx.decode(Batch.single(prompt)) == 0
    logits = [ctx.get_logits()[-1]]
    for i, tok in enumerate(toks):
        assert ctx.decode(Batch.single([tok], pos0=len(prompt) + i)) == 0
        logits.append(ctx.get_logits()[-1])
    return logits


def served_parity(jctx, pctx, prompt, n_steps: int, tol: float, min_decided: int = 2) -> dict:
    """A prefill and n_steps decode steps: JAX decodes greedily and the port
    takes JAX's tokens, so one near-tie cannot send the two down different
    paths; the port's logits within tol of max|logits| at every step, and
    its greedy token JAX's at every step whose top-2 gap exceeds twice
    that (the near-ties under it are counted, as test_torch_speculative.py
    counts partings), and at least min_decided such steps, so that the
    token check carries signal (test_torch_kv_q4.py asks none at its wider
    tolerance).  Returns the errors and the counts."""
    toks, jl = _jax_steps(jctx, prompt, n_steps)
    pl = _forced(pctx, prompt, toks)
    errs, ties = [], 0
    for i, (a, b) in enumerate(zip(pl, jl)):
        top = np.abs(b).max()
        errs.append(float(np.abs(a - b).max() / top))
        s = np.sort(b)
        if s[-1] - s[-2] > 2 * tol * top:
            assert int(np.argmax(a)) == int(np.argmax(b)), (i, errs[-1])
        else:
            ties += 1
    assert max(errs) <= tol, errs
    assert len(pl) - ties >= min_decided, ties
    return {"errs": errs, "near_ties": ties}


class JaxRouting:
    """Routing near-ties: a token whose k-th and (k+1)-th router
    probabilities nearly tie can pick another expert in the port than in
    JAX (their hidden states differ by f32 order and, in w4, by int8
    re-quantization), and that one expert moves the logits far past any
    tolerance.  So the port replays JAX's routing: JAX's top_k is wrapped to
    record (probs, top_i) of every call in order (an ordered host
    callback, inside its jitted forward), and the port's ``moe.route``
    takes the next record's experts (rows [:nt]: JAX pads a decode row to
    8), while its own top k is kept.  Every row where the two choose other
    experts must be a near-tie: JAX's k-th minus (k+1)-th probability no
    more than twice the measured noise, the largest difference of the two
    sides' probabilities over all rows.  ``check`` counts those rows."""

    def __init__(self, monkeypatch):
        self.records, self.noise, self.gaps, self.rows = [], 0.0, [], 0
        real_top_k = jax.lax.top_k

        def top_k(x, k):
            out = real_top_k(x, k)
            jax.debug.callback(lambda p, i: self.records.append((np.asarray(p), np.asarray(i))),
                               x, out[1], ordered=True)
            return out

        monkeypatch.setattr(jax.lax, "top_k", top_k)
        real_route = moe.route

        def route(router, n_used, norm_topk, scale):
            probs_j, i_j = self.records.pop(0)
            nt = router.shape[0]
            own_w, own_i = real_route(router, n_used, norm_topk, scale)
            probs = torch.softmax(router.to(torch.float32), dim=-1).numpy()
            self.noise = max(self.noise, float(np.abs(probs - probs_j[:nt]).max()))
            self.rows += nt
            for r in range(nt):
                if set(own_i[r].tolist()) != set(i_j[r].tolist()):
                    srt = np.sort(probs_j[r])[::-1]
                    self.gaps.append(float(srt[n_used - 1] - srt[n_used]))
            return replay_route(router, torch.from_numpy(i_j[:nt].astype(np.int64)), norm_topk,
                                scale)

        monkeypatch.setattr(moe, "route", route)

    def check(self) -> int:
        """Every parted row a near-tie; the number of parted rows."""
        assert not self.records  # the port made as many routing calls as JAX
        assert all(g <= 2 * self.noise for g in self.gaps), (self.gaps, self.noise)
        return len(self.gaps)


def route_calls(monkeypatch) -> dict:
    """Counts of the three MoE routes' calls in the port's forward."""
    calls = {"grouped": 0, "gathered": 0, "sweep": 0}
    for name, mod, attr in (("grouped", moe, "moe_grouped_ffn"),
                            ("gathered", moe, "moe_gathered_quant"),
                            ("sweep", llama_model, "_moe_sweep")):
        real = getattr(mod, attr)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, attr, counted)
    return calls


# (expert count, file type, mode, the routes a 12-token prefill and the
# one-token steps take: JAX's rule on the port's rows)
MIXTRAL_CASES = [
    (4, JQ.F32, None, ("grouped", "grouped")),
    (4, JQ.Q4_K, "w4", ("sweep", "sweep")),
    (8, JQ.Q4_K, None, ("sweep", "gathered")),
]


@pytest.mark.parametrize("ne,qtype,mode,routes", MIXTRAL_CASES)
def test_tiny_mixtral_serves_like_jax(tmp_path, monkeypatch, ne, qtype, mode, routes):
    """The tiny Mixtral (2 layers, E 256, 4 heads on 2 kv heads, top-2) in
    both packages' default contexts (the layers stack in both), a 12-token
    prefill and N_STEPS decode steps, by served_parity, the port on JAX's
    routing (JaxRouting: the rows that would route otherwise are near-ties,
    at most a tenth of them).  tol: 1e-2 of
    max|logits| on the float and exact files (bf16 operands: the ~7e-3 by
    which XLA's excess precision moves JAX's jitted logits, ROADMAP
    hazards), 2.5e-2 in w4 (JAX in interpret mode; measured 1.1-1.7e-2),
    where every matmul re-quantizes its input to int8 and so carries a
    rounding difference further (test_torch_loader.py's reason).  The routes taken are
    JAX's rule on the port's rows: the prefill pads to 16 rows, 32 slots,
    which sweep a stack of 8 experts (not fewer slots than experts); a
    one-row step's 2 slots gather from it."""
    if mode == "w4":
        monkeypatch.setenv("LKTPU_FORCE_PALLAS_INTERPRET", "1")
    path = _mixtral_file(tmp_path / "m.gguf", ne, qtype, n_embd=256 if qtype != JQ.F32 else 64)
    jcfg, jp, jf = jax_load(path, fast_mode=mode, fuse=True)
    cfg, pp, f = load_gguf_model(path, fast_mode=mode, fuse=True, device="cpu")
    jf.close()
    f.close()
    calls = route_calls(monkeypatch)
    routing = JaxRouting(monkeypatch)
    pctx = LlamaContext(cfg, pp, n_cells=N_CELLS, device="cpu")
    jctx = JaxContext(jcfg, jp, n_cells=N_CELLS)
    assert ("layers_stacked" in pctx.params) == ("layers_stacked" in jctx.params)
    prompt = np.random.default_rng(17).integers(0, cfg.vocab_size, 12).astype(np.int32)
    tol = 2.5e-2 if mode == "w4" else 1e-2
    served_parity(jctx, pctx, prompt, N_STEPS, tol)
    assert routing.check() <= routing.rows // 10
    want = {r: 0 for r in calls}
    want[routes[0]] += cfg.n_layer
    want[routes[1]] += N_STEPS * cfg.n_layer
    assert calls == want
