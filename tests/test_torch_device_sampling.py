"""Port parity for on-device sampling (``runtime/generate.py``): the stages
of ``_sample`` before the draw (the top-k window's ids, the keep mask, the
scaled logits) against the JAX package's on the same logits, on the greedy
path, pure temperature, top-k, top-p and min-p, with penalties, on the
per-row (spv) path and under a vocab mask; the draw equal to JAX's
``categorical`` given the same Gumbel noise; ``sample_rows`` and
``LlamaContext.sample_rows_device``; the (seed, position) contract of the
port's noise; and a chi-square check of its draw frequencies.

JAX's stages are read from its own ``_sample``, run eagerly with
``jax.random.categorical`` and ``jax.lax.top_k`` wrapped to record what
they receive and return."""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from llama_kotlin_tpu.runtime import generate as jax_gen

from llama_kotlin_tpu_torch.models.synthetic import preset_config, synthetic_params_device
from llama_kotlin_tpu_torch.runtime import generate as gen
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.context import LlamaContext

from test_torch_cli import one_thread  # noqa: F401 (autouse fixture)

B, V = 4, 1000
TOP_P_MARGIN = 1e-5  # no cum_excl within this of top_p (f32 softmax rounding)

CASES = {
    "greedy": dict(sp=dict()),
    "temperature": dict(sp=dict(temp=0.7)),
    "top_k": dict(sp=dict(temp=0.8, top_k=40)),
    "top_k_p_min_p": dict(sp=dict(temp=0.9, top_k=50, top_p=0.9, min_p=0.05)),
    "top_p_cand_cap": dict(sp=dict(temp=1.1, top_p=0.8)),
    "min_p_cand_cap": dict(sp=dict(temp=1.0, min_p=0.2)),
    "penalties": dict(sp=dict(temp=0.8, top_k=40, top_p=0.95, penalty_last_n=16,
                              penalty_repeat=1.3, penalty_freq=0.2, penalty_present=0.4,
                              nl_token=5), pen=True),
    "spv": dict(sp=dict(top_k=64), spv=True),
    "spv_penalties": dict(sp=dict(top_k=64, penalty_last_n=16, penalty_repeat=1.1,
                                  penalty_freq=0.1), spv=True, pen=True),
    "masked": dict(sp=dict(temp=0.8, top_k=40, top_p=0.9), mask=True),
    "masked_spv": dict(sp=dict(top_k=48), spv=True, mask=True),
}


def _inputs(name: str, seed: int):
    """Seeded logits [B, V] (with the mask applied as NEG_INF where the case
    masks; a row with fewer allowed tokens than the window, so NEG_INF ties
    fill it), occurrence counts of a token window, per-row arrays."""
    case = CASES[name]
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 2.5).astype(np.float32)
    if case.get("mask"):
        allow = rng.random((B, V)) < 0.3
        allow[0] = False
        allow[0, rng.choice(V, 12, replace=False)] = True  # 12 < the window
        logits = np.where(allow, logits, np.float32(gen.NEG_INF))
    counts = None
    if case.get("pen"):
        window = rng.integers(-1, 60, (B, 16))
        window[:, 0] = 5  # the newline token is in every window
        counts = np.zeros((B, V), np.float32)
        for r in range(B):
            for t in window[r][window[r] >= 0]:
                counts[r, t] += 1
        logits[:, :60] += 2.0  # the penalized ids reach the window
    spv = None
    if case.get("spv"):
        spv = {"temp": np.array([0.8, 0.0, 1.2, 0.6], np.float32),
               "top_k": np.array([40, 10, 0, 64], np.int32),
               "top_p": np.array([0.9, 1.0, 0.95, 0.7], np.float32),
               "min_p": np.array([0.05, 0.0, 0.1, 0.0], np.float32)}
    return logits, counts, spv


def _jax_run(logits, sp, counts, spv, monkeypatch, key=None):
    """JAX's _sample, eagerly, recording categorical's logits and key and
    top_k's ids.  Returns (ids, scaled or None, window ids or None, key)."""
    rec = {}
    real_cat, real_topk = jax.random.categorical, jax.lax.top_k

    def cat(k, lg, axis=-1, **kw):
        rec["scaled"], rec["key"] = np.asarray(lg), k
        return real_cat(k, lg, axis=axis, **kw)

    def topk(x, k):
        v, i = real_topk(x, k)
        rec["ids"] = np.asarray(i)
        return v, i

    monkeypatch.setattr(jax.random, "categorical", cat)
    monkeypatch.setattr(jax.lax, "top_k", topk)
    key = jax.random.PRNGKey(3) if key is None else key
    out = jax_gen._sample(jnp.asarray(logits), jax_gen.SampleParams(**sp), key,
                          None if counts is None else jnp.asarray(counts),
                          spv=None if spv is None else {k: jnp.asarray(v) for k, v in spv.items()})
    monkeypatch.undo()
    return np.asarray(out), rec.get("scaled"), rec.get("ids"), rec.get("key")


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))  # a writable copy


def _spv_t(spv):
    return None if spv is None else {k: _t(v) for k, v in spv.items()}


def _check_margin(scaled: np.ndarray, sp: dict, spv) -> None:
    """The case is well posed: no cumulative probability sits within
    TOP_P_MARGIN of a top-p cut (checked in float64 on JAX's window)."""
    ps = np.full(B, sp.get("top_p", 1.0)) if spv is None else spv["top_p"]
    fin = np.isfinite(scaled)
    for r in range(B):
        if ps[r] >= 1.0:
            continue
        x = scaled[r][fin[r]].astype(np.float64)
        p = np.exp(x - x.max())
        cum = np.cumsum(p / p.sum())
        assert np.abs(cum - ps[r]).min() > TOP_P_MARGIN


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(CASES))
def test_sample_stages_and_draw_match_jax(name, seed, monkeypatch):
    """Window ids and keep masks equal JAX's; scaled logits within 1e-6
    relative; the port's draw given JAX's Gumbel noise equals JAX's ids."""
    case = CASES[name]
    logits, counts, spv = _inputs(name, seed)
    want, scaled, ids, key = _jax_run(logits, case["sp"], counts, spv, monkeypatch)
    st = gen.sample_stages(_t(logits), gen.SampleParams(**case["sp"]), _t(counts), _spv_t(spv))
    if scaled is None:  # greedy: no draw
        assert st.scaled is None
        np.testing.assert_array_equal(st.greedy.numpy(), want)
        return
    got_scaled = st.scaled.numpy()
    assert got_scaled.shape == scaled.shape
    if ids is None:
        assert st.ids is None
    else:
        np.testing.assert_array_equal(st.ids.numpy(), ids)
        np.testing.assert_array_equal(st.keep.numpy(), np.isfinite(scaled))
        _check_margin(scaled, case["sp"], spv)
    fin = np.isfinite(scaled)
    np.testing.assert_array_equal(np.isfinite(got_scaled), fin)
    np.testing.assert_allclose(got_scaled[fin], scaled[fin], rtol=1e-6, atol=0)
    g = np.asarray(jax.random.gumbel(key, scaled.shape, jnp.float32))
    np.testing.assert_array_equal(gen.draw(st, _t(g)).numpy(), want)
    if st.ids is not None:  # the case carries signal: a window that filters
        assert (~st.keep.numpy()).any() or name == "top_k"


def test_greedy_stages_match_jax_argmax(monkeypatch):
    """The greedy ids of every case (the spv path's temp-0 rows) equal JAX's
    at temp 0 with the same penalties and mask."""
    for name, case in CASES.items():
        logits, counts, spv = _inputs(name, 7)
        sp = dict(case["sp"], temp=0.0)
        want, _, _, _ = _jax_run(logits, sp, counts, None, monkeypatch)
        st = gen.sample_stages(_t(logits), gen.SampleParams(**sp), _t(counts))
        np.testing.assert_array_equal(st.greedy.numpy(), want)
        np.testing.assert_array_equal(gen._sample(_t(logits), gen.SampleParams(**sp), None,
                                                  _t(counts)).numpy(), want)


def _bits(allow: np.ndarray) -> np.ndarray:
    return np.packbits(allow, axis=-1, bitorder="little")


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("use_pen", [False, True])
def test_sample_rows_matches_jax(use_mask, use_pen):
    """sample_rows over picked rows of a logits array, with a packed mask and
    a penalty window: the temp-0 rows equal JAX's ids; every sampled row
    draws inside the window's keep mask (equal to JAX's by the test above)
    and the mask."""
    rng = np.random.default_rng(11)
    R, n = 6, 4
    logits = (rng.standard_normal((R, V)) * 2).astype(np.float32)
    rows = np.array([4, 1, 5, 1], np.int32)
    allow = rng.random((n, V)) < 0.4
    window = rng.integers(-1, V, (n, 8)).astype(np.int32)
    spv = {"temp": np.array([0.0, 0.9, 0.0, 1.3], np.float32),
           "top_k": np.array([0, 20, 5, 0], np.int32),
           "top_p": np.array([1.0, 0.9, 1.0, 0.8], np.float32),
           "min_p": np.array([0.0, 0.05, 0.0, 0.0], np.float32),
           "seed": np.array([3, 4, 5, 6], np.int32)}
    pos = np.array([10, 11, 12, 13], np.int32)
    sp_kw = dict(top_k=32, penalty_last_n=8 if use_pen else 0, penalty_repeat=1.5,
                 penalty_present=0.5)
    want = np.asarray(jax_gen.sample_rows(
        jnp.asarray(logits), jnp.asarray(rows), jnp.asarray(_bits(allow)), jnp.asarray(window),
        {k: jnp.asarray(v) for k, v in spv.items()}, jnp.asarray(pos),
        jax_gen.SampleParams(**sp_kw), use_mask, use_pen))
    got = gen.sample_rows(_t(logits), _t(rows), _t(_bits(allow)), _t(window), _spv_t(spv),
                          _t(pos), gen.SampleParams(**sp_kw), use_mask, use_pen).numpy()
    greedy = spv["temp"] <= 0
    np.testing.assert_array_equal(got[greedy], want[greedy])
    lg = np.where(allow, logits[rows], np.float32(gen.NEG_INF)) if use_mask else logits[rows]
    counts = gen._window_counts(_t(window), V) if use_pen else None
    st = gen.sample_stages(_t(lg), gen.SampleParams(**sp_kw), counts, _spv_t(spv))
    for r in np.nonzero(~greedy)[0]:
        kept = st.ids.numpy()[r][st.keep.numpy()[r]]
        assert got[r] in kept and want[r] in kept
        if use_mask:
            assert allow[r, got[r]]


def test_seed_position_contract():
    """A row's draw depends only on its seed and position: the same (seed,
    pos) gives the same id whatever the batch around it and its place in
    it; another position or seed gives other noise; CPU integer hashing is
    exact, so the noise is a pure function of its counters."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy((rng.standard_normal((1, V)) * 0.5).astype(np.float32))
    sp = gen.SampleParams(top_k=200)
    spv1 = {"temp": torch.tensor([1.0]), "top_k": torch.tensor([0]), "top_p": torch.tensor([1.0]),
            "min_p": torch.tensor([0.0]), "seed": torch.tensor([42])}
    one = gen._sample(logits, sp, None, spv=spv1, pos=torch.tensor([7]))
    big = logits.repeat(5, 1)
    spv5 = {k: torch.cat([v.new_tensor([v[0].item()] * 2), v, v.new_tensor([v[0].item()] * 2)])
            for k, v in spv1.items()}
    spv5["seed"] = torch.tensor([1, 2, 42, 3, 42])
    pos5 = torch.tensor([7, 7, 7, 7, 8])
    five = gen._sample(big, sp, None, spv=spv5, pos=pos5)
    assert int(five[2]) == int(one[0])
    k = gen.NoiseKey
    g = lambda s, p: gen.gumbel_noise(k(torch.tensor([s]), torch.tensor([p]),  # noqa: E731
                                        torch.tensor([0])), 64)
    assert torch.equal(g(42, 7), g(42, 7))
    assert not torch.equal(g(42, 7), g(42, 8)) and not torch.equal(g(42, 7), g(43, 7))
    draws = {int(gen._sample(logits, sp, None, spv=spv1, pos=torch.tensor([p]))[0])
             for p in range(40)}
    assert len(draws) > 10  # positions draw differently
    # the shared-seed path: row r takes stream r, so rows differ at one step
    key = gen.shared_key(5, 3, 4, "cpu")
    noise = gen.gumbel_noise(key, 64)
    assert len({tuple(r.tolist()) for r in noise}) == 4


def test_chi_square_draw_frequencies():
    """20000 draws of one 8-way distribution at a fixed seed over positions
    0..19999: Pearson's chi-square against the softmax probabilities stays
    below 24.32, the 0.999 quantile at 7 degrees of freedom."""
    logits = torch.tensor([[1.5, 0.2, -0.3, 0.9, -2.0, 0.0, 1.1, -0.7]])
    n = 20000
    st = gen.sample_stages(logits.repeat(n, 1), gen.SampleParams(temp=1.0))
    key = gen.row_key(torch.full((n,), 1234), torch.arange(n))
    ids = gen.draw(st, gen.gumbel_noise(key, 8)).numpy()
    counts = np.bincount(ids, minlength=8)
    p = torch.softmax(logits[0].double(), 0).numpy()
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < 24.32, (chi2, counts)


@pytest.fixture(scope="module")
def tiny():
    cfg = preset_config("test-tiny", n_layer=1)
    return cfg, synthetic_params_device(cfg, seed=4, device="cpu")


def test_generate_sampling_contract(tiny):
    """generate() with the default SampleParams gives the greedy ids (the
    argmax after the same prefill and steps); at a seed it repeats itself;
    generate_loop in one call of 8 steps equals two chunked calls of 4 at
    the same positions (per-row seeds), and with penalties on it still
    repeats itself and moves off the plain draw."""
    cfg, params = tiny
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 9)
    ctx = lambda: LlamaContext(cfg, params, n_cells=256, device="cpu")  # noqa: E731
    greedy = gen.generate(ctx(), prompt, 6)
    c = ctx()
    assert c.decode(Batch.single(prompt)) == 0
    ref = []
    for i in range(6):
        ref.append(int(np.argmax(c.get_logits()[-1])))
        assert c.decode(Batch.single([ref[-1]], pos0=len(prompt) + i)) == 0
    assert greedy == ref
    sp = gen.SampleParams(temp=0.8, top_k=40, top_p=0.95, seed=1)
    a, b = gen.generate(ctx(), prompt, 6, sp), gen.generate(ctx(), prompt, 6, sp)
    assert a == b and a != greedy
    assert gen.generate(ctx(), prompt, 6, sp._replace(temp=0.0)) == greedy

    def loop(chunks, pen):
        c = ctx()
        assert c.decode(Batch.single(prompt)) == 0
        n = sum(chunks)
        slots = c.meta.find_slots(n)
        c.meta.commit(slots, np.arange(len(prompt), len(prompt) + n), np.zeros(n, np.int32))
        cell_pos, cell_seq = c.meta.device_view(c.n_vis_for_span(), "cpu")
        spv = {"temp": torch.tensor([0.9]), "top_k": torch.tensor([30]),
               "top_p": torch.tensor([0.95]), "min_p": torch.tensor([0.0]),
               "seed": torch.tensor([77])}
        psp = gen.SampleParams(top_k=30, penalty_last_n=8 if pen else 0, penalty_repeat=1.5)
        window = torch.full((1, 8), -1, dtype=torch.int32)
        tok = torch.tensor([int(prompt[-1])], dtype=torch.int32)
        out, done = [], 0
        for k in chunks:
            o, _ = gen.generate_loop(
                c.params, cfg, c.cache, cell_pos, cell_seq, tok,
                torch.tensor([len(prompt) + done], dtype=torch.int32),
                torch.zeros(1, dtype=torch.int32),
                torch.from_numpy(slots[done:done + k].reshape(k, 1)), k, psp,
                pen_window=window if pen else None, spv=spv)
            out += o[:, 0].tolist()
            tok, done = o[-1], done + k
        return out

    one = loop([8], False)
    assert loop([4, 4], False) == one
    pen = loop([8], True)
    assert loop([8], True) == pen


def test_generate_loop_reads_nothing_back(tiny, monkeypatch):
    """generate_loop takes no value from the device and copies none from
    the host: inside it, every call that would wait for a CUDA stream
    (torch.tensor from host data, item, tolist, cpu, numpy, a tensor's
    truth or number) raises, on the greedy path, the sampled chain of
    generate() and a penalized per-row-config loop.  On the card,
    chip_smoke.py's cli_phase runs the loop under
    torch.cuda.set_sync_debug_mode("error")."""
    cfg, params = tiny
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 9)
    loop = gen.generate_loop
    calls = []

    def refuse(name):
        def f(*args, **kw):
            raise AssertionError(f"generate_loop called {name}")
        return f

    def guarded(*args, **kw):
        calls.append(1)
        with monkeypatch.context() as m:
            m.setattr(torch, "tensor", refuse("torch.tensor"))
            for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__",
                         "__index__"):
                m.setattr(torch.Tensor, name, refuse(name))
            return loop(*args, **kw)

    monkeypatch.setattr(gen, "generate_loop", guarded)
    ctx = lambda: LlamaContext(cfg, params, n_cells=256, device="cpu")  # noqa: E731
    gen.generate(ctx(), prompt, 4)
    gen.generate(ctx(), prompt, 4, gen.SampleParams(temp=0.8, top_k=40, top_p=0.95,
                                                    min_p=0.05, seed=3))
    c = ctx()
    assert c.decode(Batch.single(prompt)) == 0
    slots = c.meta.find_slots(4)
    c.meta.commit(slots, np.arange(len(prompt), len(prompt) + 4), np.zeros(4, np.int32))
    cell_pos, cell_seq = c.meta.device_view(c.n_vis_for_span(), "cpu")
    spv = {"temp": torch.tensor([0.9]), "top_k": torch.tensor([30]),
           "top_p": torch.tensor([0.95]), "min_p": torch.tensor([0.05])}
    gen.generate_loop(c.params, cfg, c.cache, cell_pos, cell_seq,
                      torch.tensor([int(prompt[-1])], dtype=torch.int32),
                      torch.tensor([len(prompt)], dtype=torch.int32),
                      torch.zeros(1, dtype=torch.int32), torch.from_numpy(slots.reshape(4, 1)),
                      4, gen.SampleParams(top_k=30, penalty_last_n=8, penalty_repeat=1.5,
                                          penalty_present=0.2, seed=5),
                      pen_window=torch.full((1, 8), -1, dtype=torch.int32), spv=spv)
    assert len(calls) == 3


def test_sample_rows_device_matches_sample_rows(tiny):
    """LlamaContext.sample_rows_device packs a bool mask with np.packbits
    (little bit order) and unpacks it on the device: every id lies inside
    the mask, greedy rows take the masked argmax, and the ids equal
    sample_rows on the same packed inputs."""
    cfg, params = tiny
    c = LlamaContext(cfg, params, n_cells=256, device="cpu")
    batch = Batch(np.arange(5, 13), np.arange(8), np.zeros(8, np.int32), np.ones(8, bool))
    assert c.decode(batch) == 0
    rng = np.random.default_rng(5)
    rows = np.array([7, 3, 0])
    masks = rng.random((3, cfg.vocab_size)) < 0.05
    spv = {"temp": np.array([0.0, 0.8, 1.5], np.float32), "top_k": np.array([0, 8, 0]),
           "top_p": np.array([1.0, 0.9, 1.0], np.float32),
           "min_p": np.array([0.0, 0.0, 0.1], np.float32), "seed": np.array([1, 2, 3])}
    pos = np.array([8, 8, 8])
    sp = gen.SampleParams(top_k=16)
    ids = c.sample_rows_device(rows, sp, spv, pos, masks=masks)
    assert all(masks[i, t] for i, t in enumerate(ids))
    lg = c.get_logits()[rows]
    assert ids[0] == int(np.argmax(np.where(masks[0], lg[0], -np.inf)))
    again = gen.sample_rows(c.logits_device(), _t(rows), _t(_bits(masks)), torch.zeros(3, 1),
                            _spv_t(spv), _t(pos), sp, True, False).numpy()
    np.testing.assert_array_equal(ids, again)
    v, i = c.get_topk(3)
    np.testing.assert_array_equal(i, np.argsort(-c.get_logits(), axis=-1, kind="stable")[:, :3])
    np.testing.assert_array_equal(c.get_logits_ith(2), c.get_logits()[2])
