"""Multi-step generation with on-device sampling (port of
``llama_kotlin_tpu/runtime/generate.py``).

The JAX package compiles the decode loop into one ``lax.fori_loop``.  Here
the loop is a Python loop of device work: each step updates the cell
metadata on the device, runs the forward pass and samples on the device,
so nothing waits for the host until the caller reads the tokens.
(Capturing a step in a CUDA graph is later work.)

Sampling follows JAX's ``_sample`` stage for stage (penalties, the top-k
window, top-p, min-p, temperature), split in two: ``sample_stages`` does
everything before the draw, and ``draw`` takes the Gumbel noise as an
argument (a categorical draw is the argmax of the scaled logits plus
Gumbel noise, which is how ``jax.random.categorical`` draws too).  The
noise cannot equal JAX's, whose PRNG differs; it comes from a counter-based
hash computed on the device (``gumbel_noise``), so that a row's draw at
position p is a pure function of its seed and p, as JAX's key folding
makes it: not of the batch, the chunk or the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from llama_kotlin_tpu_torch.models import llama as llama_model
from llama_kotlin_tpu_torch.models.config import ModelConfig
from llama_kotlin_tpu_torch.runtime.batch import Batch
from llama_kotlin_tpu_torch.runtime.kv_cache import KVCache


class SampleParams(NamedTuple):
    """On-device sampling parameters (greedy when temp == 0).

    Mirrors the default sampler-chain order (penalties -> top_k -> top_p ->
    min_p -> temperature -> dist).  top_p / min_p operate on a top-candidate
    window: exact when top_k > 0; with top_k == 0 the window is CAND_CAP.
    """

    temp: float = 0.0
    top_k: int = 0  # 0 = off
    seed: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    penalty_last_n: int = 0  # 0 = penalties off
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    nl_token: int = -1  # restore this token's logit (penalize_nl=False)

    @property
    def use_penalties(self) -> bool:
        return self.penalty_last_n > 0 and (
            self.penalty_repeat != 1.0 or self.penalty_freq != 0.0
            or self.penalty_present != 0.0)


CAND_CAP = 512  # top-candidate window for top_p/min_p with top_k=0
NEG_INF = -1e30


# -- noise ---------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for 0 <= x < 2^32 in int64 without overflow: c is
    taken in 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (a bijection: xorshift-multiply rounds)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class NoiseKey(NamedTuple):
    """Per-row noise counters, int64 tensors [B] on the device: a row's
    noise is a function of (seed, pos, stream) and the column alone."""

    seed: torch.Tensor
    pos: torch.Tensor
    stream: torch.Tensor


def shared_key(seed, pos, n_rows: int, device) -> NoiseKey:
    """One seed and position for a batch (JAX: one key folded with the
    step's position, drawn over [B, n]): the rows take streams 0..B-1."""
    def col(v):
        if not isinstance(v, torch.Tensor):  # a fill, not a host-to-device copy
            return torch.full((n_rows,), int(v), dtype=torch.int64, device=device)
        return v.to(device=device, dtype=torch.int64).reshape(-1).expand(n_rows)
    return NoiseKey(col(seed), col(pos),
                    torch.arange(n_rows, dtype=torch.int64, device=device))


def row_key(seeds: torch.Tensor, pos: Optional[torch.Tensor]) -> NoiseKey:
    """Per-row seeds (JAX: each row's key folded with its own seed and
    position): stream 0 for every row, so a row's draws do not depend on
    where it sits in the batch.  pos None folds no position (-1)."""
    seeds = seeds.to(torch.int64)
    p = torch.full_like(seeds, -1) if pos is None else pos.to(torch.int64).expand_as(seeds)
    return NoiseKey(seeds, p, torch.zeros_like(seeds))


def gumbel_noise(key: NoiseKey, n: int) -> torch.Tensor:
    """Standard Gumbel noise [B, n] f32 from the counters, on their device.
    Integer hashing is exact on every device; u takes 24 bits, so it is an
    exact f32 in (0, 1)."""
    base = _mix32((key.seed & _M32) ^ 0x243F6A88)
    base = _mix32(base ^ (key.pos & _M32))
    base = _mix32(base ^ (key.stream & _M32))
    cols = _mix32(torch.arange(n, dtype=torch.int64, device=base.device) ^ 0x85A308D3)
    h = _mix32(base[:, None] ^ cols[None, :])
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


# -- sampling ------------------------------------------------------------------


class Stages(NamedTuple):
    """_sample's work before the draw.  scaled None: the rows are greedy.
    ids None: scaled spans the whole vocab (pure temperature)."""

    greedy: torch.Tensor  # [B] int32: argmax of the (penalized) logits
    scaled: Optional[torch.Tensor] = None  # [B, n] f32, -inf outside keep
    ids: Optional[torch.Tensor] = None  # [B, n] int64 window token ids
    keep: Optional[torch.Tensor] = None  # [B, n] bool
    greedy_rows: Optional[torch.Tensor] = None  # [B] bool (spv: temp <= 0)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """v as an f32 scalar on like's device, made by a fill: no copy from the
    host (which would wait for the stream), and a true division where a
    Python scalar would let CUDA multiply by its reciprocal."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def penalize(logits: torch.Tensor, sp: SampleParams,
             counts: Optional[torch.Tensor]) -> torch.Tensor:
    """Repetition/frequency/presence penalties over occurrence counts
    [B, V] (parity: llama_sample_repetition_penalties); f32 out."""
    logits = logits.to(torch.float32)
    if not (sp.use_penalties and counts is not None):
        return logits
    orig = logits
    seen = counts > 0
    if sp.penalty_repeat != 1.0:
        rep = _scalar(sp.penalty_repeat, logits)
        pen = torch.where(logits > 0, logits / rep, logits * rep)
        logits = torch.where(seen, pen, logits)
    logits = logits - counts * sp.penalty_freq - seen.to(torch.float32) * sp.penalty_present
    if sp.nl_token >= 0:  # penalize_nl=False keeps newline unpenalized
        logits[:, sp.nl_token] = orig[:, sp.nl_token]
    return logits


def _window(logits: torch.Tensor, cap: int):
    """The top `cap` logits per row, descending, ties to the lower id
    (``jax.lax.top_k``'s order; a stable sort keeps it)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[:, :cap], idx[:, :cap]


def sample_stages(logits: torch.Tensor, sp: SampleParams,
                  counts: Optional[torch.Tensor] = None,
                  spv: Optional[dict] = None) -> Stages:
    """logits [B, V] -> the stages before the draw.  counts [B, V] =
    occurrence counts over the penalty window.  spv (per-row arrays temp /
    top_k / top_p / min_p [B] tensors) selects the mixed-config path: one
    window of sp.top_k (the max over rows), per-row masks inside it,
    greedy rows by argmax."""
    logits = penalize(logits, sp, counts)
    V = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if spv is not None:
        cap = min(max(int(sp.top_k), 1), V)
        vals, idx = _window(logits, cap)
        kcap = torch.where(spv["top_k"] > 0, spv["top_k"],
                           torch.full_like(spv["top_k"], cap))[:, None]
        keep = torch.arange(cap, device=logits.device)[None, :] < kcap
        probs = torch.softmax(torch.where(keep, vals, -torch.inf), dim=-1)
        cum_excl = torch.cumsum(probs, dim=-1) - probs
        keep &= cum_excl < spv["top_p"][:, None].to(torch.float32)
        keep &= probs >= spv["min_p"][:, None].to(torch.float32) * probs[:, :1]
        safe_t = torch.clamp_min(spv["temp"].to(torch.float32), 1e-6)[:, None]
        scaled = torch.where(keep, vals / safe_t, -torch.inf)
        return Stages(greedy, scaled, idx, keep, spv["temp"] <= 0.0)
    if sp.temp <= 0.0:
        return Stages(greedy)
    temp = _scalar(sp.temp, logits)
    if sp.top_k <= 0 and sp.top_p >= 1.0 and sp.min_p <= 0.0:
        return Stages(greedy, logits / temp)  # pure temperature: the whole vocab
    cap = min(sp.top_k, V) if sp.top_k > 0 else min(CAND_CAP, V)
    vals, idx = _window(logits, cap)
    keep = torch.ones_like(vals, dtype=torch.bool)
    if sp.top_p < 1.0:
        probs = torch.softmax(vals, dim=-1)
        cum_excl = torch.cumsum(probs, dim=-1) - probs
        keep &= cum_excl < sp.top_p  # smallest set with cumsum >= top_p
    if sp.min_p > 0.0:
        probs = torch.softmax(vals, dim=-1)
        keep &= probs >= sp.min_p * probs[:, :1]
    return Stages(greedy, torch.where(keep, vals / temp, -torch.inf), idx, keep)


def draw(st: Stages, gumbel: Optional[torch.Tensor]) -> torch.Tensor:
    """The categorical draw given its noise [B, n] (n = scaled's width):
    argmax(scaled + gumbel), mapped through the window.  Token ids [B]
    int32."""
    if st.scaled is None:
        return st.greedy
    choice = torch.argmax(st.scaled + gumbel, dim=-1)
    sampled = choice if st.ids is None else torch.gather(st.ids, 1, choice[:, None])[:, 0]
    sampled = sampled.to(torch.int32)
    if st.greedy_rows is not None:
        sampled = torch.where(st.greedy_rows, st.greedy, sampled)
    return sampled


def _sample(logits: torch.Tensor, sp: SampleParams, key: Optional[NoiseKey],
            counts: Optional[torch.Tensor] = None, spv: Optional[dict] = None,
            pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [B, V] -> token ids [B] int32, on the logits' device.  `key`
    gives the noise of the shared-seed paths; with spv["seed"] each row's
    noise comes from its own seed and pos [B] instead (row_key)."""
    st = sample_stages(logits, sp, counts, spv)
    if st.scaled is None:
        return st.greedy
    if spv is not None and "seed" in spv:
        key = row_key(spv["seed"], pos)
    return draw(st, gumbel_noise(key, st.scaled.shape[1]))


def _unpack_mask(mask_bits: torch.Tensor, V: int) -> torch.Tensor:
    """[n, ceil(V/8)] uint8, little bit order -> bool [n, V]."""
    shifts = torch.arange(8, dtype=torch.uint8, device=mask_bits.device)
    bits = (mask_bits[:, :, None] >> shifts) & 1
    return bits.reshape(mask_bits.shape[0], -1)[:, :V] != 0


def _window_counts(window: torch.Tensor, V: int) -> torch.Tensor:
    """Occurrence counts [B, V] f32 of a token window [B, L] (-1 = empty)."""
    counts = torch.zeros((window.shape[0], V), dtype=torch.float32, device=window.device)
    counts.scatter_add_(1, window.clamp_min(0).to(torch.int64),
                        (window >= 0).to(torch.float32))
    return counts


def sample_rows(logits: torch.Tensor, row_ids: torch.Tensor, mask_bits: torch.Tensor,
                pen_window: torch.Tensor, spv: dict, pos: torch.Tensor,
                sp: SampleParams, use_mask: bool, use_pen: bool) -> torch.Tensor:
    """Device-side sampling over rows of an existing logits tensor, with an
    optional per-row vocab bitmask (grammar-legal tokens) applied first, so
    that only the packed mask goes up and the [n] ids come back.

    logits [R, V]; row_ids [n]; mask_bits [n, ceil(V/8)] uint8 (little bit
    order; ignored unless use_mask); pen_window [n, last_n] int (-1 =
    empty; ignored unless use_pen); spv per-row arrays incl. "seed"; pos
    [n] absolute sampling positions."""
    lg = logits[row_ids.to(torch.int64)].to(torch.float32)
    V = lg.shape[-1]
    if use_mask:
        lg = torch.where(_unpack_mask(mask_bits, V), lg, torch.full_like(lg, NEG_INF))
    counts = _window_counts(pen_window, V) if use_pen else None
    key = shared_key(0, 0, lg.shape[0], lg.device)  # per-row seeds in spv
    return _sample(lg, sp, key, counts, spv=spv, pos=pos)


def generate_loop(params: dict, cfg: ModelConfig, cache: KVCache,
                  cell_pos: torch.Tensor, cell_seq: torch.Tensor,
                  tokens0: torch.Tensor, pos0: torch.Tensor, seq_ids: torch.Tensor,
                  slots: torch.Tensor, n_steps: int, sp: SampleParams = SampleParams(),
                  pen_window: Optional[torch.Tensor] = None, spv: Optional[dict] = None,
                  seed=None):
    """Decode n_steps tokens for B sequences on the device.

    cell_pos/cell_seq [n_vis] hold the metadata before the loop and are
    updated in place; slots [n_steps, B] are pre-allocated cells.  Returns
    (out_tokens [n_steps, B] int32, last logits [B, vocab] f32).

    pen_window [B, last_n] (-1 = empty columns first, then the history
    oldest-first) enables the penalties when sp does: the occurrence counts
    and a ring pointer over the window are kept on the device, and each
    sampled token evicts the oldest entry.  Seeding: `seed` (a device
    scalar or an int) or sp.seed; each step's noise folds in the step's
    absolute position (pos[0], or each row's own position with spv["seed"]),
    as JAX folds it into its keys."""
    B = tokens0.shape[0]
    dev = tokens0.device
    out_ids = torch.arange(B, dtype=torch.int32, device=dev)
    out = torch.empty((n_steps, B), dtype=torch.int32, device=dev)
    seq_bits = (1 << seq_ids.to(torch.int64)).to(cell_seq.dtype)
    slots = slots.to(torch.long)
    rows = torch.arange(B, device=dev)
    use_pen = sp.use_penalties and pen_window is not None
    if use_pen:
        window = pen_window.to(device=dev, dtype=torch.int64).clone()
        counts = _window_counts(window, cfg.vocab_size)
        Ln = window.shape[1]
    per_row_seeds = spv is not None and "seed" in spv
    shared_seed = (spv is not None or sp.temp > 0.0) and not per_row_seeds
    # the seed column is made once: nothing in the loop copies from the host
    seeds = shared_key(sp.seed if seed is None else seed, 0, B, dev).seed if shared_seed else None
    tokens, pos, logits = tokens0, pos0, None
    for i in range(n_steps):
        cell_pos[slots[i]] = pos
        cell_seq[slots[i]] = seq_bits
        logits, _ = llama_model.forward(params, cfg, tokens, pos, seq_ids, slots[i], cache,
                                        cell_pos, cell_seq, out_ids)
        key = shared_key(seeds, pos[:1], B, dev) if shared_seed else None
        tokens = _sample(logits, sp, key, counts if use_pen else None, spv=spv, pos=pos)
        out[i] = tokens
        if use_pen:
            col = i % Ln
            evicted = window[:, col]
            counts.index_put_((rows, evicted.clamp_min(0)), -(evicted >= 0).to(torch.float32),
                              accumulate=True)
            counts.index_put_((rows, tokens.to(torch.int64)),
                              torch.ones(B, dtype=torch.float32, device=dev), accumulate=True)
            window[:, col] = tokens
        pos = pos + 1
    return out, logits


def generate(ctx, prompt_tokens, n_steps: int, sp: SampleParams = SampleParams(),
             seq_id: int = 0) -> list[int]:
    """Prefill through the context, then decode n_steps tokens on the device
    with sp (the first from the prefill's logits, drawn at the last prompt
    token's position).  Returns the token ids."""
    prompt_tokens = np.asarray(prompt_tokens, np.int32)
    if ctx.decode(Batch.single(prompt_tokens, seq_id=seq_id)) != 0:
        raise RuntimeError("KV cache full during prefill")
    n_prompt = len(prompt_tokens)
    dev = ctx.device
    first = _sample(ctx.logits_device()[:1], sp, shared_key(sp.seed, n_prompt - 1, 1, dev))
    slots_flat = ctx.meta.find_slots(n_steps)
    if slots_flat is None:
        raise RuntimeError("KV cache full for generation")
    pos = np.arange(n_prompt, n_prompt + n_steps, dtype=np.int32)
    ctx.meta.commit(slots_flat, pos, np.full(n_steps, seq_id, np.int32))
    cell_pos, cell_seq = ctx.meta.device_view(ctx.n_vis_for_span(), dev)
    out, _ = generate_loop(
        ctx.params, ctx.cfg, ctx.cache, cell_pos, cell_seq, first,
        torch.tensor([n_prompt], dtype=torch.int32, device=dev),
        torch.tensor([seq_id], dtype=torch.int32, device=dev),
        torch.from_numpy(slots_flat.reshape(n_steps, 1)).to(dev), n_steps, sp)
    return [int(first[0])] + [int(t) for t in out[:, 0].cpu().numpy()][:-1]
