"""Context state serialization (port of ``llama_kotlin_tpu/runtime/state.py``).

Parity target: the reference's llama_state_* API: full-context state
blobs, session files with magic/version + prompt tokens, and per-sequence
state extraction/injection.

The blobs are byte-compatible with the JAX package's in both directions:
a small struct header + an npz payload.  Float caches are stored as f32;
quantized caches (int8 codes, or packed int4 codes) store their raw code
and per-row scale planes, whose layouts equal JAX's, so a same-type
restore is bit-faithful; restoring into another cache type dequantizes
the stored form.  The port's cache has one scratch cell past ``n_cells``
(padded rows write there); a blob holds only the ``n_cells`` real ones.
Per-sequence blobs store cells sorted by position so they can be injected
into any context with free cells.
"""

from __future__ import annotations

import io
import struct

import numpy as np
import torch

from llama_kotlin_tpu_torch.runtime.kv_cache import (dequantize_cache_layer, quantize_rows,
                                                     quantize_rows_q4)

STATE_MAGIC = b"LKTS"
STATE_VERSION = 1
SESSION_MAGIC = b"LKTN"


def _pack(payload: dict, magic: bytes) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **payload)
    return magic + struct.pack("<I", STATE_VERSION) + buf.getvalue()


def _unpack(data: bytes, magic: bytes) -> dict:
    if data[:4] != magic:
        raise ValueError("bad state magic")
    (version,) = struct.unpack("<I", data[4:8])
    if version != STATE_VERSION:
        raise ValueError(f"unsupported state version {version}")
    return dict(np.load(io.BytesIO(data[8:]), allow_pickle=False))


def _np(t: torch.Tensor, dtype=None) -> np.ndarray:
    t = t if dtype is None else t.to(dtype)
    return t.cpu().numpy()


def _cache_payload(ctx) -> dict:
    """The real cells' cache planes: raw codes and scales of a quantized
    cache, f32 of a float one."""
    c, n = ctx.cache, ctx.n_cells
    if c.quantized:
        return {"kv_bits": np.int32(c.kv_bits),
                "cache_k": _np(c.k[:, :, :n]), "cache_v": _np(c.v[:, :, :n]),
                "cache_k_scale": _np(c.k_scale[:, :, :n]),
                "cache_v_scale": _np(c.v_scale[:, :, :n])}
    return {"cache_k": _np(c.k[:, :, :n], torch.float32),
            "cache_v": _np(c.v[:, :, :n], torch.float32)}


def _to_f32(codes: np.ndarray, scale: np.ndarray, bits: int) -> torch.Tensor:
    return dequantize_cache_layer(torch.from_numpy(codes), torch.from_numpy(scale), bits=bits)


def _store(ctx, cells, k, v, k_scale=None, v_scale=None) -> None:
    """Write numpy planes into the cache at cells (a slice or an index
    array along the cell axis), converted to the cache's dtypes."""
    c = ctx.cache
    for dst, src in ((c.k, k), (c.v, v), (c.k_scale, k_scale), (c.v_scale, v_scale)):
        if src is not None:
            dst[:, :, cells] = torch.from_numpy(np.ascontiguousarray(src)).to(
                device=dst.device, dtype=dst.dtype)


def _write_planes(ctx, cells, p: dict, names: tuple) -> None:
    """Restore cache planes from a blob's arrays `names` (k, v, k_scale,
    v_scale keys): raw planes into a cache of the same quantized type, else
    through f32 (dequantized when the blob is quantized, requantized with
    the port's row quantizers when the cache is)."""
    kn, vn, ksn, vsn = names
    blob_bits = int(p["kv_bits"]) if "kv_bits" in p else 0
    c = ctx.cache
    ctx_bits = c.kv_bits if c.quantized else 0
    if blob_bits and blob_bits == ctx_bits:
        _store(ctx, cells, p[kn], p[vn], p[ksn], p[vsn])
        return
    if blob_bits:
        k, v = _to_f32(p[kn], p[ksn], blob_bits), _to_f32(p[vn], p[vsn], blob_bits)
    else:
        k, v = torch.from_numpy(p[kn]), torch.from_numpy(p[vn])
    if c.quantized:
        qr = quantize_rows_q4 if c.kv_bits == 4 else quantize_rows
        (kc, ks), (vc, vs) = qr(k), qr(v)
        _store(ctx, cells, _np(kc), _np(vc), _np(ks), _np(vs))
    else:
        _store(ctx, cells, _np(k), _np(v))


def _restore_cache(ctx, p: dict) -> None:
    _write_planes(ctx, slice(0, ctx.n_cells), p,
                  ("cache_k", "cache_v", "cache_k_scale", "cache_v_scale"))


def _restore_meta(ctx, p: dict) -> None:
    ctx.meta.pos[:] = p["cell_pos"]
    ctx.meta.seq[:] = p["cell_seq"]
    # keep the allocator ring past the restored occupancy so new slots
    # extend the live span instead of fragmenting low indices (which would
    # inflate the used_span attention bucket)
    live = np.nonzero(ctx.meta.pos >= 0)[0]
    ctx.meta._next = (int(live[-1]) + 1) % ctx.meta.n_cells if live.size else 0


def _meta_dict(ctx) -> dict:
    return {"cell_pos": ctx.meta.pos.copy(), "cell_seq": ctx.meta.seq.copy(),
            **_cache_payload(ctx)}


def get_state_data(ctx) -> bytes:
    """Full context state (cf. llama_state_get_data)."""
    payload = _meta_dict(ctx)
    if ctx._logits is not None:
        payload["logits"] = _np(ctx._logits, torch.float32)
        payload["logits_rows"] = ctx._logits_rows
    return _pack(payload, STATE_MAGIC)


def _logical_shape(shape, bits: int) -> list:
    """Element shape of a cache plane (packed int4 planes are half-width)."""
    shape = list(shape)
    if bits == 4:
        shape[-1] *= 2
    return shape


def set_state_data(ctx, data: bytes) -> None:
    """Restore a full context state (cf. llama_state_set_data)."""
    p = _unpack(data, STATE_MAGIC)
    c = ctx.cache
    kshape = _logical_shape((*c.k.shape[:2], ctx.n_cells, c.k.shape[3]),
                            c.kv_bits if c.quantized else 8)
    bshape = _logical_shape(p["cache_k"].shape, int(p.get("kv_bits", 8)))
    if bshape != kshape:
        raise ValueError(
            f"cache shape mismatch: state {tuple(bshape)} vs ctx {tuple(kshape)}")
    _restore_meta(ctx, p)
    _restore_cache(ctx, p)
    if "logits" in p:
        ctx._logits = torch.from_numpy(p["logits"]).to(ctx.device)
        ctx._logits_rows = p["logits_rows"]


def save_session_file(ctx, path, tokens) -> None:
    """State + prompt tokens (cf. llama_state_save_file)."""
    payload = _meta_dict(ctx)
    payload["tokens"] = np.asarray(tokens, np.int32)
    with open(path, "wb") as f:
        f.write(_pack(payload, SESSION_MAGIC))


def load_session_file(ctx, path) -> np.ndarray:
    """Restore state; returns the stored prompt tokens."""
    with open(path, "rb") as f:
        p = _unpack(f.read(), SESSION_MAGIC)
    _restore_meta(ctx, p)
    _restore_cache(ctx, p)
    return p["tokens"]


# -- per-sequence state (cf. llama_state_seq_get_data / set_data) ------------


def get_seq_data(ctx, seq_id: int) -> bytes:
    has = ((ctx.meta.seq >> seq_id) & 1) == 1
    cells = np.nonzero(has)[0]
    order = np.argsort(ctx.meta.pos[cells], kind="stable")
    cells = cells[order].astype(np.int32)
    idx = torch.from_numpy(cells.astype(np.int64)).to(ctx.device)
    c = ctx.cache
    payload = {"pos": ctx.meta.pos[cells]}
    if c.quantized:
        payload.update(kv_bits=np.int32(c.kv_bits),
                       k=_np(c.k[:, :, idx]), v=_np(c.v[:, :, idx]),
                       k_scale=_np(c.k_scale[:, :, idx]), v_scale=_np(c.v_scale[:, :, idx]))
    else:
        payload["k"] = _np(c.k[:, :, idx], torch.float32)  # [L, KV, n, D]
        payload["v"] = _np(c.v[:, :, idx], torch.float32)
    return _pack(payload, STATE_MAGIC)


def set_seq_data(ctx, data: bytes, dest_seq: int) -> int:
    """Inject a saved sequence; returns 0 ok, 1 if not enough free cells
    (same error contract as llama_state_seq_set_data)."""
    p = _unpack(data, STATE_MAGIC)
    n = int(p["pos"].shape[0])
    slots = ctx.meta.find_slots(n)
    if slots is None:
        return 1
    ctx.meta.commit(slots, p["pos"], np.full(n, dest_seq, np.int32))
    idx = torch.from_numpy(slots.astype(np.int64)).to(ctx.device)
    _write_planes(ctx, idx, p, ("k", "v", "k_scale", "v_scale"))
    return 0
