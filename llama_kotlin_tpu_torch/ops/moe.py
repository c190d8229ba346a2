"""Top-k routed MoE feed-forward (port of ``llama_kotlin_tpu/ops/moe.py``):
the router's top-k, the grouped FFN over dense expert stacks and the
gathered FFN over quantized expert stacks.

JAX computes both FFN routes with XLA gathers, einsums and
``lax.ragged_dot_general``, not with a Pallas kernel, so the port's are
plain torch ops on every device, as ``models/llama.py::attend_stacked_plain``
is: bf16 operands, products summed in f32.  The third route, the sweep
over per-expert matrices (``models/llama.py::_moe_sweep``), runs each
expert through ``ops/qmatmul.py`` and so through the kernels.

* ``moe_grouped_ffn`` (JAX ``:55-86``): dense stacks [E, n, k] of a float
  file.  The slots sort by expert and each expert's contiguous group takes
  its weights, as ``ragged_dot`` does; the group sizes come to the host
  once (a float MoE file is a test fixture, not a served model).
* ``moe_gathered_quant`` (JAX ``:98-124``): a stacked QTensor [E, ...].
  Each (token, expert) slot gathers its expert's planes, dequantizes them
  to bf16 and takes one batched product a projection: the bytes read scale
  with the routed slots, not with E.
"""

from __future__ import annotations

from typing import Callable

import torch

from llama_kotlin_tpu_torch.ops.qmatmul import dense_matmul
from llama_kotlin_tpu_torch.quant.qtensor import QTensor, dequantize


def route(router: torch.Tensor, n_used: int, norm_topk: bool, scale: float):
    """Router logits [nt, E] -> (top_w [nt, k] f32, top_i [nt, k]) as JAX's
    ``moe_ffn`` (``llama_kotlin_tpu/models/llama.py:312-318``): softmax in
    f32, the k largest, renormalized when norm_topk (Mixtral; deepseek2
    keeps the raw probabilities), times scale (deepseek2's
    expert_weights_scale)."""
    probs = torch.softmax(router.to(torch.float32), dim=-1)
    top_w, top_i = torch.topk(probs, n_used, dim=-1)
    if norm_topk:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    if scale != 1.0:
        top_w = top_w * scale
    return top_w, top_i


def _combine(y: torch.Tensor, top_w: torch.Tensor) -> torch.Tensor:
    """Slot outputs [nt * k, d] -> sum over each token's k experts, weighted."""
    nt, k = top_w.shape
    return torch.sum(top_w[..., None] * y.reshape(nt, k, -1), dim=1)


def moe_grouped_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                    w_down: torch.Tensor, top_i: torch.Tensor, top_w: torch.Tensor,
                    act: Callable) -> torch.Tensor:
    """Routed gated FFN over dense stacks (w_gate/w_up [E, f, d], w_down
    [E, d, f], bf16): x [nt, d] -> [nt, d] f32."""
    nt, k = top_i.shape
    ids = top_i.reshape(nt * k).to(torch.long)
    order = torch.argsort(ids, stable=True)  # ties keep token order, as jnp.argsort
    xs = x[order // k].to(torch.bfloat16)
    sizes = torch.bincount(ids, minlength=w_gate.shape[0]).tolist()
    y_sorted = torch.empty((nt * k, w_down.shape[1]), dtype=torch.float32, device=x.device)
    start = 0
    for e, size in enumerate(sizes):
        if size:
            xe = xs[start:start + size]
            h = act(dense_matmul(xe, w_gate[e])) * dense_matmul(xe, w_up[e])
            y_sorted[start:start + size] = dense_matmul(h.to(torch.bfloat16), w_down[e])
        start += size
    y = torch.empty_like(y_sorted)
    y[order] = y_sorted  # unsort
    return _combine(y, top_w)


def _slot_products(xs: torch.Tensor, qt: QTensor, sel: torch.Tensor) -> torch.Tensor:
    """xs [S, d] against the dequantized (bf16) weights of the experts sel
    [S]: [S, n] f32, each slot's own expert."""
    w = dequantize(qt[sel], torch.bfloat16)  # [S, n, d]
    return torch.bmm(w.to(torch.float32), xs.to(torch.float32)[:, :, None])[..., 0]


def moe_gathered_quant(x: torch.Tensor, qt_gate: QTensor, qt_up: QTensor, qt_down: QTensor,
                       top_i: torch.Tensor, top_w: torch.Tensor, act: Callable) -> torch.Tensor:
    """Routed gated FFN over quantized expert stacks: x [nt, d] -> [nt, d]
    f32, reading only the routed experts' planes."""
    nt, k = top_i.shape
    sel = top_i.reshape(nt * k).to(torch.long)
    xs = x.to(torch.bfloat16).repeat_interleave(k, dim=0)  # [S, d] slot inputs
    h = act(_slot_products(xs, qt_gate, sel)) * _slot_products(xs, qt_up, sel)
    y = _slot_products(h.to(torch.bfloat16), qt_down, sel)
    return _combine(y, top_w)
