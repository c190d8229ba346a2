"""Weight transfer from the JAX package's params to the port's.

``params_from_numpy(tree, device)`` takes the JAX package's nested params
dict with every array already ``np.asarray``'d.  A QTensor (W4 or W8 fold,
plain or precise, or Q8F) arrives as any object (or dict) carrying the JAX field names;
the port never imports the JAX class.  Both sides then compute on identical
weights, which is what the parity tests need.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from llama_kotlin_tpu_torch.device import DeviceLike, resolve_device
from llama_kotlin_tpu_torch.quant.fold import (compact_from_jax_aux,
                                               compact_planes)
from llama_kotlin_tpu_torch.quant.formats import GGMLQuantType
from llama_kotlin_tpu_torch.quant.qtensor import QTensor


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name, None)


def _is_qtensor(obj) -> bool:
    if isinstance(obj, dict):
        return "codes" in obj and "g_scale" in obj
    return hasattr(obj, "codes") and hasattr(obj, "g_scale")


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)  # ml_dtypes bf16 holds exactly in f32
    t = torch.from_numpy(np.array(a, copy=True))  # owned, writable
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def _int8_from_numpy(obj, aux: dict, dev) -> QTensor:
    """A JAX W8 fold, plain or precise (its transposed ``scw`` plane is
    g_scale again, so it is dropped) or Q8F tensor -> the port's layout."""
    gs = int(_field(obj, "group_size"))
    if "scw" in aux and gs in (16, 32):
        flavor = "w8x" if "precise" in aux else "w8"
    elif not aux and gs == 256 and _field(obj, "g_min") is None \
            and _field(obj, "sb_scale") is None:
        flavor = "q8f"
    else:
        raise ValueError(f"unrecognised 8-bit layout (group {gs}, aux {sorted(aux)})")
    g_min = _field(obj, "g_min")
    return QTensor(codes=_tensor(_field(obj, "codes"), dev, torch.int8),
                   g_scale=_tensor(_field(obj, "g_scale"), dev, torch.float32),
                   g_min=None if g_min is None else _tensor(g_min, dev, torch.float32),
                   sb_scale=None, sb_min=None, qtype=GGMLQuantType(int(_field(obj, "qtype"))),
                   bits=8, group_size=gs, code_offset=int(_field(obj, "code_offset")),
                   shape=tuple(int(v) for v in _field(obj, "shape")), aux={"flavor": flavor})


def qtensor_from_numpy(obj, device: DeviceLike = None) -> QTensor:
    """One JAX-side served QTensor (numpy leaves: a W4 or W8 fold, plain or
    precise, or Q8F) -> the port's QTensor."""
    dev = resolve_device(device)
    aux = dict(_field(obj, "aux") or {})
    if _field(obj, "bits") == 8 and not _field(obj, "hi_signed"):
        return _int8_from_numpy(obj, aux, dev)
    if (not _field(obj, "hi_signed") or _field(obj, "bits") != 4
            or _field(obj, "group_size") != 32):
        raise ValueError("the port serves the W4 fold (hi_signed, 4-bit, group 32), "
                         "the W8 fold and Q8F")
    codes = _tensor(_field(obj, "codes"), dev)
    g_scale = _tensor(_field(obj, "g_scale"), dev, torch.float32)
    g_min = _tensor(_field(obj, "g_min"), dev, torch.float32)
    if "precise" in aux and ("sym" in aux or "madj_t" in aux):
        # W4X: the f32 g_scale/g_min planes carry over bit for bit
        new_aux = {"flavor": "w4x_sym" if "sym" in aux else "w4x"}
    elif "precise" in aux:
        raise ValueError(f"unrecognised W4X aux planes {sorted(aux)}")
    elif "q6_t" in aux:
        sc6, m6, d, dmin = compact_from_jax_aux(aux["q6_t"], aux["dd_t"])
        new_aux = dict(compact_planes(_tensor(sc6, dev), _tensor(m6, dev),
                                      _tensor(d, dev), _tensor(dmin, dev)),
                       flavor="compact")
    elif "sym" in aux:
        new_aux = {"flavor": "sym"}
    elif "madj_t" in aux:
        new_aux = {"flavor": "legacy"}
    else:
        raise ValueError(f"unrecognised W4 aux planes {sorted(aux)}")
    return QTensor(codes=codes, g_scale=g_scale, g_min=g_min, sb_scale=None,
                   sb_min=None, qtype=GGMLQuantType(int(_field(obj, "qtype"))),
                   bits=4, group_size=32, code_offset=int(_field(obj, "code_offset")),
                   shape=tuple(int(v) for v in _field(obj, "shape")),
                   hi_signed=True, aux=new_aux)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dict/list of numpy arrays and QTensors -> the port's params:
    QTensors become port QTensors, arrays become f32 torch tensors."""
    dev = resolve_device(device)
    if tree is None:
        return None
    if _is_qtensor(tree):
        return qtensor_from_numpy(tree, dev)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dev) for v in tree)
    if isinstance(tree, (int, float, bool, str)):
        return tree
    return _tensor(tree, dev, torch.float32)
