"""Carry a ``paddle_tpu`` model's parameters into the port.

Both packages use the same state-dict keys and the same layouts (paddle's
``Linear`` weight is ``(in, out)`` in both), so conversion is a copy of each
array: no transpose, no renaming. That holds for Llama and for ERNIE
(``ernie.encoder.layers.<i>.self_attn.q_proj.weight``, ...), whose
``state_dict_from_paddle_tpu`` output loads with ``strict=True``. A ``scan_layers=True`` Llama of the JAX
package stacks its decoder layers into ``model.scan_<name>`` arrays of
shape ``(L, ...)``; :func:`scan_to_layered_state_dict` splits them into the
per-layer keys the port uses, and :func:`layered_to_scan_state_dict` stacks
them back (the port's copies of the JAX package's converters).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["layered_to_scan_state_dict", "scan_to_layered_state_dict",
           "state_dict_from_paddle_tpu"]


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16, which numpy can't hand torch
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def state_dict_from_paddle_tpu(np_state: Mapping[str, np.ndarray]
                               ) -> Dict[str, torch.Tensor]:
    """``{key: array}`` from a ``paddle_tpu`` state dict (its values as
    numpy arrays) to ``{key: tensor}`` for ``load_state_dict`` of the
    port's counterpart module."""
    return {k: _to_tensor(v) for k, v in np_state.items()}


def _decoder_layer_keys() -> Dict[str, str]:
    """``{flattened: dotted}`` for every state key of the port's decoder
    layer, read from the layer itself (a scan key flattens '.' to '_')."""
    from .models.llama import LlamaConfig, LlamaDecoderLayer
    layer = LlamaDecoderLayer(LlamaConfig.tiny(), device="cpu",
                              dtype=torch.float32)
    return {k.replace(".", "_"): k for k in layer.state_dict()}


def scan_to_layered_state_dict(sd: Mapping) -> Dict:
    """Split stacked ``[prefix.]scan_<name>`` entries (leaves ``(L, ...)``)
    into ``[prefix.]layers.<i>.<dotted name>``; other keys pass through.
    Values may be numpy arrays or tensors."""
    names = _decoder_layer_keys()
    out = {}
    for k, v in sd.items():
        if ".scan_" not in k and not k.startswith("scan_"):
            out[k] = v
            continue
        prefix, flat = (k.split(".scan_", 1) if ".scan_" in k
                        else ("", k[len("scan_"):]))
        if flat not in names:
            raise ValueError(f"unrecognized scan-stacked key {k!r}: not a "
                             f"LlamaDecoderLayer state entry")
        layers = f"{prefix}.layers" if prefix else "layers"
        for i in range(v.shape[0]):
            out[f"{layers}.{i}.{names[flat]}"] = v[i]
    return out


def layered_to_scan_state_dict(sd: Mapping, num_layers: int) -> Dict:
    """Inverse of :func:`scan_to_layered_state_dict`: stack
    ``[prefix.]layers.<i>.<name>`` into ``[prefix.]scan_<name>``."""
    out, groups = {}, {}
    for k, v in sd.items():
        m = re.match(r"(?:(.*)\.)?layers\.(\d+)\.(.+)$", k)
        if m is None:
            out[k] = v
            continue
        groups.setdefault((m.group(1) or "", m.group(3)), {})[
            int(m.group(2))] = v
    for (prefix, name), per_layer in groups.items():
        if sorted(per_layer) != list(range(num_layers)):
            raise ValueError(f"layer group {name!r} has {len(per_layer)} of "
                             f"{num_layers} layers")
        vals = [per_layer[i] for i in range(num_layers)]
        stacked = torch.stack(vals) if isinstance(vals[0], torch.Tensor) \
            else np.stack(vals)
        key = f"scan_{name.replace('.', '_')}"
        out[f"{prefix}.{key}" if prefix else key] = stacked
    return out
