"""Carry a ``paddle_tpu`` model's parameters into the port.

Both packages use the same state-dict keys and the same layouts (paddle's
``Linear`` weight is ``(in, out)`` in both), so conversion is a copy of each
array: no transpose, no renaming. That holds for Llama and for ERNIE
(``ernie.encoder.layers.<i>.self_attn.q_proj.weight``, ...), whose
``state_dict_from_paddle_tpu`` output loads with ``strict=True``, and for
``incubate``'s layers (``FusedLinear``, ``FusedFeedForward``,
``FusedMultiHeadAttention`` with its ``(E, 3E)`` ``qkv`` weight,
``FusedTransformerEncoderLayer`` under ``inner.``,
``FusedBiasDropoutResidualLayerNorm``), and for the Mixture-of-Experts
layers (``MoELayer``: ``gate.gate_proj.weight`` and ``experts.{i}.*``, the
experts' own keys; ``FusedEcMoe``: ``w0`` ``(E, H, I)``, ``b0`` ``(E, 1,
I)``, ``w1`` ``(E, I, H)``, ``b1`` ``(E, 1, H)``): a JAX layer's
``state_dict`` as numpy arrays loads into the port's layer. A ``scan_layers=True`` Llama of
the JAX package stacks its decoder layers into ``model.scan_<name>`` arrays of
shape ``(L, ...)``; :func:`scan_to_layered_state_dict` splits them into the
per-layer keys the port uses, and :func:`layered_to_scan_state_dict` stacks
them back (the port's copies of the JAX package's converters).
:func:`fmt_state_dict_from_paddle_tpu` does the same for a
``FusedMultiTransformer`` (keys ``l{i}_{tag}``, qkv ``(3, H, D, E)`` in
both) and, given them, the embedding, final LayerNorm and head of the
serving stack built around it (``tools/fmt_stack.py``), after checking
that every layer carries every tag in a consistent shape.
:func:`load_resnet_state_dict` carries a ``paddle_tpu`` ResNet's state
dict (numpy arrays: the weights, biases and every BN's ``_mean`` and
``_variance``) into the port's ResNet key for key, after checking that
the keys are the model's own and every shape matches; the BN buffers stay
fp32 whatever the parameters' dtype. :func:`load_ppyoloe_state_dict` does
the same for a ``paddle_tpu`` PP-YOLOE (``backbone.stem.0.conv.weight``,
..., ``head.pred_reg.2.bias``): both keep the convolution weight as
``(out, in / groups, kh, kw)`` whatever the data format, so each array is
copied as it is.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["fmt_state_dict_from_paddle_tpu", "layered_to_scan_state_dict",
           "load_ppyoloe_state_dict", "load_resnet_state_dict",
           "scan_to_layered_state_dict",
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


def _load_exact(model, np_state: Mapping[str, np.ndarray], what: str
                ) -> None:
    own = model.state_dict()
    if set(np_state) != set(own):
        raise ValueError(
            f"not this {what}'s state dict: missing "
            f"{sorted(set(own) - set(np_state))[:4]}, extra "
            f"{sorted(set(np_state) - set(own))[:4]}")
    missing, unexpected = model.set_state_dict(
        state_dict_from_paddle_tpu(np_state))
    assert not missing and not unexpected


def load_resnet_state_dict(model, np_state: Mapping[str, np.ndarray]
                           ) -> None:
    """Load a ``paddle_tpu`` ResNet state dict (numpy values) into the
    port's ``model`` (``vision.models.ResNet``): each parameter takes the
    array in its own dtype, each BN buffer in fp32. Raises ``ValueError``
    where the keys differ from the model's or a shape does not match."""
    _load_exact(model, np_state, "ResNet")


def load_ppyoloe_state_dict(model, np_state: Mapping[str, np.ndarray]
                            ) -> None:
    """Load a ``paddle_tpu`` PP-YOLOE state dict (numpy values: the
    weights, biases and every BN's ``_mean`` / ``_variance``) into the
    port's ``models.PPYOLOE`` key for key. Raises ``ValueError`` on a
    missing or unexpected key or a shape that does not match."""
    _load_exact(model, np_state, "PP-YOLOE")


def fmt_state_dict_from_paddle_tpu(fmt: Mapping[str, np.ndarray], *,
                                   embed: Mapping = None,
                                   final_ln: Mapping = None,
                                   head: Mapping = None
                                   ) -> Dict[str, torch.Tensor]:
    """A ``paddle_tpu`` ``FusedMultiTransformer`` state dict (numpy
    values) to the port's layer; with ``embed``, ``final_ln`` and ``head``
    (the state dicts of the stack's ``nn.Embedding``, ``nn.LayerNorm`` and
    bias-free ``nn.Linear``), to the whole serving stack, the layer's keys
    under ``fmt.``. Raises ``ValueError`` on a missing, extra or
    misshapen layer key."""
    from .incubate.nn import _FMT_TAGS
    layers = sorted({int(m.group(1)) for k in fmt
                     if (m := re.match(r"l(\d+)_", k))})
    want = {f"l{i}_{t}" for i in range(len(layers)) for t in _FMT_TAGS}
    if set(fmt) != want:
        raise ValueError(f"not a FusedMultiTransformer state dict: missing "
                         f"{sorted(want - set(fmt))[:4]}, extra "
                         f"{sorted(set(fmt) - want)[:4]}")
    three, h, d, e = np.shape(fmt["l0_qkv_w"])
    shapes = {"qkv_w": (3, h, d, e), "qkv_b": (3, h, d), "out_w": (e, e)}
    for i in layers:
        for tag, shape in shapes.items():
            if tuple(np.shape(fmt[f"l{i}_{tag}"])) != shape or three != 3:
                raise ValueError(f"l{i}_{tag} has shape "
                                 f"{tuple(np.shape(fmt[f'l{i}_{tag}']))}, "
                                 f"want {shape}")
    out = state_dict_from_paddle_tpu(fmt)
    parts = {"embed": embed, "final_ln": final_ln, "head": head}
    if all(v is None for v in parts.values()):
        return out
    if any(v is None for v in parts.values()):
        raise ValueError("pass embed, final_ln and head together")
    out = {f"fmt.{k}": v for k, v in out.items()}
    for name, sd in parts.items():
        out.update({f"{name}.{k}": v
                    for k, v in state_dict_from_paddle_tpu(sd).items()})
    return out


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
