"""Carry a ``paddle_tpu`` model's parameters into the port.

Both packages use the same state-dict keys and the same layouts (paddle's
``Linear`` weight is ``(in, out)`` in both), so conversion is a copy of each
array: no transpose, no renaming.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_paddle_tpu"]


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
