"""Device resolution for the port.

The port runs on a CUDA card. An entry point given no device runs on
``cuda`` and raises when there is none: it never carries on quietly on the
CPU, whose plain PyTorch versions of the kernels are for tests. Pass
``device="cpu"`` to ask for them explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "NoDeviceError"]


class NoDeviceError(RuntimeError):
    """No CUDA card, and the caller did not ask for the CPU."""


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. A CUDA device (given or implied) must exist;
    ``"cpu"`` is returned as asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
