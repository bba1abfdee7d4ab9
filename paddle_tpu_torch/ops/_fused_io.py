"""What the wrappers of the fused small-op kernels share (``fused_norm``,
``rope``, ``swiglu``, ``softmax_cross_entropy``, ...): the dtype codes of
their C entry points, the device check, the test that lets them read
16-byte vectors and the multiply-high divider of their launch plans. The
paged decode wrapper takes its route by :func:`plain_path` too."""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dtype_code(dtype: Optional[torch.dtype], what: str) -> int:
    """The kernels' code of a float dtype (0 when absent)."""
    if dtype is None:
        return 0
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"{what}: the kernel takes float32, bfloat16 or "
                        f"float16, got {dtype}")
    return code


def cuda_device(what: str, *ts: Optional[torch.Tensor]) -> torch.device:
    """The one CUDA device of the given tensors (Nones skipped), or raise:
    a tensor that is not on the CPU reaches a kernel, never a plain
    version."""
    xs = [t for t in ts if t is not None]
    dev = xs[0].device
    if dev.type != "cuda" or any(t.device != dev for t in xs):
        raise ValueError(f"{what}: tensors must share one CUDA device, got "
                         f"{sorted({str(t.device) for t in xs})}")
    return dev


def plain_path(t: torch.Tensor) -> bool:
    """Whether a wrapper runs its plain version: for a CPU tensor only."""
    return t.device.type == "cpu"


@functools.cache
def divider(n: int) -> Tuple[int, int]:
    """``(magic, shift)`` with ``(v * magic) >> (31 + shift) == v // n`` for
    every ``0 <= v < 2^31``: ``shift = ceil(log2 n)``, ``magic =
    ceil(2^(31 + shift) / n)`` (below 2^32). The product's excess over
    ``v / n`` is under ``v / 2^(31 + shift) < 1 / n``, so the floor holds."""
    shift = (n - 1).bit_length()
    return -(-2 ** (31 + shift) // n), shift


def as_int32(v: int) -> int:
    """A value below 2^32 as the C int that carries its bits."""
    return v - 2 ** 32 if v >= 2 ** 31 else v


def aligned16(*ts: Optional[torch.Tensor]) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream
