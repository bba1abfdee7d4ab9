"""uint32 arithmetic in int64 tensors, shared by the plain versions of the
kernels' hashes (B0's keep mask, the int8-AdamW rounding bits)."""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for ``h`` in [0, 2^32) held in int64, in two
    16-bit halves of ``c`` so that no product leaves int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32
