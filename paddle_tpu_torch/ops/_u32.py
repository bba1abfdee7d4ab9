"""uint32 arithmetic in int64 tensors, shared by the plain versions of the
kernels' hashes (B0's keep mask, the int8-AdamW rounding bits), and the
seeds the kernels read from device memory."""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for ``h`` in [0, 2^32) held in int64, in two
    16-bit halves of ``c`` so that no product leaves int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def seed_term(seed, c: int, device=None):
    """``seed * c mod 2^32`` of an int seed (an int) or an integer tensor
    seed (its low 32 bits; a tensor on ``device``)."""
    if isinstance(seed, torch.Tensor):
        return mul32(seed.to(device=device, dtype=torch.int64) & M32, c)
    return ((int(seed) & M32) * c) & M32


def seed_tensor(seed, device) -> torch.Tensor:
    """``seed`` as the 0-d int64 tensor on ``device`` whose low 32 bits a
    kernel reads (an int is copied there; a tensor is reshaped, and moved
    only if it lies elsewhere)."""
    if isinstance(seed, torch.Tensor):
        t = seed.reshape(-1)[0] if seed.dim() else seed
        return t.to(device=device, dtype=torch.int64)
    return torch.tensor(int(seed) & M32, dtype=torch.int64, device=device)


def derive_seed(base: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The seed of draw ``index`` (int64 tensors on the device): ``(base +
    index * 0x9E3779B1) mod 2^32``, taken there with no host read. The
    kernels hash a seed through a full finalizer, so consecutive indices
    give unrelated streams."""
    return (index * 0x9E3779B1 + base) & M32
