"""``Linear``, ``Embedding`` and ``Dropout`` with paddle's parameter
layouts, so a ``paddle_tpu`` state dict loads key for key and shape for
shape; ``DropoutRNG``, the random streams a model hands its dropouts."""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_ops
from ..ops._u32 import M32, derive_seed

__all__ = ["Dropout", "DropoutRNG", "Embedding", "Linear", "recording_draws"]


class Linear(nn.Module):
    """``y = x @ W (+ b)`` with ``W`` of shape ``(in_features,
    out_features)`` (paddle's layout, not ``torch.nn.Linear``'s). Built on
    ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias_attr: bool = True, device=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias: Optional[nn.Parameter] = nn.Parameter(torch.zeros(
            out_features, device=device, dtype=dtype)) if bias_attr else None

    def reset_parameters(self, generator: torch.Generator,
                         std: float = 0.02) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Lookup table ``(num_embeddings, embedding_dim)``; ``device`` as for
    :class:`Linear`. With ``padding_idx`` that row starts at 0 and its
    lookups give 0 (so it takes no gradient), as in the JAX package."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, device=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.padding_idx = padding_idx
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx].zero_()

    def reset_parameters(self, generator: torch.Generator,
                         std: float = 0.02) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            if self.padding_idx is not None:
                self.weight[self.padding_idx].zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.embedding(x, self.weight, self.padding_idx)


class DropoutRNG:
    """The random stream of one model's dropouts, from ``seed``: every
    dropout seed, hidden (:class:`Dropout`, the hashed masks of
    ``ops/dropout.py``) and attention (the keep mask B0 of the flash
    kernels), comes from device state, ``seed_t`` (the base seed) and
    ``counter``: :meth:`next_seed` derives one seed on the device and
    advances the counter in-stream, with no host read. Eager and captured
    steps then draw the same sequence of seeds, and a graph replay fresh
    ones. The counterpart of the JAX package's global generator, owned by
    the model instead."""

    def __init__(self, device=None, seed: int = 0):
        dev = resolve_device(device)
        self.seed_t = torch.tensor(int(seed) & M32, dtype=torch.int64,
                                   device=dev)
        self.counter = torch.zeros((), dtype=torch.int64, device=dev)

    def note_draw(self) -> None:
        """Tell an open :func:`recording_draws` that this RNG is drawn
        from (``next_seed`` calls it)."""
        log = getattr(_draws, "log", None)
        if log is not None and self not in log:
            log[self] = self.counter.clone() if _draws.keep else None

    def next_seed(self) -> torch.Tensor:
        """The next dropout seed, a 0-d int64 tensor in [0, 2^32)
        on the device (``ops._u32.derive_seed`` of the base seed and the
        counter), after which ``counter`` advances by one."""
        self.note_draw()
        s = derive_seed(self.seed_t, self.counter)
        self.counter.add_(1)
        return s


_draws = threading.local()


@contextlib.contextmanager
def recording_draws(keep_counters: bool = False
                    ) -> Iterator[Dict[DropoutRNG, Optional[torch.Tensor]]]:
    """Record the ``DropoutRNG`` objects drawn from in this region (on this
    thread): yields a dict from each to a copy of its ``counter`` from
    before its first draw here (``keep_counters``; else None). A captured
    step registers these generators with its graph and keeps the objects,
    and its NaN gate puts these counters back."""
    prev = getattr(_draws, "log", None), getattr(_draws, "keep", False)
    log: Dict[DropoutRNG, Optional[torch.Tensor]] = {}
    _draws.log, _draws.keep = log, keep_counters
    try:
        yield log
    finally:
        _draws.log, _draws.keep = prev


class Dropout(nn.Module):
    """``paddle.nn.Dropout`` (``upscale_in_train``): ``nn_ops.dropout`` in
    training mode, the identity in eval mode; each call's seed drawn from
    ``rng.next_seed()`` (a model's ``DropoutRNG``; by default one of its
    own on ``device``, which is ``cuda`` unless ``device="cpu"``)."""

    def __init__(self, p: float = 0.5, rng: Optional[DropoutRNG] = None,
                 device=None):
        super().__init__()
        self.p = p
        self.rng = rng if rng is not None else DropoutRNG(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.dropout(x, self.p, self.training, generator=self.rng)

    def extra_repr(self) -> str:
        return f"p={self.p}"
