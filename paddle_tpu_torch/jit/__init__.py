"""``paddle.jit`` of the port: whole-step capture as a CUDA graph
(``capture_step``, ``CapturedStep``, ``HostStateWriteError``), under the
JAX package's names. ``to_static`` is not ported."""

from ..core.step_capture import (CapturedStep, HostStateWriteError,
                                 capture_step)

__all__ = ["CapturedStep", "HostStateWriteError", "capture_step"]
