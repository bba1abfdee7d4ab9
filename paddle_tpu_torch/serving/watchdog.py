"""The step watchdog under its serving import path, as
``paddle_tpu/serving/watchdog.py``: a re-export of
:mod:`paddle_tpu_torch.resilience.watchdog`."""

from __future__ import annotations

from ..resilience.watchdog import StepWatchdog, WatchdogTimeout

__all__ = ["StepWatchdog", "WatchdogTimeout"]
