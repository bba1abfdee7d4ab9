"""The port's runtime core: whole-step capture (``step_capture``)."""

from . import step_capture

__all__ = ["step_capture"]
