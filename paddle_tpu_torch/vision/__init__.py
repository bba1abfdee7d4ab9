"""``paddle.vision`` of the port: the ResNet family (``models``)."""

from . import models

__all__ = ["models"]
