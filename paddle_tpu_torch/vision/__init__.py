"""``paddle.vision`` of the port: the ResNet family (``models``) and the
detection ops (``ops``)."""

from . import models, ops

__all__ = ["models", "ops"]
