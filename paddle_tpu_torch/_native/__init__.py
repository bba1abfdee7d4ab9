"""Native kernels of the port: CUDA C++ sources under ``csrc/``, built with
``nvcc`` on first use and bound through ``ctypes`` (see ``build.py``)."""

from . import build
from .build import (LaunchCounter, check, io_cost, load, recorded_launches,
                    tensor_bytes)

__all__ = ["LaunchCounter", "build", "check", "io_cost", "load",
           "recorded_launches", "tensor_bytes"]
