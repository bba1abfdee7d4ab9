"""Native kernels of the port: CUDA C++ sources under ``csrc/``, built with
``nvcc`` on first use and bound through ``ctypes`` (see ``build.py``)."""

from . import build
from .build import LaunchCounter, check, load, recorded_launches

__all__ = ["LaunchCounter", "build", "check", "load", "recorded_launches"]
