"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

It mirrors ``paddle_tpu``'s module names. The serving slice is ported:
Llama (``models.llama``) served by the continuous-batching engine
(``serving.Engine``) over the paged KV pool, with hand-written Hopper
kernels for flash-attention prefill (``ops.flash_attention``) and paged
decode attention (``ops.paged_attention``). It imports neither JAX nor
``paddle_tpu``. Entry points run on ``cuda`` unless given ``device="cpu"``.
"""

from .device import NoDeviceError, resolve_device

__all__ = ["NoDeviceError", "resolve_device"]
