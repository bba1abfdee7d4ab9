"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

It mirrors ``paddle_tpu``'s module names. Ported: Llama
(``models.llama``) served by the continuous-batching engine
(``serving.Engine``) over the paged KV pool and trained eagerly, and
ERNIE 3.0 (``models.ernie``) trained for sequence classification, on
hand-written Hopper kernels for flash attention (``ops.flash_attention``,
with segment ids and in-kernel dropout), paged decode attention
(``ops.paged_attention``) and the int8 AdamW update (``ops.q8_adam``). It imports neither JAX nor
``paddle_tpu``. Entry points run on ``cuda`` unless given ``device="cpu"``.
"""

from .device import NoDeviceError, resolve_device

__all__ = ["NoDeviceError", "resolve_device"]
