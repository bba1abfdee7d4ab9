"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

It mirrors ``paddle_tpu``'s module names. Ported: Llama
(``models.llama``) served by the continuous-batching engine
(``serving.Engine``) over the paged KV pool and trained eagerly, and
ERNIE 3.0 (``models.ernie``) trained for sequence classification, on
hand-written Hopper kernels for flash attention (``ops.flash_attention``,
with segment ids and in-kernel dropout), paged decode attention
(``ops.paged_attention``), the int8 and multi-tensor AdamW updates
(``ops.q8_adam``, ``ops.multi_tensor_adam``) and the fused small ops
(``ops.fused_norm``, ``ops.rope``, ``ops.swiglu``,
``ops.softmax_cross_entropy`` and the embedding, bias-activation,
dropout and masked-softmax kernels, under ``incubate``'s fused functions).
``incubate.FusedMultiTransformer`` with ``masked_multihead_attention``,
the fused inference stack, is served by the same engine
(``tools/fmt_stack.py``). ``vision.models``' ResNets train on ``nn``'s
paddle layers (``nn.Layer``, ``Conv2D``, ``BatchNorm2D``, the pools) with
every batch norm on the batch-norm kernel (``ops.batch_norm``) and the
convolutions and pools of ``ops.conv_pool``. It imports neither JAX nor
``paddle_tpu``. Entry points run on ``cuda`` unless given
``device="cpu"``.
"""

from .device import NoDeviceError, resolve_device

__all__ = ["NoDeviceError", "flops", "resolve_device"]


def __getattr__(name: str):
    # ``paddle.flops``, imported on first use (it loads the layers)
    if name == "flops":
        from .flops_counter import flops
        return flops
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
