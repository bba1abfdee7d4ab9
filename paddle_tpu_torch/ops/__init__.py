"""Ops of the port: the Hopper kernels (flash attention and its variants,
paged decode attention, int8 and multi-tensor AdamW, the fused small ops
K1-K9 and the batch norm K10) and the functional ops around them
(``nn_ops``, ``loss_ops``, ``activation``, ``manipulation``,
``conv_pool``)."""
