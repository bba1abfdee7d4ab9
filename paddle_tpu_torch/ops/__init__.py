"""Ops of the port: the Hopper kernels (flash attention and its variants,
paged decode attention, int8 AdamW) and the functional nn ops around
them."""
