"""Ops of the port: the two Hopper kernels of the serving path and the
functional nn ops around them."""
