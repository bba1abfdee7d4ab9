"""Process-to-process plumbing of the port. So far only the wire framing of
``paddle_tpu.distributed.rpc`` (:mod:`~paddle_tpu_torch.distributed.rpc`),
which the serving fleet speaks between its supervisor and its worker
processes. The rendezvous store and the ``init_rpc`` / ``rpc_sync`` /
``rpc_async`` surface over it are not ported yet."""
