"""The RPC wire framing: the port's copy of ``send_msg`` / ``recv_msg`` of
``paddle_tpu/distributed/rpc.py``, byte for byte the same frames, so either
package reads the other's.

A frame is ``<u64 little-endian length> <32-byte HMAC-SHA256> <payload>``;
the length counts the MAC and the payload, and the MAC is keyed by a
secret both ends share. The serving fleet hands its secret to each worker
process through the environment, never over the wire, and its payloads are
pickles: a frame that fails authentication is refused before anything is
unpickled. Trust model as the JAX package's: pickles run code at the
receiver, so both ends belong to one job and listen on loopback.

The rendezvous store and the ``init_rpc`` / ``rpc_sync`` / ``rpc_async`` /
``shutdown`` surface of the JAX module are not ported yet; without
``init_rpc`` there is no job secret, so every call here names its own.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import socket
import struct
from typing import Optional

__all__ = ["RpcTransportError", "send_msg", "recv_msg"]

_MAC_LEN = 32  # sha256 digest


class RpcTransportError(ConnectionError):
    """The request never completed at the transport layer (a dial, read or
    write failure, a peer that died). Distinct from a server-side
    exception, which comes back with its original type, so a failover
    retries only transport failures instead of re-running calls the
    server already ran and answered with an error."""


def _mac(payload: bytes, secret: Optional[bytes]) -> bytes:
    if not secret:
        raise RuntimeError("rpc framing needs a secret (no job secret: "
                           "init_rpc is not ported)")
    return _hmac.new(secret, payload, hashlib.sha256).digest()


def send_msg(sock: socket.socket, payload: bytes,
             secret: Optional[bytes] = None) -> None:
    """One length-prefixed, MAC'd frame."""
    payload = _mac(payload, secret) + payload
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def recv_msg(sock: socket.socket, secret: Optional[bytes] = None) -> bytes:
    """Inverse of :func:`send_msg`: reads one frame and verifies its MAC.
    A peer hanging up mid-frame raises ``ConnectionError`` as soon as the
    kernel reports the closed stream, never a silent short read."""
    header = b""
    while len(header) < 8:
        chunk = sock.recv(8 - len(header))
        if not chunk:
            raise ConnectionError("rpc peer closed")
        header += chunk
    (n,) = struct.unpack("<Q", header)
    if n < _MAC_LEN:
        raise ConnectionError("rpc message too short to be authenticated")
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("rpc peer closed mid-message")
        buf.extend(chunk)
    mac, payload = bytes(buf[:_MAC_LEN]), bytes(buf[_MAC_LEN:])
    if not _hmac.compare_digest(mac, _mac(payload, secret)):
        raise ConnectionError("rpc message failed authentication")
    return payload
