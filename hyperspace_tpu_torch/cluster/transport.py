"""Length-framed TCP transport of the serving cluster (counterpart of
``hyperspace_tpu/cluster/transport.py``).

An 8-byte big-endian length, then a pickled payload; one request and one
response a connection. The accept loop and each accepted connection run on
``parallel/io.spawn_daemon`` threads. Requests are dicts with an ``op``
key; a handler's error comes back as ``{"ok": False, "error": ...}``, so a
sick worker degrades its caller instead of wedging it. Payloads are host
data only (numpy arrays, CPU tensors, plain objects): nothing on a card
is pickled.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Any, Callable

from ..parallel import io as pio
from ..robustness import retry

_HEADER = struct.Struct(">Q")
# A frame past this is a corrupt header, not data: it must not drive a
# huge read.
MAX_FRAME_BYTES = 1 << 31


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("cluster transport: peer closed mid-frame")
        buf += chunk
    return bytes(buf)


def send_obj(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HEADER.pack(len(payload)) + payload)


def recv_obj(sock: socket.socket) -> Any:
    (length,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if length > MAX_FRAME_BYTES:
        raise ConnectionError(f"cluster transport: frame of {length} bytes over the cap")
    return pickle.loads(_recv_exact(sock, length))


def send_request(host: str, port: int, obj: Any, *, timeout_s: float = 2.0,
                 attempts: int = 1, session=None) -> Any:
    """One framed round trip. ``timeout_s`` bounds every socket operation
    of each attempt; with ``attempts`` > 1 transient socket errors retry
    with backoff, and the first error raises once they run out."""

    def _once() -> Any:
        with socket.create_connection((host, port), timeout=timeout_s) as sock:
            sock.settimeout(timeout_s)
            send_obj(sock, obj)
            return recv_obj(sock)

    if attempts <= 1:
        return _once()
    return retry.call(_once, where="cluster.transport",
                      policy=retry.RetryPolicy(max_attempts=attempts), session=session)


class Server:
    """An accept loop and one daemon thread a connection, over one handler.

    ``handler(request) -> response`` runs on the connection's thread, so a
    blocking op (the gather hub waiting for every rank) stalls only its own
    connection. The constructor binds and returns at once; ``self.port`` is
    the bound port. ``stop()`` closes the listener; connections in flight
    finish on their own threads."""

    def __init__(self, bind: str, port: int, handler: Callable[[Any], Any], *,
                 name: str = "cluster"):
        self._handler = handler
        self._name = name
        self._stopped = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind((bind, port))
            self._listener.listen(64)
        except BaseException:
            self._listener.close()
            raise
        self.host, self.port = self._listener.getsockname()[:2]
        pio.spawn_daemon(f"hst-{name}-accept", self._accept_loop)

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # the listener closed
            pio.spawn_daemon(f"hst-{self._name}-conn", lambda c=conn: self._serve_one(c))

    def _serve_one(self, conn: socket.socket) -> None:
        try:
            with conn:
                conn.settimeout(300.0)
                request = recv_obj(conn)
                try:
                    response = self._handler(request)
                except Exception as e:
                    response = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                send_obj(conn, response)
        except Exception:
            pass  # a torn connection is the peer's to handle

    def stop(self) -> None:
        self._stopped.set()
        # shutdown() first: close() alone does not wake a thread blocked in
        # accept(), and the port keeps listening until that call returns.
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass

