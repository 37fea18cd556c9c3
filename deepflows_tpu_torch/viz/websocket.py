"""Minimal RFC 6455 WebSocket server-side support, stdlib only (the JAX
package's ``deepflows_tpu/viz/websocket.py``, copied: it imports no JAX).

The reference's viz platform uses FastAPI WebSockets
(``Visualization_backend/server.py:386-393``); the handshake and framing
here run directly over the ``http.server`` socket: enough for
server-to-client JSON pushes plus close and ping handling, which is all
the dashboard needs.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
import threading

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def perform_handshake(handler) -> bool:
    """Upgrade an http.server request to a WebSocket; returns success."""
    key = handler.headers.get("Sec-WebSocket-Key")
    if not key or handler.headers.get("Upgrade", "").lower() != "websocket":
        handler.send_response(400)
        handler.end_headers()
        return False
    handler.send_response(101, "Switching Protocols")
    handler.send_header("Upgrade", "websocket")
    handler.send_header("Connection", "Upgrade")
    handler.send_header("Sec-WebSocket-Accept", accept_key(key))
    handler.end_headers()
    return True


def encode_frame(payload: bytes, opcode: int = 0x1) -> bytes:
    header = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header += bytes([n])
    elif n < (1 << 16):
        header += bytes([126]) + struct.pack(">H", n)
    else:
        header += bytes([127]) + struct.pack(">Q", n)
    return header + payload


def read_frame(sock):
    """Read one client frame; returns (opcode, payload) or None on EOF."""

    def recv_exact(k):
        buf = b""
        while len(buf) < k:
            chunk = sock.recv(k - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    head = recv_exact(2)
    if head is None:
        return None
    opcode = head[0] & 0x0F
    masked = head[1] & 0x80
    n = head[1] & 0x7F
    if n == 126:
        ext = recv_exact(2)
        if ext is None:
            return None
        n = struct.unpack(">H", ext)[0]
    elif n == 127:
        ext = recv_exact(8)
        if ext is None:
            return None
        n = struct.unpack(">Q", ext)[0]
    mask = recv_exact(4) if masked else b"\x00" * 4
    if mask is None:
        return None
    payload = recv_exact(n) if n else b""
    if payload is None:
        return None
    if masked:
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return opcode, payload


class WSConnection:
    def __init__(self, sock):
        self.sock = sock
        self._lock = threading.Lock()
        self.alive = True

    def send_json(self, obj) -> bool:
        try:
            with self._lock:
                self.sock.sendall(encode_frame(json.dumps(obj).encode()))
            return True
        except OSError:
            self.alive = False
            return False

    def serve_reads(self):
        """Blocking read loop: answers pings, honors close."""
        try:
            while self.alive:
                frame = read_frame(self.sock)
                if frame is None:
                    break
                opcode, payload = frame
                if opcode == 0x8:  # close
                    with self._lock:
                        self.sock.sendall(encode_frame(payload, 0x8))
                    break
                if opcode == 0x9:  # ping -> pong
                    with self._lock:
                        self.sock.sendall(encode_frame(payload, 0xA))
        except OSError:
            pass
        finally:
            self.alive = False
