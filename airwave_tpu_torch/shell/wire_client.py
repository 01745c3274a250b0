"""Wire-protocol client for the render server.

The port's own copy of airwave_tpu/shell/wire_client.py, byte for byte the
same protocol, so either package's client talks to either package's
server. It imports only numpy and the standard library, so deployment
smoke checks (the `client` subcommand) run on boxes with no torch or CUDA
stack; the server side (shell/serve.py) owns the pool and the device. The
protocol is defined in shell/serve.py's module docstring.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Optional

import numpy as np

_LEN = struct.Struct("<I")


def _read_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    while n > 0:
        data = conn.recv(min(n, 1 << 16))
        if not data:
            return None
        chunks.append(data)
        n -= len(data)
    return b"".join(chunks)


def _send_frame(conn: socket.socket, audio: np.ndarray) -> None:
    payload = np.ascontiguousarray(audio.T, np.float32).tobytes()
    conn.sendall(_LEN.pack(audio.shape[1]) + payload)


def render_via_server(address, audio: np.ndarray,
                      chunk: int = 1024, group: int = 0,
                      resume: Optional[int] = None,
                      resume_token: Optional[str] = None,
                      on_lane=None) -> np.ndarray:
    """Reference client: stream [C, n] audio, return rendered [2, n].

    `group` selects the profile group on a grouped (multi-tenant) pool.
    `resume=LANE` + `resume_token=SECRET` reclaims a restart-orphan lane
    on a checkpoint-restored server (the stream's DSP history continues).
    `on_lane` (callable) requests the lane ack and receives
    {"lane": N, "token": SECRET} — checkpoint both to resume after a
    server restart."""
    channels, total = audio.shape
    conn = socket.create_connection(address, timeout=30)
    try:
        header = {"channels": channels}
        if group:
            header["group"] = group
        if resume is not None:
            header["resume"] = int(resume)
            if resume_token is not None:
                header["token"] = str(resume_token)
        if on_lane is not None:
            header["want_lane"] = True
        conn.sendall(json.dumps(header).encode() + b"\n")
        if on_lane is not None:
            line = b""
            while not line.endswith(b"\n"):
                piece = conn.recv(1)
                if not piece:
                    raise ConnectionError("server closed before lane ack")
                line += piece
            on_lane(json.loads(line.decode()))
        rendered = []
        clean_eof = [False]

        def reader():
            while True:
                raw = _read_exact(conn, _LEN.size)
                if raw is None:
                    return
                (n,) = _LEN.unpack(raw)
                if n == 0:
                    clean_eof[0] = True
                    return
                payload = _read_exact(conn, n * 2 * 4)
                if payload is None:
                    return
                rendered.append(
                    np.frombuffer(payload, "<f4").reshape(n, 2).T
                )

        thread = threading.Thread(target=reader, daemon=True)
        thread.start()
        send_err = None
        try:
            for start in range(0, total, chunk):
                piece = np.ascontiguousarray(audio[:, start:start + chunk])
                conn.sendall(
                    _LEN.pack(piece.shape[1])
                    + piece.T.astype("<f4").tobytes()
                )
            conn.sendall(_LEN.pack(0))
        except OSError as err:
            # Peer closed / connection failed mid-send (the exact
            # exception varies by platform: BrokenPipe, ConnectionReset,
            # ConnectionAborted, EPROTOTYPE...). If the server's clean
            # EOF frame arrived (a deliberate protocol rejection), return
            # what was rendered; otherwise this is a genuine failure —
            # re-raise below rather than silently returning a truncated
            # render.
            send_err = err
        thread.join(timeout=30)
        if send_err is not None and not clean_eof[0]:
            raise send_err
        return (np.concatenate(rendered, axis=1)
                if rendered else np.zeros((2, 0), np.float32))
    finally:
        conn.close()
