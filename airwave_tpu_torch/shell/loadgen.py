"""Selector-based wire-protocol load generator: O(1000) concurrent clients
from ONE thread.

The thread-per-client reference client (wire_client.render_via_server) is
right for ops smoke checks but cannot *prove serving scale*: 1,024 client
threads would measure the harness, not the server. This module drives any
number of concurrent wire clients from a single selector event loop
(epoll on Linux) and reports the metrics the serving scale contract is
stated in: admission (connect -> lane ack) latency, per-chunk
wire-to-wire latency, completion fairness across clients, and aggregate
rendered throughput.

Load model: REALTIME-PACED streaming, the shape live audio actually has —
each client sends one `chunk`-frame message every chunk/48k seconds
(scaled by `speed`), so the server sees a steady interleaved mix rather
than one synchronized burst. Pacing also matters for protocol liveness:
the thread data plane delivers rendered audio on INBOUND messages, so a
client that stops sending until its renders arrive would deadlock against
it (wire_client blasts everything for the same reason); a paced client
always has a next send in flight.

The port's own copy of airwave_tpu/shell/loadgen.py. Stdlib and numpy
only, same discipline as wire_client: the load generator must run on ops
boxes, and in a separate PROCESS from the server under test, so
client-side work never shares the server's GIL
(`python -m airwave_tpu_torch.shell.loadgen --connect HOST:PORT ...`
prints one JSON line; chip_smoke.py drives the serving phases with it as a
subprocess).

Protocol details: shell/serve.py module docstring.
"""

from __future__ import annotations

import heapq
import itertools
import json
import selectors
import socket
import struct
import time
from typing import Optional

import numpy as np

_LEN = struct.Struct("<I")

# Client states.
_CONNECTING = 0
_AWAIT_ACK = 1
_STREAMING = 2
_AWAIT_EOF = 3
_DONE = 4
_FAILED = 5

_SAMPLE_RATE = 48_000.0


class _Client:
    __slots__ = (
        "idx", "sock", "state", "inbuf", "outbuf", "chunk_frames",
        "blocks_total", "sent_chunks", "sent_frames", "returned_frames",
        "send_times", "latencies", "t_connect", "t_ack", "t_done",
        "clean_eof", "error", "payload", "header", "lane",
    )

    def __init__(self, idx: int, chunk_frames: int, blocks_total: int,
                 payload: bytes, header: bytes) -> None:
        self.idx = idx
        self.sock: Optional[socket.socket] = None
        self.state = _CONNECTING
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.chunk_frames = chunk_frames
        self.blocks_total = blocks_total
        self.sent_chunks = 0
        self.sent_frames = 0
        self.returned_frames = 0
        self.send_times: list = []   # (cum_frames_that_close_it, t_sent)
        self.latencies: list = []
        self.t_connect = 0.0
        self.t_ack = 0.0
        self.t_done = 0.0
        self.clean_eof = False
        self.error: Optional[str] = None
        self.payload = payload       # one chunk's wire payload (reused)
        self.header = header
        self.lane = -1


def _percentiles(values, ps=(0.50, 0.90, 0.99)) -> dict:
    if not values:
        return {"count": 0}
    arr = np.sort(np.asarray(values, np.float64))
    out = {"count": int(arr.size)}
    for p in ps:
        out[f"p{int(p * 100)}_ms"] = round(
            float(arr[min(arr.size - 1, int(p * arr.size))]) * 1e3, 3
        )
    out["max_ms"] = round(float(arr[-1]) * 1e3, 3)
    return out


def run_load(
    address,
    clients: int = 64,
    blocks_each: int = 8,
    chunk: int = 512,
    channels: int = 2,
    speed: float = 1.0,
    connect_burst: int = 64,
    timeout: float = 120.0,
    amplitude: float = 0.1,
    seed: int = 0,
) -> dict:
    """Drive `clients` realtime-paced concurrent wire clients; return
    metrics.

    Each client streams `blocks_each` chunks of `chunk` frames
    (`channels`-wide f32 noise) at one chunk per chunk/48k/speed seconds,
    then EOFs and awaits the server's completion frame. New connections
    are initiated `connect_burst` at a time so admission latency reflects
    the server's accept path, not one giant SYN burst.

    Returns a dict with admission/chunk-latency percentiles (ms),
    completion counts, fairness (per-client completion wall spread), and
    the aggregate rendered realtime multiple.
    """
    rng = np.random.default_rng(seed)
    base = (rng.standard_normal((chunk, channels)) * amplitude).astype("<f4")
    payload = _LEN.pack(chunk) + base.tobytes()
    header = json.dumps({"channels": channels, "want_lane": True}).encode() \
        + b"\n"
    pace = chunk / _SAMPLE_RATE / max(speed, 1e-9)

    sel = selectors.DefaultSelector()
    todo = [
        _Client(i, chunk, blocks_each, payload, header)
        for i in range(clients)
    ]
    pending = list(reversed(todo))  # not yet connected
    live: set = set()
    due_heap: list = []  # (due_time, tiebreak, client) send schedule
    tiebreak = itertools.count()
    t_start = time.monotonic()
    deadline = t_start + timeout

    def close_out(c: _Client, state: int, why: Optional[str] = None) -> None:
        c.state = state
        c.error = why
        c.t_done = time.monotonic()
        if c.sock is not None:
            try:
                sel.unregister(c.sock)
            except (KeyError, ValueError):
                pass
            try:
                c.sock.close()
            except OSError:
                pass
        live.discard(c)

    def interest(c: _Client) -> int:
        ev = selectors.EVENT_READ
        if c.outbuf:
            ev |= selectors.EVENT_WRITE
        return ev

    def update(c: _Client) -> None:
        try:
            sel.modify(c.sock, interest(c), c)
        except (KeyError, ValueError):
            pass

    def queue_due_chunks(c: _Client, now: float) -> bool:
        """Realtime pacing: chunk k is due at t_ack + k*pace. Returns
        True if anything was queued."""
        queued = False
        # Cap local queuing at 64 chunks so a stalled server exerts
        # backpressure on the HARNESS clock too, not just TCP.
        while (
            c.sent_chunks < c.blocks_total
            and now >= c.t_ack + c.sent_chunks * pace
            and len(c.outbuf) < 64 * len(c.payload)
        ):
            c.outbuf += c.payload
            c.sent_chunks += 1
            c.sent_frames += c.chunk_frames
            c.send_times.append((c.sent_frames, now))
            queued = True
        if c.state == _STREAMING and c.sent_chunks == c.blocks_total:
            c.outbuf += _LEN.pack(0)  # client EOF
            c.state = _AWAIT_EOF
            queued = True
        return queued

    def drain_frames(c: _Client) -> None:
        """Parse rendered frames out of c.inbuf; closes latencies."""
        while True:
            if len(c.inbuf) < _LEN.size:
                return
            (n,) = _LEN.unpack(bytes(c.inbuf[:_LEN.size]))
            if n == 0:
                c.clean_eof = True
                if c.state == _AWAIT_EOF:
                    close_out(c, _DONE)
                else:
                    close_out(c, _FAILED, "early server EOF")
                return
            need = _LEN.size + n * 2 * 4
            if len(c.inbuf) < need:
                return
            del c.inbuf[:need]
            c.returned_frames += n
            now = time.monotonic()
            while c.send_times and c.send_times[0][0] <= c.returned_frames:
                _, t0 = c.send_times.pop(0)
                c.latencies.append(now - t0)

    def start_one(c: _Client) -> None:
        c.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        c.sock.setblocking(False)
        c.t_connect = time.monotonic()
        try:
            c.sock.connect(address)
        except BlockingIOError:
            pass
        except OSError as err:
            close_out(c, _FAILED, f"connect: {err}")
            return
        c.outbuf += c.header
        sel.register(c.sock, selectors.EVENT_READ | selectors.EVENT_WRITE, c)
        live.add(c)

    while pending or live:
        now = time.monotonic()
        if now >= deadline:
            for c in list(live):
                close_out(c, _FAILED, "harness timeout")
            for c in pending:
                close_out(c, _FAILED, "harness timeout")
            break
        admitting = sum(
            1 for c in live if c.state in (_CONNECTING, _AWAIT_ACK)
        )
        while pending and admitting < max(connect_burst, 1):
            start_one(pending.pop())
            admitting += 1
        # Timer-driven sends from the due-time heap (a full scan of every
        # client per loop would make the HARNESS the bottleneck at
        # O(1000) clients).
        while due_heap and due_heap[0][0] <= now:
            _, _, c = heapq.heappop(due_heap)
            if c.state != _STREAMING:
                continue
            if queue_due_chunks(c, now):
                update(c)
            if c.state == _STREAMING:  # more chunks to come
                # Floor at now+pace: a backlog-capped client would
                # otherwise re-pop immediately and spin the loop.
                heapq.heappush(
                    due_heap,
                    (max(c.t_ack + c.sent_chunks * pace, now + pace),
                     next(tiebreak), c),
                )
        sel_timeout = 0.05
        if due_heap:
            sel_timeout = min(sel_timeout, max(due_heap[0][0] - now, 0.0))
        for key, events in sel.select(timeout=sel_timeout):
            c = key.data
            if c.state in (_DONE, _FAILED):
                continue
            if events & selectors.EVENT_WRITE:
                if c.outbuf:
                    try:
                        sent = c.sock.send(bytes(c.outbuf[: 1 << 16]))
                        del c.outbuf[:sent]
                    except BlockingIOError:
                        pass
                    except OSError as err:
                        close_out(c, _FAILED, f"send: {err}")
                        continue
                update(c)
            if events & selectors.EVENT_READ:
                try:
                    data = c.sock.recv(1 << 16)
                except BlockingIOError:
                    data = None
                except OSError as err:
                    close_out(c, _FAILED, f"recv: {err}")
                    continue
                if data is not None and not data:
                    close_out(c, _FAILED, "peer closed")
                    continue
                if data:
                    c.inbuf += data
                if c.state == _CONNECTING:
                    c.state = _AWAIT_ACK
                if c.state == _AWAIT_ACK:
                    if c.inbuf[:4] == b"\x00\x00\x00\x00":
                        # The clean EOF frame where the lane ack would be:
                        # the server refused admission (pool full, or a
                        # protocol rejection). An ack line never starts
                        # with NUL bytes.
                        close_out(c, _FAILED, "rejected before ack")
                        continue
                    nl = c.inbuf.find(b"\n")
                    if nl >= 0:
                        try:
                            ack = json.loads(bytes(c.inbuf[:nl]).decode())
                            c.lane = int(ack["lane"])
                        except (ValueError, KeyError):
                            close_out(c, _FAILED, "bad ack")
                            continue
                        del c.inbuf[: nl + 1]
                        c.t_ack = time.monotonic()
                        c.state = _STREAMING
                        queue_due_chunks(c, time.monotonic())
                        if c.state == _STREAMING:
                            heapq.heappush(
                                due_heap,
                                (c.t_ack + c.sent_chunks * pace,
                                 next(tiebreak), c),
                            )
                        update(c)
                if c.state in (_STREAMING, _AWAIT_EOF):
                    drain_frames(c)

    wall = time.monotonic() - t_start
    done = [c for c in todo if c.state == _DONE]
    failed = [c for c in todo if c.state != _DONE]
    admission = [c.t_ack - c.t_connect for c in todo if c.t_ack > 0]
    chunk_lat: list = []
    for c in todo:
        chunk_lat.extend(c.latencies)
    completion = [c.t_done - t_start for c in done]
    rendered_frames = sum(c.returned_frames for c in done)
    return {
        "clients": clients,
        "completed": len(done),
        "failed": len(failed),
        "fail_reasons": sorted({c.error for c in failed if c.error})[:8],
        "wall_s": round(wall, 3),
        "admission": _percentiles(admission),
        "chunk_latency": _percentiles(chunk_lat),
        "completion_spread_s": (
            round(max(completion) - min(completion), 3) if completion else None
        ),
        "rendered_realtime_multiple": (
            round(rendered_frames / _SAMPLE_RATE / wall, 1) if wall else None
        ),
        "speed": speed,
        "blocks_each": blocks_each,
        "chunk": chunk,
    }


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="selector-based wire load generator (one JSON line out)"
    )
    parser.add_argument("--connect", required=True, help="HOST:PORT")
    parser.add_argument("--clients", type=int, default=64)
    parser.add_argument("--blocks-each", type=int, default=8)
    parser.add_argument("--chunk", type=int, default=512)
    parser.add_argument("--channels", type=int, default=2)
    parser.add_argument("--speed", type=float, default=1.0,
                        help="pacing multiple of realtime (1.0 = realtime)")
    parser.add_argument("--connect-burst", type=int, default=64)
    parser.add_argument("--timeout", type=float, default=120.0)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    host, port = args.connect.rsplit(":", 1)
    result = run_load(
        (host, int(port)),
        clients=args.clients,
        blocks_each=args.blocks_each,
        chunk=args.chunk,
        channels=args.channels,
        speed=args.speed,
        connect_burst=args.connect_burst,
        timeout=args.timeout,
        seed=args.seed,
    )
    print(json.dumps(result), flush=True)
    return 0 if result["failed"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
