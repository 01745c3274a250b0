"""Network streaming server: the deployable serving frontend (PyTorch).

Port of airwave_tpu/shell/serve.py over the port's StreamPool. Clients
connect over TCP, send a JSON header line, then length-prefixed float32
PCM chunks; the server renders them through a shared StreamPool (HRIR
binaural + EQ on the card) and streams rendered stereo back. The wire
bytes are the JAX package's, so either package's clients talk to either
package's server.

Batching: connection IO only does socket work and ring pushes; ONE pump
thread drains every connection's pending input into shared device steps, so
N concurrent clients ride the same pool round per block instead of
serializing N separate steps (the pool's whole purpose). A short batch
window lets concurrent pushes coalesce before the pump fires, and the pump
runs at most one bounded burst per window (unthrottled straggler-chasing
degenerates into many small rounds at 100% duty).

Two data planes (io_mode):
  "selector" (default): ONE IO thread owns every client socket via
    epoll/kqueue; per-connection state machines; the pump signals the IO
    thread after each render burst, so delivery is render-completion-
    driven. It is structurally O(1) threads (thread mode's handler
    threads each carry a stack and GIL scheduling load the selector plane
    never pays): the plane for O(1000) connections.
  "thread": thread-per-connection, blocking IO, delivery rides inbound
    messages. The simplest-possible reference plane; kept as the
    comparison baseline and for debugging single connections.
Both planes share admission (_admit), wire limits, the underflow/EOF/
truncation contract, latency accounting, and backpressure semantics; the
full behavioral test suite runs against each (tests/test_torch_serve.py).

Wire protocol (little-endian):
  client -> server:  one JSON line {"channels": C[, "group": G]
                                    [, "resume": LANE, "token": SECRET]
                                    [, "want_lane": true]}\n
                     then frames: uint32 n | float32 data[C*n]  (n == 0: EOF)
  server -> client:  [one JSON line {"lane": N, "token": SECRET}\n when
                      want_lane was set]
                     frames: uint32 n | float32 data[2*n]
"group" (default 0) selects the client's profile group on a grouped
multi-tenant pool (StreamPool(profiles=...)); a group the pool does not
have is a protocol error.
"resume" continues a lane that survived a SERVER RESTART: when the server
starts on a pool restored from a checkpoint (RenderServer(orphan_tokens=
checkpoint's resume_tokens)), the restored attached lanes are ORPHANS —
their DSP carries are intact but their connections are gone. A client
reclaims its lane with {"resume": LANE, "token": SECRET} using the secret
from its want_lane ack (no attach, no state reset: the stream's
convolution/EQ history continues exactly); orphans unclaimed within
`resume_grace` seconds are detached. Lane ids are guessable ints — the
token is the authentication; a wrong/missing token or a non-orphan lane
is a protocol error and never consumes the orphan (live lanes cannot be
hijacked). Rendered-but-undelivered audio and undrained input are
transient (rings are not checkpointed) — clients resend from their last
acknowledged frame.
Wire limits: C must be 1 (mono duplicated) or the group's speaker count, and
each message's n is capped at ring capacity minus (step - 1) frames by
default — the largest size guaranteed to eventually fit past any
un-harvestable sub-step residue (step = block, or M blocks on a
blocks_per_step=M throughput pool). Violations close the connection with a
clean EOF frame instead of killing the serving thread.
Rendered audio follows the pool's underflow contract: the server returns
whatever is rendered so far; remaining tail is flushed after the client EOF
(zero-padded to the step boundary). The server's EOF frame is a
completion guarantee — if rendering stalls past the client timeout the
connection closes WITHOUT it, so clients can distinguish a truncated
stream from a successful one (`truncated_closes` counts these).

One deliberate difference from the JAX server: the resume-alias map
(old lane id -> new, after a resized restore) is cleared as soon as no
orphan is left, on the resume path too. The JAX server clears it only when
the last orphan expires, so after every orphan has resumed its aliases
outlive the grace window.
"""

from __future__ import annotations

import collections
import hmac
import json
import secrets
import selectors
import socket
import threading
import time
from typing import Optional

import numpy as np

from airwave_tpu_torch.runtime.stream_pool import StreamPool
# The wire helpers and reference client live in a torch-free module, so
# deployment smoke checks run without torch; re-exported here.
from airwave_tpu_torch.shell.wire_client import (_LEN, _read_exact,
                                                 _send_frame,
                                                 render_via_server)

__all__ = ["RenderServer", "render_via_server"]


class RenderServer:
    """One StreamPool shared across client connections, one pump thread."""

    def __init__(
        self,
        pool: StreamPool,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        client_timeout: float = 30.0,
        batch_window: float = 0.002,
        max_message_frames: Optional[int] = None,
        resume_grace: float = 30.0,
        orphan_tokens: Optional[dict] = None,
        orphan_aliases: Optional[dict] = None,
        io_mode: str = "selector",
    ) -> None:
        if io_mode not in ("thread", "selector"):
            raise ValueError(f"io_mode must be 'thread' or 'selector', "
                             f"got {io_mode!r}")
        self.pool = pool
        self.io_mode = io_mode
        self.client_timeout = float(client_timeout)
        self.batch_window = float(batch_window)
        self.resume_grace = float(resume_grace)
        # Per-lane resume secrets: generated at attach, handed to the
        # client in the want_lane ack, checkpointed, and REQUIRED to claim
        # an orphan — lane ids are guessable ints, the token is what ties
        # a lane to its original client.
        self._lane_tokens: dict = {}
        # Restart ORPHANS: when orphan_tokens is given (ANY dict — the
        # signal that this pool was restored from a checkpoint), EVERY
        # pre-attached lane is an orphan: its connection is gone by
        # definition, so it must either be reclaimed (needs its token) or
        # grace-detached — a token-less restored lane would otherwise
        # leak its slot forever. With orphan_tokens=None (a library
        # embedder sharing a live pool), pre-attached lanes are left
        # alone entirely.
        self._orphans: dict = {}
        # Resize aliasing: after a restart that RESIZED the pool
        # (restore(..., resize=True)), the lane id a client checkpointed
        # is the OLD id; aliases translate old->new for resume lookups
        # during the grace window. A resuming client that set want_lane
        # is acked the NEW id for its next checkpoint.
        self._orphan_aliases: dict = {
            int(k): int(v) for k, v in (orphan_aliases or {}).items()
        }
        if orphan_tokens is not None:
            now = time.monotonic()
            for s in getattr(pool, "_attached", {}):
                self._orphans[int(s)] = now + self.resume_grace
                tok = orphan_tokens.get(int(s))
                if tok is not None:
                    self._lane_tokens[int(s)] = str(tok)
        # Default cap: a max-size message must ALWAYS eventually fit. Up to
        # step_frames-1 frames of residue (block-1 for the default
        # single-block pool) can linger un-harvestable in the input ring,
        # so capacity-sized messages could stall forever against a
        # permanently short ring.
        self.max_message_frames = int(
            max_message_frames
            if max_message_frames is not None
            else pool.assembler.capacity - (pool.step_frames - 1)
        )
        self._lock = threading.Lock()  # pool control-plane lock
        self._listener = socket.create_server((host, port))
        self.address = self._listener.getsockname()
        self._threads: list[threading.Thread] = []
        # Live client sockets: stop() shuts these down so serving threads
        # blocked in recv() unblock immediately instead of each riding out
        # a join timeout (a lingering client must not stall shutdown).
        self._conns: set = set()
        self._threads_lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None
        self._pump_thread: Optional[threading.Thread] = None
        self._stopping = False
        self._data_ready = threading.Event()
        self._pump_cond = threading.Condition()
        self._pump_generation = 0
        self.connections_served = 0
        self.protocol_errors = 0
        self.pump_errors = 0
        self.rejected_full = 0
        self.truncated_closes = 0
        self.resumed_streams = 0
        self.expired_orphans = 0
        # Wire-to-wire chunk latency (client chunk pushed -> its last
        # rendered frame handed to the socket), measured per delivered
        # chunk. Bounded reservoir: stats() percentiles reflect the recent
        # window; the count is cumulative.
        self._lat_lock = threading.Lock()
        self._lat_samples: collections.deque = collections.deque(maxlen=4096)
        self._lat_count = 0
        # Selector data plane (io_mode="selector"): one IO thread owns
        # every client socket; the pump thread signals it through a
        # socketpair after each render burst so delivery is
        # render-completion-driven, not inbound-triggered.
        self._sel_conns: set = set()
        self._io_thread: Optional[threading.Thread] = None
        self._wake_r: Optional[socket.socket] = None
        self._wake_w: Optional[socket.socket] = None

    def start(self) -> None:
        self._pump_thread = threading.Thread(target=self._pump_loop,
                                             daemon=True)
        self._pump_thread.start()
        if self.io_mode == "selector":
            self._wake_r, self._wake_w = socket.socketpair()
            self._wake_r.setblocking(False)
            self._wake_w.setblocking(False)
            self._io_thread = threading.Thread(target=self._io_loop,
                                               daemon=True)
            self._io_thread.start()
        else:
            self._accept_thread = threading.Thread(target=self._accept_loop,
                                                   daemon=True)
            self._accept_thread.start()

    def set_equalizer(self, definition, group: Optional[int] = None) -> None:
        """Live EQ retarget, serialized against the pump thread. Streams
        mid-render crossfade per the pool's ramp semantics. On a grouped
        pool, `group=g` retargets only that profile group's clients (None:
        every group)."""
        with self._lock:
            self.pool.set_equalizer(definition, group=group)

    def set_renderer(self, renderer, prewarm: bool = True,
                     group: Optional[int] = None) -> None:
        """Live HRIR swap (crossfaded when the bank fits the carry, see
        StreamPool.set_renderer). Serving pauses under the lock for the
        swap and, by default, for a prewarm when the new renderer's
        partition or speaker shape differs, so the first rounds after the
        swap do not load new cuBLAS paths under traffic. On a grouped pool
        pass `group=g`; the shape compared is that group's."""
        with self._lock:
            g = group or 0
            old = self.pool.renderers[g] if 0 <= g < self.pool.groups else None
            self.pool.set_renderer(renderer, group=group)  # checks the group
            shape_changed = (
                old.partition_count != renderer.partition_count
                or old.num_speakers != renderer.num_speakers
            )
            if prewarm and shape_changed:
                # include_hotswap: a LATER crossfade swap onto the new
                # shape must find its dual-bank round already loaded.
                self.pool.prewarm(include_hotswap=True)

    def _record_latency(self, seconds: float) -> None:
        with self._lat_lock:
            self._lat_samples.append(seconds)
            self._lat_count += 1

    def reset_latency(self) -> None:
        """Drop all recorded wire-to-wire latency samples AND the
        cumulative count (e.g. to scope stats to a measurement window, so
        the count matches the percentiles' backing data)."""
        with self._lat_lock:
            self._lat_samples.clear()
            self._lat_count = 0

    def latency_stats(self) -> dict:
        """p50/p90/p99/max wire-to-wire chunk latency (seconds) over the
        recent reservoir, plus the cumulative delivered-chunk count."""
        with self._lat_lock:
            samples = list(self._lat_samples)
            count = self._lat_count
        if not samples:
            return {"count": 0}
        arr = np.sort(np.asarray(samples))
        q = lambda p: float(arr[min(len(arr) - 1, int(p * len(arr)))])  # noqa: E731
        return {
            "count": count,
            "p50_ms": round(q(0.50) * 1e3, 3),
            "p90_ms": round(q(0.90) * 1e3, 3),
            "p99_ms": round(q(0.99) * 1e3, 3),
            "max_ms": round(float(arr[-1]) * 1e3, 3),
        }

    def stats(self) -> dict:
        """Operational snapshot: server counters + the pool's (host-side
        only, safe to poll — serialized against the pump so the pool's
        counters are round-consistent)."""
        with self._lock:
            pool = self.pool.stats()
            orphans = len(self._orphans)
        if self.io_mode == "selector":
            live = len(self._sel_conns)
        else:
            with self._threads_lock:
                live = sum(t.is_alive() for t in self._threads)
        return {
            "latency": self.latency_stats(),
            "connections_served": self.connections_served,
            "connections_live": live,
            "protocol_errors": self.protocol_errors,
            "pump_errors": self.pump_errors,
            "rejected_full": self.rejected_full,
            "truncated_closes": self.truncated_closes,
            "resumed_streams": self.resumed_streams,
            "orphan_lanes": orphans,
            "pool": pool,
        }

    def save_checkpoint(self, path: str) -> None:
        """Persist the pool's serving checkpoint (utils/checkpoint
        save_pool_snapshot), round-consistent but cheap under the lock:
        the lock holds only for an on-device carry copy + host counters
        (snapshot(materialize=False)); the device->host readback and the
        atomic file write run outside it, so serving never stalls on the
        fetch. The checkpoint carries each lane's resume token; a server
        started on a pool restored from this file (orphan_tokens=...)
        offers the restored lanes for token-authenticated `resume`. The
        file is readable by the JAX package's loader too."""
        from airwave_tpu_torch.utils import checkpoint

        with self._lock:
            snap = self.pool.snapshot(materialize=False)
            snap["resume_tokens"] = dict(self._lane_tokens)
        checkpoint.save_pool_snapshot(path, snap)

    def stop(self) -> None:
        self._stopping = True
        # shutdown() BEFORE close(): on Linux, close() alone does not wake
        # a thread blocked in accept() (the fd stays blocked until a
        # connection arrives), so every stop() rode out the full join
        # timeout. shutdown(SHUT_RDWR) on the listening socket interrupts
        # the accept immediately.
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._data_ready.set()
        if self._io_thread is not None:
            # Selector data plane: the IO thread owns every client socket;
            # wake it (it observes _stopping, tears down all connections)
            # and join. No per-connection threads exist in this mode.
            try:
                self._wake_w.send(b"\x00")
            except (BlockingIOError, OSError):
                pass
            self._io_thread.join(timeout=5)
            for s in (self._wake_r, self._wake_w):
                try:
                    s.close()
                except OSError:
                    pass
            if self._pump_thread is not None:
                self._pump_thread.join(timeout=5)
            return
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        with self._threads_lock:
            threads = list(self._threads)
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for thread in threads:
            thread.join(timeout=5)
        # Belt and braces for the register-after-snapshot race (see
        # _serve_client's _stopping check): any conn that slipped in
        # between the snapshot and the handlers observing _stopping gets
        # its shutdown() now, then one more join pass.
        with self._threads_lock:
            stragglers = [c for c in self._conns if c not in conns]
            late_threads = [t for t in self._threads if t not in threads]
        for conn in stragglers:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for thread in late_threads:
            thread.join(timeout=5)
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=5)

    # --- pump thread: the single place device steps run ----------------------

    def _pump_loop(self) -> None:
        while not self._stopping:
            fired = self._data_ready.wait(timeout=0.1)
            if self._stopping:
                break
            self._expire_orphans()
            if not fired:
                continue
            if self.batch_window > 0:
                time.sleep(self.batch_window)
            self._data_ready.clear()
            try:
                # ONE bounded burst per batch window. Two disciplines at
                # once: (a) the lock hold is capped at 4 device rounds, so
                # pushes/pulls (and the selector delivery pass) are never
                # convoyed behind a long catch-up pump; (b) stragglers that
                # arrive DURING a round wait for the next window instead of
                # being chased with tiny follow-on rounds — unthrottled
                # chasing degenerates into many small rounds at 100%
                # duty (a small round costs nearly as much as a
                # full one), which is exactly how a loaded server falls off
                # the batching cliff. The selector IO thread is woken
                # AFTER the burst's lock release (below) — a per-round
                # on_deliver wake is useless here: the pump holds the
                # lock for the whole burst, so a woken delivery pass
                # would only park the sole IO thread on the lock (no
                # reads, writes, or accepts) for the burst remainder
                # instead of servicing sockets.
                leftover = False
                with self._lock:
                    if self.pool.assembler.ready_count() > 0:
                        self.pool.pump(max_rounds=4)
                        leftover = self.pool.assembler.ready_count() > 0
                if leftover:
                    self._data_ready.set()  # next window picks it up
            except Exception:
                # The pump thread must survive anything a render round can
                # throw (e.g. transient device errors) — a dead pump wedges
                # every connection. The pool's delivery path itself never
                # raises on full output rings (StreamPool._deliver).
                self.pump_errors += 1
                # The event was cleared before this round claimed the
                # pending input; re-arm it so the work retries next cycle
                # instead of stranding until the next client push.
                self._data_ready.set()
                time.sleep(0.05)
            with self._pump_cond:
                self._pump_generation += 1
                self._pump_cond.notify_all()
            if self._wake_w is not None:
                self._wake_io()

    def _wake_io(self) -> None:
        """Render-completion signal to the selector IO thread: it runs a
        delivery pass (pull rendered audio to write buffers, retry stalled
        pushes, complete flushes). A full pipe is fine — one pending byte
        already means "run a pass"."""
        try:
            self._wake_w.send(b"\x00")
        except (BlockingIOError, OSError):
            pass

    def _expire_orphans(self) -> None:
        """Detach restart orphans nobody resumed within the grace window."""
        if not self._orphans:
            return
        now = time.monotonic()
        with self._lock:
            expired = [s for s, dl in self._orphans.items() if dl <= now]
            for s in expired:
                self._orphans.pop(s, None)
                self._lane_tokens.pop(s, None)
                self.pool.detach(s)
                self.expired_orphans += 1
            if not self._orphans:
                self._orphan_aliases.clear()  # grace over: aliases done

    def _await_pump_round(self, generation: int, deadline: float) -> int:
        """Block until a pump round later than `generation` has run (or the
        deadline passes); returns the latest observed generation."""
        with self._pump_cond:
            while (
                self._pump_generation <= generation
                and not self._stopping
                and time.monotonic() < deadline
            ):
                self._pump_cond.wait(timeout=0.05)
            return self._pump_generation

    # --- connection handling --------------------------------------------------

    def _admit(self, header) -> Optional[tuple]:
        """Validate a parsed header and attach (or resume) a lane.

        Returns (stream, token, group, channels) on success, None after
        counting the protocol error / full-pool rejection. Shared by both
        data planes (thread-per-connection and selector), so admission
        semantics — group bounds, channel-count check against the group's
        live renderer, token-authenticated orphan resume, clean full-pool
        refusal — can never diverge between them."""
        if not isinstance(header, dict):
            self.protocol_errors += 1
            return None
        try:
            channels = int(header.get("channels", 2))
            group = int(header.get("group", 0))
            resume = header.get("resume")
            resume = None if resume is None else int(resume)
        except (TypeError, ValueError):
            self.protocol_errors += 1
            return None
        if resume is not None:
            # A restart that resized the pool remapped lane ids; the
            # client holds the OLD id from its pre-restart ack.
            resume = self._orphan_aliases.get(resume, resume)
            # Resuming fixes the lane, which fixes the group.
            group = self.pool.group_of(resume)
        if not (0 <= group < self.pool.groups):
            self.protocol_errors += 1
            return None
        with self._lock:
            # The group's renderer is read under the pool lock so a
            # concurrent set_renderer(group=...) cannot race the
            # admission check against a stale layout.
            renderer = self.pool.renderers[group]
            if channels not in (1, renderer.num_speakers,
                                renderer.layout_channels):
                self.protocol_errors += 1
                return None
            if resume is not None:
                # Only restart orphans are claimable, and only with
                # the lane's resume token (lane ids are guessable
                # ints): live lanes can never be hijacked, a wrong or
                # missing token is an error, and a failed attempt
                # does NOT consume the orphan.
                want_tok = self._lane_tokens.get(resume)
                got_tok = header.get("token")
                # Compare ENCODED bytes: compare_digest raises
                # TypeError on non-ASCII str input, which a hostile
                # header could use to kill this serving thread.
                if (resume not in self._orphans
                        or want_tok is None
                        or not isinstance(got_tok, str)
                        or not hmac.compare_digest(
                            want_tok.encode(), got_tok.encode())):
                    self.protocol_errors += 1
                    return None
                self._orphans.pop(resume, None)
                if not self._orphans:
                    # Every orphan is claimed: the aliases are done. (The
                    # JAX server clears them only on expiry.)
                    self._orphan_aliases.clear()
                stream = resume
                token = want_tok
                self.resumed_streams += 1
            else:
                try:
                    stream = self.pool.attach(group)
                except RuntimeError:
                    # Pool at max_streams: refuse THIS client cleanly
                    # instead of killing its serving thread.
                    self.rejected_full += 1
                    return None
                token = secrets.token_hex(16)
                self._lane_tokens[stream] = token
            self.connections_served += 1
        return stream, token, group, channels

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return
            thread = threading.Thread(target=self._serve_client,
                                      args=(conn,), daemon=True)
            with self._threads_lock:
                self._threads = [
                    t for t in self._threads if t.is_alive()
                ] + [thread]
            thread.start()

    def _push_with_backpressure(self, stream: int, frames: np.ndarray) -> bool:
        """Push a client chunk, waiting out full rings via pump rounds."""
        deadline = time.monotonic() + self.client_timeout
        while True:
            generation = self._pump_generation
            try:
                with self._lock:
                    self.pool.push(stream, frames)
                self._data_ready.set()
                return True
            except OverflowError:
                self._data_ready.set()
                if time.monotonic() >= deadline or self._stopping:
                    return False
                self._await_pump_round(generation, deadline)

    def _serve_client(self, conn: socket.socket) -> None:
        stream: Optional[int] = None
        clean = False
        suppress_eof = False
        with self._threads_lock:
            # A connection accepted in the same instant stop() fired
            # would register AFTER stop()'s _conns snapshot and never get
            # the shutdown() wake-up — its recv() could ride out the full
            # client_timeout past the join pass. _stopping is set before
            # stop() takes this lock, so checking it under the lock
            # closes the window: either stop() sees this conn, or this
            # thread sees _stopping.
            if self._stopping:
                try:
                    conn.close()
                except OSError:
                    pass
                return
            self._conns.add(conn)
        try:
            conn.settimeout(self.client_timeout)
            header_bytes = b""
            while not header_bytes.endswith(b"\n"):
                chunk = conn.recv(1)
                if not chunk:
                    return
                header_bytes += chunk
                if len(header_bytes) > 4096:
                    self.protocol_errors += 1
                    return
            header = json.loads(header_bytes.decode())
            admitted = self._admit(header)
            if admitted is None:
                return  # finally sends the clean EOF frame
            stream, token, _group, channels = admitted
            if isinstance(header, dict) and header.get("want_lane"):
                # Opt-in ack so the client can checkpoint its lane id +
                # resume token for a later resume; sent before any audio
                # frame.
                conn.sendall(json.dumps(
                    {"lane": stream, "token": token}
                ).encode() + b"\n")
            received = 0
            returned = 0
            # (cumulative frames pushed, push time): a chunk's wire-to-wire
            # latency closes when `returned` covers its last frame.
            pending_lat: collections.deque = collections.deque()

            def close_latencies() -> None:
                now = time.monotonic()
                while pending_lat and pending_lat[0][0] <= returned:
                    cum, t0 = pending_lat.popleft()
                    self._record_latency(now - t0)

            while True:
                raw = _read_exact(conn, _LEN.size)
                if raw is None:
                    break
                (n,) = _LEN.unpack(raw)
                if n == 0:
                    break  # client EOF
                if n > self.max_message_frames:
                    self.protocol_errors += 1
                    return
                payload = _read_exact(conn, n * channels * 4)
                if payload is None:
                    break
                frames = np.frombuffer(payload, "<f4").reshape(n, channels).T
                if not self._push_with_backpressure(stream, frames):
                    return
                received += n
                pending_lat.append((received, time.monotonic()))
                with self._lock:
                    available = self.pool.available(stream)
                    out = self.pool.pull(stream, available) if available else None
                if out is not None and out.shape[1]:
                    returned += out.shape[1]
                    _send_frame(conn, out)
                    close_latencies()

            # Flush: pad the pending partial step (block for the default
            # pool, M blocks for the multi-block tier), render, return the
            # exact remaining frames of the client's signal.
            remaining = received - returned
            if remaining > 0:
                pad = (-received) % self.pool.step_frames
                if pad and not self._push_with_backpressure(
                    stream, np.zeros((channels, pad), np.float32)
                ):
                    return
                deadline = time.monotonic() + self.client_timeout
                generation = self._pump_generation
                self._data_ready.set()
                while True:
                    with self._lock:
                        available = self.pool.available(stream)
                    if available >= remaining or time.monotonic() >= deadline:
                        break
                    generation = self._await_pump_round(generation, deadline)
                if available < remaining:
                    # Incomplete render (device stalled past the timeout):
                    # close WITHOUT the EOF frame so the client can tell
                    # truncation from success — an EOF frame means every
                    # pushed frame came back rendered.
                    self.truncated_closes += 1
                    suppress_eof = True
                    return
                with self._lock:
                    out = self.pool.pull(stream, remaining)
                returned += out.shape[1]
                _send_frame(conn, out)
                close_latencies()
            conn.sendall(_LEN.pack(0))
            clean = True
        except (OSError, ValueError, json.JSONDecodeError, OverflowError,
                AssertionError):
            pass
        finally:
            if not clean and not suppress_eof:
                try:
                    conn.sendall(_LEN.pack(0))
                except OSError:
                    pass
            if stream is not None:
                with self._lock:
                    self._lane_tokens.pop(stream, None)
                    self.pool.detach(stream)
            with self._threads_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    # --- selector data plane (io_mode="selector") -----------------------------
    #
    # One IO thread owns every client socket via epoll/kqueue
    # (selectors.DefaultSelector): at O(1000) concurrent connections,
    # thread-per-connection pays a thread + stack per client and convoys
    # the GIL across thousands of wakers, and — structurally — it can only
    # deliver rendered audio when THAT client's next inbound message
    # arrives (a blocking handler has nowhere to stand between messages).
    # The selector plane removes both: per-connection state machines cost
    # bytes not threads, and the pump thread signals the IO thread through
    # a socketpair after every render burst (it holds the pool lock for
    # the burst, so a finer-grained wake could not deliver anyway), so
    # delivery is render-completion-driven — rendered audio leaves for
    # the wire when rendering finishes, not when the client happens to
    # speak next.
    #
    # Semantics are pinned to the thread plane: identical admission
    # (_admit), wire limits, underflow/EOF/truncation contract, latency
    # accounting, and backpressure (a full input ring drops the
    # connection's READ interest — TCP pushes back on the producer — and
    # the push retries after the next pump round; a slow READER's
    # connection stops being pulled at 1 MiB of queued output so the
    # pool's output-ring gating takes over, exactly as an un-drained
    # thread-mode connection would).

    def _io_loop(self) -> None:
        sel = selectors.DefaultSelector()
        self._listener.setblocking(False)
        sel.register(self._listener, selectors.EVENT_READ, "accept")
        sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        next_sweep = time.monotonic() + 0.5
        try:
            while not self._stopping:
                events = sel.select(timeout=0.1)
                run_delivery = False
                for key, mask in events:
                    if key.data == "accept":
                        self._sel_accept(sel)
                    elif key.data == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                        run_delivery = True
                    else:
                        self._sel_io_event(sel, key.data, mask)
                if run_delivery and not self._stopping:
                    self._sel_delivery(sel)
                now = time.monotonic()
                if now >= next_sweep:
                    self._sel_sweep(sel, now)
                    next_sweep = now + 0.5
        finally:
            for c in list(self._sel_conns):
                if not c.suppress_eof:
                    try:
                        c.sock.setblocking(False)
                        c.sock.send(_LEN.pack(0))
                    except OSError:
                        pass
                self._sel_teardown(sel, c)
            sel.close()

    def _sel_accept(self, sel) -> None:
        while True:
            try:
                sock, _addr = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            c = _SelConn(sock)
            self._sel_conns.add(c)
            sel.register(sock, selectors.EVENT_READ, c)

    def _sel_interest(self, c) -> int:
        ev = 0
        # A stalled connection (full input ring) stops reading: the kernel
        # buffer fills and TCP backpressures the producer, mirroring the
        # thread plane's blocking push.
        if not c.stalled and not c.closing and not c.read_closed:
            ev |= selectors.EVENT_READ
        if c.outbuf:
            ev |= selectors.EVENT_WRITE
        return ev

    def _sel_update(self, sel, c) -> None:
        """Sync the selector to the connection's current interest.

        Zero interest UNREGISTERS the fd (selectors reject events=0):
        a stalled conn with an empty write buffer must NOT fall back to
        READ — that would refill inbuf at line rate while the pinned
        push keeps failing (backpressure defeated, unbounded memory) —
        and a half-closed fd with nothing to write is level-triggered-
        readable forever and would spin the IO thread. Wakeups for such
        conns come from the pump's post-round delivery pass, which
        re-registers them here once interest returns."""
        if c not in self._sel_conns:
            return
        ev = self._sel_interest(c)
        try:
            if ev == 0:
                try:
                    sel.unregister(c.sock)
                except KeyError:
                    pass
            else:
                try:
                    sel.modify(c.sock, ev, c)
                except KeyError:
                    sel.register(c.sock, ev, c)
        except (ValueError, OSError):
            pass

    def _sel_io_event(self, sel, c, mask) -> None:
        if c not in self._sel_conns:
            return
        if mask & selectors.EVENT_WRITE and c.outbuf:
            try:
                sent = c.sock.send(bytes(memoryview(c.outbuf)[: 1 << 16]))
                del c.outbuf[:sent]
                c.last_activity = time.monotonic()
            except BlockingIOError:
                pass
            except OSError:
                self._sel_teardown(sel, c)
                return
        if c.closing and not c.outbuf:
            self._sel_teardown(sel, c)
            return
        if mask & selectors.EVENT_READ and not c.closing:
            try:
                data = c.sock.recv(1 << 16)
            except BlockingIOError:
                data = None  # spurious wakeup
            except OSError:
                self._sel_teardown(sel, c)
                return
            if data:
                c.inbuf += data
                c.last_activity = time.monotonic()
                self._sel_process(sel, c)
            elif data == b"" and c in self._sel_conns and not c.closing:
                # Orderly read-side close from the peer. The thread plane
                # treats a mid-stream disconnect as implicit EOF and still
                # flushes the tail (the write side may be half-open);
                # mirror that. A close before admission just tears down.
                # read_closed drops READ interest: a half-closed fd stays
                # level-triggered-readable forever and would spin the loop.
                c.read_closed = True
                self._sel_process(sel, c)
                if c in self._sel_conns and not c.closing:
                    if c.state == _SEL_STREAM:
                        self._sel_begin_flush(sel, c)
                    elif c.state == _SEL_HEADER:
                        self._sel_teardown(sel, c)
                        return
        self._sel_update(sel, c)

    def _sel_process(self, sel, c) -> bool:
        """Consume as much of c.inbuf as possible. Returns True if the
        connection made progress (used by the peer-close path to decide
        whether buffered bytes completed the stream)."""
        progressed = False
        while c in self._sel_conns and not c.closing:
            if c.state == _SEL_HEADER:
                nl = c.inbuf.find(b"\n")
                if nl < 0:
                    if len(c.inbuf) > 4096:
                        self.protocol_errors += 1
                        self._sel_finish(sel, c, eof=True)
                    return progressed
                try:
                    header = json.loads(bytes(c.inbuf[:nl]).decode())
                except (ValueError, UnicodeDecodeError):
                    self.protocol_errors += 1
                    self._sel_finish(sel, c, eof=True)
                    return progressed
                del c.inbuf[: nl + 1]
                admitted = self._admit(header)
                if admitted is None:
                    self._sel_finish(sel, c, eof=True)
                    return progressed
                c.stream, token, _group, c.channels = admitted
                if isinstance(header, dict) and header.get("want_lane"):
                    c.outbuf += json.dumps(
                        {"lane": c.stream, "token": token}
                    ).encode() + b"\n"
                c.state = _SEL_STREAM
                progressed = True
            elif c.state == _SEL_STREAM:
                if len(c.inbuf) < _LEN.size:
                    return progressed
                (n,) = _LEN.unpack(bytes(c.inbuf[:_LEN.size]))
                if n == 0:
                    del c.inbuf[:_LEN.size]
                    self._sel_begin_flush(sel, c)
                    return True
                if n > self.max_message_frames:
                    self.protocol_errors += 1
                    self._sel_finish(sel, c, eof=True)
                    return progressed
                need = _LEN.size + n * c.channels * 4
                if len(c.inbuf) < need:
                    return progressed
                frames = np.frombuffer(
                    bytes(c.inbuf[_LEN.size:need]), "<f4"
                ).reshape(n, c.channels).T
                try:
                    with self._lock:
                        self.pool.push(c.stream, frames)
                except OverflowError:
                    # Leave the message in inbuf; drop READ interest and
                    # retry after the next pump round. The deadline is
                    # per PINNED MESSAGE, mirroring
                    # _push_with_backpressure's: armed on the first
                    # failed push, held across retries (re-arming on
                    # every delivery-pass retry would let other
                    # traffic's pump rounds defer the sweep forever),
                    # cleared when the push lands.
                    c.stalled = True
                    if not c.stall_deadline:
                        c.stall_deadline = (time.monotonic()
                                            + self.client_timeout)
                    self._data_ready.set()
                    return progressed
                except (ValueError, AssertionError):
                    self.protocol_errors += 1
                    self._sel_finish(sel, c, eof=True)
                    return progressed
                del c.inbuf[:need]
                c.stall_deadline = 0.0  # the pinned message landed
                c.received += n
                c.pending_lat.append((c.received, time.monotonic()))
                self._data_ready.set()
                progressed = True
            else:  # _SEL_FLUSH: the client already sent EOF — trailing
                return progressed  # bytes are ignored, as a closed
                # thread-mode handler would simply never read them.
        return progressed

    def _sel_begin_flush(self, sel, c) -> None:
        remaining = c.received - c.returned
        if remaining <= 0:
            self._sel_finish(sel, c, eof=True)
            return
        c.state = _SEL_FLUSH
        c.flush_deadline = time.monotonic() + self.client_timeout
        pad = (-c.received) % self.pool.step_frames
        if pad:
            try:
                with self._lock:
                    self.pool.push(
                        c.stream, np.zeros((c.channels, pad), np.float32)
                    )
            except OverflowError:
                c.flush_pad = pad  # retried in the delivery pass
        self._data_ready.set()
        # Everything may already be rendered (no further pump round
        # coming): resolve immediately rather than waiting on a signal.
        self._sel_deliver_one(sel, c)

    def _sel_deliver_one(self, sel, c) -> None:
        """Pull whatever is rendered for one connection into its write
        buffer; completes the flush when the tail is covered."""
        if c.stream is None or c.closing or c not in self._sel_conns:
            return
        if len(c.outbuf) > _SEL_HIGH_WATER:
            return  # slow reader: let output-ring gating take over
        with self._lock:
            if c.flush_pad:
                try:
                    self.pool.push(
                        c.stream,
                        np.zeros((c.channels, c.flush_pad), np.float32),
                    )
                    c.flush_pad = 0
                    self._data_ready.set()
                except OverflowError:
                    pass
            available = self.pool.available(c.stream)
            if c.state == _SEL_FLUSH:
                remaining = c.received - c.returned
                out = (self.pool.pull(c.stream, min(available, remaining))
                       if available and remaining else None)
            else:
                out = self.pool.pull(c.stream, available) if available \
                    else None
        self._sel_queue_out(c, out, time.monotonic())
        if c.state == _SEL_FLUSH and c.returned >= c.received:
            self._sel_finish(sel, c, eof=True)

    def _sel_delivery(self, sel) -> None:
        """Post-pump pass: deliver rendered audio, retry stalled pushes.

        ONE lock hold covers the whole pull sweep (per-connection lock
        acquisitions would cost more than the render round at O(1000)
        connections); the byte packing and latency accounting run outside
        it."""
        for c in [c for c in self._sel_conns if c.stalled]:
            c.stalled = False
            self._sel_process(sel, c)  # re-attempts the pinned push
            if not c.stalled:
                c.stall_deadline = 0.0
            # A stalled conn sits UNREGISTERED (zero interest); regain
            # READ here if the retry unstalled it.
            self._sel_update(sel, c)
        pulled = []
        with self._lock:
            for c in self._sel_conns:
                if c.stream is None or c.closing:
                    continue
                if len(c.outbuf) > _SEL_HIGH_WATER:
                    continue  # slow reader: output-ring gating takes over
                if c.flush_pad:
                    try:
                        self.pool.push(
                            c.stream,
                            np.zeros((c.channels, c.flush_pad), np.float32),
                        )
                        c.flush_pad = 0
                        self._data_ready.set()
                    except OverflowError:
                        pass
                available = self.pool.available(c.stream)
                if not available:
                    continue
                if c.state == _SEL_FLUSH:
                    remaining = c.received - c.returned
                    if not remaining:
                        continue
                    out = self.pool.pull(c.stream,
                                         min(available, remaining))
                else:
                    out = self.pool.pull(c.stream, available)
                pulled.append((c, out))
        now = time.monotonic()
        for c, out in pulled:
            self._sel_queue_out(c, out, now)
            if c.state == _SEL_FLUSH and c.returned >= c.received:
                self._sel_finish(sel, c, eof=True)
            if c in self._sel_conns:
                self._sel_update(sel, c)

    def _sel_queue_out(self, c, out, now: float) -> None:
        if out is None or not out.shape[1]:
            return
        payload = np.ascontiguousarray(out.T, np.float32).tobytes()
        c.outbuf += _LEN.pack(out.shape[1]) + payload
        c.returned += out.shape[1]
        while c.pending_lat and c.pending_lat[0][0] <= c.returned:
            _, t0 = c.pending_lat.popleft()
            self._record_latency(now - t0)

    def _sel_sweep(self, sel, now: float) -> None:
        """Timeout discipline, mirroring the thread plane's socket
        timeouts: silent/stuck connections get the clean-EOF close; a
        flush that cannot complete within client_timeout closes WITHOUT
        the EOF frame (truncation marker)."""
        for c in list(self._sel_conns):
            if c.state == _SEL_FLUSH and now >= c.flush_deadline:
                self.truncated_closes += 1
                c.suppress_eof = True
                self._sel_teardown(sel, c)
            elif c.stalled and now >= c.stall_deadline:
                self._sel_finish(sel, c, eof=True)
            elif (not c.closing and c.state != _SEL_FLUSH
                    and now - c.last_activity > self.client_timeout):
                self._sel_finish(sel, c, eof=True)
            elif c.closing and now - c.last_activity > self.client_timeout:
                self._sel_teardown(sel, c)  # peer never drained our EOF

    def _sel_finish(self, sel, c, *, eof: bool) -> None:
        """Queue the clean EOF frame and close once the write buffer
        drains (the thread plane's `finally` contract)."""
        if c.closing or c not in self._sel_conns:
            return
        if eof:
            c.outbuf += _LEN.pack(0)
        c.closing = True
        c.stalled = False
        c.last_activity = time.monotonic()
        # The lane is released NOW (as the thread plane's finally does
        # after its send attempt) — the remaining socket life is only
        # draining already-rendered bytes.
        if c.stream is not None:
            with self._lock:
                self._lane_tokens.pop(c.stream, None)
                self.pool.detach(c.stream)
            c.stream = None
        if not c.outbuf:
            self._sel_teardown(sel, c)
        else:
            self._sel_update(sel, c)

    def _sel_teardown(self, sel, c) -> None:
        if c.stream is not None:
            with self._lock:
                self._lane_tokens.pop(c.stream, None)
                self.pool.detach(c.stream)
            c.stream = None
        try:
            sel.unregister(c.sock)
        except (KeyError, ValueError):
            pass
        try:
            c.sock.close()
        except OSError:
            pass
        self._sel_conns.discard(c)


_SEL_HEADER = 0
_SEL_STREAM = 1
_SEL_FLUSH = 2
_SEL_HIGH_WATER = 1 << 20  # stop pulling for a conn with 1 MiB queued


class _SelConn:
    """Per-connection state for the selector data plane."""

    __slots__ = (
        "sock", "state", "inbuf", "outbuf", "channels", "stream",
        "received", "returned", "pending_lat", "last_activity",
        "stalled", "stall_deadline", "flush_deadline", "flush_pad",
        "closing", "suppress_eof", "read_closed",
    )

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.state = _SEL_HEADER
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.channels = 2
        self.stream: Optional[int] = None
        self.received = 0
        self.returned = 0
        self.pending_lat: collections.deque = collections.deque()
        self.last_activity = time.monotonic()
        self.stalled = False
        self.stall_deadline = 0.0
        self.flush_deadline = 0.0
        self.flush_pad = 0
        self.closing = False
        self.suppress_eof = False
        self.read_closed = False


