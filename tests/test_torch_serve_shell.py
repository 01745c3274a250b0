"""The serving shell's remaining cases of tests/test_serve.py on the PyTorch
port: hostile payloads, shared device steps, churn, a live renderer swap,
the accept limit, selector-stall backpressure, the loopback latency budget,
the full-pool reject, token-less restored lanes and hostile tokens, and the
tiers' added latency.

Each case is its JAX counterpart run on the port's server and pool
(device="cpu", the kernels' plain versions), at its shapes: block 64, a
seeded 14-channel 300-frame bank. The cases that compare audio also run
the JAX server on the same seeded input and hold the two within 1e-5
rel-RMS; the added-latency case holds the port's frame counts to the JAX
pool's."""

import json
import socket
import struct
import threading
import time

import numpy as np
import pytest

from airwave_tpu.assets import channel_maps as jcm
from airwave_tpu.graph.renderer import prepare_renderer as jprepare
from airwave_tpu.io.wav import WAVData as JWAVData
from airwave_tpu.oracle.upols_oracle import UPOLSOracle
from airwave_tpu.runtime.stream_pool import StreamPool as JPool
from airwave_tpu.shell import serve as jserve
from airwave_tpu.shell import wire_client as jwire
from airwave_tpu_torch.assets import channel_maps as tcm
from airwave_tpu_torch.graph.renderer import prepare_renderer as tprepare
from airwave_tpu_torch.io.wav import WAVData as TWAVData
from airwave_tpu_torch.runtime.stream_pool import StreamPool as TPool
from airwave_tpu_torch.shell.loadgen import run_load
from airwave_tpu_torch.shell.serve import RenderServer
from airwave_tpu_torch.shell.wire_client import render_via_server
from airwave_tpu_torch.utils.checkpoint import (load_pool_snapshot,
                                                save_pool_snapshot)
from _torch_sigpipe import sigpipe_ignored  # noqa: F401

SR = 48_000.0
BLOCK = 64
TOL = 1e-5       # the port's server against the JAX server, and float64
_LEN = struct.Struct("<I")


def rel_rms(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((a - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def bank(seed=5, frames=300):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((14, frames)) * 0.2).astype(np.float32)


def port_renderer(audio, M=1):
    return tprepare(TWAVData(SR, audio), tcm.STEREO, SR, BLOCK, lookahead=M,
                    device="cpu")


def port_pool(audio, lanes=8, **kw):
    return TPool(lanes, SR, port_renderer(audio), block_size=BLOCK,
                 device="cpu", **kw)


def jax_pool(audio, lanes=8):
    return JPool(lanes, SR, jprepare(JWAVData(SR, audio), jcm.STEREO, SR,
                                     BLOCK), block_size=BLOCK)


class running:
    """A started server, stopped on exit."""

    def __init__(self, server):
        self.server = server

    def __enter__(self):
        self.server.start()
        return self.server

    def __exit__(self, *exc):
        self.server.stop()


def oracle(audio, x):
    """float64 UPOLS render of stereo x [2, n] (n a multiple of BLOCK)
    through the bank's FL/FR pairs."""
    nblk = x.shape[1] // BLOCK
    m = tcm.hesuvi_14_channel(tcm.STEREO.channels)
    ref = np.zeros((2, nblk * BLOCK))
    for spk, speaker in ((0, tcm.FL), (1, tcm.FR)):
        for ear, ch in zip((0, 1), m.indices(speaker)):
            o = UPOLSOracle(audio[ch], BLOCK)
            ref[ear] += np.concatenate(
                [o.process(x[spk, i * BLOCK:(i + 1) * BLOCK])
                 for i in range(nblk)])
    return ref


def wait_detached(pool, timeout=5.0) -> bool:
    deadline = time.monotonic() + timeout
    while pool._attached and time.monotonic() < deadline:
        time.sleep(0.01)
    return not pool._attached


def _read_until_eof(conn):
    frames = 0
    while True:
        raw = b""
        while len(raw) < 4:
            piece = conn.recv(4 - len(raw))
            if not piece:
                return frames, False
            raw += piece
        (n,) = _LEN.unpack(raw)
        if n == 0:
            return frames, True
        need = n * 2 * 4
        while need:
            piece = conn.recv(min(need, 1 << 16))
            if not piece:
                return frames, False
            need -= len(piece)
        frames += n


@pytest.fixture(params=["thread", "selector"])
def server(request):
    audio = bank()
    srv = RenderServer(port_pool(audio), port=0, io_mode=request.param)
    with running(srv):
        yield srv, audio


def test_hostile_payloads_do_not_leak_across_lanes(server):
    """tests/test_serve.py:161: a NaN/Inf client beside a good one leaves
    the good lane within f32 rounding of its solo render, a client that
    dies mid-payload releases its slot, and the pump survives. The solo
    render is also the JAX server's within 1e-5."""
    srv, audio = server
    rng = np.random.default_rng(7)
    good = (rng.standard_normal((2, 4 * BLOCK)) * 0.3).astype(np.float32)
    solo = render_via_server(srv.address, good)
    with running(jserve.RenderServer(jax_pool(audio), port=0,
                                     io_mode=srv.io_mode)) as jsrv:
        assert rel_rms(solo, jwire.render_via_server(jsrv.address, good)) \
            < TOL

    def hostile():
        conn = socket.create_connection(srv.address, timeout=10)
        try:
            conn.sendall(json.dumps({"channels": 2}).encode() + b"\n")
            evil = np.full((2, BLOCK), np.nan, np.float32)
            evil[0, ::3] = np.inf
            payload = evil.T.reshape(-1).tobytes()
            for _ in range(4):
                conn.sendall(_LEN.pack(BLOCK) + payload)
                time.sleep(0.005)
            conn.sendall(_LEN.pack(0))
            _read_until_eof(conn)
        finally:
            conn.close()

    t = threading.Thread(target=hostile)
    t.start()
    try:
        got = render_via_server(srv.address, good)
    finally:
        t.join()
    assert np.all(np.isfinite(got))
    assert rel_rms(got, solo) < 1e-6, "a NaN lane leaked into a neighbor"

    conn = socket.create_connection(srv.address, timeout=10)
    conn.sendall(json.dumps({"channels": 2}).encode() + b"\n")
    conn.sendall(_LEN.pack(BLOCK))
    conn.sendall(b"\x00" * (BLOCK * 2 * 4 // 2))
    conn.close()
    assert wait_detached(srv.pool), "the truncated client leaked its slot"
    assert srv.pump_errors == 0
    again = render_via_server(srv.address, good)
    assert np.all(np.isfinite(again))
    assert rel_rms(again, solo) < 1e-6, "hostile traffic left residue"


def test_concurrent_clients_share_device_steps(server):
    """tests/test_serve.py:241: four concurrent clients' blocks coalesce
    into shared rounds, well under one round a block."""
    srv, _ = server
    srv.batch_window = 0.02  # widen the coalescing window
    rng = np.random.default_rng(7)
    n_clients, n_blocks = 4, 6
    signals = [(rng.standard_normal((2, n_blocks * BLOCK)) * 0.3).astype(
        np.float32) for _ in range(n_clients)]
    rounds_before = srv.pool.rounds
    blocks_before = srv.pool.blocks_rendered
    results = [None] * n_clients

    def client(i):
        results[i] = render_via_server(srv.address, signals[i], chunk=BLOCK)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    for r in results:
        assert r is not None and r.shape == (2, n_blocks * BLOCK)
    blocks = srv.pool.blocks_rendered - blocks_before
    rounds = srv.pool.rounds - rounds_before
    assert blocks == n_clients * n_blocks
    assert rounds <= blocks * 0.75, (rounds, blocks)


def test_churn_soak(server):
    """tests/test_serve.py:278, its 4-wave form: 1-3 clients a wave of
    ragged lengths and chunks; every output full-length and finite, and no
    slot leaked."""
    srv, _ = server
    rng = np.random.default_rng(11)
    for wave in range(4):
        k = 1 + (wave % 3)
        signals = [(rng.standard_normal((2, (1 + wave % 4) * BLOCK + wave % 17))
                    * 0.3).astype(np.float32) for _ in range(k)]
        results = [None] * k
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, render_via_server(srv.address, signals[i], chunk=97)))
            for i in range(k)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        for i, r in enumerate(results):
            assert r is not None and r.shape == signals[i].shape, (wave, i)
            assert np.all(np.isfinite(r))
    assert wait_detached(srv.pool)
    assert len(srv.pool._free) == srv.pool.max_streams


def test_live_renderer_swap_through_server(server):
    """tests/test_serve.py:323: RenderServer.set_renderer to a bank of
    another partition count (history reset, prewarmed) renders the next
    client through the new bank: within 1e-5 of float64 and of the JAX
    server after the same swap."""
    srv, audio = server
    rng = np.random.default_rng(6)
    new_audio = (rng.standard_normal((14, 500)) * 0.2).astype(np.float32)
    new_renderer = port_renderer(new_audio)
    assert new_renderer.partition_count != srv.pool.renderer.partition_count
    srv.set_renderer(new_renderer)
    x = (rng.standard_normal((2, 4 * BLOCK)) * 0.3).astype(np.float32)
    y = render_via_server(srv.address, x)
    assert rel_rms(y, oracle(new_audio, x)) < TOL
    with running(jserve.RenderServer(jax_pool(audio), port=0,
                                     io_mode=srv.io_mode)) as jsrv:
        jsrv.set_renderer(jprepare(JWAVData(SR, new_audio), jcm.STEREO, SR,
                                   BLOCK))
        yj = jwire.render_via_server(jsrv.address, x)
    assert rel_rms(y, yj) < TOL


def test_accept_limit_saturation_is_clean():
    """tests/test_serve.py:415: one 16-wide connect wave against 8 lanes:
    8 complete, 8 are refused before the ack (counted in rejected_full),
    no protocol error, and the server serves afterwards."""
    pool = port_pool(bank())
    pool.prewarm()
    with running(RenderServer(pool, port=0, io_mode="selector")) as srv:
        res = run_load(tuple(srv.address), clients=16, blocks_each=6,
                       chunk=4 * BLOCK, speed=1.0, connect_burst=16,
                       timeout=60.0)
        assert res["completed"] == 8 and res["failed"] == 8, res
        assert res["fail_reasons"] == ["rejected before ack"], res
        assert srv.rejected_full == 8 and srv.protocol_errors == 0
        x = (np.random.default_rng(5).standard_normal((2, 4 * BLOCK))
             * 0.2).astype(np.float32)
        y = render_via_server(srv.address, x, chunk=BLOCK)
        assert y.shape == x.shape and np.isfinite(y).all()


def test_selector_stall_backpressure_and_fixed_deadline():
    """tests/test_serve.py:450: a selector connection whose push cannot
    land stops being read (the server takes a bounded prefix of a 6 MiB
    flood) and closes at its fixed deadline although delivery passes keep
    retrying the push; the lane is released and the server serves on."""
    rng = np.random.default_rng(9)
    pool = port_pool(bank(9), lanes=2)
    srv = RenderServer(pool, port=0, io_mode="selector", client_timeout=2.0)
    blocked: set = set()
    orig_push = pool.push

    def push(stream, frames):
        if stream in blocked:
            raise OverflowError("forced: lane cannot drain")
        return orig_push(stream, frames)

    pool.push = push
    stop_wakes = threading.Event()

    def waker():
        # Concurrent traffic's stand-in: each wake runs a delivery pass,
        # which retries the pinned push (it must not re-arm the deadline).
        while not stop_wakes.is_set():
            srv._wake_io()
            time.sleep(0.05)

    wt = threading.Thread(target=waker, daemon=True)
    with running(srv):
        try:
            conn = socket.create_connection(srv.address, timeout=10)
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 17)
            conn.sendall(json.dumps({"channels": 2, "want_lane": True})
                         .encode() + b"\n")
            line = b""
            while not line.endswith(b"\n"):
                line += conn.recv(64)
            blocked.add(int(json.loads(line.decode())["lane"]))
            wt.start()
            msg = (_LEN.pack(3 * BLOCK)
                   + np.zeros((3 * BLOCK, 2), "<f4").tobytes())
            payload = memoryview(bytes(msg * (6 * (1 << 20) // len(msg))))
            conn.setblocking(False)
            accepted, closed = 0, False
            t_end = time.monotonic() + 8.0  # well past the 2 s deadline
            while time.monotonic() < t_end and accepted < len(payload):
                try:
                    accepted += conn.send(
                        payload[accepted:accepted + (1 << 16)])
                except BlockingIOError:
                    time.sleep(0.02)
                except OSError:  # the server closed the stalled connection
                    closed = True
                    break
            assert accepted < (2 << 20), (
                f"the server kept reading a stalled connection ({accepted} "
                f"of {len(payload)} bytes)")
            deadline = time.monotonic() + 10.0
            conn.setblocking(True)
            conn.settimeout(1.0)
            while not closed and time.monotonic() < deadline:
                try:
                    data = conn.recv(4096)
                except socket.timeout:
                    continue
                except OSError:
                    closed = True
                    break
                if not data or _LEN.unpack(data[:4])[0] == 0:
                    closed = True
            assert closed, "the stalled connection never hit its deadline"
            blocked.clear()
            conn.close()
            x = (rng.standard_normal((2, 4 * BLOCK)) * 0.2).astype(np.float32)
            y = render_via_server(srv.address, x, chunk=96)
            assert y.shape == x.shape and np.isfinite(y).all()
            assert srv.pump_errors == 0
        finally:
            stop_wakes.set()


def test_serve_latency_budget_loopback():
    """tests/test_serve.py:554: two clients at 0.25x realtime on a
    prewarmed 4-lane pool: the client-observed chunk latency p50 within
    100 ms and the server's wire-to-wire p50 within 60 ms."""
    pool = port_pool(bank(), lanes=4)
    pool.prewarm()
    with running(RenderServer(pool, port=0, io_mode="selector")) as srv:
        # Untimed warm-up: first-touch costs belong to start-up.
        run_load(tuple(srv.address), clients=2, blocks_each=4,
                 chunk=4 * BLOCK, speed=0.25, timeout=60.0)
        srv.reset_latency()
        res = run_load(tuple(srv.address), clients=2, blocks_each=24,
                       chunk=4 * BLOCK, speed=0.25, timeout=60.0)
        assert res["completed"] == 2 and res["failed"] == 0, res
        assert res["chunk_latency"]["p50_ms"] <= 100.0, res["chunk_latency"]
        srv_lat = srv.latency_stats()
        assert srv_lat["p50_ms"] <= 60.0, srv_lat


def test_full_pool_rejects_connection_cleanly():
    """tests/test_serve.py:594: with the one lane held by a half-open
    client, a second client is refused with a clean close (counted), and
    served once the lane is free."""
    pool = port_pool(bank(), lanes=1)
    with running(RenderServer(pool, port=0)) as srv:
        holder = socket.create_connection(srv.address, timeout=10)
        holder.sendall(json.dumps({"channels": 2}).encode() + b"\n")
        deadline = time.monotonic() + 5
        while not pool._attached and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pool._attached
        x = np.ones((2, BLOCK), np.float32) * 0.2
        y = render_via_server(srv.address, x)
        assert y.shape == (2, 0)
        assert srv.rejected_full == 1
        holder.close()
        assert wait_detached(pool)
        y = render_via_server(srv.address, x)
        assert y.shape == (2, BLOCK)


def test_tokenless_restored_lanes_expire_and_hostile_tokens_are_safe(
        tmp_path):
    """tests/test_serve.py:1023: a library checkpoint (no resume tokens)
    restored under a server grace-expires its dead lanes; a non-ASCII
    resume token is a counted protocol error that leaves the orphan lane
    unclaimed."""
    renderer = port_renderer(bank(31))
    a = TPool(4, SR, renderer, block_size=BLOCK, device="cpu")
    a.attach()
    a.attach()
    path = str(tmp_path / "tokenless")
    save_pool_snapshot(path, a.snapshot())  # the library flow: no tokens
    b = TPool(4, SR, renderer, block_size=BLOCK, device="cpu")
    snap = load_pool_snapshot(path, b)
    assert "resume_tokens" not in snap
    b.restore(snap)
    srv = RenderServer(b, port=0, resume_grace=0.2,
                       orphan_tokens=snap.get("resume_tokens", {}) or {})
    with running(srv):
        assert wait_detached(b), "token-less restored lanes leaked"
        assert srv.expired_orphans == 2
        c = TPool(4, SR, renderer, block_size=BLOCK, device="cpu")
        c.attach()
        with running(RenderServer(c, port=0, resume_grace=30.0,
                                  orphan_tokens={0: "deadbeef"})) as srv2:
            errs = srv2.protocol_errors
            conn = socket.create_connection(srv2.address, timeout=10)
            conn.sendall(('{"channels": 2, "resume": 0, '
                          '"token": "á"}\n').encode())
            assert conn.recv(16) in (b"\x00\x00\x00\x00", b"")
            conn.close()
            deadline = time.monotonic() + 5
            while srv2.protocol_errors == errs and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
            assert srv2.protocol_errors == errs + 1
            assert srv2.stats()["orphan_lanes"] == 1  # not consumed


def test_tier_added_latency_is_measured():
    """tests/test_serve.py:1084: blocks pushed until a lane's first rendered
    frame, solo and beside a saturated neighbor: exactly M on the ring tier
    (M=1, no added block) and the paged tier (M=4), on the port's pool and
    on the JAX pool alike."""
    audio14 = bank(50)
    for m in (1, 4):
        pools = [
            TPool(4, SR, port_renderer(audio14, m), block_size=BLOCK,
                  blocks_per_step=m, ring_blocks=8 * m, device="cpu"),
            JPool(4, SR, jprepare(JWAVData(SR, audio14), jcm.STEREO, SR,
                                  BLOCK, lookahead=m),
                  block_size=BLOCK, blocks_per_step=m, ring_blocks=8 * m),
        ]
        counts = []
        for pool in pools:
            rng = np.random.default_rng(50)
            a, b = pool.attach(), pool.attach()

            def blocks_to_first_output(lane, feed_neighbor):
                for k in range(1, 3 * m + 2):
                    pool.push(lane, (rng.standard_normal((2, BLOCK)) * 0.3
                                     ).astype(np.float32))
                    if feed_neighbor:
                        pool.push(b, (rng.standard_normal((2, m * BLOCK))
                                      * 0.3).astype(np.float32))
                    pool.pump()
                    if pool.available(lane):
                        return k
                raise AssertionError(f"no output after {3 * m + 1} blocks")

            solo = blocks_to_first_output(a, feed_neighbor=False)
            pool.detach(a)
            a = pool.attach()
            contended = blocks_to_first_output(a, feed_neighbor=True)
            pool.detach(a)
            pool.detach(b)
            counts.append((solo, contended))
        assert counts[0] == counts[1] == (m, m), (m, counts)
