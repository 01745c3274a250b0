"""shell/serve.RenderServer, shell/wire_client and utils/checkpoint of the
PyTorch port against the JAX package's, on the CPU.

The port's server runs the port's pool (device="cpu", the kernels' plain
versions); the JAX one runs under JAX_PLATFORMS=cpu. Shapes are those of
tests/test_serve.py: block 64, 8 lanes, a seeded 14-channel 300-frame bank.
Rendered audio is held within 1e-5 rel-RMS of the float64 UPOLS oracle and
of the JAX server on the same input; wire bytes and checkpoint files are
exchanged between the packages in both directions.
"""

import json
import os
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
from airwave_tpu.utils import checkpoint as jckpt
from airwave_tpu_torch.assets import channel_maps as tcm
from airwave_tpu_torch.graph.renderer import prepare_renderer as tprepare
from airwave_tpu_torch.io.wav import WAVData as TWAVData
from airwave_tpu_torch.runtime.stream_pool import StreamPool as TPool
from airwave_tpu_torch.shell import serve as tserve
from airwave_tpu_torch.shell import wire_client as twire
from airwave_tpu_torch.shell.app import restore_serve_checkpoint
from airwave_tpu_torch.utils import checkpoint as tckpt
from _torch_sigpipe import sigpipe_ignored  # noqa: F401

SR = 48_000.0
BLOCK = 64
TOL = 1e-5
_LEN = struct.Struct("<I")



def rel_rms(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((a - ref) ** 2)) / np.sqrt(np.mean(ref ** 2))


def bank(seed=5, frames=300):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((14, frames)) * 0.2).astype(np.float32)


def port_pool(audio, lanes=8, M=1, **kw):
    renderer = tprepare(TWAVData(SR, audio), tcm.STEREO, SR, BLOCK,
                        lookahead=M, device="cpu")
    return TPool(lanes, SR, renderer, block_size=BLOCK, blocks_per_step=M,
                 device="cpu", **kw)


def jax_pool(audio, lanes=8, M=1, **kw):
    renderer = jprepare(JWAVData(SR, audio), jcm.STEREO, SR, BLOCK,
                        lookahead=M)
    return JPool(lanes, SR, renderer, block_size=BLOCK, blocks_per_step=M,
                 **kw)


class running:
    """A started server, stopped on exit."""

    def __init__(self, server):
        self.server = server

    def __enter__(self):
        self.server.start()
        return self.server

    def __exit__(self, *exc):
        self.server.stop()


def oracle(audio, x, step=BLOCK):
    """float64 UPOLS render of stereo x [2, n] through the bank's FL/FR
    pairs, the input zero-padded to the pool's step."""
    n = x.shape[1]
    padded = np.concatenate([x, np.zeros((2, (-n) % step), np.float32)], 1)
    nblk = padded.shape[1] // BLOCK
    m = tcm.hesuvi_14_channel(tcm.STEREO.channels)
    ref = np.zeros((2, nblk * BLOCK))
    for spk, speaker in ((0, tcm.FL), (1, tcm.FR)):
        for ear, ch in zip((0, 1), m.indices(speaker)):
            o = UPOLSOracle(audio[ch], BLOCK)
            ref[ear] += np.concatenate(
                [o.process(padded[spk, i * BLOCK:(i + 1) * BLOCK])
                 for i in range(nblk)])
    return ref[:, :n]


@pytest.fixture(params=["thread", "selector"])
def server(request):
    audio = bank()
    srv = tserve.RenderServer(port_pool(audio), port=0, io_mode=request.param)
    with running(srv):
        yield srv, audio


def wait_detached(pool, timeout=5.0):
    deadline = time.monotonic() + timeout
    while pool._attached and time.monotonic() < deadline:
        time.sleep(0.01)
    return not pool._attached


def test_roundtrip_matches_oracle_and_jax_server(server):
    """The port's server against float64 and against the JAX server on the
    JAX pool, same input, same data plane (tests/test_serve.py:34)."""
    srv, audio = server
    rng = np.random.default_rng(0)
    n = 6 * BLOCK + 13  # ragged tail
    x = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    y = twire.render_via_server(srv.address, x, chunk=100)
    assert y.shape == (2, n)
    assert rel_rms(y, oracle(audio, x)) < TOL
    with running(jserve.RenderServer(jax_pool(audio), port=0,
                                     io_mode=srv.io_mode)) as jsrv:
        yj = jwire.render_via_server(jsrv.address, x, chunk=100)
    assert rel_rms(y, yj) < TOL


def test_concurrent_clients_are_isolated(server):
    srv, _ = server
    rng = np.random.default_rng(1)
    signals = [(rng.standard_normal((2, 4 * BLOCK)) * 0.3).astype(np.float32)
               for _ in range(4)]
    results = [None] * 4

    def client(i):
        results[i] = twire.render_via_server(srv.address, signals[i], chunk=64)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    solo = twire.render_via_server(srv.address, signals[2], chunk=4 * BLOCK)
    np.testing.assert_allclose(results[2], solo, atol=1e-5)
    for r in results:
        assert r is not None and r.shape[1] == 4 * BLOCK
        assert np.all(np.isfinite(r))
    assert srv.connections_served == 5


def _read_until_eof(conn):
    frames = 0
    while True:
        raw = twire._read_exact(conn, 4)
        if raw is None:
            return frames, False
        (n,) = _LEN.unpack(raw)
        if n == 0:
            return frames, True
        if twire._read_exact(conn, n * 8) is None:
            return frames, False
        frames += n


def test_malformed_header_and_wire_limits_close_cleanly(server):
    """A non-JSON header, a bad channel count and an oversized message each
    close with the clean EOF frame, count a protocol error and release the
    lane; the server keeps serving (tests/test_serve.py:88,125)."""
    srv, _ = server
    conn = socket.create_connection(srv.address, timeout=5)
    conn.sendall(b"this is not json\n")
    conn.close()
    for header, tail in (({"channels": 7}, b""),
                         ({"channels": 2},
                          _LEN.pack(srv.max_message_frames + 1))):
        conn = socket.create_connection(srv.address, timeout=5)
        conn.sendall(json.dumps(header).encode() + b"\n" + tail)
        assert _read_until_eof(conn)[1]
        conn.close()
    assert srv.protocol_errors >= 2
    assert srv.max_message_frames == (srv.pool.assembler.capacity
                                      - (srv.pool.step_frames - 1))
    x = np.ones((2, BLOCK), np.float32) * 0.2
    assert twire.render_via_server(srv.address, x).shape == (2, BLOCK)
    assert wait_detached(srv.pool)


def test_pump_thread_survives_render_exceptions(server):
    """tests/test_serve.py:358: a round that raises is counted and retried;
    the pump thread lives and the input is not lost."""
    srv, _ = server
    real_pump = srv.pool.pump
    fired = threading.Event()

    def flaky_pump(*args, **kwargs):
        if not fired.is_set():
            fired.set()
            raise RuntimeError("injected transient device failure")
        return real_pump(*args, **kwargs)

    srv.pool.pump = flaky_pump
    try:
        x = (np.random.default_rng(3).standard_normal((2, 4 * BLOCK))
             * 0.3).astype(np.float32)
        y = twire.render_via_server(srv.address, x, chunk=2 * BLOCK)
        assert fired.is_set() and srv.pump_errors >= 1
        assert srv._pump_thread.is_alive()
        assert y.shape == (2, 4 * BLOCK) and np.abs(y).max() > 1e-4
    finally:
        srv.pool.pump = real_pump


def test_stats_surface_and_latency(server):
    """stats() reports server counters, wire-to-wire latency and the pool's
    host counters (tests/test_serve.py:830,1132)."""
    srv, _ = server
    before = srv.stats()
    assert before["latency"] == {"count": 0}
    assert before["pool"]["attached"] == 0
    assert before["pool"]["attached_per_group"] is None
    assert before["pool"]["groups"] == 1
    x = (np.random.default_rng(13).standard_normal((2, 6 * BLOCK + 13))
         * 0.3).astype(np.float32)
    assert twire.render_via_server(srv.address, x, chunk=BLOCK).shape == x.shape
    after = srv.stats()
    assert after["connections_served"] == before["connections_served"] + 1
    assert after["pool"]["rounds"] >= before["pool"]["rounds"] + 7
    assert after["pump_errors"] == 0 and after["pool"]["render_errors"] == 0
    lat = after["latency"]
    assert lat["count"] > 0
    assert 0.0 <= lat["p50_ms"] <= lat["p90_ms"] <= lat["p99_ms"] \
        <= lat["max_ms"] < 10_000.0


def test_multiblock_pool_roundtrip_matches_oracle_and_jax():
    """The paged tier (M=2) behind the server: exact frame count back, the
    ragged tail flushed at the 2-block step (tests/test_serve.py:634)."""
    audio, M = bank(), 2
    rng = np.random.default_rng(5)
    n = 5 * BLOCK + 13
    x = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    with running(tserve.RenderServer(port_pool(audio, M=M), port=0)) as srv:
        y = twire.render_via_server(srv.address, x, chunk=100)
        assert srv.truncated_closes == 0 and srv.pump_errors == 0
    assert y.shape == (2, n)
    assert rel_rms(y, oracle(audio, x, M * BLOCK)) < TOL
    with running(jserve.RenderServer(jax_pool(audio, M=M), port=0)) as jsrv:
        yj = jwire.render_via_server(jsrv.address, x, chunk=100)
    assert rel_rms(y, yj) < TOL


def test_loadgen_concurrent_scale_smoke():
    """The port's load generator against the port's selector server: every
    paced client completes, with no protocol error, truncation or refusal
    (tests/test_serve.py:386)."""
    from airwave_tpu_torch.shell.loadgen import run_load

    pool = port_pool(bank(), lanes=24)
    pool.prewarm()
    with running(tserve.RenderServer(pool, port=0, io_mode="selector")) as srv:
        res = run_load(tuple(srv.address), clients=16, blocks_each=4,
                       chunk=4 * BLOCK, speed=4.0, timeout=60.0)
        st = srv.stats()
    assert res["completed"] == 16 and res["failed"] == 0, res
    assert st["protocol_errors"] == 0 and st["truncated_closes"] == 0
    assert st["rejected_full"] == 0 and st["connections_served"] == 16


# --- the wire between the packages ------------------------------------------


class Recorder:
    """A TCP endpoint that records every byte a client sends and answers
    with a lane ack (when asked) and the clean EOF frame once the client's
    EOF frame has arrived."""

    def __init__(self):
        self.listener = socket.create_server(("127.0.0.1", 0))
        self.address = self.listener.getsockname()
        self.received = []
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.listener.accept()
            except OSError:
                return
            with conn:
                data = bytearray()
                while not data.endswith(b"\n"):
                    data += conn.recv(1)
                header = json.loads(data.decode())
                if header.get("want_lane"):
                    conn.sendall(b'{"lane": 3, "token": "t"}\n')
                while True:
                    raw = twire._read_exact(conn, 4)
                    data += raw
                    (n,) = _LEN.unpack(raw)
                    if n == 0:
                        break
                    data += twire._read_exact(conn, n * header["channels"] * 4)
                conn.sendall(_LEN.pack(0))
                self.received.append(bytes(data))

    def close(self):
        self.listener.close()


def test_wire_bytes_are_identical_between_packages():
    """Both packages' clients put the same bytes on the wire (header line,
    length-prefixed frames, EOF) for the same call; the JAX client against
    the port's server and the port's client against the JAX server each
    receive exactly the frames their own package's client receives from a
    fresh server of the same construction."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 3 * BLOCK + 5)) * 0.3).astype(np.float32)
    rec = Recorder()
    try:
        calls = [dict(chunk=100), dict(chunk=64, resume=3, resume_token="t"),
                 dict(chunk=BLOCK, on_lane=lambda ack: None)]
        for kw in calls:
            for client in (jwire.render_via_server, twire.render_via_server):
                client(rec.address, x, **kw)
        deadline = time.monotonic() + 5
        while len(rec.received) < 2 * len(calls) and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        rec.close()
    assert len(rec.received) == 2 * len(calls)
    for a, b in zip(rec.received[::2], rec.received[1::2]):
        assert a == b

    audio = bank()
    outs = {}
    for name, make, client in (
            ("port_port", lambda: tserve.RenderServer(port_pool(audio), port=0),
             twire.render_via_server),
            ("port_jaxclient", lambda: tserve.RenderServer(port_pool(audio),
                                                           port=0),
             jwire.render_via_server),
            ("jax_jax", lambda: jserve.RenderServer(jax_pool(audio), port=0),
             jwire.render_via_server),
            ("jax_portclient", lambda: jserve.RenderServer(jax_pool(audio),
                                                           port=0),
             twire.render_via_server)):
        with running(make()) as srv:
            outs[name] = client(srv.address, x, chunk=100)
    assert np.array_equal(outs["port_port"], outs["port_jaxclient"])
    assert np.array_equal(outs["jax_jax"], outs["jax_portclient"])
    assert rel_rms(outs["port_port"], outs["jax_jax"]) < TOL


# --- checkpoints and restart resume ------------------------------------------


def _ack(conn):
    line = b""
    while not line.endswith(b"\n"):
        line += conn.recv(1)
    return json.loads(line.decode())


def _stream_first_half(srv, x, frames):
    """Stream x[:, :frames] on a want_lane connection kept open to a
    selector-plane server, and read exactly `frames` rendered frames: that
    plane delivers every rendered frame to the wire after each round (the
    pool is not drained here, which could race the IO thread's delivery and
    reorder the frames). Returns (conn, lane, token, rendered)."""
    assert srv.io_mode == "selector"
    conn = socket.create_connection(srv.address, timeout=30)
    conn.sendall(json.dumps({"channels": 2, "want_lane": True}).encode()
                 + b"\n")
    ack = _ack(conn)
    lane, token = int(ack["lane"]), ack["token"]
    for t in range(0, frames, BLOCK):
        piece = x[:, t:t + BLOCK]
        conn.sendall(_LEN.pack(piece.shape[1])
                     + piece.T.astype("<f4").tobytes())
    pieces, have = [], 0
    while have < frames:
        (k,) = _LEN.unpack(twire._read_exact(conn, 4))
        assert k, "the server closed the stream early"
        pieces.append(np.frombuffer(twire._read_exact(conn, k * 8),
                                    "<f4").reshape(k, 2).T)
        have += k
    assert have == frames
    return conn, lane, token, np.concatenate(pieces, axis=1)


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_restart_resume_continues_stream(tmp_path, writer, reader):
    """Checkpoint -> restart -> {"resume": lane, "token": ...}: the stream
    continues as the uninterrupted render (tests/test_serve.py:883), also
    when one package's server writes the checkpoint and the other's
    restores it; a wrong token never claims the orphan, unclaimed orphans
    expire."""
    audio = bank(21)
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((2, 4 * BLOCK)) * 0.3).astype(np.float32)
    make = {"port": (lambda: tserve.RenderServer(port_pool(audio, 4), port=0)),
            "jax": (lambda: jserve.RenderServer(jax_pool(audio, 4), port=0))}
    with running(make["port"]()) as ref:
        want = twire.render_via_server(ref.address, x, chunk=BLOCK)

    ckpt = str(tmp_path / "serve_ckpt")
    with running(make[writer]()) as srv_a:
        conn, lane, token, first = _stream_first_half(srv_a, x, 2 * BLOCK)
        srv_a.save_checkpoint(ckpt)  # the lane is attached: conn is open
        conn.close()
    # One package's render against the other's is held to the packages'
    # tolerance; the port against itself as tests/test_serve.py holds JAX.
    def check(got, ref):
        if writer == reader == "port":
            np.testing.assert_allclose(got, ref, atol=1e-6)
        else:
            assert rel_rms(got, ref) < TOL

    check(first, want[:, :2 * BLOCK])

    if reader == "port":
        pool_b = port_pool(audio, 4)
        resumed, tokens, aliases = restore_serve_checkpoint(ckpt, pool_b)
        assert resumed and aliases is None
        srv_b = tserve.RenderServer(pool_b, port=0, orphan_tokens=tokens)
    else:
        pool_b = jax_pool(audio, 4)
        snap = jckpt.load_pool_snapshot(ckpt, pool_b)
        pool_b.restore(snap)
        srv_b = jserve.RenderServer(pool_b, port=0,
                                    orphan_tokens=snap["resume_tokens"])
    with running(srv_b):
        assert srv_b.stats()["orphan_lanes"] == 1
        errs = srv_b.protocol_errors
        for bad in (None, "not-the-token"):
            out = twire.render_via_server(srv_b.address, x[:, :BLOCK],
                                          resume=lane, resume_token=bad)
            assert out.shape[1] == 0
        assert srv_b.protocol_errors == errs + 2
        assert srv_b.stats()["orphan_lanes"] == 1
        second = twire.render_via_server(srv_b.address, x[:, 2 * BLOCK:],
                                         chunk=BLOCK, resume=lane,
                                         resume_token=token)
        assert srv_b.resumed_streams == 1
    check(second, want[:, 2 * BLOCK:])

    if writer == reader == "port":
        pool_c = port_pool(audio, 4)
        _, tokens, _ = restore_serve_checkpoint(ckpt, pool_c)
        srv_c = tserve.RenderServer(pool_c, port=0, resume_grace=0.2,
                                    orphan_tokens=tokens)
        with running(srv_c):
            assert wait_detached(pool_c)
            assert srv_c.expired_orphans == 1


def test_checkpoint_header_matches_jax_for_both_tiers(tmp_path):
    """The port writes the header JAX writes for the same one-profile carry
    (treedef string, carry tag, leaf shapes and dtypes, the ring cursor as a
    0-d int32), and each package's file loads in the other's pool."""
    audio = bank()
    for M in (1, 2):
        tp, jp = port_pool(audio, M=M), jax_pool(audio, M=M)
        for pool in (tp, jp):
            pool.attach()
            pool.attach()
            pool.push_many([0, 1], np.ones((2, 2, M * BLOCK), np.float32))
            pool.pump()
        tpath, jpath = str(tmp_path / f"t{M}"), str(tmp_path / f"j{M}")
        tckpt.save_pool_snapshot(tpath, tp.snapshot())
        jckpt.save_pool_snapshot(jpath, jp.snapshot())
        with tckpt._RawReader(tckpt.checkpoint_path(tpath)) as t, \
                tckpt._RawReader(tckpt.checkpoint_path(jpath)) as j:
            assert t.treedef_repr == j.treedef_repr
            assert t.extra["carry"] == j.extra["carry"]
            assert [(m["shape"], m["dtype"], m["offset"], m["nbytes"])
                    for m in t.leaves] == [
                        (m["shape"], m["dtype"], m["offset"], m["nbytes"])
                        for m in j.leaves]
        want = {1: ".counter,.fdl,.s_from,.s_to,.write_pos",
                2: ".counter,.s_from,.s_to,[0],[1],[2],[3]"}[M]
        assert tckpt._carry_format(tp.snapshot()["state"]) == want
        assert tckpt.snapshot_lane_count(jpath) == 8
        tp.restore(tckpt.load_pool_snapshot(jpath, tp))
        jp.restore(jckpt.load_pool_snapshot(tpath, jp))
        assert sorted(tp._attached) == sorted(jp._attached) == [0, 1]


def test_checkpoint_resize_and_versioning(tmp_path):
    """A checkpoint of another --max-streams resizes on load; a schema-less
    file whose arrays fit loads, as in the JAX package (tests/
    test_serve.py:1203); another schema, the pre-half-window npz fixture, a
    carry tag that changed without a schema bump and a pool of another
    shape each raise the versioned SnapshotCompatError (tests/
    test_serve.py:1159,1300)."""
    audio = bank(41)
    a = port_pool(audio, 4)
    a.attach()
    path = str(tmp_path / "ckpt")
    tckpt.save_pool_snapshot(path, {**a.snapshot(), "resume_tokens": {0: "s"}})

    b = port_pool(audio, 8)
    resumed, tokens, aliases = restore_serve_checkpoint(path, b)
    assert resumed and len(b._attached) == 1 and tokens == {0: "s"}
    assert aliases == {0: 0}
    assert os.path.exists(tckpt.checkpoint_path(path))

    with tckpt._RawReader(tckpt.checkpoint_path(path)) as saved:
        extra = saved.extra
    tree = tckpt._host_tree(a.snapshot()["state"], a._debt)
    for name, changed, match in (
            ("future", dict(extra, schema=tckpt.POOL_SNAPSHOT_SCHEMA + 1),
             r"schema 3 is incompatible.*schema 2"),
            ("forgot_bump", dict(extra, carry=extra["carry"] + ",.overlap"),
             "carry format.*schema bump")):
        p = str(tmp_path / name)
        tckpt._write_raw(p, tree, changed)
        with pytest.raises(tckpt.SnapshotCompatError, match=match):
            tckpt.load_pool_snapshot(p, a)
    schemaless = str(tmp_path / "schemaless")
    tckpt._write_raw(schemaless, tree,
                     {k: v for k, v in extra.items() if k != "schema"})
    loaded = tckpt.load_pool_snapshot(schemaless, a)
    assert loaded["attached"] == extra["attached"]
    assert "migrated_from" not in loaded
    fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                           "pool_snapshot_prehalfwindow.npz")
    with pytest.raises(tckpt.SnapshotCompatError,
                       match=r"schema 1.*schema 2"):
        tckpt.load_pool_snapshot(fixture, a)
    renderer2 = tprepare(TWAVData(SR, audio), tcm.STEREO, SR, 2 * BLOCK,
                         device="cpu")
    d = TPool(4, SR, renderer2, block_size=2 * BLOCK, device="cpu")
    with pytest.raises(tckpt.SnapshotCompatError, match="constructed differently"):
        tckpt.load_pool_snapshot(path, d)
    resumed, tokens, aliases = restore_serve_checkpoint(path, d)
    assert (resumed, tokens, aliases) == (False, None, None)
    assert not d._attached
    assert os.path.exists(tckpt.checkpoint_path(path) + ".incompatible")
    assert restore_serve_checkpoint(None, d) == (False, None, None)
    assert restore_serve_checkpoint(str(tmp_path / "missing"), d) == (
        False, None, None)


def test_unreadable_checkpoint_starts_fresh_and_is_moved_aside(tmp_path):
    """Deliberate divergence from airwave_tpu/shell/app.py:434, whose
    restore_serve_checkpoint catches only ValueError and KeyError: an empty
    file (EOFError there) and a header listing no leaves (IndexError out of
    snapshot_lane_count there) crash-loop the JAX server. The port moves
    every unreadable checkpoint aside (empty, cut in the magic, the header
    or the payload, no leaves) and starts fresh with the pool untouched."""
    audio = bank(41)
    a = port_pool(audio, 4)
    a.attach()
    full_path = str(tmp_path / "full")
    tckpt.save_pool_snapshot(full_path, a.snapshot())
    full = open(tckpt.checkpoint_path(full_path), "rb").read()
    hlen = int.from_bytes(full[8:16], "little")
    header = json.loads(full[16:16 + hlen])
    header["leaves"] = []
    no_leaves = json.dumps(header).encode()
    cases = {"empty": b"", "magic": full[:4], "header": full[:16 + hlen // 2],
             "payload": full[:len(full) // 2],
             "no_leaves": full[:8] + len(no_leaves).to_bytes(8, "little")
             + no_leaves}
    for name, data in cases.items():
        path = str(tmp_path / name)
        with open(tckpt.checkpoint_path(path), "wb") as f:
            f.write(data)
        b = port_pool(audio, 4)
        assert restore_serve_checkpoint(path, b) == (False, None, None), name
        assert not b._attached and not os.path.exists(
            tckpt.checkpoint_path(path))
        assert os.path.exists(tckpt.checkpoint_path(path) + ".incompatible")
    # The JAX helper raises out of these two instead.
    from airwave_tpu.shell.app import restore_serve_checkpoint as jrestore

    for name, error in (("empty", EOFError), ("no_leaves", IndexError)):
        path = str(tmp_path / f"jax_{name}")
        with open(tckpt.checkpoint_path(path), "wb") as f:
            f.write(cases[name])
        with pytest.raises(error):
            jrestore(path, jax_pool(audio, 4))


def test_alias_map_empties_once_every_orphan_resumed(tmp_path):
    """Deliberate divergence from airwave_tpu/shell/serve.py:460, which
    clears the resize aliases only when an orphan EXPIRES: after every
    orphan has resumed, the JAX server still holds its alias map through
    the grace window; the port's is empty as soon as the last one
    resumes."""
    audio = bank(31)
    x = np.ones((2, BLOCK), np.float32) * 0.1
    maps = {}
    for name, pool, server in (("port", port_pool(audio, 4),
                                tserve.RenderServer),
                               ("jax", jax_pool(audio, 4),
                                jserve.RenderServer)):
        lanes = [pool.attach(), pool.attach()]
        srv = server(pool, port=0, resume_grace=30.0,
                     orphan_tokens={s: f"tok{s}" for s in lanes},
                     orphan_aliases={10 + s: s for s in lanes})
        with running(srv):
            for s in lanes:
                out = twire.render_via_server(srv.address, x, resume=10 + s,
                                              resume_token=f"tok{s}")
                assert out.shape == (2, BLOCK)
            assert srv.resumed_streams == 2 and not srv._orphans
            maps[name] = dict(srv._orphan_aliases)
    assert maps["port"] == {}
    assert maps["jax"] == {10: 0, 11: 1}


def test_save_checkpoint_never_holds_lock_during_io(tmp_path, monkeypatch):
    """The serving lock covers only the device-side carry copy; the fetch
    and the file write run outside it (tests/test_serve.py:1350)."""
    srv = tserve.RenderServer(port_pool(bank()), port=0)
    in_write, release, calls = threading.Event(), threading.Event(), {}

    def slow_save(path, snap):
        calls["snap"] = snap
        in_write.set()
        assert release.wait(10)

    monkeypatch.setattr(tckpt, "save_pool_snapshot", slow_save)
    t = threading.Thread(target=srv.save_checkpoint,
                         args=(str(tmp_path / "ck"),))
    t.start()
    try:
        assert in_write.wait(10)
        assert srv._lock.acquire(timeout=2)
        srv._lock.release()
        assert "state" in calls["snap"] and "resume_tokens" in calls["snap"]
    finally:
        release.set()
        t.join(timeout=10)
    assert not t.is_alive()
    srv._listener.close()


def test_one_profile_pool_group_interface():
    """The pool interface the server calls: groups, group_size, group_of,
    renderers following set_renderer, attach(group) and
    set_equalizer(group=) with group None or 0 only."""
    pool = port_pool(bank(), 4)
    assert pool.groups == 1 and pool.group_size == 4
    assert [pool.group_of(s) for s in (0, 3, 4)] == [0, 0, 1]
    assert pool.renderers == [pool.renderer]
    assert pool.attach(0) == 0
    with pytest.raises(ValueError, match="group 1"):
        pool.attach(1)
    pool.set_equalizer(None, group=0)
    with pytest.raises(ValueError, match="group 2"):
        pool.set_equalizer(None, group=2)
    other = tprepare(TWAVData(SR, bank(6)), tcm.STEREO, SR, BLOCK,
                     device="cpu")
    pool.set_renderer(other)
    assert pool.renderers == [other]
