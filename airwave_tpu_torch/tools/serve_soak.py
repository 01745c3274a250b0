"""Wall-clock serving soak: a live RenderServer held under churn.

Port of tests/test_soak.py:test_render_server_soak as a tool a card can run:
a RenderServer on a StreamPool driven for --seconds per serving tier of
continuous attach/detach churn, ragged chunk sizes, slow readers, EQ
retargets and crossfaded HRIR hot-swaps, with the test's pass criteria.

Waves, as the test runs them, until the window closes:
  * 1-4 normal clients (ragged lengths of 2-14 blocks, ragged chunks of
    17 to 3 blocks of frames, group i % G), and a slow reader every 3rd
    wave (10 blocks sent up front, drained with a 0.05 s pause a message);
  * an EQ retarget every 5th wave (a random gain's definition), per group
    or pool-wide in turn on a grouped pool;
  * a crossfaded hot-swap every 7th wave, group by group in turn, between
    the x0.85 and x1.0 copies of the group's bank.
Pass criteria (tests/test_soak.py:215-248): no client failed and at least
3 completed; no pump error, no render error, the pump thread alive; after a
settle render (silence over the EQ ramp's rounds and 3 more) each group's
last retarget is active with no pending target; each group's last bank is
its renderer and no attached lane owes a fade; no lane left attached, every
slot free, no stashed output.

The tiers are the test's: (blocks_per_step, groups) = (1, 2) (the ring
tier as a grouped two-profile pool, banks of different lengths) and (2, 1)
(the paged tier, one profile), each pool with ring_blocks = 4 M and
prewarmed with its hot-swap rounds. The defaults are the test's fixture:
12 lanes, block 64, the seeded 300- and 700-tap banks (N(0, 1) x 0.2,
seeds 23 and 24; the wave generator continues from seed 23's draw).

On a card it also reports the pump's ms per round (p50, p99 over the pump
calls that rendered) and the live device tensors (the bytes they asked the
caching allocator for, and their count) after the first wave, after the
first wave by which every kind of wave has run (the 7th: retarget and swap
included, so the lazily built fade state exists) and at the end: the end
must not exceed that baseline, and a window that ends before the 7th wave
fails there.

Prints one JSON line per tier; exit 1 on any failure. Runs on --device (the
card by default; it raises without one); the CPU only with --device cpu or
--cpu.

    python -m airwave_tpu_torch.tools.serve_soak [--seconds 300]
        [--blocks-per-step 1 --groups 2 | --blocks-per-step 2 --groups 1]
        [--max-streams 12] [--block 64] [--hrir-taps 300,700]
        [--device cuda:0 | --cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import struct
import sys
import threading
import time

import numpy as np

from airwave_tpu_torch.device import DEFAULT_DEVICE

SAMPLE_RATE = 48_000.0
TIERS = ((1, 2), (2, 1))      # (blocks_per_step, groups)
HRIR_SEEDS = (23, 24)         # the test's banks, group by group
SWAP_SCALES = (0.85, 1.0)     # the hot-swap targets: scaled copies
EQ_RAMP = 960                 # the 20 ms EQ crossfade at 48 kHz, in samples
JOIN_SECONDS = 90.0           # a wave's clients each get this long
_LEN = struct.Struct("<I")


def eq_definition(gain_db: float):
    """The test's two-filter EQ: a peak at 900 Hz of gain_db and a high
    shelf at 6 kHz of -gain_db / 2, preamp -1.5 dB."""
    from airwave_tpu_torch.io.apo import (EqualizerDefinition, EqualizerFilter,
                                          FilterType)

    return EqualizerDefinition(-1.5, (
        EqualizerFilter(1, 1, True, FilterType.PEAKING, 900.0, gain_db, 0.8),
        EqualizerFilter(2, 2, True, FilterType.HIGH_SHELF, 6000.0,
                        -gain_db / 2, 0.7),
    ))


def seeded_bank(rng: np.random.Generator, taps: int):
    """A 14-channel bank of N(0, 1) x 0.2 from `rng`, as a WAVData."""
    from airwave_tpu_torch.io.wav import WAVData

    return WAVData(SAMPLE_RATE, (rng.standard_normal((14, taps))
                                 * 0.2).astype(np.float32))


def build(banks, max_streams: int = 12, block: int = 64,
          blocks_per_step: int = 1, device=DEFAULT_DEVICE):
    """The soak's pool and hot-swap targets: one profile group per bank in
    `banks` (WAVData; a grouped pool from two on, its groups' EQs the
    test's +3 dB and -2 dB), stereo input, ring_blocks = 4 M, prewarmed
    with its hot-swap rounds; and per group the renderers of its bank
    scaled by SWAP_SCALES. Returns (pool, swap banks per group)."""
    from airwave_tpu_torch.assets import channel_maps as cm
    from airwave_tpu_torch.graph.renderer import prepare_renderer
    from airwave_tpu_torch.io.wav import WAVData
    from airwave_tpu_torch.runtime.stream_pool import PoolProfile, StreamPool

    M = blocks_per_step

    def renderer(wav):
        return prepare_renderer(wav, cm.STEREO, SAMPLE_RATE, block,
                                lookahead=M, device=device)

    renderers = [renderer(wav) for wav in banks]
    eqs = [eq_definition(3.0), eq_definition(-2.0)]
    kwargs = dict(block_size=block, ring_blocks=4 * M, blocks_per_step=M,
                  device=device)
    if len(banks) > 1:
        pool = StreamPool(max_streams, SAMPLE_RATE, profiles=[
            PoolProfile(r, eqs[g % 2]) for g, r in enumerate(renderers)],
            **kwargs)
    else:
        pool = StreamPool(max_streams, SAMPLE_RATE, renderers[0],
                          eq_definition=eqs[0], **kwargs)
    pool.prewarm(include_hotswap=True)
    swaps = [[renderer(WAVData(SAMPLE_RATE, (wav.audio * s).astype(
        np.float32))) for s in SWAP_SCALES] for wav in banks]
    return pool, swaps


def slow_reader_client(address, audio: np.ndarray, pause: float, block: int,
                       group: int = 0) -> int:
    """Send everything up front, then drain slowly (the output ring's gated
    harvest backpressure). Returns the frames received."""
    conn = socket.create_connection(address, timeout=60)
    try:
        conn.sendall(json.dumps({"channels": audio.shape[0],
                                 "group": group}).encode() + b"\n")
        chunk = 3 * block
        for start in range(0, audio.shape[1], chunk):
            piece = np.ascontiguousarray(audio[:, start:start + chunk])
            conn.sendall(_LEN.pack(piece.shape[1])
                         + piece.T.astype("<f4").tobytes())
        conn.sendall(_LEN.pack(0))
        got = 0
        while True:
            raw = b""
            while len(raw) < _LEN.size:
                piece = conn.recv(_LEN.size - len(raw))
                if not piece:
                    return got
                raw += piece
            (n,) = _LEN.unpack(raw)
            if n == 0:
                return got
            need = n * 2 * 4
            payload = b""
            while len(payload) < need:
                piece = conn.recv(min(1 << 16, need - len(payload)))
                if not piece:
                    return got
                payload += piece
            if not np.all(np.isfinite(np.frombuffer(payload, "<f4"))):
                raise AssertionError("non-finite frames")
            got += n
            time.sleep(pause)
    finally:
        conn.close()


class PumpTimer:
    """Installed on one pool instance (the server's pump thread calls
    pool.pump): the host wall ms per round of each pump call that
    rendered."""

    def __init__(self, pool):
        self.pool, self._pump = pool, pool.pump
        self.ms_per_round: list = []
        pool.pump = self

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        rounds = self._pump(*args, **kwargs)
        if rounds:
            self.ms_per_round.append(
                (time.perf_counter() - t0) * 1e3 / rounds)
        return rounds

    def remove(self) -> None:
        del self.pool.pump  # the class's method again


def live_tensors(server) -> dict:
    """The caching allocator's live tensors (requested bytes, count), read
    between pump rounds (under the server's pool lock) after a
    synchronize."""
    import torch

    dev = server.pool.device
    with server._lock:
        torch.cuda.synchronize(dev)
        stats = torch.cuda.memory_stats(dev)
    return {"requested_bytes": stats["requested_bytes.all.current"],
            "live_allocations": stats["allocation.all.current"]}


def memory_failures(memory: dict, waves: int) -> list:
    """The live-tensor check of a window on a card: `memory` holds the
    counters taken after the 7th wave ("baseline") and at the end ("end");
    a window of fewer than 7 waves has no baseline and fails."""
    if waves < 7 or "baseline" not in memory:  # not every wave kind ran
        return [f"the window ended at wave {waves}, before the live-tensor "
                f"baseline (wave 7)"]
    return [f"device memory grew: {key} {memory['baseline'][key]} -> {value}"
            for key, value in memory["end"].items()
            if value > memory["baseline"][key]]


def soak(pool, swap_banks, seconds: float, rng: np.random.Generator,
         client_timeout: float = 60.0) -> dict:
    """Serve `pool` for `seconds` of waves (the module docstring) and apply
    the pass criteria. Returns the result line's fields; "pass" false with
    "failures" on any miss."""
    from airwave_tpu_torch.shell.serve import RenderServer
    from airwave_tpu_torch.shell.wire_client import render_via_server

    groups, block = pool.groups, pool.block_size
    on_card = pool.device.type == "cuda"
    srv = RenderServer(pool, port=0, client_timeout=client_timeout)
    timer = PumpTimer(pool)
    srv.start()
    stats = {"clients": 0, "frames": 0, "failures": []}
    lock = threading.Lock()
    memory = {}

    def normal_client(i: int):
        # A generator per thread: np.random.Generator is not thread-safe,
        # and the main thread draws from `rng` meanwhile.
        trng = np.random.default_rng(i)
        n = int(trng.integers(2 * block, 14 * block))
        audio = (trng.standard_normal((2, n)) * 0.3).astype(np.float32)
        try:
            # Under the wire cap (ring capacity - step + 1 frames).
            out = render_via_server(srv.address, audio,
                                    chunk=int(trng.integers(17, 3 * block)),
                                    group=i % groups)
            if out.shape != (2, n) or not np.all(np.isfinite(out)):
                raise AssertionError(f"shape {out.shape} for {n} frames, "
                                     f"finite {np.all(np.isfinite(out))}")
            with lock:
                stats["clients"] += 1
                stats["frames"] += n
        except Exception as err:  # noqa: BLE001
            with lock:
                stats["failures"].append(f"normal[{i}]: {err!r}")

    def slow_client(i: int):
        n = 10 * block
        audio = (np.random.default_rng(10_000 + i).standard_normal((2, n))
                 * 0.3).astype(np.float32)
        try:
            got = slow_reader_client(srv.address, audio, 0.05, block,
                                     group=i % groups)
            if got != n:
                raise AssertionError(f"{got} of {n} frames")
            with lock:
                stats["clients"] += 1
                stats["frames"] += n
        except Exception as err:  # noqa: BLE001
            with lock:
                stats["failures"].append(f"slow[{i}]: {err!r}")

    failures = []
    last_def = {g: None for g in range(groups)}
    last_bank = {g: None for g in range(groups)}
    retargets = swaps = wave = 0
    t_start = time.perf_counter()
    try:
        stop = time.monotonic() + seconds
        while time.monotonic() < stop:
            wave += 1
            threads = [threading.Thread(target=normal_client,
                                        args=(wave * 10 + j,))
                       for j in range(int(rng.integers(1, 5)))]
            if wave % 3 == 0:
                threads.append(threading.Thread(target=slow_client,
                                                args=(wave,)))
            for t in threads:
                t.start()
            if wave % 5 == 0:  # a live EQ retarget mid-traffic
                # Grouped pools alternate pool-wide and per-group targets.
                target_group = ((wave // 5) % (groups + 1)) - 1
                new_def = eq_definition(float(rng.uniform(-6, 6)))
                srv.set_equalizer(new_def, group=None if target_group < 0
                                  else target_group)
                retargets += 1
                for g in range(groups):
                    if target_group < 0 or target_group == g:
                        last_def[g] = new_def
            if wave % 7 == 0:  # a crossfaded hot-swap mid-traffic
                g = (wave // 7) % groups
                bank = swap_banks[g][(wave // 7) % 2]
                srv.set_renderer(bank, group=g if groups > 1 else None)
                swaps += 1
                last_bank[g] = bank
            for t in threads:
                t.join(timeout=JOIN_SECONDS)
            if any(t.is_alive() for t in threads):
                failures.append(f"wave {wave}: a client outlived "
                                f"{JOIN_SECONDS} s")
                break
            if not srv._pump_thread.is_alive():
                failures.append(f"the pump thread died in wave {wave}")
                break
            if on_card and wave <= 7:
                memory["first_wave" if wave == 1 else "baseline"] = (
                    live_tensors(srv))
        window = time.perf_counter() - t_start

        if stats["failures"]:
            failures.append(f"client failures: {stats['failures'][:5]}")
        if stats["clients"] < 3:
            failures.append(f"only {stats['clients']} clients completed")
        if srv.pump_errors:
            failures.append(f"pump_errors {srv.pump_errors}")
        if pool.render_errors:
            failures.append(f"render_errors {pool.render_errors}")
        # Retargets land: settle the last ramp with a few quiet rounds.
        ramp_rounds = -(-EQ_RAMP // pool.step_frames) + 3
        settle = np.zeros((2, ramp_rounds * pool.step_frames), np.float32)
        for g, want in last_def.items():
            if want is None:
                continue
            out = render_via_server(srv.address, settle, chunk=block,
                                    group=g)
            rt = pool.eq_runtimes[g]
            if out.shape != settle.shape:
                failures.append(f"group {g}: settle render {out.shape}")
            if rt.active.definition != want:
                failures.append(f"group {g}: the last retarget never "
                                f"became active")
            if rt.pending_target is not None:
                failures.append(f"group {g}: a retarget still pending")
        # Hot-swaps land: the newest bank is active, no lane owes a fade.
        for g, bank in last_bank.items():
            if bank is not None and pool.renderers[g] is not bank:
                failures.append(f"group {g}: the last hot-swap never "
                                f"became active")
        if (pool._xfade_pending & pool._attached_mask).any():
            failures.append("an attached lane still owes a fade")
        # Churn leaves nothing behind once the last EOF lands.
        deadline = time.monotonic() + 10
        while pool._attached and time.monotonic() < deadline:
            time.sleep(0.02)
        if pool._attached:
            failures.append(f"lanes left attached: {sorted(pool._attached)}")
        if len(pool._free) != pool.max_streams:
            failures.append(f"{len(pool._free)} of {pool.max_streams} "
                            f"slots free")
        if pool._pending_out:
            failures.append(f"stashed output of lanes "
                            f"{sorted(pool._pending_out)}")
        alive = srv._pump_thread.is_alive()
        if not alive:
            failures.append("the pump thread is dead")
        if on_card:
            memory["end"] = live_tensors(srv)
    finally:
        srv.stop()
        timer.remove()

    result = {
        "metric": "serving soak",
        "pass": False,
        "seconds": window,
        "blocks_per_step": pool.blocks_per_step,
        "groups": groups,
        "max_streams": pool.max_streams,
        "block": block,
        "waves": wave,
        "clients": stats["clients"],
        "frames": stats["frames"],
        "retargets": retargets,
        "swaps": swaps,
        "rounds": pool.rounds,
        "fade_rounds": pool.fade_rounds,
        "pump_errors": srv.pump_errors,
        "render_errors": pool.render_errors,
        "pump_thread_alive": alive,
        "device": str(pool.device),
    }
    if on_card:
        import torch

        result["device"] = torch.cuda.get_device_name(pool.device)
        ms = np.asarray(timer.ms_per_round)
        result["pump_calls"] = int(ms.size)
        if ms.size:
            result["pump_ms_per_round_p50"] = float(np.percentile(ms, 50))
            result["pump_ms_per_round_p99"] = float(np.percentile(ms, 99))
        for when, counters in memory.items():
            for key, value in counters.items():
                result[f"device_{key}_{when}"] = value
        failures += memory_failures(memory, wave)
    result["pass"] = not failures
    if failures:
        result["failures"] = failures
    return result


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=float, default=float(
        os.environ.get("AIRWAVE_SOAK_SECONDS", "300")),
        help="window per tier (default $AIRWAVE_SOAK_SECONDS or 300)")
    parser.add_argument("--blocks-per-step", type=int, default=None,
                        help="one tier's M (with --groups); default both "
                             "of the test's tiers, (1, 2) then (2, 1)")
    parser.add_argument("--groups", type=int, default=None,
                        help="profile groups of the one tier (1 or 2)")
    parser.add_argument("--max-streams", type=int, default=12)
    parser.add_argument("--block", type=int, default=64)
    parser.add_argument("--hrir-taps", default="300,700",
                        help="bank length of group 0[,group 1]")
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="torch device (default cuda:0; cpu runs the "
                             "kernels' plain versions)")
    parser.add_argument("--cpu", action="store_true",
                        help="--device cpu (tiny shapes recommended)")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    if (args.blocks_per_step is None) != (args.groups is None):
        parser.error("--blocks-per-step and --groups go together")
    tiers = (TIERS if args.groups is None
             else ((args.blocks_per_step, args.groups),))
    taps = [int(t) for t in str(args.hrir_taps).split(",")]
    for M, groups in tiers:
        if groups not in (1, 2) or M < 1:
            parser.error(f"tier ({M}, {groups}): M >= 1 and 1 or 2 groups")
        if args.max_streams % groups:
            parser.error(f"--max-streams must divide by {groups} groups")
        if len(taps) < groups:
            parser.error(f"--hrir-taps lists {len(taps)} lengths for "
                         f"{groups} groups")

    from airwave_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    ok = True
    for M, groups in tiers:
        # Group 0's bank is drawn from the wave generator's seed, as the
        # test draws it; group 1's from its own.
        rng = np.random.default_rng(HRIR_SEEDS[0])
        banks = [seeded_bank(rng, taps[0])]
        if groups > 1:
            banks.append(seeded_bank(np.random.default_rng(HRIR_SEEDS[1]),
                                     taps[1]))
        pool, swaps = build(banks, args.max_streams, args.block, M, device)
        result = soak(pool, swaps, args.seconds, rng)
        result["hrir_taps"] = taps[:groups]
        print(json.dumps(result), flush=True)
        ok = ok and result["pass"]
    return 0 if ok else 1


if __name__ == "__main__":
    from airwave_tpu_torch.tools import die_quietly_on_sigpipe

    die_quietly_on_sigpipe()
    sys.exit(main())
