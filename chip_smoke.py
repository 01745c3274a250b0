"""Drive the PyTorch/CUDA port's main paths once on one CUDA card.

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --kernels-only [--baseline LABEL=SOURCE ...] [--split]

With no arguments it runs every phase below. --baseline LABEL=SOURCE (an
earlier commit's mac_kmajor.cu, or the root of a checkout of it, built with
the same nvcc flags) holds every mac_kmajor_pages and every mac_kmajor case
of the kernel phase to that build bit for bit and times the two in turns
(its "builds" field; single-block cases as bare launches of either build,
bind_single), and times the planner's paged capacity pool's device rounds
with either in turns (baseline_rounds phase); for a checkout it also times
that checkout's mac_kmajor wrapper beside this one's (wrapper phase);
--split also times this mac_kmajor.cu built with MAC_PAGES_SPLIT=1 (no FMAs)
and =2 (no row copies) at each paged case; --kernels-only stops there.

Phases, each printing one line before the last (its "at_s" field the
script's elapsed seconds):
  1. device: require CUDA, print the card's name and power limit
     (nvidia-smi), apply and check the strict fp32 precision policy;
  2. build: build the library of both MAC kernels, mac_kmajor and
     mac_kmajor_pages (one nvcc, its ptxas registers and spills printed), and
     the native frame assembler (g++) from their sources, both at once;
  3. kernel: each kernel against its plain PyTorch version on the card at the
     paths' shapes (mac_kmajor: single-block K=520 R=40 O=4 at B=16384 and
     at the ring pool's B=8192, and 3 pages R=32 O=32 at B=16384 summed by
     three launches with `accumulate`; mac_kmajor_pages: the same 3 pages in
     one launch, and 13 pages R=128 at B=2048), with errors against the
     plain version and float64, CUDA-event times of the kernel, the plain
     version and the one PyTorch call of the same function, and the bound
     from bytes and FLOPs; the fused kernel is timed in turns with the three
     launches (three, fused, fused, three) and equals them bit for bit; the
     hot-swap rounds' dual-bank shapes (mac_kmajor at O=8, B=8192 and
     16384; mac_kmajor_pages at O=64) are timed in turns with another
     route of the same kernel, which they equal bit for bit (mac_kmajor's
     generic kernel, the route before O=8 had its instance; the paged
     kernel's own 16-column instance); and the grouped pools'
     per-group shapes (mac_kmajor at B=2048 with the long and the short
     bank's R, mac_kmajor_pages at B=4096 with 3 and 2 pages) at the
     steady O, the uniform all-dual fade O and the three-half fade bank's
     O (12, its own instance timed in turns with the generic kernel and
     equal to it bit for bit, and 96); and the live runtime's mac_kmajor
     at B=1 on the bundled 4096-tap Neutral bank (R=36, O=4) and its
     Neutral -> Room fade bank (O=8); and the planner's capacity pools'
     lane counts, no multiple of 4 (mac_kmajor at B=150,129, O=4 and 8;
     mac_kmajor_pages at B=35,910 and its neighbours 35,909 and 35,911,
     O=32 and 64, each timed in turns with its 16-column route, which it
     equals bit for bit, as are the three pages of a 5.1 and a 7.1 input,
     R=96 and 128, at B=16384, O=32 and 64); and the steady-only
     capacity pools' (mac_kmajor at B=166,023, O=4; mac_kmajor_pages at
     B=38,821, O=32); and the serving pool's 3
     pages at its 1024 clients' width beside its 1032 lanes; and the mesh
     phase's per-shard widths (mac_kmajor at B=2048, O=4 and 8, B=1024
     with R=40 and 20, a 7.1.4 speaker shard, R=40 at B=4096, and a
     stereo speaker shard of the two gloo processes, R=20 at B=4096;
     mac_kmajor_pages at B=4096, O=32 and 64); and the serving soak's
     groups (mac_kmajor at B=516, R=40 and 20). Every mac_kmajor case
     equals the generic kernel bit for bit and is timed in turns with it
     (generic, route, route, generic) in CUDA events and, below 8192
     lanes, in device time from CUDA-graph replays (graph_ms: launch-sized
     cases read the card, not the host) rotating over copies of the
     operands whose working set is at least twice the L2 where at most 64
     copies reach it (graph_l2_resident marks the rows they do not), its
     mac_route on the line; where that is the balanced or the tiled route
     at O = 4, 8 or 12, the other of the two is held to it bit for bit and
     timed in turns with it (its "other_route" field); the live
     runtime's rows read the rotated window of the doubled bank in place,
     and the steady one gives the wrapper's host µs a call over 1,000
     calls without a sync (the floor's too); route_crossover times the
     small, the tiled and the balanced route at B=16..128 with their device ms
     from traces; the B=1 and B=16 rows also
     give the kernel's device time per launch from a trace of 50 launches
     (profiled_device_ms; tools/profile_chain.profile, after a warm-up
     call) beside their CUDA-event time, and the launch floor beside them:
     an empty kernel of the same library at <<<520, 256>>>, its CUDA-event
     ms per launch and its device ms from a trace of 200 launches; each
     trace must hold every launch it traced;
  4. bake: models.bake.bake at full width (B=16384 streams, S=2, T=512, a
     synthetic 4320-tap HRIR bank, a 10-filter EQ) over 32 blocks with
     blocks_per_step=8 and 1; the outputs are finite and non-silent, the two
     modes agree, 4 sampled lanes match a float64 reference (scipy
     fftconvolve then sosfilt), and each mode launched its kernel once per
     step (mac_kmajor_pages at M=8, mac_kmajor at M=1) and not the other;
  5. timing: the paged chain on device-resident input for 192 blocks, as
     bench.py:measure times the JAX chain, then one 8-block step alone in
     CUDA-event time (its kernels: the profile_chain phase, which traces
     the same chain);
  5b. precision: one child interpreter per tier (AIRWAVE_MATMUL_PRECISION
     highest, high, default; the knobs are read at import) runs
     tools/validate_accuracy's gate on the paged chain (M=8), the
     single-block chain and the ring pool against the float64 oracles
     (highest held to 1e-5, high to 1e-4, default recorded), the headline
     8-block step in CUDA-event time and its top kernels from a trace of 3
     steps (traced: "not measured" unless the trace holds every MAC
     launch), its relaxed products counted, the strict fp32 policy checked
     after it, and the two DFT products at the headline's shapes (analysis
     [1026, 512] x [512, 262144], folded synthesis [640, 1040] x [16,
     1040, 16384]): the fp32 torch.mm/matmul's ms and bound, and under a
     relaxed tier its route (bf16 tensor cores, fp32 accumulation and
     output) against its plain version (the same split operands in fp32)
     with rel-RMS and max relative error, its ms, the split's ms and its
     bound; each line carries device.precision_stamp();
  6. pool: the serving pool's ring tier (StreamPool, 8192 lanes, 48 kHz)
     from a synthetic 14-channel HRIR WAV written and loaded back by the
     port's io.wav, through prepare_renderer, with the 10-filter EQ; 48
     rounds of ragged traffic (each lane fed with probability 0.75, so the
     masked step runs and lanes rejoin with debt), then full rounds
     (ring_all with one lane detached, ring_id after it re-attaches); 4
     sampled lanes within 1e-5 of float64, mac_kmajor launched once per
     round, debt rolls run;
  7. pool_paged: the same at blocks_per_step=8 on 16384 lanes, with
     mac_kmajor_pages launched once per round;
  8. pool_timing (after each tier): every lane fed one step per round
     (push_many, pump(max_rounds=1), pull_many), 64 blocks per lane per
     reading, best of 3 after two warm-up rounds; x_realtime, ms per round
     and its push/pump/pull split, peak device memory, and the CUDA-event
     time of one saturated device round alone (its kernels: the
     profile_chain phase's pool paths);
  9. pool_retarget: a 64-lane pool on the card and the same pool on the CPU
     (plain versions) fed the same ragged traffic with three EQ retargets
     and a detach and re-attach; every stream agrees within 1e-5, for both
     tiers;
 10. hotswap_engine: BinauralEngine at 16384 lanes, two crossfaded swaps
     (the second while the first fade is pending), 4 sampled lanes within
     1e-5 of a float64 time-varying reference, fade blocks launching
     mac_kmajor at O=8 and steady blocks at O=4;
 11. hotswap_pool, hotswap_pool_paged: both pool tiers at full width with
     ragged traffic, a swap mid-stream and a lane paused across it (on the
     paged tier a second swap to a bank of fewer partitions, padded onto
     the carry); the same reference check, one MAC launch per round at the
     dual-bank O in fade rounds (8, 64) and the steady O otherwise, and the
     CUDA-event time of one steady and one fade device round;
 12. checkpoint: snapshot() mid-traffic on both tiers, restored into a fresh
     pool that then delivers the same audio as the uninterrupted one, bit
     for bit; on the ring tier also a restore(..., resize=True) into 4096
     lanes after half the lanes detach; the snapshot's bytes and seconds;
 13. pool_grouped, pool_grouped_paged: StreamPool(profiles=...) of 4
     groups (two 4320-tap banks, a 2000-tap one, four 10-filter EQs) on
     8192 ring lanes and 16384 paged lanes: ragged rounds, swaps of groups
     0 and 2 landing in one round, a second swap of group 0 while its
     paused lane still owes the first fade (the three-half fade bank), a
     retarget of group 1's EQ, saturated rounds; 2 sampled lanes per group
     within 1e-5 of the float64 time-varying reference through their own
     banks and EQ; 4 MAC launches a round (one per group, at the steady,
     dual or three-half O); a snapshot restored bit for bit; on the ring
     tier a resize into 4096 lanes, per group; the saturated grouped
     device round (steady and fade) in CUDA-event time in turns with the
     ungrouped pool's at the same lane count, the full round's host share
     and the peak memory;
 14. serve_ring: the serve CLI's path in process (shell.app.build_serve_pool,
     restore_serve_checkpoint, RenderServer with the selector data plane)
     on a 1032-lane ring pool with the seeded 14-channel 4320-frame WAV and
     the 10-filter EQ as files; 1024 clients of the port's load generator
     (python -m airwave_tpu_torch.shell.loadgen, a separate process) paced
     at realtime, and meanwhile 4 wire clients with seeded inputs, within
     1e-5 of float64; every loadgen client completes, no server error;
     admission and chunk latency percentiles, the server's wire-to-wire
     latency, the pool's rounds, the aggregate realtime multiple, the pump
     thread's share of the wall time, a torch.profiler trace of 40 pump
     calls under the load after a warm-up call (the card's and the pump
     thread's busy shares, ms per round, the pump thread's top host ops;
     for the record only; the card's "not measured" unless the trace
     holds every MAC launch of those calls),
     and mac_kmajor launched on the path;
 15. serve_paged: the same at --blocks-per-step 8 (mac_kmajor_pages);
 16. serve_checkpoint: on the loaded ring server a client streams half its
     signal, the server saves its checkpoint (bytes and seconds), the client
     streams the rest (the uninterrupted twin); a fresh pool restored from
     the file through restore_serve_checkpoint serves the same lane's rest
     to a client resuming with its token, bit for bit the twin's; a
     truncated copy of the file starts a pool fresh and is moved aside;
 17. cli: `python -m airwave_tpu_torch serve` as a process (its listening
     line read), `... client` on a WAV (within 1e-5 of float64 past the EQ's
     20 ms activation ramp), SIGINT to the server (it writes its
     checkpoint), a restart on that checkpoint (restored_checkpoint true),
     and `... status`;
 18. serve_grouped: `python -m airwave_tpu_torch serve --profile
     A.wav:eq1.txt --profile B.wav:eq2.txt` as a process, two checking
     clients in each group within 1e-5 of float64 through their group's
     bank and EQ, SIGINT (the grouped checkpoint is written) and a restart
     that restores it (profile_groups 2);
 19. render: shell.app.main(["render", ...]) on 16 stereo 30 s WAVs with the
     EQ, on the graph path (BinauralEngine behind the frame adapter, the
     device EQ; mac_kmajor) and with --throughput (the bake at M=8;
     mac_kmajor_pages): 4 sampled outputs within 1e-5 of float64 (the graph
     path past its 20 ms EQ activation ramp), and each path's realtime
     multiple;
 20. presets: shell.app.main(["presets", "seed" | "list" | "import"]) in a
     fresh data directory (3 HRIR and 5 EQ presets, then the phase's WAV
     and APO file imported), and the imported HRIR activated by a port
     HRIRManager with no device: its renderer on cuda:0, equal to the CPU
     one within 1e-6;
 21. demo: `demo --seconds 5 --eq-preset Bass` through shell.app.main
     (processing on cuda:0, one mac_kmajor launch per engine block), then
     the objects cmd_demo wires (shell.app.build_demo: SyntheticTransport,
     AudioRuntimeController, StreamPipeline, AudioEffectGraph over
     SpatialEffect(batch=1), the coordinators) driven for 940 blocks with
     the profile's HRIR switched Neutral -> Room at block 470 (the JAX
     controller's full re-prepare: a pipeline restart without a new
     capture verification, and a crossfade in the engine): the steady
     Neutral segment past the EQ ramp, the fade blocks and the steady Room
     segment each within 1e-5 of float64; mac_kmajor once a block, at O=8
     in the fade blocks; host ms per block, the card's ms per block and
     busy share from a trace of 100 more blocks (traced), the realtime
     multiple;
 22. feeder_single_block, feeder_paged: runtime.feeder.DeviceFeeder (two
     pinned host buffers per input shape, the copy on a stream of its own,
     an event the step waits on) over chain_step_fn at B=16384 for 24
     blocks and chain_step_multi_fn at M=8 for 6 steps (537 MB of input a
     step) of distinct seeded host input, against the unstaged loop on an
     equal fresh state: equal bit for bit, 4 sampled lanes within 1e-5 of
     float64, one mac_kmajor launch per block and one mac_kmajor_pages
     launch per step; wall ms per block or step of both loops, the pinned
     bytes held, and from a trace (after a warm-up call, holding every MAC
     launch) the copies' and the kernels' streams and their overlap (for
     the record);
 23. migration: the committed round-3 fixtures (ring and grouped) restored
     into port pools on the card and continued within 1e-5 of the
     uninterrupted render; then an 8192-lane ring pool's round-3
     full-window carry, built from the blocks it was fed, written as a
     schema-less npz by utils.checkpoint.save_pytree and handed to
     shell.app.restore_serve_checkpoint on a fresh pool: migrated, not moved
     aside, sampled lanes within 1e-5 of the uninterrupted pool and of
     float64; the file's bytes and the load-and-migrate seconds; the same
     file refused by a paged pool with the versioned error;
 24. planner: utils.memory_planner.cuda_pool_round_memory on both tiers at
     probe batches 512 and 1024 (per-lane bytes within 5%; steady,
     EQ-crossfade and hot-swap peaks), each tier built at pool_capacity's
     max_streams for a 24e9-byte budget and run through one round of each
     kind (the peak at most 0.85 x 24e9, the calibrated estimate over it at
     most 1.3), the hand model beside this run's measured peaks, the whole
     card's recommendation, and `python -m
     airwave_tpu_torch.tools.plan_capacity --blocks-per-step 8 --calibrate
     --probe-batch 512 --hbm-gb 24` as a process (calibrated, per-lane
     bytes within 5% of the in-process probe's);
 25. mesh (parallel.mesh, parallel.multihost, StreamPool(mesh=) on 4
     virtual shards of cuda:0, distinct cards where more are visible; each
     line gives `cards` and `shards`): the sharded paged bake at B=16384,
     M=8 with the EQ against the unsharded chain (rel-RMS at most 1e-6),
     4 sampled lanes against float64, one 8-block step of each in
     CUDA-event time in turns; the ring (8192) and paged (16384) pools
     over 4 shards and a 4-group ring pool over 2 on pool_phase's data
     through ragged rounds, an EQ retarget and a hot-swap fade, every
     delivered lane within 1e-6 of the unsharded pool, one MAC launch per
     shard and group a round, host and device ms of a saturated round of
     each in turns, a snapshot restored into the unsharded pool (its
     snapshot equal bit for bit, its output within 1e-6) and into the
     sharded pool (bit for bit the uninterrupted rounds); the 7.1.4
     speaker-sharded step (8 speakers, a 2 x 4 mesh, B=8192) against
     chain_step_fn within 1e-5; tests/_torch_multihost_worker.py as two
     gloo processes on cuda:0 at B=8192, T=512 and the 4320-tap bank (2
     shards of 2048 lanes each; speaker shards of 4096), every MAC launch
     of theirs held against its plain version in the process, the union of
     their rows within 1e-5 of one process; `serve --mesh-devices 1`
     answering a client, and one card more than are visible refused with
     the JAX CLI's error;
 24b. steady_capacity (after planner): each tier's plan for the same
     24e9-byte budget with the planner phase's calibration gives
     max_streams_steady (a pool that never swaps); a pool built at that
     width (the planner's bank and EQ, its EQ ramp settled) is soaked for
     10 s through tools/soak's function: its peak at most 0.85 x 24e9, the
     steady round's estimate (fixed bytes plus per-lane bytes times the
     lanes) over the peak at most 1.3, the soak passing; then a reset swap
     (set_renderer(crossfade=False) onto the same bank: the carry zeroed in
     place) and one round, that peak also at most 0.85 x 24e9; one more
     round on the reset carry under CheckedMacs;
 26. soak (after mesh): tools/soak at full width for 30 s a tier, the
     4320-tap bank and the 10-filter EQ: the ring tier (8192 lanes) as
     `python -m airwave_tpu_torch.tools.soak --seconds 30 --batch 8192`, a
     child process whose JSON line carries its launches, and the paged tier
     (16384 lanes, M=8) in process; each passes (every checksum finite,
     drift ratio in (0.5, 2.0)), keeps its live device tensors flat from
     the baseline call to the window's end (the bytes they requested and
     their count; memory_allocated and max_memory_allocated recorded at
     both) and launches its kernel once a round; then one call on the
     soaked paged carry under CheckedMacs;
 27. checkpoint_scale: tools/checkpoint_scale at B=16384, M=8 into a
     temporary directory: the pump stall (snapshot(materialize=False) and a
     synchronize), the readback, the atomic write, the load into a fresh
     pool and the restore, each timed; the round trip bit for bit;
 27b. profile_chain: tools/profile_chain at the headline bake (B=16384,
     M=8) and both pool tiers (ring 8192 lanes, paged 16384 at M=8; the
     saturated "_id" round), 2 traced calls of 16 blocks each under
     torch.profiler with CUDA activity (tools/profile_chain.profile: a
     warm-up call, the window opened by its lead kernels): the top kernels by device ms per block (the MAC kernel of
     each path, every launch of it in the traced calls, and the bake's
     GEMMs among them), the listed rows' sum and the CUDA-event ms per
     block of the same calls; each warm-up call's MAC launches checked;
 27c. serve_soak: tools/serve_soak on the card for 45 s a tier (the tool's
     300 s, cut) at the serve phases' width (1032 lanes, block 512): the
     ring tier as a grouped two-profile pool (the 4320-tap bank and a
     2000-tap one) and the paged tier (M=8) on the 4320-tap bank, under
     tests/test_soak.py's churn (1-4 ragged clients a wave, a slow reader
     every 3rd, an EQ retarget every 5th, a crossfaded hot-swap every 7th)
     and its pass criteria; pump ms per round p50/p99 and live device
     tensors after the first and the 7th wave and at the end (flat); 8
     MAC launches a shape (with a non-zero reference) of each window and
     of one fade round on audio after it (every group swapped, a lane of
     each streaming) checked;
 27d. serve_scale: tools/serve_scale with 256 realtime loadgen clients (a
     child process) against the in-process server on a 264-lane ring pool
     of the script's 300-tap bank: every client complete, no server error;
     8 of its MAC launches checked;
 28. path_checks: every MAC launch of the migration and mesh phases, the
     checked calls of the soak and steady_capacity phases, the sampled
     launches of the profile_chain, serve_soak and serve_scale paths, and
     a re-run of
     the planner's probe rounds (their lanes and the 8-lane warm-up) and
     capacity rounds on seeded input, held against the kernel's plain
     version on the same operands (rel-RMS at most 1e-6), one case per
     kernel and shape: the widths only these paths give (the capacity
     pools' lane counts, which need not be a multiple of 4, the probes' and
     the fixtures' 4-lane pools, the shards' widths);
then one JSON line describing each kernel, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.
Needs no network; imports no jax.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import gc
import hashlib
import io
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple
from unittest import mock

import numpy as np
import torch

from airwave_tpu_torch import native
from airwave_tpu_torch.assets import bundled, channel_maps
from airwave_tpu_torch.assets.hrir_library import HRIRManager
from airwave_tpu_torch.device import apply_precision_policy, precision_is_strict
from airwave_tpu_torch.graph.renderer import (build_hrir_time_domain,
                                              prepare_renderer)
from airwave_tpu_torch.io import wav as wavio
from airwave_tpu_torch.kernels import _build
from airwave_tpu_torch.kernels import mac_kmajor as mk
from airwave_tpu_torch.models.bake import bake
from airwave_tpu_torch.models.binaural import (BinauralChain, BinauralEngine,
                                               ChainState, chain_step_fn,
                                               make_chain_operands)
from airwave_tpu_torch.ops import biquad_design as bd
from airwave_tpu_torch.ops import eq_block, upols
from airwave_tpu_torch.parallel import mesh as pmesh
from airwave_tpu_torch.runtime.feeder import DeviceFeeder
from airwave_tpu_torch.runtime.stream_pool import (PoolProfile, PoolState,
                                                   StreamPool, pool_step_body)
from airwave_tpu_torch.shell import app as shell_app
from airwave_tpu_torch.runtime.transport import TapPurpose
from airwave_tpu_torch.shell.presentation import present_status
from airwave_tpu_torch.shell.serve import RenderServer
from airwave_tpu_torch.shell.wire_client import (_LEN, _read_exact,
                                                 render_via_server)
from airwave_tpu_torch.tools import checkpoint_scale, profile_chain
from airwave_tpu_torch.tools import serve_scale, serve_soak
from airwave_tpu_torch.tools import soak as soak_tool
from airwave_tpu_torch.utils import checkpoint, memory_planner
from airwave_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                load_pool_snapshot)
from airwave_tpu_torch.utils.memory_planner import device_hbm_bytes
from airwave_tpu_torch.utils.profiling import SPAN_PREFIX

SAMPLE_RATE = 48_000.0
BATCH, SPEAKERS, EARS, BLOCK, HRIR_TAPS = 16384, 2, 2, 512, 4320
BLOCKS_PER_STEP = 8
BAKE_BLOCKS = 32
TIMED_BLOCKS = 192
LONG_BANK = (13, 8, 2048)   # pages, speakers, lanes of the long-bank MAC case
KERNEL_TOL = 1e-6   # rel-RMS, kernel vs plain version (fp32 reassociation)
CHAIN_TOL = 1e-5    # rel-RMS, the BASELINE.md chain contract
KERNEL_SOURCE = "airwave_tpu_torch/kernels/csrc/mac_kmajor.cu"
KERNEL_REPLACES = "airwave_tpu/kernels/mac_kmajor.py:66"
# The TPU kernel's paged use, the JAX step's _paged_mac, is what
# mac_kmajor_pages replaces.
PAGED_MAC_FUNCTION = "airwave_tpu/ops/upols.py:689"
KERNELS = ("mac_kmajor", "mac_kmajor_pages")
# The H100's published peaks (NVIDIA data sheet, SXM, at 700 W): HBM bytes
# per second, and fp32 FLOP/s outside the tensor cores (the kernel's type).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12         # dense bf16 tensor-core peak (the relaxed tiers)
# The precision phase: one child interpreter per tier, each gating the
# paged chain, the single-block chain and the ring pool against float64
# (tools/validate_accuracy) at its contract; "default" is recorded only.
TIERS = ("highest", "high", "default")
TIER_CONTRACT = {"highest": CHAIN_TOL, "high": 1e-4}
PRECISION_GATES = (("paged", ("--blocks-per-step", str(BLOCKS_PER_STEP))),
                   ("single_block", ()), ("pool_ring", ("--pool",)))
PRECISION_CHILD_TIMEOUT = 240
# rel-RMS of a tier's route against its plain version (the same split
# operands in fp32), per unit of one pass's depth K: the H100's tensor cores
# truncate each k-step's sum into the fp32 accumulator, so the two differ by
# about K * 2^-30 (4.4e-7 at K=512, 9.1e-7 to 1.04e-6 at K=1040, one bf16
# pass on seeded normals); the gate allows twice that.
ROUTE_TOL_PER_K = 2.0 ** -29

HRIR_CHANNELS = 14          # a HeSuVi 14-channel bank, as the assets ship
EQ_RAMP = 960               # the 20 ms EQ crossfade at 48 kHz, in samples
POOL_LANES = {1: 8192, BLOCKS_PER_STEP: 16384}    # ring tier, paged tier
POOL_ROUNDS = {1: (48, 8), BLOCKS_PER_STEP: (6, 4)}  # (ragged, full) rounds
POOL_SHARE = 0.75           # chance that a lane is fed in a ragged round
POOL_TIMED_BLOCKS = 64      # blocks per lane per timing reading
RETARGET_LANES = 64
SHORT_TAPS = 2000           # the shorter bank of the paged tier's second swap
ENGINE_BLOCKS = (8, 1, 7)   # engine: blocks before swap 1, to swap 2, after
# Hot-swap traffic per tier: "r" a ragged round, "f" every lane fed, an int
# a swap to that bank; and the rounds in which the paused lane is not fed.
HOTSWAP_SCHEDULE = {
    1: (["r"] * 6 + [1] + ["r"] * 6 + ["f"] * 2, range(4, 8)),
    BLOCKS_PER_STEP: (["r"] * 3 + [1] + ["r"] * 3 + ["f", 2] + ["r"] * 2
                      + ["f"] * 2, range(1, 5)),
}
CHECKPOINT_ROUNDS = {1: (4, 6), BLOCKS_PER_STEP: (2, 3)}  # (before, after)
RESIZE_LANES = POOL_LANES[1] // 2
# Grouped pools: GROUPS profile groups over POOL_LANES[M] lanes. Group g
# starts on bank GROUPED_BANKS[g] (indices into the phase's banks: two
# 4320-tap banks, a SHORT_TAPS one, a second short one and a third long one)
# with the 10-filter EQ at gain scale GROUPED_EQ_SCALES[g]. Traffic per
# tier as HOTSWAP_SCHEDULE, with dicts for swaps ({group: bank}) and "e"
# for the retarget of group 1's EQ to scale GROUPED_EQ_SCALES[-1]; the
# rounds in which the paused lane (in group 0) is not fed.
GROUPS = 4
GROUPED_BANKS = (0, 1, 2, 0)
GROUPED_EQ_SCALES = (1.0, 0.5, -1.0, 1.5, -0.5)
GROUPED_SCHEDULE = {
    1: (["r"] * 6 + [{0: 1, 2: 3}] + ["r"] * 3 + [{0: 4}] + ["r"] * 3
        + ["e"] + ["f"] * 3 + ["r"] * 2 + ["f"], range(3, 11)),
    BLOCKS_PER_STEP: (["r"] * 3 + [{0: 1, 2: 3}] + ["r"] * 2 + [{0: 4}]
                      + ["r"] * 2 + ["e"] + ["f"] * 2 + ["r", "f"],
                      range(2, 6)),
}
GROUPED_CHECK_ROUNDS = 3    # ragged rounds after a snapshot or a resize
SERVE_GROUPED_FRAMES = 12 * BLOCK + 77

REPO = os.path.dirname(os.path.abspath(__file__))
SERVE_LANES = 1032          # the serve CLI's pool: the clients and 8 spare
SERVE_SOAK_GROUP = SERVE_LANES // 2  # a group of the grouped serving soak
CROSSOVER_WIDTHS = (16, 32, 48, 64, 96, 128)  # small, tiled, balanced
HOST_CALLS = 1000           # wrapper calls timed on the host, no sync
GRAPH_TIMED_BELOW = 8192    # lanes: single-block cases also in device time
L2_BYTES = 50 * 2 ** 20     # the H100's L2: graph_ms rotates inputs past it
GRAPH_COPIES_MAX = 64       # input copies graph_ms rotates over, at most
SOURCE_IN_ROOT = os.path.join("airwave_tpu_torch", "kernels", "csrc",
                              "mac_kmajor.cu")
TRACE_ATTEMPTS = 3          # traces taken while one loses kernel records
SERVE_CLIENTS = 1024        # loadgen clients, paced at realtime
LOADGEN_ARGS = ("--speed", "1.0", "--chunk", "512", "--blocks-each", "64")
SERVE_CHECKS = 4            # wire clients with known inputs during the load
SERVE_CHECK_FRAMES = 16 * BLOCK + 77
SERVE_PROFILE_CALLS = 40    # pump calls traced by torch.profiler under load
CHECKPOINT_BLOCKS = 8       # blocks streamed before and after the checkpoint
CLI_FRAMES = 2 * 48_000
DEMO_CLI_SECONDS = 5.0      # demo --seconds of the CLI run
DEMO_BLOCKS = 940           # blocks pumped through the wired demo (~10 s)
DEMO_SWAP_BLOCK = 470       # where the profile's HRIR goes Neutral -> Room
DEMO_PROFILED_BLOCKS = 100  # blocks traced (traced) after the run
DEMO_PROFILED_CALLS = 4     # ... in calls of 25 blocks, after a warm-up call
FEEDER_BLOCKS = 24          # single-block steps through the feeder
FEEDER_STEPS = 6            # 8-block steps through the feeder (537 MB each)
FEEDER_PROFILED = 6         # feeder steps traced by torch.profiler
MIGRATION_ROUNDS = 12       # full rounds before the round-3 carry is built
MIGRATION_CONTINUED = 6     # rounds after the migrated restore
PLANNER_PROBES = (512, 1024)  # probe batches of the calibration
PLANNER_HBM = 24e9          # the capacity pools' device-memory budget
# The capacity pools' lane counts on an H100 80GB at that budget (the
# planner's recommendation moves with the calibration), as kernel cases:
# lane counts that are no multiple of 4, so rows start 4, 8 or 12 bytes past
# 16-byte alignment (mac_kmajor_pages copies each row's 16-byte envelope by
# TMA and stores whole 128-byte runs all the same). The paged width is also
# run at its neighbours, B % 4 = 1 and 3.
CAPACITY_LANES = {1: 150_129, BLOCKS_PER_STEP: 35_910}
CAPACITY_PAGED_WIDTHS = tuple(CAPACITY_LANES[BLOCKS_PER_STEP] + d
                              for d in (-1, 0, 1))
# The steady_capacity phase's pools (max_streams_steady at the same budget,
# which also moves with the calibration), as kernel cases: B % 4 = 3 and 1.
STEADY_LANES = {1: 166_023, BLOCKS_PER_STEP: 38_821}
RENDER_FILES, RENDER_SECONDS = 16, 30
# The mesh phase: virtual shards of cuda:0 (distinct cards where visible).
MESH_SHARDS = 4             # the bake's and the pools' stream shards
MESH_GROUPED_SHARDS = 2     # the grouped ring pool's (GROUPS groups)
MESH_BAKE_STEPS = BAKE_BLOCKS // BLOCKS_PER_STEP
MESH_POOL_ROUNDS = {1: 8, BLOCKS_PER_STEP: 3}   # ragged rounds per tier
MESH_TIMED_STEPS = 5        # CUDA-event reps of one sharded or plain step
MESH_TOL = 1e-6             # rel-RMS, sharded against unsharded
SPEAKER_MESH = (2, 4)       # (streams, speakers) of the 7.1.4 step
SPEAKER_LANES = 8192
SPEAKER_STEPS = 3
MULTIHOST_LANES = 8192      # the two gloo processes' global batch
MESH_SERVE_FRAMES = 4 * BLOCK + 77
# The soak phase (tools/soak): each tier at its pool width for this window
# (the tool's default is 300 s), in calls of the tool's default 256 blocks.
SOAK_SECONDS = 30
SOAK_BLOCKS_PER_CALL = 256
# The steady_capacity phase: each tier's pool at the planner's
# max_streams_steady for PLANNER_HBM, soaked for this window in calls of
# this many blocks (a ring round at ~166k lanes is ~20x the 8192-lane one).
STEADY_SOAK_SECONDS = 10
STEADY_BLOCKS_PER_CALL = 16
# The profile_chain phase: tools/profile_chain's defaults (blocks a traced
# call, traced calls), the rows each path prints, and the MAC launches a
# shape (with a non-zero reference) of each path's warm-up call held
# against the plain version.
PROFILE_BLOCKS = 16
PROFILE_CALLS = 2
PROFILE_TOP = 15
PROFILE_CHECKED = 8
PROFILE_PATHS = {   # path: (the pool's round, not the bake; M; lanes)
    "profile_bake": (False, BLOCKS_PER_STEP, BATCH),
    "profile_pool_ring": (True, 1, POOL_LANES[1]),
    "profile_pool_paged": (True, BLOCKS_PER_STEP, POOL_LANES[BLOCKS_PER_STEP]),
}
# The serve_soak phase: each tier's window (the tool's default 300 s, cut),
# and the MAC launches a shape (with a non-zero reference) of each window,
# and of serve_scale's run, checked.
SERVE_SOAK_SECONDS = 45
SERVE_SOAK_CHECKED = 8
SERVE_SCALE_CLIENTS = 256   # the serve_scale phase's realtime clients
FADE_CHECK_SEED = 29        # the audio of the serve_soak phase's fade round


_T0 = time.perf_counter()


def phase(label: str, /, **fields) -> None:
    """Print one phase line; "at_s" is the script's elapsed seconds."""
    print(json.dumps({"phase": label, "at_s": time.perf_counter() - _T0,
                      **fields}), flush=True)


def rel_rms(a, ref) -> float:
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((a - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of fn() over `reps` runs, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class OtherBuild(NamedTuple):
    """Another build of both MAC kernels (--baseline, --split)."""
    pages: Callable   # run(pages, bank) -> out, as mk.mac_kmajor_pages
    bind: Callable    # bind(fdl, h, out=None, accumulate=False) -> launcher


def bind_single(one, strided: bool, fdl, h, out=None, accumulate=False):
    """A bare launcher of a build's single-block entry point on these
    operands, returning out: `one` is airwave_mac_kmajor_strided (strided:
    the wrapper's _plan, h read in place or copied as the wrapper copies it)
    or an older build's airwave_mac_kmajor (its own dispatch by O, h copied
    contiguous). The copy, the route and the arguments are made here, not
    in the launcher, so that a launcher of this build and one of another
    build time their kernels alike, neither with the wrapper's host work."""
    K, R, B = fdl.shape
    O = h.shape[1]
    if out is None:
        out = torch.empty((O, K, B), device=fdl.device)
    dev = fdl.device.index or 0
    if strided:
        plan = mk._plan(K, R, B, O, mk.h_rows(h), None, dev,
                        (fdl.data_ptr() | out.data_ptr()) % 16 == 0,
                        h.dim() == 3 and h.is_contiguous())
        if plan.copy:
            h = mk._flat_h(h).contiguous()
        args = (fdl.data_ptr(), h.data_ptr(), out.data_ptr(), plan.address,
                int(accumulate))
    else:
        h = mk._flat_h(h).contiguous()
        args = (fdl.data_ptr(), h.data_ptr(), out.data_ptr(), K, R, B, O,
                int(accumulate), 0, dev)

    def launch():
        code = one(*args, torch.cuda.current_stream(fdl.device).cuda_stream)
        if code != 0:
            raise RuntimeError(f"single-block launch: cuda error {code}")
        return out

    launch.operands = (fdl, h, out)  # alive while the launcher is
    return launch


def this_bind(fdl, h, out=None, accumulate=False):
    """bind_single on this build's library."""
    return bind_single(mk._library()[0].airwave_mac_kmajor_strided, True,
                       fdl, h, out, accumulate)


def load_build(source: str, defines=()) -> OtherBuild:
    """Another build of the MAC kernels (--baseline, --split): `source` (an
    earlier commit's mac_kmajor.cu, or the root of a checkout holding it,
    or this one's with -D `defines`), built with the package's nvcc flags
    into its build directory. Its pages entry point gets the columns the
    wrapper would pass; a source that rejects them (an older kernel took
    only 0, 16 or 32) gets 0, its own choice by O. Its single-block entry
    point is bound as bind_single binds it."""
    if os.path.isdir(source):
        source = os.path.join(source, SOURCE_IN_ROOT)
    flags = [*_build.NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    with open(source, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
    lib = _build.BUILD_DIR / f"other-{key[:16]}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build.find_nvcc(), *flags, "-o", str(lib),
                               source], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} {defines}:\n"
                               f"{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    fn = dll.airwave_mac_kmajor_pages
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    strided = hasattr(dll, "airwave_mac_kmajor_strided")
    one = dll.airwave_mac_kmajor_strided if strided else dll.airwave_mac_kmajor
    one.argtypes = mk.STRIDED_ARGTYPES if strided else (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    one.restype = ctypes.c_int

    def run(pages, bank):
        n, K, O, R = bank.shape
        B = pages[0].shape[-1]
        out = torch.empty((O, K, B), device=bank.device)
        ptrs = (ctypes.c_void_p * n)(*(p.data_ptr() for p in pages))
        stream = torch.cuda.current_stream(bank.device).cuda_stream
        for columns in (mk.pages_columns(O), 0):
            code = fn(ptrs, n, bank.data_ptr(), out.data_ptr(), K, R, B, O,
                      columns, bank.device.index or 0, stream)
            if code != 1:  # cudaErrorInvalidValue: try its own choice
                break
        if code != 0:
            raise RuntimeError(f"{source} {defines}: cuda error {code}")
        return out

    return OtherBuild(run, functools.partial(bind_single, one, strided))


def complete_trace(fn, calls: int, kernel: str, count=None,
                   attempts: int = TRACE_ATTEMPTS) -> dict:
    """traced(fn, calls, kernel, count), taken again (up to `attempts` in
    all) while the trace lost launches: a torch.profiler trace of this
    card may drop kernel records (one to thirteen in 200, now and then),
    and a trace that drops them reads low. The result's "attempts" says
    how many it took; the last is returned, complete or not."""
    for attempt in range(1, attempts + 1):
        trace = traced(fn, calls, kernel, count)
        if trace["trace_complete"]:
            break
    return dict(trace, attempts=attempt)


def traced(fn, calls: int, kernel: str, count=None, top: int = 8,
           logdir=None) -> dict:
    """fn() under tools/profile_chain.profile (a warm-up call, then `calls`
    calls, each synchronized inside the trace, the window opened by its
    lead kernels): the device ms per call of every kernel in the trace and
    its `top` kernels by name, and the device ms per launch of `kernel` (a
    part of the kernel's name; mac_kmajor leaves out the pages kernel). The
    trace must hold every launch of `kernel` that the traced calls made
    (count(): its launches so far, by default mk.launch_count(kernel)),
    else the times read "not measured", since a trace that drops kernels
    reads low. The Chrome trace is written to `logdir` when one is given."""
    count = count or (lambda: mk.launch_count(kernel))
    made = []

    def call():
        before = count()
        fn()
        made.append(count() - before)

    with tempfile.TemporaryDirectory() as tmp:
        rows = profile_chain.profile(call, torch.device("cuda", 0), calls, 1,
                                     top=None, logdir=logdir or tmp)["rows"]
    mine = [(us, n) for name, us, n in rows if kernel in name
            and (kernel != "mac_kmajor" or "pages" not in name)]
    launched = sum(made[1:])  # made[0] is the profiler's warm-up call
    held = sum(n for _, n in mine)
    result = dict(trace_complete=launched > 0 and held == launched,
                  launches=launched, traced_launches=held,
                  device_ms="not measured", kernel_ms="not measured",
                  top_kernels=[])
    if result["trace_complete"]:
        result.update(
            device_ms=sum(us for _, us, _ in rows) / 1e3 / calls,
            kernel_ms=sum(us for us, _ in mine) / 1e3 / held,
            top_kernels=[[name[:80], us / 1e3 / calls, n]
                         for name, us, n in rows[:top]])
    return result


def bench_eq_definition(scale: float = 1.0) -> bd.EqualizerDefinition:
    """bench.py:_finish_build's 10-filter EQ, its gains times `scale`."""
    kinds = (bd.FilterType.PEAKING, bd.FilterType.LOW_SHELF,
             bd.FilterType.HIGH_SHELF)
    filters = tuple(
        bd.EqualizerFilter(i + 1, i + 1, True, kinds[i % 3],
                           100.0 * (i + 1) + 60.0,
                           (-1.0) ** i * 2.0 * scale, 0.9)
        for i in range(10)
    )
    return bd.EqualizerDefinition(-2.5, filters)


def bench_eq():
    """(preamp, coefficients) of bench_eq_definition()."""
    return bd.design_cascade(bench_eq_definition(), SAMPLE_RATE)


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the HBM rate or fp32
    FLOPs over the fp32 peak, whichever is larger."""
    by_bytes, by_flops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return dict(bound_ms=max(by_bytes, by_flops) * 1e3,
                bound_by="bytes" if by_bytes >= by_flops else "operations")


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_phase() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    smi = card()
    print(smi, flush=True)
    apply_precision_policy()
    if not precision_is_strict():
        raise RuntimeError("strict fp32 precision policy not in effect")
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda,
          allow_tf32=torch.backends.cuda.matmul.allow_tf32,
          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
          matmul_precision=torch.get_float32_matmul_precision())
    return smi


def build_phase(others=None) -> dict:
    """nvcc of the kernel, g++ of the assembler and nvcc of each other build
    of the MAC kernels (label -> (source, defines)), all started together.
    Returns label -> that build's OtherBuild."""
    others = others or {}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2 + len(others)) as pool:
        kernel = pool.submit(mk.build)
        assembler = pool.submit(native.load_library)
        runs = {label: pool.submit(load_build, *spec)
                for label, spec in others.items()}
        log = kernel.result()
        assembler.result()
        runs = {label: run.result() for label, run in runs.items()}
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in log.splitlines()
             if any(w in ln for w in ("entry function", "registers", "spill"))]
    phase("build", seconds=seconds, ptxas=ptxas,
          other_builds={k: [str(v) for v in spec]
                        for k, spec in others.items()})
    return runs


def kernel_phase(rng: np.random.Generator, dev: torch.device,
                 builds=None) -> list:
    """Each kernel against its plain version at the paths' shapes, both also
    against a float64 evaluation of the same contraction, and the one
    PyTorch call that computes the same function (library_ms). The fused
    paged kernel is also timed in turns with the sum of one mac_kmajor
    launch per page that it replaces (three launches at the headline
    shape), and must equal that sum bit for bit. `builds` (label -> (run,
    exact)): other builds of mac_kmajor_pages, each timed in turns with the
    kernel at every paged case ("builds" field); an exact one must equal it
    bit for bit."""
    Kp = upols.padded_bin_count(BLOCK)
    cases = []
    builds = builds or {}
    # The inputs are drawn on the card: gigabytes of host draws and copies
    # took most of this phase's time.
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 31)))

    def tensor(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def measure(kernel, name, kern, plain, exact_fn, library, bnd, ms=None,
                profiled=False, **extra):
        got, ref = kern().double(), plain().double()
        exact = exact_fn()
        diff = got - ref
        max_abs = diff.abs().max().item()
        rel = (diff.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()
        scale = exact.pow(2).mean().sqrt()
        rel_exact = ((got - exact).pow(2).mean().sqrt() / scale).item()
        plain_rel_exact = ((ref - exact).pow(2).mean().sqrt() / scale).item()
        library_rel = ((library().double() - exact).pow(2).mean().sqrt()
                       / scale).item()
        del got, ref, exact, diff
        case = dict(kernel=kernel, case=name, max_abs_err=max_abs,
                    rel_rms=rel, rel_rms_vs_fp64=rel_exact,
                    plain_rel_rms_vs_fp64=plain_rel_exact,
                    library_rel_rms_vs_fp64=library_rel,
                    ms=cuda_ms(kern, 20) if ms is None else ms,
                    plain_ms=cuda_ms(plain, 20),
                    library_ms=cuda_ms(library, 20), **bnd, **extra)
        if profiled:  # a launch-sized case: is it the host or the body?
            trace = complete_trace(kern, 50, kernel)
            case.update(profiled_device_ms=trace["kernel_ms"],
                        traced_launches=trace["traced_launches"],
                        trace_attempts=trace["attempts"])
            if not trace["trace_complete"]:
                raise AssertionError(f"{name}: the trace holds "
                                     f"{trace['traced_launches']} of "
                                     f"{trace['launches']} launches")
        phase("kernel", **case)
        if not rel <= KERNEL_TOL:
            raise AssertionError(f"{name}: rel-RMS {rel} > {KERNEL_TOL}")
        cases.append(case)
        torch.cuda.empty_cache()

    def vs_builds(pages, bank, fused) -> dict:
        fields = {}
        for label, (run, exact) in builds.items():
            def other(run=run):
                return run.pages(pages, bank)
            if exact and not torch.equal(other(), fused()):
                raise AssertionError(f"build {label} differs from the kernel "
                                     f"at {len(pages)} pages {bank.shape}")
            # In turns: the other build, the kernel, the kernel, the other.
            turns = [cuda_ms(f, 20) for f in (other, fused, fused, other)]
            fields[label] = dict(ms=(turns[0] + turns[3]) / 2,
                                 ms_turns=[turns[0], turns[3]],
                                 kernel_ms_turns=turns[1:3],
                                 **({"equal": True} if exact else {}))
        return {"builds": fields} if fields else {}

    def dual(kernel, shape, new, old, args, label="dual bank",
             route="previous_route", extra=None):
        equal, diff = torch.equal(new(), old()), (new() - old()).abs().max().item()
        turns = [cuda_ms(f, 20) for f in (old, new, new, old)]
        equal_plain = torch.equal(new(), args[0]())
        measure(kernel, f"{label} {shape}", new, *args,
                ms=(turns[1] + turns[2]) / 2, ms_turns=turns[1:3],
                **{f"{route}_ms": (turns[0] + turns[3]) / 2,
                   f"{route}_ms_turns": [turns[0], turns[3]],
                   f"equals_{route}": equal,
                   f"max_abs_diff_{route}": diff},
                equals_plain=equal_plain, **(extra or {}))
        if not equal:
            raise AssertionError(f"{label} {shape}: the route differs from "
                                 f"the {route} route by up to {diff}")

    sms = mk._sm_count(dev.index or 0)

    def single(label, fdl, h, new=None, old=None, other=None, args=None,
               **extra):
        """A single-block case (mac_kmajor at fdl [K, R, B], h [K, O, R] or
        a rotated window): bit for bit the generic kernel and timed in
        turns with it (generic, new, new, generic), in CUDA events through
        the wrapper and, below GRAPH_TIMED_BELOW lanes, in device time
        (graph_ms over graph_copies of the operands; the generic twin on a
        contiguous h copied beforehand, so neither reading holds a copy).
        Where mac_route takes the balanced or the tiled route at O = 4, 8
        or 12, the other of the two too, bit for bit and in turns (route,
        other, other, route; device time where graph-timed, else CUDA
        events: the "other_route" field).
        Each other build is held to it the same way (other(bind) -> a
        launcher; by default bind(fdl, h)), a bare launcher of this build
        beside a bare launcher of that one (bind_single), which an exact
        build must equal bit for bit. `new`/`old` replace the call and its
        generic twin and `args` the plain, float64, library calls and bound
        (the per-page launches of 3 pages, timed in CUDA events only)."""
        K, R, B = fdl.shape
        O = h.shape[1]
        hc = mk._flat_h(h).contiguous()  # the library call's operand
        # Device time where the host's launch can bound CUDA events.
        copies = (graph_copies(fdl, h) if new is None and B < GRAPH_TIMED_BELOW
                  else None)
        route = mk.mac_route(K, R, B, O, None, sms)
        new = new or (lambda: mk.mac_kmajor(fdl, h))
        old = old or (lambda: mk.mac_kmajor(fdl, h, generic=True))
        other = other or (lambda bind: bind(fdl, h))
        fields = {}
        for tag, (run, exact) in builds.items():
            call, mine = other(run.bind), other(this_bind)
            if exact and not torch.equal(call(), new()):
                raise AssertionError(f"build {tag} differs from the kernel "
                                     f"at {label} K={K} R={R} O={O} B={B}")
            turns = [cuda_ms(f, 20) for f in (call, mine, mine, call)]
            fields[tag] = dict(ms=(turns[0] + turns[3]) / 2,
                               ms_turns=[turns[0], turns[3]],
                               kernel_ms_turns=turns[1:3],
                               **({"equal": True} if exact else {}))
            if copies is not None:
                g_run = [run.bind(*c[:3]) for c in copies]
                g_new = [this_bind(*c[:3]) for c in copies]
                turns = [graph_ms(f) for f in (g_run, g_new, g_new, g_run)]
                fields[tag].update(graph_ms=(turns[0] + turns[3]) / 2,
                                   graph_ms_turns=[turns[0], turns[3]],
                                   kernel_graph_ms_turns=turns[1:3])
        if copies is not None:
            g_new = [functools.partial(mk.mac_kmajor, f, w, out=y)
                     for f, w, y, _ in copies]
            g_old = [functools.partial(mk.mac_kmajor, f, c, out=y,
                                       generic=True)
                     for f, _, y, c in copies]
            turns = [graph_ms(f) for f in (g_old, g_new, g_new, g_old)]
            extra.update(graph_ms=(turns[1] + turns[2]) / 2,
                         graph_ms_turns=turns[1:3],
                         generic_graph_ms=(turns[0] + turns[3]) / 2,
                         generic_graph_ms_turns=[turns[0], turns[3]],
                         **copies_fields(copies))
        if route.name in ("tiled", "balanced") and O in (4, 8, 12):
            extra["other_route"] = vs_route(
                fdl, h, copies, new,
                "balanced" if route.name == "tiled" else "tiled")
        dual("mac_kmajor", f"K={K} R={R} O={O} B={B}", new, old,
             args or (lambda: mk.mac_kmajor_ref(fdl, h),
                      lambda: mk.mac_kmajor_ref(fdl.double(), h.double()),
                      lambda: torch.einsum("krb,kor->okb", fdl, hc),
                      bound(4 * (fdl.numel() + hc.numel() + O * K * B),
                            2 * K * R * O * B)),
             label=label, route="generic",
             extra=dict(mac_route=list(route),
                        **({"builds": fields} if fields else {}), **extra))
        del copies

    def vs_route(fdl, h, copies, default, other) -> dict:
        """Route `other` beside mac_route's choice (`default`, the call) at
        this case: equal bit for bit, and in turns (default, other, other,
        default)."""
        K, R, B = fdl.shape
        shape = mk.mac_route(K, R, B, h.shape[1], other, sms)
        call = functools.partial(mk._mac_kmajor, fdl, h, route=other)
        if not torch.equal(call(), default()):
            raise AssertionError(f"route {shape} differs from mac_route's "
                                 f"at K={K} R={R} B={B}")
        if copies is None:
            turns = [cuda_ms(f, 20) for f in (default, call, call, default)]
            unit = "ms"
        else:
            g_default = [functools.partial(mk.mac_kmajor, f, w, out=y)
                         for f, w, y, _ in copies]
            g_other = [functools.partial(mk._mac_kmajor, f, w, out=y,
                                         route=other)
                       for f, w, y, _ in copies]
            turns = [graph_ms(f) for f in (g_default, g_other, g_other,
                                           g_default)]
            unit = "graph_ms"
        return {"route": list(shape), "equal": True,
                unit: (turns[1] + turns[2]) / 2, f"{unit}_turns": turns[1:3],
                f"default_{unit}": (turns[0] + turns[3]) / 2,
                f"default_{unit}_turns": [turns[0], turns[3]]}

    # The bake, the ring pool, the serving ring pool, the render CLI's graph
    # path (one lane per input file), the planner's ring capacity pool and
    # its steady-only capacity pool; the serving soak's two groups of 516
    # lanes (the 4320- and the 2000-tap bank). R = S * P2 * 2 with P2 = 10
    # (9 partitions + 1) or 5, O = E * 2.
    for B, R in ((BATCH, 40), (POOL_LANES[1], 40), (SERVE_LANES, 40),
                 (RENDER_FILES, 40), (CAPACITY_LANES[1], 40),
                 (STEADY_LANES[1], 40), (SERVE_SOAK_GROUP, 40),
                 (SERVE_SOAK_GROUP, 20)):
        fdl, h = tensor((Kp, R, B)), tensor((Kp, EARS * 2, R))
        single("single_block", fdl, h, profiled=B <= RENDER_FILES)
        del fdl, h

    # Pages R = S*2*M, O = M*E*2 at M = 8: the headline's 3 pages at S = 2,
    # and a long 8-speaker bank, whose page bank is 16 KB per bin.
    M = BLOCKS_PER_STEP
    n_long, s_long, b_long = LONG_BANK
    for n, R, B in ((3, SPEAKERS * 2 * M, BATCH), (n_long, s_long * 2 * M, b_long)):
        O = M * EARS * 2
        pages = [tensor((Kp, R, B)) for _ in range(n)]
        bank = tensor((n, Kp, O, R))
        stacked = torch.stack(pages)  # for the one library call only

        def per_page(mac=mk.mac_kmajor):
            acc = mac(pages[0], bank[0])
            for p, h in zip(pages[1:], bank[1:]):
                mac(p, h, out=acc, accumulate=True)
            return acc

        def per_page_bound(bind):
            """per_page as bare launchers of one build (bind_single)."""
            acc = torch.empty((O, Kp, B), device=dev)
            launchers = [bind(pages[0], bank[0], acc)] + [
                bind(p, h, acc, True) for p, h in zip(pages[1:], bank[1:])]

            def run():
                for launch in launchers:
                    launch()
                return acc
            return run

        def fused():
            return mk.mac_kmajor_pages(pages, bank)

        shape = f"{n} pages K={Kp} R={R} O={O} B={B}"
        equal = torch.equal(fused(), per_page())
        diff = (fused() - per_page()).abs().max().item()
        # In turns: per-page launches, fused, fused, per-page launches.
        turns = [cuda_ms(f, 20) for f in (per_page, fused, fused, per_page)]
        args = (lambda: mk.mac_kmajor_pages_ref(pages, bank),
                lambda: sum(mk.mac_kmajor_ref(p.double(), h.double())
                            for p, h in zip(pages, bank)),
                lambda: torch.einsum("pkrb,pkor->okb", stacked, bank),
                bound(4 * (n * Kp * R * B + bank.numel() + O * Kp * B),
                      2 * n * Kp * R * O * B))
        if n == 3:
            single(f"paged {n} pages", pages[0], bank[0], new=per_page,
                   old=lambda: per_page(functools.partial(mk.mac_kmajor,
                                                          generic=True)),
                   other=per_page_bound, args=args)
        measure("mac_kmajor_pages", f"paged fused {shape}", fused, *args,
                **vs_builds(pages, bank, fused),
                ms=(turns[1] + turns[2]) / 2, ms_turns=turns[1:3],
                per_page_launches_ms=(turns[0] + turns[3]) / 2,
                per_page_launches_ms_turns=[turns[0], turns[3]],
                equals_per_page_launches=equal,
                max_abs_diff_per_page_launches=diff)
        if not equal:
            raise AssertionError(f"{shape}: the fused kernel differs from one "
                                 f"launch per page by up to {diff}")
        del pages, bank, stacked
        torch.cuda.empty_cache()

    # The paged serving pool and the render CLI's --throughput bake run the
    # same 3 pages at their own lane counts (the planner's paged capacity
    # pool too: below, in turns with the 16-column route). The serving
    # pool's clients alone (1024 lanes, four whole 256-lane tiles a bin)
    # show what its 8 spare lanes' ragged fifth tile costs.
    n, R, O = 3, SPEAKERS * 2 * M, M * EARS * 2
    for B in (SERVE_LANES, SERVE_CLIENTS, RENDER_FILES):
        pages = [tensor((Kp, R, B)) for _ in range(n)]
        bank = tensor((n, Kp, O, R))
        stacked = torch.stack(pages)

        def fused():
            return mk.mac_kmajor_pages(pages, bank)

        measure("mac_kmajor_pages", f"paged fused {n} pages K={Kp} R={R} "
                f"O={O} B={B}", fused,
                lambda: mk.mac_kmajor_pages_ref(pages, bank),
                lambda: sum(mk.mac_kmajor_ref(p.double(), h.double())
                            for p, h in zip(pages, bank)),
                lambda: torch.einsum("pkrb,pkor->okb", stacked, bank),
                bound(4 * (n * Kp * R * B + bank.numel() + O * Kp * B),
                      2 * n * Kp * R * O * B),
                profiled=B <= RENDER_FILES, **vs_builds(pages, bank, fused))
        del pages, bank, stacked

    # A hot-swap round's dual bank doubles the output columns: O = 8 for the
    # single block (the ring pool at 8192 lanes, the engine at 16384, the
    # capacity pool) and O = 64 for the paged round (at 16384 lanes and the
    # capacity pool's widths). Each is timed in turns with another route of
    # the same kernel, which it must equal bit for bit: for mac_kmajor the
    # generic kernel, as every single-block case ("generic" fields; older
    # runs' "previous_route" fields held it too); for mac_kmajor_pages its
    # own 16-column instance, the same kernel taking 16 output columns a
    # pass ("columns16" fields; older runs' "previous_route" fields held the
    # older kernel's own 16-column route). So are the paged capacity widths
    # at the steady O = 32, and the three pages of a 5.1 and a 7.1 input
    # (R = 96 and 128 at M = 8) at the bake's width.
    R, O = 40, 2 * EARS * 2
    for B in (POOL_LANES[1], BATCH, CAPACITY_LANES[1]):
        fdl, h = tensor((Kp, R, B)), tensor((Kp, O, R))
        single("dual bank single_block", fdl, h)
        del fdl, h
        torch.cuda.empty_cache()
    n, steady = 3, M * EARS * 2
    for R, O, B in ([(SPEAKERS * 2 * M, steady, b)
                     for b in (*CAPACITY_PAGED_WIDTHS,
                               STEADY_LANES[BLOCKS_PER_STEP])]
                    + [(SPEAKERS * 2 * M, 2 * steady, b)
                       for b in (BATCH, *CAPACITY_PAGED_WIDTHS)]
                    + [(speakers * 2 * M, o, BATCH) for speakers in (6, 8)
                       for o in (steady, 2 * steady)]):
        pages = [tensor((Kp, R, B)) for _ in range(n)]
        bank = tensor((n, Kp, O, R))
        stacked = torch.stack(pages)

        def fused():
            return mk.mac_kmajor_pages(pages, bank)

        dual("mac_kmajor_pages", f"{n} pages K={Kp} R={R} O={O} B={B}",
             fused, lambda: mk.mac_kmajor_pages(pages, bank, columns=16),
             (lambda: mk.mac_kmajor_pages_ref(pages, bank),
              lambda: sum(mk.mac_kmajor_ref(p.double(), h.double())
                          for p, h in zip(pages, bank)),
              lambda: torch.einsum("pkrb,pkor->okb", stacked, bank),
              bound(4 * (n * Kp * R * B + bank.numel() + O * Kp * B),
                    2 * n * Kp * R * O * B)),
             label="dual bank" if O > steady else "paged fused",
             route="columns16", extra=vs_builds(pages, bank, fused))
        del pages, bank, stacked
        torch.cuda.empty_cache()

    # The grouped pools' per-group launches (GROUPS groups: 2048 lanes each
    # on the ring tier, 4096 on the paged tier), for the long bank (4320
    # taps: P2 = 10, 3 pages) and the short one (SHORT_TAPS: P2 = 5, 2
    # pages), at the steady O, the fade round's uniform all-dual O and the
    # three-half fade bank's O (a second swap while a fade is pending; the
    # long bank only, as the phases run it).
    ring_b = POOL_LANES[1] // GROUPS
    for R, halves in ((40, (1, 2, 3)), (20, (1, 2))):
        for h_count in halves:
            O = h_count * EARS * 2
            fdl, h = tensor((Kp, R, ring_b)), tensor((Kp, O, R))
            single(f"grouped {h_count}-bank single_block", fdl, h)
            del fdl, h
    paged_b = POOL_LANES[M] // GROUPS
    R = SPEAKERS * 2 * M
    for n, halves in ((3, (1, 2, 3)), (2, (1, 2))):
        for h_count in halves:
            O = M * h_count * EARS * 2
            pages = [tensor((Kp, R, paged_b)) for _ in range(n)]
            bank = tensor((n, Kp, O, R))
            stacked = torch.stack(pages)

            def fused():
                return mk.mac_kmajor_pages(pages, bank)

            measure("mac_kmajor_pages", f"grouped {h_count}-bank {n} pages "
                    f"K={Kp} R={R} O={O} B={paged_b}", fused,
                    lambda: mk.mac_kmajor_pages_ref(pages, bank),
                    lambda: sum(mk.mac_kmajor_ref(p.double(), h.double())
                                for p, h in zip(pages, bank)),
                    lambda: torch.einsum("pkrb,pkor->okb", stacked, bank),
                    bound(4 * (n * Kp * R * paged_b + bank.numel()
                               + O * Kp * paged_b),
                          2 * n * Kp * R * O * paged_b),
                    **vs_builds(pages, bank, fused))
            del pages, bank, stacked
    torch.cuda.empty_cache()

    # The live runtime (demo): one lane, the bundled 4096-tap Neutral bank
    # as the single-block operand at cursor 0 (R from the bank, not 40), and
    # the Neutral -> Room fade bank (O = 8) of a profile's HRIR swap, each
    # the rotated window of the doubled bank as conv_step passes it (read
    # in place). The steady row also gives the wrapper's host time a call.
    neutral, room = (prepare_renderer(
        wavio.WAVData(SAMPLE_RATE, bundled.synthesize_hrir(style)),
        channel_maps.STEREO, SAMPLE_RATE, BLOCK, device=dev).conv_params
        for style in ("neutral", "room"))
    for params in (neutral, upols.xfade_conv_params(neutral, room)):
        h = upols._rotated_window(upols.single_block_bank(params, Kp), 0)
        fdl = tensor((Kp, h.shape[2:].numel(), 1))
        extra = {}
        if h.shape[1] == EARS * 2:
            extra["host_us_per_call"] = host_us(lambda: mk.mac_kmajor(fdl, h))
        single("demo", fdl, h, profiled=True, bank="bundled 4096-tap",
               h_window=list(h.shape), **extra)
        del fdl, h
    launch_floor(dev, Kp)
    route_crossover(tensor, Kp)

    # The mesh phase's per-shard widths: the ring pool's MESH_SHARDS shards
    # (steady and fade O), the grouped ring pool's units (GROUPS groups
    # over MESH_GROUPED_SHARDS shards; the long and the short bank), a 7.1.4
    # speaker shard (2 of 8 speakers, P2 = 10: R = 40, at the lanes of one
    # of SPEAKER_MESH[0] stream shards), the multihost processes' stereo
    # speaker shard (1 of 2 speakers, R = 20, at the lanes of one of their
    # 2 rows; their stream shards are the ring shard's width), and the
    # paged bake's and pool's shards (3 pages, steady and fade O).
    shard_b = POOL_LANES[1] // MESH_SHARDS
    unit_b = POOL_LANES[1] // GROUPS // MESH_GROUPED_SHARDS
    for R, O, B, what in ((40, 4, shard_b, "ring shard"),
                          (40, 8, shard_b, "ring shard dual bank"),
                          (40, 4, unit_b, "grouped ring unit"),
                          (20, 4, unit_b, "grouped ring unit"),
                          (40, 4, SPEAKER_LANES // SPEAKER_MESH[0],
                           "7.1.4 speaker shard"),
                          (20, 4, MULTIHOST_LANES // 2,
                           "multihost speaker shard")):
        fdl, h = tensor((Kp, R, B)), tensor((Kp, O, R))
        single(f"mesh {what}", fdl, h)
        del fdl, h
    n, R, B = 3, SPEAKERS * 2 * M, POOL_LANES[M] // MESH_SHARDS
    for O in (M * EARS * 2, 2 * M * EARS * 2):
        pages = [tensor((Kp, R, B)) for _ in range(n)]
        bank = tensor((n, Kp, O, R))
        stacked = torch.stack(pages)
        measure("mac_kmajor_pages", f"mesh paged shard {n} pages K={Kp} R={R} "
                f"O={O} B={B}", lambda: mk.mac_kmajor_pages(pages, bank),
                lambda: mk.mac_kmajor_pages_ref(pages, bank),
                lambda: sum(mk.mac_kmajor_ref(p.double(), h.double())
                            for p, h in zip(pages, bank)),
                lambda: torch.einsum("pkrb,pkor->okb", stacked, bank),
                bound(4 * (n * Kp * R * B + bank.numel() + O * Kp * B),
                      2 * n * Kp * R * O * B))
        del pages, bank, stacked
    torch.cuda.empty_cache()
    return cases


def graph_copies(fdl, h) -> list:
    """(fdl, h, out, contiguous h) copies of a single-block case's operands
    for graph_ms to rotate over: enough that the replays' working set is at
    least twice the L2 (each call then reads the card's memory, not the
    L2), at least 3 and at most GRAPH_COPIES_MAX. The first holds the
    operands themselves; a copy of a window keeps its strides."""
    K, R, B = fdl.shape
    O = h.shape[1]
    nbytes = 4 * (fdl.numel() + h.numel() + O * K * B)
    n = min(GRAPH_COPIES_MAX, max(3, -(-2 * L2_BYTES // nbytes)))
    copies = []
    for i in range(n):
        f = fdl if i == 0 else fdl.clone()
        w = h if i == 0 else torch.empty_strided(
            h.shape, h.stride(), device=h.device).copy_(h)
        copies.append((f, w, torch.empty((O, K, B), device=fdl.device),
                       mk._flat_h(w).contiguous()))
    return copies


def copies_fields(copies) -> dict:
    """A graph-timed row's rotation: its copies, their working set, and
    whether that set still fits twice the L2 (too small a case to leave
    it: its device times are L2 times, and its share of the HBM bound is
    not one)."""
    fdl, h, out, _ = copies[0]
    nbytes = 4 * (fdl.numel() + h.numel() + out.numel()) * len(copies)
    return dict(graph_copies=len(copies), graph_working_set_bytes=nbytes,
                graph_l2_resident=nbytes < 2 * L2_BYTES)


def graph_ms(fns, reps: int = 20) -> float:
    """Device ms a call: `reps` calls (at least one per function of `fns`,
    taken in turn; one function or a list, each on its own copy of the
    operands) captured in one CUDA graph, replayed 3 times between CUDA
    events (no host launch between kernels, so a launch-sized kernel reads
    its time on the card, not the host's)."""
    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    reps = max(reps, len(fns))
    for fn in fns:
        fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()  # a warm-up off the capture, as torch.cuda.graphs asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * reps)


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds a call of fn() over `calls` calls back to back,
    with no synchronization inside the loop (the card drains behind)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


# One process's wrapper timing (wrapper_phase): argv[1] the root of a
# checkout whose airwave_tpu_torch it imports, argv[2] the calls a reading.
WRAPPER_CHILD = """
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from airwave_tpu_torch.kernels import mac_kmajor as mk
calls = int(sys.argv[2])
mk.build()
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
rows = []
for B, R in ((1, 36), (516, 40)):
    fdl = torch.randn((520, R, B), generator=gen, device=dev)
    h = torch.randn((520, 4, R), generator=gen, device=dev)
    out = torch.empty((4, 520, B), device=dev)
    for _ in range(100):
        mk.mac_kmajor(fdl, h, out=out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        mk.mac_kmajor(fdl, h, out=out)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        mk.mac_kmajor(fdl, h, out=out)
    end.record()
    torch.cuda.synchronize()
    rows.append(dict(B=B, R=R, O=4, host_us=host / calls * 1e6,
                     ms=start.elapsed_time(end) / calls))
print(json.dumps(rows))
"""


def wrapper_phase(roots: dict, smi: str) -> None:
    """The wrapper, not the kernel: mac_kmajor(fdl, h, out=out) at B=1 (R=36)
    and B=516 (R=40), O=4, contiguous h, through this checkout's package and
    through each baseline checkout's (label -> root), each in a process of
    its own (WRAPPER_CHILD), in turns (the other, this, this, the other):
    host µs a call over HOST_CALLS calls without a sync, and CUDA-event ms
    a call over as many."""
    def child(root):
        proc = subprocess.run(
            [sys.executable, "-c", WRAPPER_CHILD, root, str(HOST_CALLS)],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"wrapper timing in {root} failed:\n"
                               f"{proc.stderr[-4000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1])

    for label, root in roots.items():
        turns = [child(r) for r in (root, REPO, REPO, root)]
        rows = []
        for i, row in enumerate(turns[1]):
            rows.append(dict(
                B=row["B"], R=row["R"], O=row["O"],
                host_us=[turns[1][i]["host_us"], turns[2][i]["host_us"]],
                ms=[turns[1][i]["ms"], turns[2][i]["ms"]],
                **{f"{label}_host_us": [turns[0][i]["host_us"],
                                        turns[3][i]["host_us"]],
                   f"{label}_ms": [turns[0][i]["ms"], turns[3][i]["ms"]]}))
        phase("wrapper", baseline=label, root=root, calls=HOST_CALLS,
              rows=rows, device=smi)


def route_crossover(tensor, Kp: int) -> None:
    """mac_kmajor's small, tiled and balanced routes forced at the lane
    counts around mac_route's threshold (SMALL_MAX_BATCH), R=40 O=4: equal
    bit for bit,
    each route's device ms a launch from a trace of 30 launches ("not
    measured" where the trace lost launches) and from CUDA-graph replays
    (graph_ms). Where the card's time crosses is where the small route
    should stop."""
    rows = []
    for B in CROSSOVER_WIDTHS:
        fdl, h = tensor((Kp, 40, B)), tensor((Kp, EARS * 2, 40))
        calls = {route: functools.partial(mk._mac_kmajor, fdl, h, route=route)
                 for route in ("small", "tiled", "balanced")}
        if not (torch.equal(calls["small"](), calls["tiled"]())
                and torch.equal(calls["small"](), calls["balanced"]())):
            raise AssertionError(f"route_crossover B={B}: the routes differ")
        row = dict(B=B, default=mk.mac_route(Kp, 40, B, EARS * 2).name)
        for route, call in calls.items():
            trace = complete_trace(call, 30, "mac_kmajor")
            row[f"{route}_device_ms"] = trace["kernel_ms"]
            row[f"{route}_traced_launches"] = trace["traced_launches"]
            row[f"{route}_graph_ms"] = graph_ms(call)
        rows.append(row)
        del fdl, h
    phase("route_crossover", R=40, O=EARS * 2,
          small_max_batch=mk.SMALL_MAX_BATCH, rows=rows)


def launch_floor(dev: torch.device, grid: int) -> dict:
    """The launch floor beside the launch-sized rows (B=1 and B=16): an
    empty kernel of the MAC kernels' own library (airwave_empty_launch) at
    mac_kmajor's <<<grid, 256>>>, in CUDA-event ms per launch over
    back-to-back launches (the host's launch rate) and in device ms from a
    trace of 200 launches (complete_trace), which must hold all 200."""
    empty = mk._library()[0].airwave_empty_launch
    empty.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    empty.restype = ctypes.c_int
    launched = [0]

    def launch():
        code = empty(grid, 256, dev.index or 0,
                     torch.cuda.current_stream(dev).cuda_stream)
        if code != 0:
            raise RuntimeError(f"empty kernel: cuda error {code}")
        launched[0] += 1

    trace = complete_trace(launch, 200, "airwave_empty_kernel",
                           lambda: launched[0])
    floor = dict(kernel="launch_floor", case=f"empty kernel <<<{grid}, 256>>>",
                 ms=cuda_ms(launch, 200), host_us_per_call=host_us(launch),
                 profiled_device_ms=trace["kernel_ms"],
                 traced_launches=trace["traced_launches"],
                 trace_attempts=trace["attempts"])
    phase("kernel", **floor)
    if not trace["trace_complete"]:
        raise AssertionError(f"launch floor: the trace holds "
                             f"{trace['traced_launches']} of "
                             f"{trace['launches']} launches")
    return floor


def reference_lane(hrir, x, preamp, coeffs):
    """float64 reference of the chain for one lane's input x [S, n]: per
    speaker and ear fftconvolve, summed over speakers, then the EQ cascade
    (sosfilt of the port's design_cascade coefficients, preamp first)."""
    return reference_blend([hrir], [np.ones(x.shape[-1])], x, preamp, coeffs)


def reference_blend(banks, weights, x, preamp, coeffs):
    """float64 reference of one lane through a time-varying bank: the
    per-sample blend sum_i weights[i] * (banks[i] * x) of full-history
    convolutions (scipy fftconvolve), then the EQ cascade (sosfilt)."""
    return cascade(blend_dry(banks, weights, x), preamp, coeffs)


def blend_dry(banks, weights, x) -> np.ndarray:
    """sum_i weights[i] * (banks[i] * x), per ear, in float64."""
    from scipy.signal import fftconvolve

    n = x.shape[-1]
    out = np.zeros((EARS, n))
    for e in range(EARS):
        out[e] = sum(w * sum(fftconvolve(x[s].astype(np.float64),
                                         h[s, e].astype(np.float64))[:n]
                             for s in range(SPEAKERS))
                     for h, w in zip(banks, weights) if w.any())
    return out


def cascade(dry: np.ndarray, preamp, coeffs) -> np.ndarray:
    """The EQ cascade from rest (sosfilt of the design, preamp first)."""
    from scipy.signal import sosfilt

    sos = np.array([[c.b0, c.b1, c.b2, 1.0, c.a1, c.a2] for c in coeffs])
    return sosfilt(sos, preamp * dry, axis=-1)


def fade_weights(n_banks: int, n: int, events, first: int = 0) -> np.ndarray:
    """Per-sample weights [n_banks, n] of one lane's output: bank `first`
    until the first event, then for each (start, from, to, fade), in
    order, a ramp (t - start + 1) / fade from `from` to `to`, clipped at
    1."""
    w = np.zeros((n_banks, n))
    w[first] = 1.0
    for start, frm, to, fade in events:
        r = np.minimum((np.arange(n - start) + 1.0) / fade, 1.0)
        w[:, start:] = 0.0
        w[frm, start:] += 1.0 - r
        w[to, start:] += r
    return w


def reference_lanes(hrir, x, lanes, preamp, coeffs):
    return np.stack([reference_lane(hrir, x[b], preamp, coeffs)
                     for b in lanes])


def bake_phase(rng: np.random.Generator, dev: torch.device) -> dict:
    hrir = (rng.standard_normal((SPEAKERS, EARS, HRIR_TAPS)) * 0.05).astype(
        np.float32)
    hrir[:, :, 0] += 0.8
    preamp, coeffs = bench_eq()
    x = rng.standard_normal((BATCH, SPEAKERS, BAKE_BLOCKS * BLOCK),
                            dtype=np.float32)
    x *= 0.25
    lanes = sorted(int(b) for b in rng.choice(BATCH, 4, replace=False))
    ref = reference_lanes(hrir, x, lanes, preamp, coeffs)

    outs, launches = {}, {}
    for M in (BLOCKS_PER_STEP, 1):
        mk.reset_launch_count()
        t0 = time.perf_counter()
        y, state = bake(hrir, x, SAMPLE_RATE, coeffs, preamp,
                        block_size=BLOCK, blocks_per_step=M, device=dev)
        seconds = time.perf_counter() - t0
        launches[M] = counts_now()
        del state
        finite = bool(np.isfinite(y).all())
        rms = float(np.sqrt(np.mean(np.square(y, dtype=np.float64))))
        lane_err = [rel_rms(y[b], ref[i]) for i, b in enumerate(lanes)]
        phase("bake", blocks_per_step=M, seconds=seconds, shape=list(y.shape),
              finite=finite, rms=rms, launches=launches[M], lanes=lanes,
              lane_rel_rms=lane_err)
        if not (finite and rms > 0):
            raise AssertionError(f"M={M}: output not finite or silent")
        if not max(lane_err) <= CHAIN_TOL:
            raise AssertionError(f"M={M}: lane rel-RMS {lane_err} > {CHAIN_TOL}")
        used = "mac_kmajor_pages" if M > 1 else "mac_kmajor"
        expected = {name: BAKE_BLOCKS // M if name == used else 0
                    for name in KERNELS}
        if by_kernel(launches[M]) != expected:
            raise AssertionError(f"M={M}: launches {launches[M]}, expected "
                                 f"{expected} (one per step)")
        outs[M] = y
    # On the card in float64: the host takes seconds for 2 x 537M samples.
    a, b = (torch.from_numpy(outs[m]).to(dev, torch.float64)
            for m in (BLOCKS_PER_STEP, 1))
    modes = ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()
    del a, b
    torch.cuda.empty_cache()
    phase("bake_modes", rel_rms=modes)
    if not modes <= CHAIN_TOL:
        raise AssertionError(f"M=8 vs M=1 rel-RMS {modes} > {CHAIN_TOL}")
    return launches


@torch.inference_mode()
def timing_phase(seed: int, dev: torch.device, smi: str) -> int:
    """The paged chain at B=16384, M=8 on device-resident input
    (tools/profile_chain.headline_chain, the chain the profile_chain phase
    traces), 192 blocks per call with a checksum fetched to the host
    (bench.py:measure's pattern: one warm-up call, best of 3). Returns the
    peak device memory."""
    M = BLOCKS_PER_STEP
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        chain, state, x = profile_chain.headline_chain(
            seed, dev, BATCH, BLOCKS_PER_STEP)

        def run(state):
            acc = torch.zeros((8, 128), device=dev)
            for _ in range(TIMED_BLOCKS // M):
                state, y = chain(state, x)
                acc += y.reshape(-1, 8, 128).sum(0)
            return state, acc.cpu().numpy()

        state, warm = run(state)
        if not np.isfinite(warm).all():
            raise AssertionError("non-finite timing checksum")
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            state, host = run(state)
            best = min(best, time.perf_counter() - t0)
            if not np.isfinite(host).all():
                raise AssertionError("non-finite timing checksum")
        peak = torch.cuda.max_memory_allocated()

        def one_step():
            nonlocal state
            state, _ = chain(state, x)

        step_ms = cuda_ms(one_step, 10)
    audio_seconds = BATCH * TIMED_BLOCKS * BLOCK / SAMPLE_RATE
    phase("timing", card=smi, batch=BATCH, blocks_per_step=M,
          blocks=TIMED_BLOCKS, n_pages=len(state.conv.pages),
          ms_per_block_step=best / TIMED_BLOCKS * 1e3,
          x_realtime=audio_seconds / best, peak_memory_bytes=peak,
          device_step_ms=step_ms)
    return peak


def precision_phase(seed: int) -> None:
    """The precision tiers: a fresh interpreter per tier (the knobs are
    read at import) with AIRWAVE_MATMUL_PRECISION set, running
    precision_child; each prints its own line and exits non-zero when a
    gated tier misses its contract."""
    torch.cuda.empty_cache()
    for tier in TIERS:
        env = child_env()
        env["AIRWAVE_MATMUL_PRECISION"] = tier
        for follower in ("AIRWAVE_DFT_PRECISION", "AIRWAVE_MAC_PRECISION"):
            env.pop(follower, None)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--precision-child",
             "--seed", str(seed)], env=env, cwd=REPO,
            timeout=PRECISION_CHILD_TIMEOUT)
        if proc.returncode != 0:
            raise AssertionError(f"precision tier {tier}: child exited "
                                 f"{proc.returncode}")


def tier_cases(chain: BinauralChain, tier: str, dev: torch.device,
               seed: int) -> list:
    """The headline step's two DFT products on seeded activations: the
    analysis [1026, 512] x [512, 262144] and the folded synthesis
    [640, 1040] x [16, 1040, 16384]. Each gives the fp32 torch.mm/matmul
    (the strict route) with its bound, and under a relaxed tier the tier's
    route (precision.product on the split operands) against its plain
    version on the card (the same operands in fp32; rel-RMS within
    K * ROUTE_TOL_PER_K), the activation split's ms, and the route's
    bound: max(bytes / 3.35e12,
    passes * 2MNK / 989e12), the operands read once as bf16 and the fp32
    output written once (passes 3 at high, 1 at default)."""
    from airwave_tpu_torch.ops import precision

    gen = torch.Generator(device=dev).manual_seed(seed)
    wf = chain.conv_wf
    T = wf.shape[0]
    n_cols = SPEAKERS * BLOCKS_PER_STEP * BATCH
    Y_rows = chain.synth_folded.shape[1]
    shapes = {
        "analysis": (wf, wf.reshape(T, -1).t(),
                     torch.randn((T, n_cols), generator=gen, device=dev)),
        "synthesis": (chain.synth_folded, chain.synth_folded,
                      torch.randn((BLOCKS_PER_STEP * EARS, Y_rows, BATCH),
                                  generator=gen, device=dev)),
    }
    passes = {"high": 3, "default": 1}.get(tier)
    cases = []
    for name, (key, w, act) in shapes.items():
        M_, K = w.shape
        N = act.shape[-1]
        nb = act.numel() // (K * N)
        fp32_ms = cuda_ms(lambda: torch.matmul(w, act), 5)
        case = dict(case=name, a=list(w.shape), b=list(act.shape),
                    fp32_ms=fp32_ms,
                    fp32_bound_ms=bound((M_ * K + act.numel() + nb * M_ * N)
                                        * 4, 2 * nb * M_ * N * K)["bound_ms"])
        if passes:
            A = precision.operand(w, "a", tier, key=key)
            B = precision.operand(act, "b", tier)
            got = precision.product(A, B)
            plain = torch.matmul(A.float(), B.float())
            d = (got - plain).double()
            ref = plain.double()
            nbytes = (A.numel() + B.numel()) * 2 + got.numel() * 4
            flops = passes * 2 * nb * M_ * N * K
            by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
            case.update(
                route_tolerance_rel_rms=K * ROUTE_TOL_PER_K,
                rel_rms=(d.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())
                .item(),
                max_rel_err=(d.abs().max() / ref.abs().max()).item(),
                ms=cuda_ms(lambda: precision.product(A, B), 5),
                split_ms=cuda_ms(lambda: precision.operand(act, "b", tier), 5),
                plain_ms=cuda_ms(lambda: torch.matmul(A.float(), B.float()),
                                 2),
                bound_ms=max(by_bytes, by_ops) * 1e3,
                bound_by="bytes" if by_bytes >= by_ops else "operations")
            del A, B, got, plain, d, ref
        cases.append(case)
        del act
        torch.cuda.empty_cache()
    return cases


def precision_child(seed: int) -> None:
    """One tier of the precision phase, in a fresh interpreter whose
    AIRWAVE_MATMUL_PRECISION the parent set: the accuracy gate on the paged
    chain, the single-block chain and the ring pool; the headline 8-block
    step in CUDA-event time with its kernels from a trace (traced)
    and its relaxed products counted; the DFT products' cases
    (tier_cases); the strict policy checked after the step. Prints one
    line with precision_stamp() and exits 1 if a gated tier missed its
    contract or a tier's route disagrees with its plain version."""
    from airwave_tpu_torch.device import precision_stamp
    from airwave_tpu_torch.ops import fftmm, precision
    from airwave_tpu_torch.tools import validate_accuracy

    t0 = time.perf_counter()
    tier = fftmm.PRECISION
    apply_precision_policy()
    dev = torch.device("cuda", 0)
    contract = TIER_CONTRACT.get(tier, TIER_CONTRACT["high"])
    gates = {}
    for path, argv in PRECISION_GATES:
        result = validate_accuracy.validate(
            [*argv, "--contract", str(contract), "--device", str(dev)])
        gates[path] = {"rel_rms": result["value"], "pass": result["pass"]}
    with torch.inference_mode():
        chain, state, x = profile_chain.headline_chain(
            seed, dev, BATCH, BLOCKS_PER_STEP)

        def one_step():
            nonlocal state
            state, _ = chain(state, x)

        one_step()
        precision.reset_launch_count()
        mk.reset_launch_count()
        one_step()
        torch.cuda.synchronize()
        products = precision.launch_count()
        macs = mk.launch_count("mac_kmajor_pages")
        step_ms = cuda_ms(one_step, 10)
        profile = traced(one_step, 3, "mac_kmajor_pages")
        strict = precision_is_strict()
        del state, x
        torch.cuda.empty_cache()
        cases = tier_cases(chain, tier, dev, seed)
    phase("precision", tier=tier, card=card(), contract=contract,
          gated=tier in TIER_CONTRACT, gates=gates,
          headline_step_ms=step_ms, headline_step_profile=profile,
          relaxed_products_per_step=products, mac_launches_per_step=macs,
          strict_policy_after_step=strict, cases=cases,
          seconds=time.perf_counter() - t0, **precision_stamp())
    failures = []
    if tier in TIER_CONTRACT:
        failures += [f"{path} rel-RMS {g['rel_rms']} > {contract}"
                     for path, g in gates.items() if not g["pass"]]
    if (products > 0) != (tier != "highest"):
        failures.append(f"{products} relaxed products a step at {tier}")
    if macs != 1:
        failures.append(f"{macs} MAC launches a step")
    if not strict:
        failures.append("the strict fp32 policy did not survive the step")
    failures += [f"{c['case']} route rel-RMS {c['rel_rms']} > "
                 f"{c['route_tolerance_rel_rms']}"
                 for c in cases
                 if "rel_rms" in c and c["rel_rms"] > c["route_tolerance_rel_rms"]]
    if failures:
        print(f"chip_smoke: precision {tier}: {failures}", file=sys.stderr)
        sys.exit(1)


def hrir_wav(seed: int, directory: str, taps: int = HRIR_TAPS) -> wavio.WAVData:
    """A seeded synthetic 14-channel HRIR bank of `taps` frames, written as a
    WAV file by the port's io.wav and loaded back: the renderer's asset
    path."""
    rng = np.random.default_rng(seed)
    bank = (rng.standard_normal((HRIR_CHANNELS, taps)) * 0.05).astype(
        np.float32)
    bank[:, 0] += 0.8
    path = os.path.join(directory, f"hrir14-{seed}.wav")
    wavio.save(path, bank, SAMPLE_RATE)
    return wavio.load(path)


def make_pool(wav, lanes: int, M: int, device, definition) -> StreamPool:
    renderer = prepare_renderer(wav, channel_maps.STEREO, SAMPLE_RATE, BLOCK,
                                lookahead=M, device=device)
    return StreamPool(lanes, SAMPLE_RATE, renderer, eq_definition=definition,
                      block_size=BLOCK, blocks_per_step=M, device=device)


def feed_round(pool: StreamPool, lanes: np.ndarray, chunks: np.ndarray):
    """One round: a step of input to each of `lanes` (ascending), one pump
    round, and the rendered step of each of them pulled: [k, E, frames]."""
    pool.push_many(lanes, chunks)
    rounds = pool.pump()
    if rounds != 1:
        raise AssertionError(f"pump ran {rounds} rounds, expected 1")
    return pool.pull_many(lanes, pool.step_frames)


def settle(pool: StreamPool) -> None:
    """Run the construction-time unity -> target EQ ramp to its end on
    silence: afterwards every lane starts from zero history at the target,
    which the float64 reference assumes."""
    lanes = np.arange(pool.max_streams)
    zeros = np.zeros((len(lanes), SPEAKERS, pool.step_frames), np.float32)
    for _ in range(-(-EQ_RAMP // pool.step_frames) + 1):
        feed_round(pool, lanes, zeros)


def pool_phase(label: str, wav, dev: torch.device, M: int,
               rng: np.random.Generator):
    """The pool at full width on ragged then full traffic; 4 sampled lanes
    against float64. Returns (pool, one step of input per lane, launches)."""
    lanes = POOL_LANES[M]
    ragged, full = POOL_ROUNDS[M]
    preamp, coeffs = bench_eq()
    hrir = build_hrir_time_domain(wav, channel_maps.STEREO, SAMPLE_RATE)
    t0 = time.perf_counter()
    pool = make_pool(wav, lanes, M, dev, bench_eq_definition())
    every = np.array([pool.attach() for _ in range(lanes)])
    pool.prewarm()
    settle(pool)
    setup = time.perf_counter() - t0
    step = pool.step_frames
    base = rng.standard_normal((lanes, SPEAKERS, step), dtype=np.float32)
    base *= 0.25
    sampled = sorted(int(b) for b in rng.choice(np.arange(1, lanes), 4,
                                                 replace=False))
    inputs = {b: [] for b in sampled}
    outputs = {b: [] for b in sampled}

    def run(fed):
        y = feed_round(pool, fed, base[:len(fed)])
        for b in sampled:
            pos = int(np.searchsorted(fed, b))
            if pos < len(fed) and fed[pos] == b:
                inputs[b].append(base[pos])
                outputs[b].append(y[pos])

    mk.reset_launch_count()
    t0 = time.perf_counter()
    for _ in range(ragged):
        run(np.nonzero(rng.random(lanes) < POOL_SHARE)[0])
    pool.detach(0)  # every attached lane fed: the "_all" variant
    for _ in range(full // 2):
        run(every[1:])
    if pool.attach() != 0:
        raise AssertionError("lane 0 was not recycled")
    for _ in range(full - full // 2):  # every lane fed: the "_id" variant
        run(every)
    seconds = time.perf_counter() - t0
    launches = counts_now()
    stats = pool.stats()
    lane_err = [rel_rms(np.concatenate(outputs[b], -1),
                        reference_lane(hrir, np.concatenate(inputs[b], -1),
                                       preamp, coeffs))
                for b in sampled]
    tier = "ring" if M == 1 else "paged"
    phase(label, lanes=lanes, blocks_per_step=M, setup_seconds=setup,
          seconds=seconds, rounds=ragged + full, launches=launches,
          debt_rolls=stats["debt_rolls"],
          variant_rounds=stats["variant_rounds"], lanes_sampled=sampled,
          lane_blocks=[len(inputs[b]) * M for b in sampled],
          lane_rel_rms=lane_err)
    if not max(lane_err) <= CHAIN_TOL:
        raise AssertionError(f"{label}: lane rel-RMS {lane_err} > {CHAIN_TOL}")
    used = "mac_kmajor_pages" if M > 1 else "mac_kmajor"
    expected = {name: ragged + full if name == used else 0 for name in KERNELS}
    if by_kernel(launches) != expected:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expected} (one per round)")
    if stats["debt_rolls"] <= 0:
        raise AssertionError(f"{label}: no debt roll ran")
    want = {tier, f"{tier}_all", f"{tier}_id"}
    if not want <= set(stats["variant_rounds"]) or stats["render_errors"]:
        raise AssertionError(f"{label}: variants {stats['variant_rounds']}, "
                             f"errors {stats['render_errors']}")
    return pool, base, launches


def saturated_round(pool: StreamPool, x: torch.Tensor, fade: bool = False):
    """A function running one saturated device round of `pool` (the "_id"
    step, every lane harvested, on the device-resident input x) on a fresh
    carry of the pool's shape: each group's active bank and EQ target, or
    with fade=True a hot-swap round of every group on its self-crossfade
    with every lane blending (a grouped fade round's shape)."""
    variant = "ring_id" if pool.blocks_per_step == 1 else "paged_id"
    targets = [rt.active.params for rt in pool.eq_runtimes]
    p = pool._pack(targets)
    if fade:
        banks = [pool._self_fade(g) for g in range(pool.groups)]
        params = pool._pack(b[0] for b in banks)
        operands = pool._pack(b[1] for b in banks)
        ramp = torch.from_numpy(upols.xfade_ramp(
            min(EQ_RAMP, pool.step_frames), pool.step_frames)).to(pool.device)
        mask = torch.ones(pool.max_streams, dtype=torch.bool,
                          device=pool.device)
    else:
        params = pool._conv_params
        operands = pool._pack(pool._operands(q, g)
                              for g, q in enumerate(targets))
        ramp = mask = None
    state = pool._fresh_state()
    idx = torch.arange(pool.max_streams, device=pool.device)

    def run():
        nonlocal state
        state, _ = pool_step_body(params, p, p, state, x, idx,
                                  pool.eq_runtime.transition_length, True,
                                  False, variant, operands, ramp, mask)

    return run


def pool_timing_phase(pool: StreamPool, base: np.ndarray, smi: str) -> int:
    """bench.py:measure_pool_host's pattern: every lane fed one step per
    round (push_many, pump(max_rounds=1), pull_many), POOL_TIMED_BLOCKS
    blocks per lane per reading, best of 3 after two warm-up rounds. Then
    one saturated device round alone (the "_id" step on device-resident
    input), in CUDA-event time (for the record only). Returns the peak
    device memory of the timed rounds."""
    lanes = np.arange(pool.max_streams)
    M, step = pool.blocks_per_step, pool.step_frames
    rounds = POOL_TIMED_BLOCKS // M

    def one_round(split):
        t0 = time.perf_counter()
        pool.push_many(lanes, base)
        t1 = time.perf_counter()
        pool.pump(max_rounds=1)
        t2 = time.perf_counter()
        pool.pull_many(lanes, step)
        split += (t1 - t0, t2 - t1, time.perf_counter() - t2)

    for _ in range(2):
        one_round(np.zeros(3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    best, best_split = float("inf"), None
    for _ in range(3):
        split = np.zeros(3)
        t0 = time.perf_counter()
        for _ in range(rounds):
            one_round(split)
        wall = time.perf_counter() - t0
        if wall < best:
            best, best_split = wall, split
    peak = torch.cuda.max_memory_allocated()

    variant = "ring_id" if M == 1 else "paged_id"
    with torch.inference_mode():
        x = torch.from_numpy(base).to(pool.device)
        if M > 1:
            x = x.view(len(lanes), SPEAKERS, M, BLOCK)
        device_round = saturated_round(pool, x)
        device_ms = cuda_ms(device_round, 10)
    round_ms = best / rounds * 1e3
    phase("pool_timing", card=smi, lanes=len(lanes), blocks_per_step=M,
          rounds=rounds, x_realtime=len(lanes) * rounds * step / SAMPLE_RATE
          / best, ms_per_round=round_ms, ms_per_block=round_ms / M,
          push_ms_per_round=best_split[0] / rounds * 1e3,
          pump_ms_per_round=best_split[1] / rounds * 1e3,
          pull_ms_per_round=best_split[2] / rounds * 1e3,
          device_round_variant=variant, device_round_ms=device_ms,
          host_share=1.0 - device_ms / round_ms, peak_memory_bytes=peak)
    return peak


def pool_retarget_phase(wav, dev: torch.device, rng: np.random.Generator):
    """A pool on the card and the same pool on the CPU, fed the same ragged
    traffic with three EQ retargets and a detach and re-attach: every
    stream agrees within CHAIN_TOL, on both tiers."""
    definitions = [bench_eq_definition(g) for g in (1.0, 0.5, -1.0, 1.5)]
    lanes, detached = RETARGET_LANES, 5
    for M in (1, BLOCKS_PER_STEP):
        pools = [make_pool(wav, lanes, M, d, definitions[0])
                 for d in (dev, torch.device("cpu"))]
        for pool in pools:
            for _ in range(lanes):
                pool.attach()
        step = pools[0].step_frames
        gap = -(-EQ_RAMP // step) + 2  # rounds from one retarget to the next
        retargets = {1 + gap * i: definitions[i] for i in (1, 2, 3)}
        outs = [[[] for _ in range(lanes)] for _ in pools]
        for rnd in range(1 + 4 * gap):
            if rnd in retargets:
                for pool in pools:
                    pool.set_equalizer(retargets[rnd])
            if rnd == gap + 1:
                for pool in pools:
                    pool.detach(detached)
            if rnd == gap + 3:
                for pool in pools:
                    if pool.attach() != detached:
                        raise AssertionError("lane was not recycled")
            fed = rng.random(lanes) < POOL_SHARE
            if gap + 1 <= rnd < gap + 3:
                fed[detached] = False
            fed = np.nonzero(fed)[0]
            chunks = rng.standard_normal((len(fed), SPEAKERS, step),
                                         dtype=np.float32) * 0.25
            for pool, out in zip(pools, outs):
                y = feed_round(pool, fed, chunks)
                for j, lane in enumerate(fed):
                    out[lane].append(y[j])
        err = [rel_rms(np.concatenate(a, -1), np.concatenate(b, -1))
               for a, b in zip(*outs)]
        rts = [pool.eq_runtime for pool in pools]
        stats = pools[0].stats()
        phase("pool_retarget", lanes=lanes, blocks_per_step=M,
              rounds=1 + 4 * gap, retarget_rounds=sorted(retargets),
              max_stream_rel_rms=max(err), debt_rolls=stats["debt_rolls"],
              variant_rounds=stats["variant_rounds"])
        if not max(err) <= CHAIN_TOL:
            raise AssertionError(f"card vs CPU rel-RMS {max(err)} > "
                                 f"{CHAIN_TOL} (M={M})")
        for rt in rts:
            if (rt.active.definition != definitions[-1]
                    or rt.is_transitioning or rt.pending_target is not None):
                raise AssertionError(f"the third retarget did not land "
                                     f"(M={M})")


def launches_now() -> dict:
    """Each kernel's launch count and its launches by output width O."""
    return {name: {"total": mk.launch_count(name),
                   **{f"O={o}": mk.launch_count(name, columns=o)
                      for o in (4, 8, 12, 32, 64, 96)
                      if mk.launch_count(name, columns=o)}}
            for name in KERNELS}


def routes_now() -> dict:
    """Each kernel's launches by route (mk.launch_routes)."""
    return {name: mk.launch_routes(name) for name in KERNELS}


def counts_now() -> dict:
    """Each kernel's launch count by name, and under "routes" each one's
    launches by route."""
    return {**{name: mk.launch_count(name) for name in KERNELS},
            "routes": routes_now()}


def by_kernel(counts: dict) -> dict:
    """{kernel: launches} of a counts_now() reading."""
    return {name: counts[name] for name in KERNELS}


def route_counts(counts, name: str) -> dict:
    """{route: launches} of kernel `name` in a path's launch record ({}
    where it holds no "routes")."""
    return counts.get("routes", {}).get(name, {}) if isinstance(
        counts, dict) else {}


def engine_hotswap_phase(wavs, dev: torch.device, rng: np.random.Generator,
                         smi: str) -> dict:
    """BinauralEngine(16384 lanes) with the 10-filter EQ: ENGINE_BLOCKS[0]
    blocks, a crossfaded swap, ENGINE_BLOCKS[1] block, a second swap while
    the first fade is still pending (a restart from the lerped bank), then
    ENGINE_BLOCKS[2] blocks. 4 sampled lanes against the float64
    time-varying reference; each fade block one mac_kmajor launch at O = 8,
    each steady block one at O = 4; then one steady and one fade block alone
    in CUDA-event time."""
    renderers = [prepare_renderer(w, channel_maps.STEREO, SAMPLE_RATE, BLOCK,
                                  device=dev) for w in wavs]
    banks = [build_hrir_time_domain(w, channel_maps.STEREO, SAMPLE_RATE)
             for w in wavs]
    preamp, coeffs = bench_eq()
    eng = BinauralEngine(BATCH, SAMPLE_RATE, BLOCK, renderer=renderers[0],
                         device=dev)
    eng.prepare_equalizer(bench_eq_definition())
    zeros = np.zeros((BATCH, SPEAKERS, BLOCK), np.float32)
    for _ in range(-(-EQ_RAMP // BLOCK) + 1):  # the EQ's unity ramp ends
        eng.process_block(zeros)
    sampled = sorted(int(b) for b in rng.choice(BATCH, 4, replace=False))
    before, between, after = ENGINE_BLOCKS
    swaps = {before: 1, before + between: 2}
    xs, ys = [], []
    mk.reset_launch_count()
    t0 = time.perf_counter()
    for b in range(before + between + after):
        if b in swaps and not eng.set_renderer(renderers[swaps[b]]):
            raise AssertionError(f"engine swap at block {b} did not crossfade")
        x = rng.standard_normal((BATCH, SPEAKERS, BLOCK), dtype=np.float32)
        x *= 0.25
        ys.append(eng.process_block(x)[sampled])
        xs.append(x[sampled])
    seconds = time.perf_counter() - t0
    launches = launches_now()
    fade = eng.config.transition_length(SAMPLE_RATE)
    n, t1, t2 = len(xs) * BLOCK, before * BLOCK, (before + between) * BLOCK
    r1 = np.minimum((np.arange(n) - t1 + 1.0) / fade, 1.0).clip(0.0)
    r2 = np.minimum((np.arange(n) - t2 + 1.0) / fade, 1.0).clip(0.0)
    r0 = min((t2 - t1 + 1.0) / fade, 1.0)  # where the restart freezes fade 1
    weights = np.stack([1.0 - r1, r1, np.zeros(n)])
    weights[:, t2:] = np.stack([(1.0 - r2) * (1.0 - r0), (1.0 - r2) * r0,
                                r2])[:, t2:]
    x_lane, y_lane = np.concatenate(xs, -1), np.concatenate(ys, -1)
    lane_err = [rel_rms(y_lane[i], reference_blend(banks, weights, x_lane[i],
                                                   preamp, coeffs))
                for i in range(len(sampled))]
    fade_blocks = min(between + -(-fade // BLOCK), len(xs) - before)
    expected = {"mac_kmajor": {"total": len(xs), "O=4": len(xs) - fade_blocks,
                               "O=8": fade_blocks},
                "mac_kmajor_pages": {"total": 0}}

    with torch.inference_mode():
        state = ChainState(
            upols.make_conv_state(BATCH, SPEAKERS, eng._conv_params.partition_count,
                                  BLOCK, dev),
            eq_block.make_eq_state(BATCH, device=dev))
        x_dev = torch.from_numpy(zeros).to(dev).normal_(0.0, 0.25)
        p = eng.eq_runtime.active.params
        dual = upols.xfade_conv_params(eng._conv_params, eng._conv_params)
        dual_ops = make_chain_operands(dual, None, 1, eng._k_padded)
        ramp = torch.from_numpy(upols.xfade_ramp(fade, BLOCK)).to(dev)
        tl = eng.eq_runtime.transition_length
        steady_ms = cuda_ms(lambda: chain_step_fn(
            eng._conv_params, p, p, state, x_dev, tl, True, True, False,
            eng._operands), 10)
        fade_ms = cuda_ms(lambda: chain_step_fn(
            dual, p, p, state, x_dev, tl, True, True, False, dual_ops,
            xfade_ramp=ramp), 10)
    phase("hotswap_engine", card=smi, lanes=BATCH, blocks=len(xs),
          swap_blocks=sorted(swaps), seconds=seconds, launches=launches,
          lanes_sampled=sampled, lane_rel_rms=lane_err,
          steady_block_device_ms=steady_ms, fade_block_device_ms=fade_ms)
    if not max(lane_err) <= CHAIN_TOL:
        raise AssertionError(f"engine hot-swap: lane rel-RMS {lane_err} > "
                             f"{CHAIN_TOL}")
    if launches != expected:
        raise AssertionError(f"engine hot-swap: launches {launches}, expected "
                             f"{expected}")
    return launches


class LaneRecorder:
    """Sampled lanes of a pool, round by round: their inputs and outputs,
    and their hot-swap fades on each lane's own output timeline as the pool
    runs them. A swap arms every attached lane; an armed lane fades in its
    next rendered round, from the bank it last played (also after a second
    swap before that round) to the newest."""

    def __init__(self, lanes, step: int):
        self.lanes, self.step = lanes, step
        self.inputs = {b: [] for b in lanes}
        self.outputs = {b: [] for b in lanes}
        self.current = {b: 0 for b in lanes}
        self.armed = {b: None for b in lanes}
        self.events = {b: [] for b in lanes}

    def swap(self, to: int, fade: int, lanes=None) -> None:
        for b in self.lanes if lanes is None else lanes:
            self.armed[b] = (self.current[b], to, fade)

    def record(self, fed: np.ndarray, chunks: np.ndarray, y: np.ndarray):
        for b in self.lanes:
            pos = int(np.searchsorted(fed, b))
            if pos == len(fed) or fed[pos] != b:
                continue
            if self.armed[b]:
                frm, to, fade = self.armed[b]
                self.events[b].append((len(self.inputs[b]) * self.step, frm,
                                       to, fade))
                self.current[b], self.armed[b] = to, None
            self.inputs[b].append(chunks[pos])
            self.outputs[b].append(y[pos])

    def errors(self, banks, preamp, coeffs) -> list:
        err = []
        for b in self.lanes:
            x = np.concatenate(self.inputs[b], -1)
            w = fade_weights(len(banks), x.shape[-1], self.events[b])
            err.append(rel_rms(np.concatenate(self.outputs[b], -1),
                               reference_blend(banks, w, x, preamp, coeffs)))
        return err


def pool_hotswap_phase(label: str, wavs, dev: torch.device, M: int,
                       rng: np.random.Generator, smi: str) -> dict:
    """A pool at full width through HOTSWAP_SCHEDULE[M]: ragged traffic,
    crossfaded swaps (on the paged tier a second one to a bank of fewer
    partitions, padded onto the carry), one sampled lane paused across the
    first swap that rejoins with alignment debt and fades then. 4 sampled
    lanes against the float64 time-varying reference; every round one MAC
    launch, at twice the steady O in a fade round (O = 8 ring, 64 paged) and
    at the steady O (4, 32) otherwise; then one steady and one fade device
    round alone in CUDA-event time, the fade round's kernels from a trace
    (traced)."""
    lanes = POOL_LANES[M]
    schedule, paused_rounds = HOTSWAP_SCHEDULE[M]
    renderers = [prepare_renderer(w, channel_maps.STEREO, SAMPLE_RATE, BLOCK,
                                  lookahead=M, device=dev) for w in wavs]
    banks = [build_hrir_time_domain(w, channel_maps.STEREO, SAMPLE_RATE)
             for w in wavs]
    preamp, coeffs = bench_eq()
    pool = StreamPool(lanes, SAMPLE_RATE, renderers[0],
                      eq_definition=bench_eq_definition(), block_size=BLOCK,
                      blocks_per_step=M, device=dev)
    every = np.array([pool.attach() for _ in range(lanes)])
    t0 = time.perf_counter()
    pool.prewarm(include_hotswap=True)
    prewarm_seconds = time.perf_counter() - t0
    settle(pool)
    step = pool.step_frames
    fade = min(pool.config.transition_length(SAMPLE_RATE), step)
    sampled = sorted(int(b) for b in rng.choice(lanes, 4, replace=False))
    paused = sampled[0]
    rec = LaneRecorder(sampled, step)
    name = "mac_kmajor_pages" if M > 1 else "mac_kmajor"
    steady_o, dual_o = (EARS * 2, 2 * EARS * 2) if M == 1 else (
        M * EARS * 2, 2 * M * EARS * 2)
    round_kinds, carry = [], []
    mk.reset_launch_count()
    t0 = time.perf_counter()
    rnd = 0
    for item in schedule:
        if not isinstance(item, str):
            if not pool.set_renderer(renderers[item]):
                raise AssertionError(f"{label}: swap to bank {item} reset")
            rec.swap(item, fade)
            carry.append([pool._bank_partitions[0],
                          renderers[item].partition_count, pool._lane_cycle])
            continue
        fed = every if item == "f" else np.nonzero(
            rng.random(lanes) < POOL_SHARE)[0]
        if rnd in paused_rounds:
            fed = fed[fed != paused]
        chunks = rng.standard_normal((len(fed), SPEAKERS, step),
                                     dtype=np.float32) * 0.25
        fades, before = pool.fade_rounds, launches_now()[name]
        rec.record(fed, chunks, feed_round(pool, fed, chunks))
        after = launches_now()[name]
        kind = "fade" if pool.fade_rounds > fades else "steady"
        want_o = dual_o if kind == "fade" else steady_o
        if (after["total"] - before["total"] != 1
                or after.get(f"O={want_o}", 0) - before.get(f"O={want_o}", 0) != 1):
            raise AssertionError(f"{label}: round {rnd} ({kind}) launched "
                                 f"{before} -> {after}, expected one {name} "
                                 f"at O={want_o}")
        round_kinds.append(kind)
        rnd += 1
    seconds = time.perf_counter() - t0
    launches = launches_now()
    stats = pool.stats()
    lane_err = rec.errors(banks, preamp, coeffs)

    variant = "ring_id" if M == 1 else "paged_id"
    p = pool.eq_runtime.active.params
    with torch.inference_mode():
        state = pool._fresh_state()
        shape = (lanes, SPEAKERS, M, BLOCK) if M > 1 else (lanes, SPEAKERS, BLOCK)
        x = torch.empty(shape, device=dev).normal_(0.0, 0.25)
        idx = torch.arange(lanes, device=dev)
        dual, dual_ops = pool._self_fade(0)
        mask = torch.ones(lanes, dtype=torch.bool, device=dev)

        def device_round(params, operands, ramp=None, lane_mask=None):
            nonlocal state
            state, _ = pool_step_body(
                params, p, p, state, x, idx, pool.eq_runtime.transition_length,
                True, False, variant, operands, ramp, lane_mask)

        steady_ms = cuda_ms(lambda: device_round(pool._conv_params,
                                                 pool._operands(p)), 5)
        fade_ms = cuda_ms(lambda: device_round(dual, dual_ops,
                                               pool._xfade_ramp, mask), 5)
        fade_profile = traced(
            lambda: device_round(dual, dual_ops, pool._xfade_ramp, mask), 3,
            name)
    phase(label, card=smi, lanes=lanes, blocks_per_step=M,
          prewarm_seconds=prewarm_seconds, seconds=seconds,
          rounds=len(round_kinds), round_kinds=round_kinds,
          carry_bank_cycle=carry, launches=launches,
          fade_rounds=stats["fade_rounds"], debt_rolls=stats["debt_rolls"],
          lanes_sampled=sampled, paused_lane=paused,
          lane_fades=[rec.events[b] for b in sampled], lane_rel_rms=lane_err,
          steady_round_device_ms=steady_ms, fade_round_device_ms=fade_ms,
          fade_round_profile=fade_profile)
    if not max(lane_err) <= CHAIN_TOL:
        raise AssertionError(f"{label}: lane rel-RMS {lane_err} > {CHAIN_TOL}")
    if round_kinds[-1] != "steady" or pool._xfade_params is not None:
        raise AssertionError(f"{label}: the fades did not end")
    if not rec.events[paused] or stats["debt_rolls"] <= 0:
        raise AssertionError(f"{label}: the paused lane did not rejoin and fade")
    if any(c[0] != carry[0][0] or c[2] != carry[0][0] // M for c in carry):
        raise AssertionError(f"{label}: the carry's partitions or lane cycle "
                             f"moved with the renderer: {carry}")
    if len(wavs) > 2 and not carry[-1][1] < carry[-1][0]:
        raise AssertionError(f"{label}: the last bank was not shorter than the "
                             f"carry: {carry}")
    return launches


class GroupedRecorder(LaneRecorder):
    """LaneRecorder for a grouped pool: each sampled lane starts on its
    group's bank, a swap arms only the swapped group's lanes, and a
    retarget of a group's EQ starts, at each of its lanes' next rendered
    sample, the crossfade from the old cascade (its history kept) to the
    new one (from rest) over EQ_RAMP samples."""

    def __init__(self, lanes, step: int, group_of, banks: dict, eqs: dict):
        super().__init__(lanes, step)
        self.group = {b: group_of(b) for b in lanes}
        self.current = {b: banks[self.group[b]] for b in lanes}
        self.first = dict(self.current)
        self.eq = {b: [eqs[self.group[b]]] for b in lanes}
        self.eq_start = {b: None for b in lanes}
        self._eq_armed = {b: None for b in lanes}

    def swap_group(self, group: int, to: int, fade: int) -> None:
        self.swap(to, fade, [b for b in self.lanes if self.group[b] == group])

    def retarget(self, group: int, eq) -> None:
        for b in self.lanes:
            if self.group[b] == group:
                self._eq_armed[b] = eq

    def record(self, fed, chunks, y):
        for b in self.lanes:
            pos = int(np.searchsorted(fed, b))
            if self._eq_armed[b] is not None and pos < len(fed) and fed[pos] == b:
                self.eq[b].append(self._eq_armed[b])
                self.eq_start[b] = len(self.inputs[b]) * self.step
                self._eq_armed[b] = None
        super().record(fed, chunks, y)

    def errors(self, banks) -> list:
        err = []
        for b in self.lanes:
            x = np.concatenate(self.inputs[b], -1)
            n = x.shape[-1]
            dry = blend_dry(banks, fade_weights(len(banks), n,
                                                self.events[b],
                                                self.first[b]), x)
            want = cascade(dry, *self.eq[b][0])
            if self.eq_start[b] is not None:
                t0 = self.eq_start[b]
                r = np.zeros(n)
                r[t0:] = np.minimum((np.arange(n - t0) + 1.0) / EQ_RAMP, 1.0)
                new = np.zeros_like(want)
                new[:, t0:] = cascade(dry[:, t0:], *self.eq[b][1])
                want = (1.0 - r) * want + r * new
            err.append(rel_rms(np.concatenate(self.outputs[b], -1), want))
        return err


def grouped_pool(renderers, lanes: int, M: int, dev: torch.device,
                 active=GROUPED_BANKS) -> StreamPool:
    """A grouped pool of GROUPS profiles, group g on renderers[active[g]]
    with the EQ at scale GROUPED_EQ_SCALES[g]."""
    return StreamPool(lanes, SAMPLE_RATE, block_size=BLOCK, blocks_per_step=M,
                      device=dev, profiles=[
                          PoolProfile(renderers[bank], bench_eq_definition(
                              GROUPED_EQ_SCALES[g]))
                          for g, bank in enumerate(active)])


def pool_grouped_phase(label: str, wavs, dev: torch.device, M: int,
                       rng: np.random.Generator, smi: str) -> dict:
    """A grouped pool at full width (GROUPS profile groups of different
    banks, partition counts and EQs) through GROUPED_SCHEDULE[M]: ragged
    rounds, swaps of groups 0 and 2 landing in one round, a second swap of
    group 0 while its paused lane still owes the first fade (the three-half
    fade bank), a retarget of group 1's EQ, saturated rounds. 2 sampled
    lanes per group against the float64 time-varying reference (its own
    banks and EQs); every round GROUPS MAC launches, one per group. Then a
    snapshot restored into a fresh pool (bit for bit the uninterrupted
    pool's audio), on the ring tier a resize into RESIZE_LANES lanes, and
    the saturated grouped device round in CUDA-event time in turns with the
    ungrouped pool's at the same lane count (steady and fade rounds), with
    the full round's host share and the peak memory."""
    lanes = POOL_LANES[M]
    schedule, paused_rounds = GROUPED_SCHEDULE[M]
    banks = [build_hrir_time_domain(w, channel_maps.STEREO, SAMPLE_RATE)
             for w in wavs]
    eqs = [bench_eq_definition(k) for k in GROUPED_EQ_SCALES]
    designs = [bd.design_cascade(d, SAMPLE_RATE) for d in eqs]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    renderers = [prepare_renderer(w, channel_maps.STEREO, SAMPLE_RATE, BLOCK,
                                  lookahead=M, device=dev) for w in wavs]
    pool = grouped_pool(renderers, lanes, M, dev)
    q = pool.group_size
    every = np.array([pool.attach(g) for g in range(GROUPS)
                      for _ in range(q)])
    pool.prewarm(include_hotswap=True)
    settle(pool)
    setup = time.perf_counter() - t0
    step = pool.step_frames
    fade = min(pool.config.transition_length(SAMPLE_RATE), step)
    sampled = sorted(int(g * q + b) for g in range(GROUPS)
                     for b in rng.choice(q, 2, replace=False))
    paused = sampled[0]
    rec = GroupedRecorder(sampled, step, pool.group_of,
                          {g: GROUPED_BANKS[g] for g in range(GROUPS)},
                          {g: designs[g] for g in range(GROUPS)})
    name = "mac_kmajor_pages" if M > 1 else "mac_kmajor"
    steady_o = (1 if M == 1 else M) * EARS * 2
    rounds = []
    mk.reset_launch_count()
    t0 = time.perf_counter()
    for item in schedule:
        if isinstance(item, dict):
            for g, bank in item.items():
                if not pool.set_renderer(renderers[bank], group=g):
                    raise AssertionError(f"{label}: swap of group {g} reset")
                rec.swap_group(g, bank, fade)
            continue
        if item == "e":
            pool.set_equalizer(eqs[-1], group=1)
            rec.retarget(1, designs[-1])
            continue
        fed = every if item == "f" else np.nonzero(
            rng.random(lanes) < POOL_SHARE)[0]
        if len(rounds) in paused_rounds:
            fed = fed[fed != paused]
        chunks = rng.standard_normal((len(fed), SPEAKERS, step),
                                     dtype=np.float32) * 0.25
        fades, before = pool.fade_rounds, launches_now()[name]
        rec.record(fed, chunks, feed_round(pool, fed, chunks))
        after = launches_now()[name]
        kind = "fade" if pool.fade_rounds > fades else "steady"
        by_o = {k: after[k] - before.get(k, 0) for k in after
                if k != "total" and after[k] != before.get(k, 0)}
        rounds.append([kind, by_o])
        if after["total"] - before["total"] != GROUPS or (
                (kind == "steady") != (set(by_o) == {f"O={steady_o}"})):
            raise AssertionError(f"{label}: round {len(rounds) - 1} ({kind}) "
                                 f"launched {by_o}, expected {GROUPS} {name} "
                                 f"launches")
    seconds = time.perf_counter() - t0
    launches = launches_now()
    stats = pool.stats()
    lane_err = rec.errors(banks)
    three_half = f"O={3 * steady_o}"
    result = dict(
        lanes=lanes, groups=GROUPS, blocks_per_step=M, setup_seconds=setup,
        seconds=seconds, partitions=pool._bank_partitions,
        rounds=len(rounds), round_launches=rounds, launches=launches,
        fade_rounds=stats["fade_rounds"], debt_rolls=stats["debt_rolls"],
        attached_per_group=stats["attached_per_group"],
        lanes_sampled=sampled, paused_lane=paused,
        lane_fades=[rec.events[b] for b in sampled],
        eq_switch_at=[rec.eq_start[b] for b in sampled],
        lane_rel_rms=lane_err)
    if not max(lane_err) <= CHAIN_TOL:
        raise AssertionError(f"{label}: lane rel-RMS {lane_err} > {CHAIN_TOL}")
    if not any(three_half in r[1] for r in rounds):
        raise AssertionError(f"{label}: no round ran the three-half fade bank")
    if rounds[-1][0] != "steady" or pool._xfade_params is not None:
        raise AssertionError(f"{label}: the fades did not end")
    if len(rec.events[paused]) != 1 or rec.events[paused][0][1:3] != (0, 4):
        raise AssertionError(f"{label}: the paused lane did not fade from its "
                             f"own bank: {rec.events[paused]}")
    if len(set(pool._bank_partitions)) < 2:
        raise AssertionError(f"{label}: the groups share one partition count")

    # Checkpoint: a snapshot mid-traffic restored into a fresh pool.
    def ragged(among):
        fed = among[rng.random(len(among)) < POOL_SHARE]
        return fed, rng.standard_normal((len(fed), SPEAKERS, step),
                                        dtype=np.float32) * 0.25

    # The pool's banks now, which a restored pool must be built with.
    now = [next(i for i, r in enumerate(renderers) if r is active)
           for active in pool.renderers]
    snap = pool.snapshot()
    twin = grouped_pool(renderers, lanes, M, dev, now)
    twin.restore(snap)
    del snap
    equal, differ = True, 0.0
    for _ in range(GROUPED_CHECK_ROUNDS):
        fed, chunks = ragged(every)
        ya, yb = feed_round(pool, fed, chunks), feed_round(twin, fed, chunks)
        equal &= bool(np.array_equal(ya, yb))
        differ = max(differ, float(np.abs(ya - yb).max()))
    del twin
    torch.cuda.empty_cache()
    result.update(restored_equal=equal, restored_max_abs_diff=differ)
    if not equal:
        raise AssertionError(f"{label}: the restored pool's audio differs by "
                             f"up to {differ}")
    if M == 1:
        kept = every[1::2]
        for s in every[::2]:
            pool.detach(int(s))
        snap = pool.snapshot()
        small = grouped_pool(renderers, RESIZE_LANES, M, dev, now)
        lane_map = small.restore(snap, resize=True)
        del snap
        mapped = np.array([lane_map[int(s)] for s in kept])
        ya_all, yc_all = [], []
        for _ in range(GROUPED_CHECK_ROUNDS):
            fed, chunks = ragged(kept)
            ya_all.append(feed_round(pool, fed, chunks))
            yc_all.append(feed_round(small, mapped[np.searchsorted(kept, fed)],
                                     chunks))
        ya_all, yc_all = (np.concatenate(y, 0) for y in (ya_all, yc_all))
        per_group = RESIZE_LANES // GROUPS
        want_map = np.concatenate([g * per_group + np.arange(q // 2)
                                   for g in range(GROUPS)])
        result.update(resized_lanes=RESIZE_LANES,
                      resized_per_group=bool(np.array_equal(mapped, want_map)),
                      resized_equal=bool(np.array_equal(ya_all, yc_all)),
                      resized_rel_rms=rel_rms(yc_all, ya_all))
        del small
        torch.cuda.empty_cache()
        if not (result["resized_per_group"]
                and result["resized_rel_rms"] <= KERNEL_TOL):
            raise AssertionError(f"{label}: resize {result}")

    # Timing: the saturated device round, grouped and ungrouped in turns.
    with torch.inference_mode():
        x = torch.empty((lanes, SPEAKERS) + ((M,) if M > 1 else ())
                        + (BLOCK,), device=dev).normal_(0.0, 0.25)
        flat = make_pool(wavs[0], lanes, M, dev, eqs[0])
        rounds_ms = {}
        for kind in ("steady", "fade"):
            fade_kind = kind == "fade"
            fns = (saturated_round(flat, x, fade_kind),
                   saturated_round(pool, x, fade_kind))
            mk.reset_launch_count()
            fns[1]()
            per_round = mk.launch_count(name)
            turns = [cuda_ms(fns[i], 10) for i in (0, 1, 1, 0)]
            rounds_ms[kind] = dict(ungrouped_ms=(turns[0] + turns[3]) / 2,
                                   grouped_ms=(turns[1] + turns[2]) / 2,
                                   turns=turns,
                                   grouped_mac_launches=per_round)
            del fns
        profile = traced(saturated_round(pool, x), 3, name, top=6)
        del flat
    torch.cuda.empty_cache()
    base = rng.standard_normal((lanes, SPEAKERS, step), dtype=np.float32) * 0.25
    for s in every:
        if s not in pool._attached:
            pool.attach(pool.group_of(s))

    def one_round():
        pool.push_many(every, base)
        pool.pump(max_rounds=1)
        pool.pull_many(every, step)

    for _ in range(2):
        one_round()
    timed = POOL_TIMED_BLOCKS // M
    best = float("inf")
    for _ in range(3):
        t1 = time.perf_counter()
        for _ in range(timed):
            one_round()
        best = min(best, time.perf_counter() - t1)
    round_ms = best / timed * 1e3
    result.update(
        card=smi, device_round=rounds_ms, device_round_profile=profile,
        ms_per_round=round_ms,
        host_share=1.0 - rounds_ms["steady"]["grouped_ms"] / round_ms,
        x_realtime=lanes * timed * step / SAMPLE_RATE / best,
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    phase(label, **result)
    if rounds_ms["steady"]["grouped_mac_launches"] != GROUPS:
        raise AssertionError(f"{label}: {rounds_ms}")
    del pool
    torch.cuda.empty_cache()
    return launches


def serve_grouped_phase(files: ServeFiles, wav_b, rng: np.random.Generator,
                        smi: str) -> None:
    """`python -m airwave_tpu_torch serve --profile A.wav:eq1.txt --profile
    B.wav:eq2.txt` as a process: after a warm-up client has carried the
    pool through its EQs' activation ramp, checking clients in each group
    (two per group, at once) against float64 through their group's bank
    and EQ; SIGINT writes the grouped checkpoint and a restart restores it
    (profile_groups 2)."""
    t_phase = time.perf_counter()
    hrir_b = os.path.join(files.dir, "hrir14-b.wav")
    wavio.save(hrir_b, wav_b.audio, SAMPLE_RATE)
    eq_b = os.path.join(files.dir, "eq-b.txt")
    with open(eq_b, "w") as f:
        f.write("Preamp: -1 dB\nFilter 1: ON PK Fc 700 Hz Gain 3 dB Q 1.0\n")
    ckpt = os.path.join(files.dir, "grouped.ckpt")
    serve = ["--profile", f"{files.hrir}:{files.eq}",
             "--profile", f"{hrir_b}:{eq_b}", "--max-streams", "16",
             "--port", "0", "--checkpoint", ckpt, "--checkpoint-interval", "0"]
    refs = {0: (files.hrir_td, files.preamp, files.coeffs),
            1: (build_hrir_time_domain(wavio.load(hrir_b), channel_maps.STEREO,
                                       SAMPLE_RATE),
                *bd.design_cascade(shell_app._load_equalizer(eq_b),
                                   SAMPLE_RATE))}
    xs = [rng.standard_normal((SPEAKERS, SERVE_GROUPED_FRAMES),
                              dtype=np.float32) * 0.25 for _ in range(4)]
    groups = [0, 1, 0, 1]
    ys = [None] * 4
    first = ServeProcess(serve, os.path.join(files.dir, "grouped1.err"))
    try:
        ready = first.ready()
        address = tuple(ready["listening"])
        render_via_server(address, np.zeros((SPEAKERS, 4 * BLOCK), np.float32),
                          chunk=BLOCK)  # the EQs' activation ramp ends

        def check(i):
            ys[i] = render_via_server(address, xs[i], chunk=BLOCK,
                                      group=groups[i])

        threads = [threading.Thread(target=check, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        first_rc = first.interrupt()
    finally:
        first.close()
    saved = {"checkpoint_saved": ckpt} in first.lines
    errs = [rel_rms(y, reference_lane(*refs[g][:1], x, *refs[g][1:]))
            if y is not None and y.shape == x.shape else float("inf")
            for x, y, g in zip(xs, ys, groups)]
    second = ServeProcess(serve, os.path.join(files.dir, "grouped2.err"))
    try:
        restart = second.ready()
        second_rc = second.interrupt()
    finally:
        second.close()
    phase("serve_grouped", card=smi, serve_listening=ready,
          groups=groups, check_frames=SERVE_GROUPED_FRAMES,
          check_rel_rms=errs, serve_exit=first_rc, checkpoint_saved=saved,
          checkpoint_bytes=os.path.getsize(checkpoint_path(ckpt)),
          restart_listening=restart, restart_exit=second_rc,
          seconds=time.perf_counter() - t_phase)
    if ready["profile_groups"] != 2 or ready["device"] != "cuda:0":
        raise AssertionError(f"serve_grouped: serve started as {ready}")
    if not max(errs) <= CHAIN_TOL:
        raise AssertionError(f"serve_grouped: rel-RMS {errs} > {CHAIN_TOL}")
    if first_rc or second_rc or not saved:
        raise AssertionError(f"serve_grouped: exits {first_rc}, {second_rc}; "
                             f"checkpoint saved: {saved}")
    if (restart["restored_checkpoint"] is not True
            or restart["profile_groups"] != 2):
        raise AssertionError(f"serve_grouped: the restart: {restart}")


def checkpoint_phase(wav, dev: torch.device, rng: np.random.Generator,
                     smi: str) -> dict:
    """Both tiers at full width: snapshot() mid ragged traffic, the pool
    continued, the snapshot restored into a fresh pool fed the same rounds:
    the delivered audio must be equal. On the ring tier also half the lanes
    detached, a snapshot restored with resize=True into a 4096-lane pool,
    and the compacted lanes' audio must equal the uninterrupted lanes'."""
    launches = {}
    for M in (1, BLOCKS_PER_STEP):
        lanes = POOL_LANES[M]
        before, after = CHECKPOINT_ROUNDS[M]
        a = make_pool(wav, lanes, M, dev, bench_eq_definition())
        for _ in range(lanes):
            a.attach()
        settle(a)
        step = a.step_frames

        def ragged(among):
            fed = among[rng.random(len(among)) < POOL_SHARE]
            return fed, rng.standard_normal((len(fed), SPEAKERS, step),
                                            dtype=np.float32) * 0.25

        every = np.arange(lanes)
        for _ in range(before):
            feed_round(a, *ragged(every))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = a.snapshot()
        snapshot_seconds = time.perf_counter() - t0
        conv = snap["state"].conv
        nbytes = sum(leaf.nbytes for leaf in (
            (*conv.pages,) if M > 1 else (conv.fdl,)) + tuple(snap["state"].eq))
        b = make_pool(wav, lanes, M, dev, bench_eq_definition())
        t0 = time.perf_counter()
        b.restore(snap)
        torch.cuda.synchronize()
        restore_seconds = time.perf_counter() - t0
        del snap
        mk.reset_launch_count()
        equal, differ = True, 0.0
        for _ in range(after):
            fed, chunks = ragged(every)
            ya, yb = feed_round(a, fed, chunks), feed_round(b, fed, chunks)
            equal &= bool(np.array_equal(ya, yb))
            differ = max(differ, float(np.abs(ya - yb).max()))
        launches[f"checkpoint_{M}"] = launches_now()
        result = dict(lanes=lanes, blocks_per_step=M, rounds_continued=after,
                      snapshot_bytes=nbytes, snapshot_seconds=snapshot_seconds,
                      restore_seconds=restore_seconds, resumed_equal=equal,
                      resumed_max_abs_diff=differ)
        del b
        if M == 1:
            a_lanes = every[1::2]
            for s in every[::2]:
                a.detach(int(s))
            snap = a.snapshot()
            c = make_pool(wav, RESIZE_LANES, M, dev, bench_eq_definition())
            lane_map = c.restore(snap, resize=True)
            del snap
            mapped = np.array([lane_map[int(s)] for s in a_lanes])
            resized_equal, resized_differ = True, 0.0
            for _ in range(after):
                fed, chunks = ragged(a_lanes)
                ya = feed_round(a, fed, chunks)
                yc = feed_round(c, mapped[np.searchsorted(a_lanes, fed)],
                                chunks)
                resized_equal &= bool(np.array_equal(ya, yc))
                resized_differ = max(resized_differ, float(np.abs(ya - yc).max()))
            result.update(resized_lanes=RESIZE_LANES,
                          resized_compacted=bool(np.array_equal(
                              mapped, np.arange(len(a_lanes)))),
                          resized_equal=resized_equal,
                          resized_max_abs_diff=resized_differ)
            del c
        del a
        torch.cuda.empty_cache()
        phase("checkpoint", card=smi, **result)
        if not (result["resumed_equal"] and result.get("resized_equal", True)
                and result.get("resized_compacted", True)):
            raise AssertionError(f"checkpoint (M={M}): restored audio differs "
                                 f"from the uninterrupted pool's: {result}")
    return launches


class ServeFiles:
    """The serving and CLI phases' inputs as files, the way a user passes
    them: the seeded 14-channel HRIR WAV and the 10-filter EQ as an
    EqualizerAPO preset, with the float64 reference's bank and cascade."""

    def __init__(self, directory: str, wav: wavio.WAVData, seed: int):
        self.dir = directory
        self.hrir = os.path.join(directory, f"hrir14-{seed}.wav")
        wavio.save(self.hrir, wav.audio, SAMPLE_RATE)
        kinds = {bd.FilterType.PEAKING: "PK", bd.FilterType.LOW_SHELF: "LSC",
                 bd.FilterType.HIGH_SHELF: "HSC"}
        definition = bench_eq_definition()
        lines = [f"Preamp: {definition.preamp_db} dB"] + [
            f"Filter {f.source_number}: ON {kinds[f.type]} Fc "
            f"{f.frequency_hz} Hz Gain {f.gain_db} dB Q {f.q}"
            for f in definition.filters]
        self.eq = os.path.join(directory, "bench-eq.txt")
        with open(self.eq, "w") as f:
            f.write("\n".join(lines) + "\n")
        self.hrir_td = build_hrir_time_domain(wavio.load(self.hrir),
                                              channel_maps.STEREO, SAMPLE_RATE)
        self.preamp, self.coeffs = bench_eq()
        parsed = bd.design_cascade(shell_app._load_equalizer(self.eq),
                                   SAMPLE_RATE)
        if parsed != (self.preamp, self.coeffs):
            raise AssertionError("the EQ preset file does not parse to the "
                                 "bench EQ")

    def reference(self, x: np.ndarray) -> np.ndarray:
        return reference_lane(self.hrir_td, x, self.preamp, self.coeffs)


def child_env() -> dict:
    """The environment of a child process that imports the port from this
    checkout."""
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def serve_args(files: ServeFiles, M: int, ckpt: str, *extra: str):
    return shell_app.build_parser().parse_args([
        "serve", "--hrir", files.hrir, "--eq", files.eq, "--port", "0",
        "--max-streams", str(SERVE_LANES), "--blocks-per-step", str(M),
        "--checkpoint", ckpt, *extra])


def start_server(args):
    """shell.app.cmd_serve's path up to the accept loop, in process (so the
    kernels' launch counts can be read): build_serve_pool,
    restore_serve_checkpoint, RenderServer. Returns (server, restored)."""
    pool, _layout = shell_app.build_serve_pool(args)
    restored, tokens, aliases = shell_app.restore_serve_checkpoint(
        args.checkpoint, pool)
    server = RenderServer(pool, host=args.host, port=args.port,
                          resume_grace=args.resume_grace,
                          orphan_tokens=tokens, orphan_aliases=aliases,
                          io_mode=args.io_mode)
    server.start()
    return server, restored


class PumpClock:
    """Installed on one pool instance (the server's pump thread calls
    pool.pump): the host wall time spent in pump and its calls, and, once
    armed, a torch.profiler trace of the next `calls` pump calls taken in
    the pump thread itself after one warm-up call, whose events are
    dropped, its window opened by tools/profile_chain.lead_kernels, as
    tools/profile_chain.profile does (the profiler records the host ops of
    the thread that starts it, and the card's kernels of every thread)."""

    def __init__(self, pool: StreamPool):
        self.pool, self.seconds, self.calls = pool, 0.0, 0
        self._pump = pool.pump
        self._armed = 0
        self._prof = None
        pool.pump = self

    def arm(self, calls: int) -> None:
        self._armed = calls

    @staticmethod
    def _macs() -> int:
        return sum(mk.launch_count(name) for name in KERNELS)

    def __call__(self, *args, **kwargs):
        if self._armed and self._prof is None:
            from torch.profiler import ProfilerActivity, profile, schedule

            self._prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=self._armed,
                                  repeat=1))
            self._prof.__enter__()
            self._window = None  # opened after the warm-up call
        t0 = time.perf_counter()
        macs = self._macs()
        try:
            return self._pump(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            self.seconds += dt
            self.calls += 1
            if self._prof is not None:
                if self._window is not None:
                    self._window[2] += dt
                    self._window[3] -= 1
                    self._window[4] += self._macs() - macs
                self._prof.step()
                if self._window is None:
                    profile_chain.lead_kernels(self.pool.device)
                    # [start, rounds, pump seconds, calls left, MAC launches]
                    self._window = [time.perf_counter(), self.pool.rounds,
                                    0.0, self._armed, 0]
                elif self._window[3] == 0:
                    self._close_profile()

    def _close_profile(self) -> None:
        """Stop the trace (in the pump thread that started it, under the
        server's lock: the stop's seconds are a stall the phase reports);
        the events are summarized later, off the serving path."""
        start, rounds0, pump_s, _, macs = self._window or (
            time.perf_counter(), self.pool.rounds, 0.0, 0, 0)
        wall = time.perf_counter() - start
        rounds = self.pool.rounds - rounds0
        t0 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        self._stopped = (self._prof, wall, rounds, pump_s,
                         time.perf_counter() - t0, macs)
        self._prof, self._armed = None, 0

    def remove(self) -> dict:
        """Uninstall (after the load: the pump is idle) and summarize the
        trace: the card's and the pump thread's busy shares over the traced
        calls, ms per round, the top kernels and host ops. A trace still
        open because fewer calls came is stopped first. The trace must hold
        every MAC launch of the traced calls, else the card's numbers read
        "not measured" (a trace that drops kernels reads low)."""
        del self.pool.pump  # the class's method again
        if self._prof is not None:
            self._close_profile()
        from torch.autograd import DeviceType

        prof, wall, rounds, pump_s, stop_s, macs = self._stopped
        events = [e for e in prof.key_averages()
                  if not e.key.startswith("ProfilerStep")  # the schedule's
                  and not e.key.startswith(SPAN_PREFIX)    # the program's
                  and profile_chain.LEAD_KERNEL_NAME not in e.key]
        device_ms = sum(e.self_device_time_total for e in events
                        if e.device_type == DeviceType.CUDA) / 1e3
        kernels = sorted(((e.self_device_time_total / 1e3, e.key[:60])
                          for e in events if e.device_type == DeviceType.CUDA
                          and e.self_device_time_total > 0), reverse=True)
        host = sorted(((e.self_cpu_time_total / 1e3, e.key) for e in events
                       if e.device_type == DeviceType.CPU
                       and e.self_cpu_time_total > 0), reverse=True)
        held = sum(e.count for e in events if e.device_type == DeviceType.CUDA
                   and "mac_kmajor" in e.key)
        complete = macs > 0 and held == macs
        if not complete:
            device_ms, kernels = "not measured", []
        per = max(rounds, 1)
        return dict(
            calls=SERVE_PROFILE_CALLS, window_s=wall, rounds=rounds,
            stop_seconds=stop_s, trace_complete=complete,
            mac_launches=macs, traced_mac_launches=held,
            device_busy_share=(device_ms / (wall * 1e3) if complete
                               else device_ms),
            pump_busy_share=pump_s / wall,
            device_ms_per_round=device_ms / per if complete else device_ms,
            pump_ms_per_round=pump_s * 1e3 / per,
            wall_ms_per_round=wall * 1e3 / per,
            top_kernels_ms=[[k, t] for t, k in kernels[:6]],
            top_host_ops_ms=[[k, t] for t, k in host[:10]])


def serve_phase(label: str, files: ServeFiles, M: int, seed: int,
                rng: np.random.Generator, smi: str):
    """SERVE_CLIENTS loadgen clients at realtime pacing against the serve
    path on a SERVE_LANES-lane pool, and SERVE_CHECKS wire clients with
    known inputs during the load, held against float64. Returns (server,
    launches); the ring tier's server is left running for the checkpoint
    phase."""
    t0 = time.perf_counter()
    server, restored = start_server(
        serve_args(files, M, os.path.join(files.dir, f"{label}.ckpt")))
    setup = time.perf_counter() - t0
    pool = server.pool
    host, port = server.address
    used = "mac_kmajor_pages" if M > 1 else "mac_kmajor"
    clock = PumpClock(pool)
    mk.reset_launch_count()
    rounds0 = pool.rounds
    xs = [rng.standard_normal((SPEAKERS, SERVE_CHECK_FRAMES),
                              dtype=np.float32) * 0.25
          for _ in range(SERVE_CHECKS)]
    ys = [None] * SERVE_CHECKS
    t0 = time.perf_counter()
    load_proc = subprocess.Popen(
        [sys.executable, "-m", "airwave_tpu_torch.shell.loadgen",
         "--connect", f"{host}:{port}", "--clients", str(SERVE_CLIENTS),
         *LOADGEN_ARGS, "--timeout", "240", "--seed", str(seed)],
        cwd=REPO, env=child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        # The checking clients join once the pool's construction-time EQ
        # ramp is over, so their fresh lanes hear the target from their
        # first sample, as the float64 reference does.
        deadline = time.monotonic() + 240
        while True:
            with server._lock:
                rt = pool.eq_runtime
                settled = (rt.active.definition is not None
                           and not rt.is_transitioning
                           and rt.pending_target is None)
            if settled:
                break
            if time.monotonic() > deadline or load_proc.poll() is not None:
                raise AssertionError(f"{label}: the pool's EQ ramp did not "
                                     f"end under the load")
            time.sleep(0.005)
        clock.arm(SERVE_PROFILE_CALLS)

        def check(i):
            ys[i] = render_via_server(server.address, xs[i], chunk=BLOCK)

        threads = [threading.Thread(target=check, args=(i,))
                   for i in range(SERVE_CHECKS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        out, err = load_proc.communicate(timeout=300)
    finally:
        if load_proc.poll() is None:
            load_proc.kill()
            load_proc.wait()
    wall = time.perf_counter() - t0
    launches = counts_now()
    profiled = clock.remove()
    stats = server.stats()
    if not out.strip():
        raise AssertionError(f"{label}: loadgen printed nothing: {err[-800:]}")
    load = json.loads(out.strip().splitlines()[-1])
    errs = [rel_rms(y, files.reference(x))
            if y is not None and y.shape == x.shape else float("inf")
            for x, y in zip(xs, ys)]
    phase(label, card=smi, lanes=SERVE_LANES, blocks_per_step=M,
          setup_seconds=setup, seconds=wall, clients=load["clients"],
          completed=load["completed"], failed=load["failed"],
          fail_reasons=load["fail_reasons"], loadgen_wall_s=load["wall_s"],
          admission=load["admission"], chunk_latency=load["chunk_latency"],
          completion_spread_s=load["completion_spread_s"],
          rendered_realtime_multiple=load["rendered_realtime_multiple"],
          server_latency=stats["latency"],
          pool_rounds=stats["pool"]["rounds"] - rounds0,
          pool_blocks_rendered=stats["pool"]["blocks_rendered"],
          variant_rounds=stats["pool"]["variant_rounds"],
          connections_served=stats["connections_served"],
          protocol_errors=stats["protocol_errors"],
          pump_errors=stats["pump_errors"],
          truncated_closes=stats["truncated_closes"],
          rejected_full=stats["rejected_full"], launches=launches,
          pump_seconds=clock.seconds, pump_calls=clock.calls,
          pump_share_of_loadgen_wall=clock.seconds / load["wall_s"],
          profile=profiled, check_frames=SERVE_CHECK_FRAMES,
          check_rel_rms=errs)
    if restored:
        raise AssertionError(f"{label}: a fresh server restored a checkpoint")
    if not (load["completed"] == SERVE_CLIENTS and load["failed"] == 0):
        raise AssertionError(f"{label}: {load['completed']}/{SERVE_CLIENTS} "
                             f"clients completed: {load['fail_reasons']}")
    bad = {k: stats[k] for k in ("protocol_errors", "pump_errors",
                                 "truncated_closes", "rejected_full")
           if stats[k]}
    if bad or stats["pool"]["render_errors"]:
        raise AssertionError(f"{label}: server errors {bad}, render errors "
                             f"{stats['pool']['render_errors']}")
    if not max(errs) <= CHAIN_TOL:
        raise AssertionError(f"{label}: checking clients' rel-RMS {errs} > "
                             f"{CHAIN_TOL}")
    if launches[used] <= 0 or any(launches[n] for n in KERNELS if n != used):
        raise AssertionError(f"{label}: launches {launches}, expected only "
                             f"{used}")
    if M > 1:
        server.stop()
        del server, pool
        torch.cuda.empty_cache()
        return None, launches
    return server, launches


def _stream(conn: socket.socket, audio: np.ndarray) -> np.ndarray:
    """Send audio [2, n] (n a multiple of BLOCK) in BLOCK-frame messages and
    read back exactly n rendered frames."""
    for t in range(0, audio.shape[1], BLOCK):
        conn.sendall(_LEN.pack(BLOCK)
                     + audio[:, t:t + BLOCK].T.astype("<f4").tobytes())
    pieces, have = [], 0
    while have < audio.shape[1]:
        (k,) = _LEN.unpack(_read_exact(conn, _LEN.size))
        if k == 0:
            raise AssertionError("the server closed the stream early")
        pieces.append(np.frombuffer(_read_exact(conn, k * 8),
                                    "<f4").reshape(k, 2).T)
        have += k
    return np.concatenate(pieces, axis=1)


def serve_checkpoint_phase(server: RenderServer, files: ServeFiles,
                           rng: np.random.Generator, smi: str) -> None:
    """On the loaded ring server: a want_lane client streams
    CHECKPOINT_BLOCKS blocks, the server saves its checkpoint, the client
    streams as many more (the uninterrupted twin). A fresh pool restored
    from the file serves the rest to a client resuming the lane with its
    token: bit for bit the twin. A truncated copy of the file starts fresh
    and is moved aside."""
    pool = server.pool
    n = CHECKPOINT_BLOCKS * BLOCK
    x = rng.standard_normal((SPEAKERS, 2 * n), dtype=np.float32) * 0.25
    conn = socket.create_connection(server.address, timeout=60)
    try:
        conn.sendall(json.dumps({"channels": SPEAKERS,
                                 "want_lane": True}).encode() + b"\n")
        line = b""
        while not line.endswith(b"\n"):
            line += conn.recv(1)
        ack = json.loads(line.decode())
        first = _stream(conn, x[:, :n])
        with server._lock:
            t0 = time.perf_counter()
            pool.snapshot(materialize=False)
            torch.cuda.synchronize()
            lock_seconds = time.perf_counter() - t0
        ckpt = os.path.join(files.dir, "serve_ring.ckpt")
        t0 = time.perf_counter()
        server.save_checkpoint(ckpt)
        save_seconds = time.perf_counter() - t0
        attached_at_save = len(pool._attached)
        nbytes = os.path.getsize(checkpoint_path(ckpt))
        twin = _stream(conn, x[:, n:])
        conn.sendall(_LEN.pack(0))
        eof = _read_exact(conn, _LEN.size) == _LEN.pack(0)
    finally:
        conn.close()
    server.stop()
    del server, pool
    torch.cuda.empty_cache()

    args = serve_args(files, 1, ckpt)
    fresh, _layout = shell_app.build_serve_pool(args)
    t0 = time.perf_counter()
    restored, tokens, aliases = shell_app.restore_serve_checkpoint(ckpt, fresh)
    torch.cuda.synchronize()
    restore_seconds = time.perf_counter() - t0
    resumed = RenderServer(fresh, port=0, orphan_tokens=tokens,
                           orphan_aliases=aliases, io_mode=args.io_mode)
    resumed.start()
    try:
        orphans = resumed.stats()["orphan_lanes"]
        rest = render_via_server(resumed.address, x[:, n:], chunk=BLOCK,
                                 resume=ack["lane"],
                                 resume_token=ack["token"])
        resumed_streams = resumed.resumed_streams
    finally:
        resumed.stop()
    equal = bool(rest.shape == twin.shape and np.array_equal(rest, twin))
    err = rel_rms(np.concatenate([first, twin], -1), files.reference(x))

    cut = os.path.join(files.dir, "truncated.ckpt")
    with open(checkpoint_path(ckpt), "rb") as src, \
            open(checkpoint_path(cut), "wb") as dst:
        dst.write(src.read(nbytes // 2))
    bad = shell_app.restore_serve_checkpoint(cut, fresh)
    moved = (not os.path.exists(checkpoint_path(cut))
             and os.path.exists(checkpoint_path(cut) + ".incompatible"))
    del fresh
    torch.cuda.empty_cache()
    phase("serve_checkpoint", card=smi, lanes=SERVE_LANES,
          attached_at_save=attached_at_save, checkpoint_bytes=nbytes,
          save_seconds=save_seconds, lock_seconds=lock_seconds,
          restore_seconds=restore_seconds, restored=restored,
          orphan_lanes=orphans, resumed_streams=resumed_streams,
          blocks_each_side=CHECKPOINT_BLOCKS, resumed_equal=equal,
          resumed_max_abs_diff=(float(np.abs(rest - twin).max())
                                if rest.shape == twin.shape else None),
          lane_rel_rms=err, clean_eof=eof, truncated_restored=bad[0],
          truncated_moved_aside=moved)
    if not (restored and orphans == 1 and resumed_streams == 1 and eof):
        raise AssertionError("serve_checkpoint: the restart did not offer "
                             "and resume the lane")
    if not equal:
        raise AssertionError("serve_checkpoint: the resumed lane differs from "
                             "its uninterrupted twin")
    if not err <= CHAIN_TOL:
        raise AssertionError(f"serve_checkpoint: lane rel-RMS {err} > "
                             f"{CHAIN_TOL}")
    if bad != (False, None, None) or not moved:
        raise AssertionError(f"serve_checkpoint: the truncated file gave "
                             f"{bad}, moved aside: {moved}")


class ServeProcess:
    """`python -m airwave_tpu_torch serve ...` as a child process: its
    JSON stdout lines collected by a reader thread, its stderr in a file."""

    def __init__(self, args, stderr_path: str):
        self.stderr_path = stderr_path
        self._stderr = open(stderr_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "airwave_tpu_torch", "serve", *args],
            cwd=REPO, env=child_env(), stdout=subprocess.PIPE,
            stderr=self._stderr, text=True)
        self.lines = []
        self._listening = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.lines.append(json.loads(line))
            except ValueError:
                continue
            if "listening" in self.lines[-1]:
                self._listening.set()

    def _stderr_tail(self) -> str:
        with open(self.stderr_path) as f:
            return f.read()[-1500:]

    def ready(self, timeout: float = 240) -> dict:
        if not self._listening.wait(timeout):
            raise AssertionError(f"serve printed no listening line: "
                                 f"{self._stderr_tail()}")
        return next(line for line in self.lines if "listening" in line)

    def interrupt(self, timeout: float = 120) -> int:
        self.proc.send_signal(signal.SIGINT)
        return self.proc.wait(timeout)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._stderr.close()


def run_cli(*args: str, timeout: float = 240) -> dict:
    proc = subprocess.run([sys.executable, "-m", "airwave_tpu_torch", *args],
                          cwd=REPO, env=child_env(), capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"airwave_tpu_torch {args[0]} exited "
                             f"{proc.returncode}: {proc.stderr[-1500:]}")
    return json.loads(proc.stdout[proc.stdout.index("{"):])


def cli_phase(files: ServeFiles, rng: np.random.Generator, smi: str) -> None:
    """The entry point as a user runs it: serve as a process, client on a
    WAV, SIGINT (the checkpoint is written), a restart on the checkpoint,
    status."""
    t_phase = time.perf_counter()
    ckpt = os.path.join(files.dir, "cli.ckpt")
    serve = ["--hrir", files.hrir, "--eq", files.eq, "--port", "0",
             "--checkpoint", ckpt, "--checkpoint-interval", "0"]
    x = rng.standard_normal((SPEAKERS, CLI_FRAMES), dtype=np.float32) * 0.25
    inp = os.path.join(files.dir, "cli-in.wav")
    outp = os.path.join(files.dir, "cli-out.wav")
    wavio.save(inp, x, SAMPLE_RATE)
    first = ServeProcess(serve, os.path.join(files.dir, "serve1.err"))
    try:
        t0 = time.perf_counter()
        ready = first.ready()
        start_seconds = time.perf_counter() - t0
        host, port = ready["listening"]
        t0 = time.perf_counter()
        client = run_cli("client", "--input", inp, "--output", outp,
                         "--host", host, "--port", str(port))
        client_seconds = time.perf_counter() - t0
        first_rc = first.interrupt()
    finally:
        first.close()
    saved = {"checkpoint_saved": ckpt} in first.lines
    y = wavio.load(outp).audio
    # The server's first round starts its EQ's unity -> target ramp, which
    # this client's lane hears; the float64 reference is the target alone.
    skip = EQ_RAMP + BLOCK
    err = rel_rms(y[:, skip:], files.reference(x)[:, skip:])
    second = ServeProcess(serve, os.path.join(files.dir, "serve2.err"))
    try:
        restart = second.ready()
        second_rc = second.interrupt()
    finally:
        second.close()
    status = run_cli("status")
    phase("cli", card=smi, serve_listening=ready, serve_start_seconds=start_seconds,
          client=client, client_seconds=client_seconds,
          client_rel_rms_past_ramp=err, serve_exit=first_rc,
          checkpoint_saved=saved,
          checkpoint_bytes=os.path.getsize(checkpoint_path(ckpt)),
          restart_listening=restart, restart_exit=second_rc, status=status,
          seconds=time.perf_counter() - t_phase)
    if ready["device"] != "cuda:0" or ready["restored_checkpoint"]:
        raise AssertionError(f"cli: serve started as {ready}")
    if client["truncated"] or client["rendered_frames"] != CLI_FRAMES:
        raise AssertionError(f"cli: client {client}")
    if not err <= CHAIN_TOL:
        raise AssertionError(f"cli: client rel-RMS {err} > {CHAIN_TOL}")
    if first_rc or second_rc or not saved:
        raise AssertionError(f"cli: serve exits {first_rc}, {second_rc}; "
                             f"checkpoint saved: {saved}")
    if restart["restored_checkpoint"] is not True:
        raise AssertionError(f"cli: the restart did not restore: {restart}")
    if (status["device"] != "cuda:0" or not status["native_assembler"]
            or torch.cuda.get_device_name(0) not in status["devices"]):
        raise AssertionError(f"cli: status {status}")


def render_phase(files: ServeFiles, rng: np.random.Generator,
                 smi: str) -> dict:
    """shell.app.main(["render", ...]) on RENDER_FILES stereo WAVs of
    RENDER_SECONDS with the EQ, on the graph path and with --throughput;
    4 sampled outputs against float64 (the graph path past its EQ
    activation ramp). Returns each path's launches."""
    n = int(RENDER_SECONDS * SAMPLE_RATE)
    inputs, sampled, refs = [], sorted(rng.choice(RENDER_FILES, 4,
                                                  replace=False)), {}
    for i in range(RENDER_FILES):
        x = rng.standard_normal((SPEAKERS, n), dtype=np.float32) * 0.25
        inputs += ["--input", os.path.join(files.dir, f"render-{i:02d}.wav")]
        wavio.save(inputs[-1], x, SAMPLE_RATE)
        if i in sampled:
            refs[i] = files.reference(x)
        del x
    launches = {}
    for label, extra in (("render_graph", ()),
                         ("render_throughput", ("--throughput",))):
        out_dir = os.path.join(files.dir, label)
        mk.reset_launch_count()
        captured = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(captured):
            rc = shell_app.main(["render", *inputs, "--hrir", files.hrir,
                                 "--eq", files.eq, "--output-dir", out_dir,
                                 *extra])
        seconds = time.perf_counter() - t0
        launches[label] = counts_now()
        report = json.loads(captured.getvalue())
        skip = 0 if extra else EQ_RAMP + BLOCK
        errs = [rel_rms(wavio.load(report["rendered"][i]).audio[:, skip:],
                        refs[i][:, skip:]) for i in sampled]
        profile = report["profile"]
        multiple = (profile["realtime_multiple"] if extra
                    else profile["render"]["realtime_multiple"])
        phase(label, card=smi, files=RENDER_FILES, seconds_each=RENDER_SECONDS,
              rc=rc, equalizer=report["equalizer"], device=report["device"],
              seconds=seconds, realtime_multiple=multiple, profile=profile,
              launches=launches[label], sampled=[int(i) for i in sampled],
              compared_from_sample=skip, rel_rms=errs)
        used = "mac_kmajor_pages" if extra else "mac_kmajor"
        if rc != 0 or not report["equalizer"] or report["device"] != "cuda:0":
            raise AssertionError(f"{label}: rc {rc}, report {report}")
        if not max(errs) <= CHAIN_TOL:
            raise AssertionError(f"{label}: rel-RMS {errs} > {CHAIN_TOL}")
        if launches[label][used] <= 0 or any(
                launches[label][k] for k in KERNELS if k != used):
            raise AssertionError(f"{label}: launches {launches[label]}, "
                                 f"expected only {used}")
        shutil.rmtree(out_dir)
    return launches


def run_main(*argv: str):
    """shell.app.main(argv) in process: (exit code, stdout)."""
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        rc = shell_app.main(list(argv))
    return rc, captured.getvalue()


def presets_phase(files: ServeFiles, smi: str) -> None:
    """`presets seed`, `list`, `import` (the phase's 14-channel HRIR WAV and
    the APO preset file) and `list` through shell.app.main in a fresh data
    directory; then the imported HRIR activated by a port HRIRManager with
    no device, on the card, against the same activation on the CPU."""
    with tempfile.TemporaryDirectory() as data:
        base = ("--data-dir", data)
        t0 = time.perf_counter()
        runs = [run_main(*base, "presets", "seed"),
                run_main(*base, "presets", "list"),
                run_main(*base, "presets", "import", files.hrir, files.eq),
                run_main(*base, "presets", "list")]
        seconds = time.perf_counter() - t0

        def counts(listing: str) -> dict:
            kinds = [line.split()[0] for line in listing.splitlines()]
            return {k: kinds.count(k) for k in ("hrir", "eq")}

        listed = [counts(runs[1][1]), counts(runs[3][1])]
        manager = HRIRManager(os.path.join(data, "hrir"))
        imported = next(p for p in manager.presets()
                        if not p.is_bundled)
        errors = []
        manager.activate_preset(imported.id, SAMPLE_RATE,
                                completion=errors.append)
        card = manager.published_renderer
        cpu = HRIRManager(os.path.join(data, "hrir"), device="cpu")
        cpu.activate_preset(imported.id, SAMPLE_RATE)
        bank_err = rel_rms(card.conv_params.Gflip2.cpu().numpy(),
                           cpu.published_renderer.conv_params.Gflip2.numpy())
    device = str(card.conv_params.Gflip2.device)
    phase("presets", card=smi, rc=[rc for rc, _ in runs], listed=listed,
          seed_line=runs[0][1].strip(), imported=runs[2][1].splitlines(),
          activation_errors=[str(e) for e in errors],
          renderer_device=device, renderer_partitions=card.partition_count,
          bank_rel_rms_vs_cpu=bank_err, seconds=seconds)
    if [rc for rc, _ in runs] != [0, 0, 0, 0]:
        raise AssertionError(f"presets: exit codes {[rc for rc, _ in runs]}")
    if listed != [{"hrir": 3, "eq": 5}, {"hrir": 4, "eq": 6}]:
        raise AssertionError(f"presets: listed {listed}")
    if errors != [None] or device != "cuda:0" or not bank_err <= KERNEL_TOL:
        raise AssertionError(f"presets: activation {errors} on {device}, "
                             f"bank rel-RMS {bank_err}")


def demo_reference(x, banks, t_swap, design) -> np.ndarray:
    """float64 output of the demo's graph for its recorded input x [2, n].

    The spatial path: the first bank from an empty history, then at t_swap
    the coordinator's crossfaded swap (two set_renderer calls before the
    next block restart the fade once, from the lerped bank at ramp
    1/fade), both banks over the whole history. The EQ: each publication
    (at 0 and again at the swap's re-prepare) ramps over EQ_RAMP samples
    from what was heard to its cascade started from rest."""
    n = x.shape[-1]
    r = np.minimum((np.arange(n) - t_swap + 1.0) / EQ_RAMP, 1.0)
    w_old = np.where(r > 0.0, (1.0 - r) * (1.0 - 1.0 / EQ_RAMP), 1.0)
    dry = blend_dry(banks, [w_old, 1.0 - w_old], x)
    preamp, coeffs = design
    y = dry.copy()
    for t in (0, t_swap):
        fresh = np.zeros_like(dry)
        fresh[:, t:] = cascade(dry[:, t:], preamp, coeffs)
        p = np.clip((np.arange(n) - t + 1.0) / EQ_RAMP, 0.0, 1.0)
        y = (1.0 - p) * y + p * fresh
    return y


def demo_phase(rng: np.random.Generator, smi: str) -> dict:
    """The live runtime on the card. First `demo --seconds 5 --eq-preset
    Bass` through shell.app.main in process, each of the spatial engine's
    blocks counted. Then the objects cmd_demo wires (shell.app.build_demo)
    driven directly for DEMO_BLOCKS blocks with every graph callback's input
    and output recorded, the profile's HRIR switched from Neutral to Room at
    DEMO_SWAP_BLOCK; the steady Neutral segment (past the EQ ramp), the
    fade blocks and the steady Room segment against float64; mac_kmajor
    launched once a block, at O = 8 in the fade blocks; host wall per
    block, the card's time per block from a trace (traced) and its busy
    share, the realtime multiple. Returns the launches of both runs."""
    blocks = []
    build = shell_app.build_demo

    def counting_build(*args, **kwargs):
        demo = build(*args, **kwargs)
        process = demo.spatial.engine.process_block

        def counted(x):
            blocks.append(x.shape)
            return process(x)

        demo.spatial.engine.process_block = counted
        return demo

    launches = {}
    with tempfile.TemporaryDirectory() as data:
        shell_app.build_demo = counting_build
        mk.reset_launch_count()
        t0 = time.perf_counter()
        try:
            rc, out = run_main("--data-dir", data, "demo", "--seconds",
                               str(DEMO_CLI_SECONDS), "--eq-preset", "Bass")
        finally:
            shell_app.build_demo = build
        cli_seconds = time.perf_counter() - t0
        launches["demo_cli"] = {**launches_now(), "routes": routes_now()}
    report = json.loads(out)
    phase("demo_cli", card=smi, rc=rc, report=report, seconds=cli_seconds,
          engine_blocks=len(blocks), launches=launches["demo_cli"])
    if (rc != 0 or report["status"] != "processing"
            or report["device"] != "cuda:0" or not report["spatial_ready"]
            or report["equalizer_preset"] != "Bass Booster"):
        raise AssertionError(f"demo cli: rc {rc}, report {report}")
    if not blocks or launches["demo_cli"]["mac_kmajor"]["total"] != len(
            blocks) or launches["demo_cli"]["mac_kmajor_pages"]["total"]:
        raise AssertionError(f"demo cli: {len(blocks)} engine blocks, "
                             f"launches {launches['demo_cli']}")

    with tempfile.TemporaryDirectory() as data:
        demo = build(data, "cuda:0", "Bass")
        engine = demo.spatial.engine
        process = demo.graph.process
        calls = []  # (x, y, host seconds, fading)

        def recorded(x):
            fading = bool(engine._xfade_segments)
            t = time.perf_counter()
            y = process(x)
            calls.append((x[0].copy(), y[0].copy(),
                          time.perf_counter() - t, fading))
            return y

        demo.graph.process = recorded
        neutral, room = (next(p for p in demo.hrir.presets()
                              if p.display_name == name)
                         for name in ("Neutral", "Room"))
        eq_id = demo.profiles.equalizer_preset_id(demo.output.uid)
        mk.reset_launch_count()
        t0 = time.perf_counter()
        demo.coordinator.launch()
        t_swap = trail_at_swap = None
        for b in range(DEMO_BLOCKS):
            if b == DEMO_SWAP_BLOCK:
                if demo.hrir.active_preset_id != neutral.id:
                    raise AssertionError("demo: Neutral is not active")
                t_swap, trail_at_swap = len(calls) * BLOCK, len(demo.trail)
                swap_t0 = time.perf_counter()
                demo.profiles.set_hrir_preset_id(demo.output.uid, room.id)
                swap_seconds = time.perf_counter() - swap_t0
            demo.transport.pump(BLOCK)
            demo.scheduler.advance(BLOCK / SAMPLE_RATE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["demo"] = {**launches_now(), "routes": routes_now()}
        status = demo.state.status.value
        if demo.hrir.active_preset_id != room.id:
            raise AssertionError("demo: Room is not active after the swap")
        trail = list(demo.trail)
        purpose = demo.controller.pipeline.purpose
        design = bd.design_cascade(demo.eq.load_definition(eq_id),
                                   SAMPLE_RATE)
        banks = [build_hrir_time_domain(
            wavio.load(os.path.join(demo.hrir.directory, p.filename)),
            channel_maps.STEREO, SAMPLE_RATE)
            for p in (neutral, room)]

        # The card's time per block: a trace of more blocks of the same
        # stream (for the record; these blocks are not checked).
        per_call = DEMO_PROFILED_BLOCKS // DEMO_PROFILED_CALLS
        walls = []

        def pump_blocks():
            t1 = time.perf_counter()
            for _ in range(per_call):
                demo.transport.pump(BLOCK)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)

        trace = traced(pump_blocks, DEMO_PROFILED_CALLS, "mac_kmajor")
        # The last trace's calls, after its warm-up call.
        traced_wall = sum(walls[-DEMO_PROFILED_CALLS:])
        card_ms = trace["device_ms"]
        if trace["trace_complete"]:
            card_ms /= per_call
        del calls[-len(walls) * per_call:]

        # One engine block's device step alone, in CUDA-event time (steady
        # and fade), on device-resident input.
        with torch.inference_mode():
            p = engine.eq_runtime.active.params
            x_dev = torch.zeros((1, SPEAKERS, BLOCK), device=engine.device
                                ).normal_(0.0, 0.25)
            state = engine.state
            dual = upols.xfade_conv_params(engine._conv_params,
                                           engine._conv_params)
            dual_ops = make_chain_operands(dual, None, 1, engine._k_padded)
            ramp = torch.from_numpy(upols.xfade_ramp(EQ_RAMP, BLOCK)).to(
                engine.device)
            tl = engine.eq_runtime.transition_length
            steady_ms = cuda_ms(lambda: chain_step_fn(
                engine._conv_params, p, p, state, x_dev, tl, True, False,
                False, engine._operands), 50)
            fade_ms = cuda_ms(lambda: chain_step_fn(
                dual, p, p, state, x_dev, tl, True, False, False, dual_ops,
                xfade_ramp=ramp), 50)

    x = np.concatenate([c[0] for c in calls], -1)
    y = np.concatenate([c[1] for c in calls], -1)
    host_ms = np.array([c[2] for c in calls]) * 1e3
    fading = np.array([c[3] for c in calls])
    n_blocks = len(calls)
    fade_blocks = int(fading.sum())
    ref = demo_reference(x, banks, t_swap, design)
    fade_end = t_swap + (-(-EQ_RAMP // BLOCK)) * BLOCK
    ramp_end = (-(-EQ_RAMP // BLOCK) + 1) * BLOCK
    segments = {"neutral": (ramp_end, t_swap), "fade": (t_swap, fade_end),
                "room": (fade_end, x.shape[-1])}
    errors = {k: rel_rms(y[:, a:b], ref[:, a:b])
              for k, (a, b) in segments.items()}
    after_swap = trail[trail_at_swap:]
    counts = launches["demo"]["mac_kmajor"]
    host_per_block = float(host_ms.mean())
    phase("demo", card=smi, status=status, status_trail=trail[-12:],
          swap={"restarted_pipeline": "starting" in after_swap,
                "reverified": False, "purpose_after": purpose.value,
                "crossfaded_blocks": int(fading[t_swap // BLOCK:].sum()),
                "seconds": swap_seconds},
          presentation=present_status(demo.state).title,
          blocks_processed=n_blocks, fade_blocks=fade_blocks,
          launches=launches["demo"], rel_rms=errors, segments=segments,
          host_ms_per_block=host_per_block,
          host_ms_per_block_p50=float(np.percentile(host_ms, 50)),
          host_ms_per_block_p99=float(np.percentile(host_ms, 99)),
          card_ms_per_block=card_ms, card_trace=trace,
          card_busy_share=(card_ms / (traced_wall * 1e3 / DEMO_PROFILED_BLOCKS)
                           if trace["trace_complete"] else card_ms),
          card_busy_share_of_callback=(card_ms / host_per_block
                                       if trace["trace_complete"]
                                       else card_ms),
          steady_step_device_ms=steady_ms, fade_step_device_ms=fade_ms,
          wall_seconds=wall,
          realtime_multiple=(DEMO_BLOCKS * BLOCK / SAMPLE_RATE) / wall,
          callback_realtime_multiple=(BLOCK / SAMPLE_RATE * 1e3)
          / host_per_block)
    expected = {"total": n_blocks, "O=4": n_blocks - fade_blocks,
                "O=8": fade_blocks}
    if status != "processing" or purpose != TapPurpose.PROCESSING:
        raise AssertionError(f"demo: status {status}, purpose {purpose}")
    if {k: counts.get(k, 0) for k in expected} != expected or counts[
            "total"] != n_blocks or launches["demo"]["mac_kmajor_pages"][
            "total"]:
        raise AssertionError(f"demo: launches {launches['demo']}, expected "
                             f"mac_kmajor {expected}")
    # Two fades: the activation's (a self-fade: the coordinator publishes
    # the renderer twice) and the swap's, each ceil(EQ_RAMP / BLOCK) blocks.
    if fade_blocks != 2 * -(-EQ_RAMP // BLOCK):
        raise AssertionError(f"demo: {fade_blocks} fade blocks")
    if not max(errors.values()) <= CHAIN_TOL:
        raise AssertionError(f"demo: rel-RMS {errors} > {CHAIN_TOL}")
    return launches


def host_blocks(seed: int, shape: tuple, n: int, dev: torch.device) -> list:
    """n blocks of distinct seeded input in pageable host memory, as a
    caller holds it: 0.25 * N(0, 1) float32, drawn on the card (the host
    takes seconds for gigabytes of draws) and fetched."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn(shape, generator=gen, device=dev) * 0.25)
            .cpu().numpy() for _ in range(n)]


def copy_overlap(fn, kernel: str) -> dict:
    """fn() traced (traced, one call after a warm-up call; the trace must
    hold every launch of `kernel`): from the trace's device events, the
    host-to-device copies and their streams, the kernels' streams, and how
    much of the copies' time a kernel on another stream was running."""
    with tempfile.TemporaryDirectory() as tmp:
        trace = traced(fn, 1, kernel, logdir=tmp)
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    counts = dict(trace_complete=trace["trace_complete"],
                  mac_launches=trace["launches"],
                  traced_mac_launches=trace["traced_launches"])
    if not trace["trace_complete"]:
        return dict(counts, h2d_ms="not measured",
                    h2d_overlapped_ms="not measured")

    def spans(pred):
        return [(e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream"))
                for e in events if e.get("ph") == "X" and pred(e)]

    copies = spans(lambda e: e.get("cat") == "gpu_memcpy"
                   and "HtoD" in e.get("name", ""))
    kernels = spans(lambda e: e.get("cat") == "kernel")
    overlapped = 0.0
    for start, end, stream in copies:
        reach = start
        for a, b in sorted((max(a, start), min(b, end))
                           for a, b, s in kernels
                           if s != stream and a < end and b > start):
            if b > max(a, reach):
                overlapped += b - max(a, reach)
                reach = b
    copy_us = sum(end - start for start, end, _ in copies)
    return dict(counts, h2d_copies=len(copies), h2d_ms=copy_us / 1e3,
                h2d_overlapped_ms=overlapped / 1e3,
                h2d_overlap_share=overlapped / copy_us if copy_us else 0.0,
                copy_streams=sorted({s for *_, s in copies}),
                kernel_streams=sorted({s for *_, s in kernels}))


def feeder_phase(wav, dev: torch.device, seed: int, smi: str) -> dict:
    """runtime.feeder.DeviceFeeder over both chain steps at full width
    (B=16384, S=2, T=512, the seeded 4320-tap bank, the 10-filter EQ):
    FEEDER_BLOCKS single-block steps (chain_step_fn) and FEEDER_STEPS
    8-block steps (chain_step_multi_fn, 537 MB of input a step) of distinct
    seeded host input through the feeder, and the same blocks through the
    unstaged loop (torch.from_numpy(x).to(dev), then the step) on an equal
    fresh state: equal bit for bit, 4 sampled lanes within 1e-5 of
    float64, one MAC launch per block or step; wall ms per block or step
    of both loops, the pinned bytes held, and from a trace (copy_overlap;
    for the record) the streams the copies and the kernels ran on and how much of
    the copies' time overlapped a kernel. Returns the feeder runs'
    launches."""
    preamp, coeffs = bench_eq()
    hrir = build_hrir_time_domain(wav, channel_maps.STEREO, SAMPLE_RATE)
    lanes = sorted(int(b) for b in np.random.default_rng(seed).choice(
        BATCH, 4, replace=False))
    launches = {}
    for label, M, n in (("feeder_single_block", 1, FEEDER_BLOCKS),
                        ("feeder_paged", BLOCKS_PER_STEP, FEEDER_STEPS)):
        renderer = prepare_renderer(wav, channel_maps.STEREO, SAMPLE_RATE,
                                    BLOCK, lookahead=M, device=dev)
        eq = eq_block.make_eq_params(coeffs, preamp, BLOCK, device=dev)
        chain = BinauralChain(renderer.conv_params, eq, eq, EQ_RAMP, BLOCK,
                              blocks_per_step=M)

        def fresh():
            P = renderer.partition_count
            conv = (upols.make_conv_state_paged(BATCH, SPEAKERS, P, BLOCK, M,
                                                dev) if M > 1 else
                    upols.make_conv_state(BATCH, SPEAKERS, P, BLOCK, dev))
            return ChainState(conv, eq_block.make_eq_state(BATCH, device=dev))

        shape = ((BATCH, SPEAKERS, M, BLOCK) if M > 1
                 else (BATCH, SPEAKERS, BLOCK))
        xs = host_blocks(seed + M, shape, n, dev)
        with torch.inference_mode():
            chain(fresh(), torch.zeros(shape, device=dev))  # warm-up
            torch.cuda.synchronize()
            state, plain = fresh(), []
            t0 = time.perf_counter()
            for x in xs:
                state, y = chain(state, torch.from_numpy(x).to(dev))
                plain.append(y)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            del state
            feeder = DeviceFeeder(chain, fresh(), device=dev)
            mk.reset_launch_count()
            t0 = time.perf_counter()
            feeder.prime(xs[0])
            fed = [feeder.step(x) for x in xs[1:]]
            fed.append(feeder.flush())
            torch.cuda.synchronize()
            fed_s = time.perf_counter() - t0
            launches[label] = counts_now()
            equal = all(torch.equal(a, b) for a, b in zip(fed, plain))
            differ = max(float((a - b).abs().max())
                         for a, b in zip(fed, plain))
            idx = torch.tensor(lanes, device=dev)
            got = torch.cat([y.index_select(0, idx).reshape(
                len(lanes), -1, EARS, BLOCK) for y in fed], 1)
            got = got.permute(0, 2, 1, 3).reshape(len(lanes), EARS, -1).cpu()
            del plain, fed

            def profiled_steps():
                feeder.prime(xs[0])
                for x in xs[1:FEEDER_PROFILED]:
                    feeder.step(x)
                feeder.flush()

            overlap = copy_overlap(profiled_steps,
                                   "mac_kmajor_pages" if M > 1
                                   else "mac_kmajor")
            pinned = feeder.pinned_bytes
            del feeder
        lane_err = [rel_rms(got[i].numpy(), reference_lane(
            hrir, np.concatenate([x[b].reshape(SPEAKERS, -1) for x in xs], -1),
            preamp, coeffs)) for i, b in enumerate(lanes)]
        del xs
        torch.cuda.empty_cache()
        unit = "block" if M == 1 else "step"
        phase(label, card=smi, lanes=BATCH, blocks_per_step=M, steps=n,
              input_bytes_per_step=int(np.prod(shape)) * 4,
              **{f"fed_ms_per_{unit}": fed_s / n * 1e3,
                 f"unstaged_ms_per_{unit}": plain_s / n * 1e3},
              fed_equal_unstaged=equal, max_abs_diff=differ,
              lanes_sampled=lanes, lane_rel_rms=lane_err,
              launches=launches[label], pinned_bytes=pinned,
              profiled_steps=FEEDER_PROFILED, **overlap)
        if not equal:
            raise AssertionError(f"{label}: fed outputs differ from the "
                                 f"unstaged loop's (max abs {differ})")
        if not max(lane_err) <= CHAIN_TOL:
            raise AssertionError(f"{label}: lane rel-RMS {lane_err} > "
                                 f"{CHAIN_TOL}")
        used = "mac_kmajor_pages" if M > 1 else "mac_kmajor"
        expected = {name: n if name == used else 0 for name in KERNELS}
        if by_kernel(launches[label]) != expected:
            raise AssertionError(f"{label}: launches {launches[label]}, "
                                 f"expected {expected} (one per step)")
    return launches


class CheckedMacs:
    """While entered, every MAC launch of ops.upols (both kernels) is held
    against its plain version (mk.mac_kmajor_ref, mk.mac_kmajor_pages_ref)
    on the same operands, at the shapes the path gives it: rel-RMS at most
    KERNEL_TOL, and exactly 0 where the reference is (a round of silence),
    else AssertionError. The plain version is no launch, so the paths'
    counts are unchanged. `launches` counts the checked launches by kernel,
    `cases()` lists them by shape with their largest errors and how many
    had a non-zero reference. With `limit`, a sample of a long path: each
    shape's launches are checked until `limit` of them had a non-zero
    reference (a group's lanes may idle through the first rounds); the
    later ones run unchecked."""

    def __init__(self, path: str, limit: "int | None" = None):
        self.path, self.limit = path, limit
        self.launches = dict.fromkeys(KERNELS, 0)
        self._shapes = {}

    def _sampling(self, kernel: str, shape: str) -> bool:
        case = self._shapes.get((kernel, shape))
        return (self.limit is None or case is None
                or case["nonzero_reference_launches"] < self.limit)

    def __enter__(self):
        self._saved = kernel, fused = upols.mac_kmajor, upols.mac_kmajor_pages

        def mac(fdl, h, out=None, **kw):
            if kw.get("accumulate"):
                raise AssertionError("CheckedMacs: accumulate is not checked")
            y = kernel(fdl, h, out=out, **kw)
            K, R, B = fdl.shape
            shape = f"K={K} R={R} O={h.shape[1]} B={B}"
            if self._sampling("mac_kmajor", shape):
                self._check("mac_kmajor", shape, y, mk.mac_kmajor_ref(fdl, h))
            return y

        def mac_pages(pages, bank, out=None, **kw):
            y = fused(pages, bank, out=out, **kw)
            K, R, B = pages[0].shape
            shape = f"{len(pages)} pages K={K} R={R} O={bank.shape[2]} B={B}"
            if self._sampling("mac_kmajor_pages", shape):
                self._check("mac_kmajor_pages", shape, y,
                            mk.mac_kmajor_pages_ref(pages, bank))
            return y

        upols.mac_kmajor, upols.mac_kmajor_pages = mac, mac_pages
        return self

    def __exit__(self, *exc):
        upols.mac_kmajor, upols.mac_kmajor_pages = self._saved
        return False

    def _check(self, kernel: str, shape: str, got, ref) -> None:
        diff = got - ref
        ref_norm = torch.linalg.vector_norm(ref).item()
        max_abs = diff.abs().max().item()
        if ref_norm:
            rel = torch.linalg.vector_norm(diff).item() / ref_norm
        else:
            rel = 0.0 if max_abs == 0 else float("inf")
        del diff, ref
        if not rel <= KERNEL_TOL:
            raise AssertionError(f"{self.path}: {kernel} {shape}: rel-RMS "
                                 f"{rel} against the plain version > "
                                 f"{KERNEL_TOL}")
        self.launches[kernel] += 1
        case = self._shapes.setdefault((kernel, shape), dict(
            kernel=kernel, case=f"{self.path} {shape}", launches=0,
            nonzero_reference_launches=0, max_abs_err=0.0, rel_rms=0.0))
        case["launches"] += 1
        case["nonzero_reference_launches"] += bool(ref_norm)
        case["max_abs_err"] = max(case["max_abs_err"], max_abs)
        case["rel_rms"] = max(case["rel_rms"], rel)

    def cases(self) -> list:
        return list(self._shapes.values())


def render_fixture(pool: StreamPool, lanes, streams, block: int,
                   n_blocks: int) -> list:
    """tests/test_migration.py's loop: one block per lane while its stream
    lasts, a pump, everything available pulled."""
    out = [[] for _ in lanes]
    for t in range(n_blocks):
        for j, lane in enumerate(lanes):
            if t < streams[j].shape[1] // block:
                pool.push(lane, streams[j][:, t * block:(t + 1) * block])
        pool.pump()
        for j, lane in enumerate(lanes):
            n = pool.available(lane)
            if n:
                out[j].append(pool.pull(lane, n))
    return [np.concatenate(o, axis=1) for o in out]


def migration_fixtures(dev: torch.device) -> tuple:
    """The committed round-3 fixtures restored into port pools on the card,
    built as tests/test_migration.py:95,169 builds them, continued with the
    fixtures' inputs: each lane's rel-RMS against the uninterrupted render
    on the card, the continuation's launches and the group-rounds it ran
    (one MAC launch each)."""
    errs, launched, rounds = {}, {name: 0 for name in KERNELS}, 0
    for grouped in (False, True):
        tag = "grouped_" if grouped else ""
        d = np.load(os.path.join(REPO, "tests", "fixtures",
                                 f"r3_{tag}full_window_inputs.npz"))
        block = int(d["block"])
        n_pre, n_post = int(d["n_pre"]), int(d["n_post"])
        x = d["x"]
        audios = [d["hrir_a"], d["hrir_b"]] if grouped else [d["hrir_audio"]]
        renderers = [prepare_renderer(wavio.WAVData(SAMPLE_RATE, a),
                                      channel_maps.STEREO, SAMPLE_RATE, block,
                                      device=dev) for a in audios]

        def build():
            if grouped:
                return StreamPool(4, SAMPLE_RATE, None, block_size=block,
                                  profiles=[PoolProfile(r) for r in renderers],
                                  device=dev)
            return StreamPool(4, SAMPLE_RATE, renderers[0], block_size=block,
                              device=dev)

        streams = [np.concatenate([x[0, :, :n_pre * block], d["extra_a"],
                                   x[0, :, n_pre * block:]], axis=1),
                   np.concatenate([x[1, :, :n_pre * block],
                                   x[1, :, n_pre * block:]], axis=1)]
        ref = build()
        ref_out = render_fixture(
            ref, [ref.attach(0), ref.attach(len(audios) - 1)], streams, block,
            max(s.shape[1] // block for s in streams))
        tails = [ref_out[0][:, (n_pre + 2) * block:],
                 ref_out[1][:, n_pre * block:]]
        pool = build()
        snap = load_pool_snapshot(os.path.join(
            REPO, "tests", "fixtures", f"r3_{tag}full_window_pool"), pool)
        if snap.get("migrated_from") != "full-window (schema 1)":
            raise AssertionError(f"r3 {tag or 'ring'} fixture not migrated")
        pool.restore(snap)
        mk.reset_launch_count()
        got = render_fixture(pool, snap["attached"],
                             [x[j, :, n_pre * block:] for j in range(2)],
                             block, n_post)
        for name in KERNELS:
            launched[name] += mk.launch_count(name)
        rounds += n_post * len(audios)
        errs[f"r3_{tag or 'ring_'}fixture"] = [rel_rms(g, t)
                                              for g, t in zip(got, tails)]
    return errs, launched, rounds


def migration_phase(wav, dev: torch.device, rng: np.random.Generator,
                    smi: str) -> dict:
    """Round-3 checkpoints into pools on the card: the committed fixtures
    (migration_fixtures), then at full width an 8192-lane ring pool fed on
    every lane for MIGRATION_ROUNDS rounds and snapshotted; from the blocks
    it was fed, its round-3 full-window carry by the definition of
    tests/test_migration.py:34 (slot (w-1-j) mod P holds X_{t-j} =
    rfft_2T([b_{t-j-1}, b_{t-j}]) in float64, cast to f32; the overlap each
    lane's last block), the rest of the state from the snapshot, written
    with utils.checkpoint.save_pytree as a schema-less npz; handed to
    shell.app.restore_serve_checkpoint on a fresh pool: migrated, not moved
    aside, and sampled lanes continuing within 1e-5 of the uninterrupted
    pool and of float64. The same file offered to a paged pool raises the
    versioned error. Returns the migrated pools' launches."""
    fixture_err, launched, fixture_rounds = migration_fixtures(dev)
    lanes = POOL_LANES[1]
    preamp, coeffs = bench_eq()
    hrir = build_hrir_time_domain(wav, channel_maps.STEREO, SAMPLE_RATE)
    a = make_pool(wav, lanes, 1, dev, bench_eq_definition())
    every = np.array([a.attach() for _ in range(lanes)])
    settle(a)
    P = a.renderer.partition_count - 1  # the full-window carry's slots
    sampled = sorted(int(b) for b in rng.choice(lanes, 4, replace=False))
    history = {b: [] for b in sampled}
    outputs = {b: [] for b in sampled}
    recent = []
    for _ in range(MIGRATION_ROUNDS):
        x = rng.standard_normal((lanes, SPEAKERS, BLOCK), dtype=np.float32)
        x *= 0.25
        y = feed_round(a, every, x)
        recent = (recent + [x])[-(P + 1):]
        for b in sampled:
            history[b].append(x[b])
            outputs[b].append(y[b])
    snap = a.snapshot()
    T, K, Kp = BLOCK, BLOCK + 1, upols.padded_bin_count(BLOCK)
    w = MIGRATION_ROUNDS % P  # any cursor below P
    t0 = time.perf_counter()
    fdl_old = np.zeros((Kp, SPEAKERS, P, 2, lanes), np.float32)
    for j in range(P):
        window = np.concatenate([recent[-2 - j], recent[-1 - j]], -1)
        X = np.fft.rfft(window.astype(np.float64), axis=-1)  # [B, S, K]
        slot = (w - 1 - j) % P
        fdl_old[:K, :, slot, 0, :] = X.real.transpose(2, 1, 0)
        fdl_old[:K, :, slot, 1, :] = X.imag.transpose(2, 1, 0)
    legacy = PoolState(
        conv=checkpoint._LegacyConvState(fdl_old, recent[-1],
                                         np.asarray(w, np.int32)),
        eq=snap["state"].eq)
    meta = {"attached": [int(s) for s in snap["attached"]],
            "eq_enabled": bool(snap["eq_enabled"]), "groups": 1,
            "eq_runtime": checkpoint._pack_eq_runtime(snap["eq_runtime"])}
    build_seconds = time.perf_counter() - t0
    del snap
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "r3_ring_pool")
        checkpoint.save_pytree(path, {"debt": np.zeros(lanes, np.int64),
                                      "state": legacy}, extra_json=meta)
        del legacy, fdl_old
        file_bytes = os.path.getsize(checkpoint_path(path))
        b = make_pool(wav, lanes, 1, dev, bench_eq_definition())
        t0 = time.perf_counter()
        resumed, tokens, _ = shell_app.restore_serve_checkpoint(path, b)
        torch.cuda.synchronize()
        load_seconds = time.perf_counter() - t0
        kept = os.path.exists(checkpoint_path(path)) and not os.path.exists(
            checkpoint_path(path) + ".incompatible")
        paged = make_pool(wav, lanes, BLOCKS_PER_STEP, dev, None)
        try:
            load_pool_snapshot(path, paged)
            paged_error = None
        except checkpoint.SnapshotCompatError as err:
            paged_error = str(err)
        del paged
    torch.cuda.empty_cache()
    cont = {b_: [] for b_ in sampled}
    all_err = 0.0
    for _ in range(MIGRATION_CONTINUED):
        x = rng.standard_normal((lanes, SPEAKERS, BLOCK), dtype=np.float32)
        x *= 0.25
        ya = feed_round(a, every, x)
        mk.reset_launch_count()
        yb = feed_round(b, every, x)
        for name in KERNELS:
            launched[name] += mk.launch_count(name)
        all_err = max(all_err, rel_rms(yb, ya))
        for s in sampled:
            history[s].append(x[s])
            outputs[s].append(ya[s])
            cont[s].append(yb[s])
    n_cont = MIGRATION_CONTINUED * BLOCK
    vs_twin, vs_f64 = [], []
    for s in sampled:
        ref = reference_lane(hrir, np.concatenate(history[s], -1), preamp,
                             coeffs)
        got = np.concatenate(cont[s], -1)
        twin = np.concatenate(outputs[s], -1)[:, -n_cont:]
        vs_twin.append(rel_rms(got, twin))
        vs_f64.append(rel_rms(got, ref[:, -n_cont:]))
    del a, b
    torch.cuda.empty_cache()
    phase("migration", card=smi, fixtures_rel_rms=fixture_err, lanes=lanes,
          full_window_slots=P, cursor=w, rounds_before=MIGRATION_ROUNDS,
          rounds_continued=MIGRATION_CONTINUED,
          carry_build_seconds=build_seconds,
          file_bytes=file_bytes, load_and_migrate_seconds=load_seconds,
          resumed=resumed, file_kept=kept, resume_tokens=tokens,
          lanes_sampled=sampled, lane_rel_rms_vs_uninterrupted=vs_twin,
          lane_rel_rms_vs_float64=vs_f64,
          all_lanes_rel_rms_vs_uninterrupted=all_err,
          paged_pool_error=paged_error, launches=launched)
    worst = max(max(v) for v in fixture_err.values())
    if not worst <= CHAIN_TOL:
        raise AssertionError(f"migration: fixture rel-RMS {fixture_err}")
    if not (resumed and kept):
        raise AssertionError(f"migration: restore_serve_checkpoint resumed="
                             f"{resumed}, file kept={kept}")
    if not max(vs_twin + vs_f64 + [all_err]) <= CHAIN_TOL:
        raise AssertionError(f"migration: continued lanes {vs_twin} / "
                             f"{vs_f64} / {all_err} > {CHAIN_TOL}")
    if not (paged_error and "schema 1" in paged_error):
        raise AssertionError(f"migration: the paged pool took the file: "
                             f"{paged_error}")
    expected = {"mac_kmajor": fixture_rounds + MIGRATION_CONTINUED,
                "mac_kmajor_pages": 0}
    if launched != expected:
        raise AssertionError(f"migration: launches {launched}, expected "
                             f"{expected} (one per group per round)")
    return launched


def capacity_peak(wav, dev: torch.device, lanes: int, M: int,
                  checked: CheckedMacs) -> int:
    """Device bytes above the baseline at the peak of building a pool of
    `lanes` lanes and running one steady, one EQ-crossfade and one hot-swap
    round on its own carry and device-resident input
    (memory_planner.pool_round_peak); then, the peak read, the same rounds
    again on seeded input under `checked`, so each MAC launch at this
    width is held against its plain version."""
    peak, pool = memory_planner.pool_round_peak(
        lambda: make_pool(wav, lanes, M, dev, bench_eq_definition()), dev)
    if not all(torch.isfinite(t).all() for t in pool._state.eq):
        raise AssertionError("capacity pool: non-finite EQ carry")
    with checked, torch.inference_mode():
        for kind in memory_planner.round_kinds(pool):
            pool._state, y = memory_planner.run_round(
                pool, kind, state=pool._state,
                blocks=seeded_blocks(pool, lanes, dev))
            del y
    del pool
    torch.cuda.empty_cache()
    return peak


def seeded_blocks(pool: StreamPool, lanes: int, dev: torch.device):
    """One round's input for `lanes` lanes of the pool, 0.25 * N(0, 1) drawn
    on the card from a fixed seed."""
    S, M = pool.renderer.num_speakers, pool.blocks_per_step
    shape = ((lanes, S, M, pool.block_size) if M > 1
             else (lanes, S, pool.block_size))
    gen = torch.Generator(device=dev).manual_seed(lanes)
    return torch.randn(shape, generator=gen, device=dev) * 0.25


def planner_phase(wav, dev: torch.device, measured: dict, smi: str) -> dict:
    """utils.memory_planner on the card: cuda_pool_round_memory on both tiers
    at probe batches PLANNER_PROBES (per-lane bytes within 5% between them;
    the steady, EQ-crossfade and hot-swap peaks), each tier built at
    pool_capacity(..., hbm_bytes=PLANNER_HBM, calibration=...)'s max_streams
    with one round of each kind on device-resident input (its peak at most
    0.85 * PLANNER_HBM, the calibrated estimate over it at most 1.3); the
    hand model beside this run's measured peaks (pool_timing at 8192 ring
    and 16384 paged lanes, the bake step at B=16384 M=8), the whole card's
    recommendation, and `python -m airwave_tpu_torch.tools.plan_capacity
    --blocks-per-step 8 --calibrate --probe-batch 512 --hbm-gb 24` as a
    process. Each probe's rounds (at its lanes and the warm-up's) and the
    capacity pools' rounds run once more on seeded input under CheckedMacs,
    so every MAC width the phase launches is held against the plain
    version; those re-runs are not the path's launches. Returns the
    phase's launches, the checked cases and each tier's calibration at the
    larger probe (by blocks_per_step)."""
    mk.reset_launch_count()
    tiers, calibrations = {}, {}
    checked = CheckedMacs("planner")
    for M in (1, BLOCKS_PER_STEP):
        cals = {}
        for probe in PLANNER_PROBES:
            pool = make_pool(wav, probe, M, dev, bench_eq_definition())
            cals[probe] = memory_planner.cuda_pool_round_memory(pool)
            with checked, torch.inference_mode():  # the rounds it measured
                for kind in memory_planner.round_kinds(pool):
                    for n in (memory_planner.WARMUP_LANES, probe):
                        memory_planner.run_round(
                            pool, kind, n, blocks=seeded_blocks(pool, n, dev))
            del pool
        small, large = (cals[p] for p in PLANNER_PROBES)
        calibrations[M] = large
        spread = {kind: small["rounds"][kind]["per_lane_bytes"]
                  / large["rounds"][kind]["per_lane_bytes"] - 1.0
                  for kind in large["rounds"]}
        plan = memory_planner.pool_capacity(
            SPEAKERS, HRIR_TAPS, BLOCK, lookahead=M, hbm_bytes=PLANNER_HBM,
            calibration=large)
        n = plan["max_streams"]
        peak = capacity_peak(wav, dev, n, M, checked)
        estimate = plan["params_bytes"] + plan["per_lane_bytes"] * n
        lanes_ref = POOL_LANES[M]
        hand = memory_planner.pool_capacity(SPEAKERS, HRIR_TAPS, BLOCK,
                                            lookahead=M, hbm_bytes=PLANNER_HBM)
        card = device_hbm_bytes()
        tiers["ring" if M == 1 else "paged"] = dict(
            probes={p: {"per_lane_bytes": c["per_lane_bytes"],
                        "fixed_bytes": c["fixed_bytes"],
                        "carry_bytes_exact": c["carry_bytes_exact"],
                        "rounds": c["rounds"]} for p, c in cals.items()},
            per_lane_spread=spread, max_streams=n, capacity_peak_bytes=peak,
            calibrated_estimate_bytes=estimate,
            estimate_over_peak=estimate / peak,
            peak_over_budget=peak / PLANNER_HBM,
            hand_model={"lanes": lanes_ref, "estimate_bytes":
                        hand["params_bytes"] + hand["per_lane_bytes"]
                        * lanes_ref, "per_lane_bytes": hand["per_lane_bytes"],
                        "max_streams_24e9": hand["max_streams"]},
            calibrated_at_reference_lanes=large["fixed_bytes"]
            + large["per_lane_bytes"] * lanes_ref,
            measured_peak_at_reference_lanes=measured[M],
            whole_card={"hbm_bytes": card, "max_streams": memory_planner
                        .pool_capacity(SPEAKERS, HRIR_TAPS, BLOCK,
                                       lookahead=M, hbm_bytes=card,
                                       calibration=large)["max_streams"],
                        "hand_max_streams": memory_planner.pool_capacity(
                            SPEAKERS, HRIR_TAPS, BLOCK, lookahead=M,
                            hbm_bytes=card)["max_streams"]})
        torch.cuda.empty_cache()
    # The checking rounds re-run what was measured: not the path's launches.
    launched = {name: mk.launch_count(name) - checked.launches[name]
                for name in KERNELS}
    bake_hand = memory_planner.estimate_paged_bake(
        BATCH, SPEAKERS, HRIR_TAPS, BLOCK, BLOCKS_PER_STEP).total_bytes
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "airwave_tpu_torch.tools.plan_capacity",
         "--blocks-per-step", str(BLOCKS_PER_STEP), "--calibrate",
         "--probe-batch", str(PLANNER_PROBES[0]), "--hbm-gb", "24"],
        cwd=REPO, env=child_env(), capture_output=True, text=True,
        timeout=300)
    cli_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"plan_capacity exited {proc.returncode}: "
                             f"{proc.stderr[-1500:]}")
    cli = json.loads(proc.stdout)
    paged_cal = tiers["paged"]["probes"][PLANNER_PROBES[0]]
    cli_lane_ratio = cli["per_lane_bytes"] / paged_cal["per_lane_bytes"]
    phase("planner", card=smi, hbm_budget_bytes=PLANNER_HBM, **tiers,
          bake_hand_estimate_bytes=bake_hand,
          bake_measured_peak_bytes=measured["bake"], launches=launched,
          plan_capacity_cli={k: cli.get(k) for k in (
              "calibrated", "per_lane_bytes", "params_bytes", "max_streams",
              "max_streams_steady", "calibration")},
          plan_capacity_seconds=cli_seconds,
          cli_per_lane_over_in_process=cli_lane_ratio,
          checked_launches=checked.launches, checked_cases=checked.cases())
    for tier, t in tiers.items():
        if not max(abs(v) for v in t["per_lane_spread"].values()) <= 0.05:
            raise AssertionError(f"planner ({tier}): per-lane bytes differ "
                                 f"by more than 5% between probes: "
                                 f"{t['per_lane_spread']}")
        if not t["capacity_peak_bytes"] <= 0.85 * PLANNER_HBM:
            raise AssertionError(f"planner ({tier}): the capacity pool's peak "
                                 f"{t['capacity_peak_bytes']} is over 0.85 x "
                                 f"{PLANNER_HBM}")
        if not t["estimate_over_peak"] <= 1.3:
            raise AssertionError(f"planner ({tier}): estimate over peak "
                                 f"{t['estimate_over_peak']} > 1.3")
    if not (cli["calibrated"] is True and abs(cli_lane_ratio - 1) <= 0.05):
        raise AssertionError(f"planner: plan_capacity --calibrate gave {cli}")
    return launched, checked.cases(), calibrations


def baseline_rounds_phase(wav, dev: torch.device, baselines: dict,
                          smi: str) -> None:
    """The planner's paged capacity pool (CAPACITY_LANES[M] lanes, seeded
    input on the card): each device round kind (memory_planner.run_round on
    the pool's carry) in CUDA-event ms, the mean of 5 rounds a reading, in
    turns with each --baseline build in the kernel's place in ops.upols
    (the build, the kernel, the kernel, the build)."""
    M = BLOCKS_PER_STEP
    lanes = CAPACITY_LANES[M]
    pool = make_pool(wav, lanes, M, dev, bench_eq_definition())
    gen = torch.Generator(device=dev).manual_seed(lanes)
    blocks = torch.randn((lanes, SPEAKERS, M, BLOCK), generator=gen,
                         device=dev) * 0.25
    rounds = {}
    with torch.inference_mode():
        for kind in memory_planner.round_kinds(pool):
            def one_round(kind=kind):
                pool._state, _ = memory_planner.run_round(
                    pool, kind, state=pool._state, blocks=blocks)

            for label, run in baselines.items():
                turns = []
                for mac in (run.pages, upols.mac_kmajor_pages,
                            upols.mac_kmajor_pages, run.pages):
                    with mock.patch.object(upols, "mac_kmajor_pages", mac):
                        turns.append(cuda_ms(one_round, 5))
                rounds[f"{kind} vs {label}"] = dict(
                    ms=(turns[1] + turns[2]) / 2, ms_turns=turns[1:3],
                    build_ms=(turns[0] + turns[3]) / 2,
                    build_ms_turns=[turns[0], turns[3]])
    phase("baseline_rounds", lanes=lanes, rounds=rounds, device=smi)
    del pool, blocks
    torch.cuda.empty_cache()


# --- mesh: the stream-sharded chains and pools on virtual shards ------------


def mesh_devices(n: int) -> list:
    """n shard devices: the visible cards in turn, so on one card n virtual
    shards of cuda:0 (each its own carry, launches and CUDA stream)."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def mesh_fields(devices) -> dict:
    return dict(cards=len({d.index for d in devices}), shards=len(devices))


def totals(launches: dict) -> dict:
    """{kernel: launches} of a launches_now() reading."""
    return {name: launches[name]["total"] for name in KERNELS}


def snapshot_arrays(snap: dict) -> list:
    """Every array of a pool snapshot's carry and debt, in a fixed order."""
    leaves = []
    pmesh.tree_map(lambda t: leaves.append(np.asarray(t)), snap["state"])
    return leaves + [np.asarray(snap["debt"])]


def mesh_bake_part(rng: np.random.Generator, dev: torch.device,
                   smi: str) -> dict:
    """The sharded paged bake at the headline width (B=16384, M=8, 3 pages,
    the 10-filter EQ folded) over MESH_SHARDS shards, against the unsharded
    chain on the same device-resident input, sampled lanes against float64,
    and one 8-block step of each in CUDA-event time, in turns."""
    M, B, N = BLOCKS_PER_STEP, BATCH, MESH_BAKE_STEPS
    devices = mesh_devices(MESH_SHARDS)
    hrir = (rng.standard_normal((SPEAKERS, EARS, HRIR_TAPS)) * 0.05).astype(
        np.float32)
    hrir[:, :, 0] += 0.8
    preamp, coeffs = bench_eq()
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 31)))
    lanes = sorted(int(b) for b in rng.choice(B, 4, replace=False))
    with torch.inference_mode():
        x = torch.randn((N, B, SPEAKERS, M, BLOCK), generator=gen,
                        device=dev) * 0.25
        conv = upols.make_conv_params(hrir, BLOCK, pad_to_pow2=False,
                                      lookahead=M, device=dev)
        eq = eq_block.make_eq_params(coeffs, preamp, BLOCK, device=dev)

        def fresh():
            return ChainState(
                conv=upols.make_conv_state_paged(
                    B, SPEAKERS, conv.partition_count, BLOCK, M, dev),
                eq=eq_block.make_eq_state(B, device=dev))

        mesh = pmesh.make_mesh(devices)
        run = pmesh.stream_sharded_bake_multi(
            mesh, conv.partition_count // M, eq_enabled=True)
        mk.reset_launch_count()
        with CheckedMacs("mesh_bake") as checked:
            sharded, ys = run(conv, eq, eq, fresh(), x)
            torch.cuda.synchronize()
        launches = launches_now()
        y = ys.gather(dev)                                  # [N, B, M, 2, T]
        del ys
        chain = BinauralChain(conv, eq, eq, 960, BLOCK, blocks_per_step=M)
        plain = fresh()
        ref = torch.empty_like(y)
        for n in range(N):
            plain, ref[n] = chain(plain, x[n])
        rel = ((y.double() - ref.double()).pow(2).mean().sqrt()
               / ref.double().pow(2).mean().sqrt()).item()
        del ref
        host_x = x[:, lanes].permute(1, 2, 0, 3, 4).reshape(
            len(lanes), SPEAKERS, -1).cpu().numpy()
        host_y = y[:, lanes].permute(1, 3, 0, 2, 4).reshape(
            len(lanes), EARS, -1).cpu().numpy()
        del y
        lane_err = [rel_rms(host_y[i], reference_lane(hrir, host_x[i], preamp,
                                                      coeffs))
                    for i in range(len(lanes))]
        one = pmesh.StreamShards(mesh).split(x[:1], 1)

        def sharded_step():
            nonlocal sharded
            sharded, _ = run(conv, eq, eq, sharded, one)

        def plain_step():
            nonlocal plain
            plain, _ = chain(plain, x[0])

        turns = [cuda_ms(f, MESH_TIMED_STEPS)
                 for f in (plain_step, sharded_step, sharded_step, plain_step)]
        del x, one, sharded, plain
    torch.cuda.empty_cache()
    result = dict(part="bake", card=smi, **mesh_fields(devices), batch=B,
                  blocks_per_step=M, steps=N, launches=launches,
                  rel_rms_vs_unsharded=rel, lanes=lanes, lane_rel_rms=lane_err,
                  step_ms_sharded=(turns[1] + turns[2]) / 2,
                  step_ms_sharded_turns=turns[1:3],
                  step_ms_unsharded=(turns[0] + turns[3]) / 2,
                  step_ms_unsharded_turns=[turns[0], turns[3]])
    phase("mesh", **result)
    if not rel <= MESH_TOL:
        raise AssertionError(f"mesh bake: rel-RMS {rel} against the "
                             f"unsharded bake > {MESH_TOL}")
    if not max(lane_err) <= CHAIN_TOL:
        raise AssertionError(f"mesh bake: lane rel-RMS {lane_err} > "
                             f"{CHAIN_TOL}")
    want = N * MESH_SHARDS
    if (launches["mac_kmajor_pages"]["total"] != want
            or launches["mac_kmajor"]["total"]):
        raise AssertionError(f"mesh bake: launches {launches}, expected {want} "
                             f"of mac_kmajor_pages (one per shard and step)")
    return {"launches": totals(launches), "checks": checked.cases()}


def mesh_pool_part(label: str, make, lanes: int, M: int, shards: int,
                   control, rng: np.random.Generator, smi: str) -> dict:
    """A pool over `shards` shards and the unsharded pool (make(mesh) and
    make(None)) on the same ragged traffic through control(pool, round)'s
    EQ retarget and hot-swap: every delivered lane of the sharded pool
    within MESH_TOL of the unsharded one, one MAC launch per shard and
    group a round; host and device ms of a saturated round of each, in
    turns; then a snapshot of the sharded pool restored into the unsharded
    one (its snapshot equal to the first bit for bit, its output within
    MESH_TOL) and into the sharded pool itself (its output bit for bit the
    uninterrupted rounds')."""
    devices = mesh_devices(shards)
    sharded, plain = make(pmesh.make_mesh(devices)), make(None)
    for pool in (sharded, plain):
        for lane in range(lanes):
            pool.attach(lane // pool.group_size)
    sharded.prewarm(include_hotswap=True)
    step = sharded.step_frames
    base = rng.standard_normal((lanes, SPEAKERS, step), dtype=np.float32)
    base *= 0.25
    rounds = MESH_POOL_ROUNDS[M]
    err2, ref2 = np.zeros(lanes), np.zeros(lanes)
    per_round = []
    with CheckedMacs(f"mesh_{label}") as checked:
        for r in range(rounds):
            for pool in (sharded, plain):
                control(pool, r)
            fed = np.nonzero(rng.random(lanes) < POOL_SHARE)[0]
            if r == rounds - 1:
                fed = np.arange(lanes)  # every pending fade plays out
            mk.reset_launch_count()
            got = feed_round(sharded, fed, base[:len(fed)])
            per_round.append(launches_now())
            want = feed_round(plain, fed, base[:len(fed)]).astype(np.float64)
            err2[fed] += ((got - want) ** 2).sum(axis=(1, 2))
            ref2[fed] += (want ** 2).sum(axis=(1, 2))
    lane_err = float(np.sqrt(err2[ref2 > 0] / ref2[ref2 > 0]).max())
    kernel = "mac_kmajor_pages" if M > 1 else "mac_kmajor"
    launches = {name: sum(c[name]["total"] for c in per_round)
                for name in KERNELS}
    every = np.arange(lanes)
    turns = (("unsharded", plain), ("sharded", sharded),
             ("sharded", sharded), ("unsharded", plain))
    host, device = {}, {}
    for pool in (plain, sharded):
        feed_round(pool, every, base)  # warm-up
    for key, pool in turns:
        t0 = time.perf_counter()
        feed_round(pool, every, base)
        host.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
    rounds_alone = {"unsharded": device_round(plain, base),
                    "sharded": device_round(sharded, base)}
    for key, _ in turns:
        device.setdefault(key, []).append(cuda_ms(rounds_alone[key], 3))
    del rounds_alone
    host_ms = {k: sum(v) / len(v) for k, v in host.items()}
    device_ms = {k: sum(v) / len(v) for k, v in device.items()}
    snap = sharded.snapshot()
    plain.restore(snap)
    snapshot_equal = all(np.array_equal(a, b) for a, b in zip(
        snapshot_arrays(plain.snapshot()), snapshot_arrays(snap)))
    feeds = [np.nonzero(rng.random(lanes) < POOL_SHARE)[0] for _ in range(2)]
    first = [feed_round(sharded, f, base[:len(f)]) for f in feeds]
    flat = [feed_round(plain, f, base[:len(f)]) for f in feeds]
    sharded.restore(snap)
    again = [feed_round(sharded, f, base[:len(f)]) for f in feeds]
    resume_equal = all(np.array_equal(a, b) for a, b in zip(first, again))
    resume_rel = max(rel_rms(a, b) for a, b in zip(flat, first))
    stats = sharded.stats()
    result = dict(
        part=label, card=smi, **mesh_fields(devices), lanes=lanes,
        blocks_per_step=M, groups=sharded.groups, rounds=rounds,
        fade_rounds=stats["fade_rounds"], debt_rolls=stats["debt_rolls"],
        variant_rounds=stats["variant_rounds"], launches=launches,
        launches_per_round=[c[kernel]["total"] for c in per_round],
        lane_rel_rms_vs_unsharded=lane_err,
        host_ms_per_round=host_ms, host_ms_per_round_turns=host,
        device_ms_per_round=device_ms, device_ms_per_round_turns=device,
        host_share={k: 1 - device_ms[k] / host_ms[k] for k in host_ms},
        snapshot_bytes=sum(a.nbytes for a in snapshot_arrays(snap)),
        snapshot_restored_unsharded_equal=snapshot_equal,
        resumed_sharded_bit_equal=resume_equal,
        resumed_unsharded_rel_rms=resume_rel)
    phase("mesh", **result)
    if not lane_err <= MESH_TOL:
        raise AssertionError(f"mesh {label}: lane rel-RMS {lane_err} against "
                             f"the unsharded pool > {MESH_TOL}")
    want = shards * sharded.groups
    if any(c[kernel]["total"] != want for c in per_round) or launches[
            "mac_kmajor_pages" if M == 1 else "mac_kmajor"]:
        raise AssertionError(f"mesh {label}: launches per round "
                             f"{result['launches_per_round']}, expected {want} "
                             f"of {kernel}")
    if not stats["fade_rounds"] or stats["render_errors"]:
        raise AssertionError(f"mesh {label}: no fade round ran, or errors: "
                             f"{stats}")
    if not (snapshot_equal and resume_equal and resume_rel <= MESH_TOL):
        raise AssertionError(f"mesh {label}: snapshot equal {snapshot_equal}, "
                             f"resume equal {resume_equal}, unsharded resume "
                             f"rel-RMS {resume_rel}")
    return {"launches": launches, "checks": checked.cases()}


def device_round(pool: StreamPool, base: np.ndarray):
    """A function running one saturated device round of `pool` alone: every
    lane's step (the "_id" variant) on device-resident input, each shard's
    on its own device and stream and its own fresh carry, in one fork-join
    round, so CUDA events on the current stream span every shard; what a
    pump round queues on the card, without the host's staging and delivery
    (saturated_round's round for a pool of any shard count)."""
    variant = "ring_id" if pool.blocks_per_step == 1 else "paged_id"
    targets = [rt.active.params for rt in pool.eq_runtimes]
    args = (pool._conv_params, pool._pack(targets),
            pool._pack(pool._operands(q, g) for g, q in enumerate(targets)))
    x = torch.from_numpy(base[pool._shard_order])  # shard by shard
    if pool.blocks_per_step > 1:
        x = x.view(x.shape[0], SPEAKERS, pool.blocks_per_step, BLOCK)
    L = pool.groups * pool._unit_lanes
    shards = []
    for s, dev in enumerate(pool._shards.devices):
        params, p, operands = pool._replicas.on(args, dev)
        shards.append([params, p, operands, pool._fresh_state(s),
                       x[s * L:(s + 1) * L].to(dev),
                       torch.arange(L, device=dev)])

    def run():
        with torch.inference_mode(), pool._shards.round():
            for s, sh in enumerate(shards):
                with pool._shards.shard(s):
                    sh[3], _ = pool_step_body(
                        sh[0], sh[1], sh[1], sh[3], sh[4], sh[5],
                        pool.eq_runtime.transition_length, True, False,
                        variant, sh[2])

    return run


def mesh_pools(wavs, dev: torch.device, rng: np.random.Generator,
               smi: str) -> dict:
    """The sharded pools of pool_phase's data: ring and paged tiers over
    MESH_SHARDS shards, and a grouped ring pool over MESH_GROUPED_SHARDS."""
    out = {}
    for label, M in (("pool_ring", 1), ("pool_paged", BLOCKS_PER_STEP)):
        renderers = [prepare_renderer(w, channel_maps.STEREO, SAMPLE_RATE,
                                      BLOCK, lookahead=M, device=dev)
                     for w in wavs[:2]]

        def make(mesh, M=M, r=renderers[0]):
            return StreamPool(POOL_LANES[M], SAMPLE_RATE, r,
                              eq_definition=bench_eq_definition(),
                              block_size=BLOCK, blocks_per_step=M, mesh=mesh,
                              device=None if mesh else dev)

        def control(pool, r, M=M, swap=renderers[1]):
            if r == MESH_POOL_ROUNDS[M] // 3:
                pool.set_equalizer(bench_eq_definition(0.5))
            if r == 2 * MESH_POOL_ROUNDS[M] // 3:
                pool.set_renderer(swap)

        out[f"mesh_{label}"] = mesh_pool_part(label, make, POOL_LANES[M], M,
                                              MESH_SHARDS, control, rng, smi)
        torch.cuda.empty_cache()
    renderers = [prepare_renderer(w, channel_maps.STEREO, SAMPLE_RATE, BLOCK,
                                  device=dev) for w in wavs]

    def make_grouped(mesh):
        return StreamPool(POOL_LANES[1], SAMPLE_RATE, block_size=BLOCK,
                          mesh=mesh, device=None if mesh else dev, profiles=[
                              PoolProfile(renderers[bank], bench_eq_definition(
                                  GROUPED_EQ_SCALES[g]))
                              for g, bank in enumerate(GROUPED_BANKS)])

    def control_grouped(pool, r):
        if r == MESH_POOL_ROUNDS[1] // 3:
            pool.set_equalizer(bench_eq_definition(GROUPED_EQ_SCALES[-1]),
                               group=1)
        if r == 2 * MESH_POOL_ROUNDS[1] // 3:
            pool.set_renderer(renderers[1], group=0)

    out["mesh_pool_grouped"] = mesh_pool_part(
        "pool_grouped", make_grouped, POOL_LANES[1], 1, MESH_GROUPED_SHARDS,
        control_grouped, rng, smi)
    torch.cuda.empty_cache()
    return out


def mesh_speaker_part(wav, dev: torch.device, rng: np.random.Generator,
                      smi: str) -> dict:
    """The 7.1.4 renderer's 8 resolved speakers over a (2 streams x 4
    speakers) mesh at B=8192 with the 10-filter EQ, against the unsharded
    chain_step_fn, step by step, and one step of each in CUDA-event time,
    in turns."""
    renderer = prepare_renderer(wav, channel_maps.ATMOS_7_1_4, SAMPLE_RATE,
                                BLOCK, device=dev)
    S, B = renderer.num_speakers, SPEAKER_LANES
    if S != 8:
        raise AssertionError(f"7.1.4 resolved {S} speakers, expected 8")
    devices = mesh_devices(int(np.prod(SPEAKER_MESH)))
    preamp, coeffs = bench_eq()
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 31)))
    with torch.inference_mode():
        conv = renderer.conv_params
        eq = eq_block.make_eq_params(coeffs, preamp, BLOCK, device=dev)
        x = torch.randn((SPEAKER_STEPS, B, S, BLOCK), generator=gen,
                        device=dev) * 0.25

        def fresh():
            return ChainState(
                conv=upols.make_conv_state(B, S, renderer.partition_count,
                                           BLOCK, dev),
                eq=eq_block.make_eq_state(B, device=dev))

        ops = make_chain_operands(conv, None, 1, upols.padded_bin_count(BLOCK))
        mesh = pmesh.make_mesh(devices, ("streams", "speakers"),
                               shape=SPEAKER_MESH)
        step = pmesh.stream_speaker_sharded_step(mesh, 960)
        sharded, plain = fresh(), fresh()
        ys = []
        mk.reset_launch_count()
        with CheckedMacs("mesh_speakers") as checked:
            for n in range(SPEAKER_STEPS):
                sharded, y = step(conv, eq, eq, sharded, x[n])
                ys.append(y.gather("cpu").numpy())
        launches = launches_now()
        errs = []
        for n in range(SPEAKER_STEPS):
            plain, want = chain_step_fn(conv, eq, eq, plain, x[n], 960, True,
                                        True, True, ops)
            errs.append(rel_rms(ys[n], want.cpu().numpy()))

        def sharded_step():
            nonlocal sharded
            sharded, _ = step(conv, eq, eq, sharded, x[0])

        def plain_step():
            nonlocal plain
            plain, _ = chain_step_fn(conv, eq, eq, plain, x[0], 960, True,
                                     True, True, ops)

        turns = [cuda_ms(f, MESH_TIMED_STEPS)
                 for f in (plain_step, sharded_step, sharded_step, plain_step)]
        # Where the sharded step's card time goes (for the record).
        profile = traced(sharded_step, 1, "mac_kmajor")
        del x, sharded, plain
    torch.cuda.empty_cache()
    R = 2 * renderer.partition_count * S // SPEAKER_MESH[1]
    result = dict(part="speakers_7_1_4", card=smi, **mesh_fields(devices),
                  mesh_shape=list(SPEAKER_MESH), batch=B, speakers=S,
                  speaker_shard_R=R, steps=SPEAKER_STEPS, launches=launches,
                  rel_rms_vs_unsharded=errs,
                  step_ms_sharded=(turns[1] + turns[2]) / 2,
                  step_ms_sharded_turns=turns[1:3],
                  step_ms_unsharded=(turns[0] + turns[3]) / 2,
                  step_ms_unsharded_turns=[turns[0], turns[3]],
                  sharded_step_profile=profile)
    phase("mesh", **result)
    if not max(errs) <= CHAIN_TOL:
        raise AssertionError(f"mesh speakers: rel-RMS {errs} > {CHAIN_TOL}")
    # Each step: one launch per speaker shard.
    want = SPEAKER_STEPS * int(np.prod(SPEAKER_MESH))
    if launches["mac_kmajor"]["total"] != want:
        raise AssertionError(f"mesh speakers: launches {launches}, expected "
                             f"{want} of mac_kmajor")
    return {"launches": totals(launches), "checks": checked.cases()}


MULTIHOST_WORKER = os.path.join(REPO, "tests", "_torch_multihost_worker.py")


def start_multihost(dev: torch.device, directory: str) -> tuple:
    """Start tests/_torch_multihost_worker.py as two gloo processes on
    `dev` writing into `directory`; returns (processes, start time)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, MULTIHOST_WORKER, f"127.0.0.1:{port}", "2", str(pid),
         directory, str(dev), str(MULTIHOST_LANES), str(BLOCK),
         str(HRIR_TAPS)], cwd=REPO, env=child_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    return procs, time.perf_counter()


def stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def mesh_multihost_part(started: tuple, directory: str, dev: torch.device,
                        smi: str) -> dict:
    """The two processes of start_multihost (2 virtual shards of `dev`
    each, MULTIHOST_LANES lanes in all): host_shard_spec, make_global_array
    and the stream-sharded step, then a speaker-sharded step whose rows
    span both processes; the union of their rows against one process
    within 1e-5, and every MAC launch of theirs, held against its plain
    version in the process, within KERNEL_TOL."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("multihost_worker",
                                                  MULTIHOST_WORKER)
    wk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wk)
    procs, t0 = started
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        stop(procs)
    for p, (_, err) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"multihost worker exited {p.returncode}: "
                                 f"{err[-2000:]}")
    seconds = time.perf_counter() - t0
    data = []
    for pid in range(2):
        with np.load(os.path.join(directory, f"out_{pid}.npz")) as f:
            data.append({k: f[k] for k in f.files})
    B, T = MULTIHOST_LANES, BLOCK
    hrir, x = wk.build_inputs(B, T, HRIR_TAPS)
    got = np.zeros((wk.N_BLOCKS, B, EARS, T), np.float32)
    covered = np.zeros(B, bool)
    for d in data:
        covered[int(d["start"]):int(d["start"]) + int(d["count"])] = True
        for key, rows in d.items():
            if key.startswith("block"):
                blk, row = key.replace("block", "").split("_row")
                got[int(blk), int(row):int(row) + rows.shape[0]] = rows
    with torch.inference_mode():
        conv = upols.make_conv_params(hrir, T, pad_to_pow2=False, device=dev)
        preamp, coeffs = bd.design_cascade(bd.EqualizerDefinition(-3.0),
                                           SAMPLE_RATE)
        eq = eq_block.make_eq_params(coeffs, preamp, T, device=dev)

        def fresh():
            return ChainState(
                conv=upols.make_conv_state(B, wk.S, conv.partition_count, T,
                                           dev),
                eq=eq_block.make_eq_state(B, device=dev))

        streams, speakers = fresh(), fresh()
        errs, speaker_errs = [], []
        for i in range(wk.N_BLOCKS):
            xi = torch.from_numpy(x[i]).to(dev)
            streams, y = chain_step_fn(conv, eq, eq, streams, xi, 960, True,
                                       True, False)
            errs.append(rel_rms(got[i], y.cpu().numpy()))
            speakers, y = chain_step_fn(conv, eq, eq, speakers, xi, 960, True,
                                        True, True)
            speaker_errs += [rel_rms(d[f"speakers{i}"], y.cpu().numpy())
                             for d in data]
    launches = {key: [int(d[key]) for d in data]
                for key in ("launches_streams", "launches_speakers")}
    checks, checked = [], {key: [] for key in launches}
    for pid, d in enumerate(data):
        for step in ("streams", "speakers"):
            cases = json.loads(str(d[f"mac_checks_{step}"]))
            checks += [dict(kernel="mac_kmajor",
                            case=f"mesh_multihost process {pid} {step} "
                                 f"{shape}", **c)
                       for shape, c in cases.items()]
            checked[f"launches_{step}"].append(
                sum(c["launches"] for c in cases.values()))
    result = dict(part="multihost", card=smi, processes=2, backend="gloo",
                  shards_per_process=2, batch=B, block=T, hrir_taps=HRIR_TAPS,
                  seconds_with_serve_part=seconds,
                  covered=bool(covered.all()), rel_rms_streams=errs,
                  rel_rms_speakers=speaker_errs, launches=launches,
                  checked_launches=checked, mac_checks=checks)
    phase("mesh", **result)
    bad = [c for c in checks if not c["rel_rms"] <= KERNEL_TOL]
    if bad:
        raise AssertionError(f"multihost: MAC launches against the plain "
                             f"version above {KERNEL_TOL}: {bad}")
    if checked != launches:
        raise AssertionError(f"multihost: checked launches {checked}, "
                             f"launched {launches}")
    if not covered.all():
        raise AssertionError("multihost: the processes left lanes uncovered")
    if not max(errs + speaker_errs) <= CHAIN_TOL:
        raise AssertionError(f"multihost: rel-RMS {errs} {speaker_errs} > "
                             f"{CHAIN_TOL}")
    # Each process: 2 stream shards a block; one speaker shard of each of
    # its 2 rows a block.
    want = {"launches_streams": [2 * wk.N_BLOCKS] * 2,
            "launches_speakers": [2 * wk.N_BLOCKS] * 2}
    if launches != want:
        raise AssertionError(f"multihost: launches {launches}, expected {want}")
    return {"launches": {"mac_kmajor": sum(map(sum, launches.values())),
                         "mac_kmajor_pages": 0}, "checks": checks}


def mesh_serve_part(files: ServeFiles, rng: np.random.Generator,
                    smi: str) -> None:
    """`serve --mesh-devices 1` as a process answers one client (within
    1e-5 of float64 past the EQ's ramp); `--mesh-devices N` with one card
    more than are visible exits with the JAX CLI's error."""
    x = rng.standard_normal((SPEAKERS, MESH_SERVE_FRAMES),
                            dtype=np.float32) * 0.25
    inp = os.path.join(files.dir, "mesh-in.wav")
    outp = os.path.join(files.dir, "mesh-out.wav")
    wavio.save(inp, x, SAMPLE_RATE)
    serve = ["--hrir", files.hrir, "--eq", files.eq, "--port", "0",
             "--max-streams", "8", "--mesh-devices", "1"]
    proc = ServeProcess(serve, os.path.join(files.dir, "mesh-serve.err"))
    try:
        ready = proc.ready()
        host, port = ready["listening"]
        client = run_cli("client", "--input", inp, "--output", outp,
                         "--host", host, "--port", str(port))
        rc = proc.interrupt()
    finally:
        proc.close()
    y = wavio.load(outp).audio
    skip = EQ_RAMP + BLOCK
    err = rel_rms(y[:, skip:], files.reference(x)[:, skip:])
    too_many = torch.cuda.device_count() + 1
    refused = subprocess.run(
        [sys.executable, "-m", "airwave_tpu_torch", "serve", "--hrir",
         files.hrir, "--port", "0", "--mesh-devices", str(too_many)],
        cwd=REPO, env=child_env(), capture_output=True, text=True, timeout=240)
    message = f"--mesh-devices {too_many}: only {too_many - 1} devices visible"
    phase("mesh", part="serve", card=smi, listening=ready, client=client,
          client_rel_rms_past_ramp=err, exit=rc,
          refused_mesh_devices=too_many, refused_exit=refused.returncode,
          refused_error=refused.stderr.strip().splitlines()[-1:])
    if ready["mesh_devices"] != 1 or rc or client["truncated"]:
        raise AssertionError(f"mesh serve: {ready}, exit {rc}, {client}")
    if not err <= CHAIN_TOL:
        raise AssertionError(f"mesh serve: client rel-RMS {err} > {CHAIN_TOL}")
    if refused.returncode == 0 or message not in refused.stderr:
        raise AssertionError(f"mesh serve: --mesh-devices {too_many} did not "
                             f"exit with '{message}': {refused.stderr[-800:]}")


def mesh_phase(wavs, files: ServeFiles, dev: torch.device,
               rng: np.random.Generator, smi: str) -> tuple:
    """The five parts of the mesh phase; returns (launches by path, the
    shards' MAC checks)."""
    t0 = time.perf_counter()
    parts = {"mesh_bake": mesh_bake_part(rng, dev, smi)}
    parts.update(mesh_pools(wavs, dev, rng, smi))
    parts["mesh_speakers"] = mesh_speaker_part(wavs[0], dev, rng, smi)
    # The two processes start while the serve part runs (neither is timed).
    with tempfile.TemporaryDirectory() as tmp:
        started = start_multihost(dev, tmp)
        try:
            mesh_serve_part(files, rng, smi)
        except BaseException:
            stop(started[0])
            raise
        parts["mesh_multihost"] = mesh_multihost_part(started, tmp, dev, smi)
    phase("mesh", part="done", card=smi, seconds=time.perf_counter() - t0)
    launches = {path: p["launches"] for path, p in parts.items()}
    checks = [c for p in parts.values() for c in p.get("checks", [])]
    return launches, checks


def free_device_memory() -> None:
    """Drop what earlier phases left for the collector and return the
    cached blocks, so a phase's peak is its own."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def settle_rounds(M: int) -> int:
    """Rounds of soak_tool.settle_eq at tier M (one MAC launch each)."""
    return -(-EQ_RAMP // (M * BLOCK)) + 1


def soak_launches(result: dict, M: int) -> dict:
    """The launches a soak of `result` makes, the pool's settle rounds
    included: one of the tier's kernel per round."""
    calls = result["calls"] + 2  # the warm-up and the baseline call too
    used = "mac_kmajor_pages" if M > 1 else "mac_kmajor"
    rounds = settle_rounds(M) + calls * result["blocks_per_call"] // M
    return {name: rounds if name == used else 0 for name in KERNELS}


def check_soak(label: str, result: dict, M: int, launches=None) -> None:
    """A soak result passed (finite, no drift, no growth of live device
    tensors) and, where `launches` are given, launched the tier's kernel
    once per round."""
    if not result.get("pass"):
        raise AssertionError(f"{label}: soak failed: {result}")
    if not 0.5 < result["output_drift_ratio"] < 2.0:
        raise AssertionError(f"{label}: drift {result['output_drift_ratio']}")
    for key in ("device_requested_bytes", "device_live_allocations"):
        if result[f"{key}_end"] > result[f"{key}_baseline"]:
            raise AssertionError(f"{label}: {key} grew: {result}")
    expected = soak_launches(result, M)
    if launches is not None and launches != expected:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expected} (one per round)")


def soak_phase(dev: torch.device, smi: str) -> tuple:
    """tools/soak on both tiers at full width: the ring tier (8192 lanes)
    through the tool's CLI as a child process (`python -m
    airwave_tpu_torch.tools.soak --seconds SOAK_SECONDS --batch 8192`), the
    paged tier (16384 lanes, M=8) in process through soak_tool.soak, each
    for SOAK_SECONDS on the 4320-tap bank and the 10-filter EQ. Each must
    pass (every checksum finite, drift ratio in (0.5, 2.0)), keep its live
    device tensors flat from the baseline call to the window's end and launch
    its kernel once per round. Then one more call on the soaked paged carry
    under CheckedMacs. Returns (launches by path, the checked cases)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "airwave_tpu_torch.tools.soak", "--seconds",
         str(SOAK_SECONDS), "--batch", str(POOL_LANES[1])],
        cwd=REPO, env=child_env(), capture_output=True, text=True,
        timeout=SOAK_SECONDS + 300)
    if proc.returncode != 0:
        raise AssertionError(f"soak (ring) exited {proc.returncode}: "
                             f"{proc.stdout[-1500:]}{proc.stderr[-1500:]}")
    ring = json.loads(proc.stdout.splitlines()[-1])
    ring_seconds = time.perf_counter() - t0
    check_soak("soak (ring)", ring, 1, ring["launches"])

    t1 = time.perf_counter()
    M = BLOCKS_PER_STEP
    mk.reset_launch_count()
    free_device_memory()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pool = soak_tool.build_pool(POOL_LANES[M], blocks_per_step=M, device=dev)
    x = soak_tool.device_input(pool)
    paged = soak_tool.soak(pool, x, SOAK_SECONDS, SOAK_BLOCKS_PER_CALL)
    launches = {name: mk.launch_count(name) for name in KERNELS}
    paged_seconds = time.perf_counter() - t1
    paged_peak = torch.cuda.max_memory_allocated() - base
    check_soak("soak (paged)", paged, M, launches)
    with CheckedMacs("soak_paged") as checked:
        acc = soak_tool.make_call(pool, x, SOAK_BLOCKS_PER_CALL)()
        finite = bool(torch.isfinite(acc).all())
    del pool, x, acc
    torch.cuda.empty_cache()
    phase("soak", card=smi, seconds=time.perf_counter() - t0,
          window_seconds=SOAK_SECONDS, ring=ring, ring_seconds=ring_seconds,
          paged=paged, paged_launches=launches, paged_seconds=paged_seconds,
          paged_peak_bytes=paged_peak,
          checked_call_finite=finite, checked_launches=checked.launches)
    if not finite:
        raise AssertionError("soak (paged): the checked call is not finite")
    return ({"soak_ring": ring["launches"], "soak_paged": launches},
            checked.cases())


def steady_capacity_phase(wav, dev: torch.device, calibrations: dict,
                          smi: str) -> tuple:
    """The planner's steady-only capacity on the card: for each tier, the
    plan for PLANNER_HBM with the planner phase's calibration
    (calibrations[M]) gives max_streams_steady; a pool that never swaps is
    built at that width (make_pool, the calibration's bank and EQ), its EQ
    ramp settled and soaked for STEADY_SOAK_SECONDS through soak_tool.soak.
    Its peak (device bytes above the allocation before it was built) must be
    at most 0.85 * PLANNER_HBM, and the steady estimate (the steady round's
    fixed bytes plus its per-lane bytes times the lanes) over the peak at
    most 1.3: the limits the planner phase holds max_streams to. Then a
    reset swap (set_renderer(crossfade=False) onto the same bank, which
    zeroes the carry in place) and one round, whose peak must stay under
    0.85 * PLANNER_HBM too, and one more round under CheckedMacs. Returns
    (the path's launches, the checked cases)."""
    t0 = time.perf_counter()
    mk.reset_launch_count()
    checked = CheckedMacs("steady_capacity")
    tiers = {}
    for M in (1, BLOCKS_PER_STEP):
        cal = calibrations[M]
        plan = memory_planner.pool_capacity(
            SPEAKERS, HRIR_TAPS, BLOCK, lookahead=M, hbm_bytes=PLANNER_HBM,
            calibration=cal)
        n = plan["max_streams_steady"]
        steady = cal["rounds"]["steady"]
        estimate = steady["fixed_bytes"] + steady["per_lane_bytes"] * n
        free_device_memory()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        pool = make_pool(wav, n, M, dev, bench_eq_definition())
        soak_tool.settle_eq(pool)
        x = soak_tool.device_input(pool)
        result = soak_tool.soak(pool, x, STEADY_SOAK_SECONDS,
                                STEADY_BLOCKS_PER_CALL)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        seconds = time.perf_counter() - t1
        # A reset swap (crossfade=False onto the same-shape bank zeroes the
        # carry in place) and one round on the zeroed carry, at the plan.
        torch.cuda.reset_peak_memory_stats()
        pool.set_renderer(pool.renderers[0], crossfade=False)
        soak_tool.make_call(pool, x, M)()
        torch.cuda.synchronize()
        reset_peak = torch.cuda.max_memory_allocated() - base
        with checked:
            acc = soak_tool.make_call(pool, x, M)()
            finite = bool(torch.isfinite(acc).all())
        del pool, x, acc
        torch.cuda.empty_cache()
        tiers["ring" if M == 1 else "paged"] = dict(
            max_streams_steady=n, max_streams=plan["max_streams"],
            steady_per_lane_bytes=steady["per_lane_bytes"],
            steady_fixed_bytes=steady["fixed_bytes"], peak_bytes=peak,
            steady_estimate_bytes=estimate, estimate_over_peak=estimate / peak,
            peak_over_budget=peak / PLANNER_HBM, soak=result,
            reset_swap_peak_bytes=reset_peak,
            reset_swap_peak_over_budget=reset_peak / PLANNER_HBM,
            checked_round_finite=finite, seconds=seconds)
    launched = {name: mk.launch_count(name) - checked.launches[name]
                for name in KERNELS}
    phase("steady_capacity", card=smi, seconds=time.perf_counter() - t0,
          hbm_budget_bytes=PLANNER_HBM, window_seconds=STEADY_SOAK_SECONDS,
          launches=launched, checked_launches=checked.launches, **tiers)
    for tier, t in tiers.items():
        M = 1 if tier == "ring" else BLOCKS_PER_STEP
        if not t["peak_bytes"] <= 0.85 * PLANNER_HBM:
            raise AssertionError(f"steady_capacity ({tier}): peak "
                                 f"{t['peak_bytes']} over 0.85 x {PLANNER_HBM}")
        if not t["reset_swap_peak_bytes"] <= 0.85 * PLANNER_HBM:
            raise AssertionError(f"steady_capacity ({tier}): the reset swap "
                                 f"peaks at {t['reset_swap_peak_bytes']}, "
                                 f"over 0.85 x {PLANNER_HBM}")
        if not t["estimate_over_peak"] <= 1.3:
            raise AssertionError(f"steady_capacity ({tier}): estimate over "
                                 f"peak {t['estimate_over_peak']} > 1.3")
        if not t["checked_round_finite"]:
            raise AssertionError(f"steady_capacity ({tier}): not finite")
        check_soak(f"steady_capacity ({tier})", t["soak"], M)
    # Each tier's soak, and its one round after the reset swap.
    expected = {name: sum(soak_launches(t["soak"], 1 if tier == "ring"
                                        else BLOCKS_PER_STEP)[name]
                          for tier, t in tiers.items()) + 1
                for name in KERNELS}
    if launched != expected:
        raise AssertionError(f"steady_capacity: launches {launched}, "
                             f"expected {expected}")
    return launched, checked.cases()


def checkpoint_scale_phase(dev: torch.device, smi: str) -> dict:
    """tools/checkpoint_scale at B=16384, M=8 (the 4320-tap bank) into a
    temporary directory: the pump stall (snapshot(materialize=False) and a
    synchronize), the readback, the atomic write, the load into a fresh
    pool and the restore, each timed, and the round trip bit for bit.
    Returns the path's launches (its one warm round)."""
    t0 = time.perf_counter()
    mk.reset_launch_count()
    free_device_memory()
    with tempfile.TemporaryDirectory() as tmp:
        result = checkpoint_scale.measure(
            batch=BATCH, blocks_per_step=BLOCKS_PER_STEP,
            out=os.path.join(tmp, "pool"), device=dev)
        left = os.listdir(tmp)
    launches = {name: mk.launch_count(name) for name in KERNELS}
    torch.cuda.empty_cache()
    phase("checkpoint_scale", card=smi, seconds=time.perf_counter() - t0,
          **result, launches=launches)
    if not result["roundtrip_exact"]:
        raise AssertionError("checkpoint_scale: the round trip is not exact")
    if left:
        raise AssertionError(f"checkpoint_scale: files left behind: {left}")
    if launches != {"mac_kmajor": 0, "mac_kmajor_pages": 1}:
        raise AssertionError(f"checkpoint_scale: launches {launches}, "
                             f"expected one mac_kmajor_pages (the warm round)")
    return launches


def profile_chain_phase(smi: str) -> tuple:
    """tools/profile_chain at the headline bake (B=16384, M=8) and both
    pool tiers (ring 8192 lanes, paged 16384 lanes with M=8): per path, its
    warm-up call under CheckedMacs (a sample of PROFILE_CHECKED launches a
    shape), then tools/profile_chain.profile of PROFILE_CALLS calls of
    PROFILE_BLOCKS blocks. Each path's rows (CUDA kernels by device time)
    must name its MAC kernel and count every launch of it in the traced
    calls (the trace taken again while it drops records, up to
    TRACE_ATTEMPTS in all, as in complete_trace), the bake's also its
    GEMMs. Returns (launches by path, the
    checked cases)."""
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    launches, checks = {}, []
    for path, (pool, M, batch) in PROFILE_PATHS.items():
        free_device_memory()
        mk.reset_launch_count()
        call, blocks = profile_chain.build_call(batch, PROFILE_BLOCKS, M,
                                                pool=pool, device=dev)
        with CheckedMacs(path, limit=PROFILE_CHECKED) as checked:
            call().to("cpu")  # the warm-up, outside the trace
        kernel = "mac_kmajor_pages" if M > 1 else "mac_kmajor"
        want = PROFILE_CALLS * blocks // M
        held = []  # traced launches of each attempt (see complete_trace)
        while len(held) < TRACE_ATTEMPTS and want not in held:
            with tempfile.TemporaryDirectory() as tmp:
                result = profile_chain.profile(call, dev, PROFILE_CALLS,
                                               blocks, logdir=tmp)
                trace_bytes = os.path.getsize(os.path.join(tmp, "trace.json"))
            rows = result["rows"]
            mac_rows = [count for name, _, count in rows
                        if kernel in name and (M > 1 or "pages" not in name)]
            held.append(sum(mac_rows))
        del call
        launches[path] = counts_now()
        checks += checked.cases()
        phase("profile_chain", card=smi, path=path, batch=batch,
              blocks_per_step=M, blocks=blocks, calls=PROFILE_CALLS,
              sum_listed_ms_per_block=result["sum_listed_ms_per_block"],
              device_ms_per_block=result["device_ms_per_block"],
              trace_bytes=trace_bytes, launches=launches[path],
              traced_mac_launches=sum(mac_rows), expected_traced=want,
              trace_attempts=len(held), traced_by_attempt=held,
              checked_launches=checked.launches,
              top_rows=[[name[:110], us / 1e3 / result["blocks_total"],
                         count] for name, us, count in rows[:PROFILE_TOP]])
        if sum(mac_rows) != want:
            raise AssertionError(f"{path}: the trace holds {sum(mac_rows)} "
                                 f"{kernel} launches of {want}")
        if not pool and not any("gemm" in name.lower() for name, _, _ in rows):
            raise AssertionError(f"{path}: no GEMM row in the profile")
    torch.cuda.empty_cache()
    phase("profile_chain", card=smi, seconds=time.perf_counter() - t0)
    return launches, checks


def fade_on_audio(pool: StreamPool, swaps) -> None:
    """After a serving soak (its server stopped): one lane of each group
    streams a round, then every group swaps to its first swap target
    (crossfaded) and the lanes stream the fade round. The soak's swaps land
    as clients connect, so its few fade rounds may see only silent delay
    lines; this one gives each group's fade MAC audio to be checked on."""
    rng = np.random.default_rng(FADE_CHECK_SEED)
    lanes = [pool.attach(g) for g in range(pool.groups)]
    S, T = pool.renderer.num_speakers, pool.step_frames
    for swap in (False, True):
        if swap:
            for g in range(pool.groups):
                pool.set_renderer(swaps[g][0], group=g)
        pool.push_many(lanes, (rng.standard_normal((len(lanes), S, T))
                               * 0.3).astype(np.float32))
        pool.pump()
        pool.pull_many(lanes, T)
    for lane in lanes:
        pool.detach(lane)


def serve_soak_phase(wav, short, dev: torch.device, smi: str) -> tuple:
    """tools/serve_soak on the card at the serve phases' width (SERVE_LANES
    lanes, block 512) for SERVE_SOAK_SECONDS a tier: the ring tier (M=1) as
    a grouped two-profile pool (the 4320-tap bank `wav` and the
    SHORT_TAPS-tap `short`) and the paged tier (M=8) on `wav`, under the
    test's churn (ragged clients, slow readers, EQ retargets, crossfaded
    hot-swaps). Each must pass every criterion of tests/test_soak.py, with
    its live device tensors flat; each window's MAC launches, and those of
    a fade round on audio after it (fade_on_audio), run under CheckedMacs,
    a sample of SERVE_SOAK_CHECKED a shape. Returns (launches by path, the
    checked cases)."""
    t0 = time.perf_counter()
    launches, checks = {}, []
    for path, M, banks in (("serve_soak_ring", 1, [wav, short]),
                           ("serve_soak_paged", BLOCKS_PER_STEP, [wav])):
        free_device_memory()
        t1 = time.perf_counter()
        pool, swaps = serve_soak.build(banks, SERVE_LANES, BLOCK, M, dev)
        setup = time.perf_counter() - t1
        mk.reset_launch_count()
        with CheckedMacs(path, limit=SERVE_SOAK_CHECKED) as checked:
            result = serve_soak.soak(pool, swaps, SERVE_SOAK_SECONDS,
                                     np.random.default_rng(23))
            fade_on_audio(pool, swaps)
        launches[path] = counts_now()
        by_columns = {f"{name} O={o}": mk.launch_count(name, columns=o)
                      for name in KERNELS for o in (4, 8, 32, 64)
                      if mk.launch_count(name, columns=o)}
        checks += checked.cases()
        del pool, swaps
        phase("serve_soak", card=smi, path=path, setup_seconds=setup,
              launches=launches[path], launches_by_columns=by_columns,
              checked_launches=checked.launches, **result)
        if not result["pass"]:
            raise AssertionError(f"{path}: {result.get('failures')}")
        if ("device_requested_bytes_baseline" not in result
                or result["waves"] < 7):
            raise AssertionError(f"{path}: the window ended before the "
                                 f"live-tensor baseline (wave 7)")
        kernel = "mac_kmajor_pages" if M > 1 else "mac_kmajor"
        if not launches[path][kernel] or sum(
                by_kernel(launches[path]).values()) != launches[path][kernel]:
            raise AssertionError(f"{path}: launches {launches[path]}")
    torch.cuda.empty_cache()
    phase("serve_soak", card=smi, seconds=time.perf_counter() - t0)
    return launches, checks


def serve_scale_phase(dev: torch.device, smi: str) -> tuple:
    """tools/serve_scale on the card: SERVE_SCALE_CLIENTS realtime loadgen
    clients (a child process) against the in-process server on a ring pool
    of clients + 8 lanes (the script's 300-tap bank), every client
    complete and no server error; its MAC launches under CheckedMacs, a
    sample of SERVE_SOAK_CHECKED a shape. Returns (the path's launches, the checked cases)."""
    t0 = time.perf_counter()
    free_device_memory()
    args = serve_scale.build_parser().parse_args(
        ["--clients", str(SERVE_SCALE_CLIENTS)])
    mk.reset_launch_count()
    with CheckedMacs("serve_scale", limit=SERVE_SOAK_CHECKED) as checked:
        result = serve_scale.measure(args, dev)
    launches = counts_now()
    phase("serve_scale", card=smi, seconds=time.perf_counter() - t0,
          launches=launches, checked_launches=checked.launches, **result)
    load, server = result["load"], result["server"]
    if load["completed"] != SERVE_SCALE_CLIENTS or load["failed"]:
        raise AssertionError(f"serve_scale: {load}")
    if any(server[k] for k in ("protocol_errors", "pump_errors",
                               "rejected_full", "truncated_closes")):
        raise AssertionError(f"serve_scale: server errors {server}")
    if not launches["mac_kmajor"] or launches["mac_kmajor_pages"]:
        raise AssertionError(f"serve_scale: launches {launches}")
    return launches, checked.cases()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--baseline", action="append", default=[], metavar="LABEL=SOURCE",
        help="another mac_kmajor.cu (an earlier commit's), or the root of a "
             "checkout of that commit, whose mac_kmajor_pages and mac_kmajor "
             "every paged and single-block kernel case must equal bit for "
             "bit and is timed in turns with, as are the paged capacity "
             "pool's device rounds (and, for a checkout, its mac_kmajor "
             "wrapper's host time); may be repeated")
    parser.add_argument(
        "--split", action="store_true",
        help="also time, at every paged kernel case, this mac_kmajor.cu "
             "built with MAC_PAGES_SPLIT=1 (no FMAs) and =2 (no row copies): "
             "which side of its pipeline bounds the case (their sums are "
             "wrong)")
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the kernel phase (and the baseline "
                             "rounds); print no result line")
    parser.add_argument("--precision-child", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.precision_child:
        precision_child(args.seed)
        return
    others = dict(label_source.split("=", 1) for label_source in args.baseline)
    others = {label: (source, ()) for label, source in others.items()}
    if args.split:
        source = str(_build.CSRC_DIR / mk.SOURCE)
        others.update(no_fma=(source, ("MAC_PAGES_SPLIT=1",)),
                      no_copy=(source, ("MAC_PAGES_SPLIT=2",)))

    t_start = time.perf_counter()
    smi = device_phase()
    dev = torch.device("cuda", 0)
    runs = build_phase(others)
    rng = np.random.default_rng(args.seed)
    cases = kernel_phase(rng, dev, {label: (run, not others[label][1])
                                    for label, run in runs.items()})
    baselines = {label: runs[label] for label in runs if not others[label][1]}
    roots = {label: source for label, (source, defines) in others.items()
             if not defines and os.path.isdir(source)}
    if roots:
        wrapper_phase(roots, smi)
    if baselines:
        with tempfile.TemporaryDirectory() as tmp:
            baseline_rounds_phase(hrir_wav(args.seed, tmp), dev, baselines,
                                  smi)
    if args.kernels_only:
        phase("done", seconds=time.perf_counter() - t_start)
        return
    launches = bake_phase(rng, dev)
    peaks = {"bake": timing_phase(args.seed, dev, smi)}
    precision_phase(args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        wav = hrir_wav(args.seed, tmp)
    for label, M in (("pool", 1), ("pool_paged", BLOCKS_PER_STEP)):
        pool, base, launches[label] = pool_phase(label, wav, dev, M, rng)
        peaks[M] = pool_timing_phase(pool, base, smi)
        del pool, base
        torch.cuda.empty_cache()
    pool_retarget_phase(wav, dev, rng)
    with tempfile.TemporaryDirectory() as tmp:
        swap = [hrir_wav(args.seed + i, tmp) for i in (1, 2)]
        short = hrir_wav(args.seed + 3, tmp, SHORT_TAPS)
    hotswap = {
        "engine_hotswap": engine_hotswap_phase([wav, *swap], dev, rng, smi),
        "pool_ring_hotswap": pool_hotswap_phase(
            "hotswap_pool", [wav, swap[0]], dev, 1, rng, smi),
        "pool_paged_hotswap": pool_hotswap_phase(
            "hotswap_pool_paged", [wav, swap[0], short], dev, BLOCKS_PER_STEP,
            rng, smi),
    }
    checkpoints = checkpoint_phase(wav, dev, rng, smi)
    with tempfile.TemporaryDirectory() as tmp:
        short2 = hrir_wav(args.seed + 4, tmp, SHORT_TAPS)
    grouped_wavs = [wav, swap[0], short, short2, swap[1]]
    for label, M in (("pool_grouped", 1),
                     ("pool_grouped_paged", BLOCKS_PER_STEP)):
        launches[label] = pool_grouped_phase(label, grouped_wavs, dev, M, rng,
                                             smi)
    with tempfile.TemporaryDirectory() as tmp:
        files = ServeFiles(tmp, wav, args.seed)
        ring_server, launches["serve_ring"] = serve_phase(
            "serve_ring", files, 1, args.seed, rng, smi)
        serve_checkpoint_phase(ring_server, files, rng, smi)
        del ring_server
        _, launches["serve_paged"] = serve_phase(
            "serve_paged", files, BLOCKS_PER_STEP, args.seed + 1, rng, smi)
        cli_phase(files, rng, smi)
        serve_grouped_phase(files, swap[0], rng, smi)
        launches.update(render_phase(files, rng, smi))
        presets_phase(files, smi)
    launches.update(demo_phase(rng, smi))
    launches.update(feeder_phase(wav, dev, args.seed, smi))
    with CheckedMacs("migration") as checked:
        launches["migration"] = migration_phase(wav, dev, rng, smi)
    launches["planner"], planner_checks, calibrations = planner_phase(
        wav, dev, peaks, smi)
    launches["steady_capacity"], steady_checks = steady_capacity_phase(
        wav, dev, calibrations, smi)
    with tempfile.TemporaryDirectory() as tmp:
        mesh_launches, mesh_checks = mesh_phase(
            [wav, swap[0], short, short2, swap[1]],
            ServeFiles(tmp, wav, args.seed), dev, rng, smi)
    soak_launches_by_path, soak_checks = soak_phase(dev, smi)
    launches.update(soak_launches_by_path)
    launches["checkpoint_scale"] = checkpoint_scale_phase(dev, smi)
    profile_launches, profile_checks = profile_chain_phase(smi)
    launches.update(profile_launches)
    serve_soak_launches, serve_soak_checks = serve_soak_phase(
        wav, short, dev, smi)
    launches.update(serve_soak_launches)
    launches["serve_scale"], serve_scale_checks = serve_scale_phase(dev, smi)
    path_checks = (checked.cases() + planner_checks + steady_checks
                   + mesh_checks + soak_checks + profile_checks
                   + serve_soak_checks + serve_scale_checks)
    phase("path_checks", tolerance_rel_rms=KERNEL_TOL, cases=path_checks)
    silent = [c["case"] for c in path_checks
              if not c["nonzero_reference_launches"]]
    if silent:
        raise AssertionError(f"path_checks: only silence checked at {silent}")
    phase("done", seconds=time.perf_counter() - t_start)

    paths = {"bake_paged": launches[BLOCKS_PER_STEP],
             "bake_single_block": launches[1],
             "pool_ring": launches["pool"],
             "pool_paged": launches["pool_paged"],
             **{path: launches[path] for path in (
                 "serve_ring", "serve_paged", "render_graph",
                 "render_throughput", "feeder_single_block", "feeder_paged",
                 "migration", "planner", "steady_capacity", "soak_ring",
                 "soak_paged", "checkpoint_scale", "profile_bake",
                 "profile_pool_ring", "profile_pool_paged",
                 "serve_soak_ring", "serve_soak_paged", "serve_scale")},
             **{path: {name: launches[path][name]["total"]
                       for name in KERNELS}
                for path in ("demo", "demo_cli")},
             **{path: {name: counts[name]["total"] for name in KERNELS}
                for path, counts in {
                    **hotswap, **checkpoints,
                    **{k: launches[k] for k in ("pool_grouped",
                                                "pool_grouped_paged")}}.items()},
             **mesh_launches}
    # The routes the in-process paths' launches took (mk.launch_routes; the
    # child processes' launches are counted by kernel only).
    recorded = {"bake_paged": launches[BLOCKS_PER_STEP],
                "bake_single_block": launches[1], "pool_ring": launches["pool"],
                "pool_paged": launches["pool_paged"], **launches,
                **hotswap, **checkpoints}
    # Each kernel's headline case: the single block at B=16384 (bake M=1)
    # and the fused 3 pages (bake M=8 and the paged pool).
    entries = []
    for name, function in (("mac_kmajor", None),
                           ("mac_kmajor_pages", PAGED_MAC_FUNCTION)):
        own = [c for c in cases if c["kernel"] == name]
        checks = [c for c in path_checks if c["kernel"] == name]
        main_case = own[0]
        by_path = {path: counts[name] for path, counts in paths.items()}
        by_route = {path: route_counts(recorded.get(path), name)
                    for path in paths
                    if route_counts(recorded.get(path), name)}
        entries.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES, "replaces_function": function,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_by_route": by_route,
            "max_abs_err": max(c["max_abs_err"] for c in own + checks),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"], "cases": own,
            "path_checks": checks,
        })
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
