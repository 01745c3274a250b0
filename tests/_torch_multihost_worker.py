"""Two-process multihost worker of the PyTorch port (spawned by
tests/test_torch_parallel.py, and by chip_smoke.py on the card).

Each process joins a torch.distributed gloo group, takes its devices (4
virtual shards of the CPU, or 2 of a card), builds the global stream mesh,
its HostShardSpec slice of a deterministic global batch (the JAX worker's,
tests/_multihost_worker.py), assembles its input with make_global_array,
runs the stream-sharded chain for a few blocks and writes its output rows.
Then it runs the speaker-sharded step on a (streams, speakers) mesh whose
every row holds one device of each process, so each block's downmix is an
all_reduce across the processes. The parent holds the union of both
processes' rows against one process. Every mac_kmajor launch of both steps
is held against the kernel's plain version on the same operands, and the
largest errors by shape go into the output with the launch counts.

Usage: python _torch_multihost_worker.py COORD NPROC PID OUTDIR
       [DEVICE [BATCH BLOCK TAPS]]
(DEVICE: cpu, the default, or cuda:N; the global batch, block size and
HRIR length default to the JAX worker's GLOBAL_BATCH, T and L)
"""

import contextlib
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GLOBAL_BATCH = 16
S, T, L, N_BLOCKS = 2, 8, 16, 3


def build_inputs(batch: int = GLOBAL_BATCH, block: int = T, taps: int = L):
    """Deterministic global problem, identical on every process (the JAX
    worker's at the default sizes)."""
    rng = np.random.default_rng(7)
    hrir = (rng.standard_normal((S, 2, taps)) * 0.3).astype(np.float32)
    x = (rng.standard_normal((N_BLOCKS, batch, S, block)) * 0.5).astype(
        np.float32
    )
    return hrir, x


@contextlib.contextmanager
def checked_macs(upols, mk, cases: dict):
    """While entered, every mac_kmajor call of ops.upols also computes
    mk.mac_kmajor_ref on the same operands (no launch). `cases` collects,
    by shape, the calls, those with a non-zero reference, and the largest
    absolute and rel-RMS errors."""
    kernel = upols.mac_kmajor

    def mac(fdl, h, out=None, **kw):
        if kw.get("accumulate"):
            raise AssertionError("checked_macs: accumulate is not checked")
        y = kernel(fdl, h, out=out, **kw)
        ref = mk.mac_kmajor_ref(fdl, h)
        diff = y - ref
        norm = torch.linalg.vector_norm(ref).item()
        max_abs = diff.abs().max().item()
        if norm:
            rel = torch.linalg.vector_norm(diff).item() / norm
        else:
            rel = 0.0 if max_abs == 0 else float("inf")
        K, R, B = fdl.shape
        case = cases.setdefault(f"K={K} R={R} O={h.shape[1]} B={B}", dict(
            launches=0, nonzero_reference_launches=0, max_abs_err=0.0,
            rel_rms=0.0))
        case["launches"] += 1
        case["nonzero_reference_launches"] += bool(norm)
        case["max_abs_err"] = max(case["max_abs_err"], max_abs)
        case["rel_rms"] = max(case["rel_rms"], rel)
        return y

    upols.mac_kmajor = mac
    try:
        yield cases
    finally:
        upols.mac_kmajor = kernel


def main() -> int:
    coord, nproc, pid, outdir = sys.argv[1:5]
    device = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    batch, block, taps = (int(a) for a in sys.argv[6:9] or
                          (GLOBAL_BATCH, T, L))
    from airwave_tpu_torch.io.apo import EqualizerDefinition
    from airwave_tpu_torch.kernels import mac_kmajor as mk
    from airwave_tpu_torch.models.binaural import ChainState
    from airwave_tpu_torch.ops import biquad_design as bd
    from airwave_tpu_torch.ops import eq_block, upols
    from airwave_tpu_torch.parallel import mesh as pmesh
    from airwave_tpu_torch.parallel import multihost as mh

    mh.initialize(coord, int(nproc), int(pid), backend="gloo")
    assert mh.process_count() == int(nproc), mh.process_count()
    per_process = 4 if device == "cpu" else 2
    mesh = mh.global_mesh(devices=[device] * per_process)
    assert mesh.size == per_process * int(nproc)

    hrir, x = build_inputs(batch, block, taps)
    dev = torch.device(device)
    conv_params = upols.make_conv_params(hrir, block, pad_to_pow2=False,
                                         device=dev)
    preamp, coeffs = bd.design_cascade(EqualizerDefinition(preamp_db=-3.0),
                                       48_000.0)
    eq_params = eq_block.make_eq_params(coeffs, preamp, block, device=dev)

    def make_state():
        return ChainState(
            conv=upols.make_conv_state(batch, S, conv_params.partition_count,
                                       block, dev),
            eq=eq_block.make_eq_state(batch, device=dev))

    spec = mh.host_shard_spec(batch, mesh)
    state = pmesh.shard_chain_state(make_state(), mesh)
    assert set(state.starts) <= set(range(spec.local_start,
                                          spec.local_start + spec.local_count))
    step = pmesh.stream_sharded_step(mesh, transition_length=960,
                                     eq_crossfading=False)
    out = {"start": spec.local_start, "count": spec.local_count}
    mk.reset_launch_count()
    with checked_macs(upols, mk, {}) as checks:
        for i in range(N_BLOCKS):
            xg = mh.make_global_array(x[i][spec.local_slice], spec, mesh)
            state, y = step(conv_params, eq_params, eq_params, state, xg)
            for start, rows in zip(y.starts, y.parts):
                out[f"block{i}_row{start}"] = rows.cpu().numpy()
    # mac_kmajor launches of each part (a CPU run launches none).
    out["launches_streams"] = mk.launch_count("mac_kmajor")
    out["mac_checks_streams"] = json.dumps(checks)
    del state

    # Streams x speakers with every row across the processes: row i holds
    # device i of each process, so the downmix all_reduces each block.
    n_proc = int(nproc)
    mesh2 = pmesh.Mesh(mesh.devices.reshape(n_proc, per_process).T,
                       ("streams", "speakers"),
                       mesh.process_index.reshape(n_proc, per_process).T)
    speaker_step = pmesh.stream_speaker_sharded_step(mesh2,
                                                     transition_length=960)
    state2 = make_state()
    mk.reset_launch_count()
    with checked_macs(upols, mk, {}) as checks:
        for i in range(N_BLOCKS):
            state2, y = speaker_step(conv_params, eq_params, eq_params,
                                     state2, torch.from_numpy(x[i]))
            out[f"speakers{i}"] = y.gather("cpu").numpy()
    out["launches_speakers"] = mk.launch_count("mac_kmajor")
    out["mac_checks_speakers"] = json.dumps(checks)

    np.savez(os.path.join(outdir, f"out_{pid}.npz"), **out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
