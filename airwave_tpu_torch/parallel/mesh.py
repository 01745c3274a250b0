"""Stream-sharded (and speaker-sharded) render over several devices.

Port of airwave_tpu/parallel/mesh.py. The natural axis is data parallelism
over streams: each stream's carry (delay line, EQ state) stays on its
shard's device, so the steady state moves no tensor between shards. Only a
sharded speaker axis needs a sum across shards (the binaural downmix adds
the speakers' partial mixes once per block).

A Mesh is an array of torch devices with axis names, the counterpart of
jax.sharding.Mesh. Devices may repeat: those are virtual shards, each with
its own carry, its own kernel launches and, on a card, its own CUDA stream
(the counterpart of the JAX tests' virtual CPU devices). Stream shard i of
a batch of B lanes holds lanes [i*B/n, (i+1)*B/n), the row-contiguous order
of NamedSharding(P("streams")).

Where XLA compiles one SPMD program, the port runs a Python loop over the
shards of this process, each shard's work on its device and stream. Sharded
values travel in a Sharded container (per-shard parts with their first
lanes, `gather(device)` for the whole); the step functions take either
such a container or a whole [B, ...] input and split it. Params are
replicated: one copy per distinct device, cached (Replicas).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from airwave_tpu_torch.device import apply_precision_policy, resolve_device
from airwave_tpu_torch.models.binaural import (ChainState, chain_step_fn,
                                               chain_step_multi_fn,
                                               make_chain_operands)
from airwave_tpu_torch.ops import eq_block, upols

STREAMS = "streams"
SPEAKERS = "speakers"


def process_index() -> int:
    """This process's rank in torch.distributed's default group, else 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices laid out on named axes. `devices` is an object array of
    torch.device (repeats allowed: virtual shards); `process_index` the
    same-shaped int array of the process that holds each device."""

    devices: np.ndarray
    axis_names: tuple
    process_index: np.ndarray

    @property
    def shape(self) -> dict:
        """{axis name: size}, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {name!r}")
        return self.axis_names.index(name)


def make_mesh(devices: Optional[Sequence] = None,
              axis_names: Sequence[str] = (STREAMS,),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh of this process's `devices` (every visible card by default;
    it raises where there is none, and takes the CPU only when asked, e.g.
    ["cpu"] * 8) reshaped to `shape` (required for more than one axis).
    multihost.global_mesh builds the mesh of several processes."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() takes every visible card, and "
                "torch.cuda.is_available() is False (pass devices=['cpu'] * n "
                "for n virtual CPU shards)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    axis_names = tuple(axis_names)
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("provide shape for multi-axis meshes")
        shape = (len(devices),)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    arr = arr.reshape(tuple(shape))
    if len(axis_names) != arr.ndim:
        raise ValueError(f"{len(axis_names)} axis names for a mesh of shape "
                         f"{arr.shape}")
    return Mesh(arr, axis_names, np.full(arr.shape, process_index(), np.int64))


# --- trees: ChainState, ConvParams, ... with tensor, int or None leaves ------


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of nested (named) tuples, zipped with `rest`."""
    if isinstance(tree, tuple):
        items = [tree_map(fn, t, *(r[i] for r in rest))
                 for i, t in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(tree, *rest)


def _tensors(tree) -> list:
    out = []
    tree_map(lambda t: out.append(t) if isinstance(t, torch.Tensor) else None,
             tree)
    return out


def chain_state_shardings() -> ChainState:
    """The lane axis of each leaf of a single-block ChainState (None: the
    leaf is replicated, as the ring cursor is): the last axis of the delay
    line, axis 0 of the EQ state. With paged_chain_state_shardings the one
    place that says how a carry splits over stream shards."""
    return ChainState(conv=upols.ConvState(fdl=-1, write_pos=None),
                      eq=eq_block.EqState(s_from=0, s_to=0, counter=0))


def paged_chain_state_shardings(n_pages: int) -> ChainState:
    """chain_state_shardings for the M-block lookahead carry: the pages are
    batch-minor like the delay line."""
    return ChainState(conv=upols.PagedConvState(pages=(-1,) * int(n_pages)),
                      eq=eq_block.EqState(s_from=0, s_to=0, counter=0))


def lane_axes(value):
    """The lane axes of a ChainState (by its conv carry's kind) or of a
    bare conv carry or EqState."""
    if isinstance(value, ChainState):
        conv = lane_axes(value.conv)
        return ChainState(conv=conv, eq=lane_axes(value.eq))
    if isinstance(value, upols.PagedConvState):
        return paged_chain_state_shardings(len(value.pages)).conv
    if isinstance(value, upols.ConvState):
        return chain_state_shardings().conv
    if isinstance(value, eq_block.EqState):
        return chain_state_shardings().eq
    raise TypeError(f"no lane axes for {type(value).__name__}")


def take_lanes(tree, axes, start: int, count: int, device: torch.device):
    """Lanes [start, start+count) of every leaf, as new contiguous tensors
    on `device` (replicated leaves pass through)."""
    def take(t, ax):
        if ax is None:
            return t
        part = t.narrow(ax % t.dim(), start, count)
        return part.to(device, copy=True, memory_format=torch.contiguous_format)
    return tree_map(take, tree, axes)


def cat_lanes(parts: Sequence, axes, device: torch.device):
    """Concatenate parts (trees in lane order) along each leaf's lane axis
    into new tensors on `device`; a replicated leaf must agree across
    parts."""
    def cat(*leaves):
        *ts, ax = leaves
        if ax is None:
            if any(int(t) != int(ts[0]) for t in ts[1:]):
                raise ValueError(f"replicated leaf differs across shards: "
                                 f"{[int(t) for t in ts]}")
            return ts[0]
        return torch.cat([t.to(device) for t in ts], dim=ax % ts[0].dim())
    return tree_map(cat, parts[0], *parts[1:], axes)


class Sharded(NamedTuple):
    """A value split over stream shards: `parts[i]` (a tensor or a
    ChainState, or a SpeakerShard) holds lanes [starts[i], starts[i] +
    lanes of the part) of `batch`, its lane axes `axes` (an int for a
    tensor, lane_axes(part) for a carry). A process holds only its own
    shards' parts; parts with equal starts are replicas."""

    parts: tuple
    starts: tuple
    batch: int
    axes: object = 0

    def gather(self, device: "torch.device | str" = "cpu"):
        """The whole value on `device`, parts in lane order (one replica of
        each block). Raises unless this process holds every lane."""
        device = resolve_device(device)
        seen, parts = set(), []
        for start, part in sorted(zip(self.starts, self.parts),
                                  key=lambda sp: sp[0]):
            if start not in seen:
                seen.add(start)
                parts.append(part.merged(device)
                             if isinstance(part, SpeakerShard) else part)
        axes = lane_axes(parts[0]) if self.axes is None else self.axes
        got = sum(_lanes_of(p, axes) for p in parts)
        if got != self.batch:
            raise ValueError(f"this process holds {got} of {self.batch} "
                             f"lanes: gather needs every shard")
        return cat_lanes(parts, axes, device)


def _lanes_of(part, axes) -> int:
    for t, ax in zip(_flat(part), _flat(axes)):
        if ax is not None:
            return t.shape[ax]
    raise ValueError("a part with no lane axis")


def _flat(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


# --- params: one copy per distinct device ------------------------------------


# Entries a Replicas keeps: every (params tree, device) pair in use at once.
REPLICA_CACHE_SIZE = 32


class Replicas:
    """Copies of params trees on other devices, one per (tree, device),
    kept in a small LRU: a tree already on the device is returned as it is
    (virtual shards copy nothing); otherwise the copy is made once and
    reused while the same tensors come back. The memo holds the source
    tensors, so an id is never reused while its entry lives."""

    def __init__(self) -> None:
        self._memo: OrderedDict = OrderedDict()

    def memo(self, keys: tuple, tag, build: Callable):
        """build() once per (the objects `keys`, `tag`), LRU-cached."""
        key = (tuple(id(k) for k in keys), tag)
        hit = self._memo.get(key)
        if hit is None:
            hit = self._memo[key] = (keys, build())
            if len(self._memo) > REPLICA_CACHE_SIZE:
                self._memo.popitem(last=False)
        else:
            self._memo.move_to_end(key)
        return hit[1]

    def on(self, tree, device: torch.device):
        tensors = _tensors(tree)
        if all(t.device == device for t in tensors):
            return tree
        return self.memo(tuple(tensors), str(device), lambda: tree_map(
            lambda t: t.to(device) if isinstance(t, torch.Tensor) else t,
            tree))


# --- the shards of one process and their streams -----------------------------


class ShardStreams:
    """The devices of a set of shards and, on a card, a CUDA stream each.
    `round()` forks every shard's stream from its device's current stream
    and joins them back after the block, so work queued on the current
    stream before or after a round is ordered against the shards' work;
    `shard(i)` runs the block on shard i's device and stream. With
    own_streams=False (or on the CPU) both are no-ops beyond the device."""

    def __init__(self, devices: Sequence[torch.device],
                 own_streams: bool = True) -> None:
        self.devices = [resolve_device(d) for d in devices]
        self.streams = [torch.cuda.Stream(device=d)
                        if own_streams and d.type == "cuda" else None
                        for d in self.devices]

    @contextlib.contextmanager
    def round(self):
        mains = {}
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                main = mains.setdefault(d, torch.cuda.current_stream(d))
                s.wait_stream(main)
        try:
            yield
        finally:
            for d, s in zip(self.devices, self.streams):
                if s is not None:
                    mains[d].wait_stream(s)

    @contextlib.contextmanager
    def shard(self, i: int):
        s = self.streams[i]
        with _device(self.devices[i]):
            if s is None:
                yield
            else:
                with torch.cuda.stream(s):
                    yield


class StreamShards:
    """The stream shards of `mesh` that this process runs: shard i holds
    lanes [i*B/n, (i+1)*B/n) on the first device of row i of the stream
    axis (other axes replicate the block; one of them is enough)."""

    def __init__(self, mesh: Mesh, axis_name: str = STREAMS) -> None:
        ax = mesh.axis(axis_name)
        self.count = mesh.devices.shape[ax]
        rows = np.moveaxis(mesh.devices, ax, 0).reshape(self.count, -1)[:, 0]
        procs = np.moveaxis(mesh.process_index, ax, 0).reshape(
            self.count, -1)[:, 0]
        me = process_index()
        self.local = [i for i in range(self.count) if procs[i] == me]
        if not self.local:
            raise ValueError("the mesh holds no stream shard of this process")
        self.devices = [rows[i] for i in self.local]

    def lanes(self, batch: int) -> int:
        if batch % self.count:
            raise ValueError(f"batch {batch} does not divide by the "
                             f"{self.count} stream shards")
        return batch // self.count

    def split(self, value, axis: int = 0) -> Sharded:
        """A whole input (tensor or numpy array, global lanes on `axis`) as
        this process's parts; of a Sharded input, one part (replica) per
        local shard."""
        if isinstance(value, Sharded):
            n = self.lanes(value.batch)
            by_start = {}
            for start, part in zip(value.starts, value.parts):
                by_start.setdefault(start, part)
            missing = [i * n for i in self.local if i * n not in by_start]
            if missing:
                raise ValueError(f"the input holds no part at lanes {missing}")
            return Sharded(tuple(by_start[i * n] for i in self.local),
                           tuple(i * n for i in self.local), value.batch,
                           value.axes)
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        batch = value.shape[axis]
        n = self.lanes(batch)
        parts = tuple(
            take_lanes(value, axis, i * n, n, self.devices[k])
            for k, i in enumerate(self.local))
        return Sharded(parts, tuple(i * n for i in self.local), batch, axis)

    def shard_state(self, state) -> Sharded:
        """A carry (ChainState) split into this process's shards; a Sharded
        carry passes through."""
        if isinstance(state, Sharded):
            return state
        axes = lane_axes(state)
        batch = _lanes_of(state, axes)
        n = self.lanes(batch)
        parts = tuple(take_lanes(state, axes, i * n, n, self.devices[k])
                      for k, i in enumerate(self.local))
        return Sharded(parts, tuple(i * n for i in self.local), batch, None)


def shard_chain_state(state: ChainState, mesh: Mesh,
                      stream_axis: str = STREAMS) -> Sharded:
    """Place a carry with the batch split over the stream axis: this
    process's shards, each a ChainState on its device (the delay line's
    last axis and the EQ state's first are the lanes)."""
    return StreamShards(mesh, stream_axis).shard_state(state)


class _ShardRunner:
    """What a sharded step function keeps between calls: the mesh's local
    stream shards, their streams, and the params replicated per device with
    the operands derived from them."""

    def __init__(self, mesh: Mesh) -> None:
        apply_precision_policy()
        self.shards = StreamShards(mesh)
        self.streams = ShardStreams(self.shards.devices,
                                    own_streams=len(self.shards.local) > 1)
        self.replicas = Replicas()

    def params(self, device: torch.device, *trees) -> list:
        return [self.replicas.on(t, device) for t in trees]

    def operands(self, conv_params, eq_to, M: int, conv,
                 device: torch.device):
        """make_chain_operands of params already on `device`, built once."""
        Kp = (conv.pages[0] if hasattr(conv, "pages") else conv.fdl).shape[0]
        keys = tuple(_tensors(conv_params)) + (
            tuple(_tensors(eq_to)) if M > 1 else ())
        return self.replicas.memo(keys, ("operands", M, Kp, str(device)),
                                  lambda: make_chain_operands(
                                      conv_params, eq_to, M, Kp))

    def run(self, state, xs, x_axis: int, body: Callable, y_axis: int):
        """body(device, state_part, x_part) -> (state_part', y_part) on every
        local shard, on its device and stream, in one fork-join round."""
        state = self.shards.shard_state(state)
        xs = self.shards.split(xs, x_axis)
        if xs.starts != state.starts:
            raise ValueError(f"input shards start at {xs.starts}, the "
                             f"carry's at {state.starts}")
        parts, ys = [], []
        with torch.inference_mode(), self.streams.round():
            for k, device in enumerate(self.shards.devices):
                with self.streams.shard(k):
                    s, y = body(device, state.parts[k],
                                xs.parts[k].to(device))
                parts.append(s)
                ys.append(y)
        return (Sharded(tuple(parts), state.starts, state.batch, None),
                Sharded(tuple(ys), state.starts, state.batch, y_axis))


def stream_sharded_step(mesh: Mesh, transition_length: int = 960,
                        spatial_enabled: bool = True, eq_enabled: bool = True,
                        eq_crossfading: bool = True):
    """Pure data-parallel step: step(conv_params, eq_from, eq_to, state, x)
    -> (state', y). `state` is a ChainState (split here) or the Sharded
    carry of an earlier call; x a whole [B, S, T] input or Sharded over
    lanes; y is Sharded [B, 2, T]. Each shard runs chain_step_fn on its
    lanes, on its device and stream; nothing crosses shards. Like
    chain_step_fn the single-block step writes each shard's delay line in
    place: the carry passed in is consumed."""
    runner = _ShardRunner(mesh)

    def step(conv_params, eq_from, eq_to, state, x):
        def body(device, s, xs):
            conv, ef, et = runner.params(device, conv_params, eq_from, eq_to)
            ops = (runner.operands(conv, None, 1, s.conv, device)
                   if spatial_enabled else None)
            return chain_step_fn(conv, ef, et, s, xs, transition_length,
                                 spatial_enabled, eq_enabled, eq_crossfading,
                                 ops)
        return runner.run(state, x, 0, body, 0)

    return step


def stream_sharded_bake(mesh: Mesh, transition_length: int = 960,
                        eq_enabled: bool = True):
    """Sharded offline bake (BASELINE config 5 on several devices):
    run(conv_params, eq_from, eq_to, state, x_blocks [N, B, S, T]) ->
    (state', y_blocks Sharded [N, B, 2, T]), the blocks looped on each
    shard in turn (the shards' streams overlap on a card)."""
    runner = _ShardRunner(mesh)

    def run(conv_params, eq_from, eq_to, state, x_blocks):
        def body(device, s, xb):
            conv, ef, et = runner.params(device, conv_params, eq_from, eq_to)
            ops = runner.operands(conv, None, 1, s.conv, device)
            ys = []
            for n in range(xb.shape[0]):
                s, y = chain_step_fn(conv, ef, et, s, xb[n], transition_length,
                                     True, eq_enabled, False, ops)
                ys.append(y)
            return s, torch.stack(ys)
        return runner.run(state, x_blocks, 1, body, 1)

    return run


def stream_sharded_bake_multi(mesh: Mesh, n_pages: int,
                              transition_length: int = 960,
                              eq_enabled: bool = True):
    """Sharded M-block lookahead bake (the headline path on several
    devices): run(conv_params, eq_from, eq_to, state, x_steps [N, B, S, M,
    T]) -> (state', y_steps Sharded [N, B, M, 2, T]). Each shard runs
    chain_step_multi_fn (the EQ folded into the synthesis when enabled) on
    its paged carry of `n_pages` pages."""
    runner = _ShardRunner(mesh)

    def run(conv_params, eq_from, eq_to, state, x_steps):
        def body(device, s, xs):
            if len(s.conv.pages) != n_pages:
                raise ValueError(f"carry has {len(s.conv.pages)} pages, the "
                                 f"bake was built for {n_pages}")
            conv, ef, et = runner.params(device, conv_params, eq_from, eq_to)
            ops = runner.operands(conv, et, xs.shape[3], s.conv, device)
            ys = []
            for n in range(xs.shape[0]):
                s, y = chain_step_multi_fn(conv, ef, et, s, xs[n],
                                           transition_length, eq_enabled,
                                           False, ops)
                ys.append(y)
            return s, torch.stack(ys)
        return runner.run(state, x_steps, 1, body, 1)

    return run


# --- streams x speakers --------------------------------------------------------


class SpeakerShard(NamedTuple):
    """Stream shard i's carry on a (streams, speakers) mesh: the conv carry
    of each speaker shard this process holds (`speakers`, in order), each
    on its device, and the EQ state, on the row's first local device."""

    convs: tuple
    speakers: tuple
    eq: eq_block.EqState

    def merged(self, device: torch.device) -> ChainState:
        """The row's ChainState on `device` (needs every speaker shard)."""
        fdl = torch.cat([c.fdl.to(device) for c in self.convs], dim=1)
        return ChainState(
            conv=upols.ConvState(fdl=fdl, write_pos=self.convs[0].write_pos),
            eq=tree_map(lambda t: t.to(device), self.eq))


def stream_speaker_sharded_step(mesh: Mesh, transition_length: int = 960,
                                eq_enabled: bool = True):
    """Streams x speakers: each (stream i, speaker j) shard holds its
    slice of the bank's speakers (its part of R = speakers x partitions x
    re/im) and of the delay line's speaker axis, and runs upols.conv_step
    (so mac_kmajor at its own R) on its device. The partial stereo mixes
    are summed on the row's first local device in speaker-shard order (the
    JAX version's psum); where a row spans processes the local sum is then
    torch.distributed.all_reduce'd over the row's processes (staged through
    host memory on gloo). Then the EQ runs once per stream shard. The
    shards run on their devices' current streams, so each cross-device copy
    of a partial mix is ordered by PyTorch.

    step(conv_params, eq_from, eq_to, state, x) -> (state', y): state a
    ChainState with a single-block carry (split here) or the Sharded carry
    of an earlier call (parts are SpeakerShards), x a whole [B, S, T] input
    or Sharded over lanes; y Sharded [B, 2, T]."""
    apply_precision_policy()
    if mesh.devices.ndim != 2:
        raise ValueError("stream_speaker_sharded_step needs a 2-D mesh")
    si, pi = mesh.axis(STREAMS), mesh.axis(SPEAKERS)
    grid = np.moveaxis(mesh.devices, (si, pi), (0, 1))
    procs = np.moveaxis(mesh.process_index, (si, pi), (0, 1))
    n_rows, n_spk = grid.shape
    me = process_index()
    mine = {i: [j for j in range(n_spk) if procs[i, j] == me]
            for i in range(n_rows)}
    rows = [i for i in range(n_rows) if mine[i]]
    if not rows:
        raise ValueError("the mesh holds no device of this process")
    groups = _row_groups(procs)
    replicas = Replicas()

    def split_state(state: ChainState, batch: int) -> Sharded:
        n = batch // n_rows
        per = state.conv.fdl.shape[1] // n_spk
        parts = []
        for i in rows:
            convs = tuple(upols.ConvState(
                fdl=state.conv.fdl.narrow(-1, i * n, n).narrow(1, j * per, per)
                .to(grid[i, j], copy=True,
                    memory_format=torch.contiguous_format),
                write_pos=state.conv.write_pos) for j in mine[i])
            eq = take_lanes(state.eq, lane_axes(state.eq), i * n, n,
                            grid[i, mine[i][0]])
            parts.append(SpeakerShard(convs, tuple(mine[i]), eq))
        return Sharded(tuple(parts), tuple(i * n for i in rows), batch, None)

    def conv_shard(conv_params, conv_state, x, i, j, per):
        dev, Kp = grid[i, j], conv_state.fdl.shape[0]

        def build():
            bank = upols.ConvParams(
                Gflip2=conv_params.Gflip2.narrow(0, j * per, per).to(
                    dev, copy=True), wf=conv_params.wf.to(dev),
                wi=conv_params.wi.to(dev))
            return bank, make_chain_operands(bank, None, 1, Kp)

        # Speaker shard j's bank and operands, built once per bank.
        bank, ops = replicas.memo(tuple(_tensors(conv_params)),
                                  ("speakers", j, per, Kp, str(dev)), build)
        # Contiguous: on a strided slice of x the analysis matmul would
        # broadcast its weights into one small GEMM per lane.
        xj = x.narrow(1, j * per, per).to(dev).contiguous()
        with _device(dev):
            return upols.conv_step(bank, conv_state, xj, ops.bank, ops.synth)

    def step(conv_params, eq_from, eq_to, state, x):
        if isinstance(x, Sharded):
            x_rows, batch = dict(zip(x.starts, x.parts)), x.batch
        else:
            x = x if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x))
            x_rows, batch = None, x.shape[0]
        if batch % n_rows:
            raise ValueError(f"batch {batch} does not divide by the {n_rows} "
                             f"stream shards")
        S = conv_params.num_speakers
        if S % n_spk:
            raise ValueError(f"{S} speakers do not divide by {n_spk} speaker "
                             f"shards")
        n, per = batch // n_rows, S // n_spk
        if not isinstance(state, Sharded):
            state = split_state(state, batch)
        parts, ys = [], []
        with torch.inference_mode():
            for part, i in zip(state.parts, rows):
                xi = x_rows[i * n] if x_rows else x.narrow(0, i * n, n)
                first = grid[i, part.speakers[0]]
                convs, acc = [], None
                for conv_state, j in zip(part.convs, part.speakers):
                    conv_state, y = conv_shard(conv_params, conv_state, xi, i,
                                               j, per)
                    convs.append(conv_state)
                    y = y.to(first)
                    acc = y if acc is None else acc + y
                eq = part.eq
                with _device(first):
                    if groups[i] is not None:
                        acc = _all_reduce(acc, groups[i])
                    if eq_enabled:
                        ef, et = (replicas.on(p, first)
                                  for p in (eq_from, eq_to))
                        eq, acc = eq_block.eq_step(ef, et, eq, acc,
                                                   transition_length)
                parts.append(SpeakerShard(tuple(convs), part.speakers, eq))
                ys.append(acc)
        return (Sharded(tuple(parts), state.starts, batch, None),
                Sharded(tuple(ys), state.starts, batch, 0))

    return step


def _device(device: torch.device):
    """torch.cuda.device(device) for a card, else nothing."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _row_groups(procs: np.ndarray) -> list:
    """A torch.distributed group per stream row whose speaker shards span
    more than one process (None for rows within one process, and for rows
    this process is not in). Every process creates every group, in the
    same order, as new_group requires."""
    dist = torch.distributed
    multi = (dist.is_available() and dist.is_initialized()
             and dist.get_world_size() > 1)
    me = process_index()
    groups = []
    for row in procs:
        ranks = sorted({int(p) for p in row})
        group = dist.new_group(ranks) if multi and len(ranks) > 1 else None
        groups.append(group if me in ranks else None)
    return groups


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group`. gloo reduces host tensors: a card's tensor is
    staged through host memory explicitly."""
    dist = torch.distributed
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    buf = t.to("cpu") if staged else t.contiguous()
    dist.all_reduce(buf, group=group)
    return buf.to(t.device) if staged else buf
