"""The general traffic generator and its loops.

A traffic mix is a data file, traffic/<name>.json, that names the entry it
drives and gives its parameters:

    entry            the entry point under entries/
    lanes            streams rendered together in one step
    distinct_steps   steps of input drawn from the seed and cycled, so that
                     no input sits in the card's 50 MB L2 between its uses
    input_scale      input samples are input_scale * N(0, 1)
    loop             "closed": back-to-back steps, a checksum of each call's
                     outputs fetched once per call of steps_per_call steps;
                     "rounds": one step a round, the round's output waited
                     for before the next round is dispatched
    steps_per_call   (closed) steps between two fetches of the checksum
    warmup_steps     steps run before the window, in set-up
    trace_steps      steps of each traced window
    check            lanes: lanes sampled; steps: window steps sampled
                     (drawn among the first `within_steps` of the window),
                     besides the window's last step; limit_rel_rms: the
                     limit of the compared number

Every seed runs the same sizes; the seed draws the values and which lanes
and steps are compared.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import numpy as np

SEED_STREAMS = {"weights": 0, "inputs": 1}


def device_generator(seed: int, stream: str, device):
    """A torch.Generator on `device` for one named stream of the seed."""
    import torch

    key = (int(seed) * 2 + SEED_STREAMS[stream]) % (1 << 63)
    return torch.Generator(device=device).manual_seed(key)


def make_inputs(shape: tuple, traffic: dict, seed: int, device):
    """[distinct_steps, *shape] float32 on `device`, input_scale * N(0, 1),
    drawn there in one call."""
    import torch

    gen = device_generator(seed, "inputs", device)
    x = torch.randn((traffic["distinct_steps"], *shape), generator=gen,
                    device=device)
    return x.mul_(float(traffic["input_scale"]))


def sample_plan(seed: int, traffic: dict, first_step: int):
    """(sorted lane indices, sorted window steps) to compare, from `seed`."""
    check = traffic["check"]
    rng = np.random.default_rng([int(seed), 7])
    lanes = np.sort(rng.choice(traffic["lanes"], size=check["lanes"],
                               replace=False))
    steps = np.sort(rng.choice(check["within_steps"], size=check["steps"],
                               replace=False)) + first_step
    return lanes, [int(s) for s in steps]


class Window(NamedTuple):
    first_step: int
    steps: int              # steps run
    seconds: float          # host clock over the whole window
    round_ms: list          # per round, dispatch to output ready ("rounds")
    dispatch_ns: list       # host time inside each step call
    checksums: list         # per call ("closed")
    last: object            # the last step's output


def run_loop(step, inputs, traffic: dict, first_step: int, device,
             seconds: float = 0.0, max_steps: "int | None" = None,
             after=None, annotate=contextlib.nullcontext) -> Window:
    """Drive `step(x)` with the mix's loop from global step `first_step`
    until `seconds` have passed (checked at the end of each call or round)
    or `max_steps` steps have run. `after(k, y)` sees each step's output
    once the loop no longer times it (after the round's wait in "rounds"),
    `annotate()` wraps each step call (a trace's step span)."""
    import torch

    on_card = torch.device(device).type == "cuda"
    n = inputs.shape[0]
    k = first_step
    round_ms, dispatch, checksums = [], [], []
    y = None
    if on_card:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()

    def done():
        if max_steps is not None:
            return k - first_step >= max_steps
        return time.perf_counter() - t0 >= seconds

    if traffic["loop"] == "closed":
        per_call = int(traffic["steps_per_call"])
        while True:
            acc = torch.zeros((), device=device)
            for _ in range(per_call):
                a = time.perf_counter_ns()
                with annotate():
                    y = step(inputs[k % n])
                dispatch.append(time.perf_counter_ns() - a)
                acc += y.sum()
                if after is not None:
                    after(k, y)
                k += 1
            checksums.append(float(acc))      # the fetch waits for the call
            if done():
                break
    elif traffic["loop"] == "rounds":
        if on_card:
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        while True:
            if on_card:
                begin.record()
            a = time.perf_counter_ns()
            with annotate():
                y = step(inputs[k % n])
            b = time.perf_counter_ns()
            if on_card:
                end.record()
                end.synchronize()
                round_ms.append(begin.elapsed_time(end))
            else:
                round_ms.append((time.perf_counter_ns() - a) / 1e6)
            dispatch.append(b - a)
            if after is not None:
                after(k, y)
            k += 1
            if done():
                break
    else:
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    seconds_run = time.perf_counter() - t0
    return Window(first_step, k - first_step, seconds_run, round_ms,
                  dispatch, checksums, y)
