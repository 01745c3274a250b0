"""round_ms_p99 (ms, end to end): the 99th percentile, by nearest rank, of
every round of the window, each timed from its dispatch to its output being
ready by CUDA events recorded on the stream around it (the device's clock).
A round over the 10.67 ms block period is an audible dropout."""

import math


def read(run):
    if not run.round_ms or not run.on_card:
        return None
    ordered = sorted(run.round_ms)
    return ordered[math.ceil(0.99 * len(ordered)) - 1]
