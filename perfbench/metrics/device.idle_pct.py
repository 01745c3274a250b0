"""device.idle_pct (%, layer: device): the share of the traced window in
which no operation ran on the card, from the trace recorded without Python
stacks (so the host runs as it does untraced but for the profiler's own
records). Moves x_realtime."""


def read(run):
    t = run.plain
    if t is None or not t.ops or not t.window_us:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
