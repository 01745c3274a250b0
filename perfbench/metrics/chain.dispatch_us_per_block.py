"""chain.dispatch_us_per_block (us/block, layer: chain step, host side:
models/binaural): host time inside BinauralChain.forward a block, from the
benchmark's own span around each call of the untraced window (host clock,
summed over every call of the window). Moves round_ms_p99."""


def read(run):
    if not run.dispatch_ns:
        return None
    blocks = len(run.dispatch_ns) * run.blocks_per_step
    return sum(run.dispatch_ns) / 1e3 / blocks
