"""peak_bytes_per_lane (B/lane, end to end): the caching allocator's peak
over set-up and window (torch.cuda.max_memory_allocated), less the
benchmark's own input buffer, over the lanes: what an operator sizing a pool
pays for each stream."""


def read(run):
    if not run.on_card:
        return None
    return (run.peak_bytes - run.input_bytes) / run.lanes
