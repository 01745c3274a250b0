"""Offline asset tools: SOFA conversion, spatial metrics and synthesis, the
variant generator and the pool capacity planner; the preset dataset gate
(validate_presets, files only) and the hot-path gate (check_hot_path); and
the card-side tools: the accuracy gate (validate_accuracy), the device soak
of the pool round (soak) and the serving checkpoint's cost at scale
(checkpoint_scale)."""


def die_quietly_on_sigpipe() -> None:
    """A tool's process entry: die quietly when its output is piped into
    `head` and closed, as a unix tool does. Only the `__main__` block calls
    it, never main(): in a process that embeds main() (a server, a test
    worker) the default disposition would make any write to a closed
    socket kill the whole process."""
    import signal

    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):  # no SIGPIPE, or not the main thread
        pass
