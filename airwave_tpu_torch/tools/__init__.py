"""Offline asset tools: SOFA conversion, spatial metrics and synthesis, the
variant generator and the pool capacity planner."""


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
