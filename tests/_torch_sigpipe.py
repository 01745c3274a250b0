"""The SIGPIPE fixture shared by the port's socket test files.

Import it into a test module (`from _torch_sigpipe import sigpipe_ignored`)
and it applies to every case there."""

import signal

import pytest


@pytest.fixture(autouse=True)
def sigpipe_ignored():
    """The interpreter's SIGPIPE disposition (ignored: a write to a closed
    peer raises) for every case of the module. A CLI main() run in process
    earlier in this worker (tests/test_tools.py runs the JAX tools' main(),
    which resets it to the default) would otherwise make a socket peer close
    kill the worker."""
    previous = signal.signal(signal.SIGPIPE, signal.SIG_IGN)
    yield
    signal.signal(signal.SIGPIPE, previous)
