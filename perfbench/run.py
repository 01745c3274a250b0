"""Run one cell of the benchmark: see perfbench/core/cli.py.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>
"""

import time

STARTED = time.time()

import os  # noqa: E402
import sys  # noqa: E402


def process_start() -> float:
    """The process's start on the time.time() clock, from /proc (10 ms
    ticks); the first line of this file where /proc cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return STARTED
    age = uptime - ticks / os.sysconf("SC_CLK_TCK")
    return min(STARTED, time.time() - age)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from perfbench.core.cli import main

    sys.exit(main(started=process_start()))
