"""setup_s (s, end to end, host clock): from the process's start to the
first timed step: imports, the card's start, the first run's nvcc build,
the operands, the carry, the input and the warm-up steps."""


def read(run):
    return run.setup_s
