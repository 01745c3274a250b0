"""The benchmark's command line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout. Prints progress and, as its last lines on
standard error, each compared number beside its limit; prints the result
as one JSON object on the last line of standard output. Exits 2, and
prints no result, where the program cannot be imported (a directory
that holds the benchmark alone), without a CUDA card or with fewer cards
than the cell asks for; and 3 when the run loaded a module of the JAX side.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from perfbench.core.imports import forbidden_modules
from perfbench.core.roofline import (BF16_FLOPS_PER_S, FP32_FLOPS_PER_S,
                                     HBM_BYTES_PER_S)

TIER_VARS = ("AIRWAVE_MATMUL_PRECISION", "AIRWAVE_DFT_PRECISION",
             "AIRWAVE_MAC_PRECISION")


def err(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def set_tier(tier: str) -> None:
    """The program's precision tier, read when it is imported: the
    configuration's, whatever the environment held."""
    for var in TIER_VARS:
        os.environ.pop(var, None)
    os.environ["AIRWAVE_MATMUL_PRECISION"] = tier


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "not read")


def main(argv=None, started: "float | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    ap.add_argument("--tier", default=None,
                    help="run the program at another precision tier than "
                         "the configuration states (the control of the "
                         "comparison; never used by the benchmark's runs)")
    args = ap.parse_args(argv)

    from perfbench.core.spec import Spec

    spec = Spec()
    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    set_tier(args.tier or config["tier"])

    import torch

    t_torch = time.time()
    try:
        import airwave_tpu_torch  # noqa: F401
    except ImportError as exc:
        err(f"perfbench: the program airwave_tpu_torch cannot be imported "
            f"({exc}); run from the root of a checkout")
        return 2
    t_program = time.time()

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        err(f"perfbench: the cell needs {chips} CUDA card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}")
        return 2
    if started is not None:
        err(f"imports: torch {t_torch - started:.3f} s, the program "
            f"{t_program - t_torch:.3f} s, the card found "
            f"{time.time() - t_program:.3f} s")

    from perfbench.core.cell import run_cell

    if args.trace:
        err(f"card: {power_limit()}; peaks: {HBM_BYTES_PER_S / 1e12:g} TB/s "
            f"HBM, {FP32_FLOPS_PER_S / 1e12:g} TFLOP/s fp32, "
            f"{BF16_FLOPS_PER_S / 1e12:g} TFLOP/s bf16 dense "
            f"(H100 SXM at 700 W)")
    result, checks = run_cell(spec, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", started, log=err)
    found = forbidden_modules(sys.modules)
    if found:
        err(f"perfbench: the run loaded {', '.join(found)}")
        return 3
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    for c in checks:
        err(c.line())
    print(json.dumps(result), flush=True)
    return 0
