"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source under csrc/ is compiled at first use into a shared library with
a plain C interface, in kernels/_build/ next to this file, keyed on the
source's hash, the nvcc version and the flags; a later process reuses the
library. Nothing else is compiled or loaded: a missing nvcc or a failed
build raises KernelBuildError, and no caller falls back to the plain PyTorch
version.

The flags hold the strict tier: IEEE fp32, so no --use_fast_math and no
-ftz=true. sm_90a is the H100's architecture-specific target.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from airwave_tpu_torch.utils.profiling import BUILD_KERNEL_LIBRARY, span

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
    "--shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """A CUDA source of the package could not be compiled or loaded."""


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME or $CUDA_PATH, then PATH, then the toolkit's
    default install prefix."""
    candidates = [Path(os.environ[v]) / "bin" / "nvcc"
                  for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of airwave_tpu_torch are "
        "built from their sources at first use and need the CUDA toolkit"
    )


@functools.lru_cache(maxsize=None)
def load(source_name: str) -> tuple:
    """(ctypes.CDLL, build log) for csrc/<source_name>. The log holds nvcc's
    output (ptxas register and shared-memory report) when this call built
    the library, and is empty when it was already built."""
    with span(BUILD_KERNEL_LIBRARY):
        src = CSRC_DIR / source_name
        nvcc = find_nvcc()
        version = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True, check=True).stdout
        key = hashlib.sha256(
            src.read_bytes() + version.encode() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        lib = BUILD_DIR / f"{src.stem}-{key}.so"
        log = ""
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build under a private name and rename: concurrent first uses in
            # several processes never load a half-written library.
            tmp = BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise KernelBuildError(
                    f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
            os.replace(tmp, lib)
        try:
            return ctypes.CDLL(str(lib)), log
        except OSError as err:
            raise KernelBuildError(f"cannot load {lib}: {err}") from err
