"""The check that a run loaded nothing of the JAX side.

Names are compared whole, by the top-level package of each module (the part
before the first dot): `airwave_tpu_torch` is the program and passes,
`airwave_tpu` is the JAX package and fails.
"""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "airwave_tpu", "bench",
                       "chip_smoke"})


def forbidden_modules(names) -> list:
    """The sorted top-level names among `names` that the run may not load."""
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
