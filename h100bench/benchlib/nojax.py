"""The modules a run of the port may not load: JAX, its libraries, and the
JAX package that the port was made from. Names are compared whole, by the
part before the first dot, because the port's own name
(``ssd_tensorflow_tpu_torch``) begins with the JAX package's."""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ssd_tensorflow_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(module_names) -> list:
    """The top-level names among ``module_names`` that are forbidden, sorted."""
    return sorted({top_level(n) for n in module_names} & FORBIDDEN)
