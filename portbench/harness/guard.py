"""What the benchmark may not load: JAX and the JAX package the port was
made from. Names are compared whole, by the part before the first dot:
the port's package, ``srl_zoo_tpu_torch``, begins with the JAX package's
name and is allowed."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "srl_zoo_tpu"})


def forbidden(names: Iterable[str]) -> List[str]:
    """The module names among ``names`` whose top-level name is
    forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def loaded_forbidden() -> List[str]:
    """The forbidden modules this process has loaded."""
    return forbidden(list(sys.modules))
