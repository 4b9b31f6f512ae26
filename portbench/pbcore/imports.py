"""The modules a run may not hold: JAX and the JAX package.

Compared by whole top-level names (the part before the first dot), since
the port's name, ``ldpc_decoder_tpu_torch``, begins with the JAX
package's.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "ldpc_decoder_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: what this
    process has imported)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
