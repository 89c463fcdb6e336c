"""The check that a run loads neither JAX nor the JAX package.

Each loaded module's top-level name (the part before the first dot) is
compared whole, so ``s2s_tpu_torch`` passes and ``s2s_tpu`` and
``s2s_tpu.models`` fail.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "s2s_tpu")


def offending(names) -> list[str]:
    """The names among *names* whose top-level name is forbidden, sorted."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def loaded() -> list[str]:
    """The forbidden modules loaded in this process."""
    return offending(list(sys.modules))
