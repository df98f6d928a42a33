"""The check that nothing of the JAX package or of JAX is loaded."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "giddy_tpu")


def loaded(modules=None) -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot)
    is one of FORBIDDEN, compared whole: giddy_tpu_torch passes."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def check() -> None:
    found = loaded()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {found[:20]}")
