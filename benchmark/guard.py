"""The import guard: no module of JAX or of the JAX package in a run.

A module's top-level name is the part of its name before the first dot,
compared whole: `rtm_tpu_torch` (the program) begins with `rtm_tpu` (the
JAX package) and is not it.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "rtm_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(modules=None, forbidden=FORBIDDEN) -> list:
    """Sorted names of the loaded modules whose top-level name is one of
    `forbidden` (sys.modules by default)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in forbidden)
