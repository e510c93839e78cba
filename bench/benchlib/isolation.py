"""The benchmark measures the PyTorch port alone: no module of JAX, Flax or
the JAX package may be loaded in the process that prints a result.
Modules are compared by their top-level name (the part before the first
dot) as a whole name, so that `repro_torch` is not taken for `repro`."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# What the port's libraries might pull in on their own is kept out in the
# run's environment (transformers' Flax backend).
ENVIRONMENT = {"USE_FLAX": "0", "USE_JAX": "0"}


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules: Iterable[str] = None,
                     forbidden: Iterable[str] = FORBIDDEN) -> List[str]:
    """The loaded module names whose top-level name is forbidden."""
    modules = list(sys.modules) if modules is None else list(modules)
    bad = set(forbidden)
    return sorted(m for m in modules if top_level(m) in bad)
