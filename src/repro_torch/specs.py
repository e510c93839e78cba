"""One spec-string grammar for the port's pluggable-component registries; an
own copy of `repro/specs.py`, held equal to it by
tests/test_torch_baselines.py.

Relay policies ("staleness:0.5") and, in later slices, participation
schedules and clocks accept the same CLI-style shape NAME[:ARG[,ARG...]].
`parse_spec` tokenizes it, validates NAME against the caller's registry and
raises one uniform error listing the valid names; the caller interprets the
arguments.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple


def parse_spec(spec, kind: str, names: Sequence[str],
               aliases: dict = None) -> Tuple[str, List[str]]:
    """Tokenize "NAME[:ARG[,ARG...]]" and validate NAME.

    spec: the spec string (str() is applied); kind: what the registry holds,
    for the error message; names: the registry's valid names; aliases:
    optional {alias: canonical} applied before validation.

    Returns (name, args), args the non-empty ","-split argument tokens.
    Raises ValueError `unknown <kind>: <spec!r> (have <sorted names>)` for
    an unknown name.
    """
    name, _, arg = str(spec).partition(":")
    if aliases and name in aliases:
        name = aliases[name]
    if name not in names:
        raise ValueError(
            f"unknown {kind}: {spec!r} (have {sorted(names)})")
    return name, [a for a in arg.split(",") if a] if arg else []
