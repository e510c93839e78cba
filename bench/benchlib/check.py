"""The comparison that decides `correct`: numbers, each beside its limit.

Norm gaps are taken by the worst leaf: the gap between the program's norm
of a leaf and the reference's, over the reference's norm of that leaf or
of the median leaf, whichever is larger (some leaves are all but zero).
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of a change's comparison: they move by round-off
alone (`moving`)."""
from __future__ import annotations

import statistics
import sys
from typing import Dict, Iterable, List, Optional


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keep: Optional[Iterable[str]] = None) -> float:
    keys = list(ref) if keep is None else list(keep)
    med = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The median over leaves of the same per-leaf gap: steadier than the
    worst leaf, which a lower precision may move no more than rounding."""
    med = statistics.median(ref.values())
    return statistics.median(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                             for k in ref)


def moving(grad_norms: Dict[str, float]) -> List[str]:
    med = statistics.median(grad_norms.values())
    return [k for k, v in grad_norms.items() if v >= 1e-3 * med]


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


class Checks:
    """Named numbers with their limits (`limits`: the cell's file), in the
    order they were added; a number the file gives no limit is not
    compared."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = limits
        self.items: List[Dict] = []

    def add(self, name: str, value: float) -> None:
        if name not in self.limits:
            return
        self.items.append({"name": name, "value": float(value),
                           "limit": float(self.limits[name])})

    @property
    def correct(self) -> bool:
        # a number that came out NaN fails
        return bool(self.items) and all(
            c["value"] <= c["limit"] for c in self.items)

    def report(self, stream=sys.stderr) -> None:
        for c in self.items:
            ok = "ok" if c["value"] <= c["limit"] else "FAIL"
            print(f"check {c['name']} {c['value']!r} limit {c['limit']!r} "
                  f"{ok}", file=stream)
        stream.flush()

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {c["name"]: {"value": c["value"], "limit": c["limit"]}
                for c in self.items}
