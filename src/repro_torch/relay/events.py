"""The relay's host-side event log; an own copy of `HostEventQueue` from the
reference's `repro/relay/events.py`. `AdaptiveParticipation` replays its
observed commit delays through it. The fixed-shape pending buffer and the
event-ordered commit come with asynchrony (ROADMAP slice 4)."""
from __future__ import annotations

from typing import List, Tuple


class HostEventQueue:
    """Host-side event log. Events are (birth, pos, client_id, stamp,
    payload); `pop_due(t)` returns round t's commit set sorted by (birth,
    pos), the order the reference's `commit_and_park` appends rows in."""

    def __init__(self):
        self._events: List[Tuple[int, int, int, int, object, int]] = []

    def push(self, birth: int, pos: int, client_id: int, stamp: int,
             payload, delay: int):
        self._events.append((int(birth), int(pos), int(client_id),
                             int(stamp), payload, int(birth) + int(delay)))

    def pop_due(self, round_idx: int):
        due = sorted((e for e in self._events if e[5] == int(round_idx)),
                     key=lambda e: (e[0], e[1]))
        self._events = [e for e in self._events if e[5] != int(round_idx)]
        return due

    def __len__(self):
        return len(self._events)
