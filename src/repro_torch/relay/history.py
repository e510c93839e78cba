"""The bounded ring of relay-state snapshots behind stale downloads
(download lag); the port of the reference's `repro/relay/history.py`.

The synchronous engines let every client download from the relay state of
the previous round. A duty-cycled device trains against whatever snapshot
it fetched at its last sync, possibly rounds old. This module keeps the
last `H_max` post-merge relay states in a fixed-shape ring, so a client
training in round t samples its teachers and global prototypes from the
snapshot `d <= H_max - 1` rounds staler than its round-start sync: the
post-merge state of round t - d - 1 (d = 0 is the round-start state).

A `History` holds the snapshots stacked, every leaf of the policy's state
with a leading (H_max,) axis, and `head`, a 0-d int32 tensor on the device
naming the slot of the most recent snapshot. Stacking is policy-agnostic
(every policy state is a NamedTuple of fixed-shape tensors, nested for the
sharded relay, whose leaves then lead with (H_max, S)), and `read_at`
returns a state of the policy's own type.

  - `push` evicts the oldest snapshot once the ring is full;
  - `read_at(hist, d)` returns exactly the snapshot d pushes ago for
    d <= H_max - 1 and clamps deeper requests to the oldest one;
  - every slot starts as the initial state, so a read past the pushes made
    so far sees the Algorithm-1 init state.

`push` and `read_at` read nothing back to the host, so the vectorized
engine runs them inside its round step; the sequential engine replays the
ring as a most-recent-first list (`core/collab.py`). `H_max = 1` keeps only
the current state: delay-0 reads equal the history-free engines' bit for
bit. On a client mesh the ring is REPLICATED (`out_spec`): every rank
holds every snapshot, and a client's stale read is a local gather.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.relay import placement
from repro_torch.tree import tree_map


class History(NamedTuple):
    """snaps: the policy state with every leaf stacked (H_max, ...); head:
    0-d int32, the ring slot of the most recent snapshot."""
    snaps: Any
    head: torch.Tensor

    @property
    def h_max(self) -> int:
        return _first_leaf(self.snaps).shape[0]


def _first_leaf(tree) -> torch.Tensor:
    """The first tensor of a (nested) NamedTuple state: a sharded relay's
    state nests the inner policy's."""
    while isinstance(tree, tuple):
        tree = tree[0]
    return tree


def init(snapshot, h_max: int) -> History:
    """A ring of `h_max` copies of `snapshot`, on its device."""
    if h_max < 1:
        raise ValueError(f"history depth must be >= 1, got {h_max}")
    snaps = tree_map(lambda a: a.unsqueeze(0).repeat(h_max, *[1] * a.dim()),
                     snapshot)
    return History(snaps=snaps, head=torch.zeros(
        (), dtype=torch.int32, device=_first_leaf(snapshot).device))


def out_spec(hist: History):
    """Placement declaration (`relay/placement.py`): the ring stacks
    snapshots of a REPLICATED relay state along a history axis, and every
    client must be able to read any depth, so the whole ring (snaps and
    head) is REPLICATED; a client-sharded delay vector then reads it with a
    local gather on each rank."""
    return placement.like(hist, placement.REPLICATED)


def push(hist: History, snapshot) -> History:
    """Append a post-merge snapshot, evicting the oldest; no host read."""
    head = torch.remainder(hist.head + 1, hist.h_max).to(torch.int32)
    idx = head.reshape(1).long()
    return History(
        snaps=tree_map(lambda buf, a: buf.index_copy(0, idx, a.unsqueeze(0)),
                       hist.snaps, snapshot),
        head=head)


def read_at(hist: History, delay):
    """The snapshot `delay` pushes ago (0 = the most recent), clamped to the
    ring's depth. `delay` an int, a 0-d tensor (-> the policy's state) or a
    (k,) tensor (-> a state whose every leaf has a leading (k,) axis, one
    snapshot a client: the reference's `read_at` under `vmap`)."""
    h = hist.h_max
    d = torch.as_tensor(delay, device=hist.head.device).to(torch.int32)
    slot = torch.remainder(hist.head - d.clamp(0, h - 1), h)
    if slot.dim() == 0:
        return tree_map(lambda buf: buf.index_select(0, slot.reshape(1))[0],
                        hist.snaps)
    return tree_map(lambda buf: buf.index_select(0, slot), hist.snaps)
