"""Shared relay pieces (the port of the parts of `repro/relay/base.py` that
the flat relay uses): the ring-slot owner sentinels, the default capacity,
the prototype merge with its clock tick, and the ring write positions."""
from __future__ import annotations

import torch

from repro_torch.core import prototypes
from repro_torch.types import CollabConfig

# Ring-slot owner sentinels. Real clients are >= 0.
SEED_OWNER = -1      # server-seeded random observation (paper Alg. 1 init)
EMPTY_OWNER = -2     # slot never written


def default_capacity(ccfg: CollabConfig, n_clients: int = 2) -> int:
    """32 . N . M_up live observations."""
    return 32 * max(1, n_clients) * max(1, ccfg.m_up)


def merge_protos(state, proto: prototypes.ProtoState):
    """Per-round recompute of t-bar^c (Alg. 1) plus the server logical-clock
    tick (one tick per merge)."""
    return state._replace(global_protos=prototypes.means(proto),
                          valid_g=proto.count > 0, clock=state.clock + 1)


def stamps_or_now(state, k: int, stamp_rows=None):
    """Rows' birth clocks: `stamp_rows`, or the current clock for all k
    rows (the synchronous case). (k,) int32."""
    if stamp_rows is None:
        return state.clock.to(torch.int32).expand(k).clone()
    return stamp_rows.to(torch.int32)


def ring_indices(ptr, k: int, cap: int, row_mask=None):
    """Ring write positions for k rows, of which only `row_mask` are real
    (None = all). Masked-out rows get index `cap` (out of range: the append
    drops them) and consume no slot. Returns (idx (k,) int32, new_ptr ()
    int32)."""
    if row_mask is None:
        idx = (ptr + torch.arange(k, dtype=torch.int32, device=ptr.device)) % cap
        return idx.to(torch.int32), ((ptr + k) % cap).to(torch.int32)
    w = row_mask.to(torch.int32)
    offs = torch.cumsum(w, 0) - 1                 # slot offset per real row
    idx = torch.where(row_mask, (ptr + offs) % cap,
                      torch.full_like(offs, cap)).to(torch.int32)
    return idx, ((ptr + w.sum()) % cap).to(torch.int32)
