"""The relay's event log for bounded-delay uploads; the port of the
reference's `repro/relay/events.py`.

The synchronous engines commit every upload of round r in round r.
Cross-device fleets do not: a straggler's upload arrives rounds later. The
event log makes lateness exact:

  - an upload born in round r by the client at upload position u, with
    commit delay d (from a `repro_torch.sim` clock, d <= D_max), is the
    event (birth=r, pos=u) committed in round r + d;
  - round t commits, in EVENT ORDER, every event whose commit round is t:
    birth round ascending first, upload position second. This round's
    delay-0 uploads have birth t and commit last;
  - each committed observation row is stamped with the upload's BIRTH
    clock (the server clock when it was produced), so the ages of
    per_class and staleness (clock - stamp) count the delay;
  - uploads in flight are parked in a fixed-shape pending buffer of D_max
    slots a client, indexed by birth round mod D_max. Bounded delay makes
    this collision-free: the entry born in round r has committed by round
    r + D_max, when its slot is needed again.

The vectorized engine carries `PendingState` (tensors; `commit_and_park`
runs inside its round step with no host read); the sequential engine
replays the same event order through `HostEventQueue`, and the
vectorized engine's `CommitMirror` replays it payload-free for the
records and the ledger. A delayed upload's per-class sums join the merge
of its commit round, so round t's global prototypes average exactly the
contributions that committed in round t.

On a client mesh the pending buffer is CLIENT_SHARDED (`out_spec`): each
rank parks its own block of upload positions, and `commit_and_park`'s
commit payload (this round's uploads and the parked ones, by upload
position) is the round's one exchange (`relay/placement.py`), after which
every rank appends and merges the same rows and sums.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prototypes
from repro_torch.relay import participation, placement


class PendingState(NamedTuple):
    """In-flight uploads of a fleet, fixed shape, indexed by [upload
    position u, pending slot j = birth round mod D_max].

    obs   (N, D, m, C, d') f32 : parked observation rows
    valid (N, D, C)   bool     : per-class validity of each parked upload
    psum  (N, D, C, d') f32    : parked per-class prototype sums
    pcnt  (N, D, C)   f32      : parked per-class prototype counts
    lsum / lcnt                : fd's logit sums (None otherwise)
    birth (N, D) int32         : round the upload was produced in
    stamp (N, D) int32         : server clock at birth
    commit (N, D) int32        : round the upload is due to commit in
    live  (N, D) bool          : slot holds an in-flight upload
    """
    obs: torch.Tensor
    valid: torch.Tensor
    psum: torch.Tensor
    pcnt: torch.Tensor
    lsum: Optional[torch.Tensor]
    lcnt: Optional[torch.Tensor]
    birth: torch.Tensor
    stamp: torch.Tensor
    commit: torch.Tensor
    live: torch.Tensor

    @property
    def d_max(self) -> int:
        return self.live.shape[1]


def init_pending(n: int, d_max: int, m_up: int, num_classes: int,
                 d_feature: int, fd: bool = False, device=None) -> PendingState:
    """Empty pending buffer for n upload positions; `fd` adds the logit
    sums (C x C)."""
    C, d = num_classes, d_feature
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)
    return PendingState(
        obs=z(n, d_max, m_up, C, d), valid=zb(n, d_max, C),
        psum=z(n, d_max, C, d), pcnt=z(n, d_max, C),
        lsum=z(n, d_max, C, C) if fd else None,
        lcnt=z(n, d_max, C) if fd else None,
        birth=zi(n, d_max), stamp=zi(n, d_max),
        commit=torch.full((n, d_max), -1, dtype=torch.int32, device=device),
        live=zb(n, d_max))


def out_spec(pending: PendingState):
    """Placement declaration (`relay/placement.py`): every leaf is indexed
    [upload position, pending slot, ...] and an in-flight upload is read by
    no other client until it commits, so the whole buffer is CLIENT_SHARDED
    over its leading (upload position) axis; the commit is the exchange
    point (`commit_and_park`'s `mesh`)."""
    return placement.like(pending, placement.CLIENT_SHARDED)


def event_slot_order(round_idx, d_max: int):
    """Pending slots in EVENT (birth-ascending) order for a round-
    `round_idx` commit: the slot of birth round_idx - d_max, ..., of birth
    round_idx - 1. (d_max,) int32; round_idx an int or a 0-d tensor (on
    the device, for no host read)."""
    r = torch.as_tensor(round_idx, dtype=torch.int32)
    births = r - torch.arange(d_max, 0, -1, dtype=torch.int32,
                              device=r.device)
    return torch.remainder(births, d_max).to(torch.int32)


def _rep(a, m: int):
    """Each upload's entry repeated for its m observation rows:
    (k, ...) -> (k * m, ...)."""
    return a.unsqueeze(1).expand(a.shape[0], m, *a.shape[1:]) \
        .reshape(a.shape[0] * m, *a.shape[1:])


def live_after(pending: PendingState, round_idx, delays, mask):
    """The pending buffer's `live` after round `round_idx`'s commit: the due
    uploads retired, this round's delayed ones parked in slot round_idx
    mod D_max. (N, D) bool, with no host read."""
    slot = torch.remainder(round_idx, pending.d_max).reshape(1).long()
    live = pending.live & (pending.commit != round_idx)
    return live.index_copy(1, slot, (mask & (delays > 0)).unsqueeze(1))


_PARKED = ("obs", "valid", "psum", "pcnt", "lsum", "lcnt", "stamp")


def commit_and_park(policy, rstate, pending: PendingState, fresh: Dict,
                    round_idx, delays, mask, mesh=None,
                    layout=placement.CLIENT_SHARDED, extra=None):
    """ONE round of the asynchronous relay, with no host read: commit every
    due event in event order, then park this round's delayed uploads. The
    single relay write of the asynchronous engines.

    fresh: this round's uploads as per-client tensors in UPLOAD (bucket)
    order: dict(obs (N, m, C, d'), valid (N, C), psum (N, C, d'), pcnt
    (N, C), lsum/lcnt (fd) or absent, owner (N,) int32 client ids).
    round_idx a 0-d int32 tensor; delays (N,) int32 this round's commit
    delays and mask (N,) bool participation, both in upload order.

    mesh: a client mesh, on which N is this rank's block of upload
    positions (`layout`: CLIENT_SHARDED, or `placement.Blocks` for a mixed
    fleet). The commit payload, this round's uploads and the parked ones
    by upload position with their commit masks and birth stamps, is THE
    round's exchange (`placement.exchange`; the identity off a mesh): every
    rank then appends the same rows in event order and reduces the same
    per-position sums in the unsharded order, and parks its own block.
    `extra`, client-sharded leaves of the same layout (telemetry's inputs),
    rides the exchange and comes back gathered as a third output.

    Returns (new_rstate, new_pending). A round with no commit leaves rstate
    untouched (no append, no merge, no clock tick): `keep_if` on the
    device."""
    owner = fresh["owner"]
    dev = owner.device
    D = pending.d_max
    round_idx = torch.as_tensor(round_idx, dtype=torch.int32, device=dev)
    fresh_commit = mask & (delays == 0)
    fresh_stamp = policy.stamp_now(rstate, owner)
    payload = {"fresh": dict(fresh, commit=fresh_commit, stamp=fresh_stamp)}
    if D > 0:
        payload["parked"] = dict(
            {k: getattr(pending, k) for k in _PARKED},
            due=pending.live & (pending.commit == round_idx))
    payload, shared = placement.exchange((payload, extra), mesh, layout)
    f = payload["fresh"]
    owner_all = f["owner"]
    N, m = f["obs"].shape[:2]
    wf = f["commit"].to(torch.float32)

    # -- the commit set in event order: parked slots, then the fresh rows --
    obs_rows = f["obs"].reshape(N * m, *f["obs"].shape[2:])
    valid_rows = _rep(f["valid"], m)
    owner_rows = _rep(owner_all, m)
    row_mask = _rep(f["commit"], m)
    stamp_rows = _rep(f["stamp"], m)
    any_commit = f["commit"].any()
    po = {}
    if D > 0:
        order = event_slot_order(round_idx, D)
        po = {k: None if v is None else v.movedim(0, 1).index_select(0, order)
              for k, v in payload["parked"].items()}          # (D, N, ...)
        flat = lambda a: a.reshape(D * N, *a.shape[2:])
        obs_rows = torch.cat([po["obs"].reshape(D * N * m,
                                                *po["obs"].shape[3:]),
                              obs_rows])
        valid_rows = torch.cat([_rep(flat(po["valid"]), m), valid_rows])
        owner_rows = torch.cat([_rep(owner_all.expand(D, N).reshape(-1), m),
                                owner_rows])
        row_mask = torch.cat([_rep(flat(po["due"]), m), row_mask])
        stamp_rows = torch.cat([_rep(flat(po["stamp"]), m), stamp_rows])
        wdue = po["due"].to(torch.float32)
        any_commit = any_commit | po["due"].any()

    def reduce(fsum, fcnt, parked_sum, parked_cnt):
        """The committing uploads' prototype sums: the mask-weighted sum
        over upload positions, as the synchronous step reduces them, plus
        the due parked sums. A policy with `reduce_uploads` (cohort shards)
        takes each position's fresh contribution plus its due parked ones
        instead, and segments them by the position's owner: a position's
        owner is fixed (arrivals do not run with an upload clock), so its
        parked sums are its own."""
        if policy.reduce_uploads is None:
            s = (fsum * wf[:, None, None]).sum(0)
            c = (fcnt * wf[:, None]).sum(0)
            if D > 0:
                s = s + (parked_sum * wdue[:, :, None, None]).sum((0, 1))
                c = c + (parked_cnt * wdue[:, :, None]).sum((0, 1))
            return prototypes.ProtoState(s, c)
        s = fsum * wf[:, None, None]
        c = fcnt * wf[:, None]
        if D > 0:
            s = s + (parked_sum * wdue[:, :, None, None]).sum(0)
            c = c + (parked_cnt * wdue[:, :, None]).sum(0)
        return policy.reduce_uploads(s, c, torch.ones_like(wf), owner_all)

    proto = reduce(f["psum"], f["pcnt"], po.get("psum"), po.get("pcnt"))
    logit = (reduce(f["lsum"], f["lcnt"], po.get("lsum"), po.get("lcnt"))
             if f.get("lsum") is not None else None)
    new = policy.append(rstate, obs_rows, valid_rows, owner_rows, row_mask,
                        stamp_rows)
    new = policy.merge_round(new, proto, logit)
    rstate = participation.keep_if(any_commit, new, rstate)

    # -- park this rank's delayed uploads in slot round_idx mod D ----------
    out = (rstate, pending)
    if D > 0:
        n = owner.shape[0]
        slot = torch.remainder(round_idx, D).reshape(1).long()
        put = lambda buf, v: (None if buf is None
                              else buf.index_copy(1, slot, v.unsqueeze(1)))
        out = (rstate, pending._replace(
            obs=put(pending.obs, fresh["obs"]),
            valid=put(pending.valid, fresh["valid"]),
            psum=put(pending.psum, fresh["psum"]),
            pcnt=put(pending.pcnt, fresh["pcnt"]),
            lsum=put(pending.lsum, fresh.get("lsum")),
            lcnt=put(pending.lcnt, fresh.get("lcnt")),
            birth=put(pending.birth, round_idx.expand(n)),
            stamp=put(pending.stamp, fresh_stamp),
            commit=put(pending.commit, (round_idx + delays).to(torch.int32)),
            live=live_after(pending, round_idx, delays, mask)))
    return out if extra is None else out + (shared,)


# ---------------------------------------------------------------------------
# the sequential engine's replay queue and the host-side commit mirror
# ---------------------------------------------------------------------------
class HostEventQueue:
    """Host-side event log. Events are (birth, pos, client_id, stamp,
    payload); `pop_due(t)` returns round t's commit set sorted by (birth,
    pos), the order `commit_and_park` appends rows in."""

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


class CommitMirror:
    """A payload-free `HostEventQueue`, so the vectorized engine reports
    each round's commits and bills the ledger without reading the pending
    buffer: both engines derive the same (birth, client) commit sets from
    the same masks and delays through the same queue."""

    def __init__(self):
        self._q = HostEventQueue()

    def step(self, round_idx: int, mask: np.ndarray, delays: np.ndarray,
             upload_order) -> List[Tuple[int, int]]:
        """Advance one round -> its commits as [(birth round, client id),
        ...] in event order."""
        for pos, cid in enumerate(upload_order):
            if mask[cid]:
                self._q.push(birth=round_idx, pos=pos, client_id=int(cid),
                             stamp=0, payload=None, delay=int(delays[cid]))
        return [(birth, cid)
                for birth, _, cid, *_ in self._q.pop_due(round_idx)]
