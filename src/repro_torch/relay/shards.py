"""Cohort-sharded relay: S independent relays and periodic prototype gossip;
the port of `repro/relay/shards.py`.

The paper's claim is that relay cost follows the ring capacity and the
participants a round, never the population. One global ring breaks that
at population scale: every append goes through one write pointer, every
client samples one pool, and capacity has to grow with the population to
keep owners diverse. So the relay is sharded by client: each client
hashes to one of S shards (`shard_of`, a pure integer mix of its id, so a
client's shard never changes), and each shard is a complete inner policy
state, so flat, per_class and staleness work unchanged.

Layout. `ShardedRelayState.shards` is the inner policy's state with every
leaf stacked along a leading (S,) axis, and `torch.func.vmap` over that
axis runs the inner policy's functions once a shard, with no change to
them. The delegating properties (`ptr`, `owner`, `clock`, ..., each
(S, ...)) keep the engines' and the tests' readers shape-generic.

Per-shard clocks. A shard ticks its clock only in a round in which its
own cohort committed: a shard with no prototype mass this round is frozen
leaf for leaf (no merge, no ageing, no tick). Uploads are stamped with
their OWNER's shard clock (`stamp_now`, `host_stamps`), so age = clock -
stamp stays a within-shard quantity.

Gossip. Every `gossip_every`-th merge (counted by `merges`, which advances
only on rounds that commit), the active shards replace their prototypes by
the per-class weighted mean of this round's per-shard sums, sum_s sum_s /
max(sum_s cnt_s, 1): empty shards weigh nothing (no 0/0), quiet shards do
not receive (they are frozen), and classes with no mass anywhere keep each
shard's own merge. With S = 1 the gossip mean IS the inner merge and
`reduce_uploads` is the engines' own weighted sum, op for op, so
`sharded:<inner>,1` evolves the state of `<inner>` bit for bit.

On a client mesh the stacked state is REPLICATED (`out_spec`): every rank
runs the same reduction and merge over the round's gathered uploads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prototypes
from repro_torch.relay import base, flat
from repro_torch.tree import tree_map
from repro_torch.types import CollabConfig

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for 0 <= x < 2**32 in int64, with no product past
    2**48: c is split into 16-bit halves (the product of x and a full 32-bit
    constant would overflow int64)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def shard_of(client_id, n_shards: int):
    """A client's shard: a 32-bit murmur-style mix of its id, mod S, bit for
    bit the reference's uint32 arithmetic. The id is first reduced mod 2**32
    as the reference's uint32 cast does (SEED_OWNER -1 and EMPTY_OWNER -2
    included), and the mix runs in int64 (torch has no shifts or remainders
    for uint32). A tensor gives an int32 tensor on its device; an int or an
    array gives numpy int32 (the host form of the sequential engine)."""
    if isinstance(client_id, torch.Tensor):
        x, cast = client_id.to(torch.int64), (lambda a: a.to(torch.int32))
    else:
        x, cast = (np.asarray(client_id, dtype=np.int64),
                   (lambda a: a.astype(np.int32)))
    x = x & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return cast(x % max(1, n_shards))


class ShardedRelayState(NamedTuple):
    """The inner policy's state with every leaf stacked (S, ...), and the
    merge counter that times the gossip (0-d int32)."""
    shards: Any
    merges: torch.Tensor

    @property
    def obs(self):
        return self.shards.obs

    @property
    def valid(self):
        return self.shards.valid

    @property
    def owner(self):
        return self.shards.owner

    @property
    def ptr(self):
        return self.shards.ptr

    @property
    def global_protos(self):
        return self.shards.global_protos

    @property
    def valid_g(self):
        return self.shards.valid_g

    @property
    def mean_logits(self):
        return self.shards.mean_logits

    @property
    def stamp(self):
        return self.shards.stamp

    @property
    def clock(self):
        return self.shards.clock                    # (S,) per-shard clocks

    @property
    def age(self):
        return self.shards.age          # AttributeError when the inner has none

    @property
    def n_shards(self) -> int:
        return self.shards.owner.shape[0]


def shard_view(state: ShardedRelayState, s):
    """Shard s's inner state (s an int or a 0-d tensor)."""
    return tree_map(lambda leaf: leaf[s], state.shards)


@dataclass(frozen=True)
class ShardedRelay(base.RelayPolicy):
    """S inner relays, hash routing by owner and periodic prototype
    gossip."""
    inner: base.RelayPolicy = field(default_factory=flat.FlatRelay)
    shards: int = 1
    gossip_every: int = 1
    name: str = "sharded"

    def __post_init__(self):
        if self.shards < 1:
            raise ValueError("sharded relay needs at least one shard")
        if self.gossip_every < 1:
            raise ValueError("gossip_every must be >= 1")
        if isinstance(self.inner, ShardedRelay):
            raise ValueError("sharded relay cannot nest another sharded relay")

    def init_state(self, ccfg: CollabConfig, d_feature: int, seed: int = 0,
                   capacity: Optional[int] = None, n_clients: int = 2,
                   device=None) -> ShardedRelayState:
        """Every shard starts from the SAME Algorithm-1 init (the common
        anchor that aligns feature spaces, and keeps the gossip meaningful
        from the first exchange). `capacity` is per shard."""
        one = self.inner.init_state(ccfg, d_feature, seed, capacity,
                                    n_clients, device=device)
        stacked = tree_map(lambda leaf: torch.stack([leaf] * self.shards),
                           one)
        return ShardedRelayState(shards=stacked, merges=torch.zeros(
            (), dtype=torch.int32, device=one.owner.device))

    def _shard_ids(self, device):
        return torch.arange(self.shards, dtype=torch.int32, device=device)

    def append(self, state, obs_rows, valid_rows, owner_rows, row_mask=None,
               stamp_rows=None):
        """Each row goes to its owner's shard only: shard s appends the rows
        masked in and hashed to s (the others consume no slot there)."""
        if row_mask is None:
            row_mask = torch.ones(owner_rows.shape[0], dtype=torch.bool,
                                  device=owner_rows.device)
        row_shard = shard_of(owner_rows, self.shards)

        def one(shard_state, s):
            return self.inner.append(shard_state, obs_rows, valid_rows,
                                     owner_rows, row_mask & (row_shard == s),
                                     stamp_rows)

        new = torch.func.vmap(one)(state.shards,
                                   self._shard_ids(row_shard.device))
        return state._replace(shards=new)

    def noise_shape(self, state, m_down):
        """One client draws on one shard: the inner policy's shape there."""
        return self.inner.noise_shape(shard_view(state, 0), m_down)

    def sample_teachers(self, state, client_ids, m_down, noise, picks):
        """Each client samples its OWN shard only (a download touches the
        per-shard capacity, not S of it). The inner sampler runs for the
        fleet on every shard at once (`vmap` over the shard axis: each
        draw gathers only its m_down rows), and each client keeps the
        teacher of its shard: the client's noise is the inner policy's on
        one shard, as in the reference."""
        t = torch.func.vmap(lambda st: self.inner.sample_teachers(
            st, client_ids, m_down, noise, picks))(state.shards)
        sh = shard_of(client_ids, self.shards).long()
        n = torch.arange(sh.shape[0], device=sh.device)
        return {k: v[sh, n] for k, v in t.items()}

    def reduce_uploads(self, psum, pcnt, w, owners):
        """Per-shard partial sums, (S, C, ...) and (S, C), of the uploads'
        contributions weighted by `w`. S = 1 is the engines' own weighted
        sum, op for op (the bit-compatibility anchor)."""
        if self.shards == 1:
            return prototypes.ProtoState(
                (psum * w[:, None, None]).sum(0)[None],
                (pcnt * w[:, None]).sum(0)[None])
        oh = shard_of(owners, self.shards)[:, None] == self._shard_ids(
            owners.device)[None, :]
        wsh = w[:, None] * oh.to(w.dtype)                         # (k, S)
        return prototypes.ProtoState(
            torch.einsum("ks,kcd->scd", wsh, psum.float()),
            torch.einsum("ks,kc->sc", wsh, pcnt.float()))

    def merge_round(self, state, proto, logit=None):
        """Per-shard merge, a quiet shard frozen, then the gossip.
        `proto`/`logit` lead with (S,) (`reduce_uploads`). A shard is ACTIVE
        iff it received prototype mass this round; inactive shards keep
        every leaf (no recompute, no ageing, no tick)."""
        S = self.shards
        active = proto.count.sum(-1) > 0                          # (S,)
        if logit is None:
            merged = torch.func.vmap(
                lambda st, p: self.inner.merge_round(st, p))(state.shards,
                                                            proto)
        else:
            merged = torch.func.vmap(self.inner.merge_round)(
                state.shards, proto, logit)
        apply = active & ((state.merges + 1) % self.gossip_every == 0)
        gcnt = proto.count.sum(0)                                 # (C,)
        gmean = proto.sum.sum(0) / gcnt.clamp(min=1.0)[:, None]
        merged = merged._replace(
            global_protos=torch.where(
                apply[:, None, None] & (gcnt > 0)[None, :, None],
                gmean[None], merged.global_protos),
            valid_g=torch.where(apply[:, None], (gcnt > 0)[None],
                                merged.valid_g))
        if logit is not None:
            lcnt = logit.count.sum(0)
            lmean = logit.sum.sum(0) / lcnt.clamp(min=1.0)[:, None]
            merged = merged._replace(mean_logits=torch.where(
                apply[:, None, None] & (lcnt > 0)[None, :, None],
                lmean[None], merged.mean_logits))
        keep = tree_map(lambda new, old: torch.where(
            active.reshape((S,) + (1,) * (new.dim() - 1)), new, old),
            merged, state.shards)
        return ShardedRelayState(shards=keep, merges=state.merges + 1)

    def evict_owners(self, state, owners):
        """Evicted owners leave every shard (their rows only ever lived in
        their own shard; elsewhere nothing matches)."""
        new = torch.func.vmap(lambda st: self.inner.evict_owners(st, owners))(
            state.shards)
        return state._replace(shards=new)

    def stamp_now(self, state, owners):
        """Each owner's birth stamp is its shard's clock."""
        return state.clock[shard_of(owners, self.shards).long()].to(
            torch.int32)

    def host_stamps(self, state, owners) -> np.ndarray:
        clocks = state.clock.cpu().numpy()
        return clocks[shard_of(np.asarray(owners, np.int64),
                               self.shards)].astype(np.int64)

    def debug_entries(self, state):
        """The inner policy's entries of every shard, each tagged with its
        shard."""
        return [{**e, "shard": s} for s in range(self.shards)
                for e in self.inner.debug_entries(shard_view(state, s))]
