"""Relay policies, participation schedules and the asynchronous relay (the
port of `repro/relay/__init__.py` without the placement parts):
`FlatRelay`, `PerClassRelay`, `StalenessRelay` and `ShardedRelay` (cohort
shards over any of them) behind the contract of `relay/base.py`, resolved
by `get_policy`; `RelayServer` binds one to a live state for the
sequential engine; the schedules of `relay/participation.py`, resolved by
`get_schedule`; `relay.events`, the event-ordered commit log of
bounded-delay uploads, and `relay.history`, the snapshot ring of stale
downloads, both driven by `repro_torch.sim` clocks."""
from __future__ import annotations

from typing import Union

from repro_torch.relay import events, history  # noqa: F401
from repro_torch.relay.base import (EMPTY_OWNER, SEED_OWNER,  # noqa: F401
                                    TEACHER_KEYS, RelayPolicy,
                                    default_capacity)
from repro_torch.relay.flat import FlatRelay, RelayState  # noqa: F401
from repro_torch.relay.participation import (  # noqa: F401
    AdaptiveParticipation, BernoulliP, Cyclic, FullParticipation,
    ParticipationSchedule, UniformK, get_schedule)
from repro_torch.relay.per_class import (PerClassRelay,  # noqa: F401
                                         PerClassRelayState)
from repro_torch.relay.server import RelayServer  # noqa: F401
from repro_torch.relay.shards import (ShardedRelay,  # noqa: F401
                                      ShardedRelayState, shard_of,
                                      shard_view)
from repro_torch.relay.staleness import (StalenessRelay,  # noqa: F401
                                         StalenessRelayState,
                                         staleness_weights)
from repro_torch.specs import parse_spec

POLICIES = {"flat": FlatRelay, "per_class": PerClassRelay,
            "staleness": StalenessRelay, "sharded": ShardedRelay}


def get_policy(spec: Union[str, RelayPolicy, None], **kwargs) -> RelayPolicy:
    """Resolve a policy name ("flat" | "per_class" | "staleness", or
    "staleness:<lam>") or instance; None is the flat policy.
    "sharded:<inner>,<S>[,<gossip_every>]" wraps an inner policy name in S
    cohort shards (an inner policy with its own arguments is passed as an
    instance: ShardedRelay(inner=StalenessRelay(lam=...), shards=S))."""
    if spec is None:
        return FlatRelay()
    if isinstance(spec, RelayPolicy):
        return spec
    name, args = parse_spec(spec, "relay policy", POLICIES)
    if name == "staleness" and args:
        kwargs.setdefault("lam", float(args[0]))
    if name == "sharded":
        if args:
            kwargs.setdefault("inner", get_policy(args[0]))
        if len(args) > 1:
            kwargs.setdefault("shards", int(args[1]))
        if len(args) > 2:
            kwargs.setdefault("gossip_every", int(args[2]))
    return POLICIES[name](**kwargs)
