"""Relay policies, participation schedules and the asynchronous relay (the
port of `repro/relay/__init__.py` without the placement and shard parts):
`FlatRelay`, `PerClassRelay` and `StalenessRelay` behind the contract of
`relay/base.py`, resolved by `get_policy`; `RelayServer` binds one to a
live state for the sequential engine; the schedules of
`relay/participation.py`, resolved by `get_schedule`; `relay.events`, the
event-ordered commit log of bounded-delay uploads, and `relay.history`, the
snapshot ring of stale downloads, both driven by `repro_torch.sim`
clocks."""
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
from repro_torch.relay.staleness import (StalenessRelay,  # noqa: F401
                                         StalenessRelayState,
                                         staleness_weights)
from repro_torch.specs import parse_spec

POLICIES = {"flat": FlatRelay, "per_class": PerClassRelay,
            "staleness": StalenessRelay, "sharded": None}


def get_policy(spec: Union[str, RelayPolicy, None], **kwargs) -> RelayPolicy:
    """Resolve a policy name ("flat" | "per_class" | "staleness", or
    "staleness:<lam>") or instance; None is the flat policy. "sharded"
    raises NotImplementedError: cohort shards come with population scale."""
    if spec is None:
        return FlatRelay()
    if isinstance(spec, RelayPolicy):
        return spec
    name, args = parse_spec(spec, "relay policy", POLICIES)
    if name == "sharded":
        raise NotImplementedError(
            f"relay policy {spec!r}: cohort shards come with population "
            "scale (ROADMAP slice 5)")
    if name == "staleness" and args:
        kwargs.setdefault("lam", float(args[0]))
    return POLICIES[name](**kwargs)
