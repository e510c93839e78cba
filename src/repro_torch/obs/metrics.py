"""Round telemetry: one fixed-shape `RoundTelemetry` of tensors a round; the
port of `repro/obs/metrics.py` (without `out_spec`: placement comes with
multi-device, ROADMAP slice 9).

The vectorized engine computes it INSIDE its round step (a build flag of the
step: with it off the step's inputs, outputs and device ops are exactly
those of a step built without it), from the relay, pending and history state
the step already holds, with no host read. The bucketed engine computes it
once after its shared commit (`make_telemetry_fn`). The sequential engine
computes the same function over its ring, which is equal integer for
integer, with the event-log quantities it counts on the host (the lags of
its commits, its queue depth, its download delays) passed in
(`make_host_telemetry_fn`). So the integer leaves agree exactly across the
engines, and the float leaves within the engines' summation-order
tolerance.

Leaves (C = num_classes, B = STALE_BINS, n_b = bucket count):

  occupancy        ()    int32  live ring slots (owner != EMPTY_OWNER)
  fill             (C,)  int32  valid observations a class across the ring
  owner_diversity  ()    int32  distinct real clients (owner >= 0) owning
                                at least one live slot; seeds excluded
  stale_hist       (B,)  int32  ages of live slots in the POST-round state,
                                age = clock - stamp, clipped into bin B-1
  pending_depth    ()    int32  uploads still in flight after the round
  commit_hist      (B,)  int32  this round's commits by commit lag (commit
                                round - birth round); bin 0 is the delay-0
                                uploads, so late commits = commit_hist[1:]
  stale_reads      ()    int32  present clients that read a stale snapshot
                                (download delay > 0)
  proto_drift      ()    f32    ||global_protos - last round's||_2
  bucket_loss      (n_b,) f32   mean last-batch total loss over the
                                bucket's PRESENT clients
  bucket_grad_norm (n_b,) f32   the same mean of the gradient norm

The histograms are fixed-length adds of one-hot rows into B bins, never
`torch.bincount`, which on CUDA reads its input's maximum to size the
output (a host sync). A sharded state is summarized shard by shard under
`torch.func.vmap` and summed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.relay.base import EMPTY_OWNER

# One histogram width for stale_hist and commit_hist: ages and lags
# 0..STALE_BINS-2 get their own bin, everything older the last one.
STALE_BINS = 8


class RoundTelemetry(NamedTuple):
    occupancy: torch.Tensor          # () int32
    fill: torch.Tensor               # (C,) int32
    owner_diversity: torch.Tensor    # () int32
    stale_hist: torch.Tensor         # (STALE_BINS,) int32
    pending_depth: torch.Tensor      # () int32
    commit_hist: torch.Tensor        # (STALE_BINS,) int32
    stale_reads: torch.Tensor        # () int32
    proto_drift: torch.Tensor        # () f32
    bucket_loss: torch.Tensor        # (n_buckets,) f32
    bucket_grad_norm: torch.Tensor   # (n_buckets,) f32


# The integer leaves come from ring, clock and event bookkeeping that the
# engines hold equal, so they agree exactly; the float leaves carry the
# engines' summation-order tolerance.
EXACT_LEAVES = ("occupancy", "fill", "owner_diversity", "stale_hist",
                "pending_depth", "commit_hist", "stale_reads")
FLOAT_LEAVES = ("proto_drift", "bucket_loss", "bucket_grad_norm")


def _hist(bins, weights):
    """(STALE_BINS,) int32 counts of `weights` (bool) by `bins` (ints in
    [0, STALE_BINS)): a sum of one-hot rows, fixed length, vmappable."""
    one_hot = bins.reshape(-1, 1) == torch.arange(
        STALE_BINS, dtype=bins.dtype, device=bins.device)
    return (one_hot & weights.reshape(-1, 1)).sum(0, dtype=torch.int32)


def _single_summary(state):
    """(occupancy, fill, owner_diversity, stale_hist) of ONE relay state.

    flat and staleness rings hold valid (cap, C) and owner (cap,); per_class
    holds valid (C, cap_c) and owner (C, cap_c), and is told apart by its
    per-class write pointers (`ptr` of rank 1)."""
    per_class = state.ptr.dim() == 1
    owner = state.owner.reshape(-1)
    live = owner != EMPTY_OWNER
    fill = state.valid.sum(1 if per_class else 0, dtype=torch.int32)
    occupancy = live.sum(dtype=torch.int32)
    # distinct real owners by sorting: dead slots and seeds sort to the
    # sentinel, and a real owner counts where it differs from its sorted
    # predecessor. Unlike a scatter onto an (N,) count this does not depend
    # on the id space, which streaming arrivals leave unbounded.
    sentinel = torch.iinfo(torch.int32).max
    key = torch.sort(torch.where(live & (owner >= 0), owner,
                                 sentinel)).values
    first = torch.ones_like(key[:1], dtype=torch.bool)
    distinct = (key != sentinel) & torch.cat([first, key[1:] != key[:-1]])
    owner_diversity = distinct.sum(dtype=torch.int32)
    age = (state.clock - state.stamp.reshape(-1)).clamp(0, STALE_BINS - 1)
    return occupancy, fill, owner_diversity, _hist(age, live)


def _per_shard(state):
    """`_single_summary` of every shard of a sharded state, each leaf
    stacked (S, ...); a single relay as one shard."""
    if hasattr(state, "shards"):
        return torch.func.vmap(_single_summary)(state.shards)
    return tuple(leaf[None] for leaf in _single_summary(state))


def relay_summary(state, n_clients: int = 0):
    """(occupancy, fill, owner_diversity, stale_hist) of a relay state. A
    sharded state sums its shards: a client hashes to exactly one shard, so
    the distinct owners add up too. `n_clients` is unused (the reference's
    signature)."""
    if not hasattr(state, "shards"):
        return _single_summary(state)
    occ, fill, div, hist = _per_shard(state)
    return (occ.sum(dtype=torch.int32), fill.sum(0, dtype=torch.int32),
            div.sum(dtype=torch.int32), hist.sum(0, dtype=torch.int32))


def shard_summary(state, n_clients: int = 0) -> dict:
    """Host dict of the PER-SHARD occupancy, owner diversity and age
    histogram (a single relay reports itself as one shard): the
    population sweep's report surface."""
    occ, _, div, hist = _per_shard(state)
    return {"occupancy": occ.tolist(), "owner_diversity": div.tolist(),
            "stale_hist": hist.tolist()}


def round_telemetry(prev_state, new_state, n_clients: int = 0, *, mask,
                    loss_parts, gnorm_parts, mask_parts,
                    pending=None, pending_pre=None, round_idx=None,
                    delays=None, dl=None,
                    commit_hist=None, pending_depth=None) -> RoundTelemetry:
    """The one telemetry computation of every engine path.

    prev_state / new_state: the relay state at round start (after any
    eviction) and at round end. mask: (N,) bool participation.
    loss_parts / gnorm_parts / mask_parts: one (k_b,) tensor a bucket, in
    bucket order, absent clients zeroed (one entry for a homogeneous fleet).

    The commit-lag histogram has two sources. The vectorized engine passes
    the PRE-commit pending buffer (`pending_pre`, `round_idx`, `delays`)
    and the lags are recomputed from the due-event predicate
    `events.commit_and_park` uses; bin 0 counts the present clients with
    delay 0 (all present clients without `delays`). The sequential engine,
    which replays events on the host, passes its own `commit_hist` and
    `pending_depth` as tensors. Both count the same events."""
    occupancy, fill, owner_diversity, stale_hist = relay_summary(new_state)
    # zeros by a fill on the device: a tensor made from a host value is a
    # copy that waits for the device
    zero = torch.zeros((), dtype=torch.int32, device=occupancy.device)
    if pending_depth is not None:
        pending_depth = pending_depth.to(torch.int32).reshape(())
    elif pending is not None:
        pending_depth = pending.live.sum(dtype=torch.int32)
    else:
        pending_depth = zero
    if commit_hist is not None:
        commit_hist = commit_hist.to(torch.int32)
    else:
        fresh = mask & (delays == 0) if delays is not None else mask
        commit_hist = _hist(torch.zeros_like(fresh, dtype=torch.int32), fresh)
        if pending_pre is not None and pending_pre.d_max > 0:
            due = pending_pre.live & (pending_pre.commit == round_idx)
            lag = (round_idx - pending_pre.birth).clamp(0, STALE_BINS - 1)
            commit_hist = commit_hist + _hist(lag, due)
    stale_reads = ((mask & (dl > 0)).sum(dtype=torch.int32)
                   if dl is not None else zero)
    dp = new_state.global_protos - prev_state.global_protos
    proto_drift = torch.sqrt(torch.square(dp).sum()).to(torch.float32)
    bl, bg = [], []
    for lp, gp, mp in zip(loss_parts, gnorm_parts, mask_parts):
        n_b = mp.to(torch.float32).sum().clamp(min=1.0)
        bl.append(lp.sum() / n_b)
        bg.append(gp.sum() / n_b)
    return RoundTelemetry(
        occupancy=occupancy, fill=fill, owner_diversity=owner_diversity,
        stale_hist=stale_hist, pending_depth=pending_depth,
        commit_hist=commit_hist, stale_reads=stale_reads,
        proto_drift=proto_drift,
        bucket_loss=torch.stack(bl).to(torch.float32),
        bucket_grad_norm=torch.stack(bg).to(torch.float32))


def make_telemetry_fn(n_clients: int, asynchronous: bool = False,
                      lagged: bool = False):
    """`round_telemetry` for the BUCKETED vectorized engine, which runs it
    once after the shared commit (its bucket steps and the commit are
    separate calls, so there is no single step to put it in). Signature
    `fn(prev_state, new_state, mask, mask_parts, loss_parts, gnorm_parts,
    *rest)`: `rest` is (pending_pre, pending_post, round_idx, delays) when
    `asynchronous`, then (dl,) when `lagged`."""

    def fn(prev_state, new_state, mask, mask_parts, loss_parts,
           gnorm_parts, *rest):
        pending_pre = pending = round_idx = delays = dl = None
        if asynchronous:
            pending_pre, pending, round_idx, delays = rest[:4]
            rest = rest[4:]
        if lagged:
            dl = rest[0]
        return round_telemetry(
            prev_state, new_state, n_clients, mask=mask,
            loss_parts=loss_parts, gnorm_parts=gnorm_parts,
            mask_parts=mask_parts, pending=pending,
            pending_pre=pending_pre, round_idx=round_idx, delays=delays,
            dl=dl)

    return fn


def make_host_telemetry_fn(n_clients: int):
    """`round_telemetry` for the SEQUENTIAL engine: the relay reductions over
    its ring, and the event-log quantities it counts on the host (the lag
    histogram of its commits, its queue depth, the download delays)
    passed in."""

    def fn(prev_state, new_state, mask, mask_parts, loss_parts,
           gnorm_parts, commit_hist, pending_depth, dl):
        return round_telemetry(
            prev_state, new_state, n_clients, mask=mask,
            loss_parts=loss_parts, gnorm_parts=gnorm_parts,
            mask_parts=mask_parts, commit_hist=commit_hist,
            pending_depth=pending_depth, dl=dl)

    return fn


def to_record(telem: RoundTelemetry) -> dict:
    """JSON-safe host dict of one round's telemetry: scalars as Python int
    or float, vectors as lists; the `telemetry` entry of both engines'
    round records. Every leaf goes into one float64 tensor (exact for int32
    and float32) and crosses to the host in ONE copy, not one a leaf."""
    flat = torch.cat([leaf.reshape(-1).to(torch.float64)
                      for leaf in telem]).cpu().tolist()
    out, at = {}, 0
    for name, leaf in zip(RoundTelemetry._fields, telem):
        cast = float if leaf.is_floating_point() else int
        vals = [cast(v) for v in flat[at:at + leaf.numel()]]
        at += leaf.numel()
        out[name] = vals[0] if leaf.dim() == 0 else vals
    return out
