"""Placement: where each piece of fleet state lives on a client mesh; the
port of `repro/relay/placement.py`.

The fleet holds three kinds of round state, and they want different homes
when the client axis is spread over ranks:

  - relay states (flat, per_class, staleness and sharded rings, global
    prototypes): the SHARED pool every client reads and the server merges,
    REPLICATED: every rank holds it whole;
  - the client stacks (parameters, Adam state, data, batches) and the
    asynchronous pending buffer (`relay/events.py`): one row a client or
    upload position, CLIENT_SHARDED over the leading axis, a contiguous
    block of N / W rows a rank, in rank order;
  - the download-lag history ring (`relay/history.py`): snapshots of a
    replicated state, REPLICATED.

The state classes DECLARE their placement (`RelayPolicy.out_spec`,
`events.out_spec`, `history.out_spec`, `obs.metrics.out_spec`), and
`resolve` turns a declaration into DTensor placements on a `DeviceMesh`:
`(Shard(0),)` or `(Replicate(),)`, which the vectorized engine reads to
decide what it slices into rank blocks and what it holds whole.

The reference is single-controller: GSPMD reads the declarations as jit
shardings and inserts the collectives. The port is multi-controller (one
process a rank), so the one collective is explicit, and the same for every
fleet composition: `exchange`, called once a round on the commit payload
right before the relay append and merge. It gathers the CLIENT_SHARDED
leaves of a tree over the "clients" group, in rank order, which for
contiguous blocks is the upload order. Everything before it in the round
is local along the client axis; after it every rank runs the unchanged
append and merge on the same full payload, so the relay state stays equal
on every rank and equal to the one-rank engine's. Off a mesh `exchange` is
the identity, and the round body is the same code.

`EXCHANGES` counts the calls (like `kernels.ops.LAUNCHES`): "exchange" the
round's exchanges, on a mesh or off it, "gather" the gathers of records,
accuracies and `client_params` outside the round step.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch import sharding
from repro_torch.tree import leaves, tree_map

# Placement of one state leaf. CLIENT_SHARDED means the LEADING axis is the
# client (or upload position) axis; everything else is REPLICATED.
REPLICATED = "replicated"
CLIENT_SHARDED = "client_sharded"

# The vectorized engine's mesh axis (sharding.client_mesh).
CLIENT_AXIS = sharding.CLIENTS

_VALID = (REPLICATED, CLIENT_SHARDED)

EXCHANGES = {"exchange": 0, "gather": 0}

# byte alignment of each leaf in the packed exchange buffer (the widest
# dtype a leaf has, int64 / float64)
_ALIGN = 8


def reset_exchanges() -> None:
    for k in EXCHANGES:
        EXCHANGES[k] = 0


def _check(placement: str):
    if placement not in _VALID:
        raise ValueError(
            f"unknown placement: {placement!r} (have {sorted(_VALID)})")


class Blocks(tuple):
    """The placement of a leading axis made of consecutive blocks, each
    with its own tag: ((tag, length on this rank), ...). A mixed fleet's
    client and upload-position axis: a bucket whose size the mesh divides
    is CLIENT_SHARDED (its rank block here), any other REPLICATED (whole on
    every rank, so that its rows enter the exchange once, not W times)."""

    def __new__(cls, blocks: Sequence[Tuple[str, int]]):
        out = tuple((tag, int(n)) for tag, n in blocks)
        for tag, _ in out:
            _check(tag)
        return super().__new__(cls, out)

    @property
    def local_size(self) -> int:
        return sum(n for _, n in self)


def like(tree, placement: str):
    """`tree`'s structure with every tensor leaf replaced by `placement`
    (None stays None)."""
    _check(placement)
    return tree_map(lambda _: placement, tree)


def device_spec(mesh, placement: str, axis: str = CLIENT_AXIS):
    """ONE placement tag as DTensor placements on `mesh`: the leading dim
    over `axis` for CLIENT_SHARDED, replicated otherwise."""
    _check(placement)
    if placement == CLIENT_SHARDED:
        return sharding.leading_axis(mesh, axis)
    return sharding.replicated(mesh)


def resolve(placements, mesh, axis: str = CLIENT_AXIS):
    """A placement tree (an `out_spec` declaration), or one tag, as DTensor
    placements on `mesh`, leaf for leaf."""
    if isinstance(placements, str):
        return device_spec(mesh, placements, axis)
    return tree_map(lambda p: device_spec(mesh, p, axis), placements)


def rank_block(mesh, n: int, placement: str = CLIENT_SHARDED,
               axis: str = CLIENT_AXIS) -> Tuple[int, int]:
    """[lo, hi): the rows of an n-row leading axis this rank holds. A
    client-sharded axis is split in W contiguous blocks, block r on rank r
    (W must divide n); a replicated one, or any axis off a mesh, is held
    whole."""
    _check(placement)
    if mesh is None or placement != CLIENT_SHARDED:
        return 0, n
    w = sharding.axis_size(mesh, axis)
    if n % w:
        raise ValueError(f"{n} rows do not split into {w} equal rank blocks")
    r = mesh.get_local_rank(axis)
    return r * (n // w), (r + 1) * (n // w)


def exchange(tree, mesh, spec=CLIENT_SHARDED, axis: str = CLIENT_AXIS):
    """THE round's cross-rank exchange: every CLIENT_SHARDED leaf of `tree`
    gathered over the mesh's `axis` group along its leading axis, in rank
    order, in ONE collective; REPLICATED leaves and None pass as they are.
    `spec` is a tag for every leaf or a `Blocks` layout of every leaf's
    leading axis. Called once a round, on the commit payload, right before
    the relay append and merge; the identity off a mesh (`mesh` None).
    Counted in EXCHANGES["exchange"] either way."""
    EXCHANGES["exchange"] += 1
    return _gather(tree, mesh, spec, axis)


def gather(tree, mesh, spec=CLIENT_SHARDED, axis: str = CLIENT_AXIS):
    """`exchange`'s mechanism for what crosses ranks outside the round step
    (per-client metrics and accuracies for the round record,
    `client_params`), counted apart in EXCHANGES["gather"]."""
    EXCHANGES["gather"] += 1
    return _gather(tree, mesh, spec, axis)


def _blocks(spec, leaf) -> Blocks:
    if isinstance(spec, Blocks):
        if spec.local_size != leaf.shape[0]:
            raise ValueError(f"a leading axis of {leaf.shape[0]} rows under "
                             f"blocks of {spec.local_size}")
        return spec
    _check(spec)
    return Blocks(((spec, leaf.shape[0]),))


def _gather(tree, mesh, spec, axis):
    if mesh is None:
        return tree
    pieces: List[torch.Tensor] = []

    def collect(leaf):
        at = 0
        for tag, n in _blocks(spec, leaf):
            if tag == CLIENT_SHARDED:
                pieces.append(leaf.narrow(0, at, n))
            at += n
        return leaf

    tree_map(collect, tree)
    if not pieces:
        return tree
    got = iter(_all_gather(pieces, mesh.get_group(axis),
                           sharding.axis_size(mesh, axis)))

    def rebuild(leaf):
        out, at = [], 0
        for tag, n in _blocks(spec, leaf):
            out.append(next(got) if tag == CLIENT_SHARDED
                       else leaf.narrow(0, at, n))
            at += n
        return out[0] if len(out) == 1 else torch.cat(out)

    return tree_map(rebuild, tree)


def _all_gather(parts: List[torch.Tensor], group, world: int):
    """Each rank's `parts` (the same shapes and dtypes on every rank)
    gathered in rank order along dim 0, in ONE collective: every part's
    bytes packed into one uint8 buffer (each at an 8-byte offset), one
    `all_gather` of it, and each part's rows viewed back in its own dtype.
    uint8 is a type every backend takes, so bool, integer and float leaves
    cross alike. gloo with CUDA tensors goes through host memory, which
    waits for the device; NCCL's collective queues on the stream."""
    import torch.distributed as dist
    if any(p.dim() == 0 for p in parts):
        raise ValueError("a client-sharded leaf needs a leading axis")
    dev = parts[0].device
    segs, spans, at = [], [], 0
    for p in parts:
        b = p.contiguous().reshape(-1).view(torch.uint8)
        segs.append(b)
        pad = -b.numel() % _ALIGN
        if pad:
            segs.append(b.new_zeros(pad))
        spans.append((at, b.numel()))
        at += b.numel() + pad
    buf = torch.cat(segs)
    staged = dev.type != "cpu" and str(dist.get_backend(group)) == "gloo"
    if staged:
        buf = buf.cpu()
    whole = buf.new_empty((world, buf.numel()))
    dist.all_gather(list(whole.unbind(0)), buf, group=group)
    if staged:
        whole = whole.to(dev)
    out = []
    for p, (off, nb) in zip(parts, spans):
        shape = (world * p.shape[0],) + tuple(p.shape[1:])
        if nb == 0:
            out.append(p.new_empty(shape))
            continue
        out.append(whole[:, off:off + nb].view(p.dtype).reshape(shape))
    return out


def tags(tree) -> set:
    """The set of placement tags in a declaration (tests, checks)."""
    return set(leaves(tree))
