"""Sharding rules, the port of `repro/sharding.py`: the client mesh of the
fleet engine, and the LM launch path's rules.

Mesh axes (see launch/mesh.py):
  - "clients": the vectorized collab engine's client axis (`client_mesh`).
  - "pod"    : CoRS client axis of the LM launch mesh (multi-pod only).
  - "data"   : batch / FSDP axis.
  - "model"  : tensor-parallel axis (heads / d_ff / vocab / experts).

The reference is single-controller: one process holds every device, and
GSPMD turns `PartitionSpec`s into shardings and collectives. The port is
multi-controller, in PyTorch's own model: one process a rank under
`torch.distributed`, a mesh a `torch.distributed.device_mesh.DeviceMesh`,
and a placed tensor a DTensor, whose ops propagate shardings and issue the
collectives much as GSPMD does.

A spec is a plain tuple with one entry a tensor dim, as the reference's
`PartitionSpec`: None (replicated), one axis name, or a tuple of axis
names (the dim split over several axes, the first one major). `placements`
turns a spec into DTensor placements on a mesh; the rules read only the
mesh's axis names and sizes, so a `launch.mesh.MeshShape` serves them as
well as a `DeviceMesh` (the dry-run reckons a 512-rank mesh in one
process).

All rules degrade gracefully: a dimension is only sharded when divisible
by the axis size, otherwise left replicated.

The LM train step's "pod" axis splits the leading client axis: each rank
holds and runs only its own clients (`client_block`), each on the mesh of
the other axes (`client_of`, `put_client`, `stack_clients`), and a sum over
clients is one all-reduce over "pod" (`pod_sum`, `pod_reduce`): the
reference's `vmap` over a pod-sharded axis, with no DTensor indexing of
that axis, which would gather every client to every rank.

The port's layers are separate tensors where the reference stacks a
segment's layers on a leading axis (`models/blocks.py`). `tree_param_specs`
computes a layer's spec as the reference's for the stacked leaf with the
layer entry dropped: where the reference's FSDP rule shards that layer
axis (no other dim divides), each port layer is held whole over that axis.

One departure, a fault of the reference's own (`repro/sharding.py:141-143`):
under the "moe_ep" hint its `param_spec` puts "model" on dim 0 of an
expert leaf (`..._e`), meant as the expert dim of (E, d, f), but on the
stacked (L, E, d, f) leaf dim 0 is the layer axis. Dropping that entry
would leave the experts whole on every rank of "model", each computing
all E of them. So inside a layer list `layer_spec` reads an expert leaf
under "moe_ep" on its per-layer (E, d, f) shape, where the rule's "model"
lands on the experts (if E divides the axis; FSDP's "data" split then
follows as usual), and `nn/moe.py:_experts` runs each rank's own block of
experts. `param_spec` itself stays the reference's, entry for entry.
"""
from __future__ import annotations

import contextlib
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.tree import tree_map

CLIENTS = "clients"


def _device_type() -> str:
    """The device type of the default process group's backend: NCCL's
    collectives run on CUDA tensors, gloo's on CPU tensors."""
    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def client_mesh(n: Optional[int] = None):
    """A 1-D `DeviceMesh` with the axis ("clients",) over the first `n`
    ranks of the default process group (all of them by default), on the
    device type of its backend. The process group must be initialized
    (`torch.distributed.init_process_group`, with its address, world size
    and rank given); nothing is started here, and nothing falls back to a
    single process."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "client_mesh needs an initialized torch.distributed process "
            "group: call init_process_group(backend, init_method=..., "
            "world_size=W, rank=r) in every rank first")
    n = dist.get_world_size() if n is None else int(n)
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(CLIENTS,))


def axis_size(mesh, name: str) -> int:
    """The number of ranks along mesh axis `name`, 1 for an axis the mesh
    does not have (a `DeviceMesh` or a `launch.mesh.MeshShape`)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def replicated(mesh) -> Tuple:
    """Every rank holds the whole value: `Replicate()` on every mesh axis."""
    return (Replicate(),) * mesh.ndim


def leading_axis(mesh, axis: str) -> Tuple:
    """The leading dim split over mesh axis `axis` in contiguous blocks, one
    a rank in rank order (`Shard(0)`), replicated over any other axis."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return tuple(Shard(0) if a == axis else Replicate() for a in names)


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


# ---------------------------------------------------------------------------
# the LM launch path's rules
# ---------------------------------------------------------------------------
def dp_axes(mesh) -> tuple:
    """Axes over which the batch is sharded ("pod" folds into batch)."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def dp_size(mesh) -> int:
    return _prod(mesh, dp_axes(mesh))


def _prod(mesh, axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return n


def maybe(axis: Optional[str], dim: int, size: int):
    """Return `axis` if `dim` is divisible by `size`, else None."""
    return axis if (axis is not None and size > 1 and dim % size == 0) else None


def batch_spec(mesh, batch: int, *rest) -> tuple:
    """Shard the leading batch dim over (pod, data) as far as divisible."""
    axes: List[str] = []
    for a in dp_axes(mesh):
        if batch % (axis_size(mesh, a) * _prod(mesh, axes)) == 0:
            axes.append(a)
    # one axis as its name, as `PartitionSpec` normalises ('data',)
    lead = (axes[0] if len(axes) == 1 else tuple(axes)) if axes else None
    return (lead, *rest)


def head_axis_plan(num_heads: int, head_dim: int, tp: int) -> str:
    """Which per-head axis the model axis shards: 'heads' | 'head_dim' | 'none'."""
    if tp <= 1:
        return "none"
    if num_heads % tp == 0:
        return "heads"
    if head_dim % tp == 0:
        return "head_dim"
    return "none"


def param_spec(path: str, shape: tuple, mesh, *, fsdp: bool) -> tuple:
    """Heuristic parameter sharding from the param-tree path (the reference's
    rule, entry for entry).

    Conventions used by the model code (nn/ + models/):
      - 'embed'               : (vocab, d_model)        -> vocab over model
      - 'lm_head' / 'w_out'   : (d_model, vocab)        -> vocab over model
      - 'wq','wk','wv'        : (d_model, heads*hd)     -> out dim over model
      - 'wo'                  : (heads*hd, d_model)     -> in dim over model
      - 'w_gate','w_up'       : (d_model, d_ff)         -> d_ff over model
      - 'w_down'              : (d_ff, d_model)         -> d_ff over model
      - experts '..._e'       : (E, d, f)               -> f over model
      - everything else       : replicated (biases, norms, small projs)
    FSDP additionally shards the *other* matrix dim over data when divisible.
    """
    tp = axis_size(mesh, "model")
    dp = axis_size(mesh, "data")
    leaf = path.split("/")[-1]
    ndim = len(shape)
    spec: List = [None] * ndim

    model_dim = None  # index sharded by "model"
    if ndim >= 2:
        if leaf in ("embed", "proto"):
            model_dim = 0
        elif leaf in ("lm_head", "w_out"):
            model_dim = ndim - 1
        elif leaf in ("wq", "wk", "wv", "w_gate", "w_up", "wkv_b", "wq_b",
                      "w_in", "w_qkv"):
            model_dim = ndim - 1
        elif leaf in ("wo", "w_down"):
            model_dim = ndim - 2
        elif leaf.endswith("_e"):      # stacked expert weights (E, d, f)
            # "tp": shard the per-expert ffn dim; "ep": shard the expert dim
            model_dim = 0 if _HINTS.get("moe_ep") else ndim - 1

    if model_dim is not None and maybe("model", shape[model_dim], tp):
        spec[model_dim] = "model"

    if fsdp and ndim >= 2:
        # shard one remaining large dim over data
        for d in range(ndim - 1, -1, -1):
            if spec[d] is None and shape[d] % dp == 0 and shape[d] >= dp:
                spec[d] = "data"
                break
    return tuple(spec)


def _is_layer_list(node) -> bool:
    """A segment's (or an encoder's, a decoder's) list of per-layer dicts,
    which the reference stacks on a leading layer axis."""
    return (isinstance(node, list) and len(node) > 0
            and all(isinstance(x, dict) for x in node))


def map_params(fn, tree, path: str = "", n_layers: int = 0):
    """`fn(path, leaf, n_layers)` over a parameter tree's tensor leaves, in
    the tree's structure: `path` is the leaf's path in the reference's
    layout ('segments/0/attn/wq', the layer index left out), `n_layers` the
    length of the layer list the leaf is in (0 outside one)."""
    join = lambda k: f"{path}/{k}" if path else str(k)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_params(fn, v, join(k), n_layers)
                for k, v in tree.items()}
    if _is_layer_list(tree):
        return [map_params(fn, x, path, len(tree)) for x in tree]
    if isinstance(tree, (list, tuple)):
        out = [map_params(fn, v, join(i), n_layers)
               for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(path, tree, n_layers)


def layer_spec(rule, path: str, shape: tuple, n_layers: int) -> tuple:
    """`rule(path, shape)` for one leaf of the port's tree: on the stacked
    shape (n_layers, *shape) with the layer entry dropped inside a layer
    list (see the module's docstring), on `shape` outside one. An expert
    leaf under the "moe_ep" hint is read on its own shape where the rule
    then splits its expert dim over "model" (the module's docstring says
    why); a rule that does not (a strategy that replicates the parameters,
    ZeRO-1's moments) keeps the stacked reading."""
    if not n_layers:
        return tuple(rule(path, tuple(shape)))
    if hint("moe_ep") and path.split("/")[-1].endswith("_e"):
        own = tuple(rule(path, tuple(shape)))
        if own and own[0] == "model":
            return own
    return tuple(rule(path, (n_layers, *shape)))[1:]


def tree_param_specs(params, mesh, *, fsdp: bool):
    """The spec tree matching `params` (the port's layout)."""
    rule = lambda path, shape: param_spec(path, shape, mesh, fsdp=fsdp)
    return map_params(lambda path, leaf, n: layer_spec(rule, path,
                                                       leaf.shape, n),
                      params)


def placements(spec: Sequence, mesh) -> Tuple:
    """A spec as DTensor placements on `mesh`: `Shard(d)` on each mesh dim
    that tensor dim d names, `Replicate()` on the others. A dim named by a
    tuple of axes is split over them in the tuple's order, the first one
    major, as JAX splits it; DTensor shards one tensor dim over several
    mesh dims in mesh order, so the tuple must follow the mesh's order."""
    names = axis_names(mesh)
    out: List = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r}; the "
                                 f"mesh has {names}")
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {tuple(spec)} uses axis {a!r} twice")
            out[i] = Shard(d)
            idx.append(i)
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)} splits dim {d} over {axes}"
                             f" out of the mesh's order {names}")
    return tuple(out)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def place(tree, specs, mesh, *, src_data_rank: Optional[int] = 0):
    """`tree`'s tensors as DTensors on `mesh`, each placed by its spec in
    `specs` (a tree of the same structure with a spec at each tensor): the
    counterpart of `jax.device_put(tree, shardings)`. Each rank keeps its
    shard of rank `src_data_rank`'s tensor (broadcast from it), or with
    `src_data_rank=None` of its own, without communication (every rank
    made the same tree). A leaf that is a DTensor already is redistributed
    to its spec."""

    def leaf(node, pl):
        if is_dtensor(node):
            return (node if tuple(node.placements) == pl
                    else node.redistribute(mesh, pl))
        d = distribute_tensor(node, mesh, pl, src_data_rank=src_data_rank)
        local = d.to_local()
        if _is_view(local):
            # a view of the whole tensor would keep it alive: own the shard
            d = DTensor.from_local(local.clone(), mesh, pl, run_check=False,
                                   shape=d.shape, stride=d.stride())
        return d
    return _walk_specs(tree, specs, mesh, leaf)


def _walk_specs(tree, specs, mesh, leaf):
    """`leaf(tensor, placements)` over a tree and its spec tree."""
    def walk(node, spec):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(v, s) for v, s in zip(node, spec)]
            if isinstance(node, list):
                return out
            return (type(node)(*out) if hasattr(node, "_fields")
                    else tuple(out))
        return leaf(node, placements(spec, mesh))
    return walk(tree, specs)


def _is_view(local) -> bool:
    return (local.untyped_storage().nbytes()
            > local.numel() * local.element_size())


def _own(local, mesh, pl, shape):
    """The DTensor of `local` placed `pl`, of global `shape` (contiguous); a
    view of a larger tensor would keep it alive, so the shard is cloned."""
    if _is_view(local):
        local = local.clone()
    shape = tuple(shape)
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def place_block(tree, specs, mesh):
    """`place` for a tree that holds only this rank's block of every dim its
    spec splits over "pod" (a rank's own clients, from
    `train.init_state(..., clients=)`), whole on the other dims: each rank
    keeps its shard of those, without communication. At full width no rank
    can build every client; the result equals `place` of the whole tree
    (`src_data_rank=None`). A leaf not split over "pod" is whole here, as
    in `place`."""
    names = axis_names(mesh)
    i = names.index(POD) if POD in names else None
    others = tuple(a for a in names if a != POD)
    sub = mesh[others] if i is not None and others else None

    def leaf(node, pl):
        if i is None or not isinstance(pl[i], Shard):
            d = distribute_tensor(node, mesh, pl, src_data_rank=None)
            return _own(d.to_local(), mesh, pl, d.shape)
        d = pl[i].dim
        local = node
        if sub is not None:
            sub_pl = tuple(p for a, p in zip(names, pl) if a != POD)
            local = distribute_tensor(node, sub, sub_pl,
                                      src_data_rank=None).to_local()
        shape = list(node.shape)
        shape[d] *= mesh.size(i)
        return _own(local, mesh, pl, shape)
    return _walk_specs(tree, specs, mesh, leaf)


def rows_like(t, x):
    """`t`, a plain tensor whose leading dim is `x`'s batch dim (positions
    made on every rank alike), placed as `x`'s batch: its leading dim split
    where `x`'s is, replicated elsewhere. The identity when `x` is not a
    DTensor."""
    if not is_dtensor(x):
        return t
    pl = tuple(p if p.is_shard(0) else Replicate() for p in x.placements)
    return distribute_tensor(t, x.device_mesh, pl, src_data_rank=None)


def replicated_like(t, x):
    """`t`, a plain tensor every rank holds alike (draws, masks), as a
    DTensor replicated on `x`'s mesh; the identity when `x` is not a
    DTensor or `t` is None."""
    if t is None or not is_dtensor(x) or is_dtensor(t):
        return t
    return distribute_tensor(t, x.device_mesh, replicated(x.device_mesh),
                             src_data_rank=None)


def replicate(x):
    """A DTensor replicated on every rank of its mesh (a `Partial` sum or
    mean reduced, a split gathered), still a DTensor; anything else as it
    is."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, replicated(x.device_mesh))


def full(x):
    """A DTensor's whole value as a plain tensor (a collective: every rank
    of its mesh calls it); anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def local_rows(fn, n_out: int, *tensors, split_dims: Sequence[int] = (0,)):
    """`fn(*tensors)` for an op that DTensor has no rule for but that reads
    only the rows it writes (MoE's top-k, dispatch and combine, rope,
    attention on whole heads, a cache's pad): on plain tensors as it is, on
    DTensors through `local_map` (`local_axes`), on each rank's shard. The
    first input keeps its splits of the dims in `split_dims` (by default
    the batch rows) and is made whole on every other mesh dim; an input of
    its rank is placed alike, one of another rank (positions beside
    activations) keeps only the batch split. The `n_out` outputs are
    placed as the first input."""
    n = tensors[0].dim()
    lead = "".join(chr(ord("a") + d) if d in split_dims else "."
                   for d in range(n))
    ins = tuple(lead if t.dim() == n else lead[0] + "." * (t.dim() - 1)
                for t in tensors)
    return local_axes(fn, ins, (lead,) * n_out, *tensors)


def local_axes(fn, ins: Sequence[str], outs: Sequence[str], *tensors,
               units: Optional[dict] = None):
    """`fn(*tensors)` on each rank's block through `local_map`, the blocks
    named by letters, for an op DTensor has no rule for (a recurrence, a
    chunked scan, a conv over the sequence): on plain tensors as it is.

    `ins` holds one string a tensor and `outs` one an output, a letter a
    dim ("b" the batch rows, "h" heads, ...; "." a dim that is never
    split). On each mesh dim the first tensor's placement chooses: its
    `Shard(d)` splits the letter at d, where that letter is not "." and,
    for a letter in `units` (a flattened axis, d = H x P, split on whole
    heads only), the mesh dims that split it divide `units[letter]`;
    anything else splits nothing there, and the first tensor is gathered
    on that mesh dim. Every tensor and output is then `Shard` of its own
    dim with the split letter, or `Replicate()` where it has none; the
    gradient of an input without it is a `Partial` sum (the share of its
    rank's block), with it the same `Shard`. Plain tensors pass as they
    are."""
    lead = tensors[0]
    if not is_dtensor(lead):
        return fn(*tensors)
    from torch.distributed.tensor.experimental import local_map
    mesh = lead.device_mesh
    split = [ins[0][p.dim] if isinstance(p, Shard) and ins[0][p.dim] != "."
             else None for p in lead.placements]
    for letter, n in (units or {}).items():
        dims = [i for i, s in enumerate(split) if s == letter]
        if n % _prod_sizes(mesh, dims):
            for i in dims:
                split[i] = None

    def pl(spec, grad=False):
        return tuple(Shard(spec.index(s)) if s is not None and s in spec
                     else Partial() if s is not None and grad
                     else Replicate() for s in split)

    args = []
    for t, spec in zip(tensors, ins):
        if is_dtensor(t) and tuple(t.placements) != pl(spec):
            t = t.redistribute(mesh, pl(spec))
        args.append(t)
    return local_map(
        fn, out_placements=tuple(pl(s) for s in outs),
        in_placements=tuple(pl(s) if is_dtensor(t) else None
                            for t, s in zip(args, ins)),
        in_grad_placements=tuple(pl(s, grad=True) if is_dtensor(t) else None
                                 for t, s in zip(args, ins)),
        device_mesh=mesh)(*args)


def _prod_sizes(mesh, dims) -> int:
    n = 1
    for i in dims:
        n *= mesh.size(i)
    return n


def placed_like(tree, like):
    """Every DTensor of `tree` redistributed to the placements of the tensor
    at the same place in `like` (a step hands its state back placed as it
    took it: a `Partial` sum is reduced, a gathered leaf cut again); plain
    tensors pass as they are."""
    def one(t, ref):
        if not is_dtensor(t) or tuple(t.placements) == tuple(ref.placements):
            return t
        return t.redistribute(ref.device_mesh, ref.placements)
    return tree_map(one, tree, like)


# ---------------------------------------------------------------------------
# the "pod" client axis: a rank holds and runs only its own clients
# ---------------------------------------------------------------------------
POD = "pod"


class ClientBlock(NamedTuple):
    """This rank's block [lo, hi) of a step's leading client axis, and where
    its clients run: `mesh` the whole mesh and `sub` the mesh of its other
    axes (one client's ("data", "model") mesh; None where there is none),
    on a state whose client axis is split over "pod"; both None where the
    clients are whole on every rank (off a mesh, or a client axis
    replicated over it)."""
    lo: int
    hi: int
    mesh: Any = None
    sub: Any = None

    @property
    def split(self) -> bool:
        return self.mesh is not None


def client_block(x, n: int) -> ClientBlock:
    """The block of an n-client leading axis this rank holds, read from `x`,
    a leaf with that axis (the Adam step counter, say): split over "pod"
    where `x` is a DTensor with `Shard(0)` on that mesh dim (n / pod
    clients a rank, in rank order; pod must divide n), else all n."""
    if not is_dtensor(x) or POD not in axis_names(x.device_mesh):
        return ClientBlock(0, n)
    mesh, names = x.device_mesh, axis_names(x.device_mesh)
    i = names.index(POD)
    if x.placements[i] != Shard(0):
        return ClientBlock(0, n)
    w = mesh.size(i)
    if n % w:
        raise ValueError(f"{n} clients do not split into {w} equal pod blocks")
    r = mesh.get_local_rank(i)
    others = tuple(a for a in names if a != POD)
    sub = mesh[others] if others else None
    return ClientBlock(r * (n // w), (r + 1) * (n // w), mesh, sub)


def _client_placements(x, blk: ClientBlock) -> Tuple:
    """`x`'s placements on `blk.sub`: the "pod" entry dropped, a split of
    tensor dim d > 0 now of dim d - 1 (one client's leaf)."""
    names = axis_names(blk.mesh)
    out = []
    for a, p in zip(names, x.placements):
        if a == POD:
            continue
        if isinstance(p, Shard):
            if p.dim == 0:
                raise ValueError(f"the client axis is split over {a!r}; only "
                                 f"'pod' may split it")
            p = Shard(p.dim - 1)
        out.append(p)
    return tuple(out)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def client_of(x, i: int, blk: ClientBlock):
    """Client i of `x`'s leading axis (i a global client index in the
    block): `x[i]` where the block is not split or `x` is a plain tensor
    (inputs every rank holds whole); on a split block this rank's local row
    i - lo as a DTensor on `blk.sub`, its other dims split as in `x`, or
    the local row itself where the mesh has no other axis. Nothing crosses
    "pod": DTensor's own `x[i]` would gather every client to every rank."""
    if not blk.split or not is_dtensor(x):
        return x[i]
    local = x.to_local()[i - blk.lo]
    if blk.sub is None:
        return local
    shape = tuple(x.shape[1:])
    return DTensor.from_local(local, blk.sub, _client_placements(x, blk),
                              run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def client_sub(x, blk: ClientBlock):
    """A leaf without a client axis, replicated over "pod" (the prototype
    means), as a DTensor on `blk.sub` with the same local values; `x` as
    it is off a split block."""
    if not blk.split or not is_dtensor(x):
        return x
    names = axis_names(blk.mesh)
    i = names.index(POD)
    if not isinstance(x.placements[i], Replicate):
        raise ValueError(f"{x.placements} is not replicated over 'pod'")
    if blk.sub is None:
        return x.to_local()
    pl = tuple(p for a, p in zip(names, x.placements) if a != POD)
    return DTensor.from_local(x.to_local(), blk.sub, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def client_buffer(like, blk: ClientBlock):
    """An uninitialized buffer for `like`'s clients in this block, filled
    client by client with `put_client`: `like`'s shape (a DTensor placed as
    `like` off a split block), or its local block on a split one."""
    return torch.empty_like(like.to_local() if blk.split else like)


def put_client(buf, i: int, value, like, blk: ClientBlock) -> None:
    """Write client i's `value` (from `client_of`'s mesh) into `buf`, placed
    as `like`'s client i: on a split block `value` is first redistributed to
    `like`'s placements on `blk.sub` (a `Partial` gradient reduced over
    "data" or "model", never over "pod")."""
    if not blk.split:
        buf[i].copy_(value)
        return
    if is_dtensor(value):
        pl = _client_placements(like, blk)
        if tuple(value.placements) != pl:
            value = value.redistribute(blk.sub, pl)
        value = value.to_local()
    buf[i - blk.lo].copy_(value)


def from_block(buf, like, blk: ClientBlock):
    """`buf` (`client_buffer`'s) as a tensor placed like `like`: on a split
    block the DTensor of the whole mesh whose local block is `buf`."""
    if not blk.split:
        return buf
    return DTensor.from_local(buf, blk.mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def stack_clients(values, blk: ClientBlock):
    """The block's clients' values (one a client, in order, on `client_of`'s
    mesh) stacked on a new leading client axis: `torch.stack` off a split
    block; on one, the DTensor of the whole mesh split over "pod" whose
    local block stacks this rank's values (each placed as the first), their
    other splits kept."""
    if not blk.split:
        return torch.stack(values)
    v0 = values[0]
    sub_pl = tuple(v0.placements) if is_dtensor(v0) else ()
    local = torch.stack([
        (v if tuple(v.placements) == sub_pl
         else v.redistribute(blk.sub, sub_pl)).to_local()
        if is_dtensor(v) else v for v in values])
    it = iter(sub_pl)
    pl = tuple(Shard(0) if a == POD else _shifted(next(it))
               for a in axis_names(blk.mesh))
    shape = (blk.mesh.size(axis_names(blk.mesh).index(POD)) * len(values),
             *v0.shape)
    return DTensor.from_local(local, blk.mesh, pl, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))


def _shifted(p):
    return Shard(p.dim + 1) if isinstance(p, Shard) else p


def expand_clients(x, like, blk: ClientBlock):
    """`x`, a leaf without the client axis and whole over "pod" (`pod_sum`'s
    result), as every client of `like`, placed as `like`: off a split block
    `x.expand(like.shape)`, contiguous; on one, this rank's clients."""
    if not blk.split:
        return x.expand(like.shape).contiguous()
    local = x.to_local()
    return from_block(local.expand(blk.hi - blk.lo, *local.shape).contiguous(),
                      like, blk)


def block_rows(t, blk: ClientBlock):
    """An input every rank holds whole with a leading client axis (the
    participation mask), as a DTensor split over "pod" like the state's
    clients (each rank keeps its block, no communication); `t` as it is off
    a split block or where it is None."""
    if t is None or not blk.split:
        return t
    return distribute_tensor(t, blk.mesh, leading_axis(blk.mesh, POD),
                             src_data_rank=None)


def pod_sum(x, blk: ClientBlock, like=None, weights=None):
    """The sum over clients of `x`, a leaf with the block's client axis,
    each client weighted by `weights` (N,) where given (the participation
    mask): off a split block `x.sum(0)`; on one, each rank adds its own
    clients, then `pod_reduce` (one all-reduce over "pod"), placed as
    `like` (by default whole over "pod" and as `x` over the other axes)."""
    local = x.to_local() if blk.split else x
    if weights is not None:
        w = weights.to_local() if blk.split else weights
        local = local * w.reshape(w.shape + (1,) * (local.dim() - 1))
    if not blk.split:
        return local.sum(0)
    return pod_reduce(local.sum(0), blk, _client_placements(x, blk),
                      tuple(x.shape[1:]), like)


def pod_reduce(local, blk: ClientBlock, rest=None, shape=None, like=None):
    """`local`, this rank's sum over its own clients, summed over "pod": a
    DTensor `Partial` over "pod" (placed `rest` over the other axes,
    `Replicate()` by default; global `shape`, by default local's)
    redistributed to `like`'s placements, or whole over "pod": one
    all-reduce over "pod", nothing else across pods."""
    names = axis_names(blk.mesh)
    it = iter(rest if rest is not None else (Replicate(),) * (len(names) - 1))
    src = tuple(Partial() if a == POD else next(it) for a in names)
    dst = (tuple(like.placements) if like is not None else tuple(
        Replicate() if a == POD else p for a, p in zip(names, src)))
    shape = tuple(local.shape if shape is None else shape)
    s = DTensor.from_local(local, blk.mesh, src, run_check=False,
                           shape=shape, stride=_contiguous_stride(shape))
    # the other axes are placed first (a split taken locally, or reduced
    # over them), so that only this rank's block crosses "pod"
    mid = tuple(p if a == POD else d for a, p, d in zip(names, src, dst))
    if mid != src:
        s = s.redistribute(blk.mesh, mid)
    return s.redistribute(blk.mesh, dst)


def lookup(table, idx):
    """`table[idx]`: rows of `table` (V, ...) by integer ids `idx`. On a
    mesh (DTensors), through `local_map`: DTensor's own index rule refuses
    ids split over two mesh dims in PyTorch 2.11, and a table split on its
    rows needs a masked lookup. On each mesh dim, a table split on rows
    (`Shard(0)`: the vocab over "model") meets ids whole there, each rank
    looks up its own block with zero rows elsewhere, and the result is a
    `Partial` sum (exactly one rank adds a nonzero row, so the sum is
    exact); a whole table takes the ids as they are split, the result rows
    likewise; any other split of the table is gathered first. The table's
    gradient from a rank's own ids is a partial sum."""
    if not is_dtensor(table):
        return table[idx.long()]
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    idx = replicated_like(idx, table)
    tab, ids, out, grad, blocks = [], [], [], [], []
    for i in range(mesh.ndim):
        if table.placements[i] == Shard(0):
            tab.append(Shard(0))
            ids.append(Replicate())
            out.append(Partial())
            grad.append(Shard(0))
            blocks.append(i)
        else:
            split = idx.placements[i] == Shard(0)
            tab.append(Replicate())
            ids.append(Shard(0) if split else Replicate())
            out.append(ids[-1])
            grad.append(Partial() if split else Replicate())
    table = table.redistribute(mesh, tab)
    idx = idx.redistribute(mesh, ids)
    V, v0 = table.shape[0], 0
    for i in blocks:
        chunk = -(-V // mesh.size(i))
        v0 += mesh.get_local_rank(i) * chunk
        V = chunk

    def rows(w, t):
        t = t.long()
        if not blocks:
            return w[t]
        t = t - v0
        hit = (t >= 0) & (t < w.shape[0])
        return w[t.clamp(0, w.shape[0] - 1)] * hit[..., None].to(w.dtype)

    return local_map(rows, out_placements=(tuple(out),),
                     in_placements=(tuple(tab), tuple(ids)),
                     in_grad_placements=(tuple(grad), tuple(ids)),
                     device_mesh=mesh)(table, idx)


# ---------------------------------------------------------------------------
# Sharding hints: knobs the launcher sets before a step is built, so deep
# layers (the MoE dispatch buffers) can apply mesh-aware constraints
# without threading the mesh through every call signature.
# ---------------------------------------------------------------------------
_HINTS = {"mesh": None, "moe_ep": False, "moe_dp": False}


def set_hints(**kw):
    _HINTS.update(kw)


@contextlib.contextmanager
def hints_restored():
    """Every hint as it was on entry, restored on exit."""
    saved = dict(_HINTS)
    try:
        yield
    finally:
        _HINTS.clear()
        _HINTS.update(saved)


def hint(name: str):
    return _HINTS.get(name)


def constrain(x, *spec):
    """`x` redistributed to `spec` on its mesh when a mesh is hinted and `x`
    is a DTensor (the reference's `with_sharding_constraint`); the identity
    otherwise. An axis name the mesh lacks reads as None, as in the
    reference."""
    m = _HINTS.get("mesh")
    if m is None or not is_dtensor(x):
        return x
    names = axis_names(x.device_mesh)
    cleaned = tuple(None if isinstance(s, str) and s not in names else s
                    for s in spec)
    return x.redistribute(x.device_mesh, placements(cleaned, x.device_mesh))
