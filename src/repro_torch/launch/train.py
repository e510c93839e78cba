"""The CoRS train step at LM scale, the port of `repro/launch/train.py`.

Client semantics: parameters and Adam state carry a leading `clients` axis,
as in the reference, so `convert` carries a `TrainState` across. The
reference `vmap`s one client's step over that axis (each client one pod);
on one card the port runs the clients one after another inside the step:
one client's activations are live at a time, the math is unchanged, and
nothing is read back to the host per client. Each client's forward and
backward go through `lm.forward(mode="train")`, or for an encoder-decoder
`encdec.encode` and `encdec.decode_forward(mode="train")`: plain attention
by the reference's rule, each decoder-only layer rematerialised (the
encoder-decoder's are not, as in the reference).

The only cross-client exchange in cors and fd is the prototype merge of
the per-class feature stats, computed by `prototypes.accumulate` (on the
card the proto_accum kernel) in one launch for all clients, with the
client axis (N, B*S, d'). It runs where the step merges them: cors or fd
with `sync_in_step`. Elsewhere the reference's stats are dead code (XLA
drops them), and the port skips the launch. The baselines come from the
same `make_train_step`: fedavg averages the parameters every step (O(D));
il exchanges nothing.

Draws: the reference splits a key per client and draws each client's K
negative classes with `jax.random.randint`; the port takes them as an
(N, K) argument (`draw_negatives` makes them from a `torch.Generator`).

Shardings, as the reference's (`state_shardings` with the strategies "tp",
"dp_only" and "zero1", `round_sync_shardings`, `batch_shardings`), give
spec trees (`sharding.py`); `sharding.place` puts the state and batch on
a `DeviceMesh` by them (`sharding.place_block` a rank's own clients from
`init_state(..., clients=)`), and `make_train_step` runs on the placed
trees: DTensor propagates the shardings through the forward, autograd
and Adam, and the merge's `ops.proto_accum` launches once a rank on its
rows and vocab block. On a mesh with "pod" the client axis is split over
it, as in the reference: each rank holds and runs only its own clients
(`sharding.client_block`), each on the ("data", "model") sub-mesh, and
no parameter, gradient, moment or activation crosses "pod". What does is
each mode's exchange alone, one all-reduce over "pod" a leaf
(`sharding.pod_sum`): the prototype sums and counts in cors and fd, the
parameters' float32 sums in fedavg, nothing in il; beside them the
metrics' means, one scalar each. The round syncs take client-sharded
stats (`round_sync_shardings`) and sum them so; their pending slots and
history ring stay replicated.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import sharding
from repro_torch.core import losses, prototypes
from repro_torch.device import resolve_device
from repro_torch.models import encdec, lm
from repro_torch.optim import adam_init, adam_update
from repro_torch.relay import history as relay_history, placement
from repro_torch.relay.participation import bcast_mask, freeze_absent
from repro_torch.tree import leaves, tree_map
from repro_torch.types import CollabConfig, ModelConfig, ShapeConfig


class TrainState(NamedTuple):
    params: Any                      # LM tree, every leaf (N, ...)
    opt: Any                         # stacked AdamState, step (N,)
    proto: prototypes.ProtoState     # (C, d'), (C,)
    step: torch.Tensor               # 0-d int32


# ---------------------------------------------------------------------------
# per-client loss
# ---------------------------------------------------------------------------
def _lm_outputs(cfg: ModelConfig, params, batch):
    if cfg.is_encoder_decoder:
        enc = encdec.encode(params, cfg, batch["frames"], mode="train")
        return encdec.decode_forward(params, cfg, batch["tokens"], enc,
                                     mode="train")
    return lm.forward(params, cfg, batch, mode="train")


def _head_w(cfg: ModelConfig, params):
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].T
    return w


def num_negatives(cfg: ModelConfig, ccfg: CollabConfig) -> int:
    """K of the LM's L_disc: min(num_negatives or 1023, V - 1)."""
    return min(ccfg.num_negatives or 1023, cfg.vocab_size - 1)


def draw_negatives(gen: torch.Generator, cfg: ModelConfig,
                   ccfg: CollabConfig, n_clients: int) -> torch.Tensor:
    """(n_clients, K) negative class ids from `gen`, on its device."""
    return losses.sample_negatives(gen, num_negatives(cfg, ccfg),
                                   cfg.vocab_size, (n_clients,))


def make_loss_fn(cfg: ModelConfig, ccfg: CollabConfig, *,
                 disc_tokens: int = 8192):
    """Per-client loss: Eq. (6) adapted to LM classification (class = next
    token). L_disc uses K sampled negatives on the first `disc_tokens`
    tokens. `loss_fn(params, batch, proto_means, neg_ids)` -> (total,
    (metrics, features, labels)); neg_ids (K,) is read in cors mode only.

    The port's `ce_loss` and `kd_loss` reduce the last sample axis and take
    any leading axis for clients, so the tokens are flattened to (B*S, .)
    first: each call returns the reference's mean over all tokens."""
    V = cfg.vocab_size

    def loss_fn(params, batch, proto_means, neg_ids=None):
        out = _lm_outputs(cfg, params, batch)
        feats, logits = out["features"], out["logits"]
        labels = batch["labels"]
        f_flat = feats.reshape(-1, feats.shape[-1])
        y_flat = labels.reshape(-1)
        z_flat = logits.reshape(-1, V)
        # on a mesh each term is reduced whole before they combine (a mean's
        # Partial and the MoE aux's do not add in PyTorch 2.11's DTensor)
        whole = sharding.replicate
        l_ce = whole(losses.ce_loss(z_flat, y_flat))
        metrics = {"ce": l_ce}
        total = l_ce + 0.01 * whole(out["aux"])
        if ccfg.mode == "cors":
            l_kd = whole(losses.kd_loss(f_flat, proto_means, y_flat))
            T = min(disc_tokens, f_flat.shape[0])
            l_disc = whole(losses.disc_loss_sampled(
                neg_ids, f_flat[:T], proto_means, y_flat[:T],
                _head_w(cfg, params), None, student_logits=z_flat[:T]))
            total = total + ccfg.lambda_kd * l_kd + ccfg.lambda_disc * l_disc
            metrics.update(kd=l_kd, disc=l_disc)
        metrics["total"] = total
        return total, (metrics, feats, labels)

    return loss_fn


def client_grads(loss_fn, params, batch, proto_means, neg_ids=None):
    """One client's gradients (a tree like `params`), metrics, features and
    labels; the features and labels detached."""
    p = tree_map(lambda a: a.detach().requires_grad_(True), params)
    total, (metrics, feats, labels) = loss_fn(p, batch, proto_means, neg_ids)
    grads = torch.autograd.grad(total, leaves(p))
    it = iter(grads)
    return (tree_map(lambda _: next(it), p),
            {k: v.detach() for k, v in metrics.items()},
            feats.detach(), labels)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def make_train_step(cfg: ModelConfig, ccfg: CollabConfig, *,
                    n_clients: int = 1, lr: float = 1e-3,
                    disc_tokens: int = 8192, sync_in_step: bool = True):
    """sync_in_step=False is the paper-faithful cadence: Algorithm 1
    exchanges prototypes once per ROUND, not per step; `make_round_sync()`
    then does the merge (of stats the caller accumulates, as the reference
    does: this step returns none). The default True folds the exchange into
    every step.

    `train_step(state, batch, neg_ids=None, participation=None)` ->
    (state, metrics). batch: tokens and labels (N, B, S) on the state's
    device; neg_ids (N, K) (cors only); participation an optional (N,) bool
    tensor: absent clients' params and Adam state freeze for the step, their
    stats are zero-weighted in the merge, fedavg averages over present
    clients, and the metrics are means over present clients. On a state
    split over "pod" every rank passes the same whole neg_ids and mask,
    and the batch placed by `batch_shardings`: each reads its own
    clients' rows."""
    loss_fn = make_loss_fn(cfg, ccfg, disc_tokens=disc_tokens)
    C = cfg.vocab_size
    merge_stats = ccfg.mode in ("cors", "fd") and sync_in_step

    def train_step(state: TrainState, batch, neg_ids=None,
                   participation=None):
        # this rank's clients: all of them, or on a state split over "pod"
        # its own block, each run on the ("data", "model") sub-mesh
        blk = sharding.client_block(state.opt.step, n_clients)
        proto_means = prototypes.means(state.proto)
        if blk.split:
            participation = sharding.block_rows(participation, blk)
        else:
            # on a mesh, the mask as a replicated DTensor (the loss places
            # the draws so)
            participation = sharding.replicated_like(participation,
                                                     proto_means)
        means_c = sharding.client_sub(proto_means, blk)
        grads = tree_map(lambda p: sharding.client_buffer(p, blk),
                         state.params)
        per_client, feats, labels = [], [], []
        with sharding.hints_restored():
            if blk.split:
                sharding.set_hints(mesh=blk.sub)
            for i in range(blk.lo, blk.hi):
                g, m, f, y = client_grads(
                    loss_fn, tree_map(lambda a: sharding.client_of(a, i, blk),
                                      state.params),
                    {k: sharding.client_of(v, i, blk)
                     for k, v in batch.items()}, means_c,
                    None if neg_ids is None else neg_ids[i])
                tree_map(lambda buf, gi, p: sharding.put_client(
                    buf, i, gi, p, blk), grads, g, state.params)
                del g
                per_client.append(m)
                if merge_stats:
                    feats.append(f.reshape(-1, f.shape[-1]))
                    labels.append(y.reshape(-1))
        grads = tree_map(lambda buf, p: sharding.from_block(buf, p, blk),
                         grads, state.params)
        params, opt = adam_update(state.params, grads, state.opt, lr=lr)
        del grads
        metrics = {k: sharding.stack_clients([m[k] for m in per_client], blk)
                   for k in per_client[0]}
        wf = n_eff = None
        if participation is not None:
            wf = participation.float()
            n_eff = sharding.pod_sum(wf, blk).clamp(min=1.0)
            params = freeze_absent(participation, params, state.params)
            opt = freeze_absent(participation, opt, state.opt)
        if ccfg.mode == "fedavg":
            params = tree_map(lambda p: _fedavg(p, wf, n_eff, blk), params)
            if participation is not None:
                params = freeze_absent(participation, params, state.params)
        proto = state.proto
        if merge_stats:
            # the paper's exchange: one launch for this rank's clients'
            # stats, then their sum over clients (over "pod": the step's
            # one exchange)
            f = sharding.stack_clients(feats, blk)
            stats = prototypes.accumulate(
                prototypes.init_state(C, f.shape[-1], f.device,
                                      clients=n_clients),
                f, sharding.stack_clients(labels, blk))
            proto = _decayed(ccfg, state.proto, *(
                sharding.pod_sum(x, blk, like, weights=wf)
                for x, like in zip(stats, state.proto)))
        if wf is None and not blk.split:
            metrics = {k: v.mean() for k, v in metrics.items()}
        else:
            n = n_clients if wf is None else n_eff
            metrics = {k: sharding.pod_sum(v, blk, weights=wf) / n
                       for k, v in metrics.items()}
        new = TrainState(params, opt, proto, state.step + 1)
        return sharding.placed_like(new, state), metrics

    return train_step


def _fedavg(p, wf, n_eff, blk):
    """The fedavg baseline's per-step mean over clients, in float32, back
    in p's dtype and broadcast to every client; over present clients
    (weights wf, their count n_eff) under a participation mask. On a
    "pod"-split state, one all-reduce over "pod" of the parameter's float32
    sum."""
    if wf is None and not blk.split:
        s = p.float().mean(0)
    else:
        s = sharding.pod_sum(p.float(), blk, weights=wf) / (
            p.shape[0] if wf is None else n_eff)
    return sharding.expand_clients(s.to(p.dtype), p, blk)


def _decayed(ccfg: CollabConfig, proto: prototypes.ProtoState, add_sum,
             add_count) -> prototypes.ProtoState:
    """decay * proto + the merged stats, those placed as `proto` first (a
    `Partial` sum over the rows reduced)."""
    decay = ccfg.proto_momentum or 1.0
    add = sharding.placed_like(prototypes.ProtoState(add_sum, add_count),
                               proto)
    return prototypes.ProtoState(decay * proto.sum + add.sum,
                                 decay * proto.count + add.count)


def make_round_sync(ccfg: CollabConfig):
    """Per-round prototype exchange (paper Algorithm 1 cadence): merge the
    clients' accumulated stats into the shared ProtoState, once per round
    when the step was built with sync_in_step=False. Takes one stats
    ProtoState per client-architecture bucket, each with its own leading
    client axis: a mixed fleet is N_buckets train steps and one round
    sync. For stats that commit late use `make_async_round_sync`."""
    def round_sync(state: TrainState, *bucket_stats: prototypes.ProtoState):
        merged = prototypes.merge(*[_client_total(s, state.proto)
                                    for s in bucket_stats])
        return state._replace(proto=_decayed(ccfg, state.proto, merged.sum,
                                             merged.count))
    return round_sync


def _client_total(stats: prototypes.ProtoState,
                  like: prototypes.ProtoState) -> prototypes.ProtoState:
    """A bucket's stats summed over its clients: on stats split over "pod"
    (`round_sync_shardings`' CLIENT_SHARDED), each rank's own clients, then
    one all-reduce over "pod", placed as `like`."""
    blk = sharding.client_block(stats.count, stats.count.shape[0])
    return prototypes.ProtoState(*(sharding.pod_sum(x, blk, ref)
                                   for x, ref in zip(stats, like)))


def make_async_round_sync(ccfg: CollabConfig, d_max: int):
    """`make_round_sync` for a bounded-delay fleet (`repro_torch.sim`
    clocks): a client's round-r stats with commit delay d join the shared
    prototype state in round r+d. The merge is a sum, so late contributions
    are order-free; the clock state is a fixed-shape pending ProtoState of
    d_max future slots (slot j = stats due j+1 rounds from now).

    Returns (init_pending, round_sync):
      init_pending(C, d', device=None) -> pending ProtoState (d_max, C, .)
      round_sync(state, pending, delays_b, stats_b, ...) -> (state, pending)
        with (k_b,) int commit delays and the bucket's stacked stats per
        bucket. Delays stay on the device. As the reference's
        `.at[delays].add(mode="drop")`, a negative delay counts from the
        end (-1 is d_max) and one outside [-(d_max+1), d_max] is dropped;
        `index_add_` would raise on it, so it is masked. d_max = 0 is
        `make_round_sync` exactly.
    """
    assert d_max >= 0, d_max
    slots = d_max + 1

    def init_pending(C: int, d_feature: int, device=None):
        dev = resolve_device(device)
        return prototypes.ProtoState(
            torch.zeros(d_max, C, d_feature, device=dev),
            torch.zeros(d_max, C, device=dev))

    def round_sync(state: TrainState, pending: prototypes.ProtoState,
                   *delays_and_stats):
        assert len(delays_and_stats) % 2 == 0, \
            "pass (delays, stats) per bucket"
        C, d = state.proto.sum.shape
        dev = state.proto.sum.device
        sums = torch.zeros(slots, C, d, device=dev)
        counts = torch.zeros(slots, C, device=dev)
        blk = None
        for b in range(0, len(delays_and_stats), 2):
            stats = delays_and_stats[b + 1]
            # each rank scatters its own clients (all of them off "pod");
            # placed stats are read through their local values
            blk = sharding.client_block(stats.count, stats.count.shape[0])
            delays = torch.as_tensor(delays_and_stats[b], device=dev).long()
            delays = delays[blk.lo:blk.hi]
            s_sum, s_count = (t.to_local() if sharding.is_dtensor(t) else t
                              for t in stats)
            idx = torch.where(delays < 0, delays + slots, delays)
            keep = (idx >= 0) & (idx < slots)
            idx = idx.clamp(0, slots - 1)
            sums.index_add_(0, idx, torch.where(
                bcast_mask(keep, s_sum), s_sum, 0.0))
            counts.index_add_(0, idx, torch.where(
                bcast_mask(keep, s_count), s_count, 0.0))
        if blk is not None and blk.split:
            # the round's one exchange: the slots summed over "pod"
            sums, counts = (sharding.pod_reduce(t, blk)
                            for t in (sums, counts))
        sums, counts = (sharding.replicated_like(t, state.proto.sum)
                        for t in (sums, counts))
        pending = prototypes.ProtoState(*(
            sharding.replicated_like(t, state.proto.sum) for t in pending))
        commit_sum, commit_count = sums[0], counts[0]
        if d_max > 0:
            commit_sum = commit_sum + pending.sum[0]
            commit_count = commit_count + pending.count[0]
            # new pending[j] (due j+1 rounds from now) = old pending[j+1]
            # + the fresh stats with delay j+1
            shift = lambda a, fresh: torch.cat(
                [a[1:], torch.zeros_like(a[:1])]) + fresh[1:]
            pending = prototypes.ProtoState(shift(pending.sum, sums),
                                            shift(pending.count, counts))
        state = state._replace(proto=_decayed(ccfg, state.proto, commit_sum,
                                              commit_count))
        return state, pending

    return init_pending, round_sync


def make_download_lag_round_sync(ccfg: CollabConfig, h_max: int):
    """`make_round_sync` for a fleet whose clients READ stale prototypes
    (download clocks): the plain merge, then a push of the post-merge
    ProtoState into a ring of the last `h_max` (`relay/history.py`), so a
    client with download delay d is served the prototypes of round t - d.

    Returns (init_history, round_sync, read_at):
      init_history(C, d', device=None) -> History ring of empty ProtoStates
      round_sync(state, hist, *bucket_stats) -> (state, hist)
      read_at(hist, delays) -> ProtoState as of `delays` rounds ago; a
        scalar, or a (k,) tensor for a stacked ProtoState, one a client.
    h_max = 1 keeps only the current post-merge proto."""
    assert h_max >= 1, h_max
    sync = make_round_sync(ccfg)

    def init_history(C: int, d_feature: int, device=None):
        return relay_history.init(
            prototypes.init_state(C, d_feature, resolve_device(device)),
            h_max)

    def round_sync(state: TrainState, hist: relay_history.History,
                   *bucket_stats: prototypes.ProtoState):
        state = sync(state, *bucket_stats)
        # the ring is replicated: pushed on every rank's whole values
        new = relay_history.push(tree_map(sharding.full, hist),
                                 tree_map(sharding.full, state.proto))
        return state, tree_map(sharding.replicated_like, new, hist)

    return init_history, round_sync, relay_history.read_at


def proto_round_telemetry(prev: prototypes.ProtoState,
                          new: prototypes.ProtoState) -> Dict[str, Any]:
    """One round's prototype-level observability: the drift of the class
    means across the round's merge, the total absorbed stat mass, and class
    coverage. Host-side (three reads a round, not a step); JSON-safe for
    the `obs` JSONL sink and report."""
    dm = prototypes.means(new) - prototypes.means(prev)
    return {
        "proto_drift": float(torch.sqrt(torch.sum(torch.square(dm)))),
        "proto_mass": float(torch.sum(new.count)),
        "classes_seen": int(torch.sum(new.count > 0)),
    }


# ---------------------------------------------------------------------------
# state construction
# ---------------------------------------------------------------------------
def _stack_clients(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def init_state(cfg: ModelConfig, gen: Optional[torch.Generator],
               n_clients: int = 1, device=None, *,
               clients: Optional[Tuple[int, int]] = None) -> TrainState:
    """N clients' random models from `gen` (one after another: `lm.init_lm`,
    or `encdec.init_encdec` for an encoder-decoder), stacked, with zero
    Adam moments (step (N,)), an empty ProtoState and step 0. With
    `gen=None`, meta tensors: `init_state_shapes`.

    `clients` = (lo, hi): only that block of clients, stacked on a leading
    axis of hi - lo (those before lo are drawn from `gen` and dropped, so
    the block equals rows [lo, hi) of the whole state): a rank's own
    clients on a state split over "pod", placed by `sharding.place_block`.
    At full width no rank can build every client."""
    init = encdec.init_encdec if cfg.is_encoder_decoder else lm.init_lm
    lo, hi = (0, n_clients) if clients is None else clients
    ps = []
    for i in range(hi):
        p = init(gen, cfg, device=device)
        if i >= lo:
            ps.append(p)
        del p
    p = _stack_clients(ps)
    del ps
    dev = leaves(p)[0].device
    return TrainState(p, adam_init(p, clients=hi - lo),
                      prototypes.init_state(cfg.vocab_size, cfg.d_feature,
                                            dev),
                      torch.zeros((), dtype=torch.int32, device=dev))


def init_state_shapes(cfg: ModelConfig, n_clients: int = 1) -> TrainState:
    """The TrainState's shapes and dtypes as `meta` tensors, nothing
    allocated: the counterpart of the reference's `jax.eval_shape`."""
    return init_state(cfg, None, n_clients)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                      n_clients: int = 1) -> Dict[str, Any]:
    """One global train batch as `meta` tensors, split over `n_clients`
    clients (global_batch // n_clients rows each): labels (N, Bc, S) int32;
    tokens (N, Bc, S) int32, or embeddings (N, Bc, S, d) with M-RoPE
    positions (N, Bc, S, 3) int32 where the rope is M-RoPE; an
    encoder-decoder's tokens and frames (N, Bc, encoder_seq, d) in the
    model's dtype."""
    N, S = n_clients, shape.seq_len
    Bc = shape.global_batch // n_clients
    dt = getattr(torch, cfg.dtype)
    meta = torch.device("meta")
    ints = lambda *s: torch.empty(*s, dtype=torch.int32, device=meta)
    batch: Dict[str, Any] = {"labels": ints(N, Bc, S)}
    if cfg.input_kind == "tokens" or cfg.is_encoder_decoder:
        batch["tokens"] = ints(N, Bc, S)
    else:
        batch["embeddings"] = torch.empty(N, Bc, S, cfg.d_model, dtype=dt,
                                          device=meta)
        if cfg.rope_kind == "mrope":
            batch["positions"] = ints(N, Bc, S, 3)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.empty(N, Bc, cfg.encoder_seq, cfg.d_model,
                                      dtype=dt, device=meta)
    return batch


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------
def _client_lead(mesh, n_clients: int):
    return ("pod" if (n_clients > 1 and "pod" in sharding.axis_names(mesh))
            else None)


def state_shardings(state_shapes, cfg: ModelConfig, mesh, n_clients: int = 1,
                    *, strategy: str = "tp") -> TrainState:
    """A TrainState of specs. strategy:
      "tp"      (default) model axis = tensor parallel
      "dp_only" params replicated; the model axis becomes extra data
                parallelism - no per-layer activation all-reduces
      "zero1"   dp_only + Adam moments sharded over the flattened
                (data, model) axes (ZeRO-1: replicated-params memory without
                replicated-optimizer memory)
    Leaves carry the leading client axis; inside a layer list the rules
    read the reference's stacked shape (`sharding.layer_spec`)."""
    lead = _client_lead(mesh, n_clients)
    flat_dp = sharding.dp_size(mesh) * sharding.axis_size(mesh, "model")
    names = sharding.axis_names(mesh)

    def param_rule(path, dims):
        if strategy in ("dp_only", "zero1"):
            return (None,) * len(dims)
        return sharding.param_spec(path, dims, mesh, fsdp=cfg.fsdp)

    def opt_rule(path, dims):
        if strategy == "zero1":
            spec = [None] * len(dims)
            for i, dsz in enumerate(dims):
                if dsz % flat_dp == 0 and dsz >= flat_dp:
                    axes = tuple(a for a in ("data", "model") if a in names)
                    spec[i] = axes if len(axes) > 1 else axes[0]
                    break
            return tuple(spec)
        return param_rule(path, dims)

    def spec_tree(tree, rule):
        return sharding.map_params(
            lambda path, leaf, n: (lead, *sharding.layer_spec(
                rule, path, tuple(leaf.shape[1:]), n)), tree)

    params_sh = spec_tree(state_shapes.params, param_rule)
    opt_sh = type(state_shapes.opt)(
        (lead,), spec_tree(state_shapes.opt.m, opt_rule),
        spec_tree(state_shapes.opt.v, opt_rule))
    tp = sharding.axis_size(mesh, "model")
    shard_v = strategy != "dp_only" and cfg.vocab_size % tp == 0
    proto_sh = prototypes.ProtoState(
        ("model", None) if shard_v else (None, None),
        ("model",) if shard_v else (None,))
    return TrainState(params_sh, opt_sh, proto_sh, ())


def round_sync_shardings(mesh, n_clients: int = 1):
    """Placements for the per-round prototype exchange (`make_round_sync` /
    `make_async_round_sync` / `make_download_lag_round_sync`), through the
    same declarations the collaborative engines use
    (`relay/placement.resolve`), resolved against this path's "pod" client
    axis: the shared, pending and history ProtoStates are REPLICATED;
    per-client bucket stats (leading client axis) are CLIENT_SHARDED over
    "pod", their sum inside the round sync then the round's one exchange.
    Returns (replicated, stats) DTensor placements; on a single-client or
    pod-less mesh both are replicated."""
    lead = _client_lead(mesh, n_clients)
    rep = placement.resolve(placement.REPLICATED, mesh)
    stats = (placement.resolve(placement.CLIENT_SHARDED, mesh, axis=lead)
             if lead else rep)
    return rep, stats


def batch_shardings(batch_shapes, mesh, n_clients: int = 1, *,
                    strategy: str = "tp"):
    """(N, Bc, ...) -> client over pod, batch over data (+model: dp_only
    and zero1)."""
    lead = _client_lead(mesh, n_clients)
    baxes = ("data", "model") if strategy in ("dp_only", "zero1") else "data"
    return tree_map(lambda l: (lead, baxes, *((None,) * (l.dim() - 2))),
                    batch_shapes)
