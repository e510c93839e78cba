"""The dry-run, the PyTorch form of `repro/launch/dryrun.py`: every (arch ×
shape) combination on a production mesh, with the step built and its
state and batch placed by the launch path's shardings.

The reference lowers and compiles each step for 512 fake host devices and
reads XLA's memory and cost analyses and its HLO collectives. PyTorch runs
eagerly and has no compile step, so the port's counterpart has two halves:

  - reckoned (`reckon_one`, the default): on a production `MeshShape`
    ((16, 16) over ("data", "model"), or (2, 16, 16) with "pod"), in one
    process. The step's state, batch and caches are meta tensors
    (`serve.params_shapes`, `serve.cache_shapes`,
    `train.init_state_shapes`, `train.train_batch_specs`); their specs
    (`serve.*_shardings`, `train.state_shardings`, `train.batch_shardings`)
    give every rank's shard of every leaf, split as DTensor splits it. The
    record sets each rank's bytes beside `roofline.memory_floor_bytes` and
    `roofline.model_flops`, and checks that the shards, each counted once,
    add up to the unsharded bytes exactly;
  - run (`run_one`, `--one-step`): on a real `DeviceMesh` of this process
    group's ranks (under `torchrun`), one step on placed random weights of
    the reduced config at a small shape of the same mode: the counterpart
    of compiling. On a mesh with "pod" a train step splits its clients over
    it, each rank training only its own (`train.make_train_step`). The
    record holds the collectives the run made, by kind and by mesh axis
    (`roofline.CollectiveBytes`, every operand of a collective summed:
    the reference's HLO reading counts a tuple all-reduce's first shape
    only), in full and without the scalars, and the roofline terms with
    them as the collective term. On the card by default: NCCL with a card
    a rank, or gloo ranks sharing the cards where the ranks outnumber them
    (DTensor's functional collectives staged through host memory,
    `ranks.stage_functional_collectives`); on the CPU only with
    `--device cpu`. Without a GPU and without `--device cpu` it raises.

No counterpart: XLA's cost analysis (HLO FLOPs and bytes accessed, the
scan-corrected depth variants); the records' roofline terms come from the
analytic FLOPs and bytes instead. A reckoned record has no collective
term: nothing runs.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k [--multi-pod] [--mode cors|fedavg|il]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.dryrun \\
      --one-step --mesh 2x2 --arch tinyllama-1.1b --shape prefill_32k \\
      [--device cuda|cpu]
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.dryrun \\
      --one-step --mesh 2x1x1 --arch tinyllama-1.1b --shape train_4k \\
      --mode cors|fd|fedavg|il [--device cuda|cpu]

Records: artifacts/dryrun_torch/<arch>__<shape>__<mesh>__<mode>.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.launch import roofline, serve as serve_lib, train as train_lib
from repro_torch.launch.mesh import (MeshShape, describe, device_mesh,
                                     make_production_mesh, mesh_shape)
from repro_torch.tree import leaves, tree_map
from repro_torch.types import CollabConfig, ShapeConfig

ARTDIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                      "artifacts", "dryrun_torch")


def should_skip(cfg, shape) -> str:
    if shape.name == "long_500k" and cfg.long_context_mode == "skip":
        return ("enc-dec with a 30s audio frontend has no 500k-token decode "
                "regime (DESIGN.md shape/skip matrix)")
    return ""


def build(cfg, shape, mesh, *, mode: str, n_clients: int,
          strategy: str = "tp", moe_ep: bool = False, sync: str = "step"):
    """The step for (cfg, shape), its inputs as meta tensors and their specs
    on `mesh` (a `MeshShape` or a `DeviceMesh`): the counterpart of the
    reference's `build_lowered`, with its knobs: strategy ("tp" | "dp_only"
    | "zero1"), moe_ep (expert-parallel MoE), sync ("step": the exchange in
    every step; "round": once a round, the paper's Algorithm 1).
    -> (step, {name: (meta tree, spec tree)}). Sets the sharding hints:
    the caller restores them (`sharding.hints_restored`)."""
    sharding.set_hints(mesh=mesh, moe_ep=moe_ep,
                       moe_dp=strategy in ("dp_only", "zero1"))
    if shape.mode == "train":
        ccfg = CollabConfig(mode=mode, num_classes=cfg.vocab_size,
                            d_feature=cfg.d_feature, num_negatives=1023)
        step = train_lib.make_train_step(cfg, ccfg, n_clients=n_clients,
                                         sync_in_step=(sync == "step"))
        state = train_lib.init_state_shapes(cfg, n_clients)
        batch = train_lib.train_batch_specs(cfg, shape, n_clients)
        return step, {
            "state": (state, train_lib.state_shardings(
                state, cfg, mesh, n_clients, strategy=strategy)),
            "batch": (batch, train_lib.batch_shardings(
                batch, mesh, n_clients, strategy=strategy))}
    params = serve_lib.params_shapes(cfg)
    batch = serve_lib.serve_batch_specs(cfg, shape)
    trees = {"params": (params, serve_lib.params_shardings(params, cfg,
                                                           mesh)),
             "batch": (batch, serve_lib.batch_shardings(batch, mesh))}
    if shape.mode == "prefill":
        return serve_lib.make_prefill_step(cfg), trees
    caches = serve_lib.cache_shapes(cfg, shape)
    trees["cache"] = (caches, serve_lib.cache_shardings(caches, cfg, mesh,
                                                        shape))
    window = serve_lib.decode_window(cfg, shape)
    return serve_lib.make_decode_step(cfg, window=window), trees


# ---------------------------------------------------------------------------
# the reckoned half: every rank's shard of every leaf
# ---------------------------------------------------------------------------
def _chunks(n: int, w: int) -> np.ndarray:
    """The lengths of `torch.chunk(range(n), w)`, zero-padded to w: how
    DTensor's `Shard` splits a dim of length n over w ranks."""
    c = -(-n // w) if n else 0
    return np.array([max(0, min(c, n - i * c)) for i in range(w)],
                    dtype=np.int64)


def leaf_bytes(shape, itemsize: int, spec, mesh) -> np.ndarray:
    """Each rank's bytes of one leaf placed by `spec`, as an array over the
    mesh's coordinates. A dim split over several mesh dims is split in mesh
    order, each block again over the next (`sharding.placements`)."""
    ms = mesh_shape(mesh)
    pl = sharding.placements(spec, ms)
    out = np.full(ms.sizes, itemsize, dtype=np.int64)
    for d, n in enumerate(shape):
        sizes = np.array(n, dtype=np.int64)
        axes = [i for i, p in enumerate(pl) if p.is_shard(d)]
        for i in axes:
            w = ms.sizes[i]
            flat = sizes.reshape(-1)
            sizes = np.stack([_chunks(int(v), w) for v in flat]).reshape(
                sizes.shape + (w,))
        view = [1] * ms.ndim
        for j, i in enumerate(axes):
            view[i] = ms.sizes[i]
        out = out * sizes.reshape(view)
    return out


def _owner_mask(spec, mesh) -> np.ndarray:
    """1 on the ranks that count a leaf's shard once: coordinate 0 on every
    mesh dim the leaf is replicated over."""
    ms = mesh_shape(mesh)
    pl = sharding.placements(spec, ms)
    m = np.ones(ms.sizes, dtype=np.int64)
    for i, p in enumerate(pl):
        if not p.is_shard():
            view = [1] * ms.ndim
            view[i] = ms.sizes[i]
            m = m * (np.arange(ms.sizes[i]) == 0).reshape(view)
    return m


def _spec_leaves(tree, specs):
    """(tensor, spec) pairs of a tree and its spec tree (specs are tuples,
    so the tensor tree's structure leads)."""
    out = []

    def walk(node, spec):
        if node is None:
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, spec[k])
        elif isinstance(node, (list, tuple)):
            for v, s in zip(node, spec):
                walk(v, s)
        else:
            out.append((node, spec))
    walk(tree, specs)
    return out


def reckon(tree, specs, mesh) -> Dict[str, float]:
    """A placed tree's bytes: `total` unsharded; `per_rank_max` and
    `per_rank_min` held by one rank; `owned_sum` the shards over every
    rank, each counted once (equal to `total` exactly when the split is
    right)."""
    ms = mesh_shape(mesh)
    held = np.zeros(ms.sizes, dtype=np.int64)
    owned = 0
    total = 0
    for t, spec in _spec_leaves(tree, specs):
        b = leaf_bytes(tuple(t.shape), t.element_size(), spec, ms)
        held += b
        owned += int((b * _owner_mask(spec, ms)).sum())
        total += t.numel() * t.element_size()
    return {"total": total, "per_rank_max": int(held.max()),
            "per_rank_min": int(held.min()), "owned_sum": owned}


def reckon_one(arch: str, shape_name: str, *, multi_pod: bool,
               mode: str = "cors", strategy: str = "tp",
               moe_ep: bool = False, sync: str = "step",
               tag: str = "") -> dict:
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    skip = should_skip(cfg, shape)
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag, "mode": mode,
           "status": "skip", "skip_reason": skip, "tag": tag,
           "knobs": {"strategy": strategy, "moe_ep": moe_ep, "sync": sync}}
    if skip:
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_clients = mesh.shape.get("pod", 1)
    t0 = time.time()
    with sharding.hints_restored():
        _, trees = build(cfg, shape, mesh, mode=mode, n_clients=n_clients,
                         strategy=strategy, moe_ep=moe_ep, sync=sync)
    n_dev = mesh.size()
    byts = {k: reckon(t, s, mesh) for k, (t, s) in trees.items()}
    per_rank = sum(b["per_rank_max"] for b in byts.values())
    floor = roofline.memory_floor_bytes(cfg, shape, n_dev,
                                        n_clients=n_clients)
    mf = roofline.model_flops(cfg, shape, n_clients)
    exact = all(b["owned_sum"] == b["total"] for b in byts.values())
    rec.update(
        status="ok" if exact else "fail", n_devices=n_dev,
        mesh_axes=describe(mesh), shards_sum_exact=exact,
        reckon_s=round(time.time() - t0, 3), bytes=byts,
        per_rank_bytes=per_rank, memory_floor=floor,
        per_rank_over_floor=per_rank / floor["total"],
        model_flops_global=mf,
        terms=roofline.terms({"flops": mf / n_dev,
                              "bytes accessed": per_rank}, {"total": 0}))
    if not exact:
        rec["error"] = "the ranks' shards do not add up to the unsharded bytes"
    return rec


# ---------------------------------------------------------------------------
# the run half: one step on a real mesh
# ---------------------------------------------------------------------------
def run_shape(shape: ShapeConfig, mesh, n_clients: int) -> ShapeConfig:
    """A small shape of `shape`'s mode for the reduced config: a batch of
    one row a data rank a client (at least 2), 32 tokens."""
    dp = sharding.dp_size(mesh) * (sharding.axis_size(mesh, "model")
                                   if shape.mode == "train" else 1)
    return dataclasses.replace(shape, seq_len=32,
                               global_batch=max(2, dp) * n_clients)


def run_one(cfg, shape: ShapeConfig, mesh, *, mode: str = "cors",
            strategy: str = "tp", moe_ep: bool = False, sync: str = "step",
            seed: int = 0):
    """One step of (cfg, shape) on the `DeviceMesh` `mesh`, on random
    weights from `seed` placed by the shardings (every rank makes the same
    tree; `sharding.place` keeps its shard): the counterpart of compiling.
    Returns the step's outputs (DTensors)."""
    n_clients = sharding.axis_size(mesh, "pod") if shape.mode == "train" \
        else 1
    with sharding.hints_restored():
        return _run_built(cfg, shape, mesh, mode=mode, n_clients=n_clients,
                          strategy=strategy, moe_ep=moe_ep, sync=sync,
                          seed=seed)


def _filler(cfg, gen):
    """Random leaves like meta tensors from `gen`: ids below the vocab size,
    floats from a normal."""
    def fill(t):
        if not t.dtype.is_floating_point:
            return torch.randint(0, cfg.vocab_size, tuple(t.shape),
                                 generator=gen, device=gen.device,
                                 dtype=t.dtype)
        return torch.randn(tuple(t.shape), generator=gen, device=gen.device
                           ).to(t.dtype)
    return fill


def train_inputs(cfg, shape: ShapeConfig, n_clients: int, seed: int = 0,
                 device="cpu"):
    """The (state, batch, negatives) of `run_one`'s train step, as every
    rank makes them before placing them: the batch, the clients' weights
    and their K = 15 negatives a client, in that order from one generator
    seeded `seed`. Plain tensors: the unsharded step takes them as they
    are."""
    gen = torch.Generator(device).manual_seed(seed)
    batch = tree_map(_filler(cfg, gen),
                     train_lib.train_batch_specs(cfg, shape, n_clients))
    state = train_lib.init_state(cfg, gen, n_clients, device=device)
    ccfg = CollabConfig(num_classes=cfg.vocab_size, d_feature=cfg.d_feature,
                        num_negatives=15)
    return state, batch, train_lib.draw_negatives(gen, cfg, ccfg, n_clients)


def _run_built(cfg, shape, mesh, *, mode, n_clients, strategy, moe_ep,
               sync, seed):
    from repro_torch.launch.serve import decode_window
    from repro_torch.models import encdec, lm
    dev = mesh.device_type
    step, trees = build(cfg, shape, mesh, mode=mode, n_clients=n_clients,
                        strategy=strategy, moe_ep=moe_ep, sync=sync)

    def put(name, tree):
        return sharding.place(tree, trees[name][1], mesh, src_data_rank=None)

    if shape.mode == "train":
        state, batch, neg = train_inputs(cfg, shape, n_clients, seed, dev)
        return step(put("state", state), put("batch", batch), neg)
    gen = torch.Generator(dev).manual_seed(seed)
    with torch.no_grad():
        batch = put("batch", tree_map(_filler(cfg, gen), trees["batch"][0]))
        init = encdec.init_encdec if cfg.is_encoder_decoder \
            else lm.init_lm
        params = put("params", init(gen, cfg, device=dev))
        if shape.mode == "prefill":
            return step(params, batch)
        if cfg.is_encoder_decoder:
            caches = tree_map(lambda t: torch.zeros(
                tuple(t.shape), dtype=t.dtype, device=dev),
                trees["cache"][0])
        else:
            caches = lm.init_cache(cfg, shape.global_batch,
                                   shape.seq_len,
                                   window=decode_window(cfg, shape),
                                   device=dev)
        return step(params, batch, put("cache", caches))


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------
def save(rec, outdir=ARTDIR):
    os.makedirs(outdir, exist_ok=True)
    tag = rec.get("tag", "") or ""
    if tag:
        tag = "__" + tag
    name = (f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__{rec['mode']}"
            f"{tag}.json")
    with open(os.path.join(outdir, name), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return name


def fmt(rec) -> str:
    if rec["status"] != "ok":
        why = rec.get("skip_reason") or rec.get("error", "")
        return (f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:12s} "
                f"{rec['status'].upper()}: {why[:60]}")
    if "ran" in rec:
        pod = rec["collectives"].get("pod")
        return (f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:12s} "
                f"ran one step in {rec['run_s']:.2f}s on {rec['ran']} "
                f"({rec['device']})"
                + (f", {pod['total']} B in {pod['count']} collectives over "
                   f"pod" if pod else ""))
    t = rec["terms"]
    return (f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:12s} "
            f"rank={rec['per_rank_bytes'] / 2**30:8.3f}GiB "
            f"floor={rec['memory_floor']['total'] / 2**30:8.3f}GiB "
            f"comp={t['compute_s'] * 1e3:9.2f}ms "
            f"mem={t['memory_s'] * 1e3:8.2f}ms -> {t['bottleneck']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="cors",
                    choices=["cors", "fd", "fedavg", "il"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--strategy", default="tp",
                    choices=["tp", "dp_only", "zero1"])
    ap.add_argument("--moe-ep", action="store_true",
                    help="expert-parallel MoE sharding")
    ap.add_argument("--sync", default="step", choices=["step", "round"],
                    help="prototype exchange cadence")
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"],
                    help="activation checkpoint policy")
    # not "--run": torchrun reads that as an abbreviation of its own
    # "--run-path" wherever it stands
    ap.add_argument("--one-step", action="store_true",
                    help="run one step of the reduced config on a real mesh "
                         "of this process group's ranks (under torchrun)")
    ap.add_argument("--mesh", default="1x1",
                    help="--one-step's mesh: DATAxMODEL or PODxDATAxMODEL")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="--one-step's device: the card (default; raises "
                         "without a GPU) or, asked for, the CPU")
    ap.add_argument("--tag", default="", help="record filename suffix")
    ap.add_argument("--out", default=ARTDIR)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    combos = [(a, s) for a in archs for s in shapes]
    from repro_torch.models import blocks as _blocks
    _blocks.REMAT_POLICY = args.remat
    mesh = None
    if args.one_step:
        mesh = _run_mesh(args.mesh, args.device)
    knobs = dict(strategy=args.strategy, moe_ep=args.moe_ep, sync=args.sync)
    ok = skip = fail = 0
    for a, s in combos:
        mesh_tag = ("pod2x16x16" if args.multi_pod else "pod16x16") \
            if mesh is None else describe(mesh)
        try:
            if mesh is None:
                rec = reckon_one(a, s, multi_pod=args.multi_pod,
                                 mode=args.mode, tag=args.tag, **knobs)
            else:
                rec = _run_record(a, s, mesh, mesh_tag, args, knobs)
        except Exception as e:
            rec = {"arch": a, "shape": s, "mesh": mesh_tag,
                   "mode": args.mode, "status": "fail",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        if mesh is None or torch.distributed.get_rank() == 0:
            save(rec, args.out)
            print(fmt(rec), flush=True)
        ok += rec["status"] == "ok"
        skip += rec["status"] == "skip"
        fail += rec["status"] == "fail"
    if mesh is None or torch.distributed.get_rank() == 0:
        print(f"\n== dry-run summary: {ok} ok / {skip} skip / {fail} fail ==")
    if mesh is not None:
        torch.distributed.destroy_process_group()
    if fail:
        raise SystemExit(1)


def _run_mesh(spec: str, device: str):
    """This torchrun rank's mesh of `spec`'s sizes on `device`. On "cuda":
    NCCL with a card a rank, or, where the ranks outnumber the cards, gloo
    ranks sharing them (rank r on card r mod the count, DTensor's
    functional collectives staged through host memory); raises without a
    GPU. On "cpu": gloo on the CPU."""
    from repro_torch import ranks
    from repro_torch.device import resolve_device
    sizes = tuple(int(x) for x in spec.split("x"))
    names = ("data", "model") if len(sizes) == 2 else ("pod", "data",
                                                      "model")
    dev = resolve_device(device)
    if dev.type == "cpu":
        ranks.init_from_env("gloo")
    elif torch.cuda.device_count() >= int(os.environ.get("WORLD_SIZE", "1")):
        ranks.init_from_env("nccl")
    else:
        torch.cuda.set_device(int(os.environ.get("RANK", "0"))
                              % torch.cuda.device_count())
        ranks.init_from_env("gloo")
        ranks.stage_functional_collectives()
    return device_mesh(MeshShape(names, sizes), dev.type)


def _run_record(arch, shape_name, mesh, mesh_tag, args, knobs):
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
           "mode": args.mode, "status": "skip",
           "skip_reason": should_skip(cfg, shape), "tag": args.tag,
           "knobs": knobs}
    if rec["skip_reason"]:
        return rec
    small = cfg.reduced()
    n_clients = sharding.axis_size(mesh, "pod") \
        if shape.mode == "train" else 1
    run = run_shape(shape, mesh, n_clients)
    t0 = time.time()
    with roofline.CollectiveBytes(mesh) as cb:
        out = run_one(small, run, mesh, mode=args.mode, **knobs)
    run_s = time.time() - t0
    vals = [t.full_tensor() if sharding.is_dtensor(t) else t
            for t in leaves(out)]
    finite = all(bool(torch.isfinite(v.float()).all()) for v in vals
                 if v.is_floating_point())
    coll = cb.by_axis()
    n_dev = mesh.size()
    rec.update(status="ok" if finite else "fail", ran=describe(mesh),
               device=mesh.device_type,
               run_config=small.name, run_shape=dataclasses.asdict(run),
               run_s=run_s, finite=finite,
               collectives=coll, collectives_beyond_scalars=cb.by_axis(2),
               terms=roofline.terms(
                   {"flops": roofline.model_flops(small, run, n_clients)
                    / n_dev,
                    "bytes accessed": roofline.memory_floor_bytes(
                        small, run, n_dev, n_clients=n_clients)["total"]},
                   {"total": sum(d["total"] for d in coll.values())}))
    if not finite:
        rec["error"] = "non-finite outputs"
    return rec


if __name__ == "__main__":
    main()
