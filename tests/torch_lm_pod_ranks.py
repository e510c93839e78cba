"""Gloo ranks on the CPU running the port's LM train step with its client
axis split over "pod" (each rank trains only its own clients) and its round
syncs on client-sharded stats, every collective counted by mesh axis
(`launch/roofline.CollectiveBytes`). Two uses:

  PYTHONPATH=src python tests/torch_lm_pod_ranks.py bytes OUT

two ranks, mesh (2, 1, 1) over ("pod", "data", "model"): the dry-run's one
step (`dryrun.run_one`) of the reduced TinyLlama in cors, fd, fedavg and
il, and the same step unsharded on the same inputs (`dryrun.train_inputs`).

  PYTHONPATH=src python tests/torch_lm_pod_ranks.py cases IN OUT

four ranks, mesh (2, 1, 2): IN is a `torch.save`d dict ({"arch", "state":
the reference's `init_state` converted to the port, "batch", "neg", "mask",
"stats": per-client ProtoState, "delays"}) written by
tests/test_torch_lm_pod.py; one step of each of CASES and the three round
syncs on the placed trees (`sharding.place`, `train.state_shardings`,
`batch_shardings`, `round_sync_shardings`). First each rank checks that
`train.init_state(..., clients=)` placed by `sharding.place_block` equals
the whole state placed by `sharding.place`.

The ranks import nothing of JAX. Each gathers every output whole; rank 0
saves them with the bytes counted over each axis to OUT. A rank that fails
raises, and the run exits non-zero.
"""
import sys

import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch import ranks, sharding
from repro_torch.configs import get_arch, get_shape
from repro_torch.core import prototypes
from repro_torch.launch import dryrun, mesh as lmesh, roofline, train
from repro_torch.tree import leaves, tree_map
from repro_torch.types import CollabConfig

MODES = ("cors", "fd", "fedavg", "il")
# (name, mode, strategy, with the mask)
CASES = (("cors", "cors", "tp", False), ("fd", "fd", "tp", False),
         ("fedavg", "fedavg", "tp", False), ("il", "il", "tp", False),
         ("zero1", "cors", "zero1", False), ("absent", "cors", "tp", True))
D_MAX, H_MAX = 1, 2


def _whole(tree):
    return tree_map(sharding.full, tree)


def bytes_main(rank, world, dst):
    ranks.cpu_threads()
    mesh = lmesh.device_mesh(lmesh.MeshShape(("pod", "data", "model"),
                                             (2, 1, 1)))
    cfg = get_arch("tinyllama-1.1b").reduced()
    shape = dryrun.run_shape(get_shape("train_4k"), mesh, 2)
    res = {}
    for mode in MODES:
        with roofline.CollectiveBytes(mesh) as cb:
            state, met = dryrun.run_one(cfg, shape, mesh, mode=mode)
        # one client a rank: the state's local block holds one
        local = state.opt.step.to_local().shape[0]
        got = _whole((state, met))
        with sharding.hints_restored():
            step, _ = dryrun.build(cfg, shape, lmesh.make_host_mesh(),
                                   mode=mode, n_clients=2)
        want = step(*dryrun.train_inputs(cfg, shape, 2))
        res[mode] = {"got": got, "want": want, "local_clients": local,
                     "all": cb.by_axis(), "payload": cb.by_axis(2)}
    if rank == 0:
        torch.save(res, dst)
        print("POD_BYTES_OK", flush=True)


def block_init_check(cfg, state_specs, mesh, n):
    """`init_state(..., clients=)` of this rank's block, placed by
    `place_block`, against the whole `init_state` placed by `place`."""
    gen = lambda: torch.Generator().manual_seed(3)
    whole = sharding.place(train.init_state(cfg, gen(), n, device="cpu"),
                           state_specs, mesh, src_data_rank=None)
    blk = sharding.client_block(whole.opt.step, n)
    mine = sharding.place_block(train.init_state(
        cfg, gen(), n, device="cpu", clients=(blk.lo, blk.hi)), state_specs,
        mesh)
    for a, b in zip(leaves(whole), leaves(mine)):
        if not (tuple(a.placements) == tuple(b.placements)
                and a.shape == b.shape
                and torch.equal(a.to_local(), b.to_local())):
            raise AssertionError(f"place_block differs: {a.placements} "
                                 f"{b.placements} {a.shape} {b.shape}")


def cases_main(rank, world, src, dst):
    ranks.cpu_threads()
    mesh = lmesh.device_mesh(lmesh.MeshShape(("pod", "data", "model"),
                                             (2, 1, 2)))
    case = torch.load(src, weights_only=False)
    cfg = get_arch(case["arch"]).reduced()
    N = case["neg"].shape[0]
    K = case["neg"].shape[1]
    specs = {s: train.state_shardings(case["state"], cfg, mesh, N,
                                      strategy=s) for s in ("tp", "zero1")}
    block_init_check(cfg, specs["tp"], mesh, N)
    if rank == 0:
        print("PLACE_BLOCK_OK", flush=True)
    res = {}
    for name, mode, strategy, masked in CASES:
        ccfg = CollabConfig(mode=mode, num_classes=cfg.vocab_size,
                            d_feature=cfg.d_feature, num_negatives=K)
        step = train.make_train_step(cfg, ccfg, n_clients=N)
        sharding.set_hints(mesh=mesh, moe_ep=False,
                           moe_dp=strategy in ("dp_only", "zero1"))
        try:
            st = sharding.place(case["state"], specs[strategy], mesh,
                                src_data_rank=None)
            b = sharding.place(case["batch"], train.batch_shardings(
                case["batch"], mesh, N, strategy=strategy), mesh,
                src_data_rank=None)
            # a rank trains one client, on its (data, model) sub-mesh
            assert st.opt.step.to_local().shape[0] == N // 2
            mask = case["mask"] if masked else None
            with roofline.CollectiveBytes(mesh) as cb:
                new, met = step(st, b, case["neg"], mask)
        finally:
            sharding.set_hints(mesh=None)
        one_client = sum(p.to_local()[0].numel() * 4
                         for p in leaves(st.params))
        res[name] = {"state": _whole(new),
                     "metrics": {k: float(sharding.full(v))
                                 for k, v in met.items()},
                     "payload": cb.by_axis(2), "all": cb.by_axis(),
                     "fedavg_bytes": one_client}
    ccfg = CollabConfig(mode="cors", num_classes=cfg.vocab_size,
                        d_feature=cfg.d_feature, num_negatives=K)
    C, d = cfg.vocab_size, cfg.d_feature
    rep, stats_pl = train.round_sync_shardings(mesh, N)
    st = sharding.place(case["state"], specs["tp"], mesh, src_data_rank=None)
    put = lambda t, pl: distribute_tensor(t, mesh, pl, src_data_rank=None)
    stats = prototypes.ProtoState(*(put(t, stats_pl) for t in case["stats"]))
    syncs = {}
    with roofline.CollectiveBytes(mesh) as cb:
        out = train.make_round_sync(ccfg)(st, stats)
    syncs["round"] = (_whole(out.proto), cb)
    init_pending, async_sync = train.make_async_round_sync(ccfg, D_MAX)
    pending = tree_map(lambda t: put(t, rep), init_pending(C, d, "cpu"))
    with roofline.CollectiveBytes(mesh) as cb:
        out, pending = async_sync(st, pending, case["delays"], stats)
    syncs["async"] = ((_whole(out.proto), _whole(pending)), cb)
    init_hist, lag_sync, _ = train.make_download_lag_round_sync(ccfg, H_MAX)
    hist = tree_map(lambda t: put(t, rep), init_hist(C, d, "cpu"))
    with roofline.CollectiveBytes(mesh) as cb:
        out, hist = lag_sync(st, hist, stats)
    syncs["lag"] = ((_whole(out.proto), _whole(hist)), cb)
    for name, (got, cb) in syncs.items():
        res["sync_" + name] = {"got": got, "payload": cb.by_axis(2),
                               "all": cb.by_axis()}
    if rank == 0:
        torch.save(res, dst)
        print("POD_CASES_OK", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "bytes":
        ranks.spawn(bytes_main, 2, "gloo", sys.argv[2])
    else:
        ranks.spawn(cases_main, 4, "gloo", sys.argv[2], sys.argv[3])
