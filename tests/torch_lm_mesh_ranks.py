"""Four gloo ranks on the CPU running the port's LM launch path on the
mesh (2, 2) over ("data", "model"): serving (prefill, then one decode step
against the prefill's caches padded by a slot) and, for each strategy
"tp", "dp_only" and "zero1", client 0's gradients and one cors train step,
on parameters, caches, states and batches placed by the serve and train
shardings (`sharding.place`).

  PYTHONPATH=src python tests/torch_lm_mesh_ranks.py IN OUT

First each rank checks that a dim split over ("pod", "data") is split
pod-major, as JAX splits it (`pod_major`). IN is a `torch.save`d dict a
case ({"arch": {"params": the reference's
parameters converted to the port, "prompts", "token", "state", "batch",
"neg"}}), written by tests/test_torch_lm_mesh.py from the reference's
weights; the ranks import nothing of JAX. Each rank gathers every output
whole; rank 0 saves them to OUT, and the test holds them against the
reference's unsharded steps. A rank that fails raises, and the run exits
non-zero.
"""
import sys

import torch

from repro_torch import ranks, sharding
from repro_torch.configs import get_arch
from repro_torch.core import prototypes
from repro_torch.launch import mesh as lmesh, serve, train
from repro_torch.models import lm
from repro_torch.tree import leaves, tree_map
from repro_torch.types import CollabConfig

WORLD, SHAPE = 4, (2, 2)
STRATEGIES = ("tp", "dp_only", "zero1")
K = 15                      # negatives a client


def run_case(cfg, case, mesh):
    out = {}
    params = sharding.place(case["params"], serve.params_shardings(
        case["params"], cfg, mesh), mesh, src_data_rank=None)
    toks = {"tokens": case["prompts"]}
    put = lambda b: sharding.place(b, serve.batch_shardings(b, mesh), mesh,
                                   src_data_rank=None)
    with torch.no_grad():
        pre = serve.make_prefill_step(cfg)(params, put(toks))
        out["prefill_logits"] = sharding.full(pre["logits"])
        out["prefill_caches"] = [sharding.full(t) for t in leaves(pre["caches"])]
        caches = lm.pad_cache_for_decode(cfg, pre["caches"])
        dec = serve.make_decode_step(cfg)(params, put(
            {"tokens": case["token"]}), caches)
        out["decode_logits"] = sharding.full(dec["logits"])
    ccfg = CollabConfig(mode="cors", num_classes=cfg.vocab_size,
                        d_feature=cfg.d_feature, num_negatives=K)
    N = case["neg"].shape[0]
    step = train.make_train_step(cfg, ccfg, n_clients=N)
    loss_fn = train.make_loss_fn(cfg, ccfg)
    for strategy in STRATEGIES:
        sharding.set_hints(mesh=mesh, moe_ep=False,
                           moe_dp=strategy in ("dp_only", "zero1"))
        try:
            st = sharding.place(case["state"], train.state_shardings(
                case["state"], cfg, mesh, N, strategy=strategy), mesh,
                src_data_rank=None)
            b = sharding.place(case["batch"], train.batch_shardings(
                case["batch"], mesh, N, strategy=strategy), mesh,
                src_data_rank=None)
            g, m0, _, _ = train.client_grads(
                loss_fn, tree_map(lambda a: a[0], st.params),
                {k: v[0] for k, v in b.items()},
                prototypes.means(st.proto), case["neg"][0])
            new, met = step(st, b, case["neg"])
        finally:
            sharding.set_hints(mesh=None)
        out[strategy] = {
            "grads": tree_map(sharding.full, g),
            "client0": {k: float(sharding.full(v)) for k, v in m0.items()},
            "metrics": {k: float(sharding.full(v)) for k, v in met.items()},
            "state": tree_map(sharding.full, new)}
    return out


def pod_major(rank):
    """A dim split over ("pod", "data") on a (2, 2) mesh of those axes:
    the rank at (p, d) holds block p * 2 + d of four, pod-major, as JAX
    splits a dim over a tuple of axes (the first one major)."""
    mesh = lmesh.device_mesh(lmesh.MeshShape(("pod", "data"), SHAPE))
    x = torch.arange(16).reshape(8, 2)
    got = sharding.place(x, (("pod", "data"), None), mesh,
                         src_data_rank=None).to_local()
    p, d = mesh.get_local_rank("pod"), mesh.get_local_rank("data")
    block = p * SHAPE[1] + d
    if not torch.equal(got, x[2 * block:2 * block + 2]):
        raise AssertionError(f"rank {rank} at (pod {p}, data {d}) holds "
                             f"{got.tolist()}, not block {block}")


def rank_main(rank, world, src, dst):
    ranks.cpu_threads()
    pod_major(rank)
    if rank == 0:
        print("POD_MAJOR_OK", flush=True)
    mesh = lmesh.device_mesh(lmesh.MeshShape(("data", "model"), SHAPE))
    cases = torch.load(src, weights_only=False)
    res = {arch: run_case(get_arch(arch).reduced(), case, mesh)
           for arch, case in cases.items()}
    if rank == 0:
        torch.save(res, dst)
        print("LM_MESH_OK", flush=True)


if __name__ == "__main__":
    ranks.spawn(rank_main, WORLD, "gloo", sys.argv[1], sys.argv[2])
