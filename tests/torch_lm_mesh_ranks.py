"""Four gloo ranks on the CPU running the port's LM launch path on the
mesh (2, 2) over ("data", "model"): serving (prefill, then one decode step
against the prefill's caches padded by a slot, and `serve_lm.serve` with
its caches grown and placed by `serve.cache_shardings`) and, for each
strategy "tp", "dp_only" and "zero1", client 0's gradients and one cors
train step, on parameters, caches, states and batches placed by the serve
and train shardings (`sharding.place`).

  PYTHONPATH=src python tests/torch_lm_mesh_ranks.py IN OUT
  PYTHONPATH=src python tests/torch_lm_mesh_ranks.py dryrun OUT

First each rank checks that a dim split over ("pod", "data") is split
pod-major, as JAX splits it (`pod_major`). IN is a `torch.save`d dict a
case ({"arch": {"params": the reference's parameters converted to the
port, "serve": the prefill's batch, "decode": the decode step's, "state",
"batch", "neg"}}), written by tests/test_torch_lm_mesh.py from the
reference's weights; a case with "pod" also runs one cors step with
its clients split over "pod" (`pod_step`); a case with "moe_ep" also
serves and runs one "tp" step under the expert-parallel hint
(`moe_ep_case`: every rank holds E / 2 experts of each `_e` leaf, and the
expert products run on the expert split). A batch is what the arch takes: tokens; embeddings
and M-RoPE positions (Qwen2-VL); tokens and audio frames (Whisper's
prefill and train batches). The ranks import nothing of JAX. Each rank
gathers every output whole; rank 0 saves them to OUT, and the test holds
them against the reference's unsharded steps. With `dryrun`, two ranks
write the dry-run's `--one-step` records of DRYRUN (tests/
test_torch_lm_mesh_dryrun.py). A rank that fails raises, and the run exits
non-zero.
"""
import sys
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch import ranks, serve_lm, sharding
from repro_torch.configs import get_arch
from repro_torch.core import prototypes
from repro_torch.launch import dryrun, mesh as lmesh, roofline, serve, train
from repro_torch.models import encdec, lm
from repro_torch.nn import moe
from repro_torch.tree import tree_map
from repro_torch.types import CollabConfig

WORLD, SHAPE = 4, (2, 2)
STRATEGIES = ("tp", "dp_only", "zero1")
K = 15                      # negatives a client
POD_SHAPE = (2, 1, 2)       # ("pod", "data", "model"): a client a pod
# the dry-run's one step on two ranks, mesh (2, 1, 1): (arch, shapes)
DRYRUN = (("zamba2-1.2b", ("train_4k", "prefill_32k", "decode_32k")),
          ("deepseek-v2-lite-16b", ("train_4k", "prefill_32k",
                                    "decode_32k")))


def make_batches(cfg, rng, n, b, s):
    """Seeded numpy inputs of the arch's kind: the prefill's batch (b, s),
    the decode step's (b, 1) at position s, and the train batch (n, b, s)
    with its labels. Tokens; embeddings and M-RoPE positions (t, h, w)
    where the model takes embeddings; audio frames (encoder_seq of them)
    beside an encoder-decoder's tokens."""
    V, d = cfg.vocab_size, cfg.d_model

    def one(lead, S, t0):
        if cfg.input_kind == "tokens" or cfg.is_encoder_decoder:
            return {"tokens": rng.integers(0, V, lead + (S,)).astype(np.int32)}
        x = {"embeddings": rng.standard_normal(lead + (S, d)).astype(
            np.float32)}
        if cfg.rope_kind == "mrope":
            t = np.broadcast_to(t0 + np.arange(S), lead + (S,))
            hw = rng.integers(0, 8, lead + (S, 2))
            x["positions"] = np.concatenate([t[..., None], hw], -1).astype(
                np.int32)
        return x

    def frames(lead):
        return rng.standard_normal(lead + (cfg.encoder_seq, d)).astype(
            np.float32)

    pre, dec, tr = one((b,), s, 0), one((b,), 1, s), one((n, b), s, 0)
    tr["labels"] = rng.integers(0, V, (n, b, s)).astype(np.int32)
    if cfg.is_encoder_decoder:
        pre["frames"], tr["frames"] = frames((b,)), frames((n, b))
    return pre, dec, tr


def pad_for_decode(cfg, caches):
    """The prefill's caches padded by one slot for the decode step."""
    if cfg.is_encoder_decoder:
        return encdec.pad_cache_for_decode(caches)
    return lm.pad_cache_for_decode(cfg, caches)


def _put(tree, specs, mesh):
    if mesh is None:
        return tree
    return sharding.place(tree, specs, mesh, src_data_rank=None)


def serve_case(cfg, case, mesh, params, out):
    """Prefill, one decode step and `serve_lm.serve` of one token into
    `out`, gathered whole."""
    bspec = lambda b: None if mesh is None else serve.batch_shardings(b, mesh)
    put = lambda tree, specs: _put(tree, specs, mesh)
    with torch.no_grad():
        pre = serve.make_prefill_step(cfg)(params,
                                           put(case["serve"],
                                               bspec(case["serve"])))
        out["prefill_logits"] = sharding.full(pre["logits"])
        # copies: decode overwrites the recurrent states in place
        out["prefill_caches"] = tree_map(lambda t: sharding.full(t).clone(),
                                         pre["caches"])
        caches = pad_for_decode(cfg, pre["caches"])
        dec = serve.make_decode_step(cfg)(
            params, put(case["decode"], bspec(case["decode"])), caches)
        out["decode_logits"] = sharding.full(dec["logits"])
        out["decode_caches"] = tree_map(sharding.full, dec["caches"])
        # the serving loop: one token, its caches grown and placed by
        # `cache_shardings`, decoding the same batch
        r = serve_lm.serve(params, cfg, case["serve"], 1,
                           next_batch=lambda i, logits: case["decode"],
                           mesh=mesh)
        out["serve_logits"] = r["logits"]
        out["serve_caches"] = tree_map(sharding.full, r["caches"])


def run_case(cfg, case, mesh):
    """The serving and training outputs of one case, gathered whole; on
    `mesh` None the unsharded path on the same inputs."""
    out = {}
    put = lambda tree, specs: _put(tree, specs, mesh)
    params = put(case["params"], None if mesh is None
                 else serve.params_shardings(case["params"], cfg, mesh))
    serve_case(cfg, case, mesh, params, out)
    for strategy in STRATEGIES if mesh is not None else ("tp",):
        out[strategy] = train_case(cfg, case, mesh, strategy, moe_ep=False)
    if case.get("pod") and mesh is not None:
        out["pod"] = pod_step(cfg, case, CollabConfig(
            mode="cors", num_classes=cfg.vocab_size,
            d_feature=cfg.d_feature, num_negatives=K))
    if case.get("moe_ep") and mesh is not None:
        out["moe_ep"] = moe_ep_case(cfg, case, mesh)
    return out


def train_case(cfg, case, mesh, strategy, *, moe_ep):
    """Client 0's gradients and one cors step under `strategy`, gathered
    whole."""
    put = lambda tree, specs: _put(tree, specs, mesh)
    ccfg = CollabConfig(mode="cors", num_classes=cfg.vocab_size,
                        d_feature=cfg.d_feature, num_negatives=K)
    N = case["neg"].shape[0]
    step = train.make_train_step(cfg, ccfg, n_clients=N)
    loss_fn = train.make_loss_fn(cfg, ccfg)
    sharding.set_hints(mesh=mesh, moe_ep=moe_ep,
                       moe_dp=strategy in ("dp_only", "zero1"))
    try:
        st = put(case["state"], None if mesh is None
                 else train.state_shardings(case["state"], cfg, mesh, N,
                                            strategy=strategy))
        b = put(case["batch"], None if mesh is None
                else train.batch_shardings(case["batch"], mesh, N,
                                           strategy=strategy))
        g, m0, _, _ = train.client_grads(
            loss_fn, tree_map(lambda a: a[0], st.params),
            {k: v[0] for k, v in b.items()},
            prototypes.means(st.proto), case["neg"][0])
        new, met = step(st, b, case["neg"])
    finally:
        sharding.set_hints(mesh=None, moe_ep=False)
    return {"grads": tree_map(sharding.full, g),
            "client0": {k: float(sharding.full(v)) for k, v in m0.items()},
            "metrics": {k: float(sharding.full(v)) for k, v in met.items()},
            "state": tree_map(sharding.full, new)}


def moe_ep_case(cfg, case, mesh):
    """Serving and one "tp" step under the "moe_ep" hint: the expert
    leaves split on their expert dim over "model", checked on every rank
    (E / model experts held, every `_experts` call on that split), and the
    outputs gathered whole. -> the outputs, with "local_experts" (the
    experts a rank holds of each `_e` leaf) and "placements" (the expert
    weights' placements at each `_experts` call)."""
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    seen, before = [], moe._experts

    def spy(buf, w_gate, w_up, w_down):
        seen.append(tuple(str(p) for p in w_gate.placements))
        return before(buf, w_gate, w_up, w_down)

    out = {}
    moe._experts = spy
    sharding.set_hints(mesh=mesh, moe_ep=True, moe_dp=False)
    try:
        params = _put(case["params"], serve.params_shardings(
            case["params"], cfg, mesh), mesh)
        held = []
        sharding.map_params(lambda path, t, n: held.append(
            t.to_local().shape[0]) if path.endswith("_e") else None, params)
        if not held or set(held) != {cfg.num_experts // tp}:
            raise AssertionError(f"moe_ep: a rank holds {held} experts of "
                                 f"its _e leaves, not {cfg.num_experts} / "
                                 f"{tp}")
        serve_case(cfg, case, mesh, params, out)
        out["tp"] = train_case(cfg, case, mesh, "tp", moe_ep=True)
    finally:
        moe._experts = before
        sharding.set_hints(mesh=None, moe_ep=False)
    out["local_experts"] = held
    out["placements"] = sorted(set(seen))
    return out


def pod_step(cfg, case, ccfg):
    """One cors step ("tp") with the clients split over "pod" on the mesh
    POD_SHAPE (each rank trains its own client on its ("data", "model")
    sub-mesh), gathered whole, with the bytes each collective moved by mesh
    axis."""
    mesh = lmesh.device_mesh(lmesh.MeshShape(("pod", "data", "model"),
                                             POD_SHAPE))
    N = case["neg"].shape[0]
    step = train.make_train_step(cfg, ccfg, n_clients=N)
    sharding.set_hints(mesh=mesh, moe_ep=False, moe_dp=False)
    try:
        st = sharding.place(case["state"], train.state_shardings(
            case["state"], cfg, mesh, N), mesh, src_data_rank=None)
        b = sharding.place(case["batch"], train.batch_shardings(
            case["batch"], mesh, N), mesh, src_data_rank=None)
        with roofline.CollectiveBytes(mesh) as cb:
            new, met = step(st, b, case["neg"])
    finally:
        sharding.set_hints(mesh=None)
    return {"state": tree_map(sharding.full, new),
            "metrics": {k: float(sharding.full(v)) for k, v in met.items()},
            "payload": cb.by_axis(2)}


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


def dryrun_main(rank, world, dst):
    """The dry-run's `--one-step` record (`dryrun._run_record`, cors, "tp")
    of each of DRYRUN on the mesh (2, 1, 1); rank 0 saves them to dst."""
    ranks.cpu_threads()
    mesh = lmesh.device_mesh(lmesh.MeshShape(("pod", "data", "model"),
                                             (2, 1, 1)))
    args = SimpleNamespace(mode="cors", tag="")
    knobs = dict(strategy="tp", moe_ep=False, sync="step")
    recs = [dryrun._run_record(arch, shape, mesh, lmesh.describe(mesh), args,
                               knobs)
            for arch, shapes in DRYRUN for shape in shapes]
    if rank == 0:
        torch.save(recs, dst)
        print("DRYRUN_OK", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "dryrun":
        ranks.spawn(dryrun_main, 2, "gloo", sys.argv[2])
    else:
        ranks.spawn(rank_main, WORLD, "gloo", sys.argv[1], sys.argv[2])
