"""Four gloo ranks on the CPU running the port's vectorized engine on a
client mesh, every fleet composition that the reference's vectorized
engine runs with a mesh (tests/test_multidevice.py's script, markers
included), and fd, il, fedavg, the sharded relay, a bucket layout with
client-sharded and replicated buckets at once, static-k blocks padded with
absent clients, and streaming arrivals.

  PYTHONPATH=src python tests/torch_fleet_ranks.py [OUT_DIR]

On the CPU the fleets start from the reference's weights (its
`init_mlp` under keys split from PRNGKey(0), as its script) and draw from
its key schedule (`JaxDraws` of tests/test_torch_collab.py), so that the
records can be held against the reference's own engine. Each rank runs
each composition on its block of N / 4 clients and sends its round
records, ledger, relay bookkeeping, weights and exchange count to rank 0,
which holds them against the port's sequential engine and its unsharded
vectorized engine on the same fleet, as tests/oracles.py's `run_matched`
holds the reference's: participants, commit lists, ledgers, telemetry
integers and the ring's integer fields exactly; accuracies and telemetry
floats within 2e-2, observations and global prototypes within 5e-3 of the
sequential engine's; against the unsharded engine also every metric
(rtol 1e-3, atol 1e-4) and the observations within 1e-4. Every rank's
records equal rank 0's exactly, and every rank counts one exchange a round
(none in il, which exchanges nothing). Rank 0 prints one marker a
composition and, given OUT_DIR, pickles its results there as
`<marker>.pkl` (tests/test_torch_multidevice.py holds them against the
reference's vectorized engine); a failed check raises, and the run exits
non-zero.

On the card (`card_rank_main`) the fleets are the port's own (its
`init_mlp`, its draws): that machine has no JAX.
"""
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import convert, ranks, sharding  # noqa: E402
from repro_torch.core import client as client_lib, collab, vec_collab  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.relay import placement  # noqa: E402
from repro_torch.types import (CollabConfig, FleetConfig,  # noqa: E402
                               TrainConfig)

WORLD = 4
SPEC = client_lib.ClientSpec(apply=mlp.apply,
                             head=lambda p: (p["head_w"], p["head_b"]))
# a second spec object makes a second bucket, as the reference's SPEC_B
SPEC_B = client_lib.ClientSpec(apply=mlp.apply,
                               head=lambda p: (p["head_w"], p["head_b"]))
EXACT = ("ptr", "owner", "valid", "stamp", "clock", "age", "valid_g")

# (marker, N, fleet, mode, hetero, telemetry, rounds)
COMPOSITIONS = [
    ("SYNC_OK", 8, {}, "cors", None, False, 2),
    ("ASYNC_OK", 8, dict(policy="staleness", clock="lognormal:2"), "cors",
     None, False, 3),
    ("DOWNLOAD_OK", 8, dict(policy="per_class", download_clock="lognormal:2"),
     "cors", None, False, 3),
    # k = 3 on 4 ranks: 2 clients a rank, every rank's block full width
    ("STATICK_OK", 8, dict(participation="uniform_k:3"), "cors", None, False,
     2),
    # k = 3 on 4 ranks of 4: a block of 3 a rank, padded with absent clients
    ("STATICK_PADDED_OK", 16, dict(participation="uniform_k:3"), "cors", None,
     False, 2),
    # 5 + 3: neither bucket divides over 4 ranks, both run whole everywhere
    ("HETERO_OK", 8, {}, "cors", "5+3", False, 2),
    ("TELEMETRY_OK", 8, dict(policy="staleness", clock="lognormal:2"), "cors",
     None, True, 3),
    ("COMPOSED_OK", 8, dict(clock="lognormal:2", download_clock="lognormal:2"),
     "cors", None, False, 3),
    ("FD_OK", 8, {}, "fd", None, False, 2),
    ("IL_OK", 8, {}, "il", None, False, 2),
    ("FEDAVG_OK", 8, {}, "fedavg", None, False, 2),
    ("FEDAVG_STATICK_OK", 16, dict(participation="uniform_k:3"), "fedavg",
     None, False, 2),
    ("SHARDED_OK", 8, dict(policy="sharded:flat,2",
                           participation="uniform_k:3"), "cors", None, False,
     2),
    ("STREAM_OK", 8, dict(arrivals="stream:4,2.0,0.3,20,0"), "cors", None,
     False, 3),
    # 4 + 3 + 1: one client-sharded bucket beside two whole ones, under an
    # upload clock with telemetry (the pending buffer in blocks)
    ("HETERO_BLOCKS_OK", 8, dict(clock="lognormal:2"), "cors", "4+3+1", True,
     3),
    ("HETERO_BLOCKS_SYNC_OK", 8, dict(download_clock="lognormal:1"), "fd",
     "4+3+1", True, 2),
]


def hidden_of(hetero, i: int) -> int:
    if hetero == "5+3":
        return 96 if i % 3 == 0 else 64
    if hetero == "4+3+1":
        return 64 if i % 2 == 0 else (96 if i < 7 else 128)
    return 64


def data(n):
    """The reference script's data (tests/test_multidevice.py): 24 samples a
    client, 96 test images."""
    x, y = synthetic.class_images(24 * n, seed=0, noise=0.4)
    test = synthetic.class_images(96, seed=9, noise=0.4)
    return partition.uniform_split(x, y, n, seed=1), test


def collab_kw(mode):
    return dict(mode=mode, num_classes=10, d_feature=84, lambda_kd=2.0,
                lambda_disc=1.0)


def reference_weights(n, hetero):
    """The reference script's initial weights, as numpy: its `init_mlp`
    under `jax.random.split(PRNGKey(0), n)`."""
    import jax
    from repro.models import mlp as jmlp
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    return [{k: np.asarray(v) for k, v in
             jmlp.init_mlp(key, hidden=hidden_of(hetero, i)).items()}
            for i, key in enumerate(keys)]


def build(engine, n, fleet, mode="cors", hetero=None, telemetry=False,
          mesh=None, device="cpu", reference=False):
    """The reference script's MLP fleet, batch 16, in the port's `engine`.
    With `reference`, the reference's weights and draws; else the port's
    `init_mlp` from seed 0 and its own draws."""
    parts, test = data(n)
    hid = [hidden_of(hetero, i) for i in range(n)]
    specs = [SPEC if h == 64 else SPEC_B for h in hid]
    if reference:
        from test_torch_collab import JaxDraws
        params = [convert.params_from_jax(p, "mlp", device="cpu")
                  for p in reference_weights(n, hetero)]
        draws = JaxDraws(0, n)
    else:
        g = torch.Generator().manual_seed(0)
        params = [mlp.init_mlp(g, hidden=h, device="cpu") for h in hid]
        draws = None
    cls = (collab.CollabTrainer if engine == "seq"
           else vec_collab.VectorizedCollabTrainer)
    return cls(specs, params, parts, test, CollabConfig(**collab_kw(mode)),
               TrainConfig(batch_size=16), seed=0, draws=draws,
               fleet=FleetConfig(mesh=mesh, **fleet), device=device,
               telemetry=telemetry or None)


def relay_fields(state):
    """The relay state's fields as numpy, those it has of EXACT and the
    float ones."""
    out = {}
    for f in EXACT + ("obs", "global_protos"):
        v = getattr(state, f, None)
        if isinstance(v, torch.Tensor):
            out[f] = v.cpu().numpy()
    return out


def held_against(got, want, what, rounds, tight=False):
    """`got` (a mesh run's results) against `want` (a trainer run on one
    process), as `run_matched` holds the reference's engines."""
    assert len(got["records"]) == rounds == len(want.history), what
    for rg, rw in zip(got["records"], want.history):
        for k in ("round", "participants", "commits", "comm_up", "comm_down"):
            assert rg[k] == rw[k], (what, k, rg[k], rw[k])
        np.testing.assert_allclose(rg["accs"], rw["accs"], atol=2e-2,
                                   err_msg=what)
        if tight:
            for mg, mw in zip(rg["metrics"], rw["metrics"]):
                for k in mw:
                    np.testing.assert_allclose(mg[k], mw[k], rtol=1e-3,
                                               atol=1e-4, err_msg=what + k)
        assert ("telemetry" in rg) == ("telemetry" in rw), what
        if "telemetry" in rw:
            for k in obs_metrics.EXACT_LEAVES:
                assert rg["telemetry"][k] == rw["telemetry"][k], (what, k)
            for k in obs_metrics.FLOAT_LEAVES:
                np.testing.assert_allclose(rg["telemetry"][k],
                                           rw["telemetry"][k], atol=2e-2,
                                           rtol=2e-2, err_msg=what + k)
    assert got["ledger"] == want.ledger.by_round, what
    state = want.server.state if hasattr(want, "server") else want.relay_state
    ref = relay_fields(state)
    for f, v in got["relay"].items():
        if f in EXACT:
            np.testing.assert_array_equal(v, ref[f], err_msg=what + f)
        else:
            np.testing.assert_allclose(v, ref[f], atol=1e-4 if tight else 5e-3,
                                       err_msg=what + f)


def rank_main(rank, world, out_dir=None):
    ranks.cpu_threads()
    mesh = sharding.client_mesh(world)
    # the fleet must divide over the ranks (the reference's guard)
    try:
        build("vec", 6, {}, mesh=mesh, reference=True)
    except ValueError as e:
        assert "must divide" in str(e), e
    else:
        raise SystemExit("N=6 on a 4-rank mesh should be refused")
    if rank == 0:
        print("UNEVEN_GUARD_OK", flush=True)
    for marker, n, fleet, mode, hetero, telem, rounds in COMPOSITIONS:
        vec = build("vec", n, fleet, mode, hetero, telem, mesh=mesh,
                    reference=True)
        if hetero is None:               # this rank's block of the stack
            assert (vec._lo, vec._hi) == (rank * n // world,
                                          (rank + 1) * n // world), marker
        if marker == "STATICK_PADDED_OK":
            assert vec._k_block == 3 < vec._hi - vec._lo, marker
        if marker.startswith("HETERO_BLOCKS"):
            assert [t for t, _ in vec._layout] == [
                placement.CLIENT_SHARDED, placement.REPLICATED,
                placement.REPLICATED], vec._layout
        placement.reset_exchanges()
        for _ in range(rounds):
            vec.run_round()
        mine = {"records": vec.history, "ledger": vec.ledger.by_round,
                "relay": relay_fields(vec.relay_state),
                "exchanges": placement.EXCHANGES["exchange"],
                # a collective on the mesh: every rank asks for every client
                "weights": [convert.params_to_numpy(vec.client_params(i),
                                                    "mlp") for i in range(n)]}
        everyone = [None] * world
        dist.all_gather_object(everyone, mine)
        if rank == 0:
            for r, got in enumerate(everyone):
                assert got["records"] == mine["records"], (marker, r)
                assert got["exchanges"] == (0 if mode == "il" and not telem
                                            else rounds), (marker, got)
            seq = build("seq", n, fleet, mode, hetero, telem, reference=True)
            plain = build("vec", n, fleet, mode, hetero, telem,
                          reference=True)
            for _ in range(rounds):
                seq.run_round()
                plain.run_round()
            held_against(mine, seq, marker + " vs seq ", rounds)
            held_against(mine, plain, marker + " vs unsharded vec ", rounds,
                         tight=True)
            if out_dir:
                with open(os.path.join(out_dir, marker + ".pkl"), "wb") as f:
                    pickle.dump(mine, f)
            print(marker, flush=True)
        dist.barrier()
    if rank == 0:
        print("MULTIDEVICE_OK", flush=True)


# the compositions of the four ranks sharing one card
CARD_COMPOSITIONS = ("SYNC_OK", "ASYNC_OK", "HETERO_OK", "TELEMETRY_OK")


def card_rank_main(rank, world, out_dir):
    """One of four ranks sharing cuda:0 over gloo: CARD_COMPOSITIONS on its
    block, its results pickled to out_dir/rank{rank}.pkl."""
    # the card tests' precision (their `cuda` fixture): TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = sharding.client_mesh(world)
    out = {}
    for marker, n, fleet, mode, hetero, telem, rounds in COMPOSITIONS:
        if marker in CARD_COMPOSITIONS:
            vec = build("vec", n, fleet, mode, hetero, telem, mesh=mesh,
                        device="cuda")
            placement.reset_exchanges()
            for _ in range(rounds):
                vec.run_round()
            out[marker] = {"records": vec.history,
                           "ledger": vec.ledger.by_round,
                           "relay": relay_fields(vec.relay_state),
                           "exchanges": placement.EXCHANGES["exchange"]}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    ranks.spawn(rank_main, WORLD, "gloo", *sys.argv[1:2])
