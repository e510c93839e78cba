"""End-to-end run of the port (the twin of
examples/collab_image_classification.py): N = 5 LeNet clients on sparse
local data, CoRS or one of the paper's Table 1 baselines (fd, fedavg, il),
per-round accuracy, exact communication accounting and the kernels' launch
counts. `--engine vec` (the default, as in the reference's example) runs all
clients in one batched round step (one a bucket with `--hetero`), `seq` the
sequential engine. `--relay-policy` picks the server's relay (cors and
fd), `--participation` who takes part in each round, `--hetero` makes
the fleet mixed: the MLP on odd client ids, LeNet on even ones.
`--clock-model` makes uploads commit late (stragglers, in event order) and
`--download-clock` makes clients train against stale relay snapshots.
Telemetry metrics are always on (`repro_torch.obs`): the run ends with the
fleet's late commits and stale reads, `--telemetry-out` streams the round
records to a JSONL file (render it with `python -m repro_torch.obs.report`),
and `--out` receives one checkpoint a client, `client{i}.npz` in the
reference's layout (`convert.params_to_numpy`: HWIO convolutions), which the
reference's `load_pytree` reads. CL, il on
one client holding all the data, is `build_trainer(1, "cl")`, as the
reference's `benchmarks/common.run_mode("cl", 1)`; a streaming fleet (the
clients are seats of a cohort table, `sim/population.py`) is
`build_trainer(..., arrivals="stream:k,rate,p_leave,population,seed")`, as
the reference's `benchmarks/common.make_trainer(..., arrivals=...)`.

`--ranks W` runs the vec engine on a client mesh of W ranks, N / W clients
a rank, with the round's uploads as its one exchange (`FleetConfig.mesh`,
`relay/placement.py`): W processes started here (`ranks.spawn`), or, under
`torchrun --nproc-per-node W -m repro_torch.collab_image_classification`,
the launcher's ranks. On CUDA with a card a rank the ranks talk over NCCL,
otherwise (the CPU, or ranks sharing a card) over gloo. Every rank runs every round and holds the same records;
rank 0 prints and writes the checkpoints.

  PYTHONPATH=src python -m repro_torch.collab_image_classification \
      [--rounds R] [--clients N] [--mode cors|il|fd|fedavg] \
      [--relay-policy flat|per_class|staleness[:lam]|sharded:<inner>,<S>[,<g>]] \
      [--participation full|uniform_k:K|cyclic:K|bernoulli:P|adaptive:P[,B]] \
      [--hetero] [--clock-model none|homogeneous:D|lognormal:D[,S]|periodic:D,P] \
      [--download-clock none|homogeneous:D|lognormal:D[,S]|periodic:D,P] \
      [--engine vec|seq] [--device cuda|cpu] [--ranks W] \
      [--telemetry-out RUN.jsonl] [--out DIR]
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import convert, obs, ranks, sharding
from repro_torch.checkpoint import save_pytree
from repro_torch.core import client as client_lib, collab, vec_collab
from repro_torch.data import partition, synthetic
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import cnn, mlp
from repro_torch.types import CollabConfig, FleetConfig, TrainConfig

CNN_SPEC = client_lib.ClientSpec(apply=cnn.apply,
                                 head=lambda p: (p["head_w"], p["head_b"]))
MLP_SPEC = client_lib.ClientSpec(apply=mlp.apply,
                                 head=lambda p: (p["head_w"], p["head_b"]))


ENGINES = {"vec": vec_collab.VectorizedCollabTrainer,
           "seq": collab.CollabTrainer}


def build_trainer(clients: int = 5, mode: str = "cors", seed: int = 0,
                  lambda_kd: float = 2.0, lambda_disc: float = 1.0,
                  device=None, engine: str = "vec", n_train: int = 1200,
                  relay_policy=None, participation=None,
                  hetero: bool = False, clock=None, download_clock=None,
                  arrivals=None, telemetry=None, mesh=None):
    """The example's fleet: `class_images(n_train)` split uniformly over the
    clients, 2000 test images, batch 32, LeNet clients (with `hetero`, the
    MLP on odd client ids) with random weights from `seed`, in the `engine`
    trainer with the `relay_policy` relay, the `participation` schedule,
    the upload `clock` and the `download_clock` (`repro_torch.sim` specs;
    None or "none" is the synchronous fleet), and the `arrivals` schedule
    (None, or "stream:...": the clients are seats of a cohort table), with
    `telemetry` as the trainers take it (None: off), on the client `mesh`
    (None, or `sharding.client_mesh(W)`: the vec engine only)."""
    x, y = synthetic.class_images(n_train, seed=0, noise=0.8)
    tx, ty = synthetic.class_images(2000, seed=99, noise=0.8)
    parts = partition.uniform_split(x, y, clients, seed=1)
    g = torch.Generator().manual_seed(seed)
    mixed = [hetero and i % 2 == 1 for i in range(clients)]
    specs = [MLP_SPEC if m else CNN_SPEC for m in mixed]
    params = [mlp.init_mlp(g, device="cpu") if m
              else cnn.init_cnn(g, device="cpu") for m in mixed]
    ccfg = CollabConfig(mode=mode, num_classes=10, d_feature=84,
                        lambda_kd=lambda_kd, lambda_disc=lambda_disc)
    return ENGINES[engine](specs, params, parts, (tx, ty), ccfg,
                           TrainConfig(batch_size=32), seed=seed,
                           fleet=FleetConfig(policy=relay_policy,
                                             participation=participation,
                                             clock=clock,
                                             download_clock=download_clock,
                                             arrivals=arrivals, mesh=mesh),
                           device=device, telemetry=telemetry)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--mode", default="cors",
                    choices=["cors", "il", "fd", "fedavg"])
    ap.add_argument("--relay-policy", default="flat",
                    help="the server's relay: flat | per_class | "
                         "staleness[:lam] | sharded:<inner>,<S>[,<g>] (S "
                         "cohort shards of the inner relay, prototypes "
                         "gossiped every g merges)")
    ap.add_argument("--participation", default="full",
                    help="who takes part in each round: full | uniform_k:K "
                         "| cyclic:K | bernoulli:P | adaptive:P[,BOOST]")
    ap.add_argument("--hetero", action="store_true",
                    help="mixed fleet: odd client ids run the MLP instead "
                         "of LeNet (vec: one batched step a model)")
    ap.add_argument("--clock-model", default="none",
                    help="upload clock of the asynchronous relay: none | "
                         "homogeneous[:delay] | lognormal[:dmax[,sigma]] | "
                         "periodic[:dmax[,period]]; e.g. lognormal:4 is a "
                         "straggler fleet whose uploads commit up to 4 "
                         "rounds late, in event order")
    ap.add_argument("--download-clock", default="none",
                    help="download lag, the same specs as --clock-model "
                         "with their own randomness: clients read teachers "
                         "and global prototypes from the relay snapshot of "
                         "d rounds ago; e.g. periodic:3,4 is a duty-cycled "
                         "fleet syncing every 4 rounds")
    ap.add_argument("--engine", default="vec", choices=sorted(ENGINES))
    ap.add_argument("--lambda-kd", type=float, default=2.0)
    ap.add_argument("--lambda-disc", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--telemetry-out", default=None, metavar="RUN.jsonl",
                    help="stream the round records, telemetry included, to "
                         "this JSONL file (render it with `python -m "
                         "repro_torch.obs.report RUN.jsonl`); telemetry "
                         "metrics are on either way")
    ap.add_argument("--out", default="artifacts/collab_ckpt",
                    help="directory of the per-client checkpoints")
    ap.add_argument("--ranks", type=int, default=0,
                    help="run the vec engine on a client mesh of this many "
                         "ranks, started here (0: no mesh; under torchrun "
                         "the launcher's ranks)")
    args = ap.parse_args(argv)
    if ranks.under_launcher():
        world = int(os.environ["WORLD_SIZE"])
        rank = ranks.init_from_env(_backend(args.device, world))
        try:
            _run(rank, world, args)
        finally:
            torch.distributed.destroy_process_group()
    elif args.ranks:
        ranks.spawn(_run, args.ranks, _backend(args.device, args.ranks), args)
    else:
        _run(0, 0, args)


def _backend(device, world: int) -> str:
    """NCCL where the ranks run on CUDA with a card each; gloo on the CPU
    or where ranks share a card (NCCL refuses two ranks on one device)."""
    cuda = resolve_device(device).type == "cuda"
    return "nccl" if cuda and world <= torch.cuda.device_count() else "gloo"


def _run(rank: int, world: int, args):
    """The run in one process: rank `rank` of a client mesh of `world`
    ranks (0: no mesh). Rank 0 prints and writes the checkpoints."""
    if world and (args.device == "cpu" or not torch.cuda.is_available()):
        ranks.cpu_threads()
    say = print if rank == 0 else (lambda *a, **k: None)
    trainer = build_trainer(args.clients, args.mode,
                            lambda_kd=args.lambda_kd,
                            lambda_disc=args.lambda_disc, device=args.device,
                            engine=args.engine,
                            relay_policy=args.relay_policy,
                            participation=args.participation,
                            hetero=args.hetero, clock=args.clock_model,
                            download_clock=args.download_clock,
                            telemetry=obs.TelemetryConfig(
                                jsonl=args.telemetry_out if rank == 0
                                else None),
                            mesh=sharding.client_mesh(world) if world
                            else None)
    say(f"{args.clients} clients sharing 1200 samples, mode={args.mode}, "
          f"relay={args.relay_policy}, participation={args.participation}, "
          f"clock={args.clock_model}, download clock={args.download_clock}, "
          f"engine={args.engine}, device={trainer.device}"
          + (", hetero LeNet/MLP fleet" if args.hetero else "")
          + (f", client mesh of {world} ranks" if world else ""))
    ops.reset_launches()
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        rec = trainer.run_round()
        dt = time.perf_counter() - t0
        say(f"  round {rec['round']:3d} acc {rec['acc_mean']:.4f} "
              f"±{rec['acc_std']:.4f}  comm {trainer.ledger.total_bytes/1e6:.2f}"
              f" MB  {dt:.3f} s  participants {rec['participants']}  "
              f"commits {rec['commits']}  "
              f"launches {dict(ops.LAUNCHES)}")
    # fleet health from the engine's own telemetry: the counters both
    # engines compute, not recounted here
    telem = [h["telemetry"] for h in trainer.history]
    late = sum(sum(t["commit_hist"][1:]) for t in telem)
    if late:
        say(f"async relay: {late} uploads committed late (in event order, "
              f"see src/repro_torch/relay/events.py)")
    stale = sum(t["stale_reads"] for t in telem)
    if stale:
        say(f"download lag: {stale} client-rounds trained against a stale "
              f"relay snapshot (history ring, see "
              f"src/repro_torch/relay/history.py)")
    if args.telemetry_out:
        say(f"telemetry: {args.telemetry_out} (render with `python -m "
              f"repro_torch.obs.report {args.telemetry_out}`)")

    for i in range(args.clients):
        # on a mesh `client_params` is a collective: every rank calls it
        p = (trainer.client_params(i) if args.engine == "vec"
             else trainer.clients[i].params)
        kind = "mlp" if args.hetero and i % 2 == 1 else "cnn"
        if rank == 0:
            save_pytree(os.path.join(args.out, f"client{i}.npz"),
                        convert.params_to_numpy(p, kind), step=args.rounds)
    best = max(h["acc_mean"] for h in trainer.history)
    say(f"\nbest mean accuracy: {best:.4f}; "
          f"total comm {trainer.ledger.total_bytes/1e6:.2f} MB; "
          f"checkpoints in {args.out}/")


if __name__ == "__main__":
    main()
