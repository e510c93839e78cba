"""CoRS across heterogeneous LM architectures, the twin of
examples/collab_lm.py: a reduced TinyLlama client and a reduced xLSTM
client collaborate purely through per-class (= per-next-token) feature
representations. No weights cross the boundary, so the architectures never
need to match.

The same fleet as the reference's example: vocab 256, sequences of 64,
batch 8, 8 local steps a round, L_disc on the first 64 tokens of a batch
with 32 sampled negatives. `--clock-model` commits each client's prototype
stats late through the bounded-delay pending buffer
(`launch.train.make_async_round_sync`), and `--download-clock` serves each
client the global prototypes from a past round through the history ring
(`relay/history.py`). `--telemetry-out` streams per-round records (CE,
late and stale counters, prototype drift, mass and coverage from
`launch.train.proto_round_telemetry`) to a JSONL that
`python -m repro_torch.obs.report` renders. Draws (batch seeds, negative
classes) come from numpy and a `torch.Generator`, so the numbers are the
twin's own.

  PYTHONPATH=src python -m repro_torch.collab_lm [--rounds R] \
      [--clock-model none|homogeneous:D|lognormal:D[,S]|periodic:D,P] \
      [--download-clock none|...] [--telemetry-out RUN.jsonl] \
      [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import obs, sim
from repro_torch.configs import get_arch
from repro_torch.core import losses, prototypes
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.optim import adam_init, adam_update
from repro_torch.relay import history as relay_history
from repro_torch.types import CollabConfig

VOCAB = 256
SEQ = 64
BATCH = 8
STEPS_PER_ROUND = 8
DISC_TOKENS = 64
NEGATIVES = 32


def make_client(arch: str, gen: torch.Generator, device):
    cfg = get_arch(arch).reduced(vocab_size=VOCAB)
    params = lm.init_lm(gen, cfg, device=device)
    return {"cfg": cfg, "params": params, "opt": adam_init(params)}


def make_loss_fn(cfg, lam_kd: float, lam_disc: float):
    """The example's per-client loss, in `launch.train.client_grads`'s
    form: (total, (metrics, features, labels))."""
    def loss_fn(params, batch, proto_means, neg_ids):
        out = lm.forward(params, cfg, {"tokens": batch["tokens"]})
        feats, logits = out["features"], out["logits"]
        labels = batch["labels"]
        f = feats.reshape(-1, feats.shape[-1])
        y = labels.reshape(-1)
        z = logits.reshape(-1, VOCAB)
        l_ce = losses.ce_loss(z, y)
        l_kd = losses.kd_loss(f, proto_means, y)
        l_disc = losses.disc_loss_sampled(
            neg_ids, f[:DISC_TOKENS], proto_means, y[:DISC_TOKENS],
            params["lm_head"], student_logits=z[:DISC_TOKENS])
        total = l_ce + lam_kd * l_kd + lam_disc * l_disc
        return total, ({"ce": l_ce}, feats, labels)
    return loss_fn


def local_round(client, batches, proto_means, lam_kd, lam_disc,
                gen: torch.Generator):
    """STEPS_PER_ROUND Adam steps; -> (the last step's CE, the round's
    per-class feature stats)."""
    cfg = client["cfg"]
    loss_fn = make_loss_fn(cfg, lam_kd, lam_disc)
    dev = proto_means.device
    stats = prototypes.init_state(VOCAB, cfg.d_model, dev)
    ce = None
    for batch in batches:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        neg = losses.sample_negatives(gen, NEGATIVES, VOCAB)
        grads, m, feats, labels = launch_train.client_grads(
            loss_fn, client["params"], batch, proto_means, neg)
        client["params"], client["opt"] = adam_update(
            client["params"], grads, client["opt"])
        ce = m["ce"]
        stats = prototypes.accumulate(stats, feats.reshape(-1, cfg.d_model),
                                      labels.reshape(-1))
    return float(ce), stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--clock-model", default="none",
                    help="virtual-time upload clock (repro_torch.sim): none | "
                         "homogeneous[:delay] | lognormal[:dmax[,sigma]] | "
                         "periodic[:dmax[,period]]; a client's round-r "
                         "prototype stats join the shared state in round "
                         "r+delay via the bounded-delay pending buffer")
    ap.add_argument("--download-clock", default="none",
                    help="download-lag clock (same specs, independent "
                         "randomness): clients read the global prototypes "
                         "of round t-d from the history ring instead of this "
                         "round's fresh merge")
    ap.add_argument("--telemetry-out", default=None, metavar="RUN.jsonl",
                    help="stream per-round records (CE, late/stale "
                         "counters, prototype drift) to this JSONL file "
                         "(render with `python -m repro_torch.obs.report "
                         "RUN.jsonl`)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    gen = torch.Generator(device=dev).manual_seed(0)
    clients = [make_client("tinyllama-1.1b", gen, dev),
               make_client("xlstm-125m", gen, dev)]
    # both reduced archs give 256-dim features, as shared prototypes need
    assert clients[0]["cfg"].d_model == clients[1]["cfg"].d_model
    d = clients[0]["cfg"].d_model
    n = len(clients)

    stream = synthetic.token_stream(100_000, vocab=VOCAB, seed=0)
    splits = [stream[:50_000], stream[50_000:]]      # private corpora

    # fleet clocking: the upload clock feeds the bounded-delay pending
    # buffer, the download clock indexes the ring of post-merge snapshots;
    # both are the synchronous loop at d_max = 0
    clock = sim.get_clock(args.clock_model, seed=7)
    dl_clock = sim.get_download_clock(args.download_clock, seed=7)
    d_max = clock.d_max if clock is not None else 0
    h_max = (dl_clock.d_max + 1) if dl_clock is not None else 1
    ccfg = CollabConfig(mode="cors", num_classes=VOCAB, d_feature=d)
    init_pending, round_sync = launch_train.make_async_round_sync(ccfg, d_max)
    pending = init_pending(VOCAB, d, dev)
    hist = relay_history.init(prototypes.init_state(VOCAB, d, dev), h_max)

    writer = (obs.JsonlWriter(args.telemetry_out)
              if args.telemetry_out else None)
    global_state = prototypes.init_state(VOCAB, d, dev)
    late_total = stale_total = 0
    rng = np.random.default_rng(42)
    neg_gen = torch.Generator(device=dev).manual_seed(42)
    print(f"clients: tinyllama-reduced + xlstm-reduced, vocab={VOCAB}, "
          f"clock={args.clock_model}, download={args.download_clock}")
    print("round  ce[llama]  ce[xlstm]  comm_MB/round")
    for r in range(args.rounds):
        dl = (dl_clock.delays(r, n) if dl_clock is not None
              else np.zeros((n,), np.int64))
        round_stats = []
        ces = []
        for i, (c, corp) in enumerate(zip(clients, splits)):
            # each client trains against the snapshot its download clock
            # last synced: round r - dl[i]'s post-merge prototypes
            proto_means = prototypes.means(
                relay_history.read_at(hist, int(dl[i])))
            batches = list(synthetic.lm_batches(
                corp, BATCH, SEQ, STEPS_PER_ROUND,
                seed=int(rng.integers(0, 1 << 30))))
            ce, stats = local_round(c, batches, proto_means, 1.0, 0.1,
                                    neg_gen)
            ces.append(ce)
            round_stats.append(stats)
        # the only exchange: this round's due stats (fresh delay-0 ones
        # plus pending arrivals) merge into a fresh global state
        delays = (clock.delays(r, n) if clock is not None
                  else np.zeros((n,), np.int64))
        stacked = prototypes.ProtoState(
            torch.stack([s.sum for s in round_stats]),
            torch.stack([s.count for s in round_stats]))
        state = launch_train.TrainState(
            None, None, prototypes.init_state(VOCAB, d, dev),
            torch.zeros((), dtype=torch.int32, device=dev))
        state, pending = round_sync(state, pending,
                                    torch.as_tensor(delays, device=dev),
                                    stacked)
        prev_state, global_state = global_state, state.proto
        hist = relay_history.push(hist, global_state)
        late = int(np.sum(delays > 0))
        stale = int(np.sum(dl > 0))
        late_total += late
        stale_total += stale
        comm_floats = 2 * n * VOCAB * (d + 1)            # up+down, all clients
        comm_mb = comm_floats * 4 / 1e6
        print(f"{r + 1:4d}   {ces[0]:.4f}    {ces[1]:.4f}    {comm_mb:.3f}")
        if writer:
            writer.write({
                "round": r,
                "participants": list(range(n)),
                "ce": {c["cfg"].name: ce for c, ce in zip(clients, ces)},
                "late_commits": late, "stale_reads": stale,
                "comm_up": comm_floats / 2, "comm_down": comm_floats / 2,
                "proto_telemetry": launch_train.proto_round_telemetry(
                    prev_state, global_state),
            })
    if writer:
        writer.close()

    if late_total:
        print(f"async prototype relay: {late_total} client-round stat "
              f"uploads committed late (bounded-delay pending, see "
              f"src/repro_torch/launch/train.py)")
    if stale_total:
        print(f"download lag: {stale_total} client-rounds trained against "
              f"a stale prototype snapshot (history ring, see "
              f"src/repro_torch/relay/history.py)")
    if args.telemetry_out:
        print(f"telemetry: {args.telemetry_out} (render with "
              f"`python -m repro_torch.obs.report {args.telemetry_out}`)")
    print("\nheterogeneous-arch collaboration ran end-to-end; the exchanged "
          "state is (V, d'+1) floats per client per round, independent of "
          "either model's size.")


if __name__ == "__main__":
    main()
