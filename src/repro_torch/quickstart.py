"""Quickstart of the port (the twin of examples/quickstart.py): two
collaborating LeNet clients (different random inits, private data shards)
trained with the paper's objective L_CE + lambda_KD L_KD + lambda_disc
L_disc, with per-round accuracy and the exact communication ledger.

  PYTHONPATH=src python -m repro_torch.quickstart [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.collab_image_classification import CNN_SPEC
from repro_torch.core import collab
from repro_torch.data import partition, synthetic
from repro_torch.models import cnn
from repro_torch.types import CollabConfig, TrainConfig


def build_trainer(device=None, seed: int = 0) -> collab.CollabTrainer:
    x, y = synthetic.class_images(600, seed=0, noise=0.6)
    tx, ty = synthetic.class_images(800, seed=9, noise=0.6)
    parts = partition.uniform_split(x, y, 2, seed=1)
    g = torch.Generator().manual_seed(seed)
    params = [cnn.init_cnn(g, device="cpu") for _ in range(2)]
    ccfg = CollabConfig(mode="cors", num_classes=10, d_feature=84,
                        lambda_kd=2.0, lambda_disc=1.0)
    return collab.CollabTrainer([CNN_SPEC] * 2, params, parts, (tx, ty),
                                ccfg, TrainConfig(batch_size=32), seed=seed,
                                device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    trainer = build_trainer(args.device)
    print("round  acc_mean  acc_std   L_CE    L_KD    L_disc   MI-bound")
    for _ in range(args.rounds):
        rec = trainer.run_round()
        m = rec["metrics"][0]
        print(f"{rec['round']:4d}   {rec['acc_mean']:.4f}   "
              f"{rec['acc_std']:.4f}  {m['ce']:.3f}  {m.get('kd', 0):.4f}  "
              f"{m.get('disc', 0):.3f}  {m.get('mi_bound', 0):+.3f} nats")
    mb = trainer.ledger.total_bytes / 1e6
    params = trainer.clients[0].params
    print(f"\ntotal communication: {mb:.2f} MB "
          f"(FedAvg would have used "
          f"{cnn.num_params(params) * 2 * args.rounds * 4 / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
