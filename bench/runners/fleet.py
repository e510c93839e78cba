"""Runner of the fleet cells: the port's vectorized CoRS engine
(`core/vec_collab.VectorizedCollabTrainer`) on a fleet of LeNet5 clients,
rounds back to back (a closed loop: the next round starts when the last
one's record is on the host).

Set-up makes the weights, each client's samples and the shared test set on
the card from the seed (`benchlib/images.py`), hands them to the trainer,
and runs the check's first rounds through the trainer's own `run_round`:
they are the warm-up too. The window runs more rounds of the same
trainer. Work is counted in client training samples: clients x local
steps x batch a round.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from benchlib import check as chk, flops, images
from ref import lenet_cors

LEAVES = lenet_cors.LEAVES


class Runner:
    def __init__(self, cell, seed: int, dev: str):
        self.cell, self.seed, self.dev = cell, int(seed), dev
        self.cfg, self.traffic = cell.config, cell.traffic
        self.N = int(self.traffic["clients"])
        self.mode = self.traffic["mode"]
        self.span_path = None

    # ------------------------------------------------------------------
    def setup(self, trace: bool = False):
        from repro_torch import obs
        from repro_torch.collab_image_classification import CNN_SPEC
        from repro_torch.core.vec_collab import VectorizedCollabTrainer
        from repro_torch.types import CollabConfig, FleetConfig, TrainConfig

        cfg, N = self.cfg, self.N
        if self.dev == "cuda":
            # the configuration's precision: float32 products, TF32 as it says
            torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
            torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
        inp = images.fleet_inputs(self.seed, N, cfg, self.dev)
        w = inp["params"]
        params_list = [{k: w[k][i] for k in LEAVES} for i in range(N)]
        x, y = inp["x"].cpu(), inp["y"].cpu()
        client_data = [(x[i], y[i]) for i in range(N)]
        test = (inp["test_x"].cpu(), inp["test_y"].cpu())
        ccfg = CollabConfig(mode=self.mode, num_classes=cfg["num_classes"],
                            d_feature=cfg["d_feature"],
                            lambda_kd=cfg["lambda_kd"],
                            lambda_disc=cfg["lambda_disc"],
                            n_avg=cfg["n_avg"], m_up=cfg["m_up"],
                            m_down=cfg["m_down"])
        tcfg = TrainConfig(learning_rate=cfg["lr"], beta1=cfg["beta1"],
                           beta2=cfg["beta2"], eps=cfg["eps"],
                           batch_size=cfg["batch_size"],
                           local_epochs=cfg["local_epochs"])
        telemetry = None
        if trace:
            # the engine's own phase spans, written where the run may write
            fd, self.span_path = tempfile.mkstemp(suffix=".json",
                                                  prefix="bench_spans_")
            os.close(fd)
            telemetry = obs.TelemetryConfig(metrics=False,
                                            trace=self.span_path)
        self.trainer = VectorizedCollabTrainer(
            CNN_SPEC, params_list, client_data, test, ccfg, tcfg,
            seed=self.seed, fleet=FleetConfig(policy=self.traffic["relay"]),
            device=self.dev, telemetry=telemetry)
        del params_list, client_data, inp
        self.p0 = {k: v.detach().clone() for k, v in
                   self.trainer.params.items()}
        # the check's rounds, through the window's own call
        self.records = []
        for r in range(int(self.traffic["check_rounds"])):
            self.records.append(self.trainer.run_round())
            if r == 0:
                self.moment1 = _norms(self.trainer.opt_state.m)
        self.change = {k: float(torch.linalg.vector_norm(
            self.trainer.params[k] - self.p0[k])) for k in LEAVES}
        rs = self.trainer.relay_state
        self.ring = {"owner": rs.owner.cpu().numpy(),
                     "valid": rs.valid.cpu().numpy(),
                     "stamp": rs.stamp.cpu().numpy(),
                     "ptr": int(rs.ptr), "clock": int(rs.clock)}
        self.protos = rs.global_protos.cpu()
        del self.p0
        nb = cfg["samples_per_client"] // cfg["batch_size"]
        self.samples_per_round = N * nb * cfg["batch_size"]

    def step(self) -> float:
        self.trainer.run_round()
        return float(self.samples_per_round)

    def attempted(self, window) -> int:
        return window.steps

    def failed(self, window) -> int:
        return 0

    # ------------------------------------------------------------------
    def round_flops(self) -> float:
        cfg = self.cfg
        fwd = cfg["test_samples"] + (cfg["samples_per_client"]
                                     if self.mode == "cors" else 0)
        return flops.lenet_flops(cfg, self.samples_per_round,
                                 self.N * fwd)

    def end_to_end(self, window):
        return {"fleet_samples_per_s": window.work / window.seconds}

    def traced_stretch(self):
        for _ in range(int(self.traffic["trace_rounds"])):
            self.trainer.run_round()

    def facts(self, window):
        from repro_torch.kernels import ops
        cfg = self.cfg
        spans = []
        if self.span_path:
            with open(self.span_path) as f:
                ev = json.load(f)["traceEvents"]
            first = int(self.traffic["check_rounds"])
            spans = [e["dur"] * 1e-6 for e in ev if e["name"] == "round_step"
                     and e.get("args", {}).get("round", 0) >= first]
            os.unlink(self.span_path)
            self.span_path = None
        return {"rounds": int(self.traffic["trace_rounds"]),
                "round_step_s": spans,
                "kernel_symbols": dict(ops.KERNEL_SYMBOLS),
                "window_flops": self.round_flops() * window.steps,
                "peak_flops_dtype": cfg["compute_dtype"],
                "disc_shape": (self.N, cfg["batch_size"], cfg["num_classes"],
                               cfg["num_classes"]),
                "mode": self.mode}

    # ------------------------------------------------------------------
    def check(self):
        """The program's first rounds against the plain reference's from
        the same seed, once the program's state is freed."""
        prog = {"loss": [float(np.mean([m["total"] for m in r["metrics"]]))
                         for r in self.records],
                "acc": [r["acc_mean"] for r in self.records]}
        del self.trainer
        if self.dev == "cuda":
            torch.cuda.empty_cache()
        ref = reference(self.cell, self.seed, self.dev,
                        int(self.traffic["check_rounds"]))
        return compare(self.cell, prog, self.moment1, self.change, self.ring,
                       self.protos, ref)


def _norms(tree):
    return {k: float(torch.linalg.vector_norm(tree[k])) for k in LEAVES}


def reference(cell, seed, dev, rounds, prec="float32"):
    """The plain reference's first `rounds` rounds from the seed's
    inputs, with products at `prec`."""
    if dev == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    inp = images.fleet_inputs(seed, int(cell.traffic["clients"]),
                              cell.config, dev)
    with torch.no_grad():
        p0 = {k: v.clone() for k, v in inp["params"].items()}
    return lenet_cors.run_rounds(cell.config, cell.traffic, seed, p0, inp,
                                 rounds, prec)


def compare(cell, prog, moment1, change, ring, protos, ref) -> chk.Checks:
    c = chk.Checks(cell.limits)
    c.add("loss_gap", max(chk.rel_gap(a, b) for a, b in
                          zip(prog["loss"], ref["loss"])))
    c.add("moment1_gap", chk.worst_leaf_gap(moment1, ref["moment1_norms"]))
    c.add("change_gap", chk.worst_leaf_gap(
        change, ref["change_norms"], chk.moving(ref["moment1_norms"])))
    c.add("acc_gap", max(abs(a - b) for a, b in zip(prog["acc"], ref["acc"])))
    rr = ref["ring"]
    c.add("ring_mismatch", sum(int(np.sum(ring[k] != rr[k])) for k in rr))
    g = ref["global_protos"]
    c.add("proto_gap", torch.linalg.vector_norm(protos - g)
          / torch.linalg.vector_norm(g))
    return c


def control(cell, seed, dev, prec="tf32") -> chk.Checks:
    """The control: the reference in the program's place, its products at
    `prec`, held against the float32 reference by the cell's limits."""
    rounds = int(cell.traffic["check_rounds"])
    low = reference(cell, seed, dev, rounds, prec)
    ring = {k: low["ring"][k] for k in low["ring"]}
    prog = {"loss": low["loss"], "acc": low["acc"]}
    ref = reference(cell, seed, dev, rounds)
    return compare(cell, prog, low["moment1_norms"], low["change_norms"],
                   ring, low["global_protos"], ref)
