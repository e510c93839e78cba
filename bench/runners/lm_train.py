"""Runner of the LM training cells: the port's CoRS train step
(`launch/train.make_train_step`) on N clients of a decoder-only MoE LM,
steps back to back.

Set-up makes every client's weights on the card from the seed
(`benchlib/lm_weights.py`) in the configuration's dtype, builds the train
state around them (zero Adam moments, empty prototypes), and runs the
check's first steps through the step the window runs, on token rows drawn
from the seed: they are the warm-up too. Every step, in set-up and in the
window, draws new rows (tokens uniform over the vocabulary, labels the
next token) and new negative classes. Work is counted in training tokens:
clients x rows x sequence a step.
"""
from __future__ import annotations

import numpy as np
import torch

from benchlib import check as chk, flops, lm_weights
from ref import granite


def port_config(cfg):
    """The port's ModelConfig of the configuration: the port's registered
    architecture (its family and kinds of layer) with the file's shapes
    and settings put in, so that what runs is what the file states."""
    import dataclasses
    from repro_torch.configs import get_arch
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return dataclasses.replace(
        get_arch(cfg["port_arch"]), num_layers=cfg["num_hidden_layers"],
        block_pattern=("attn",) * cfg["num_hidden_layers"], d_model=d,
        num_heads=H, num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or d // H, v_head_dim=0, d_feature=0,
        d_ff=cfg["intermediate_size"], moe_d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"],
        num_experts=cfg["num_local_experts"],
        experts_per_token=cfg["num_experts_per_tok"], num_shared_experts=0,
        capacity_factor=cfg["capacity_factor"], rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"], dtype=cfg["torch_dtype"],
        tie_embeddings=cfg["tie_word_embeddings"],
        router_aux_weight=cfg["router_aux_loss_coef"])


def device_us_per_token(busy_s: float, steps: int, tokens_per_step: int):
    """Microseconds of device time a training token over `steps` steps."""
    return 1e6 * busy_s / (steps * tokens_per_step)


def data_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([int(seed), stream])
               .generate_state(1, np.uint64)[0] >> 1)


class Rows:
    """Token rows and negative classes drawn from the seed, step by step."""

    def __init__(self, seed, dev, N, B, S, V, K):
        self.gen = torch.Generator(device=dev).manual_seed(data_seed(seed, 1))
        self.dev, self.shape, self.V, self.K = dev, (N, B, S + 1), V, K

    def next(self):
        t = torch.randint(0, self.V, self.shape, generator=self.gen,
                          device=self.dev, dtype=torch.int32)
        neg = torch.randint(0, self.V, (self.shape[0], self.K),
                            generator=self.gen, device=self.dev)
        return {"tokens": t[..., :-1], "labels": t[..., 1:]}, neg


class Runner:
    def __init__(self, cell, seed: int, dev: str):
        self.cell, self.seed, self.dev = cell, int(seed), dev
        self.cfg, self.traffic = cell.config, cell.traffic
        self.tr = self.cfg["training"]
        self.N = int(self.traffic["clients"])
        self.B = int(self.traffic["rows_per_client"])
        self.S = int(self.traffic["seq_len"])

    def _rows(self):
        K = min(self.tr["num_negatives"], self.cfg["vocab_size"] - 1)
        return Rows(self.seed, self.dev, self.N, self.B, self.S,
                    self.cfg["vocab_size"], K)

    def setup(self, trace: bool = False):
        from repro_torch.core import prototypes
        from repro_torch.launch import train
        from repro_torch.optim import adam_init
        from repro_torch.types import CollabConfig

        cfg, tr, N = self.cfg, self.tr, self.N
        self.mcfg = port_config(cfg)
        params = lm_weights.make(cfg, self.seed, self.dev, clients=N)
        self.state = train.TrainState(
            params, adam_init(params, clients=N),
            prototypes.init_state(cfg["vocab_size"], cfg["hidden_size"],
                                  self.dev),
            torch.zeros((), dtype=torch.int32, device=self.dev))
        del params
        ccfg = CollabConfig(mode=self.traffic["mode"],
                            num_classes=cfg["vocab_size"],
                            d_feature=cfg["hidden_size"],
                            lambda_kd=tr["lambda_kd"],
                            lambda_disc=tr["lambda_disc"],
                            num_negatives=tr["num_negatives"])
        self.step_fn = train.make_train_step(
            self.mcfg, ccfg, n_clients=N, lr=tr["lr"],
            disc_tokens=tr["disc_tokens"], sync_in_step=True)
        self.rows = self._rows()
        self.losses = []
        for t in range(int(self.traffic["check_steps"])):
            self._step()
            self.losses.append(float(self.metrics["total"]))
            if t == 0:
                b1 = tr["beta1"]
                self.grad_norms = {
                    k: float(torch.linalg.vector_norm(m)) / (1 - b1)
                    for k, m in lm_weights.leaves(self.state.opt.m)}
        p0 = dict(lm_weights.leaves(lm_weights.make(cfg, self.seed, self.dev,
                                                    clients=N)))
        self.change = {k: float(torch.linalg.vector_norm(
            p.float() - p0[k].float()))
            for k, p in lm_weights.leaves(self.state.params)}
        del p0
        self.proto_sum = self.state.proto.sum.cpu()
        self.proto_count = self.state.proto.count.cpu()
        self.tokens_per_step = N * self.B * self.S

    def _step(self):
        batch, neg = self.rows.next()
        self.state, self.metrics = self.step_fn(self.state, batch, neg)

    def step(self) -> float:
        self._step()
        if self.dev == "cuda":
            torch.cuda.synchronize()
        return float(self.tokens_per_step)

    def attempted(self, window) -> int:
        return window.steps

    def failed(self, window) -> int:
        return 0

    def end_to_end(self, window):
        """The card's busy time a training token, over the traced steps
        that follow the window: the step is paced by the host's dispatch,
        whose speed differs between processes by more than a bound can
        hold, so the window's rate is read per layer
        (`tokens_per_s.train`). None without a card (the CPU tests)."""
        if self.dev != "cuda":
            return {"train_device_us_per_token": None}
        from benchlib.trace import capture
        tr = capture(self.traced_stretch)
        return {"train_device_us_per_token": device_us_per_token(
            tr.busy_s, int(self.traffic["trace_steps"]),
            self.tokens_per_step)}

    def traced_stretch(self):
        torch.cuda.reset_peak_memory_stats()
        for _ in range(int(self.traffic["trace_steps"])):
            self._step()
        torch.cuda.synchronize()
        self.peak_traced = torch.cuda.max_memory_allocated()

    def facts(self, window):
        from repro_torch.kernels import ops
        cfg = self.cfg
        return {"steps": int(self.traffic["trace_steps"]),
                "kernel_symbols": dict(ops.KERNEL_SYMBOLS),
                "window_flops": window.steps * flops.lm_train_flops(
                    cfg, self.N * self.B, self.S),
                "peak_flops_dtype": cfg["torch_dtype"],
                "proto_shape": (self.N, self.B * self.S, cfg["hidden_size"],
                                cfg["vocab_size"]),
                "peak_bytes": getattr(self, "peak_traced", None)}

    def check(self):
        del self.state, self.step_fn, self.metrics
        if self.dev == "cuda":
            torch.cuda.empty_cache()
        ref = reference(self.cell, self.seed, self.dev)
        return compare(self.cell, self.losses, self.grad_norms, self.change,
                       self.proto_sum, self.proto_count, ref)


def reference(cell, seed, dev, prec="float32"):
    """The plain reference's first steps from the seed's weights and rows,
    products at `prec`; -> its readings, the change norms taken."""
    if dev == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg, traffic = cell.config, cell.traffic
    N, steps = int(traffic["clients"]), int(traffic["check_steps"])
    K = min(cfg["training"]["num_negatives"], cfg["vocab_size"] - 1)
    rows = Rows(seed, dev, N, int(traffic["rows_per_client"]),
                int(traffic["seq_len"]), cfg["vocab_size"], K)
    drawn = [rows.next() for _ in range(steps)]
    params = lm_weights.make(cfg, seed, dev, clients=N)
    out = granite.train_steps(params, [b for b, _ in drawn],
                              [n for _, n in drawn], cfg, cfg["training"],
                              steps, prec)
    p0 = dict(lm_weights.leaves(lm_weights.make(cfg, seed, dev, clients=N)))
    out["change_norms"] = {k: float(torch.linalg.vector_norm(
        p.float() - p0[k].float())) for k, p in lm_weights.leaves(params)}
    del out["params"], params, p0
    out["proto_sum"] = out["proto_sum"].cpu()
    out["proto_count"] = out["proto_count"].cpu()
    return out


def compare(cell, losses, grad_norms, change, psum, pcnt, ref) -> chk.Checks:
    c = chk.Checks(cell.limits)
    c.add("loss_gap", max(chk.rel_gap(a, b) for a, b in
                          zip(losses, ref["loss"])))
    c.add("grad_gap", chk.worst_leaf_gap(grad_norms, ref["grad_norms"]))
    c.add("grad_gap_median", chk.median_leaf_gap(grad_norms,
                                                 ref["grad_norms"]))
    c.add("change_gap", chk.worst_leaf_gap(
        change, ref["change_norms"], chk.moving(ref["grad_norms"])))
    c.add("proto_count_mismatch", (pcnt != ref["proto_count"]).sum())
    c.add("proto_gap", torch.linalg.vector_norm(psum - ref["proto_sum"])
          / torch.linalg.vector_norm(ref["proto_sum"]))
    return c


def control(cell, seed, dev, prec="fp8") -> chk.Checks:
    """The reference in the program's place, products at `prec`, held
    against the float32 reference by the cell's limits."""
    low = reference(cell, seed, dev, prec)
    ref = reference(cell, seed, dev)
    return compare(cell, low["loss"], low["grad_norms"], low["change_norms"],
                   low["proto_sum"], low["proto_count"], ref)
