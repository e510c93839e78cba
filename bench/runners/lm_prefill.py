"""Runner of the LM prefill cells: the port's `serve_lm.serve` answering
batches of prompts with one greedy token each, offered at a fixed rate
(an open loop: batches are due on a schedule whether or not earlier ones
have finished, and wait in a queue in order of arrival).

The traffic file fixes the batch size, the prompt lengths (every length
of the range once in each cycle, shortest and longest in turn), the rate,
and so the whole schedule; the seed draws the prompts' tokens. A
request's time to first token runs from when its batch was due to when
its token is on the host, so it counts the wait in the queue. Every
batch due inside the window is served, also when it finishes after the
window's end. Set-up makes the weights on the card from the seed and
warms up every prompt length the traffic uses.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchlib import check as chk, flops, lm_weights, spec
from runners.lm_train import data_seed, port_config
from ref import granite


def lengths(traffic):
    return list(range(int(traffic["len_min"]), int(traffic["len_max"]) + 1,
                      int(traffic["len_step"])))


def schedule(traffic, n: int):
    """The first n batches' prompt lengths: cycles of every length once,
    shortest and longest in turn, the same for every seed, so that the
    queue's waits do not hang on the seed: the seed draws the prompts'
    tokens."""
    ls = lengths(traffic)
    cycle = [ls[j // 2] if j % 2 == 0 else ls[-1 - j // 2]
             for j in range(len(ls))]
    return [cycle[i % len(cycle)] for i in range(n)]


class Prompts:
    """Batch i's prompt tokens, drawn from the seed on the device."""

    def __init__(self, seed, dev, B, V):
        self.seed, self.dev, self.B, self.V = seed, dev, B, V

    def batch(self, i: int, L: int):
        g = torch.Generator(device=self.dev).manual_seed(
            data_seed(self.seed, 1000 + i))
        return torch.randint(0, self.V, (self.B, L), generator=g,
                             device=self.dev, dtype=torch.int32)


class Runner:
    def __init__(self, cell, seed: int, dev: str):
        self.cell, self.seed, self.dev = cell, int(seed), dev
        self.cfg, self.traffic = cell.config, cell.traffic
        self.B = int(self.traffic["batch"])
        self.rate = float(self.traffic["batches_per_s"])

    def setup(self, trace: bool = False):
        from repro_torch import serve_lm
        self.serve = serve_lm.serve
        self.mcfg = port_config(self.cfg)
        self.params = lm_weights.make(self.cfg, self.seed, self.dev)
        self.prompts = Prompts(self.seed, self.dev, self.B,
                               self.cfg["vocab_size"])
        for j, L in enumerate(lengths(self.traffic)):
            self._serve(self.prompts.batch(-1 - j, L))
        self.served = []

    def _serve(self, tokens):
        # a prefill: the prompt's one greedy token, no decode step
        out = self.serve(self.params, self.mcfg, {"tokens": tokens}, 0)
        return out["logits"][0].argmax(-1).cpu()

    def run_window(self, seconds: float):
        """Serves every batch due in [0, seconds) on the fixed-rate
        schedule; -> (batches, requests, seconds until the last answer)."""
        n = max(1, int(np.ceil(seconds * self.rate)))
        ls = schedule(self.traffic, n)
        t0 = time.perf_counter()
        for i, L in enumerate(ls):
            due = i / self.rate
            tokens = self.prompts.batch(i, L)
            wait = due - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
            first = self._serve(tokens)
            done = time.perf_counter() - t0
            self.served.append({"i": i, "L": L, "due": due, "done": done,
                                "tokens": first})
        return n, n * self.B, time.perf_counter() - t0

    def attempted(self, window) -> int:
        return window.work

    def failed(self, window) -> int:
        return int(window.work) - self.B * len(self.served)

    def ttft_s(self):
        return [s["done"] - s["due"] for s in self.served]

    def end_to_end(self, window):
        t = np.repeat(self.ttft_s(), self.B)
        return {"ttft_ms_p95": 1e3 * float(np.percentile(t, 95))}

    def traced_stretch(self):
        ls = lengths(self.traffic)
        k = int(self.traffic["trace_batches"])
        self.traced_lengths = [ls[j * (len(ls) - 1) // max(1, k - 1)]
                               for j in range(k)]
        for j, L in enumerate(self.traced_lengths):
            self._serve(self.prompts.batch(-100 - j, L))

    def facts(self, window):
        from repro_torch.kernels import ops
        cfg = self.cfg
        d, H, G, hd = lm_weights.dims(cfg)
        work = sum(flops.lm_prefill_flops(cfg, self.B, s["L"])
                   for s in self.served)
        return {"kernel_symbols": dict(ops.KERNEL_SYMBOLS),
                "window_flops": work, "peak_flops_dtype": cfg["torch_dtype"],
                "flash_calls": [(self.B, L, H, G, hd, hd)
                                for L in self.traced_lengths
                                for _ in range(cfg["num_hidden_layers"])],
                "flash_elem": 2 if cfg["torch_dtype"] == "bfloat16" else 4}

    def check(self):
        del self.params
        if self.dev == "cuda":
            torch.cuda.empty_cache()
        picks = sample(self.served, self.seed,
                       int(self.traffic["check_batches"]))
        return judge(self.cell, self.seed, self.dev,
                     [(s["i"], s["L"], s["tokens"]) for s in picks])


def sample(served, seed, k):
    """k served batches drawn from the seed, the longest prompt's always
    among them."""
    rng = np.random.default_rng(data_seed(seed, 3))
    longest = max(range(len(served)), key=lambda j: served[j]["L"])
    rest = [j for j in range(len(served)) if j != longest]
    pick = [longest] + rng.permutation(rest)[:max(0, k - 1)].tolist()
    return [served[j] for j in sorted(pick)]


def judge(cell, seed, dev, answers, params=None) -> chk.Checks:
    """The comparison that decides `correct`: for each (batch index,
    length, served tokens), how far below the float32 reference's best
    last-position logit each served token's logit lies; the widest gap
    against the cell's limit."""
    cfg, params, prompts = _reference_inputs(cell, seed, dev, params)
    gaps = []
    for i, L, tok in answers:
        z = granite.prefill_logits(params, prompts.batch(i, L), cfg)
        got = z.gather(1, tok.to(z.device).long()[:, None])[:, 0]
        gaps.extend((z.max(-1).values - got).tolist())
    c = chk.Checks(cell.limits)
    c.add("token_logit_gap", max(gaps))
    return c


def _reference_inputs(cell, seed, dev, params=None):
    if dev == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = cell.config
    if params is None:
        params = lm_weights.make(cfg, seed, dev)
    return cfg, params, Prompts(seed, dev, int(cell.traffic["batch"]),
                                cfg["vocab_size"])


def control(cell, seed, dev, prec="fp8") -> chk.Checks:
    """The reference at `prec` in the program's place: it answers the
    batches that the check samples from a window of the manifest's
    run_seconds at the cell's rate, with the greedy token of its own
    last-position logits, and its answers go through the program's
    comparison (`judge`)."""
    seconds = spec.load_manifest(cell.bench_dir.parent)["run_seconds"]
    n = max(1, int(np.ceil(seconds * float(cell.traffic["batches_per_s"]))))
    served = [{"i": i, "L": L}
              for i, L in enumerate(schedule(cell.traffic, n))]
    picks = sample(served, seed, int(cell.traffic["check_batches"]))
    cfg, params, prompts = _reference_inputs(cell, seed, dev)
    answers = [(s["i"], s["L"], granite.prefill_logits(
        params, prompts.batch(s["i"], s["L"]), cfg, prec).argmax(-1).cpu())
        for s in picks]
    return judge(cell, seed, dev, answers, params)
