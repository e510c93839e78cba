"""End-to-end serving of the port (the twin of examples/serve_lm.py):
prefill a batch of prompts, then decode greedily into a fixed-size KV cache.
Every layer's prefill attention runs in the flash kernel on the card.

  PYTHONPATH=src python -m repro_torch.serve_lm [--arch tinyllama-1.1b]
      [--reduced | --no-reduced] [--batch 4] [--prompt-len 32] [--tokens 16]
      [--seed 0] [--device cuda|cpu]

`--reduced` (the default) serves the 2-layer, d_model 256, vocabulary 512
variant, as the reference example does; `--no-reduced` serves the full
width. Weights are random, drawn from `--seed`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch import serve as serve_lib
from repro_torch.models import lm

PROMPT_STRIDE = 100            # prompt i starts at token i * 100 of the stream


# the reference example's name for extending every cache's seq axis
_grow_caches = lm.pad_cache_for_decode


def make_prompts(cfg, batch: int, prompt_len: int) -> np.ndarray:
    """(batch, prompt_len) int32 prompts from `token_stream(seed=1)`, prompt
    i starting at token 100 i, as the reference example cuts them."""
    n = max(10_000, (batch - 1) * PROMPT_STRIDE + prompt_len)
    stream = synthetic.token_stream(n, vocab=cfg.vocab_size, seed=1)
    return np.stack([stream[i * PROMPT_STRIDE:i * PROMPT_STRIDE + prompt_len]
                     for i in range(batch)])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(params, cfg, prompts, tokens: int):
    """Prefill `prompts` (B, S) and decode `tokens` greedy steps into a
    cache of S + tokens slots (written at cache_index, attention masked to
    the slots written so far).

    -> dict(ids (B, tokens) int64 on the CPU: the generated tokens;
    logits (tokens + 1, B, V) float32: the prefill's last-position logits,
    then each decode step's; prefill_s, decode_s: host seconds, each ending
    in a device synchronise)."""
    dev = params["final_norm"]["scale"].device
    prefill = serve_lib.make_prefill_step(cfg)
    decode = serve_lib.make_decode_step(cfg)
    toks = torch.as_tensor(np.asarray(prompts), device=dev)
    S = toks.shape[1]

    t0 = time.perf_counter()
    out = prefill(params, {"tokens": toks})
    caches = _grow_caches(cfg, out["caches"], tokens)
    logits = out["logits"]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    all_logits, generated = [logits[:, -1].float()], []
    t0 = time.perf_counter()
    for i in range(tokens):
        nxt = logits[:, -1].argmax(-1)[:, None]
        generated.append(nxt[:, 0])
        out = decode(params, {"tokens": nxt}, caches, cache_index=S + i,
                     masked=True)
        logits, caches = out["logits"], out["caches"]
        all_logits.append(logits[:, -1].float())
    _sync(dev)
    t_decode = time.perf_counter() - t0
    ids = (torch.stack(generated, 1) if generated
           else torch.zeros(toks.shape[0], 0, dtype=torch.long, device=dev))
    return {"ids": ids.cpu(), "logits": torch.stack(all_logits),
            "prefill_s": t_prefill, "decode_s": t_decode}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_layers=2, d_model=256, vocab_size=512)
    print(f"serving {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size} {cfg.dtype} on {dev}")
    params = lm.init_lm(torch.Generator(device=dev).manual_seed(args.seed),
                        cfg, device=dev)
    prompts = make_prompts(cfg, args.batch, args.prompt_len)
    with torch.inference_mode():
        r = serve(params, cfg, prompts, args.tokens)
    print(f"prefill: {args.batch}x{args.prompt_len} tokens in "
          f"{r['prefill_s'] * 1e3:.1f} ms")
    print(f"decode : {args.tokens} steps x batch {args.batch} in "
          f"{r['decode_s'] * 1e3:.1f} ms "
          f"({args.tokens * args.batch / r['decode_s']:.1f} tok/s)")
    print("sample continuation ids:", r["ids"][0][:12].numpy())


if __name__ == "__main__":
    main()
