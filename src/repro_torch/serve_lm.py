"""End-to-end serving of the port (the twin of examples/serve_lm.py):
prefill a batch of prompts, then decode greedily into a fixed-size cache.
Every attention prefill (GQA, MLA, zamba2's shared block, Whisper's
encoder, self- and cross-attention) runs in the flash kernel on the card,
and so does Whisper's cross-attention in decode.

  PYTHONPATH=src python -m repro_torch.serve_lm [--arch tinyllama-1.1b]
      [--reduced | --no-reduced] [--batch 4] [--prompt-len 32] [--tokens 16]
      [--seed 0] [--device cuda|cpu]

`--arch` takes every decoder-only token model of `configs.ARCHS`.
Qwen2-VL takes embeddings (its vision frontend is a stub), which a token
loop cannot feed back, and Whisper-small's prefill takes audio frames
beside its tokens: the command line raises for both, as the reference
example fails on them. `serve` takes Qwen2-VL's batch of
`serve_batch_specs` and a `next_batch` of new embeddings, and Whisper's
`{"tokens", "frames"}` batch of `serve_batch_specs` (frames (B, 1500, d)),
then feeds its greedy tokens back; only its self cache grows. `--reduced`
(the default) serves the 2-layer, d_model 256, vocabulary 512 variant, as
the reference example does; `--no-reduced` serves the full width. Weights
are random, drawn from `--seed`. A prompt length must be a multiple of the
SSD chunk (`ssm_chunk`) where it exceeds it, for mamba and mLSTM layers.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.configs import get_arch
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch import serve as serve_lib
from repro_torch.models import encdec, lm
from repro_torch.tree import leaves
from repro_torch.types import ShapeConfig

PROMPT_STRIDE = 100            # prompt i starts at token i * 100 of the stream


def _grow_caches(cfg, caches, extra: int):
    """Every attention cache's seq axis (the shared block's too) extended
    by `extra` empty slots; an encoder-decoder's self cache only."""
    if cfg.is_encoder_decoder:
        return encdec.pad_cache_for_decode(caches, extra)
    return lm.pad_cache_for_decode(cfg, caches, extra)


def check_token_model(cfg) -> None:
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: its prefill takes audio "
            f"frames beside the tokens; call repro_torch.serve_lm.serve with "
            f"a batch dict {{'tokens': (B, S), 'frames': (B, "
            f"{cfg.encoder_seq}, {cfg.d_model})}} as serve_batch_specs "
            f"shapes it")
    if cfg.input_kind != "tokens":
        raise ValueError(
            f"{cfg.name} takes {cfg.input_kind} input, not tokens: the "
            f"serving loop feeds generated tokens back; call "
            f"repro_torch.serve_lm.serve with the batch of serve_batch_specs "
            f"(embeddings and M-RoPE positions) and a next_batch of new "
            f"embeddings")


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


def greedy_tokens(step: int, logits):
    """The token loop's decode batch: each row's greedy next token."""
    return {"tokens": logits[:, -1].argmax(-1)[:, None]}


def serve(params, cfg, prompts, tokens: int, next_batch=greedy_tokens,
          mesh=None):
    """Prefill `prompts` and decode `tokens` steps into a cache of S + tokens
    slots (written at cache_index, attention masked to the slots written so
    far). `prompts` is (B, S) token ids, or a batch dict as
    `serve_batch_specs` shapes it (an embeddings model's embeddings and
    M-RoPE positions; an encoder-decoder's tokens and frames). Step i
    decodes `next_batch(i, logits)`, `logits` the last step's: by default
    the greedy tokens fed back. With a `mesh` (a `DeviceMesh`; `params`
    placed on it, `sharding.place` by `launch.serve.params_shardings`), each
    step's batch and the grown caches are placed by the serve shardings,
    and the ids and logits come back whole.

    -> dict(ids (B, tokens) int64 on the CPU: the tokens decoded, none for
    embeddings batches; logits (tokens + 1, B, V) float32: the prefill's
    last-position logits, then each decode step's; prefill_s, decode_s:
    host seconds, each ending in a device synchronise)."""
    dev = leaves(params)[0].device
    if isinstance(prompts, dict):
        batch = prompts
    else:
        check_token_model(cfg)
        batch = {"tokens": torch.as_tensor(np.asarray(prompts), device=dev)}
    prefill = serve_lib.make_prefill_step(cfg)
    decode = serve_lib.make_decode_step(cfg)
    B, S = batch["tokens" if "tokens" in batch else "embeddings"].shape[:2]

    def put(tree, specs):
        return tree if mesh is None else sharding.place(tree, specs, mesh,
                                                        src_data_rank=None)

    def bspec(b):
        return None if mesh is None else serve_lib.batch_shardings(b, mesh)

    t0 = time.perf_counter()
    out = prefill(params, put(batch, bspec(batch)))
    caches = _grow_caches(cfg, out["caches"], tokens)
    if mesh is not None:
        shape = ShapeConfig("serve", S + tokens, B, "decode")
        caches = put(caches, serve_lib.cache_shardings(caches, cfg, mesh,
                                                       shape))
    logits = out["logits"]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    all_logits, generated = [logits[:, -1].float()], []
    t0 = time.perf_counter()
    for i in range(tokens):
        step = next_batch(i, logits)
        if "tokens" in step:
            generated.append(step["tokens"][:, 0])
        out = decode(params, put(step, bspec(step)), caches,
                     cache_index=S + i, masked=True)
        logits, caches = out["logits"], out["caches"]
        all_logits.append(logits[:, -1].float())
    _sync(dev)
    t_decode = time.perf_counter() - t0
    ids = (torch.stack(generated, 1) if generated
           else torch.zeros(B, 0, dtype=torch.long, device=dev))
    return {"ids": sharding.full(ids).cpu(),
            "logits": sharding.full(torch.stack(all_logits)),
            "caches": caches,
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

    cfg = get_arch(args.arch)
    check_token_model(cfg)
    dev = resolve_device(args.device)
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
