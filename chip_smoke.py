#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (`src/repro_torch/`).

  python3 chip_smoke.py        # from the repository root, on a CUDA machine

Phases (each failure raises, so the process exits non-zero):
  1. device: a CUDA device must be present; prints its name and power limit;
  2. build: compiles the hand-written kernels (`kernels/csrc/*.cu`) and
     prints the registers, shared memory and spills of the twenty
     tensor-core flash_attention kernels, ten bf16 and ten float32 split
     TF32 (hd 32, 64, 128 and MLA's 192/128 and 96/64, causal and full),
     each within a block's shared memory, none spilling;
  3. precision: TF32 off for cuDNN convolutions and matmuls;
  4. kernels: each kernel against its plain PyTorch version on the card at
     the main paths' shapes and larger ones (flash_attention also at MLA's
     split head dims, 192/128 and 96/64 at phase 11's shapes, ragged and
     over several tiles, and 80/64, in both dtypes, each row's device kernel
     named by the profiler in phase 6, in bf16 at phase 11's GQA
     prefill shapes, and at phase 12's four Whisper shapes in bf16 and
     float32, Sq != Sk for cross-attention; proto_accum also at phase
     13's Whisper shape, (2, 896, 768, 51865)), with times, the bound from
     bytes and operations, and a library call's time where one PyTorch call
     computes the same function; each float32 flash row also prints the
     3xTF32 bound (3 x its operations at TF32's rate, the split kernel's
     floor) and its key splits, more than one required at Whisper's cross
     attention and decode;
  5. slice: 3 synchronous CoRS rounds of 5 LeNet clients (the example's data
     sizes) in the sequential engine on the card, with the kernels' launch
     counts asserted, then the same 3 rounds on the CPU: ring state and
     ledger equal, accuracies close;
  5b. vec: the same 3 rounds in the vectorized engine (one batched round
     step for all clients, every round step under CUDA sync-debug mode
     "error", so a host sync inside it fails), with the batched kernels'
     launch counts asserted (21 / 21 / 3), ring and ledger equal to the
     sequential engine's on the card, accuracies within 2e-2; s/round of
     both engines;
  5c. baselines: 3 rounds at N = 5 (cl: N = 1, all the data) in both
     engines on the card, and in the sequential engine on the CPU, of each
     of fd (flat relay), fedavg, cl, cors under the per_class relay and
     cors under staleness:0.5: the kernels' launch counts asserted exactly
     for each path, every vec round step under sync-debug mode "error",
     vec's ring integers (and ages) and ledger equal to seq's on the card
     and seq's on the card equal to the CPU's, accuracies within 2e-2, fd's
     mean logits finite and within 1e-3 across engines; s/round of every
     path in both engines;
  5d. participation: 3 cors rounds at N = 5 under each of uniform_k:3,
     cyclic:2 (both compacted in vec), bernoulli:0.5 and adaptive:0.5 (full
     width, masked), and a mixed fleet of N = 6 (LeNet on even ids, the MLP
     on odd ids: two buckets in vec) in cors (full) and fd (uniform_k:3),
     in both engines on the card and seq on the CPU: launches exact by the
     formulas at PARTICIPATION_PATHS, every vec step (the round step, or
     each bucket's step and the shared commit) under sync-debug mode
     "error", participants, ring integers (and ages) and ledger equal vec =
     seq on the card = seq on the CPU, accuracies within 2e-2; s/round;
     then at N = 32 (240 samples a client) cyclic:8 compacted against the
     same schedule run full width (masked) and against full participation:
     3 rounds each (launches exact, no host sync, ring and ledger of the two
     cyclic runs equal), s/round, and one profiled round each (device ops,
     busy time and share);
  5e. asynchrony: 3 rounds at N = 5 (a mixed fleet: 6) of each of
     ASYNC_PATHS, uploads committed late by an upload clock (cors under
     flat / lognormal:2, per_class / periodic:2,3, staleness:0.5 /
     homogeneous:1; fd / lognormal:2 under uniform_k:3, vec full width),
     stale downloads by a download clock (cors / periodic:2,3 under
     uniform_k:3, vec compacted), both (staleness:0.5, lognormal:2 twice;
     the mixed fleet, homogeneous:1 twice), in both engines on the card and
     seq on the CPU: at least one delayed commit or stale read on each,
     launches exact, every vec step under sync-debug mode "error",
     participants, commits, uploads in flight (seq's queue, vec's live
     pending slots), ring integers (and ages), the history ring at every
     depth and the ledger equal vec = seq on the card = seq on the CPU,
     accuracies within 2e-2; s/round; then at N = 32 cors under
     lognormal:2 against the same fleet synchronous in vec: 9 rounds of
     each in turns (launches exact, no host sync), s/round and the pairs
     the asynchronous round lost, one profiled round each;
  5f. population scale: each of SHARD_PATHS (cors on sharded:flat,1,
     sharded:flat,4, sharded:per_class,4 and sharded:staleness,4 under
     uniform_k:3 (vec compacted); fd on sharded:flat,2; sharded:flat,4
     under an upload clock lognormal:2 and under a download clock
     periodic:2,3; a streaming fleet of 5 seats on sharded:flat,2, 8
     rounds) in both engines on the card and seq on the CPU: launches
     exact, every vec step and eviction under sync-debug mode "error",
     participants, commits, uploads in flight, cohort views, ring integers
     with per-shard clocks and ages, merges, the history ring and the
     ledger equal vec = seq on the card = seq on the CPU, accuracies
     within 2e-2, a delayed commit, a stale read, evictions and dropped
     arrivals where asked; sharded:flat,1 against flat in vec, every ring
     leaf and weight bit-equal; sharded:flat,4 against flat in vec, 9
     rounds each in turns and one profiled round each (s/round, device
     ops, busy time); then 32 seats of stream:8,8.0,0.3,1000000,0
     on sharded:flat,4, 12 rounds in vec and seq on the card: evictions,
     records, ring and ledger equal, the resident bytes (relay state and
     cohort table) equal to the figure from shards, capacity and seats,
     one profiled round against phase 5e's synchronous N = 32 fleet, the
     median s/round;
  5g. telemetry and I/O: each of TELEMETRY_PATHS (cors at N = 5 on flat
     synchronous, under an upload clock lognormal:2, a download clock
     periodic:2,3, uniform_k:3 compacted, on sharded:flat,4; the mixed
     LeNet/MLP fleet of 6 under lognormal:2; 5 seats of
     stream:2,1.5,0.3,7,0 on sharded:flat,2 for 8 rounds) with telemetry, a
     JSONL sink and a trace, in both engines on the card and seq on the
     CPU, with the 5e/5f checks plus: the telemetry's integer leaves equal
     vec = seq on the card = seq on the CPU and its float leaves within
     2e-2, its late commits and stale reads those of the records, each
     JSONL equal to its trainer's history and rendered by obs.report, each
     trace holding its engine's spans, every client of the vec trainer
     checkpointed and loaded back bit-equal on the card, and (first path)
     a round of each engine under torch.profiler holding the spans as
     record_function ranges; then vec with telemetry on against off at
     N = 5 and N = 32, TELEMETRY_PAIRS rounds each in turns (launches
     exact, no host sync): median s/round, and one profiled round each
     (device ops, busy time), the N = 5 telemetry-off ops equal to phase
     6's vec count;
  6. profile: one more round of each engine under torch.profiler (device
     busy share, device ops, time by kernel), then one call at each of
     phase 4's MLA rows and float32 Whisper cross-attention rows under the
     profiler: at 192/128 and 96/64 bf16 must launch the bf16 tensor-core
     kernel once and float32 the split-TF32 one (also under a key split),
     80/64 the CUDA-core one (after phase 5's timings, which a profiler
     session would slow); then 2 rounds
     of each engine
     at N = 32 LeNet clients of 240 samples: the vec-over-seq ratio of
     s/round at N = 5 and N = 32;
  5h. the fleet on a client mesh (after phase 6, so that its profiles do
     not slow the earlier timings): 5h-a one rank over NCCL on the card,
     each MESH_PATHS fleet (the reference's mesh compositions at N = 8 on
     the MLP) for 3 rounds with the mesh and without, every device step
     under sync-debug "error": records, relay state, history, pending
     buffer and weights bit-equal, launches exact, one exchange a round;
     then the N = 32 LeNet fleet with and without the mesh in turns
     (bit-equal, s/round, one profiled round each), the sequential
     engine on it (the vec-against-seq spread), the unsharded LeNet fleet
     with cuDNN off, and the grouped-convolution check (clients 0-7's
     LeNet features and gradients within the 32-client stack against an
     8-client stack, cuDNN on and off); 5h-b four gloo ranks sharing the
     card (`ranks.spawn`): N = 6 refused, each MESH_PATHS fleet and the
     LeNet fleet with cuDNN on and off, every rank's records equal to the
     others' and held against 5h-a's unsharded runs (integers exactly,
     the floats of the MLP fleets and of LeNet with cuDNN off at
     tests/test_torch_vec_collab.py's MLP bounds, those of LeNet on cuDNN
     within MESH_SPREAD times its vec-against-seq spread), each rank's
     launches for its own stacks, one exchange a round, s/round printed
     as a correctness run;
  7. serve: full-width TinyLlama-1.1B (22 layers, bf16, random weights from
     seed 0) prefills 4 prompts of 1024 tokens and decodes 32 greedy tokens
     through `repro_torch.serve_lm.serve`; 22 flash_attention launches
     asserted, logits finite;
  8. serve check: the same width in float32 with 256-token prompts: prefill
     logits of the kernel path against the plain attention, and one decode
     step after a prefill of S-1 tokens against the prefill of S;
  9. serve profile: one prefill and 4 decode steps under torch.profiler
     (device busy share, flash_attention's device time per launch and its
     share of the prefill's device time);
  10. train (`repro_torch.launch.train`): 10a, the reduced float32
     TinyLlama, xLSTM, Whisper, Granite, Zamba2, MiniCPM3 and
     DeepSeek-V2-Lite, 3 cors steps of 2 clients and a round sync over
     stats from prototypes.accumulate, on the card and on the CPU from the
     same weights, batches and negative ids (metrics, parameters, Adam
     moments, ProtoState and steps within PARITY_* of each other); 10b,
     TinyLlama-1.1B at its published widths (bf16, random weights from
     seed 0), 2 clients x batch 2 x 2048 tokens, cors, L_disc on 4096
     tokens, the merge in every step, 3 steps: metrics finite, the
     parameters moved, proto counts 3 x 8192, exactly one proto_accum
     launch a step (the client axis, (2, 4096, 2048, 32000)) and no
     flash_attention launch (training attends with the plain functions),
     peak memory under 70 GB; s/step, tokens/s, model FLOPs against bf16
     peak, and one profiled step (busy share, device ops, top kernels,
     proto_accum's device time); 10c, the collab_lm twin on the card for
     2 rounds under lognormal:2 uploads and periodic:2,3 downloads, its
     JSONL rendered;
  11. families: every other decoder-only arch at its published widths in
     bf16 (random weights from seed 0; DeepSeek-67B cut to 16 of its 95
     layers to fit the card): granite-moe-1b-a400m, deepseek-v2-lite-16b,
     minicpm3-4b, chatglm3-6b, qwen2-vl-7b (embeddings and M-RoPE
     positions from `serve_batch_specs`; `serve_lm.serve` decodes seeded
     random embeddings for it, as it cannot feed its tokens back), zamba2-1.2b,
     xlstm-125m and deepseek-67b, one after another, each freed before
     the next: 4 prompts of 256 tokens, 8 greedy tokens, after a warm-up;
     flash launches asserted (24 / 27 / 62 / 28 / 28 / 6 / 0 / 16, MLA's
     at its split head dims), every one in the profiled prefill the
     tensor-core kernel by the profiler's names, logits finite, ids (4, 8)
     for the token models; parameters, set-up s, prefill ms, decode ms a
     step, peak memory, and one profiled prefill (flash's share of its
     device time);
     then each family in float32 at full width and its least depth (2
     layers, 6 for zamba2), MoE at a capacity factor of num_experts: the
     kernel path against plain attention and decode against prefill within
     CHECK_TOL x max(1, |logit|), attention in bf16 failing it where the
     family has attention;
  12. whisper: Whisper-small at its published widths (12 + 12 layers, d
     768, vocabulary 51865, bf16, random weights from seed 0) serves 4
     clips of 1,500 seeded random frames (the stubbed audio frontend)
     with 32-token prompts and decodes 64 greedy tokens through
     `serve_lm.serve`: exactly 36 flash launches a prefill (12 encoder,
     12 self, 12 cross) and 12 a decode step (cross-attention at Sq = 1),
     logits finite, ids (4, 64); prefill ms, decode ms a step, peak
     memory, one profiled prefill and 4 decode steps (flash's share of the
     device time, busy share, device ops); then float32 at published
     widths and 2 + 2 layers: the kernel path against plain attention and
     decode against prefill within CHECK_TOL x max(1, |logit|), bf16
     attention failing it;
  13. train kinds: Whisper-small at full width (2 clients x 2 clips x 448
     tokens over 1,500 frames, cors, 3 steps) and, at published widths on
     2 clients x 1 x 2048 tokens for 2 steps, Granite-MoE-1B (MoE),
     Zamba2-1.2B (mamba2 and the shared block), MiniCPM3-4B (MLA) and
     DeepSeek-V2-Lite (MLA with MoE), each cut in depth only as far as the
     70 GB gate forces (FAMILY_TRAIN; the cut printed, and one step one
     layer shallower must put one layer deeper within LM_MEM_MARGIN of
     the gate): metrics finite,
     parameters moved, proto counts, exactly one proto_accum launch a
     step with the client axis and no flash launch, peak under 70 GB,
     MoE's balance loss finite; s/step, tokens/s, and one profiled step
     (busy share, device ops, proto_accum's device time). Phase 10a holds
     Whisper and the four kinds, reduced, on the card against the CPU;
  14. the LM launch path on a mesh (`launch/mesh.py`, `sharding.py`'s LM
     half, the serve and train shardings on DTensor): 14a, one NCCL rank,
     mesh (1, 1) over ("data", "model"), TinyLlama-1.1B at full width
     and 4 of 22 layers:
     phase 7's serving and phase 10b's training (2 steps of each of "tp",
     "dp_only" and "zero1") on trees placed by the shardings, bit-equal to
     the unsharded path (logits, tokens, caches; parameters, moments,
     ProtoState, metrics), one flash launch a layer a prefill and one
     proto_accum launch a step (`ops` runs DTensors through `local_map`),
     prefill ms, decode ms a step and s/step beside the unsharded ones;
     14b, four gloo ranks sharing the card (DTensor's functional
     collectives staged through host memory, `ranks.
     stage_functional_collectives`), mesh (2, 2), full width and 2 of 22
     layers in float32: serving and one train step of each strategy
     against the unsharded runs on the card, within MESH_LM_* (a bf16
     prefill's difference reported only);
  15. the LM train step with its clients split over "pod" (each rank
     trains only its own; the prototype merge, or fedavg's parameter
     mean, is the only exchange across pods), gloo ranks sharing the card,
     every collective counted by mesh axis: 15a, two ranks, mesh (2, 1,
     1), phase 10b's TinyLlama-1.1B run, a client a rank: 2 cors steps
     bit-equal to 10b's (by a digest of every leaf), one proto_accum
     launch a rank a step, C (d'+1) 4 bytes over pod a step, then a step
     without the merge and `make_round_sync` on client-sharded stats; s/step
     and each rank's peak; 15b, four ranks, mesh (2, 1, 2), full width and
     2 of 22 layers in float32: cors, fd, fedavg, il, zero1 and an absent
     client against the unsharded steps by phase 14b's bounds, the three
     round syncs bit-equal by digest, each mode's exact payload over pod;
  16. every other LM family on a mesh (MLA's latent cache, mamba2 and
     zamba2's shared block, the xLSTM's recurrences, ChatGLM3, Qwen2-VL,
     DeepSeek-67B, Whisper's cross caches): 16a, one NCCL rank, mesh (1,
     1), each family at published widths in bf16 and the least depth that
     holds its block kinds (MESH_FAMILIES): `serve_lm.serve` of 4 x 256
     prompts and 8 tokens (Whisper: 4 clips, 32-token prompts) and one
     cors step of 2 clients under "tp", bit-equal to the unsharded path
     (logits, ids, cache digests; every leaf's digest, metrics), flash
     launches one an attention layer a prefill (and Whisper's 12 a decode
     step), one proto_accum launch a step; prefill ms, decode ms a step,
     s/step beside unsharded; 16b, four gloo ranks sharing the card, mesh
     (2, 2), every family reduced in float32: serving and client 0's
     gradients and one "tp" step against the unsharded runs on the card
     by 14b's bounds, launches a rank exact; then Granite (MESH_EP_ARCH)
     once more under the expert-parallel hint ("moe_ep"): each rank holds
     2 of the 4 experts of every `_e` leaf, the same checks;
  17. sliding-window prefill through the windowed flash kernel: 17a both
     tensor-core kernels (bf16, and float32 in split TF32) against the
     plain version at WINDOW_SHAPE (TinyLlama's heads, 4096 tokens) with
     windows 1, 63, 64 and 1000, at MLA's split dims and one non-causal
     window, by phase 4's limits; a window of S or more bit-equal to none,
     a window of 1 returning v's rows (bf16 bit for bit, float32 within
     FLASH_F32_TOL: 22 bits of split TF32 cannot hold all 24); kernel, plain
     and SDPA-with-a-band-mask times at (1, 4096, 32, 4, 64) window 1000;
     17b TinyLlama-1.1B's windowed prefill (1 x 4096 tokens, window 1024)
     through the kernel against plain attention (`prefill_attention`),
     bf16 at full depth within WINDOW_BF16_TOL x max(1, |logit|) and below
     the window's own effect, float32 at 2 layers within CHECK_TOL; 17c
     the timed run at 32768 tokens and window 8192 (`swa_window`): the
     windowed kernel's first and last WINDOW_ROWS rows against plain
     attention over every key, its ms a launch beside the unwindowed
     kernel's, its bound (S W - W^2 / 2 pairs a head) and SDPA with a band
     mask, then the prefill with and without the window in turns, 22
     flash launches a prefill asserted, peak memory; 17d the float32
     2-layer windowed prefill on a (1, 1) NCCL mesh, bit-equal to
     unsharded.
Each stretch of phases prints its wall seconds as it ends (`[time]`
lines; the 1,200 s limit is the whole run's).
Phase 5h-a also runs the MLP stack check (clients 0-1's features and
gradients within the 8-client MLP stack against a 2-client stack, and the
first layer's batched GEMM at batch 8 against batch 2). Phases 10b and 13
print each peak beside `launch/roofline.memory_floor_bytes`.
Phase 4 also holds three faulty flash results at the serving shape and at
DeepSeek-V2-Lite's split shape against the bf16 check, which must reject
each: a bf16 accumulator, the last 16 keys dropped, and P rounded to bf16
once before P V.
Phase 4 also runs every disc_loss and proto_accum shape twice and requires
equal bits (proto_accum also at 10b's shape, (2, 4096, 2048, 32000)), and
runs the kernels with a leading client axis (the vectorized engine's
shapes), whose results must be bit-equal to one launch a client,
also on a (k, ...) block gathered by `index_select` from an N-client stack
(static-k compaction's shapes: k = 3 of 5, 8 of 32); phase 6 requires one
kernel symbol a wrapper call.
It prints a JSON line of per-kernel results (with share_of_bound, bound_ms
over ms, device_us_per_launch from the profiles, and launches_by_path from
phases 5c, 5d, 5e, 5f, 5g, 10b, 11, 12, 13, 14, 15, 16 and 17; flash's
"window" entry holds phase 17's numbers) before the last line,
and as the last line {"ok": true, ...}.
"""
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MEM_BPS = 3.35e12          # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM bf16 dense tensor cores
SMEM_PER_BLOCK = 232448    # H100: dynamic shared memory a block may use
TOL = 1e-5                 # max |kernel - plain| <= TOL * max(1, max |plain|)
ROUNDS, CLIENTS = 3, 5
STEPS = 7                  # 240 samples a client / batch 32, remainder dropped
# Phase 5c's paths: (name, mode, relay policy, clients) and the launches
# (disc_loss fwd, bwd, proto_accum) over ROUNDS rounds, seq then vec: fd
# accumulates features and logits (two proto_accum launches an upload);
# fedavg and cl run no kernel.
CORS_LAUNCHES = ((CLIENTS * STEPS * ROUNDS,) * 2 + (CLIENTS * ROUNDS,),
                 (STEPS * ROUNDS,) * 2 + (ROUNDS,))
PATHS = (("fd", "fd", "flat", CLIENTS,
          ((0, 0, 2 * CLIENTS * ROUNDS), (0, 0, 2 * ROUNDS))),
         ("fedavg", "fedavg", "flat", CLIENTS, ((0, 0, 0), (0, 0, 0))),
         ("cl", "cl", "flat", 1, ((0, 0, 0), (0, 0, 0))),
         ("cors per_class", "cors", "per_class", CLIENTS, CORS_LAUNCHES),
         ("cors staleness:0.5", "cors", "staleness:0.5", CLIENTS,
          CORS_LAUNCHES))
# Phase 5d's paths: (name, mode, schedule, clients, hetero, the vec engine's
# compaction width _k_active, its launches). nb batches a client a round
# (240 samples at N = 5: 7; 200 at N = 6: 6): seq launches disc_loss nb x
# the round's participants forward and backward and proto_accum once a
# participant (twice in fd), counted from the records; vec launches once a
# local step and once a round for the whole stack, compacted or not (a
# zero-participant round still runs the step), and in a mixed fleet once
# a bucket.
MIX_STEPS = 6
PARTICIPATION_PATHS = (
    ("cors uniform_k:3", "cors", "uniform_k:3", CLIENTS, False, 3,
     (STEPS * ROUNDS,) * 2 + (ROUNDS,)),
    ("cors cyclic:2", "cors", "cyclic:2", CLIENTS, False, 2,
     (STEPS * ROUNDS,) * 2 + (ROUNDS,)),
    ("cors bernoulli:0.5", "cors", "bernoulli:0.5", CLIENTS, False, CLIENTS,
     (STEPS * ROUNDS,) * 2 + (ROUNDS,)),
    ("cors adaptive:0.5", "cors", "adaptive:0.5", CLIENTS, False, CLIENTS,
     (STEPS * ROUNDS,) * 2 + (ROUNDS,)),
    ("cors mixed", "cors", "full", 6, True, None,
     (2 * MIX_STEPS * ROUNDS,) * 2 + (2 * ROUNDS,)),
    ("fd mixed uniform_k:3", "fd", "uniform_k:3", 6, True, None,
     (0, 0, 4 * ROUNDS)))
COMPACT_K = 8              # cyclic:8 at SCALE_CLIENTS = 32: k/N = 1/4
CORS_VEC = (STEPS * ROUNDS,) * 2 + (ROUNDS,)


class FleetPath(NamedTuple):
    """A path of phases 5e and 5f: name, mode, relay policy; schedule,
    upload clock, download clock and arrival spec (None: none); clients, a
    mixed fleet, rounds; the vec engine's _k_active (None: bucketed) and
    its launches (disc_loss fwd, bwd, proto_accum) over the rounds. seq
    launches 7 a present client a round each way and one proto_accum a
    present client (two in fd), a delayed upload's in its birth round."""
    name: str
    mode: str
    policy: str
    sched: Optional[str] = None
    clock: Optional[str] = None
    dl: Optional[str] = None
    arrivals: Optional[str] = None
    n: int = CLIENTS
    hetero: bool = False
    rounds: int = ROUNDS
    k_active: Optional[int] = CLIENTS
    want_vec: Tuple[int, int, int] = CORS_VEC


# Phase 5e: an asynchronous fleet runs vec full width (its commits are not
# the participants' uploads); download lag alone keeps compaction.
ASYNC_PAIRS = 9            # N = 32: rounds of each fleet, taken in turns
ASYNC_PATHS = (
    FleetPath("cors flat lognormal:2", "cors", "flat", clock="lognormal:2"),
    FleetPath("cors per_class periodic:2,3", "cors", "per_class",
              clock="periodic:2,3"),
    FleetPath("cors staleness:0.5 homogeneous:1", "cors", "staleness:0.5",
              clock="homogeneous:1"),
    FleetPath("fd flat lognormal:2 uniform_k:3", "fd", "flat", "uniform_k:3",
              "lognormal:2", want_vec=(0, 0, 2 * ROUNDS)),
    FleetPath("cors flat lag periodic:2,3 uniform_k:3", "cors", "flat",
              "uniform_k:3", dl="periodic:2,3", k_active=3),
    FleetPath("cors staleness:0.5 lognormal:2 lag lognormal:2", "cors",
              "staleness:0.5", clock="lognormal:2", dl="lognormal:2"),
    FleetPath("cors mixed homogeneous:1 lag homogeneous:1", "cors", "flat",
              clock="homogeneous:1", dl="homogeneous:1", n=6, hetero=True,
              k_active=None,
              want_vec=(2 * MIX_STEPS * ROUNDS,) * 2 + (2 * ROUNDS,)))
# Phase 5f: cohort shards and streaming arrivals. vec runs the step in
# every round, also one with no participant (streaming runs full width).
STREAM_SMALL = "stream:2,1.5,0.3,7,0"     # 5 seats: 3 evictions, 2 drops
STREAM_ROUNDS = 8
SHARD_PATHS = (
    FleetPath("cors sharded:flat,1", "cors", "sharded:flat,1"),
    FleetPath("cors sharded:flat,4", "cors", "sharded:flat,4"),
    FleetPath("cors sharded:per_class,4", "cors", "sharded:per_class,4"),
    FleetPath("cors sharded:staleness,4 uniform_k:3", "cors",
              "sharded:staleness,4", "uniform_k:3", k_active=3),
    FleetPath("fd sharded:flat,2", "fd", "sharded:flat,2",
              want_vec=(0, 0, 2 * ROUNDS)),
    FleetPath("cors sharded:flat,4 lognormal:2", "cors", "sharded:flat,4",
              clock="lognormal:2"),
    FleetPath("cors sharded:flat,4 lag periodic:2,3", "cors",
              "sharded:flat,4", dl="periodic:2,3"),
    FleetPath(f"cors sharded:flat,2 {STREAM_SMALL}", "cors",
              "sharded:flat,2", arrivals=STREAM_SMALL, rounds=STREAM_ROUNDS,
              want_vec=(STEPS * STREAM_ROUNDS,) * 2 + (STREAM_ROUNDS,)))
# Phase 5g: telemetry (TelemetryConfig with a JSONL sink and a trace) on
# paths of phases 5, 5d, 5e and 5f, their launches unchanged by it.
TELEMETRY_PATHS = (
    FleetPath("telemetry: cors flat", "cors", "flat"),
    FleetPath("telemetry: cors flat lognormal:2", "cors", "flat",
              clock="lognormal:2"),
    FleetPath("telemetry: cors flat lag periodic:2,3", "cors", "flat",
              dl="periodic:2,3"),
    FleetPath("telemetry: cors flat uniform_k:3", "cors", "flat",
              "uniform_k:3", k_active=3),
    FleetPath("telemetry: cors sharded:flat,4", "cors", "sharded:flat,4"),
    FleetPath("telemetry: cors mixed lognormal:2", "cors", "flat",
              clock="lognormal:2", n=6, hetero=True, k_active=None,
              want_vec=(2 * MIX_STEPS * ROUNDS,) * 2 + (2 * ROUNDS,)),
    FleetPath(f"telemetry: cors sharded:flat,2 {STREAM_SMALL}", "cors",
              "sharded:flat,2", arrivals=STREAM_SMALL, rounds=STREAM_ROUNDS,
              want_vec=(STEPS * STREAM_ROUNDS,) * 2 + (STREAM_ROUNDS,)))
TELEMETRY_PAIRS = 9        # rounds of telemetry on and off, in turns
# the spans each engine's trace must hold (a mixed fleet's vec: its bucket
# steps and shared commit in place of the round step)
SEQ_SPANS = {"teacher_read", "update", "upload", "commit", "eval"}
VEC_SPANS = {"round_step", "eval"}
BUCKET_SPANS = {"bucket_steps", "commit", "eval"}
SHARD_PAIRS = 9            # N = 5: rounds of sharded:flat,4 and flat, in turns
# population scale: 32 seats, 8 participants a round from round 2 on,
# arrivals drawn from a million ids (62 evictions from round 5, 10 drops)
STREAM_SCALE, STREAM_SCALE_ROUNDS, SCALE_SHARDS = (
    "stream:8,8.0,0.3,1000000,0", 12, 4)
RING_INTS = ("ptr", "owner", "valid", "stamp", "clock", "valid_g")
SCALE_CLIENTS, SCALE_ROUNDS = 32, 2   # class_images(7680): 240 samples a client
# Phase 5h: the fleet on a client mesh (relay/placement.py, FleetConfig.mesh).
# The reference's mesh compositions (tests/test_multidevice.py) at N = 8 on
# the MLP, 24 samples a client and batch 16, so one local step a round:
# (name, fleet, mixed 5 + 3 fleet, telemetry). A rank launches disc_loss
# once a local step each way and proto_accum once a round for each stack it
# runs: its block of a client-sharded stack, or a whole bucket that the
# ranks do not divide (5 + 3 on 4 ranks: both buckets, on every rank).
MESH_CLIENTS, MESH_RANKS, MESH_SAMPLES = 8, 4, 24
MESH_PATHS = (
    ("synchronous", {}, False, False),
    ("staleness lognormal:2", dict(policy="staleness", clock="lognormal:2"),
     False, False),
    ("per_class lag lognormal:2",
     dict(policy="per_class", download_clock="lognormal:2"), False, False),
    ("uniform_k:3", dict(participation="uniform_k:3"), False, False),
    ("mixed 5+3", {}, True, False),
    ("telemetry staleness lognormal:2",
     dict(policy="staleness", clock="lognormal:2"), False, True),
    ("lognormal:2 lag lognormal:2",
     dict(clock="lognormal:2", download_clock="lognormal:2"), False, False))
MESH_LENET = "LeNet N=32 cors flat"
MESH_PINNED = "LeNet N=32 cors flat, cuDNN off"
# 4 ranks against the unsharded engine: integers exactly, accuracies and
# telemetry floats within 2e-2, and the floats (metrics rtol, grad_norm
# rtol, metrics atol, observations and global prototypes, weights) at
# tests/test_torch_vec_collab.py's MLP vec-against-seq bounds MESH_TOL for
# the MLP fleets and for the LeNet fleet with cuDNN off on both sides
# (PyTorch's own convolution, which runs a grouped convolution group by
# group, so a rank's 8-client stack rounds as the 32-client one does).
# The LeNet fleet on cuDNN, the path users run, keeps each float spread
# within MESH_SPREAD times the unsharded engine's spread from the
# sequential one on the same fleet (5h-a): in float32 (TF32 off, also in
# each rank) cuDNN's grouped convolutions of an 8-client stack may round
# otherwise than those of the 32-client one (5h-a's grouped-convolution
# check reads it), and max-pool near-ties and Adam carry that on, as they
# carry the grouped convolutions' rounding between the vec and seq
# engines (tests/test_torch_vec_collab.py's docstring).
MESH_TOL = (1e-3, 1e-3, 1e-4, 1e-4, 1e-4)
MESH_SPREAD = 4
# flash_attention (B, S, H, G, hd), S = Sq = Sk: the serving prefill's shape
# first, then tests/test_kernels.py's, a ragged one, and the serving shape at
# head_dim 32 and 128. Kernel and plain do the same float32 math, summed in
# another order (the bf16 kernel splits P into two bf16 halves to keep it).
# float32: |kernel - plain| <= FLASH_F32_TOL x max(1, max|plain|), as
# tests/test_kernels.py. bf16: both round that float32 result to bf16, so
# they differ by at most one bf16 step, element by element:
# |kernel - plain| <= BF16_ATOL + BF16_RTOL |plain|.
FLASH_SHAPES = ((4, 1024, 32, 4, 64), (2, 128, 4, 2, 64), (1, 256, 8, 8, 128),
                (2, 128, 4, 1, 32), (2, 100, 4, 2, 64), (4, 1024, 32, 4, 32),
                (4, 1024, 32, 4, 128))
FLASH_F32_TOL = 2e-5
BF16_ATOL, BF16_RTOL = 1e-4, 2.0 ** -7
# the float32 flash kernel's floor: its split runs three TF32 products for
# each float32 one (H100 SXM dense TF32, NVIDIA data sheet)
TF32_FLOPS = 495e12
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 1024, 32
CHECK_PROMPT = 256
# float32 serving check: |kernel path - plain| <= CHECK_TOL * max(1, |plain|)
# over the last position's logits: 22 layers of float32 products summed in
# another order (the same bound for decode against prefill). The H100 reads
# about 3.4e-6 x max|logit| for both; bf16 attention in the same model must
# fail it.
CHECK_TOL = 5e-5
# Phase 10: LM training (launch/train.py). 10a holds the step on the card
# against the CPU on reduced float32 models; 10b trains TinyLlama-1.1B at
# its published widths (bf16, random weights from seed 0): 2 clients, cors,
# batch 2 x 2048 tokens a client (its context), L_disc on T = 4096 tokens,
# the merge in every step (sync_in_step, the reference's default), LM_STEPS
# steps; 10c runs the collab_lm twin on the card.
LM_CLIENTS, LM_STEPS = 2, 3
LM_BATCH, LM_SEQ, LM_DISC_TOKENS = 2, 2048, 8192
LM_MEM_LIMIT = 70e9            # the peak 10b and 13 must stay under
# Phase 13's cuts keep no less room than this under the gate: one layer
# more must come within it (the peak varied by 0.02 GB between two runs
# of one depth, and one layer more is a linear estimate)
LM_MEM_MARGIN = 0.5e9
PARITY_BATCH, PARITY_SEQ, PARITY_DISC = 4, 64, 128
# 10a's tolerances, card against CPU (the same weights, batches and
# negative ids; TF32 off): metrics |d| <= 1e-4 x max(1, |m|) (float32
# products summed in another order); parameters: Adam's first steps move
# an element by about lr whatever its gradient's size, so an element whose
# gradient is ~0 may move the other way: |d| <= 2 lr a step, and at most
# 1% of the elements beyond 1e-4; ProtoState sums within 5e-3 x
# max(1, |sum|) (the features of parameters that differ so), counts equal.
PARITY_MET_TOL, PARITY_PARAM_TOL, PARITY_PARAM_FRAC = 1e-4, 1e-4, 0.01
PARITY_PROTO_TOL = 5e-3
# proto_accum at 10b's shape: (N, B*S, d', V)
LM_PROTO_SHAPE = (LM_CLIENTS, LM_BATCH * LM_SEQ, 2048, 32000)
# Phase 11: every decoder-only family serves at its published widths (bf16,
# random weights from seed 0): FAMILY_BATCH prompts of FAMILY_PROMPT tokens
# (a multiple of zamba2's SSD chunk, 128, and of the xLSTM's, 256), then
# FAMILY_TOKENS greedy tokens. (arch, layers kept or None for all, flash
# launches a prefill): one for each attention layer (MLA's at its split
# head dims), one for each of zamba2's 6 applications of its shared block,
# none for the xLSTM. DeepSeek-67B (67 B parameters, 134 GB in bf16) is cut
# to 16 of its 95 layers to fit one 80 GB card, every width kept.
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_TOKENS = 4, 256, 8
FAMILIES = (("granite-moe-1b-a400m", None, 24),
            ("deepseek-v2-lite-16b", None, 27), ("minicpm3-4b", None, 62),
            ("chatglm3-6b", None, 28), ("qwen2-vl-7b", None, 28),
            ("zamba2-1.2b", None, 6), ("xlstm-125m", None, 0),
            ("deepseek-67b", 16, 16))
# flash_attention at MLA's split head dims (B, Sq, Sk, H, G, hd, hv), benched
# in phase 4 in both dtypes, the kernel that ran named by the profiler in
# phase 6:
# phase 11's DeepSeek-V2-Lite and MiniCPM3 prefill shapes first, then a
# partial query tile and key tile at both pairs and several tiles of each
# at 192/128 (the tensor-core kernel in bf16), and the reduced configs'
# 80/64 (the CUDA-core kernel in both dtypes)
FLASH_MLA_SHAPES = ((4, 256, 256, 16, 16, 192, 128),
                    (4, 256, 256, 40, 40, 96, 64),
                    (1, 77, 130, 8, 8, 192, 128), (1, 77, 130, 8, 8, 96, 64),
                    (1, 300, 300, 16, 16, 192, 128),
                    (2, 100, 100, 4, 4, 80, 64))
# (hd, hv) pairs that the tensor-core kernels take, bf16 and float32 (ops.py)
FLASH_TC_MLA_DIMS = ((192, 128), (96, 64))
# the tensor-core flash instances that ptxas may report spilling: none
# since the window's range test (bf16 hd 64 causal spilled 12 bytes stored
# and 36 loaded before); phase 2 fails on any
FLASH_KNOWN_SPILLS = set()
# ... and at the other families' equal head dims (B, S, H, G, hd), bf16 and
# causal as phase 11 serves them, on the tensor-core kernel: Qwen2-VL,
# ChatGLM3, DeepSeek-67B, Granite, Zamba2's shared block
FLASH_FAMILY_SHAPES = ((4, 256, 28, 4, 128), (4, 256, 32, 2, 128),
                       (4, 256, 64, 8, 128), (4, 256, 16, 8, 64),
                       (4, 256, 32, 32, 64))
# Phase 12: Whisper-small serves at its published widths (bf16, random
# weights from seed 0): WHISPER_BATCH clips of 1,500 seeded random frames
# (the reference's stubbed audio frontend) with WHISPER_PROMPT-token
# prompts, then WHISPER_TOKENS greedy tokens (within its 448 decoder
# positions). Its flash shapes (B, Sq, Sk, H, G, hd, causal), benched in
# phase 4 in bf16 and float32: the encoder over the frames, the decoder's
# self-attention over the prompt, its cross-attention from the prompt and,
# in decode, from one token over the frames.
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_TOKENS = 4, 32, 64
WHISPER_FLASH_SHAPES = ((4, 1500, 1500, 12, 12, 64, False),
                        (4, 32, 32, 12, 12, 64, True),
                        (4, 32, 1500, 12, 12, 64, False),
                        (4, 1, 1500, 12, 12, 64, False))
# Phase 13: training at published widths (bf16, random weights from seed
# 0), cors, 2 clients, L_disc on the first LM_DISC_TOKENS tokens: Whisper
# on 2 clips of 448 tokens (its decoder's positions) over 1,500 frames a
# client, LM_STEPS steps; the four kinds of the families on one sequence
# of 2048 tokens a client, FAMILY_TRAIN_STEPS steps, each at the depth the
# 70 GB gate allows, every width kept: (arch, layers kept or None for
# all). The step holds both clients' parameters, gradients and Adam
# moments, old and new, about 44 bytes a parameter of one client. Phase
# 13 checks each cut: from the peak one layer less, one layer more must
# come within LM_MEM_MARGIN of the gate (MiniCPM3: 70.01 GB expected at
# 16 layers on an H100 80GB HBM3 at 700 W).
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ = 2, 448
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ, FAMILY_TRAIN_STEPS = 1, 2048, 2
FAMILY_TRAIN = (("granite-moe-1b-a400m", None), ("zamba2-1.2b", None),
                ("minicpm3-4b", 15), ("deepseek-v2-lite-16b", 1))
# proto_accum at Whisper's train shape: (N, B*S, d', V)
WHISPER_PROTO_SHAPE = (LM_CLIENTS, WHISPER_TRAIN_BATCH * WHISPER_TRAIN_SEQ,
                       768, 51865)


def time_ms(fn, reps=50, warmup=5):
    """Mean device time of fn() in ms, by CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(nbytes, flops, peak=F32_FLOPS):
    t_b, t_o = nbytes / MEM_BPS * 1e3, flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_err(got, want, what):
    """Largest |got - want| over the outputs; raises past the tolerance."""
    worst = 0.0
    for a, b in zip(got, want):
        e = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
        scale = max(1.0, float(b.float().abs().max()) if b.numel() else 0.0)
        if not e <= TOL * scale:
            raise AssertionError(f"{what}: max error {e:.3e} > {TOL} x {scale:.3e}")
        worst = max(worst, e)
    return worst


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: no CUDA device (torch.cuda.is_available() is "
                         "False); this script measures the port on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build():
    from repro_torch.kernels import build
    secs = build.build_all()
    print(f"[build] kernels built in {secs:.2f} s into {build.BUILD_DIR}")
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line:
                print(f"[build] {name}: {line.strip()}")
    lib = build.lib("flash_attention")
    res = {}
    for dtype, symbol, smem in (
            ("bf16", "flash_attention_bf16_kernel",
             lib.flash_attention_bf16_smem),
            ("float32", "flash_attention_tf32x3_kernel",
             lib.flash_attention_f32_smem)):
        res[dtype] = flash_resources(build.BUILD_LOG["flash_attention"],
                                     symbol, smem)
        for tag, r in res[dtype].items():
            print(f"[build] {symbol} {tag}: {r['registers']} registers a "
                  f"thread at entry (setmaxnreg moves them between producer "
                  f"and consumers where a block has two consumer "
                  f"warpgroups), {r['smem_bytes']} bytes of dynamic shared "
                  f"memory, {r['spill_stores']} / {r['spill_loads']} bytes of "
                  f"spill stores / loads")
    return res


def flash_resources(log, symbol, smem):
    """ptxas -v's registers and spills of each instance of a tensor-core
    flash kernel (`symbol`), and its dynamic shared memory (`smem(hd, hv)`)
    -> {"hd64 causal": {...}, "hd192/128 full": ...}: the three equal head
    dims and MLA's two pairs, causal and full."""
    res, cur = {}, None
    for line in log.splitlines():
        m = re.search(rf"Function properties for \S*{symbol}"
                      r"ILi(\d+)ELi(\d+)ELb(\d)", line)
        if m:
            hd, hv = int(m.group(1)), int(m.group(2))
            dims = f"{hd}" if hd == hv else f"{hd}/{hv}"
            cur = f"hd{dims} {'causal' if m.group(3) == '1' else 'full'}"
            res[cur] = {"smem_bytes": smem(hd, hv)}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            res[cur]["spill_stores"] = int(m.group(1))
            res[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            res[cur]["registers"] = int(m.group(1))
            cur = None
    if len(res) != 10 or any(len(r) != 4 for r in res.values()):
        raise AssertionError(f"ptxas -v did not report the ten {symbol} "
                             f"instances: {res}")
    if any(not 0 < r["smem_bytes"] <= SMEM_PER_BLOCK for r in res.values()):
        raise AssertionError(f"a {symbol} instance needs more shared memory "
                             f"than a block may use: {res}")
    spilled = {t for t, r in res.items() if r["spill_stores"] or r["spill_loads"]}
    if spilled - FLASH_KNOWN_SPILLS:
        raise AssertionError(f"{symbol} instances that spill: "
                             f"{sorted(spilled)} (known: "
                             f"{sorted(FLASH_KNOWN_SPILLS)})")
    return res


def phase_precision():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[precision] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def check_disc(B, C, M, with_valid, dev, gen):
    from repro_torch.kernels import ops, ref
    s = (torch.randn(B, C, generator=gen) * 2).to(dev)
    q = torch.softmax(torch.randn(M, C, generator=gen) * 2, -1).to(dev)
    y = torch.randint(0, M, (B,), generator=gen, dtype=torch.int32).to(dev)
    v = (torch.arange(M) % 3 != 1).to(dev) if with_valid else None
    g = torch.randn(B, generator=gen).to(dev)
    tag = f"disc_loss ({B}, {C}, {M}){' valid' if with_valid else ''}"
    out, want = ops.disc_loss_fwd(s, q, y, v), ref.disc_loss_fwd(s, q, y, v)
    grads = ops.disc_loss_bwd(g, s, q, y, v, *out[1:])
    again = ops.disc_loss_fwd(s, q, y, v)
    grads_again = ops.disc_loss_bwd(g, s, q, y, v, *again[1:])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out + grads,
                                                 again + grads_again)):
        raise AssertionError(f"{tag}: two launches disagree")
    e_f = max_err(out, want, tag + " fwd")
    e_b = max_err(grads, ref.disc_loss_bwd(g, s, q, y, v, *want[1:]),
                  tag + " bwd")
    fwd = dict(ms=time_ms(lambda: ops.disc_loss_fwd(s, q, y, v)),
               plain_ms=time_ms(lambda: ref.disc_loss_fwd(s, q, y, v)),
               max_abs_err=e_f, library_ms=None)
    bwd = dict(ms=time_ms(lambda: ops.disc_loss_bwd(g, s, q, y, v, *out[1:])),
               plain_ms=time_ms(lambda: ref.disc_loss_bwd(g, s, q, y, v,
                                                          *want[1:])),
               max_abs_err=e_b, library_ms=None)
    (fb, fo), (bb, bo) = _disc_bytes_ops(B, C, M)
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(fb, fo)
    bwd["bound_ms"], bwd["bound_by"] = bound_ms(bb, bo)
    for name, r in (("fwd", fwd), ("bwd", bwd)):
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        print(f"[kernels] {tag} {name}: max_abs_err {r['max_abs_err']:.3e} "
              f"(tol {TOL} x max(1, |plain|)), two launches bit-equal, "
              f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"bound_ms {r['bound_ms']:.6f} ({r['bound_by']}), "
              f"{r['share_of_bound']:.3f} of the bound")
    return fwd, bwd


def check_proto(n, d, C, dtype, dev, gen):
    from repro_torch.kernels import ops, ref
    f = torch.randn(n, d, generator=gen).to(dtype).to(dev)
    lab = torch.randint(0, C, (n,), generator=gen, dtype=torch.int32).to(dev)
    tag = f"proto_accum ({n}, {d}, {C}) {str(dtype).split('.')[-1]}"
    out = ops.proto_accum(f, lab, C)
    again = ops.proto_accum(f, lab, C)
    torch.cuda.synchronize()
    if not (torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])):
        raise AssertionError(f"{tag}: two launches disagree")
    err = max_err(out, ref.proto_accum(f, lab, C), tag)
    f32, lab64 = f.float(), lab.long()
    r = dict(ms=time_ms(lambda: ops.proto_accum(f, lab, C)),
             plain_ms=time_ms(lambda: ref.proto_accum(f, lab, C)),
             library_ms=time_ms(lambda: torch.zeros(C, d, device=dev)
                                .index_add_(0, lab64, f32)),
             max_abs_err=err)
    r["bound_ms"], r["bound_by"] = bound_ms(
        n * d * f.element_size() + 4 * n + 4 * (C * d + C), n * d)
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    print(f"[kernels] {tag}: max_abs_err {err:.3e}, two launches bit-equal, "
          f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
          f"{r['library_ms']:.4f} (index_add_ on f32) bound_ms "
          f"{r['bound_ms']:.6f} ({r['bound_by']}), {r['share_of_bound']:.3f} "
          f"of the bound")
    return r


def _disc_bytes_ops(B, C, M):
    """(bytes, operations) of one client's forward and backward: each input
    read once, each output written once (f32 / int32)."""
    return ((4 * (B * C + M * C + B + M) + 4 * (3 * B + B * M),
             2 * B * C * M + 4 * B * C + 6 * B * M),
            (4 * (B * C + M * C + 4 * B + M + B * M) + 4 * (B * C + M * C),
             4 * B * C * M + 6 * B * C + 8 * B * M))


def check_disc_batched(N, B, C, M, with_valid, dev, gen):
    """disc_loss with a leading axis of N clients (the vectorized engine's
    call): one launch, bit-equal to N launches of one client, within TOL of
    the batched plain version."""
    from repro_torch.kernels import ops, ref
    s = (torch.randn(N, B, C, generator=gen) * 2).to(dev)
    q = torch.softmax(torch.randn(N, M, C, generator=gen) * 2, -1).to(dev)
    y = torch.randint(0, M, (N, B), generator=gen, dtype=torch.int32).to(dev)
    v = (torch.rand(N, M, generator=gen) > 0.3).to(dev) if with_valid else None
    g = torch.randn(N, B, generator=gen).to(dev)
    vi = lambda i: None if v is None else v[i]
    tag = f"disc_loss batched ({N}, {B}, {C}, {M}){' valid' if with_valid else ''}"
    out = ops.disc_loss_fwd(s, q, y, v)
    grads = ops.disc_loss_bwd(g, s, q, y, v, *out[1:])
    per = [ops.disc_loss_fwd(s[i], q[i], y[i], vi(i)) for i in range(N)]
    per_g = [ops.disc_loss_bwd(g[i], s[i], q[i], y[i], vi(i), *per[i][1:])
             for i in range(N)]
    torch.cuda.synchronize()
    for k, a in enumerate(out):
        if not torch.equal(a, torch.stack([p[k] for p in per])):
            raise AssertionError(f"{tag}: forward output {k} differs from one "
                                 f"launch a client")
    for k, a in enumerate(grads):
        if not torch.equal(a, torch.stack([p[k] for p in per_g])):
            raise AssertionError(f"{tag}: backward output {k} differs from one "
                                 f"launch a client")
    want = ref.disc_loss_fwd(s, q, y, v)
    e_f = max_err(out, want, tag + " fwd")
    e_b = max_err(grads, ref.disc_loss_bwd(g, s, q, y, v, *want[1:]), tag + " bwd")
    fwd = dict(ms=time_ms(lambda: ops.disc_loss_fwd(s, q, y, v)),
               plain_ms=time_ms(lambda: ref.disc_loss_fwd(s, q, y, v)),
               max_abs_err=e_f, library_ms=None)
    bwd = dict(ms=time_ms(lambda: ops.disc_loss_bwd(g, s, q, y, v, *out[1:])),
               plain_ms=time_ms(lambda: ref.disc_loss_bwd(g, s, q, y, v,
                                                          *want[1:])),
               max_abs_err=e_b, library_ms=None)
    (fb, fo), (bb, bo) = _disc_bytes_ops(B, C, M)
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(N * fb, N * fo)
    bwd["bound_ms"], bwd["bound_by"] = bound_ms(N * bb, N * bo)
    for name, r in (("fwd", fwd), ("bwd", bwd)):
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        print(f"[kernels] {tag} {name}: max_abs_err {r['max_abs_err']:.3e} "
              f"(tol {TOL} x max(1, |plain|)), bit-equal to {N} one-client "
              f"launches, kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"bound_ms {r['bound_ms']:.6f} ({r['bound_by']}), "
              f"{r['share_of_bound']:.3f} of the bound")
    return fwd, bwd


def check_proto_batched(N, n, d, C, dtype, dev, gen):
    """proto_accum with a leading axis of N clients: one launch, bit-equal
    to N launches of one client, within TOL of the batched plain version;
    the library call is one `index_add_` over the clients' classes."""
    from repro_torch.kernels import ops, ref
    f = torch.randn(N, n, d, generator=gen).to(dtype).to(dev)
    lab = torch.randint(0, C, (N, n), generator=gen, dtype=torch.int32).to(dev)
    tag = f"proto_accum batched ({N}, {n}, {d}, {C}) {str(dtype).split('.')[-1]}"
    out = ops.proto_accum(f, lab, C)
    again = ops.proto_accum(f, lab, C)
    per = [ops.proto_accum(f[i], lab[i], C) for i in range(N)]
    torch.cuda.synchronize()
    for k in range(2):
        if not torch.equal(out[k], again[k]):
            raise AssertionError(f"{tag}: two launches disagree")
        if not torch.equal(out[k], torch.stack([p[k] for p in per])):
            raise AssertionError(f"{tag}: output {k} differs from one launch "
                                 f"a client")
    err = max_err(out, ref.proto_accum(f, lab, C), tag)
    f32 = f.float().reshape(N * n, d)
    rows = (lab.long() + C * torch.arange(N, device=dev)[:, None]).reshape(-1)
    r = dict(ms=time_ms(lambda: ops.proto_accum(f, lab, C)),
             plain_ms=time_ms(lambda: ref.proto_accum(f, lab, C)),
             library_ms=time_ms(lambda: torch.zeros(N * C, d, device=dev)
                                .index_add_(0, rows, f32)),
             max_abs_err=err)
    r["bound_ms"], r["bound_by"] = bound_ms(
        N * (n * d * f.element_size() + 4 * n + 4 * (C * d + C)), N * n * d)
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    print(f"[kernels] {tag}: max_abs_err {err:.3e}, two launches and {N} "
          f"one-client launches bit-equal, kernel_ms {r['ms']:.4f} plain_ms "
          f"{r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} (index_add_ "
          f"on f32) bound_ms {r['bound_ms']:.6f} ({r['bound_by']}), "
          f"{r['share_of_bound']:.3f} of the bound")
    return r


def check_gathered(N, idx, dev, gen, B=32, C=10, M=10, n=240, d=84):
    """Static-k compaction's calls: disc_loss forward and backward and
    proto_accum on a (k, ...) block gathered by `index_select` from an
    N-client stack, each result bit-equal to one launch a client on the
    stack's own rows."""
    from repro_torch.kernels import ops
    s = (torch.randn(N, B, C, generator=gen) * 2).to(dev)
    q = torch.softmax(torch.randn(N, M, C, generator=gen) * 2, -1).to(dev)
    y = torch.randint(0, M, (N, B), generator=gen, dtype=torch.int32).to(dev)
    v = (torch.rand(N, M, generator=gen) > 0.3).to(dev)
    g = torch.randn(N, B, generator=gen).to(dev)
    f = torch.randn(N, n, d, generator=gen).to(dev)
    lab = torch.randint(0, C, (N, n), generator=gen, dtype=torch.int32).to(dev)
    ix = torch.tensor(idx, device=dev)
    sk, qk, yk, vk, gk, fk, labk = (t.index_select(0, ix)
                                    for t in (s, q, y, v, g, f, lab))
    out = ops.disc_loss_fwd(sk, qk, yk, vk)
    grads = ops.disc_loss_bwd(gk, sk, qk, yk, vk, *out[1:])
    sums = ops.proto_accum(fk, labk, C)
    for j, i in enumerate(idx):
        one = ops.disc_loss_fwd(s[i], q[i], y[i], v[i])
        one_g = ops.disc_loss_bwd(g[i], s[i], q[i], y[i], v[i], *one[1:])
        one_p = ops.proto_accum(f[i], lab[i], C)
        for what, got, want in (("disc_loss fwd", out, one),
                                ("disc_loss bwd", grads, one_g),
                                ("proto_accum", sums, one_p)):
            if not all(torch.equal(a[j], b) for a, b in zip(got, want)):
                raise AssertionError(f"{what} on a block gathered from {N} "
                                     f"clients: client {i} differs from its "
                                     f"own launch")
    print(f"[kernels] gathered block {len(idx)} of {N} clients {idx}: disc_loss"
          f" ({len(idx)}, {B}, {C}, {M}) fwd and bwd and proto_accum "
          f"({len(idx)}, {n}, {d}, {C}) bit-equal to one launch a client")


def flash_excess(got, want):
    """Largest |got - want| over its limit, element by element (> 1 fails):
    one bf16 step for bf16, FLASH_F32_TOL x max(1, max|want|) for float32."""
    d = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        return float((d / (BF16_ATOL + BF16_RTOL * want.float().abs())).max())
    return float(d.max()) / (FLASH_F32_TOL * max(1.0, float(want.abs().max())))


def flash_faulty(q, k, v, causal, fault, bk):
    """A faulty flash kernel, emulated: the online softmax over key tiles of
    `bk` with float32 running state, but for one fault: "bf16 accumulator"
    rounds the running sum and accumulator to bf16 after every tile; "P
    rounded to bf16 once" rounds P to bf16 before P V, as FlashAttention-2/3
    do where the kernel splits P into two bf16 halves. The bf16 check must
    reject both. v's width hv may differ from q's hd (MLA)."""
    B, Sq, H, hd = q.shape
    G, hv = k.shape[2], v.shape[3]
    qf = q.reshape(B, Sq, G, H // G, hd).float() * hd ** -0.5
    m = torch.full((B, G, Sq, H // G, 1), -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, G, Sq, H // G, hv, device=q.device)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    for k0 in range(0, k.shape[1], bk):
        kt, vt = k[:, k0:k0 + bk].float(), v[:, k0:k0 + bk].float()
        s = torch.einsum("bqghd,bkgd->bgqhk", qf, kt)
        if causal:
            k_pos = torch.arange(k0, k0 + kt.shape[1], device=q.device)
            s = s.masked_fill(~(q_pos >= k_pos)[None, None, :, None, :], -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p, alpha = torch.exp(s - m_new), torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if fault == "P rounded to bf16 once":
            p = p.bfloat16().float()
        acc = acc * alpha + torch.einsum("bgqhk,bkgd->bgqhd", p, vt)
        if fault == "bf16 accumulator":
            l, acc = l.bfloat16().float(), acc.bfloat16().float()
        m = m_new
    o = acc / l.clamp_min(1e-30)
    return o.permute(0, 2, 1, 3, 4).reshape(B, Sq, H, hv).to(q.dtype)


def flash_controls(B, S, H, G, hd, dev, gen, hv=None):
    """Three faulty results at a shape, bf16 causal, that the bf16 check
    must reject: the bf16-accumulating emulation, attention that drops the
    last 16 keys, and P rounded to bf16 once over the tensor-core kernel's
    key tiles (128 at hd 32 and 64, else 64). Values hv wide (hd when
    None). -> {name: (excess, old excess)}, the old being against 2e-2 x
    max(1, max|plain|)."""
    from repro_torch.kernels import ref
    hv = hd if hv is None else hv
    q, k, v = (torch.randn(B, S, n, d, generator=gen).bfloat16().to(dev)
               for n, d in ((H, hd), (G, hd), (G, hv)))
    want = ref.flash_attention(q, k, v, causal=True)
    dims = f"{hd}" if hv == hd else f"{hd}/{hv}"
    old_lim = 2e-2 * max(1.0, float(want.float().abs().max()))
    out = {}
    for name, bad in (
            ("bf16 accumulator",
             flash_faulty(q, k, v, True, "bf16 accumulator", bk=32)),
            ("last 16 keys dropped",
             ref.flash_attention(q, k[:, :-16], v[:, :-16], causal=True)),
            ("P rounded to bf16 once",
             flash_faulty(q, k, v, True, "P rounded to bf16 once",
                          bk=128 if hd == hv and hd <= 64 else 64))):
        ex = flash_excess(bad, want)
        old = float((bad.float() - want.float()).abs().max()) / old_lim
        print(f"[kernels] control ({B}, {S}, {H}, {G}, {dims}) bf16 causal, "
              f"{name}: {ex:.2f} x the limit (the old 2e-2 x max|plain| limit:"
              f" {old:.2f} x)")
        if not ex > 1:
            raise AssertionError(f"the bf16 check passes a faulty kernel "
                                 f"({name}): {ex:.3f} x the limit")
        out[name] = (ex, old)
    return out


def flash_name(key):
    """A profiler key's flash kernel with its template arguments, e.g.
    "flash_attention_bf16_kernel<192, 128, true>", or None."""
    m = re.search(r"flash_attention\w*(<[^>]*>)?", key)
    return m.group(0) if m else None


def flash_kernel_names(fn, windows=3):
    """[(name, count)] of the flash kernels fn() launched, by the profiler's
    names (`flash_name`). A window that shows no flash kernel while its
    device records fall short of the launches the host counted (the
    profiler dropped some, MARKERS notwithstanding) proves nothing either
    way, so it is taken again, up to `windows` in all."""
    for i in range(windows):
        _, ev, launched, dropped = profile(fn)
        names = [(flash_name(e.key), e.count) for e in ev if flash_name(e.key)]
        kept = sum(e.count for e in ev)
        if names or kept >= launched:
            return names
        print(f"[flash symbols] window {i + 1}: the profiler kept {kept} of "
              f"{launched} device records and dropped {dropped} of {MARKERS} "
              f"markers; taken again")
    return names


def flash_symbol(dtype, hd, hv):
    """The device kernel that takes a flash call (ops.KERNEL_SYMBOLS): at
    (80, 64) the CUDA-core kernel, elsewhere the tensor-core kernel of its
    dtype."""
    if (hd, hv) == (80, 64):
        return "flash_attention_kernel"
    return ("flash_attention_bf16_kernel" if dtype == torch.bfloat16
            else "flash_attention_tf32x3_kernel")


def phase_flash_symbols(dev, rows):
    """The device kernel of each of phase 4's MLA rows and float32 Whisper
    cross-attention rows (`rows`, its flash results), by the profiler's
    names (`flash_symbol`), once a call, a key split included. Run after
    phase 6: a profiler session leaves the process's later launches slower
    (phase 4's small flash and SDPA calls read up to twice their times once
    one had run), which would skew phases 4 and 5. Each row gains its
    "symbol"."""
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(0)
    for r in rows:
        if len(r["shape"]) == 9:              # (B, Sq, Sk, H, G, hd, hv, ...)
            B, Sq, Sk, H, G, hd, hv, dtype, mode = r["shape"]
        elif (len(r["shape"]) == 8 and r["shape"][6] == "float32"
              and r["shape"][1] != r["shape"][2]):   # Whisper's cross attention
            B, Sq, Sk, H, G, hd, dtype, mode = r["shape"]
            hv = hd
        else:
            continue
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(*s, generator=gen).to(dt).to(dev)
                   for s in ((B, Sq, H, hd), (B, Sk, G, hd), (B, Sk, G, hv)))
        want = flash_symbol(dt, hd, hv)
        names = flash_kernel_names(
            lambda: ops.flash_attention(q, k, v, causal=mode == "causal"))
        if (len(names) != 1 or names[0][1] != 1
                or not re.search(rf"\b{want}\b", names[0][0])):
            raise AssertionError(f"flash_attention {r['shape']}: launched "
                                 f"{names}, not one {want}")
        r["symbol"] = names[0][0]
        print(f"[flash symbols] ({B}, {Sq}x{Sk}, {H}, {G}, {hd}/{hv}) {dtype} "
              f"{mode}: ran {names[0][0]}"
              + (f" (key splits {r['splits']})" if r.get("splits") else ""))


def check_flash(B, S, H, G, hd, dtype, causal, dev, gen, hv=None, Sk=None):
    """The kernel against its plain version at (B, S, H, G, hd), values hv
    wide (hd when None; MLA's prefill has hv < hd), over Sk keys (S when
    None; Whisper's cross-attention has Sk != S)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    hv = hd if hv is None else hv
    Sk = S if Sk is None else Sk
    q = torch.randn(B, S, H, hd, generator=gen).to(dtype).to(dev)
    k = torch.randn(B, Sk, G, hd, generator=gen).to(dtype).to(dev)
    v = torch.randn(B, Sk, G, hv, generator=gen).to(dtype).to(dev)
    dims = f"{hd}" if hv == hd else f"{hd}/{hv}"
    seq = f"{S}" if Sk == S else f"{S}x{Sk}"
    tag = (f"flash_attention ({B}, {seq}, {H}, {G}, {dims}) "
           f"{str(dtype).split('.')[-1]} {'causal' if causal else 'full'}")
    out = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    excess = flash_excess(out, want)
    if not excess <= 1:
        raise AssertionError(f"{tag}: max error {err:.3e}, {excess:.3f} x the "
                             f"limit")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    reps = 20 if max(S, Sk) >= 1024 else 50
    r = dict(ms=time_ms(lambda: ops.flash_attention(q, k, v, causal=causal),
                        reps),
             plain_ms=time_ms(lambda: ref.flash_attention(q, k, v,
                                                          causal=causal), reps),
             library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=causal, enable_gqa=True), reps),
             max_abs_err=err, limit_used=excess)
    # q, k and v read once, the output written once; 2 B H S Sk (hd + hv)
    # operations (two products), half of them unmasked when causal (S = Sk)
    flops = 2 * B * H * S * Sk * (hd + hv) / (2 if causal else 1)
    nbytes = (B * S * H + B * Sk * G) * (hd + hv) * q.element_size()
    r["bound_ms"], r["bound_by"] = bound_ms(
        nbytes, flops, BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    lim = ("1e-4 + 2^-7 |plain|" if dtype == torch.bfloat16
           else f"{FLASH_F32_TOL} x max(1, |plain|)")
    extra = ""
    if dtype == torch.float32:
        # the split-TF32 kernel's floor: three TF32 products for each
        r["bound_3xtf32_ms"], r["bound_3xtf32_by"] = bound_ms(
            nbytes, 3 * flops, TF32_FLOPS)
        r["splits"] = ops.flash_f32_splits(B, S, Sk, H, hd, hv, causal)
        extra = (f"; 3xTF32 bound_ms {r['bound_3xtf32_ms']:.6f} "
                 f"({r['bound_3xtf32_by']}), "
                 f"{r['bound_3xtf32_ms'] / r['ms']:.3f} of it; key splits "
                 f"{r['splits']}")
    print(f"[kernels] {tag}: max_abs_err {err:.3e}, {excess:.3f} x the limit "
          f"({lim}) kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
          f"library_ms {r['library_ms']:.4f} (scaled_dot_product_attention) "
          f"bound_ms {r['bound_ms']:.6f} ({r['bound_by']}), "
          f"{r['share_of_bound']:.3f} of the bound{extra}")
    return r


def phase_kernels(dev):
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(0)
    res = {"disc_loss_fwd": [], "disc_loss_bwd": [], "proto_accum": [],
           "flash_attention": [], "disc_loss_fwd_batched": [],
           "disc_loss_bwd_batched": [], "proto_accum_batched": []}
    for B, C, M in ((32, 10, 10), (320, 10, 10), (2048, 4096, 256),
                    (100, 777, 33), (16, 64, 7000)):
        for with_valid in (False, True):
            fwd, bwd = check_disc(B, C, M, with_valid, dev, gen)
            shape = [B, C, M, "valid" if with_valid else "all"]
            res["disc_loss_fwd"].append(dict(fwd, shape=shape))
            res["disc_loss_bwd"].append(dict(bwd, shape=shape))
    for n, d, C in ((240, 84, 10), (1024, 84, 10), (8192, 512, 4096)):
        for dtype in (torch.float32, torch.bfloat16):
            r = check_proto(n, d, C, dtype, dev, gen)
            res["proto_accum"].append(
                dict(r, shape=[n, d, C, str(dtype).split(".")[-1]]))
    # fd's per-class logit sums: 40-byte rows (d = C = 10)
    r = check_proto(240, 10, 10, torch.float32, dev, gen)
    res["proto_accum"].append(dict(r, shape=[240, 10, 10, "float32"]))
    # out-of-range labels contribute nothing
    f = torch.randn(1000, 64, generator=gen).to(dev)
    lab = torch.randint(-3, 303, (1000,), generator=gen).to(dev)
    from repro_torch.kernels import ref
    max_err(ops.proto_accum(f, lab, 300), ref.proto_accum(f, lab, 300),
            "proto_accum out-of-range labels")
    # the vectorized engine's calls: the main path's (5, 32, 10, 10) first,
    # then a shape that takes the split forward
    for N, B, C, M in ((CLIENTS, 32, 10, 10), (3, 100, 777, 33)):
        for with_valid in (False, True):
            fwd, bwd = check_disc_batched(N, B, C, M, with_valid, dev, gen)
            shape = [N, B, C, M, "valid" if with_valid else "all"]
            res["disc_loss_fwd_batched"].append(dict(fwd, shape=shape))
            res["disc_loss_bwd_batched"].append(dict(bwd, shape=shape))
    # static-k compaction's blocks: uniform_k:3 at N = 5, cyclic:8 at N = 32
    check_gathered(CLIENTS, [0, 2, 3], dev, gen)
    check_gathered(SCALE_CLIENTS, list(range(8, 8 + COMPACT_K)), dev, gen)
    for d, dtype in ((84, torch.float32), (84, torch.bfloat16),
                     (10, torch.float32)):          # d 10: fd's logit sums
        r = check_proto_batched(CLIENTS, 240, d, 10, dtype, dev, gen)
        res["proto_accum_batched"].append(
            dict(r, shape=[CLIENTS, 240, d, 10, str(dtype).split(".")[-1]]))
    # the LM train step's upload stats (phase 10b's shape): features cast to
    # float32 by prototypes.accumulate
    r = check_proto_batched(*LM_PROTO_SHAPE, torch.float32, dev, gen)
    res["proto_accum_batched"].append(dict(r, shape=[*LM_PROTO_SHAPE,
                                                     "float32"]))
    for B, S, H, G, hd in FLASH_SHAPES:        # the main path's row first
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                r = check_flash(B, S, H, G, hd, dtype, causal, dev, gen)
                res["flash_attention"].append(dict(
                    r, shape=[B, S, H, G, hd, str(dtype).split(".")[-1],
                              "causal" if causal else "full"]))
    for B, Sq, Sk, H, G, hd, hv in FLASH_MLA_SHAPES:   # MLA's split dims
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                r = check_flash(B, Sq, H, G, hd, dtype, causal, dev, gen, hv,
                                Sk=Sk)
                res["flash_attention"].append(dict(
                    r, shape=[B, Sq, Sk, H, G, hd, hv,
                              str(dtype).split(".")[-1],
                              "causal" if causal else "full"]))
    for B, S, H, G, hd in FLASH_FAMILY_SHAPES:     # phase 11's GQA prefills
        r = check_flash(B, S, H, G, hd, torch.bfloat16, True, dev, gen)
        res["flash_attention"].append(dict(
            r, shape=[B, S, H, G, hd, "bfloat16", "causal"]))
    for B, Sq, Sk, H, G, hd, causal in WHISPER_FLASH_SHAPES:   # phase 12's
        for dtype in (torch.bfloat16, torch.float32):
            r = check_flash(B, Sq, H, G, hd, dtype, causal, dev, gen, Sk=Sk)
            res["flash_attention"].append(dict(
                r, shape=[B, Sq, Sk, H, G, hd, str(dtype).split(".")[-1],
                          "causal" if causal else "full"]))
            # cross attention and decode leave 48 query tiles for 132 SMs:
            # the float32 kernel splits their keys
            if dtype == torch.float32 and Sk > Sq and not r["splits"] > 1:
                raise AssertionError(f"flash_attention float32 ({B}, {Sq}x"
                                     f"{Sk}, {H}, {G}, {hd}): {r['splits']} "
                                     f"key split, not more")
    # Whisper's upload stats in phase 13: 51865 classes leave a partial
    # last class block
    r = check_proto_batched(*WHISPER_PROTO_SHAPE, torch.float32, dev, gen)
    res["proto_accum_batched"].append(dict(r, shape=[*WHISPER_PROTO_SHAPE,
                                                     "float32"]))
    B, Sq, _, H, G, hd, hv = FLASH_MLA_SHAPES[0]
    res["flash_controls"] = {
        "serving": flash_controls(*FLASH_SHAPES[0], dev, gen),
        "mla 192/128": flash_controls(B, Sq, H, G, hd, dev, gen, hv)}
    return res


def phase_slice(dev):
    from repro_torch.collab_image_classification import build_trainer
    from repro_torch.kernels import ops
    gpu = build_trainer(CLIENTS, "cors", seed=0, device=dev, engine="seq")
    ops.reset_launches()
    secs = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        rec = gpu.run_round()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        print(f"[slice] cuda round {rec['round']}: acc {rec['acc_mean']:.4f} "
              f"accs {rec['accs']} {secs[-1]:.3f} s")
    launches = dict(ops.LAUNCHES)
    print(f"[slice] launches {launches}; seconds per round {secs}")
    want = {"disc_loss_fwd": CLIENTS * STEPS * ROUNDS,
            "disc_loss_bwd": CLIENTS * STEPS * ROUNDS,
            "proto_accum": CLIENTS * ROUNDS, "flash_attention": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    for h in gpu.history:
        for m in h["metrics"]:
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"non-finite metrics {m}")

    cpu = build_trainer(CLIENTS, "cors", seed=0, device="cpu", engine="seq")
    for _ in range(ROUNDS):
        cpu.run_round()
    sg, sc = gpu.server.state, cpu.server.state
    for f in ("ptr", "owner", "valid", "stamp", "clock", "valid_g"):
        if not torch.equal(getattr(sg, f).cpu(), getattr(sc, f)):
            raise AssertionError(f"ring field {f} differs between cuda and cpu")
    if gpu.ledger.by_round != cpu.ledger.by_round:
        raise AssertionError("ledgers differ between cuda and cpu")
    for hg, hc in zip(gpu.history, cpu.history):
        d = max(abs(a - b) for a, b in zip(hg["accs"], hc["accs"]))
        if d > 2e-2:
            raise AssertionError(f"round {hg['round']}: accuracies differ by {d}")
    d_obs = float((sg.obs.cpu() - sc.obs).abs().max())
    d_gp = float((sg.global_protos.cpu() - sc.global_protos).abs().max())
    print(f"[slice] cuda vs cpu: ring and ledger equal; accs cuda "
          f"{gpu.history[-1]['accs']} cpu {cpu.history[-1]['accs']}; max |obs| "
          f"diff {d_obs:.3e}, max |global_protos| diff {d_gp:.3e}")
    return gpu, launches, secs


# The profiler drops the first device records of a window, more of them the
# more the process has profiled (each large window adds one, and a window
# now and then loses over a hundred), and keeps the host's launch calls. So
# a window opens with MARKERS spin kernels (left out of the events), and its
# device ops are counted from the host's calls that enqueue one.
MARKERS = 1024
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemcpy",
                "cudaMemcpy2DAsync", "cudaMemsetAsync", "cudaMemset")


def profile(fn):
    """fn() under torch.profiler -> (host wall s, the device events of
    key_averages(), the device ops fn launched, the marker records dropped).
    The window opens with MARKERS marker kernels (`torch.cuda._sleep`'s spin
    kernel), so that the device records the profiler drops are theirs."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(MARKERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_ev = [e for e in events
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    ev = [e for e in dev_ev if "spin_kernel" not in e.key]
    launched = sum(e.count for e in events if e.key in LAUNCH_CALLS) - MARKERS
    dropped = MARKERS - sum(e.count for e in dev_ev if "spin_kernel" in e.key)
    return wall, ev, launched, dropped


def report_profile(tag, wall, ev, launched, dropped, top=12):
    """Prints busy share, device ops and the top kernels; returns busy us
    and, for each LAUNCHES key of the port, (launches, device us) of its
    kernels."""
    from repro_torch.kernels import ops
    busy_us = sum(e.self_device_time_total for e in ev)
    print(f"[{tag}] wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f}%), "
          f"{launched} device ops ({sum(e.count for e in ev)} device records "
          f"kept by the profiler; it dropped {dropped} of {MARKERS} markers)")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:5d}  {e.key[:90]}")
    port = {}
    for name in ops.LAUNCHES:
        pat = re.compile(r"\b(" + "|".join(ops.KERNEL_SYMBOLS[name]) + r")\b")
        hits = [e for e in ev if pat.search(e.key)]
        if hits:
            n = sum(e.count for e in hits)
            us = sum(e.self_device_time_total for e in hits)
            port[name] = (n, us)
            print(f"[{tag}] port kernel {name}: x{n}, {us / n:.2f} us device "
                  f"time per launch")
    return busy_us, port


def phase_vec(dev, seq):
    """The paper's scenario in the vectorized engine: the same 3 rounds as
    phase 5, every round step under sync-debug mode "error", held against
    the sequential engine's run on the card (`seq`, 3 rounds)."""
    from repro_torch.collab_image_classification import build_trainer
    from repro_torch.kernels import ops
    vec = build_trainer(CLIENTS, "cors", seed=0, device=dev, engine="vec")
    restore = no_sync(vec)
    ops.reset_launches()
    secs = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        rec = vec.run_round()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        print(f"[vec] round {rec['round']}: acc {rec['acc_mean']:.4f} accs "
              f"{rec['accs']} {secs[-1]:.3f} s")
    restore()
    launches = dict(ops.LAUNCHES)
    print(f"[vec] launches {launches}; seconds per round {secs}; no host sync "
          f"inside the round step")
    want = {"disc_loss_fwd": STEPS * ROUNDS, "disc_loss_bwd": STEPS * ROUNDS,
            "proto_accum": ROUNDS, "flash_attention": 0}
    if launches != want:
        raise AssertionError(f"vec launch counts {launches} != {want}")
    for h in vec.history:
        for m in h["metrics"]:
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"non-finite metrics {m}")
    sv, ss = vec.relay_state, seq.server.state
    for f in ("ptr", "owner", "valid", "stamp", "clock", "valid_g"):
        if not torch.equal(getattr(sv, f), getattr(ss, f)):
            raise AssertionError(f"ring field {f} differs between vec and seq")
    if vec.ledger.by_round != seq.ledger.by_round:
        raise AssertionError("ledgers differ between vec and seq")
    for hv, hs in zip(vec.history, seq.history):
        d = max(abs(a - b) for a, b in zip(hv["accs"], hs["accs"]))
        if d > 2e-2:
            raise AssertionError(f"round {hv['round']}: vec and seq accuracies "
                                 f"differ by {d}")
    d_obs = float((sv.obs - ss.obs).abs().max())
    d_gp = float((sv.global_protos - ss.global_protos).abs().max())
    print(f"[vec] vec vs seq on the card: ring and ledger equal; accs vec "
          f"{vec.history[-1]['accs']} seq {seq.history[-1]['accs']}; max |obs| "
          f"diff {d_obs:.3e}, max |global_protos| diff {d_gp:.3e}")
    return vec, launches, secs


def no_sync(vec):
    """Wraps every device step of the vec trainer (its round step, or each
    bucket's step, the shared relay commit and the history push of a mixed
    fleet) so that a
    host sync inside one raises (CUDA sync-debug mode "error"); -> a
    function that unwraps them."""
    owners = ([(b, "step") for b in vec.buckets]
              + [(vec, "_relay_commit"), (vec, "_hist_push")]
              if vec.hetero else [(vec, "_round_step")])
    if vec._cohort is not None:             # a streaming fleet's evictions
        owners.append((vec, "_evict"))
    if vec.hetero and vec._telem:           # a mixed fleet's telemetry call
        owners.append((vec, "_telem_fn"))
    saved = [(o, a, getattr(o, a)) for o, a in owners]

    def wrap(step):
        def no_sync_step(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return step(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return no_sync_step

    for o, a, step in saved:
        setattr(o, a, wrap(step))
    return lambda: [setattr(o, a, step) for o, a, step in saved]


def timed_rounds(trainer, tag, after_round=None, rounds=ROUNDS):
    """`rounds` rounds with the launch counts set to 0 just before and read
    just after -> (launches (fwd, bwd, proto), seconds per round);
    `after_round()`, when given, is called after each round, outside the
    timing."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    secs = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        rec = trainer.run_round()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        for m in rec["metrics"]:
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"{tag}: non-finite metrics {m}")
        if after_round is not None:
            after_round()
    n = dict(ops.LAUNCHES)
    if n["flash_attention"]:
        raise AssertionError(f"{tag}: flash_attention launched")
    return (n["disc_loss_fwd"], n["disc_loss_bwd"], n["proto_accum"]), secs


def same_ring(a, b, what):
    """Ring integers (and ages; a sharded state's per-shard ones and its
    merge count) of two relay states equal."""
    for f in (RING_INTS + (("age",) if hasattr(a, "age") else ())
              + (("merges",) if hasattr(a, "merges") else ())):
        if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()):
            raise AssertionError(f"{what}: ring field {f} differs")


def same_accs(ha, hb, what):
    for ra, rb in zip(ha, hb):
        d = max(abs(p - q) for p, q in zip(ra["accs"], rb["accs"]))
        if d > 2e-2:
            raise AssertionError(f"{what}, round {ra['round']}: accuracies "
                                 f"differ by {d}")


def phase_baselines(dev):
    """The paper's Table 1 baselines and the relay policies (PATHS), each in
    both engines on the card and in seq on the CPU. -> {path: {"seq":
    launches, "vec": launches, "seq_s": [...], "vec_s": [...]}}."""
    from repro_torch.collab_image_classification import build_trainer
    out = {}
    for name, mode, policy, n, (want_seq, want_vec) in PATHS:
        mk = lambda device, engine: build_trainer(
            n, mode, seed=0, device=device, engine=engine,
            relay_policy=policy)
        seq = mk(dev, "seq")
        l_seq, s_seq = timed_rounds(seq, f"{name} seq")
        vec = mk(dev, "vec")
        restore = no_sync(vec)
        l_vec, s_vec = timed_rounds(vec, f"{name} vec")
        restore()
        print(f"[baselines] {name}: launches (disc fwd, bwd, proto_accum) "
              f"seq {l_seq} vec {l_vec}; s/round seq {s_seq} vec {s_vec}; no "
              f"host sync inside the vec round step")
        if l_seq != want_seq or l_vec != want_vec:
            raise AssertionError(f"{name}: launches seq {l_seq} vec {l_vec} "
                                 f"!= {want_seq} {want_vec}")
        cpu = mk("cpu", "seq")
        cpu.run(ROUNDS)
        sv, ss, sc = vec.relay_state, seq.server.state, cpu.server.state
        same_ring(sv, ss, f"{name}: vec and seq on the card")
        same_ring(ss, sc, f"{name}: seq on the card and on the CPU")
        if not vec.ledger.by_round == seq.ledger.by_round == cpu.ledger.by_round:
            raise AssertionError(f"{name}: ledgers differ")
        same_accs(vec.history, seq.history, f"{name}: vec and seq")
        same_accs(seq.history, cpu.history, f"{name}: card and CPU")
        d_ml = float((sv.mean_logits - ss.mean_logits).abs().max())
        if mode == "fd":
            for st in (sv, ss):
                if not (bool(torch.isfinite(st.mean_logits).all())
                        and float(st.mean_logits.abs().max()) > 0):
                    raise AssertionError(f"{name}: mean logits not finite "
                                         f"or still zero")
            if not d_ml <= 1e-3:
                raise AssertionError(f"{name}: mean logits of vec and seq "
                                     f"differ by {d_ml:.3e}")
        print(f"[baselines] {name}: ring{' and ages' if hasattr(sv, 'age') else ''}"
              f" and ledger equal (vec = seq on the card = seq on the CPU); "
              f"accs vec {vec.history[-1]['accs']} seq "
              f"{seq.history[-1]['accs']} cpu {cpu.history[-1]['accs']}; max "
              f"|mean_logits| vec - seq {d_ml:.3e}; comm "
              f"{seq.ledger.total_bytes / 1e6:.3f} MB")
        out[name] = {"seq": l_seq, "vec": l_vec, "seq_s": s_seq,
                     "vec_s": s_vec}
        del seq, vec, cpu
    return out


def same_records(a, b, what):
    """Participants and commits of two trainers' histories equal, round by
    round."""
    for ra, rb in zip(a.history, b.history):
        if (ra["participants"], ra["commits"]) != (rb["participants"],
                                                   rb["commits"]):
            raise AssertionError(f"{what}, round {ra['round']}: participants"
                                 f" {ra['participants']} / "
                                 f"{rb['participants']}")


def phase_participation(dev):
    """Phase 5d's schedules and mixed fleets (PARTICIPATION_PATHS), each in
    both engines on the card and in seq on the CPU. -> {path: {"seq":
    launches, "vec": launches, "seq_s": [...], "vec_s": [...]}}."""
    from repro_torch.collab_image_classification import build_trainer
    out = {}
    for name, mode, sched, n, hetero, k_active, want_vec in PARTICIPATION_PATHS:
        mk = lambda device, engine: build_trainer(
            n, mode, seed=0, device=device, engine=engine,
            participation=sched, hetero=hetero)
        seq = mk(dev, "seq")
        l_seq, s_seq = timed_rounds(seq, f"{name} seq")
        vec = mk(dev, "vec")
        if vec.hetero != hetero or (not hetero and vec._k_active != k_active):
            raise AssertionError(f"{name}: hetero {vec.hetero}, k_active "
                                 f"{getattr(vec, '_k_active', None)}")
        restore = no_sync(vec)
        l_vec, s_vec = timed_rounds(vec, f"{name} vec")
        restore()
        cpu = mk("cpu", "seq")
        cpu.run(ROUNDS)
        steps = MIX_STEPS if hetero else STEPS
        present = sum(len(h["participants"]) for h in seq.history)
        want_seq = ((steps * present,) * 2 + (present,) if mode == "cors"
                    else (0, 0, 2 * present))
        print(f"[participation] {name}: participants "
              f"{[h['participants'] for h in seq.history]}; launches (disc "
              f"fwd, bwd, proto_accum) seq {l_seq} vec {l_vec}; s/round seq "
              f"{s_seq} vec {s_vec}; no host sync inside any vec step")
        if l_seq != want_seq or l_vec != want_vec:
            raise AssertionError(f"{name}: launches seq {l_seq} vec {l_vec} "
                                 f"!= {want_seq} {want_vec}")
        same_records(vec, seq, f"{name}: vec and seq")
        same_records(seq, cpu, f"{name}: card and CPU")
        sv, ss, sc = vec.relay_state, seq.server.state, cpu.server.state
        same_ring(sv, ss, f"{name}: vec and seq on the card")
        same_ring(ss, sc, f"{name}: seq on the card and on the CPU")
        if not vec.ledger.by_round == seq.ledger.by_round == cpu.ledger.by_round:
            raise AssertionError(f"{name}: ledgers differ")
        same_accs(vec.history, seq.history, f"{name}: vec and seq")
        same_accs(seq.history, cpu.history, f"{name}: card and CPU")
        print(f"[participation] {name}: participants, ring"
              f"{' and ages' if hasattr(sv, 'age') else ''} and ledger equal "
              f"(vec = seq on the card = seq on the CPU); accs vec "
              f"{vec.history[-1]['accs']} seq {seq.history[-1]['accs']}; comm "
              f"{seq.ledger.total_bytes / 1e6:.3f} MB")
        out[name] = {"seq": l_seq, "vec": l_vec, "seq_s": s_seq,
                     "vec_s": s_vec}
        del seq, vec, cpu
    return out


def phase_compaction(dev):
    """N = 32: cyclic:8 compacted (a (8, ...) block) against the same
    schedule run full width and masked, and against full participation:
    ROUNDS rounds each with launches exact and no host sync, then one
    profiled round. -> {run: {"s": [...], "ops": n, "busy_ms": t, "busy":
    share}}."""
    from repro_torch.collab_image_classification import build_trainer
    want = (STEPS * ROUNDS,) * 2 + (ROUNDS,)
    runs, res = {}, {}
    for tag, sched, masked in (("cyclic:8 compacted", f"cyclic:{COMPACT_K}",
                                False),
                               ("cyclic:8 full width", f"cyclic:{COMPACT_K}",
                                True),
                               ("full participation", "full", False)):
        t = build_trainer(SCALE_CLIENTS, "cors", seed=0, device=dev,
                          engine="vec", n_train=240 * SCALE_CLIENTS,
                          participation=sched)
        if masked:                      # the same schedule, masked, no gather
            t._k_active = t.n_clients
            t._round_step = t._make_round_step()
        restore = no_sync(t)
        launches, secs = timed_rounds(t, tag)
        restore()
        if launches != want:
            raise AssertionError(f"N={SCALE_CLIENTS} {tag}: launches "
                                 f"{launches} != {want}")
        _, n_ops, busy, busy_us = phase_profile(t, f"compaction {tag}", True)
        res[tag] = {"s": secs, "ops": n_ops, "busy_ms": busy_us / 1e3,
                    "busy": busy, "k_active": t._k_active}
        runs[tag] = t
        print(f"[compaction] N={SCALE_CLIENTS} {tag} (k_active "
              f"{t._k_active}): s/round {secs}, profiled round {n_ops} device "
              f"ops, {busy_us / 1e3:.3f} ms busy ({100 * busy:.1f}%)")
    a, b = runs["cyclic:8 compacted"], runs["cyclic:8 full width"]
    same_records(a, b, "cyclic:8 compacted and full width")
    same_ring(a.relay_state, b.relay_state, "cyclic:8 compacted and full width")
    if a.ledger.by_round != b.ledger.by_round:
        raise AssertionError("cyclic:8 compacted and full width: ledgers differ")
    same_accs(a.history, b.history, "cyclic:8 compacted and full width")
    c, f = res["cyclic:8 compacted"], res["cyclic:8 full width"]
    steady = lambda x: sum(x[1:]) / len(x[1:])
    print(f"[compaction] compacted over full width: s/round "
          f"{steady(c['s']) / steady(f['s']):.3f}, device ops "
          f"{c['ops'] / f['ops']:.3f}, busy time "
          f"{c['busy_ms'] / f['busy_ms']:.3f}; ring and ledger equal")
    return res


def in_flight(t):
    """Uploads in flight after a round: the sequential engine's queue, the
    vectorized engine's live pending slots (0 without a pending buffer)."""
    if hasattr(t, "_queue"):
        return len(t._queue)
    return int(t.pending.live.sum()) if t._async else 0


def same_snapshots(a, b, what):
    """The history rings of two trainers (vec's `hist`, seq's `_snaps`)
    equal in their ring integers at every depth, the clamp included."""
    from repro_torch.relay import history
    for d in range(a._h_max + 1):
        snaps = [t._snapshot(d) if hasattr(t, "_snaps")
                 else history.read_at(t.hist, d) for t in (a, b)]
        same_ring(*snaps, f"{what}, snapshot {d} deep")


def phase_fleet_paths(dev, tag, paths, telemetry_dir=None):
    """Each of `paths` (FleetPath) in both engines on the card and in seq on
    the CPU: launches exact, at least one delayed commit (upload clock),
    stale read (download clock), eviction and dropped arrival (arrivals),
    every vec step (and a streaming fleet's evictions) under sync-debug
    mode "error", participants, commits, uploads in flight, cohort views,
    ring integers (ages; per-shard clocks and merges), the history ring and
    the ledger equal vec = seq on the card = seq on the CPU, accuracies
    within 2e-2, fd's mean logits finite. With `telemetry_dir` every trainer
    runs with telemetry, a JSONL sink and a trace there, and
    `check_telemetry` holds them (the first path's also under
    torch.profiler). -> {path: {"seq": launches, "vec": launches, "seq_s":
    [...], "vec_s": [...]}}."""
    from repro_torch import obs
    from repro_torch.collab_image_classification import build_trainer
    out = {}
    for j, p in enumerate(paths):
        files = lambda device, engine: {
            k: os.path.join(telemetry_dir, f"{j}-{engine}-{device}.{k}")
            for k in ("jsonl", "json")}
        mk = lambda device, engine: build_trainer(
            p.n, p.mode, seed=0, device=device, engine=engine,
            relay_policy=p.policy, participation=p.sched, hetero=p.hetero,
            clock=p.clock, download_clock=p.dl, arrivals=p.arrivals,
            telemetry=None if telemetry_dir is None else obs.TelemetryConfig(
                jsonl=files(device, engine)["jsonl"],
                trace=files(device, engine)["json"]))
        flying = {"seq": [], "vec": [], "cpu": []}
        seq = mk(dev, "seq")
        l_seq, s_seq = timed_rounds(
            seq, f"{p.name} seq",
            lambda: flying["seq"].append(in_flight(seq)), p.rounds)
        vec = mk(dev, "vec")
        if (vec.hetero != p.hetero or vec._async != (p.clock is not None)
                or vec._lagged != (p.dl is not None)
                or (not p.hetero and vec._k_active != p.k_active)):
            raise AssertionError(f"{p.name}: hetero {vec.hetero}, async "
                                 f"{vec._async}, lagged {vec._lagged}, "
                                 f"k_active {getattr(vec, '_k_active', None)}")
        restore = no_sync(vec)
        l_vec, s_vec = timed_rounds(
            vec, f"{p.name} vec",
            lambda: flying["vec"].append(in_flight(vec)), p.rounds)
        restore()
        cpu = mk("cpu", "seq")
        timed_rounds(cpu, f"{p.name} cpu",
                     lambda: flying["cpu"].append(in_flight(cpu)), p.rounds)
        steps = MIX_STEPS if p.hetero else STEPS
        present = sum(len(h["participants"]) for h in seq.history)
        want_seq = ((steps * present,) * 2 + (present,) if p.mode == "cors"
                    else (0, 0, 2 * present))
        delayed = [c for h in seq.history for c in h["commits"]
                   if c[0] < h["round"] - 1]
        stale = ([(r, i) for r, h in enumerate(seq.history)
                  for i in h["participants"]
                  if seq.dl_clock.delays(r, p.n)[i] > 0]
                 if p.dl is not None else [])
        cohort = seq._cohort
        evicted = ([(r, cohort.round(r).evicted.tolist())
                    for r in range(p.rounds) if cohort.round(r).evicted.size]
                   if cohort is not None else [])
        sv, ss, sc = vec.relay_state, seq.server.state, cpu.server.state
        print(f"[{tag}] {p.name}: participants "
              f"{[h['participants'] for h in seq.history]}; commits "
              f"{[h['commits'] for h in seq.history]}; delayed {delayed}; "
              f"stale reads (round, client) {stale}; in flight {flying}; "
              f"evictions (round, ids) {evicted}; dropped arrivals "
              f"{cohort.dropped if cohort is not None else 0}; clock "
              f"{sv.clock.tolist()}; launches (disc fwd, bwd, proto_accum) "
              f"seq {l_seq} vec {l_vec}; s/round seq {s_seq} vec {s_vec}; no "
              f"host sync inside any vec step")
        if l_seq != want_seq or l_vec != p.want_vec:
            raise AssertionError(f"{p.name}: launches seq {l_seq} vec "
                                 f"{l_vec} != {want_seq} {p.want_vec}")
        if p.clock is not None and not delayed:
            raise AssertionError(f"{p.name}: no delayed commit")
        if p.dl is not None and not stale:
            raise AssertionError(f"{p.name}: no stale read")
        if cohort is not None:
            if not (evicted and cohort.dropped):
                raise AssertionError(f"{p.name}: no eviction or no dropped "
                                     f"arrival")
            same_cohorts([seq, vec, cpu], p.rounds, p.name)
        if not flying["vec"] == flying["seq"] == flying["cpu"]:
            raise AssertionError(f"{p.name}: uploads in flight differ")
        same_records(vec, seq, f"{p.name}: vec and seq")
        same_records(seq, cpu, f"{p.name}: card and CPU")
        same_ring(sv, ss, f"{p.name}: vec and seq on the card")
        same_ring(ss, sc, f"{p.name}: seq on the card and on the CPU")
        if p.dl is not None:
            same_snapshots(vec, seq, f"{p.name}: vec and seq on the card")
            same_snapshots(seq, cpu, f"{p.name}: seq on the card and the CPU")
        if not vec.ledger.by_round == seq.ledger.by_round == cpu.ledger.by_round:
            raise AssertionError(f"{p.name}: ledgers differ")
        same_accs(vec.history, seq.history, f"{p.name}: vec and seq")
        same_accs(seq.history, cpu.history, f"{p.name}: card and CPU")
        if p.mode == "fd" and not bool(torch.isfinite(sv.mean_logits).all()):
            raise AssertionError(f"{p.name}: mean logits not finite")
        if telemetry_dir is not None:
            check_telemetry(
                p, {"vec": vec, "seq": seq, "cpu": cpu},
                {"vec": files(dev, "vec"), "seq": files(dev, "seq"),
                 "cpu": files("cpu", "seq")},
                len(delayed), len(stale), evicted,
                os.path.join(telemetry_dir, f"{j}-ckpt"), j == 0)
        print(f"[{tag}] {p.name}: participants, commits, uploads in flight, "
              f"{'cohort views, ' if cohort is not None else ''}ring"
              f"{' and ages' if hasattr(sv, 'age') else ''}"
              f"{', merges' if hasattr(sv, 'merges') else ''}"
              f"{', history ring' if p.dl else ''} and ledger equal (vec = "
              f"seq on the card = seq on the CPU); accs vec "
              f"{vec.history[-1]['accs']} seq {seq.history[-1]['accs']}; comm "
              f"{seq.ledger.total_bytes / 1e6:.3f} MB")
        out[p.name] = {"seq": l_seq, "vec": l_vec, "seq_s": s_seq,
                       "vec_s": s_vec}
        del seq, vec, cpu
    return out


def _as_list(v):
    return v if isinstance(v, list) else [v]


def check_telemetry(p, trainers, files, late, stale, evicted, ckpt_dir,
                    profiled):
    """Phase 5g's checks of one path's trainers ({"vec", "seq", "cpu"}):
    the telemetry's integer leaves equal vec = seq on the card = seq on the
    CPU every round and its float leaves within 2e-2 (atol and rtol, the
    reference's assert_telemetry_match); its late commits and stale reads
    those the records show; each JSONL equal to its trainer's history and
    rendered by obs.report; each trace holding its engine's spans (evict
    where the cohort evicted); every client of the vec trainer saved and
    loaded back bit-equal on the card; with `profiled`, one more round of
    each engine on the card under torch.profiler, whose events must hold
    the spans (record_function ranges)."""
    from repro_torch import obs
    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.obs import report
    worst = 0.0
    for e, f in (("vec", "seq"), ("seq", "cpu")):
        for ra, rb in zip(trainers[e].history, trainers[f].history):
            ta, tb = ra["telemetry"], rb["telemetry"]
            for k in obs.metrics.EXACT_LEAVES:
                if ta[k] != tb[k]:
                    raise AssertionError(
                        f"{p.name}, round {ra['round']}: telemetry {k} {e} "
                        f"{ta[k]} != {f} {tb[k]}")
            for k in obs.metrics.FLOAT_LEAVES:
                for x, y in zip(_as_list(ta[k]), _as_list(tb[k])):
                    if not abs(x - y) <= 2e-2 * (1 + abs(y)):
                        raise AssertionError(
                            f"{p.name}, round {ra['round']}: telemetry {k} "
                            f"{e} {x} against {f} {y}")
                    worst = max(worst, abs(x - y))
    tel = [r["telemetry"] for r in trainers["seq"].history]
    got = (sum(sum(t["commit_hist"][1:]) for t in tel),
           sum(t["stale_reads"] for t in tel))
    if got != (late, stale):
        raise AssertionError(f"{p.name}: telemetry's late commits and stale "
                             f"reads {got} != the records' {(late, stale)}")
    for e, t in trainers.items():
        records = obs.read_jsonl(files[e]["jsonl"])
        if records != json.loads(json.dumps(t.history)):
            raise AssertionError(f"{p.name}: {e}'s JSONL differs from its "
                                 f"history")
        if "run report" not in report.render(records):
            raise AssertionError(f"{p.name}: {e}'s report is empty")
        with open(files[e]["json"]) as fh:
            names = {ev["name"] for ev in json.load(fh)["traceEvents"]}
        want = (SEQ_SPANS if e != "vec" else BUCKET_SPANS if t.hetero
                else VEC_SPANS) | ({"evict"} if evicted else set())
        if not want <= names:
            raise AssertionError(f"{p.name}: {e}'s trace lacks spans "
                                 f"{want - names}")
    vec = trainers["vec"]
    n_leaves = 0
    for i in range(vec.n_clients):
        params = vec.client_params(i)
        path = os.path.join(ckpt_dir, f"client{i}.npz")
        save_pytree(path, params, step=len(vec.history))
        back = load_pytree(path, params)
        for k, v in params.items():
            if not (back[k].device == v.device and back[k].dtype == v.dtype
                    and torch.equal(back[k], v)):
                raise AssertionError(f"{p.name}: client {i}'s checkpoint "
                                     f"leaf {k} differs")
            n_leaves += 1
    msg = ""
    if profiled:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        for e, want in (("vec", VEC_SPANS), ("seq", SEQ_SPANS)):
            with prof_ctx(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                trainers[e].run_round()
                torch.cuda.synchronize()
            keys = {ev.key for ev in prof.key_averages()}
            if not want <= keys:
                raise AssertionError(f"{p.name}: the profile of a {e} round "
                                     f"lacks the spans {want - keys}")
        msg = "; a profiled round of each engine holds its spans"
    print(f"[telemetry] {p.name}: telemetry equal vec = seq on the card = seq "
          f"on the CPU (integer leaves exactly, float leaves within "
          f"{worst:.3e}); {got[0]} late commits, {got[1]} stale reads; last "
          f"round vec {tel[-1]}; JSONL = history, report rendered, trace "
          f"spans present; {vec.n_clients} client checkpoints ({n_leaves} "
          f"leaves) bit-equal on the card{msg}")


def phase_telemetry_cost(dev, n, off=None):
    """vec, cors / flat at N = n (240 samples a client): telemetry on
    (metrics only) against off, TELEMETRY_PAIRS timed rounds of each in
    turns (the order alternating, launches exact, no host sync) and the
    median s/round of rounds 2 on; the 4th round of each runs under
    torch.profiler instead (device ops, busy time). `off`, when given, is
    the telemetry-off trainer (phase 5b's, which phase 6 profiles too); the
    on trainer first catches up with its rounds, untimed. -> {"on": {...},
    "off": {...}}."""
    from repro_torch.collab_image_classification import build_trainer
    from repro_torch.kernels import ops
    mk = lambda tel: build_trainer(n, "cors", seed=0, device=dev,
                                   engine="vec", n_train=240 * n,
                                   telemetry=tel)
    runs = {"on": mk(True), "off": off if off is not None else mk(None)}
    for _ in runs["off"].history:
        runs["on"].run_round()
    secs = {tag: [] for tag in runs}
    launches = {tag: (0, 0, 0) for tag in runs}
    profiled = {}
    for r in range(TELEMETRY_PAIRS + 1):
        for tag in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            t = runs[tag]
            if r == ROUNDS:
                _, n_ops, busy, busy_us = phase_profile(
                    t, f"telemetry {tag} N={n}", True)
                profiled[tag] = {"ops": n_ops, "busy_ms": busy_us / 1e3,
                                 "busy": busy}
                continue
            restore = no_sync(t)
            ops.reset_launches()
            t0 = time.perf_counter()
            rec = t.run_round()
            torch.cuda.synchronize()
            secs[tag].append(time.perf_counter() - t0)
            restore()
            if ("telemetry" in rec) != (tag == "on"):
                raise AssertionError(f"telemetry {tag}: record {sorted(rec)}")
            launches[tag] = tuple(
                x + ops.LAUNCHES[k] for x, k in zip(launches[tag], (
                    "disc_loss_fwd", "disc_loss_bwd", "proto_accum")))
    want = (STEPS * TELEMETRY_PAIRS,) * 2 + (TELEMETRY_PAIRS,)
    res = {}
    for tag, t in runs.items():
        if launches[tag] != want:
            raise AssertionError(f"N={n} telemetry {tag}: launches "
                                 f"{launches[tag]} != {want}")
        res[tag] = {"s": secs[tag], "median": statistics.median(secs[tag][1:]),
                    **profiled[tag]}
    a, b = res["on"], res["off"]
    print(f"[telemetry] N={n} vec, telemetry on over off: median s/round of "
          f"rounds 2-{TELEMETRY_PAIRS} {a['median'] / b['median']:.3f} "
          f"({a['median']:.4f} / {b['median']:.4f} s; on slower in "
          f"{sum(x > y for x, y in zip(a['s'][1:], b['s'][1:]))} of "
          f"{TELEMETRY_PAIRS - 1} pairs), device ops {a['ops']} / {b['ops']} "
          f"(+{a['ops'] - b['ops']}, {a['ops'] / b['ops']:.4f}), busy time "
          f"{a['busy_ms']:.3f} / {b['busy_ms']:.3f} ms = "
          f"{a['busy_ms'] / b['busy_ms']:.4f}")
    return res


def phase_async_scale(dev):
    """N = 32 (240 samples a client), vec: cors with the flat relay under
    lognormal:2 against the same fleet synchronous, ASYNC_PAIRS rounds of
    each in turns (the order alternating from round to round, so that host
    drift falls on both), launches exact, no host sync; then one profiled
    round each. -> {run: {"s": [...], "ops": n, "busy_ms": t, "busy":
    share}, "slower_pairs": n}."""
    from repro_torch.collab_image_classification import build_trainer
    from repro_torch.kernels import ops
    runs = {tag: build_trainer(SCALE_CLIENTS, "cors", seed=0, device=dev,
                               engine="vec", n_train=240 * SCALE_CLIENTS,
                               clock=clock)
            for tag, clock in (("lognormal:2", "lognormal:2"),
                               ("synchronous", None))}
    secs = {tag: [] for tag in runs}
    launches = {tag: (0, 0, 0) for tag in runs}
    for r in range(ASYNC_PAIRS):
        for tag in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            t = runs[tag]
            restore = no_sync(t)
            ops.reset_launches()
            t0 = time.perf_counter()
            t.run_round()
            torch.cuda.synchronize()
            secs[tag].append(time.perf_counter() - t0)
            restore()
            n = ops.LAUNCHES
            launches[tag] = tuple(
                x + n[k] for x, k in zip(launches[tag], (
                    "disc_loss_fwd", "disc_loss_bwd", "proto_accum")))
    want = (STEPS * ASYNC_PAIRS,) * 2 + (ASYNC_PAIRS,)
    res = {}
    for tag, t in runs.items():
        if launches[tag] != want:
            raise AssertionError(f"N={SCALE_CLIENTS} {tag}: launches "
                                 f"{launches[tag]} != {want}")
        _, n_ops, busy, busy_us = phase_profile(t, f"async {tag}", True)
        res[tag] = {"s": secs[tag], "ops": n_ops, "busy_ms": busy_us / 1e3,
                    "busy": busy}
        print(f"[async] N={SCALE_CLIENTS} {tag}: s/round {secs[tag]}, "
              f"launches {launches[tag]}, profiled round {n_ops} device ops, "
              f"{busy_us / 1e3:.3f} ms busy ({100 * busy:.1f}%)")
    a, b = res["lognormal:2"], res["synchronous"]
    med = lambda x: statistics.median(x[1:])
    res["slower_pairs"] = sum(x > y for x, y in zip(a["s"][1:], b["s"][1:]))
    print(f"[async] N={SCALE_CLIENTS} asynchronous over synchronous: median "
          f"s/round of rounds 2-{ASYNC_PAIRS} {med(a['s']) / med(b['s']):.3f} "
          f"({med(a['s']):.4f} / {med(b['s']):.4f} s; asynchronous slower in "
          f"{res['slower_pairs']} of {ASYNC_PAIRS - 1} pairs), device ops "
          f"{a['ops'] / b['ops']:.3f}, busy time "
          f"{a['busy_ms'] / b['busy_ms']:.3f}")
    return res


def same_cohorts(trainers, rounds, what):
    """The cohort tables of streaming trainers equal, view by view, with
    their dropped arrivals."""
    a = trainers[0]._cohort
    for t in trainers[1:]:
        for r in range(rounds):
            for x, y in zip(a.round(r), t._cohort.round(r)):
                if not (x.shape == y.shape and (x == y).all()):
                    raise AssertionError(f"{what}: cohort views differ in "
                                         f"round {r + 1}")
        if t._cohort.dropped != a.dropped:
            raise AssertionError(f"{what}: dropped arrivals differ")


def phase_shard_anchor(dev):
    """The compatibility anchor: sharded:flat,1 against flat in vec on the
    card, round by round in turns with cuDNN deterministic, every leaf of
    the ring and every weight bit-equal after ROUNDS rounds."""
    from repro_torch.collab_image_classification import build_trainer
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = [build_trainer(CLIENTS, "cors", seed=0, device=dev,
                              engine="vec", relay_policy=p)
                for p in ("flat", "sharded:flat,1")]
        for _ in range(ROUNDS):
            for t in runs:
                t.run_round()
    finally:
        torch.backends.cudnn.deterministic = prev
    a, b = (t.relay_state for t in runs)
    for f in a._fields:
        if not torch.equal(getattr(a, f), getattr(b, f)[0]):
            raise AssertionError(f"sharded:flat,1 against flat: {f} differs")
    for k, v in runs[0].params.items():
        if not torch.equal(v, runs[1].params[k]):
            raise AssertionError(f"sharded:flat,1 against flat: weight {k} "
                                 f"differs")
    print(f"[population] anchor: sharded:flat,1 and flat in vec, {ROUNDS} "
          f"rounds: every ring leaf ({len(a._fields)}) and every weight "
          f"bit-equal; merges {int(b.merges)}")


def phase_shard_cost(dev):
    """N = 5, vec, cors: sharded:flat,4 against flat, SHARD_PAIRS rounds of
    each in turns (the order alternating from round to round), then one
    profiled round each. -> {policy: {"s": [...], "median": s, "ops": n,
    "busy_ms": t}}."""
    from repro_torch.collab_image_classification import build_trainer
    runs = {p: build_trainer(CLIENTS, "cors", seed=0, device=dev,
                             engine="vec", relay_policy=p)
            for p in ("sharded:flat,4", "flat")}
    secs = {p: [] for p in runs}
    for r in range(SHARD_PAIRS):
        for p in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            t0 = time.perf_counter()
            runs[p].run_round()
            torch.cuda.synchronize()
            secs[p].append(time.perf_counter() - t0)
    res = {}
    for p, t in runs.items():
        _, n_ops, busy, busy_us = phase_profile(t, f"shard cost {p}", True)
        res[p] = {"s": secs[p], "median": statistics.median(secs[p][1:]),
                  "ops": n_ops, "busy_ms": busy_us / 1e3, "busy": busy}
    a, b = res["sharded:flat,4"], res["flat"]
    print(f"[population] N={CLIENTS} vec, sharded:flat,4 over flat: median "
          f"s/round of rounds 2-{SHARD_PAIRS} {a['median'] / b['median']:.3f}"
          f" ({a['median']:.4f} / {b['median']:.4f} s; sharded slower in "
          f"{sum(x > y for x, y in zip(a['s'][1:], b['s'][1:]))} of "
          f"{SHARD_PAIRS - 1} pairs), device ops {a['ops']} / {b['ops']} = "
          f"{a['ops'] / b['ops']:.3f}, busy time {a['busy_ms']:.3f} / "
          f"{b['busy_ms']:.3f} ms = {a['busy_ms'] / b['busy_ms']:.3f}")
    return res


def resident_bytes_formula(S, cap, seats, C, d):
    """The bytes a flat-inner sharded relay and a cohort table hold: per
    shard obs (cap, C, d) f32, valid (cap, C) bool, owner and stamp (cap,)
    int32, ptr and clock int32, global_protos (C, d) f32, valid_g (C,)
    bool, mean_logits (C, C) f32; the merge counter; per seat an int32 id,
    a bool and an int64 last-active round."""
    shard = cap * C * d * 4 + cap * C + 2 * cap * 4 + 2 * 4 + C * d * 4 \
        + C + C * C * 4
    return S * shard + 4 + seats * (4 + 1 + 8)


def phase_population_scale(dev, sync32):
    """Population scale: 32 seats (240 samples a seat) of STREAM_SCALE on
    sharded:flat,4, STREAM_SCALE_ROUNDS rounds in vec (steps and evictions
    under sync-debug mode "error") and in seq on the card: launches exact,
    evictions happen, participants, commits, cohort views, ring, merges and
    ledger equal; the resident bytes (relay state and cohort table) equal
    to the figure from shards, per-shard capacity and seats; one profiled
    vec round against phase 5e's synchronous N = 32 flat fleet (`sync32`);
    the median s/round of rounds 2 on. -> the numbers."""
    from repro_torch.collab_image_classification import build_trainer
    from repro_torch.relay import default_capacity
    R = STREAM_SCALE_ROUNDS
    mk = lambda engine: build_trainer(
        SCALE_CLIENTS, "cors", seed=0, device=dev, engine=engine,
        n_train=240 * SCALE_CLIENTS,
        relay_policy=f"sharded:flat,{SCALE_SHARDS}", arrivals=STREAM_SCALE)
    vec = mk("vec")
    restore = no_sync(vec)
    l_vec, s_vec = timed_rounds(vec, "population scale vec", rounds=R)
    restore()
    seq = mk("seq")
    l_seq, s_seq = timed_rounds(seq, "population scale seq", rounds=R)
    present = sum(len(h["participants"]) for h in seq.history)
    want_vec, want_seq = ((STEPS * R,) * 2 + (R,),
                          (STEPS * present,) * 2 + (present,))
    if l_vec != want_vec or l_seq != want_seq:
        raise AssertionError(f"population scale: launches vec {l_vec} seq "
                             f"{l_seq} != {want_vec} {want_seq}")
    evictions = sum(vec._cohort.round(r).evicted.size for r in range(R))
    if not evictions:
        raise AssertionError("population scale: no eviction")
    same_cohorts([seq, vec], R, "population scale")
    same_records(vec, seq, "population scale: vec and seq")
    same_ring(vec.relay_state, seq.server.state,
              "population scale: vec and seq on the card")
    if vec.ledger.by_round != seq.ledger.by_round:
        raise AssertionError("population scale: ledgers differ")
    same_accs(vec.history, seq.history, "population scale: vec and seq")
    ccfg = vec.ccfg
    cap = default_capacity(ccfg, SCALE_CLIENTS)
    relay_b = sum(t.numel() * t.element_size()
                  for t in _leaves(list(vec.relay_state)))
    table_b = vec._cohort.nbytes()
    want_b = resident_bytes_formula(SCALE_SHARDS, cap, SCALE_CLIENTS,
                                    ccfg.num_classes, ccfg.d_feature)
    if relay_b + table_b != want_b or vec.relay_state.obs.shape[1] != cap:
        raise AssertionError(f"population scale: resident bytes {relay_b} + "
                             f"{table_b} != {want_b}")
    med = lambda x: statistics.median(x[1:])
    res = {"s_vec": s_vec, "s_seq": s_seq, "median_vec": med(s_vec),
           "median_seq": med(s_seq), "relay_bytes": relay_b,
           "table_bytes": table_b, "evictions": int(evictions),
           "dropped": vec._cohort.dropped,
           "participants": [len(h["participants"]) for h in vec.history],
           "max_id": int(max(vec._cohort.round(r).seat_ids.max()
                             for r in range(R)))}
    _, n_ops, busy, busy_us = phase_profile(vec, "population scale profile",
                                            True)
    res.update(ops=n_ops, busy_ms=busy_us / 1e3, busy=busy)
    print(f"[population] N={SCALE_CLIENTS} seats, {STREAM_SCALE}, "
          f"sharded:flat,{SCALE_SHARDS}, {R} rounds: participants "
          f"{res['participants']}, {evictions} evictions, "
          f"{res['dropped']} dropped arrivals, ids up to {res['max_id']}; "
          f"launches vec {l_vec} seq {l_seq}; cohort views, participants, "
          f"commits, ring, merges and ledger equal vec = seq on the card; "
          f"resident bytes {relay_b} (relay: {SCALE_SHARDS} shards x {cap} "
          f"slots) + {table_b} (cohort table: {SCALE_CLIENTS} seats) = "
          f"{want_b}, none sized by the population of 10^6")
    print(f"[population] N={SCALE_CLIENTS} median s/round of rounds 2-{R}: "
          f"vec {res['median_vec']:.4f} s, seq {res['median_seq']:.4f} s; "
          f"profiled vec round {n_ops} device ops, {busy_us / 1e3:.3f} ms "
          f"busy ({100 * busy:.1f}%) against the synchronous flat fleet's "
          f"{sync32['ops']} ops, {sync32['busy_ms']:.3f} ms (phase 5e): "
          f"{n_ops / sync32['ops']:.3f}x the ops, "
          f"{busy_us / 1e3 / sync32['busy_ms']:.3f}x the busy time")
    return res


def phase_profile(engine, tag, batched):
    """One more round under torch.profiler: device busy share, device ops,
    the device time by kernel name, and one kernel symbol a wrapper call for
    the slice's kernels (KERNEL_SYMBOLS). -> (device us a launch by kernel,
    device ops, busy share, busy us)."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    wall, ev, launched, dropped = profile(engine.run_round)
    calls = dict(ops.LAUNCHES)
    busy, port = report_profile(tag, wall, ev, launched, dropped)
    for name in ("disc_loss_fwd", "disc_loss_bwd", "proto_accum"):
        if port.get(name, (0, 0))[0] != calls[name]:
            raise AssertionError(f"{name}: {port.get(name)} kernels for "
                                 f"{calls[name]} wrapper calls")
    total = sum(us for n, us in port.values())
    print(f"[{tag}] one kernel a wrapper call; the port's kernels "
          f"{total / 1e3:.4f} ms of device time a round")
    sfx = "_batched" if batched else ""
    return ({name + sfx: us / n for name, (n, us) in port.items()},
            launched, busy / 1e6 / wall, busy)


def phase_scale(dev, secs_seq5, secs_vec5):
    """s/round of both engines at N = 32 (240 samples each), and the
    vec-over-seq ratio at N = 5 (phases 5 and 5b, steady rounds 2-3) and
    N = 32 (round 2)."""
    from repro_torch.collab_image_classification import build_trainer
    secs = {}
    for engine in ("vec", "seq"):
        t = build_trainer(SCALE_CLIENTS, "cors", seed=0, device=dev,
                          engine=engine, n_train=240 * SCALE_CLIENTS)
        secs[engine] = []
        for _ in range(SCALE_ROUNDS):
            t0 = time.perf_counter()
            rec = t.run_round()
            torch.cuda.synchronize()
            secs[engine].append(time.perf_counter() - t0)
        print(f"[scale] N={SCALE_CLIENTS} {engine}: seconds per round "
              f"{secs[engine]}, acc {rec['acc_mean']:.4f}")
        del t
    steady = lambda x: sum(x[1:]) / len(x[1:])
    r5 = steady(secs_seq5) / steady(secs_vec5)
    r32 = secs["seq"][-1] / secs["vec"][-1]
    print(f"[scale] s/round seq over vec: N={CLIENTS} {r5:.3f}x "
          f"({steady(secs_seq5):.4f} / {steady(secs_vec5):.4f} s), "
          f"N={SCALE_CLIENTS} {r32:.3f}x ({secs['seq'][-1]:.4f} / "
          f"{secs['vec'][-1]:.4f} s)")
    return {"n5": r5, "n32": r32, "secs32": secs}


def mesh_fleet(fleet, hetero, telemetry, dev, mesh=None, n=MESH_CLIENTS):
    """Phase 5h's MLP fleet in the vec engine, the reference mesh script's:
    MESH_SAMPLES samples a client, batch 16, random weights from seed 0;
    `hetero`: hidden width 96 on the ids divisible by 3, 64 elsewhere (5 +
    3 at N = 8)."""
    from repro_torch.collab_image_classification import MLP_SPEC
    from repro_torch.core import vec_collab
    from repro_torch.data import partition, synthetic
    from repro_torch.models import mlp
    from repro_torch.types import CollabConfig, FleetConfig, TrainConfig
    x, y = synthetic.class_images(MESH_SAMPLES * n, seed=0, noise=0.4)
    test = synthetic.class_images(96, seed=9, noise=0.4)
    parts = partition.uniform_split(x, y, n, seed=1)
    g = torch.Generator().manual_seed(0)
    params = [mlp.init_mlp(g, hidden=96 if hetero and i % 3 == 0 else 64,
                           device="cpu") for i in range(n)]
    return vec_collab.VectorizedCollabTrainer(
        [MLP_SPEC] * n, params, parts, test,
        CollabConfig(num_classes=10, d_feature=84, lambda_kd=2.0,
                     lambda_disc=1.0), TrainConfig(batch_size=16), seed=0,
        fleet=FleetConfig(mesh=mesh, **fleet), device=dev,
        telemetry=telemetry or None)


def mesh_run(t, rounds=ROUNDS, guard=False):
    """`rounds` rounds of trainer `t`, its round steps under sync-debug
    "error" with `guard`, the launch and exchange counts set to 0 just
    before and read just after -> dict(records, launches (fwd, bwd,
    proto), exchanges, s a round, relay fields on the host)."""
    from repro_torch.kernels import ops
    from repro_torch.relay import placement
    restore = no_sync(t) if guard else (lambda: None)
    ops.reset_launches()
    placement.reset_exchanges()
    secs = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        rec = t.run_round()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        for m in rec["metrics"]:
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"non-finite metrics {m}")
    restore()
    n = ops.LAUNCHES
    stacks = [b.params for b in t.buckets] if t.hetero else [t.params]
    return {"records": list(t.history[-rounds:]),
            "params": [{k: v.cpu() for k, v in p.items()} for p in stacks],
            "launches": (n["disc_loss_fwd"], n["disc_loss_bwd"],
                         n["proto_accum"]),
            "exchanges": placement.EXCHANGES["exchange"], "secs": secs,
            "relay": {f: getattr(t.relay_state, f).cpu().numpy()
                      for f in RING_INTS + ("obs", "global_protos")}}


def mesh_want(hetero):
    """A rank's launches over ROUNDS rounds on phase 5h's MLP fleets (one
    local step a round): each way and proto_accum, once a stack."""
    return ((2 if hetero else 1) * ROUNDS,) * 3


def bit_equal(a, b, what):
    """Two trainers run alike, one on a one-rank mesh: records, relay
    state, history ring, pending buffer and every client's parameters
    equal bit for bit."""
    from repro_torch.tree import leaves
    if a.history != b.history:
        raise AssertionError(f"{what}: round records differ")
    for tree in ("relay_state", "hist", "pending"):
        for x, y in zip(leaves(getattr(a, tree, None)),
                        leaves(getattr(b, tree, None))):
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: {tree} differs")
    for i in range(a.n_clients):
        pa, pb = a.client_params(i), b.client_params(i)
        if not all(torch.equal(pa[k], pb[k]) for k in pa):
            raise AssertionError(f"{what}: client {i}'s parameters differ")


def float_spread(recs_a, recs_b, relay_a, relay_b):
    """The largest relative difference of any client's metric in any round
    and the largest absolute one of the observations and global
    prototypes, between two runs of one fleet."""
    rel = max(abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-12)
              for ra, rb in zip(recs_a, recs_b)
              for ma, mb in zip(ra["metrics"], rb["metrics"]) for k in mb)
    return {"metrics_rel": rel, "obs": max(
        float(abs(relay_a[f] - relay_b[f]).max())
        for f in ("obs", "global_protos"))}


def mesh_held(got, want, what, tol):
    """A 4-rank run's results against the unsharded engine's (`want`, the
    same fleet and rounds): participants, commits, ledger floats, telemetry
    integers and ring integers exactly; accuracies and telemetry floats
    within 2e-2; metrics, observations and global prototypes within `tol`
    (MESH_TOL, or None: read by the caller). -> float_spread of the two."""
    from repro_torch.obs import metrics as obs_metrics
    for rg, rw in zip(got["records"], want["records"]):
        for k in ("round", "participants", "commits", "comm_up", "comm_down"):
            if rg[k] != rw[k]:
                raise AssertionError(f"{what}: {k} {rg[k]} != {rw[k]}")
        if max(abs(a - b) for a, b in zip(rg["accs"], rw["accs"])) > 2e-2:
            raise AssertionError(f"{what}: accuracies differ")
        if ("telemetry" in rg) != ("telemetry" in rw):
            raise AssertionError(f"{what}: telemetry in one run only")
        for k in obs_metrics.EXACT_LEAVES if "telemetry" in rw else ():
            if rg["telemetry"][k] != rw["telemetry"][k]:
                raise AssertionError(f"{what}: telemetry {k} differs")
        for k in obs_metrics.FLOAT_LEAVES if "telemetry" in rw else ():
            a, b = (torch.tensor(rg["telemetry"][k], dtype=torch.float64),
                    torch.tensor(rw["telemetry"][k], dtype=torch.float64))
            if not torch.allclose(a, b, rtol=2e-2, atol=2e-2):
                raise AssertionError(f"{what}: telemetry {k} {a} vs {b}")
    for f in RING_INTS:
        if not (got["relay"][f] == want["relay"][f]).all():
            raise AssertionError(f"{what}: ring field {f} differs")
    spread = float_spread(got["records"], want["records"], got["relay"],
                          want["relay"])
    if tol is None:
        return spread
    rtol, g_rtol, atol, o_tol, _ = tol
    for rg, rw in zip(got["records"], want["records"]):
        for mg, mw in zip(rg["metrics"], rw["metrics"]):
            for k in mw:
                tol = atol + (g_rtol if k == "grad_norm" else rtol) * abs(mw[k])
                if abs(mg[k] - mw[k]) > tol:
                    raise AssertionError(f"{what}: metric {k} {mg[k]} vs "
                                         f"{mw[k]}")
    if spread["obs"] > o_tol:
        raise AssertionError(f"{what}: observations {spread['obs']:.3e} "
                             f"apart > {o_tol}")
    return spread


def mesh_weights(res, want, what, tol):
    """Every client's weights after the ranks' run (each rank's block of a
    client-sharded stack, in rank order; a whole bucket from rank 0)
    against the unsharded engine's, within `tol` (as mesh_held's); -> the
    largest difference."""
    worst = 0.0
    for j, stack in enumerate(want["params"]):
        for k, w in stack.items():
            blocks = [got["params"][j][k] for got in res]
            full = (blocks[0] if blocks[0].shape[0] == w.shape[0]
                    else torch.cat(blocks))
            worst = max(worst, float((full - w).abs().max()))
    if tol is not None and worst > tol[4]:
        raise AssertionError(f"{what}: weights {worst:.3e} apart > {tol[4]}")
    return worst


class cudnn_enabled:
    """`torch.backends.cudnn.enabled` set to `on` inside the block (TF32
    and every other setting as they were)."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.was = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = self.on

    def __exit__(self, *exc):
        torch.backends.cudnn.enabled = self.was


def grouped_conv_check(stack, block, dev):
    """Clients [0, block)'s LeNet features, and the gradients of their
    squares' sum with respect to both convolutions' weights, computed in
    the whole `stack`'s grouped convolutions (the vec engine's `vmap`)
    and in a stack of those `block` clients alone, on one seeded batch of
    32 images a client: -> {"cudnn on" / "cudnn off": (features' largest
    difference, gradients' relative to their largest entry)}."""
    from repro_torch.data import synthetic
    from repro_torch.models import cnn
    n = next(iter(stack.values())).shape[0]
    x, _ = synthetic.class_images(32 * n, seed=5, noise=0.8)
    x = torch.from_numpy(x).to(dev).reshape(n, 32, *x.shape[1:])
    feats = torch.func.vmap(cnn.features)
    out = {}
    for on in (True, False):
        got = []
        with cudnn_enabled(on):
            for m in (n, block):
                p = {k: v[:m].detach().clone().requires_grad_(True)
                     for k, v in stack.items()}
                s = feats(p, x[:m])[:block]
                g = torch.autograd.grad(s.square().sum(),
                                        [p["conv1"], p["conv2"]])
                got.append((s.detach(), [t[:block] for t in g]))
        (sa, ga), (sb, gb) = got
        out["cudnn on" if on else "cudnn off"] = (
            float((sa - sb).abs().max()),
            max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(ga, gb)))
    return out


def phase_mesh_one_rank(dev, smi):
    """5h-a: one rank over NCCL on cuda:0. Each MESH_PATHS fleet for ROUNDS
    rounds on the mesh and without it, every device step under sync-debug
    "error": records, ring, ledger, commits and parameters bit-equal, the
    same launches, one exchange a round. Then the paper's scenario, N = 32
    LeNet cors/flat, ROUNDS rounds with and without the mesh in turns
    (bit-equal), and one profiled round of each. -> (summary, the unsharded
    runs by path for 5h-b)."""
    import torch.distributed as dist
    from repro_torch import ranks, sharding
    from repro_torch.collab_image_classification import build_trainer
    from repro_torch.relay import placement
    tmp = tempfile.mkdtemp(prefix="mesh-")
    ranks.init(0, 1, "nccl", f"file://{tmp}/rendezvous")
    plain, out = {}, {}
    try:
        mesh = sharding.client_mesh(1)
        # the NCCL communicator comes up here, outside any sync-debug window
        placement.gather(torch.zeros(1, device=dev), mesh)
        for name, fleet, hetero, telem in MESH_PATHS:
            a = mesh_fleet(fleet, hetero, telem, dev, mesh)
            b = mesh_fleet(fleet, hetero, telem, dev)
            ra, rb = mesh_run(a, guard=True), mesh_run(b, guard=True)
            bit_equal(a, b, f"mesh {name}")
            want = mesh_want(hetero)
            if ra["launches"] != want or rb["launches"] != want:
                raise AssertionError(f"mesh {name}: launches {ra['launches']}"
                                     f" / {rb['launches']} != {want}")
            if ra["exchanges"] != ROUNDS or rb["exchanges"] != ROUNDS:
                raise AssertionError(f"mesh {name}: {ra['exchanges']} / "
                                     f"{rb['exchanges']} exchanges in "
                                     f"{ROUNDS} rounds")
            plain[name] = rb
            print(f"[mesh] 1 rank nccl {name}: bit-equal to unsharded, "
                  f"launches {ra['launches']}, {ROUNDS} exchanges, no host "
                  f"sync in the step; s/round {ra['secs']} (unsharded "
                  f"{rb['secs']}) [{smi}]")
        kw = dict(seed=0, device=dev, engine="vec",
                  n_train=240 * SCALE_CLIENTS)
        runs = {"mesh": build_trainer(SCALE_CLIENTS, "cors", mesh=mesh, **kw),
                "unsharded": build_trainer(SCALE_CLIENTS, "cors", **kw)}
        res = {tag: {"secs": [], "launches": (0, 0, 0), "exchanges": 0}
               for tag in runs}
        for r in range(ROUNDS):
            for tag in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                one = mesh_run(runs[tag], rounds=1, guard=True)
                res[tag]["secs"] += one["secs"]
                res[tag]["exchanges"] += one["exchanges"]
                res[tag]["launches"] = tuple(
                    x + y for x, y in zip(res[tag]["launches"],
                                          one["launches"]))
        bit_equal(runs["mesh"], runs["unsharded"], f"mesh {MESH_LENET}")
        # the unsharded engine against the sequential one on this fleet:
        # the spread that the four ranks' is read beside
        seq = build_trainer(SCALE_CLIENTS, "cors", **dict(kw, engine="seq"))
        seq.run(ROUNDS)
        relay_of = lambda st: {f: getattr(st, f).cpu().numpy()
                               for f in RING_INTS + ("obs", "global_protos")}
        vs_seq = float_spread(runs["unsharded"].history[:ROUNDS],
                              seq.history, relay_of(
                                  runs["unsharded"].relay_state),
                              relay_of(seq.server.state))
        vs_seq["weights"] = max(
            float((runs["unsharded"].params[k][i] - c.params[k]).abs().max())
            for i, c in enumerate(seq.clients) for k in c.params)
        same_ring(runs["unsharded"].relay_state, seq.server.state,
                  f"{MESH_LENET} vec against seq")
        print(f"[mesh] {MESH_LENET}: unsharded vec against seq on the card, "
              f"ring equal, metrics at most {vs_seq['metrics_rel']:.3e} "
              f"apart relative, observations {vs_seq['obs']:.3e}, weights "
              f"{vs_seq['weights']:.3e}")
        del seq
        conv = grouped_conv_check(runs["unsharded"].params,
                                  SCALE_CLIENTS // MESH_RANKS, dev)
        print(f"[mesh] grouped convolutions: clients 0-"
              f"{SCALE_CLIENTS // MESH_RANKS - 1}'s LeNet features and "
              f"conv gradients within the {SCALE_CLIENTS}-client stack "
              f"against a {SCALE_CLIENTS // MESH_RANKS}-client stack, "
              + ", ".join(f"{k}: features {a:.3e}, gradients {b:.3e} "
                          f"(relative) apart"
                          for k, (a, b) in conv.items()))
        mlp_check = mlp_stack_check(
            mesh_fleet({}, False, False, dev).params,
            MESH_CLIENTS // MESH_RANKS, dev)
        print(f"[mesh] MLP stack: clients 0-"
              f"{MESH_CLIENTS // MESH_RANKS - 1}'s features and hidden-weight "
              f"gradients within the {MESH_CLIENTS}-client stack against a "
              f"{MESH_CLIENTS // MESH_RANKS}-client stack: features "
              f"{mlp_check['features']:.3e}, gradients "
              f"{mlp_check['gradients']:.3e} (relative) apart; the first "
              f"layer's batched GEMM, slices 0-"
              f"{MESH_CLIENTS // MESH_RANKS - 1} of {MESH_CLIENTS} against "
              f"{MESH_CLIENTS // MESH_RANKS}: {mlp_check['bmm']:.3e} apart "
              f"[{smi}]")
        with cudnn_enabled(False):
            plain[MESH_PINNED] = mesh_run(build_trainer(
                SCALE_CLIENTS, "cors", **kw))
        if (plain[MESH_PINNED]["launches"] != CORS_VEC
                or plain[MESH_PINNED]["exchanges"] != ROUNDS):
            raise AssertionError(f"{MESH_PINNED} unsharded: launches "
                                 f"{plain[MESH_PINNED]['launches']}")
        print(f"[mesh] {MESH_PINNED} unsharded: s/round "
              f"{plain[MESH_PINNED]['secs']} [{smi}]")
        plain[MESH_LENET] = {
            "records": list(runs["unsharded"].history),
            "params": [{k: v.cpu()
                        for k, v in runs["unsharded"].params.items()}],
            "relay": {f: getattr(runs["unsharded"].relay_state, f).cpu()
                      .numpy() for f in RING_INTS + ("obs", "global_protos")}}
        for tag, t in runs.items():
            if res[tag]["launches"] != CORS_VEC or res[tag]["exchanges"] != ROUNDS:
                raise AssertionError(f"mesh {MESH_LENET} {tag}: launches "
                                     f"{res[tag]['launches']}, exchanges "
                                     f"{res[tag]['exchanges']}")
            _, n_ops, busy, busy_us = phase_profile(
                t, f"mesh 1 rank {tag}", True)
            res[tag].update(ops=n_ops, busy=busy, busy_ms=busy_us / 1e3)
            print(f"[mesh] {MESH_LENET} {tag} (1 rank, nccl): s/round "
                  f"{res[tag]['secs']}, {res[tag]['exchanges']} exchanges in "
                  f"{ROUNDS} rounds, profiled round {n_ops} device ops, "
                  f"{busy_us / 1e3:.3f} ms busy ({100 * busy:.1f}%) [{smi}]")
        out = {"ranks": 1, "backend": "nccl", MESH_LENET: res,
               "vec_vs_seq": vs_seq, "grouped_conv": conv,
               "mlp_stack": mlp_check}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return out, plain


def mesh_rank_main(rank, world, out_dir):
    """One of 5h-b's ranks, all on cuda:0 over gloo: the N = 6 guard, each
    MESH_PATHS fleet and the N = 32 LeNet fleet for ROUNDS rounds on its
    block, results pickled to out_dir/rank{rank}.pkl."""
    import pickle
    from repro_torch import sharding
    from repro_torch.collab_image_classification import build_trainer
    torch.set_num_threads(1)
    phase_precision()
    dev = torch.device("cuda", 0)
    mesh = sharding.client_mesh(world)
    res = {}
    try:
        mesh_fleet({}, False, False, dev, mesh, n=6)
    except ValueError as e:
        res["guard"] = str(e)
    for name, fleet, hetero, telem in MESH_PATHS:
        res[name] = mesh_run(mesh_fleet(fleet, hetero, telem, dev, mesh))
    for name, on in ((MESH_LENET, True), (MESH_PINNED, False)):
        with cudnn_enabled(on):
            res[name] = mesh_run(build_trainer(
                SCALE_CLIENTS, "cors", seed=0, device=dev, engine="vec",
                n_train=240 * SCALE_CLIENTS, mesh=mesh))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def phase_mesh_four_ranks(smi, plain, vs_seq):
    """5h-b: four ranks sharing cuda:0 over gloo (NCCL refuses two ranks on
    one device; gloo stages each exchange through host memory), 2 clients a
    rank at N = 8 and 8 at N = 32: every rank's records equal every other
    rank's and the unsharded engine's (`plain`, from 5h-a; the LeNet fleet
    on cuDNN within MESH_SPREAD times `vs_seq`, its spread from the
    sequential engine), each rank's launches for its own stacks, one
    exchange a round, and N = 6 refused. A correctness run: four processes
    on one card are no scaling number."""
    import pickle
    from repro_torch import ranks
    tmp = tempfile.mkdtemp(prefix="mesh-")
    try:
        t0 = time.perf_counter()
        ranks.spawn(mesh_rank_main, MESH_RANKS, "gloo", tmp)
        wall = time.perf_counter() - t0
        res = []
        for r in range(MESH_RANKS):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"ranks": MESH_RANKS, "backend": "gloo", "wall_s": wall}
    for r, got in enumerate(res):
        if "must divide" not in got.get("guard", ""):
            raise AssertionError(f"rank {r}: N=6 on {MESH_RANKS} ranks was "
                                 f"not refused: {got.get('guard')}")
    lenets = ((MESH_LENET, None, False, None), (MESH_PINNED, None, False, None))
    for name, _, hetero, _ in MESH_PATHS + lenets:
        lenet = name in (MESH_LENET, MESH_PINNED)
        tol = None if name == MESH_LENET else MESH_TOL
        want = CORS_VEC if lenet else mesh_want(hetero)
        spread = {"metrics_rel": 0.0, "obs": 0.0}
        for r, got in enumerate(res):
            g = got[name]
            if g["records"] != res[0][name]["records"]:
                raise AssertionError(f"4 ranks {name}: rank {r}'s records "
                                     "differ from rank 0's")
            if g["launches"] != want or g["exchanges"] != ROUNDS:
                raise AssertionError(f"4 ranks {name}: rank {r} launches "
                                     f"{g['launches']} (want {want}), "
                                     f"{g['exchanges']} exchanges")
            one = mesh_held(g, plain[name], f"4 ranks {name}, rank {r}", tol)
            spread = {k: max(v, one[k]) for k, v in spread.items()}
        spread["weights"] = mesh_weights([got[name] for got in res],
                                         plain[name], f"4 ranks {name}", tol)
        if tol is None:
            limit = {k: MESH_SPREAD * vs_seq[k] for k in spread}
            if any(spread[k] > limit[k] for k in spread):
                raise AssertionError(f"4 ranks {name}: spread {spread} from "
                                     f"unsharded beyond {MESH_SPREAD} x the "
                                     f"vec-against-seq spread {vs_seq}")
        out[name] = {"secs": [got[name]["secs"] for got in res],
                     "launches": want, "spread": spread}
        print(f"[mesh] 4 ranks gloo on one card, {name}: every rank's "
              f"records equal and held against unsharded (metrics at most "
              f"{spread['metrics_rel']:.3e} apart relative, observations "
              f"{spread['obs']:.3e}, weights {spread['weights']:.3e}"
              + ("" if tol else f"; within {MESH_SPREAD} x the unsharded "
                 f"engine's from seq")
              + f"); launches a rank {want}, {ROUNDS} exchanges; s/round (a "
              f"correctness run) rank 0 {res[0][name]['secs']} [{smi}]")
    print(f"[mesh] 4 ranks gloo: N=6 refused ('must divide'); {wall:.1f} s "
          f"wall for the spawn and every path [{smi}]")
    return out


def phase_serve(dev):
    """Full-width TinyLlama-1.1B in bf16 through the serving twin."""
    from repro_torch import serve_lm
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    cfg = get_arch("tinyllama-1.1b")
    t0 = time.perf_counter()
    params = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    prompts = serve_lm.make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT)
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"H={cfg.num_heads} G={cfg.num_kv_heads} {cfg.dtype}, {n_par / 1e9:.3f}"
          f" B parameters, set up in {time.perf_counter() - t0:.2f} s")
    with torch.inference_mode():
        serve_lm.serve(params, cfg, prompts, 2)          # warm-up
        ops.reset_launches()
        r = serve_lm.serve(params, cfg, prompts, SERVE_TOKENS)
        launches = dict(ops.LAUNCHES)
    print(f"[serve] launches {launches}")
    want = {"disc_loss_fwd": 0, "disc_loss_bwd": 0, "proto_accum": 0,
            "flash_attention": cfg.num_layers}
    if launches != want:
        raise AssertionError(f"serving launch counts {launches} != {want}")
    if not bool(torch.isfinite(r["logits"]).all()):
        raise AssertionError("non-finite serving logits")
    if r["ids"].shape != (SERVE_BATCH, SERVE_TOKENS):
        raise AssertionError(f"generated ids of shape {tuple(r['ids'].shape)}")
    n = SERVE_BATCH * SERVE_TOKENS
    print(f"[serve] prefill {SERVE_BATCH}x{SERVE_PROMPT} tokens: "
          f"{r['prefill_s'] * 1e3:.2f} ms; decode {SERVE_TOKENS} steps x batch "
          f"{SERVE_BATCH}: {r['decode_s'] * 1e3:.2f} ms "
          f"({r['decode_s'] * 1e3 / SERVE_TOKENS:.3f} ms/step, "
          f"{n / r['decode_s']:.1f} tok/s); ids[0][:8] {r['ids'][0][:8].tolist()}")
    return cfg, params, prompts, launches, r


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def phase_serve_check(dev):
    """Float32 full width: the kernel path against the plain attention, and
    decode against prefill."""
    from repro_torch import serve_lm
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ref
    from repro_torch.models import lm
    from repro_torch.nn import attention
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b"), dtype="float32")
    params = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    toks = torch.as_tensor(serve_lm.make_prompts(cfg, SERVE_BATCH,
                                                 CHECK_PROMPT), device=dev)
    with torch.inference_mode():
        kern = lm.forward(params, cfg, {"tokens": toks},
                          mode="prefill")["logits"][:, -1]
        with attention.prefill_attention(ref.flash_attention):
            plain = lm.forward(params, cfg, {"tokens": toks},
                               mode="prefill")["logits"][:, -1]
        with attention.prefill_attention(bf16_attention):   # must fail
            ctrl = lm.forward(params, cfg, {"tokens": toks},
                              mode="prefill")["logits"][:, -1]
        pre = lm.forward(params, cfg, {"tokens": toks[:, :-1]}, mode="prefill")
        dec = lm.decode_step(params, cfg, {"tokens": toks[:, -1:]},
                             lm.pad_cache_for_decode(cfg, pre["caches"]))
    scale = max(1.0, float(plain.abs().max()))
    e_k = float((kern - plain).abs().max())
    e_d = float((dec["logits"][:, 0] - kern).abs().max())
    e_c = float((ctrl - plain).abs().max())
    print(f"[check] float32 full width, {SERVE_BATCH}x{CHECK_PROMPT} tokens: "
          f"max |kernel path - plain attention| {e_k:.3e}, max |decode - "
          f"prefill| {e_d:.3e} at the last position, max |logit| {scale:.3e} "
          f"(tol {CHECK_TOL} x max(1, |logit|) = {CHECK_TOL * scale:.3e}); "
          f"control, attention in bf16: {e_c:.3e}")
    if not e_c > CHECK_TOL * scale:
        raise AssertionError(f"the float32 check passes bf16 attention: "
                             f"{e_c:.3e} <= {CHECK_TOL} x {scale:.3e}")
    for what, e in (("kernel path vs plain", e_k), ("decode vs prefill", e_d)):
        if not e <= CHECK_TOL * scale:
            raise AssertionError(f"{what}: {e:.3e} > {CHECK_TOL} x {scale:.3e}")
    if not bool(torch.isfinite(kern).all()):
        raise AssertionError("non-finite float32 logits")
    return e_k, e_d, e_c


def bf16_attention(q, k, v, causal=True):
    """Plain attention on bf16 copies of float32 q, k, v, back in float32:
    the control the float32 serving check must reject."""
    from repro_torch.kernels import ref
    return ref.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                               causal=causal).float()


def phase_serve_profile(cfg, params, prompts):
    """One prefill, then 4 decode steps, each under torch.profiler."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    dev = params["final_norm"]["scale"].device
    toks = torch.as_tensor(prompts, device=dev)
    prefill = serve.make_prefill_step(cfg)
    decode = serve.make_decode_step(cfg)
    state = {}
    with torch.inference_mode():
        def run_prefill():
            out = prefill(params, {"tokens": toks})
            state["caches"] = lm.pad_cache_for_decode(cfg, out["caches"], 4)
            state["nxt"] = out["logits"][:, -1].argmax(-1)[:, None]
        wall, ev, launched, dropped = profile(run_prefill)
        busy, port = report_profile("serve profile prefill", wall, ev,
                                    launched, dropped)
        n, us = port["flash_attention"]
        print(f"[serve profile prefill] flash_attention: {us / n:.2f} us per "
              f"launch, {100 * us / busy:.1f}% of the prefill's device time")

        def run_decode():
            nxt = state["nxt"]
            for i in range(4):
                out = decode(params, {"tokens": nxt}, state["caches"],
                             cache_index=toks.shape[1] + i, masked=True)
                nxt = out["logits"][:, -1].argmax(-1)[:, None]
        wall_d, ev_d, launched_d, dropped_d = profile(run_decode)
        busy_d, _ = report_profile("serve profile decode x4", wall_d, ev_d,
                                   launched_d, dropped_d, top=8)
        print(f"[serve profile decode x4] {launched_d / 4:.0f}"
              f" device ops and {wall_d / 4 * 1e3:.2f} ms a step")
    return {"flash_device_us": us / n, "flash_share": us / busy,
            "prefill_busy": busy / 1e6 / wall, "decode_busy": busy_d / 1e6 / wall_d}


def lm_train_batches(vocab, n_clients, batch, seq, steps, seed):
    """`steps` stacked (N, B, S) batches of tokens and labels from the
    synthetic Markov stream, a private slice of it a client."""
    import numpy as np
    from repro_torch.data import synthetic
    n_tok = max(4 * batch * (seq + 1), 20_000)
    stream = synthetic.token_stream(n_clients * n_tok, vocab=vocab,
                                    seed=seed)
    per = [list(synthetic.lm_batches(stream[i * n_tok:(i + 1) * n_tok],
                                     batch, seq, steps, seed=seed + i))
           for i in range(n_clients)]
    return [{k: torch.as_tensor(np.stack([p[s][k] for p in per]))
             for k in ("tokens", "labels")} for s in range(steps)]


def _to(tree, dev):
    from repro_torch.tree import tree_map
    return tree_map(lambda a: a.to(dev), tree)


def lm_stats(cfg, params, batch, n_clients):
    """The round's upload stats of the clients' current models on `batch`,
    through prototypes.accumulate with the client axis (one launch)."""
    from repro_torch.core import prototypes
    from repro_torch.launch import train
    from repro_torch.tree import tree_map
    feats = []
    with torch.no_grad():
        for i in range(n_clients):
            p = tree_map(lambda a: a[i], params)
            f = train._lm_outputs(cfg, p, {k: v[i] for k, v in batch.items()
                                           if k != "labels"})["features"]
            feats.append(f.reshape(-1, f.shape[-1]))
    dev = feats[0].device
    return prototypes.accumulate(
        prototypes.init_state(cfg.vocab_size, cfg.d_feature, dev,
                              clients=n_clients),
        torch.stack(feats), batch["labels"].reshape(n_clients, -1).to(dev))


def add_frames(cfg, batches, batch, gen):
    """An encoder-decoder's train batches get seeded random frames (N,
    batch, encoder_seq, d) in the model's dtype, on `gen`'s device."""
    if cfg.is_encoder_decoder:
        for b in batches:
            b["frames"] = torch.randn(
                LM_CLIENTS, batch, cfg.encoder_seq, cfg.d_model,
                generator=gen, device=gen.device).to(getattr(torch,
                                                             cfg.dtype))
    return batches


def phase_lm_parity(dev):
    """10a: make_train_step (2 clients, cors, 3 steps), then make_round_sync
    over stats from prototypes.accumulate, on the card and on the CPU from
    the same weights, batches and negative ids: the reduced TinyLlama and
    xLSTM, Whisper (8 frames a clip) and the four kinds of phase 13 (Zamba2
    at 2 layers: its shared block once)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.tree import leaves
    from repro_torch.types import CollabConfig
    worst = {}
    for arch in ("tinyllama-1.1b", "xlstm-125m", "whisper-small",
                 *(a for a, _ in FAMILY_TRAIN)):
        cfg = get_arch(arch).reduced()
        ccfg = CollabConfig(mode="cors", num_classes=cfg.vocab_size,
                            d_feature=cfg.d_feature)
        cpu = train.init_state(cfg, torch.Generator().manual_seed(0),
                               LM_CLIENTS, device="cpu")
        gpu = _to(cpu, dev)
        batches = add_frames(cfg, lm_train_batches(
            cfg.vocab_size, LM_CLIENTS, PARITY_BATCH, PARITY_SEQ, LM_STEPS,
            seed=3), PARITY_BATCH, torch.Generator().manual_seed(4))
        gen = torch.Generator().manual_seed(5)
        negs = [train.draw_negatives(gen, cfg, ccfg, LM_CLIENTS)
                for _ in range(LM_STEPS)]
        step = train.make_train_step(cfg, ccfg, n_clients=LM_CLIENTS,
                                     disc_tokens=PARITY_DISC)
        e_met = 0.0
        for s, (b, neg) in enumerate(zip(batches, negs)):
            cpu, mc = step(cpu, b, neg)
            gpu, mg = step(gpu, _to(b, dev), neg.to(dev))
            for k in mc:
                e = abs(float(mg[k]) - float(mc[k]))
                if not e <= PARITY_MET_TOL * max(1.0, abs(float(mc[k]))):
                    raise AssertionError(f"[train parity] {arch} step {s} "
                                         f"{k}: card {float(mg[k])} cpu "
                                         f"{float(mc[k])}")
                e_met = max(e_met, e)
        sync = train.make_round_sync(ccfg)
        cpu = sync(cpu, lm_stats(cfg, cpu.params, batches[-1], LM_CLIENTS))
        gpu = sync(gpu, lm_stats(cfg, gpu.params, _to(batches[-1], dev),
                                 LM_CLIENTS))
        e_par, n_far, n_all = 0.0, 0, 0
        for a, b in zip(leaves((cpu.params, cpu.opt.m)),
                        leaves((gpu.params, gpu.opt.m))):
            d = (b.cpu().float() - a.float()).abs()
            e_par = max(e_par, float(d.max()))
            n_far += int((d > PARITY_PARAM_TOL).sum())
            n_all += d.numel()
        lim = 2 * 1e-3 * LM_STEPS
        if not (e_par <= lim and n_far <= PARITY_PARAM_FRAC * n_all):
            raise AssertionError(f"[train parity] {arch}: parameters differ "
                                 f"by {e_par:.3e} (limit {lim}), {n_far} of "
                                 f"{n_all} beyond {PARITY_PARAM_TOL}")
        if not torch.equal(gpu.proto.count.cpu(), cpu.proto.count):
            raise AssertionError(f"[train parity] {arch}: proto counts differ")
        if not (torch.equal(gpu.opt.step.cpu(), cpu.opt.step)
                and int(gpu.step) == int(cpu.step) == LM_STEPS):
            raise AssertionError(f"[train parity] {arch}: step counts differ")
        e_pro = float((gpu.proto.sum.cpu() - cpu.proto.sum).abs().max())
        scale = max(1.0, float(cpu.proto.sum.abs().max()))
        if not e_pro <= PARITY_PROTO_TOL * scale:
            raise AssertionError(f"[train parity] {arch}: proto sums differ "
                                 f"by {e_pro:.3e} > {PARITY_PROTO_TOL} x "
                                 f"{scale:.3e}")
        worst[arch] = {"metrics": e_met, "params": e_par,
                       "params_beyond_1e-4": n_far / n_all, "proto_sum": e_pro}
        print(f"[train parity] {cfg.name}: {LM_STEPS} cors steps of "
              f"{LM_CLIENTS} clients (B {PARITY_BATCH}, S {PARITY_SEQ}) and a "
              f"round sync, card vs cpu: metrics {e_met:.3e}, parameters and "
              f"moments {e_par:.3e} ({n_far} of {n_all} beyond "
              f"{PARITY_PARAM_TOL}), proto sums {e_pro:.3e} of {scale:.3e}, "
              f"counts and steps equal")
    return worst


def lm_step_flops(cfg, n_clients, B, S, T, K):
    """-> (hardware, model) FLOPs of one train step, from the shapes.
    Hardware FLOPs count what the step runs: dense products 2 x params x
    tokens forward, run twice by the per-layer remat and twice more in the
    backward (8 P T), and attention's two products over all S^2 pairs (the
    plain functions mask, they do not skip) at the same 4x. Model FLOPs
    count 6 P T and the causal half of the pairs at 3x. Both count L_disc's
    teacher logits (T + K) x d' x V and its two products with the student's
    softmax, 3x for the backward."""
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    H, G, hd, ff = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    per_layer = d * H * hd * 2 + d * G * hd * 2 + 3 * d * ff
    dense = 2 * (L * per_layer + d * V) * B * S
    attn = L * 4 * B * S * S * H * hd
    disc = 2 * (T + K) * d * V + 2 * T * V + 2 * T * K * V
    return (n_clients * (4 * (dense + attn) + 3 * disc),
            n_clients * (3 * (dense + attn / 2) + 3 * disc))


def phase_lm_train(dev):
    """10b: full-width TinyLlama-1.1B training steps on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.tree import leaves
    from repro_torch.types import CollabConfig
    cfg = get_arch("tinyllama-1.1b")
    ccfg = CollabConfig(mode="cors", num_classes=cfg.vocab_size,
                        d_feature=cfg.d_feature)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train.init_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             LM_CLIENTS, device=dev)
    n_par = sum(t.numel() for t in leaves(state.params)) // LM_CLIENTS
    head0 = state.params["lm_head"].clone()
    batches = [_to(b, dev) for b in lm_train_batches(
        cfg.vocab_size, LM_CLIENTS, LM_BATCH, LM_SEQ, LM_STEPS + 1, seed=0)]
    gen = torch.Generator(device=dev).manual_seed(1)
    negs = [train.draw_negatives(gen, cfg, ccfg, LM_CLIENTS)
            for _ in range(LM_STEPS + 1)]
    step = train.make_train_step(cfg, ccfg, n_clients=LM_CLIENTS,
                                 disc_tokens=LM_DISC_TOKENS)
    torch.cuda.synchronize()
    print(f"[train] {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"V={cfg.vocab_size} {cfg.dtype}, {n_par / 1e9:.3f} B parameters a "
          f"client, {LM_CLIENTS} clients x batch {LM_BATCH} x {LM_SEQ} tokens, "
          f"set up in {time.perf_counter() - t0:.2f} s")
    ops.reset_launches()
    secs, mets, pod_ref = [], [], []
    for s in range(LM_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batches[s], negs[s])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in m.items()})
        print(f"[train] step {s + 1}: {secs[-1]:.3f} s, {mets[-1]}")
        if s < POD_STEPS:               # phase 15a's reference, untimed
            pod_ref.append(pod_step_reference(state, mets[-1]))
    launches, batched = dict(ops.LAUNCHES), dict(ops.LAUNCHES_BATCHED)
    peak = torch.cuda.max_memory_allocated()
    want = {"disc_loss_fwd": 0, "disc_loss_bwd": 0, "proto_accum": LM_STEPS,
            "flash_attention": 0}
    if launches != want:
        raise AssertionError(f"[train] launch counts {launches} != {want}")
    want = {"disc_loss_fwd": 0, "disc_loss_bwd": 0, "proto_accum": LM_STEPS}
    if batched != want:                 # every launch with the client axis
        raise AssertionError(f"[train] launches with a client axis {batched}"
                             f" != {want}")
    if not all(math.isfinite(v) for m in mets for v in m.values()):
        raise AssertionError(f"[train] non-finite metrics {mets}")
    tokens = LM_CLIENTS * LM_BATCH * LM_SEQ
    if int(state.proto.count.sum()) != LM_STEPS * tokens:
        raise AssertionError(f"[train] proto count {state.proto.count.sum()} "
                             f"!= {LM_STEPS * tokens}")
    moved = float((state.params["lm_head"] - head0).float().abs().max())
    if not (moved > 0 and all(bool(torch.isfinite(t).all())
                              for t in leaves(state.params))):
        raise AssertionError(f"[train] parameters did not move or are not "
                             f"finite (lm_head moved {moved})")
    if peak > LM_MEM_LIMIT:
        raise AssertionError(f"[train] peak memory {peak / 1e9:.1f} GB > "
                             f"{LM_MEM_LIMIT / 1e9:.0f} GB")
    s_step = statistics.median(secs[1:])
    T = min(LM_DISC_TOKENS, LM_BATCH * LM_SEQ)
    flops, model_flops = lm_step_flops(cfg, LM_CLIENTS, LM_BATCH, LM_SEQ, T,
                                       train.num_negatives(cfg, ccfg))
    print(f"[train] launches {launches}, with a client axis {batched}; "
          f"proto count {LM_STEPS} x {tokens}; lm_head moved {moved:.3e}; "
          f"s/step {s_step:.4f} (median of steps 2-{LM_STEPS}), "
          f"{tokens / s_step:.1f} tokens/s, peak memory {peak / 1e9:.2f} GB; "
          f"hardware FLOPs a step (remat and masked pairs) {flops:.3e} -> "
          f"{flops / s_step / 1e12:.1f} TFLOP/s, "
          f"{flops / s_step / BF16_FLOPS:.3f} of bf16 peak; model FLOPs "
          f"(6 P T, causal) {model_flops:.3e} -> "
          f"{model_flops / s_step / BF16_FLOPS:.3f} of bf16 peak")
    wall, ev, launched, dropped = profile(
        lambda: step(state, batches[-1], negs[-1]))
    busy, port = report_profile("train profile", wall, ev, launched,
                                dropped, top=15)
    n_pa, us_pa = port["proto_accum"]
    if n_pa != 1 or "flash_attention" in port:
        raise AssertionError(f"[train profile] port kernels {port}")
    print(f"[train profile] proto_accum {us_pa:.2f} us a launch at "
          f"{LM_PROTO_SHAPE}; {100 * us_pa / busy:.3f}% of the step's device "
          f"time")
    floor = memory_floor(cfg, LM_BATCH, LM_SEQ)
    print(f"[train] peak {peak / 1e9:.2f} GB against the analytic floor "
          f"(launch/roofline.memory_floor_bytes: 12 bytes a parameter, one "
          f"checkpoint a layer, logits, prototypes) {floor / 1e9:.2f} GB: "
          f"{peak / floor:.2f}x; {peak / (LM_CLIENTS * n_par):.1f} bytes a "
          f"parameter of the {LM_CLIENTS} clients")
    return {"s_per_step": s_step, "tokens_per_s": tokens / s_step,
            "peak_bytes": peak, "memory_floor_bytes": floor,
            "hardware_flops": flops,
            "share_of_bf16_peak": flops / s_step / BF16_FLOPS,
            "model_flops": model_flops,
            "model_share_of_bf16_peak": model_flops / s_step / BF16_FLOPS,
            "busy_share": busy / 1e6 / wall, "device_ops": launched,
            "proto_accum_us": us_pa, "launches": launches,
            "launches_batched": batched, "steps_s": secs,
            "pod_ref": pod_ref}


def phase_lm_twin(dev):
    """10c: the collab_lm twin on the card, 2 rounds under an upload and a
    download clock, its JSONL rendered."""
    from repro_torch import collab_lm, obs
    from repro_torch.obs import report
    with tempfile.TemporaryDirectory() as tdir:
        path = os.path.join(tdir, "lm.jsonl")
        t0 = time.perf_counter()
        collab_lm.main(["--rounds", "2", "--clock-model", "lognormal:2",
                        "--download-clock", "periodic:2,3", "--telemetry-out",
                        path, "--device", str(dev)])
        secs = time.perf_counter() - t0
        records = obs.read_jsonl(path)
        text = report.render(records)
    if len(records) != 2 or "run report: 2 rounds" not in text:
        raise AssertionError(f"[lm twin] JSONL of {len(records)} records")
    for r in records:
        if not all(math.isfinite(v) for v in r["ce"].values()):
            raise AssertionError(f"[lm twin] non-finite CE {r['ce']}")
    print(f"[lm twin] 2 rounds on the card in {secs:.2f} s; the JSONL "
          f"renders ({len(text.splitlines())} lines)")
    return secs


def family_depth(cfg, n):
    """cfg cut to n layers, its distinct kinds cycled in order (the xLSTM's
    (mlstm, slstm) at 2), every width kept."""
    kinds = list(dict.fromkeys(cfg.block_pattern))
    return dataclasses.replace(cfg, num_layers=n, block_pattern=tuple(
        kinds[i % len(kinds)] for i in range(n)))


def family_inputs(cfg, B, S, dev, gen, offset=0):
    """A batch for `cfg`: tokens cut from `token_stream` as the serving twin
    cuts its prompts, or, for an embeddings model, seeded random
    embeddings with M-RoPE positions starting at `offset`, shaped by
    `serve.serve_batch_specs`."""
    from repro_torch import serve_lm
    from repro_torch.launch import serve
    from repro_torch.nn import rope
    from repro_torch.types import ShapeConfig
    if cfg.input_kind == "tokens":
        return {"tokens": torch.as_tensor(serve_lm.make_prompts(cfg, B, S),
                                          device=dev)}
    specs = serve.serve_batch_specs(cfg, ShapeConfig("phase 11", S, B,
                                                     "prefill"))
    emb = specs["embeddings"]
    return {"embeddings": torch.randn(emb.shape, generator=gen, device=dev
                                      ).to(emb.dtype),
            "positions": rope.default_positions(B, S, cfg.rope_kind,
                                                offset=offset, device=dev)}


def phase_family_serve(dev, arch, layers, want_flash):
    """One family at its published widths in bf16: serve FAMILY_BATCH x
    FAMILY_PROMPT tokens and FAMILY_TOKENS decode steps (after a warm-up
    of 2), launches asserted, then one prefill under torch.profiler."""
    from repro_torch import serve_lm
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = get_arch(arch)
    if layers:
        cfg = family_depth(cfg, layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_par = sum(t.numel() for t in _leaves(params))
    # tokens fed back, or (Qwen2-VL) seeded embeddings with their M-RoPE
    # positions, drawn before the timed loop
    tokens = cfg.input_kind == "tokens"
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = family_inputs(cfg, FAMILY_BATCH, FAMILY_PROMPT, dev, gen)
    next_batch = serve_lm.greedy_tokens
    if not tokens:
        steps = [family_inputs(cfg, FAMILY_BATCH, 1, dev, gen,
                               offset=FAMILY_PROMPT + i)
                 for i in range(FAMILY_TOKENS)]
        next_batch = lambda i, logits: steps[i]
    run = lambda n: serve_lm.serve(params, cfg, batch, n, next_batch)
    with torch.inference_mode():
        run(2)                                           # warm-up
        ops.reset_launches()
        r = run(FAMILY_TOKENS)
        launches = dict(ops.LAUNCHES)
        prefill = serve.make_prefill_step(cfg)
        wall, ev, launched, dropped = profile(lambda: prefill(params, batch))
    peak = torch.cuda.max_memory_allocated()
    want = {"disc_loss_fwd": 0, "disc_loss_bwd": 0, "proto_accum": 0,
            "flash_attention": want_flash}
    if launches != want:
        raise AssertionError(f"{arch}: launch counts {launches} != {want}")
    if not bool(torch.isfinite(r["logits"]).all()):
        raise AssertionError(f"{arch}: non-finite serving logits")
    if tuple(r["logits"].shape) != (FAMILY_TOKENS + 1, FAMILY_BATCH,
                                    cfg.vocab_size):
        raise AssertionError(f"{arch}: logits of shape {tuple(r['logits'].shape)}")
    if tokens and tuple(r["ids"].shape) != (FAMILY_BATCH, FAMILY_TOKENS):
        raise AssertionError(f"{arch}: generated ids of shape "
                             f"{tuple(r['ids'].shape)}")
    busy, port = report_profile(f"family {arch} prefill profile", wall, ev,
                                launched, dropped, top=6)
    n_f, us_f = port.get("flash_attention", (0, 0.0))
    if n_f != want_flash:
        raise AssertionError(f"{arch}: {n_f} flash kernels in the profiled "
                             f"prefill, not {want_flash}")
    # bf16 at every family's head dims, MLA's split ones too, takes the
    # tensor-core kernel
    flash_names = sorted({flash_name(e.key) for e in ev if flash_name(e.key)})
    if not all(re.search(r"\bflash_attention_bf16_kernel\b", n)
               for n in flash_names):
        raise AssertionError(f"{arch}: the bf16 prefill launched "
                             f"{flash_names}, not the tensor-core kernel only")
    out = {"arch": arch, "layers": cfg.num_layers, "params": n_par,
           "setup_s": setup_s, "prefill_ms": r["prefill_s"] * 1e3,
           "decode_ms_per_step": r["decode_s"] * 1e3 / FAMILY_TOKENS,
           "peak_gb": peak / 1e9, "flash_launches": launches["flash_attention"],
           "flash_us_per_launch": us_f / n_f if n_f else None,
           "flash_kernels": flash_names,
           "flash_share_of_prefill_device_time": us_f / busy,
           "prefill_busy_share": busy / 1e6 / wall}
    print(f"[family] {arch}: {cfg.num_layers}L d={cfg.d_model} {cfg.dtype}, "
          f"{n_par / 1e9:.3f} B parameters, set up in {setup_s:.2f} s; "
          f"prefill {FAMILY_BATCH}x{FAMILY_PROMPT}: {out['prefill_ms']:.2f} ms; "
          f"decode {out['decode_ms_per_step']:.2f} ms/step; peak "
          f"{out['peak_gb']:.2f} GB; flash {launches['flash_attention']} "
          f"launches, {100 * out['flash_share_of_prefill_device_time']:.1f}% "
          f"of the prefill's device time ({', '.join(flash_names) or 'none'})"
          + (f"; ids[0] {r['ids'][0].tolist()}" if tokens else ""))
    del params
    torch.cuda.empty_cache()
    return out


def phase_family_check(dev, arch):
    """One family at full width in float32 at its least depth (2 layers, 6
    for zamba2 so the shared block runs once), MoE at a capacity factor of
    num_experts: the kernel path against plain attention and decode
    against prefill at the last position, each within CHECK_TOL x max(1,
    |logit|); attention in bf16 (where the family has attention) must
    fail it. Recurrent families prefill min(CHECK_PROMPT, ssm_chunk)
    tokens: prefills of S and S - 1 must both divide into SSD chunks."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ref
    from repro_torch.models import lm
    from repro_torch.nn import attention
    cfg = dataclasses.replace(get_arch(arch), dtype="float32")
    cfg = family_depth(cfg, cfg.shared_attn_period or 2)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    recurrent = bool({"mamba", "mlstm"} & set(cfg.block_pattern))
    S = min(CHECK_PROMPT, cfg.ssm_chunk) if recurrent else CHECK_PROMPT
    has_attn = "attn" in cfg.block_pattern or bool(cfg.shared_attn_period)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_lm(gen, cfg, device=dev)
    batch = family_inputs(cfg, SERVE_BATCH, S, dev, gen)
    head = {k: v[:, :-1] for k, v in batch.items()}
    last = {k: v[:, -1:] for k, v in batch.items()}
    run = lambda b: lm.forward(params, cfg, b, mode="prefill")
    with torch.inference_mode():
        kern = run(batch)["logits"][:, -1]
        with attention.prefill_attention(ref.flash_attention):
            plain = run(batch)["logits"][:, -1]
        ctrl = None
        if has_attn:
            with attention.prefill_attention(bf16_attention):  # must fail
                ctrl = run(batch)["logits"][:, -1]
        dec = lm.decode_step(params, cfg, last, lm.pad_cache_for_decode(
            cfg, run(head)["caches"]))["logits"][:, 0]
    scale = max(1.0, float(plain.abs().max()))
    e_k = float((kern - plain).abs().max())
    e_d = float((dec - kern).abs().max())
    e_c = None if ctrl is None else float((ctrl - plain).abs().max())
    print(f"[family check] {arch} float32 {cfg.num_layers}L "
          f"{SERVE_BATCH}x{S}: max |kernel path - plain| {e_k:.3e}, max "
          f"|decode - prefill| {e_d:.3e}, max |logit| {scale:.3e} (tol "
          f"{CHECK_TOL * scale:.3e}); control, attention in bf16: "
          + ("no attention layer" if e_c is None else f"{e_c:.3e}"))
    if e_c is not None and not e_c > CHECK_TOL * scale:
        raise AssertionError(f"{arch}: the float32 check passes bf16 "
                             f"attention: {e_c:.3e} <= {CHECK_TOL} x {scale:.3e}")
    for what, e in (("kernel path vs plain", e_k), ("decode vs prefill", e_d)):
        if not e <= CHECK_TOL * scale:
            raise AssertionError(f"{arch}: {what}: {e:.3e} > {CHECK_TOL} x "
                                 f"{scale:.3e}")
    if not bool(torch.isfinite(kern).all()):
        raise AssertionError(f"{arch}: non-finite float32 logits")
    del params
    torch.cuda.empty_cache()
    return {"kernel_vs_plain": e_k, "decode_vs_prefill": e_d,
            "bf16_attention_control": e_c, "max_logit": scale,
            "layers": cfg.num_layers, "prompt": S}


def phase_families(dev):
    """Phase 11: each family served in bf16, then its float32 check."""
    serve_rows, checks = [], {}
    for arch, layers, want in FAMILIES:
        serve_rows.append(phase_family_serve(dev, arch, layers, want))
    for arch, _, _ in FAMILIES:
        checks[arch] = phase_family_check(dev, arch)
    return serve_rows, checks


def whisper_inputs(cfg, B, S, dev, gen):
    """Whisper's prefill batch: B prompts of S tokens cut from
    `token_stream` as the serving twin cuts them, and B x encoder_seq
    seeded random frames in the model's dtype (the reference's stubbed
    audio frontend), shaped by `serve.serve_batch_specs`."""
    from repro_torch import serve_lm
    from repro_torch.launch import serve
    from repro_torch.types import ShapeConfig
    frames = serve.serve_batch_specs(cfg, ShapeConfig("phase 12", S, B,
                                                      "prefill"))["frames"]
    return {"tokens": torch.as_tensor(serve_lm.make_prompts(cfg, B, S),
                                      device=dev),
            "frames": torch.randn(frames.shape, generator=gen, device=dev
                                  ).to(frames.dtype)}


def phase_whisper_serve(dev):
    """Phase 12: Whisper-small at its published widths in bf16 through
    `serve_lm.serve` on a frames batch (after a warm-up of 2 tokens), then
    one prefill and one decode step counted alone, one prefill and 4 decode
    steps under torch.profiler."""
    from repro_torch import serve_lm
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import encdec
    cfg = get_arch("whisper-small")
    L, S = cfg.num_layers, WHISPER_PROMPT
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = encdec.init_encdec(gen, cfg, device=dev)
    batch = whisper_inputs(cfg, WHISPER_BATCH, S, dev, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_par = sum(t.numel() for t in _leaves(params))
    prefill, decode = serve.make_prefill_step(cfg), serve.make_decode_step(cfg)
    with torch.inference_mode():
        serve_lm.serve(params, cfg, batch, 2)            # warm-up
        ops.reset_launches()
        r = serve_lm.serve(params, cfg, batch, WHISPER_TOKENS)
        launches = dict(ops.LAUNCHES)
        ops.reset_launches()
        out = prefill(params, batch)
        n_prefill = ops.LAUNCHES["flash_attention"]
        caches = encdec.pad_cache_for_decode(out["caches"], 4)
        first = out["logits"][:, -1].argmax(-1)[:, None]
        ops.reset_launches()
        decode(params, {"tokens": first}, caches, cache_index=S, masked=True)
        n_decode = ops.LAUNCHES["flash_attention"]
        wall, ev, launched, dropped = profile(lambda: prefill(params, batch))

        def run_decode():
            nxt = first
            for i in range(4):
                o = decode(params, {"tokens": nxt}, caches, cache_index=S + i,
                           masked=True)
                nxt = o["logits"][:, -1].argmax(-1)[:, None]
        wall_d, ev_d, launched_d, dropped_d = profile(run_decode)
    peak = torch.cuda.max_memory_allocated()
    want = {"disc_loss_fwd": 0, "disc_loss_bwd": 0, "proto_accum": 0,
            "flash_attention": 3 * L + L * WHISPER_TOKENS}
    if launches != want:
        raise AssertionError(f"[whisper] launch counts {launches} != {want}")
    if (n_prefill, n_decode) != (3 * L, L):
        raise AssertionError(f"[whisper] flash launches: {n_prefill} a "
                             f"prefill, {n_decode} a decode step; not "
                             f"{3 * L} and {L}")
    if not bool(torch.isfinite(r["logits"]).all()):
        raise AssertionError("[whisper] non-finite serving logits")
    if tuple(r["ids"].shape) != (WHISPER_BATCH, WHISPER_TOKENS):
        raise AssertionError(f"[whisper] generated ids of shape "
                             f"{tuple(r['ids'].shape)}")
    busy, port = report_profile("whisper prefill profile", wall, ev,
                                launched, dropped, top=8)
    busy_d, port_d = report_profile("whisper decode x4 profile", wall_d,
                                    ev_d, launched_d, dropped_d, top=8)
    n_f, us_f = port.get("flash_attention", (0, 0.0))
    n_fd, us_fd = port_d.get("flash_attention", (0, 0.0))
    if (n_f, n_fd) != (3 * L, 4 * L):
        raise AssertionError(f"[whisper] flash kernels in the profiles: "
                             f"{n_f} and {n_fd}, not {3 * L} and {4 * L}")
    n_tok = WHISPER_BATCH * WHISPER_TOKENS
    res = {"layers": f"{cfg.num_encoder_layers}+{L}", "params": n_par,
           "setup_s": setup_s, "prefill_ms": r["prefill_s"] * 1e3,
           "decode_ms_per_step": r["decode_s"] * 1e3 / WHISPER_TOKENS,
           "decode_tokens_per_s": n_tok / r["decode_s"],
           "peak_gb": peak / 1e9, "flash_launches": launches[
               "flash_attention"], "flash_per_prefill": n_prefill,
           "flash_per_decode_step": n_decode,
           "flash_us_per_prefill_launch": us_f / n_f,
           "flash_share_of_prefill_device_time": us_f / busy,
           "prefill_busy_share": busy / 1e6 / wall,
           "prefill_device_ops": launched,
           "flash_us_per_decode_launch": us_fd / n_fd,
           "flash_share_of_decode_device_time": us_fd / busy_d,
           "decode_busy_share": busy_d / 1e6 / wall_d,
           "decode_device_ops_per_step": launched_d / 4}
    print(f"[whisper] {cfg.name}: {res['layers']}L d={cfg.d_model} "
          f"V={cfg.vocab_size} {cfg.dtype}, {n_par / 1e9:.3f} B parameters, "
          f"set up in {setup_s:.2f} s; prefill {WHISPER_BATCH} x "
          f"({cfg.encoder_seq} frames + {S} tokens): {res['prefill_ms']:.2f}"
          f" ms; decode {WHISPER_TOKENS} steps: "
          f"{res['decode_ms_per_step']:.3f} ms/step "
          f"({res['decode_tokens_per_s']:.1f} tok/s); peak {res['peak_gb']:.2f}"
          f" GB; flash {n_prefill} launches a prefill, {n_decode} a decode "
          f"step ({launches['flash_attention']} in the run), "
          f"{100 * res['flash_share_of_prefill_device_time']:.1f}% of the "
          f"prefill's device time, busy {100 * res['prefill_busy_share']:.1f}"
          f"%, {launched} device ops; decode {100 * res['decode_busy_share']:.1f}"
          f"% busy, {launched_d / 4:.0f} device ops a step; ids[0][:8] "
          f"{r['ids'][0][:8].tolist()}")
    del params, caches
    torch.cuda.empty_cache()
    return res


def phase_whisper_check(dev):
    """Phase 12's float32 check: Whisper-small at its published widths and
    2 + 2 layers, the kernel path against plain attention and one decode
    step against the prefill, within CHECK_TOL x max(1, |logit|);
    attention in bf16 must fail it."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models import encdec
    from repro_torch.nn import attention
    cfg = dataclasses.replace(family_depth(get_arch("whisper-small"), 2),
                              num_encoder_layers=2, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = encdec.init_encdec(gen, cfg, device=dev)
    batch = whisper_inputs(cfg, WHISPER_BATCH, WHISPER_PROMPT, dev, gen)
    prefill, decode = serve.make_prefill_step(cfg), serve.make_decode_step(cfg)
    with torch.inference_mode():
        kern = prefill(params, batch)["logits"][:, -1]
        with attention.prefill_attention(ref.flash_attention):
            plain = prefill(params, batch)["logits"][:, -1]
        with attention.prefill_attention(bf16_attention):     # must fail
            ctrl = prefill(params, batch)["logits"][:, -1]
        head = dict(batch, tokens=batch["tokens"][:, :-1])
        caches = encdec.pad_cache_for_decode(prefill(params, head)["caches"])
        dec = decode(params, {"tokens": batch["tokens"][:, -1:]},
                     caches)["logits"][:, 0]
    scale = max(1.0, float(plain.abs().max()))
    e_k = float((kern - plain).abs().max())
    e_d = float((dec - kern).abs().max())
    e_c = float((ctrl - plain).abs().max())
    print(f"[whisper check] float32 2+2L d={cfg.d_model}, {WHISPER_BATCH} x "
          f"({cfg.encoder_seq} frames + {WHISPER_PROMPT} tokens): max |kernel "
          f"path - plain| {e_k:.3e}, max |decode - prefill| {e_d:.3e}, max "
          f"|logit| {scale:.3e} (tol {CHECK_TOL * scale:.3e}); control, "
          f"attention in bf16: {e_c:.3e}")
    if not e_c > CHECK_TOL * scale:
        raise AssertionError(f"[whisper check] the float32 check passes bf16 "
                             f"attention: {e_c:.3e} <= {CHECK_TOL} x {scale:.3e}")
    for what, e in (("kernel path vs plain", e_k), ("decode vs prefill", e_d)):
        if not e <= CHECK_TOL * scale:
            raise AssertionError(f"[whisper check] {what}: {e:.3e} > "
                                 f"{CHECK_TOL} x {scale:.3e}")
    if not bool(torch.isfinite(kern).all()):
        raise AssertionError("[whisper check] non-finite float32 logits")
    del params
    torch.cuda.empty_cache()
    return {"kernel_vs_plain": e_k, "decode_vs_prefill": e_d,
            "bf16_attention_control": e_c, "max_logit": scale}


def phase_model_train(dev, arch, layers, batch, seq, steps):
    """Phase 13: `arch` at its published widths (cut to `layers` if given)
    trains `steps` cors steps of LM_CLIENTS clients x batch x seq tokens
    (with 1,500 frames a clip for Whisper) on the card: metrics finite,
    parameters moved and finite, proto counts, exactly one proto_accum
    launch a step with the client axis and no flash launch, peak memory
    under LM_MEM_LIMIT, MoE's balance loss finite; then one more step
    under torch.profiler (busy share, device ops, proto_accum's device
    time)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.tree import leaves, tree_map
    from repro_torch.types import CollabConfig
    cfg = get_arch(arch)
    full = cfg.num_layers
    if layers:
        cfg = family_depth(cfg, layers)
    ccfg = CollabConfig(mode="cors", num_classes=cfg.vocab_size,
                        d_feature=cfg.d_feature)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train.init_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             LM_CLIENTS, device=dev)
    n_par = sum(t.numel() for t in leaves(state.params)) // LM_CLIENTS
    head0 = state.params["lm_head"].clone()
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = add_frames(cfg, [_to(b, dev) for b in lm_train_batches(
        cfg.vocab_size, LM_CLIENTS, batch, seq, steps, seed=0)], batch, gen)
    negs = [train.draw_negatives(gen, cfg, ccfg, LM_CLIENTS)
            for _ in range(steps)]
    step = train.make_train_step(cfg, ccfg, n_clients=LM_CLIENTS,
                                 disc_tokens=LM_DISC_TOKENS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cut = (f"{cfg.num_layers} of its {full} layers (cut to fit the "
           f"{LM_MEM_LIMIT / 1e9:.0f} GB gate)" if cfg.num_layers < full
           else f"all {full} layers")
    print(f"[family train] {arch}: {cut}, d={cfg.d_model} V={cfg.vocab_size}"
          f" {cfg.dtype}, {n_par / 1e9:.3f} B parameters a client, "
          f"{LM_CLIENTS} clients x {batch} x {seq} tokens, set up in "
          f"{setup_s:.2f} s")
    ops.reset_launches()
    secs, mets = [], []
    for s in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batches[s], negs[s])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in m.items()})
    launches, batched = dict(ops.LAUNCHES), dict(ops.LAUNCHES_BATCHED)
    peak = torch.cuda.max_memory_allocated()
    want = {"disc_loss_fwd": 0, "disc_loss_bwd": 0, "proto_accum": steps,
            "flash_attention": 0}
    if launches != want or batched["proto_accum"] != steps:
        raise AssertionError(f"[family train] {arch}: launch counts "
                             f"{launches}, with a client axis {batched}; "
                             f"want {want}, all with the client axis")
    if not all(math.isfinite(v) for m in mets for v in m.values()):
        raise AssertionError(f"[family train] {arch}: non-finite metrics "
                             f"{mets}")
    tokens = LM_CLIENTS * batch * seq
    if int(state.proto.count.sum()) != steps * tokens:
        raise AssertionError(f"[family train] {arch}: proto count "
                             f"{int(state.proto.count.sum())} != "
                             f"{steps * tokens}")
    moved = float((state.params["lm_head"] - head0).float().abs().max())
    if not (moved > 0 and all(bool(torch.isfinite(t).all())
                              for t in leaves(state.params))):
        raise AssertionError(f"[family train] {arch}: parameters did not "
                             f"move or are not finite (lm_head moved {moved})")
    if peak > LM_MEM_LIMIT:
        raise AssertionError(f"[family train] {arch}: peak memory "
                             f"{peak / 1e9:.2f} GB > "
                             f"{LM_MEM_LIMIT / 1e9:.0f} GB")
    aux = None
    if cfg.num_experts:              # client 0's balance loss, last batch
        with torch.no_grad():
            aux = float(train._lm_outputs(
                cfg, tree_map(lambda a: a[0], state.params),
                {k: v[0] for k, v in batches[-1].items()})["aux"])
        if not (math.isfinite(aux) and aux > 0):
            raise AssertionError(f"[family train] {arch}: MoE aux {aux}")
    s_step = statistics.median(secs[1:] or secs)
    print(f"[family train] {arch}: launches {launches}, proto count "
          f"{steps} x {tokens}, lm_head moved {moved:.3e}, s/step "
          f"{s_step:.4f} (median of steps 2-{steps}), "
          f"{tokens / s_step:.1f} tokens/s, peak memory {peak / 1e9:.2f} GB"
          + ("" if aux is None else f", MoE aux {aux:.4f}")
          + f"; last metrics {mets[-1]}")
    wall, ev, launched, dropped = profile(
        lambda: step(state, batches[-1], negs[-1]))
    busy, port = report_profile(f"train {arch} profile", wall, ev, launched,
                                dropped, top=8)
    n_pa, us_pa = port.get("proto_accum", (0, 0.0))
    if n_pa != 1 or "flash_attention" in port:
        raise AssertionError(f"[train {arch} profile] port kernels {port}")
    floor = memory_floor(cfg, batch, seq)
    print(f"[family train] {arch}: peak {peak / 1e9:.2f} GB against the "
          f"analytic floor {floor / 1e9:.2f} GB (launch/roofline."
          f"memory_floor_bytes): {peak / floor:.2f}x")
    res = {"arch": arch, "layers": cfg.num_layers, "of_layers": full,
           "params": n_par, "setup_s": setup_s, "s_per_step": s_step,
           "tokens_per_s": tokens / s_step, "peak_gb": peak / 1e9,
           "memory_floor_gb": floor / 1e9,
           "steps_s": secs, "moe_aux": aux, "busy_share": busy / 1e6 / wall,
           "device_ops": launched, "proto_accum_us": us_pa,
           "proto_accum_share": us_pa / busy, "launches": launches,
           "launches_batched": batched, "metrics": mets[-1]}
    print(f"[train {arch} profile] proto_accum {us_pa:.2f} us a launch, "
          f"{100 * us_pa / busy:.3f}% of the step's device time")
    del state, batches
    torch.cuda.empty_cache()
    if cfg.num_layers < full:
        # the cut goes no deeper than the gate forces: one layer more
        # would come within LM_MEM_MARGIN of it, by the peak one layer
        # less gives
        less = one_step_peak(dev, family_depth(get_arch(arch),
                                               cfg.num_layers - 1),
                             ccfg, batch, seq)
        more = 2 * peak - less
        print(f"[family train] {arch}: peak {less / 1e9:.2f} GB at "
              f"{cfg.num_layers - 1} layers, {peak / 1e9:.2f} GB at "
              f"{cfg.num_layers}: {more / 1e9:.2f} GB expected at "
              f"{cfg.num_layers + 1}, within {LM_MEM_MARGIN / 1e9:.1f} GB "
              f"of the {LM_MEM_LIMIT / 1e9:.0f} GB gate or past it")
        if not more > LM_MEM_LIMIT - LM_MEM_MARGIN:
            raise AssertionError(f"[family train] {arch}: "
                                 f"{cfg.num_layers + 1} layers would fit "
                                 f"({more / 1e9:.2f} GB expected)")
        res.update(peak_gb_one_layer_less=less / 1e9,
                   peak_gb_one_layer_more_expected=more / 1e9)
    return res


def one_step_peak(dev, cfg, ccfg, batch, seq):
    """Peak device memory of one cors step of LM_CLIENTS clients x batch x
    seq tokens on `cfg` (seed-0 weights), everything freed after."""
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = train.init_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             LM_CLIENTS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    b = add_frames(cfg, [_to(lm_train_batches(
        cfg.vocab_size, LM_CLIENTS, batch, seq, 1, seed=0)[0], dev)],
        batch, gen)[0]
    step = train.make_train_step(cfg, ccfg, n_clients=LM_CLIENTS,
                                 disc_tokens=LM_DISC_TOKENS)
    state, _ = step(state, b, train.draw_negatives(gen, cfg, ccfg,
                                                   LM_CLIENTS))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del state, b
    torch.cuda.empty_cache()
    return peak


def phase_train_kinds(dev):
    """Phase 13: Whisper-small, then the four kinds of FAMILY_TRAIN."""
    rows = [phase_model_train(dev, "whisper-small", None,
                              WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ,
                              LM_STEPS)]
    for arch, layers in FAMILY_TRAIN:
        rows.append(phase_model_train(dev, arch, layers, FAMILY_TRAIN_BATCH,
                                      FAMILY_TRAIN_SEQ, FAMILY_TRAIN_STEPS))
    return rows


# Phase 14: the LM launch path on a mesh (launch/mesh.py, the LM half of
# sharding.py, the serve and train shardings on DTensor). 14a: one NCCL
# rank, mesh (1, 1) over ("data", "model"), TinyLlama-1.1B at full width
# and MESH_LM_ONE_RANK_LAYERS of 22 layers (cut from 22 to 11 when phase 15
# came and to 4 when phase 16 came, to keep the script's time;
# bit-equality does not depend on depth):
# phase 7's serving (SERVE_BATCH x SERVE_PROMPT, SERVE_TOKENS tokens) and
# phase 10b's training (LM_CLIENTS x LM_BATCH x LM_SEQ, MESH_LM_STEPS steps
# of each strategy) on placed trees, bit-equal to the unsharded path. 14b:
# four gloo ranks sharing the card, mesh (2, 2), full width and
# MESH_LM_LAYERS of 22 layers in float32 (cut from 4 to 2 when phase 16
# came, as 14a, for the script's time; 15b shares it): serving (MESH_LM_PROMPT-token
# prompts, MESH_LM_TOKENS tokens) and one train step of each strategy
# (MESH_LM_CLIENTS x MESH_LM_TRAIN_BATCH x MESH_LM_TRAIN_SEQ) held against the
# unsharded step on the card: logits within CHECK_TOL x max(1, |logit|),
# the step's loss within MESH_LM_LOSS_TOL relative, client 0's gradients
# within MESH_LM_GRAD_TOL x max|g| a leaf, parameters and moments by
# phase 10a's PARITY_PARAM_* rule (one step), proto counts exact; a bf16
# prefill's difference is reported only.
MESH_LM_ARCH = "tinyllama-1.1b"
MESH_LM_STRATEGIES = ("tp", "dp_only", "zero1")
MESH_LM_STEPS = 2
MESH_LM_SHAPE = (2, 2)
MESH_LM_LAYERS = 2
MESH_LM_ONE_RANK_LAYERS = 4
MESH_LM_PROMPT, MESH_LM_TOKENS = 256, 4
# one client (14a holds the two-client loop); its batch divides over the 4
# ranks of (data, model) (dp_only)
MESH_LM_CLIENTS, MESH_LM_TRAIN_BATCH, MESH_LM_TRAIN_SEQ = 1, 4, 128
MESH_LM_LOSS_TOL, MESH_LM_GRAD_TOL = 1e-5, 1e-5


def quiet_redistribute():
    """DTensor warns at every redistribution that a flattened mesh would
    take one collective where it takes two; the mesh here is (2, 2) on
    purpose, and the warning floods the log."""
    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)


def mesh_lm_place_state(cfg, state, mesh, strategy, moe_ep=False):
    from repro_torch import sharding
    from repro_torch.launch import train
    sharding.set_hints(mesh=mesh, moe_ep=moe_ep,
                       moe_dp=strategy in ("dp_only", "zero1"))
    return sharding.place(state, train.state_shardings(
        state, cfg, mesh, state.opt.step.shape[0], strategy=strategy), mesh,
        src_data_rank=None)


def mesh_lm_place_batch(batch, mesh, strategy):
    from repro_torch import sharding
    from repro_torch.launch import train
    return sharding.place(batch, train.batch_shardings(
        batch, mesh, batch["labels"].shape[0], strategy=strategy), mesh,
        src_data_rank=None)


def phase_mesh_lm_one_rank(dev, smi):
    """14a: one NCCL rank, mesh (1, 1): serving and training on placed
    trees bit-equal to the unsharded path, flash and proto_accum launches
    as phases 7 and 10b count them, times beside the unsharded ones."""
    import torch.distributed as dist
    from repro_torch import ranks, serve_lm, sharding
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lmesh, serve, train
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    from repro_torch.types import CollabConfig
    tmp = tempfile.mkdtemp(prefix="mesh-lm-")
    t_phase = time.perf_counter()
    quiet_redistribute()
    ranks.init(0, 1, "nccl", f"file://{tmp}/rendezvous")
    out = {"mesh": "data:1xmodel:1", "backend": "nccl"}
    try:
        mesh = lmesh.device_mesh(lmesh.make_host_mesh())
        cfg = family_depth(get_arch(MESH_LM_ARCH), MESH_LM_ONE_RANK_LAYERS)
        params = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
        placed = sharding.place(params, serve.params_shardings(
            params, cfg, mesh), mesh, src_data_rank=None)
        prompts = serve_lm.make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT)
        runs = {}
        with torch.no_grad():
            for tag, p, m in (("unsharded", params, None),
                              ("mesh", placed, mesh)):
                serve_lm.serve(p, cfg, prompts, 2, mesh=m)     # warm-up
                ops.reset_launches()
                r = serve_lm.serve(p, cfg, prompts, SERVE_TOKENS, mesh=m)
                r["launches"] = dict(ops.LAUNCHES)
                runs[tag] = r
        a, b = runs["mesh"], runs["unsharded"]
        want = {"disc_loss_fwd": 0, "disc_loss_bwd": 0, "proto_accum": 0,
                "flash_attention": cfg.num_layers}
        if a["launches"] != want or b["launches"] != want:
            raise AssertionError(f"[mesh lm] serving launches {a['launches']}"
                                 f" / {b['launches']} != {want}")
        if not (torch.equal(a["logits"], b["logits"])
                and torch.equal(a["ids"], b["ids"])):
            raise AssertionError("[mesh lm] placed serving logits or ids "
                                 "differ from the unsharded path")
        for x, y in zip(leaves(a["caches"]), leaves(b["caches"])):
            if not torch.equal(sharding.full(x), y):
                raise AssertionError("[mesh lm] placed serving caches differ "
                                     "from the unsharded path")
        out["serve"] = {t: {"prefill_ms": r["prefill_s"] * 1e3,
                            "decode_ms_step": r["decode_s"] * 1e3
                            / SERVE_TOKENS} for t, r in runs.items()}
        out["serve"]["flash_launches_a_prefill"] = a["launches"][
            "flash_attention"]
        print(f"[mesh lm] 14a {cfg.name} serving on data:1xmodel:1 (nccl), "
              f"{SERVE_BATCH}x{SERVE_PROMPT} prompts, {SERVE_TOKENS} tokens: "
              f"logits, ids and caches bit-equal to unsharded, "
              f"{cfg.num_layers} flash launches a prefill; prefill "
              f"{a['prefill_s'] * 1e3:.2f} ms (unsharded "
              f"{b['prefill_s'] * 1e3:.2f}), decode "
              f"{a['decode_s'] * 1e3 / SERVE_TOKENS:.3f} ms/step (unsharded "
              f"{b['decode_s'] * 1e3 / SERVE_TOKENS:.3f}) [{smi}]")
        del runs, a, b, placed, params
        torch.cuda.empty_cache()

        ccfg = CollabConfig(mode="cors", num_classes=cfg.vocab_size,
                            d_feature=cfg.d_feature)
        batches = [_to(x, dev) for x in lm_train_batches(
            cfg.vocab_size, LM_CLIENTS, LM_BATCH, LM_SEQ, MESH_LM_STEPS,
            seed=0)]
        gen = torch.Generator(device=dev).manual_seed(1)
        negs = [train.draw_negatives(gen, cfg, ccfg, LM_CLIENTS)
                for _ in range(MESH_LM_STEPS)]
        step = train.make_train_step(cfg, ccfg, n_clients=LM_CLIENTS,
                                     disc_tokens=LM_DISC_TOKENS)

        def run(strategy):
            state = train.init_state(
                cfg, torch.Generator(device=dev).manual_seed(0), LM_CLIENTS,
                device=dev)
            bs = batches
            if strategy:
                state = mesh_lm_place_state(cfg, state, mesh, strategy)
                bs = [mesh_lm_place_batch(x, mesh, strategy) for x in bs]
            ops.reset_launches()
            secs, mets = [], []
            try:
                for x, neg in zip(bs, negs):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = step(state, x, neg)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                    mets.append({k: float(sharding.full(v))
                                 for k, v in m.items()})
            finally:
                sharding.set_hints(mesh=None)
            return (state, mets, secs, dict(ops.LAUNCHES),
                    dict(ops.LAUNCHES_BATCHED))

        state, mets, secs, launches, batched = run(None)
        ref = [t.cpu() for t in leaves(state)]
        ref_mets = mets
        out["train"] = {"unsharded": {"s_per_step": secs}}
        del state
        torch.cuda.empty_cache()
        want = {"disc_loss_fwd": 0, "disc_loss_bwd": 0,
                "proto_accum": MESH_LM_STEPS, "flash_attention": 0}
        for strategy in MESH_LM_STRATEGIES:
            state, mets, s_secs, launches, batched = run(strategy)
            if launches != want or batched["proto_accum"] != MESH_LM_STEPS:
                raise AssertionError(f"[mesh lm] train {strategy}: launches "
                                     f"{launches}, batched {batched}")
            if mets != ref_mets:
                raise AssertionError(f"[mesh lm] train {strategy}: metrics "
                                     f"{mets} != unsharded {ref_mets}")
            for x, y in zip(leaves(state), ref):
                if not torch.equal(sharding.full(x).cpu(), y):
                    raise AssertionError(f"[mesh lm] train {strategy}: the "
                                         "state differs from unsharded")
            out["train"][strategy] = {
                "s_per_step": s_secs,
                "proto_accum_launches_a_step": launches["proto_accum"]
                / MESH_LM_STEPS}
            print(f"[mesh lm] 14a {cfg.name} train {strategy} on "
                  f"data:1xmodel:1 (nccl), {LM_CLIENTS} clients x {LM_BATCH} "
                  f"x {LM_SEQ} tokens, {MESH_LM_STEPS} steps: parameters, "
                  f"moments, proto sums and counts and metrics bit-equal to "
                  f"unsharded, one proto_accum launch a step; s/step "
                  f"{[round(s, 4) for s in s_secs]} (unsharded "
                  f"{[round(s, 4) for s in secs]}) [{smi}]")
            del state
            torch.cuda.empty_cache()
        out["wall_s"] = time.perf_counter() - t_phase
        print(f"[mesh lm] 14a: {out['wall_s']:.1f} s in all")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def mesh_lm_cfg(dtype="float32"):
    from repro_torch.configs import get_arch
    return dataclasses.replace(family_depth(get_arch(MESH_LM_ARCH),
                                            MESH_LM_LAYERS), dtype=dtype)


def mesh_lm_train_inputs(cfg, dev):
    from repro_torch.launch import train
    from repro_torch.types import CollabConfig
    ccfg = CollabConfig(mode="cors", num_classes=cfg.vocab_size,
                        d_feature=cfg.d_feature)
    batch = _to(lm_train_batches(cfg.vocab_size, MESH_LM_CLIENTS,
                                 MESH_LM_TRAIN_BATCH, MESH_LM_TRAIN_SEQ, 1,
                                 seed=0)[0], dev)
    neg = train.draw_negatives(torch.Generator(device=dev).manual_seed(1),
                               cfg, ccfg, MESH_LM_CLIENTS)
    return ccfg, batch, neg


def mesh_lm_grads(cfg, ccfg, state, batch, neg):
    """Client 0's gradients (the step's loss function, before Adam)."""
    from repro_torch.core import prototypes
    from repro_torch.launch import train
    from repro_torch.tree import tree_map
    loss_fn = train.make_loss_fn(cfg, ccfg)
    g, m, _, _ = train.client_grads(
        loss_fn, tree_map(lambda a: a[0], state.params),
        {k: v[0] for k, v in batch.items()}, prototypes.means(state.proto),
        neg[0])
    return g, m


def mesh_lm_reference(dev, path):
    """14b's unsharded runs on the card, saved to `path` (on the CPU)."""
    from repro_torch import serve_lm
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    cfg = mesh_lm_cfg()
    ref = {}
    with torch.no_grad():
        params = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
        prompts = serve_lm.make_prompts(cfg, SERVE_BATCH, MESH_LM_PROMPT)
        r = serve_lm.serve(params, cfg, prompts, MESH_LM_TOKENS)
        ref["logits"], ref["ids"] = r["logits"].cpu(), r["ids"]
        ref["caches"] = [t.cpu() for t in leaves(r["caches"])]
        del params, r
        cfg16 = mesh_lm_cfg("bfloat16")
        p16 = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg16,
                         device=dev)
        ref["bf16_logits"] = lm.forward(p16, cfg16, {"tokens": torch.as_tensor(
            prompts, device=dev)}, mode="prefill")["logits"][:, -1].float(
            ).cpu()
        del p16
    ccfg, batch, neg = mesh_lm_train_inputs(cfg, dev)
    state = train.init_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             MESH_LM_CLIENTS, device=dev)
    g, m = mesh_lm_grads(cfg, ccfg, state, batch, neg)
    ref["grads"] = [t.cpu() for t in leaves(g)]
    step = train.make_train_step(cfg, ccfg, n_clients=MESH_LM_CLIENTS)
    state, met = step(state, batch, neg)
    ref["loss"] = float(met["total"])
    ref["params"] = [t.cpu() for t in leaves((state.params, state.opt.m))]
    ref["proto_count"] = state.proto.count.cpu()
    torch.save(ref, path)
    del state, g
    torch.cuda.empty_cache()


def mesh_lm_local(x, full):
    """A DTensor's local shard (a `Partial` sum reduced first) on the host,
    the same slice of `full` (the whole reference on the host), and
    whether this rank counts the shard once (coordinate 0 on every mesh
    dim that replicates it)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = x.device_mesh
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    if tuple(pl) != tuple(x.placements):
        x = x.redistribute(mesh, pl)
    shape, off = compute_local_shape_and_global_offset(full.shape, mesh, pl)
    own = all(p.is_shard() or mesh.get_local_rank(i) == 0
              for i, p in enumerate(pl))
    return (x.to_local().cpu(),
            full[tuple(slice(o, o + n) for o, n in zip(off, shape))], own)


def mesh_lm_rank_main(rank, world, tmp):
    """One of 14b's ranks, all on cuda:0 over gloo (DTensor's functional
    collectives staged through host memory, `ranks.STAGED`): serving, a
    bf16 prefill and one train step of each strategy on the (2, 2) mesh,
    held by rank 0 against the unsharded runs in tmp/ref.pt; rank 0 writes
    tmp/result.json."""
    import torch.distributed as dist
    from repro_torch import ranks, serve_lm, sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lmesh, serve, train
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    torch.set_num_threads(2)          # 8 host cores, 4 ranks
    quiet_redistribute()
    phase_precision()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ranks.stage_functional_collectives()
    mesh = lmesh.device_mesh(lmesh.MeshShape(("data", "model"),
                                             MESH_LM_SHAPE), "cuda")
    ref = torch.load(os.path.join(tmp, "ref.pt"), mmap=True)
    cfg = mesh_lm_cfg()
    res = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        p = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                       device=dev)
        p = sharding.place(p, serve.params_shardings(p, cfg, mesh), mesh,
                           src_data_rank=None)
        prompts = serve_lm.make_prompts(cfg, SERVE_BATCH, MESH_LM_PROMPT)
        ops.reset_launches()
        r = serve_lm.serve(p, cfg, prompts, MESH_LM_TOKENS, mesh=mesh)
        res["serve_launches"] = dict(ops.LAUNCHES)
        caches = [sharding.full(t).cpu() for t in leaves(r["caches"])]
        d = (r["logits"].cpu() - ref["logits"]).abs()
        res["logits"] = float((d / ref["logits"].abs().clamp(min=1.0)).max())
        res["ids_equal"] = bool(torch.equal(r["ids"], ref["ids"]))
        res["caches"] = max(float((a - b).abs().max())
                            for a, b in zip(caches, ref["caches"]))
        del p, r, caches
        cfg16 = mesh_lm_cfg("bfloat16")
        p16 = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg16,
                         device=dev)
        p16 = sharding.place(p16, serve.params_shardings(p16, cfg16, mesh),
                             mesh, src_data_rank=None)
        tok = {"tokens": torch.as_tensor(prompts, device=dev)}
        tok = sharding.place(tok, serve.batch_shardings(tok, mesh), mesh,
                             src_data_rank=None)
        lg = lm.forward(p16, cfg16, tok, mode="prefill")["logits"]
        lg = sharding.full(lg[:, -1].float()).cpu()
        res["bf16_logits"] = float((lg - ref["bf16_logits"]).abs().max())
        del p16
    ccfg, batch, neg = mesh_lm_train_inputs(cfg, dev)
    step = train.make_train_step(cfg, ccfg, n_clients=MESH_LM_CLIENTS)
    res["train"] = {}
    res["serve_s"] = time.perf_counter() - t0
    for strategy in MESH_LM_STRATEGIES:
        t0 = time.perf_counter()
        state = mesh_lm_place_state(cfg, train.init_state(
            cfg, torch.Generator(device=dev).manual_seed(0), MESH_LM_CLIENTS,
            device=dev), mesh, strategy)
        pb = mesh_lm_place_batch(batch, mesh, strategy)
        try:
            # each rank holds its shards against the same slices of the
            # reference; the maxima and counts are reduced over the ranks
            g, _ = mesh_lm_grads(cfg, ccfg, state, pb, neg)
            e_g = []
            for a, b in zip(leaves(g), ref["grads"]):
                x, r, _ = mesh_lm_local(a, b)
                e_g.append((float((x - r).abs().max()),
                            float(r.abs().max())))
            del g, x
            ops.reset_launches()
            state, met = step(state, pb, neg)
            launches = dict(ops.LAUNCHES)
        finally:
            sharding.set_hints(mesh=None)
        loss = float(sharding.full(met["total"]))
        e_p, n_far, n_all = 0.0, 0, 0
        for a, b in zip(leaves((state.params, state.opt.m)), ref["params"]):
            x, r, own = mesh_lm_local(a, b)
            dd = (x.float() - r.float()).abs()
            e_p = max(e_p, float(dd.max()))
            if own:
                n_far += int((dd > PARITY_PARAM_TOL).sum())
                n_all += dd.numel()
        e_g = torch.tensor(e_g, dtype=torch.float64)
        dist.all_reduce(e_g, op=dist.ReduceOp.MAX)
        ints = torch.tensor([n_far, n_all], dtype=torch.int64)
        dist.all_reduce(ints)
        e_p = torch.tensor([e_p], dtype=torch.float64)
        dist.all_reduce(e_p, op=dist.ReduceOp.MAX)
        count = sharding.full(state.proto.count).cpu()
        res["train"][strategy] = {
            "loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]),
            "grads_rel": float((e_g[:, 0] / e_g[:, 1].clamp(min=1e-30)
                                ).max()),
            "params": float(e_p[0]), "params_far": int(ints[0]),
            "params_n": int(ints[1]),
            "counts_equal": bool(torch.equal(count, ref["proto_count"])),
            "proto_accum_launches": launches["proto_accum"],
            "wall_s": time.perf_counter() - t0}
        del state, pb
        torch.cuda.empty_cache()
    res["staged"] = dict(ranks.STAGED)
    if rank == 0:
        with open(os.path.join(tmp, "result.json"), "w") as f:
            json.dump(res, f)


def phase_mesh_lm_four_ranks(dev, smi):
    """14b: four gloo ranks sharing cuda:0 on the (2, 2) mesh against the
    unsharded runs on the card, by the bounds above."""
    from repro_torch import ranks
    tmp = tempfile.mkdtemp(prefix="mesh-lm-")
    try:
        t0 = time.perf_counter()
        mesh_lm_reference(dev, os.path.join(tmp, "ref.pt"))
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks.spawn(mesh_lm_rank_main, 4, "gloo", tmp)
        wall = time.perf_counter() - t0
        with open(os.path.join(tmp, "result.json")) as f:
            res = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg = mesh_lm_cfg()
    want = {"disc_loss_fwd": 0, "disc_loss_bwd": 0, "proto_accum": 0,
            "flash_attention": cfg.num_layers}
    if res["serve_launches"] != want:
        raise AssertionError(f"[mesh lm] 14b serving launches a rank "
                             f"{res['serve_launches']} != {want}")
    if not (res["logits"] <= CHECK_TOL and res["ids_equal"]):
        raise AssertionError(f"[mesh lm] 14b logits {res['logits']:.3e} "
                             f"relative (limit {CHECK_TOL}), ids equal "
                             f"{res['ids_equal']}")
    lim = 2 * 1e-3
    for strategy, t in res["train"].items():
        ok = (t["loss_rel"] <= MESH_LM_LOSS_TOL
              and t["grads_rel"] <= MESH_LM_GRAD_TOL
              and t["params"] <= lim
              and t["params_far"] <= PARITY_PARAM_FRAC * t["params_n"]
              and t["counts_equal"] and t["proto_accum_launches"] == 1)
        if not ok:
            raise AssertionError(f"[mesh lm] 14b train {strategy}: {t}")
        print(f"[mesh lm] 14b train {strategy} on data:2xmodel:2 (4 gloo "
              f"ranks, one card; {t['wall_s']:.1f} s), {MESH_LM_LAYERS} of "
              f"22 layers, float32: "
              f"loss {t['loss_rel']:.3e} relative, client 0's gradients "
              f"{t['grads_rel']:.3e} of max|g| a leaf, parameters and "
              f"moments {t['params']:.3e} ({t['params_far']} of "
              f"{t['params_n']} beyond {PARITY_PARAM_TOL}), proto counts "
              f"equal, one proto_accum launch a rank")
    print(f"[mesh lm] 14b serving on data:2xmodel:2: logits "
          f"{res['logits']:.3e} relative (limit {CHECK_TOL}), ids equal, "
          f"caches {res['caches']:.3e}, {cfg.num_layers} flash launches a "
          f"rank a prefill; bf16 prefill logits {res['bf16_logits']:.3e} "
          f"from unsharded (reported only); host-staged collectives "
          f"{res['staged']}; {t_ref:.1f} s unsharded, {wall:.1f} s the four "
          f"ranks, serving {res['serve_s']:.1f} s of it [{smi}]")
    res.update(ranks=4, backend="gloo", wall_s=wall, reference_s=t_ref)
    return res


# Phase 15: the LM train step with its client axis split over "pod" (each
# rank trains only its own clients; the prototype merge, or fedavg's
# parameter mean, is the only exchange across pods), ranks sharing the card
# over gloo with DTensor's functional collectives staged, every collective
# counted by mesh axis (`launch/roofline.CollectiveBytes`). 15a: two ranks,
# mesh (2, 1, 1), phase 10b's TinyLlama-1.1B run (full width and depth,
# bf16, 2 clients, one a rank, 2 x 2048 tokens each): POD_STEPS cors steps,
# each rank's client held against 10b's same client by a digest of every
# leaf's bits (parameters and both moments), metrics and proto counts
# equal, proto sums bit-equal or within POD_PROTO_TOL x max(1, |sum|); then
# one step with the merge left to the round and `make_round_sync` on the
# ranks' upload stats. 15b: four ranks, mesh (2, 1, 2), full width and
# MESH_LM_LAYERS layers in float32: POD_CASES against the unsharded
# 2-client steps on the card by phase 14b's bounds (client 0's gradients
# in cors), an absent client's leaves unchanged bit for bit, and the three
# round syncs on client-sharded stats bit-equal (by digest) to the
# unsharded ones. Bytes over "pod" beyond the metric scalars: exactly each
# mode's payload.
POD_STEPS = 2
POD_PROTO_TOL = 1e-6
POD_SAMPLE = 4096          # elements a leaf kept for step 2's bounds
POD_CASES = (("cors", "cors", "tp", False), ("fd", "fd", "tp", False),
             ("fedavg", "fedavg", "tp", False), ("il", "il", "tp", False),
             ("zero1", "cors", "zero1", False), ("absent", "cors", "tp", True))
POD_MASK = (True, False)
POD_D_MAX, POD_H_MAX = 1, 2


def bit_digest(t):
    """Two wrapping int64 sums of a tensor's raw bits, one plain and one
    weighted by position (mod 65521): two leaves with equal digests are
    taken as bit-equal (phase 15 holds a rank's client against an
    unsharded run's, on other processes, without moving the leaves)."""
    x = t.detach().contiguous().reshape(-1)
    b = x.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[x.element_size()]).long()
    w = torch.arange(b.numel(), device=b.device) % 65521 + 1
    return [int(b.sum()), int((b * w).sum())]


def leaf_sample(t):
    x = t.detach().reshape(-1)
    return x[::max(1, x.numel() // POD_SAMPLE)][:POD_SAMPLE].float().cpu()


def pod_step_reference(state, metrics):
    """A step of phase 10b as 15a reads it: each client's digest and sample
    of every parameter and Adam moment, the metrics and the ProtoState (on
    the host)."""
    from repro_torch.tree import leaves
    ls = leaves((state.params, state.opt.m, state.opt.v))
    n = state.opt.step.shape[0]
    return {"digests": [[bit_digest(a[i]) for i in range(n)] for a in ls],
            "samples": [[leaf_sample(a[i]) for i in range(n)] for a in ls],
            "metrics": metrics,
            "proto": (state.proto.sum.cpu(), state.proto.count.cpu())}


def pod_setup(shape):
    """A rank of phase 15: cuda:0 over gloo, the functional collectives
    staged, the ("pod", "data", "model") mesh of `shape`."""
    from repro_torch import ranks
    from repro_torch.launch import mesh as lmesh
    torch.set_num_threads(2)
    quiet_redistribute()
    phase_precision()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ranks.stage_functional_collectives()
    return dev, lmesh.device_mesh(lmesh.MeshShape(("pod", "data", "model"),
                                                  shape), "cuda")


def pod_bytes(cb):
    """(payload over "pod", scalars over "pod", payload over "model") of a
    counter's collectives, in bytes."""
    every, payload = cb.by_axis(), cb.by_axis(2)
    return (payload["pod"]["total"],
            every["pod"]["total"] - payload["pod"]["total"],
            payload["model"]["total"])


def pod_rank_main(rank, world, tmp):
    """One of 15a's two ranks: its client of phase 10b's run, held against
    tmp/ref.pt; writes tmp/result_<rank>.json."""
    from repro_torch import ranks, sharding
    from repro_torch.configs import get_arch
    from repro_torch.core import prototypes
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline, train
    from repro_torch.tree import leaves, tree_map
    from repro_torch.types import CollabConfig
    from torch.distributed.tensor import DTensor
    dev, mesh = pod_setup((2, 1, 1))
    ref = torch.load(os.path.join(tmp, "ref.pt"), mmap=True)
    cfg = get_arch("tinyllama-1.1b")
    ccfg = CollabConfig(mode="cors", num_classes=cfg.vocab_size,
                        d_feature=cfg.d_feature)
    N, C, d = LM_CLIENTS, cfg.vocab_size, cfg.d_feature
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    specs = train.state_shardings(train.init_state_shapes(cfg, N), cfg, mesh,
                                  N)
    pod = mesh.get_local_rank("pod")
    lo, hi = pod * N // 2, (pod + 1) * N // 2
    # this rank builds its own client alone (the other one drawn and
    # dropped), as 10b's whole state would hold it
    state = sharding.place_block(train.init_state(
        cfg, torch.Generator(device=dev).manual_seed(0), N, device=dev,
        clients=(lo, hi)), specs, mesh)
    batches = [sharding.place(b, train.batch_shardings(b, mesh, N), mesh,
                              src_data_rank=None)
               for b in (_to(x, dev) for x in lm_train_batches(
                   cfg.vocab_size, N, LM_BATCH, LM_SEQ, LM_STEPS + 1,
                   seed=0))]
    gen = torch.Generator(device=dev).manual_seed(1)
    negs = [train.draw_negatives(gen, cfg, ccfg, N)
            for _ in range(LM_STEPS + 1)]
    step = train.make_train_step(cfg, ccfg, n_clients=N,
                                 disc_tokens=LM_DISC_TOKENS)
    torch.cuda.synchronize()
    res = {"rank": rank, "clients": [lo, hi], "setup_s":
           time.perf_counter() - t0, "steps": []}
    for s in range(POD_STEPS):
        want = ref["steps"][s]
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with roofline.CollectiveBytes(mesh) as cb:
            state, m = step(state, batches[s], negs[s])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.LAUNCHES["proto_accum"]
        mets = {k: float(sharding.full(v)) for k, v in m.items()}
        ls = leaves((state.params, state.opt.m, state.opt.v))
        equal, far, n_all, e_max = 0, 0, 0, 0.0
        for j, a in enumerate(ls):
            for i in range(lo, hi):
                x = a.to_local()[i - lo]
                if bit_digest(x) == want["digests"][j][i]:
                    equal += 1
                dd = (leaf_sample(x) - want["samples"][j][i]).abs()
                e_max = max(e_max, float(dd.max()))
                far += int((dd > PARITY_PARAM_TOL).sum())
                n_all += dd.numel()
        p_sum, p_cnt = (sharding.full(t).cpu() for t in state.proto)
        w_sum, w_cnt = want["proto"]
        pod_b, scalars, model_b = pod_bytes(cb)
        res["steps"].append({
            "s": secs, "proto_accum_launches": launches,
            "metrics": mets, "metrics_equal": mets == want["metrics"],
            "metrics_rel": max(abs(mets[k] - v) / abs(v)
                               for k, v in want["metrics"].items()),
            "leaves_equal": equal, "leaves": len(ls) * (hi - lo),
            "sample_max": e_max, "sample_far": far, "sample_n": n_all,
            "counts_equal": bool(torch.equal(p_cnt, w_cnt)),
            "sums_equal": bool(torch.equal(p_sum, w_sum)),
            "sums_max": float((p_sum - w_sum).abs().max()),
            "sums_scale": max(1.0, float(w_sum.abs().max())),
            "pod_bytes": pod_b, "pod_scalar_bytes": scalars,
            "model_bytes": model_b})
        del ls, p_sum, w_sum
    # the paper's cadence: the step keeps its stats, the round merges them
    step_r = train.make_train_step(cfg, ccfg, n_clients=N,
                                   disc_tokens=LM_DISC_TOKENS,
                                   sync_in_step=False)
    ops.reset_launches()
    state, _ = step_r(state, batches[POD_STEPS], negs[POD_STEPS])
    blk = sharding.client_block(state.opt.step, N)
    with torch.no_grad(), sharding.hints_restored():
        sharding.set_hints(mesh=blk.sub)
        feats, labels = [], []
        for i in range(lo, hi):
            b = {k: sharding.client_of(v, i, blk)
                 for k, v in batches[POD_STEPS].items()}
            f = train._lm_outputs(cfg, tree_map(
                lambda a: sharding.client_of(a, i, blk), state.params),
                {k: v for k, v in b.items() if k != "labels"})["features"]
            feats.append(sharding.full(f).reshape(-1, d))
            labels.append(sharding.full(b["labels"]).reshape(-1))
        local = prototypes.accumulate(
            prototypes.init_state(C, d, dev, clients=hi - lo),
            torch.stack(feats), torch.stack(labels))
    _, stats_pl = train.round_sync_shardings(mesh, N)
    stats = prototypes.ProtoState(*(DTensor.from_local(
        t, mesh, stats_pl, run_check=False) for t in local))
    with roofline.CollectiveBytes(mesh) as cb:
        state = train.make_round_sync(ccfg)(state, stats)
    count = int(sharding.full(state.proto.count).sum())
    pod_b, scalars, _ = pod_bytes(cb)
    res["fedavg_bytes"] = sum(a.to_local()[0].numel() * 4
                              for a in leaves(state.params))
    res["round"] = {"proto_accum_launches": ops.LAUNCHES["proto_accum"],
                    "count": count, "pod_bytes": pod_b,
                    "pod_scalar_bytes": scalars}
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["staged"] = dict(ranks.STAGED)
    with open(os.path.join(tmp, f"result_{rank}.json"), "w") as f:
        json.dump(res, f)


def phase_pod_two_ranks(dev, smi, ref):
    """15a: two gloo ranks on the card, a client each, against phase 10b."""
    from repro_torch import ranks
    tmp = tempfile.mkdtemp(prefix="pod-lm-")
    try:
        t0 = time.perf_counter()
        torch.save({"steps": ref}, os.path.join(tmp, "ref.pt"))
        del ref
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks.spawn(pod_rank_main, 2, "gloo", tmp)
        wall = time.perf_counter() - t0
        res = []
        for r in range(2):
            with open(os.path.join(tmp, f"result_{r}.json")) as f:
                res.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    from repro_torch.configs import get_arch
    cfg = get_arch("tinyllama-1.1b")
    payload = cfg.vocab_size * (cfg.d_feature + 1) * 4
    tokens = LM_CLIENTS * LM_BATCH * LM_SEQ
    which = []
    for s in range(POD_STEPS):
        rows = [r["steps"][s] for r in res]
        bits = all(t["leaves_equal"] == t["leaves"] for t in rows)
        ok = (all(t["counts_equal"] and t["proto_accum_launches"] == 1
                  and t["pod_bytes"] == payload for t in rows))
        sums_ok = all(t["sums_equal"] or t["sums_max"]
                      <= POD_PROTO_TOL * t["sums_scale"] for t in rows)
        if s == 0:
            # step 1: bit-equal to 10b's unsharded step
            ok = ok and bits and all(t["metrics_equal"] for t in rows)
        else:
            # step 2: bit-equal, or within phase 14b's bounds on the samples
            ok = ok and (bits or all(
                t["metrics_rel"] <= MESH_LM_LOSS_TOL
                and t["sample_max"] <= 2 * 1e-3
                and t["sample_far"] <= PARITY_PARAM_FRAC * t["sample_n"]
                for t in rows))
        if not (ok and sums_ok):
            raise AssertionError(f"[pod] 15a step {s + 1}: {rows}")
        how = ("bit-equal" if bits and all(t["metrics_equal"] for t in rows)
               else "within 14b's bounds (sampled)")
        sums = ("bit-equal" if all(t["sums_equal"] for t in rows) else
                f"within {POD_PROTO_TOL} x max(1, |sum|)")
        which.append({"step": s + 1, "state": how, "proto_sums": sums})
        t = rows[0]
        print(f"[pod] 15a step {s + 1} tinyllama-1.1b on pod:2xdata:1x"
              f"model:1 (2 gloo ranks, one card, a client each, "
              f"{LM_BATCH} x {LM_SEQ} tokens): parameters and moments "
              f"{how} to 10b's unsharded step ({t['leaves_equal']} of "
              f"{t['leaves']} leaf digests equal a rank), metrics "
              f"{'equal' if t['metrics_equal'] else t['metrics_rel']}, "
              f"proto counts equal, sums {sums} (max {t['sums_max']:.3e}); "
              f"over pod {t['pod_bytes']} B (C (d'+1) 4 = {payload}) + "
              f"{t['pod_scalar_bytes']} B of metric scalars (fedavg's "
              f"D 4 would be {res[0]['fedavg_bytes']} B); s/step "
              f"{[round(r['steps'][s]['s'], 4) for r in res]} (10b "
              f"unsharded 1.836-1.985); proto_accum launches a rank "
              f"{[r['steps'][s]['proto_accum_launches'] for r in res]} "
              f"[{smi}]")
    rnd = [r["round"] for r in res]
    if not all(t["count"] == (POD_STEPS + 1) * tokens
               and t["proto_accum_launches"] == 1
               and t["pod_bytes"] == payload for t in rnd):
        raise AssertionError(f"[pod] 15a round: {rnd}")
    peaks = [r["peak_bytes"] for r in res]
    print(f"[pod] 15a round (sync_in_step=False, then make_round_sync on "
          f"client-sharded stats): counts {rnd[0]['count']} = "
          f"{POD_STEPS + 1} x {tokens}, one proto_accum launch a rank, "
          f"{rnd[0]['pod_bytes']} B over pod; peak memory a rank "
          f"{[round(p / 1e9, 2) for p in peaks]} GB; setup "
          f"{[round(r['setup_s'], 2) for r in res]} s; staged "
          f"{res[0]['staged']}; {wall:.1f} s the two ranks, {t_ref:.1f} s "
          f"the reference's file [{smi}]")
    return {"ranks": 2, "mesh": "pod:2xdata:1xmodel:1", "wall_s": wall,
            "held": which,
            "s_per_step": [[r["steps"][s]["s"] for r in res]
                           for s in range(POD_STEPS)],
            "pod_bytes_a_step": res[0]["steps"][0]["pod_bytes"],
            "pod_scalar_bytes_a_step": res[0]["steps"][0]["pod_scalar_bytes"],
            "peak_bytes": peaks,
            "proto_accum_launches_a_step": [
                [r["steps"][s]["proto_accum_launches"] for r in res]
                for s in range(POD_STEPS)]}


def pod_four_inputs(cfg, ccfg, dev):
    """15b's batch (2 clients x MESH_LM_TRAIN_BATCH x MESH_LM_TRAIN_SEQ),
    negatives and round-sync stats, alike on every process."""
    from repro_torch.core import prototypes
    from repro_torch.launch import train
    batch = _to(lm_train_batches(cfg.vocab_size, LM_CLIENTS,
                                 MESH_LM_TRAIN_BATCH, MESH_LM_TRAIN_SEQ, 1,
                                 seed=0)[0], dev)
    neg = train.draw_negatives(torch.Generator(device=dev).manual_seed(1),
                               cfg, ccfg, LM_CLIENTS)
    gen = torch.Generator(device=dev).manual_seed(2)
    stats = prototypes.ProtoState(
        torch.randn(LM_CLIENTS, cfg.vocab_size, cfg.d_feature, generator=gen,
                    device=dev),
        torch.randint(0, 5, (LM_CLIENTS, cfg.vocab_size), generator=gen,
                      device=dev).float())
    return batch, neg, stats


def pod_ccfg(cfg, mode="cors"):
    from repro_torch.types import CollabConfig
    return CollabConfig(mode=mode, num_classes=cfg.vocab_size,
                        d_feature=cfg.d_feature)


def pod_syncs(ccfg, C, d, dev):
    """(name, fn(state, stats) -> what 15b holds) of the three round
    syncs: the merged ProtoState, with the pending slots (delays (0, 1))
    or the history ring."""
    from repro_torch.launch import train
    init_pending, async_sync = train.make_async_round_sync(ccfg, POD_D_MAX)
    init_hist, lag_sync, _ = train.make_download_lag_round_sync(ccfg,
                                                                POD_H_MAX)

    def lagged(st, s):
        out, hist = lag_sync(st, init_hist(C, d, dev), s)
        return out.proto, hist

    def delayed(st, s):
        out, pending = async_sync(st, init_pending(C, d, dev),
                                  torch.tensor([0, 1], device=dev), s)
        return out.proto, pending

    return (("round", lambda st, s: train.make_round_sync(ccfg)(st, s).proto),
            ("async", delayed), ("lag", lagged))


def pod_four_reference(dev, path):
    """15b's unsharded 2-client runs on the card, saved to `path`: each
    case's parameters (a client's leaf stored once where the clients agree,
    one tensor for cases that agree on the present clients), client 0's
    gradients in cors, metrics, counts, and the round syncs' digests."""
    from repro_torch.launch import train
    from repro_torch.tree import leaves
    cfg = mesh_lm_cfg()
    batch, neg, stats = pod_four_inputs(cfg, pod_ccfg(cfg), dev)
    init = lambda: train.init_state(
        cfg, torch.Generator(device=dev).manual_seed(0), LM_CLIENTS,
        device=dev)
    ref = {"params": {}, "cases": {}}
    for name, mode, _, masked in POD_CASES:
        ccfg = pod_ccfg(cfg, mode)
        state = init()
        if name == "cors":
            g, _ = mesh_lm_grads(cfg, ccfg, state, batch, neg)
            ref["grads"] = [t.cpu() for t in leaves(g)]
            del g
        mask = torch.tensor(POD_MASK, device=dev) if masked else None
        new, met = train.make_train_step(cfg, ccfg, n_clients=LM_CLIENTS)(
            state, batch, neg, mask)
        present = [i for i in range(LM_CLIENTS) if not masked or POD_MASK[i]]
        params = [t.cpu() for t in leaves(new.params)]
        key = next((k for k, v in ref["params"].items() if all(
            torch.equal(a[present], b[present]) for a, b in zip(v, params))),
            name)
        if key == name:
            ref["params"][key] = [
                t[:1].clone().expand(t.shape) if all(
                    torch.equal(t[0], t[i]) for i in range(1, len(t)))
                else t for t in params]
        ref["cases"][name] = {
            "key": key, "present": present, "loss": float(met["total"]),
            "count": new.proto.count.cpu()}
        del state, new, params
        torch.cuda.empty_cache()
    ref["syncs"] = {}
    state = init()
    for name, fn in pod_syncs(pod_ccfg(cfg), cfg.vocab_size, cfg.d_feature,
                              dev):
        ref["syncs"][name] = [bit_digest(t) for t in leaves(fn(state, stats))]
    del state
    torch.save(ref, path)
    torch.cuda.empty_cache()


def pod_four_rank_main(rank, world, tmp):
    """One of 15b's four ranks on the (2, 1, 2) mesh, held by phase 14b's
    bounds against tmp/ref.pt; rank 0 writes tmp/result.json."""
    import torch.distributed as dist
    from repro_torch import ranks, sharding
    from repro_torch.core import prototypes
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline, train
    from repro_torch.tree import leaves, tree_map
    from torch.distributed.tensor import DTensor, distribute_tensor
    dev, mesh = pod_setup((2, 1, 2))
    ref = torch.load(os.path.join(tmp, "ref.pt"), mmap=True)
    cfg = mesh_lm_cfg()
    N = LM_CLIENTS
    batch, neg, stats = pod_four_inputs(cfg, pod_ccfg(cfg), dev)
    shapes = train.init_state_shapes(cfg, N)
    specs = {st: train.state_shardings(shapes, cfg, mesh, N, strategy=st)
             for st in ("tp", "zero1")}
    pod = mesh.get_local_rank("pod")
    blk = (pod * N // 2, (pod + 1) * N // 2)

    def fresh(strategy):
        return sharding.place_block(train.init_state(
            cfg, torch.Generator(device=dev).manual_seed(0), N, device=dev,
            clients=blk), specs[strategy], mesh)

    res = {"cases": {}}
    for name, mode, strategy, masked in POD_CASES:
        t0 = time.perf_counter()
        want = ref["cases"][name]
        ccfg = pod_ccfg(cfg, mode)
        step = train.make_train_step(cfg, ccfg, n_clients=N)
        sharding.set_hints(mesh=mesh, moe_ep=False,
                           moe_dp=strategy in ("dp_only", "zero1"))
        e_g = []
        try:
            state = fresh(strategy)
            pb = sharding.place(batch, train.batch_shardings(
                batch, mesh, N, strategy=strategy), mesh, src_data_rank=None)
            if name == "cors" and pod == 0:
                # client 0's gradients on its (data, model) sub-mesh
                cb_ = sharding.client_block(state.opt.step, N)
                with sharding.hints_restored():
                    sharding.set_hints(mesh=cb_.sub)
                    g, _, _, _ = train.client_grads(
                        train.make_loss_fn(cfg, ccfg),
                        tree_map(lambda a: sharding.client_of(a, 0, cb_),
                                 state.params),
                        {k: sharding.client_of(v, 0, cb_)
                         for k, v in pb.items()},
                        sharding.client_sub(prototypes.means(state.proto),
                                            cb_), neg[0])
                for a, b in zip(leaves(g), ref["grads"]):
                    x, r, _ = mesh_lm_local(a, b)
                    e_g.append(float((x - r).abs().max())
                               / max(float(r.abs().max()), 1e-30))
                del g
            mask = torch.tensor(POD_MASK, device=dev) if masked else None
            ops.reset_launches()
            with roofline.CollectiveBytes(mesh) as cb:
                new, met = step(state, pb, neg, mask)
            launches = ops.LAUNCHES["proto_accum"]
        finally:
            sharding.set_hints(mesh=None)
        loss = float(sharding.full(met["total"]))
        e_p, n_far, n_all, frozen = 0.0, 0, 0, True
        for a, old, b in zip(leaves(new.params), leaves(state.params),
                             ref["params"][want["key"]]):
            if blk[0] not in want["present"]:
                frozen = frozen and torch.equal(a.to_local(), old.to_local())
                continue
            x, r, own = mesh_lm_local(a, b)
            dd = (x.float() - r.float()).abs()
            e_p = max(e_p, float(dd.max()))
            if own:
                n_far += int((dd > PARITY_PARAM_TOL).sum())
                n_all += dd.numel()
        red = torch.tensor([e_p, max(e_g, default=0.0)], dtype=torch.float64)
        dist.all_reduce(red, op=dist.ReduceOp.MAX)
        ints = torch.tensor([n_far, n_all, int(not frozen)])
        dist.all_reduce(ints)
        count = sharding.full(new.proto.count).cpu()
        pod_b, scalars, model_b = pod_bytes(cb)
        fedavg_b = sum(p.to_local()[0].numel() * 4
                       for p in leaves(state.params))
        res["cases"][name] = {
            "loss_rel": abs(loss - want["loss"]) / abs(want["loss"]),
            "grads_rel": float(red[1]), "params": float(red[0]),
            "params_far": int(ints[0]), "params_n": int(ints[1]),
            "frozen_moved": int(ints[2]),
            "counts_equal": bool(torch.equal(count, want["count"])),
            "proto_accum_launches": launches, "pod_bytes": pod_b,
            "pod_scalar_bytes": scalars, "model_bytes": model_b,
            "fedavg_bytes": fedavg_b, "wall_s": time.perf_counter() - t0}
        del state, new, pb
        torch.cuda.empty_cache()
    rep, stats_pl = train.round_sync_shardings(mesh, N)
    placed = prototypes.ProtoState(*(
        DTensor.from_local(
            distribute_tensor(t, mesh, stats_pl,
                              src_data_rank=None).to_local().clone(),
            mesh, stats_pl, run_check=False, shape=t.shape, stride=t.stride())
        for t in stats))
    del stats
    state = fresh("tp")
    res["syncs"] = {}
    for name, fn in pod_syncs(pod_ccfg(cfg), cfg.vocab_size, cfg.d_feature,
                              dev):
        with roofline.CollectiveBytes(mesh) as cb:
            out = fn(state, placed)
        digs = [bit_digest(sharding.full(t)) for t in leaves(out)]
        pod_b, scalars, _ = pod_bytes(cb)
        res["syncs"][name] = {"equal": digs == ref["syncs"][name],
                              "pod_bytes": pod_b,
                              "pod_scalar_bytes": scalars}
    res["staged"] = dict(ranks.STAGED)
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    if rank == 0:
        with open(os.path.join(tmp, "result.json"), "w") as f:
            json.dump(res, f)


def phase_pod_four_ranks(dev, smi):
    """15b: four gloo ranks sharing cuda:0 on the (2, 1, 2) mesh against the
    unsharded runs on the card."""
    from repro_torch import ranks
    tmp = tempfile.mkdtemp(prefix="pod-lm-")
    try:
        t0 = time.perf_counter()
        pod_four_reference(dev, os.path.join(tmp, "ref.pt"))
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks.spawn(pod_four_rank_main, 4, "gloo", tmp)
        wall = time.perf_counter() - t0
        with open(os.path.join(tmp, "result.json")) as f:
            res = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg = mesh_lm_cfg()
    block = cfg.vocab_size // 2 * (cfg.d_feature + 1) * 4
    lim = 2 * 1e-3
    for name, t in res["cases"].items():
        want = {"fedavg": t["fedavg_bytes"], "il": 0}.get(name, block)
        launches = 0 if name in ("fedavg", "il") else 1
        ok = (t["loss_rel"] <= MESH_LM_LOSS_TOL
              and t["grads_rel"] <= MESH_LM_GRAD_TOL
              and t["params"] <= lim
              and t["params_far"] <= PARITY_PARAM_FRAC * t["params_n"]
              and t["frozen_moved"] == 0 and t["counts_equal"]
              and t["proto_accum_launches"] == launches
              and t["pod_bytes"] == want)
        if not ok:
            raise AssertionError(f"[pod] 15b {name}: {t} (pod bytes want "
                                 f"{want})")
        print(f"[pod] 15b {name} on pod:2xdata:1xmodel:2 (4 gloo ranks, one "
              f"card; {t['wall_s']:.1f} s), {MESH_LM_LAYERS} of 22 layers, "
              f"float32: loss {t['loss_rel']:.3e} relative, parameters "
              f"{t['params']:.3e} ({t['params_far']} of {t['params_n']} "
              f"beyond {PARITY_PARAM_TOL})"
              + (f", client 0's gradients {t['grads_rel']:.3e} of max|g|"
                 if name == "cors" else "")
              + (", the absent client's leaves unchanged" if name == "absent"
                 else "")
              + f", counts equal, {launches} proto_accum launch a rank; a "
              f"rank sends {t['pod_bytes']} B over pod (+ "
              f"{t['pod_scalar_bytes']} B of scalars), {t['model_bytes']} "
              f"B over model")
    payload = {"round": block, "async": (POD_D_MAX + 1) * 2 * block,
               "lag": block}
    for name, t in res["syncs"].items():
        if not (t["equal"] and t["pod_bytes"] == payload[name]):
            raise AssertionError(f"[pod] 15b sync {name}: {t}")
    print(f"[pod] 15b round syncs on client-sharded stats (round, async "
          f"with delays (0, 1), download lag): bit-equal to unsharded by "
          f"digest, over pod {[t['pod_bytes'] for t in res['syncs'].values()]}"
          f" B a rank; host-staged collectives {res['staged']}; peak rank 0 "
          f"{res['peak_bytes'] / 1e9:.2f} GB; {t_ref:.1f} s unsharded, "
          f"{wall:.1f} s the four ranks [{smi}]")
    res.update(ranks=4, backend="gloo", wall_s=wall, reference_s=t_ref)
    return res


def mlp_stack_check(stack, block, dev):
    """Clients [0, block)'s MLP features, and the gradients of their
    squares' sum with respect to both hidden weights, within the whole
    `stack` (the vec engine's `vmap`: batched GEMMs over the clients)
    against a stack of those `block` clients alone, on one seeded batch of
    16 images a client; and one batched GEMM of the first layer's shape,
    (n, 16, 784) @ (n, 784, 64), its first `block` slices against the same
    GEMM over `block` slices. -> features' largest difference, gradients'
    relative to their largest entry, the GEMM's largest difference."""
    from repro_torch.data import synthetic
    from repro_torch.models import mlp
    n = next(iter(stack.values())).shape[0]
    x, _ = synthetic.class_images(16 * n, seed=5, noise=0.4)
    x = torch.from_numpy(x).to(dev).reshape(n, 16, -1)
    feats = torch.func.vmap(mlp.features)
    got = []
    for m in (n, block):
        p = {k: v[:m].detach().clone().requires_grad_(True)
             for k, v in stack.items()}
        s = feats(p, x[:m])[:block]
        g = torch.autograd.grad(s.square().sum(), [p["w1"], p["w2"]])
        got.append((s.detach(), [t[:block] for t in g]))
    (sa, ga), (sb, gb) = got
    w1 = stack["w1"].detach()
    gemm = float((torch.bmm(x, w1)[:block] - torch.bmm(x[:block], w1[:block])
                  ).abs().max())
    return {"features": float((sa - sb).abs().max()),
            "gradients": max(float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(ga, gb)),
            "bmm": gemm}


# Phase 16: every other LM family on a mesh, serving and training on
# DTensor (MLA's latent cache, mamba2 and zamba2's shared block, the xLSTM's
# recurrences, ChatGLM3, Qwen2-VL, DeepSeek-67B, Whisper's cross caches).
# 16a: one NCCL rank, mesh (1, 1) over ("data", "model"), each family at
# its published widths in bf16 on seed-0 weights, at the least depth that
# holds each of its block kinds once (MESH_FAMILIES: arch, serving layers
# or None for all, training layers or None for no training here):
# `serve_lm.serve` on MESH_FAM_BATCH x MESH_FAM_PROMPT prompts and
# MESH_FAM_TOKENS tokens (Whisper: phase 12's clips and prompts), logits,
# ids and caches bit-equal to the unsharded run, flash launches one an
# attention layer a prefill (Whisper also 12 a decode step); one cors step
# of LM_CLIENTS clients x 1 x MESH_FAM_TRAIN_SEQ tokens under "tp",
# bit-equal to the unsharded step by a digest of every leaf, one
# proto_accum launch. Training depths are phase 13's where its 70 GB gate
# cut them (DeepSeek-V2-Lite 1 layer); DeepSeek-67B's one layer holds 2.4 B
# parameters a client (its vocabulary of 102,400 at d 8,192, twice), about
# 104 GB for two clients' step, so 16a serves it only (16b and the CPU test
# train it). 16b: four gloo ranks sharing the card, one spawn for all
# families, each reduced (2 layers, d 256, float32; zamba2's holds its
# shared point): serving (MESH_FAM_PROMPT_B-token prompts, MESH_FAM_TOKENS_B
# tokens) and client 0's gradients and one cors step under "tp" (14b's
# MESH_LM_TRAIN_BATCH rows a client, which the data axis divides), against
# the unsharded runs on the card by 14b's bounds.
MESH_FAMILIES = (("deepseek-v2-lite-16b", 2, 1), ("minicpm3-4b", 1, 1),
                 ("chatglm3-6b", 1, 1), ("qwen2-vl-7b", 1, 1),
                 ("deepseek-67b", 1, None), ("zamba2-1.2b", 6, 6),
                 ("xlstm-125m", 2, 2), ("whisper-small", None, 12))
MESH_FAM_BATCH, MESH_FAM_PROMPT, MESH_FAM_TOKENS = 4, 256, 8
MESH_FAM_TRAIN_SEQ = 256
MESH_FAM_PROMPT_B, MESH_FAM_TOKENS_B = 32, 2
# 16b also runs this MoE arch under the expert-parallel hint ("moe_ep"):
# its expert leaves split on the expert dim over "model"
MESH_EP_ARCH = "granite-moe-1b-a400m"


def mesh_family_cfg(arch, layers=None, reduced=False):
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    if reduced:
        return cfg.reduced()
    if layers and not cfg.is_encoder_decoder:
        cfg = family_depth(cfg, layers)
    return cfg


def mesh_family_flash(cfg, tokens):
    """Flash launches of a `serve_lm.serve` of `tokens` tokens: one an
    attention layer a prefill (zamba2's shared block at each of its
    points; Whisper's encoder, self- and cross-attention), and Whisper's
    cross-attention again each decode step."""
    from repro_torch.models import lm
    if cfg.is_encoder_decoder:
        return (cfg.num_encoder_layers + 2 * cfg.num_layers
                + cfg.num_layers * tokens)
    return (sum(k == "attn" for k in cfg.block_pattern)
            + len(lm.shared_points(cfg)))


def mesh_family_serve_inputs(cfg, B, S, tokens, dev):
    """(prefill batch, next_batch) of `serve_lm.serve` from seed 0: tokens,
    Qwen2-VL's embeddings with M-RoPE positions (and its decode steps'),
    Whisper's tokens and frames."""
    from repro_torch import serve_lm
    gen = torch.Generator(device=dev).manual_seed(0)
    if cfg.is_encoder_decoder:
        return whisper_inputs(cfg, B, S, dev, gen), serve_lm.greedy_tokens
    batch = family_inputs(cfg, B, S, dev, gen)
    if cfg.input_kind == "tokens":
        return batch, serve_lm.greedy_tokens
    steps = [family_inputs(cfg, B, 1, dev, gen, offset=S + i)
             for i in range(tokens)]
    return batch, lambda i, logits: steps[i]


def mesh_family_train_inputs(cfg, rows, seq, dev):
    """(ccfg, batch, negatives) of one cors step of LM_CLIENTS clients x
    rows x seq tokens: the synthetic stream's tokens and labels, Qwen2-VL's
    seeded embeddings and M-RoPE positions in place of tokens, Whisper's
    seeded frames beside them."""
    from repro_torch.launch import train
    from repro_torch.nn import rope
    from repro_torch.types import CollabConfig
    ccfg = CollabConfig(mode="cors", num_classes=cfg.vocab_size,
                        d_feature=cfg.d_feature)
    batch = _to(lm_train_batches(cfg.vocab_size, LM_CLIENTS, rows, seq, 1,
                                 seed=0)[0], dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    add_frames(cfg, [batch], rows, gen)
    if cfg.input_kind != "tokens":
        del batch["tokens"]
        batch["embeddings"] = torch.randn(
            LM_CLIENTS, rows, seq, cfg.d_model, generator=gen,
            device=dev).to(getattr(torch, cfg.dtype))
        batch["positions"] = rope.default_positions(
            rows, seq, cfg.rope_kind, device=dev)[None].expand(
            LM_CLIENTS, rows, seq, 3).contiguous()
    return ccfg, batch, train.draw_negatives(gen, cfg, ccfg, LM_CLIENTS)


def mesh_family_one_rank(dev, mesh, arch, s_layers, t_layers, smi):
    """16a for one family: serving and (where `t_layers`) one train step,
    unsharded and on the placed trees, bit-equal, launches exact."""
    from repro_torch import serve_lm, sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.models import encdec, lm
    from repro_torch.tree import leaves
    cfg = mesh_family_cfg(arch, s_layers)
    init = encdec.init_encdec if cfg.is_encoder_decoder else lm.init_lm
    out = {"arch": arch, "serve_layers": cfg.num_layers}
    params = init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    placed = sharding.place(params, serve.params_shardings(params, cfg, mesh),
                            mesh, src_data_rank=None)
    S = WHISPER_PROMPT if cfg.is_encoder_decoder else MESH_FAM_PROMPT
    batch, next_batch = mesh_family_serve_inputs(
        cfg, MESH_FAM_BATCH, S, MESH_FAM_TOKENS, dev)
    runs = {}
    with torch.no_grad():
        for tag, p, m in (("unsharded", params, None), ("mesh", placed, mesh)):
            serve_lm.serve(p, cfg, batch, 2, next_batch, mesh=m)  # warm-up
            ops.reset_launches()
            r = serve_lm.serve(p, cfg, batch, MESH_FAM_TOKENS, next_batch,
                               mesh=m)
            r["launches"] = dict(ops.LAUNCHES)
            r["caches"] = [bit_digest(sharding.full(t))
                           for t in leaves(r["caches"])]
            runs[tag] = r
    del params, placed
    a, b = runs["mesh"], runs["unsharded"]
    want = {"disc_loss_fwd": 0, "disc_loss_bwd": 0, "proto_accum": 0,
            "flash_attention": mesh_family_flash(cfg, MESH_FAM_TOKENS)}
    if a["launches"] != want or b["launches"] != want:
        raise AssertionError(f"[mesh families] {arch} serving launches "
                             f"{a['launches']} / {b['launches']} != {want}")
    if not (torch.equal(a["logits"], b["logits"])
            and torch.equal(a["ids"], b["ids"]) and a["caches"] == b["caches"]
            and bool(torch.isfinite(a["logits"]).all())):
        raise AssertionError(f"[mesh families] {arch}: placed serving logits,"
                             f" ids or caches differ from the unsharded path")
    out["serve"] = {t: {"prefill_ms": r["prefill_s"] * 1e3,
                        "decode_ms_step": r["decode_s"] * 1e3
                        / MESH_FAM_TOKENS} for t, r in runs.items()}
    out["flash_launches"] = want["flash_attention"]
    print(f"[mesh families] 16a {arch} serving, {cfg.num_layers} layers "
          f"bf16 on data:1xmodel:1 (nccl), {MESH_FAM_BATCH}x{S} prompts, "
          f"{MESH_FAM_TOKENS} tokens: logits, ids and caches bit-equal to "
          f"unsharded, {want['flash_attention']} flash launches; prefill "
          f"{a['prefill_s'] * 1e3:.2f} ms (unsharded "
          f"{b['prefill_s'] * 1e3:.2f}), decode "
          f"{a['decode_s'] * 1e3 / MESH_FAM_TOKENS:.3f} ms/step (unsharded "
          f"{b['decode_s'] * 1e3 / MESH_FAM_TOKENS:.3f}) [{smi}]")
    del runs, a, b
    torch.cuda.empty_cache()
    if not t_layers:
        return out
    tcfg = mesh_family_cfg(arch, t_layers)
    ccfg, batch, neg = mesh_family_train_inputs(tcfg, 1, MESH_FAM_TRAIN_SEQ,
                                                dev)
    step = train.make_train_step(tcfg, ccfg, n_clients=LM_CLIENTS,
                                 disc_tokens=LM_DISC_TOKENS)
    runs = {}
    for tag in ("unsharded", "mesh"):
        state = train.init_state(tcfg, torch.Generator(device=dev).manual_seed(
            0), LM_CLIENTS, device=dev)
        b = batch
        if tag == "mesh":
            state = mesh_lm_place_state(tcfg, state, mesh, "tp")
            b = mesh_lm_place_batch(batch, mesh, "tp")
        ops.reset_launches()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, b, neg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            sharding.set_hints(mesh=None)
        runs[tag] = {"digests": [bit_digest(sharding.full(t))
                                 for t in leaves(state)],
                     "metrics": {k: float(sharding.full(v))
                                 for k, v in met.items()},
                     "s": secs, "launches": dict(ops.LAUNCHES),
                     "batched": dict(ops.LAUNCHES_BATCHED)}
        del state
        torch.cuda.empty_cache()
    a, b = runs["mesh"], runs["unsharded"]
    want = {"disc_loss_fwd": 0, "disc_loss_bwd": 0, "proto_accum": 1,
            "flash_attention": 0}
    for r in (a, b):
        if r["launches"] != want or r["batched"]["proto_accum"] != 1:
            raise AssertionError(f"[mesh families] {arch} train launches "
                                 f"{r['launches']}, batched {r['batched']}")
    if a["digests"] != b["digests"] or a["metrics"] != b["metrics"]:
        raise AssertionError(f"[mesh families] {arch} train: the placed step "
                             f"differs from the unsharded step")
    if not all(math.isfinite(v) for v in a["metrics"].values()):
        raise AssertionError(f"[mesh families] {arch}: metrics {a['metrics']}")
    out["train"] = {"layers": tcfg.num_layers, "s_per_step": {
        "unsharded": b["s"], "mesh": a["s"]}, "proto_accum_launches": 1}
    print(f"[mesh families] 16a {arch} train tp, {tcfg.num_layers} layers "
          f"bf16, {LM_CLIENTS} clients x 1 x {MESH_FAM_TRAIN_SEQ} tokens: "
          f"{len(a['digests'])} leaf digests, metrics and counts bit-equal to "
          f"unsharded, one proto_accum launch; s/step {a['s']:.4f} "
          f"(unsharded {b['s']:.4f}) [{smi}]")
    return out


def phase_mesh_families_one_rank(dev, smi):
    """16a: every family of MESH_FAMILIES on one NCCL rank."""
    import torch.distributed as dist
    from repro_torch import ranks
    from repro_torch.launch import mesh as lmesh
    tmp = tempfile.mkdtemp(prefix="mesh-fam-")
    t0 = time.perf_counter()
    quiet_redistribute()
    ranks.init(0, 1, "nccl", f"file://{tmp}/rendezvous")
    try:
        mesh = lmesh.device_mesh(lmesh.make_host_mesh())
        rows = [mesh_family_one_rank(dev, mesh, arch, s, t, smi)
                for arch, s, t in MESH_FAMILIES]
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    print(f"[mesh families] 16a: {wall:.1f} s in all")
    return {"mesh": "data:1xmodel:1", "backend": "nccl", "families": rows,
            "wall_s": wall}


def mesh_family_reduced_runs(cfg, dev, mesh=None, moe_ep=False):
    """16b's runs of one reduced family, unsharded or on `mesh`: serving,
    client 0's gradients and one cors step under "tp", on the card, every
    output whole on the host, and the launches of each. With `moe_ep`, all
    of it under the expert-parallel hint, and the experts a rank holds of
    each `_e` leaf ("local_experts")."""
    from repro_torch import serve_lm, sharding
    from repro_torch.core import prototypes
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.models import encdec, lm
    from repro_torch.tree import leaves, tree_map
    init = encdec.init_encdec if cfg.is_encoder_decoder else lm.init_lm
    host = lambda t: sharding.full(t).cpu()
    out = {}
    with torch.no_grad():
        p = init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        if mesh is not None:
            sharding.set_hints(mesh=mesh if moe_ep else None, moe_ep=moe_ep,
                               moe_dp=False)
            p = sharding.place(p, serve.params_shardings(p, cfg, mesh), mesh,
                               src_data_rank=None)
            held = []
            sharding.map_params(lambda path, t, n: held.append(
                t.to_local().shape[0]) if path.endswith("_e") else None, p)
            out["local_experts"] = sorted(set(held))
        batch, next_batch = mesh_family_serve_inputs(
            cfg, MESH_FAM_BATCH, MESH_FAM_PROMPT_B, MESH_FAM_TOKENS_B, dev)
        ops.reset_launches()
        r = serve_lm.serve(p, cfg, batch, MESH_FAM_TOKENS_B, next_batch,
                           mesh=mesh)
        out["serve_launches"] = dict(ops.LAUNCHES)
        out["logits"], out["ids"] = r["logits"].cpu(), r["ids"]
        out["caches"] = [host(t) for t in leaves(r["caches"])]
        del p, r
    ccfg, batch, neg = mesh_family_train_inputs(
        cfg, MESH_LM_TRAIN_BATCH, MESH_FAM_PROMPT_B, dev)
    state = train.init_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             LM_CLIENTS, device=dev)
    if mesh is not None:
        state = mesh_lm_place_state(cfg, state, mesh, "tp", moe_ep)
        batch = mesh_lm_place_batch(batch, mesh, "tp")
    try:
        g, _ = mesh_lm_grads(cfg, ccfg, state, batch, neg)
        out["grads"] = [host(t) for t in leaves(g)]
        del g
        ops.reset_launches()
        step = train.make_train_step(cfg, ccfg, n_clients=LM_CLIENTS)
        state, met = step(state, batch, neg)
        out["train_launches"] = dict(ops.LAUNCHES)
    finally:
        sharding.set_hints(mesh=None, moe_ep=False)
    out["loss"] = float(sharding.full(met["total"]))
    out["params"] = [host(t) for t in leaves((state.params, state.opt.m))]
    out["proto_count"] = host(state.proto.count)
    return out


def mesh_family_rank_main(rank, world, tmp):
    """One of 16b's ranks, all on cuda:0 over gloo (functional collectives
    staged): every reduced family on the (2, 2) mesh, held by rank 0
    against the unsharded runs in tmp/ref.pt; rank 0 writes
    tmp/result.json."""
    from repro_torch import ranks
    from repro_torch.launch import mesh as lmesh
    torch.set_num_threads(2)          # 8 host cores, 4 ranks
    quiet_redistribute()
    phase_precision()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ranks.stage_functional_collectives()
    mesh = lmesh.device_mesh(lmesh.MeshShape(("data", "model"),
                                             MESH_LM_SHAPE), "cuda")
    ref = torch.load(os.path.join(tmp, "ref.pt"))
    res = {}
    cases = [(arch, arch, False) for arch, _, _ in MESH_FAMILIES]
    cases.append((f"{MESH_EP_ARCH} moe_ep", MESH_EP_ARCH, True))
    for key, arch, moe_ep in cases:
        t0 = time.perf_counter()
        cfg = mesh_family_cfg(arch, reduced=True)
        got = mesh_family_reduced_runs(cfg, dev, mesh, moe_ep=moe_ep)
        want = ref[arch]
        rel = lambda a, b: float(((a.double() - b.double()).abs()
                                  / b.double().abs().clamp(min=1.0)).max())
        far = n_all = 0
        e_p = 0.0
        for a, b in zip(got["params"], want["params"]):
            d = (a.double() - b.double()).abs()
            e_p = max(e_p, float(d.max()))
            far += int((d > PARITY_PARAM_TOL).sum())
            n_all += d.numel()
        res[key] = {
            "serve_launches": got["serve_launches"],
            "local_experts": got["local_experts"],
            "experts": cfg.num_experts,
            "want_flash": mesh_family_flash(cfg, MESH_FAM_TOKENS_B),
            "logits": rel(got["logits"], want["logits"]),
            "ids_equal": bool(torch.equal(got["ids"], want["ids"])),
            "caches": max(rel(a, b) for a, b in zip(got["caches"],
                                                    want["caches"])),
            "loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grads_rel": max(float((a - b).abs().max())
                             / max(float(b.abs().max()), 1e-30)
                             for a, b in zip(got["grads"], want["grads"])),
            "params": e_p, "params_far": far, "params_n": n_all,
            "counts_equal": bool(torch.equal(got["proto_count"],
                                             want["proto_count"])),
            "proto_accum_launches": got["train_launches"]["proto_accum"],
            "wall_s": time.perf_counter() - t0}
        torch.cuda.empty_cache()
    res["staged"] = dict(ranks.STAGED)
    if rank == 0:
        with open(os.path.join(tmp, "result.json"), "w") as f:
            json.dump(res, f)


def phase_mesh_families_four_ranks(dev, smi):
    """16b: four gloo ranks sharing cuda:0 on the (2, 2) mesh, every
    reduced family against its unsharded runs on the card."""
    from repro_torch import ranks
    tmp = tempfile.mkdtemp(prefix="mesh-fam-")
    try:
        t0 = time.perf_counter()
        torch.save({arch: mesh_family_reduced_runs(
            mesh_family_cfg(arch, reduced=True), dev)
            for arch in [a for a, _, _ in MESH_FAMILIES] + [MESH_EP_ARCH]},
            os.path.join(tmp, "ref.pt"))
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks.spawn(mesh_family_rank_main, 4, "gloo", tmp)
        wall = time.perf_counter() - t0
        with open(os.path.join(tmp, "result.json")) as f:
            res = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    staged = res.pop("staged")
    for arch, t in res.items():
        want = {"disc_loss_fwd": 0, "disc_loss_bwd": 0, "proto_accum": 0,
                "flash_attention": t["want_flash"]}
        ok = (t["serve_launches"] == want and t["logits"] <= CHECK_TOL
              and t["ids_equal"] and t["loss_rel"] <= MESH_LM_LOSS_TOL
              and t["grads_rel"] <= MESH_LM_GRAD_TOL
              and t["params"] <= 2 * 1e-3
              and t["params_far"] <= PARITY_PARAM_FRAC * t["params_n"]
              and t["counts_equal"] and t["proto_accum_launches"] == 1)
        if arch.endswith("moe_ep"):
            # the experts split over "model" (2): E / 2 a rank of each leaf
            ok = ok and t["local_experts"] == [t["experts"] // 2]
        if not ok:
            raise AssertionError(f"[mesh families] 16b {arch}: {t}")
        print(f"[mesh families] 16b {arch} reduced float32 on data:2xmodel:2 "
              f"(4 gloo ranks, one card; {t['wall_s']:.1f} s): logits "
              f"{t['logits']:.3e} relative, ids equal, caches "
              f"{t['caches']:.3e} (reported), {t['want_flash']} flash "
              f"launches a rank; train tp: loss {t['loss_rel']:.3e} "
              f"relative, client 0's gradients {t['grads_rel']:.3e} of "
              f"max|g|, parameters and moments {t['params']:.3e} "
              f"({t['params_far']} of {t['params_n']} beyond "
              f"{PARITY_PARAM_TOL}), counts equal, one proto_accum launch a "
              f"rank; experts a rank of each _e leaf {t['local_experts']}")
    print(f"[mesh families] 16b: {t_ref:.1f} s unsharded, {wall:.1f} s the "
          f"four ranks; host-staged collectives {staged} [{smi}]")
    return {"ranks": 4, "backend": "gloo", "families": res, "wall_s": wall,
            "reference_s": t_ref}


# phase 17: sliding-window prefill through the windowed flash kernel
WINDOW_SHAPE = (1, 4096, 32, 4, 64, 64)    # TinyLlama's heads, 4096 tokens
WINDOW_WIDTHS = (1, 63, 64, 1000)          # 1, tile-ragged, a tile, many
WINDOW_MLA_SHAPES = ((1, 1024, 16, 16, 192, 128),   # DeepSeek-V2-Lite
                     (1, 1024, 40, 40, 96, 64))     # MiniCPM3
WINDOW_MLA_WIDTHS = (65, 300)
WINDOW_FULL = 1000                         # the non-causal case's window
WINDOW_CHECK = (4096, 1024)                # 17b: tokens, window
# 17b in bf16, the whole model: max |kernel path - plain| over the logits
# <= WINDOW_BF16_TOL x max(1, |logit|), and below the window's own effect
# (the same prefill without the window), so that the check can tell them
# apart; float32 at 2 layers within CHECK_TOL
WINDOW_BF16_TOL = 5e-2
WINDOW_RUN = (32768, 8192)                 # 17c: prefill_32k's length, swa_window
WINDOW_ROWS = 256                          # 17c: rows held against plain
WINDOW_TURNS = 3                           # 17c: prefills of each, in turns


def window_inputs(shape, dtype, dev, gen):
    B, S, H, G, hd, hv = shape
    return (torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype),
            torch.randn(B, S, G, hd, generator=gen, device=dev).to(dtype),
            torch.randn(B, S, G, hv, generator=gen, device=dev).to(dtype))


def window_pairs(S, W):
    """The (query, key) pairs a causal window of W keys leaves a head: the
    sum over rows of min(i + 1, W), S W - W^2 / 2 + W / 2 for S >= W."""
    W = min(W, S)
    return W * (W + 1) // 2 + (S - W) * W


def window_bound(shape, W, dtype):
    """The least time of a causal windowed flash call: q, k, v read once
    and the output written once, 2 (hd + hv) operations a pair a head."""
    B, S, H, G, hd, hv = shape
    size = 2 if dtype == torch.bfloat16 else 4
    return bound_ms((B * S * H + B * S * G) * (hd + hv) * size,
                    2 * B * H * window_pairs(S, W) * (hd + hv),
                    BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)


def sdpa_band(q, k, v, W):
    """`scaled_dot_product_attention` of the same function with a boolean
    band mask (causal, q_pos - k_pos < W), KV heads repeated to the query
    heads: the yardstick. -> a function of no arguments, or None with the
    reason printed where no memory-bounded backend takes it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(rep, 2).transpose(1, 2)
    vt = v.repeat_interleave(rep, 2).transpose(1, 2)
    i = torch.arange(q.shape[1], device=q.device)
    diff = i[:, None] - i[None, :]
    mask = (diff >= 0) & (diff < W)

    def run():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    try:
        run()
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"[window] scaled_dot_product_attention with a band mask at "
              f"{tuple(q.shape)}: no memory-bounded backend ({e})"[:400])
        return None
    return run


def check_window(shape, dtype, causal, W, dev, gen):
    """The windowed kernel against its plain version, one bf16 step (or
    FLASH_F32_TOL) element by element, as phase 4."""
    from repro_torch.kernels import ops, ref
    q, k, v = window_inputs(shape, dtype, dev, gen)
    out = ops.flash_attention(q, k, v, causal=causal, window=W)
    want = ref.flash_attention(q, k, v, causal=causal, window=W)
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    excess = flash_excess(out, want)
    tag = (f"flash_attention {shape} {str(dtype).split('.')[-1]} "
           f"{'causal' if causal else 'full'} window {W}")
    if not excess <= 1:
        raise AssertionError(f"{tag}: max error {err:.3e}, {excess:.3f} x the "
                             f"limit")
    return {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
            "causal": causal, "window": W, "max_abs_err": err,
            "limit_used": excess}


def phase_window_kernels(dev):
    """17a: both windowed kernels against the plain version, at TinyLlama's
    heads over 4096 tokens (windows 1, 63, 64, 1000), at MLA's split dims,
    one non-causal window; a window past the sequence bit-equal to none,
    a window of 1 returning v's rows; the kernel, plain and SDPA-band
    times at the first shape in bf16."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(17)
    rows = []
    t0 = time.perf_counter()
    for dtype in (torch.bfloat16, torch.float32):
        for W in WINDOW_WIDTHS:
            rows.append(check_window(WINDOW_SHAPE, dtype, True, W, dev, gen))
        rows.append(check_window(WINDOW_SHAPE, dtype, False, WINDOW_FULL, dev,
                                 gen))
        for shape in WINDOW_MLA_SHAPES:
            for W in WINDOW_MLA_WIDTHS:
                rows.append(check_window(shape, dtype, True, W, dev, gen))
        q, k, v = window_inputs(WINDOW_SHAPE, dtype, dev, gen)
        S, rep = q.shape[1], q.shape[2] // k.shape[2]
        for causal in (True, False):
            none = ops.flash_attention(q, k, v, causal=causal)
            for W in (S, S + 7):
                if not torch.equal(ops.flash_attention(
                        q, k, v, causal=causal, window=W), none):
                    raise AssertionError(f"window {W} >= S {S} is not "
                                         f"bit-equal to no window ({dtype}, "
                                         f"causal {causal})")
        # each row sees its own key alone, p = 1: bf16 returns v's rows bit
        # for bit; float32's split TF32 holds 22 of v's 24 bits, within
        # FLASH_F32_TOL (flash_attention.cu)
        one = ops.flash_attention(q, k, v, window=1)
        v_rows = v.repeat_interleave(rep, 2)
        if not (torch.equal(one, v_rows) if dtype == torch.bfloat16
                else flash_excess(one, v_rows) <= 1):
            raise AssertionError(f"window 1 does not return v's rows ({dtype})")
    worst = max(rows, key=lambda r: r["limit_used"])
    print(f"[window] 17a: {len(rows)} windowed shapes against plain, worst "
          f"{worst['limit_used']:.3f} x the limit ({worst['dtype']} "
          f"{worst['shape']} window {worst['window']}, max_abs_err "
          f"{worst['max_abs_err']:.3e}); window >= S bit-equal to none in "
          f"bf16 and float32, window 1 = v (bf16 bit for bit, float32 "
          f"within the limit) ({time.perf_counter() - t0:.1f} s)")
    W = WINDOW_FULL
    q, k, v = window_inputs(WINDOW_SHAPE, torch.bfloat16, dev, gen)
    band = sdpa_band(q, k, v, W)
    timed = {"shape": list(WINDOW_SHAPE), "window": W,
             "ms": time_ms(lambda: ops.flash_attention(q, k, v, window=W), 20),
             "causal_ms": time_ms(lambda: ops.flash_attention(q, k, v), 20),
             "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v,
                                                             window=W), 20),
             "library_ms": None if band is None else time_ms(band, 20)}
    timed["bound_ms"], timed["bound_by"] = window_bound(WINDOW_SHAPE, W,
                                                        torch.bfloat16)
    print(f"[window] 17a bf16 {WINDOW_SHAPE} window {W}: kernel "
          f"{timed['ms']:.4f} ms (causal, no window {timed['causal_ms']:.4f})"
          f", plain {timed['plain_ms']:.4f}, SDPA band mask "
          f"{timed['library_ms']}, bound {timed['bound_ms']:.6f} ms "
          f"({timed['bound_by']})")
    return {"rows": rows, "timed": timed}


def phase_window_model(dev, smi):
    """17b-d: TinyLlama-1.1B's windowed prefill. 17b full width and depth
    in bf16 (1 x 4096 tokens, window 1024), the kernel path against plain
    attention, and at 2 layers in float32; 17c the timed run at 32768
    tokens and window 8192 (swa_window): 22 flash launches, the kernel's
    ms a launch beside its bound and SDPA's, the prefill with and without
    the window in turns, peak memory; 17d the 2-layer float32 prefill on a
    (1, 1) NCCL mesh, bit-equal to unsharded."""
    import torch.distributed as dist
    from repro_torch import ranks, serve_lm, sharding
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import mesh as lmesh, serve
    from repro_torch.models import lm
    from repro_torch.nn import attention
    from repro_torch.tree import leaves
    out = {}
    cfg = get_arch("tinyllama-1.1b")
    params = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    S, W = WINDOW_CHECK
    toks = check_toks = torch.as_tensor(serve_lm.make_prompts(cfg, 1, S),
                                        device=dev)
    with torch.inference_mode():
        kern = lm.forward(params, cfg, {"tokens": toks}, mode="prefill",
                          window=W)["logits"].float()
        with attention.prefill_attention(ref.flash_attention):
            plain = lm.forward(params, cfg, {"tokens": toks}, mode="prefill",
                               window=W)["logits"].float()
        full = lm.forward(params, cfg, {"tokens": toks},
                          mode="prefill")["logits"].float()
    scale = max(1.0, float(plain.abs().max()))
    e_k = float((kern - plain).abs().max())
    e_w = float((full - kern).abs().max())
    print(f"[window] 17b {cfg.name} bf16 full width, 1x{S} tokens, window "
          f"{W}: max |kernel path - plain| {e_k:.3e}, max |no window - "
          f"window| {e_w:.3e}, max |logit| {scale:.3e} (bound {WINDOW_BF16_TOL}"
          f" x max(1, |logit|) = {WINDOW_BF16_TOL * scale:.3e}, and below the "
          f"window's effect)")
    if not (e_k <= WINDOW_BF16_TOL * scale and e_k < e_w
            and bool(torch.isfinite(kern).all())):
        raise AssertionError(f"17b bf16: {e_k:.3e} against {e_w:.3e}, scale "
                             f"{scale:.3e}")
    out["bf16_check"] = {"kernel_vs_plain": e_k, "window_effect": e_w,
                         "max_logit": scale}
    del kern, plain, full
    cfg32 = family_depth(dataclasses.replace(cfg, dtype="float32"), 2)
    p32 = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg32,
                     device=dev)
    with torch.inference_mode():
        want32 = lm.forward(p32, cfg32, {"tokens": toks}, mode="prefill",
                            window=W)
        with attention.prefill_attention(ref.flash_attention):
            plain = lm.forward(p32, cfg32, {"tokens": toks}, mode="prefill",
                               window=W)["logits"]
    scale32 = max(1.0, float(plain.abs().max()))
    e32 = float((want32["logits"] - plain).abs().max())
    print(f"[window] 17b float32 full width, 2 layers: max |kernel path - "
          f"plain| {e32:.3e} (tol {CHECK_TOL} x {scale32:.3e})")
    if not e32 <= CHECK_TOL * scale32:
        raise AssertionError(f"17b float32: {e32:.3e} > {CHECK_TOL} x "
                             f"{scale32:.3e}")
    out["f32_check"] = e32
    del plain

    # 17c: the windowed kernel at the timed shape, its first and last rows
    # against plain attention over every key, then the prefill
    S, W = WINDOW_RUN
    shape = (1, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
             cfg.head_dim)
    gen = torch.Generator(device=dev).manual_seed(170)
    q, k, v = window_inputs(shape, torch.bfloat16, dev, gen)
    o = ops.flash_attention(q, k, v, window=W)
    worst = 0.0
    for r0 in (0, S - WINDOW_ROWS):
        want = attention.full_attention(q[:, r0:r0 + WINDOW_ROWS], k, v,
                                        causal=True, window=W, q_offset=r0)
        worst = max(worst, flash_excess(o[:, r0:r0 + WINDOW_ROWS], want))
    if not worst <= 1:
        raise AssertionError(f"17c: the windowed kernel's rows at {shape} are "
                             f"{worst:.3f} x the bf16 limit from plain")
    band = sdpa_band(q, k, v, W)
    kt = {"shape": list(shape), "window": W, "rows_vs_plain": worst,
          "ms": time_ms(lambda: ops.flash_attention(q, k, v, window=W), 10,
                        2),
          "causal_ms": time_ms(lambda: ops.flash_attention(q, k, v), 10, 2),
          "library_ms": None if band is None else time_ms(band, 5, 1)}
    kt["bound_ms"], kt["bound_by"] = window_bound(shape, W, torch.bfloat16)
    kt["causal_bound_ms"] = window_bound(shape, S, torch.bfloat16)[0]
    del q, k, v, o, band
    torch.cuda.empty_cache()
    toks = torch.as_tensor(serve_lm.make_prompts(cfg, 1, S), device=dev)
    times = {W: [], 0: []}
    peaks = {}
    with torch.inference_mode():
        for w in (W, 0):                                   # warm-up
            lm.forward(params, cfg, {"tokens": toks}, mode="prefill",
                       window=w)
        torch.cuda.synchronize()
        for turn in range(WINDOW_TURNS):
            for w in ((W, 0) if turn % 2 == 0 else (0, W)):
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launches()
                t0 = time.perf_counter()
                r = lm.forward(params, cfg, {"tokens": toks}, mode="prefill",
                               window=w)
                torch.cuda.synchronize()
                times[w].append(time.perf_counter() - t0)
                peaks[w] = torch.cuda.max_memory_allocated()
                launches = dict(ops.LAUNCHES)
                if launches["flash_attention"] != cfg.num_layers or any(
                        launches[n] for n in launches
                        if n != "flash_attention"):
                    raise AssertionError(f"17c window {w}: launches "
                                         f"{launches}")
                if not bool(torch.isfinite(r["logits"]).all()):
                    raise AssertionError(f"17c window {w}: non-finite logits")
                del r
    kt["launches"] = cfg.num_layers
    pre = {"prefill_ms_window": [t * 1e3 for t in times[W]],
           "prefill_ms_no_window": [t * 1e3 for t in times[0]],
           "peak_gb_window": peaks[W] / 1e9, "peak_gb_no_window": peaks[0] / 1e9}
    print(f"[window] 17c {cfg.name} bf16 1x{S} tokens, window {W}: "
          f"{cfg.num_layers} flash launches a prefill; kernel "
          f"{kt['ms'] * 1e3:.1f} us a launch (no window, causal: "
          f"{kt['causal_ms'] * 1e3:.1f}), bound {kt['bound_ms']:.4f} ms "
          f"({kt['bound_by']}; causal {kt['causal_bound_ms']:.4f}), SDPA band "
          f"mask {kt['library_ms']} ms; rows against plain {worst:.3f} x the "
          f"limit; prefill ms with the window "
          f"{[round(t, 2) for t in pre['prefill_ms_window']]}, without "
          f"{[round(t, 2) for t in pre['prefill_ms_no_window']]}; peak "
          f"{pre['peak_gb_window']:.2f} / {pre['peak_gb_no_window']:.2f} GB "
          f"[{smi}]")
    out["kernel"], out["prefill"] = kt, pre
    del params
    torch.cuda.empty_cache()

    # 17d: the float32 2-layer windowed prefill on a (1, 1) NCCL mesh
    S, W = WINDOW_CHECK
    toks = check_toks
    tmp = tempfile.mkdtemp(prefix="window-mesh-")
    ranks.init(0, 1, "nccl", f"file://{tmp}/rendezvous")
    try:
        mesh = lmesh.device_mesh(lmesh.make_host_mesh())
        batch = {"tokens": toks}
        pp = sharding.place(p32, serve.params_shardings(p32, cfg32, mesh),
                            mesh, src_data_rank=None)
        pb = sharding.place(batch, serve.batch_shardings(batch, mesh), mesh,
                            src_data_rank=None)
        with torch.inference_mode():
            ops.reset_launches()
            got = lm.forward(pp, cfg32, pb, mode="prefill", window=W)
            n_flash = ops.LAUNCHES["flash_attention"]
            same = torch.equal(sharding.full(got["logits"]), want32["logits"])
            same_c = all(torch.equal(sharding.full(a), b) for a, b in zip(
                leaves(got["caches"]), leaves(want32["caches"])))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[window] 17d float32 2 layers, window {W}, mesh data:1xmodel:1 "
          f"(NCCL): logits bit-equal {same}, caches bit-equal {same_c}, "
          f"{n_flash} flash launches")
    if not (same and same_c and n_flash == cfg32.num_layers):
        raise AssertionError("17d: the windowed prefill on the mesh is not "
                             "bit-equal to unsharded")
    out["mesh_bit_equal"] = True
    return out


def memory_floor(cfg, batch, seq):
    """`launch/roofline.memory_floor_bytes` of a train step of LM_CLIENTS
    clients x batch x seq tokens on one device: the bytes the state,
    one checkpoint a layer, the logits and the prototypes need at least."""
    from repro_torch.launch import roofline
    from repro_torch.types import ShapeConfig
    return roofline.memory_floor_bytes(
        cfg, ShapeConfig("train", seq, LM_CLIENTS * batch, "train"), 1,
        n_clients=LM_CLIENTS)["total"]


class Laps:
    """The wall seconds of each stretch of phases, printed as it ends (the
    script's time limit is the whole run's)."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.rows = {}

    def __call__(self, tag):
        now = time.perf_counter()
        self.rows[tag] = round(now - self.last, 1)
        self.last = now
        print(f"[time] {tag}: {self.rows[tag]} s ({now - self.t0:.1f} s in "
              f"all)")


def main():
    lap = Laps()
    smi = phase_device()
    dev = torch.device("cuda")
    resources = phase_build()
    phase_precision()
    lap("1-3 device, build, precision")
    res = phase_kernels(dev)
    lap("4 kernels")
    gpu, launches, secs_seq = phase_slice(dev)
    vec, launches_vec, secs_vec = phase_vec(dev, gpu)
    paths = phase_baselines(dev)
    lap("5, 5b, 5c")
    paths.update(phase_participation(dev))
    compaction = phase_compaction(dev)
    lap("5d")
    paths.update(phase_fleet_paths(dev, "async", ASYNC_PATHS))
    async_scale = phase_async_scale(dev)
    lap("5e")
    paths.update(phase_fleet_paths(dev, "population", SHARD_PATHS))
    phase_shard_anchor(dev)
    shard_cost = phase_shard_cost(dev)
    population = phase_population_scale(dev, async_scale["synchronous"])
    lap("5f")
    with tempfile.TemporaryDirectory() as tdir:
        paths.update(phase_fleet_paths(dev, "telemetry", TELEMETRY_PATHS,
                                       tdir))
    telemetry = {CLIENTS: phase_telemetry_cost(dev, CLIENTS, vec),
                 SCALE_CLIENTS: phase_telemetry_cost(dev, SCALE_CLIENTS)}
    lap("5g")
    # phase 5b's trainer, 5g's telemetry-off arm: a round launches as many
    # device ops here as in 5g's window
    off_ops = telemetry[CLIENTS]["off"]["ops"]
    dev_us_vec, ops_vec, busy_vec, _ = phase_profile(vec, "profile vec", True)
    if ops_vec != off_ops:
        raise AssertionError(f"telemetry off at N={CLIENTS}: {off_ops} device "
                             f"ops, not phase 6's {ops_vec}")
    dev_us, ops_seq, busy_seq, _ = phase_profile(gpu, "profile seq", False)
    dev_us.update(dev_us_vec)
    phase_flash_symbols(dev, res["flash_attention"])
    print(f"[profile] device ops a round: vec {ops_vec} (= 5g's telemetry-off "
          f"count), seq {ops_seq} ({ops_vec / ops_seq:.3f}"
          f" of seq); device busy vec {100 * busy_vec:.1f}%, seq "
          f"{100 * busy_seq:.1f}%")
    del gpu, vec
    scale = phase_scale(dev, secs_seq, secs_vec)
    lap("6 profile, scale")
    torch.cuda.empty_cache()
    mesh_one, mesh_plain = phase_mesh_one_rank(dev, smi)
    mesh_four = phase_mesh_four_ranks(smi, mesh_plain, mesh_one["vec_vs_seq"])
    lap("5h")
    torch.cuda.empty_cache()
    cfg, params, prompts, serve_launches, _ = phase_serve(dev)
    prof = phase_serve_profile(cfg, params, prompts)
    del params
    torch.cuda.empty_cache()
    e_k, e_d, e_c = phase_serve_check(dev)
    lap("7-9 serve")
    torch.cuda.empty_cache()
    lm_parity = phase_lm_parity(dev)
    lm_train = phase_lm_train(dev)
    pod_ref = lm_train.pop("pod_ref")
    torch.cuda.empty_cache()
    lm_twin_s = phase_lm_twin(dev)
    lap("10 train")
    torch.cuda.empty_cache()
    families, family_checks = phase_families(dev)
    lap("11 families")
    whisper = phase_whisper_serve(dev)
    whisper_check = phase_whisper_check(dev)
    lap("12 whisper")
    trains = phase_train_kinds(dev)
    lap("13 train kinds")
    torch.cuda.empty_cache()
    mesh_lm = {"one_rank": phase_mesh_lm_one_rank(dev, smi)}
    torch.cuda.empty_cache()
    mesh_lm["four_ranks"] = phase_mesh_lm_four_ranks(dev, smi)
    lap("14 lm mesh")
    torch.cuda.empty_cache()
    pod = {"two_ranks": phase_pod_two_ranks(dev, smi, pod_ref)}
    del pod_ref
    torch.cuda.empty_cache()
    pod["four_ranks"] = phase_pod_four_ranks(dev, smi)
    lap("15 pod")
    torch.cuda.empty_cache()
    fam_mesh = {"one_rank": phase_mesh_families_one_rank(dev, smi)}
    torch.cuda.empty_cache()
    fam_mesh["four_ranks"] = phase_mesh_families_four_ranks(dev, smi)
    lap("16 family meshes")
    torch.cuda.empty_cache()
    window = {"kernels": phase_window_kernels(dev)}
    window.update(phase_window_model(dev, smi))
    lap("17 windowed prefill")
    launches["flash_attention"] = serve_launches["flash_attention"]
    for name in ("disc_loss_fwd", "disc_loss_bwd", "proto_accum"):
        launches[name + "_batched"] = launches_vec[name]
    dev_us["flash_attention"] = prof["flash_device_us"]

    src = "src/repro_torch/kernels/csrc/"
    disc = (src + "disc_loss.cu", "src/repro/kernels/disc_loss.py:30")
    proto = (src + "proto_accum.cu", "src/repro/kernels/proto_accum.py:22")
    meta = {"disc_loss_fwd": disc, "disc_loss_bwd": disc, "proto_accum": proto,
            "flash_attention": (src + "flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:25"),
            "disc_loss_fwd_batched": disc, "disc_loss_bwd_batched": disc,
            "proto_accum_batched": proto}
    controls = res.pop("flash_controls")
    train_rows = [{k: v for k, v in t.items() if "launches" not in k}
                  for t in trains]
    kernels = []
    for name, rows in res.items():
        main_row = rows[0]                 # the main path's shape, first
        k = {"name": name, "route": "cuda", "source": meta[name][0],
             "replaces": meta[name][1], "launches": launches[name],
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
             "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
             "share_of_bound": main_row["bound_ms"] / main_row["ms"],
             "library_ms": main_row["library_ms"], "shape": main_row["shape"],
             "device_us_per_launch": dev_us[name], "shapes": rows}
        if name != "flash_attention":
            j = name.startswith("disc_loss_bwd") + 2 * name.startswith("proto")
            k["launches_by_path"] = {
                p: v["vec" if name.endswith("_batched") else "seq"][j]
                for p, v in paths.items()}
        # 10b's launches, split as the wrappers counted them: with a client
        # axis (the _batched rows) or without
        base = name.removesuffix("_batched")
        n_b = lm_train["launches_batched"].get(base, 0)
        k.setdefault("launches_by_path", {})["lm_train"] = (
            n_b if name.endswith("_batched")
            else lm_train["launches"][base] - n_b)
        for t in trains:                    # phase 13, split the same way
            n_b = t["launches_batched"].get(base, 0)
            k["launches_by_path"][f"train {t['arch']}"] = (
                n_b if name.endswith("_batched")
                else t["launches"][base] - n_b)
        if name == "proto_accum_batched":
            k["lm_train_device_us_per_launch"] = lm_train["proto_accum_us"]
            k["train_device_us_per_launch"] = {
                t["arch"]: t["proto_accum_us"] for t in trains}
        if name == "proto_accum_batched":
            k["launches_by_path"].update(
                {f"mesh lm train {st} (1 rank, a step)": mesh_lm["one_rank"][
                    "train"][st]["proto_accum_launches_a_step"]
                 for st in MESH_LM_STRATEGIES})
            k["launches_by_path"].update(
                {f"mesh lm train {st} (4 ranks, a rank a step)": t[
                    "proto_accum_launches"]
                 for st, t in mesh_lm["four_ranks"]["train"].items()})
            k["launches_by_path"]["lm pod train (2 ranks, a rank a step)"] = (
                pod["two_ranks"]["proto_accum_launches_a_step"][0][0])
            k["launches_by_path"].update(
                {f"lm pod {name} (4 ranks, a rank a step)": t[
                    "proto_accum_launches"]
                 for name, t in pod["four_ranks"]["cases"].items()})
            k["launches_by_path"].update(
                {f"mesh train {f['arch']} (1 rank, a step)": f["train"][
                    "proto_accum_launches"]
                 for f in fam_mesh["one_rank"]["families"] if "train" in f})
            k["launches_by_path"].update(
                {f"mesh train {a} (4 ranks, a rank a step)": t[
                    "proto_accum_launches"]
                 for a, t in fam_mesh["four_ranks"]["families"].items()})
        if name == "flash_attention":
            k["launches_by_path"]["serve tinyllama-1.1b"] = launches[name]
            k["launches_by_path"]["mesh lm serve (1 rank, a prefill)"] = (
                mesh_lm["one_rank"]["serve"]["flash_launches_a_prefill"])
            k["launches_by_path"]["mesh lm serve (4 ranks, a rank a "
                                  "prefill)"] = mesh_lm["four_ranks"][
                "serve_launches"]["flash_attention"]
            k["launches_by_path"].update(
                {f"serve {f['arch']}": f["flash_launches"] for f in families})
            k["launches_by_path"]["serve whisper-small"] = whisper[
                "flash_launches"]
            k["launches_by_path"].update(
                {f"mesh serve {f['arch']} (1 rank, {MESH_FAM_TOKENS} "
                 f"tokens)": f["flash_launches"]
                 for f in fam_mesh["one_rank"]["families"]})
            k["launches_by_path"].update(
                {f"mesh serve {a} (4 ranks, a rank, {MESH_FAM_TOKENS_B} "
                 f"tokens)": t["serve_launches"]["flash_attention"]
                 for a, t in fam_mesh["four_ranks"]["families"].items()})
            k["launches_by_path"][
                f"windowed prefill tinyllama-1.1b (1 x {WINDOW_RUN[0]} "
                f"tokens, window {WINDOW_RUN[1]})"] = window["kernel"][
                "launches"]
            k["max_abs_err"] = max([k["max_abs_err"]] + [
                r["max_abs_err"] for r in window["kernels"]["rows"]])
            k["window"] = {"timed_32k": window["kernel"],
                           "timed_4k": window["kernels"]["timed"],
                           "checks": window["kernels"]["rows"],
                           "prefill": window["prefill"],
                           "bf16_model_check": window["bf16_check"],
                           "f32_model_check": window["f32_check"],
                           "mesh_bit_equal": window["mesh_bit_equal"]}
            k["share_of_prefill_device_time"] = prof["flash_share"]
            k["controls_times_limit"] = {
                where: {n: c[0] for n, c in cs.items()}
                for where, cs in controls.items()}
            k["bf16_kernel_resources"] = resources["bf16"]
            k["f32_kernel_resources"] = resources["float32"]
            k["serve_check_f32"] = {"kernel_vs_plain": e_k,
                                    "decode_vs_prefill": e_d,
                                    "bf16_attention_control": e_c}
            k["family_checks_f32"] = family_checks
            k["whisper_check_f32"] = whisper_check
        kernels.append(k)
    print(f"[card] {smi}; vec over seq s/round: N={CLIENTS} "
          f"{scale['n5']:.3f}x, N={SCALE_CLIENTS} {scale['n32']:.3f}x; device "
          f"ops a round vec {ops_vec} seq {ops_seq}; N={SCALE_CLIENTS} "
          f"compaction {json.dumps(compaction)}; N={SCALE_CLIENTS} async "
          f"{json.dumps(async_scale)}; N={CLIENTS} shards "
          f"{json.dumps(shard_cost)}; N={SCALE_CLIENTS} population "
          f"{json.dumps(population)}; telemetry on / off "
          f"{json.dumps(telemetry)}; client mesh {json.dumps(mesh_one)} "
          f"{json.dumps(mesh_four)}; lm train parity "
          f"{json.dumps(lm_parity)}; lm train "
          f"{json.dumps({k: v for k, v in lm_train.items() if 'launches' not in k})}"
          f"; mesh lm {json.dumps(mesh_lm)}; lm pod {json.dumps(pod)}"
          f"; mesh families {json.dumps(fam_mesh)}"
          f"; lm twin 2 rounds {lm_twin_s:.2f} s; families "
          f"{json.dumps(families)}; whisper serve {json.dumps(whisper)}; "
          f"train kinds {json.dumps(train_rows)}; phase seconds "
          f"{json.dumps(lap.rows)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
