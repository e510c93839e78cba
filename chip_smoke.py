#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (`src/repro_torch/`).

  python3 chip_smoke.py        # from the repository root, on a CUDA machine

Phases (each failure raises, so the process exits non-zero):
  1. device: a CUDA device must be present; prints its name and power limit;
  2. build: compiles the hand-written kernels (`kernels/csrc/*.cu`) and
     prints the registers, shared memory and spills of the bf16 (tensor-core)
     flash_attention kernel;
  3. precision: TF32 off for cuDNN convolutions and matmuls;
  4. kernels: each kernel against its plain PyTorch version on the card at
     the main paths' shapes and larger ones, with times, the bound from
     bytes and operations, and a library call's time where one PyTorch call
     computes the same function;
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
  6. profile: one more round of each engine under torch.profiler (device
     busy share, device ops, time by kernel), then 2 rounds of each engine
     at N = 32 LeNet clients of 240 samples: the vec-over-seq ratio of
     s/round at N = 5 and N = 32;
  7. serve: full-width TinyLlama-1.1B (22 layers, bf16, random weights from
     seed 0) prefills 4 prompts of 1024 tokens and decodes 32 greedy tokens
     through `repro_torch.serve_lm.serve`; 22 flash_attention launches
     asserted, logits finite;
  8. serve check: the same width in float32 with 256-token prompts: prefill
     logits of the kernel path against the plain attention, and one decode
     step after a prefill of S-1 tokens against the prefill of S;
  9. serve profile: one prefill and 4 decode steps under torch.profiler
     (device busy share, flash_attention's device time per launch and its
     share of the prefill's device time).
Phase 4 also holds three faulty flash results at the serving shape against
the bf16 check, which must reject each: a bf16 accumulator, the last 16 keys
dropped, and P rounded to bf16 once before P V.
Phase 4 also runs every disc_loss and proto_accum shape twice and requires
equal bits, and runs the kernels with a leading client axis (the vectorized
engine's shapes), whose results must be bit-equal to one launch a client,
also on a (k, ...) block gathered by `index_select` from an N-client stack
(static-k compaction's shapes: k = 3 of 5, 8 of 32); phase 6 requires one
kernel symbol a wrapper call.
It prints a JSON line of per-kernel results (with share_of_bound, bound_ms
over ms, device_us_per_launch from the profiles, and launches_by_path from
phases 5c and 5d) before the last line,
and as the last line {"ok": true, ...}.
"""
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MEM_BPS = 3.35e12          # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM bf16 dense tensor cores
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
RING_INTS = ("ptr", "owner", "valid", "stamp", "clock", "valid_g")
SCALE_CLIENTS, SCALE_ROUNDS = 32, 2   # class_images(7680): 240 samples a client
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
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 1024, 32
CHECK_PROMPT = 256
# float32 serving check: |kernel path - plain| <= CHECK_TOL * max(1, |plain|)
# over the last position's logits: 22 layers of float32 products summed in
# another order (the same bound for decode against prefill). The H100 reads
# about 3.4e-6 x max|logit| for both; bf16 attention in the same model must
# fail it.
CHECK_TOL = 5e-5


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
    res = flash_resources(build.BUILD_LOG["flash_attention"],
                          build.lib("flash_attention"))
    for tag, r in res.items():
        print(f"[build] flash_attention_bf16_kernel {tag}: {r['registers']} "
              f"registers a thread at entry (setmaxnreg moves them between "
              f"producer and consumers), {r['smem_bytes']} bytes of dynamic shared "
              f"memory, {r['spill_stores']} / {r['spill_loads']} bytes of spill"
              f" stores / loads")
    return res


def flash_resources(log, lib):
    """ptxas -v's registers and spills of each bf16 flash kernel, and its
    dynamic shared memory -> {"hd64 causal": {...}, ...}."""
    res, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*flash_attention_bf16_kernel"
                      r"ILi(\d+)ELb(\d)", line)
        if m:
            hd = int(m.group(1))
            cur = f"hd{hd} {'causal' if m.group(2) == '1' else 'full'}"
            res[cur] = {"smem_bytes": lib.flash_attention_bf16_smem(hd)}
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
    if len(res) != 6 or any(len(r) != 4 for r in res.values()):
        raise AssertionError(f"ptxas -v did not report the six bf16 flash "
                             f"kernels: {res}")
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
    per = [ops.proto_accum(f[i], lab[i], C) for i in range(N)]
    torch.cuda.synchronize()
    for k in range(2):
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
    print(f"[kernels] {tag}: max_abs_err {err:.3e}, bit-equal to {N} "
          f"one-client launches, kernel_ms {r['ms']:.4f} plain_ms "
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
    reject both."""
    B, Sq, H, hd = q.shape
    G = k.shape[2]
    qf = q.reshape(B, Sq, G, H // G, hd).float() * hd ** -0.5
    m = torch.full((B, G, Sq, H // G, 1), -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, G, Sq, H // G, hd, device=q.device)
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
    return o.permute(0, 2, 1, 3, 4).reshape(B, Sq, H, hd).to(q.dtype)


def flash_controls(B, S, H, G, hd, dev, gen):
    """Three faulty results at the serving shape, bf16 causal, that the bf16
    check must reject: the bf16-accumulating emulation, attention that drops
    the last 16 keys, and P rounded to bf16 once. -> {name: (excess, old
    excess)}, the old being against 2e-2 x max(1, max|plain|)."""
    from repro_torch.kernels import ref
    q, k, v = (torch.randn(B, S, n, hd, generator=gen).bfloat16().to(dev)
               for n in (H, G, G))
    want = ref.flash_attention(q, k, v, causal=True)
    old_lim = 2e-2 * max(1.0, float(want.float().abs().max()))
    out = {}
    for name, bad in (
            ("bf16 accumulator",
             flash_faulty(q, k, v, True, "bf16 accumulator", bk=32)),
            ("last 16 keys dropped",
             ref.flash_attention(q, k[:, :-16], v[:, :-16], causal=True)),
            ("P rounded to bf16 once",
             flash_faulty(q, k, v, True, "P rounded to bf16 once", bk=128))):
        ex = flash_excess(bad, want)
        old = float((bad.float() - want.float()).abs().max()) / old_lim
        print(f"[kernels] control ({B}, {S}, {H}, {G}, {hd}) bf16 causal, "
              f"{name}: {ex:.2f} x the limit (the old 2e-2 x max|plain| limit:"
              f" {old:.2f} x)")
        if not ex > 1:
            raise AssertionError(f"the bf16 check passes a faulty kernel "
                                 f"({name}): {ex:.3f} x the limit")
        out[name] = (ex, old)
    return out


def check_flash(B, S, H, G, hd, dtype, causal, dev, gen):
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    q = torch.randn(B, S, H, hd, generator=gen).to(dtype).to(dev)
    k = torch.randn(B, S, G, hd, generator=gen).to(dtype).to(dev)
    v = torch.randn(B, S, G, hd, generator=gen).to(dtype).to(dev)
    tag = (f"flash_attention ({B}, {S}, {H}, {G}, {hd}) "
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
    reps = 20 if S >= 1024 else 50
    r = dict(ms=time_ms(lambda: ops.flash_attention(q, k, v, causal=causal),
                        reps),
             plain_ms=time_ms(lambda: ref.flash_attention(q, k, v,
                                                          causal=causal), reps),
             library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=causal, enable_gqa=True), reps),
             max_abs_err=err, limit_used=excess)
    # q and k/v read once, the output written once; 4 B H S S hd operations
    # (two products), half of them unmasked when causal
    flops = 4 * B * H * S * S * hd / (2 if causal else 1)
    r["bound_ms"], r["bound_by"] = bound_ms(
        (2 * B * S * H + 2 * B * S * G) * hd * q.element_size(), flops,
        BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    lim = ("1e-4 + 2^-7 |plain|" if dtype == torch.bfloat16
           else f"{FLASH_F32_TOL} x max(1, |plain|)")
    print(f"[kernels] {tag}: max_abs_err {err:.3e}, {excess:.3f} x the limit "
          f"({lim}) kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
          f"library_ms {r['library_ms']:.4f} (scaled_dot_product_attention) "
          f"bound_ms {r['bound_ms']:.6f} ({r['bound_by']}), "
          f"{r['share_of_bound']:.3f} of the bound")
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
    for B, S, H, G, hd in FLASH_SHAPES:        # the main path's row first
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                r = check_flash(B, S, H, G, hd, dtype, causal, dev, gen)
                res["flash_attention"].append(dict(
                    r, shape=[B, S, H, G, hd, str(dtype).split(".")[-1],
                              "causal" if causal else "full"]))
    res["flash_controls"] = flash_controls(*FLASH_SHAPES[0], dev, gen)
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


def profile(fn):
    """fn() under torch.profiler -> (host wall s, the device events of
    key_averages())."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages()
          if getattr(e, "device_type", None) is not None
          and str(e.device_type).endswith("CUDA")]
    return wall, ev


def report_profile(tag, wall, ev, top=12):
    """Prints busy share and the top kernels; returns busy us and, for each
    LAUNCHES key of the port, (launches, device us) of its kernels."""
    from repro_torch.kernels import ops
    busy_us = sum(e.self_device_time_total for e in ev)
    print(f"[{tag}] wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f}%), "
          f"{sum(e.count for e in ev)} device ops")
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
    bucket's step and the shared relay commit of a mixed fleet) so that a
    host sync inside one raises (CUDA sync-debug mode "error"); -> a
    function that unwraps them."""
    owners = ([(b, "step") for b in vec.buckets] + [(vec, "_relay_commit")]
              if vec.hetero else [(vec, "_round_step")])
    saved = [(o, a, getattr(o, a)) for o, a in owners]

    def wrap(step):
        def no_sync_step(*args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return step(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return no_sync_step

    for o, a, step in saved:
        setattr(o, a, wrap(step))
    return lambda: [setattr(o, a, step) for o, a, step in saved]


def timed_rounds(trainer, tag):
    """ROUNDS rounds with the launch counts set to 0 just before and read
    just after -> (launches (fwd, bwd, proto), seconds per round)."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    secs = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        rec = trainer.run_round()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        for m in rec["metrics"]:
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"{tag}: non-finite metrics {m}")
    n = dict(ops.LAUNCHES)
    if n["flash_attention"]:
        raise AssertionError(f"{tag}: flash_attention launched")
    return (n["disc_loss_fwd"], n["disc_loss_bwd"], n["proto_accum"]), secs


def same_ring(a, b, what):
    """Ring integers (and ages) of two trainers' relay states equal."""
    for f in RING_INTS + (("age",) if hasattr(a, "age") else ()):
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


def phase_profile(engine, tag, batched):
    """One more round under torch.profiler: device busy share, device ops,
    the device time by kernel name, and one kernel symbol a wrapper call for
    the slice's kernels (KERNEL_SYMBOLS). -> (device us a launch by kernel,
    device ops, busy share, busy us)."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    wall, ev = profile(engine.run_round)
    calls = dict(ops.LAUNCHES)
    busy, port = report_profile(tag, wall, ev)
    for name in ("disc_loss_fwd", "disc_loss_bwd", "proto_accum"):
        if port.get(name, (0, 0))[0] != calls[name]:
            raise AssertionError(f"{name}: {port.get(name)} kernels for "
                                 f"{calls[name]} wrapper calls")
    total = sum(us for n, us in port.values())
    print(f"[{tag}] one kernel a wrapper call; the port's kernels "
          f"{total / 1e3:.4f} ms of device time a round")
    sfx = "_batched" if batched else ""
    return ({name + sfx: us / n for name, (n, us) in port.items()},
            sum(e.count for e in ev), busy / 1e6 / wall, busy)


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
        wall, ev = profile(run_prefill)
        busy, port = report_profile("serve profile prefill", wall, ev)
        n, us = port["flash_attention"]
        print(f"[serve profile prefill] flash_attention: {us / n:.2f} us per "
              f"launch, {100 * us / busy:.1f}% of the prefill's device time")

        def run_decode():
            nxt = state["nxt"]
            for i in range(4):
                out = decode(params, {"tokens": nxt}, state["caches"],
                             cache_index=toks.shape[1] + i, masked=True)
                nxt = out["logits"][:, -1].argmax(-1)[:, None]
        wall_d, ev_d = profile(run_decode)
        busy_d, _ = report_profile("serve profile decode x4", wall_d, ev_d,
                                   top=8)
        print(f"[serve profile decode x4] {sum(e.count for e in ev_d) / 4:.0f}"
              f" device ops and {wall_d / 4 * 1e3:.2f} ms a step")
    return {"flash_device_us": us / n, "flash_share": us / busy,
            "prefill_busy": busy / 1e6 / wall, "decode_busy": busy_d / 1e6 / wall_d}


def main():
    smi = phase_device()
    dev = torch.device("cuda")
    resources = phase_build()
    phase_precision()
    res = phase_kernels(dev)
    gpu, launches, secs_seq = phase_slice(dev)
    vec, launches_vec, secs_vec = phase_vec(dev, gpu)
    paths = phase_baselines(dev)
    paths.update(phase_participation(dev))
    compaction = phase_compaction(dev)
    dev_us, ops_seq, busy_seq, _ = phase_profile(gpu, "profile seq", False)
    dev_us_vec, ops_vec, busy_vec, _ = phase_profile(vec, "profile vec", True)
    dev_us.update(dev_us_vec)
    print(f"[profile] device ops a round: vec {ops_vec}, seq {ops_seq} "
          f"({ops_vec / ops_seq:.3f} of seq); device busy vec "
          f"{100 * busy_vec:.1f}%, seq {100 * busy_seq:.1f}%")
    del gpu, vec
    scale = phase_scale(dev, secs_seq, secs_vec)
    torch.cuda.empty_cache()
    cfg, params, prompts, serve_launches, _ = phase_serve(dev)
    prof = phase_serve_profile(cfg, params, prompts)
    del params
    torch.cuda.empty_cache()
    e_k, e_d, e_c = phase_serve_check(dev)
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
        if name == "flash_attention":
            k["share_of_prefill_device_time"] = prof["flash_share"]
            k["controls_times_limit"] = {n: c[0] for n, c in controls.items()}
            k["bf16_kernel_resources"] = resources
            k["serve_check_f32"] = {"kernel_vs_plain": e_k,
                                    "decode_vs_prefill": e_d,
                                    "bf16_attention_control": e_c}
        kernels.append(k)
    print(f"[card] {smi}; vec over seq s/round: N={CLIENTS} "
          f"{scale['n5']:.3f}x, N={SCALE_CLIENTS} {scale['n32']:.3f}x; device "
          f"ops a round vec {ops_vec} seq {ops_seq}; N={SCALE_CLIENTS} "
          f"compaction {json.dumps(compaction)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
