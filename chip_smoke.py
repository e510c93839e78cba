#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (`src/repro_torch/`).

  python3 chip_smoke.py        # from the repository root, on a CUDA machine

Phases (each failure raises, so the process exits non-zero):
  1. device: a CUDA device must be present; prints its name and power limit;
  2. build: compiles the hand-written kernels (`kernels/csrc/*.cu`);
  3. precision: TF32 off for cuDNN convolutions and matmuls;
  4. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes and larger ones, with times, the bound from
     bytes and operations, and a library call's time where one PyTorch call
     computes the same function;
  5. slice: 3 synchronous CoRS rounds of 5 LeNet clients (the example's data
     sizes) on the card, with the kernels' launch counts asserted, then the
     same 3 rounds on the CPU: ring state and ledger equal, accuracies close;
  6. profile: one more round under torch.profiler (device busy share, time by
     kernel).
It prints a JSON line of per-kernel results before the last line, and as the
last line {"ok": true, "device": {...}}.
"""
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
TOL = 1e-5                 # max |kernel - plain| <= TOL * max(1, max |plain|)
ROUNDS, CLIENTS = 3, 5
STEPS = 7                  # 240 samples a client / batch 32, remainder dropped


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


def bound_ms(nbytes, flops):
    t_b, t_o = nbytes / MEM_BPS * 1e3, flops / F32_FLOPS * 1e3
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
    torch.cuda.synchronize()
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
    # bytes: each input read once, each output written once (f32 / int32)
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(
        4 * (B * C + M * C + B + M) + 4 * (3 * B + B * M),
        2 * B * C * M + 4 * B * C + 6 * B * M)
    bwd["bound_ms"], bwd["bound_by"] = bound_ms(
        4 * (B * C + M * C + 4 * B + M + B * M) + 4 * (B * C + M * C),
        4 * B * C * M + 6 * B * C + 8 * B * M)
    for name, r in (("fwd", fwd), ("bwd", bwd)):
        print(f"[kernels] {tag} {name}: max_abs_err {r['max_abs_err']:.3e} "
              f"(tol {TOL} x max(1, |plain|)) kernel_ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.6f} "
              f"({r['bound_by']})")
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
    print(f"[kernels] {tag}: max_abs_err {err:.3e} kernel_ms {r['ms']:.4f} "
          f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
          f"(index_add_ on f32) bound_ms {r['bound_ms']:.6f} ({r['bound_by']})")
    return r


def phase_kernels(dev):
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(0)
    res = {"disc_loss_fwd": [], "disc_loss_bwd": [], "proto_accum": []}
    for B, C, M in ((32, 10, 10), (320, 10, 10), (2048, 4096, 256)):
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
    # out-of-range labels contribute nothing
    f = torch.randn(1000, 64, generator=gen).to(dev)
    lab = torch.randint(-3, 303, (1000,), generator=gen).to(dev)
    from repro_torch.kernels import ref
    max_err(ops.proto_accum(f, lab, 300), ref.proto_accum(f, lab, 300),
            "proto_accum out-of-range labels")
    return res


def phase_slice(dev):
    from repro_torch.collab_image_classification import build_trainer
    from repro_torch.kernels import ops
    gpu = build_trainer(CLIENTS, "cors", seed=0, device=dev)
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
            "proto_accum": CLIENTS * ROUNDS}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    for h in gpu.history:
        for m in h["metrics"]:
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"non-finite metrics {m}")

    cpu = build_trainer(CLIENTS, "cors", seed=0, device="cpu")
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


def phase_profile(gpu):
    """One more round under torch.profiler: device busy share and the
    device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gpu.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages()
          if getattr(e, "device_type", None) is not None
          and str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.self_device_time_total for e in ev)
    print(f"[profile] round wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f}%), "
          f"{sum(e.count for e in ev)} device ops")
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:5d}  {e.key[:90]}")
    for e in ev:
        hit = re.search(r"(disc_\w+|proto_accum_kernel<\w+>)", e.key)
        if hit:
            print(f"[profile] port kernel {hit.group(1)}: x{e.count}, "
                  f"{e.self_device_time_total / e.count:.2f} us device time "
                  f"per launch")


def main():
    smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    phase_precision()
    res = phase_kernels(dev)
    gpu, launches, _ = phase_slice(dev)
    phase_profile(gpu)

    src = "src/repro_torch/kernels/csrc/"
    meta = {
        "disc_loss_fwd": (src + "disc_loss.cu", "src/repro/kernels/disc_loss.py:30"),
        "disc_loss_bwd": (src + "disc_loss.cu", "src/repro/kernels/disc_loss.py:30"),
        "proto_accum": (src + "proto_accum.cu", "src/repro/kernels/proto_accum.py:22"),
    }
    kernels = []
    for name, rows in res.items():
        main_row = rows[0]                 # the main path's shape, first
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "shape": main_row["shape"],
            "shapes": rows})
    print(f"[card] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
