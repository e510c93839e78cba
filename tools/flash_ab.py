#!/usr/bin/env python3
"""The flash kernels of this tree against another tree's, on the card.

  python3 tools/flash_ab.py --other DIR [--sass] [--turns N] [--out FILE.json]

DIR holds another tree of this repository, for example the parent commit
(`git archive <rev> | tar -x -C DIR`). The script builds DIR's
`src/repro_torch/kernels/csrc/flash_attention.cu` with this tree's nvcc
flags beside this tree's library, then calls both libraries' C entry points
`flash_attention_bf16` and `flash_attention_f32` on the same inputs, each
by its own signature (a tree whose entry point takes a sliding window gets
window 0, none; a float32 entry that takes a workspace and counters gets
them as its library's `flash_attention_f32_workspace` and `_counters` size
them):

  1. bit-equality: at phase 4's equal-dim bf16 shapes of `chip_smoke.py`
     (FLASH_SHAPES causal and full, FLASH_FAMILY_SHAPES causal,
     WHISPER_FLASH_SHAPES as phase 12 runs them) the two outputs must be
     equal bit for bit; it exits non-zero if one is not;
  2. code: with `--sass`, the machine code of each bf16 instance
     (`cuobjdump -sass`: the tensor-core kernel's, and the CUDA-core
     kernel's at (80, 64)) of the two libraries, compared instruction by
     instruction where both have the instance (the other tree's instances
     named by hd alone are taken as (hd, hd));
  3. bf16 times: CUDA events over `chip_smoke.time_ms`'s repetitions, the
     two libraries in `--turns` rounds of (other, this, this, other), at
     MLA's published pairs (bf16, causal and full, phase 11's shapes) and at
     the equal-dim serving shape, beside scaled_dot_product_attention's time
     in the same turns and the bound of `chip_smoke.check_flash`;
  4. float32 times: the same turns at every float32 shape of phase 4
     (FLASH_SHAPES and FLASH_MLA_SHAPES causal and full, WHISPER_FLASH_SHAPES
     as phase 12 runs them, which hold phases 11's and 12's shapes) and at
     FLASH_FAMILY_SHAPES causal, beside SDPA's time in float32, the float32
     bound (operations at 67 TFLOP/s) and the 3xTF32 bound (3 x the
     operations at TF32's 495), with each side's max |out - plain| (the
     arithmetic changed, so float32 outputs are not compared bit for bit),
     then each side's device time a launch by the profiler.

Needs a CUDA card; prints the card's name and power limit first.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import build  # noqa: E402


class Lib(NamedTuple):
    """A loaded flash library, whether its entry points take the sliding
    window (an int after `causal`), and whether its float32 entry point
    takes a workspace and counters (two pointers after the output)."""
    cdll: ctypes.CDLL
    windowed: bool
    f32_scratch: bool


def params(src: Path, fn: str) -> str:
    """The parameter list of a source's C entry point `fn`."""
    m = re.search(rf'extern "C" int {fn}\((.*?)\)', src.read_text(), re.S)
    if m is None:
        raise SystemExit(f"no {fn} entry point in {src}")
    return m.group(1)


def load(src: Path, so: Path) -> Lib:
    """A library built from `src`, typed by the source's own signatures."""
    lib = ctypes.CDLL(str(so))
    windowed = "window" in params(src, "flash_attention_bf16")
    scratch = "ws" in params(src, "flash_attention_f32")
    P, I = ctypes.c_void_p, ctypes.c_int
    ints = [I] * (9 if windowed else 8)
    lib.flash_attention_bf16.argtypes = [P] * 4 + ints + [P]
    lib.flash_attention_f32.argtypes = [P] * (6 if scratch else 4) + ints + [P]
    lib.flash_attention_bf16.restype = lib.flash_attention_f32.restype = I
    if scratch:
        for fn in ("flash_attention_f32_workspace",
                   "flash_attention_f32_counters",
                   "flash_attention_f32_splits"):
            getattr(lib, fn).argtypes = [I] * 8
            getattr(lib, fn).restype = I
    return Lib(lib, windowed, scratch)


def build_other(other: Path):
    """DIR's flash_attention.cu compiled into build/kernels/ and loaded,
    typed by its own signature -> (Lib, its path)."""
    src = other / "src/repro_torch/kernels/csrc/flash_attention.cu"
    out = build.BUILD_DIR / "libflash_attention.other.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    return load(src, out), out


def sass_by_instance(so: Path):
    """{(hd, hv, causal): [instruction lines]} of a library's bf16 flash
    kernels, from `cuobjdump -sass`: the tensor-core kernel's instances and
    the CUDA-core kernel's bf16 one at (80, 64)."""
    tool = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = re.search(r"(?:flash_attention_bf16_kernelI|"
                          r"flash_attention_kernelI13__nv_bfloat16)"
                          r"Li(\d+)E(?:Li(\d+)E)?Lb(\d)", line)
            cur = None
            if m:
                hd = int(m.group(1))
                hv = int(m.group(2)) if m.group(2) else hd
                cur = (hd, hv, m.group(3) == "1")
                out[cur] = []
        elif cur and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            out[cur].append(line.strip())
    return out


def call(lib, q, k, v, causal):
    """One launch of a Lib's bf16 entry point, without a window -> (B, Sq,
    H, hv) bf16."""
    B, Sq, H, hd = q.shape
    Sk, G, hv = k.shape[1], k.shape[2], v.shape[3]
    o = q.new_empty(B, Sq, H, hv)
    window = (0,) if lib.windowed else ()
    rc = lib.cdll.flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk, H,
        G, hd, hv, int(causal), *window,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_bf16 returned {rc} at "
                           f"{tuple(q.shape)}, {tuple(v.shape)}")
    return o


def scratch_args(lib, q, k, v, causal):
    """The workspace and counter pointers a Lib's float32 entry point takes
    for a call (none for an entry without them), sized by its own plan once
    a case, outside the timed calls: -> a tuple of arguments."""
    if not lib.f32_scratch:
        return ()
    B, Sq, H, hd = q.shape
    Sk, hv = k.shape[1], v.shape[3]
    plan = (B, Sq, Sk, H, hd, hv, int(causal), 0)
    n_ws = lib.cdll.flash_attention_f32_workspace(*plan)
    n_cnt = lib.cdll.flash_attention_f32_counters(*plan)
    if not n_ws:
        return (None, None)
    ws = torch.empty(n_ws, device=q.device)
    _KEEP.append(ws)
    return ws.data_ptr(), _zeroed(n_cnt).data_ptr()


def call_f32(lib, q, k, v, causal, scratch):
    """One launch of a Lib's float32 entry point, without a window, with
    `scratch_args`'s arguments -> (B, Sq, H, hv) float32."""
    B, Sq, H, hd = q.shape
    Sk, G, hv = k.shape[1], k.shape[2], v.shape[3]
    o = q.new_empty(B, Sq, H, hv)
    window = (0,) if lib.windowed else ()
    rc = lib.cdll.flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *scratch, B,
        Sq, Sk, H, G, hd, hv, int(causal), *window,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_f32 returned {rc} at "
                           f"{tuple(q.shape)}, {tuple(v.shape)}")
    return o


_COUNTERS = {}
_KEEP = []                   # workspaces alive for the script's length


def _zeroed(n):
    """Zeroed int counters, at least n, shared by the calls (each launch
    leaves them at zero)."""
    buf = _COUNTERS.get("buf")
    if buf is None or buf.numel() < n:
        buf = _COUNTERS["buf"] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                             device="cuda")
    return buf


def inputs(B, Sq, Sk, H, G, hd, hv, gen, dtype=torch.bfloat16):
    return tuple(torch.randn(*s, generator=gen).to(dtype).cuda()
                 for s in ((B, Sq, H, hd), (B, Sk, G, hd), (B, Sk, G, hv)))


def equal_dim_cases():
    """(B, Sq, Sk, H, G, hd, causal) of phase 4's equal-dim bf16 rows."""
    for B, S, H, G, hd in cs.FLASH_SHAPES:
        for causal in (True, False):
            yield B, S, S, H, G, hd, causal
    for B, S, H, G, hd in cs.FLASH_FAMILY_SHAPES:
        yield B, S, S, H, G, hd, True
    for B, Sq, Sk, H, G, hd, causal in cs.WHISPER_FLASH_SHAPES:
        yield B, Sq, Sk, H, G, hd, causal


def f32_cases():
    """(B, Sq, Sk, H, G, hd, hv, causal) of the float32 rows: phase 4's,
    which hold phases 11's and 12's shapes, and the GQA families' prefills."""
    for B, S, H, G, hd in cs.FLASH_SHAPES:
        for causal in (True, False):
            yield B, S, S, H, G, hd, hd, causal
    for B, Sq, Sk, H, G, hd, hv in cs.FLASH_MLA_SHAPES:
        for causal in (True, False):
            yield B, Sq, Sk, H, G, hd, hv, causal
    for B, Sq, Sk, H, G, hd, causal in cs.WHISPER_FLASH_SHAPES:
        yield B, Sq, Sk, H, G, hd, hd, causal
    for B, S, H, G, hd in cs.FLASH_FAMILY_SHAPES:
        yield B, S, S, H, G, hd, hd, True


def device_us(fn, calls=20):
    """The profiler's device time a flash launch of fn(), in us."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "flash_attention" in e.key]
    return sum(e.device_time_total for e in ev) / max(1, sum(e.count for e in ev))


def time_f32(other, this, turns, gen):
    """Section 4 of the docstring -> a row a case. After every case's turns
    (a profiler session slows a process's later small launches), each
    side's device time a launch by the profiler: at the small shapes the
    turns time the host's calls, not the card."""
    from repro_torch.kernels import ref
    rows, calls = [], []
    for B, Sq, Sk, H, G, hd, hv, causal in f32_cases():
        q, k, v = inputs(B, Sq, Sk, H, G, hd, hv, gen, torch.float32)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        want = ref.flash_attention(q, k, v, causal=causal)
        libs = {"other": other, "this": this}
        scratch = {w: scratch_args(lib, q, k, v, causal)
                   for w, lib in libs.items()}
        err = {w: float((call_f32(lib, q, k, v, causal, scratch[w])
                         - want).abs().max()) for w, lib in libs.items()}
        reps = 20 if max(Sq, Sk) >= 1024 else 50
        t = {"other": [], "this": [], "sdpa": []}
        for who in ("other", "this", "this", "other") * turns:
            t[who].append(cs.time_ms(lambda: call_f32(
                libs[who], q, k, v, causal, scratch[who]), reps))
            t["sdpa"].append(cs.time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True), reps))
        flops = 2 * B * H * Sq * Sk * (hd + hv) / (2 if causal else 1)
        nbytes = (B * Sq * H + B * Sk * G) * (hd + hv) * 4
        bound, by = cs.bound_ms(nbytes, flops, cs.F32_FLOPS)
        bound3, by3 = cs.bound_ms(nbytes, 3 * flops, cs.TF32_FLOPS)
        splits = (this.cdll.flash_attention_f32_splits(
            B, Sq, Sk, H, hd, hv, int(causal), 0) if this.f32_scratch else 1)
        mean = {w: sum(x) / len(x) for w, x in t.items()}
        lim = cs.FLASH_F32_TOL * max(1.0, float(want.abs().max()))
        row = {"shape": [B, Sq, Sk, H, G, hd, hv,
                         "causal" if causal else "full"],
               "other_ms": t["other"], "this_ms": t["this"],
               "sdpa_ms": t["sdpa"], "bound_ms": bound, "bound_by": by,
               "bound_3xtf32_ms": bound3, "bound_3xtf32_by": by3,
               "splits": splits, "other_max_abs_err": err["other"],
               "this_max_abs_err": err["this"], "limit": lim}
        row.update({f"{w}_mean_ms": m for w, m in mean.items()})
        rows.append(row)
        calls.append({w: (lambda lib=lib, a=(q, k, v, causal, scratch[w]):
                          call_f32(lib, *a)) for w, lib in libs.items()})
        print(f"[ab] ({B}, {Sq}x{Sk}, {H}, {G}, {hd}/{hv}) float32 "
              f"{'causal' if causal else 'full'}: other "
              f"{mean['other']:.4f} ms, this {mean['this']:.4f} ms "
              f"({mean['other'] / mean['this']:.2f}x), sdpa "
              f"{mean['sdpa']:.4f} ms (this / sdpa "
              f"{mean['this'] / mean['sdpa']:.2f}); bounds float32 "
              f"{bound:.6f} ms ({by}), 3xTF32 {bound3:.6f} ms ({by3}, "
              f"{bound3 / mean['this']:.3f} of it); key splits {splits}; "
              f"max |d| to plain other {err['other']:.3e}, this "
              f"{err['this']:.3e} ({err['this'] / lim:.3f} x the limit); "
              f"turns other {t['other']}, this {t['this']}")
    for row, fns in zip(rows, calls):
        for w, fn in fns.items():
            row[f"{w}_device_us"] = device_us(fn)
        print(f"[ab] {row['shape']} float32 device us a launch: other "
              f"{row['other_device_us']:.2f}, this {row['this_device_us']:.2f}")
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    smi = cs.phase_device()
    cs.phase_precision()
    build.lib("flash_attention")
    this = load(build.CSRC / "flash_attention.cu",
                build._target("flash_attention"))
    other, other_so = build_other(args.other)
    gen = torch.Generator().manual_seed(0)

    code = {}
    if args.sass:
        a = sass_by_instance(other_so)
        b = sass_by_instance(build._target("flash_attention"))
        for key in sorted(set(a) & set(b)):
            same = a[key] == b[key]
            code[f"{key[0]}/{key[1]} {'causal' if key[2] else 'full'}"] = {
                "same_sass": same, "instructions": [len(a[key]),
                                                    len(b[key])]}
            print(f"[ab] sass {key}: {'identical' if same else 'DIFFERENT'} "
                  f"({len(a[key])} / {len(b[key])} instructions)")

    bits = []
    for B, Sq, Sk, H, G, hd, causal in equal_dim_cases():
        q, k, v = inputs(B, Sq, Sk, H, G, hd, hd, gen)
        a, b = call(other, q, k, v, causal), call(this, q, k, v, causal)
        torch.cuda.synchronize()
        same = torch.equal(a.view(torch.int16), b.view(torch.int16))
        bits.append({"shape": [B, Sq, Sk, H, G, hd,
                               "causal" if causal else "full"],
                     "bit_equal": same})
        print(f"[ab] equal dims ({B}, {Sq}x{Sk}, {H}, {G}, {hd}) "
              f"{'causal' if causal else 'full'}: "
              f"{'bit-equal' if same else 'DIFFERENT'}")

    times = []
    shapes = list(cs.FLASH_MLA_SHAPES[:2])                 # phase 11's MLA
    shapes.append((4, 1024, 1024, 32, 4, 64, 64))          # serving, hd 64
    for B, Sq, Sk, H, G, hd, hv in shapes:
        q, k, v = inputs(B, Sq, Sk, H, G, hd, hv, gen)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        reps = 20 if Sk >= 1024 else 50
        for causal in (True, False):
            t = {"other": [], "this": [], "sdpa": []}
            for who in ("other", "this", "this", "other") * args.turns:
                lib = other if who == "other" else this
                t[who].append(cs.time_ms(lambda: call(lib, q, k, v, causal),
                                         reps))
                t["sdpa"].append(cs.time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True), reps))
            flops = 2 * B * H * Sq * Sk * (hd + hv) / (2 if causal else 1)
            bound, by = cs.bound_ms((B * Sq * H + B * Sk * G) * (hd + hv) * 2,
                                    flops, cs.BF16_FLOPS)
            row = {"shape": [B, Sq, Sk, H, G, hd, hv,
                             "causal" if causal else "full"],
                   "other_ms": t["other"], "this_ms": t["this"],
                   "sdpa_ms": t["sdpa"], "bound_ms": bound, "bound_by": by}
            mean = {w: sum(x) / len(x) for w, x in t.items()}
            row.update({f"{w}_mean_ms": m for w, m in mean.items()})
            times.append(row)
            print(f"[ab] ({B}, {Sq}x{Sk}, {H}, {G}, {hd}/{hv}) bf16 "
                  f"{'causal' if causal else 'full'}: other "
                  f"{mean['other']:.4f} ms, this {mean['this']:.4f} ms "
                  f"({mean['other'] / mean['this']:.2f}x), sdpa "
                  f"{mean['sdpa']:.4f} ms (this / sdpa "
                  f"{mean['this'] / mean['sdpa']:.2f}), bound {bound:.6f} ms "
                  f"({by}, {bound / mean['this']:.3f} of it); turns other "
                  f"{t['other']}, this {t['this']}")
    times_f32 = time_f32(other, this, args.turns, gen)
    result = {"device": smi, "bit_equal": bits, "sass": code, "times": times,
              "times_f32": times_f32}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"all_bit_equal": all(b["bit_equal"] for b in bits),
                      "cases": len(bits)}))
    if not all(b["bit_equal"] for b in bits):
        raise SystemExit("FAIL: an equal-dim bf16 output differs from the "
                         "other tree's")


if __name__ == "__main__":
    main()
