#!/usr/bin/env python3
"""The bf16 flash kernel of this tree against another tree's, on the card.

  python3 tools/flash_ab.py --other DIR [--sass] [--turns N] [--out FILE.json]

DIR holds another tree of this repository, for example the parent commit
(`git archive <rev> | tar -x -C DIR`). The script builds DIR's
`src/repro_torch/kernels/csrc/flash_attention.cu` with this tree's nvcc
flags beside this tree's library, then calls both libraries' C entry point
`flash_attention_bf16` on the same inputs, each by its own signature (a
tree whose entry point takes a sliding window gets window 0, none):

  1. bit-equality: at phase 4's equal-dim bf16 shapes of `chip_smoke.py`
     (FLASH_SHAPES causal and full, FLASH_FAMILY_SHAPES causal,
     WHISPER_FLASH_SHAPES as phase 12 runs them) the two outputs must be
     equal bit for bit; it exits non-zero if one is not;
  2. code: with `--sass`, the machine code of each bf16 tensor-core
     instance (`cuobjdump -sass`) of the two libraries, compared instruction
     by instruction where both have the instance (the other tree's
     instances named by hd alone are taken as (hd, hd));
  3. times: CUDA events over `chip_smoke.time_ms`'s repetitions, the two
     libraries in `--turns` rounds of (other, this, this, other), at MLA's
     published pairs (bf16, causal and full, phase 11's shapes) and at the
     equal-dim serving shape, beside scaled_dot_product_attention's time in
     the same turns and the bound of `chip_smoke.check_flash`.

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
    """A loaded flash library and whether its bf16 entry point takes the
    sliding window (an int after `causal`)."""
    cdll: ctypes.CDLL
    windowed: bool


def takes_window(src: Path) -> bool:
    """Whether a source's `flash_attention_bf16` has a `window` parameter."""
    m = re.search(r'extern "C" int flash_attention_bf16\((.*?)\)',
                  src.read_text(), re.S)
    if m is None:
        raise SystemExit(f"no flash_attention_bf16 entry point in {src}")
    return "window" in m.group(1)


def build_other(other: Path):
    """DIR's flash_attention.cu compiled into build/kernels/ and loaded,
    typed by its own signature -> (Lib, its path)."""
    src = other / "src/repro_torch/kernels/csrc/flash_attention.cu"
    out = build.BUILD_DIR / "libflash_attention.other.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    windowed = takes_window(src)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bf16.argtypes = [P] * 4 + [I] * (9 if windowed
                                                         else 8) + [P]
    lib.flash_attention_bf16.restype = ctypes.c_int
    return Lib(lib, windowed), out


def sass_by_instance(so: Path):
    """{(hd, hv, causal): [instruction lines]} of a library's bf16
    tensor-core flash kernels, from `cuobjdump -sass`."""
    tool = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_attention_bf16_kernelILi(\d+)E(?:Li(\d+)E)?"
                          r"Lb(\d)", line)
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


def inputs(B, Sq, Sk, H, G, hd, hv, gen):
    return tuple(torch.randn(*s, generator=gen).bfloat16().cuda()
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    smi = cs.phase_device()
    cs.phase_precision()
    this = Lib(build.lib("flash_attention"), takes_window(
        build.CSRC / "flash_attention.cu"))
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
    result = {"device": smi, "bit_equal": bits, "sass": code, "times": times}
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
