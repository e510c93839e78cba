"""Build and load the port's CUDA kernels (`csrc/*.cu`) at first use.

Each source is compiled by `nvcc` for sm_90a into its own shared library with
a plain C interface, all sources in parallel, and loaded with `ctypes`. The
libraries go to `build/kernels/` at the repository root (git-ignored), named
by a hash of their source and flags, so an edited source is never served
from a stale build. Nothing here runs at import: the CPU tests import every
module of the port and this machine need not have `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("disc_loss", "proto_accum", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# argtypes of every C entry point; each returns a cudaError_t as int, but for
# the queries (`*_tiles`, `*_counters`, `proto_accum_plan`, `*_workspace`,
# `flash_attention_bf16_smem`). Labels are int32 or int64 (the int after the
# labels pointer says which); valid is a bool pointer, or null for all valid.
# The launches take the number of clients N before the per-client shape.
SIGNATURES = {
    "disc_loss": {
        "disc_loss_fwd": [_P] * 3 + [_I] + [_P] * 7 + [_I] * 4 + [_P],
        "disc_loss_bwd": [_P] * 4 + [_I] + [_P] * 8 + [_I] * 4 + [_P],
        "disc_loss_bwd_workspace": [_I] * 3,
        "disc_loss_bwd_counters": [_I] * 3,
        "disc_loss_fwd_workspace": [_I] * 3,
        "disc_loss_fwd_counters": [_I] * 3,
    },
    "proto_accum": {
        "proto_accum_f32": [_P] * 2 + [_I] + [_P] * 4 + [_I] * 5 + [_P],
        "proto_accum_bf16": [_P] * 2 + [_I] + [_P] * 4 + [_I] * 5 + [_P],
        "proto_accum_plan": [_I] * 3,
        "proto_accum_workspace": [_I] * 3,
        "proto_accum_counters": [_I] * 3,
    },
    "flash_attention": {
        "flash_attention_f32": [_P] * 4 + [_I] * 7 + [_P],
        "flash_attention_bf16": [_P] * 4 + [_I] * 7 + [_P],
        "flash_attention_bf16_smem": [_I],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> nvcc output (ptxas -v), kept beside the library as lib*.log
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the GPU")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}.{tag}.so"


def build_all() -> float:
    """Compile every source whose library is missing, one `nvcc` per source,
    all started together. Returns the wall seconds spent; raises with the
    compiler's output if a build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            log = out.with_suffix(".log")
            if log.exists():
                BUILD_LOG[name] = log.read_text()
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, built first if needed."""
    if name not in _LIBS:
        build_all()
        cdll = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(cdll, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = cdll
    return _LIBS[name]
