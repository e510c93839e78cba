"""Dispatch between the CUDA kernels and their plain versions.

A CPU tensor goes to the plain version in `ref.py`. A CUDA tensor goes to the
kernel, or the call raises: there is no fallback to plain on the card. Each
kernel wrapper adds one to its entry of `LAUNCHES` where it launches, and
nowhere else, so a run can show that its main path went through the kernels.
Outputs and scratch are allocated here; kernels run on the current stream.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES: Dict[str, int] = {"disc_loss_fwd": 0, "disc_loss_bwd": 0,
                            "proto_accum": 0, "flash_attention": 0}

# The device symbols (`__global__` functions in csrc/) each wrapper launches,
# by the wrapper's LAUNCHES key: how a profile's kernel names map back to it.
KERNEL_SYMBOLS: Dict[str, tuple] = {
    "disc_loss_fwd": ("disc_fwd", "disc_fwd_small"),
    "disc_loss_bwd": ("disc_bwd",),
    "proto_accum": ("proto_accum_kernel",),
    "flash_attention": ("flash_attention_bf16_kernel",      # tensor cores
                        "flash_attention_kernel"),          # float32
}
FLASH_HEAD_DIMS = (32, 64, 128)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*tensors) -> bool:
    """True if every tensor is on the card, False if every one is on the
    CPU; anything else raises."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if dev is None:
            dev = t.device
        elif t.device != dev:
            kinds = {t.device.type for t in tensors if t is not None}
            if kinds == {"cuda"}:
                devs = {t.device for t in tensors if t is not None}
                raise ValueError(f"tensors on several CUDA devices: {devs}")
            raise ValueError(f"tensors must all be on the CPU or all on one "
                             f"CUDA device; got {sorted(kinds)}")
    if dev is None or dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"tensors must all be on the CPU or all on one CUDA "
                     f"device; got {[dev.type]}")


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _stream(device: Optional[torch.device] = None) -> int:
    """The current stream of `device` (default: the current device) as an
    int, by PyTorch's raw-stream query (a Stream object per call costs
    microseconds of host time)."""
    idx = torch.cuda.current_device() if device is None else device.index
    return torch._C._cuda_getCurrentRawStream(idx)


def _valid_ptr(valid, shape):
    """valid (M,) or (N, M) bool as the kernels read it, or None (all
    valid)."""
    if valid is None:
        return None
    if tuple(valid.shape) != shape:
        raise ValueError(f"valid must have shape {shape}, got {tuple(valid.shape)}")
    if valid.dtype != torch.bool:
        raise ValueError(f"the kernels take a bool valid mask, got {valid.dtype}")
    return valid.contiguous()


def _labels(labels, shape):
    """-> (labels as the kernels read them, 1 if int64 else 0)."""
    if tuple(labels.shape) != shape:
        raise ValueError(f"labels must have shape {shape}, got {tuple(labels.shape)}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"labels must be int32 or int64, got {labels.dtype}")
    return labels.contiguous(), int(labels.dtype == torch.int64)


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


# Zeroed int counters by (device, stream): a kernel that adds partial results
# across blocks lets its last block find itself by one counter a tile and
# resets that counter to 0 before it ends, so a buffer serves every launch on
# its stream.
_COUNTERS: Dict[tuple, torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


# -- disc_loss ----------------------------------------------------------------
@functools.lru_cache(maxsize=256)
def _disc_plan(B: int, C: int, M: int):
    """-> ((workspace floats, counters) of the forward, the same of the
    backward); 0 for none."""
    L = build.lib("disc_loss")
    return ((L.disc_loss_fwd_workspace(B, C, M), L.disc_loss_fwd_counters(B, C, M)),
            (L.disc_loss_bwd_workspace(B, C, M), L.disc_loss_bwd_counters(B, C, M)))


def _disc_shapes(s, q):
    """-> (lead, N, B, C, M): s (B, C) and q (M, C), lead () and N 1; or s
    (N, B, C) and q (N, M, C), one client a slice, lead (N,)."""
    ok = (s.dim() in (2, 3) and q.dim() == s.dim() and s.shape[-1] == q.shape[-1]
          and s.shape[:-2] == q.shape[:-2])
    if not ok:
        raise ValueError(f"need s (B, C) and q (M, C), or s (N, B, C) and q "
                         f"(N, M, C); got {tuple(s.shape)} and {tuple(q.shape)}")
    if s.dtype != torch.float32 or q.dtype != torch.float32:
        raise ValueError("disc_loss takes float32 s and q")
    lead = tuple(s.shape[:-2])
    return lead, (lead[0] if lead else 1), s.shape[-2], s.shape[-1], q.shape[-2]


def disc_loss_fwd(s, q, labels, valid=None):
    """-> loss (..., B), row_max (..., B), log_z (..., B), h_raw (..., B, M)
    for s (..., B, C), q (..., M, C), labels (..., B), valid (..., M) or
    None, with an optional leading client axis: one launch for every
    client. See `ref.disc_loss_fwd`."""
    if not _on_cuda(s, q, labels, valid):
        return ref.disc_loss_fwd(s, q, labels, valid)
    lead, N, B, C, M = _disc_shapes(s, q)
    L = build.lib("disc_loss")
    s, q = s.contiguous(), q.contiguous()
    lab, lab64 = _labels(labels, lead + (B,))
    v = _valid_ptr(valid, lead + (M,))
    loss = torch.empty(*lead, B, dtype=torch.float32, device=s.device)
    row_max = torch.empty_like(loss)
    log_z = torch.empty_like(loss)
    h_raw = torch.empty(*lead, B, M, dtype=torch.float32, device=s.device)
    if B and N:
        n_ws, n_cnt = _disc_plan(B, C, M)[0]
        stream = _stream(s.device)
        ws = cnt = None
        if n_ws:               # partials of M tiles and class-axis splits
            ws = torch.empty(N * n_ws, dtype=torch.float32, device=s.device)
            cnt = _counters(s.device, stream, N * n_cnt)
        _check(L.disc_loss_fwd(s.data_ptr(), q.data_ptr(), lab.data_ptr(), lab64,
                               _ptr(v), loss.data_ptr(), row_max.data_ptr(),
                               log_z.data_ptr(), h_raw.data_ptr(), _ptr(ws),
                               _ptr(cnt), N, B, C, M, stream), "disc_loss_fwd")
        LAUNCHES["disc_loss_fwd"] += 1
    return loss, row_max, log_z, h_raw


def disc_loss_bwd(g, s, q, labels, valid, row_max, log_z, h_raw):
    """-> (ds (..., B, C), dq (..., M, C)), one launch for every client; see
    `ref.disc_loss_bwd`."""
    if not _on_cuda(g, s, q, labels, valid, row_max, log_z, h_raw):
        return ref.disc_loss_bwd(g, s, q, labels, valid, row_max, log_z, h_raw)
    lead, N, B, C, M = _disc_shapes(s, q)
    if (tuple(g.shape) != lead + (B,) or tuple(row_max.shape) != lead + (B,)
            or tuple(log_z.shape) != lead + (B,)
            or tuple(h_raw.shape) != lead + (B, M)):
        raise ValueError("g, row_max and log_z must be (..., B) and h_raw "
                         "(..., B, M)")
    L = build.lib("disc_loss")
    s, q = s.contiguous(), q.contiguous()
    g = g.to(torch.float32).contiguous()
    lab, lab64 = _labels(labels, lead + (B,))
    v = _valid_ptr(valid, lead + (M,))
    ds = torch.empty_like(s)
    dq = torch.empty_like(q) if B else torch.zeros_like(q)
    if B and N:
        n_ws, n_cnt = _disc_plan(B, C, M)[1]
        stream = _stream(s.device)
        ws = cnt = None
        if n_ws:               # the row splits' dq partials, added in order
            ws = torch.empty(N * n_ws, dtype=torch.float32, device=s.device)
            cnt = _counters(s.device, stream, N * n_cnt)
        _check(L.disc_loss_bwd(g.data_ptr(), s.data_ptr(), q.data_ptr(),
                               lab.data_ptr(), lab64, _ptr(v),
                               row_max.contiguous().data_ptr(),
                               log_z.contiguous().data_ptr(),
                               h_raw.contiguous().data_ptr(), ds.data_ptr(),
                               dq.data_ptr(), _ptr(ws), _ptr(cnt), N, B, C, M,
                               stream), "disc_loss_bwd")
        LAUNCHES["disc_loss_bwd"] += 1
    return ds, dq


class DiscLoss(torch.autograd.Function):
    """Per-sample L_disc with its gradient in s and q: the forward kernel,
    then the backward kernel (their plain versions for CPU tensors), one
    launch each a call, with or without a leading client axis."""

    @staticmethod
    def forward(ctx, s, q, labels, valid):
        loss, row_max, log_z, h_raw = disc_loss_fwd(s, q, labels, valid)
        ctx.save_for_backward(s, q, labels, valid, row_max, log_z, h_raw)
        return loss

    @staticmethod
    def backward(ctx, g):
        ds, dq = disc_loss_bwd(g, *ctx.saved_tensors)
        return ds, dq, None, None


def disc_loss(student_logits, teacher_probs, labels,
              valid: Optional[torch.Tensor] = None):
    """Differentiable per-sample loss (..., B); `ref.disc_loss`'s contract."""
    return DiscLoss.apply(student_logits.float(), teacher_probs.float(),
                          labels, valid)


# -- proto_accum --------------------------------------------------------------
@functools.lru_cache(maxsize=256)
def _proto_plan(n: int, d: int, C: int):
    """-> (row chunks K, workspace floats, counters) for the kernel."""
    L = build.lib("proto_accum")
    K = L.proto_accum_plan(n, d, C)
    return K, L.proto_accum_workspace(K, d, C), L.proto_accum_counters(K, d, C)


def proto_accum(features, labels, num_classes: int):
    """features (..., n, d) f32 or bf16; labels (..., n) int -> (sums (...,
    C, d) f32, counts (..., C) f32), with an optional leading client axis:
    one launch for every client. Labels outside [0, C) contribute nothing."""
    if not _on_cuda(features, labels):
        return ref.proto_accum(features, labels, num_classes)
    if features.dim() not in (2, 3):
        raise ValueError(f"features must be (n, d) or (N, n, d), got "
                         f"{tuple(features.shape)}")
    lead = tuple(features.shape[:-2])
    N = lead[0] if lead else 1
    n, d = features.shape[-2:]
    C = int(num_classes)
    if C < 1 or d < 1:
        raise ValueError(f"proto_accum needs C >= 1 and d >= 1, got {C}, {d}")
    fn = {torch.float32: "proto_accum_f32",
          torch.bfloat16: "proto_accum_bf16"}.get(features.dtype)
    if fn is None:
        raise ValueError(f"proto_accum takes float32 or bfloat16 features, "
                         f"got {features.dtype}")
    L = build.lib("proto_accum")
    f = features.contiguous()
    lab, lab64 = _labels(labels, lead + (n,))
    sums = torch.empty(*lead, C, d, dtype=torch.float32, device=f.device)
    counts = torch.empty(*lead, C, dtype=torch.float32, device=f.device)
    if N:
        K, n_ws, n_cnt = _proto_plan(n, d, C)
        stream = _stream(f.device)
        ws = cnt = None
        if n_ws:           # past one cluster: the chunks' partials, added in order
            ws = torch.empty(N * n_ws, dtype=torch.float32, device=f.device)
            cnt = _counters(f.device, stream, N * n_cnt)
        _check(getattr(L, fn)(f.data_ptr(), lab.data_ptr(), lab64, sums.data_ptr(),
                              counts.data_ptr(), _ptr(ws), _ptr(cnt), N, n, d, C,
                              K, stream), "proto_accum")
        LAUNCHES["proto_accum"] += 1
    return sums, counts


# -- flash_attention ----------------------------------------------------------
def flash_attention(q, k, v, causal: bool = True):
    """q (B, Sq, H, hd); k, v (B, Sk, G, hd), H % G == 0, float32 or bf16,
    hd in FLASH_HEAD_DIMS -> (B, Sq, H, hd) in q's dtype; see
    `ref.flash_attention`."""
    if (q.dim() != 4 or k.dim() != 4 or v.shape != k.shape
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]):
        raise ValueError(f"need q (B, Sq, H, hd) and k, v (B, Sk, G, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], k.shape[2]
    if G < 1 or H % G != 0:
        raise ValueError(f"query heads {H} must be a multiple of KV heads {G}")
    if Sk < 1:
        raise ValueError("flash_attention needs at least one key")
    if hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {FLASH_HEAD_DIMS}, "
                         f"got {hd}")
    fn = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}.get(q.dtype)
    if fn is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not _on_cuda(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # the kernel's output has no grad_fn: without this the gradient
        # through attention would be dropped without a word
        raise NotImplementedError(
            "flash_attention has no backward kernel yet (ROADMAP: LM "
            "training); on the card call it under torch.no_grad() or "
            "torch.inference_mode(), or with inputs that do not require grad")
    L = build.lib("flash_attention")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if B and Sq:
        _check(getattr(L, fn)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), B, Sq, Sk, H, G, hd,
                              int(bool(causal)), _stream()), "flash_attention")
        LAUNCHES["flash_attention"] += 1
    return out
