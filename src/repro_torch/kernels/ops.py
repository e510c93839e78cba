"""Dispatch between the CUDA kernels and their plain versions.

A CPU tensor goes to the plain version in `ref.py`. A CUDA tensor goes to the
kernel, or the call raises: there is no fallback to plain on the card. Each
kernel wrapper adds one to its entry of `LAUNCHES` where it launches, and
nowhere else, so a run can show that its main path went through the kernels;
a launch with a leading client axis also adds one to `LAUNCHES_BATCHED`.
Outputs and scratch are allocated here; kernels run on the current stream.

DTensors (the LM launch path on a mesh, `sharding.place`): the kernels take
raw pointers, so a DTensor never reaches them. `flash_attention` and
`proto_accum` run DTensor inputs through
`torch.distributed.tensor.experimental.local_map`: each rank calls the
kernel (or, for CPU shards, its plain version) once on its local shards,
with the placements each wrapper declares; a DTensor placed in any other
way raises, and nothing is gathered to one rank or moved to the CPU.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES: Dict[str, int] = {"disc_loss_fwd": 0, "disc_loss_bwd": 0,
                            "proto_accum": 0, "flash_attention": 0}
# Of those, the launches with a leading client axis (one for every client),
# for the kernels that take one: a run can tell them from the 2-D calls.
LAUNCHES_BATCHED: Dict[str, int] = {"disc_loss_fwd": 0, "disc_loss_bwd": 0,
                                    "proto_accum": 0}

# The device symbols (`__global__` functions in csrc/) each wrapper launches,
# by the wrapper's LAUNCHES key: how a profile's kernel names map back to it.
KERNEL_SYMBOLS: Dict[str, tuple] = {
    "disc_loss_fwd": ("disc_fwd", "disc_fwd_small"),
    "disc_loss_bwd": ("disc_bwd",),
    "proto_accum": ("proto_accum_kernel",),
    "flash_attention": ("flash_attention_bf16_kernel",      # bf16 tensor cores
                        "flash_attention_tf32x3_kernel",    # float32, split TF32
                        "flash_attention_kernel"),          # CUDA cores, (80, 64)
}
FLASH_HEAD_DIMS = (32, 64, 128)
# (query/key dim, value dim) pairs of MLA's prefill (qk_nope + qk_rope,
# v_head_dim): DeepSeek-V2-Lite, MiniCPM3 and the reduced configs. Both
# dtypes at the first two take a tensor-core kernel (as at FLASH_HEAD_DIMS),
# at the reduced configs' (80, 64) the CUDA-core one.
FLASH_MLA_DIMS = ((192, 128), (96, 64), (80, 64))
FLASH_DIMS = tuple((d, d) for d in FLASH_HEAD_DIMS) + FLASH_MLA_DIMS


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BATCHED):
        for k in counts:
            counts[k] = 0


def _count(name: str, batched: bool) -> None:
    LAUNCHES[name] += 1
    if batched:
        LAUNCHES_BATCHED[name] += 1


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


def _is_dtensor(*tensors) -> bool:
    """True if any of `tensors` is a DTensor; then every one must be, on one
    mesh."""
    from torch.distributed.tensor import DTensor
    flags = [isinstance(t, DTensor) for t in tensors if t is not None]
    if not any(flags):
        return False
    if not all(flags):
        raise ValueError("mixed DTensor and plain tensor inputs: place every "
                         "input on the mesh (sharding.place) or none")
    if len({t.device_mesh for t in tensors if t is not None}) != 1:
        raise ValueError("DTensor inputs on different meshes")
    return True


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
        _count("disc_loss_fwd", bool(lead))
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
        _count("disc_loss_bwd", bool(lead))
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
    one launch for every client. Labels outside [0, C) contribute nothing.

    DTensor inputs (see `_proto_accum_dtensor`): one launch a rank on its
    rows and class block."""
    if _is_dtensor(features, labels):
        return _proto_accum_dtensor(features, labels, num_classes)
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
        _count("proto_accum", bool(lead))
    return sums, counts


def proto_accum_placements(features, labels):
    """The placements `proto_accum` declares for DTensor `features` (..., n,
    d) and `labels` (..., n): on each mesh dim both `Shard` on the row dim
    n where both are split there; with a client axis (N, n, d), both
    `Shard(0)` where both split the clients there (the LM step's "pod"
    axis); else both `Replicate()`."""
    from torch.distributed.tensor import Replicate, Shard
    fd, ld = features.dim() - 2, labels.dim() - 1
    out_f, out_l = [], []
    for pf, pl in zip(features.placements, labels.placements):
        if pf == Shard(fd) and pl == Shard(ld):
            out_f.append(Shard(fd))
            out_l.append(Shard(ld))
        elif fd == 1 and pf == Shard(0) and pl == Shard(0):
            out_f.append(Shard(0))
            out_l.append(Shard(0))
        else:
            out_f.append(Replicate())
            out_l.append(Replicate())
    return tuple(out_f), tuple(out_l)


def proto_accum_placed(features, labels):
    """DTensor `features` and `labels` redistributed to the placements
    `proto_accum` declares (`proto_accum_placements`): a caller whose
    features arrive otherwise (a `Partial` sum, a split of d) places them
    so first."""
    pf, pl = proto_accum_placements(features, labels)
    mesh = features.device_mesh
    return features.redistribute(mesh, pf), labels.redistribute(mesh, pl)


def _proto_accum_dtensor(features, labels, num_classes: int):
    """proto_accum on DTensors, one launch a rank through `local_map`.

    Declared placements (`proto_accum_placements`): on every mesh dim,
    `features` (..., n, d) and `labels` (..., n) are both `Shard` on the
    row dim n, both `Shard(0)` on a client axis (N, n, d), or both
    `Replicate()`. A rank's sums and counts are then `Shard(0)` over the
    mesh dims that split the clients (its own clients' block: the launch
    covers them alone, client axis N / pod), `Partial` over the mesh dims
    that split the rows (each rank adds its own rows; the caller's first
    read reduces them once), and on the mesh
    dims that replicate the rows the classes are split: the rank at
    coordinate r of a dim of size w (w dividing C, C / w = Cw) accumulates
    its block [r Cw, (r + 1) Cw) with labels - r Cw and C = Cw, exact by
    the kernel's own rule that labels outside [0, C) add nothing: the
    vocab-sharded prototypes of the LM train step
    (`launch/train.state_shardings`), one launch a rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = features.device_mesh
    if labels.dim() != features.dim() - 1 or features.dim() not in (2, 3):
        raise ValueError(f"features must be (n, d) or (N, n, d) and labels "
                         f"(n,) or (N, n); got {tuple(features.shape)}, "
                         f"{tuple(labels.shape)}")
    declared = proto_accum_placements(features, labels)
    if (tuple(features.placements), tuple(labels.placements)) != declared:
        raise ValueError(
            f"proto_accum takes DTensors sharded on the row dim, on the "
            f"client dim or replicated, alike for features and labels, on "
            f"every mesh "
            f"dim; got {features.placements} and {labels.placements} "
            f"(`proto_accum_placed` places them so)")
    fd, ld = features.dim() - 2, labels.dim() - 1
    C = int(num_classes)
    f_out, c_out, blocks = [], [], []
    for i, p in enumerate(declared[0]):
        w = mesh.size(i)
        if p.is_shard(0) and fd == 1:
            f_out.append(Shard(0))
            c_out.append(Shard(0))
        elif p.is_shard():
            f_out.append(Partial())
            c_out.append(Partial())
        elif w > 1 and C % w == 0:
            f_out.append(Shard(fd))
            c_out.append(Shard(ld))
            blocks.append(i)
        else:
            f_out.append(Replicate())
            c_out.append(Replicate())
    Cl, v0 = C, 0
    for i in blocks:
        Cl //= mesh.size(i)
        v0 = v0 * mesh.size(i) + mesh.get_local_rank(i)
    v0 *= Cl

    def local(f, y):
        return proto_accum(f, y - v0 if v0 else y, Cl)

    return local_map(local, out_placements=(tuple(f_out), tuple(c_out)),
                     in_placements=(features.placements, labels.placements),
                     device_mesh=mesh)(features, labels)


# -- flash_attention ----------------------------------------------------------
def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q (B, Sq, H, hd); k (B, Sk, G, hd); v (B, Sk, G, hv), H % G == 0,
    float32 or bf16, (hd, hv) in FLASH_DIMS -> (B, Sq, H, hv) in q's dtype;
    see `ref.flash_attention`. `window` W > 0 masks keys with q_pos - k_pos
    >= W as well (sliding-window prefill; 0: no window); every row must
    keep a key, so Sq < Sk + W. The kernels skip the key tiles left of a
    block's window. At equal dims and at MLA's (192, 128) and (96, 64),
    bf16 runs on the tensor cores (`flash_attention_bf16_kernel`) and
    float32 on them too, each product split into three TF32 products for
    float32 accuracy (`flash_attention_tf32x3_kernel`; where the query tiles
    leave SMs idle, as in Whisper's cross attention and decode, it splits
    the keys over several blocks, `flash_f32_splits`, and its last block
    combines them in a fixed order); both dtypes at the reduced configs'
    (80, 64) run on the CUDA cores (`flash_attention_kernel`).

    DTensor q, k, v run through `local_map`, one launch a rank on its own
    batch rows and heads. Declared placements, alike for q, k and v on
    every mesh dim: `Shard(0)` (the batch), `Shard(2)` (heads; the mesh dim
    must divide both H and G, so that a rank's query heads read its own KV
    heads) or `Replicate()`. Any other placement raises: a split of the
    sequence or of head_dim would compute another softmax, so a caller
    whose heads do not split redistributes them whole first
    (`nn.attention.gqa_block`). A window changes none of this."""
    if _is_dtensor(q, k, v):
        return _flash_dtensor(q, k, v, causal, window)
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or v.shape[:3] != k.shape[:3]
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]):
        raise ValueError(f"need q (B, Sq, H, hd), k (B, Sk, G, hd) and v (B, "
                         f"Sk, G, hv); got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk, G, hv = k.shape[1], k.shape[2], v.shape[3]
    if G < 1 or H % G != 0:
        raise ValueError(f"query heads {H} must be a multiple of KV heads {G}")
    if Sk < 1:
        raise ValueError("flash_attention needs at least one key")
    window = int(window)
    if window < 0 or (window and Sq >= Sk + window):
        raise ValueError(f"flash_attention's window must be 0 (none) or "
                         f"leave every query a key (Sq < Sk + window); got "
                         f"window {window} at Sq {Sq}, Sk {Sk}")
    if (hd, hv) not in FLASH_DIMS:
        raise ValueError(f"flash_attention takes (head_dim, value dim) in "
                         f"{FLASH_DIMS}, got {(hd, hv)}")
    fn = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}.get(q.dtype)
    if fn is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not _on_cuda(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # the kernel's output has no grad_fn: without this the gradient
        # through attention would be dropped without a word
        raise NotImplementedError(
            "flash_attention has no backward kernel: training computes "
            "attention with the plain functions, as the reference does "
            "(nn.attention.gqa_block(mode=\"train\")), and the kernel serves "
            "prefill only; on the card call it under torch.no_grad() or "
            "torch.inference_mode(), or with inputs that do not require grad")
    L = build.lib("flash_attention")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = q.new_empty(B, Sq, H, hv)
    if B and Sq:
        causal = int(bool(causal))
        stream = _stream()
        if fn == "flash_attention_f32":
            n_ws, n_cnt = _flash_f32_plan(B, Sq, Sk, H, hd, hv, causal, window)
            ws = cnt = None
            if n_ws:           # a key split: the splits' partials, combined in order
                ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
                cnt = _counters(q.device, stream, n_cnt)
            err = L.flash_attention_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _ptr(ws), _ptr(cnt), B, Sq, Sk, H, G, hd, hv, causal, window,
                stream)
        else:
            err = L.flash_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                Sq, Sk, H, G, hd, hv, causal, window, stream)
        _check(err, "flash_attention")
        LAUNCHES["flash_attention"] += 1
    return out


@functools.lru_cache(maxsize=256)
def _flash_f32_plan(B, Sq, Sk, H, hd, hv, causal, window):
    """-> (workspace floats, counters) of a float32 launch; 0 without a key
    split. The split is the kernel's own choice, from the shape and the
    card's SM count (`flash_attention_f32_splits`)."""
    L = build.lib("flash_attention")
    args = (B, Sq, Sk, H, hd, hv, causal, window)
    return (L.flash_attention_f32_workspace(*args),
            L.flash_attention_f32_counters(*args))


def flash_f32_splits(B, Sq, Sk, H, hd, hv, causal: bool = True,
                     window: int = 0) -> int:
    """The key splits of the float32 kernel at a launch's shape on the
    current card (1: none), as the kernel chooses them."""
    return build.lib("flash_attention").flash_attention_f32_splits(
        B, Sq, Sk, H, hd, hv, int(bool(causal)), int(window))


def _flash_dtensor(q, k, v, causal: bool, window: int):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    H, G = q.shape[2], k.shape[2]
    for i, p in enumerate(q.placements):
        ok = (p == k.placements[i] == v.placements[i]
              and (isinstance(p, Replicate) or p in (Shard(0), Shard(2))))
        if p == Shard(2) and (H % mesh.size(i) or G % mesh.size(i)):
            ok = False
        if not ok:
            raise ValueError(
                f"flash_attention takes q, k and v placed alike on every "
                f"mesh dim as Shard(0), Shard(2) (dividing H {H} and G {G}) "
                f"or Replicate(); got {q.placements}, {k.placements}, "
                f"{v.placements}")
    return local_map(flash_attention, out_placements=(q.placements,),
                     in_placements=(q.placements, k.placements, v.placements,
                                    None, None),
                     device_mesh=mesh)(q, k, v, causal, window)
