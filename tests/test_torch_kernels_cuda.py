"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

These tests need a CUDA device and skip without one (the kernels have no CPU
mode). On the card, from the repository root:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py

The file imports torch, numpy and the port only, so it runs where JAX is not
installed. Tolerance: |kernel - plain| <= 1e-5 x max|plain| (+ 1e-4
relative) for float outputs, float32 sums of up to C*M terms in another
order; counts and ring bookkeeping exactly; flash_attention's bf16 output
within one bf16 step of the plain version's, element by element (below).
"""
import re

import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b):
    torch.testing.assert_close(a, b, rtol=1e-4,
                               atol=1e-5 * max(1.0, float(b.abs().max())))


def _disc_inputs(B, C, M, with_valid, dev):
    g = torch.Generator().manual_seed(B + C + M)
    s = (torch.randn(B, C, generator=g) * 2).to(dev)
    q = torch.softmax(torch.randn(M, C, generator=g) * 2, -1).to(dev)
    y = torch.randint(0, M, (B,), generator=g).to(dev)
    v = (torch.arange(M) % 3 != 1).to(dev) if with_valid else None
    return s, q, y, v


@pytest.mark.parametrize("B,C,M", [(32, 10, 10), (320, 10, 10),
                                   (2048, 4096, 256), (100, 777, 33),
                                   (7, 5000, 300)])
@pytest.mark.parametrize("with_valid", [False, True])
def test_disc_loss_kernels_match_plain(cuda, B, C, M, with_valid):
    s, q, y, v = _disc_inputs(B, C, M, with_valid, cuda)
    out = ops.disc_loss_fwd(s, q, y, v)
    want = ref.disc_loss_fwd(s, q, y, v)
    for a, b in zip(out, want):
        _close(a, b)
    g = torch.randn(B, generator=torch.Generator().manual_seed(0)).to(cuda)
    for a, b in zip(ops.disc_loss_bwd(g, s, q, y, v, *out[1:]),
                    ref.disc_loss_bwd(g, s, q, y, v, *want[1:])):
        _close(a, b)


def test_disc_loss_autograd_on_the_card(cuda):
    """`ops.disc_loss` launches both kernels and its gradient equals torch
    autograd through the plain forward."""
    s, q, y, v = _disc_inputs(64, 10, 10, True, cuda)
    w = torch.randn(64, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = dict(ops.LAUNCHES)
    grads = []
    for fn in (ops.disc_loss, ref.disc_loss):
        st, qt = s.clone().requires_grad_(True), q.clone().requires_grad_(True)
        grads.append(torch.autograd.grad((fn(st, qt, y, v) * w).sum(),
                                         (st, qt)))
    for a, b in zip(*grads):
        _close(a, b)
    assert ops.LAUNCHES["disc_loss_fwd"] == before["disc_loss_fwd"] + 1
    assert ops.LAUNCHES["disc_loss_bwd"] == before["disc_loss_bwd"] + 1


@pytest.mark.parametrize("n,d,C", [(240, 84, 10), (1024, 84, 10),
                                   (8192, 512, 4096), (1000, 64, 300),
                                   (7, 16, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_proto_accum_kernel_matches_plain(cuda, n, d, C, dtype):
    g = torch.Generator().manual_seed(n + d + C)
    f = torch.randn(n, d, generator=g).to(dtype).to(cuda)
    lab = torch.randint(-1, C + 1, (n,), generator=g).to(cuda)  # some out of range
    s, c = ops.proto_accum(f, lab, C)
    rs, rc = ref.proto_accum(f, lab, C)
    _close(s, rs)
    assert torch.equal(c, rc)
    s2, c2 = ops.proto_accum(f, lab, C)
    assert torch.equal(s, s2) and torch.equal(c, c2)       # deterministic


# Tile edges of the kernels: disc_fwd's 64-row, 64-teacher-row and 32-class
# tiles, disc_bwd's 32-class, 64-row and 256-teacher-row tiles (M past 256
# walks several), M = 1, C = 1, B = 1 and M past the old limit of 6752;
# shapes whose rows are not 16-byte aligned take the 4-byte copies.
DISC_EDGES = [(1, 1, 1), (2, 5, 1), (10, 1, 3), (63, 31, 63), (64, 32, 64),
              (65, 33, 65), (129, 100, 257), (70, 40, 513), (16, 64, 7000)]


@pytest.mark.parametrize("B,C,M", DISC_EDGES)
@pytest.mark.parametrize("label_dtype", [torch.int64, torch.int32])
def test_disc_loss_kernels_at_tile_edges(cuda, B, C, M, label_dtype):
    s, q, y, v = _disc_inputs(B, C, M, True, cuda)
    y = y.to(label_dtype)
    out = ops.disc_loss_fwd(s, q, y, v)
    want = ref.disc_loss_fwd(s, q, y, v)
    for a, b in zip(out, want):
        _close(a, b)
    g = torch.randn(B, generator=torch.Generator().manual_seed(0)).to(cuda)
    for a, b in zip(ops.disc_loss_bwd(g, s, q, y, v, *out[1:]),
                    ref.disc_loss_bwd(g, s, q, y, v, *want[1:])):
        _close(a, b)


def test_disc_loss_kernels_on_unaligned_rows(cuda):
    """Rows that start off a 16-byte boundary (a storage offset of one
    float) take the 4-byte copies and give the same results."""
    B, C, M = 70, 64, 96
    s0, q0, y, v = _disc_inputs(B, C, M, True, cuda)
    s = torch.empty(B * C + 1, device=cuda)[1:].view(B, C).copy_(s0)
    q = torch.empty(M * C + 1, device=cuda)[1:].view(M, C).copy_(q0)
    out = ops.disc_loss_fwd(s, q, y, v)
    for a, b in zip(out, ref.disc_loss_fwd(s0, q0, y, v)):
        _close(a, b)
    g = torch.randn(B, generator=torch.Generator().manual_seed(0)).to(cuda)
    for a, b in zip(ops.disc_loss_bwd(g, s, q, y, v, *out[1:]),
                    ref.disc_loss_bwd(g, s0, q0, y, v, *out[1:])):
        _close(a, b)


@pytest.mark.parametrize("B,C,M", [(32, 10, 10), (2048, 4096, 256),
                                   (16, 64, 7000), (100, 777, 33)])
def test_disc_loss_kernels_are_deterministic(cuda, B, C, M):
    s, q, y, v = _disc_inputs(B, C, M, True, cuda)
    g = torch.randn(B, generator=torch.Generator().manual_seed(0)).to(cuda)
    runs = []
    for _ in range(2):
        out = ops.disc_loss_fwd(s, q, y, v)
        runs.append(out + ops.disc_loss_bwd(g, s, q, y, v, *out[1:]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_disc_loss_partly_masked_logits_make_no_nan(cuda):
    """Logits of -inf on whole class tiles (a masked vocabulary) must not
    turn the running softmax into NaN."""
    B, C, M = 8, 100, 12
    s, q, y, v = _disc_inputs(B, C, M, False, cuda)
    s[:, :40] = float("-inf")
    s[3, 50:] = float("-inf")
    out = ops.disc_loss_fwd(s, q, y, v)
    want = ref.disc_loss_fwd(s, q, y, v)
    for a, b in zip(out, want):
        assert bool(torch.isfinite(a).all())
        _close(a, b)


def _proto_edge_cases(dev):
    g = torch.Generator().manual_seed(5)
    f = lambda n, d: torch.randn(n, d, generator=g)
    return {
        "n = 1": (f(1, 84), torch.tensor([3]), 10),
        "one class holds every row": (f(300, 84), torch.full((300,), 7), 10),
        "one class of many holds every row": (f(3000, 64),
                                              torch.full((3000,), 299), 300),
        "an empty class": (f(240, 84), torch.randint(0, 9, (240,),
                                                     generator=g), 10),
        "C = 1": (f(100, 20), torch.randint(-1, 2, (100,), generator=g), 1),
        "C = 33, past one class tile": (f(500, 130), torch.randint(
            0, 33, (500,), generator=g), 33),
        "many groups a chunk": (f(20000, 84), torch.randint(
            0, 10, (20000,), generator=g), 10),
        "d = 3, rows not 16-byte aligned": (f(77, 3), torch.randint(
            0, 5, (77,), generator=g), 5),
    }


@pytest.mark.parametrize("case", list(_proto_edge_cases("cpu")))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label_dtype", [torch.int64, torch.int32])
def test_proto_accum_kernel_at_tile_edges(cuda, case, dtype, label_dtype):
    f, lab, C = _proto_edge_cases("cpu")[case]
    f, lab = f.to(dtype).to(cuda), lab.to(label_dtype).to(cuda)
    s, c = ops.proto_accum(f, lab, C)
    rs, rc = ref.proto_accum(f, lab, C)
    _close(s, rs)
    assert torch.equal(c, rc)
    s2, c2 = ops.proto_accum(f, lab, C)
    assert torch.equal(s, s2) and torch.equal(c, c2)


def test_disc_and_proto_launch_one_kernel_each(cuda):
    """disc_loss_fwd, disc_loss_bwd and proto_accum each launch exactly one
    kernel a call, by the profiler's names (`ops.KERNEL_SYMBOLS`), at the
    main path's shapes and the LM shape."""
    from torch.profiler import ProfilerActivity, profile
    for B, C, M in ((32, 10, 10), (2048, 4096, 256)):
        s, q, y, v = _disc_inputs(B, C, M, True, cuda)
        g = torch.ones(B, device=cuda)
        out = ops.disc_loss_fwd(s, q, y, v)
        calls = {"disc_loss_fwd": lambda: ops.disc_loss_fwd(s, q, y, v),
                 "disc_loss_bwd": lambda: ops.disc_loss_bwd(g, s, q, y, v,
                                                            *out[1:])}
        f = torch.randn(240 if C == 10 else 8192, 84 if C == 10 else 512,
                        device=cuda)
        lab = torch.randint(0, C, (f.shape[0],), device=cuda)
        calls["proto_accum"] = lambda: ops.proto_accum(f, lab, C)
        for name, fn in calls.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            kern = [(e.key, e.count) for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA")
                    and not e.key.startswith("Memset")]
            pat = re.compile(r"\b(" + "|".join(ops.KERNEL_SYMBOLS[name])
                             + r")\b")
            ours = [k for k in kern if pat.search(k[0])]
            assert len(ours) == 1 and ours[0][1] == 1, (name, B, kern)


# -- the client axis: one launch for N clients, bit-equal to N launches of
# one client (each client's blocks do that client's work in the same order),
# across the tile edges, the split forward (C 777), several M tiles (M 257),
# proto_accum's cluster (K <= 16) and workspace (K > 16) passes.
@pytest.mark.parametrize("N", [1, 2, 5, 33])
@pytest.mark.parametrize("B,C,M", [(32, 10, 10), (65, 33, 65), (100, 777, 33),
                                   (129, 100, 257)])
@pytest.mark.parametrize("with_valid", [False, True])
def test_disc_loss_client_axis_equals_one_launch_a_client(cuda, N, B, C, M,
                                                          with_valid):
    g = torch.Generator().manual_seed(N + B + C + M)
    s = (torch.randn(N, B, C, generator=g) * 2).to(cuda)
    q = torch.softmax(torch.randn(N, M, C, generator=g) * 2, -1).to(cuda)
    y = torch.randint(0, M, (N, B), generator=g).to(cuda)
    v = (torch.rand(N, M, generator=g) > 0.3).to(cuda) if with_valid else None
    w = torch.randn(N, B, generator=g).to(cuda)
    vi = lambda i: None if v is None else v[i]
    before = dict(ops.LAUNCHES)
    out = ops.disc_loss_fwd(s, q, y, v)
    grads = ops.disc_loss_bwd(w, s, q, y, v, *out[1:])
    assert ops.LAUNCHES["disc_loss_fwd"] == before["disc_loss_fwd"] + 1
    assert ops.LAUNCHES["disc_loss_bwd"] == before["disc_loss_bwd"] + 1
    for i in range(N):
        one = ops.disc_loss_fwd(s[i], q[i], y[i], vi(i))
        for a, b in zip(out, one):
            assert torch.equal(a[i], b)
        for a, b in zip(grads, ops.disc_loss_bwd(w[i], s[i], q[i], y[i], vi(i),
                                                 *one[1:])):
            assert torch.equal(a[i], b)
    want = ref.disc_loss_fwd(s, q, y, v)
    for a, b in zip(out, want):
        _close(a, b)
    for a, b in zip(grads, ref.disc_loss_bwd(w, s, q, y, v, *want[1:])):
        _close(a, b)


@pytest.mark.parametrize("N", [1, 2, 5, 33])
@pytest.mark.parametrize("n,d,C", [(240, 84, 10), (1024, 84, 10),
                                   (3000, 64, 300), (20000, 84, 10), (77, 3, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_proto_accum_client_axis_equals_one_launch_a_client(cuda, N, n, d, C,
                                                            dtype):
    g = torch.Generator().manual_seed(N + n + d + C)
    f = torch.randn(N, n, d, generator=g).to(dtype).to(cuda)
    lab = torch.randint(-1, C + 1, (N, n), generator=g).to(cuda)
    before = ops.LAUNCHES["proto_accum"]
    s, c = ops.proto_accum(f, lab, C)
    assert ops.LAUNCHES["proto_accum"] == before + 1
    for i in range(N):
        si, ci = ops.proto_accum(f[i], lab[i], C)
        assert torch.equal(s[i], si) and torch.equal(c[i], ci)
    rs, rc = ref.proto_accum(f, lab, C)
    _close(s, rs)
    assert torch.equal(c, rc)


# The vectorized engine's static-k compaction: a (k, ...) block gathered by
# `index_select` from an N-client stack, as its round step gathers the
# participants; each result bit-equal to one launch a client on the rows of
# the stack the block was gathered from.
@pytest.mark.parametrize("idx", [[1, 3], [4, 0, 2, 1, 3]])
def test_kernels_on_a_gathered_client_block_equal_one_launch_a_client(cuda,
                                                                      idx):
    N, B, C, M, n, d = 5, 32, 10, 10, 240, 84
    g = torch.Generator().manual_seed(len(idx))
    s = (torch.randn(N, B, C, generator=g) * 2).to(cuda)
    q = torch.softmax(torch.randn(N, M, C, generator=g) * 2, -1).to(cuda)
    y = torch.randint(0, M, (N, B), generator=g).to(cuda)
    v = (torch.rand(N, M, generator=g) > 0.3).to(cuda)
    w = torch.randn(N, B, generator=g).to(cuda)
    f = torch.randn(N, n, d, generator=g).to(cuda)
    lab = torch.randint(0, C, (N, n), generator=g).to(cuda)
    ix = torch.tensor(idx, device=cuda)
    sk, qk, yk, vk, wk, fk, labk = (t.index_select(0, ix)
                                    for t in (s, q, y, v, w, f, lab))
    before = dict(ops.LAUNCHES)
    out = ops.disc_loss_fwd(sk, qk, yk, vk)
    grads = ops.disc_loss_bwd(wk, sk, qk, yk, vk, *out[1:])
    sums, counts = ops.proto_accum(fk, labk, C)
    for name in ("disc_loss_fwd", "disc_loss_bwd", "proto_accum"):
        assert ops.LAUNCHES[name] == before[name] + 1, name
    for j, i in enumerate(idx):
        one = ops.disc_loss_fwd(s[i], q[i], y[i], v[i])
        for a, b in zip(out, one):
            assert torch.equal(a[j], b)
        for a, b in zip(grads, ops.disc_loss_bwd(w[i], s[i], q[i], y[i], v[i],
                                                 *one[1:])):
            assert torch.equal(a[j], b)
        si, ci = ops.proto_accum(f[i], lab[i], C)
        assert torch.equal(sums[j], si) and torch.equal(counts[j], ci)


def _device_kernels(fn, tries=3):
    """[(name, count)] of the device kernels in a profiler session around
    fn(). Each session first launches a fill kernel, so that a session
    that lost its events (not even the fill: taken again, at most `tries`
    times) is told from a call that launched nothing."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda")
            fn()
            torch.cuda.synchronize()
        kern = [(e.key, e.count) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")
                and not e.key.startswith("Memset")]
        if kern:
            return kern
    raise AssertionError(f"the profiler recorded no device kernel in {tries} "
                         f"sessions")


def test_client_axis_calls_launch_one_kernel_each(cuda):
    """With a client axis each wrapper call is still one kernel, by the
    profiler's names (`ops.KERNEL_SYMBOLS`)."""
    g = torch.Generator().manual_seed(0)
    calls = {}
    for N, B, C, M in ((5, 32, 10, 10), (3, 100, 777, 33)):
        s = torch.randn(N, B, C, generator=g).to(cuda)
        q = torch.softmax(torch.randn(N, M, C, generator=g), -1).to(cuda)
        y = torch.randint(0, M, (N, B), generator=g).to(cuda)
        out = ops.disc_loss_fwd(s, q, y)
        w = torch.ones(N, B, device=cuda)
        calls[("disc_loss_fwd", N, C)] = lambda s=s, q=q, y=y: ops.disc_loss_fwd(s, q, y)
        calls[("disc_loss_bwd", N, C)] = (
            lambda s=s, q=q, y=y, w=w, out=out: ops.disc_loss_bwd(w, s, q, y, None,
                                                                  *out[1:]))
    for N, n in ((5, 240), (2, 20000)):
        f = torch.randn(N, n, 84, generator=g).to(cuda)
        lab = torch.randint(0, 10, (N, n), generator=g).to(cuda)
        calls[("proto_accum", N, n)] = lambda f=f, lab=lab: ops.proto_accum(f, lab, 10)
    for key, fn in calls.items():
        kern = _device_kernels(fn)
        pat = re.compile(r"\b(" + "|".join(ops.KERNEL_SYMBOLS[key[0]]) + r")\b")
        ours = [k for k in kern if pat.search(k[0])]
        assert len(ours) == 1 and ours[0][1] == 1, (key, kern)


def test_vec_round_on_the_card_never_syncs_and_matches_seq(cuda):
    """Two CoRS rounds of a small MLP fleet in the vectorized engine, every
    round step under CUDA sync-debug mode "error": one batched kernel launch
    a local step and a round, ring and ledger equal to the sequential
    engine's on the card, accuracies within 2e-2."""
    from repro_torch.core import client, collab, vec_collab
    from repro_torch.data import partition, synthetic
    from repro_torch.models import mlp
    from repro_torch.types import CollabConfig, TrainConfig
    x, y = synthetic.class_images(192, seed=0, noise=0.4)
    parts = partition.uniform_split(x, y, 3, seed=1)
    spec = client.ClientSpec(apply=mlp.apply,
                             head=lambda p: (p["head_w"], p["head_b"]))

    def build(cls):
        gen = torch.Generator().manual_seed(0)
        ps = [mlp.init_mlp(gen, device="cpu") for _ in range(3)]
        return cls([spec] * 3, ps, parts, (x, y), CollabConfig(lambda_kd=2.0),
                   TrainConfig(), seed=0, device=cuda)

    vec = build(vec_collab.VectorizedCollabTrainer)
    step = vec._round_step

    def no_sync_step(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return step(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    vec._round_step = no_sync_step
    ops.reset_launches()
    vec.run(2)
    assert ops.LAUNCHES == {"disc_loss_fwd": 4, "disc_loss_bwd": 4,
                            "proto_accum": 2, "flash_attention": 0}
    seq = build(collab.CollabTrainer)
    seq.run(2)
    for f in ("ptr", "owner", "valid", "stamp", "clock", "valid_g"):
        assert torch.equal(getattr(vec.relay_state, f),
                           getattr(seq.server.state, f)), f
    assert vec.ledger.by_round == seq.ledger.by_round
    for ra, rb in zip(vec.history, seq.history):
        assert max(abs(p - q) for p, q in zip(ra["accs"], rb["accs"])) <= 2e-2


def test_ops_raise_on_what_the_kernels_do_not_take(cuda):
    s, q, y, _ = _disc_inputs(8, 10, 10, False, cuda)
    with pytest.raises(ValueError):
        ops.disc_loss_fwd(s.double(), q, y)
    with pytest.raises(ValueError):
        ops.disc_loss_fwd(s, q, y.float())
    with pytest.raises(ValueError):
        ops.proto_accum(s.half(), y, 10)
    with pytest.raises(ValueError):
        ops.disc_loss_fwd(s, q.cpu(), y)
    with pytest.raises(ValueError):                       # valid must be bool
        ops.disc_loss_fwd(s, q, y, torch.ones(10, device=cuda))


def test_trainer_on_the_card_matches_the_cpu(cuda):
    """Two CoRS rounds of a small MLP fleet: ring and ledger equal, and every
    kernel launched."""
    from repro_torch.core import client, collab
    from repro_torch.data import partition, synthetic
    from repro_torch.models import mlp
    from repro_torch.types import CollabConfig, TrainConfig
    x, y = synthetic.class_images(192, seed=0, noise=0.4)
    parts = partition.uniform_split(x, y, 3, seed=1)
    spec = client.ClientSpec(apply=mlp.apply,
                             head=lambda p: (p["head_w"], p["head_b"]))

    def run(dev):
        gen = torch.Generator().manual_seed(0)
        ps = [mlp.init_mlp(gen, device="cpu") for _ in range(3)]
        t = collab.CollabTrainer([spec] * 3, ps, parts, (x, y),
                                 CollabConfig(lambda_kd=2.0), TrainConfig(),
                                 seed=0, device=dev)
        t.run(2)
        return t

    ops.reset_launches()
    a = run(cuda)
    assert ops.LAUNCHES == {"disc_loss_fwd": 12, "disc_loss_bwd": 12,
                            "proto_accum": 6, "flash_attention": 0}
    b = run("cpu")
    for f in ("ptr", "owner", "valid", "stamp", "clock", "valid_g"):
        assert torch.equal(getattr(a.server.state, f).cpu(),
                           getattr(b.server.state, f)), f
    assert a.ledger.by_round == b.ledger.by_round
    for ra, rb in zip(a.history, b.history):
        assert max(abs(p - q) for p, q in zip(ra["accs"], rb["accs"])) <= 2e-2


# -- flash_attention: the test shapes of tests/test_kernels.py, a ragged one,
# the serving prefill's (at hd 64, and at 32 and 128), and the edges of the
# bf16 kernel's 128-row query tiles and 64-row warpgroups. Both sides do the
# same float32 math, summed in another order (the bf16 kernel splits P into
# two bf16 halves to keep it). float32: 2e-5 x max(1, max|plain|), as
# tests/test_kernels.py. bf16: both round that float32 result to bf16, so
# they differ by at most one bf16 step per element:
# |kernel - plain| <= 1e-4 + 2^-7 |plain|.
BF16_ATOL, BF16_RTOL = 1e-4, 2.0 ** -7
SERVE_SHAPE = (4, 1024, 1024, 32, 4, 64)
FLASH_SHAPES = [(2, 128, 128, 4, 2, 64), (1, 256, 256, 8, 8, 128),
                (2, 128, 128, 4, 1, 32), (2, 100, 100, 4, 2, 64),
                (1, 77, 130, 8, 2, 128), SERVE_SHAPE,
                (2, 1, 1, 4, 2, 64), (1, 63, 63, 4, 2, 64),
                (1, 65, 65, 8, 2, 128), (1, 127, 127, 4, 1, 32),
                (1, 129, 129, 8, 2, 64), (1, 1000, 1000, 8, 2, 64),
                (4, 1024, 1024, 32, 4, 32), (4, 1024, 1024, 32, 4, 128)]


@pytest.mark.parametrize("B,Sq,Sk,H,G,hd", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Sk, H, G, hd,
                                              causal, dtype):
    g = torch.Generator().manual_seed(B + Sq + H + hd)
    q = torch.randn(B, Sq, H, hd, generator=g).to(dtype).to(cuda)
    k = torch.randn(B, Sk, G, hd, generator=g).to(dtype).to(cuda)
    v = torch.randn(B, Sk, G, hd, generator=g).to(dtype).to(cuda)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == want.shape
    diff = (out.float() - want.float()).abs()
    if dtype == torch.float32:
        limit = 2e-5 * max(1.0, float(want.abs().max()))
    else:
        limit = BF16_ATOL + BF16_RTOL * want.float().abs()
    assert bool((diff <= limit).all()), float(diff.max())


def test_flash_attention_launches_one_kernel_by_dtype(cuda):
    """At the serving shape a bf16 call launches the tensor-core kernel once
    and a float32 call the CUDA-core kernel once, by the profiler's names."""
    from torch.profiler import ProfilerActivity, profile
    B, Sq, Sk, H, G, hd = SERVE_SHAPE
    g = torch.Generator().manual_seed(0)
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(B, Sq, H, hd, generator=g).to(dtype).to(cuda)
        k = torch.randn(B, Sk, G, hd, generator=g).to(dtype).to(cuda)
        before = ops.LAUNCHES["flash_attention"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ops.flash_attention(q, k, k, causal=True)
            torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention"] == before + 1
        names[dtype] = [(e.key, e.count) for e in prof.key_averages()
                        if "flash_attention" in e.key
                        and str(e.device_type).endswith("CUDA")]
    tensor_core = re.compile(r"\bflash_attention_bf16_kernel\b")
    cuda_core = re.compile(r"\bflash_attention_kernel\b")
    bf, f32 = names[torch.bfloat16], names[torch.float32]
    assert len(bf) == 1 and bf[0][1] == 1 and tensor_core.search(bf[0][0]), bf
    assert len(f32) == 1 and f32[0][1] == 1 and cuda_core.search(f32[0][0]), f32


def test_flash_attention_raises_on_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 8, 4, 48, device=cuda)
    k = torch.randn(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k)                      # head_dim 48
    q = torch.randn(1, 8, 4, 64, device=cuda)
    k = torch.randn(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError):
        ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.randn(1, 8, 3, 64, device=cuda),
                            torch.randn(1, 8, 3, 64, device=cuda))


def test_flash_attention_raises_where_a_gradient_would_be_dropped(cuda):
    """The kernel has no backward yet: inputs that require grad raise under
    grad mode instead of giving an output with no grad_fn."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 64, 4, 64, generator=g).to(cuda).requires_grad_(True)
    k = torch.randn(1, 64, 2, 64, generator=g).to(cuda)
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, k, k)
    with torch.no_grad():
        out = ops.flash_attention(q, k, k)
    assert not out.requires_grad
    with torch.inference_mode():
        ops.flash_attention(q.detach(), k, k)
