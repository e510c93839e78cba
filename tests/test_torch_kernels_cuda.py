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


def _device_events(fn):
    """fn() under torch.profiler -> [(key, count)] of its CUDA events, no
    memsets. A window that recorded no CUDA event at all (the profiler
    dropped it: every wrapper call launches at least one kernel) is taken
    again, at most twice; any other outcome is returned as it is."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        cuda_events = [e for e in prof.key_averages()
                       if str(e.device_type).endswith("CUDA")]
        if cuda_events:
            break
    return [(e.key, e.count) for e in cuda_events
            if not e.key.startswith("Memset")]


def test_disc_and_proto_launch_one_kernel_each(cuda):
    """disc_loss_fwd, disc_loss_bwd and proto_accum each launch exactly one
    kernel a call, by the profiler's names (`ops.KERNEL_SYMBOLS`), at the
    main path's shapes and the LM shape. The profiler is warmed up once
    first; a window with a kernel of the wrong count fails at once."""
    _device_events(lambda: torch.ones(8, device=cuda).sum())
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
            kern = _device_events(fn)
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
    batched = dict(ops.LAUNCHES_BATCHED)
    out = ops.disc_loss_fwd(s, q, y, v)
    grads = ops.disc_loss_bwd(w, s, q, y, v, *out[1:])
    for name in ("disc_loss_fwd", "disc_loss_bwd"):
        assert ops.LAUNCHES[name] == before[name] + 1
        assert ops.LAUNCHES_BATCHED[name] == batched[name] + 1
    for i in range(N):
        one = ops.disc_loss_fwd(s[i], q[i], y[i], vi(i))
        for a, b in zip(out, one):
            assert torch.equal(a[i], b)
        for a, b in zip(grads, ops.disc_loss_bwd(w[i], s[i], q[i], y[i], vi(i),
                                                 *one[1:])):
            assert torch.equal(a[i], b)
    for name in ("disc_loss_fwd", "disc_loss_bwd"):   # 2-D calls: not batched
        assert ops.LAUNCHES_BATCHED[name] == batched[name] + 1
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
    batched = ops.LAUNCHES_BATCHED["proto_accum"]
    s, c = ops.proto_accum(f, lab, C)
    assert ops.LAUNCHES["proto_accum"] == before + 1
    for i in range(N):
        si, ci = ops.proto_accum(f[i], lab[i], C)
        assert torch.equal(s[i], si) and torch.equal(c[i], ci)
    # the client-axis launch counts as batched, the 2-D ones do not
    assert ops.LAUNCHES["proto_accum"] == before + 1 + N
    assert ops.LAUNCHES_BATCHED["proto_accum"] == batched + 1
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


@pytest.mark.parametrize("fleet", [
    {}, {"participation": "uniform_k:2"},
    {"clock": "lognormal:2", "download_clock": "periodic:2,3"},
    {"policy": "sharded:flat,2", "arrivals": "stream:2,1.5,0.3,7,0"}])
def test_telemetry_step_on_the_card_never_syncs(cuda, fleet):
    """The round step built with telemetry, under CUDA sync-debug mode
    "error" for three rounds (synchronous, compacted, asynchronous with
    download lag, streaming): it returns the RoundTelemetry last, the host
    reads it once a round, and its integer leaves equal the sequential
    engine's on the card."""
    from repro_torch import obs
    from repro_torch.core import client, collab, vec_collab
    from repro_torch.data import partition, synthetic
    from repro_torch.models import mlp
    from repro_torch.types import CollabConfig, FleetConfig, TrainConfig
    x, y = synthetic.class_images(192, seed=0, noise=0.4)
    parts = partition.uniform_split(x, y, 3, seed=1)
    spec = client.ClientSpec(apply=mlp.apply,
                             head=lambda p: (p["head_w"], p["head_b"]))

    def build(cls):
        gen = torch.Generator().manual_seed(0)
        ps = [mlp.init_mlp(gen, device="cpu") for _ in range(3)]
        return cls([spec] * 3, ps, parts, (x, y), CollabConfig(lambda_kd=2.0),
                   TrainConfig(), seed=0, fleet=FleetConfig(**fleet),
                   device=cuda, telemetry=True)

    vec = build(vec_collab.VectorizedCollabTrainer)
    step = vec._round_step

    def no_sync_step(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = step(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert isinstance(out[-1], obs.RoundTelemetry)
        assert out[-1].occupancy.is_cuda
        return out

    vec._round_step = no_sync_step
    vec.run(3)
    seq = build(collab.CollabTrainer)
    seq.run(3)
    for ra, rb in zip(vec.history, seq.history):
        for k in obs.metrics.EXACT_LEAVES:
            assert ra["telemetry"][k] == rb["telemetry"][k], k


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
# the serving prefill's (at hd 64, and at 32 and 128), the edges of the
# bf16 kernel's 128-row query tiles and 64-row warpgroups, and the LM
# families' prefills at 4 x 256 (Qwen2-VL, ChatGLM3, DeepSeek-67B, Granite,
# Zamba2's shared block), and Whisper-small's four (H = G = 12: the encoder
# over 1,500 frames, the decoder's self-attention over 32 tokens, its
# cross-attention from 32 tokens and, in decode, from one, over the 1,500
# frames: Sk = 1500 leaves a partial last key tile). Both sides do the
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
                (4, 1024, 1024, 32, 4, 32), (4, 1024, 1024, 32, 4, 128),
                (4, 256, 256, 28, 4, 128), (4, 256, 256, 32, 2, 128),
                (4, 256, 256, 64, 8, 128), (4, 256, 256, 16, 8, 64),
                (4, 256, 256, 32, 32, 64),
                (4, 1500, 1500, 12, 12, 64), (4, 32, 32, 12, 12, 64),
                (4, 32, 1500, 12, 12, 64), (4, 1, 1500, 12, 12, 64)]


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
    """At the serving shape a bf16 call launches the bf16 tensor-core kernel
    once and a float32 call the split-TF32 tensor-core kernel once, by the
    profiler's names.
    Each window opens with a fill kernel (`_device_kernels`): a window of
    the lone flash call once recorded no flash kernel."""
    B, Sq, Sk, H, G, hd = SERVE_SHAPE
    g = torch.Generator().manual_seed(0)
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(B, Sq, H, hd, generator=g).to(dtype).to(cuda)
        k = torch.randn(B, Sk, G, hd, generator=g).to(dtype).to(cuda)
        before = ops.LAUNCHES["flash_attention"]
        ops.flash_attention(q, k, k, causal=True)
        assert ops.LAUNCHES["flash_attention"] == before + 1
        names[dtype] = [(n, c) for n, c in _device_kernels(
            lambda: ops.flash_attention(q, k, k, causal=True))
            if "flash_attention" in n]
    tensor_core = re.compile(r"\bflash_attention_bf16_kernel\b")
    split_tf32 = re.compile(r"\bflash_attention_tf32x3_kernel\b")
    bf, f32 = names[torch.bfloat16], names[torch.float32]
    assert len(bf) == 1 and bf[0][1] == 1 and tensor_core.search(bf[0][0]), bf
    assert len(f32) == 1 and f32[0][1] == 1 and split_tf32.search(f32[0][0]), f32


@pytest.mark.parametrize("B,Sq,Sk,H,G,hd,hv", [
    (4, 32, 1500, 12, 12, 64, 64), (4, 1, 1500, 12, 12, 64, 64),
    (1, 256, 256, 8, 8, 128, 128), (3, 1, 777, 4, 2, 128, 128),
    (2, 5, 2000, 4, 4, 192, 128), (1, 70, 3000, 2, 2, 96, 64)])
def test_flash_attention_f32_key_split(cuda, B, Sq, Sk, H, G, hd, hv):
    """Where the query tiles leave SMs idle (Whisper's cross attention and
    decode among them) the float32 kernel splits the keys over several
    blocks: within the float32 limit of the plain version, two runs
    bit-equal (the combine's order is fixed), one kernel a call by the
    profiler's names, and the counters left at zero for the next call."""
    g = torch.Generator().manual_seed(Sq + Sk)
    q = torch.randn(B, Sq, H, hd, generator=g).to(cuda)
    k = torch.randn(B, Sk, G, hd, generator=g).to(cuda)
    v = torch.randn(B, Sk, G, hv, generator=g).to(cuda)
    causal = Sq == Sk
    assert ops.flash_f32_splits(B, Sq, Sk, H, hd, hv, causal) > 1
    out = ops.flash_attention(q, k, v, causal=causal)
    again = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention(q, k, v, causal=causal)
    limit = 2e-5 * max(1.0, float(want.abs().max()))
    assert float((out - want).abs().max()) <= limit
    assert torch.equal(out, again)
    names = [(n, c) for n, c in _device_kernels(
        lambda: ops.flash_attention(q, k, v, causal=causal))
        if "flash_attention" in n]
    assert len(names) == 1 and names[0][1] == 1, names
    assert re.search(r"\bflash_attention_tf32x3_kernel\b", names[0][0])
    torch.cuda.synchronize()
    assert not ops._COUNTERS[(cuda.index or 0, ops._stream())].any()


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


# The sliding window (phase 17a of chip_smoke.py): (B, S, H, G, hd, hv,
# window, causal) at TinyLlama's heads over 4096 tokens, at MLA's split
# dims, ragged lengths, and one non-causal window; the plain version's
# window mask is the reference's (q_pos - k_pos < window).
WINDOW_CASES = ([(1, 4096, 32, 4, 64, 64, w, True) for w in (1, 63, 64, 1000)]
                + [(1, 4096, 32, 4, 64, 64, 1000, False),
                   (1, 1024, 16, 16, 192, 128, 65, True),
                   (1, 1024, 40, 40, 96, 64, 300, True),
                   (2, 1000, 8, 2, 128, 128, 129, True),
                   (1, 130, 4, 1, 32, 32, 3, True),
                   (2, 300, 4, 2, 80, 64, 70, True),
                   (1, 200, 4, 2, 64, 64, 65, False)])


@pytest.mark.parametrize("B,S,H,G,hd,hv,window,causal", WINDOW_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_window_matches_plain(cuda, B, S, H, G, hd, hv,
                                              window, causal, dtype):
    g = torch.Generator().manual_seed(S + window + hd)
    q = torch.randn(B, S, H, hd, generator=g).to(dtype).to(cuda)
    k = torch.randn(B, S, G, hd, generator=g).to(dtype).to(cuda)
    v = torch.randn(B, S, G, hv, generator=g).to(dtype).to(cuda)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    diff = (out.float() - want.float()).abs()
    if dtype == torch.float32:
        limit = 2e-5 * max(1.0, float(want.abs().max()))
    else:
        limit = BF16_ATOL + BF16_RTOL * want.float().abs()
    assert bool((diff <= limit).all()), float(diff.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,hv", [(64, 64), (192, 128), (80, 64)])
def test_flash_attention_window_edges(cuda, dtype, hd, hv):
    """A window of S or more is bit-equal to none, causal or not; a causal
    window of 1 returns v's rows (each row sees its own key): exactly in
    bf16 and on the CUDA cores, within the float32 limit on the split-TF32
    kernel, whose two TF32 halves hold 22 of a float32's 24 bits."""
    g = torch.Generator().manual_seed(hd)
    S, H, G = 300, 4, 2
    q = torch.randn(1, S, H, hd, generator=g).to(dtype).to(cuda)
    k = torch.randn(1, S, G, hd, generator=g).to(dtype).to(cuda)
    v = torch.randn(1, S, G, hv, generator=g).to(dtype).to(cuda)
    for causal in (True, False):
        none = ops.flash_attention(q, k, v, causal=causal)
        for w in (S, S + 1, 10 ** 6):
            assert torch.equal(ops.flash_attention(q, k, v, causal=causal,
                                                   window=w), none), w
    one = ops.flash_attention(q, k, v, window=1)
    want = v.repeat_interleave(H // G, 2)
    if dtype == torch.float32 and (hd, hv) != (80, 64):
        limit = 2e-5 * max(1.0, float(want.abs().max()))
        assert float((one - want).abs().max()) <= limit
    else:
        assert torch.equal(one, want)


@pytest.mark.parametrize("N,n,d,C", [(2, 4096, 2048, 32000),
                                     (2, 896, 768, 51865)])
def test_proto_accum_at_the_lm_train_shape(cuda, N, n, d, C):
    """The LM train step's upload stats, (N, B*S, d', V) = (2, 4096, 2048,
    32000) for TinyLlama-1.1B and (2, 896, 768, 51865) for Whisper-small
    (51865 = 32 x 1620 + 25 leaves a partial last class block): counts
    equal, sums within the file's tolerance, two launches bit-equal."""
    g = torch.Generator().manual_seed(21)
    f = torch.randn(N, n, d, generator=g).to(cuda)
    lab = torch.randint(0, C, (N, n), generator=g).to(cuda)
    sums, counts = ops.proto_accum(f, lab, C)
    again = ops.proto_accum(f, lab, C)
    want = ref.proto_accum(f, lab, C)
    assert torch.equal(counts, want[1])
    _close(sums, want[0])
    assert torch.equal(sums, again[0]) and torch.equal(counts, again[1])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "xlstm-125m",
                                  "whisper-small", "granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "minicpm3-4b",
                                  "zamba2-1.2b"])
def test_lm_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Two cors steps of the reduced LM (2 clients, float32) on the card
    and on the CPU from the same weights, batches and negative ids: metrics
    within 1e-4 relative; parameters within 2 lr a step, at most 1% of them
    beyond 1e-4 (Adam moves an element whose gradient is ~0 by about lr,
    either way); proto counts equal, sums within 5e-3 x max|sum|; one
    proto_accum launch a step and no flash_attention launch on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.tree import leaves, tree_map
    from repro_torch.types import CollabConfig
    cfg = get_arch(arch).reduced(num_layers=4 if arch == "zamba2-1.2b"
                                 else 2)
    ccfg = CollabConfig(mode="cors", num_classes=cfg.vocab_size,
                        d_feature=cfg.d_feature)
    cpu = train.init_state(cfg, torch.Generator().manual_seed(0), 2,
                           device="cpu")
    gpu = tree_map(lambda a: a.to(cuda), cpu)
    g = torch.Generator().manual_seed(1)
    step = train.make_train_step(cfg, ccfg, n_clients=2, disc_tokens=48)
    ops.reset_launches()
    for _ in range(2):
        toks = torch.randint(0, cfg.vocab_size, (2, 2, 33), generator=g)
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.randn(2, 2, cfg.encoder_seq, cfg.d_model,
                                          generator=g)
        neg = train.draw_negatives(g, cfg, ccfg, 2)
        cpu, mc = step(cpu, batch, neg)
        gpu, mg = step(gpu, tree_map(lambda a: a.to(cuda), batch),
                       neg.to(cuda))
        for k in mc:
            assert abs(float(mg[k]) - float(mc[k])) <= 1e-4 * max(
                1.0, abs(float(mc[k]))), k
    assert ops.LAUNCHES["proto_accum"] == 2
    assert ops.LAUNCHES_BATCHED["proto_accum"] == 2    # with the client axis
    assert ops.LAUNCHES["flash_attention"] == 0
    far = total = 0
    for a, b in zip(leaves(cpu.params), leaves(gpu.params)):
        d = (b.cpu() - a).abs()
        assert float(d.max()) <= 2 * 2e-3
        far += int((d > 1e-4).sum())
        total += d.numel()
    assert far <= 0.01 * total
    assert torch.equal(gpu.proto.count.cpu(), cpu.proto.count)
    torch.testing.assert_close(
        gpu.proto.sum.cpu(), cpu.proto.sum, rtol=0,
        atol=5e-3 * max(1.0, float(cpu.proto.sum.abs().max())))


def test_train_mode_attention_is_plain_and_keeps_its_gradient(cuda):
    """gqa_block in train mode takes the plain functions under autograd on
    the card (no flash launch, the weights get gradients); the prefill mode
    still goes through the kernel and raises for inputs that require
    grad."""
    from repro_torch.nn import attention, rope
    g = torch.Generator().manual_seed(2)
    p = {n: (torch.randn(64, 64 if n in ("wq", "wo") else 32, generator=g)
             * 0.1).to(cuda).requires_grad_(True)
         for n in ("wq", "wk", "wv", "wo")}
    x = torch.randn(2, 1536, 64, generator=g).to(cuda)   # chunked: 1536 % 512
    kw = dict(num_heads=2, num_kv_heads=1, head_dim=32, rope_kind="rope",
              rope_theta=10000.0)
    pos = rope.default_positions(2, 1536, "rope", device=cuda)
    ops.reset_launches()
    y = attention.gqa_block(p, x, pos, mode="train", **kw)
    y.square().sum().backward()
    assert ops.LAUNCHES["flash_attention"] == 0
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in p.values())
    with pytest.raises(NotImplementedError, match="prefill"):
        attention.gqa_block(p, x, pos, **kw)


# -- flash_attention at MLA's split head dims (query/key hd, value hv):
# DeepSeek-V2-Lite's (192, 128) at the card's serving shape, MiniCPM3's
# (96, 64), ragged ones (a partial query tile and a partial key tile) and a
# multi-tile one at both pairs, and the reduced configs' (80, 64). bf16 at
# the two published pairs runs on the tensor cores, the rest on the CUDA
# cores: the same bounds as the equal-dim rows above.
MLA_FLASH_SHAPES = [(4, 256, 256, 16, 16, 192, 128),
                    (4, 256, 256, 40, 40, 96, 64),
                    (1, 77, 130, 8, 8, 192, 128), (2, 100, 100, 4, 4, 80, 64),
                    (1, 77, 130, 8, 8, 96, 64),
                    (1, 300, 300, 16, 16, 192, 128)]


@pytest.mark.parametrize("B,Sq,Sk,H,G,hd,hv", MLA_FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_mla_dims_matches_plain(cuda, B, Sq, Sk, H, G, hd,
                                                   hv, causal, dtype):
    g = torch.Generator().manual_seed(B + Sq + hd + hv)
    q = torch.randn(B, Sq, H, hd, generator=g).to(dtype).to(cuda)
    k = torch.randn(B, Sk, G, hd, generator=g).to(dtype).to(cuda)
    v = torch.randn(B, Sk, G, hv, generator=g).to(dtype).to(cuda)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == want.shape == (B, Sq, H, hv)
    diff = (out.float() - want.float()).abs()
    if dtype == torch.float32:
        limit = 2e-5 * max(1.0, float(want.abs().max()))
    else:
        limit = BF16_ATOL + BF16_RTOL * want.float().abs()
    assert bool((diff <= limit).all()), float(diff.max())


@pytest.mark.parametrize("hd,hv,dtype,symbol", [
    (192, 128, torch.bfloat16, "flash_attention_bf16_kernel"),
    (96, 64, torch.bfloat16, "flash_attention_bf16_kernel"),
    (80, 64, torch.bfloat16, "flash_attention_kernel"),
    (192, 128, torch.float32, "flash_attention_tf32x3_kernel"),
    (96, 64, torch.float32, "flash_attention_tf32x3_kernel"),
    (80, 64, torch.float32, "flash_attention_kernel")])
def test_flash_attention_at_mla_dims_launches_the_cuda_core_kernel(
        cuda, hd, hv, dtype, symbol):
    """Which kernel each MLA pair takes, once a call, by the profiler's
    names: at the published (192, 128) and (96, 64) the tensor-core kernel
    of the dtype (bf16, or float32 in split TF32), both dtypes at the
    reduced configs' (80, 64) the CUDA-core kernel."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(4, 256, 16, hd, generator=g).to(dtype).to(cuda)
    v = torch.randn(4, 256, 16, hv, generator=g).to(dtype).to(cuda)
    names = [(n, c) for n, c in _device_kernels(
        lambda: ops.flash_attention(q, q, v, causal=True))
        if "flash_attention" in n]
    assert len(names) == 1 and names[0][1] == 1, names
    assert re.search(rf"\b{symbol}\b", names[0][0]), names


def test_flash_attention_library_refuses_a_pair_it_has_no_kernel_for(cuda):
    """Below the wrapper's own check: the library returns an error for a
    bf16 or float32 pair it has no instantiation of, launches nothing, and
    its shared-memory query answers -1; the wrapper turns a nonzero return
    into an error, so no pair falls back to another kernel."""
    from repro_torch.kernels import build
    L = build.lib("flash_attention")
    q = torch.zeros(1, 8, 2, 160, dtype=torch.bfloat16, device=cuda)
    v = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16, device=cuda)
    o = torch.empty(1, 8, 2, 128, dtype=torch.bfloat16, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for fn, t in (("flash_attention_bf16", torch.bfloat16),
                  ("flash_attention_f32", torch.float32)):
        qt, vt, ot = q.to(t), v.to(t), o.to(t)
        # the float32 entry takes a workspace and counters (none here)
        scratch = (None, None) if t == torch.float32 else ()
        for hd, hv in ((160, 128), (96, 96), (64, 32)):
            rc = getattr(L, fn)(qt.data_ptr(), qt.data_ptr(), vt.data_ptr(),
                                ot.data_ptr(), *scratch, 1, 8, 8, 2, 2, hd,
                                hv, 1, 0, stream)
            assert rc != 0, (fn, hd, hv)
        # a negative window, and one that leaves a row no key (Sq >= Sk + W)
        vq = vt[..., :64].contiguous()
        for Sq, Sk, w in ((8, 8, -1), (8, 4, 4)):
            rc = getattr(L, fn)(vq.data_ptr(), vq.data_ptr(), vq.data_ptr(),
                                ot.data_ptr(), *scratch, 1, Sq, Sk, 2, 2, 64,
                                64, 0, w, stream)
            assert rc != 0, (fn, Sq, Sk, w)
    assert L.flash_attention_bf16_smem(80, 64) == -1
    assert L.flash_attention_bf16_smem(192, 128) > L.flash_attention_bf16_smem(
        128, 128)
    assert L.flash_attention_f32_smem(80, 64) == -1
    assert 0 < L.flash_attention_f32_smem(192, 128) <= 232448
    assert L.flash_attention_f32_splits(1, 8, 8, 2, 160, 128, 1, 0) == -1
    # a launch whose plan splits its keys refuses a missing workspace
    qs = torch.zeros(4, 1, 12, 64, device=cuda)
    ks = torch.zeros(4, 1500, 12, 64, device=cuda)
    assert L.flash_attention_f32_splits(4, 1, 1500, 12, 64, 64, 0, 0) > 1
    rc = L.flash_attention_f32(qs.data_ptr(), ks.data_ptr(), ks.data_ptr(),
                               qs.data_ptr(), None, None, 4, 1, 1500, 12, 12,
                               64, 64, 0, 0, stream)
    assert rc != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("arch,launches", [
    ("deepseek-v2-lite-16b", 2), ("minicpm3-4b", 2),
    ("granite-moe-1b-a400m", 2), ("zamba2-1.2b", 2), ("xlstm-125m", 0)])
def test_reduced_family_serving_on_the_card_matches_the_cpu(cuda, arch,
                                                            launches):
    """The reduced float32 model's prefill and two masked decode steps on
    the card against the CPU from the same weights: logits within 1e-4 x
    max(1, |logit|) (float32 products summed in another order), one flash
    launch an attention prefill (zamba2 at 4 layers: its shared block
    twice), none in decode."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    cfg = get_arch(arch).reduced(num_layers=4 if arch == "zamba2-1.2b" else 2)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    p = lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    logits = {}
    for dev in ("cpu", cuda):
        pd = tree_map(lambda a: a.to(dev), p)
        ops.reset_launches()
        with torch.inference_mode():
            out = lm.forward(pd, cfg, {"tokens": toks[:, :14].to(dev)},
                             mode="prefill")
            n_prefill = ops.LAUNCHES["flash_attention"]
            c = lm.pad_cache_for_decode(cfg, out["caches"], 2)
            got = [out["logits"][:, -1]]
            for i in range(2):
                d = lm.decode_step(pd, cfg, {"tokens": toks[:, 14 + i:15 + i]
                                             .to(dev)}, c, cache_index=14 + i,
                                   masked=True)
                c = d["caches"]
                got.append(d["logits"][:, 0])
        assert ops.LAUNCHES["flash_attention"] == n_prefill
        logits[str(dev)] = torch.stack(got).cpu()
    assert n_prefill == launches
    want = logits["cpu"]
    err = float((logits["cuda"] - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(want.abs().max())), err


def test_reduced_whisper_serving_on_the_card_matches_the_cpu(cuda):
    """The reduced float32 Whisper (2 + 2 layers, 20 frames) through
    serve_lm.serve on the card and on the CPU from the same weights: logits
    within 1e-4 x max(1, |logit|), the same ids; flash launches 3 a layer
    in prefill (encoder, self, cross) and one a decoder layer a decode step
    (cross-attention at Sq = 1)."""
    import dataclasses
    from repro_torch import serve_lm
    from repro_torch.configs import get_arch
    from repro_torch.models import encdec
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_arch("whisper-small").reduced(),
                              encoder_seq=20)
    p = encdec.init_encdec(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8), generator=g),
             "frames": torch.randn(2, 20, cfg.d_model, generator=g)}
    out = {}
    for dev in ("cpu", cuda):
        ops.reset_launches()
        with torch.inference_mode():
            out[str(dev)] = serve_lm.serve(
                tree_map(lambda a: a.to(dev), p), cfg,
                tree_map(lambda a: a.to(dev), batch), 3)
    assert ops.LAUNCHES["flash_attention"] == 3 * 2 + 3 * 2
    want = out["cpu"]["logits"]
    err = float((out["cuda"]["logits"].cpu() - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(want.abs().max())), err
    assert torch.equal(out["cuda"]["ids"], out["cpu"]["ids"])


def _mlp_fleet(cuda, fleet, mesh=None, n=4):
    from repro_torch.core import client, vec_collab
    from repro_torch.data import partition, synthetic
    from repro_torch.models import mlp
    from repro_torch.types import CollabConfig, FleetConfig, TrainConfig
    x, y = synthetic.class_images(48 * n, seed=0, noise=0.4)
    parts = partition.uniform_split(x, y, n, seed=1)
    spec = client.ClientSpec(apply=mlp.apply,
                             head=lambda p: (p["head_w"], p["head_b"]))
    gen = torch.Generator().manual_seed(0)
    ps = [mlp.init_mlp(gen, device="cpu") for _ in range(n)]
    return vec_collab.VectorizedCollabTrainer(
        [spec] * n, ps, parts, (x, y), CollabConfig(lambda_kd=2.0),
        TrainConfig(batch_size=16), seed=0, fleet=FleetConfig(mesh=mesh, **fleet),
        device=cuda, telemetry=True)


@pytest.mark.parametrize("fleet", [
    {}, {"participation": "uniform_k:2"},
    {"clock": "lognormal:2", "download_clock": "periodic:2,3"}])
def test_one_rank_nccl_mesh_round_is_bit_equal_and_never_syncs(cuda, fleet):
    """The vec engine on a one-rank NCCL client mesh, each round step (its
    exchange included) under CUDA sync-debug mode "error" after the
    communicator is up: three rounds with telemetry bit-equal to the
    unsharded engine's (records, relay state, parameters) and one exchange
    a round."""
    import tempfile
    import torch.distributed as dist
    from repro_torch import ranks, sharding
    from repro_torch.relay import placement
    from repro_torch.tree import leaves
    tmp = tempfile.mkdtemp()
    ranks.init(0, 1, "nccl", f"file://{tmp}/rendezvous")
    try:
        mesh = sharding.client_mesh(1)
        placement.gather(torch.zeros(1, device=cuda), mesh)
        meshed, plain = _mlp_fleet(cuda, fleet, mesh), _mlp_fleet(cuda, fleet)
        step = meshed._round_step

        def no_sync_step(*args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return step(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        meshed._round_step = no_sync_step
        placement.reset_exchanges()
        for _ in range(3):
            assert meshed.run_round() == plain.run_round()
        assert placement.EXCHANGES["exchange"] == 6
        for a, b in zip(leaves(meshed.relay_state), leaves(plain.relay_state)):
            assert torch.equal(a, b)
        for i in range(4):
            pa, pb = meshed.client_params(i), plain.client_params(i)
            assert all(torch.equal(pa[k], pb[k]) for k in pa)
    finally:
        dist.destroy_process_group()


def test_four_ranks_sharing_the_card_equal_the_unsharded_records(cuda,
                                                                tmp_path):
    """Four gloo ranks sharing cuda:0 (tests/torch_fleet_ranks.py), 2
    clients a rank: every rank's records equal rank 0's, one exchange a
    round, and each composition held against the unsharded engine on the
    card (integers exactly, floats at the vec-against-seq tolerances)."""
    import pickle
    import torch_fleet_ranks as tfr
    from repro_torch import ranks
    ranks.spawn(tfr.card_rank_main, 4, "gloo", str(tmp_path))
    got = []
    for r in range(4):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    for marker, n, fleet, mode, hetero, telem, rounds in tfr.COMPOSITIONS:
        if marker not in tfr.CARD_COMPOSITIONS:
            continue
        for g in got:
            assert g[marker]["records"] == got[0][marker]["records"], marker
            assert g[marker]["exchanges"] == rounds, marker
        plain = tfr.build("vec", n, fleet, mode, hetero, telem,
                          device="cuda")
        for _ in range(rounds):
            plain.run_round()
        tfr.held_against(got[0][marker], plain, marker, rounds, tight=True)

