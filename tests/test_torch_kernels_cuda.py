"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

These tests need a CUDA device and skip without one (the kernels have no CPU
mode). On the card, from the repository root:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py

The file imports torch, numpy and the port only, so it runs where JAX is not
installed. Tolerance: |kernel - plain| <= 1e-5 x max|plain| (+ 1e-4
relative) for float outputs, float32 sums of up to C*M terms in another
order; counts and ring bookkeeping exactly.
"""
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
                            "proto_accum": 6}
    b = run("cpu")
    for f in ("ptr", "owner", "valid", "stamp", "clock", "valid_g"):
        assert torch.equal(getattr(a.server.state, f).cpu(),
                           getattr(b.server.state, f)), f
    assert a.ledger.by_round == b.ledger.by_round
    for ra, rb in zip(a.history, b.history):
        assert max(abs(p - q) for p, q in zip(ra["accs"], rb["accs"])) <= 2e-2
