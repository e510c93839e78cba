"""The port's plain kernel versions against the reference's jnp oracles and
its Pallas kernels (interpret mode), the analytic disc_loss backward against
`jax.grad`, and the CPU dispatch of `kernels/ops.py`. The CUDA kernels
themselves are held against these plain versions in
test_torch_kernels_cuda.py, on the card.

Tolerances: 2e-4 (atol and rtol) where the Pallas tests of the reference use
it, float32 products summed in another order; 1e-5 for the backward, whose
formula is exact and whose only slack is summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import disc_loss as jdl, proto_accum as jpa
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

DISC_SHAPES = [(32, 10, 10), (64, 1000, 10), (100, 777, 33), (256, 2048, 128)]
PROTO_SHAPES = [(100, 84, 10), (512, 128, 256), (1000, 64, 300), (7, 16, 4)]


def _disc_inputs(B, C, M, seed=0, with_valid=False):
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((B, C)) * 2).astype(np.float32)
    q = np.asarray(jax.nn.softmax(
        (rng.standard_normal((M, C)) * 2).astype(np.float32), axis=-1))
    y = rng.integers(0, M, B).astype(np.int32)
    v = (np.arange(M) % 3 != 1) if with_valid else None
    return s, q, y, v


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("B,C,M", DISC_SHAPES)
@pytest.mark.parametrize("with_valid", [False, True])
def test_disc_loss_plain_matches_reference_and_pallas(B, C, M, with_valid):
    s, q, y, v = _disc_inputs(B, C, M, with_valid=with_valid)
    got = ref.disc_loss(_t(s), _t(q), _t(y), _t(v)).numpy()
    want = np.asarray(jref.disc_loss(s, q, y, v))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    vv = np.ones((M,), bool) if v is None else v
    pallas = np.asarray(jdl.disc_loss(s, q, y, vv, block_b=32, block_c=256,
                                      interpret=True))
    np.testing.assert_allclose(got, pallas, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("n,d,C", PROTO_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proto_accum_plain_matches_reference_and_pallas(n, d, C, dtype):
    rng = np.random.default_rng(1)
    f = rng.standard_normal((n, d)).astype(np.float32)
    lab = rng.integers(0, C, n).astype(np.int32)
    fj = jnp.asarray(f, getattr(jnp, dtype))
    ft = torch.from_numpy(f).to(getattr(torch, dtype))
    s, c = ref.proto_accum(ft, torch.from_numpy(lab), C)
    rs, rc = jref.proto_accum(fj, lab, C)
    ps, pc = jpa.proto_accum(fj, lab, C, block_n=128, block_c=64,
                             interpret=True)
    for ws, wc in ((rs, rc), (ps, pc)):
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), atol=2e-4,
                                   rtol=2e-4)
        np.testing.assert_array_equal(c.numpy(), np.asarray(wc))


def test_proto_accum_plain_ignores_out_of_range_labels():
    f = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    lab = torch.tensor([0, -1, 2, 3, 7, 2])
    s, c = ref.proto_accum(f, lab, 3)
    np.testing.assert_array_equal(c.numpy(), [1, 0, 2])
    np.testing.assert_array_equal(s.numpy(), [[0, 1], [0, 0], [14, 16]])


@pytest.mark.parametrize("B,C,M", [(32, 10, 10), (100, 777, 33), (16, 64, 8)])
@pytest.mark.parametrize("with_valid", [False, True])
def test_disc_loss_bwd_matches_jax_grad(B, C, M, with_valid):
    s, q, y, v = _disc_inputs(B, C, M, seed=2, with_valid=with_valid)
    g = np.random.default_rng(3).standard_normal(B).astype(np.float32)
    f = lambda ss, qq: jnp.sum(g * jref.disc_loss(ss, qq, y, v))
    want_ds, want_dq = jax.grad(f, argnums=(0, 1))(s, q)
    _, row_max, log_z, h_raw = ref.disc_loss_fwd(_t(s), _t(q), _t(y), _t(v))
    ds, dq = ref.disc_loss_bwd(_t(g), _t(s), _t(q), _t(y), _t(v), row_max,
                               log_z, h_raw)
    np.testing.assert_allclose(ds.numpy(), np.asarray(want_ds), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), atol=1e-5,
                               rtol=1e-5)


def test_disc_loss_bwd_zero_where_clip_is_active():
    """A student row and teacher rows on disjoint classes give h_raw < 1e-7
    for those pairs: their gradient must vanish, as jax.grad of the clip
    does."""
    s = np.full((2, 4), -30.0, np.float32)
    s[:, 0] = 30.0
    q = np.full((3, 4), 1e-12, np.float32)
    q[0, 0] = q[1, 1] = q[2, 2] = 1.0
    y = np.array([0, 1], np.int32)
    g = np.ones(2, np.float32)
    f = lambda ss, qq: jnp.sum(jref.disc_loss(ss, qq, y))
    want_ds, want_dq = jax.grad(f, argnums=(0, 1))(s, q)
    _, row_max, log_z, h_raw = ref.disc_loss_fwd(_t(s), _t(q), _t(y))
    assert (h_raw.numpy() < ref.EPS).any()
    ds, dq = ref.disc_loss_bwd(_t(g), _t(s), _t(q), _t(y), None, row_max,
                               log_z, h_raw)
    np.testing.assert_allclose(ds.numpy(), np.asarray(want_ds), atol=1e-5)
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), atol=1e-5)


def test_autograd_function_on_cpu_uses_the_analytic_backward():
    """`ops.disc_loss` on CPU tensors: the plain forward, and a backward
    equal both to `ref.disc_loss_bwd` and to torch autograd through the plain
    forward."""
    s, q, y, v = _disc_inputs(24, 12, 12, seed=4, with_valid=True)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(24)
                         .astype(np.float32))
    before = dict(ops.LAUNCHES)
    grads = []
    for fn in (ops.disc_loss, ref.disc_loss):
        st = _t(s).requires_grad_(True)
        qt = _t(q).requires_grad_(True)
        loss = fn(st, qt, _t(y), _t(v))
        grads.append(torch.autograd.grad((loss * g).sum(), (st, qt)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    assert ops.LAUNCHES == before          # no kernel launch on the CPU


def test_ops_refuse_tensors_off_the_cpu_and_off_cuda():
    """Only CPU tensors take the plain version; anything else is a kernel
    call or an error, never a quiet fallback."""
    s = torch.zeros(4, 5, device="meta")
    q = torch.zeros(3, 5, device="meta")
    y = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.disc_loss_fwd(s, q, y)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.proto_accum(s, y, 3)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.proto_accum(torch.zeros(4, 5), y, 3)


# -- the client axis: the batched plain versions (one batched product, as the
# vectorized engine calls them) against `jax.vmap` of the reference's oracle
# and of its Pallas kernels in interpret mode, and the batched backward
# against `jax.grad` of the vmapped oracle; tolerances as above.
@pytest.mark.parametrize("N,B,C,M", [(5, 32, 10, 10), (3, 100, 777, 33),
                                     (2, 16, 64, 8)])
@pytest.mark.parametrize("with_valid", [False, True])
def test_batched_disc_loss_plain_matches_vmapped_reference(N, B, C, M,
                                                           with_valid):
    rng = np.random.default_rng(N + B)
    s = (rng.standard_normal((N, B, C)) * 2).astype(np.float32)
    q = np.asarray(jax.nn.softmax(
        (rng.standard_normal((N, M, C)) * 2).astype(np.float32), axis=-1))
    y = rng.integers(0, M, (N, B)).astype(np.int32)
    v = rng.random((N, M)) > 0.3 if with_valid else None
    vv = np.ones((N, M), bool) if v is None else v
    loss, row_max, log_z, h_raw = ref.disc_loss_fwd(_t(s), _t(q), _t(y), _t(v))
    assert loss.shape == (N, B) and h_raw.shape == (N, B, M)
    want = jax.vmap(jref.disc_loss)(s, q, y, vv)
    pallas = jax.vmap(lambda a, b, c, d: jdl.disc_loss(
        a, b, c, d, block_b=32, block_c=256, interpret=True))(s, q, y, vv)
    for w in (want, pallas):
        np.testing.assert_allclose(loss.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=2e-4)
    for i in range(N):                  # each client's slice is its own call
        one = ref.disc_loss_fwd(_t(s[i]), _t(q[i]), _t(y[i]),
                                None if v is None else _t(v[i]))
        for a, b in zip((loss, row_max, log_z, h_raw), one):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), atol=1e-6,
                                       rtol=1e-6)
    g = rng.standard_normal((N, B)).astype(np.float32)
    f = lambda ss, qq: jnp.sum(g * jax.vmap(jref.disc_loss)(ss, qq, y, vv))
    want_ds, want_dq = jax.grad(f, argnums=(0, 1))(s, q)
    ds, dq = ref.disc_loss_bwd(_t(g), _t(s), _t(q), _t(y), _t(v), row_max,
                               log_z, h_raw)
    np.testing.assert_allclose(ds.numpy(), np.asarray(want_ds), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("N,n,d,C", [(5, 240, 84, 10), (3, 100, 84, 10),
                                     (2, 512, 128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_proto_accum_plain_matches_vmapped_reference(N, n, d, C,
                                                             dtype):
    rng = np.random.default_rng(N + n)
    f = rng.standard_normal((N, n, d)).astype(np.float32)
    lab = rng.integers(0, C, (N, n)).astype(np.int32)
    fj = jnp.asarray(f, getattr(jnp, dtype))
    s, c = ref.proto_accum(torch.from_numpy(f).to(getattr(torch, dtype)),
                           torch.from_numpy(lab), C)
    assert s.shape == (N, C, d) and c.shape == (N, C)
    rs, rc = jax.vmap(lambda a, b: jref.proto_accum(a, b, C))(fj, lab)
    ps, pc = jax.vmap(lambda a, b: jpa.proto_accum(
        a, b, C, block_n=128, block_c=64, interpret=True))(fj, lab)
    for ws, wc in ((rs, rc), (ps, pc)):
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), atol=2e-4,
                                   rtol=2e-4)
        np.testing.assert_array_equal(c.numpy(), np.asarray(wc))


def test_ops_take_a_client_axis_on_the_cpu():
    """The wrappers pass a client axis through to the plain versions on the
    CPU (no launch), and `ops.disc_loss`'s gradient with a client axis is
    each client's own."""
    rng = np.random.default_rng(7)
    s = _t((rng.standard_normal((3, 8, 6)) * 2).astype(np.float32))
    q = torch.softmax(_t(rng.standard_normal((3, 5, 6)).astype(np.float32)), -1)
    y = _t(rng.integers(0, 5, (3, 8)).astype(np.int64))
    v = _t(rng.random((3, 5)) > 0.2)
    before = dict(ops.LAUNCHES)
    st = s.clone().requires_grad_(True)
    qt = q.clone().requires_grad_(True)
    ds, dq = torch.autograd.grad(ops.disc_loss(st, qt, y, v).sum(), (st, qt))
    for i in range(3):
        si = s[i].clone().requires_grad_(True)
        qi = q[i].clone().requires_grad_(True)
        a, b = torch.autograd.grad(ops.disc_loss(si, qi, y[i], v[i]).sum(),
                                   (si, qi))
        np.testing.assert_allclose(ds[i].numpy(), a.numpy(), atol=1e-6)
        np.testing.assert_allclose(dq[i].numpy(), b.numpy(), atol=1e-6)
    sums, counts = ops.proto_accum(s, y, 5)
    assert sums.shape == (3, 5, 6) and counts.shape == (3, 5)
    assert ops.LAUNCHES == before
