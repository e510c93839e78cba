"""The port's data, models and weight conversion against the reference:
synthetic data and partitions bit-equal, LeNet and MLP features and logits
within 1e-5 (float32 convolutions and products summed in another order)."""
import jax
import numpy as np
import pytest
import torch

from repro.data import partition as jpartition, synthetic as jsynthetic
from repro.models import cnn as jcnn, mlp as jmlp
from repro_torch import convert
from repro_torch.data import partition, synthetic
from repro_torch.models import cnn, mlp


@pytest.mark.parametrize("kw", [dict(n=64, seed=0, noise=0.8),
                                dict(n=33, seed=99, noise=0.4, modes=2),
                                dict(n=16, seed=3, num_classes=4, image=16)])
def test_class_images_bit_equal(kw):
    n = kw.pop("n")
    xa, ya = jsynthetic.class_images(n, **kw)
    xb, yb = synthetic.class_images(n, **kw)
    assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ya, yb)


def test_uniform_split_bit_equal():
    x, y = synthetic.class_images(101, seed=0)
    for a, b in zip(jpartition.uniform_split(x, y, 5, seed=1),
                    partition.uniform_split(x, y, 5, seed=1)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def _np(p):
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("kind", ["cnn", "mlp"])
def test_model_matches_reference(kind):
    jmod, tmod = (jcnn, cnn) if kind == "cnn" else (jmlp, mlp)
    init = jcnn.init_cnn if kind == "cnn" else jmlp.init_mlp
    jp = init(jax.random.PRNGKey(3))
    # non-zero biases, so their layout is exercised too
    rng = np.random.default_rng(0)
    jp = {k: (v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
              if v.ndim == 1 else v) for k, v in _np(jp).items()}
    tp = convert.params_from_jax(jp, kind, device="cpu")
    x = rng.standard_normal((7, 28, 28, 1)).astype(np.float32)
    fj, lj = jmod.apply(jp, x)
    ft, lt = tmod.apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5, rtol=1e-5)
    assert tmod.num_params(tp) == jmod.num_params(jp)


@pytest.mark.parametrize("kind", ["cnn", "mlp"])
def test_convert_round_trip(kind):
    init = jcnn.init_cnn if kind == "cnn" else jmlp.init_mlp
    jp = _np(init(jax.random.PRNGKey(1)))
    back = convert.params_to_numpy(convert.params_from_jax(jp, kind,
                                                           device="cpu"), kind)
    assert sorted(back) == sorted(jp)
    for k in jp:
        np.testing.assert_array_equal(back[k], jp[k], err_msg=k)


def test_port_init_shapes_match_reference():
    g = torch.Generator().manual_seed(0)
    for tp, jp, kind in ((cnn.init_cnn(g, device="cpu"),
                          jcnn.init_cnn(jax.random.PRNGKey(0)), "cnn"),
                         (mlp.init_mlp(g, device="cpu"),
                          jmlp.init_mlp(jax.random.PRNGKey(0)), "mlp")):
        back = convert.params_to_numpy(tp, kind)
        assert {k: v.shape for k, v in back.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}


def test_entry_points_refuse_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cnn.init_cnn(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_jax({}, "mlp", device="cuda")
