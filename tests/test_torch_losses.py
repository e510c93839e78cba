"""The port's losses against `repro.core.losses`: values and gradients with
respect to the features, head_w and head_b, within 1e-5 (float32, other
summation order). L_disc runs through the port's kernel dispatch, which on
CPU tensors is the plain forward and the analytic backward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jl
from repro_torch.core import losses as tl

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(B=24, d=16, C=10, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(feats=np.tanh(f32(B, d)), obs=np.tanh(f32(C, d)),
                protos=np.tanh(f32(C, d)) * 0.5,
                y=rng.integers(0, C, B).astype(np.int32),
                w=f32(d, C) / 2, b=f32(C) * 0.1)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _check(jfn, tfn, x, argnames):
    """value and grads of jfn(*) vs tfn(*) w.r.t. the named inputs."""
    jargs = [x[k] for k in argnames]
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(argnames))))(*jargs)
    targs = [_t(x[k], True) for k in argnames]
    tv = tfn(*targs)
    tg = torch.autograd.grad(tv, targs)
    np.testing.assert_allclose(float(tv.detach()), float(jv), **TOL)
    for k, a, b in zip(argnames, tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=k, **TOL)


def test_ce_loss():
    x = _inputs()
    logits = lambda f, w, b: f @ w + b
    _check(lambda f, w, b: jl.ce_loss(logits(f, w, b), x["y"]),
           lambda f, w, b: tl.ce_loss(logits(f, w, b), _t(x["y"])),
           x, ["feats", "w", "b"])


@pytest.mark.parametrize("with_valid", [False, True])
def test_kd_loss(with_valid):
    x = _inputs()
    v = (np.arange(10) % 4 != 0) if with_valid else None
    _check(lambda f: jl.kd_loss(f, x["protos"], x["y"], valid=v),
           lambda f: tl.kd_loss(f, _t(x["protos"]), _t(x["y"]),
                                valid=None if v is None else _t(v)),
           x, ["feats"])


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("given_logits", [False, True])
def test_disc_loss(with_valid, given_logits):
    """Gradients reach head_w and head_b through the student logits AND the
    teacher probabilities softmax(tau_u(obs))."""
    x = _inputs(seed=1)
    v = (np.arange(10) % 3 != 1) if with_valid else None
    tv = None if v is None else _t(v)

    def jfn(f, w, b):
        sl = f @ w + b if given_logits else None
        return jl.disc_loss(f, x["obs"], x["y"], w, b, valid=v,
                            student_logits=sl)

    def tfn(f, w, b):
        sl = f @ w + b if given_logits else None
        return tl.disc_loss(f, _t(x["obs"]), _t(x["y"]), w, b, valid=tv,
                            student_logits=sl)

    _check(jfn, tfn, x, ["feats", "w", "b"])


def test_objective_as_the_client_sums_it():
    """CE + 2 KD + 1 disc, the example's weights, with every gradient."""
    x = _inputs(seed=2)
    vo = np.arange(10) != 5

    def obj(L, T):
        def fn(f, w, b):
            logits = f @ w + b
            return (L.ce_loss(logits, T(x["y"]))
                    + 2.0 * L.kd_loss(f, T(x["protos"]), T(x["y"]))
                    + L.disc_loss(f, T(x["obs"]), T(x["y"]), w, b,
                                  valid=T(vo), student_logits=logits))
        return fn

    _check(obj(jl, jnp.asarray), obj(tl, _t), x, ["feats", "w", "b"])


def test_hhat_and_mi_bound():
    x = _inputs()
    s, t = x["feats"] @ x["w"], x["obs"] @ x["w"]
    np.testing.assert_allclose(tl.hhat_matrix(_t(s), _t(t)).numpy(),
                               np.asarray(jl.hhat_matrix(s, t)), **TOL)
    d = _t(np.float32(0.7))
    np.testing.assert_allclose(float(tl.mi_lower_bound(d, 9)),
                               float(jl.mi_lower_bound(jnp.float32(0.7), 9)),
                               **TOL)
