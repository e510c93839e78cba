"""The port's MoE layer (`repro_torch.nn.moe`) against the reference's
(`repro/nn/moe.py`), on the CPU, in float32.

Weights come from the reference's `init_moe`; inputs from a numpy seed.
Integers exactly: the top-k indices (both sort by descending probability),
the dispatch slots and their validity, a case that drops tokens included,
and the capacities. Floats: max |port - reference| <= 1e-4 x max(1,
max|reference|), float32 products summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as jmoe
from repro_torch.nn import moe

TOL = 1e-4
KEY = jax.random.PRNGKey(0)
D, E, F_FF = 32, 8, 48


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


def _params(num_shared):
    jp = jax.tree.map(np.asarray,
                      jmoe.init_moe(KEY, D, E, F_FF, num_shared, jnp.float32))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


def _x(B=2, S=12, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)


@pytest.mark.parametrize("seq,k,cf", [(12, 2, 1.5), (1, 6, 1.5), (256, 8, 1.5),
                                      (1, 8, 32.0), (100, 3, 0.3)])
def test_capacity_matches_reference(seq, k, cf):
    assert moe.capacity(seq, k, E, cf) == jmoe.capacity(seq, k, E, cf)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_route_matches_reference(k):
    jp, tp = _params(0)
    x = _x()
    jtop_p, jtop_i, jaux = jmoe.route(jp["router"], x, k)
    top_p, top_i, aux = moe.route(tp["router"], torch.from_numpy(x), k)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    _close(top_p, jtop_p)
    _close(aux, jaux)
    assert top_p.dtype == aux.dtype == torch.float32


@pytest.mark.parametrize("cf", [0.5, 1.5, float(E)])
def test_dispatch_matches_reference(cf):
    """Slots and validity exactly, the buffer bit for bit (each kept slot
    holds one copied row); cf 0.5 drops tokens, cf E drops none."""
    jp, tp = _params(0)
    x = _x(S=16, seed=1)
    k = 2
    cap = moe.capacity(16, k, E, cf)
    _, jtop_i, _ = jmoe.route(jp["router"], x, k)
    jbuf, jslot, jvalid = jax.vmap(
        lambda xr, ir: jmoe._dispatch_row(xr, ir, cap, E))(x, jtop_i)
    buf, slot, valid = moe.dispatch(torch.from_numpy(x),
                                    torch.from_numpy(np.array(jtop_i)).long(),
                                    cap, E)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert bool(valid.all()) == (cf == E)


@pytest.mark.parametrize("num_shared", [0, 1])
@pytest.mark.parametrize("cf", [0.5, 1.5, float(E)])
def test_moe_block_matches_reference(num_shared, cf):
    jp, tp = _params(num_shared)
    x = _x(S=16, seed=2)
    jy, jaux = jmoe.moe_block(jp, x, num_experts=E, k=2, cf=cf,
                              num_shared=num_shared)
    y, aux = moe.moe_block(tp, torch.from_numpy(x), num_experts=E, k=2,
                           cf=cf, num_shared=num_shared)
    _close(y, jy)
    _close(aux, jaux)


def test_one_token_never_drops():
    """A one-token decode keeps every choice whatever the capacity factor:
    its k experts are distinct."""
    _, tp = _params(0)
    x = torch.from_numpy(_x(B=3, S=1, seed=3))
    _, top_i, _ = moe.route(tp["router"], x, 4)
    _, _, valid = moe.dispatch(x, top_i, moe.capacity(1, 4, E, 0.1), E)
    assert bool(valid.all())


def test_init_matches_the_reference_layout():
    jp, _ = _params(1)
    tp = moe.init_moe(torch.Generator().manual_seed(0), D, E, F_FF, 1,
                      torch.bfloat16)
    assert sorted(tp) == sorted(jp)          # jax.tree.map sorts the keys
    for name in ("router", "w_gate_e", "w_up_e", "w_down_e"):
        assert tuple(tp[name].shape) == jp[name].shape, name
    assert tp["router"].dtype == torch.float32
    assert tp["w_gate_e"].dtype == torch.bfloat16
    assert {n: tuple(a.shape) for n, a in tp["shared"].items()} == \
        {n: a.shape for n, a in jp["shared"].items()}
