"""The port's LM launch path on four gloo CPU ranks, mesh (2, 2) over
("data", "model"), against the reference's unsharded JAX steps on the
same weights: one subprocess runs tests/torch_lm_mesh_ranks.py on the
reduced TinyLlama (2 layers, float32), from the reference's `init_lm` /
`init_state` weights and its draws of the negative classes. The reduced
Granite MoE runs the same checks in tests/test_torch_lm_mesh_moe.py (a
file of its own, so that the two take a worker each).

Bounds, those of chip_smoke.py's phase 14b: prefill and decode logits
within 5e-5 x max(1, |logit|), caches within 1e-5 x max(1, |cache|);
client 0's loss within 1e-5 relative and its gradients within 1e-5 x
max|g| a leaf; after one step, the step's metrics within 1e-5 relative,
parameters and Adam moments within 2 lr with at most 1% of the elements
beyond 1e-4 (Adam's first step turns a near-zero gradient's sign into
±lr), ProtoState counts exact and sums within 1e-4 x max(1, |sum|).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import get_arch as jget_arch
from repro.core import prototypes as jproto
from repro.launch import serve as jserve, train as jtrain
from repro.models import lm as jlm
from repro.types import CollabConfig as JCollab
from repro_torch import convert
from repro_torch.checkpoint import io as tio
from repro_torch.tree import tree_map
import torch_lm_mesh_ranks as lmr

N, B, S = 2, 4, 16
LR = 1e-3
LOGIT_TOL, CACHE_TOL, LOSS_TOL, GRAD_TOL = 5e-5, 1e-5, 1e-5, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def reference(arch):
    """The reference's unsharded runs and the inputs of the ranks."""
    jcfg = jget_arch(arch).reduced()
    V = jcfg.vocab_size
    rng = np.random.default_rng(len(arch))
    prompts = rng.integers(0, V, (B, S)).astype(np.int32)
    token = rng.integers(0, V, (B, 1)).astype(np.int32)
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    pre = jax.jit(jserve.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(prompts)})
    dec = jax.jit(jserve.make_decode_step(jcfg))(
        jp, {"tokens": jnp.asarray(token)},
        jlm.pad_cache_for_decode(jcfg, pre["caches"]))
    ccfg = JCollab(mode="cors", num_classes=V, d_feature=jcfg.d_feature,
                   num_negatives=lmr.K)
    js = jtrain.init_state(jcfg, jax.random.PRNGKey(1), N)
    toks = rng.integers(0, V, (N, B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, N)
    neg = np.stack([np.asarray(jax.random.randint(
        jax.random.split(k)[0], (lmr.K,), 0, V)) for k in keys])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, (jm, _, _)), jg = jax.jit(jax.vmap(jax.value_and_grad(
        jtrain.make_loss_fn(jcfg, ccfg), has_aux=True),
        in_axes=(0, 0, None, 0)))(js.params, jb, jproto.means(js.proto),
                                  keys)
    new, met = jax.jit(jtrain.make_train_step(jcfg, ccfg, n_clients=N))(
        js, jb, key)
    inputs = {"params": convert.lm_params_from_jax(_np(jp), device="cpu"),
              "prompts": torch.from_numpy(prompts),
              "token": torch.from_numpy(token),
              "state": convert.train_state_from_jax(_np(js), device="cpu"),
              "batch": {k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in batch.items()},
              "neg": torch.from_numpy(neg)}
    want = {"prefill": _np(pre), "decode": _np(dec),
            "grads0": jax.tree.map(lambda a: np.asarray(a[0]), jg),
            "client0": {k: float(v[0]) for k, v in jm.items()},
            "metrics": {k: float(v) for k, v in met.items()},
            "state": _np(new)}
    return inputs, want


def run_four_ranks(arch, d):
    """(the ranks' outputs, the reference's) for `arch`, through files in
    the directory `d`."""
    torch.set_num_threads(1)
    inputs, want = reference(arch)
    torch.save({arch: inputs}, d / "in.pt")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(root, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "tests", "torch_lm_mesh_ranks.py"),
         str(d / "in.pt"), str(d / "out.pt")],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    assert "POD_MAJOR_OK" in out.stdout.split()
    assert "LM_MESH_OK" in out.stdout.split()
    return torch.load(d / "out.pt", weights_only=False)[arch], want


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_four_ranks("tinyllama-1.1b", tmp_path_factory.mktemp("lm"))


def _within(got, want, tol, what):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(g - w)
    assert (d <= tol * np.maximum(1.0, np.abs(w))).all(), (what, d.max())


def test_prefill_and_decode_match_the_reference(four_ranks):
    check_serving(*four_ranks)


def check_serving(got, want):
    _within(got["prefill_logits"], want["prefill"]["logits"], LOGIT_TOL,
            "prefill logits")
    _within(got["decode_logits"], want["decode"]["logits"], LOGIT_TOL,
            "decode logits")
    wc = jax.tree.leaves(want["prefill"]["caches"])
    flat = tio._paths({"c": _stack_like(want["prefill"]["caches"],
                                        got["prefill_caches"])})
    assert len(wc) == len(got["prefill_caches"]) == len(flat)
    for path, a in flat.items():
        b = tio._paths({"c": want["prefill"]["caches"]})[path]
        _within(a, b, CACHE_TOL, path)


def _stack_like(ref_tree, flat_port):
    """The port's cache leaves (in its order) as a tree of the reference's
    structure: both keep the stacked cache layout."""
    it = iter(flat_port)
    return _rebuild(ref_tree, it)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it) for t in tree)
    return next(it).numpy()


@pytest.mark.parametrize("strategy", lmr.STRATEGIES)
def test_train_step_matches_the_reference(four_ranks, strategy):
    check_train(four_ranks[0][strategy], four_ranks[1])


def check_train(got, want):
    for k, w in want["client0"].items():
        assert abs(got["client0"][k] - w) <= LOSS_TOL * abs(w), k
    for k, w in want["metrics"].items():
        assert abs(got["metrics"][k] - w) <= LOSS_TOL * abs(w), k
    g = tio._paths(convert.lm_params_to_numpy(got["grads"]))
    w = jio._paths(want["grads0"])
    assert sorted(g) == sorted(w)
    for path in w:
        scale = float(np.abs(w[path]).max())
        d = float(np.abs(g[path] - w[path]).max())
        assert d <= GRAD_TOL * max(scale, 1e-30), (path, d, scale)
    st, ws = got["state"], want["state"]
    far = total = 0
    for field in ("params", "m", "v"):
        t = st.params if field == "params" else getattr(st.opt, field)
        j = ws.params if field == "params" else getattr(ws.opt, field)
        a = tio._paths(convert.lm_params_to_numpy(t, clients=True))
        b = jio._paths(j)
        for path in b:
            d = np.abs(a[path].astype(np.float64) - b[path])
            assert d.max() <= 2 * LR, (field, path, d.max())
            far += int((d > 1e-4).sum())
            total += d.size
    assert far <= 0.01 * total, (far, total)
    np.testing.assert_array_equal(st.proto.count.numpy(), ws.proto.count)
    np.testing.assert_allclose(
        st.proto.sum.numpy(), ws.proto.sum, rtol=0,
        atol=1e-4 * max(1.0, float(np.abs(ws.proto.sum).max())))
    np.testing.assert_array_equal(st.opt.step.numpy(), ws.opt.step)
    assert int(st.step) == int(ws.step) == 1
