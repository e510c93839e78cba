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
from repro.models import encdec as jencdec, lm as jlm
from repro.types import CollabConfig as JCollab
from repro_torch import convert
from repro_torch.checkpoint import io as tio
import torch_lm_mesh_ranks as lmr

N, B, S = 2, 4, 16
LR = 1e-3
LOGIT_TOL, CACHE_TOL, LOSS_TOL, GRAD_TOL = 5e-5, 1e-5, 1e-5, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def seq_len(cfg):
    """S, or two SSD chunks where the arch has mamba or mLSTM layers (so
    that the inter-chunk recurrence runs)."""
    if any(k in ("mamba", "mlstm") for k in cfg.block_pattern):
        return 2 * cfg.ssm_chunk
    return S


def _pad_self(caches):
    """The reference's encoder-decoder caches, the self cache padded by a
    slot (as `jlm.pad_cache_for_decode` pads a decoder-only model's)."""
    pad = lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)])
    return {"self": jax.tree.map(pad, caches["self"]),
            "cross": caches["cross"]}


def reference(arch, pod=False, moe_ep=False):
    """The reference's unsharded runs and the inputs of the ranks; with
    `pod` the ranks also run the train step on the "pod" mesh, with
    `moe_ep` serving and a "tp" step under the expert-parallel hint."""
    jcfg = jget_arch(arch).reduced()
    V = jcfg.vocab_size
    rng = np.random.default_rng(len(arch))
    pre_b, dec_b, batch = lmr.make_batches(jcfg, rng, N, B, seq_len(jcfg))
    jnp_of = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
    if jcfg.is_encoder_decoder:
        jp = jencdec.init_encdec(jax.random.PRNGKey(0), jcfg)
        pad, from_jax = _pad_self, convert.encdec_params_from_jax
    else:
        jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
        pad = lambda c: jlm.pad_cache_for_decode(jcfg, c)
        from_jax = convert.lm_params_from_jax
    pre = jax.jit(jserve.make_prefill_step(jcfg))(jp, jnp_of(pre_b))
    dec = jax.jit(jserve.make_decode_step(jcfg))(jp, jnp_of(dec_b),
                                                 pad(pre["caches"]))
    ccfg = JCollab(mode="cors", num_classes=V, d_feature=jcfg.d_feature,
                   num_negatives=lmr.K)
    js = jtrain.init_state(jcfg, jax.random.PRNGKey(1), N)
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, N)
    neg = np.stack([np.asarray(jax.random.randint(
        jax.random.split(k)[0], (lmr.K,), 0, V)) for k in keys])
    jb = jnp_of(batch)
    (_, (jm, _, _)), jg = jax.jit(jax.vmap(jax.value_and_grad(
        jtrain.make_loss_fn(jcfg, ccfg), has_aux=True),
        in_axes=(0, 0, None, 0)))(js.params, jb, jproto.means(js.proto),
                                  keys)
    new, met = jax.jit(jtrain.make_train_step(jcfg, ccfg, n_clients=N))(
        js, jb, key)
    tensors = lambda b: {k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in b.items()}
    inputs = {"params": from_jax(_np(jp), device="cpu"),
              "serve": tensors(pre_b), "decode": tensors(dec_b),
              "state": convert.train_state_from_jax(_np(js), device="cpu"),
              "batch": tensors(batch),
              "neg": torch.from_numpy(neg), "pod": pod, "moe_ep": moe_ep}
    want = {"prefill": _np(pre), "decode": _np(dec),
            "grads0": jax.tree.map(lambda a: np.asarray(a[0]), jg),
            "client0": {k: float(v[0]) for k, v in jm.items()},
            "metrics": {k: float(v) for k, v in met.items()},
            "state": _np(new)}
    return inputs, want


def run_four_ranks_many(archs, d, pod=(), moe_ep=()):
    """{arch: (the ranks' outputs, the reference's)} for every arch of
    `archs`, all in one four-rank run, through files in the directory
    `d`; an arch in `pod` also runs its train step on the "pod" mesh
    (output "pod"), one in `moe_ep` serves and trains under the
    expert-parallel hint too (output "moe_ep")."""
    torch.set_num_threads(1)
    refs = {arch: reference(arch, arch in pod, arch in moe_ep)
            for arch in archs}
    torch.save({arch: r[0] for arch, r in refs.items()}, d / "in.pt")
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
    got = torch.load(d / "out.pt", weights_only=False)
    return {arch: (got[arch], refs[arch][1]) for arch in archs}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_four_ranks_many(("tinyllama-1.1b",), tmp_path_factory.mktemp(
        "lm"))["tinyllama-1.1b"]


def _within(got, want, tol, what):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(g - w)
    assert (d <= tol * np.maximum(1.0, np.abs(w))).all(), (what, d.max())


def test_prefill_and_decode_match_the_reference(four_ranks):
    check_serving(*four_ranks)


def check_serving(got, want, held=()):
    """The prefill's and the decode step's logits and caches, and the
    serving loop's (one token into caches placed by `cache_shardings`),
    against the reference's steps. A cache leaf under a path prefix in
    `held` is held at CACHE_TOL x max(1, max|reference leaf|), the leaf's
    largest value in place of each element's (a recurrent state that
    carries ulps across its steps: the port's unsharded step misses the
    element-wise bound there too, see tests/test_torch_lm_mesh_xlstm.py)."""
    for tag, lg, caches, ref in (
            ("prefill", got["prefill_logits"], got["prefill_caches"],
             want["prefill"]),
            ("decode", got["decode_logits"], got["decode_caches"],
             want["decode"]),
            ("serve prefill", got["serve_logits"][0][:, None], None,
             want["prefill"]),
            ("serve decode", got["serve_logits"][1][:, None],
             got["serve_caches"], want["decode"])):
        _within(lg, ref["logits"], LOGIT_TOL, f"{tag} logits")
        if caches is None:
            continue
        a, b = tio._paths({"c": caches}), tio._paths({"c": ref["caches"]})
        assert sorted(a) == sorted(b), (tag, sorted(a), sorted(b))
        for path in b:
            if path.startswith(tuple(f"c/{h}" for h in held)):
                err = float(np.abs(np.asarray(a[path], np.float64)
                                   - b[path]).max())
                scale = max(1.0, float(np.abs(b[path]).max()))
                assert err <= CACHE_TOL * scale, (tag, path, err, scale)
            else:
                _within(a[path], b[path], CACHE_TOL, f"{tag} {path}")


@pytest.mark.parametrize("strategy", lmr.STRATEGIES)
def test_train_step_matches_the_reference(four_ranks, strategy):
    check_train(four_ranks[0][strategy], four_ranks[1])


def _to_numpy(params, clients=False):
    to = (convert.encdec_params_to_numpy if "enc_layers" in params
          else convert.lm_params_to_numpy)
    return to(params, clients=clients)


def check_train(got, want):
    """Client 0's loss and gradients, then the step (`check_step`)."""
    for k, w in want["client0"].items():
        assert abs(got["client0"][k] - w) <= LOSS_TOL * abs(w), k
    g = tio._paths(_to_numpy(got["grads"]))
    w = jio._paths(want["grads0"])
    assert sorted(g) == sorted(w)
    for path in w:
        scale = float(np.abs(w[path]).max())
        d = float(np.abs(g[path] - w[path]).max())
        assert d <= GRAD_TOL * max(scale, 1e-30), (path, d, scale)
    check_step(got, want)


def check_step(got, want):
    """One step's metrics, parameters, Adam moments and ProtoState."""
    for k, w in want["metrics"].items():
        assert abs(got["metrics"][k] - w) <= LOSS_TOL * abs(w), k
    st, ws = got["state"], want["state"]
    far = total = 0
    for field in ("params", "m", "v"):
        t = st.params if field == "params" else getattr(st.opt, field)
        j = ws.params if field == "params" else getattr(ws.opt, field)
        a = tio._paths(_to_numpy(t, clients=True))
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
