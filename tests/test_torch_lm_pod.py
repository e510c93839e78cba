"""The port's LM train step with its clients split over "pod", on four gloo
CPU ranks, mesh (2, 1, 2) over ("pod", "data", "model"): each rank trains
its own client on its ("data", "model") sub-mesh, tensor parallel over
"model". One subprocess runs tests/torch_lm_pod_ranks.py on the reduced
TinyLlama (2 layers, float32), N = 2, from the reference's `init_state`
weights and its draws of the negative classes, against the reference's
unsharded jitted `make_train_step(n_clients=2)` and its three round syncs:
cors, fd, fedavg and il on "tp", cors on "zero1", cors with client 1
absent, and `make_round_sync`, `make_async_round_sync` (delays (0, 1)) and
`make_download_lag_round_sync` on stats split over "pod"
(`round_sync_shardings`).

Bounds, those of tests/test_torch_lm_mesh.py: the step's metrics within
1e-5 relative, parameters and Adam moments within 2 lr with at most 1% of
the elements beyond 1e-4, ProtoState counts exact and sums within 1e-4 x
max(1, |sum|); the round syncs' sums within 1e-6 x max(1, |sum|), counts,
pending slots and the ring's head exact.

Bytes over "pod", a rank, as counted (`roofline.CollectiveBytes`), beyond
the metric scalars: exactly each mode's payload, this rank's vocab block of
the prototype sums and counts in cors, fd, zero1 and with a client absent
((C / 2) (d' + 1) floats), its shard of one client's parameters in fedavg,
nothing in il; a round sync the same block, the async one its whole
(d_max + 1) slots.
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
from repro.launch import train as jtrain
from repro.types import CollabConfig as JCollab
from repro_torch import convert
from repro_torch.checkpoint import io as tio
import torch_lm_pod_ranks as pr

ARCH = "tinyllama-1.1b"
N, B, S, K = 2, 4, 16, 15
LR = 1e-3
LOSS_TOL, SYNC_TOL = 1e-5, 1e-6
MASK = np.array([True, False])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def reference():
    """The reference's unsharded runs and the inputs of the ranks."""
    jcfg = jget_arch(ARCH).reduced()
    V, d = jcfg.vocab_size, jcfg.d_feature
    rng = np.random.default_rng(27)
    js = jtrain.init_state(jcfg, jax.random.PRNGKey(1), N)
    toks = rng.integers(0, V, (N, B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    key = jax.random.PRNGKey(5)
    neg = np.stack([np.asarray(jax.random.randint(
        jax.random.split(k)[0], (K,), 0, V))
        for k in jax.random.split(key, N)])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = {}
    for name, mode, _, masked in pr.CASES:
        ccfg = JCollab(mode=mode, num_classes=V, d_feature=d,
                       num_negatives=K)
        step = jax.jit(jtrain.make_train_step(jcfg, ccfg, n_clients=N))
        new, met = (step(js, jb, key, jnp.asarray(MASK)) if masked
                    else step(js, jb, key))
        want[name] = {"state": _np(new),
                      "metrics": {k: float(v) for k, v in met.items()}}
    stats = (rng.normal(size=(N, V, d)).astype(np.float32),
             rng.integers(0, 5, (N, V)).astype(np.float32))
    delays = np.array([0, 1], dtype=np.int32)
    jstats = jproto.ProtoState(*map(jnp.asarray, stats))
    ccfg = JCollab(mode="cors", num_classes=V, d_feature=d, num_negatives=K)
    want["sync_round"] = _np(jax.jit(jtrain.make_round_sync(ccfg))(
        js, jstats).proto)
    init_pending, async_sync = jtrain.make_async_round_sync(ccfg, pr.D_MAX)
    out, pending = jax.jit(async_sync)(js, init_pending(V, d),
                                       jnp.asarray(delays), jstats)
    want["sync_async"] = (_np(out.proto), _np(pending))
    init_hist, lag_sync, _ = jtrain.make_download_lag_round_sync(ccfg,
                                                                 pr.H_MAX)
    out, hist = jax.jit(lag_sync)(js, init_hist(V, d), jstats)
    want["sync_lag"] = (_np(out.proto), _np(hist))
    inputs = {"arch": ARCH,
              "state": convert.train_state_from_jax(_np(js), device="cpu"),
              "batch": {k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in batch.items()},
              "neg": torch.from_numpy(neg), "mask": torch.from_numpy(MASK),
              "stats": tuple(torch.from_numpy(t) for t in stats),
              "delays": torch.from_numpy(delays)}
    return inputs, want


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("lm_pod")
    inputs, want = reference()
    torch.save(inputs, d / "in.pt")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(root, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "tests", "torch_lm_pod_ranks.py"),
         "cases", str(d / "in.pt"), str(d / "out.pt")],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    assert "PLACE_BLOCK_OK" in out.stdout.split()
    assert "POD_CASES_OK" in out.stdout.split()
    return torch.load(d / "out.pt", weights_only=False), want


def _block_bytes():
    cfg = jget_arch(ARCH).reduced()
    return cfg.vocab_size // 2 * (cfg.d_feature + 1) * 4


@pytest.mark.parametrize("case", [c[0] for c in pr.CASES])
def test_pod_step_matches_the_reference(four_ranks, case):
    got, want = four_ranks[0][case], four_ranks[1][case]
    for k, w in want["metrics"].items():
        assert abs(got["metrics"][k] - w) <= LOSS_TOL * abs(w), k
    st, ws = got["state"], want["state"]
    far = total = 0
    for field in ("params", "m", "v"):
        t = st.params if field == "params" else getattr(st.opt, field)
        j = ws.params if field == "params" else getattr(ws.opt, field)
        a = tio._paths(convert.lm_params_to_numpy(t, clients=True))
        b = jio._paths(j)
        assert sorted(a) == sorted(b)
        for path in b:
            dd = np.abs(a[path].astype(np.float64) - b[path])
            assert dd.max() <= 2 * LR, (field, path, dd.max())
            far += int((dd > 1e-4).sum())
            total += dd.size
    assert far <= 0.01 * total, (far, total)
    np.testing.assert_array_equal(st.proto.count.numpy(), ws.proto.count)
    np.testing.assert_allclose(
        st.proto.sum.numpy(), ws.proto.sum, rtol=0,
        atol=1e-4 * max(1.0, float(np.abs(ws.proto.sum).max())))
    np.testing.assert_array_equal(st.opt.step.numpy(), ws.opt.step)
    assert int(st.step) == int(ws.step) == 1


@pytest.mark.parametrize("case", [c[0] for c in pr.CASES])
def test_pod_step_moves_only_its_payload_over_pod(four_ranks, case):
    got = four_ranks[0][case]
    pod = got["payload"]["pod"]
    want = {"fedavg": got["fedavg_bytes"], "il": 0}.get(case, _block_bytes())
    assert pod["total"] == pod["all-reduce"] == want, (pod, want)
    # the metric means: one scalar each, the mask's count with the mask
    n_metrics = 4 if case in ("cors", "zero1", "absent") else 2
    scalars = got["all"]["pod"]["total"] - pod["total"]
    assert scalars == 4 * (n_metrics + (case == "absent"))


def _close(a, b, what):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, err_msg=what,
                               atol=SYNC_TOL * max(1.0, float(np.abs(b).max())))


def test_round_sync_matches_the_reference(four_ranks):
    got, want = four_ranks[0]["sync_round"], four_ranks[1]["sync_round"]
    _close(got["got"].sum.numpy(), want.sum, "sum")
    np.testing.assert_array_equal(got["got"].count.numpy(), want.count)
    assert got["payload"]["pod"]["total"] == _block_bytes()


def test_async_round_sync_matches_the_reference(four_ranks):
    got, want = four_ranks[0]["sync_async"], four_ranks[1]["sync_async"]
    (proto, pending), (wproto, wpending) = got["got"], want
    _close(proto.sum.numpy(), wproto.sum, "sum")
    np.testing.assert_array_equal(proto.count.numpy(), wproto.count)
    _close(pending.sum.numpy(), wpending.sum, "pending sum")
    np.testing.assert_array_equal(pending.count.numpy(), wpending.count)
    assert got["payload"]["pod"]["total"] == (pr.D_MAX + 1) * 2 * \
        _block_bytes()


def test_download_lag_round_sync_matches_the_reference(four_ranks):
    got, want = four_ranks[0]["sync_lag"], four_ranks[1]["sync_lag"]
    (proto, hist), (wproto, whist) = got["got"], want
    _close(proto.sum.numpy(), wproto.sum, "sum")
    np.testing.assert_array_equal(proto.count.numpy(), wproto.count)
    _close(hist.snaps.sum.numpy(), whist.snaps.sum, "ring sums")
    np.testing.assert_array_equal(hist.snaps.count.numpy(),
                                  whist.snaps.count)
    assert int(hist.head) == int(whist.head)
    assert got["payload"]["pod"]["total"] == _block_bytes()
