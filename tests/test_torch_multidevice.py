"""The port's vectorized engine on a client mesh of four ranks (the twin of
tests/test_multidevice.py): one subprocess runs tests/torch_fleet_ranks.py,
which starts four gloo ranks on the CPU, runs every composition that the
reference's vectorized engine runs with a mesh (and fd, il, fedavg, the
sharded relay, streaming arrivals, padded static-k blocks, a mixed fleet
with client-sharded and replicated buckets at once) on 2 or 4 clients a
rank, from the reference's weights and draws, and holds every rank's
records against the port's sequential engine and its unsharded vectorized
engine, with one exchange a round.

The reference's own mesh script does not run under this installation's
jax, but its vectorized engine without a mesh does, and a client mesh must
give what the unsharded engine gives on the same fleet. So each
composition's gathered results are also held against the reference's
`VectorizedCollabTrainer` run without a mesh, at
tests/test_torch_vec_collab.py's port-against-reference bounds for the
MLP: participants, commits, ledger and the ring's integers exactly;
metrics rtol 1e-3, atol 1e-4; accuracies within 2e-2; observations,
global prototypes and weights within 1e-4; telemetry as
tests/test_torch_telemetry.py holds it (integers exactly, floats 2e-2).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from oracles import assert_telemetry_match
from repro.core import client as jclient, vec_collab as jvec
from repro.models import mlp as jmlp
from repro.types import CollabConfig as JCollabConfig
from repro.types import FleetConfig as JFleetConfig
from repro.types import TrainConfig as JTrainConfig
from test_torch_relay_policies import same_records
import torch_fleet_ranks as tfr

MARKERS = ("UNEVEN_GUARD_OK", "SYNC_OK", "ASYNC_OK", "DOWNLOAD_OK",
           "STATICK_OK", "STATICK_PADDED_OK", "HETERO_OK", "TELEMETRY_OK",
           "COMPOSED_OK", "FD_OK", "IL_OK", "FEDAVG_OK", "FEDAVG_STATICK_OK",
           "SHARDED_OK", "STREAM_OK", "HETERO_BLOCKS_OK",
           "HETERO_BLOCKS_SYNC_OK", "MULTIDEVICE_OK")
TOL = 1e-4                 # observations, prototypes, weights (the MLP's)
J_SPEC = jclient.ClientSpec(apply=jmlp.apply,
                            head=lambda p: (p["head_w"], p["head_b"]))
J_SPEC_B = jclient.ClientSpec(apply=jmlp.apply,
                              head=lambda p: (p["head_w"], p["head_b"]))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The subprocess's output and the directory of rank 0's results."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_dir = tmp_path_factory.mktemp("four_ranks")
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(root, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "tests", "torch_fleet_ranks.py"),
         str(out_dir)],
        env=env, capture_output=True, text=True, timeout=300)
    return out, out_dir


def test_client_mesh_4_ranks_matches_the_engines(four_ranks):
    out, _ = four_ranks
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    for marker in MARKERS:
        assert marker in out.stdout.split(), (marker, out.stdout)


def reference_run(n, fleet, mode, hetero, telemetry, rounds):
    """The reference's vectorized engine, no mesh, on the rank script's
    fleet."""
    parts, test = tfr.data(n)
    specs = [J_SPEC if tfr.hidden_of(hetero, i) == 64 else J_SPEC_B
             for i in range(n)]
    ref = jvec.VectorizedCollabTrainer(
        specs, tfr.reference_weights(n, hetero), parts, test,
        JCollabConfig(**tfr.collab_kw(mode)), JTrainConfig(batch_size=16),
        seed=0, fleet=JFleetConfig(**fleet), telemetry=telemetry or None)
    for _ in range(rounds):
        ref.run_round()
    return ref


@pytest.mark.parametrize("composition", tfr.COMPOSITIONS,
                         ids=[c[0] for c in tfr.COMPOSITIONS])
def test_client_mesh_4_ranks_matches_the_reference(four_ranks, composition):
    marker, n, fleet, mode, hetero, telemetry, rounds = composition
    out, out_dir = four_ranks
    path = out_dir / f"{marker}.pkl"
    assert path.exists(), (marker, out.stdout[-2000:], out.stderr[-4000:])
    with open(path, "rb") as f:
        got = pickle.load(f)
    ref = reference_run(n, fleet, mode, hetero, telemetry, rounds)
    assert len(got["records"]) == rounds == len(ref.history)
    for rj, rg in zip(ref.history, got["records"]):
        same_records(rj, rg)
        assert ("telemetry" in rj) == ("telemetry" in rg)
        if "telemetry" in rj:
            assert_telemetry_match(rj["telemetry"], rg["telemetry"])
    assert got["ledger"] == ref.ledger.by_round
    for f, v in got["relay"].items():
        want = np.asarray(getattr(ref.relay_state, f))
        if f in tfr.EXACT:
            np.testing.assert_array_equal(v, want, err_msg=f)
        else:
            np.testing.assert_allclose(v, want, atol=TOL, err_msg=f)
    for i, w in enumerate(got["weights"]):
        want = {k: np.asarray(v) for k, v in ref.client_params(i).items()}
        assert sorted(w) == sorted(want), i
        for k in want:
            np.testing.assert_allclose(w[k], want[k], atol=TOL,
                                       err_msg=(i, k))
