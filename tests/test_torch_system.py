"""Twins of tests/test_system.py's relay checks on the port's sequential
engine, the `RelayServer` introspection and export the reference has, the
quickstart twin, and `data/partition.dirichlet_split` bit-equal to the
reference's, on the CPU."""
import numpy as np
import pytest
import torch

import repro_torch.relay as trelay
from repro.data import partition as jpartition
from repro_torch import quickstart
from repro_torch.data import partition, synthetic
from repro_torch.relay.server import RelayServer


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def trainer():
    """The quickstart's two LeNet clients after one cors round."""
    torch.set_num_threads(1)
    tr = quickstart.build_trainer(device="cpu")
    tr.run_round()
    return tr


def test_relay_excludes_own_observations(trainer):
    owners = {o["owner"] for o in trainer.server.obs_buffer}
    assert 1 in owners


def test_server_is_relay_only(trainer):
    """The server never holds or touches model weights (paper's design)."""
    assert not hasattr(trainer.server, "model")
    assert not hasattr(trainer.server, "params")


def test_relay_server_introspection_and_export(trainer):
    srv = trainer.server
    assert trelay.RelayServer is RelayServer and isinstance(srv, RelayServer)
    assert torch.equal(srv.valid_g, srv.state.valid_g)
    assert srv.valid_g.dtype == torch.bool and bool(srv.valid_g.all())
    buf, entries = srv.obs_buffer, srv.debug_entries()
    assert len(buf) == len(entries) > 0
    assert [e["owner"] for e in buf] == [e["owner"] for e in entries]


def test_quickstart_twin_prints_its_lines(capsys):
    quickstart.main(["--rounds", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "round  acc_mean  acc_std   L_CE    L_KD    L_disc   MI-bound" in out
    assert "   1   " in out and "nats" in out
    assert "total communication:" in out and "FedAvg would have used" in out


@pytest.mark.parametrize("n_clients,alpha,seed,num_classes",
                         [(3, 0.5, 0, None), (5, 0.1, 7, None),
                          (4, 10.0, 3, 12)])
def test_dirichlet_split_bit_equal(n_clients, alpha, seed, num_classes):
    x, y = synthetic.class_images(300, seed=2)
    want = jpartition.dirichlet_split(x, y, n_clients, alpha=alpha, seed=seed,
                                      num_classes=num_classes)
    got = partition.dirichlet_split(x, y, n_clients, alpha=alpha, seed=seed,
                                    num_classes=num_classes)
    assert len(got) == len(want) == n_clients
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    assert sum(len(gy) for _, gy in got) == len(y)
