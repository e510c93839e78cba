"""The port's twin of examples/collab_lm.py (`repro_torch.collab_lm`) on the
CPU: the reduced TinyLlama and xLSTM clients for one round under an upload
and a download clock, the lines it prints, and its JSONL, which the port's
report renders and whose records carry the reference example's keys."""
import pytest
import torch

from repro_torch import collab_lm, obs
from repro_torch.obs import report

# the keys of the reference example's JSONL records (examples/collab_lm.py)
RECORD_KEYS = ["ce", "comm_down", "comm_up", "late_commits", "participants",
               "proto_telemetry", "round", "stale_reads"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("clock", ["none", "homogeneous:1"])
def test_twin_runs_a_round_and_writes_its_jsonl(tmp_path, capsys, clock):
    """Synchronous, both clients' stats merge in the round (2 clients x 8
    steps x 8 x 64 tokens); with both clocks at 1 they commit a round late
    and each client reads the round-start snapshot."""
    path = tmp_path / "lm.jsonl"
    collab_lm.main(["--rounds", "1", "--device", "cpu", "--clock-model",
                    clock, "--download-clock", clock,
                    "--telemetry-out", str(path)])
    text = capsys.readouterr().out
    late = 2 if clock != "none" else 0
    assert "clients: tinyllama-reduced + xlstm-reduced, vocab=256" in text
    assert "round  ce[llama]  ce[xlstm]  comm_MB/round" in text
    assert ("async prototype relay: 2 client-round stat uploads" in text) \
        == bool(late)
    assert ("download lag: 2 client-rounds" in text) == bool(late)
    assert f"telemetry: {path}" in text
    records = obs.read_jsonl(str(path))
    assert len(records) == 1
    rec = records[0]
    assert sorted(rec) == RECORD_KEYS
    assert sorted(rec["ce"]) == ["tinyllama-1.1b-reduced", "xlstm-125m-reduced"]
    assert rec["late_commits"] == late and rec["stale_reads"] == late
    assert rec["comm_up"] == 2 * 256 * 257
    mass = 0.0 if late else 2 * 8 * 8 * 64
    assert rec["proto_telemetry"]["proto_mass"] == mass
    assert "run report: 1 rounds" in report.render(records)
