"""The benchmark's manifest and every file it names: they parse, their names
and units keep the rules, each per-layer metric moves an end-to-end metric
its cells report, and a cell, configuration and metric that exist only in
a temporary directory load by name (the harness needs no edit to grow)."""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from benchlib import spec  # noqa: E402

MANIFEST = spec.load_manifest(BENCH.parent)


def test_manifest_keeps_every_rule():
    assert spec.validate(MANIFEST, BENCH) == []


def test_manifest_command_and_paths():
    assert MANIFEST["command"] == ["python3", "bench/run.py"]
    assert MANIFEST["paths"] == ["bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_loads_with_its_files(cell):
    c = spec.load_cell(cell, MANIFEST, BENCH)
    assert c.chips == 1
    assert spec.load_runner(c.runner, BENCH).Runner
    names = {m["name"] for m in c.e2e}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(spec.load_reader(m["name"], BENCH))
    # every limit is a number the cell's comparison names
    assert c.limits and all(isinstance(v, (int, float))
                            for v in c.limits.values())


@pytest.mark.parametrize("cfg", [c["name"] for c in MANIFEST["configs"]])
def test_config_file_states_what_it_cut(cfg):
    entry = next(c for c in MANIFEST["configs"] if c["name"] == cfg)
    data = json.loads((BENCH.parent / entry["file"]).read_text())
    assert data["name"] == cfg
    assert data["reduced"] == entry["reduced"]
    for k in entry["reduced"]:
        assert k in data, k
    assert entry["source"].startswith("https://")


@pytest.mark.parametrize("name,ok", [
    ("fleet-cors-n256", True), ("mfu.train", True), ("_x", True),
    ("a b", False), ("a/b", False), ("-x", False), ("µs", False),
    ("x" * 65, False)])
def test_name_rule(name, ok):
    assert bool(spec.NAME_RE.match(name)) is ok


def test_validate_catches_a_broken_manifest():
    bad = json.loads(json.dumps(MANIFEST))
    bad["per_layer"][0]["moves"] = "nothing"
    bad["end_to_end"][0]["bound"] = 0.5
    bad["workloads"][0]["why"] = "x" * 201
    problems = spec.validate(bad, BENCH)
    assert any("moves" in p for p in problems)
    assert any("bound" in p for p in problems)
    assert any("why" in p for p in problems)


def test_a_new_cell_config_and_metric_from_new_files_alone(tmp_path):
    """A configuration, traffic mix, cell and metric that exist only in a
    temporary copy load by name, with no edit to a file already there."""
    bench = tmp_path / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = json.loads((BENCH / "configs" / "lenet5-cors.json").read_text())
    cfg.update(name="lenet5-wide", fc_width=240)
    (bench / "configs" / "lenet5-wide.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "cors-n64-closed.json").write_text(json.dumps(
        {"runner": "fleet", "mode": "cors", "clients": 64,
         "participation": "full", "relay": "flat", "check_rounds": 3,
         "trace_rounds": 3}))
    (bench / "workloads" / "fleet-wide-n64.json").write_text(json.dumps(
        json.loads((BENCH / "workloads" / "fleet-cors-n256.json")
                   .read_text())))
    (bench / "metrics" / "rounds_traced.fleet.py").write_text(
        "def read(run):\n    return run.facts.get('rounds')\n")
    m = json.loads(json.dumps(MANIFEST))
    m["configs"].append({"name": "lenet5-wide", "source": "https://x.org/y",
                         "file": "bench/configs/lenet5-wide.json",
                         "reduced": [], "why": "a wider head"})
    m["workloads"].append({"name": "fleet-wide-n64", "config": "lenet5-wide",
                           "traffic": "cors-n64-closed", "chips": 1,
                           "why": "64 clients of the wider model"})
    for e in m["end_to_end"]:
        if e["name"] == "fleet_samples_per_s":
            e["workloads"].append("fleet-wide-n64")
    m["per_layer"].append({"name": "rounds_traced.fleet", "unit": "rounds",
                           "better": "higher", "source": "program_counter",
                           "layer": "engine (core/vec_collab.py)",
                           "moves": "fleet_samples_per_s",
                           "workloads": ["fleet-wide-n64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    assert spec.validate(m, bench) == []
    cell = spec.load_cell("fleet-wide-n64", m, bench)
    assert cell.config["fc_width"] == 240 and cell.traffic["clients"] == 64
    assert [x["name"] for x in cell.per_layer] == ["rounds_traced.fleet"]

    class Info:
        facts = {"rounds": 3}
    assert spec.load_reader("rounds_traced.fleet", bench)(Info()) == 3
