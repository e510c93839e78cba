"""The manifest (`BENCHMARK.json`) and the data files it names.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric sits in a file of its own, found by its name:

  bench/configs/<config>.json     the configuration as it is run
  bench/traffic/<traffic>.json    the traffic mix: the runner that runs it
                                  and that runner's parameters
  bench/workloads/<cell>.json     the cell's correctness limits
  bench/metrics/<metric>.py       one reader for each per-layer metric
  bench/runners/<runner>.py       one runner for each kind of traffic

A later cell, configuration or metric is added with new files and new
entries, never by editing one of these.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class SpecError(ValueError):
    """A manifest or data file that breaks the benchmark's rules."""


def _read_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"missing file {path}") from None


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise SpecError(f"{what} {name!r}: a name is 1-64 of letters, digits, "
                        f"'_', '.', '-' and starts with a letter, digit or _")
    return name


class Cell:
    """One workload of the manifest with its data files read."""

    def __init__(self, entry: dict, config: dict, traffic: dict,
                 limits: dict, e2e: List[dict], per_layer: List[dict],
                 bench_dir: Path):
        self.entry = entry
        self.name = entry["name"]
        self.chips = int(entry["chips"])
        self.config = config
        self.traffic = traffic
        self.limits = limits
        self.e2e = e2e
        self.per_layer = per_layer
        self.bench_dir = bench_dir

    @property
    def runner(self) -> str:
        return self.traffic["runner"]


def load_manifest(root: Path = ROOT) -> dict:
    return _read_json(Path(root) / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: Optional[dict] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of the manifest, its configuration, traffic mix and
    limits read from their files, and the metrics it reports."""
    manifest = manifest if manifest is not None else load_manifest(
        bench_dir.parent)
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise SpecError(f"unknown workload {name!r}; the manifest has "
                        f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg_entry = configs[entry["config"]]
    config = _read_json(bench_dir.parent / cfg_entry["file"])
    traffic = _read_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    limits = _read_json(bench_dir / "workloads" / f"{name}.json")
    e2e = [m for m in manifest["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in manifest["per_layer"] if _applies(m, name)]
    return Cell(entry, config, traffic, limits, e2e, per_layer, bench_dir)


def _load_file(path: Path, modname: str):
    if not path.is_file():
        raise SpecError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_runner(name: str, bench_dir: Path = BENCH_DIR):
    check_name(name, "runner")
    return _load_file(bench_dir / "runners" / f"{name}.py",
                      f"bench_runner_{name.replace('.', '_')}")


def load_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The reader of a per-layer metric: `read(run) -> float | None`."""
    check_name(metric, "metric")
    mod = _load_file(bench_dir / "metrics" / f"{metric}.py",
                     "bench_metric_" + re.sub(r"[^A-Za-z0-9_]", "_", metric))
    if not callable(getattr(mod, "read", None)):
        raise SpecError(f"metric file for {metric} has no read(run)")
    return mod.read


def validate(manifest: dict, bench_dir: Path = BENCH_DIR) -> List[str]:
    """Every rule a file can break before any run; -> the problems found
    (empty when the manifest and its files are sound)."""
    bad: List[str] = []

    def need(cond, msg):
        if not cond:
            bad.append(msg)

    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    need(set(manifest) == keys, f"manifest keys {sorted(manifest)}")
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in manifest.get(group, []):
            n = item.get("name")
            need(isinstance(n, str) and NAME_RE.match(n), f"name {n!r}")
            need(n not in names, f"name {n!r} twice")
            names.add(n)
    cfg_names = {c["name"] for c in manifest["configs"]}
    used = set()
    for c in manifest["configs"]:
        need(set(c) == {"name", "source", "file", "reduced", "why"},
             f"config {c['name']} keys")
        need(c["file"].startswith("bench/"), f"config file {c['file']}")
        need((bench_dir.parent / c["file"]).is_file(),
             f"config file {c['file']} missing")
        for k in c["reduced"]:
            need(bool(NAME_RE.match(k)), f"reduced key {k!r}")
            need(not (k.endswith("_dim") or k.endswith("_rank")
                      or "size" in k or "width" in k),
                 f"reduced names a width: {k}")
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    need("setup_s" in e2e, "setup_s missing")
    pairs = set()
    for w in manifest["workloads"]:
        need(set(w) == {"name", "config", "traffic", "chips", "why"},
             f"workload {w['name']} keys")
        need(w["config"] in cfg_names, f"workload {w['name']} config")
        used.add(w["config"])
        need(w["chips"] in (1, 4), f"workload {w['name']} chips")
        need(0 < len(w["why"]) <= 200 and "\n" not in w["why"],
             f"workload {w['name']} why")
        need((w["config"], w["traffic"]) not in pairs,
             f"workload {w['name']}: pair twice")
        pairs.add((w["config"], w["traffic"]))
        need((bench_dir / "traffic" / f"{w['traffic']}.json").is_file(),
             f"traffic file {w['traffic']} missing")
        need((bench_dir / "workloads" / f"{w['name']}.json").is_file(),
             f"limits file {w['name']} missing")
        reported = [m for m in manifest["end_to_end"]
                    if _applies(m, w["name"])]
        need(len(reported) >= 2, f"workload {w['name']}: needs setup_s and "
                                 f"another end-to-end metric")
        need(any(_applies(m, w["name"]) for m in manifest["per_layer"]),
             f"workload {w['name']}: no per-layer metric")
    need(used == cfg_names, "a configuration no cell uses")
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        need(bool(UNIT_RE.match(m.get("unit", ""))), f"unit of {m['name']}")
        need(m.get("better") in ("lower", "higher"), f"better of {m['name']}")
        for c in m.get("workloads", []):
            need(c in cells, f"{m['name']} lists unknown cell {c}")
    for m in manifest["end_to_end"]:
        allowed = {"name", "unit", "better", "bound", "source", "workloads"}
        need(set(m) <= allowed and {"name", "unit", "better", "bound",
                                     "source"} <= set(m),
             f"end-to-end {m['name']} keys")
        need(m["source"] in ("host_clock", "device_trace"),
             f"source of {m['name']}")
        need(0.01 <= m["bound"] <= 0.25, f"bound of {m['name']}")
    for m in manifest["per_layer"]:
        allowed = {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"}
        need(set(m) <= allowed and allowed - {"workloads"} <= set(m),
             f"per-layer {m['name']} keys")
        need(m["source"] in ("device_trace", "program_span",
                             "program_counter", "host_clock"),
             f"source of {m['name']}")
        need(m["moves"] in e2e, f"{m['name']} moves {m['moves']}")
        for c in (m.get("workloads", sorted(cells)) if m["moves"] in e2e
                  else ()):
            need(_applies(e2e[m["moves"]], c),
                 f"{m['name']} in {c}, which does not report {m['moves']}")
        need((bench_dir / "metrics" / f"{m['name']}.py").is_file(),
             f"reader of {m['name']} missing")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            need(m["unit"] == "%", f"{m['name']} unit")
    return bad
