"""The port's benchmark: one run of one cell.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It reads the cell from BENCHMARK.json and its files under bench/, makes
the inputs and weights from --seed on the card, sets up and warms up the
program (`src/repro_torch`) through the cell's runner, runs its timed
window for --seconds, and with --trace 1 a profiled stretch after it,
then holds what the program produced against the plain reference under
bench/ref/. The last line of standard output is one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), device, with --trace 1 breakdown, and last
checks, each number compared beside its limit (also the last lines of
standard error). It exits non-zero and prints no result when there is no
card, or fewer than the cell asks for, and when a module of JAX or of the
JAX package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import device, isolation, spec  # noqa: E402


class Window:
    """What the timed window did: steps, units of work and seconds."""

    def __init__(self, steps: int, work: float, seconds: float):
        self.steps, self.work, self.seconds = steps, work, seconds


class RunInfo:
    """What a per-layer reader reads: the cell, the window, the traced
    stretch (`trace`: a benchlib.trace.Trace) and the runner's own facts
    about it (`facts`)."""

    def __init__(self, cell, window, trace, facts):
        self.cell, self.window, self.trace, self.facts = \
            cell, window, trace, facts


def set_environment() -> None:
    """Keep JAX out of the process, and every build and kernel cache of
    the program inside this checkout at fixed paths."""
    os.environ.update(isolation.ENVIRONMENT)
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))


def execute(cell, seed: int, seconds: float, trace: bool, dev: str = "cuda",
            t_start: float = None):
    """One run of `cell` through its runner (bench/runners/); -> the result
    dict, or None when the run may not print one (a forbidden module
    loaded)."""
    import torch
    t_start = T_START if t_start is None else t_start
    # one thread for the host's own CPU work: idle intra-op threads took
    # cores from the port's dispatch and made host-paced runs noisy
    torch.set_num_threads(1)
    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    runner = spec.load_runner(cell.runner).Runner(cell, seed, dev)
    runner.setup(trace=trace)
    sync()
    setup_s = time.perf_counter() - t_start

    if hasattr(runner, "run_window"):
        # an open loop keeps its own schedule
        window = Window(*runner.run_window(seconds))
    else:
        steps, work = 0, 0.0
        t0 = time.perf_counter()
        while True:
            work += runner.step()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        window = Window(steps, work, time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    metrics, breakdown, extra_device = {}, None, {}
    if not trace:
        values = runner.end_to_end(window)
        values["setup_s"] = setup_s
        for m in cell.e2e:
            v = values[m["name"]]
            if v is not None:   # None: a device reading, with no card
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        from benchlib.trace import capture
        tr = capture(runner.traced_stretch)
        info = RunInfo(cell, window, tr, runner.facts(window))
        for m in cell.per_layer:
            v = spec.load_reader(m["name"], cell.bench_dir)(info)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": tr.top_device_ops(),
                     "idle_gaps": tr.idle_gaps()}
        extra_device = {"busy_s": tr.busy_s, "window_s": tr.window_s}

    bad = isolation.forbidden_loaded()
    if bad:
        print("forbidden modules loaded: " + ", ".join(bad), file=sys.stderr)
        return None
    checks = runner.check()
    checks.report()
    dev_info = (device.describe(cell.chips) if cuda else
                {"platform": "cpu", "kind": "cpu", "count": 1})
    dev_info["memory_peak_bytes"] = int(peak)
    dev_info.update(extra_device)
    result = {"correct": checks.correct,
              "attempted": runner.attempted(window),
              "failed": runner.failed(window),
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks.as_dict()
    if isolation.forbidden_loaded():
        return None
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    cell = spec.load_cell(args.workload)
    try:
        device.require_cards(cell.chips)
    except device.NoChip as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
