"""Run-report CLI: a telemetry JSONL run rendered as per-round tables; the
port of `repro/obs/report.py`, whose text it reproduces for the same
records.

    PYTHONPATH=src python -m repro_torch.obs.report RUN.jsonl [--last N]

Reads the round records both engines write through the JSONL sink
(`repro_torch.obs.sink`) and prints a per-round table (accuracy,
participants, commits, relay occupancy and owner diversity, pending depth,
late commits, stale reads, prototype drift, mean loss), the commit-lag
histogram over all rounds and the final round's staleness histogram, and
the communication ledger (floats, and MB at 4 bytes a float). Records
without a `telemetry` entry (metrics off, sink on) keep the accuracy and
communication columns.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.sink import read_jsonl

BYTES_PER_FLOAT = 4


def _fmt_hist(hist) -> str:
    return " ".join(str(int(v)) for v in hist)


def render(records, last: int = 0) -> str:
    """The report as one string (the CLI prints it; tests assert on it)."""
    if not records:
        return "(empty run: no round records)\n"
    shown = records[-last:] if last else records
    lines = []
    n_rounds = len(records)
    has_telem = any("telemetry" in r for r in records)
    lines.append(f"run report: {n_rounds} rounds"
                 + ("" if last == 0 or last >= n_rounds
                    else f" (showing last {len(shown)})"))
    lines.append("")
    header = (f"{'round':>5} {'acc':>7} {'parts':>5} {'commits':>7} "
              f"{'occ':>4} {'div':>4} {'pend':>4} {'late':>4} "
              f"{'stale':>5} {'drift':>8} {'loss':>8}")
    lines.append(header)
    lines.append("-" * len(header))
    for r in shown:
        t = r.get("telemetry")
        if t is None:
            occ = div = pend = late = stale = drift = loss = "-"
        else:
            occ = int(t["occupancy"])
            div = int(t["owner_diversity"])
            pend = int(t["pending_depth"])
            late = sum(int(v) for v in t["commit_hist"][1:])
            stale = int(t["stale_reads"])
            drift = f"{float(t['proto_drift']):.4f}"
            nb = [float(v) for v in t["bucket_loss"]]
            loss = f"{sum(nb) / len(nb):.4f}"
        acc = (f"{r['acc_mean']:.4f}" if "acc_mean" in r else "-")
        lines.append(
            f"{r['round']:>5} {acc:>7} "
            f"{len(r.get('participants', [])):>5} "
            f"{len(r.get('commits', [])):>7} {occ:>4} {div:>4} {pend:>4} "
            f"{late:>4} {stale:>5} {drift:>8} {loss:>8}")
    lines.append("")

    if has_telem:
        agg = [0] * obs_metrics.STALE_BINS
        for r in records:
            t = r.get("telemetry")
            if t:
                for i, v in enumerate(t["commit_hist"]):
                    agg[i] += int(v)
        lines.append(f"commit-lag histogram (all rounds, lag 0.."
                     f"{obs_metrics.STALE_BINS - 1}+): {_fmt_hist(agg)}")
        for r in reversed(records):
            t = r.get("telemetry")
            if t:
                lines.append(
                    f"staleness histogram (final round, age 0.."
                    f"{obs_metrics.STALE_BINS - 1}+): "
                    f"{_fmt_hist(t['stale_hist'])}")
                lines.append(
                    f"per-class fill (final round): {_fmt_hist(t['fill'])}")
                break
        lines.append("")

    up = sum(float(r.get("comm_up", 0.0)) for r in records)
    down = sum(float(r.get("comm_down", 0.0)) for r in records)
    mb = BYTES_PER_FLOAT * (up + down) / 1e6
    lines.append(f"comm: up {up:.0f} floats, down {down:.0f} floats "
                 f"({mb:.3f} MB at {BYTES_PER_FLOAT} B/float)")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a per-round summary from a telemetry JSONL run")
    ap.add_argument("jsonl", help="path to a run's JSONL metrics file")
    ap.add_argument("--last", type=int, default=0,
                    help="only show the last N rounds in the table")
    args = ap.parse_args(argv)
    print(render(read_jsonl(args.jsonl), last=args.last), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
