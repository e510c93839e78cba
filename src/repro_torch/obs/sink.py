"""JSONL metrics sink: one line a round record, flushed as written; the
port's own copy of `repro/obs/sink.py`.

Both engines hand their round record to a `JsonlWriter`, and `python -m
repro_torch.obs.report` renders the file back into tables. JSONL because
runs are streams: an interrupted run keeps every completed round, `tail -f`
works, and a reader never needs the whole file in memory. Records reach the
sink already on the host (`obs.metrics.to_record` makes the telemetry
entry); numpy scalars and arrays that leak into a record are converted.
"""
from __future__ import annotations

import json
import os

import numpy as np


def _np_default(x):
    """json.dumps fallback for the numpy scalars and arrays of a record."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    raise TypeError(f"not JSON-serializable: {type(x)!r}")


class JsonlWriter:
    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "w")

    def write(self, record: dict):
        self._f.write(json.dumps(record, default=_np_default) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_jsonl(path: str) -> list:
    """A JSONL run -> its list of round records."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
