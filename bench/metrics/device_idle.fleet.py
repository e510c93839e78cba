"""device_idle.fleet: the share of the traced rounds in which no operation
ran on the card (the profiler's device timeline)."""
from benchlib.readers import idle_percent


def read(run):
    return idle_percent(run)
