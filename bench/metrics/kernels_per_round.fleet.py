"""kernels_per_round.fleet: the device operations (kernels, copies,
memsets) the host launched a round, counted from its launch calls in the
profile of the traced rounds."""


def read(run):
    n = run.facts.get("rounds")
    if not n or run.trace is None or run.trace.launches <= 0:
        return None
    return run.trace.launches / n
