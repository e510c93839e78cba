"""dispatch_ms.fleet: the mean host milliseconds a round inside the
engine's own `round_step` span (`obs.TraceRecorder` without `profile`:
host time until the step's dispatch returned), over the window's rounds."""


def read(run):
    spans = run.facts.get("round_step_s") or []
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
