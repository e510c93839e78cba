"""peak_gb.train: torch.cuda.max_memory_allocated over the traced steps,
after a reset at their start (GB of 1e9 bytes)."""


def read(run):
    b = run.facts.get("peak_bytes")
    return None if not b else b / 1e9
