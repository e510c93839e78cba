"""tokens_per_s.train: all clients' training tokens of the window's steps
over the window's seconds on the host's clock (each step ends in the
prototype merge). The window runs before the traced steps, unprofiled."""


def read(run):
    w = run.window
    return None if w.seconds <= 0 else w.work / w.seconds
