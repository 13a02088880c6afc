"""Time to a verified proof: the window's wall over the proofs it
completed, each proved and then verified by the program (host clock)."""


def read(run):
    return run.window_s / len(run.done) if run.done else None
