"""The program's verify of each window proof (its bytes parsed back, then
verified on the host): the mean wall in ms."""


def read(run):
    return 1e3 * sum(s.verify_s for s in run.done) / len(run.done) if run.done else None
