"""Wall of the statement pool's wallet and trace builds, by the program's
host builders, in set-up."""


def read(run):
    return run.build_s
