"""Process start to the window's start: imports, the CUDA context, kernel
builds or loads, the statement pool's wallets and traces, one warm prove."""


def read(run):
    return run.setup_s
